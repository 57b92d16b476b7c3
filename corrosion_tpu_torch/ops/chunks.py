"""Seq-granular chunk dissemination and partial-version buffering
(counterpart of corrosion_tpu/ops/chunks.py).

S concurrent large transactions ("streams", each a (writer, version)
pair) disseminate as seq ranges: each (node, stream) row holds its seq
coverage as a fixed-capacity interval set (``ops/intervals.py``); chunks
gossip epidemically as random covered sub-ranges under a bounded intake;
due nodes run partial-need sync (``SyncNeedV1::Partial``): they compute
their seq gaps, request up to ``gap_requests`` of them from one peer and
insert what the peer can grant under a per-session seq budget. A stream
is *applied* at a node once its contiguous watermark reaches
``last_seq``. The reference computes this plane with plain array ops and
no Pallas kernel; so does the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import faulting, intervals, routing
from corrosion_tpu_torch.ops.gossip import MASK, _as_i32
from corrosion_tpu_torch.ops.intervals import IntervalSet


@dataclass(frozen=True)
class ChunkConfig:
    n_nodes: int
    n_streams: int  # concurrent large transactions
    cap: int = 16  # interval slots per (node, stream)
    chunk_len: int = 256  # seqs per gossiped chunk (~8 KiB / row bytes)
    fanout: int = 3
    k_in: int = 6  # bounded chunk intake per (node, stream) per round
    loss_prob: float = 0.0
    sync_interval: int = 5
    gap_requests: int = 4  # partial-need ranges requested per session
    sync_seq_budget: int = 4096  # seqs granted per session
    # Propagation observables in the degenerate single-region form: link_00
    # = chunks gossiped, useful = chunks accepted by the bounded intake.
    prop_observe: bool = False

    @property
    def rows(self) -> int:
        return self.n_nodes * self.n_streams


class ChunkState(NamedTuple):
    have: IntervalSet  # starts/ends [N*S, C] seq coverage per (node, stream)


def init_chunks(cfg: ChunkConfig, origin, last_seq, device=None) -> ChunkState:
    """The origin node of each stream starts with full coverage
    [0, last_seq]; every other row is empty."""
    device = resolve_device(device)
    origin = torch.as_tensor(origin, dtype=torch.int64, device=device)
    last_seq = torch.as_tensor(last_seq, dtype=torch.int64, device=device)
    have = intervals.make(cfg.cap, (cfg.rows,), device)
    rows = origin * cfg.n_streams + torch.arange(cfg.n_streams, device=device)
    starts, ends = have.starts, have.ends
    starts[rows, 0] = 0
    ends[rows, 0] = last_seq
    return ChunkState(have=IntervalSet(starts, ends))


def _phase(node: torch.Tensor, sync_interval: int) -> torch.Tensor:
    """The node's sync phase: ``node * 40503`` wraps in int32 as in the
    reference (node ids from 53,021 up), then a Python-style modulus."""
    return _as_i32(node * 40503) % sync_interval


def _pick_slot(live, u):
    """Each chunk's source slot: the argmax of its uniform scores over the
    row's live slots (the first of tied scores, as ``jnp.argmax``)."""
    return torch.argmax(torch.where(live[:, None, :], u, -1.0), dim=-1)


def _first_overlap(overlap):
    """[rows, 1]: the first overlapping slot of each row, 0 when none
    (``argmax`` takes no bool: cast first)."""
    return torch.argmax(overlap.to(torch.int32), dim=1, keepdim=True)


def chunk_round(
    state: ChunkState,
    last_seq,  # [S]
    alive,  # bool[N]
    round_idx,
    rng,
    cfg: ChunkConfig,
    loss=None,  # float32[] injected chunk-loss probability
) -> tuple[ChunkState, dict]:
    """One chunk-plane round: epidemic chunk send with bounded intake, then
    partial-need sync. Returns the next state and the round's stats."""
    n, s_count, f = cfg.n_nodes, cfg.n_streams, cfg.fanout
    rows = cfg.rows
    have = state.have
    dev = have.starts.device
    keys = rng_mod.split(rng, 5)
    k_tgt, k_slot, k_pos, k_loss, k_peer = (keys[i] for i in range(5))

    ar = torch.arange(rows, device=dev)
    row_node = ar // s_count
    row_stream = ar % s_count
    row_last = last_seq[row_stream]
    live = intervals.slot_mask(have)  # bool[rows, C]
    has_any = live.any(1)

    # ---- 1. epidemic chunk send: a random covered sub-range to f targets
    with record_function("corro_broadcast"):
        tgt = rng_mod.randint(k_tgt, (rows, f), 0, n)  # receiver node
        u = rng_mod.uniform(k_slot, (rows, f, cfg.cap))
        slot = _pick_slot(live, u)
        del u
        ss = have.starts.gather(1, slot)
        se = have.ends.gather(1, slot)
        span = torch.clamp(se - ss + 1, min=1)
        pos = ss + rng_mod.randint(k_pos, (rows, f), 0, 1 << 30) % span
        ce = torch.minimum(pos + cfg.chunk_len - 1, se)
        ok = (
            has_any[:, None]
            & alive[row_node][:, None]
            & alive[tgt]
            & (tgt != row_node[:, None])
        )
        # The plan's loss arrives as one scalar: no region structure here.
        ok, n_lost = faulting.apply_loss(k_loss, ok, cfg.loss_prob, loss)

        m_row = (tgt * s_count + row_stream[:, None]).reshape(-1)
        in_mask, (in_s, in_e) = routing.bounded_intake(
            m_row, ok.reshape(-1), (pos.reshape(-1), ce.reshape(-1)), rows,
            cfg.k_in,
        )
        for j in range(cfg.k_in):
            inserted = intervals.insert(have, in_s[:, j], in_e[:, j])
            have = intervals.select(in_mask[:, j], inserted, have)

    # ---- 2. partial-need sync (SyncNeedV1::Partial) ----------------------
    with record_function("corro_sync"):
        phase = _phase(row_node, cfg.sync_interval)
        due = alive[row_node] & ((round_idx + phase) % cfg.sync_interval == 0)
        peer = rng_mod.randint(k_peer, (n,), 0, n)
        peer_ok = alive[peer] & (peer != torch.arange(n, device=dev))
        p_row = peer[row_node] * s_count + row_stream
        gaps = intervals.gaps(have, 0, row_last)
        ps, pe = have.starts[p_row], have.ends[p_row]
        p_live = ps <= pe
        budget_left = torch.full((rows,), cfg.sync_seq_budget, dtype=torch.int64, device=dev)
        granted = torch.zeros((rows,), dtype=torch.int64, device=dev)
        row_peer_ok = peer_ok[row_node]
        for g in range(cfg.gap_requests):
            gs, ge = gaps.starts[:, g], gaps.ends[:, g]
            overlap = p_live & (ps <= ge[:, None]) & (pe >= gs[:, None])
            idx = _first_overlap(overlap)
            g_s = torch.maximum(gs, ps.gather(1, idx)[:, 0])
            g_e = torch.minimum(ge, pe.gather(1, idx)[:, 0])
            g_e = torch.minimum(g_e, g_s + budget_left - 1)
            ok_g = (
                due & row_peer_ok & (gs <= ge) & overlap.any(1)
                & (budget_left > 0)
            )
            have = intervals.select(ok_g, intervals.insert(have, g_s, g_e), have)
            got = torch.where(ok_g, g_e - g_s + 1, 0)
            budget_left = budget_left - got
            granted = granted + got

    new_state = ChunkState(have=have)
    with record_function("corro_health"):
        # Remaining seq deficit to full coverage, summed cluster-wide. The
        # reference sums float32; the port takes the exact integer sum and
        # rounds once, which is the same value while the mass is below 2^24.
        covered = intervals.total(have)
        row_deficit = torch.clamp(row_last + 1 - covered, min=0)
        need_seqs = row_deficit.sum().to(torch.float32)
        # The worst node's deficit summed over its streams (u32).
        need_node_max = (row_deficit.reshape(n, s_count).sum(1) & MASK).amax()
        # Node-level sync sessions this round.
        phase_n = _phase(torch.arange(n, device=dev), cfg.sync_interval)
        due_n = alive & ((round_idx + phase_n) % cfg.sync_interval == 0)
        stats = {
            "chunks_sent": ok.sum(),
            "chunks_applied": in_mask.sum(),
            "seqs_granted": granted.sum() & MASK,
            "sessions": (due_n & peer_ok).sum(),
            "need_seqs": need_seqs,
            "need_node_max": need_node_max,
            "applied_nodes": applied_mask(new_state, last_seq, cfg).sum(),
            "lost_msgs": n_lost,
        }
    return new_state, stats


def wipe_coverage(state: ChunkState, wipe, cfg: ChunkConfig) -> ChunkState:
    """Crash-with-state-wipe on the chunk plane: every interval slot of a
    wiped node's (node, stream) rows resets to empty."""
    mask = wipe.repeat_interleave(cfg.n_streams)[:, None]  # bool[rows, 1]
    return ChunkState(have=IntervalSet(
        starts=torch.where(mask, intervals.EMPTY, state.have.starts),
        ends=torch.where(mask, intervals.EMPTY - 1, state.have.ends),
    ))


def applied_mask(state: ChunkState, last_seq, cfg: ChunkConfig) -> torch.Tensor:
    """bool[N, S]: stream fully reassembled (gap-free to last_seq) at each
    node."""
    rows = torch.arange(cfg.rows, device=state.have.starts.device)
    row_last = last_seq[rows % cfg.n_streams]
    wm = intervals.contiguous_watermark(state.have, 0)
    return (wm >= row_last).reshape(cfg.n_nodes, cfg.n_streams)

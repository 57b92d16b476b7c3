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

import contextlib
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import exchange, faulting, intervals, routing
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


def init_chunks(cfg: ChunkConfig, origin, last_seq, device=None,
                pos: exchange.Pos | None = None) -> ChunkState:
    """The origin node of each stream starts with full coverage
    [0, last_seq]; every other row is empty. ``pos`` builds just a mesh
    position's block: its rows ``[row_start * S, (row_start + n_local) *
    S)``, where only the origins it owns start full."""
    device = resolve_device(device)
    pos = exchange.whole(cfg.n_nodes) if pos is None else pos
    origin = torch.as_tensor(origin, dtype=torch.int64, device=device)
    last_seq = torch.as_tensor(last_seq, dtype=torch.int64, device=device)
    r_own = pos.n_local * cfg.n_streams
    # One spare row past the block takes the origins other positions own.
    have = intervals.make(cfg.cap, (r_own + 1,), device)
    local = origin - pos.row_start
    own = (local >= 0) & (local < pos.n_local)
    rows = torch.where(own, local * cfg.n_streams + torch.arange(cfg.n_streams, device=device),
                       r_own)
    starts, ends = have.starts, have.ends
    starts[rows, 0] = 0
    ends[rows, 0] = last_seq
    if pos.whole:
        return ChunkState(have=IntervalSet(starts[:r_own], ends[:r_own]))
    return ChunkState(have=IntervalSet(starts[:r_own].clone(), ends[:r_own].clone()))


def _phase(node: torch.Tensor, sync_interval: int) -> torch.Tensor:
    """The node's sync phase: ``node * 40503`` wraps in int32 as in the
    reference (node ids from 53,021 up), then a Python-style modulus."""
    return _as_i32(node * 40503) % sync_interval


@functools.lru_cache(maxsize=64)
def _phase_cohorts(row_start: int, n_local: int, sync_interval: int) -> tuple:
    """For each phase p, the local rows of the nodes ``[row_start,
    row_start + n_local)`` whose sync phase is p (``_phase`` on the host,
    once a position)."""
    nodes = np.arange(row_start, row_start + n_local, dtype=np.int64)
    x = (nodes * 40503) & 0xFFFFFFFF
    phase = np.remainder(np.where(x >= 1 << 31, x - (1 << 32), x), sync_interval)
    return tuple(np.flatnonzero(phase == p) for p in range(sync_interval))


def phase_rows(pos: exchange.Pos, cfg: ChunkConfig, device) -> tuple | None:
    """A position's sync cohorts on ``device``: for each phase p, the
    local rows of its nodes whose sync phase is p. A round's due nodes are
    the alive ones of the cohort of phase ``-round mod sync_interval``.
    Made once a run (``_chunk_round`` takes them). None for a position
    holding every row, which reads every peer row in one gather."""
    if pos.whole:
        return None
    return tuple(torch.as_tensor(rows, device=device)
                 for rows in _phase_cohorts(pos.row_start, pos.n_local, cfg.sync_interval))


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
    partial-need sync. Returns the next state and the round's stats.
    ``_chunk_round`` on one position holding every row."""
    pos = exchange.whole(cfg.n_nodes)
    new_state, part, peak = exchange.solo(_chunk_round(
        state, last_seq, alive, int(round_idx), rng, cfg, pos, None, loss,
    ))
    return new_state, chunk_stats(part, peak)


def _chunk_round(state: ChunkState, last_seq, alive, round_idx: int, rng, cfg: ChunkConfig,
                 pos: exchange.Pos, phases: tuple | None, loss=None):
    """``chunk_round`` over one mesh position's rows: a generator over
    ``pos`` (``state`` its block of (node, stream) rows, ``alive`` the
    whole liveness vector, ``round_idx`` the round as a host int,
    ``phases`` its ``phase_rows``) that returns (the position's next
    state, its partial sums, its partial maxima); ``chunk_stats`` turns
    their totals into the round's stats.
    Each position draws its rows of the reference's full-shape draws. The
    chunk send is a ``Route`` to the targets' owners; the partial-need
    sync asks for the peers' coverage rows of this round's due nodes."""
    n, s_count, f = cfg.n_nodes, cfg.n_streams, cfg.fanout
    nl = pos.n_local
    rows = nl * s_count
    have = state.have
    dev = have.starts.device
    keys = rng_mod.split_keys(rng, 5)
    k_tgt, k_slot, k_pos, k_loss, k_peer = (keys[i] for i in range(5))
    # The position's rows of the [N * S, ...] draws.
    box = None if pos.whole else (pos.row_start * s_count, (pos.row_start + nl) * s_count)

    nodes = pos.nodes(dev)  # global node id of each local node
    ar = torch.arange(rows, device=dev)
    row_local = ar // s_count  # the row's local node
    row_stream = ar % s_count
    del ar
    row_last = last_seq[row_stream]
    alive_n = alive if pos.whole else alive[nodes]
    live = intervals.slot_mask(have)  # bool[rows, C]
    has_any = live.any(1)
    # Profiler ranges as the reference's named scopes; lockstepped
    # positions would interleave them, so only a whole position opens them.
    plane = record_function if pos.whole else (lambda name: contextlib.nullcontext())

    # ---- 1. epidemic chunk send: a random covered sub-range to f targets
    with plane("corro_broadcast"):
        tgt = rng_mod.randint(k_tgt, (cfg.rows, f), 0, n, rows=box)  # receiver node
        u = rng_mod.uniform(k_slot, (cfg.rows, f, cfg.cap), rows=box)
        slot = _pick_slot(live, u)
        del u
        ss = have.starts.gather(1, slot)
        se = have.ends.gather(1, slot)
        span = torch.clamp(se - ss + 1, min=1)
        pos_s = ss + rng_mod.randint(k_pos, (cfg.rows, f), 0, 1 << 30, rows=box) % span
        ce = torch.minimum(pos_s + cfg.chunk_len - 1, se)
        ok = (
            has_any[:, None]
            & alive_n[row_local][:, None]
            & alive[tgt]
            & (tgt != (pos.row_start + row_local)[:, None])
        )
        # The plan's loss arrives as one scalar: no region structure here.
        ok, n_lost = faulting.apply_loss(k_loss, ok, cfg.loss_prob, loss,
                                         full_rows=None if box is None else (cfg.rows, box[0]))
        # Each target's owner takes the chunks addressed to it, every
        # position's in position order and each sender's in its own
        # flattened (row, j) order. Positions own contiguous row blocks in
        # the C order of the mesh, so that is the reference's flat message
        # order restricted to the owner's rows, and ``bounded_intake``'s
        # "lowest flat index first" ranks exactly as the reference's over
        # the owner's (local node, stream) rows: bit-equality rests on it.
        # Each entry carries its receiving (node, stream) row.
        m_row = (tgt * s_count + row_stream[:, None]).reshape(-1)
        _, valid, (m_row, m_s, m_e) = yield exchange.Route(
            "chunks", tgt.reshape(-1), ok.reshape(-1), (m_row, pos_s.reshape(-1), ce.reshape(-1)),
        )
        if pos.row_start:
            m_row = m_row - pos.row_start * s_count
        in_mask, (in_s, in_e) = routing.bounded_intake(m_row, valid, (m_s, m_e), rows, cfg.k_in)
        del valid, m_row, m_s, m_e
        for j in range(cfg.k_in):
            inserted = intervals.insert(have, in_s[:, j], in_e[:, j])
            have = intervals.select(in_mask[:, j], inserted, have)

    # ---- 2. partial-need sync (SyncNeedV1::Partial) ----------------------
    with plane("corro_sync"):
        due_n = alive_n & ((round_idx + _phase(nodes, cfg.sync_interval))
                           % cfg.sync_interval == 0)
        due = due_n[row_local]
        peer = rng_mod.randint(k_peer, (n,), 0, n, rows=pos.box)
        peer_ok = alive[peer] & (peer != nodes)
        gaps = intervals.gaps(have, 0, row_last)
        tables = (have.starts.reshape(nl, -1), have.ends.reshape(nl, -1))
        if phases is None:
            # Every row here: one gather of the peers' rows, as the reference.
            ps, pe = yield exchange.Rows("chunk_sync", tables, peer)
        else:
            # The peers' coverage rows of this round's phase cohort only: a
            # row that is not due never grants, so the rest may hold
            # anything (they read as empty).
            cohort = phases[-round_idx % cfg.sync_interval]
            got_s, got_e = yield exchange.Rows("chunk_sync", tables, peer[cohort])
            ps = torch.full((nl, s_count * cfg.cap), intervals.EMPTY, dtype=torch.int64,
                            device=dev)
            ps[cohort] = got_s
            del got_s
            pe = torch.full((nl, s_count * cfg.cap), intervals.EMPTY - 1, dtype=torch.int64,
                            device=dev)
            pe[cohort] = got_e
            del got_e
        del tables
        ps, pe = ps.reshape(rows, cfg.cap), pe.reshape(rows, cfg.cap)
        p_live = ps <= pe
        budget_left = torch.full((rows,), cfg.sync_seq_budget, dtype=torch.int64, device=dev)
        granted = torch.zeros((rows,), dtype=torch.int64, device=dev)
        row_peer_ok = peer_ok[row_local]
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
    with plane("corro_health"):
        # The position's shares: the remaining seq deficit to full coverage
        # (exact int64, rounded to float32 once after the sum: the
        # reference sums float32, which is the same value while the mass is
        # below 2^24), the worst node's deficit summed over its streams
        # (u32), node-level sync sessions.
        covered = intervals.total(have)
        row_deficit = torch.clamp(row_last + 1 - covered, min=0)
        part = {
            "chunks_sent": ok.sum(),
            "chunks_applied": in_mask.sum(),
            "seqs_granted": granted.sum(),
            "sessions": (due_n & peer_ok).sum(),
            "need_seqs": row_deficit.sum(),
            "applied_nodes": applied_mask(new_state, last_seq, cfg).sum(),
            "lost_msgs": n_lost,
        }
        peak = {"need_node_max": (row_deficit.reshape(nl, s_count).sum(1) & MASK).amax()}
    return new_state, part, peak


def chunk_stats(total: dict, peak: dict) -> dict:
    """The round's stats from the totals of ``_chunk_round``'s partial
    sums and maxima over every position."""
    return {
        "chunks_sent": total["chunks_sent"],
        "chunks_applied": total["chunks_applied"],
        "seqs_granted": total["seqs_granted"] & MASK,
        "sessions": total["sessions"],
        "need_seqs": total["need_seqs"].to(torch.float32),
        "need_node_max": peak["need_node_max"],
        "applied_nodes": total["applied_nodes"],
        "lost_msgs": total["lost_msgs"],
    }


def wipe_coverage(state: ChunkState, wipe, cfg: ChunkConfig) -> ChunkState:
    """Crash-with-state-wipe on the chunk plane: every interval slot of a
    wiped node's (node, stream) rows resets to empty (``wipe`` the block's
    nodes of the mask)."""
    mask = wipe.repeat_interleave(cfg.n_streams)[:, None]  # bool[rows, 1]
    return ChunkState(have=IntervalSet(
        starts=torch.where(mask, intervals.EMPTY, state.have.starts),
        ends=torch.where(mask, intervals.EMPTY - 1, state.have.ends),
    ))


def applied_mask(state: ChunkState, last_seq, cfg: ChunkConfig) -> torch.Tensor:
    """bool[n, S]: stream fully reassembled (gap-free to last_seq) at each
    node of the block (every node, or a mesh position's)."""
    rows = torch.arange(state.have.starts.shape[0], device=state.have.starts.device)
    row_last = last_seq[rows % cfg.n_streams]
    wm = intervals.contiguous_watermark(state.have, 0)
    return (wm >= row_last).reshape(-1, cfg.n_streams)

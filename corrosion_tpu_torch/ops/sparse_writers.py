"""Sparse writer axis: rotating hot slots + per-node deviation tables, in
PyTorch.

Counterpart of corrosion_tpu/ops/sparse_writers.py, whose module docstring
describes the design: any of N nodes may write; ``w_hot`` rotating SLOTS
carry the dense [N, w_hot] plane for the currently active writers (queue
entries also carry the writer's GLOBAL id, ``track_writer_ids``), and a
demoted writer's residual lag lives in bounded per-node deviation tables
that ``cold_sync`` heals from the stream's origin. A deviation entry is
never dropped silently: ``rotate`` reports ``dev_dropped`` and the engine
raises on it.

Where the reference builds one-hot matmuls (column gathers and scatters
over shared slot indices, which serialise on a TPU), the port indexes
directly: ``index_select`` for ``_col_gather``, ``index_copy_`` for the
promoted columns, and the ``table_gather`` kernel for the reset-slot mask
of the queue. Each ``lax.cond`` on ``dev_any`` is a counted host read
(``gossip.HOST_SYNCS["branch"]``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.ops import onehot, routing
from corrosion_tpu_torch.ops.gossip import (
    MASK,
    DataState,
    GossipConfig,
    _branch,
    _merge_versions_dense,
    _ok_rows,
    init_data,
)


@dataclass(frozen=True)
class SparseConfig:
    """Knobs for the rotating-slot writer plane (the reference's)."""

    epoch_rounds: int = 16  # rotation cadence
    k_dev: int = 64  # deviation-table capacity per node
    d_max: int = 256  # max slot retirements per epoch (static pad)
    p_max: int = 256  # max promotions per epoch (static pad)
    demote_after: int = 1  # quiescent epochs before a slot may demote
    cold_budget: int = 64  # versions healed per node per cold_sync session
    cold_chunk: int = 32  # versions per deviation entry per session


class SparseState(NamedTuple):
    data: DataState  # the hot plane ([N, w_hot] slot tensors)
    head_full: torch.Tensor  # [N] committed head per NODE (global writers)
    slot_writer: torch.Tensor  # [w_hot] node id per slot, -1 empty
    dev_writer: torch.Tensor  # [N, k_dev] global writer id, -1 empty
    dev_contig: torch.Tensor  # [N, k_dev] lagging watermark
    dev_any: torch.Tensor  # bool[] any deviation entry exists


def init_sparse(cfg: GossipConfig, sp: SparseConfig, device=None) -> SparseState:
    device = resolve_device(device)
    n = cfg.n_nodes
    return SparseState(
        data=init_data(cfg, device),
        head_full=torch.zeros((n,), dtype=torch.int64, device=device),
        slot_writer=torch.full((cfg.n_writers,), -1, dtype=torch.int64, device=device),
        dev_writer=torch.full((n, sp.k_dev), -1, dtype=torch.int64, device=device),
        dev_contig=torch.zeros((n, sp.k_dev), dtype=torch.int64, device=device),
        dev_any=torch.zeros((), dtype=torch.bool, device=device),
    )


def _col_gather(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[N, D] = table[:, slots] for shared column indices (exact; the
    reference's u16-halves matmul computes the same)."""
    return torch.index_select(table, 1, slots)


def _set_drop(base: torch.Tensor, idx: torch.Tensor, vals, width: int) -> torch.Tensor:
    """A copy of 1-D ``base`` with ``base[idx] = vals``, dropping every
    ``idx == width`` (the reference's ``.at[].set(mode="drop")``; the
    scatter lands those in a sentinel slot that is cut off)."""
    out = torch.cat([base, base.new_zeros(1)])
    vals = torch.as_tensor(vals, dtype=base.dtype, device=base.device).expand(idx.shape)
    return out.scatter(0, idx, vals)[:width]


def demote_report(state: SparseState, cand_slots, cand_ok):
    """Device-side feasibility for a host-proposed retirement list.
    Returns (caught_up bool[D], maxload [D]): whether every node's hot
    contig equals the slot's head (zero-lag demotion is free), and the
    largest deviation-table load over nodes if candidates 0..d were all
    force-demoted."""
    data = state.data
    cs = torch.clamp(cand_slots, min=0)
    contig_c = _col_gather(data.contig, cs)  # [N, D]
    lag = ((data.head[cs][None, :] - contig_c) & MASK) * cand_ok[None, :]
    caught_up = (lag > 0).sum(dim=0) == 0
    occ = (state.dev_writer >= 0).sum(dim=1)  # [N]
    adds = torch.cumsum((lag > 0).to(torch.int64), dim=1)  # [N, D]
    maxload = (occ[:, None] + adds).amax(dim=0)
    return caught_up, maxload


def rotate(state: SparseState, retire_slots, retire_ok, promote_slots,
           promote_writers, promote_ok, cfg: GossipConfig):
    """Epoch transition (reference ``rotate``): retire slots, inserting
    deviation entries for laggards, then promote new writers into free
    slots, consuming any deviation entries for them. Returns (state,
    stats); ``stats["dev_dropped"]`` must stay 0."""
    data = state.data
    n, w_hot = cfg.n_nodes, cfg.n_writers
    p = promote_slots.shape[0]
    dev = data.contig.device
    rs = torch.clamp(retire_slots, min=0)
    ps = torch.clamp(promote_slots, min=0)

    # ---- retire: write heads back, insert deviation entries ----------------
    writer_ret = torch.where(retire_ok, state.slot_writer[rs], -1)
    head_ret = data.head[rs]
    ret_live = retire_ok & (writer_ret >= 0)
    head_full = _set_drop(state.head_full, torch.where(ret_live, writer_ret, n), head_ret, n)

    contig_ret = _col_gather(data.contig, rs)  # [N, D]
    lag_mask = (
        (contig_ret < head_ret[None, :]) & retire_ok[None, :] & (writer_ret[None, :] >= 0)
    )
    cand_w = torch.cat(
        [state.dev_writer, torch.where(lag_mask, writer_ret[None, :], -1)], dim=1
    )
    cand_c = torch.cat([state.dev_contig, contig_ret], dim=1)
    cand_valid = cand_w >= 0
    keep, (dev_writer, dev_contig) = routing.rebuild_bounded_queue(
        cand_valid, cand_valid.to(torch.int64), (cand_w, cand_c),
        state.dev_writer.shape[1],
    )
    dev_writer = torch.where(keep, dev_writer, -1)
    dev_dropped = cand_valid.sum() - keep.sum()

    retired_col = _set_drop(
        torch.zeros(w_hot, dtype=torch.bool, device=dev),
        torch.where(retire_ok, rs, w_hot), True, w_hot,
    )
    slot_writer = torch.where(retired_col, -1, state.slot_writer)

    # ---- promote: init columns from head_full, refined by dev entries ------
    pw = torch.clamp(promote_writers, min=0)
    # head_full AFTER the retire writeback (a writer promoted this epoch is
    # never also retiring this epoch: host invariant).
    claims = head_full[pw][None, :].expand(n, p)
    # Writer id -> promotion index (p is the sentinel; index n is never read).
    promo_idx = torch.full((n + 1,), p, dtype=torch.int64, device=dev).scatter(
        0, torch.where(promote_ok, pw, n), torch.arange(p, device=dev)
    )
    if _branch(state.dev_any):
        # Per deviation entry: is its writer promoted this epoch? A node has
        # at most one entry per writer, so the scatter of entry claims into
        # the [N, P] claim matrix is collision-free (misses land on the
        # sentinel slot n * p, cut off).
        k_dev = dev_writer.shape[1]
        idx = promo_idx[torch.clamp(dev_writer, min=0)]  # [N, K]
        hit = (idx < p) & (dev_writer >= 0)
        rowi = torch.arange(n, device=dev)[:, None].expand(n, k_dev)
        pos = torch.where(hit, rowi * p + idx, n * p)
        flat = torch.cat([claims.reshape(-1), claims.new_zeros(1)])
        claims = flat.scatter(0, pos.reshape(-1), dev_contig.reshape(-1))[:-1].reshape(n, p)
        dev_writer = torch.where(hit, -1, dev_writer)

    promoted_col = _set_drop(
        torch.zeros(w_hot, dtype=torch.bool, device=dev),
        torch.where(promote_ok, ps, w_hot), True, w_hot,
    )
    col_reset = retired_col | promoted_col
    # Retired and promoted columns reset; the promoted ones then take their
    # claims: an index_copy of the valid promotions only (one counted read
    # of the mask).
    sel = _ok_rows(ps, promote_ok)
    cols, col_claims = ps[sel], claims[:, sel]
    contig = torch.where(col_reset[None, :], 0, data.contig)
    contig.index_copy_(1, cols, col_claims)
    seen = torch.where(col_reset[None, :], 0, data.seen)
    seen.index_copy_(1, cols, col_claims)
    # Window bits of reset columns drop (possession under-claim: safe).
    oo = torch.where(col_reset[None, None, :], 0, data.oo)
    head = torch.where(
        promoted_col,
        _set_drop(torch.zeros_like(data.head), torch.where(promote_ok, ps, w_hot),
                  head_full[pw], w_hot),
        torch.where(retired_col, 0, data.head),
    )
    slot_writer = torch.where(
        promoted_col,
        _set_drop(torch.full_like(slot_writer, -1), torch.where(promote_ok, ps, w_hot),
                  promote_writers, w_hot),
        slot_writer,
    )

    # Queue entries of reset slots die (their content is applied at its
    # holders; receivers that never got it lag on the retired writer and
    # heal through deviations/cold_sync): q_writer holds slot ids, mapped
    # through the [W] reset mask by the shared-table gather.
    q_dead = onehot.table_gather(
        col_reset.to(torch.int64), torch.clamp(data.q_writer, min=0)
    )
    q_writer = torch.where((q_dead > 0) & (data.q_writer >= 0), -1, data.q_writer)

    live = dev_writer >= 0
    stats = {
        "retired": ret_live.sum(),
        "promoted": promote_ok.sum(),
        "dev_entries": live.sum(),
        "dev_dropped": dev_dropped,
    }
    return (
        SparseState(
            data=data._replace(
                contig=contig, seen=seen, oo=oo,
                oo_any=oo.any() if cfg.window_k else data.oo_any,
                head=head, q_writer=q_writer,
            ),
            head_full=head_full,
            slot_writer=slot_writer,
            dev_writer=dev_writer,
            dev_contig=dev_contig,
            dev_any=live.any(),
        ),
        stats,
    )


def cold_sync(state: SparseState, region, alive, partition, cfg: GossipConfig,
              sp: SparseConfig):
    """Heal deviation entries by pulling from each stream's origin node,
    budgeted per node per session, merging the granted versions' CRDT
    cells (reference ``cold_sync``). Sessions run only while deviation
    entries exist."""
    dev = state.dev_writer.device
    if not _branch(state.dev_any):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return state, {"cold_healed": zero, "cold_merges": zero}
    n = cfg.n_nodes
    dev_w, dev_c = state.dev_writer, state.dev_contig
    k_dev = dev_w.shape[1]
    wsafe = torch.clamp(dev_w, min=0)
    # Reachability of the origin: alive and not partitioned from us.
    ok = (dev_w >= 0) & alive[wsafe] & ~partition[region[:, None], region[wsafe]]
    target = state.head_full[wsafe]  # [N, K]
    deficit = torch.where(ok, target - torch.minimum(target, dev_c), 0)
    per_e = torch.clamp(deficit, max=sp.cold_chunk)
    cum = torch.cumsum(per_e, dim=1)
    grant = torch.minimum(torch.clamp(sp.cold_budget - (cum - per_e), min=0), per_e)
    new_c = dev_c + grant
    healed = grant.sum() & MASK

    cells = state.data.cells
    n_merges = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.n_cells > 0:
        # Enumerate granted (writer, version) pairs into [N, B] and merge
        # their cells. The entry owning unit e is the count of cumulative
        # grants <= e: a searchsorted (the reference's [N, B, K] compare
        # count, which is 1.6 GB of bools at full size).
        b = sp.cold_budget
        e = torch.arange(b, device=dev)
        gcum = torch.cumsum(grant, dim=1)
        e_idx = torch.searchsorted(gcum, e[None, :].expand(n, b).contiguous(), right=True)
        e_idx = torch.clamp(e_idx, max=k_dev - 1)
        prev = torch.where(
            e_idx > 0, onehot.rowgather(gcum, torch.clamp(e_idx - 1, min=0)), 0
        )
        ver = (onehot.rowgather(dev_c, e_idx) + 1 + (e[None, :] - prev)) & MASK
        gw = onehot.rowgather(wsafe, e_idx)
        mask = e[None, :] < gcum[:, -1][:, None]
        cells, n_merges = _merge_versions_dense(cells, None, gw, ver, mask, None, n, cfg)

    # Entries that reached the cold head clear.
    dev_w2 = torch.where(ok & (new_c >= target), -1, dev_w)
    return (
        state._replace(
            data=state.data._replace(cells=cells),
            dev_writer=dev_w2,
            dev_contig=new_c,
            dev_any=(dev_w2 >= 0).any(),
        ),
        {"cold_healed": healed, "cold_merges": n_merges & MASK},
    )


def cold_visibility(state: SparseState, sample_writer, sample_ver) -> torch.Tensor:
    """bool[S, N] visibility of sampled writes against the COLD plane: a
    cold write is held everywhere except at nodes with a deviation entry
    below it. 16 samples at a time bound the [16, N, K] compare."""
    s, n = sample_writer.shape[0], state.dev_writer.shape[0]
    if not _branch(state.dev_any):
        return torch.ones((s, n), dtype=torch.bool, device=sample_writer.device)
    outs = [torch.ones((0, n), dtype=torch.bool, device=sample_writer.device)]
    for i in range(0, s, 16):
        w, v = sample_writer[i : i + 16], sample_ver[i : i + 16]
        lag = (state.dev_writer[None] == w[:, None, None]) & (
            state.dev_contig[None] < v[:, None, None]
        )
        outs.append(~lag.any(dim=2))
    return torch.cat(outs)


def cold_need(state: SparseState) -> torch.Tensor:
    """Sum of outstanding deviation lag (the cold part of total_need)."""
    target = state.head_full[torch.clamp(state.dev_writer, min=0)]
    lag = torch.where(
        state.dev_writer >= 0, target - torch.minimum(target, state.dev_contig), 0
    )
    return lag.sum() & MASK

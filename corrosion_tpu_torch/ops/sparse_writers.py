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

``_demote_report``, ``_rotate`` and ``_cold_sync`` are bodies over one
mesh position's rows (``ops/exchange.py``: they yield where they read
what other positions own), and ``demote_report``, ``rotate`` and
``cold_sync`` run them on one position holding every row. ``dev_any`` is
replicated: each body that changes the deviation tables ORs the
positions' entries into it, so every position takes the same branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.ops import exchange, onehot, routing
from corrosion_tpu_torch.ops.gossip import (
    MASK,
    DataState,
    GossipConfig,
    _branch,
    _merge_versions_dense,
    _ok_rows,
    init_data,
    serial_merge_reference,
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


def init_sparse(cfg: GossipConfig, sp: SparseConfig, device=None,
                n_rows: int | None = None) -> SparseState:
    """The initial state; ``n_rows`` builds just a mesh position's block of
    that many node rows (the slot vectors and flags whole)."""
    device = resolve_device(device)
    n = cfg.n_nodes if n_rows is None else n_rows
    return SparseState(
        data=init_data(cfg, device, n_rows=n_rows),
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
    force-demoted. ``_demote_report`` on one position holding every
    row."""
    n = state.dev_writer.shape[0]
    return exchange.solo(_demote_report(state, cand_slots, cand_ok, exchange.whole(n)))


def _demote_report(state: SparseState, cand_slots, cand_ok, pos):
    """``demote_report`` over one position's rows (``state`` its block):
    each candidate's lagging-row count is summed across positions and
    tested for 0 after the total, and the load bound is a maximum over
    rows, so both decompose exactly."""
    data = state.data
    cs = torch.clamp(cand_slots, min=0)
    contig_c = _col_gather(data.contig, cs)  # [n_local, D]
    lagging = (((data.head[cs][None, :] - contig_c) & MASK) * cand_ok[None, :]) > 0
    del contig_c
    occ = (state.dev_writer >= 0).sum(dim=1)  # [n_local]
    adds = torch.cumsum(lagging.to(torch.int64), dim=1)  # [n_local, D]
    load = (occ[:, None] + adds).amax(dim=0)
    counts = lagging.sum(dim=0)
    # The [n_local, D] temporaries go before the exchange: every position
    # holds its frame there at once.
    del adds, lagging
    total = yield exchange.Reduce("demote", sum=(counts,), max=(load,))
    return total.sum[0] == 0, total.max[0]


def rotate(state: SparseState, retire_slots, retire_ok, promote_slots,
           promote_writers, promote_ok, cfg: GossipConfig):
    """Epoch transition (reference ``rotate``): retire slots, inserting
    deviation entries for laggards, then promote new writers into free
    slots, consuming any deviation entries for them. Returns (state,
    stats); ``stats["dev_dropped"]`` must stay 0. ``_rotate`` on one
    position holding every row."""
    return exchange.solo(_rotate(
        state, retire_slots, retire_ok, promote_slots, promote_writers, promote_ok, cfg,
        exchange.whole(cfg.n_nodes),
    ))


def _rotate(state: SparseState, retire_slots, retire_ok, promote_slots, promote_writers,
            promote_ok, cfg: GossipConfig, pos):
    """``rotate`` over one position's rows (``state`` its block; the plan
    and the slot vectors whole). The retired heads land in the position's
    own range of ``head_full``; the promotions' claims read the whole
    vector after that write-back (one ``Gather``); the slot vectors are
    computed alike at every position; the deviation-table counts and the
    window and deviation flags are totals over positions."""
    data = state.data
    n, w_hot, first = pos.n_local, cfg.n_writers, pos.row_start
    p = promote_slots.shape[0]
    dev = data.contig.device
    rs = torch.clamp(retire_slots, min=0)
    ps = torch.clamp(promote_slots, min=0)

    # ---- retire: write heads back, insert deviation entries ----------------
    writer_ret = torch.where(retire_ok, state.slot_writer[rs], -1)
    head_ret = data.head[rs]
    ret_live = retire_ok & (writer_ret >= 0)
    # The retired writers in this position's range land in its block.
    mine = ret_live & (writer_ret >= first) & (writer_ret < first + n)
    head_full = _set_drop(state.head_full, torch.where(mine, writer_ret - first, n), head_ret, n)
    # The promotions' claims read head_full AFTER the retire writeback (a
    # writer promoted this epoch is never also retiring this epoch: host
    # invariant), at the promoted writers' global ids.
    (whole_hf,) = yield exchange.Gather("head_full", (head_full,))
    pw = torch.clamp(promote_writers, min=0)
    claim_row = whole_hf[pw]
    del whole_hf

    contig_ret = _col_gather(data.contig, rs)  # [n, D]
    lag_mask = (
        (contig_ret < head_ret[None, :]) & retire_ok[None, :] & (writer_ret[None, :] >= 0)
    )
    cand_w = torch.cat(
        [state.dev_writer, torch.where(lag_mask, writer_ret[None, :], -1)], dim=1
    )
    cand_c = torch.cat([state.dev_contig, contig_ret], dim=1)
    del contig_ret, lag_mask
    cand_valid = cand_w >= 0
    keep, (dev_writer, dev_contig) = routing.rebuild_bounded_queue(
        cand_valid, cand_valid.to(torch.int64), (cand_w, cand_c),
        state.dev_writer.shape[1],
    )
    dev_writer = torch.where(keep, dev_writer, -1)
    dev_dropped = cand_valid.sum() - keep.sum()
    del cand_w, cand_c, cand_valid, keep

    retired_col = _set_drop(
        torch.zeros(w_hot, dtype=torch.bool, device=dev),
        torch.where(retire_ok, rs, w_hot), True, w_hot,
    )
    slot_writer = torch.where(retired_col, -1, state.slot_writer)

    # ---- promote: init columns from head_full, refined by dev entries ------
    claims = claim_row[None, :].expand(n, p)
    # Writer id -> promotion index (p is the sentinel; index N is never
    # read): an [N + 1] control vector, alike at every position.
    n_total = pos.n_total
    promo_idx = torch.full((n_total + 1,), p, dtype=torch.int64, device=dev).scatter(
        0, torch.where(promote_ok, pw, n_total), torch.arange(p, device=dev)
    )
    if _branch(state.dev_any):
        # Per deviation entry: is its writer promoted this epoch? A node has
        # at most one entry per writer, so the scatter of entry claims into
        # the [n, P] claim matrix is collision-free (misses land on the
        # sentinel slot n * p, cut off).
        k_dev = dev_writer.shape[1]
        idx = promo_idx[torch.clamp(dev_writer, min=0)]  # [n, K]
        hit = (idx < p) & (dev_writer >= 0)
        rowi = torch.arange(n, device=dev)[:, None].expand(n, k_dev)
        at = torch.where(hit, rowi * p + idx, n * p)
        flat = torch.cat([claims.reshape(-1), claims.new_zeros(1)])
        claims = flat.scatter(0, at.reshape(-1), dev_contig.reshape(-1))[:-1].reshape(n, p)
        dev_writer = torch.where(hit, -1, dev_writer)
        del idx, hit, rowi, at, flat

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
    del claims
    contig = torch.where(col_reset[None, :], 0, data.contig)
    contig.index_copy_(1, cols, col_claims)
    seen = torch.where(col_reset[None, :], 0, data.seen)
    seen.index_copy_(1, cols, col_claims)
    del col_claims
    # Window bits of reset columns drop (possession under-claim: safe).
    oo = torch.where(col_reset[None, None, :], 0, data.oo)
    head = torch.where(
        promoted_col,
        _set_drop(torch.zeros_like(data.head), torch.where(promote_ok, ps, w_hot),
                  claim_row, w_hot),
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
    del q_dead

    live = dev_writer >= 0
    total = yield exchange.Reduce(
        "rotate", sum=(live.sum(), dev_dropped), any=(live.any(), oo.any())
    )
    stats = {
        "retired": ret_live.sum(),
        "promoted": promote_ok.sum(),
        "dev_entries": total.sum[0],
        "dev_dropped": total.sum[1],
    }
    return (
        SparseState(
            data=data._replace(
                contig=contig, seen=seen, oo=oo,
                oo_any=total.any[1] if cfg.window_k else data.oo_any,
                head=head, q_writer=q_writer,
            ),
            head_full=head_full,
            slot_writer=slot_writer,
            dev_writer=dev_writer,
            dev_contig=dev_contig,
            dev_any=total.any[0],
        ),
        stats,
    )


def cold_sync(state: SparseState, region, alive, partition, cfg: GossipConfig,
              sp: SparseConfig):
    """Heal deviation entries by pulling from each stream's origin node,
    budgeted per node per session, merging the granted versions' CRDT
    cells (reference ``cold_sync``). Sessions run only while deviation
    entries exist. ``_cold_sync`` on one position holding every row."""
    out, stats, _ = exchange.solo(_cold_sync(
        state, region, alive, partition, cfg, sp, exchange.whole(cfg.n_nodes)
    ))
    return out, stats


def _cold_sync(state: SparseState, region, alive, partition, cfg: GossipConfig,
               sp: SparseConfig, pos):
    """``cold_sync`` over one position's rows (``state`` its block;
    ``region``, ``alive`` and ``partition`` whole). While deviation entries
    exist anywhere (the replicated ``dev_any``, so every position takes the
    same branch) it gathers the whole ``head_full`` (one ``Gather``: the
    entries name global writers), heals the position's own entries and
    merges their granted cells on its rows, and ORs the positions'
    remaining entries into the next ``dev_any``. Returns (state, the
    position's ``cold_healed``/``cold_merges`` shares, each wrapped to u32,
    and the gathered ``head_full``, None where the plane was skipped)."""
    dev = state.dev_writer.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if not _branch(state.dev_any):
        return state, {"cold_healed": zero, "cold_merges": zero}, None
    (head_full,) = yield exchange.Gather("head_full", (state.head_full,))
    n = pos.n_local
    rows = slice(pos.row_start, pos.row_start + n)
    dev_w, dev_c = state.dev_writer, state.dev_contig
    k_dev = dev_w.shape[1]
    wsafe = torch.clamp(dev_w, min=0)
    # Reachability of the origin: alive and not partitioned from us.
    ok = (dev_w >= 0) & alive[wsafe] & ~partition[region[rows][:, None], region[wsafe]]
    target = head_full[wsafe]  # [n, K]
    deficit = torch.where(ok, target - torch.minimum(target, dev_c), 0)
    per_e = torch.clamp(deficit, max=sp.cold_chunk)
    cum = torch.cumsum(per_e, dim=1)
    grant = torch.minimum(torch.clamp(sp.cold_budget - (cum - per_e), min=0), per_e)
    del deficit, per_e, cum
    new_c = dev_c + grant
    healed = grant.sum() & MASK

    cells = state.data.cells
    n_merges = zero
    if cfg.n_cells > 0:
        # Enumerate granted (writer, version) pairs into [n, B] and merge
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
        del gcum, e_idx, prev
        cells, n_merges = _merge_versions_dense(cells, None, gw, ver, mask, None, n, cfg)
        del gw, ver, mask
    del grant, wsafe

    # Entries that reached the cold head clear.
    dev_w2 = torch.where(ok & (new_c >= target), -1, dev_w)
    del ok, target
    (dev_any,) = (yield exchange.Reduce("cold", any=((dev_w2 >= 0).any(),))).any
    return (
        state._replace(
            data=state.data._replace(cells=cells),
            dev_writer=dev_w2,
            dev_contig=new_c,
            dev_any=dev_any,
        ),
        {"cold_healed": healed, "cold_merges": n_merges & MASK},
        head_full,
    )


def cold_visibility(state: SparseState, sample_writer, sample_ver) -> torch.Tensor:
    """bool[S, N] visibility of sampled writes against the COLD plane: a
    cold write is held everywhere except at nodes with a deviation entry
    below it. 16 samples at a time bound the [16, N, K] compare. Row-local:
    on a position's block it gives the block's [S, n_local] columns (its
    branch reads the replicated ``dev_any``)."""
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
    return _cold_need_part(state, state.head_full) & MASK


def _cold_need_part(state: SparseState, head_full) -> torch.Tensor:
    """A block's share of ``cold_need`` before the u32 wrap, given the
    whole ``head_full`` (``_cold_sync``'s gather; None where the plane was
    skipped, so no deviation entry exists anywhere)."""
    if head_full is None:
        return torch.zeros((), dtype=torch.int64, device=state.dev_writer.device)
    target = head_full[torch.clamp(state.dev_writer, min=0)]
    lag = torch.where(
        state.dev_writer >= 0, target - torch.minimum(target, state.dev_contig), 0
    )
    return lag.sum()


def serial_merge_reference_sparse(head_full, cfg: GossipConfig, device=None):
    """Ground truth for any-node-writes runs: every committed version
    (w = node id, v <= head_full[w]) merged into one fresh cell state;
    the dense ground truth over the global heads."""
    return serial_merge_reference(head_full, cfg, device)

"""CRDT cell registers (counterpart of corrosion_tpu/ops/crdt.py).

A cell is an LWW register ordered lexicographically by (causal length,
col_version, value_rank): odd ``cl`` is a live row, even a deleted one,
and merges take the max. ``derive_change`` makes a version's content a
pure function of (writer, version, slot), so every replica derives
identical rows. ``apply_changes`` scatter-merges a change batch (the
ground truth ``gossip.serial_merge_reference`` is built on it); the
engines' own merge lives in ``gossip._merge_versions_dense``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASK = 0xFFFFFFFF


class CellState(NamedTuple):
    """Struct-of-arrays LWW register state for K cells (u32 in int64)."""

    cl: torch.Tensor  # [K] causal length of the owning row
    col_version: torch.Tensor  # [K]
    value_rank: torch.Tensor  # [K] orderable value surrogate


class ChangeBatch(NamedTuple):
    """B changes addressed to dense cell keys; ``mask`` marks the live
    entries of a fixed-size batch."""

    key: torch.Tensor  # [B] in [0, K)
    cl: torch.Tensor  # [B]
    col_version: torch.Tensor  # [B]
    value_rank: torch.Tensor  # [B]
    mask: torch.Tensor  # bool[B]


def make_cells(n_cells: int, device=None) -> CellState:
    z = torch.zeros((n_cells,), dtype=torch.int64, device=device)
    return CellState(cl=z, col_version=z.clone(), value_rank=z.clone())


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche over u32 (multiplies wrap mod 2^32)."""
    h = h & MASK
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK
    h = h ^ (h >> 16)
    return h


def derive_change(writer, version, slot: int, n_cells: int):
    """Deterministic change content for (writer, version, cell-slot):
    ``(key, cl, col_version, value_rank)``; ~1/16 of writes are deletes."""
    w = writer & MASK
    v = version & MASK
    h = _mix(
        ((w * 2654435761) & MASK)
        + ((v * 40503) & MASK)
        + ((int(slot) * 2246822519) & MASK)
    )
    key = h % n_cells
    cl = torch.where(h % 16 == 0, 2, 1)
    value_rank = _mix(h + 0x9E3779B9)
    return key, cl, v, value_rank


def _lex_gt(a_cl, a_cv, a_vr, b_cl, b_cv, b_vr):
    """(a_cl, a_cv, a_vr) > (b_cl, b_cv, b_vr) lexicographically."""
    return (
        (a_cl > b_cl)
        | ((a_cl == b_cl) & (a_cv > b_cv))
        | ((a_cl == b_cl) & (a_cv == b_cv) & (a_vr > b_vr))
    )


def merge_cells(local: CellState, incoming: CellState) -> CellState:
    """Elementwise merge of two aligned cell states (replica join)."""
    take = _lex_gt(
        incoming.cl, incoming.col_version, incoming.value_rank,
        local.cl, local.col_version, local.value_rank,
    )
    return CellState(*(torch.where(take, i, lo) for i, lo in zip(incoming, local)))


def _scatter_max(base: torch.Tensor, key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return base.scatter_reduce(0, key, val, "amax", include_self=True)


def apply_changes(state: CellState, batch: ChangeBatch) -> CellState:
    """Scatter-merge a change batch into cell state: the exact
    lexicographic (cl, col_version, value_rank) max per key across the
    batch and the current state, in two scatter-max passes, as the
    reference: (cl << 24) | col_version (exact while cl < 2^8 and
    col_version < 2^24, u32 wraparound kept), then value_rank among the
    entries that match the winner. A masked-out entry contributes 0."""
    k = batch.key
    live = batch.mask
    packed_state = ((state.cl << 24) | state.col_version) & MASK
    packed_in = ((batch.cl << 24) | batch.col_version) & MASK
    p1 = _scatter_max(packed_state, k, torch.where(live, packed_in, 0))
    cl1 = p1 >> 24
    cv1 = p1 & ((1 << 24) - 1)
    # Pass 2: value_rank among the (cl, cv) winners.
    seed = torch.where(p1 == packed_state, state.value_rank, 0)
    in_win = live & (packed_in == p1[k])
    vr1 = _scatter_max(seed, k, torch.where(in_win, batch.value_rank, 0))
    return CellState(cl=cl1, col_version=cv1, value_rank=vr1)


def row_live(state: CellState) -> torch.Tensor:
    """bool[K]: causal-length liveness (odd cl = live)."""
    return (state.cl & 1) == 1


def local_write(state: CellState, key, value_rank) -> CellState:
    """A local UPDATE of one cell: bump col_version, keep cl (at least 1)."""
    key = torch.as_tensor(key, device=state.cl.device).reshape(-1)
    one = torch.ones(key.shape, dtype=torch.int64, device=key.device)
    vr = torch.as_tensor(value_rank, dtype=torch.int64, device=key.device)
    return CellState(
        cl=_scatter_max(state.cl, key, one),
        col_version=state.col_version.index_put((key,), one, accumulate=True) & MASK,
        value_rank=state.value_rank.index_put((key,), vr.expand(key.shape)),
    )


def local_insert_row(state: CellState, keys) -> CellState:
    """(Re-)insert a row: an even cl moves to the next odd value with
    col_version restarting at 1; an already-live row is an upsert whose
    col_version bumps."""
    keys = torch.as_tensor(keys, device=state.cl.device)
    cl = state.cl[keys]
    resurrect = (cl & 1) == 0
    new_cl = torch.where(resurrect, cl + 1, cl) & MASK
    new_cv = torch.where(resurrect, 1, state.col_version[keys] + 1) & MASK
    return CellState(
        cl=state.cl.index_put((keys,), new_cl),
        col_version=state.col_version.index_put((keys,), new_cv),
        value_rank=state.value_rank,
    )


def local_delete_row(state: CellState, keys) -> CellState:
    """Delete a row: an odd cl moves to the next even value; its columns
    reset."""
    keys = torch.as_tensor(keys, device=state.cl.device)
    cl = state.cl[keys]
    zero = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    return CellState(
        cl=state.cl.index_put((keys,), torch.where((cl & 1) == 1, cl + 1, cl) & MASK),
        col_version=state.col_version.index_put((keys,), zero),
        value_rank=state.value_rank.index_put((keys,), zero),
    )

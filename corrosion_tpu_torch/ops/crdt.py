"""CRDT cell registers: the parts of corrosion_tpu/ops/crdt.py the dense
engine's merge needs.

A cell is an LWW register ordered lexicographically by (causal length,
col_version, value_rank); the merge itself lives in
``gossip._merge_versions_dense``. ``derive_change`` makes a version's
content a pure function of (writer, version, slot), so every replica
derives identical rows.
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

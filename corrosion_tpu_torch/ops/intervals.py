"""Fixed-capacity interval-set tensors (counterpart of
corrosion_tpu/ops/intervals.py).

A set of inclusive integer ranges is a pair of tensors ``(starts, ends)``
of capacity C on the last axis, sorted ascending by start, disjoint and
non-adjacent, with empty slots at the back holding ``(EMPTY, EMPTY - 1)``.
Where the reference works on one set and is ``vmap``-ed over rows, every
function here takes any number of leading row axes (``[..., C]``); the
interval bounds ``s``/``e`` broadcast against them. Values are int32 in
the reference and int64 here: every bound stays far inside int32, so no
result differs. Capacity overflow drops the shortest interval (the first
of equal lengths), which under-approximates coverage — the safe direction
for data a node *has*.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch import resolve_device

# Sentinel start of an empty slot: huge so empty slots sort last, two below
# int32 max so ``start - 1`` / ``end + 1`` stay in int32.
EMPTY = 2**31 - 4
_BIG_LEN = 2**31 - 1


class IntervalSet(NamedTuple):
    """Sorted, coalesced, capacity-bounded sets of inclusive ranges."""

    starts: torch.Tensor  # int64[..., C]
    ends: torch.Tensor  # int64[..., C]

    @property
    def capacity(self) -> int:
        return self.starts.shape[-1]


def make(capacity: int, batch: tuple = (), device=None) -> IntervalSet:
    """Empty sets of ``capacity`` slots, one per index of ``batch``."""
    device = resolve_device(device)
    shape = (*batch, capacity)
    return IntervalSet(
        starts=torch.full(shape, EMPTY, dtype=torch.int64, device=device),
        ends=torch.full(shape, EMPTY - 1, dtype=torch.int64, device=device),
    )


def from_ranges(ranges, capacity: int, device=None) -> IntervalSet:
    """One set from ``[(start, end), ...]``, inserted in order."""
    iv = make(capacity, device=device)
    for s, e in ranges:
        iv = insert(iv, s, e)
    return iv


def _bound(x, like: torch.Tensor) -> torch.Tensor:
    """An interval bound as int64 on ``like``'s device, with a trailing
    axis to broadcast against the slots."""
    return torch.as_tensor(x, dtype=torch.int64, device=like.device)[..., None]


def slot_mask(iv: IntervalSet) -> torch.Tensor:
    """bool[..., C]: which slots hold a real interval."""
    return iv.starts <= iv.ends


def count(iv: IntervalSet) -> torch.Tensor:
    return slot_mask(iv).sum(-1)


def total(iv: IntervalSet) -> torch.Tensor:
    """Number of integers covered by each set."""
    return torch.where(slot_mask(iv), iv.ends - iv.starts + 1, 0).sum(-1)


def is_empty(iv: IntervalSet) -> torch.Tensor:
    return ~slot_mask(iv).any(-1)


def max_end(iv: IntervalSet) -> torch.Tensor:
    """Largest covered integer, or -1 when empty."""
    return torch.where(slot_mask(iv), iv.ends, -1).amax(-1)


def min_start(iv: IntervalSet) -> torch.Tensor:
    """Smallest covered integer, or EMPTY when empty."""
    return iv.starts.amin(-1)


def contains(iv: IntervalSet, x) -> torch.Tensor:
    x = _bound(x, iv.starts)
    return (slot_mask(iv) & (iv.starts <= x) & (x <= iv.ends)).any(-1)


def contains_range(iv: IntervalSet, s, e) -> torch.Tensor:
    """True iff [s, e] lies entirely inside one interval of the set."""
    s, e = _bound(s, iv.starts), _bound(e, iv.starts)
    return (slot_mask(iv) & (iv.starts <= s) & (e <= iv.ends)).any(-1)


def _sorted_by_start(starts: torch.Tensor, ends: torch.Tensor):
    # Stable, as ``jnp.argsort``.
    order = torch.argsort(starts, dim=-1, stable=True)
    return starts.gather(-1, order), ends.gather(-1, order)


def _compact(starts, ends, capacity: int, max_extra: int = 1) -> IntervalSet:
    """Sort candidate slots, resolving overflow by dropping the shortest
    interval (``argmin``: the first of equal lengths in candidate order).
    ``max_extra`` bounds how far the live count can exceed ``capacity``
    (1 for both insert and remove)."""
    valid = starts <= ends
    starts = torch.where(valid, starts, EMPTY)
    ends = torch.where(valid, ends, EMPTY - 1)
    slots = torch.arange(starts.shape[-1], device=starts.device)
    for _ in range(max(1, max_extra)):
        live = starts <= ends
        overflow = live.sum(-1, keepdim=True) > capacity
        lengths = torch.where(live, ends - starts + 1, _BIG_LEN)
        drop = torch.argmin(lengths, dim=-1, keepdim=True)
        kill = overflow & (slots == drop)
        starts = torch.where(kill, EMPTY, starts)
        ends = torch.where(kill, EMPTY - 1, ends)
    starts, ends = _sorted_by_start(starts, ends)
    return IntervalSet(starts[..., :capacity], ends[..., :capacity])


def insert(iv: IntervalSet, s, e) -> IntervalSet:
    """Insert [s, e], coalescing overlapping and adjacent intervals. The
    candidates are the untouched slots followed by the merged one."""
    s, e = _bound(s, iv.starts), _bound(e, iv.starts)
    touch = slot_mask(iv) & (iv.starts <= e + 1) & (iv.ends >= s - 1)
    merged_s = torch.minimum(
        s, torch.where(touch, iv.starts, EMPTY).amin(-1, keepdim=True)
    )
    merged_e = torch.maximum(
        e, torch.where(touch, iv.ends, -(2**31) + 1).amax(-1, keepdim=True)
    )
    cat_s = torch.cat([torch.where(touch, EMPTY, iv.starts), merged_s], -1)
    cat_e = torch.cat([torch.where(touch, EMPTY - 1, iv.ends), merged_e], -1)
    return _compact(cat_s, cat_e, iv.capacity)


def remove(iv: IntervalSet, s, e) -> IntervalSet:
    """Remove [s, e]; an interval spanning both edges splits in two. The
    candidates are every slot's left piece, then every slot's right
    piece."""
    s, e = _bound(s, iv.starts), _bound(e, iv.starts)
    m = slot_mask(iv)
    left_e = torch.minimum(iv.ends, s - 1)
    lv = m & (iv.starts <= left_e)
    right_s = torch.maximum(iv.starts, e + 1)
    rv = m & (right_s <= iv.ends)
    cat_s = torch.cat(
        [torch.where(lv, iv.starts, EMPTY), torch.where(rv, right_s, EMPTY)], -1
    )
    cat_e = torch.cat(
        [torch.where(lv, left_e, EMPTY - 1), torch.where(rv, iv.ends, EMPTY - 1)], -1
    )
    return _compact(cat_s, cat_e, iv.capacity)


def gaps(iv: IntervalSet, s, e) -> IntervalSet:
    """Sub-ranges of [s, e] NOT covered by the set, at capacity C + 1:
    the gap before each clipped slot, then the tail gap."""
    batch = (*iv.starts.shape[:-1], 1)
    s, e = _bound(s, iv.starts).expand(batch), _bound(e, iv.starts).expand(batch)
    inter = slot_mask(iv) & (iv.starts <= e) & (iv.ends >= s)
    cs = torch.where(inter, torch.maximum(iv.starts, s), EMPTY)
    ce = torch.where(inter, torch.minimum(iv.ends, e), EMPTY - 1)
    cs, ce = _sorted_by_start(cs, ce)
    g_s = torch.cat([s - 1, ce], -1) + 1
    g_e = torch.cat([cs, e + 1], -1) - 1
    n_real = inter.sum(-1, keepdim=True)
    idx = torch.arange(iv.capacity + 1, device=iv.starts.device)
    g_e = torch.where(idx == n_real, e, g_e)  # the tail gap ends at e
    valid = (idx <= n_real) & (g_s <= g_e)
    return IntervalSet(*_sorted_by_start(
        torch.where(valid, g_s, EMPTY), torch.where(valid, g_e, EMPTY - 1)
    ))


def select(mask: torch.Tensor, new: IntervalSet, old: IntervalSet) -> IntervalSet:
    """Per-set choice: ``new`` where ``mask[...]``, else ``old``."""
    m = mask[..., None]
    return IntervalSet(
        torch.where(m, new.starts, old.starts), torch.where(m, new.ends, old.ends)
    )


def union(a: IntervalSet, b: IntervalSet) -> IntervalSet:
    """a ∪ b at a's capacity: b's real slots inserted one by one."""
    out = a
    for j in range(b.capacity):
        s, e = b.starts[..., j], b.ends[..., j]
        out = select(s <= e, insert(out, s, e), out)
    return out


def contiguous_watermark(iv: IntervalSet, base) -> torch.Tensor:
    """Highest v such that [base, v] is fully covered (base - 1 if none):
    one pass over the sorted slots."""
    wm = torch.as_tensor(base, dtype=torch.int64, device=iv.starts.device) - 1
    wm = wm.expand(iv.starts.shape[:-1])
    for j in range(iv.capacity):
        s, e = iv.starts[..., j], iv.ends[..., j]
        wm = torch.where((s <= wm + 1) & (e > wm), e, wm)
    return wm


def to_host(iv: IntervalSet):
    """The set as ``[(start, end), ...]``; a list of such lists per leading
    index when batched (testing and debugging)."""
    starts, ends = iv.starts.cpu().tolist(), iv.ends.cpu().tolist()

    def one(ss, es):
        if ss and isinstance(ss[0], list):
            return [one(a, b) for a, b in zip(ss, es)]
        return [(s, e) for s, e in zip(ss, es) if s <= e]

    return one(starts, ends)

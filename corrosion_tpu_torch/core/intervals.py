"""Inclusive integer interval sets and maps.

Host-side equivalent of the `rangemap` crate (RangeInclusiveSet /
RangeInclusiveMap) that the reference leans on for version bookkeeping
(corro-types/agent.rs:945-1052) and sync-need computation
(corro-types/sync.rs:123-246). The simulator uses fixed-capacity interval
tensors instead (corrosion_tpu_torch.ops.intervals); differential tests
assert the two implementations agree. Counterpart of
corrosion_tpu/core/intervals.py.

Ranges are inclusive [start, end] over ints. Adjacent ranges coalesce
([1,3] + [4,5] -> [1,5]); for the map, only when their values are equal.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Any, Iterable, Iterator


class RangeSet:
    """Sorted, coalesced set of inclusive integer ranges."""

    __slots__ = ("_starts", "_ends")

    def __init__(self, ranges: Iterable[tuple[int, int]] = ()) -> None:
        self._starts: list[int] = []
        self._ends: list[int] = []
        for s, e in ranges:
            self.insert(s, e)

    def __bool__(self) -> bool:
        return bool(self._starts)

    def __len__(self) -> int:
        return len(self._starts)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RangeSet):
            return NotImplemented
        return self._starts == other._starts and self._ends == other._ends

    def __iter__(self) -> Iterator[tuple[int, int]]:
        return iter(zip(self._starts, self._ends))

    def __repr__(self) -> str:
        return f"RangeSet({list(self)})"

    def copy(self) -> "RangeSet":
        rs = RangeSet()
        rs._starts = self._starts.copy()
        rs._ends = self._ends.copy()
        return rs

    def insert(self, start: int, end: int) -> None:
        if end < start:
            raise ValueError(f"invalid range [{start}, {end}]")
        # Find all existing ranges overlapping or adjacent to [start-1, end+1]
        # and merge them into one.
        lo = bisect_left(self._ends, start - 1)
        hi = bisect_right(self._starts, end + 1)
        if lo < hi:
            start = min(start, self._starts[lo])
            end = max(end, self._ends[hi - 1])
        self._starts[lo:hi] = [start]
        self._ends[lo:hi] = [end]

    def remove(self, start: int, end: int) -> None:
        if end < start:
            raise ValueError(f"invalid range [{start}, {end}]")
        lo = bisect_left(self._ends, start)
        hi = bisect_right(self._starts, end)
        if lo >= hi:
            return
        new_starts: list[int] = []
        new_ends: list[int] = []
        if self._starts[lo] < start:
            new_starts.append(self._starts[lo])
            new_ends.append(start - 1)
        if self._ends[hi - 1] > end:
            new_starts.append(end + 1)
            new_ends.append(self._ends[hi - 1])
        self._starts[lo:hi] = new_starts
        self._ends[lo:hi] = new_ends

    def contains(self, x: int) -> bool:
        i = bisect_left(self._ends, x)
        return i < len(self._starts) and self._starts[i] <= x

    def contains_range(self, start: int, end: int) -> bool:
        i = bisect_left(self._ends, start)
        return i < len(self._starts) and self._starts[i] <= start and end <= self._ends[i]

    def gaps(self, start: int, end: int) -> Iterator[tuple[int, int]]:
        """Sub-ranges of [start, end] not covered by this set."""
        cursor = start
        i = bisect_left(self._ends, start)
        while cursor <= end and i < len(self._starts):
            s, e = self._starts[i], self._ends[i]
            if s > end:
                break
            if s > cursor:
                yield (cursor, s - 1)
            cursor = max(cursor, e + 1)
            i += 1
        if cursor <= end:
            yield (cursor, end)

    def max_end(self) -> int | None:
        return self._ends[-1] if self._ends else None

    def total(self) -> int:
        return sum(e - s + 1 for s, e in self)


class RangeMap:
    """Sorted map of disjoint inclusive ranges to values.

    Inserting overwrites any overlapped portion of existing ranges (rangemap
    RangeInclusiveMap semantics). Adjacent ranges with equal values coalesce.
    """

    __slots__ = ("_starts", "_ends", "_values")

    def __init__(self, items: Iterable[tuple[int, int, Any]] = ()) -> None:
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._values: list[Any] = []
        for s, e, v in items:
            self.insert(s, e, v)

    def __bool__(self) -> bool:
        return bool(self._starts)

    def __len__(self) -> int:
        return len(self._starts)

    def __iter__(self) -> Iterator[tuple[int, int, Any]]:
        return iter(zip(self._starts, self._ends, self._values))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RangeMap):
            return NotImplemented
        return list(self) == list(other)

    def __repr__(self) -> str:
        return f"RangeMap({list(self)})"

    def insert(self, start: int, end: int, value: Any) -> None:
        if end < start:
            raise ValueError(f"invalid range [{start}, {end}]")
        lo = bisect_left(self._ends, start)
        hi = bisect_right(self._starts, end)
        new: list[tuple[int, int, Any]] = []
        if lo < hi:
            s0, e0, v0 = self._starts[lo], self._ends[lo], self._values[lo]
            if s0 < start:
                new.append((s0, start - 1, v0))
            s1, e1, v1 = self._starts[hi - 1], self._ends[hi - 1], self._values[hi - 1]
            if e1 > end:
                new.append((end + 1, e1, v1))
        # splice in the new range between any preserved fragments
        new.append((start, end, value))
        new.sort(key=lambda t: t[0])
        self._starts[lo:hi] = [t[0] for t in new]
        self._ends[lo:hi] = [t[1] for t in new]
        self._values[lo:hi] = [t[2] for t in new]
        self._coalesce_around(lo, lo + len(new))

    def _coalesce_around(self, lo: int, hi: int) -> None:
        i = max(0, lo - 1)
        while i < len(self._starts) - 1 and i <= hi:
            if (
                self._ends[i] + 1 == self._starts[i + 1]
                and self._values[i] == self._values[i + 1]
            ):
                self._ends[i] = self._ends[i + 1]
                del self._starts[i + 1], self._ends[i + 1], self._values[i + 1]
                hi -= 1
            else:
                i += 1

    def remove(self, start: int, end: int) -> None:
        if end < start:
            raise ValueError(f"invalid range [{start}, {end}]")
        lo = bisect_left(self._ends, start)
        hi = bisect_right(self._starts, end)
        if lo >= hi:
            return
        new: list[tuple[int, int, Any]] = []
        if self._starts[lo] < start:
            new.append((self._starts[lo], start - 1, self._values[lo]))
        if self._ends[hi - 1] > end:
            new.append((end + 1, self._ends[hi - 1], self._values[hi - 1]))
        self._starts[lo:hi] = [t[0] for t in new]
        self._ends[lo:hi] = [t[1] for t in new]
        self._values[lo:hi] = [t[2] for t in new]

    def get(self, x: int) -> Any | None:
        i = bisect_left(self._ends, x)
        if i < len(self._starts) and self._starts[i] <= x:
            return self._values[i]
        return None

    def get_range(self, x: int) -> tuple[int, int, Any] | None:
        i = bisect_left(self._ends, x)
        if i < len(self._starts) and self._starts[i] <= x:
            return (self._starts[i], self._ends[i], self._values[i])
        return None

    def overlapping(self, start: int, end: int) -> Iterator[tuple[int, int, Any]]:
        i = bisect_left(self._ends, start)
        while i < len(self._starts) and self._starts[i] <= end:
            yield (self._starts[i], self._ends[i], self._values[i])
            i += 1

    def max_end(self) -> int | None:
        return self._ends[-1] if self._ends else None

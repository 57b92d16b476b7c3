"""Version bookkeeping + sync-need computation (host side).

Faithful re-implementation of the reference's replication bookkeeping:

- ``KnownDbVersion`` variants and ``BookedVersions`` with its
  cleared/current/partials tri-state and the ``sync_need`` gap set
  (reference corro-types/src/agent.rs:580-591, 945-1052; ``insert_many``
  semantics at agent.rs:1009-1047).
- ``SyncState`` — heads / need / partial_need — and
  ``compute_available_needs`` (the version-vector diff that drives every
  anti-entropy session; reference corro-types/src/sync.rs:77-246), plus
  ``generate_sync`` (sync.rs:276-323).

Tested against translations of the reference's own unit vectors
(sync.rs:376-491) in tests/test_bookkeeping.py, and this copy against
the reference's in tests/test_torch_core.py. The simulator's sync plane
models the same math batched (ops/gossip.py sync_round; ops/chunks.py
partial needs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from .intervals import RangeSet


@dataclass(frozen=True)
class Current:
    """A fully-applied version (agent.rs:897-905)."""

    db_version: int
    last_seq: int
    ts: int


@dataclass
class Partial:
    """A partially-buffered version: seq coverage + the final seq
    (agent.rs:907-914)."""

    seqs: RangeSet
    last_seq: int
    ts: int

    def is_complete(self) -> bool:
        return self.seqs.contains_range(0, self.last_seq)

    def gaps(self) -> list[tuple[int, int]]:
        return list(self.seqs.gaps(0, self.last_seq))


class Cleared:
    """Marker for compacted/emptied versions (KnownDbVersion::Cleared)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Cleared"


CLEARED = Cleared()
KnownDbVersion = Current | Partial | Cleared


class BookedVersions:
    """Per-actor version -> {Cleared, Current, Partial} map with gap
    tracking (reference agent.rs:945-1052)."""

    __slots__ = ("cleared", "current", "partials", "_sync_need", "_last")

    def __init__(self) -> None:
        self.cleared = RangeSet()
        self.current: dict[int, Current] = {}
        self.partials: dict[int, Partial] = {}
        self._sync_need = RangeSet()
        self._last: int | None = None

    # -- queries (agent.rs:958-1007) ---------------------------------------

    def contains_version(self, version: int) -> bool:
        return (
            self.cleared.contains(version)
            or version in self.current
            or version in self.partials
        )

    def get(self, version: int) -> KnownDbVersion | None:
        if self.cleared.contains(version):
            return CLEARED
        if version in self.current:
            return self.current[version]
        if version in self.partials:
            return self.partials[version]
        return None

    def contains(self, version: int, seqs: tuple[int, int] | None = None) -> bool:
        if not self.contains_version(version):
            return False
        if seqs is None:
            return True
        known = self.get(version)
        if isinstance(known, Partial):
            return known.seqs.contains_range(seqs[0], seqs[1])
        return True  # Cleared / Current hold every seq

    def contains_all(
        self, versions: tuple[int, int], seqs: tuple[int, int] | None = None
    ) -> bool:
        return all(
            self.contains(v, seqs) for v in range(versions[0], versions[1] + 1)
        )

    def last(self) -> int | None:
        return self._last

    def current_versions(self) -> dict[int, int]:
        """db_version -> version (agent.rs:994-999)."""
        return {c.db_version: v for v, c in self.current.items()}

    # -- mutation (agent.rs:1005-1047) -------------------------------------

    def insert(self, version: int, known: KnownDbVersion) -> None:
        self.insert_many(version, version, known)

    def insert_many(self, start: int, end: int, known: KnownDbVersion) -> None:
        """Record [start, end] as ``known``; track gaps below ``start`` as
        sync need — exactly insert_many (agent.rs:1009-1047): Partial/Current
        apply to ``start`` only (single-version callers), Cleared applies to
        the whole range."""
        if isinstance(known, Partial):
            self.partials[start] = known
        elif isinstance(known, Current):
            self.partials.pop(start, None)
            self.current[start] = known
        else:  # Cleared
            for v in range(start, end + 1):
                self.partials.pop(v, None)
                self.current.pop(v, None)
            self.cleared.insert(start, end)

        old_last = self._last if self._last is not None else 0
        self._last = max(end, old_last)
        if old_last < start:
            # Versions we skipped over are needed (agent.rs:1038-1043).
            self._sync_need.insert(old_last + 1, start)
        self._sync_need.remove(start, end)

    def sync_need(self) -> RangeSet:
        return self._sync_need


@dataclass
class SyncState:
    """heads / need / partial_need per actor (sync.rs:77-83)."""

    actor_id: str = ""
    heads: dict[str, int] = field(default_factory=dict)
    need: dict[str, list[tuple[int, int]]] = field(default_factory=dict)
    partial_need: dict[str, dict[int, list[tuple[int, int]]]] = field(
        default_factory=dict
    )

    def need_len(self) -> int:
        """sync.rs:86-105 (partial ranges are counted as chunks / 50)."""
        full = sum(
            e - s + 1 for ranges in self.need.values() for s, e in ranges
        )
        partial_seqs = sum(
            e - s + 1
            for partials in self.partial_need.values()
            for ranges in partials.values()
            for s, e in ranges
        )
        return full + partial_seqs // 50

    def need_len_for_actor(self, actor_id: str) -> int:
        """sync.rs:107-121."""
        return sum(
            e - s + 1 for s, e in self.need.get(actor_id, [])
        ) + len(self.partial_need.get(actor_id, {}))

    def compute_available_needs(
        self, other: "SyncState"
    ) -> dict[str, list["SyncNeed"]]:
        """What ``other`` can serve us: the version-vector diff at the heart
        of every sync session (sync.rs:123-246)."""
        needs: dict[str, list[SyncNeed]] = {}

        for actor_id, head in other.heads.items():
            if actor_id == self.actor_id or head == 0:
                continue

            # Versions `other` FULLY has: [1, head] minus its needs and its
            # partials (sync.rs:139-161).
            other_haves = RangeSet([(1, head)])
            for s, e in other.need.get(actor_id, []):
                other_haves.remove(s, e)
            for v in other.partial_need.get(actor_id, {}):
                other_haves.remove(v, v)

            # Full needs of ours they can serve (sync.rs:163-174).
            for rs, re_ in self.need.get(actor_id, []):
                for hs, he in other_haves:
                    if hs > re_ or he < rs:
                        continue
                    needs.setdefault(actor_id, []).append(
                        FullNeed(max(rs, hs), min(re_, he))
                    )

            # Partial needs (sync.rs:176-228).
            for v, seqs in self.partial_need.get(actor_id, {}).items():
                if other_haves.contains(v):
                    needs.setdefault(actor_id, []).append(
                        PartialNeed(v, list(seqs))
                    )
                else:
                    other_seqs = other.partial_need.get(actor_id, {}).get(v)
                    if other_seqs is None:
                        continue
                    max_other = max((e for _, e in other_seqs), default=None)
                    max_ours = max((e for _, e in seqs), default=None)
                    ends = [x for x in (max_other, max_ours) if x is not None]
                    if not ends:
                        continue
                    end = max(ends)
                    # Seqs `other` has within its partial (sync.rs:196-204).
                    other_seq_haves = RangeSet([(0, end)])
                    for s, e in other_seqs:
                        other_seq_haves.remove(s, e)
                    overlap = [
                        (max(rs, hs), min(re_, he))
                        for rs, re_ in seqs
                        for hs, he in other_seq_haves
                        if hs <= re_ and he >= rs
                    ]
                    if overlap:
                        needs.setdefault(actor_id, []).append(
                            PartialNeed(v, overlap)
                        )

            # Head gap (sync.rs:230-243).
            our_head = self.heads.get(actor_id)
            if our_head is None:
                needs.setdefault(actor_id, []).append(FullNeed(1, head))
            elif head > our_head:
                needs.setdefault(actor_id, []).append(
                    FullNeed(our_head + 1, head)
                )

        return needs


@dataclass(frozen=True)
class FullNeed:
    """SyncNeedV1::Full (sync.rs:248-251)."""

    start: int
    end: int

    def count(self) -> int:
        return self.end - self.start + 1


@dataclass(frozen=True)
class PartialNeed:
    """SyncNeedV1::Partial (sync.rs:252-257)."""

    version: int
    seqs: list[tuple[int, int]]

    def count(self) -> int:
        return 1


SyncNeed = FullNeed | PartialNeed


class Bookie:
    """actor_id -> BookedVersions (reference agent.rs:1129-1170, sans the
    counted-lock wrapper — the host agent is single-threaded per node)."""

    def __init__(self) -> None:
        self._by_actor: dict[str, BookedVersions] = {}

    def for_actor(self, actor_id: str) -> BookedVersions:
        return self._by_actor.setdefault(actor_id, BookedVersions())

    def get(self, actor_id: str) -> BookedVersions | None:
        return self._by_actor.get(actor_id)

    def items(self) -> Iterable[tuple[str, BookedVersions]]:
        return self._by_actor.items()


def generate_sync(bookie: Bookie, actor_id: str) -> SyncState:
    """Build our SyncState to open a session (sync.rs:276-323)."""
    state = SyncState(actor_id=actor_id)
    for other_id, booked in bookie.items():
        last = booked.last()
        if last is None:
            continue
        need = list(booked.sync_need())
        if need:
            state.need[other_id] = need
        for v, partial in booked.partials.items():
            state.partial_need.setdefault(other_id, {})[v] = partial.gaps()
        state.heads[other_id] = last
    return state

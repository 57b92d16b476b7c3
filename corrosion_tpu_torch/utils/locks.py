"""Lock registry: labeled, age-tracked lock diagnostics.

The reference wraps every Bookie/Booked lock in a CountedTokioRwLock whose
registry records label, kind, state, and age, surfaced live by `corrosion
locks --top N` for production deadlock/contention diagnosis
(corro-types/src/agent.rs:593-893, corro-admin/src/lib.rs:186-207). Same
contract here: the store's writer lock and any agent-level critical section
register acquisitions; the admin RPC serves ranked snapshots.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

ACQUIRING, LOCKED = "acquiring", "locked"


@dataclass
class LockMeta:
    id: int
    label: str
    kind: str  # read | write
    state: str
    started_at: float

    def age_ms(self) -> float:
        return (time.monotonic() - self.started_at) * 1000.0


class LockRegistry:
    """Tracks in-flight lock acquisitions (LockRegistry, agent.rs:720-869)."""

    def __init__(self) -> None:
        self._seq = itertools.count(1)
        self._live: dict[int, LockMeta] = {}
        self._guard = threading.Lock()

    @contextmanager
    def acquire(self, lock: threading.Lock, label: str, kind: str = "write"):
        meta = LockMeta(
            id=next(self._seq), label=label, kind=kind,
            state=ACQUIRING, started_at=time.monotonic(),
        )
        with self._guard:
            self._live[meta.id] = meta
        lock.acquire()
        meta.state = LOCKED
        meta.started_at = time.monotonic()
        try:
            yield
        finally:
            lock.release()
            with self._guard:
                self._live.pop(meta.id, None)

    def snapshot(self, top: int = 10) -> list[dict]:
        """Longest-held/waited first (`corrosion locks --top N`)."""
        with self._guard:
            metas = list(self._live.values())
        metas.sort(key=lambda m: -m.age_ms())
        return [
            {
                "id": m.id,
                "label": m.label,
                "kind": m.kind,
                "state": m.state,
                "age_ms": round(m.age_ms(), 1),
            }
            for m in metas[:top]
        ]

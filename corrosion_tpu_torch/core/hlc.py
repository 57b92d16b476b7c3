"""Hybrid logical clock.

Equivalent of the `uhlc` crate used by the reference (corro-types
broadcast.rs:223-319 wraps uhlc's NTP64 Timestamp; the agent builds its HLC
with a 300 ms max clock delta, agent.rs:281-289).

Encoding: a Timestamp is a u64 = (physical_millis << LOGICAL_BITS) | logical
counter (20 bits ≈ 1M logical ticks per millisecond; 44 physical bits cover
several centuries). Comparisons are plain integer comparisons, so timestamps
totally order events across the cluster; ties are broken by actor id at use
sites.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

LOGICAL_BITS = 20
LOGICAL_MASK = (1 << LOGICAL_BITS) - 1
MAX_U64 = (1 << 64) - 1

# Reject remote timestamps further than this ahead of our physical clock
# (uhlc delta; reference uses 300 ms, agent.rs:285).
DEFAULT_MAX_DELTA_MS = 300


def make_ts(physical_ms: int, logical: int = 0) -> int:
    return ((physical_ms << LOGICAL_BITS) | (logical & LOGICAL_MASK)) & MAX_U64


def ts_physical_ms(ts: int) -> int:
    return ts >> LOGICAL_BITS


def ts_logical(ts: int) -> int:
    return ts & LOGICAL_MASK


def ts_to_string(ts: int) -> str:
    return f"{ts_physical_ms(ts)}:{ts_logical(ts)}"


def ts_from_string(s: str) -> int:
    phys, _, logical = s.partition(":")
    return make_ts(int(phys), int(logical or 0))


class ClockDriftError(Exception):
    def __init__(self, ts: int, now_ms: int, max_delta_ms: int):
        super().__init__(
            f"remote timestamp {ts_to_string(ts)} is more than "
            f"{max_delta_ms}ms ahead of local clock ({now_ms}ms)"
        )
        self.ts = ts


@dataclass
class HLC:
    """Thread-safe hybrid logical clock."""

    max_delta_ms: int = DEFAULT_MAX_DELTA_MS
    _last: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def _now_ms(self) -> int:
        return time.time_ns() // 1_000_000

    def new_timestamp(self) -> int:
        """Monotonic local timestamp: max(wall clock, last+1 logical)."""
        with self._lock:
            wall = make_ts(self._now_ms())
            self._last = wall if wall > self._last else self._last + 1
            return self._last

    def update_with_timestamp(self, ts: int) -> None:
        """Merge a remote timestamp (sync clock exchange, peer.rs:1306-1325).

        Raises ClockDriftError when the remote clock is too far ahead.
        """
        with self._lock:
            now_ms = self._now_ms()
            if ts_physical_ms(ts) > now_ms + self.max_delta_ms:
                raise ClockDriftError(ts, now_ms, self.max_delta_ms)
            if ts > self._last:
                self._last = ts

    @property
    def last(self) -> int:
        with self._lock:
            return self._last

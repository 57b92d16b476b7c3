"""Exponential backoff iterator with jitter.

Equivalent of the reference's crates/backoff (lib.rs:7-150): an iterator of
wait durations growing by ``factor`` from ``min_wait`` to ``max_wait``, with
optional full jitter, and an optional cap on the number of retries.

``seed`` makes the jitter deterministic (chaos/regression tests pin the
exact wait sequence); ``on_wait`` is an observability hook called with
each yielded wait — the agent wires it to
``corro_peer_backoff_retries_total`` so retry pressure is visible on
/metrics instead of only in debug logs.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Backoff:
    """Iterator of backoff delays in seconds."""

    min_wait: float = 1.0
    max_wait: float = 60.0
    factor: float = 2.0
    jitter: bool = True
    max_retries: int | None = None
    seed: int | None = None
    on_wait: Callable[[float], None] | None = None
    _attempt: int = field(default=0, repr=False)
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def __post_init__(self) -> None:
        if self.seed is not None:
            self._rng = random.Random(self.seed)

    def __iter__(self) -> "Backoff":
        return self

    def __next__(self) -> float:
        if self.max_retries is not None and self._attempt >= self.max_retries:
            raise StopIteration
        wait = min(self.max_wait, self.min_wait * (self.factor**self._attempt))
        self._attempt += 1
        if self.jitter:
            # Full jitter in [min_wait, wait] keeps retries spread out while
            # never hammering faster than the configured floor.
            wait = self._rng.uniform(self.min_wait, max(self.min_wait, wait))
        if self.on_wait is not None:
            self.on_wait(wait)
        return wait

    def reset(self) -> None:
        self._attempt = 0

"""Graceful-shutdown primitive.

Equivalent of the reference's crates/tripwire (tripwire.rs:21-174): a future
that resolves when shutdown is requested (signal or programmatic), plus helpers
to run work preemptibly — ``outcome`` distinguishes completed work from
preempted work like the reference's ``Outcome::{Completed, Preempted}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
from dataclasses import dataclass
from typing import Any, Awaitable, Literal


@dataclass
class Outcome:
    kind: Literal["completed", "preempted"]
    value: Any = None

    @property
    def completed(self) -> bool:
        return self.kind == "completed"

    @property
    def preempted(self) -> bool:
        return self.kind == "preempted"


class Tripwire:
    """One-shot shutdown latch shareable across tasks."""

    def __init__(self) -> None:
        self._event = asyncio.Event()

    @classmethod
    def new_signals(cls) -> "Tripwire":
        """Trip on SIGINT/SIGTERM, like Tripwire::new_signals (tripwire.rs:54)."""
        tw = cls()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, tw.trip)
        return tw

    def trip(self) -> None:
        self._event.set()

    @property
    def tripped(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        await self._event.wait()

    async def preemptible(self, aw: Awaitable[Any]) -> Outcome:
        """Run ``aw`` until completion or until the tripwire fires."""
        task = asyncio.ensure_future(aw)
        waiter = asyncio.ensure_future(self._event.wait())
        done, _ = await asyncio.wait(
            {task, waiter}, return_when=asyncio.FIRST_COMPLETED
        )
        if task in done:
            waiter.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await waiter
            return Outcome("completed", task.result())
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task
        return Outcome("preempted")


async def timeout(aw: Awaitable[Any], seconds: float) -> Any:
    """TimeoutFutureExt equivalent — plain asyncio.wait_for wrapper."""
    return await asyncio.wait_for(aw, seconds)

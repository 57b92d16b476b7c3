"""Counted task spawning with drain-on-shutdown.

Equivalent of the reference's crates/spawn (lib.rs:13-134): every spawned task
is registered; ``wait_for_all_pending_handles`` polls until all tasks finish
(100 ms poll, capped wait), doubling as a task-leak detector in tests.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Coroutine

log = logging.getLogger(__name__)


class TaskRegistry:
    """Tracks live tasks; global default instance mirrors PENDING_HANDLES."""

    def __init__(self) -> None:
        self._tasks: set[asyncio.Task] = set()

    def spawn(
        self, coro: Coroutine[Any, Any, Any] | Awaitable[Any], name: str | None = None
    ) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        if name:
            task.set_name(name)
        self._tasks.add(task)
        task.add_done_callback(self._on_done)
        return task

    def _on_done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if not task.cancelled():
            exc = task.exception()
            if exc is not None:
                log.error("task %s failed: %r", task.get_name(), exc)

    @property
    def pending(self) -> int:
        return len(self._tasks)

    async def wait_for_all_pending_handles(self, cap: float = 60.0) -> bool:
        """Poll every 100 ms until no tasks remain or ``cap`` seconds elapse.

        Returns True if fully drained (spawn/lib.rs:116-134 semantics).
        """
        waited = 0.0
        while self._tasks and waited < cap:
            await asyncio.sleep(0.1)
            waited += 0.1
        if self._tasks:
            log.warning(
                "shutdown cap reached with %d pending tasks: %s",
                len(self._tasks),
                [t.get_name() for t in self._tasks],
            )
            return False
        return True

    async def cancel_all(self) -> None:
        for task in list(self._tasks):
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


GLOBAL = TaskRegistry()
spawn_counted = GLOBAL.spawn
wait_for_all_pending_handles = GLOBAL.wait_for_all_pending_handles

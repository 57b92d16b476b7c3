"""SplitPool: 1 serialized writer + a read-connection pool + 3-tier write
priority queues.

The reference's SplitPool (corro-types/src/agent.rs:353-578) holds one
read-write connection behind three bounded priority queues (low 1024 /
normal 512 / high 256) plus a global write semaphore, and a 20-connection
read-only pool. This is its asyncio shape around our Store:

- Writes are closures executed one at a time on a dedicated writer thread,
  admitted through three bounded queues drained strictly high → normal →
  low (``write_priority`` ≈ the API write path, ``write_normal`` ≈ change
  ingest, ``write_low`` ≈ background compaction/empties).
- Reads run on a pool of ``read_conns`` extra read-only connections
  (WAL snapshot isolation) under a semaphore, in worker threads, so big
  queries never block the event loop or the writer.

Counterpart of corrosion_tpu/agent/pool.py.
"""

from __future__ import annotations

import asyncio
import sqlite3
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

from corrosion_tpu_torch import native
from corrosion_tpu_torch.agent.store import Store
from corrosion_tpu_torch.core.values import Statement

HIGH, NORMAL, LOW = 0, 1, 2
QUEUE_DEPTHS = {HIGH: 256, NORMAL: 512, LOW: 1024}  # agent.rs:399-421


@dataclass
class _Job:
    fn: Callable[[], Any]
    future: asyncio.Future


class SplitPool:
    """Async facade over a Store: serialized prioritized writes + pooled
    snapshot reads.

    **Backpressure contract** (deterministic; the write-storm tests pin
    it): when a priority class's bounded queue is full, ``write`` BLOCKS
    the caller in ``Queue.put`` until the writer drains a slot — it
    never sheds, drops, or reorders within a class. Load-shed is the API
    layer's job (``RouteLimit`` 503s *before* work is accepted); once a
    write is admitted past admission control it is executed, in FIFO
    order within its class, with queue-full pressure propagating to the
    producer as await-time. ``queue_depths`` overrides the per-class
    bounds (tests shrink them to make the blocking observable).
    """

    def __init__(
        self, store: Store, read_conns: int = 20,
        queue_depths: dict[int, int] | None = None,
    ) -> None:
        self.store = store
        self.metrics = None  # optional MetricsRegistry (agent wires it)
        self._exec_hist = None  # resolved lazily from the registry
        self._queue_hist = None
        self._queues = {
            p: asyncio.Queue(maxsize=d)
            # Merge, don't replace: a partial override must leave the
            # other priority classes at their defaults, not KeyError at
            # the first write to an un-listed class.
            for p, d in {**QUEUE_DEPTHS, **(queue_depths or {})}.items()
        }
        self._kick = asyncio.Event()
        self._writer_task: asyncio.Task | None = None
        self._read_sem = asyncio.Semaphore(read_conns)
        self._read_pool: list[sqlite3.Connection] = []
        self._read_lock = threading.Lock()
        self._n_read = read_conns
        self._gen = 0  # bumped by flush_read_conns; stale conns retire
        self._conn_gen: dict[sqlite3.Connection, int] = {}
        self._current: _Job | None = None  # job the writer is executing
        self._closed = False
        # Dedicated single writer thread (not asyncio.to_thread): close()
        # must be able to WAIT for an in-flight job — cancelling the
        # awaiting task leaves the thread running, and closing the store's
        # connection under a mid-transaction job segfaults in sqlite3.
        self._writer_exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="splitpool-writer"
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._writer_task = asyncio.get_running_loop().create_task(
            self._writer_loop()
        )

    async def close(self) -> None:
        self._closed = True
        if self._writer_task is not None:
            self._kick.set()
            self._writer_task.cancel()
            try:
                await self._writer_task
            except asyncio.CancelledError:
                pass
        # Fail the in-flight and still-queued jobs so their awaiting
        # callers never hang.
        if self._current is not None and not self._current.future.done():
            self._current.future.set_exception(RuntimeError("pool closed"))
        while (job := self._pop()) is not None:
            if not job.future.done():
                job.future.set_exception(RuntimeError("pool closed"))
        # Drain the writer THREAD: an in-flight job keeps executing after
        # its awaiting task is cancelled, and the store connection must
        # not be closed under it.
        await asyncio.to_thread(self._writer_exec.shutdown, True)
        with self._read_lock:
            for c in self._read_pool:
                c.close()
            self._read_pool.clear()

    # -- writes --------------------------------------------------------------

    async def write(
        self, fn: Callable[[], Any], priority: int = NORMAL
    ) -> Any:
        """Run ``fn`` (a closure over the Store) on the writer, serialized
        with all other writes, admitted by priority class. Queue-full
        blocks right here (deterministic backpressure, never a shed or a
        drop — see the class docstring)."""
        if self._closed:
            raise RuntimeError("pool closed")
        loop = asyncio.get_running_loop()
        job = _Job(fn=fn, future=loop.create_future())
        t0 = time.perf_counter()
        await self._queues[priority].put(job)  # bounded: backpressure
        if self._closed and not job.future.done():
            # close() drained the queues while we were blocked in put():
            # nothing will ever run this job — fail it, don't hang.
            job.future.set_exception(RuntimeError("pool closed"))
        self._kick.set()
        try:
            return await job.future
        finally:
            if self.metrics is not None:
                # Queue-to-done wall time (the reference splits queue vs
                # execution; the writer runs one job at a time, so queue
                # wait dominates the difference). Histogram handle cached:
                # this is the ingest hot path and a registry lookup takes
                # the registry lock per call.
                h = self._exec_hist
                if h is None:
                    h = self._exec_hist = self.metrics.histogram(
                        "corro_sqlite_pool_execution_seconds",
                        "writer job wall time incl. queue wait",
                    )
                h.observe(time.perf_counter() - t0)

    async def write_priority(self, fn: Callable[[], Any]) -> Any:
        return await self.write(fn, HIGH)

    async def write_low(self, fn: Callable[[], Any]) -> Any:
        return await self.write(fn, LOW)

    # corro-lint: disable=CT040 reason=single writer-loop task owns _current; close() only reads it to fail the in-flight future
    async def _writer_loop(self) -> None:
        while not self._closed:
            job = self._pop()
            if job is None:
                self._kick.clear()
                await self._kick.wait()
                continue
            self._current = job
            try:
                result = await asyncio.get_running_loop().run_in_executor(
                    self._writer_exec, job.fn
                )
            except asyncio.CancelledError:
                # close() cancelled us mid-job: fail the caller before the
                # cancellation unwinds, or it would await forever.
                if not job.future.done():
                    job.future.set_exception(RuntimeError("pool closed"))
                raise
            except Exception as e:  # propagate to the caller only
                if not job.future.done():
                    job.future.set_exception(e)
                continue
            finally:
                self._current = None
            if not job.future.done():
                job.future.set_result(result)

    def queue_depths(self) -> dict[str, int]:
        """Queued writer jobs per priority class (for metrics)."""
        return {
            "high": self._queues[HIGH].qsize(),
            "normal": self._queues[NORMAL].qsize(),
            "low": self._queues[LOW].qsize(),
        }

    def _pop(self) -> _Job | None:
        for p in (HIGH, NORMAL, LOW):
            try:
                return self._queues[p].get_nowait()
            except asyncio.QueueEmpty:
                continue
        return None

    # -- reads ---------------------------------------------------------------

    async def query(self, stmt: Statement) -> tuple[list[str], list[tuple]]:
        """Pooled snapshot read (the 20-conn read pool role)."""
        t0 = time.perf_counter()
        async with self._read_sem:
            if self.metrics is not None:
                h = self._queue_hist
                if h is None:
                    h = self._queue_hist = self.metrics.histogram(
                        "corro_sqlite_pool_queue_seconds",
                        "wait for a read-pool slot",
                    )
                h.observe(time.perf_counter() - t0)
            return await asyncio.to_thread(self._query_sync, stmt)

    def _query_sync(self, stmt: Statement) -> tuple[list[str], list[tuple]]:
        conn = self._take_conn()
        try:
            from corrosion_tpu_torch.agent.store import _bind

            cur = conn.execute(stmt.sql, _bind(stmt))
            cols = [d[0] for d in cur.description] if cur.description else []
            return cols, cur.fetchall()
        finally:
            self._put_conn(conn)

    def quiesce_reads(self):
        """Async context manager acquiring every read slot: no pooled read
        runs until it exits (used around online restore, where same-process
        readers are not excluded by the fcntl file locks)."""
        sem, n = self._read_sem, self._n_read

        class _Quiesce:
            async def __aenter__(self):
                for _ in range(n):
                    await sem.acquire()
                return self

            async def __aexit__(self, *exc):
                for _ in range(n):
                    sem.release()
                return False

        return _Quiesce()

    def _take_conn(self) -> sqlite3.Connection:
        with self._read_lock:
            if self._read_pool:
                return self._read_pool.pop()
            gen = self._gen
        conn = sqlite3.connect(self.store.path, check_same_thread=False)
        conn.isolation_level = None
        conn.execute("PRAGMA query_only=1")
        # Same SQL surface as the store's own read connection.
        from corrosion_tpu_torch.agent.store import _sql_pack

        conn.create_function("corro_pack", -1, _sql_pack, deterministic=True)
        native.load_crdt_extension(conn)
        with self._read_lock:
            self._conn_gen[conn] = gen
        return conn

    def flush_read_conns(self) -> None:
        """Retire all pooled read connections (after an online restore their
        page caches are stale); checked-out connections retire on return via
        the generation stamp. Fresh ones are opened on demand."""
        with self._read_lock:
            self._gen += 1
            for c in self._read_pool:
                self._conn_gen.pop(c, None)
                c.close()
            self._read_pool.clear()

    def _put_conn(self, conn: sqlite3.Connection) -> None:
        with self._read_lock:
            fresh = self._conn_gen.get(conn, -1) == self._gen
            if fresh and len(self._read_pool) < self._n_read and not self._closed:
                self._read_pool.append(conn)
                return
            self._conn_gen.pop(conn, None)
        conn.close()

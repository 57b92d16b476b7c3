"""Open-loop load drivers + the subscription pump.

``LoadHarness`` owns the run clock, per-route latency histograms
(``utils.metrics`` bucket machinery — the same family the agent exports
on /metrics), and shed/error accounting split by cause: a 503 from
``RouteLimit`` is *shed* (admission control doing its job, fast-fail), a
connection failure is a *transport error*, and a request that neither
completes nor fails within its deadline is a *timeout*. The three are
different findings — a saturation sweep that lumped them together could
not distinguish "load-shed engaged as promised" from "the server fell
over".

``SubscriptionPump`` keeps one NDJSON subscription stream drained and
feeds every frame to the :class:`~corrosion_tpu_torch.loadgen.oracle.
FanoutOracle`; when the server ends the stream (listener-queue overflow
eviction, agent restart) it resumes via
``SubscriptionStream.reconnect()`` from the last observed change id, so
an evicted laggard re-joins without duplicates or gaps — exactly the
contract the oracle then verifies.

Counterpart of corrosion_tpu/loadgen/harness.py.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from corrosion_tpu_torch.client import ApiError, CorrosionApiClient
from corrosion_tpu_torch.loadgen.oracle import FanoutOracle
from corrosion_tpu_torch.loadgen.schedule import Arrival
from corrosion_tpu_torch.utils.metrics import MetricsRegistry

OUTCOMES = ("ok", "shed", "error", "timeout")


@dataclass
class RouteStats:
    """Per-route open-loop accounting (one instance per route+stage)."""

    sent: int = 0
    ok: int = 0
    shed: int = 0
    error: int = 0
    timeout: int = 0
    errors_sample: list = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {
            "sent": self.sent, "ok": self.ok, "shed": self.shed,
            "error": self.error, "timeout": self.timeout,
        }
        if self.errors_sample:
            d["errors_sample"] = self.errors_sample[:4]
        return d


class LoadHarness:
    """Run clock + per-route accounting for one scenario execution."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry or MetricsRegistry()
        self._hist = self.registry.histogram(
            "loadgen_route_seconds",
            "open-loop request latency from SCHEDULED arrival "
            "(includes generator queueing — coordinated-omission-free)",
        )
        self._stats: dict[tuple[str, int], RouteStats] = {}
        self._t0: float | None = None
        self._lat_max: dict[tuple[str, int], float] = {}

    def stats(self, route: str, stage: int = 0) -> RouteStats:
        key = (route, stage)
        if key not in self._stats:
            self._stats[key] = RouteStats()
        return self._stats[key]

    # -- open-loop core ------------------------------------------------------

    async def run_arrivals(self, arrivals: list[Arrival], fire) -> None:
        """Fire ``fire(arrival)`` at each scheduled instant without
        waiting for earlier calls (open-loop); awaits all completions
        before returning. The run clock starts at the first call, so
        latencies from :meth:`timed` line up with the schedule."""
        loop = asyncio.get_running_loop()
        if self._t0 is None:
            self._t0 = loop.time()
        t0 = self._t0
        tasks = []
        for a in arrivals:
            delay = t0 + a.t - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.ensure_future(fire(a)))
        if tasks:
            await asyncio.gather(*tasks)

    async def timed(
        self, route: str, arrival: Arrival, coro_fn, *,
        deadline_s: float = 15.0,
    ):
        """Run one request, classify its outcome, and record latency
        from the *scheduled* arrival. Returns the request's result, or
        None on shed/error/timeout."""
        loop = asyncio.get_running_loop()
        st = self.stats(route, arrival.stage)
        st.sent += 1
        result = None
        outcome = "ok"
        try:
            result = await asyncio.wait_for(coro_fn(), deadline_s)
        except ApiError as e:
            if e.status == 503:
                outcome = "shed"
            else:
                outcome = "error"
                st.errors_sample.append(f"HTTP {e.status}: {e.body[:80]}")
        except asyncio.TimeoutError:
            outcome = "timeout"
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            outcome = "error"
            st.errors_sample.append(repr(e)[:120])
        setattr(st, outcome, getattr(st, outcome) + 1)
        lat = loop.time() - ((self._t0 or 0.0) + arrival.t)
        # Shed MUST fail fast — its latency is part of the admission-
        # control promise, so it is recorded too (separate outcome label).
        self._hist.observe(
            lat, route=route, outcome=outcome, stage=str(arrival.stage)
        )
        key = (route, arrival.stage, outcome)
        self._lat_max[key] = max(self._lat_max.get(key, 0.0), lat)
        return result

    # -- report assembly -----------------------------------------------------

    def route_report(self, route: str, stage: int = 0) -> dict:
        """Stats + ok-latency percentiles for one route (and stage)."""
        st = self.stats(route, stage)
        out = st.to_dict()
        labels = {"route": route, "outcome": "ok", "stage": str(stage)}
        count = self._hist.count(**labels)
        lat_max = self._lat_max.get((route, stage, "ok"), 0.0)

        def q_ms(q: float) -> float:
            return round(
                min(self._hist.quantile(q, **labels), lat_max) * 1000.0, 3,
            )

        if count:
            out["latency_ms"] = {
                "p50": q_ms(0.50), "p90": q_ms(0.90), "p99": q_ms(0.99),
                "max": round(lat_max * 1000.0, 3),
            }
        if st.shed:
            # The other half of the admission promise: shed is FAST-fail.
            shed_max = self._lat_max.get((route, stage, "shed"), 0.0)
            out["shed_latency_ms"] = {
                "p99": round(
                    min(
                        self._hist.quantile(
                            0.99, route=route, outcome="shed",
                            stage=str(stage),
                        ),
                        shed_max,
                    ) * 1000.0, 3,
                ),
                "max": round(shed_max * 1000.0, 3),
            }
        return out

    def stages_of(self, route: str) -> list[int]:
        return sorted(s for (r, s) in self._stats if r == route)


class SubscriptionPump:
    """One live NDJSON subscription stream, drained into the oracle.

    Lifecycle: ``await start()`` subscribes and consumes the initial
    snapshot (sub_id header, columns, rows, end-of-query) synchronously —
    when it returns, the oracle knows this stream's obligations begin.
    The live phase runs as a background task; ``await stop()`` tears it
    down. A stream ended by the server (listener-queue overflow eviction
    or restart) resumes via ``reconnect()`` from the last change id.

    Events must be ``SELECT``s whose first cell is the row key and whose
    remaining cells serialize to the committed payload — the scenarios
    use ``SELECT id, text FROM tests ...`` so ``cells[0]`` is the key and
    ``cells[1]`` the payload.
    """

    def __init__(
        self,
        client: CorrosionApiClient,
        sql: str,
        oracle: FanoutOracle,
        *,
        group: int | None = None,
        label: str = "",
        reconnect: bool = True,
        reconnect_delay_s: float = 0.2,
        reconnect_retries: int = 25,
    ) -> None:
        self.client = client
        self.sql = sql
        self.oracle = oracle
        self.group = group
        self.label = label
        self.auto_reconnect = reconnect
        self.reconnect_delay_s = reconnect_delay_s
        self.reconnect_retries = reconnect_retries
        self.sid: int | None = None
        self.stream = None
        self._task: asyncio.Task | None = None
        self._stopping = False
        self.dead_reason: str | None = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.sid = self.oracle.attach_stream(
            group=self.group, label=self.label
        )
        self.stream = await self.client.subscribe(self.sql)
        await self._consume_snapshot(loop)
        self._task = asyncio.ensure_future(self._run())

    async def _consume_snapshot(self, loop) -> None:
        """Drain frames up to the end-of-query marker. Change events may
        legally arrive BEFORE eoq on a catch-up resume (the server
        replays the change log instead of a snapshot) — forward them."""
        async for ev in self.stream:
            if "row" in ev:
                _rowid, cells = ev["row"]
                self.oracle.snapshot_row(
                    self.sid, cells[0], tuple(cells[1:]),
                    t_wall=time.time(),
                )
            elif "change" in ev:
                self._on_change(ev, loop)
                # Catch-up resume: no eoq frame follows the replay.
                break
            elif "eoq" in ev:
                break
        self.oracle.snapshot_done(self.sid, loop.time())

    def _on_change(self, ev: dict, loop) -> None:
        kind, _rowid, cells, change_id = ev["change"]
        # Both clocks on purpose: loop.time() feeds the lag histogram
        # (monotonic, ack-relative); time.time() is the wall stamp the
        # timeline correlator joins against the agent's span export.
        self.oracle.change(
            self.sid, kind, cells[0], tuple(cells[1:]), change_id,
            loop.time(), t_wall=time.time(),
        )

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            try:
                async for ev in self.stream:
                    if "change" in ev:
                        self._on_change(ev, loop)
                    elif "row" in ev:
                        # Snapshot-restart replay after a deep reconnect.
                        _rowid, cells = ev["row"]
                        self.oracle.snapshot_row(
                            self.sid, cells[0], tuple(cells[1:])
                        )
            except (ConnectionError, OSError, asyncio.IncompleteReadError,
                    ValueError):
                pass
            if self._stopping or not self.auto_reconnect:
                return
            if not await self._try_reconnect():
                return

    async def _try_reconnect(self) -> bool:
        for _ in range(self.reconnect_retries):
            if self._stopping:
                return False
            try:
                await self.stream.reconnect()
            except (ApiError, ConnectionError, OSError) as e:
                self.dead_reason = repr(e)
                await asyncio.sleep(self.reconnect_delay_s)
                continue
            self.dead_reason = None  # corro-lint: disable=CT040 reason=single pump task owns dead_reason; it is report status, not control state
            self.oracle.reconnected(self.sid)
            return True
        return False

    def request_stop(self) -> None:
        """Synchronously mark the pump stopping and cut its stream, so a
        teardown path can pre-mark EVERY pump before awaiting the batched
        ``stop()``s — a pump whose ``async for`` breaks after the mark
        exits instead of spending reconnect retries against a stopping
        cluster."""
        self._stopping = True
        if self.stream is not None:
            self.stream.close()

    async def stop(self) -> None:
        self.request_stop()
        # Capture-and-swap before awaiting: a concurrent stop() (final
        # teardown racing a scenario's own stop) must not null _task
        # under the first caller's await — `self._task.cancel()` would
        # then be `None.cancel()`.
        task, self._task = self._task, None
        if task is not None:
            try:
                await asyncio.wait_for(task, 5.0)
            except asyncio.TimeoutError:
                task.cancel()
            except asyncio.CancelledError:
                task.cancel()
                raise  # we were cancelled: propagate, don't absorb


async def stop_pumps(pumps: list["SubscriptionPump"]) -> None:
    """Tear down a fleet of pumps: pre-mark EVERY pump stopping (so none
    spends reconnect retries against a stopping cluster), then await the
    stops in bounded batches — the one teardown shared by the loadgen
    scenarios and the host chaos harness."""
    for p in pumps:
        p.request_stop()
    for base in range(0, len(pumps), 256):
        await asyncio.gather(*(p.stop() for p in pumps[base:base + 256]))

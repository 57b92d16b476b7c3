"""The three standing serving-plane scenarios (docs/SERVING.md).

- :func:`fanout_storm` (``loadgen run``): thousands of concurrent NDJSON
  subscriptions plus a sustained open-loop write storm through
  /v1/transactions, pooled reads through /v1/queries and the PG wire
  server — with the fan-out oracle asserting exactly-once delivery and
  monotonic change ids on every stream.
- :func:`saturation_sweep` (``loadgen sweep``): ramp the transaction
  arrival rate past ``api_concurrency`` and verify the admission-control
  promise empirically: shed requests 503 fast, admitted p99 stays
  bounded across the ramp, and the client-side shed count matches the
  server's own ``corro_api_shed_total`` accounting.
- :func:`intake_policy` (``loadgen soak``): the docs/SCALING.md
  queue-policy collapse rule, measured: run the kernel plane's gossip
  engine with ``rebroadcast_intake`` above and below the cluster write
  rate and show the undelivered-version backlog (staleness mass) stays
  bounded above the threshold and diverges below it.

Scenarios launch their own in-process agents (agent/testing — real TCP
over loopback, like every cluster test) so `loadgen` is self-contained
on a CI runner; each returns a plain dict that the caller funnels
through :func:`corrosion_tpu_torch.loadgen.report.emit_serving_report`.

Counterpart of corrosion_tpu/loadgen/scenarios.py.
"""

from __future__ import annotations

import asyncio
import os
import resource
import tempfile
import time

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.agent.testing import launch_test_cluster, stop_cluster
from corrosion_tpu_torch.loadgen.harness import (
    LoadHarness,
    SubscriptionPump,
    stop_pumps,
)
from corrosion_tpu_torch.loadgen.oracle import FanoutOracle
from corrosion_tpu_torch.loadgen.pgread import PgReadClient
from corrosion_tpu_torch.loadgen.report import serving_context
from corrosion_tpu_torch.loadgen.schedule import Arrival, open_loop

# Stream fan-out is FD-bound (one client + one server socket per
# subscription): lift the soft NOFILE limit to the hard one before a big
# storm so "sustains >= 2k concurrent subscriptions" doesn't depend on
# the shell's default ulimit.
def _raise_nofile() -> None:
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ValueError, OSError):
        pass


# Cluster launch/teardown now live in agent/testing (shared with the
# fidelity harness and the CLI). Load scenarios skip the membership
# barrier — a 1-agent storm has no peers and the pumps attach anyway.
async def _launch_cluster(data_dir: str, n_agents: int, **cfg):
    return await launch_test_cluster(
        data_dir, n_agents, wait_membership=False, **cfg
    )


_stop_cluster = stop_cluster


def _payload(k: int) -> str:
    return f"loadgen-w{k}"


def _window_sub_sql(fallback_groups: int, g: int) -> str:
    """A deliberately fallback-bound subscription query: the window
    function in the select list defeats PK injection (whole-row identity,
    full-snapshot re-evaluation per batch — the VERDICT r5 #8 cliff), yet
    stays oracle-compatible: ``min(id) OVER (PARTITION BY id)`` is the
    row's own id, so the delivered payload ``(text, id)`` is deterministic
    per key and never changes as other rows arrive."""
    return (
        "SELECT id, text, min(id) OVER (PARTITION BY id) AS w"
        f" FROM tests WHERE id % {fallback_groups} = {g}"
    )


async def fanout_storm(
    data_dir: str,
    *,
    subs: int = 2000,
    writes: int = 80,
    write_rate: float = 10.0,
    read_rate: float = 20.0,
    pg_rate: float = 10.0,
    sub_groups: int = 4,
    n_agents: int = 1,
    drain_timeout_s: float = 30.0,
    attach_batch: int = 64,
    trace_dir: str | None = None,
    trace_sample: float = 1.0,
    sub_costs: bool = False,
    fallback_subs: int = 0,
    fallback_groups: int = 2,
    progress=None,
) -> dict:
    """Scenario (b): the subscription fan-out storm. Returns the ``run``
    report block (routes + oracle verdict + achieved concurrency).

    ``trace_dir`` switches the run into causal-tracing mode: agents
    launch with ``trace_writes`` on and per-agent span export files
    under the directory, every write carries a client-minted W3C
    traceparent, and the report gains a ``trace`` block (span files +
    oracle delivery records) — everything ``obs timeline`` needs to
    reconstruct each acked write's journey (docs/OBSERVABILITY.md
    "Causal tracing").

    ``sub_costs`` arms the serving query-cost plane: agents launch with
    ``AgentConfig.sub_costs`` on, the oracle keeps per-delivery records,
    and the report gains a ``sub_costs`` block (the ``corro-sub-cost/1``
    ledger snapshot + group->sub_id mapping + oracle records) — the
    input of ``obs serving report``. ``fallback_subs`` additionally
    attaches that many deliberately fallback-bound window-function
    subscriptions spread over ``fallback_groups`` distinct queries, so a
    storm exercises the fallback cliff on purpose (the machinery-fired
    rule requires it)."""

    def note(msg):
        if progress is not None:
            progress.write(f"[loadgen run] {msg}\n")
            progress.flush()

    _raise_nofile()
    cluster_kw: dict = {}
    span_files: list[str] = []
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        span_files = [
            os.path.join(trace_dir, f"spans-agent{i}.jsonl")
            for i in range(n_agents)
        ]
        cluster_kw = dict(
            trace_writes=True,
            trace_sample=trace_sample,
            cfg_for=lambda i: {"trace_export_path": span_files[i]},
        )
    if sub_costs:
        cluster_kw["sub_costs"] = True
    agents = await _launch_cluster(data_dir, n_agents, **cluster_kw)
    harness = LoadHarness()
    oracle = FanoutOracle(
        registry=harness.registry,
        keep_deliveries=trace_dir is not None or sub_costs,
    )
    pumps: list[SubscriptionPump] = []
    pg_server = pg_client = None
    try:
        pg_server, (pg_host, pg_port) = await _serve_pg(agents[0])
        # Subscriptions spread over `sub_groups` DISTINCT queries (each
        # group is its own matcher — fan-out cost AND match cost scale)
        # on the first agent; writes round-robin the cluster.
        note(f"attaching {subs} subscriptions in {sub_groups} groups")
        for base in range(0, subs, attach_batch):
            batch = []
            for i in range(base, min(base + attach_batch, subs)):
                g = i % sub_groups
                pump = SubscriptionPump(
                    agents[0].client,
                    f"SELECT id, text FROM tests WHERE id % {sub_groups} "
                    f"= {g}",
                    oracle, group=g, label=f"sub{i}",
                )
                pumps.append(pump)
                batch.append(pump.start())
            await asyncio.gather(*batch)
        if fallback_subs:
            # Fallback-bound window streams ride their own oracle groups
            # (sub_groups + wg): each write registers a second commit with
            # the window payload, so exactly-once/no-loss obligations hold
            # for the cliff population too.
            note(
                f"attaching {fallback_subs} fallback-bound window subs "
                f"in {fallback_groups} groups"
            )
            for base in range(0, fallback_subs, attach_batch):
                batch = []
                for j in range(
                    base, min(base + attach_batch, fallback_subs)
                ):
                    wg = j % fallback_groups
                    pump = SubscriptionPump(
                        agents[0].client,
                        _window_sub_sql(fallback_groups, wg),
                        oracle, group=sub_groups + wg, label=f"wsub{j}",
                    )
                    pumps.append(pump)
                    batch.append(pump.start())
                await asyncio.gather(*batch)
        note("subscriptions live; starting storm")

        loop = asyncio.get_running_loop()
        next_key = iter(range(10**9))

        async def fire_write(a: Arrival):
            k = next(next_key)
            payload = _payload(k)
            ta = agents[k % len(agents)]

            async def go():
                tp = trace_id = t_send = t_send_mono = None
                if trace_dir is not None:
                    # The CLIENT mints the trace id (Dapper-style): the
                    # agent's api_write root continues it, so spans,
                    # this commit record, and the stream deliveries for
                    # key k all join on one id. Send time is stamped on
                    # BOTH clocks: epoch (joins the span domain) and
                    # monotonic (the independent wall the correlator
                    # reconciles the epoch-derived stage sum against).
                    trace_id = os.urandom(16).hex()
                    tp = f"00-{trace_id}-{os.urandom(8).hex()}-01"
                    t_send = time.time()
                    t_send_mono = loop.time()
                await ta.client.execute(
                    [["INSERT INTO tests (id, text) VALUES (?, ?)",
                      [k, payload]]],
                    traceparent=tp,
                )
                t_ack = loop.time()
                oracle.commit(
                    k, (payload,), t_ack, group=k % sub_groups,
                    trace_id=trace_id, t_send_wall=t_send,
                    t_ack_wall=(
                        time.time() if trace_dir is not None else None
                    ),
                    t_send_mono=t_send_mono,
                )
                if fallback_subs:
                    # The same row reaches the window streams with the
                    # window column appended: a distinct (key, payload)
                    # commit on the window group, same ack time.
                    oracle.commit(
                        k, (payload, k), t_ack,
                        group=sub_groups + (k % fallback_groups),
                    )

            # Deadline scales with fan-out: every commit costs the
            # server O(subs) queue pushes + socket writes, and the
            # loadgen process itself drains every one of those lines —
            # at 2k streams a fixed 15 s ceiling measures the harness,
            # not the server.
            await harness.timed(
                "transactions", a, go,
                deadline_s=15.0 + (subs + fallback_subs) / 100.0,
            )

        async def fire_read(a: Arrival):
            ta = agents[a.stage % len(agents)]
            await harness.timed(
                "queries", a,
                lambda: ta.client.query("SELECT count(*) FROM tests"),
            )

        pg_client = await PgReadClient.connect(pg_host, pg_port)
        pg_lock = asyncio.Lock()

        async def fire_pg(a: Arrival):
            async def go():
                # One PG connection, serialized queries (the pooled-read
                # realistic shape; rate is modest by design).
                async with pg_lock:
                    return await pg_client.query(
                        "SELECT count(*) FROM tests"
                    )

            await harness.timed("pg", a, go)

        duration = writes / write_rate
        await asyncio.gather(
            harness.run_arrivals(
                open_loop(write_rate, writes), fire_write
            ),
            harness.run_arrivals(
                open_loop(read_rate, max(1, int(read_rate * duration))),
                fire_read,
            ),
            harness.run_arrivals(
                open_loop(pg_rate, max(1, int(pg_rate * duration))),
                fire_pg,
            ),
        )
        note("storm done; draining fan-out")
        deadline = loop.time() + drain_timeout_s
        while oracle.pending(limit=1) and loop.time() < deadline:
            await asyncio.sleep(0.1)
        note(f"drained (pending={oracle.pending(limit=100)})")
        for base in range(0, len(pumps), 256):
            await asyncio.gather(
                *(p.stop() for p in pumps[base:base + 256])
            )
        verdict = oracle.finish()
        out = {
            "subs": subs,
            "sub_groups": sub_groups,
            "fallback_subs": fallback_subs,
            "fallback_groups": fallback_groups if fallback_subs else 0,
            "agents": n_agents,
            "writes": writes,
            "write_rate_hz": write_rate,
            "routes": {
                r: harness.route_report(r)
                for r in ("transactions", "queries", "pg")
            },
            "oracle": verdict,
        }
        if trace_dir is not None:
            out["trace"] = {
                "span_files": span_files,
                "sample": trace_sample,
                "oracle_records": oracle.delivery_records(),
            }
        if sub_costs:
            # Query-cost plane export: the live ledger snapshot, the
            # oracle group -> matcher sub_id mapping (each group is one
            # distinct query, hence one MatcherHandle), and the oracle's
            # delivery records — everything `obs serving report` joins.
            mgr = agents[0].agent.subs
            groups_map: dict[str, str] = {}
            for g in range(sub_groups):
                groups_map[str(g)] = mgr.subscribe(
                    f"SELECT id, text FROM tests WHERE id % {sub_groups} "
                    f"= {g}"
                ).id
            for wg in range(fallback_groups if fallback_subs else 0):
                groups_map[str(sub_groups + wg)] = mgr.subscribe(
                    _window_sub_sql(fallback_groups, wg)
                ).id
            out["sub_costs"] = {
                "enabled": True,
                "ledger": mgr.cost_snapshot(),
                "groups": groups_map,
                "oracle_records": (
                    out["trace"]["oracle_records"]
                    if trace_dir is not None
                    else oracle.delivery_records()
                ),
            }
        return out
    finally:
        # Everything the scenario opened closes here, success or not —
        # a failing assertion mid-storm must not leak the PG server,
        # its connection, or auto-reconnecting pump tasks onto the
        # caller's event loop. _stopping is flipped BEFORE the streams
        # close so a pump whose `async for` breaks exits instead of
        # spending reconnect retries against the stopping cluster.
        if pg_client is not None:
            pg_client.close()
        if pg_server is not None:
            pg_server.close()
        await stop_pumps(pumps)
        await _stop_cluster(agents)


async def _serve_pg(ta):
    from corrosion_tpu_torch.agent.pg import serve_pg

    return await serve_pg(ta.agent)


async def saturation_sweep(
    data_dir: str,
    *,
    api_concurrency: int = 4,
    rates: tuple = (50.0, 200.0, 400.0),
    stage_duration_s: float = 2.0,
    burst: int = 16,
    bounded_p99_ms: float = 5000.0,
    progress=None,
) -> dict:
    """Scenario (a): ramp transaction arrivals past ``api_concurrency``.

    The agent runs with a deliberately small admission limit so the CI
    smoke saturates at loopback-feasible rates; ``burst`` packs arrivals
    so that more than ``api_concurrency`` requests are concurrently
    in-flight at the top stages regardless of service-time jitter.
    Verifies, per stage: shed requests fail fast (their latency rides
    the same histogram), admitted p99 stays under ``bounded_p99_ms``,
    and the client-observed shed count equals the server's
    ``corro_api_shed_total{route=/v1/transactions}``.
    """

    def note(msg):
        if progress is not None:
            progress.write(f"[loadgen sweep] {msg}\n")
            progress.flush()

    _raise_nofile()
    agents = await _launch_cluster(
        data_dir, 1, api_concurrency=api_concurrency
    )
    ta = agents[0]
    harness = LoadHarness()
    try:
        next_key = iter(range(10**9))

        async def fire(a: Arrival):
            k = next(next_key)
            await harness.timed(
                "transactions", a,
                lambda: ta.client.execute(
                    [["INSERT INTO tests (id, text) VALUES (?, ?)",
                      [k, _payload(k)]]]
                ),
                deadline_s=10.0,
            )

        # Burst only on the TOP stage: below capacity arrivals fire on
        # the plain grid (they should admit cleanly); the final stage
        # packs `burst` > api_concurrency arrivals per instant so shed
        # engagement is guaranteed by concurrency, not service-time
        # jitter. (`ramp` keeps a uniform burst; the sweep builds its
        # stages directly for the per-stage shape.)
        arrivals = []
        t = 0.0
        for idx, r in enumerate(rates):
            b = burst if idx == len(rates) - 1 else 1
            n = max(1, round(r * stage_duration_s))
            arrivals.extend(
                open_loop(r, n, burst=b, start=t, stage=idx)
            )
            t += stage_duration_s
        note(
            f"ramp {list(rates)} Hz x {stage_duration_s}s, top burst="
            f"{burst}, api_concurrency={api_concurrency}"
        )
        await harness.run_arrivals(arrivals, fire)

        stages = []
        shed_total = 0
        admitted_p99_max = 0.0
        for idx, rate in enumerate(rates):
            rep = harness.route_report("transactions", stage=idx)
            rep["offered_rate_hz"] = rate
            stages.append(rep)
            shed_total += rep["shed"]
            p99 = rep.get("latency_ms", {}).get("p99")
            if p99 is not None:
                admitted_p99_max = max(admitted_p99_max, p99)
        server_shed = ta.agent.metrics.counter(
            "corro_api_shed_total"
        ).get(route="/v1/transactions")
        shed_engaged = shed_total > 0
        note(
            f"shed client={shed_total} server={server_shed:g} "
            f"admitted_p99_max={admitted_p99_max}ms"
        )
        return {
            "api_concurrency": api_concurrency,
            "burst": burst,
            "stages": stages,
            "shed_total": shed_total,
            "server_shed_total": server_shed,
            "shed_accounting_consistent": server_shed == shed_total,
            "shed_engaged": shed_engaged,
            "admitted_p99_ms_max": admitted_p99_max,
            "admitted_p99_bounded": admitted_p99_max <= bounded_p99_ms,
            "bounded_p99_ms": bounded_p99_ms,
        }
    finally:
        await _stop_cluster(agents)


def intake_policy(
    *,
    nodes: int = 96,
    rounds: int = 96,
    write_prob: float = 0.08,
    intake_margin: int = 8,
    starved_intake: int = 1,
    seed: int = 0,
    progress=None,
    series_path: str | None = None,
    device=None,
) -> dict:
    """Scenario (c): the docs/SCALING.md collapse rule, measured.

    Runs the dense gossip engine twice on an identical sustained write
    schedule with the anti-entropy plane effectively disabled
    (``sync_interval`` past the run length) so broadcast intake is the
    ONLY delivery path — the isolation the 20k-node policy sweep used:
    once with ``rebroadcast_intake = write_rate + margin`` (the
    documented sizing rule) and once starved far below the write rate.
    The undelivered-version backlog (staleness mass, Σ per-node
    watermark gap) must stay bounded (tail slope ~flat, saw-tooth steady
    state) in the sized run and diverge (persistent positive slope,
    multi-x higher backlog) in the starved run.

    Both runs go on ``device`` (default CUDA; raises when CUDA is absent
    and no device is given).
    """
    import numpy as np

    from corrosion_tpu_torch.models.baselines import _cfg
    from corrosion_tpu_torch.obs.series import (
        MetricSeriesRecorder,
        record_process_sample,
        replay_series,
        series_values,
    )
    from corrosion_tpu_torch.sim.engine import Schedule, simulate
    from corrosion_tpu_torch.utils.metrics import MetricsRegistry

    device = resolve_device(device)

    def note(msg):
        if progress is not None:
            progress.write(f"[loadgen soak] {msg}\n")
            progress.flush()

    # Process self-observability rides the ONE sampling path every
    # endurance surface shares (obs/series.record_process_sample):
    # gauges set from live /proc reads, then a whole-registry snapshot
    # per section boundary. ``series_path`` keeps the
    # corro-metric-series/1 record as an artifact (`loadgen soak
    # --series-out`); by default it lands in a scratch dir.
    registry = MetricsRegistry()
    _scratch = None
    if series_path is None:
        _scratch = tempfile.TemporaryDirectory()
        series_path = os.path.join(_scratch.name, "soak.series.jsonl")
    recorder = MetricSeriesRecorder(
        series_path, source="loadgen-soak", mode="w"
    )
    t_start = time.monotonic()
    record_process_sample(recorder, registry, lag_s=0.0)

    # Sustained storm: no drain tail — the collapse rule is about steady
    # state under load, and a drain would let even a starved intake
    # eventually catch up.
    rng = np.random.default_rng(seed)
    writes = (rng.random((rounds, nodes)) < write_prob).astype(np.uint32)
    write_rate = float(writes.sum()) / rounds

    def run_with_intake(intake: int) -> dict:
        cfg, topo = _cfg(
            nodes, writers=list(range(nodes)),
            regions=[nodes // 4] * 4,
            # Broadcast-only: a sync wave would periodically rescue the
            # starved run and blur the intake signal.
            sync_interval=10 * rounds,
            fanout_near=3, fanout_far=3, queue=24,
            rebroadcast_intake=intake, n_cells=0, device=device,
        )
        sched = Schedule(writes=writes).make_samples(32)
        note(f"intake={intake} (write rate {write_rate:.1f}/round)")
        _, curves = simulate(cfg, topo, sched, seed=seed, device=device)
        stale = np.asarray(curves["staleness_sum"], np.float64)
        # Tail slope: least-squares over the last half of the run (wide
        # enough to smooth the bounded regime's saw-tooth) — bounded
        # means the backlog stopped growing, divergent means it still
        # climbs at end of run.
        tail = stale[-(rounds // 2):]
        x = np.arange(len(tail), dtype=np.float64)
        slope = float(np.polyfit(x, tail, 1)[0]) if len(tail) > 1 else 0.0
        return {
            "intake": intake,
            "staleness_last": float(stale[-1]),
            "staleness_peak": float(stale.max()),
            "tail_slope_per_round": round(slope, 3),
            "backlog_curve": [
                float(v) for v in stale[:: max(1, rounds // 36)]
            ],
        }

    sized = run_with_intake(int(round(write_rate)) + intake_margin)
    record_process_sample(
        recorder, registry, lag_s=time.monotonic() - t_start
    )
    starved = run_with_intake(starved_intake)
    # Bounded vs divergent, empirically: the sized run's end-of-run
    # backlog holds at a few rounds' worth of cluster write mass
    # (write_rate versions/round x nodes watermark-gap each — the
    # steady-state saw-tooth), while the starved run still climbs at end
    # of run (tail slope above the write rate) and sits multi-x above
    # the sized backlog.
    bounded_ceiling = 5.0 * write_rate * nodes
    divergence_ratio = (
        starved["staleness_last"] / max(sized["staleness_last"], 1.0)
    )
    record_process_sample(
        recorder, registry, lag_s=time.monotonic() - t_start
    )
    recorder.close()
    proc_samples = replay_series(series_path)["samples"]
    if _scratch is not None:
        _scratch.cleanup()
        series_path = None

    def _endpoints(name: str) -> tuple[float | None, float | None]:
        _, vals = series_values(proc_samples, name, family="gauges")
        return (vals[0], vals[-1]) if vals else (None, None)

    rss0, rss1 = _endpoints("corro_runtime_rss_bytes")
    fds0, fds1 = _endpoints("corro_runtime_open_fds")
    return {
        "kernel_nodes": nodes,
        "rounds": rounds,
        "write_rate_per_round": round(write_rate, 2),
        # Process self-observability (the satellite the hours-long
        # ROADMAP-5 soaks need): RSS/fd growth across the run, plus how
        # long the synchronous kernel sections held the event loop —
        # the soak's own loop-lag figure (the whole section IS lag when
        # run from an async caller). Start/end are the first/last
        # samples of the corro-metric-series/1 record above — the same
        # recorder+gauges path the agent runtime loop and the endurance
        # detectors consume, not a parallel ad-hoc probe.
        "process": {
            "start": {"rss_bytes": rss0, "open_fds": fds0},
            "end": {"rss_bytes": rss1, "open_fds": fds1},
            "rss_growth_bytes": (
                rss1 - rss0
                if rss1 is not None and rss0 is not None else None
            ),
            "loop_held_s": round(time.monotonic() - t_start, 3),
            "samples": len(proc_samples),
            "series_path": series_path,
        },
        "sized": sized,
        "starved": starved,
        "bounded_ceiling": bounded_ceiling,
        "divergence_ratio": round(divergence_ratio, 2),
        "collapse_rule_holds": (
            sized["staleness_last"] < bounded_ceiling
            and starved["tail_slope_per_round"] > write_rate
            and divergence_ratio > 3.0
        ),
    }


async def full_report(
    data_dir: str,
    *,
    subs: int = 200,
    writes: int = 120,
    write_rate: float = 40.0,
    scenario: str = "ci_smoke",
    include_soak: bool = False,
    progress=None,
    device=None,
    **sweep_kw,
) -> dict:
    """run + sweep (+ optionally soak) into one self-describing report —
    the loadgen-smoke CI entrypoint's measurement. ``device`` is the soak's
    and the report's platform (default CUDA; raises when CUDA is absent and
    no device is given)."""
    device = resolve_device(device)
    run = await fanout_storm(
        os.path.join(data_dir, "run"),
        subs=subs, writes=writes, write_rate=write_rate,
        progress=progress,
    )
    sweep = await saturation_sweep(
        os.path.join(data_dir, "sweep"), progress=progress, **sweep_kw
    )
    report = {
        **serving_context(scenario, 1, subs, writes, write_rate, device=device),
        "subs": subs,
        "run": run,
        "sweep": sweep,
    }
    if include_soak:
        report["soak"] = intake_policy(progress=progress, device=device)
    return report

"""Mixed-mode live-vs-kernel comparison: the divergence measurement.

One entry point (:func:`compare_live_kernel`) runs the SAME write
workload through both sides of the dispatch seam:

- **live**: an in-process multi-agent cluster (``agent/testing``, real
  TCP/UDP over loopback) with a chained :class:`sim.trace.Trace`
  recorder on every agent and a per-node subscription watcher sampling
  per-write first-visibility wall timestamps from the NDJSON
  subscription plane;
- **kernel**: the recorded trace replayed through the simulator twice —
  once **calibrated** (bucketed at the :class:`RoundModel`'s measured
  ``round_ms`` with the model's miss/probe-loss axes compiled in through
  the chaos plane) and once **uncalibrated** (the hardcoded 500 ms
  reference identification, no axes).

Both sides' visibility latencies land in the existing
``delivery_latency_hist`` bucket space (``telemetry.VIS_LAT_EDGES``,
bucketed by ``health.latency_bucket``) **in calibrated-round units**, so
the histograms are directly comparable: live wall-ms divide by the
calibrated round length; kernel round-latencies rescale by
``round_ms_used / round_ms_calibrated``. The divergence verdict per
kernel run is the bucket-space earth-mover's distance (sum of |ΔCDF|
over buckets) against the live CDF — with the bucket-resolution
Kolmogorov distance and the full per-bucket diff reported alongside —
plus p50/p99 bucket deltas, per-percentile latency ratios, and the
time-to-convergence delta. The acceptance claim
``scripts/fidelity_smoke.py`` gates: the calibrated replay's CDF lands
strictly closer to the live cluster's than the uncalibrated replay's.

Counterpart of corrosion_tpu/fidelity/compare.py.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.fidelity.calibrate import (
    REFERENCE_ROUND_MS,
    RoundModel,
    calibrate_live,
    trace_fingerprint,
)

# Row-id namespace: writer w's k-th row is w * WRITER_STRIDE + k, so a
# delivered change maps back to its (writer, seq) without a lookup table.
WRITER_STRIDE = 1_000_000


def _n_buckets() -> int:
    from corrosion_tpu_torch.sim.telemetry import VIS_LAT_EDGES

    return len(VIS_LAT_EDGES) + 1


def bucket_hist(lat_cal_rounds) -> list:
    """Histogram counts over the fixed delivery-latency buckets for
    latencies expressed in calibrated rounds (``health.latency_bucket``
    is the one bucketize both sides share)."""
    from corrosion_tpu_torch.sim.health import latency_bucket

    counts = [0] * _n_buckets()
    for x in np.asarray(lat_cal_rounds, np.float64).ravel():
        counts[latency_bucket(float(x))] += 1
    return counts


def hist_cdf(counts) -> list:
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    return (np.cumsum(counts) / total).tolist() if total > 0 else []


def divergence_verdict(live_hist, kernel_hist) -> dict:
    """Bucket-space divergence of a kernel histogram from the live one.

    The headline metric is ``cdf_distance`` — the sum of per-bucket
    |ΔCDF|, which for a 1-D histogram IS the earth-mover's distance in
    bucket units ("on average, how many buckets is the kernel's
    latency mass displaced from the live cluster's"). The max
    (Kolmogorov distance at bucket resolution) and the full per-bucket
    diff vector are reported alongside; p50/p99 bucket deltas reuse
    ``health.cdf_quantile``. EMD is the gated ordering metric because it
    is robust to single-bucket edge jitter: a replay that is 3 buckets
    off for most of its mass can never out-score one within 1 bucket by
    landing a lucky bucket boundary.
    """
    from corrosion_tpu_torch.sim.health import cdf_quantile

    lc, kc = hist_cdf(live_hist), hist_cdf(kernel_hist)
    if not lc or not kc:
        raise ValueError("divergence needs non-empty live AND kernel hists")
    per_bucket = [round(abs(a - b), 6) for a, b in zip(lc, kc)]
    lp50, _ = cdf_quantile(np.asarray(live_hist, np.float64), 0.50)
    lp99, _ = cdf_quantile(np.asarray(live_hist, np.float64), 0.99)
    kp50, _ = cdf_quantile(np.asarray(kernel_hist, np.float64), 0.50)
    kp99, _ = cdf_quantile(np.asarray(kernel_hist, np.float64), 0.99)
    return {
        "cdf_distance": round(sum(per_bucket), 6),  # EMD, bucket units
        "kolmogorov": max(per_bucket),
        "per_bucket_cdf_diff": per_bucket,
        "p50_bucket": kp50,
        "p99_bucket": kp99,
        "p50_bucket_delta": abs(kp50 - lp50),
        "p99_bucket_delta": abs(kp99 - lp99),
    }


# ---------------------------------------------------------------------------
# Live side.


class VisibilityWatcher:
    """One agent's subscription stream, recording the wall time (ms,
    ``time.time`` basis — the same basis as the trace's HLC physical
    timestamps) each row id FIRST became visible on this node."""

    def __init__(self, node: int, client, sql: str):
        self.node = node
        self.sql = sql
        self.client = client
        self.seen_ms: dict[int, float] = {}
        self.stream = None
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        self.stream = await self.client.subscribe(self.sql)
        self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        try:
            async for ev in self.stream:
                now_ms = time.time() * 1000.0
                if "change" in ev:
                    _kind, _rowid, cells, _cid = ev["change"]
                    self.seen_ms.setdefault(int(cells[0]), now_ms)
                elif "row" in ev:
                    _rowid, cells = ev["row"]
                    self.seen_ms.setdefault(int(cells[0]), now_ms)
        except (ConnectionError, OSError, asyncio.IncompleteReadError,
                ValueError):
            pass

    async def stop(self) -> None:
        if self.stream is not None:
            self.stream.close()
        task, self._task = self._task, None
        if task is not None:
            try:
                await asyncio.wait_for(task, 5.0)
            except asyncio.TimeoutError:
                pass  # wait_for already cancelled the watcher task
            except asyncio.CancelledError:
                task.cancel()
                raise  # we were cancelled: propagate, don't absorb


async def run_live_workload(
    data_dir: str,
    arrivals,
    n_agents: int = 3,
    settle_timeout_s: float = 30.0,
    probes: int = 40,
    model: RoundModel | None = None,
    progress=None,
) -> dict:
    """Run a write workload against a live loopback cluster, tracing
    commits and sampling per-write visibility.

    ``arrivals`` is a list of ``(t_s, writer_idx)`` — writer ``w``'s
    writes fire open-loop at their scheduled offsets and commit rows
    ``w * WRITER_STRIDE + seq``. Returns the merged trace, per-(node,
    write) visibility latencies in wall ms, the calibrated
    :class:`RoundModel` measured on the same cluster (skipped when a
    pre-built ``model`` is supplied — no probe sampling or apply-rate
    train runs), and run facts.
    """
    from corrosion_tpu_torch.agent.testing import (
        launch_test_cluster, poll_until, stop_cluster,
    )
    from corrosion_tpu_torch.sim.trace import Trace

    def note(msg):
        if progress is not None:
            progress.write(f"[fidelity] {msg}\n")
            progress.flush()

    writers = sorted({w for _t, w in arrivals})
    if writers and writers[-1] >= n_agents:
        raise ValueError(
            f"workload writer {writers[-1]} needs >= {writers[-1] + 1} "
            f"agents, have {n_agents}"
        )
    agents = []
    watchers: list[VisibilityWatcher] = []
    trace = Trace()
    try:
        agents = await launch_test_cluster(data_dir, n_agents)
        note(f"{n_agents} agents up with full membership")
        for i, a in enumerate(agents):
            w = VisibilityWatcher(i, a.client, "SELECT id, text FROM tests")
            await w.start()
            watchers.append(w)

        # Calibrate on the SAME cluster the workload runs on — BEFORE
        # attaching the trace recorders, so the calibration write train
        # (tests2) never pollutes the compared workload's trace. A
        # pre-built model skips the measurement entirely.
        if model is None:
            model = await calibrate_live(agents, probes=probes)
            note(f"calibrated: {model.describe()}")
        else:
            note(f"pre-built model: {model.describe()}")
        for a in agents:
            trace.record(a.agent)

        # Open-loop write storm: arrivals fire on the wall-clock grid;
        # per-writer sequences stay ordered (versions must be contiguous
        # per actor for schedule_from_trace).
        seqs = {w: 0 for w in writers}
        loop = asyncio.get_running_loop()
        t0 = loop.time()

        async def fire(w: int, seq: int, at_s: float) -> None:
            delay = t0 + at_s - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            row = w * WRITER_STRIDE + seq
            await agents[w].client.execute([[
                "INSERT INTO tests (id, text) VALUES (?, ?)",
                [row, f"fid-w{w}-{seq}"],
            ]])

        # One ordered lane per writer; lanes run concurrently.
        lanes: dict[int, list] = {w: [] for w in writers}
        for t_s, w in sorted(arrivals):
            lanes[w].append((t_s, seqs[w]))
            seqs[w] += 1

        async def lane(w: int) -> None:
            for t_s, seq in lanes[w]:
                await fire(w, seq, t_s)

        note(f"firing {len(arrivals)} writes over {len(writers)} writers")
        await asyncio.gather(*(lane(w) for w in writers))

        all_rows = {
            w * WRITER_STRIDE + s for w in writers for s in range(seqs[w])
        }

        async def all_seen():
            return all(
                all_rows <= set(wt.seen_ms) for wt in watchers
            )

        try:
            await poll_until(all_seen, timeout=settle_timeout_s)
            note("all writes visible on every node")
        except TimeoutError:
            # Partial visibility is a RESULT (reported as unseen pairs),
            # not a harness crash — the divergence report must still
            # emit so the standing lane can flag it.
            note("settle timeout: some writes never became visible")
    finally:
        for w in watchers:
            await w.stop()
        actor_ids = [a.agent.actor_id for a in agents]
        await stop_cluster(agents)

    # Commit wall-ms per row id from the trace (actor w's k-th version is
    # its k-th fired row — per-writer lanes are strictly sequential).
    commit_ms: dict[int, float] = {}
    per_actor_count: dict[str, int] = {}
    for t_ms, actor, _v in sorted(trace.events):
        w = actor_ids.index(actor)
        k = per_actor_count.get(actor, 0)
        per_actor_count[actor] = k + 1
        commit_ms[w * WRITER_STRIDE + k] = float(t_ms)

    # REMOTE pairs only — the kernel side applies the same filter
    # (see kernel_replay): visibility of a write on nodes OTHER than
    # its writer is the dissemination quantity being validated.
    lat_ms: list[float] = []
    unseen = 0
    for wt in watchers:
        for row, t_commit in commit_ms.items():
            if row // WRITER_STRIDE == wt.node:
                continue  # the writer's own node
            t_seen = wt.seen_ms.get(row)
            if t_seen is None:
                unseen += 1
            else:
                lat_ms.append(max(t_seen - t_commit, 0.0))
    ttc_ms = (
        max(
            t for wt in watchers
            for r, t in wt.seen_ms.items()
            if r in commit_ms and r // WRITER_STRIDE != wt.node
        ) - min(commit_ms.values())
        if lat_ms else None
    )
    return {
        "trace": trace,
        "model": model,
        "lat_ms": lat_ms,
        "unseen": unseen,
        "pairs": len(lat_ms) + unseen,
        "ttc_ms": ttc_ms,
        "nodes": len(watchers),
        "writes": len(commit_ms),
    }


# ---------------------------------------------------------------------------
# Kernel side.


def kernel_replay(
    trace,
    round_ms: float,
    n_nodes: int,
    model: RoundModel | None = None,
    drain_rounds: int = 60,
    seed: int = 0,
    vis_offset_rounds: float = 0.5,
    device=None,
    **gossip_kw,
) -> dict:
    """Replay a recorded trace in the kernel at ``round_ms``, optionally
    with a model's compiled fault axes merged in (``RoundModel.apply`` →
    the chaos plane's ``apply_plan``). Returns per-pair visibility
    latencies in ROUNDS plus convergence facts. ``vis_offset_rounds`` is
    the round→wall discretization correction (RoundModel docstring) the
    wall-clock projections add — applied identically to calibrated and
    uncalibrated replays. Runs on ``device`` (default CUDA; raises when
    CUDA is absent and no device is given)."""
    from corrosion_tpu_torch.models.baselines import _cfg
    from corrosion_tpu_torch.sim.engine import simulate
    from corrosion_tpu_torch.sim.trace import schedule_from_trace

    device = resolve_device(device)

    actors, sched = schedule_from_trace(
        trace, round_ms=round_ms, drain_rounds=drain_rounds
    )
    w = len(actors)
    if n_nodes < w:
        raise ValueError(f"n_nodes {n_nodes} < {w} recorded writers")
    if model is not None:
        # Capacity deferral FIRST (it may extend the round count), then
        # the compiled miss/probe-loss axes.
        sched = model.defer_schedule(sched)
        sched = model.apply(sched, n_nodes=n_nodes)
    max_writes = int(sched.writes.max())
    cfg, topo = _cfg(
        n_nodes,
        writers=list(range(w)),
        sync_interval=4,
        n_cells=0,
        max_writes_per_round=max(4, max_writes),
        device=device,
        **gossip_kw,
    )
    final, curves = simulate(cfg, topo, sched, seed=seed, device=device)
    vis = final.vis_round.cpu().numpy()  # [S, N]
    lat_rounds = (
        vis.astype(np.float64) - sched.sample_round[:, None].astype(np.float64)
    )
    # REMOTE pairs only: a writer's visibility of its own write is a
    # local-matcher fact on both sides (live: the sub matcher fires on
    # the write path, ~instant; kernel: commit-round visibility), not a
    # dissemination measurement — it would only pad bucket 0 and, under
    # capacity deferral, pad it inconsistently.
    remote = np.ones_like(vis, dtype=bool)
    remote[np.arange(len(sched.sample_writer)), sched.sample_writer] = False
    seen = (vis >= 0) & remote
    unseen = int(((vis < 0) & remote).sum())
    ttc_ms = (
        float(
            (vis[remote].max() + vis_offset_rounds
             - sched.sample_round.min()) * round_ms
        )
        if unseen == 0 and vis.size and remote.any() else None
    )
    return {
        "round_ms": round_ms,
        "rounds": sched.rounds,
        "lat_rounds": lat_rounds[seen].ravel(),
        "vis_offset_rounds": vis_offset_rounds,
        "unseen": unseen,
        "pairs": int(remote.sum()),
        "ttc_ms": ttc_ms,
        "need_last": float(np.asarray(curves["need"])[-1]),
    }


# ---------------------------------------------------------------------------
# The whole comparison.


def _side_report(live: dict, rep: dict, cal_round_ms: float) -> dict:
    """Fold one kernel replay into the common calibrated bucket space and
    attach its divergence verdict against the live histograms."""
    from corrosion_tpu_torch.sim.telemetry import VIS_LAT_EDGES

    scale = rep["round_ms"] / cal_round_ms
    offset = rep["vis_offset_rounds"]
    hist = bucket_hist((np.asarray(rep["lat_rounds"]) + offset) * scale)
    live_hist = bucket_hist(np.asarray(live["lat_ms"]) / cal_round_ms)
    if sum(live_hist) == 0 or sum(hist) == 0:
        # Nothing ever delivered on one side: still a REPORT (the gate's
        # unseen/missing-ceiling breaches flag it), never a crash — the
        # standing lane must emit its artifact for a broken run too.
        return {
            "round_ms": round(rep["round_ms"], 4),
            "rounds": rep["rounds"],
            "pairs": rep["pairs"],
            "unseen": rep["unseen"],
            "hist": hist,
            "cdf": [],
            "ttc_ms": rep["ttc_ms"],
            "ttc_delta_ms": None,
        }
    v = divergence_verdict(live_hist, hist)
    edges_ms = [e * cal_round_ms for e in VIS_LAT_EDGES]

    def edge_ms(bucket: int) -> float:
        return (
            edges_ms[bucket] if bucket < len(edges_ms) else float("inf")
        )

    live_p50 = np.percentile(live["lat_ms"], 50) if live["lat_ms"] else None
    live_p99 = np.percentile(live["lat_ms"], 99) if live["lat_ms"] else None
    kern = (np.asarray(rep["lat_rounds"]) + offset) * rep["round_ms"]
    out = {
        "round_ms": round(rep["round_ms"], 4),
        "rounds": rep["rounds"],
        "pairs": rep["pairs"],
        "unseen": rep["unseen"],
        "hist": hist,
        "cdf": [round(c, 6) for c in hist_cdf(hist)],
        **v,
        "p50_edge_ms": edge_ms(v["p50_bucket"]),
        "p99_edge_ms": edge_ms(v["p99_bucket"]),
        "ttc_ms": rep["ttc_ms"],
        "ttc_delta_ms": (
            None if rep["ttc_ms"] is None or live["ttc_ms"] is None
            else round(abs(rep["ttc_ms"] - live["ttc_ms"]), 2)
        ),
    }
    # Each ratio guards on its OWN denominator: a loopback live p50 can
    # legitimately clamp to 0.0 ms while p99 stays well-defined.
    if kern.size and live_p50 is not None and live_p50 > 0:
        out["p50_ratio"] = round(float(np.percentile(kern, 50)) / live_p50, 3)
    if kern.size and live_p99 is not None and live_p99 > 0:
        out["p99_ratio"] = round(float(np.percentile(kern, 99)) / live_p99, 3)
    return out


async def compare_live_kernel(
    data_dir: str,
    arrivals,
    n_agents: int = 3,
    model: RoundModel | None = None,
    seed: int = 0,
    settle_timeout_s: float = 30.0,
    progress=None,
    device=None,
) -> dict:
    """The mixed-mode harness: one workload, both sides, calibrated and
    uncalibrated kernel replays, one divergence report block. A
    pre-built ``model`` skips the in-run calibration (CLI ``--model``).
    The replays run on ``device`` (default CUDA; raises when CUDA is
    absent and no device is given, before the live cluster starts)."""
    device = resolve_device(device)
    live = await run_live_workload(
        data_dir, arrivals, n_agents=n_agents,
        settle_timeout_s=settle_timeout_s, model=model, progress=progress,
    )
    mdl = live["model"]
    cal = kernel_replay(
        live["trace"], mdl.round_ms, n_nodes=live["nodes"], model=mdl,
        seed=seed, vis_offset_rounds=mdl.vis_offset_rounds, device=device,
    )
    uncal = kernel_replay(
        live["trace"], REFERENCE_ROUND_MS, n_nodes=live["nodes"], model=None,
        seed=seed, vis_offset_rounds=mdl.vis_offset_rounds, device=device,
    )
    live_hist = bucket_hist(np.asarray(live["lat_ms"]) / mdl.round_ms)
    cal_rep = _side_report(live, cal, mdl.round_ms)
    uncal_rep = _side_report(live, uncal, mdl.round_ms)
    return {
        "trace_fingerprint": trace_fingerprint(live["trace"].events),
        "model": mdl.to_dict(),
        "live": {
            "nodes": live["nodes"],
            "writes": live["writes"],
            "pairs": live["pairs"],
            "unseen": live["unseen"],
            "hist": live_hist,
            "cdf": [round(c, 6) for c in hist_cdf(live_hist)],
            "lat_p50_ms": (
                round(float(np.percentile(live["lat_ms"], 50)), 2)
                if live["lat_ms"] else None
            ),
            "lat_p99_ms": (
                round(float(np.percentile(live["lat_ms"], 99)), 2)
                if live["lat_ms"] else None
            ),
            "ttc_ms": (
                round(live["ttc_ms"], 2) if live["ttc_ms"] is not None
                else None
            ),
        },
        "calibrated": cal_rep,
        "uncalibrated": uncal_rep,
        # Strictly-closer ordering; a degraded side (no CDF — nothing
        # delivered) can never claim the win.
        "calibrated_closer": (
            cal_rep.get("cdf_distance") is not None
            and uncal_rep.get("cdf_distance") is not None
            and cal_rep["cdf_distance"] < uncal_rep["cdf_distance"]
        ),
    }

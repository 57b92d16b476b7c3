"""Convergence health analyzer: flight records -> protocol verdicts
(counterpart of corrosion_tpu/sim/health.py), and the demo scenarios.

The engines' health curves (``telemetry.HEALTH_CURVE_KEYS``) measure
staleness, delivery latency, SWIM misbelief and backlog per round; this
host side (numpy, as in the reference) derives the run-level verdicts
from them, in memory or replayed from a flight JSONL:

- **time-to-convergence**: the first round after which need, membership
  mismatches and staleness stay zero;
- **staleness percentiles** and the peak single-node lag;
- **delivery-latency CDF** over the on-device histogram buckets
  (``VIS_LAT_EDGES``), with bucket-resolution p50/p99;
- **per-churn-event detection latency** from ``swim_undetected_deaths``;
- **recovery after heal** (``recovery_after_heal``), the chaos plane's
  verdict.

``publish_report`` folds the verdicts into a registry as
``corro_kernel_health_*`` gauges and ``diff_reports`` flags regressions
between two reports. ``churned_demo_cluster`` builds the reference's
committed convergence and epidemic scenarios from the same seed, and
``record_demo_flight`` records one.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import asdict, dataclass, field, replace

import numpy as np

from corrosion_tpu_torch.models.baselines import _cfg
from corrosion_tpu_torch.sim.engine import Schedule
from corrosion_tpu_torch.sim.telemetry import (
    VIS_LAT_EDGES,
    VIS_LAT_KEYS,
    curve_array,
    replay_flight,
)

REPORT_SCHEMA = "corro-convergence-report/1"


def flight_header(path: str) -> dict:
    """First ``{"kind": "flight", ...}`` record of a flight JSONL (the
    engine + open timestamp), or {} for a headerless/garbage file."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if obj.get("kind") == "flight":
                return obj
            return {}
    return {}


def iter_flight(path: str, follow: bool = False, poll_s: float = 0.25,
                idle_timeout_s: float | None = None):
    """Yield parsed records from a flight JSONL, optionally tailing a
    file that is still being written.

    Only whole lines are consumed: a partially-flushed tail line is held
    back until its newline arrives (``follow=True``) or skipped at EOF
    (``follow=False``). Garbage lines (a crash's torn write) are
    skipped, like ``replay_flight``. ``idle_timeout_s`` bounds how long
    a follow waits without new data before giving up (None = forever).

    **Rotation-aware** (``follow=True``): the size-capped recorder
    renames the live file to ``path.N`` and opens a fresh ``path``
    (``FlightRecorder.max_bytes``) — a follower holding the old handle
    would silently stop seeing records. At EOF the live file's inode is
    re-checked; on a rotation the old handle is drained to completion
    (the renamed file keeps serving its fd), then the follower replays
    any gap through the rotated segment chain (segment headers carry
    their index; header ``S`` lives at ``path.{S+1}`` once rotated —
    the ``flight_segments`` naming contract) before resuming on the
    live file. No record is lost or re-read across any number of
    rotations between polls.
    """
    cur_path = path
    cur_seg: int | None = None
    opened_any = False
    idle = 0.0
    while True:
        try:
            f = open(cur_path)
        except FileNotFoundError:
            if not opened_any:
                raise  # a missing/typo'd path is an error, not an empty tail
            # Mid-rotation race: the live path is briefly absent between
            # os.replace and the fresh open. Poll, don't die.
            if not follow:
                return
            if idle_timeout_s is not None and idle >= idle_timeout_s:
                return
            time.sleep(poll_s)
            idle += poll_s
            continue
        opened_any = True
        redirect = False  # gap-detection already chose the next file
        with f:
            ino = os.fstat(f.fileno()).st_ino
            buf = ""
            while True:
                chunk = f.readline()
                if chunk:
                    buf += chunk
                    if not buf.endswith("\n"):
                        continue  # partial line: wait for the rest
                    line, buf = buf.strip(), ""
                    idle = 0.0
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue
                    if obj.get("kind") == "flight" and "segment" in obj:
                        seg = int(obj["segment"])
                        if cur_seg is not None and seg > cur_seg + 1:
                            # This file starts PAST the next unread
                            # segment — the recorder rotated between
                            # our exists() probe and the open (the
                            # check-then-open race). Replay the missed
                            # segment(s) first; this file is revisited
                            # through the normal chain advance, from
                            # the top, nothing yielded from this visit.
                            missed = f"{path}.{cur_seg + 2}"
                            if os.path.exists(missed):
                                cur_path = missed
                                redirect = True
                                break
                        cur_seg = seg
                    yield obj
                    continue
                # EOF on the current handle.
                if not follow:
                    return
                if cur_path != path:
                    break  # finished replaying a rotated segment
                try:
                    rotated = os.stat(path).st_ino != ino
                except FileNotFoundError:
                    rotated = True
                if rotated:
                    break  # old live file fully drained — advance
                if idle_timeout_s is not None and idle >= idle_timeout_s:
                    return
                time.sleep(poll_s)
                idle += poll_s
        # Advance along the segment chain: the file just drained carried
        # header segment ``cur_seg`` (rotated name path.{cur_seg+1}), so
        # the next unread segment's header is cur_seg+1 — at
        # path.{cur_seg+2} when it too already rotated, else the live
        # file (whose header is re-checked on open: if it rotated again
        # between this probe and the open, the gap detection above
        # redirects to the missed segment without yielding anything).
        if not redirect:
            nxt = None
            if cur_seg is not None:
                cand = f"{path}.{cur_seg + 2}"
                if os.path.exists(cand):
                    nxt = cand
            cur_path = nxt if nxt is not None else path


# Shared zero-fill curve accessor (telemetry.curve_array): old flight
# files predating a plane replay as all-zero for its keys.
_arr = curve_array


def detection_latencies(undetected: np.ndarray,
                        kill_rounds=None) -> list[dict]:
    """Per-churn-event rounds-to-detection from the
    ``swim_undetected_deaths`` curve.

    Without ``kill_rounds``: each excursion of the curve above zero is
    one (possibly merged) churn event; its detection latency is the
    excursion length in rounds, ``None`` while still unresolved at the
    end of the record. With ``kill_rounds`` (the schedule's ground
    truth): one event per kill round, detected at the first later round
    where the curve returns to zero — overlapping kills then get their
    own per-event latencies instead of one merged excursion.

    Caveat: the curve counts (live observer, DEAD target) misbeliefs, so
    a victim's REVIVAL vacuously clears its pairs — the reported latency
    is "rounds until no live observer believed a dead node up", an upper
    bound clipped at the kill→revive gap when SWIM had not finished
    declaring the death by then. Schedules meant to measure pure
    detection speed should revive well after ``suspect_rounds`` plus
    dissemination time (churned_demo_cluster's rounds//4 → rounds//2
    spacing leaves ~rounds/4 rounds, ample for the default config).
    """
    u = np.asarray(undetected, dtype=np.float64)
    events: list[dict] = []
    if kill_rounds is not None:
        for k in kill_rounds:
            k = int(k)
            after = np.nonzero((np.arange(len(u)) >= k) & (u == 0))[0]
            events.append({
                "round": k,
                "detected_rounds": (
                    int(after[0] - k) if after.size else None
                ),
            })
        return events
    above = u > 0
    start = None
    for r, a in enumerate(above):
        if a and start is None:
            start = r
        elif not a and start is not None:
            events.append({"round": start, "detected_rounds": r - start})
            start = None
    if start is not None:
        events.append({"round": start, "detected_rounds": None})
    return events


def recovery_after_heal(
    curves: dict, heal_round: int, round_ms: float = 500.0,
    require_membership: bool = False,
) -> dict:
    """Recovery-time-after-heal: how long the protocol took to go quiet
    once the last injected fault cleared (the chaos plane's headline
    verdict, consumed by sim/invariants.py).

    Quiet means ``need == 0``, ``staleness_sum == 0``, and
    ``swim_undetected_deaths == 0`` sustained to the end of the record.
    ``mismatches`` joins the predicate only with
    ``require_membership=True``: suspect/down beliefs about LIVE nodes
    are sticky by design until down-GC forgets them (the reference's
    ``remove_down_after`` is 48 h), so a probe-loss storm legitimately
    leaves nonzero mismatches long after the data plane recovered.

    Returns ``{"heal_round", "recovered_round", "recovery_rounds",
    "recovery_s"}`` with Nones when the record never recovers.
    """
    need = _arr(curves, "need")
    rounds = len(need)

    def _get(key):
        # Zero-fill anchored on the need curve: partial dicts (tests,
        # pre-health flight replays) must not break the broadcast.
        if key in curves:
            return np.asarray(curves[key], dtype=np.float64)
        return np.zeros(rounds, dtype=np.float64)

    stale = _get("staleness_sum")
    undet = _get("swim_undetected_deaths")
    quiet = (need == 0) & (stale == 0) & (undet == 0)
    if require_membership:
        quiet &= _get("mismatches") == 0
    recovered: int | None = None
    if rounds and quiet[-1]:
        nonquiet = np.nonzero(~quiet)[0]
        recovered = int(nonquiet[-1]) + 1 if nonquiet.size else 0
        recovered = max(recovered, int(heal_round))
    rec_rounds = None if recovered is None else recovered - int(heal_round)
    return {
        "heal_round": int(heal_round),
        "recovered_round": recovered,
        "recovery_rounds": rec_rounds,
        "recovery_s": (
            None if rec_rounds is None
            else rec_rounds * round_ms / 1000.0
        ),
    }


def cdf_quantile(counts: np.ndarray, q: float) -> tuple[int, float]:
    """(bucket index, upper edge in rounds) of quantile ``q`` over the
    fixed delivery-latency buckets; the overflow bucket's edge is inf.
    Returns (-1, nan) when the histogram is empty."""
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        return -1, float("nan")
    cdf = np.cumsum(counts) / total
    idx = int(np.searchsorted(cdf, q, side="left"))
    idx = min(idx, len(counts) - 1)
    edge = (
        float(VIS_LAT_EDGES[idx]) if idx < len(VIS_LAT_EDGES)
        else float("inf")
    )
    return idx, edge


def latency_bucket(lat_rounds: float) -> int:
    """Bucket index a latency (in rounds) lands in — the host-side twin
    of the on-device bucketize, for agreement checks."""
    idx = 0
    for e in VIS_LAT_EDGES:
        if lat_rounds > e:
            idx += 1
    return idx


@dataclass
class ConvergenceReport:
    """Run-level protocol-health verdicts derived from round curves."""

    engine: str = "unknown"
    rounds: int = 0
    round_ms: float = 500.0
    # Convergence
    converged_round: int | None = None  # first all-quiet round
    ttc_s: float | None = None  # converged_round in simulated seconds
    need_last: float = 0.0
    mismatches_last: float = 0.0
    staleness_last: float = 0.0
    # Staleness over the run
    staleness_p50: float = float("nan")
    staleness_p99: float = float("nan")
    staleness_max_peak: float = 0.0
    # Delivery latency (from the on-device histogram alone)
    vis_total: int = 0
    vis_hist: list = field(default_factory=list)  # counts per bucket
    vis_cdf: list = field(default_factory=list)  # cumulative fractions
    vis_p50_bucket: int = -1
    vis_p99_bucket: int = -1
    vis_p50_s: float = float("nan")  # bucket upper edge, seconds
    vis_p99_s: float = float("nan")
    # SWIM health
    false_alarms_total: float = 0.0
    flaps_total: float = 0.0
    detection_events: list = field(default_factory=list)
    detection_max_rounds: int | None = None
    undetected_unresolved: int = 0  # events still open at record end
    # Backlog
    queue_backlog_peak: float = 0.0
    queue_backlog_last: float = 0.0
    # Traffic totals (context for diffs)
    msgs_total: float = 0.0
    applied_total: float = 0.0
    sessions_total: float = 0.0

    def to_dict(self) -> dict:
        """JSON-safe dict: strict parsers reject NaN/Infinity, so NaN
        (no data) serializes as null and inf (overflow bucket) as the
        string "inf" — ``load_report`` round-trips both."""
        d = {k: _json_num(v) for k, v in asdict(self).items()}
        d["schema"] = REPORT_SCHEMA
        return d

    @property
    def converged(self) -> bool:
        return self.converged_round is not None

    def render(self) -> str:
        """Human-readable report."""
        rm = self.round_ms / 1000.0

        def s(x):
            if x is None or (isinstance(x, float) and math.isnan(x)):
                return "n/a"
            return f"{x:g}"

        def lat(x):
            """Latency with its own unit: overflow-bucket values render
            as '>edge s' so callers never append another 's'."""
            if x is None or (isinstance(x, float) and math.isnan(x)):
                return "n/a"
            if isinstance(x, float) and math.isinf(x):
                return f">{VIS_LAT_EDGES[-1] * rm:g}s"
            return f"{x:g}s"

        lines = [
            f"engine={self.engine} rounds={self.rounds} "
            f"round_ms={self.round_ms:g}",
            (
                f"converged: yes at round {self.converged_round} "
                f"({self.ttc_s:g}s simulated)"
                if self.converged
                else f"converged: NO (need={s(self.need_last)} "
                f"mismatches={s(self.mismatches_last)} "
                f"staleness={s(self.staleness_last)} at record end)"
            ),
            f"staleness: p50={s(self.staleness_p50)} "
            f"p99={s(self.staleness_p99)} "
            f"worst_node_peak={s(self.staleness_max_peak)} "
            f"last={s(self.staleness_last)}",
        ]
        if self.vis_total:
            marks = [f"{e * rm:g}s" for e in VIS_LAT_EDGES] + ["inf"]
            cdf = " ".join(
                f"<={m}:{c * 100:.1f}%"
                for m, c in zip(marks, self.vis_cdf)
            )
            lines.append(
                f"delivery latency ({self.vis_total} events): "
                f"p50<={lat(self.vis_p50_s)} p99<={lat(self.vis_p99_s)}"
            )
            lines.append(f"  CDF: {cdf}")
        else:
            lines.append("delivery latency: no visibility events recorded")
        det = [
            e["detected_rounds"] for e in self.detection_events
            if e["detected_rounds"] is not None
        ]
        lines.append(
            f"swim: false_alarm_pair_rounds={s(self.false_alarms_total)} "
            f"flaps={s(self.flaps_total)} churn_events="
            f"{len(self.detection_events)} "
            + (
                f"detection_rounds_max={max(det)} " if det else ""
            )
            + f"unresolved={self.undetected_unresolved}"
        )
        lines.append(
            f"backlog: queue_peak={s(self.queue_backlog_peak)} "
            f"queue_last={s(self.queue_backlog_last)}"
        )
        lines.append(
            f"traffic: msgs={s(self.msgs_total)} "
            f"applied={s(self.applied_total)} "
            f"sessions={s(self.sessions_total)}"
        )
        return "\n".join(lines)


def report_from_curves(
    curves: dict,
    engine: str = "unknown",
    round_ms: float = 500.0,
    kill_rounds=None,
) -> ConvergenceReport:
    """Derive a ConvergenceReport from per-round curves (any engine's
    ``round_curves`` output, or a ``replay_flight`` reconstruction)."""
    need = _arr(curves, "need")
    mism = _arr(curves, "mismatches")
    stale = _arr(curves, "staleness_sum")
    rounds = len(need)

    quiet = (need == 0) & (mism == 0) & (stale == 0)
    converged_round: int | None = None
    if rounds and quiet[-1]:
        # First round of the trailing all-quiet run.
        nonquiet = np.nonzero(~quiet)[0]
        converged_round = int(nonquiet[-1]) + 1 if nonquiet.size else 0

    hist = np.asarray(
        [_arr(curves, k).sum() for k in VIS_LAT_KEYS], dtype=np.float64
    )
    total = int(hist.sum())
    cdf = (np.cumsum(hist) / total).tolist() if total else []
    p50_b, p50_edge = cdf_quantile(hist, 0.50)
    p99_b, p99_edge = cdf_quantile(hist, 0.99)
    rm = round_ms / 1000.0

    undetected = _arr(curves, "swim_undetected_deaths")
    events = detection_latencies(undetected, kill_rounds=kill_rounds)
    det = [e["detected_rounds"] for e in events
           if e["detected_rounds"] is not None]

    backlog = _arr(curves, "queue_backlog")
    stale_max = _arr(curves, "staleness_max")
    return ConvergenceReport(
        engine=engine,
        rounds=rounds,
        round_ms=round_ms,
        converged_round=converged_round,
        ttc_s=(
            None if converged_round is None else converged_round * rm
        ),
        need_last=float(need[-1]) if rounds else 0.0,
        mismatches_last=float(mism[-1]) if rounds else 0.0,
        staleness_last=float(stale[-1]) if rounds else 0.0,
        staleness_p50=(
            float(np.percentile(stale, 50)) if rounds else float("nan")
        ),
        staleness_p99=(
            float(np.percentile(stale, 99)) if rounds else float("nan")
        ),
        staleness_max_peak=float(stale_max.max()) if rounds else 0.0,
        vis_total=total,
        vis_hist=hist.astype(np.int64).tolist(),
        vis_cdf=cdf,
        vis_p50_bucket=p50_b,
        vis_p99_bucket=p99_b,
        vis_p50_s=p50_edge * rm,
        vis_p99_s=p99_edge * rm,
        false_alarms_total=float(_arr(curves, "swim_false_alarms").sum()),
        flaps_total=float(_arr(curves, "swim_flaps").sum()),
        detection_events=events,
        detection_max_rounds=max(det) if det else None,
        undetected_unresolved=sum(
            1 for e in events if e["detected_rounds"] is None
        ),
        queue_backlog_peak=float(backlog.max()) if rounds else 0.0,
        queue_backlog_last=float(backlog[-1]) if rounds else 0.0,
        msgs_total=float(_arr(curves, "msgs").sum()),
        applied_total=float(
            _arr(curves, "applied_broadcast").sum()
            + _arr(curves, "applied_sync").sum()
        ),
        sessions_total=float(_arr(curves, "sessions").sum()),
    )


def report_from_flight(
    path: str, round_ms: float = 500.0, kill_rounds=None
) -> ConvergenceReport:
    """ConvergenceReport from a flight-recorder JSONL alone — the crashed
    or still-running run's record is enough; no final state needed."""
    curves, _chunks = replay_flight(path)
    engine = flight_header(path).get("engine", "unknown")
    return report_from_curves(
        curves, engine=engine, round_ms=round_ms, kill_rounds=kill_rounds
    )


def load_report(path: str, round_ms: float = 500.0) -> ConvergenceReport:
    """Load a report from either a flight JSONL or a saved report JSON
    (``ConvergenceReport.to_dict`` as JSON)."""
    # Classify by parsing the FIRST LINE as JSON and looking at its keys:
    # a flight JSONL's first record is {"kind": "flight"|...}, a saved
    # report is one JSON object whose "schema" names the report format.
    # (A fixed-size substring sniff misclassifies large reports whose
    # trailing schema key falls outside the sniffed prefix.)
    with open(path) as f:
        first = f.readline().strip()
    obj = None
    try:
        obj = json.loads(first)
    except ValueError:
        # Not one-object-per-line: a pretty-printed report parses as a
        # whole file; anything else falls through to the flight reader.
        try:
            with open(path) as f:
                obj = json.load(f)
        except ValueError:
            pass
    if isinstance(obj, dict) and "kind" not in obj:
        if obj.get("schema") != REPORT_SCHEMA:
            raise ValueError(
                f"{path}: not a flight JSONL or {REPORT_SCHEMA} report"
            )
        obj.pop("schema", None)
        # Undo the JSON-safe encoding (to_dict): null -> NaN on float
        # fields, "inf" -> inf.
        nan_fields = {
            "staleness_p50", "staleness_p99", "vis_p50_s", "vis_p99_s",
        }
        for k, v in obj.items():
            if v == "inf":
                obj[k] = float("inf")
            elif v is None and k in nan_fields:
                obj[k] = float("nan")
        return ConvergenceReport(**obj)
    return report_from_flight(path, round_ms=round_ms)


def publish_report(registry, report: ConvergenceReport,
                   engine: str | None = None) -> None:
    """Fold run-level verdicts into a MetricsRegistry as
    ``corro_kernel_health_*`` gauges (the per-round curve series are
    published by ``telemetry.publish_curves``).

    Latency sentinels: -1 = no data (no visibility events), -2 = the
    percentile landed in the overflow bucket (worse than every finite
    edge — the regression case); ``vis_overflow_events`` carries the raw
    overflow-bucket count so dashboards can alert on it directly.
    """
    eng = engine or report.engine

    def lat_sentinel(x: float) -> float:
        if x is None or math.isnan(x):
            return -1.0
        if math.isinf(x):
            return -2.0
        return x

    overflow_events = float(report.vis_hist[-1]) if report.vis_hist else 0.0
    g = [
        ("converged", 1.0 if report.converged else 0.0,
         "run reached all-quiet convergence"),
        ("converged_round",
         float(report.converged_round)
         if report.converged_round is not None else -1.0,
         "first all-quiet round (-1 = never)"),
        ("staleness_p99", _nan_to(report.staleness_p99, -1.0),
         "p99 of per-round cluster staleness mass"),
        ("staleness_peak", report.staleness_max_peak,
         "worst single-node watermark lag seen"),
        ("vis_p50_seconds", lat_sentinel(report.vis_p50_s),
         "delivery latency p50 (bucket upper edge, simulated s; "
         "-1 = no data, -2 = overflow bucket)"),
        ("vis_p99_seconds", lat_sentinel(report.vis_p99_s),
         "delivery latency p99 (bucket upper edge, simulated s; "
         "-1 = no data, -2 = overflow bucket)"),
        ("vis_overflow_events", overflow_events,
         "visibility events past the last finite latency edge"),
        ("detection_max_rounds",
         float(report.detection_max_rounds)
         if report.detection_max_rounds is not None else -1.0,
         "slowest churn-event rounds-to-detection"),
        ("queue_backlog_peak", report.queue_backlog_peak,
         "peak pending-broadcast backlog"),
    ]
    for name, value, help_ in g:
        registry.gauge(
            f"corro_kernel_health_{name}", f"health plane: {help_}"
        ).set(float(value), engine=eng)


def _nan_to(x: float, repl: float) -> float:
    return repl if (x is None or math.isnan(x) or math.isinf(x)) else x


def _json_num(x):
    """JSON-safe scalar: NaN -> null, +/-inf -> "inf" (strict parsers
    reject the Python json module's bare NaN/Infinity tokens)."""
    if isinstance(x, float):
        if math.isnan(x):
            return None
        if math.isinf(x):
            return "inf"
    return x


# Metrics compared by ``diff_reports``: (field, larger-is-worse, absolute slack
# added to the tolerance band — keeps zero/zero and bucket-edge jitter
# from flagging).
DIFF_METRICS = (
    ("converged_round", True, 2.0),
    ("vis_p50_s", True, 0.0),
    ("vis_p99_s", True, 0.0),
    ("staleness_p99", True, 1.0),
    ("staleness_max_peak", True, 1.0),
    ("detection_max_rounds", True, 2.0),
    ("queue_backlog_peak", True, 8.0),
    ("undetected_unresolved", True, 0.0),
)


def diff_reports(
    baseline: ConvergenceReport,
    candidate: ConvergenceReport,
    tolerance: float = 0.2,
) -> dict:
    """BENCH-style regression diff: flag candidate metrics worse than
    baseline by more than ``tolerance`` (relative) plus a per-metric
    absolute slack. Non-convergence where the baseline converged is
    always a regression. Returns {"regressions": [...], "rows": [...]}.
    """
    rows = []
    regressions = []
    if baseline.converged and not candidate.converged:
        regressions.append(
            "candidate did not converge (baseline did: round "
            f"{baseline.converged_round})"
        )
    for name, larger_worse, slack in DIFF_METRICS:
        a = getattr(baseline, name)
        b = getattr(candidate, name)
        # inf is a real (worst-bucket) value and must participate in the
        # comparison — a candidate regressing into the overflow bucket is
        # exactly what the gate exists to catch; only unknowns skip.
        af = float(a) if a is not None else math.nan
        bf = float(b) if b is not None else math.nan
        row = {
            "metric": name, "baseline": _json_num(a),
            "candidate": _json_num(b), "ok": True,
        }
        if not (math.isnan(af) or math.isnan(bf)):
            if larger_worse:
                worse = bf > af * (1.0 + tolerance) + slack
            else:
                worse = bf < af * (1.0 - tolerance) - slack
            if worse:
                row["ok"] = False
                regressions.append(
                    f"{name}: {b} vs baseline {a} "
                    f"(tolerance {tolerance:.0%} + {slack:g})"
                )
        rows.append(row)
    return {"regressions": regressions, "rows": rows}


GEO_REGIONS = 4  # region count of the geo scenario family (<= PROP_REGIONS)

# The three mechanisms composed, as the reference's epidemic smoke, its
# `obs record --adaptive` and its tests run them.
ADAPTIVE_GOSSIP = {
    "rumor_kill_k": 2,
    "pull_switch_age": 2,
    "age_forward": True,
}


def churned_demo_cluster(
    nodes: int = 128,
    rounds: int = 64,
    samples: int = 64,
    churn: bool = True,
    seed: int = 0,
    geo: bool = False,
    adaptive: bool = False,
    device=None,
):
    """Small dense cluster with a kill/revive wave of ``nodes // 16``
    non-writer nodes (killed at ``rounds // 4``, revived by ``rounds //
    2``), writers at 15% a round and a drained last third. ``geo=True``:
    ``GEO_REGIONS`` regions on the circle geography, writers spread
    around it, ``prop_observe`` on; ``adaptive=True`` (geo only) adds
    ``ADAPTIVE_GOSSIP``. Returns (ClusterConfig, Topology, Schedule,
    kill_rounds), the topology on ``device``."""
    n_writers = max(4, min(16, nodes // 8))
    if adaptive and not geo:
        raise ValueError(
            "adaptive=True is defined for the geo scenario family only "
            "(the flat variant's RNG stream is pinned pre-adaptive)"
        )
    adaptive_kw = dict(ADAPTIVE_GOSSIP) if adaptive else {}
    if geo:
        sizes = [nodes // GEO_REGIONS] * GEO_REGIONS
        sizes[-1] += nodes - sum(sizes)
        writers = sorted({
            min(round(i * nodes / n_writers), nodes - 1) for i in range(n_writers)
        })
        n_writers = len(writers)
        cfg, topo = _cfg(
            nodes, writers=writers, regions=sizes, region_rtt="geo",
            sync_interval=5, n_cells=0, prop_observe=True, device=device,
            **adaptive_kw,
        )
        writer_set = set(writers)
        non_writers = np.asarray([i for i in range(nodes) if i not in writer_set])
    else:
        cfg, topo = _cfg(
            nodes, writers=list(range(n_writers)), sync_interval=5, n_cells=0,
            device=device,
        )
        non_writers = np.arange(n_writers, nodes)
    rng = np.random.default_rng(seed)
    writes = (rng.random((rounds, n_writers)) < 0.15).astype(np.uint32)
    drain = max(rounds // 3, 1)
    writes[rounds - drain :, :] = 0
    kill = revive = None
    kill_rounds: list[int] = []
    if churn and rounds >= 16:
        kill = np.zeros((rounds, nodes), bool)
        revive = np.zeros((rounds, nodes), bool)
        victims = rng.choice(non_writers, size=max(nodes // 16, 1), replace=False)
        k_at = rounds // 4
        r_at = min(rounds // 2, rounds - drain)
        kill[k_at, victims] = True
        revive[r_at, victims] = True
        kill_rounds = [k_at]
    sched = Schedule(writes=writes, kill=kill, revive=revive).make_samples(samples)
    return cfg, topo, sched, kill_rounds


def with_adaptive(cfg, **gossip_kw):
    """``cfg`` (any engine's config) with ``ADAPTIVE_GOSSIP`` and
    ``gossip_kw`` set on its gossip config: ``with_adaptive(cfg,
    sync_sketch_buckets=8)`` is the reference tests' ``composed_sketch``
    tuning."""
    return replace(cfg, gossip=replace(cfg.gossip, **ADAPTIVE_GOSSIP, **gossip_kw))


def record_demo_flight(
    out: str,
    nodes: int = 128,
    rounds: int = 64,
    churn: bool = False,
    seed: int = 0,
    progress=None,
    geo: bool = False,
    adaptive: bool = False,
    device=None,
) -> dict:
    """Run ``churned_demo_cluster`` on the dense engine in chunks of
    ``rounds // 4``, recording a flight JSONL at ``out``. Returns the run's
    facts (kill rounds, convergence). Runs on ``device`` (default CUDA;
    raises when CUDA is absent and no device is given)."""
    from corrosion_tpu_torch.sim.engine import simulate
    from corrosion_tpu_torch.sim.telemetry import FlightRecorder, KernelTelemetry

    cfg, topo, sched, kill_rounds = churned_demo_cluster(
        nodes=nodes, rounds=rounds, churn=churn, seed=seed, geo=geo,
        adaptive=adaptive, device=device,
    )
    tele = KernelTelemetry(
        engine="dense", progress=progress,
        recorder=FlightRecorder(out, engine="dense", mode="w"),
    )
    try:
        _final, curves = simulate(
            cfg, topo, sched, seed=seed, max_chunk=max(rounds // 4, 1),
            telemetry=tele, device=device,
        )
    finally:
        tele.recorder.close()
    # The first round after which outstanding need stays zero.
    need = np.asarray(curves["need"], dtype=np.float64)
    nz = np.nonzero(need > 0)[0]
    if need.size and float(need[-1]) == 0.0:
        converged_round = int(nz[-1]) + 1 if nz.size else 0
    else:
        converged_round = None
    return {
        "flight": os.path.abspath(out),
        "nodes": nodes,
        "rounds": rounds,
        "geo": geo,
        "adaptive": adaptive,
        "regions": GEO_REGIONS if geo else 1,
        "fanout": cfg.gossip.fanout,
        "kill_rounds": kill_rounds,
        "need_last": float(need[-1]) if need.size else None,
        "converged_round": converged_round,
        "staleness_last": float(np.asarray(curves["staleness_sum"])[-1]),
        "mismatches_last": float(np.asarray(curves["mismatches"])[-1]),
    }

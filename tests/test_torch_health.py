"""The convergence health analyzer (``sim/health.py``) against the live JAX
reference on the CPU: ``record_demo_flight`` at the committed scenario
(96 nodes, 48 rounds, churn, seed 0) records the reference's flight and
facts, and the reports built from the same curves or the same flight
(``report_from_curves``, ``report_from_flight``, ``load_report``,
``diff_reports``, ``publish_report``) are equal, field for field. Also
the detection, recovery and bucket helpers, and ``iter_flight`` tailing a
file a writer thread is still writing.
"""

import json
import math
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from corrosion_tpu.sim import health as jh
from corrosion_tpu.utils.metrics import MetricsRegistry
from corrosion_tpu_torch.sim import health as th
from corrosion_tpu_torch.sim import telemetry as tt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEMO = dict(nodes=96, rounds=48, churn=True, seed=0)


def _flight_lines(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("t_unix", None)
        rec.pop("wall_s", None)
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    facts_t = th.record_demo_flight(str(d / "t.jsonl"), **DEMO, device="cpu")
    facts_j = jh.record_demo_flight(str(d / "j.jsonl"), **DEMO)
    return d, facts_t, facts_j


def _same_report(a, b):
    assert a.to_dict() == b.to_dict()
    assert a.render() == b.render()


def test_record_demo_flight_equals_the_reference(demo):
    d, facts_t, facts_j = demo
    assert {k: v for k, v in facts_t.items() if k != "flight"} == \
           {k: v for k, v in facts_j.items() if k != "flight"}
    assert _flight_lines(d / "t.jsonl") == _flight_lines(d / "j.jsonl")
    assert facts_t["kill_rounds"] == [12] and facts_t["converged_round"] is not None


def test_reports_from_curves_and_flight_equal_the_reference(demo):
    d, facts, _ = demo
    kills = facts["kill_rounds"]
    curves, _ = tt.replay_flight(str(d / "t.jsonl"))
    for kw in ({}, {"kill_rounds": kills}, {"round_ms": 250.0, "engine": "dense"}):
        _same_report(th.report_from_curves(curves, **kw), jh.report_from_curves(curves, **kw))
    t = th.report_from_flight(str(d / "t.jsonl"), kill_rounds=kills)
    _same_report(t, jh.report_from_flight(str(d / "t.jsonl"), kill_rounds=kills))
    assert t.converged and t.engine == "dense" and t.vis_total > 0
    # The committed baseline is this scenario's report: the diff is clean.
    base = th.load_report(str(REPO / "CONVERGENCE_BASELINE.json"))
    _same_report(base, jh.load_report(str(REPO / "CONVERGENCE_BASELINE.json")))
    diff = th.diff_reports(base, t, tolerance=0.35)
    assert diff == jh.diff_reports(jh.load_report(str(REPO / "CONVERGENCE_BASELINE.json")),
                                   jh.report_from_flight(str(d / "t.jsonl"), kill_rounds=kills),
                                   tolerance=0.35)
    assert diff["regressions"] == [], diff


def test_load_report_and_diff_reports_equal_the_reference(demo, tmp_path):
    d, facts, _ = demo
    rep = th.report_from_flight(str(d / "t.jsonl"), kill_rounds=facts["kill_rounds"])
    path = tmp_path / "rep.json"
    path.write_text(json.dumps(rep.to_dict(), indent=2))
    for p in (str(path), str(d / "t.jsonl")):
        _same_report(th.load_report(p), jh.load_report(p))
    # A worse candidate: never converged, slower, more backlog.
    worse = th.load_report(str(path))
    worse.converged_round = None
    worse.vis_p99_s = float("inf")
    worse.queue_backlog_peak = rep.queue_backlog_peak * 3 + 20
    worse.staleness_p99 = float("nan")
    jworse = jh.ConvergenceReport(**{k: getattr(worse, k) for k in worse.__dataclass_fields__})
    jrep = jh.load_report(str(path))
    for tol in (0.0, 0.2, 0.35):
        got = th.diff_reports(rep, worse, tolerance=tol)
        assert got == jh.diff_reports(jrep, jworse, tolerance=tol)
        assert any("did not converge" in r for r in got["regressions"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other/1"}))
    with pytest.raises(ValueError, match="not a flight JSONL"):
        th.load_report(str(bad))


def test_publish_report_equals_the_reference(demo):
    d, facts, _ = demo
    rep = th.report_from_flight(str(d / "t.jsonl"), kill_rounds=facts["kill_rounds"])
    jrep = jh.report_from_flight(str(d / "t.jsonl"), kill_rounds=facts["kill_rounds"])
    empty = th.report_from_curves({"msgs": np.zeros(3)})
    jempty = jh.report_from_curves({"msgs": np.zeros(3)})
    for a, b in ((rep, jrep), (empty, jempty)):
        ra, rb = MetricsRegistry(), MetricsRegistry()
        th.publish_report(ra, a, engine="x")
        jh.publish_report(rb, b, engine="x")
        assert ra.render() == rb.render()


def test_detection_recovery_and_buckets_equal_the_reference():
    und = np.array([0, 0, 3, 5, 2, 0, 0, 4, 4, 0, 1, 1])
    for kr in (None, [2], [2, 7], [11]):
        assert th.detection_latencies(und, kr) == jh.detection_latencies(und, kr)
    g = np.random.default_rng(2)
    for _ in range(20):
        curves = {k: (g.random(16) < 0.3) * g.integers(1, 5, 16)
                  for k in ("need", "staleness_sum", "swim_undetected_deaths", "mismatches")}
        for k in curves:
            curves[k][-4:] = 0 if g.random() < 0.7 else curves[k][-4:]
        for heal in (0, 5, 15):
            for mem in (False, True):
                assert th.recovery_after_heal(curves, heal, 500.0, mem) == \
                       jh.recovery_after_heal(curves, heal, 500.0, mem)
    assert th.recovery_after_heal({"need": np.zeros(0)}, 3) == \
           jh.recovery_after_heal({"need": np.zeros(0)}, 3)
    for counts in ([0] * 8, [1] * 8, [0, 0, 0, 0, 0, 0, 0, 5], [9, 1, 0, 0, 0, 0, 0, 0]):
        for q in (0.0, 0.5, 0.99, 1.0):
            a, b = th.cdf_quantile(counts, q), jh.cdf_quantile(counts, q)
            assert a[0] == b[0] and (a[1] == b[1] or (math.isnan(a[1]) and math.isnan(b[1])))
    for lat in (0, 1, 1.5, 2, 3, 64, 64.5, 1000):
        assert th.latency_bucket(lat) == jh.latency_bucket(lat)


def test_iter_flight_follows_a_live_writer(tmp_path):
    """A writer thread records chunks (rotating past 3 KB) while the reader
    tails the file; every record arrives once, in order, and the follow
    ends on its idle timeout once the writer has closed."""
    path = str(tmp_path / "live.jsonl")
    curves = {k: np.arange(4).astype(tt.CURVE_DTYPES[k]) for k in ("need", "msgs")}
    rec = tt.FlightRecorder(path, mode="w", max_bytes=3000)
    done = threading.Event()

    def write():
        try:
            for c in range(12):
                rec.record_chunk(4 * c, curves, wall_s=0.01)
                time.sleep(0.02)
        finally:
            rec.close()
            done.set()

    writer = threading.Thread(target=write, daemon=True)
    t0 = time.monotonic()
    writer.start()
    got = list(th.iter_flight(path, follow=True, poll_s=0.01, idle_timeout_s=1.0))
    writer.join(timeout=10)
    assert done.is_set() and time.monotonic() - t0 < 30
    rounds = [r["round"] for r in got if r["kind"] == "round"]
    assert rounds == list(range(48))
    assert sum(r["kind"] == "chunk" for r in got) == 12
    segments = [r["segment"] for r in got if r["kind"] == "flight"]
    assert segments == sorted(set(segments)) and len(segments) > 1
    assert th.flight_header(path)["segment"] == segments[-1]
    # A finished file reads the same without follow, as the reference reads it.
    assert list(th.iter_flight(path)) == list(jh.iter_flight(path))
    with open(path, "a") as f:
        f.write('{"kind": "round"')  # a torn tail is held back
    assert list(th.iter_flight(path)) == list(jh.iter_flight(path))
    with pytest.raises(FileNotFoundError):
        list(th.iter_flight(str(tmp_path / "missing.jsonl")))
    assert th.flight_header(os.devnull) == {}

"""The epidemic analyzer (``obs/epidemic.py``) against the live JAX
reference on the CPU: the geo demo flight (96 nodes, 48 rounds, churn,
seed 0), push-only and adaptive, gives the reference's
``corro-epidemic/1`` report, SI fit included, and the committed
baselines' diff is clean; the report's helpers, ``diff_reports``,
``render_report``, ``publish_epidemic`` and ``oracle_coverage`` agree on
the same inputs.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from corrosion_tpu.obs import epidemic as je
from corrosion_tpu.sim import health as jh
from corrosion_tpu.utils.metrics import MetricsRegistry
from corrosion_tpu_torch.obs import epidemic as te
from corrosion_tpu_torch.sim import health as th
from corrosion_tpu_torch.sim import telemetry as tt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BASELINES = {False: "EPIDEMIC_BASELINE.json", True: "EPIDEMIC_BASELINE_ADAPTIVE.json"}


@pytest.fixture(scope="module", params=[False, True], ids=["push", "adaptive"])
def geo(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("geo")
    kw = dict(nodes=96, rounds=48, churn=True, seed=0, geo=True, adaptive=request.param)
    facts = th.record_demo_flight(str(d / "t.jsonl"), **kw, device="cpu")
    jfacts = jh.record_demo_flight(str(d / "j.jsonl"), **kw)
    return request.param, d, facts, jfacts


def _report_kw(facts):
    return dict(fanout=facts["fanout"], nodes=facts["nodes"], geo_regions=facts["regions"])


def test_build_report_on_the_geo_flight_equals_the_reference(geo):
    adaptive, d, facts, jfacts = geo
    assert {k: v for k, v in facts.items() if k != "flight"} == \
           {k: v for k, v in jfacts.items() if k != "flight"}
    rep = te.report_from_flight(str(d / "t.jsonl"), **_report_kw(facts))
    assert rep == je.report_from_flight(str(d / "j.jsonl"), **_report_kw(jfacts))
    assert rep["checks_ok"] and rep["fit"]["fitted"], rep["check_problems"]
    curves, _ = tt.replay_flight(str(d / "t.jsonl"))
    for kw in ({}, _report_kw(facts), dict(fanout=2, round_ms=250.0)):
        assert te.build_report(curves, **kw) == je.build_report(curves, **kw)
    assert te.render_report(rep) == je.render_report(rep)
    base_path = str(REPO / BASELINES[adaptive])
    base = te.load_report(base_path)
    assert base == je.load_report(base_path)
    diff = te.diff_reports(base, rep, tolerance=0.35)
    assert diff == je.diff_reports(base, rep, tolerance=0.35)
    assert diff["regressions"] == [], diff
    ra, rb = MetricsRegistry(), MetricsRegistry()
    te.publish_epidemic(ra, rep)
    je.publish_epidemic(rb, rep)
    assert ra.render() == rb.render()


def test_diff_reports_flags_the_reference_s_regressions(geo):
    _, d, facts, _ = geo
    rep = te.report_from_flight(str(d / "t.jsonl"), **_report_kw(facts))
    broken = dict(rep, checks_ok=False, check_problems=["x"], fit={"fitted": False},
                  spread_exponent=rep["spread_exponent"] * 0.3, fit_r2=None)
    for tol in (0.0, 0.25, 0.35):
        got = te.diff_reports(rep, broken, tolerance=tol)
        assert got == je.diff_reports(rep, broken, tolerance=tol)
        assert len(got["regressions"]) >= 3


def test_report_helpers_equal_the_reference(tmp_path):
    g = np.random.default_rng(4)
    for trial in range(6):
        curves = {k: g.integers(0, 30, 10).astype(np.uint32) for k in tt.PROP_CURVE_KEYS}
        curves.update({k: g.integers(0, 30, 10).astype(np.uint32)
                       for k in ("msgs", "vis_count")})
        if trial % 2:  # a run whose accounting holds
            curves["msgs"] = sum(curves[k] for k in tt.LINK_CURVE_KEYS)
            curves["vis_count"] = sum(curves[k] for k in tt.RUMOR_AGE_KEYS)
            curves["prop_dup_msgs"] = curves["msgs"] - np.minimum(curves["prop_useful_msgs"],
                                                                  curves["msgs"])
            curves["prop_useful_msgs"] = curves["msgs"] - curves["prop_dup_msgs"]
        for geo_regions in (None, 2, 4):
            assert te.build_report(curves, geo_regions=geo_regions, nodes=50) == \
                   je.build_report(curves, geo_regions=geo_regions, nodes=50)
        assert te.conservation_checks(curves) == je.conservation_checks(curves)
        hist = te.rumor_age_histogram(curves)
        assert np.array_equal(hist, je.rumor_age_histogram(curves))
        assert np.array_equal(te.link_matrix(curves), je.link_matrix(curves))
    for pts in ([], [(1.0, 0.5)], [(1.0, 0.0), (2.0, 1.0)], [(1.0, 0.2), (2.0, 0.6), (4.0, 0.9)]):
        assert te.fit_si(pts) == je.fit_si(pts)
    for n in (3, 4, 7):
        assert np.array_equal(te.geo_rings(n), je.geo_rings(n))
    assert te.push_gossip_theory(4, 96) == je.push_gossip_theory(4, 96)
    assert te.push_gossip_theory(3, None) == je.push_gossip_theory(3, None)
    records = {
        "writes": [{"key": f"k{i}", "t_ack_wall": 10.0 + i} for i in range(8)],
        "deliveries": [{"kind": "change", "key": f"k{i % 8}", "t_wall": 10.0 + i % 8 + 0.3 * i}
                       for i in range(40)] + [{"kind": "other", "key": "k0", "t_wall": 1.0}],
    }
    assert te.oracle_coverage(records, 250.0) == je.oracle_coverage(records, 250.0)


def test_report_from_flight_refuses_a_flight_without_the_plane(tmp_path):
    path = str(tmp_path / "flat.jsonl")
    th.record_demo_flight(path, nodes=32, rounds=16, churn=False, device="cpu")
    with pytest.raises(ValueError, match="prop_observe off"):
        te.report_from_flight(path)
    with pytest.raises(ValueError, match="prop_observe off"):
        je.report_from_flight(path)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "corro-epidemic/0"}))
    with pytest.raises(ValueError, match="not a flight JSONL"):
        te.load_report(str(bad))

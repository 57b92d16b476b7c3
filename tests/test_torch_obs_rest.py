"""The rest of the port's ``obs/`` (``trajectory``, ``serving``,
``timeline``, ``journey`` and the package's exports) against the
reference's:

- trajectory: ``tests/test_cost_plane.py``'s three cases run against the
  port, and the report on the repo's committed ``BENCH_r*`` /
  ``MULTICHIP_r*`` artifacts equal to the reference's, dict for dict and
  rendered;
- serving: the pure-dict cases of ``tests/test_sub_costs.py`` run against
  the port, and the report, the ledger file, the budget gate and the diff
  equal to the reference's on the same run;
- timeline: the synthetic cases of ``tests/test_obs_timeline.py`` run
  against the port, and the timeline built from span files both
  packages' tracers export equal to the reference's;
- journey: ``tests/test_obs_timeline.py``'s two synthetic cases run
  against the port, and the journeys of a small wan_100k run, recorded as
  a flight by each package, equal to the reference's (each package's
  reader on each package's flight).

The live-agent case of ``tests/test_obs_timeline.py`` at :545 and the
rest of ``tests/test_sub_costs.py`` run against the port's agent runtime
in ``test_torch_agent_runtime.py``; :609 waits for ``loadgen/``, :642 for
``loadgen/`` and ``cli``.
"""

import json
import os

import numpy as np
import pytest
import torch

import test_cost_plane as ref_cost_tests
import test_obs_timeline as ref_timeline_tests
import test_sub_costs as ref_sub_cost_tests
from corrosion_tpu.models import baselines as jb
from corrosion_tpu.obs import journey as jjourney
from corrosion_tpu.obs import serving as jserving
from corrosion_tpu.obs import timeline as jtimeline
from corrosion_tpu.obs import trajectory as jtrajectory
from corrosion_tpu.sim import engine as je
from corrosion_tpu.sim import telemetry as jtelemetry
from corrosion_tpu.utils import tracing as jtracing
from corrosion_tpu_torch import obs as tobs
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import journey as tjourney
from corrosion_tpu_torch.obs import serving as tserving
from corrosion_tpu_torch.obs import timeline as ttimeline
from corrosion_tpu_torch.obs import trajectory as ttrajectory
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import host_oracles as H
from corrosion_tpu_torch.sim import telemetry as ttelemetry
from corrosion_tpu_torch.sim import trace as ttrace
from corrosion_tpu_torch.utils import tracing as ttracing
from test_torch_core import run_against

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OBS_SWAPS = {
    "corrosion_tpu.obs.trajectory": ttrajectory,
    "corrosion_tpu.obs.serving": tserving,
    "corrosion_tpu.obs.timeline": ttimeline,
    "corrosion_tpu.obs.journey": tjourney,
    "corrosion_tpu.sim.trace": ttrace,
    "corrosion_tpu.utils.tracing": ttracing,
}

# -- trajectory ---------------------------------------------------------------

TRAJECTORY_CASES = (
    "test_trajectory_flags_platform_fallback_and_refuses_delta",
    "test_trajectory_reads_committed_artifacts_and_r05_break",
    "test_trajectory_parses_prose_diag_line",
)


@pytest.mark.parametrize("case", TRAJECTORY_CASES)
def test_reference_trajectory_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    run_against(ref_cost_tests, case, OBS_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_trajectory_of_the_committed_artifacts_equals_the_reference():
    a, b = jtrajectory.build_trajectory(REPO), ttrajectory.build_trajectory(REPO)
    assert a == b and len(b["bench"]) >= 5 and b["multichip"]
    assert ttrajectory.render_trajectory(b) == jtrajectory.render_trajectory(a)


# -- serving -------------------------------------------------------------------

SERVING_CASES = (
    "test_heatmap_join_attribution_and_reconciliation",
    "test_heatmap_join_flags_mass_mismatch",
    "test_heatmap_refuses_run_without_ledger",
    "test_ledger_jsonl_roundtrip",
    "test_budget_gate_green_on_clean_measurement",
    "test_budget_gate_machinery_fired_rule",
    "test_budget_gate_absolute_rules",
    "test_baseline_diff_regression",
)


@pytest.mark.parametrize("case", SERVING_CASES)
def test_reference_serving_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    run_against(ref_sub_cost_tests, case, OBS_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_serving_outputs_equal_the_reference(tmp_path):
    run = ref_sub_cost_tests._fake_run()
    a, b = jserving.build_serving_report(run), tserving.build_serving_report(run)
    assert a == b
    assert jserving.render_serving_report(a) == tserving.render_serving_report(b)
    for mod, name in ((jserving, "j"), (tserving, "t")):
        mod.write_cost_ledger(str(tmp_path / f"{name}.jsonl"), run["sub_costs"]["ledger"],
                              context={"scenario": "t"})
    assert (tmp_path / "j.jsonl").read_bytes() == (tmp_path / "t.jsonl").read_bytes()
    assert tserving.read_cost_ledger(str(tmp_path / "j.jsonl")) == \
        jserving.read_cost_ledger(str(tmp_path / "t.jsonl"))
    cand = json.loads(json.dumps(a))
    cand["eval_ms"]["total"] = a["eval_ms"]["total"] * 10 + 100.0
    cand["fallback"]["share_of_eval_seconds"] = 0.99
    assert jserving.diff_serving_reports(a, cand) == tserving.diff_serving_reports(b, cand)
    measured = {"platform": "cpu", "scenario": "t", "streams": 2, "run": run, "serving": a}
    for budget in (ref_sub_cost_tests._budget(), ref_sub_cost_tests._budget(streams=512),
                   ref_sub_cost_tests._budget(fallback_share_max=0.5)):
        assert jserving.check_serving_cost_budget(measured, budget) == \
            tserving.check_serving_cost_budget(measured, budget)


# -- timeline --------------------------------------------------------------------

TIMELINE_CASES = (
    "test_timeline_local_write_stages_and_reconcile",
    "test_timeline_remote_hop_attributed_to_serving_hop_only",
    "test_timeline_missing_span_lowers_coverage_and_fails_verdict",
    "test_timeline_clock_skew_fails_reconciliation",
    "test_timeline_independent_wall_catches_epoch_clock_step",
    "test_timeline_sampling_judges_only_kept_writes",
)
JOURNEY_CASES = (
    "test_journey_reconstruction_attributes_and_reconciles",
    "test_journey_unattributable_mass_reported",
)


@pytest.mark.parametrize("case", TIMELINE_CASES + JOURNEY_CASES)
def test_reference_timeline_and_journey_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    run_against(ref_timeline_tests, case, OBS_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_obs_exports_the_timeline():
    assert tobs.TIMELINE_SCHEMA == jtimeline.TIMELINE_SCHEMA == "corro-timeline/1"
    assert tobs.build_timeline is ttimeline.build_timeline
    assert tobs.load_spans is ttimeline.load_spans
    assert tobs.timeline_from_run is ttimeline.timeline_from_run


def _write_spans(path, writes: int, base: float) -> dict:
    """Span-export lines of ``writes`` writes: an ``api_write`` root with a
    ``commit`` child, and a remote ``ingest_apply`` hop for odd writes;
    returns the matching write and delivery records."""
    writes_out, dels = [], []
    with open(path, "a") as f:
        for i in range(writes):
            tid, t0 = f"{i + 1:032x}", base + i
            api, commit = f"{2 * i + 1:016x}", f"{2 * i + 2:016x}"
            spans = [("api_write", api, None, "a", 0.002, 10_000),
                     ("commit", commit, api, "a", 0.003, 6_000)]
            if i % 2:
                spans.append(("ingest_apply", f"{i:08x}" * 2, commit, "b", 0.010, 2_000))
            for name, sid, parent, service, at, dur in spans:
                f.write(json.dumps({
                    "name": name, "trace_id": tid, "span_id": sid, "parent_id": parent,
                    "service": service, "start_ns": int((t0 + at) * 1e9),
                    "duration_us": dur, "attrs": {},
                }) + "\n")
            writes_out.append({"key": i, "group": None, "trace_id": tid, "t_send_wall": t0,
                               "t_ack_wall": t0 + 0.013})
            dels.append({"kind": "change", "sid": 0, "key": i, "change_id": i + 1,
                         "t_wall": t0 + 0.012})
    return {"writes": writes_out, "deliveries": dels}


def test_timeline_from_run_equals_the_reference(tmp_path):
    """Span files with a torn line and a missing file: both packages load
    the same spans and build the same timeline from the run block."""
    spans_a = tmp_path / "a.jsonl"
    records = _write_spans(spans_a, writes=6, base=7000.0)
    with open(spans_a, "a") as f:
        f.write('{"name": "torn"\n')
    run = {"trace": {"span_files": [str(spans_a), str(tmp_path / "missing.jsonl")],
                     "oracle_records": records, "sample": 1.0}}
    assert ttimeline.load_spans(run["trace"]["span_files"]) == \
        jtimeline.load_spans(run["trace"]["span_files"])
    a, b = jtimeline.timeline_from_run(run), ttimeline.timeline_from_run(run)
    assert a == b
    assert b["writes_reconstructed"] == 6 and b["hops"]["writes_with_remote_hop"] == 3
    assert ttimeline.timeline_ok(b) == jtimeline.timeline_ok(a)
    with pytest.raises(ValueError, match="trace block"):
        ttimeline.timeline_from_run({})


def test_tracer_exports_build_equal_timelines(tmp_path):
    """Spans exported by each package's own ``Tracer`` (nested api_write
    and commit around a sleepless body) give equal timelines when joined
    with the same records."""
    out = []
    for tracing, name in ((jtracing, "j"), (ttracing, "t")):
        path = tmp_path / f"{name}.jsonl"
        tr = tracing.Tracer(service="svc", export_path=str(path))
        with tr.span("api_write") as api:
            with tr.span("commit"):
                pass
        tr.close()
        spans = ttimeline.load_spans([str(path)])
        assert [s["name"] for s in spans] == ["commit", "api_write"]
        assert set(spans[0]) == set(jtimeline.load_spans([str(path)])[0])
        start = spans[1]["start_ns"] / 1e9
        end = start + spans[1]["duration_us"] / 1e6
        records = {"writes": [{"key": 1, "group": None, "trace_id": api.trace_id,
                               "t_send_wall": start - 0.001, "t_ack_wall": end + 0.001}],
                   "deliveries": [{"kind": "change", "sid": 0, "key": 1, "change_id": 1,
                                   "t_wall": end + 0.0005}]}
        a, b = jtimeline.build_timeline(spans, records), ttimeline.build_timeline(spans, records)
        assert a == b and b["writes_reconstructed"] == 1
        out.append(b["coverage"])
    assert out == [1.0, 1.0]


# -- journey -------------------------------------------------------------------

JOURNEY_KW = dict(n=400, n_regions=4, n_writers=32, rounds=72, samples=64, partition=False)


@pytest.fixture(scope="module")
def flights(tmp_path_factory):
    """The same small wan_100k run recorded as a flight by each package,
    and the schedule's writes."""
    d = tmp_path_factory.mktemp("flights")
    cfg, topo, sched = tb.wan_100k(device="cpu", **JOURNEY_KW)
    tele = ttelemetry.KernelTelemetry(
        recorder=ttelemetry.FlightRecorder(str(d / "port.jsonl"), mode="w"))
    te.simulate(cfg, topo, sched, seed=0, telemetry=tele, device="cpu", max_chunk=24)
    tele.recorder.close()
    cj, topo_j, sched_j = jb.wan_100k(**JOURNEY_KW)
    tele_j = jtelemetry.KernelTelemetry(
        recorder=jtelemetry.FlightRecorder(str(d / "ref.jsonl"), mode="w"))
    je.simulate(cj, topo_j, sched_j, seed=0, telemetry=tele_j, max_chunk=24)
    tele_j.recorder.close()
    assert np.array_equal(sched.writes, sched_j.writes)
    return d, sched.writes


def test_journeys_equal_the_reference_on_both_flights(flights):
    d, writes = flights
    trace = H.schedule_trace(writes)
    assert len(trace.events) == int(writes.sum())
    want = jjourney.reconstruct_write_journeys(str(d / "ref.jsonl"), trace, round_ms=H.ROUND_MS)
    for flight in ("ref.jsonl", "port.jsonl"):
        got = tjourney.reconstruct_write_journeys(str(d / flight), trace, round_ms=H.ROUND_MS)
        assert got == want, flight
    assert want["totals"]["attribution_fraction"] == 1.0
    capped = tjourney.reconstruct_write_journeys(str(d / "port.jsonl"), trace, max_writes=5)
    assert len(capped["writes"]) == 5 and capped["totals"] == want["totals"]


def test_journey_check_on_the_ports_flight(flights):
    d, writes = flights
    out = H.journey_check(str(d / "port.jsonl"), writes)
    assert out["trace_writes"] == int(writes.sum())
    assert out["attributed"] + out["unattributed"] == out["vis_events"] > 0
    assert out["flight_rounds"] == JOURNEY_KW["rounds"]

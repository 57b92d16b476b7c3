"""The port's ``obs/series.py`` and ``obs/endurance.py`` against the
reference's:

- the reference's own cases (``tests/test_endurance.py``, all but its
  engine, agent, CLI and load-generator install points) run against the
  port's ``series``, ``endurance`` and ``utils.metrics``;
- the same reports from the same samples: ``build_report``,
  ``render_report``, ``check_soak_budget`` and ``diff_soak`` equal, dict
  for dict, on the positive controls of those cases;
- series files byte-equal under ``clock=None``, rotation included, and
  the kernel install point (``KernelTelemetry(registry=, series=)`` on a
  chunked dense run) writing the reference engine's file byte for byte;
- ``attach`` adopts only the port's own live recorder, refcounted.
"""

import copy

import numpy as np
import pytest

import test_endurance as ref_endurance_tests
from corrosion_tpu import models as jmodels
from corrosion_tpu.obs import endurance as jend
from corrosion_tpu.obs import series as jseries
from corrosion_tpu.sim import simulate as jsimulate
from corrosion_tpu.sim import telemetry as jtele
from corrosion_tpu.utils import metrics as jmetrics
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import endurance as tend
from corrosion_tpu_torch.obs import series as tseries
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import telemetry as ttele
from corrosion_tpu_torch.utils import metrics as tmetrics
from test_endurance import _clean_samples, _soak_report, mk_hist, mk_sample
from test_torch_core import reference_cases, run_against

SWAPS = {
    "corrosion_tpu.obs.endurance": tend,
    "corrosion_tpu.obs.series": tseries,
    "corrosion_tpu.utils.metrics": tmetrics,
}
# The reference's install-point cases drive its engine, agent, CLI and
# load generator, which the port does not hold here; the kernel install
# point has its own test below.
INSTALL_POINTS = {
    "test_kernel_series_chunked_deterministic_and_zero_cost",
    "test_agent_runtime_series_install",
    "test_obs_soak_cli_report_and_diff",
    "test_loadgen_soak_process_block_rides_the_recorder",
}


@pytest.mark.parametrize(
    "case", [c for c in reference_cases(ref_endurance_tests) if c not in INSTALL_POINTS]
)
def test_reference_endurance_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    run_against(ref_endurance_tests, case, SWAPS, monkeypatch, tmp_path=tmp_path)


def _set(samples, family, name, fn, when=lambda i: True):
    for i, s in enumerate(samples):
        if when(i):
            s[family][name] = fn(i)
    return samples


SAMPLE_SETS = {
    "clean": _clean_samples,
    "fd_leak": lambda: _set(_clean_samples(), "gauges", "corro_runtime_open_fds",
                            lambda i: 40.0 + 5.0 * i),
    "wedge": lambda: _set(_clean_samples(), "counters", "corro_changes_applied",
                          lambda i: 100.0, lambda i: i >= 10),
    "restart": lambda: _set(
        _set(_clean_samples(), "counters", "corro_changes_committed",
             lambda i: 10.0 * (i - 15), lambda i: i >= 15),
        "counters", "corro_changes_applied", lambda i: 10.0 * (i - 15), lambda i: i >= 15),
    "slow_burn": lambda: _set(_clean_samples(), "gauges", "corro_sync_needs", lambda i: 900.0),
    "recovered": lambda: _set(_clean_samples(), "gauges", "corro_sync_needs",
                              lambda i: 900.0, lambda i: i < 10),
    "flappy": lambda: _set(_clean_samples(), "counters", "corro_gossip_member_removed",
                           lambda i: 2.0 * (i if i < 20 else i - 20)),
    "stalled": lambda: _set(_clean_samples(), "gauges", "corro_runtime_loop_lag_last_seconds",
                            lambda i: 2.0, lambda i: 5 <= i < 10 or 20 <= i < 24),
    "wrap": lambda: _set(_clean_samples(), "counters", "corro_changes_applied",
                         lambda i: (2.0**32 - 50 + 10.0 * i) % 2.0**32),
    "empty": lambda: [],
}


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_reports_equal_the_reference(name):
    samples = SAMPLE_SETS[name]()
    for kw in ({}, {"t_scale_s": 0.5}):
        want = jend.build_report(copy.deepcopy(samples), label=name, **kw)
        got = tend.build_report(copy.deepcopy(samples), label=name, **kw)
        assert got == want
        assert tend.render_report(got) == jend.render_report(want)


BUDGETS = (
    {"platform": "cpu", "scenario": "soak_smoke", "tolerance": 3.0,
     "leak_ceilings_per_hour": {"host:corro_runtime_rss_bytes": 1e6},
     "require_detectors_armed": True, "require_determinism": True, "wall_ceiling_s": 60.0},
    {"tolerance": 100.0, "wedge_max": 0},
    {"require_detectors_armed": True, "leak_ceilings_per_hour": {}},
    {"leak_ceilings_per_hour": {"host:corro_no_such_series": 1.0}, "require_determinism": True},
)


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_soak_budget_and_diff_equal_the_reference(name):
    def soak(mod, samples, determinism=True):
        block = mod.build_report(copy.deepcopy(samples), label="n0")
        return _soak_report(block, kernel_block=block, determinism=determinism)

    samples = SAMPLE_SETS[name]()
    base = {m: soak(m, _clean_samples()) for m in (jend, tend)}
    for determinism in (True, False):
        rep = {m: soak(m, samples, determinism) for m in (jend, tend)}
        assert rep[tend] == rep[jend]
        for budget in BUDGETS:
            assert tend.check_soak_budget(rep[tend], budget) == \
                jend.check_soak_budget(rep[jend], budget)
        assert tend.diff_soak(base[tend], rep[tend]) == jend.diff_soak(base[jend], rep[jend])


def _drive_series(mod, metrics, path: str, max_bytes=None) -> None:
    """A scripted registry sampled with ``clock=None``: counters, gauges
    with labels, a histogram, an event, a rotation when ``max_bytes``."""
    reg = metrics.MetricsRegistry()
    rec = mod.MetricSeriesRecorder(path, source="test", mode="w", max_bytes=max_bytes, clock=None)
    rng = np.random.default_rng(4)
    for r in range(40):
        reg.counter("corro_changes_committed").inc(float(rng.integers(0, 9)))
        reg.gauge("corro_sync_needs").set(float(rng.integers(0, 99)), peer=str(r % 3))
        reg.histogram("corro_lag_seconds", buckets=(0.1, 1.0)).observe(float(rng.random() * 2))
        rec.sample(reg, t=float(r), exclude=("corro_lag_seconds",) if r % 7 == 0 else ())
        if r == 20:
            rec.record_event({"kind": "restart", "t": 20.0})
    rec.close()


@pytest.mark.parametrize("max_bytes", [None, 4096])
def test_series_files_byte_equal_the_reference(tmp_path, max_bytes):
    jp, tp = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    _drive_series(jseries, jmetrics, jp, max_bytes)
    _drive_series(tseries, tmetrics, tp, max_bytes)
    jsegs, tsegs = jseries.series_segments(jp), tseries.series_segments(tp)
    assert len(tsegs) == len(jsegs)
    assert len(tsegs) == 1 if max_bytes is None else len(tsegs) > 2
    for a, b in zip(jsegs, tsegs):
        assert open(a, "rb").read() == open(b, "rb").read()
    want, got = jseries.replay_series(jp), tseries.replay_series(tp)
    assert got == want and len(got["samples"]) == 40
    name = 'corro_sync_needs{peer="1"}'
    assert tseries.series_values(got["samples"], name, family="gauges") == \
        jseries.series_values(want["samples"], name, family="gauges")
    for fam in ("counters", "gauges", "histograms"):
        assert tseries.series_names(got["samples"], fam) == jseries.series_names(want["samples"], fam)


def test_attach_adopts_only_the_ports_recorder(tmp_path):
    path = str(tmp_path / "shared.jsonl")
    rec = tseries.MetricSeriesRecorder.attach(path, clock=None, mode="w")
    assert tseries.MetricSeriesRecorder.attach(path) is rec and rec._refs == 2
    ref = jseries.MetricSeriesRecorder.attach(str(tmp_path / "ref.jsonl"), clock=None, mode="w")
    assert tseries.MetricSeriesRecorder._live is not jseries.MetricSeriesRecorder._live
    assert all(not isinstance(r, jseries.MetricSeriesRecorder)
               for r in tseries.MetricSeriesRecorder._live.values())
    ref.close()
    reg = tmetrics.MetricsRegistry()
    tseries.record_process_sample(rec, reg, t=1.0, lag_s=0.01)
    rec.close()
    assert rec._f is not None  # one reference left
    rec.close()
    assert rec._f is None
    data = tseries.replay_series(path)
    assert len(data["headers"]) == 1 and len(data["samples"]) == 1
    gauges = data["samples"][0]["gauges"]
    assert gauges["corro_runtime_loop_lag_last_seconds"] == 0.01
    assert gauges["corro_runtime_rss_bytes"] > 0 and gauges["corro_runtime_open_fds"] > 0
    # A closed recorder is reopened, not adopted.
    again = tseries.MetricSeriesRecorder.attach(path, clock=None)
    assert again is not rec
    again.close()


def test_kernel_series_equals_the_reference_engines(tmp_path):
    """The metrics bridge on a chunked dense run (merge_10k cut to 32
    nodes, 24 rounds in chunks of 8): the port's registry and series
    write the reference engine's series file byte for byte, and the
    ``corro_kernel_*_total`` counters equal the curves' sums."""
    jcfg, jtopo, jsched = jmodels.merge_10k(n=32, rounds=24, samples=16)
    tcfg, ttopo, tsched = tb.merge_10k(n=32, rounds=24, samples=16, device="cpu")
    jp, tp = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")

    jreg = jmetrics.MetricsRegistry()
    jrec = jseries.MetricSeriesRecorder(jp, source="kernel", mode="w", clock=None)
    jsimulate(jcfg, jtopo, jsched, seed=5, max_chunk=8,
              telemetry=jtele.KernelTelemetry(engine="dense", registry=jreg, series=jrec))
    jrec.close()

    treg = tmetrics.MetricsRegistry()
    trec = tseries.MetricSeriesRecorder(tp, source="kernel", mode="w", clock=None)
    _, curves = tengine.simulate(
        tcfg, ttopo, tsched, seed=5, max_chunk=8, device="cpu",
        telemetry=ttele.KernelTelemetry(engine="dense", registry=treg, series=trec),
    )
    trec.close()

    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert [s["t"] for s in tseries.replay_series(tp)["samples"]] == [8.0, 16.0, 24.0]
    assert treg.counter("corro_kernel_rounds_total").get(engine="dense") == 24.0
    for k, v in curves.items():
        if k in ttele.LINK_CURVE_KEYS or k in ttele.RUMOR_AGE_KEYS:
            continue
        name = f"{ttele.series_name(k)}_total"
        assert treg.counter(name).get(engine="dense") == float(np.asarray(v, np.float64).sum()), k
    # The registries agree but for the chunk walls.
    jsnap, tsnap = jreg.series_snapshot(), treg.series_snapshot()
    for snap in (jsnap, tsnap):
        snap["histograms"] = {k: v for k, v in snap["histograms"].items() if "chunk_seconds" not in k}
    assert tsnap == jsnap


def test_hist_builders_reach_the_burn_windows():
    """A histogram-backed SLO over ``mk_hist`` samples: equal verdicts."""
    samples = [mk_sample(i, histograms={"corro_broadcast_recv_lag_seconds": mk_hist(
        [0.1, 1.0, 10.0], [i, 2 * i, 9 * i], total=9 * i, s=3.0 * i)}) for i in range(30)]
    assert tend.build_report(samples, label="h") == jend.build_report(samples, label="h")

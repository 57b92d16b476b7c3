"""The port's ``fidelity/`` against the reference's, on the CPU:

- every case of ``tests/test_fidelity.py`` run against the port's
  modules (``test_torch_core.run_against``): the round model, ring
  occupancy, capacity deferral, the divergence metrics, the emit path and
  the budget gate, the identity model's bit-identical engine runs and the
  WAN ring model in tier 1; the DCN scenario and the live mixed-mode
  comparisons keep the reference's ``slow`` mark. The engine, ``_cfg``,
  ``kernel_replay``, the scenarios and ``fidelity_context`` are bound to
  ``device="cpu"``;
- every new entry point that takes a device resolves it (CUDA, or raise);
- ``sim/host_oracles.py``'s fidelity checks (``chip_smoke.py`` phase 15):
  the DCN scenario and the 10,000-node replay's form at small size in
  tier 1, the live runs slow-marked.

Equality with the live reference is
``test_torch_chaos_fidelity_interop.py``.
"""

import asyncio
import copy
import functools
import types

import numpy as np
import pytest

import test_fidelity as ref_fidelity
import corrosion_tpu_torch.fidelity as tfidelity
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.fidelity import calibrate as tcalibrate
from corrosion_tpu_torch.fidelity import compare as tcompare
from corrosion_tpu_torch.fidelity import report as treport
from corrosion_tpu_torch.fidelity import scenarios as tscenarios
from corrosion_tpu_torch.models import baselines as tbaselines
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import faults as tfaults
from corrosion_tpu_torch.sim import host_oracles as H
from corrosion_tpu_torch.sim.trace import Trace
from test_torch_agent_runtime import RUNTIME_SWAPS
from test_torch_core import reference_cases, run_against


def on_cpu(module, *names):
    """A copy of ``module`` whose functions ``names`` run with
    ``device="cpu"``."""
    mod = types.ModuleType(module.__name__)
    mod.__dict__.update(vars(module))
    for name in names:
        setattr(mod, name, functools.partial(getattr(module, name), device="cpu"))
    return mod


CPU_COMPARE = on_cpu(tcompare, "kernel_replay", "compare_live_kernel")
CPU_SCENARIOS = on_cpu(tscenarios, "steady_load", "burst_drain", "dcn_partition",
                       "full_report")
CPU_REPORT = on_cpu(treport, "fidelity_context")
# The package first: ``run_against`` sets each module's attribute on the
# package object that ``sys.modules`` holds by then.
FIDELITY_SWAPS = {
    "corrosion_tpu.fidelity": tfidelity,
    "corrosion_tpu.fidelity.calibrate": tcalibrate,
    "corrosion_tpu.fidelity.compare": CPU_COMPARE,
    "corrosion_tpu.fidelity.report": CPU_REPORT,
    "corrosion_tpu.fidelity.scenarios": CPU_SCENARIOS,
    "corrosion_tpu.models.baselines": on_cpu(tbaselines, "_cfg"),
    "corrosion_tpu.sim.engine": on_cpu(tengine, "simulate"),
    "corrosion_tpu.sim.faults": tfaults,
    **RUNTIME_SWAPS,
}
SLOW = tuple(c for c in reference_cases(ref_fidelity)
             if "slow" in [m.name for m in getattr(getattr(ref_fidelity, c), "pytestmark", [])])
CASES = [pytest.param(c, marks=pytest.mark.slow) if c in SLOW else c
         for c in reference_cases(ref_fidelity)]


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


@pytest.mark.parametrize("case", CASES)
def test_reference_fidelity_cases_hold_on_the_port(case, tmp_path, capsys, monkeypatch):
    run_against(ref_fidelity, case, FIDELITY_SWAPS, monkeypatch, tmp_path=tmp_path,
                capsys=capsys)


def test_every_case_is_run_and_the_slow_ones_keep_their_mark():
    assert len(reference_cases(ref_fidelity)) == 22
    assert set(SLOW) == {
        "test_dcn_partition_scenario_invariant_cross_check",
        "test_mixed_mode_steady_calibrated_beats_uncalibrated",
        "test_mixed_mode_burst_calibrated_beats_uncalibrated",
        "test_fidelity_cli_calibrate_and_replay",
    }


def test_the_swap_reaches_the_port(monkeypatch):
    import sys

    run_against(ref_fidelity, "test_trace_fingerprint_stable_and_order_free", FIDELITY_SWAPS,
                monkeypatch)
    assert ref_fidelity.RoundModel is tcalibrate.RoundModel
    assert ref_fidelity.check_fidelity_budget is treport.check_fidelity_budget
    assert sys.modules["corrosion_tpu.fidelity"].scenarios is CPU_SCENARIOS


def test_ring_repr_comes_from_the_ports_ring_edges():
    from corrosion_tpu_torch.agent.membership import RING_BUCKETS_MS, rtt_ring

    assert len(tcalibrate.RING_REPR_MS) == len(RING_BUCKETS_MS)
    assert [rtt_ring(x) for x in tcalibrate.RING_REPR_MS] == list(range(len(RING_BUCKETS_MS)))


@pytest.mark.parametrize("call", [
    lambda: tcompare.kernel_replay(Trace(events=[(0, "aa", 1)]), 500.0, n_nodes=4),
    lambda: tscenarios.dcn_partition(rounds=8),
    lambda: treport.fidelity_context("steady", 3, "ab12"),
    lambda: asyncio.run(tcompare.compare_live_kernel("/nonexistent", [(0.0, 0)])),
    lambda: asyncio.run(tscenarios.steady_load("/nonexistent")),
    lambda: asyncio.run(tscenarios.full_report("/nonexistent")),
], ids=["kernel_replay", "dcn_partition", "fidelity_context", "compare_live_kernel",
        "steady_load", "full_report"])
def test_entry_points_resolve_their_device(call):
    """Without CUDA and without a device each raises before it runs
    anything (the live ones before they start a cluster)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_fidelity_context_on_the_cpu():
    ctx = treport.fidelity_context("steady", 3, "ab12", 24, device="cpu")
    assert ctx["platform"] == "cpu" and ctx["trace_fingerprint"] == "ab12"
    assert treport.emit_fidelity_report(ctx) == ctx


# -- the host oracles of chip_smoke.py phase 15 --------------------------------


def _trace(seed: int = 0, actors=("aa", "bb", "cc"), writes: int = 8) -> Trace:
    rng = np.random.default_rng(seed)
    events = []
    for a in actors:
        t = 0
        for v in range(1, writes + 1):
            t += int(rng.integers(10, 300))
            events.append((t, a, v))
    return Trace(events=events)


def test_fidelity_replay_oracle_small():
    """The 10,000-node replay's form at 64 nodes: nothing unseen, the
    calibrated run with both chaos axes, the uncalibrated with none."""
    out = H.fidelity_replay_10k(_trace(), "cpu", nodes=64)
    assert out["nodes"] == 64 and out["writers"] == 3 and out["writes"] == 24
    assert out["calibrated"]["axes"] == ["loss", "probe_loss"]
    assert out["uncalibrated"]["axes"] == []
    for side in ("calibrated", "uncalibrated"):
        assert out[side]["unseen"] == 0 and out[side]["pairs"] == 24 * 63
        assert out[side]["p50_rounds"] <= out[side]["p99_rounds"]
    assert out["calibrated"]["round_ms"] == 541.17


def test_fidelity_dcn_oracle_holds_its_cpu_run(monkeypatch):
    summary, rep = H.fidelity_dcn("cpu")
    assert summary["invariants_ok"] and summary["both_recovered"]
    # The held comparisons reuse this run's report.
    monkeypatch.setattr(tscenarios, "dcn_partition", lambda device: copy.deepcopy(rep))
    again, _ = H.fidelity_dcn("cpu", cpu_report=rep)
    assert again["equal_to_cpu"] and again["calibrated"] == summary["calibrated"]
    changed = dict(rep, recovery_delta_rounds=rep["recovery_delta_rounds"] + 1)
    with pytest.raises(AssertionError, match="differs from the CPU"):
        H.fidelity_dcn("cpu", cpu_report=changed)


def test_recorded_replays_are_held_to_the_cpu():
    """The wrapper sees each replay; a replay dict that differs in one
    latency is not equal."""
    calls = []
    with H.recorded_replays(calls):
        got = tcompare.kernel_replay(_trace(1), 500.0, n_nodes=6, device="cpu")
    assert len(calls) == 1
    trace, a, kw, out = calls[0]
    assert out is got and a == (500.0,) and kw == {"n_nodes": 6, "device": "cpu"}
    want = tcompare.kernel_replay(trace, *a, **kw)
    assert H.replays_equal(got, want)
    bent = dict(want, lat_rounds=want["lat_rounds"] + np.eye(1, want["lat_rounds"].size)[0])
    assert not H.replays_equal(got, bent)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["steady", "burst"])
def test_fidelity_live_oracle(kind, tmp_path):
    out, trace = H.fidelity_live(kind, "cpu", root=tmp_path)
    assert out["calibrated_closer"] and out["replays_equal_cpu"] == 2
    assert len(trace.events) == out["writes"] == 24

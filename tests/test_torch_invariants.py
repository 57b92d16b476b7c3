"""The invariant suite (``sim/invariants.py``) against the live JAX
reference on the CPU: each runner's ``InvariantReport.to_dict()`` equals
the reference's on the same plan (facts, violations, recovery), a repro
file the reference's format wrote replays to the same report, and the
report helpers agree. The whole suite on all four engines and the fuzzer
with shrinking are slow-marked, as the reference's own suite tests are.
"""

import json

import numpy as np
import pytest
import torch

from corrosion_tpu.sim import faults as jf
from corrosion_tpu.sim import invariants as ji
from corrosion_tpu_torch.sim import faults as tf
from corrosion_tpu_torch.sim import invariants as ti

torch.set_num_threads(1)

SHORT = 24  # rounds: the shortest plan named_scenarios builds


def _plans(rounds):
    return (
        jf.named_scenarios(rounds, ji.STD_REGIONS, ji.STD_NODES, protect=ji.PROTECTED),
        tf.named_scenarios(rounds, ti.STD_REGIONS, ti.STD_NODES, protect=ti.PROTECTED),
    )


@pytest.mark.parametrize("engine,scenario", [
    ("dense", "kitchen-sink"), ("chunk", "crash-wipe"), ("chunk", "kitchen-sink"),
])
def test_runner_report_equals_the_reference(engine, scenario):
    jp, tp = (p[scenario] for p in _plans(SHORT))
    a = ji.RUNNERS[engine](jp, seed=0).to_dict()
    b = ti.RUNNERS[engine](tp, seed=0, device="cpu").to_dict()
    assert b == a
    assert b["plan"]["name"] == scenario and "chaos_lost_msgs" in b["facts"]


def test_replay_repro_of_a_reference_repro_file(tmp_path):
    """A non-healing plan's repro, written in the reference's format from
    the reference's own plan objects, fails the same way on both."""
    plan = jf.FaultPlan(SHORT, (
        jf.Fault("loss", 4, 10, prob=0.3),
        jf.Fault("partition", 6, SHORT, a=(0,)),
    ), name="never-heals")
    path = tmp_path / "repro.json"
    path.write_text(json.dumps({
        "schema": ji.REPRO_SCHEMA, "seed": 0, "engine": "dense",
        "scenario": {"nodes": ji.STD_NODES, "regions": ji.STD_REGIONS,
                     "protected": list(ji.PROTECTED)},
        "original_plan": plan.to_dict(), "plan": plan.to_dict(), "shrink_evals": 0,
        "violations": [],
    }, indent=2))
    a = ji.replay_repro(str(path)).to_dict()
    b = ti.replay_repro(str(path), device="cpu").to_dict()
    assert b == a and not b["ok"]
    assert any("did not recover" in v for v in b["violations"]), b["violations"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "corro-chaos-repro/0"}))
    with pytest.raises(ValueError, match="not a corro-chaos-repro/1"):
        ti.replay_repro(str(bad))


def test_plan_portability_and_report_helpers_equal_the_reference():
    jp, tp = _plans(48)
    for name in jp:
        for eng in ti.ENGINES:
            pj, nj = ji.plan_for_engine(jp[name], eng)
            pt, nt = ti.plan_for_engine(tp[name], eng)
            assert pt.to_dict() == pj.to_dict() and nt == nj
        cj = ji._densify(jp[name].compile(48, 4), 48, 4)
        ct = ti._densify(tp[name].compile(48, 4), 48, 4)
        for axis in ("loss", "probe_loss", "kill", "revive", "wipe", "partition"):
            a, b = getattr(cj, axis), getattr(ct, axis)
            assert (a is None and b is None) or np.array_equal(a, b), (name, axis)
        assert ti._write_window(tp[name]) == ji._write_window(jp[name])
    assert ti.PROTECTED == ji.PROTECTED and ti.ENGINES == ji.ENGINES
    rep = ti.InvariantReport("dense", False, ["x"], 9, {"recovery_rounds": None},
                             {"degraded": ["probe_loss dropped"]})
    jrep = ji.InvariantReport("dense", False, ["x"], 9, {"recovery_rounds": None},
                              {"degraded": ["probe_loss dropped"]})
    assert rep.render() == jrep.render() and rep.to_dict() == jrep.to_dict()


@pytest.mark.slow  # tier-1 budget: four engines twice at 48 rounds (~60 s)
def test_the_whole_suite_equals_the_reference():
    jp, tp = _plans(48)
    for name in ("kitchen-sink", "partition-heal"):
        a = [r.to_dict() for r in ji.run_suite(jp[name], seed=0)]
        b = [r.to_dict() for r in ti.run_suite(tp[name], seed=0, device="cpu")]
        assert b == a
        assert all(r["ok"] for r in b), [r["violations"] for r in b]


@pytest.mark.slow  # tier-1 budget: the shrink re-runs the dense engine per eval (~60 s)
def test_fuzz_with_shrinking_equals_the_reference(tmp_path):
    kw = dict(seed=1, plans=1, engines=("dense",), rounds=48, break_heal=True, shrink_evals=6)
    a = ji.fuzz(out_dir=str(tmp_path / "j"), **kw)
    b = ti.fuzz(out_dir=str(tmp_path / "t"), device="cpu", **kw)
    assert b["failures"] == a["failures"] == 1
    assert b["plans"][0]["reports"] == a["plans"][0]["reports"]
    assert b["plans"][0]["repro"] == a["plans"][0]["repro"]
    rep = ti.replay_repro(b["repros"][0], device="cpu")
    assert not rep.ok and rep.to_dict() == ji.replay_repro(a["repros"][0]).to_dict()

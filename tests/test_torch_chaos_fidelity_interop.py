"""The port's ``fidelity/`` and ``hostchaos/`` against the live reference
on the same inputs, on the CPU:

- ``kernel_replay`` of one seeded synthetic trace under four models (none,
  the committed ``ROUND_MODEL_WAN.json`` loaded by each package, the
  identity model, and a measured apply rate under a burst past capacity,
  whose deferral extends the rounds): equal dicts, ``lat_rounds`` bit for
  bit;
- ``dcn_partition(rounds=24)``: equal dicts;
- the model derivations (``wan_ring_model``, ``derive_model``,
  ``from_ring_occupancy``, ``from_characterization``) on seeded samples:
  equal ``to_dict()``;
- every scenario of ``SCENARIOS`` at seeds 0-2: the shims of each agent
  driven through one fixed event sequence record the same traces and
  fingerprints in both packages, each package's ``replay_schedule`` and
  ``verify_schedule_determinism`` accept the other's report and both
  refuse the same tampered one;
- ``check_hostchaos_budget`` and ``check_fidelity_budget``: the same
  verdicts on the same reports.

Each reference replay compiles the JAX engine once; the live scenarios
run only on the card's host (``chip_smoke.py`` phase 15) and as slow
cases.
"""

import copy
from pathlib import Path

import numpy as np
import pytest

from corrosion_tpu.agent import netem as jnetem
from corrosion_tpu.fidelity import calibrate as jcal
from corrosion_tpu.fidelity import compare as jcompare
from corrosion_tpu.fidelity import report as jfreport
from corrosion_tpu.fidelity import scenarios as jscenarios
from corrosion_tpu.hostchaos import harness as jharness
from corrosion_tpu.hostchaos import report as jhreport
from corrosion_tpu.hostchaos import scenarios as jhscenarios
from corrosion_tpu.sim.trace import Trace as JTrace
from corrosion_tpu_torch.agent import netem as tnetem
from corrosion_tpu_torch.fidelity import calibrate as tcal
from corrosion_tpu_torch.fidelity import compare as tcompare
from corrosion_tpu_torch.fidelity import report as tfreport
from corrosion_tpu_torch.fidelity import scenarios as tscenarios
from corrosion_tpu_torch.hostchaos import harness as tharness
from corrosion_tpu_torch.hostchaos import report as threport
from corrosion_tpu_torch.hostchaos import scenarios as thscenarios
from corrosion_tpu_torch.sim.trace import Trace as TTrace

REPO = Path(__file__).resolve().parent.parent
REPLAY_NODES = 12


def synthetic_events(seed: int = 0, actors=("aa", "bb", "cc"), writes: int = 10) -> list:
    """Each actor's versions 1..``writes`` at seeded gaps (ms)."""
    rng = np.random.default_rng(seed)
    events = []
    for a in actors:
        t = int(rng.integers(0, 100))
        for v in range(1, writes + 1):
            t += int(rng.integers(5, 400))
            events.append((t, a, v))
    return events


def burst_events(writes: int = 30) -> list:
    """Every write of one actor in the first 20 ms, then one late write of
    another: a burst past the capacity of a measured apply rate."""
    return [(i * 2 // 3, "aa", i + 1) for i in range(writes)] + [(900, "bb", 1)]


def _models(cal) -> dict:
    """The four models, built in package ``cal``."""
    return {
        "none": None,
        "round_model_wan": cal.RoundModel.load(str(REPO / "ROUND_MODEL_WAN.json")),
        "identity": cal.identity_model(),
        "apply_rate": cal.derive_model(
            {(0, 0): [1.0, 2.0, 4.0, 9.0]}, flush_ms=50.0, apply_ms=50.0,
            apply_rate_per_s=20.0, probe_attempts=200, probe_timeouts=6,
            provenance={"source": "test"},
        ),
    }


# The burst's replay drains for a few rounds only, so its backlog under the
# measured apply rate outlives the trace's schedule.
BURST_DRAIN_ROUNDS = 4


def _replay(compare, trace_cls, cal, model: str, **kw):
    m = _models(cal)[model]
    round_ms = cal.REFERENCE_ROUND_MS if m is None else m.round_ms
    if model == "apply_rate":
        events, kw = burst_events(), dict(kw, drain_rounds=BURST_DRAIN_ROUNDS)
    else:
        events = synthetic_events()
    return compare.kernel_replay(trace_cls(events=events), round_ms, n_nodes=REPLAY_NODES,
                                 model=m, seed=1, **kw)


@pytest.mark.parametrize("model", ["none", "round_model_wan", "identity", "apply_rate"])
def test_kernel_replay_equals_the_reference(model):
    got = _replay(tcompare, TTrace, tcal, model, device="cpu")
    want = _replay(jcompare, JTrace, jcal, model)
    assert set(got) == set(want)
    assert got["lat_rounds"].dtype == want["lat_rounds"].dtype
    assert np.array_equal(got["lat_rounds"], want["lat_rounds"])
    assert {k: v for k, v in got.items() if k != "lat_rounds"} == \
           {k: v for k, v in want.items() if k != "lat_rounds"}
    assert got["lat_rounds"].size + got["unseen"] == got["pairs"]
    if model == "apply_rate":
        # The deferral extended the schedule past its trace's rounds.
        plain = tcompare.kernel_replay(TTrace(events=burst_events()), _models(tcal)[model].round_ms,
                                       n_nodes=REPLAY_NODES, seed=1,
                                       drain_rounds=BURST_DRAIN_ROUNDS, device="cpu")
        assert got["rounds"] > plain["rounds"], (got["rounds"], plain["rounds"])
    else:
        assert got["unseen"] == 0


def test_dcn_partition_equals_the_reference():
    got = tscenarios.dcn_partition(rounds=24, device="cpu")
    want = jscenarios.dcn_partition(rounds=24)
    assert got == want
    assert got["invariants_ok"] and got["both_recovered"]


@pytest.mark.parametrize("seed", range(4))
def test_model_derivations_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    regions = 1 + seed % 3
    samples = {(i, j): rng.gamma(2.0, 30.0, size=int(rng.integers(1, 12))).tolist()
               for i in range(regions) for j in range(regions) if rng.random() < 0.8}
    samples.setdefault((0, 0), [float(rng.uniform(1, 200))])
    kw = dict(flush_ms=float(rng.uniform(50, 500)), apply_ms=float(rng.uniform(0, 60)),
              apply_rate_per_s=float(rng.uniform(0, 500)), regions=regions,
              probe_attempts=200, probe_timeouts=int(rng.integers(0, 20)),
              provenance={"source": "test", "seed": seed})
    assert tcal.derive_model(samples, **kw).to_dict() == jcal.derive_model(samples, **kw).to_dict()

    occ = rng.integers(0, 5, size=(regions, regions, len(jcal.RING_REPR_MS)))
    occ[..., 0] += 1  # every pair holds a sample
    kw = dict(flush_ms=float(rng.uniform(50, 500)), apply_ms=float(rng.uniform(0, 60)),
              probe_loss=float(rng.uniform(0, 0.2)))
    assert tcal.from_ring_occupancy(occ, **kw).to_dict() == \
           jcal.from_ring_occupancy(occ, **kw).to_dict()

    p50 = float(rng.uniform(0.2, 20))
    char = {"probe_rtt_under_bulk_ms": {"p50": p50, "p99": p50 * float(rng.uniform(1, 8))},
            "probe_loss_under_bulk": float(rng.uniform(0, 0.1)), "rows": seed}
    assert tcal.from_characterization(char, flush_ms=50.0).to_dict() == \
           jcal.from_characterization(char, flush_ms=50.0).to_dict()
    assert tscenarios.wan_ring_model(flush_ms=kw["flush_ms"]).to_dict() == \
           jscenarios.wan_ring_model(flush_ms=kw["flush_ms"]).to_dict()
    assert tcal.RING_REPR_MS == jcal.RING_REPR_MS
    assert tcal.trace_fingerprint(synthetic_events(seed)) == \
           jcal.trace_fingerprint(synthetic_events(seed))


# -- the host-chaos schedules ---------------------------------------------------------


def drive_shim(netem, spec, seed: int, local: int) -> tuple:
    """Agent ``local``'s shim of scenario ``spec`` at ``seed`` through one
    fixed event sequence over 24 s of plan time: every peer's datagrams and
    each stream plane. Returns (trace, fingerprint, stats)."""
    clock = [0.0]
    plan = netem.HostFaultPlan.from_json(spec.plan.to_json())
    shim = netem.NetemShim(plan, seed=seed, local=f"n{local}", clock=lambda: clock[0])
    peers = [j for j in range(spec.n_agents) if j != local]
    for j in peers:
        shim.register_peer(("127.0.0.1", 7000 + j), f"n{j}")
    shim.arm()
    for step in range(160):
        clock[0] += 0.15
        addr = ("127.0.0.1", 7000 + peers[step % len(peers)])
        shim.udp_fault(addr)
        shim.stream_fault("bcast", addr)
        if step % 3 == 0:
            shim.stream_fault("sync", addr)
    return [dict(e) for e in shim.trace], shim.fingerprint(), dict(shim.stats)


def _report(spec, seed: int, agents: dict) -> dict:
    return {
        "scenario": spec.name, "seed": seed, "plan": spec.plan.to_json_obj(),
        "netem": {"seed": seed, "agents": {
            name: {"trace": trace, "trace_fingerprint": fp} for name, (trace, fp, _) in agents.items()
        }} if not spec.plan.empty else {},
    }


@pytest.mark.parametrize("name", sorted(jhscenarios.SCENARIOS))
def test_scenario_fingerprints_equal_the_reference(name):
    tspec, jspec = thscenarios.get_scenario(name), jhscenarios.get_scenario(name)
    assert tspec.plan.to_json() == jspec.plan.to_json()
    for seed in range(3):
        t_agents, j_agents = {}, {}
        for i in range(tspec.n_agents):
            t_agents[f"n{i}"] = drive_shim(tnetem, tspec, seed, i)
            j_agents[f"n{i}"] = drive_shim(jnetem, jspec, seed, i)
            assert t_agents[f"n{i}"] == j_agents[f"n{i}"], (name, seed, i)
            trace = t_agents[f"n{i}"][0]
            assert tnetem.replay_schedule(tspec.plan, seed, f"n{i}", trace) == \
                   jnetem.replay_schedule(jspec.plan, seed, f"n{i}", trace) == (True, [])
        rep = _report(tspec, seed, t_agents)
        assert tharness.verify_schedule_determinism(rep) == \
               jharness.verify_schedule_determinism(rep) == (True, [])
        if tspec.plan.empty:
            continue
        assert any(tr for tr, _, _ in t_agents.values()), name
        bad = copy.deepcopy(rep)
        trace = next(b["trace"] for b in bad["netem"]["agents"].values() if b["trace"])
        trace[0]["drop"] = not trace[0]["drop"]
        got = tharness.verify_schedule_determinism(bad)
        assert not got[0] and got == jharness.verify_schedule_determinism(bad)
    assert tharness.verify_schedule_determinism({}) == jharness.verify_schedule_determinism({})


# -- the budget gates -------------------------------------------------------------


def _hostchaos_block(**kw) -> dict:
    block = {
        "oracle": {"violations": 0}, "machinery_ok": True,
        "machinery_required": ["breaker_trips"], "machinery": {"breaker_trips": 2},
        "converged": True, "bookkeeping_contiguous": True, "ok": True,
        "drain_s": 1.5, "convergence_s": 0.4, "failures": [],
    }
    block.update(kw)
    return block


def hostchaos_reports() -> list:
    good = _hostchaos_block()
    return [
        {"platform": p, "scenario": "host_chaos_smoke", "scenarios": s}
        for p in ("cpu", "gpu")
        for s in (
            {"wan_steady": good, "kill_restart": good},
            {"wan_steady": good},
            {"wan_steady": _hostchaos_block(drain_s=45.0), "kill_restart": good},
            {"wan_steady": good, "kill_restart": _hostchaos_block(machinery_ok=False)},
            {"wan_steady": _hostchaos_block(oracle={"violations": 2}),
             "kill_restart": _hostchaos_block(converged=False, failures=["x"])},
            {"wan_steady": _hostchaos_block(convergence_s=None), "kill_restart": good},
        )
    ]


def test_hostchaos_budget_verdicts_equal_the_reference():
    import json

    budget = json.loads((REPO / "bench_budget.json").read_text())["hostchaos"]
    budgets = [budget, dict(budget, tolerance=10.0), dict(budget, require_converged=False,
                                                           require_machinery_fired=False), {}]
    verdicts = []
    for rep in hostchaos_reports():
        for b in budgets:
            got = threport.check_hostchaos_budget(rep, b)
            assert got == jhreport.check_hostchaos_budget(rep, b)
            verdicts.append(got[0])
    assert True in verdicts and False in verdicts


def fidelity_reports() -> list:
    base = {
        "platform": "cpu", "scenario": "ci_smoke",
        "scenarios": {
            "steady": {"calibrated": {"cdf_distance": 0.79, "p99_bucket_delta": 1, "unseen": 0},
                       "uncalibrated": {"cdf_distance": 2.77}, "calibrated_closer": True,
                       "live": {"unseen": 0}},
            "burst": {"calibrated": {"cdf_distance": 0.625, "p99_bucket_delta": 1, "unseen": 0},
                      "uncalibrated": {"cdf_distance": 2.625}, "calibrated_closer": True,
                      "live": {"unseen": 0}},
            "dcn": {"invariants_ok": True, "recovery_delta_rounds": 0,
                    "calibrated": {"unseen": 0}},
        },
    }
    out = [base, dict(base, platform="gpu")]
    for path, value in (("steady.calibrated_closer", False), ("dcn.invariants_ok", False),
                        ("burst.calibrated.cdf_distance", 3.0), ("steady.live.unseen", 2),
                        ("dcn.recovery_delta_rounds", 7)):
        rep = copy.deepcopy(base)
        scen, *keys = path.split(".")
        cur = rep["scenarios"][scen]
        for k in keys[:-1]:
            cur = cur[k]
        cur[keys[-1]] = value
        out.append(rep)
    gone = copy.deepcopy(base)
    del gone["scenarios"]["burst"]
    return out + [gone]


def test_fidelity_budget_verdicts_equal_the_reference():
    import json

    budget = json.loads((REPO / "bench_budget.json").read_text())["fidelity"]
    budgets = [budget, dict(budget, tolerance=1000.0), dict(budget, unseen_max=5), {}]
    verdicts = []
    for rep in fidelity_reports():
        for b in budgets:
            got = tfreport.check_fidelity_budget(rep, b)
            assert got == jfreport.check_fidelity_budget(rep, b)
            verdicts.append(got[0])
    assert True in verdicts and False in verdicts

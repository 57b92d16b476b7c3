"""The port's bench harness (``corrosion_tpu_torch/sim/benchlib.py``)
against the live JAX reference on the CPU:

- every pure helper gives the reference's result, or raises the
  reference's exception, on the same inputs; the constants are the
  reference's;
- ``check_budget`` gives the reference's ``(ok, breaches)`` on the
  committed ``bench_budget.json`` and on synthetic budgets;
- ``plane_composite``: each cumulative prefix's carry after two steps
  equals the reference's, bit for bit, from a small merge_10k final state,
  on the fast path and on the forced wide path (ROADMAP Queue 3);
- ``measure_multichip`` at a small shape (64 nodes, D in {1, 8}): the
  equality flags, the exchange bytes and the traffic model equal the
  reference's. The reference's plane attribution and roofline lowerings
  are replaced by stubs there: they only time and cost the composite
  (pinned above), and would compile ten more programs; its large tail
  (``_measure_large``, 64 nodes on 8 positions) gives the reference's
  convergence, residual need and exchange bytes;
- the elastic drills' checkpoint fingerprints, which now come from
  ``benchlib.config_fingerprint``, are the ones they had before.

Tolerance: exact everywhere.
"""

import dataclasses
import glob
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu import models as jmodels
from corrosion_tpu.obs import costs as jcosts
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu.sim import benchlib as jbench
from corrosion_tpu.sim import engine as jengine
from corrosion_tpu.sim import telemetry as jtele
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.elastic import scenarios
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.sim import benchlib as tbench
from corrosion_tpu_torch.sim import checkpoint
from corrosion_tpu_torch.sim import engine as tengine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception's type is the result
        return "raises", type(e).__name__


NESTED = {"a": {"b": {"c": 3}}, "x": 1, "l": [1, 2]}


@pytest.mark.parametrize("name,args", [
    ("get_path", (NESTED, "a.b.c")),
    ("get_path", (NESTED, "a.b")),
    ("get_path", (NESTED, "a.z.c")),
    ("get_path", (NESTED, "x.y")),
    ("get_path", (NESTED, "l.0")),
    ("get_path", ({}, "")),
    ("get_path", (NESTED, None)),
    ("config_fingerprint", ("cfg-repr", 128, 48)),
    ("config_fingerprint", ()),
    ("config_fingerprint", ((1, 2), {"k": [1.5]}, None, "x\x00y")),
    ("rounded_step_report", (123.456, {"broadcast": 50.04, "swim": 20.05, "sync": 30.15})),
    ("rounded_step_report", (0.0, {})),
    ("rounded_step_report", (10.0, {"a": None})),
    ("rounded_step_report", (None, {})),
    ("roofline_report", ({"broadcast": {"flops": 1e6, "bytes": 2e6}}, {"broadcast": 50.0, "swim": 0.0})),
    ("roofline_report", ({"a": {"flops": 3, "bytes": 0}}, {"a": 1.5})),
    ("roofline_report", ({"a": {"flops": 3}}, {"a": 1.5})),
    ("roofline_report", ({}, {})),
    ("compile_split_report", (74.82, 61234.5)),
    ("compile_split_report", (1.0, 5000.0)),
    ("compile_split_report", (0.0, 0.0)),
    ("compile_split_report", ("1", 2.0)),
])
def test_pure_helpers_equal_the_reference(name, args):
    assert _outcome(getattr(tbench, name), *args) == _outcome(getattr(jbench, name), *args)


def test_constants_are_the_reference_s():
    for name in ("PLANE_STAGES", "DEFAULT_TOLERANCE", "MULTICHIP_DEVICE_COUNTS", "MULTICHIP_NODES",
                 "MULTICHIP_ROUNDS", "MULTICHIP_SPARSE_NODES", "MULTICHIP_SEED",
                 "MULTICHIP_STATE_FRACTION"):
        assert getattr(tbench, name) == getattr(jbench, name), name
    # multichip_mesh is the mesh module's own, re-exported.
    from corrosion_tpu_torch.parallel import mesh as tmesh

    assert tbench.multichip_mesh is tmesh.multichip_mesh


def test_bench_context_names_the_platform_it_was_given():
    ctx = tbench.bench_context("cfg-repr", 128, 48, device="cpu")
    assert ctx == {"platform": "cpu", "device_count": 1,
                   "config_fingerprint": jbench.config_fingerprint("cfg-repr", 128, 48)}
    assert ctx != tbench.bench_context("cfg-repr", 256, 48, device="cpu")
    with pytest.raises(TypeError):
        tbench.bench_context("cfg-repr")  # the device is never guessed


def _budget_cases():
    budget = json.loads((REPO / "bench_budget.json").read_text())
    synthetic = [
        {"tolerance": 1.5, "platform": "cpu", "kernels": "native", "step_ms": 100.0},
        {"step_ms": 100.0, "plane_ms": {"broadcast": 60.0, "sync": 30.0}},
        {"tolerance": 2, "nodes": 512, "rounds": 60, "device_count": 1, "step_ms": 10,
         "plane_ms": {"broadcast": 5, "swim": 1}},
    ]
    measured = [
        {"platform": "tpu", "kernels": "native", "step_ms": 1.0},
        {"platform": "cpu", "kernels": "pallas", "step_ms": 1.0},
        {"platform": "cpu", "kernels": "native", "step_ms": 1.0},
        {"step_ms": 100.0, "plane_ms": {"broadcast": 60.0, "sync": 30.0}},
        {"step_ms": 151.0, "plane_ms": {"broadcast": 91.0}},
        {"step_ms": 149.9, "plane_ms": {"broadcast": 89.9, "sync": 45.0}},
        {"platform": "gpu", "kernels": "cuda", "nodes": 512, "rounds": 60, "device_count": 1,
         "step_ms": 10.0, "plane_ms": {"broadcast": 10.0, "swim": 2.0, "sync": 1.0}},
        {"platform": "cpu", "kernels": "plain", "nodes": 512, "rounds": 60, "device_count": 8,
         "step_ms": 25.0},
        {},
    ]
    return [(m, b) for b in [budget, *synthetic] for m in measured]


@pytest.mark.parametrize("measured,budget", _budget_cases())
def test_check_budget_equals_the_reference(measured, budget):
    assert _outcome(tbench.check_budget, measured, budget) == \
        _outcome(jbench.check_budget, measured, budget)


def test_committed_budget_refuses_a_gpu_report():
    """The committed budget was refreshed on a TPU: a report of the port
    breaches on its platform, as the reference's rule says."""
    budget = json.loads((REPO / "bench_budget.json").read_text())
    ok, breaches = tbench.check_budget({"platform": "gpu", "kernels": "cuda", "step_ms": 1.0}, budget)
    assert not ok and any(b.startswith("platform:") for b in breaches)


# ---- plane_composite --------------------------------------------------------


def _carry_equal(tcarry, jcarry):
    td, tsw, tvr = tcarry
    jd, jsw, jvr = jcarry
    want = {"data": jd._asdict(), "swim": jsw._asdict()}
    want["data"]["cells"] = jd.cells._asdict()
    got = {"data": interop.to_numpy(td), "swim": interop.to_numpy(tsw)}
    bad = []

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        elif not np.array_equal(np.asarray(a), np.asarray(b)):
            bad.append(path)

    walk(got, want, "")
    if not np.array_equal(tvr.numpy(), np.asarray(jvr)):
        bad.append("vis_round")
    return bad


def _burst(sched, n_rounds):
    writes = sched.writes.copy()
    writes[:n_rounds, :] = 2
    return dataclasses.replace(sched, writes=writes).make_samples(32)


@pytest.fixture(params=["fast", "wide"])
def composite_pair(request):
    """The reference's and the port's composite over the same small
    merge_10k final state (n=48, 24 rounds of bursts), on the fast path
    or the forced wide path."""
    wide = request.param == "wide"
    saved = (jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS)
    if wide:
        jax.clear_caches()
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        jcfg, jtopo, jsched = jmodels.merge_10k(n=48, rounds=24, samples=32)
        jsched = _burst(jsched, 12)
        jfinal, _ = jengine.simulate(jcfg, jtopo, jsched, seed=0)
        tcfg, ttopo, tsched = tb.merge_10k(n=48, rounds=24, samples=32, device="cpu")
        tsched = _burst(tsched, 12)
        tfinal, _ = tengine.simulate(tcfg, ttopo, tsched, seed=0, device="cpu")
        yield (jbench.plane_composite(jcfg, jtopo, jsched, jfinal),
               tbench.plane_composite(tcfg, ttopo, tsched, tfinal))
    finally:
        if wide:
            jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = saved
            jax.clear_caches()


def test_plane_composite_prefixes_equal_the_reference(composite_pair):
    (jmake, jstages, jcarry0), (tmake, tstages, tcarry0) = composite_pair
    assert tstages == jstages == ("broadcast", "swim", "sync", "track")
    assert not _carry_equal(tcarry0, jcarry0)
    for k in range(len(tstages) + 1):
        jstep, tstep = jmake(tuple(jstages[:k])), tmake(tuple(tstages[:k]))
        jc, tc = jcarry0, tcarry0
        for i in range(2):
            jc = jax.jit(jstep)(jc, jnp.int32(i))
            tc = tstep(tc, i)
        bad = _carry_equal(tc, jc)
        assert not bad, f"prefix {tstages[:k]}: carry differs in {bad}"


# ---- measure_multichip ------------------------------------------------------


SMALL_LANE = dict(MULTICHIP_NODES=64, MULTICHIP_SPARSE_NODES=64, MULTICHIP_ROUNDS=16)


def test_measure_multichip_flags_and_bytes_equal_the_reference(monkeypatch):
    for name, v in SMALL_LANE.items():
        monkeypatch.setattr(jbench, name, v)
        monkeypatch.setattr(tbench, name, v)
    monkeypatch.setattr(jtele, "attribute_planes", lambda make, stages, carry, iters=10:
                        jtele.PlaneAttribution(tuple(stages), tuple(range(len(stages) + 1))))
    monkeypatch.setattr(jcosts, "roofline_stage_costs", lambda comp, stages, carry:
                        {s: {"flops": 0.0, "bytes": 0.0} for s in stages})
    want = jbench.measure_multichip(device_counts=(1, 8))
    got = jtele.check_bench_invariants(tbench.measure_multichip(device_counts=(1, 8), device="cpu"))
    for k in ("bit_identical_across_device_counts", "converged", "xshard_bytes_per_round_ici",
              "xshard_bytes_per_round_dcn", "traffic_model", "nodes", "sparse_nodes", "rounds",
              "seed", "device_counts", "device_count", "metric"):
        assert got[k] == want[k], k
    assert set(got) == set(want)
    assert got["platform"] == "cpu" and got["kernels"] == "plain"
    assert set(got["roofline"]) == set(got["plane_ms"]) == set(tbench.PLANE_STAGES)



@pytest.mark.parametrize("rounds", [4, 24])
def test_measure_large_fields_equal_the_reference(rounds):
    """The lane's large tail at 64 nodes on the 8-position mesh: cut short
    (4 rounds, still draining) and run to convergence (24). The state
    bytes are the port's own (int64 carriers), held to the capacity
    model's prediction for the same config at rest."""
    from corrosion_tpu_torch.obs import costs as tcosts

    n = 64
    want = jbench._measure_large(n, rounds, jbench.multichip_mesh(8), lambda msg: None)
    mesh = tbench.multichip_mesh(8, device="cpu")
    got = tbench._measure_large(n, rounds, mesh, lambda msg: None)
    assert set(got) == set(want)
    for k in ("nodes", "rounds", "converged", "need_last", "xshard_bytes_per_round_ici",
              "xshard_bytes_per_round_dcn"):
        assert got[k] == want[k], k
    assert got["converged"] == (rounds == 24) and (got["need_last"] == 0) == (rounds == 24)
    predicted = tcosts.predicted_state_bytes(tcosts.flagship_cfg(n)[0], 16, mesh)
    assert got["state_mib_per_device_max"] == round(predicted / 2**20, 2)

# ---- the elastic drills' fingerprints ---------------------------------------

DRILL_FINGERPRINTS = {
    "reshard_dense_4to8": "9e7d07f60d72cebf",
    "reshard_sparse_4to8": "82ce0684e0a83690",
    "reshard_chunk_4to8": "4222873ec2202585",
    "reshard_mixed_4to8": "0a353d64737eed78",
    "preempt_dense_churn": "376c8d41f3531a67",
}


@pytest.mark.parametrize("name", sorted(DRILL_FINGERPRINTS))
def test_drill_fingerprints_unchanged(name, tmp_path):
    scenarios.run_scenario(name, checkpoint_dir=str(tmp_path), device="cpu")
    files = sorted(glob.glob(str(tmp_path / "*.npz")))
    assert files
    assert {checkpoint.read_header(f)["config_fingerprint"] for f in files} == \
        {DRILL_FINGERPRINTS[name]}

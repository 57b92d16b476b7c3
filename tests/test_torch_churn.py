"""Churn, wipe and rejoin sync of the port against the JAX reference:
``churn_32()`` (ten flapping nodes over dense SWIM: ``apply_churn``, the
5-way key split, ``revive_sync``) as a whole run, bit-equal in every
round curve and final-state leaf; the same run with ``wipe`` set to its
kill mask (``faulting.wipe_nodes``); and the run carried across mid-run
at round 200 — after kills and revivals — through ``interop`` and
continued in the port, against the reference's uninterrupted run.
"""

import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import swim as tsw
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import telemetry as tt

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

SPLIT = 200


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _nested(tree):
    if hasattr(tree, "_fields"):
        return {k: _nested(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _assert_tree_equal(jax_tree, port_tree):
    a, b = _flat(jax_tree), _flat(interop.to_numpy(port_tree))
    assert a.keys() == b.keys()
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"state differs in {bad}"


def _assert_curves_equal(cj, ct, start=0):
    assert set(ct) == set(tt.ROUND_CURVE_KEYS) == set(cj)
    bad = [
        k for k in cj
        if not (cj[k].dtype == ct[k].dtype and np.array_equal(cj[k][start:], ct[k]))
    ]
    assert not bad, f"curves differ in {bad}"


def _wiped(sched, schedule_cls):
    return schedule_cls(
        writes=sched.writes, kill=sched.kill, revive=sched.revive,
        wipe=sched.kill.copy(), sample_writer=sched.sample_writer,
        sample_ver=sched.sample_ver, sample_round=sched.sample_round,
    )


def _both(name, **kw):
    return getattr(jb, name)(**kw), getattr(tb, name)(device="cpu", **kw)


@pytest.fixture(scope="module")
def churn_reference():
    cj, topo_j, sched_j = jb.churn_32()
    final_j, curves_j = je.simulate(cj, topo_j, sched_j, seed=0)
    return cj, topo_j, sched_j, final_j, curves_j


def test_churn_32_run_matches_reference(churn_reference):
    _, _, sched_j, final_j, curves_j = churn_reference
    ct, topo_t, sched_t = tb.churn_32(device="cpu")
    for f in ("writes", "kill", "revive", "sample_writer", "sample_ver", "sample_round"):
        assert np.array_equal(getattr(sched_j, f), getattr(sched_t, f)), f
    final_t, curves_t = te.simulate(ct, topo_t, sched_t, seed=0, device="cpu")
    # The storm is live: kills are detected, revivals flap incarnations
    # and rejoin syncs apply versions.
    assert curves_j["mismatches"].max() > 0 and curves_j["mismatches"][-1] == 0
    assert curves_j["swim_undetected_deaths"].sum() > 0
    _assert_curves_equal(curves_j, curves_t)
    _assert_tree_equal(final_j, final_t)


def test_churn_32_with_wipe_matches_reference():
    (cj, topo_j, sched_j), (ct, topo_t, sched_t) = _both("churn_32")
    sched_j = _wiped(sched_j, je.Schedule)
    sched_t = _wiped(sched_t, te.Schedule)
    final_j, curves_j = je.simulate(cj, topo_j, sched_j, seed=0)
    final_t, curves_t = te.simulate(ct, topo_t, sched_t, seed=0, device="cpu")
    assert curves_j["chaos_wiped"].sum() == sched_j.kill.sum() > 0
    _assert_curves_equal(curves_j, curves_t)
    _assert_tree_equal(final_j, final_t)


def test_churn_32_carried_across_mid_run(churn_reference):
    cj, topo_j, sched_j, final_j, curves_j = churn_reference
    mid_j, _ = je.simulate(
        cj, topo_j,
        je.Schedule(
            writes=sched_j.writes[:SPLIT], kill=sched_j.kill[:SPLIT],
            revive=sched_j.revive[:SPLIT], sample_writer=sched_j.sample_writer,
            sample_ver=sched_j.sample_ver, sample_round=sched_j.sample_round,
        ),
        seed=0,
    )
    # Kills and revivals both happened before the carry, and more follow.
    assert sched_j.kill[:SPLIT].any() and sched_j.revive[:SPLIT].any()
    assert sched_j.kill[SPLIT:].any() and sched_j.revive[SPLIT:].any()
    ct, _, sched_t = tb.churn_32(device="cpu")
    topo_t = interop.topology_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in topo_j._asdict().items()},
        device="cpu",
    )
    state_t = interop.cluster_state_from_numpy(_nested(mid_j), device="cpu")
    assert isinstance(state_t.swim, tsw.SwimState)
    final_t, curves_t = te.simulate(
        ct, topo_t, sched_t.slice(SPLIT, sched_t.rounds), seed=0, state=state_t,
        device="cpu", max_chunk=64,
    )
    _assert_curves_equal(curves_j, curves_t, start=SPLIT)
    _assert_tree_equal(final_j, final_t)

"""Whole-run parity: the port's ``simulate`` on a shrunken wan_100k equals
the JAX reference bit for bit — every round curve and every final-state
leaf — over 72 rounds, so the region-0 partition (rounds 60-71) is live.

Also: a JAX state carried across mid-run continues identically in the
port, and the port's chunked run equals its unchunked run.
"""

import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import telemetry as tt

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

KW = dict(n=400, n_regions=4, n_writers=32, rounds=72, samples=64)
SPLIT = 40


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


def _assert_state_equal(jax_state, port_state):
    a, b = _flat(jax_state), _flat(interop.to_numpy(port_state))
    assert a.keys() == b.keys()
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"final state differs in {bad}"


def _assert_curves_equal(cj, ct, start=0):
    assert set(ct) == set(tt.ROUND_CURVE_KEYS) == set(cj)
    bad = [
        k for k in cj
        if not (cj[k].dtype == ct[k].dtype and np.array_equal(cj[k][start:], ct[k]))
    ]
    assert not bad, f"curves differ in {bad}"


def _jax_schedule_slice(s, start, stop):
    return je.Schedule(
        writes=s.writes[start:stop],
        partition=None if s.partition is None else s.partition[start:stop],
        sample_writer=s.sample_writer, sample_ver=s.sample_ver,
        sample_round=s.sample_round,
    )


@pytest.fixture(scope="module")
def reference():
    cfg, topo, sched = jb.wan_100k(**KW)
    final, curves = je.simulate(cfg, topo, sched, seed=0)
    return cfg, topo, sched, final, curves


@pytest.fixture(scope="module")
def port_run():
    cfg, topo, sched = tb.wan_100k(device="cpu", **KW)
    final, curves = te.simulate(cfg, topo, sched, seed=0, device="cpu")
    return cfg, topo, sched, final, curves


def test_wan_100k_run_matches_reference(reference, port_run):
    _, _, sched, final_j, curves_j = reference
    _, _, _, final_t, curves_t = port_run
    # The run exercises what it should: the partition, the window and
    # the sync plane all act, and sampled writes become visible.
    assert sched.partition[60:72].any()
    assert curves_j["sync_regrant"].sum() > 0
    assert curves_j["applied_sync"].sum() > 0 and curves_j["vis_count"].sum() > 0
    _assert_curves_equal(curves_j, curves_t)
    _assert_state_equal(final_j, final_t)


def test_state_carried_across_mid_run(reference):
    cfg_j, topo_j, sched_j, final_j, curves_j = reference
    mid_j, _ = je.simulate(
        cfg_j, topo_j, _jax_schedule_slice(sched_j, 0, SPLIT), seed=0
    )
    cfg_t, _, sched_t = tb.wan_100k(device="cpu", **KW)
    topo_t = interop.topology_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in topo_j._asdict().items()},
        device="cpu",
    )
    state_t = interop.cluster_state_from_numpy(_nested(mid_j), device="cpu")
    final_t, curves_t = te.simulate(
        cfg_t, topo_t, sched_t.slice(SPLIT, KW["rounds"]), seed=0,
        state=state_t, device="cpu",
    )
    _assert_curves_equal(curves_j, curves_t, start=SPLIT)
    _assert_state_equal(final_j, final_t)


def test_chunked_run_equals_unchunked(port_run):
    cfg, topo, sched, final, curves = port_run
    final_c, curves_c = te.simulate(
        cfg, topo, sched, seed=0, max_chunk=16, device="cpu"
    )
    for k in curves:
        assert np.array_equal(curves[k], curves_c[k]) and curves[k].dtype == curves_c[k].dtype, k
    a, b = _flat(interop.to_numpy(final)), _flat(interop.to_numpy(final_c))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_visibility_latencies_match_reference(reference, port_run):
    cfg_j, _, sched, final_j, _ = reference
    cfg_t, _, _, final_t, _ = port_run
    a = je.visibility_latencies(final_j, sched, cfg_j)
    b = te.visibility_latencies(final_t, sched, cfg_t)
    assert a == b

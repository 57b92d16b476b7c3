"""Whole-run parity of the propagation plane and the adaptive mechanisms:
the port's engines equal the JAX reference bit for bit on every round
curve (``ROUND_CURVE_KEYS``: the link matrix, the useful/duplicate split,
the rumor-age histogram, the kill and pull counters among them) and every
final-state leaf, ``q_dup`` included.

- the reference's committed geo epidemic scenario,
  ``churned_demo_cluster(96, 48, geo=True)``, push-only and with
  ``ADAPTIVE_GOSSIP``, through the dense engine; the port's curves also
  keep the plane's conservation identities;
- a reference state taken mid-run under the rumor kill, carried into the
  port through ``interop`` and run on from there by both packages;
- the any-node-writes engine on ``anywrite_sparse(n=96, ...)`` with
  ``prop_observe`` and ``ADAPTIVE_GOSSIP``, and its state's ``q_dup``
  carried through ``interop.sparse_state_from_numpy``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import engine as je
from corrosion_tpu.sim import health as jh
from corrosion_tpu.sim import sparse_engine as jse
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import health as th
from corrosion_tpu_torch.sim import sparse_engine as tse
from corrosion_tpu_torch.sim import telemetry as tt

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

GEO = dict(nodes=96, rounds=48, samples=64, geo=True)
SPLIT = 24


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
        if not (np.asarray(cj[k]).dtype == ct[k].dtype and np.array_equal(np.asarray(cj[k])[start:], ct[k]))
    ]
    assert not bad, f"curves differ in {bad}"


def _mass(curves, keys):
    return sum(curves[k].astype(np.int64) for k in keys)


def _assert_conservation(curves):
    msgs = curves["msgs"].astype(np.int64)
    assert np.array_equal(_mass(curves, tt.LINK_CURVE_KEYS), msgs)
    assert np.array_equal(_mass(curves, ("prop_useful_msgs", "prop_dup_msgs")), msgs)
    assert np.array_equal(_mass(curves, tt.RUMOR_AGE_KEYS), curves["vis_count"].astype(np.int64))


_REF: dict = {}


def _reference(adaptive):
    if adaptive not in _REF:
        cfg, topo, sched, _ = jh.churned_demo_cluster(adaptive=adaptive, **GEO)
        _REF[adaptive] = (cfg, topo, sched, *je.simulate(cfg, topo, sched, seed=0))
    return _REF[adaptive]


@pytest.mark.parametrize("adaptive", [False, True], ids=["push", "adaptive"])
def test_geo_epidemic_run_matches_reference(adaptive):
    *_, final_j, curves_j = _reference(adaptive)
    cfg, topo, sched, _ = th.churned_demo_cluster(adaptive=adaptive, device="cpu", **GEO)
    final_t, curves_t = te.simulate(cfg, topo, sched, seed=0, device="cpu")
    _assert_curves_equal(curves_j, curves_t)
    _assert_state_equal(final_j, final_t)
    _assert_conservation(curves_t)
    kills = int(curves_t["prop_rumor_kills"].sum())
    pulls = int(curves_t["prop_pull_rounds"].sum())
    assert (kills > 0 and pulls > 0) if adaptive else (kills == pulls == 0)
    assert curves_t["need"][-1] == 0 and curves_t["mismatches"][-1] == 0


def _jax_slice(s, start, stop):
    return je.Schedule(
        writes=s.writes[start:stop], kill=s.kill[start:stop], revive=s.revive[start:stop],
        sample_writer=s.sample_writer, sample_ver=s.sample_ver, sample_round=s.sample_round,
    )


def test_killed_rumor_state_carried_across_mid_run():
    """A reference state after ``SPLIT`` rounds of the adaptive run
    (``rumor_kill_k = 2``, non-empty ``q_dup``) converts to the port's,
    back to the same arrays, and steps on in the port exactly as the
    reference's uninterrupted run does: the first round after the split,
    then the rest."""
    cfg_j, topo_j, sched_j, final_j, curves_j = _reference(True)
    assert cfg_j.gossip.rumor_kill_k == 2
    mid_j, _ = je.simulate(cfg_j, topo_j, _jax_slice(sched_j, 0, SPLIT), seed=0)
    nested = _nested(mid_j)
    assert nested["data"]["q_dup"].shape == (GEO["nodes"], cfg_j.gossip.queue)
    assert nested["data"]["q_dup"].any()
    state_t = interop.cluster_state_from_numpy(nested, device="cpu")
    _assert_state_equal(mid_j, state_t)
    cfg_t, _, sched_t, _ = th.churned_demo_cluster(adaptive=True, device="cpu", **GEO)
    topo_t = interop.topology_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in topo_j._asdict().items()},
        device="cpu",
    )
    one_t, curves_one = te.simulate(
        cfg_t, topo_t, sched_t.slice(SPLIT, SPLIT + 1), seed=0, state=state_t, device="cpu"
    )
    _assert_curves_equal({k: np.asarray(v)[SPLIT:SPLIT + 1] for k, v in curves_j.items()}, curves_one)
    final_t, curves_t = te.simulate(
        cfg_t, topo_t, sched_t.slice(SPLIT + 1, GEO["rounds"]), seed=0, state=one_t, device="cpu"
    )
    _assert_curves_equal(curves_j, curves_t, start=SPLIT + 1)
    _assert_state_equal(final_j, final_t)


SPARSE = dict(n=96, w_hot=16, n_regions=4, rounds=24, cohort=8, epoch_rounds=8, k_dev=8, samples=16)


def _adaptive_sparse(cfg):
    kw = dict(prop_observe=True, **jh.ADAPTIVE_GOSSIP)
    return dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, **kw))


def test_sparse_engine_adaptive_run_matches_reference():
    cfg_j, topo_j, sched_j = jb.anywrite_sparse(**SPARSE)
    sj, swj, vj, curves_j, info_j = jse.simulate_sparse(_adaptive_sparse(cfg_j), topo_j, sched_j, seed=0)
    cfg_t, topo_t, sched_t = tb.anywrite_sparse(device="cpu", **SPARSE)
    st, swt, vt, curves_t, info_t = tse.simulate_sparse(
        _adaptive_sparse(cfg_t), topo_t, sched_t, seed=0, device="cpu"
    )
    _assert_curves_equal(curves_j, curves_t)
    _assert_state_equal(sj, st)
    _assert_state_equal(swj, swt)
    assert np.array_equal(np.asarray(vj), vt.numpy())
    info_j.pop("resume"), info_t.pop("resume")
    assert info_j == info_t
    _assert_conservation(curves_t)
    assert curves_t["prop_rumor_kills"].sum() > 0
    # The sparse state, q_dup and all, carried through interop.
    nested = _nested(sj)
    assert nested["data"]["q_dup"].shape == (SPARSE["n"], cfg_j.gossip.queue)
    _assert_state_equal(sj, interop.sparse_state_from_numpy(nested, device="cpu"))

"""Dense SWIM and the sync-driven builders of the port against the JAX
reference: ``three_node()`` and ``anti_entropy_1k(n=200, burst=400)`` as
whole runs, bit-equal in every round curve and final-state leaf, plus
single-step checks of the dense ``swim_round``/``apply_churn`` (with
wipe, probe loss and down-member GC) and the sparse ``apply_churn`` from
one state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import swim as jsw
from corrosion_tpu.ops import swim_sparse as jss
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import swim as tsw
from corrosion_tpu_torch.ops import swim_sparse as tss
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import telemetry as tt

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


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


def _both(name, **kw):
    return getattr(jb, name)(**kw), getattr(tb, name)(device="cpu", **kw)


def test_three_node_run_matches_reference():
    (cj, topo_j, sched_j), (ct, topo_t, sched_t) = _both("three_node")
    assert dataclasses.asdict(cj.gossip) == dataclasses.asdict(ct.gossip)
    final_j, curves_j = je.simulate(cj, topo_j, sched_j, seed=0)
    final_t, curves_t = te.simulate(ct, topo_t, sched_t, seed=0, device="cpu")
    assert curves_j["need"][-1] == 0 and curves_j["vis_count"].sum() > 0
    _assert_curves_equal(curves_j, curves_t)
    _assert_tree_equal(final_j, final_t)


def test_anti_entropy_1k_run_matches_reference():
    kw = dict(n=200, burst=400)
    (cj, topo_j, sched_j), (ct, topo_t, sched_t) = _both("anti_entropy_1k", **kw)
    final_j, curves_j = je.simulate(cj, topo_j, sched_j, seed=0)
    final_t, curves_t = te.simulate(ct, topo_t, sched_t, seed=0, device="cpu")
    assert curves_j["applied_sync"].sum() > 0 and curves_j["need"][-1] == 0
    _assert_curves_equal(curves_j, curves_t)
    _assert_tree_equal(final_j, final_t)


def _swim_state(cfg_t, rounds, seed):
    """A dense SWIM state after a few rounds with a third of the nodes
    dead, so timers, downs and refutations are all in flight."""
    st = tsw.init_state(cfg_t, device="cpu")
    dead = np.zeros(cfg_t.n_nodes, bool)
    dead[::3] = True
    st = st._replace(alive=torch.as_tensor(~dead))
    for r in range(rounds):
        st = tsw.swim_round(st, trng.fold_in(trng.PRNGKey(seed), r), torch.tensor(r), cfg_t)
    return st


@pytest.mark.parametrize("down_gc_rounds", [0, 3])
def test_dense_swim_round_and_churn(down_gc_rounds):
    n = 48
    cfg_j = jsw.SwimConfig(n_nodes=n, loss_prob=0.1, down_gc_rounds=down_gc_rounds)
    cfg_t = tsw.SwimConfig(n_nodes=n, loss_prob=0.1, down_gc_rounds=down_gc_rounds)
    assert tsw.impl(cfg_t) is tsw
    st_t = _swim_state(cfg_t, 6, seed=2)
    st_j = jsw.SwimState(**{k: jnp.asarray(v) for k, v in interop.to_numpy(st_t).items()})
    g = np.random.default_rng(down_gc_rounds)
    for r in range(6, 14):
        kill = g.random(n) < 0.1
        revive = ~np.asarray(st_j.alive) & (g.random(n) < 0.4)
        wipe = kill & (g.random(n) < 0.5)
        kj = jax.random.fold_in(jax.random.PRNGKey(9), r)
        kt = trng.fold_in(trng.PRNGKey(9), r)
        st_j = jsw.apply_churn(
            st_j, jnp.asarray(kill), jnp.asarray(revive), jax.random.fold_in(kj, 1),
            cfg_j.max_transmissions, wipe=jnp.asarray(wipe),
        )
        st_t = tsw.apply_churn(
            st_t, torch.as_tensor(kill), torch.as_tensor(revive), trng.fold_in(kt, 1),
            cfg_t.max_transmissions, wipe=torch.as_tensor(wipe),
        )
        _assert_tree_equal(st_j, st_t)
        pl = 0.3 if r % 2 else None
        st_j = jsw.swim_round(
            st_j, kj, jnp.int32(r), cfg_j,
            probe_loss=None if pl is None else jnp.float32(pl),
        )
        st_t = tsw.swim_round(
            st_t, kt, torch.tensor(r), cfg_t,
            probe_loss=None if pl is None else torch.tensor(pl, dtype=torch.float32),
        )
        _assert_tree_equal(st_j, st_t)
        assert int(jsw.mismatches(st_j)) == int(tsw.mismatches(st_t))
        hj, ht = jsw.health_counts(st_j), tsw.health_counts(st_t)
        assert [int(x) for x in hj] == [int(x) for x in ht]


def test_sparse_apply_churn():
    (cj, _, _), (ct, topo_t, _) = _both(
        "wan_100k", n=160, n_regions=4, n_writers=8, rounds=8, samples=8
    )
    g = np.random.default_rng(4)
    sched = te.Schedule(writes=g.integers(0, 2, (8, 8)).astype(np.uint32))
    st_t = te.simulate(ct, topo_t, sched.make_samples(8), seed=1, device="cpu")[0].swim
    dead = g.random(ct.n_nodes) < 0.3
    st_t = st_t._replace(alive=torch.as_tensor(~dead))
    st_j = jss.SparseSwimState(**{k: jnp.asarray(v) for k, v in interop.to_numpy(st_t).items()})
    kill = ~dead & (g.random(ct.n_nodes) < 0.1)
    revive = dead & (g.random(ct.n_nodes) < 0.5)
    for wipe in (None, kill & (g.random(ct.n_nodes) < 0.5)):
        for key in (None, 3):
            out_j = jss.apply_churn(
                st_j, jnp.asarray(kill), jnp.asarray(revive),
                None if key is None else jax.random.PRNGKey(key),
                cj.swim.max_transmissions,
                wipe=None if wipe is None else jnp.asarray(wipe),
            )
            out_t = tss.apply_churn(
                st_t, torch.as_tensor(kill), torch.as_tensor(revive),
                None if key is None else trng.PRNGKey(key),
                ct.swim.max_transmissions,
                wipe=None if wipe is None else torch.as_tensor(wipe),
            )
            _assert_tree_equal(out_j, out_t)
            assert int(jss.mismatches(out_j)) == int(tss.mismatches(out_t))


def test_argmin_takes_the_first_index_on_ties():
    # SWIM's timer-slot pick relies on it in both frameworks.
    x = np.random.default_rng(0).integers(0, 3, (64, 8))
    assert np.array_equal(
        np.asarray(jnp.argmin(jnp.asarray(x), axis=1)),
        torch.argmin(torch.as_tensor(x), dim=1).numpy(),
    )
    assert np.array_equal(np.argmin(x, axis=1), torch.argmin(torch.as_tensor(x), dim=1).numpy())

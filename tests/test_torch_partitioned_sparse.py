"""The partitioned any-node-writes engine (``parallel.simulate_sparse_sharded``:
every plane of the sparse round and of the epoch boundary per mesh
position, on state that stays in the positions' blocks) against the
port's unsharded run and the live JAX reference on the CPU:

- one case at n=96 (divisible by every mesh size), 4 epochs of 8 rounds,
  fewer hot slots than an epoch's writers (forced demotions), a region cut
  (laggards, so retired slots leave deviation entries that cold sync
  heals) and pause-resume churn, whose ``retired``, ``max_dev_entries``
  and ``cold_healed`` are all above 0;
- at D in {1, 2, 4, 8} and the (2, 2) WAN mesh, the partitioned run equals
  the unsharded port and the reference on every curve (the xshard keys
  held to ``traffic_model`` instead), every state leaf and ``info``, with
  no whole-state assembly and no controller-form broadcast during the run;
- the ``prop_observe`` variant partitioned on (2, 2) against its unsharded
  run;
- the structural check (``WholePlaneCheck``): at D=4 no operation inside a
  round or epoch body outputs a whole node plane, over a run that crosses
  a retiring epoch boundary;
- each position's state bytes, read after every round, equal
  ``mesh.predicted_per_device_bytes``;
- a run stopped after an epoch on D=2 and resumed on D=4 equals the
  uninterrupted run.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import sparse_engine as jse
from corrosion_tpu_torch import interop, parallel
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import epidemic as tepidemic
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.parallel import shard_driver as tdriver
from corrosion_tpu_torch.sim import sparse_engine as tse
from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

torch.set_num_threads(1)

N = 96
ROUNDS = 32
SEED = 2
MESHES = ((1,), (2,), (4,), (8,), (2, 2))
# 6 hot slots for 4 new writers an epoch: epoch 1 force-demotes epoch 0's
# writers while region 0 is cut off (rounds 8-16), so they retire with
# laggards; 48 samples, so no per-position extent equals N.
CASE = dict(n=N, w_hot=6, rounds=ROUNDS, n_regions=4, epoch_rounds=8, cohort=4,
            burst_writes=2, samples=48, k_dev=16, partition=True, demote_after=1)


def _mesh(dims):
    return tmesh.mesh_from_dims(dims, device="cpu")


def _churn(sched, n):
    """Six non-writer nodes flap: down from rounds 6-16, back 12 later."""
    rounds = sched.writes.shape[0]
    kill = np.zeros((rounds, n), bool)
    revive = np.zeros((rounds, n), bool)
    writers = set(np.nonzero(sched.writes.sum(axis=0))[0].tolist())
    flappers = [i for i in range(n) if i not in writers][:6]
    for j, node in enumerate(flappers):
        kill[6 + 2 * j, node] = True
        revive[18 + 2 * j, node] = True
    sched.kill, sched.revive = kill, revive
    return sched


def _build(mod, prop_observe=False, **kw):
    cfg, topo, sched = mod.anywrite_sparse(**CASE, **kw)
    if prop_observe:
        cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, prop_observe=True))
    return cfg, topo, _churn(sched, cfg.n_nodes)


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_tree_equal(ref, got, what, ref_is_jax=True):
    a = _flat(jax.device_get(ref)) if ref_is_jax else _flat(interop.to_numpy(ref))
    b = _flat(interop.to_numpy(got))
    assert a.keys() == b.keys(), what
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"{what}: state differs in {bad}"


def _assert_curves_equal(ref, got, what):
    assert set(ref) == set(got), what
    bad = [k for k in ref if k not in XSHARD_CURVE_KEYS
           and not (np.asarray(ref[k]).dtype == got[k].dtype
                    and np.array_equal(np.asarray(ref[k]), got[k]))]
    assert not bad, f"{what}: curves differ in {bad}"


def _info(out):
    return {k: v for k, v in out[4].items() if k != "resume"}


def _assert_run_equal(ref, got, what, ref_is_jax=True):
    """Curves, the sparse and swim states, vis_round and info."""
    _assert_curves_equal(ref[3], got[3], what)
    _assert_tree_equal(ref[0], got[0], f"{what} sstate", ref_is_jax)
    _assert_tree_equal(ref[1], got[1], f"{what} swim", ref_is_jax)
    vis_ref = np.asarray(ref[2]) if ref_is_jax else tmesh.to_host(ref[2]).numpy().astype(np.int32)
    assert np.array_equal(vis_ref, tmesh.to_host(got[2]).numpy().astype(np.int32)), what
    assert _info(ref) == _info(got), what


_RUNS: dict = {}


def _runs():
    """(port inputs, reference run, unsharded port run) of the case, made
    once a module with JAX's caches cleared around the reference's run."""
    if not _RUNS:
        jax.clear_caches()
        try:
            ref = jse.simulate_sparse(*_build(jb), seed=SEED)
        finally:
            jax.clear_caches()
        port = _build(tb, device="cpu")
        _RUNS["case"] = port, ref, tse.simulate_sparse(*port, seed=SEED, device="cpu")
    return _RUNS["case"]


@contextlib.contextmanager
def _no_controller():
    """Inside: any whole-state assembly or controller-form broadcast
    raises."""
    def refuse(*a, **k):
        raise AssertionError("the partitioned sparse run assembled or broadcast in the controller")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmesh, "assemble", refuse)
        mp.setattr(tdriver, "make_sharded_broadcast", refuse)
        yield


def test_unsharded_port_equals_the_reference_and_reaches_the_cold_plane():
    _, ref, mine = _runs()
    _assert_run_equal(ref, mine, "port vs reference")
    info, curves = mine[4], mine[3]
    # The case exercises what the partition has to carry: retirements with
    # laggards, deviation entries, cold healing, churn.
    assert info["retired"] > 0 and info["max_dev_entries"] > 0, info
    assert curves["cold_healed"].sum() > 0 and curves["mismatches"].max() > 0
    assert info["epochs"] == ROUNDS // CASE["epoch_rounds"]


@pytest.mark.parametrize("dims", MESHES, ids=["x".join(map(str, d)) for d in MESHES])
def test_partitioned_sparse_equals_unsharded_and_reference(dims):
    (cfg, topo, sched), ref, mine = _runs()
    mesh = _mesh(dims)
    info = {}
    with _no_controller():
        got = parallel.simulate_sparse_sharded(cfg, topo, sched, mesh, seed=SEED, info=info)
    what = f"sparse on {dims}"
    for tree in (got[0], got[1], got[2], got[4]["resume"]["sstate"]):
        leaves = tmesh.tree_leaves(tree)
        assert leaves and all(isinstance(x, tmesh.Placed) and x.mesh == mesh for x in leaves)
    _assert_run_equal(mine, got, f"{what} vs port unsharded", ref_is_jax=False)
    _assert_run_equal(ref, got, f"{what} vs reference")
    ok, problems = tepidemic.xshard_model_check(got[3], cfg.gossip, mesh)
    assert ok, problems
    # Every position's bytes after every round are the placement's.
    tree = (got[0], got[1], got[2])
    predicted = tmesh.predicted_per_device_bytes(tree, tdriver.sparse_specs(tree, mesh), mesh)
    assert len(info["state_bytes"]) == ROUNDS
    assert all(row == [predicted] * mesh.size for row in info["state_bytes"]), what
    assert parallel.per_device_state_bytes(tree) == dict.fromkeys(range(mesh.size), predicted)
    if mesh.size > 1:
        by_tag = info["exchange_bytes_by_tag"]
        # The epoch bodies' exchanges and the cold plane's gather ran.
        assert {"reduce:demote", "reduce:rotate", "gather:head_full", "reduce:cold",
                "queue:broadcast", "gather:alive"} <= set(by_tag), sorted(by_tag)


def test_prop_observe_partitioned_equals_unsharded():
    """The propagation counters partitioned (their unsharded run is held to
    the reference in ``test_torch_prop``)."""
    cfg, topo, sched = _build(tb, prop_observe=True, device="cpu")
    mine = tse.simulate_sparse(cfg, topo, sched, seed=SEED, device="cpu")
    assert mine[3]["prop_useful_msgs"].sum() > 0 and mine[3]["prop_dup_msgs"].sum() > 0
    with _no_controller():
        got = parallel.simulate_sparse_sharded(cfg, topo, sched, _mesh((2, 2)), seed=SEED)
    _assert_run_equal(mine, got, "prop_observe on (2, 2) vs port unsharded", ref_is_jax=False)


def test_no_whole_node_plane_inside_the_sparse_bodies():
    (cfg, topo, sched), _, mine = _runs()
    mesh = _mesh((4,))
    check = tdriver.WholePlaneCheck(N, N // 4, n_cells=cfg.gossip.n_cells)
    # Epochs 0 and 1: the boundary into epoch 1 retires slots with laggards.
    got = parallel.simulate_sparse_sharded(cfg, topo, sched, mesh, seed=SEED, watch=check,
                                           stop_after_epoch=1)
    assert got[4]["retired"] > 0 and got[4]["max_dev_entries"] > 0, _info(got)
    assert check.ops > 1000
    assert check.found == [], f"whole planes inside the bodies: {check.found[:8]}"
    # The hook watches only: the run is the unsharded one's first epochs.
    rounds = 2 * CASE["epoch_rounds"]
    _assert_curves_equal({k: v[:rounds] for k, v in mine[3].items()}, got[3], "watched")


def test_resume_on_another_mesh_equals_the_uninterrupted_run():
    (cfg, topo, sched), _, mine = _runs()
    first = parallel.simulate_sparse_sharded(cfg, topo, sched, _mesh((2,)), seed=SEED,
                                             stop_after_epoch=1)
    resume = first[4]["resume"]
    assert resume["next_epoch"] == 2
    rest = parallel.simulate_sparse_sharded(cfg, topo, sched, _mesh((4,)), seed=SEED,
                                            resume=resume)
    joined = {k: np.concatenate([first[3][k], rest[3][k]]) for k in first[3]}
    _assert_curves_equal(mine[3], joined, "resumed on D=4")
    for i, what in enumerate(("sstate", "swim")):
        _assert_tree_equal(mine[i], rest[i], f"resumed on D=4 {what}", ref_is_jax=False)
    assert torch.equal(mine[2], tmesh.to_host(rest[2]))
    assert rest[4]["epochs"] == ROUNDS // CASE["epoch_rounds"] - 2

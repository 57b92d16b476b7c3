"""The partitioned chunk and mixed engines (``parallel.simulate_chunks_sharded``
and ``parallel.simulate_mixed_sharded``: every plane of the round per mesh
position, on state that stays in the positions' blocks) against the
port's unsharded runs and the live JAX reference on the CPU:

- the chunk case: ``anti_entropy_chunks`` at n=64 with 3 streams (192
  (node, stream) rows, so no per-position extent equals N or N * S) under
  a fault plan with loss, kill/revive churn and a crash-with-state-wipe;
- the mixed case: ``mixed_storm`` at n=64 (the suite's ``MIXED`` shape)
  under churn with a wipe and receiver loss, 24 rounds in which the big
  versions commit, reassemble, are admitted (cell merges) and cross by
  sync (coverage back-filled); and without churn on the (2, 2) mesh;
- at D in {1, 2, 4, 8} and the (2, 2) WAN mesh, each partitioned run
  equals the unsharded port and the reference on every curve (the mixed
  xshard keys held to ``traffic_model`` instead), every state leaf, the
  chunk plane's ``vis``, ``applied_frac`` and p50/p99, with no whole-state
  assembly and no controller-form broadcast during the run, and each
  position's state bytes after every round equal to
  ``mesh.predicted_per_device_bytes``;
- the structural check (``WholePlaneCheck`` with the row extent N * S):
  at D=4 no operation inside a round body of either engine outputs a whole
  node or (node, stream) plane over a whole run (the mixed round under
  churn at n=96 with 3 streams, where no other per-position extent is N or
  N * S);
- a run of each engine stopped on D=2 and resumed on D=4 equals the
  uninterrupted run.

Tolerance: exact everywhere.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import chunk_engine as jce
from corrosion_tpu.sim import faults as jfaults
from corrosion_tpu.sim import mixed_engine as jme
from corrosion_tpu_torch import interop, parallel
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import epidemic as tepidemic
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.parallel import shard_driver as tdriver
from corrosion_tpu_torch.sim import chunk_engine as tce
from corrosion_tpu_torch.sim import faults as tfaults
from corrosion_tpu_torch.sim import mixed_engine as tme
from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

torch.set_num_threads(1)

N = 64
MESHES = ((1,), (2,), (4,), (8,), (2, 2))
IDS = ["x".join(map(str, d)) for d in MESHES]
CHUNK = dict(n=N, streams=3, last_seq=1023, rounds=0)
CHUNK_ROUNDS = 24
CHUNK_SEED = 3
MIXED = dict(n=N, streams=2, last_seq=63, rounds=24, samples=16, n_cells=64)
CHECK_MIXED = dict(n=96, streams=3)


def _mesh(dims):
    return tmesh.mesh_from_dims(dims, device="cpu")


def _chunk_plan(mod, origin):
    """Loss, a wipe that spares the origins and revives, a node that stays
    down."""
    spared = set(np.asarray(origin).tolist())
    victims = tuple(x for x in range(5, 40) if x not in spared)[:5]
    return mod.FaultPlan(CHUNK_ROUNDS, (
        mod.Fault("loss", 4, 16, prob=0.3),
        mod.Fault("churn", 6, 7, nodes=victims, revive_at=14, wipe=True),
        mod.Fault("churn", 8, 9, nodes=(victims[-1] + 1,)),
    ))


def _mixed(mod, faults_mod, churn: bool, **kw):
    """``mixed_storm`` at ``MIXED``; under ``churn`` a kill/revive/wipe
    schedule that spares the streams' origin nodes (0 and 1) with receiver
    loss on region 0."""
    cfg, ccfg, topo, sched, spec = mod.mixed_storm(**dict(MIXED, **kw))
    if churn:
        plan = faults_mod.FaultPlan(sched.rounds, (
            faults_mod.Fault("churn", 6, 7, nodes=(5, 6, 20), revive_at=14, wipe=True),
            faults_mod.Fault("churn", 4, 5, nodes=(40,)),
            faults_mod.Fault("loss", 3, 11, prob=0.5, regions=(0,)),
        ))
        sched = faults_mod.apply_plan(sched, plan, cfg.n_nodes, 4)
    return cfg, ccfg, topo, sched, spec


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, (tuple, list)):
        tree = {str(i): v for i, v in enumerate(tree)}
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


def _assert_curves_equal(ref, got, what, skip=XSHARD_CURVE_KEYS):
    assert set(ref) == set(got), what
    bad = [k for k in ref if k not in skip
           and not (np.asarray(ref[k]).dtype == got[k].dtype
                    and np.array_equal(np.asarray(ref[k]), got[k]))]
    assert not bad, f"{what}: curves differ in {bad}"


def _assert_chunk_run_equal(ref, got, what, ref_is_jax=True):
    """The coverage state, ``vis``, the metrics and every curve."""
    (rs, rm), (gs, gm) = ref, got
    _assert_tree_equal(rs, gs, f"{what} state", ref_is_jax)
    vis = np.asarray(rm["vis"]) if ref_is_jax else interop.to_numpy(rm["vis"])
    assert np.array_equal(vis, interop.to_numpy(gm["vis"])), what
    for k in ("applied_frac", "unapplied", "p50_s", "p99_s", "seqs_granted", "chunks_sent"):
        assert rm[k] == gm[k], (what, k)
    _assert_curves_equal(rm["curves"], gm["curves"], what, skip=())


@contextlib.contextmanager
def _no_controller():
    """Inside: any whole-state assembly or controller-form broadcast
    raises."""
    def refuse(*a, **k):
        raise AssertionError("the partitioned run assembled or broadcast in the controller")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmesh, "assemble", refuse)
        mp.setattr(tdriver, "make_sharded_broadcast", refuse)
        yield


def _assert_bytes(info, tree, specs, mesh, rounds, what):
    """Every position's state bytes after every round are the placement's;
    the placed result holds the same."""
    predicted = tmesh.predicted_per_device_bytes(tree, specs, mesh)
    assert len(info["state_bytes"]) == rounds, what
    assert all(row == [predicted] * mesh.size for row in info["state_bytes"]), what
    assert parallel.per_device_state_bytes(tree) == dict.fromkeys(range(mesh.size), predicted)


def _assert_placed(tree, mesh):
    leaves = tmesh.tree_leaves(tree)
    assert leaves and all(isinstance(x, tmesh.Placed) and x.mesh == mesh for x in leaves)


# ---- the chunk engine --------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_runs():
    """(port inputs, reference run, unsharded port run), made once."""
    jcfg, jorigin, jlast, _ = jb.anti_entropy_chunks(**CHUNK)
    ref = jce.simulate_chunks(jcfg, jorigin, jlast, CHUNK_ROUNDS, seed=CHUNK_SEED,
                              faults=_chunk_plan(jfaults, jorigin))
    cfg, origin, last, _ = tb.anti_entropy_chunks(**CHUNK, device="cpu")
    plan = _chunk_plan(tfaults, origin)
    mine = tce.simulate_chunks(cfg, origin, last, CHUNK_ROUNDS, seed=CHUNK_SEED, faults=plan,
                               device="cpu")
    return (cfg, origin, last, plan), ref, mine


def _chunk_sharded(inputs, mesh, **kw):
    cfg, origin, last, plan = inputs
    return parallel.simulate_chunks_sharded(cfg, origin, last, CHUNK_ROUNDS, mesh,
                                            seed=CHUNK_SEED, faults=plan, **kw)


def test_unsharded_chunks_equal_the_reference_under_faults(chunk_runs):
    _, ref, mine = chunk_runs
    _assert_chunk_run_equal(ref, mine, "chunk port vs reference")
    curves = mine[1]["curves"]
    # The case exercises what the partition carries: loss, a wipe, sync.
    assert curves["chaos_lost_msgs"].sum() > 0 and curves["chaos_wiped"].sum() > 0
    assert curves["seqs_granted"].sum() > 0 and 0 < mine[1]["applied_frac"] < 1


@pytest.mark.parametrize("dims", MESHES, ids=IDS)
def test_partitioned_chunks_equal_unsharded_and_reference(chunk_runs, dims):
    inputs, ref, mine = chunk_runs
    mesh = _mesh(dims)
    info = {}
    with _no_controller():
        got = _chunk_sharded(inputs, mesh, info=info)
    what = f"chunk on {dims}"
    _assert_placed(got[0], mesh)
    _assert_placed(got[1]["vis"], mesh)
    _assert_chunk_run_equal(mine, got, f"{what} vs port unsharded", ref_is_jax=False)
    _assert_chunk_run_equal(ref, got, f"{what} vs reference")
    assert float(got[1]["curves"]["xshard_bytes_ici"].sum()) == 0.0  # no queue to exchange
    tree = (got[0], got[1]["vis"])
    _assert_bytes(info, tree, tdriver.chunk_specs(tree, mesh), mesh, CHUNK_ROUNDS, what)
    if mesh.size > 1:
        assert set(info["exchange_bytes_by_tag"]) == {
            "route:chunks", "rows:chunk_sync", "reduce:chunks"}, info["exchange_bytes_by_tag"]


# ---- the mixed engine --------------------------------------------------------


def _admission_spy(monkeypatch):
    """Counts of the admission's cell merges and of the sync crossings'
    back-filled (node, stream) pairs, over every call."""
    seen = {"merges": 0, "crossed": 0}
    admit, backfill = tme._admit_big, tme._backfill_coverage

    def counted_admit(*a, **k):
        data, merges = yield from admit(*a, **k)
        seen["merges"] += int(merges)
        return data, merges

    def counted_backfill(chunks, crossed, *a, **k):
        seen["crossed"] += int(crossed.sum())
        return backfill(chunks, crossed, *a, **k)

    monkeypatch.setattr(tme, "_admit_big", counted_admit)
    monkeypatch.setattr(tme, "_backfill_coverage", counted_backfill)
    return seen


@pytest.fixture(scope="module")
def mixed_runs():
    """Per variant (churn, quiet): (port inputs, reference run, unsharded
    port run, the unsharded run's admission and crossing counts)."""
    out = {}
    for name, churn in (("churn", True), ("quiet", False)):
        ref = jme.simulate_mixed(*_mixed(jb, jfaults, churn), seed=0)
        inputs = _mixed(tb, tfaults, churn, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            seen = _admission_spy(mp)
            mine = tme.simulate_mixed(*inputs, seed=0, device="cpu")
        out[name] = inputs, ref, mine, seen
    return out


def test_unsharded_mixed_equals_the_reference_and_reaches_every_step(mixed_runs):
    for name, (_, ref, mine, seen) in mixed_runs.items():
        _assert_tree_equal(ref[0], mine[0], f"mixed {name} port vs reference")
        _assert_curves_equal(ref[1], mine[1], f"mixed {name} port vs reference", skip=())
        # Streams commit, reassemble, are admitted and cross by sync.
        assert mine[1]["streams_applied"].max() > 0 and mine[1]["chunks_sent"].sum() > 0
        assert seen["merges"] > 0 and seen["crossed"] > 0, (name, seen)
    curves = mixed_runs["churn"][2][1]
    assert curves["chaos_wiped"].sum() > 0 and curves["chaos_lost_msgs"].sum() > 0


def _check_mixed(mixed_runs, name, dims, watch=None):
    inputs, ref, mine, _ = mixed_runs[name]
    mesh = _mesh(dims)
    info = {}
    with _no_controller():
        final, curves = parallel.simulate_mixed_sharded(*inputs, mesh, seed=0, info=info,
                                                        watch=watch)
    what = f"mixed {name} on {dims}"
    _assert_placed(final, mesh)
    _assert_tree_equal(mine[0], final, f"{what} vs port unsharded", ref_is_jax=False)
    _assert_tree_equal(ref[0], final, f"{what} vs reference")
    _assert_curves_equal(mine[1], curves, f"{what} vs port unsharded")
    _assert_curves_equal(ref[1], curves, f"{what} vs reference")
    ok, problems = tepidemic.xshard_model_check(curves, inputs[0].gossip, mesh)
    assert ok, problems
    _assert_bytes(info, final, tmesh.mixed_state_specs(final, mesh), mesh, MIXED["rounds"], what)
    if mesh.size > 1:
        assert {"route:chunks", "rows:chunk_sync", "reduce:admit", "reduce:health",
                "queue:broadcast", "rows:sync"} <= set(info["exchange_bytes_by_tag"])
    return curves


@pytest.mark.parametrize("dims", MESHES, ids=IDS)
def test_partitioned_mixed_under_churn_equals_unsharded_and_reference(mixed_runs, dims):
    _check_mixed(mixed_runs, "churn", dims)


def test_partitioned_mixed_without_churn_equals_unsharded_and_reference(mixed_runs):
    _check_mixed(mixed_runs, "quiet", (2, 2))


def test_no_whole_plane_inside_the_chunk_and_mixed_bodies(chunk_runs):
    inputs, _, mine = chunk_runs
    cfg = inputs[0]
    check = tdriver.WholePlaneCheck(N, N // 4, n_streams=cfg.n_streams)
    got = _chunk_sharded(inputs, _mesh((4,)), watch=check)
    assert check.ops > 1000
    assert check.found == [], f"chunk: whole planes inside the bodies: {check.found[:8]}"
    # The hook watches only: the run is the unsharded one.
    _assert_chunk_run_equal(mine, got, "chunk watched", ref_is_jax=False)
    # The mixed round at n=96 with 3 streams: at n=64 its 64 writers and
    # its [n_local, 8] SWIM tables would give per-position extents of N
    # and N * S.
    inputs = _mixed(tb, tfaults, True, **CHECK_MIXED, device="cpu")
    n, n_streams = inputs[0].n_nodes, inputs[1].n_streams
    final, curves = tme.simulate_mixed(*inputs, seed=0, device="cpu")
    check = tdriver.WholePlaneCheck(n, n // 4, n_cells=inputs[0].gossip.n_cells,
                                    n_streams=n_streams)
    got = parallel.simulate_mixed_sharded(*inputs, _mesh((4,)), seed=0, watch=check)
    assert check.ops > 1000
    assert check.found == [], f"mixed: whole planes inside the bodies: {check.found[:8]}"
    _assert_tree_equal(final, got[0], "mixed watched", ref_is_jax=False)
    _assert_curves_equal(curves, got[1], "mixed watched")


def test_resume_on_another_mesh_equals_the_uninterrupted_run(chunk_runs, mixed_runs):
    # The chunk engine (no faults: a fault plan's tail loses who is down):
    # rounds [0, 12) on D=2, then [12, 24) on D=4.
    (cfg, origin, last, _), _, _ = chunk_runs
    whole, wm = tce.simulate_chunks(cfg, origin, last, CHUNK_ROUNDS, seed=CHUNK_SEED,
                                    device="cpu")
    half = CHUNK_ROUNDS // 2
    s1, m1 = parallel.simulate_chunks_sharded(cfg, origin, last, half, _mesh((2,)),
                                              seed=CHUNK_SEED)
    s2, m2 = parallel.simulate_chunks_sharded(cfg, origin, last, CHUNK_ROUNDS - half,
                                              _mesh((4,)), seed=CHUNK_SEED, state=s1,
                                              vis=m1["vis"], start_round=half)
    _assert_tree_equal(whole, s2, "chunk resumed on D=4", ref_is_jax=False)
    assert torch.equal(wm["vis"], tmesh.to_host(m2["vis"]))
    joined = {k: np.concatenate([m1["curves"][k], m2["curves"][k]]) for k in m1["curves"]}
    _assert_curves_equal(wm["curves"], joined, "chunk resumed on D=4", skip=())
    # The mixed engine under churn: its carried round anchors the tail.
    inputs, _, (final, curves), _ = mixed_runs["churn"]
    cfg, ccfg, topo, sched, spec = inputs
    half = sched.rounds // 2
    mid, c1 = parallel.simulate_mixed_sharded(cfg, ccfg, topo, sched.slice(0, half), spec,
                                              _mesh((2,)), seed=0)
    end, c2 = parallel.simulate_mixed_sharded(cfg, ccfg, topo, sched.slice(half, sched.rounds),
                                              spec, _mesh((4,)), seed=0, state=mid)
    _assert_tree_equal(final, end, "mixed resumed on D=4", ref_is_jax=False)
    _assert_curves_equal(curves, {k: np.concatenate([c1[k], c2[k]]) for k in c1},
                         "mixed resumed on D=4")

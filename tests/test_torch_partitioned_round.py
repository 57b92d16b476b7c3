"""The partitioned dense round (``parallel.simulate_sharded``: every plane
per mesh position, on state that stays in the positions' blocks) against
the port's unsharded run and the live JAX reference on the CPU:

- sub-box draws (``rng``'s ``rows``/``axis``) equal the full draw sliced
  and ``jax.random`` on the same key, on row ranges of either axis, index
  rows, and empty and full boxes;
- at D in {1, 2, 4, 8} and the (2, 2) WAN mesh, the partitioned run
  equals the unsharded port and the reference on every curve (the xshard
  keys held to ``traffic_model`` instead) and every state leaf, in three
  configurations at n=96 that together cover sparse and dense SWIM (the
  down-member GC's draw included), churn with wipe and revive, the pull
  escalation and the adaptive plane, the window under loss, the probe
  loss axis, and all three sync scorings: the total-progress digest of
  the full-size path and the bucketed sketch (both forced at this size
  with ``_EXACT_SCORE_MAX = 0``) and the exact deficit;
- the legacy delivery, forced as ``test_torch_shard_driver`` forces it,
  partitioned at D=2;
- the structural check (``WholePlaneCheck``): at D=4 no operation inside
  a position body outputs a whole node plane;
- each position's state bytes, read after every round, equal
  ``mesh.predicted_per_device_bytes``, and the control-vector gather's
  bytes equal ``traffic_model``'s ``alive_gather_bytes`` a round.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu import models as jmodels
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu.sim import engine as jengine
from corrosion_tpu_torch import interop, parallel
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import epidemic as tepidemic
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.parallel import shard_driver as tdriver
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import health as thealth
from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

torch.set_num_threads(1)

N = 96
ROUNDS = 12
MESHES = ((1,), (2,), (4,), (8,), (2, 2))
CHECK_ROUNDS = 7  # the structural check's rounds: kills, wipes and revivals
BASE = dict(n=N, n_regions=4, n_writers=16, rounds=ROUNDS, samples=16, partition=False)


def _mesh(dims):
    return tmesh.mesh_from_dims(dims, device="cpu")


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


def _assert_state_equal(ref_tree, port_tree, what, ref_is_jax=True):
    a = _flat(jax.device_get(ref_tree)) if ref_is_jax else _flat(interop.to_numpy(ref_tree))
    b = _flat(interop.to_numpy(port_tree))
    assert a.keys() == b.keys(), what
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"{what}: state differs in {bad}"


def _assert_curves_equal(ref, got, what):
    assert set(ref) == set(got), what
    bad = [
        k for k in ref if k not in XSHARD_CURVE_KEYS
        and not (np.asarray(ref[k]).dtype == got[k].dtype
                 and np.array_equal(np.asarray(ref[k]), got[k]))
    ]
    assert not bad, f"{what}: curves differ in {bad}"


# ---- sub-box draws -----------------------------------------------------------


def _np(x):
    return np.asarray(x).astype(np.int64)


BOXES = [
    ((96, 3), (0, 96), 0),  # full box
    ((96, 3), (24, 48), 0),  # a position's rows
    ((96, 3), (40, 40), 0),  # empty box
    ((4, 96), (72, 96), 1),  # SWIM probe tries: columns
    ((4, 96), (0, 0), 1),
    ((16, 4, 5), (1, 3), 1),  # the middle axis of a 3-D shape
    ((16, 4), [5, 0, 15, 7], 0),  # sync cohort entries: index rows
]
# Spans of the engine's draws: near-source offsets, and node counts below
# and past 2^16, where the reference's u32 multiplier wraps.
SPANS = ((0, 1 << 30), (3, 1 << 30), (0, 96), (0, 100_000))


@pytest.mark.parametrize("seed", (0, 2**31 - 1))
@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("shape,rows,axis", BOXES)
def test_sub_box_draws_equal_the_full_draw_sliced_and_jax(seed, lo, hi, shape, rows, axis):
    kj, kt = jax.random.fold_in(jax.random.PRNGKey(seed), 5), trng.fold_in(trng.PRNGKey(seed), 5)
    if isinstance(rows, list):
        idx = torch.tensor(rows, dtype=torch.int64)
        sl = [slice(None)] * len(shape)
        sl[axis] = rows
        rows_arg = idx
    else:
        sl = [slice(None)] * len(shape)
        sl[axis] = slice(*rows)
        rows_arg = rows
    sl = tuple(sl)
    draws = {
        "randint": (lambda **kw: trng.randint(kt, shape, lo, hi, **kw),
                    jax.random.randint(kj, shape, lo, hi)),
        "uniform": (lambda **kw: trng.uniform(kt, shape, **kw),
                    jax.random.uniform(kj, shape)),
        "random_bits": (lambda **kw: trng.random_bits(kt, shape, **kw),
                        jax.random.bits(kj, shape, dtype=np.uint32)),
    }
    for name, (port, ref) in draws.items():
        box = port(rows=rows_arg, axis=axis)
        full = port()
        assert torch.equal(box, full[sl]), name
        ref = np.asarray(ref)
        if name == "uniform":
            assert np.array_equal(box.numpy().view(np.uint32), ref[sl].view(np.uint32)), name
        else:
            assert np.array_equal(box.numpy(), _np(ref[sl])), name


# ---- the partitioned round -----------------------------------------------------


def _churn(sched, n, rounds):
    """Kills at rounds 2-4, revivals at 5-7, a third of the kills wiped."""
    rng = np.random.default_rng(11)
    kill = np.zeros((rounds, n), bool)
    revive = np.zeros((rounds, n), bool)
    wipe = np.zeros((rounds, n), bool)
    nodes = rng.choice(n, size=12, replace=False)
    for i, node in enumerate(nodes):
        kill[2 + i % 3, node] = True
        revive[5 + i % 3, node] = True
        wipe[2 + i % 3, node] = i % 3 == 0
    sched.kill, sched.revive, sched.wipe = kill, revive, wipe
    sched.probe_loss = np.full(rounds, 0.1, np.float32)
    return sched


# The three configurations: (swim overrides, gossip overrides, force the
# inexact scoring, force the legacy delivery).
CONFIGS = {
    # wan_100k's main path: sparse SWIM, the digest scoring, loss under the
    # window, the pull escalation.
    "sparse_digest": ({}, dict(loss_prob=0.2, pull_switch_age=2), True, False),
    # Dense SWIM with its GC, the adaptive plane (rumor kill feedback, the
    # escalation, age-targeted intake, the propagation counters), exact
    # scoring.
    "dense_adaptive": (dict(view_capacity=0, down_gc_rounds=4),
                       dict(loss_prob=0.2, prop_observe=True, **thealth.ADAPTIVE_GOSSIP),
                       False, False),
    # The legacy delivery at D=2 with dense SWIM and the bucketed sketch.
    "legacy_sketch": (dict(view_capacity=0), dict(loss_prob=0.2, sync_sketch_buckets=4),
                      True, True),
}


def _build(name):
    swim_kw, gossip_kw, _, _ = CONFIGS[name]
    runs = []
    for build in (jmodels.wan_100k, lambda **k: tb.wan_100k(device="cpu", **k)):
        cfg, topo, sched = build(**BASE)
        sched.writes[:, :] = 0
        sched.writes[:10, :] = 2
        cfg = dataclasses.replace(
            cfg, swim=dataclasses.replace(cfg.swim, **swim_kw),
            gossip=dataclasses.replace(cfg.gossip, **gossip_kw),
        )
        runs.append((cfg, topo, _churn(sched.make_samples(16), N, ROUNDS)))
    return runs


_FLAGS = ((jg, "_EXACT_SCORE_MAX"), (tg, "_EXACT_SCORE_MAX"), (jg, "_FAST_MAX_WRITERS"),
          (jg, "_BLOCK_ENUM_MIN_WRITERS"), (tg, "_FAST_MAX_WRITERS"))
_RUNS: dict = {}  # configuration -> (port inputs, reference run, unsharded port run)


@contextlib.contextmanager
def _forced(name):
    """The configuration's forced paths, in both packages."""
    _, _, inexact, legacy = CONFIGS[name]
    saved = [getattr(m, a) for m, a in _FLAGS]
    if inexact:
        jg._EXACT_SCORE_MAX = tg._EXACT_SCORE_MAX = 0
    if legacy:
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        yield
    finally:
        for (m, a), v in zip(_FLAGS, saved):
            setattr(m, a, v)


@pytest.fixture
def config(request):
    """One configuration's reference run and unsharded port run (made once
    a module, JAX's caches cleared around it), with its forced paths in
    force while the test runs."""
    name = request.param
    with _forced(name):
        if name not in _RUNS:
            jax.clear_caches()
            try:
                (jcfg, jtopo, jsched), port = _build(name)
                ref = jengine.simulate(jcfg, jtopo, jsched, seed=3)
                _RUNS[name] = port, ref, tengine.simulate(*port, seed=3, device="cpu")
            finally:
                jax.clear_caches()
        yield (name,) + _RUNS[name]


@pytest.mark.parametrize("config", sorted(CONFIGS), indirect=True)
def test_unsharded_port_equals_the_reference(config):
    name, _, (jfinal, jcurves), (tfinal, tcurves) = config
    _assert_state_equal(jfinal, tfinal, f"{name}: port vs reference")
    _assert_curves_equal(jcurves, tcurves, f"{name}: port vs reference")
    # The configuration reaches what it is meant to cover.
    assert float(tcurves["chaos_wiped"].sum()) > 0
    assert float(tcurves["chaos_lost_msgs"].sum()) > 0


# Sparse and dense SWIM on every mesh; the legacy delivery at D=2.
CASES = [(name, dims) for name in ("dense_adaptive", "sparse_digest") for dims in MESHES]
CASES.append(("legacy_sketch", (2,)))


@pytest.mark.parametrize("config,dims", CASES, indirect=["config"],
                         ids=[f"{c}-{'x'.join(map(str, d))}" for c, d in CASES])
def test_partitioned_round_equals_unsharded_and_reference(config, dims):
    name, (tcfg, ttopo, tsched), (jfinal, jcurves), (tfinal, tcurves) = config
    mesh = _mesh(dims)
    info = {}
    final, curves = parallel.simulate_sharded(tcfg, ttopo, tsched, mesh, seed=3, info=info,
                                              max_chunk=5)
    what = f"{name} on {dims}"
    leaves = tmesh.tree_leaves(final)
    assert leaves and all(isinstance(x, tmesh.Placed) and x.mesh == mesh for x in leaves)
    _assert_state_equal(tfinal, final, f"{what} vs port unsharded", ref_is_jax=False)
    _assert_state_equal(jfinal, final, f"{what} vs reference")
    _assert_curves_equal(tcurves, curves, f"{what} vs port unsharded")
    _assert_curves_equal(jcurves, curves, f"{what} vs reference")
    ok, problems = tepidemic.xshard_model_check(curves, tcfg.gossip, mesh)
    assert ok, problems
    # Every position's bytes after every round are the placement's.
    predicted = tmesh.predicted_per_device_bytes(
        final, tmesh.cluster_state_specs(final, mesh), mesh
    )
    assert len(info["state_bytes"]) == tsched.rounds
    assert all(row == [predicted] * mesh.size for row in info["state_bytes"]), what
    assert parallel.per_device_state_bytes(final) == dict.fromkeys(range(mesh.size), predicted)
    # The alive gather moves what the reference's model says, a round.
    alive = parallel.traffic_model(tcfg.gossip, mesh)["detail"].get("alive_gather_bytes", 0.0)
    assert info["exchange_bytes_by_tag"].get("gather:alive", 0.0) == alive * tsched.rounds
    if mesh.size > 1:
        assert {"reduce", "gather", "rows", "queue"} <= set(info["exchange_bytes"])


@pytest.mark.parametrize("config", sorted(CONFIGS), indirect=True)
def test_no_whole_node_plane_inside_a_position_body(config):
    name, (tcfg, ttopo, tsched), _, (tfinal, tcurves) = config
    mesh = _mesh((4,))
    check = tdriver.WholePlaneCheck(N, N // 4, n_cells=tcfg.gossip.n_cells)
    final, curves = parallel.simulate_sharded(
        tcfg, ttopo, tsched.slice(0, CHECK_ROUNDS), mesh, seed=3, watch=check
    )
    assert check.ops > 1000
    assert check.found == [], f"{name}: whole planes inside the bodies: {check.found[:8]}"
    # The hook watches only: the run is the unsharded one's first rounds.
    _assert_curves_equal({k: v[:CHECK_ROUNDS] for k, v in tcurves.items()}, curves,
                         f"{name} watched")


def test_the_check_sees_a_whole_plane():
    """The structural check fires on the plane a controller would build."""
    check = tdriver.WholePlaneCheck(96, 24, n_cells=4)
    with check:
        torch.zeros((96, 16), dtype=torch.int64)
        torch.zeros((16, 96), dtype=torch.int64)  # an [S, N] visibility plane
        torch.zeros((96 * 4,), dtype=torch.int64)  # the flat cell plane
        torch.zeros((24, 96), dtype=torch.int64)  # a dense view block: allowed
        torch.zeros((96,), dtype=torch.bool)  # a control vector: allowed
        torch.zeros((1, 96), dtype=torch.bool)
    assert [shape for _, shape in check.found] == [(96, 16), (16, 96), (384,)]
    # With the chunk plane's streams: a whole [N * S, C] coverage plane or
    # flat (node, stream) row vector, and an [N, S] plane.
    check = tdriver.WholePlaneCheck(96, 24, n_streams=3)
    with check:
        torch.zeros((288, 16), dtype=torch.int64)
        torch.zeros((288,), dtype=torch.bool)
        torch.zeros((96, 3), dtype=torch.int64)
        torch.zeros((72, 16), dtype=torch.int64)  # a position's coverage block: allowed
        torch.zeros((24, 48), dtype=torch.int64)  # its rows as [n_local, S * C]: allowed
    assert [shape for _, shape in check.found] == [(288, 16), (288,), (96, 3)]

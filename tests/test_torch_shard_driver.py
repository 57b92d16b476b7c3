"""The port's explicit shard driver (``corrosion_tpu_torch/parallel/
shard_driver.py``) against the live JAX reference on the CPU, at n=64:

- ``traffic_model`` equals the reference's, dict for dict, on every mesh,
  with and without writer-id tracking and the propagation plane;
- the dense, sparse, chunk and mixed sharded runs at D in {1, 2, 4, 8}
  equal the port's unsharded run and the reference's unsharded run on
  every curve (the xshard keys held to ``traffic_model`` instead) and
  every state leaf, and come back placed per position;
- the dense run at D=4 equals the reference's own ``simulate_sharded`` on
  its 2x2 mesh, the xshard curves included (the reference's sharded entry
  compiles for ~40 s, so it runs at this one mesh);
- the legacy delivery, forced at small size in both packages
  (``_FAST_MAX_WRITERS = 0``, and ``_BLOCK_ENUM_MIN_WRITERS = 1`` in the
  reference, JAX's caches cleared around it), sharded at D=2;
- the rumor kill's sender feedback, the one cross-shard reduction it adds
  (the reference's ``test_kill_feedback_shard_invariant``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu import models as jmodels
from corrosion_tpu import parallel as jparallel
from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu.sim import benchlib
from corrosion_tpu.sim import chunk_engine as jchunk
from corrosion_tpu.sim import engine as jengine
from corrosion_tpu.sim import health as jhealth
from corrosion_tpu.sim import mixed_engine as jmixed
from corrosion_tpu.sim import sparse_engine as jsparse
from corrosion_tpu_torch import interop, parallel
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import epidemic as tepidemic
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.sim import chunk_engine as tchunk
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import health as thealth
from corrosion_tpu_torch.sim import mixed_engine as tmixed
from corrosion_tpu_torch.sim import sparse_engine as tsparse
from corrosion_tpu_torch.sim.telemetry import PROP_CURVE_KEYS, XSHARD_CURVE_KEYS

torch.set_num_threads(1)

DEVICE_COUNTS = (1, 2, 4, 8)
DENSE = dict(n=64, n_regions=4, n_writers=16, rounds=24, samples=16, partition=False)
SPARSE = dict(n=64, w_hot=8, rounds=16, n_regions=4, epoch_rounds=8, cohort=10,
              burst_writes=2, samples=16, k_dev=8)
MIXED = dict(n=64, streams=2, last_seq=63, rounds=48, samples=16, n_cells=64)


def _tmesh(d):
    return tmesh.multichip_mesh(d, device="cpu")


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


def _assert_state_equal(jax_tree, port_tree, what):
    a, b = _flat(jax.device_get(jax_tree)), _flat(interop.to_numpy(port_tree))
    assert a.keys() == b.keys(), what
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"{what}: state differs in {bad}"


def _assert_curves_equal(ref, got, what, skip=XSHARD_CURVE_KEYS):
    assert set(ref) == set(got), what
    bad = [
        k for k in ref if k not in skip
        and not (np.asarray(ref[k]).dtype == got[k].dtype and np.array_equal(np.asarray(ref[k]), got[k]))
    ]
    assert not bad, f"{what}: curves differ in {bad}"


def _assert_model(curves, cfg_gossip, mesh):
    ok, problems = tepidemic.xshard_model_check(curves, cfg_gossip, mesh)
    assert ok, problems
    if mesh.size > 1:
        assert curves["xshard_bytes_ici"].min() > 0


def _assert_placed(tree, mesh):
    leaves = tmesh.tree_leaves(tree)
    assert leaves and all(isinstance(x, tmesh.Placed) and x.mesh == mesh for x in leaves)
    assert sorted(parallel.per_device_state_bytes(tree)) == list(range(mesh.size))


def _dense(**gossip_kw):
    jcfg, jtopo, jsched = jmodels.wan_100k(**DENSE)
    tcfg, ttopo, tsched = tb.wan_100k(device="cpu", **DENSE)
    out = []
    for cfg, topo, sched in ((jcfg, jtopo, jsched), (tcfg, ttopo, tsched)):
        sched.writes[:, :] = 0
        sched.writes[:8, :] = 1
        if gossip_kw:
            cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, **gossip_kw))
        out.append((cfg, topo, sched.make_samples(16)))
    return out


@pytest.fixture(scope="module")
def dense():
    (jcfg, jtopo, jsched), (tcfg, ttopo, tsched) = _dense()
    ref = jengine.simulate(jcfg, jtopo, jsched, seed=5)
    mine = tengine.simulate(tcfg, ttopo, tsched, seed=5, device="cpu")
    return (jcfg, jtopo, jsched), (tcfg, ttopo, tsched), ref, mine


@pytest.mark.parametrize("d", DEVICE_COUNTS)
@pytest.mark.parametrize("variant", ["plain", "track_writer_ids", "prop_observe"])
def test_traffic_model_equals_the_reference(variant, d):
    kw = {} if variant == "plain" else {variant: True}
    jcfg = dataclasses.replace(jg.GossipConfig(n_nodes=64, n_writers=16, queue=48), **kw)
    tcfg = dataclasses.replace(tg.GossipConfig(n_nodes=64, n_writers=16, queue=48), **kw)
    want = jparallel.traffic_model(jcfg, benchlib.multichip_mesh(d))
    assert parallel.traffic_model(tcfg, _tmesh(d)) == want
    if d > 1:
        per_entry = 16 if variant == "track_writer_ids" else 12
        assert want["detail"]["queue_block_bytes"] == 64 // d * 48 * per_entry


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_dense_sharded_equals_unsharded_and_reference(dense, d):
    (_, _, _), (tcfg, ttopo, tsched), (jfinal, jcurves), (tfinal, tcurves) = dense
    mesh = _tmesh(d)
    final, curves = parallel.simulate_sharded(tcfg, ttopo, tsched, mesh, seed=5)
    _assert_placed(final, mesh)
    _assert_state_equal(jfinal, final, f"dense D={d} vs reference")
    assert interop.to_numpy(final).keys() == interop.to_numpy(tfinal).keys()
    _assert_curves_equal(jcurves, curves, f"dense D={d} vs reference")
    _assert_curves_equal(tcurves, curves, f"dense D={d} vs port unsharded")
    for k in XSHARD_CURVE_KEYS:  # unsharded runs report no traffic
        assert float(jcurves[k].sum()) == float(tcurves[k].sum()) == 0.0
    _assert_model(curves, tcfg.gossip, mesh)
    # The resume seam: two sharded halves on other meshes equal the whole.
    half = tsched.rounds // 2
    mid, c1 = parallel.simulate_sharded(tcfg, ttopo, tsched.slice(0, half), _tmesh(8 // d), seed=5)
    end, c2 = parallel.simulate_sharded(tcfg, ttopo, tsched.slice(half, tsched.rounds), mesh,
                                        seed=5, state=mid, max_chunk=5)
    _assert_state_equal(jfinal, end, f"dense resumed on D={d}")
    _assert_curves_equal(
        tcurves, {k: np.concatenate([c1[k], c2[k]]) for k in c1}, f"dense resumed on D={d}"
    )


def test_dense_d4_equals_the_reference_sharded_run(dense):
    (jcfg, jtopo, jsched), (tcfg, ttopo, tsched), _, _ = dense
    jfinal, jcurves = jparallel.simulate_sharded(jcfg, jtopo, jsched, benchlib.multichip_mesh(4),
                                                 seed=5)
    final, curves = parallel.simulate_sharded(tcfg, ttopo, tsched, _tmesh(4), seed=5)
    assert float(jcurves["xshard_bytes_dcn"][0]) > 0
    _assert_curves_equal(jcurves, curves, "dense D=4 vs reference sharded", skip=())
    _assert_state_equal(jfinal, final, "dense D=4 vs reference sharded")


@pytest.fixture(scope="module")
def sparse():
    jcfg, jtopo, jsched = jb.anywrite_sparse(**SPARSE)
    tcfg, ttopo, tsched = tb.anywrite_sparse(device="cpu", **SPARSE)
    ref = jsparse.simulate_sparse(jcfg, jtopo, jsched, seed=0)
    mine = tsparse.simulate_sparse(tcfg, ttopo, tsched, seed=0, device="cpu")
    return tcfg, ttopo, tsched, ref, mine


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_sparse_sharded_equals_unsharded_and_reference(sparse, d):
    tcfg, ttopo, tsched, ref, mine = sparse
    mesh = _tmesh(d)
    got = parallel.simulate_sparse_sharded(tcfg, ttopo, tsched, mesh, seed=0)
    for i, what in enumerate(("sstate", "swim", "vis_round")):
        _assert_placed(got[i], mesh)
        _assert_state_equal(ref[i], got[i], f"sparse D={d} {what}")
    assert got[4]["max_dev_entries"] == ref[4]["max_dev_entries"] == mine[4]["max_dev_entries"]
    _assert_curves_equal(ref[3], got[3], f"sparse D={d} vs reference")
    _assert_curves_equal(mine[3], got[3], f"sparse D={d} vs port unsharded")
    _assert_model(got[3], tcfg.gossip, mesh)
    _assert_placed(got[4]["resume"]["sstate"], mesh)


@pytest.fixture(scope="module")
def chunks():
    ccfg, origin, last_seq, _ = jb.anti_entropy_chunks(n=64, streams=2, last_seq=127, rounds=0)
    jstate, jm = jchunk.simulate_chunks(ccfg, origin, last_seq, 24, seed=3)
    tccfg, torigin, tlast, _ = tb.anti_entropy_chunks(n=64, streams=2, last_seq=127, rounds=0,
                                                      device="cpu")
    return tccfg, torigin, tlast, (jstate, jm)


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_chunk_sharded_equals_reference(chunks, d):
    tccfg, torigin, tlast, (jstate, jm) = chunks
    mesh = _tmesh(d)
    state, m = parallel.simulate_chunks_sharded(tccfg, torigin, tlast, 24, mesh, seed=3)
    _assert_placed(state, mesh)
    _assert_placed(m["vis"], mesh)
    _assert_state_equal(jstate, state, f"chunk D={d}")
    assert np.array_equal(np.asarray(jm["vis"]), interop.to_numpy(m["vis"]))
    assert m["applied_frac"] == jm["applied_frac"]
    _assert_curves_equal(jm["curves"], m["curves"], f"chunk D={d}", skip=())
    assert float(m["curves"]["xshard_bytes_ici"].sum()) == 0.0  # no queue to exchange


@pytest.fixture(scope="module")
def mixed():
    jargs = jb.mixed_storm(**MIXED)
    targs = tb.mixed_storm(device="cpu", **MIXED)
    return targs, jmixed.simulate_mixed(*jargs, seed=0)


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_mixed_sharded_equals_reference(mixed, d):
    (tcfg, tccfg, ttopo, tsched, tspec), (jfinal, jcurves) = mixed
    mesh = _tmesh(d)
    final, curves = parallel.simulate_mixed_sharded(tcfg, tccfg, ttopo, tsched, tspec, mesh,
                                                    seed=0)
    _assert_placed(final, mesh)
    _assert_state_equal(jfinal, final, f"mixed D={d}")
    _assert_curves_equal(jcurves, curves, f"mixed D={d}")
    _assert_model(curves, tcfg.gossip, mesh)


@pytest.fixture
def legacy_path():
    saved = (jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS)
    jax.clear_caches()
    jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        yield
    finally:
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = saved
        jax.clear_caches()


def test_legacy_delivery_sharded_at_d2(legacy_path, monkeypatch):
    """merge_10k at n=64 with a burst (two versions per writer per round
    for rounds 0-11) under loss: the window opens and the legacy
    admission's rowsum assembles its bits inside the shard bodies."""
    from corrosion_tpu_torch.ops import onehot

    calls = {"rowsum": 0, "rowgather_wide": 0}
    for name in calls:
        fn = getattr(onehot, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(onehot, name, counted)
    kw = dict(n=64, rounds=24, samples=16)
    runs = []
    for build in (jb.merge_10k, lambda **k: tb.merge_10k(device="cpu", **k)):
        cfg, topo, sched = build(**kw)
        cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, loss_prob=0.2))
        sched.writes[:12, :] = 2
        runs.append((cfg, topo, sched.make_samples(16)))
    (jcfg, jtopo, jsched), (tcfg, ttopo, tsched) = runs
    jfinal, jcurves = jengine.simulate(jcfg, jtopo, jsched, seed=1)
    mesh = _tmesh(2)
    final, curves = parallel.simulate_sharded(tcfg, ttopo, tsched, mesh, seed=1)
    assert float(jcurves["chaos_lost_msgs"].sum()) > 0
    # Both shard bodies took the legacy delivery and its window admission.
    assert calls["rowgather_wide"] >= 2 * tsched.rounds and calls["rowsum"] > 0, calls
    _assert_state_equal(jfinal, final, "legacy D=2")
    _assert_curves_equal(jcurves, curves, "legacy D=2")
    _assert_model(curves, tcfg.gossip, mesh)


def test_kill_feedback_shard_invariant():
    """The rumor kill's sender feedback (a full [N, Q] scatter-add summed
    across shards) at D=2: equal to the unsharded run on protocol state
    and every propagation curve, and q_dup never joins the exchange (the
    byte model still holds)."""
    kw = dict(n=32, n_regions=4, n_writers=8, rounds=12, samples=8, partition=False)
    gossip_kw = dict(prop_observe=True, **thealth.ADAPTIVE_GOSSIP)
    assert gossip_kw == dict(prop_observe=True, **jhealth.ADAPTIVE_GOSSIP)
    runs = []
    for build in (jmodels.wan_100k, lambda **k: tb.wan_100k(device="cpu", **k)):
        cfg, topo, sched = build(**kw)
        sched.writes[:, :] = 0
        sched.writes[:4, :] = 1
        cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, **gossip_kw))
        runs.append((cfg, topo, sched.make_samples(8)))
    (jcfg, jtopo, jsched), (tcfg, ttopo, tsched) = runs
    jfinal, jcurves = jengine.simulate(jcfg, jtopo, jsched, seed=0)
    mesh = tmesh.make_mesh(2, device="cpu")
    final, curves = parallel.simulate_sharded(tcfg, ttopo, tsched, mesh, seed=0)
    assert float(curves["prop_rumor_kills"].sum()) > 0
    for k in PROP_CURVE_KEYS:
        assert np.array_equal(np.asarray(jcurves[k]), curves[k]), k
    _assert_state_equal(jfinal, final, "kill D=2")
    _assert_model(curves, tcfg.gossip, mesh)

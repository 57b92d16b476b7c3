"""The port's mesh and placement (``corrosion_tpu_torch/parallel/mesh.py``)
against the live JAX reference on the CPU: every leaf's spec and split
factor equal the reference's for the dense, sparse, chunk and mixed state
at D in {1, 2, 4 (2x2), 8 (2x4)}; the byte prediction equals the bytes
each position holds (and, at the reference's itemsizes, the reference's
prediction); a split that does not divide raises; the per-position state
at D=8 is at most 1/6 of D=1; a reference state of each family, read
whole, places on a port mesh (``interop.placed_state_from_numpy``) and
reads back equal.
"""

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu import models as jmodels
from corrosion_tpu.models.baselines import anywrite_sparse as j_anywrite
from corrosion_tpu.ops import sparse_writers as j_sw
from corrosion_tpu.ops import swim as j_swim
from corrosion_tpu.ops.chunks import ChunkConfig as JChunkConfig
from corrosion_tpu.ops.chunks import init_chunks as j_init_chunks
from corrosion_tpu.parallel import mesh as jmesh
from corrosion_tpu.sim import benchlib
from corrosion_tpu.sim import engine as jengine
from corrosion_tpu.sim import invariants as jinv
from corrosion_tpu.sim import mixed_engine as jmixed
from corrosion_tpu.sim.faults import FaultPlan as JFaultPlan
from corrosion_tpu_torch import interop, parallel
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import sparse_writers as t_sw
from corrosion_tpu_torch.ops import swim as t_swim
from corrosion_tpu_torch.ops.chunks import ChunkConfig as TChunkConfig
from corrosion_tpu_torch.ops.chunks import init_chunks as t_init_chunks
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.parallel import shard_driver as tdriver
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import invariants as tinv
from corrosion_tpu_torch.sim import mixed_engine as tmixed
from corrosion_tpu_torch.sim.faults import FaultPlan as TFaultPlan

torch.set_num_threads(1)

DEVICE_COUNTS = (1, 2, 4, 8)
N = 64


def _jp(spec) -> tuple:
    """A reference PartitionSpec as a tuple of entries."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


def _j_leaves(specs) -> list:
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _states():
    """(name, reference host tree, its spec builder, port tree, its spec
    builder) for the four state families at n = 64."""
    chunk_kw = dict(n_nodes=N, n_streams=2, cap=8, chunk_len=64, fanout=2, k_in=4,
                    sync_interval=2, gap_requests=2, sync_seq_budget=256)
    origin, last = np.asarray([0, 7], np.int32), np.asarray([255, 255], np.int32)
    jcfg, _, jsched = jmodels.wan_100k(n=N, n_regions=4, n_writers=16, rounds=8, samples=8)
    tcfg, _, tsched = tb.wan_100k(n=N, n_regions=4, n_writers=16, rounds=8, samples=8,
                                  device="cpu")
    skw = dict(n=N, w_hot=8, rounds=16, n_regions=4, epoch_rounds=8, cohort=4,
               burst_writes=2, samples=16, k_dev=8, seed=3)
    sj, _, ssj = j_anywrite(**skw)
    st, _, sst = tb.anywrite_sparse(device="cpu", **skw)
    plan_j, plan_t = JFaultPlan(rounds=24, name="contract"), TFaultPlan(rounds=24, name="contract")
    mj = jinv._mixed_scenario(plan_j, 0)
    mt = tinv._mixed_scenario(plan_t, 0, "cpu")

    def j_sparse_specs(tree, mesh):
        node = jmesh._node_axis(mesh, None)
        return (jmesh.sparse_state_specs(tree[0], mesh), jmesh.node_major_specs(tree[1], mesh),
                jax.sharding.PartitionSpec(None, node))

    def t_sparse_specs(tree, mesh):
        node = tdriver.node_spec_entry(mesh)
        return (tmesh.sparse_state_specs(tree[0], mesh), tmesh.node_major_specs(tree[1], mesh),
                tmesh.P(None, node))

    def j_chunk_specs(tree, mesh):
        return (jmesh.node_major_specs(tree[0], mesh),
                jax.sharding.PartitionSpec(jmesh._node_axis(mesh, None), None))

    def t_chunk_specs(tree, mesh):
        return (tmesh.node_major_specs(tree[0], mesh), tmesh.P(tdriver.node_spec_entry(mesh), None))

    return [
        ("dense", jax.device_get(jengine.init_cluster(jcfg, len(jsched.sample_writer))),
         jmesh.cluster_state_specs,
         tengine.init_cluster(tcfg, len(tsched.sample_writer), "cpu"), tmesh.cluster_state_specs),
        ("sparse", jax.device_get((
            j_sw.init_sparse(sj.gossip, sj.sparse), j_swim.impl(sj.swim).init_state(sj.swim),
            np.zeros((len(ssj.sample_writer), N), np.int32))),
         j_sparse_specs,
         (t_sw.init_sparse(st.gossip, st.sparse, "cpu"),
          t_swim.impl(st.swim).init_state(st.swim, "cpu"),
          torch.zeros((len(sst.sample_writer), N), dtype=torch.int64)),
         t_sparse_specs),
        ("chunk", jax.device_get((j_init_chunks(JChunkConfig(**chunk_kw), origin, last),
                                  np.full((N, 2), -1, np.int32))),
         j_chunk_specs,
         (t_init_chunks(TChunkConfig(**chunk_kw), origin, last, "cpu"),
          torch.full((N, 2), -1, dtype=torch.int64)),
         t_chunk_specs),
        ("mixed", jax.device_get(jmixed.init_mixed_state(*mj)), jmesh.mixed_state_specs,
         tmixed.init_mixed_state(*mt, device="cpu"), tmesh.mixed_state_specs),
    ]


@pytest.fixture(scope="module")
def states():
    return _states()


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_specs_and_factors_equal_the_reference(states, d):
    jm, tm = benchlib.multichip_mesh(d), tmesh.multichip_mesh(d, device="cpu")
    assert tm.shape == dict(jm.shape) and tm.axis_names == tuple(jm.axis_names)
    for name, jtree, jspecs, ttree, tspecs in states:
        js, ts = _j_leaves(jspecs(jtree, jm)), tmesh.tree_leaves(tspecs(ttree, tm))
        assert [_jp(s) for s in js] == [tuple(s) for s in ts], name
        assert [jmesh.spec_shard_factor(s, jm) for s in js] == [
            tmesh.spec_shard_factor(s, tm) for s in ts
        ], name
        # Leaf for leaf the same shapes, so the same placement.
        assert [np.shape(x) for x in jax.tree.leaves(jtree)] == [
            tuple(x.shape) for x in tmesh.tree_leaves(ttree)
        ], name


@pytest.mark.parametrize("d", DEVICE_COUNTS)
def test_predicted_bytes_equal_each_positions_bytes(states, d):
    jm, tm = benchlib.multichip_mesh(d), tmesh.multichip_mesh(d, device="cpu")
    for name, jtree, jspecs, ttree, tspecs in states:
        specs = tspecs(ttree, tm)
        predicted = tmesh.predicted_per_device_bytes(ttree, specs, tm)
        placed = tmesh.place(ttree, specs, tm)
        measured = parallel.per_device_state_bytes(placed)
        assert sorted(measured) == list(range(d)), name
        assert set(measured.values()) == {predicted}, name
        # Read whole again, the placement lost nothing.
        got = tmesh.tree_leaves(tmesh.assemble(placed))
        assert all(torch.equal(a, b) for a, b in zip(tmesh.tree_leaves(ttree), got)), name
        # At the reference's itemsizes (u32, i32, bool) the port's
        # arithmetic gives the reference's prediction.
        ref_bytes = jmesh.predicted_per_device_bytes(jtree, jspecs(jtree, jm), jm)
        assert tmesh.predicted_per_device_bytes(interop.to_numpy(ttree), specs, tm) == ref_bytes


def test_a_split_that_does_not_divide_raises():
    cfg, _, sched = tb.wan_100k(n=12, n_regions=2, n_writers=4, rounds=4, samples=4,
                                device="cpu")
    state = tengine.init_cluster(cfg, len(sched.sample_writer), "cpu")
    mesh = tmesh.multichip_mesh(8, device="cpu")
    specs = tmesh.cluster_state_specs(state, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.predicted_per_device_bytes(state, specs, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_cluster_state(state, mesh)


def test_per_position_state_scales_o_n_over_d():
    cfg, _, sched = tb.wan_100k(n=512, n_regions=4, n_writers=16, rounds=4, samples=16,
                                device="cpu")
    most = {}
    for d in (1, 8):
        state = tengine.init_cluster(cfg, len(sched.sample_writer), "cpu")
        per = parallel.per_device_state_bytes(
            parallel.shard_cluster_state(state, tmesh.multichip_mesh(d, device="cpu"))
        )
        assert len(per) == d
        most[d] = max(per.values())
    assert most[8] <= most[1] / 6, most


def test_mesh_layout_repr_and_hash():
    mesh = tmesh.make_wan_mesh(2, 4, device="cpu")
    assert mesh.shape == {"dcn": 2, "ici": 4} and mesh.size == 8
    assert mesh == tmesh.make_wan_mesh(2, 4, device="cpu")
    assert hash(mesh) == hash(tmesh.make_wan_mesh(2, 4, device="cpu"))
    assert mesh != tmesh.make_mesh(8, device="cpu")
    assert repr(mesh) == "Mesh(dcn=2, ici=4; 8 positions on cpu)"
    assert tdriver.make_sharded_broadcast(mesh) is tdriver.make_sharded_broadcast(
        tmesh.make_wan_mesh(2, 4, device="cpu")
    )
    # Positions of a mesh named by dims, either package's.
    assert interop.mesh_dims(interop.mesh_from_dims((2, 4), "cpu")) == (2, 4)
    assert interop.mesh_dims(benchlib.multichip_mesh(8)) == (2, 4)
    assert interop.mesh_dims(interop.mesh_from_dims((2,), "cpu")) == (2,)


def test_placed_blocks_follow_dcn_major_order():
    mesh = tmesh.make_wan_mesh(2, 2, device="cpu")
    x = torch.arange(8 * 3).reshape(8, 3)
    placed = tmesh.place_leaf(x, tmesh.P(("dcn", "ici"), None), mesh)
    for i, b in enumerate(placed.blocks):
        assert torch.equal(b, x[2 * i : 2 * i + 2])
    # A split over the ici axis alone repeats its blocks along dcn.
    ici = tmesh.place_leaf(x, tmesh.P("ici", None), mesh)
    assert [int(b[0, 0]) for b in ici.blocks] == [0, 12, 0, 12]
    assert torch.equal(ici.whole(), x)
    rep = tmesh.place_leaf(x, tmesh.P(), mesh)
    assert all(b is rep.blocks[0] for b in rep.blocks) and torch.equal(rep.whole(), x)


def _as_dicts(tree):
    if hasattr(tree, "_fields"):
        return {k: _as_dicts(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


@pytest.mark.parametrize("d", (2, 8))
def test_a_reference_state_places_on_a_port_mesh(states, d):
    tm = tmesh.multichip_mesh(d, device="cpu")
    by_name = {name: jtree for name, jtree, *_ in states}
    for kind, jtree in (("cluster", by_name["dense"]), ("sparse", by_name["sparse"][0]),
                        ("chunk", by_name["chunk"][0]), ("mixed", by_name["mixed"])):
        want = _as_dicts(jtree)
        placed = interop.placed_state_from_numpy(want, tm, kind)
        leaves = tmesh.tree_leaves(placed)
        assert all(isinstance(x, tmesh.Placed) for x in leaves), kind
        per = parallel.per_device_state_bytes(placed)
        assert len(per) == d and len(set(per.values())) == 1, kind
        got = interop.to_numpy(placed)

        def same(a, b):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    same(a[k], b[k])
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b)

        same(want, got)

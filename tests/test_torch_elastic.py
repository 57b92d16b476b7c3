"""The port's elastic plane (``corrosion_tpu_torch/elastic/``) against the
live JAX reference on the CPU:

- ``poison_lost_shard`` destroys the same elements as the reference's on
  the same mid-run state, and only one position's block;
- ``schedule_slice`` windows every axis, and place -> gather -> re-place
  over the spec builders is a bijection with an exact byte reconcile for
  every state family and every (D, D') in {1, 2, 4, 8}^2;
- ``reshard_dense_4to8`` and ``preempt_dense_churn`` give the reference's
  reports, walls aside and with the byte prediction taken at the
  reference's itemsizes (the port's own counts its int64 carriers at 8
  bytes); the rest of the drill catalog holds on the port;
- checkpoints cross packages and meshes both ways: the reference's file,
  written on a 2x2 mesh, resumes in the port on 2x4 to the reference's
  final state, and the port's resumes in the reference;
- ``check_elastic_budget`` gives the reference's verdicts on the same
  reports and budgets.
"""

import copy
import dataclasses
import itertools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.elastic import preempt as jpreempt
from corrosion_tpu.elastic import report as jreport
from corrosion_tpu.elastic import reshard as jreshard
from corrosion_tpu.elastic import scenarios as jscenarios
from corrosion_tpu.parallel import mesh as jmesh
from corrosion_tpu.parallel import shard_driver as jdriver
from corrosion_tpu.sim import checkpoint as jcheckpoint
from corrosion_tpu.sim import engine as jengine
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.elastic import preempt as tpreempt
from corrosion_tpu_torch.elastic import report as treport
from corrosion_tpu_torch.elastic import reshard as treshard
from corrosion_tpu_torch.elastic import scenarios as tscenarios
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.parallel import shard_driver as tdriver
from corrosion_tpu_torch.sim import engine as tengine
from test_torch_parallel_mesh import _states

torch.set_num_threads(1)

BUDGET = json.loads((Path(__file__).resolve().parent.parent / "bench_budget.json").read_text())["elastic"]


def _mid_state():
    """The reference's dense state after 8 rounds at n=16, and the port's
    copy of it."""
    from corrosion_tpu import models

    cfg, topo, sched = models.wan_100k(n=16, n_regions=2, n_writers=4, rounds=8, samples=4)
    sched.writes[:2, :] = 1
    final, _ = jengine.simulate(cfg, topo, sched.make_samples(4), seed=1)
    host = jax.device_get(final)
    nested = jax.tree_util.tree_map(np.asarray, host)

    def as_dict(t):
        if hasattr(t, "_fields"):
            return {k: as_dict(v) for k, v in t._asdict().items()}
        return t

    return host, interop.cluster_state_from_numpy(as_dict(nested), "cpu")


def test_poison_lost_shard_hits_the_reference_rows():
    jhost, thost = _mid_state()
    jm, tm = jreshard.virtual_mesh(8), treshard.virtual_mesh(8, "cpu")
    for dev in (0, 3, 7):
        jp, jn = jpreempt.poison_lost_shard(jhost, jmesh.cluster_state_specs(jhost, jm), jm, dev)
        tp, tn = tpreempt.poison_lost_shard(thost, tmesh.cluster_state_specs(thost, tm), tm, dev)
        assert jn == tn > 0
        ja = [np.asarray(x) for x in jax.tree.leaves(jhost)]
        jb_ = [np.asarray(x) for x in jax.tree.leaves(jp)]
        ta = [x.numpy() for x in tmesh.tree_leaves(thost)]
        tb_ = [x.numpy() for x in tmesh.tree_leaves(tp)]
        assert len(ja) == len(ta)
        for a0, a1, b0, b1 in zip(ja, jb_, ta, tb_):
            assert np.array_equal(a0 != a1, b0 != b1)
        # Rows [2 dev, 2 dev + 2) of the node-major leaves, nothing else.
        a, b = thost.data.contig.numpy(), tp.data.contig.numpy()
        rows = [2 * dev, 2 * dev + 1]
        assert not np.array_equal(a[rows], b[rows])
        assert np.array_equal(np.delete(a, rows, axis=0), np.delete(b, rows, axis=0))
        assert torch.equal(thost.data.head, tp.data.head)
    with pytest.raises(ValueError, match="outside"):
        tpreempt.poison_lost_shard(thost, tmesh.cluster_state_specs(thost, tm), tm, 8)


def test_schedule_slice_windows_faults_keeps_samples_absolute():
    _cfg, _topo, sched = tb.wan_100k(n=16, n_regions=2, n_writers=4, rounds=8, samples=4,
                                     device="cpu")
    sched.writes[:2, :] = 1
    sched = dataclasses.replace(
        sched.make_samples(4), loss=np.linspace(0, 1, 16, dtype=np.float32).reshape(8, 2)
    )
    sl = treshard.schedule_slice(sched, 2, 6)
    assert sl.rounds == 4 and sl.kill is None
    np.testing.assert_array_equal(sl.writes, sched.writes[2:6])
    np.testing.assert_array_equal(sl.loss, sched.loss[2:6])
    np.testing.assert_array_equal(sl.sample_round, sched.sample_round)
    np.testing.assert_array_equal(sl.sample_writer, sched.sample_writer)


def test_mesh_specs_are_a_reshard_bijection():
    meshes = {d: treshard.virtual_mesh(d, "cpu") for d in (1, 2, 4, 8)}
    for name, _jtree, _jspecs, host, specs_fn in _states():
        for d_a, d_b in itertools.product((1, 2, 4, 8), repeat=2):
            placed_a, rec_a = treshard.place_reconciled(host, specs_fn(host, meshes[d_a]), meshes[d_a])
            host_a = tmesh.to_host(placed_a)
            assert treport.diff_trees(host, host_a, f"{name} D={d_a}: ") == []
            placed_b, rec_b = treshard.place_reconciled(
                host_a, specs_fn(host_a, meshes[d_b]), meshes[d_b]
            )
            assert treport.diff_trees(host, placed_b, f"{name} {d_a}->{d_b}: ") == []
            assert rec_a["ok"] and rec_b["ok"]
            assert rec_a["devices"] == d_a and rec_b["devices"] == d_b


def _same_report(jrep, trep, ref_bytes):
    """Reports equal but for the walls and the byte prediction, which the
    port makes at its own itemsizes; ``ref_bytes`` is the port's
    prediction at the reference's."""
    jrep, trep = copy.deepcopy(jrep), copy.deepcopy(trep)
    jrep.pop("wall_s"), trep.pop("wall_s")
    assert jrep["reconcile"].pop("predicted_per_device_bytes") == ref_bytes
    trep["reconcile"].pop("predicted_per_device_bytes")
    assert jrep == trep


def _dense_ref_bytes(mesh_dims, n_samples):
    cfg, _, _ = tscenarios._dense_setup("cpu")
    state = tengine.init_cluster(cfg, n_samples, "cpu")
    mesh = tmesh.mesh_from_dims(mesh_dims, "cpu")
    return tmesh.predicted_per_device_bytes(
        interop.to_numpy(state), tmesh.cluster_state_specs(state, mesh), mesh
    )


@pytest.fixture(scope="module")
def reshard_pair(tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    jrep = jscenarios.run_reshard_scenario("dense", 4, 8, checkpoint_dir=str(jdir))
    trep = tscenarios.run_reshard_scenario("dense", 4, 8, checkpoint_dir=str(tdir), device="cpu")
    return jrep, trep, jdir / "dense_reshard.npz", tdir / "dense_reshard.npz"


def test_reshard_dense_4to8_matches_the_reference(reshard_pair):
    jrep, trep, _, _ = reshard_pair
    assert trep["ok"] and trep["bit_identical"] and trep["checkpoint"]["mesh"] == [2, 2]
    _, _, sched = tscenarios._dense_setup("cpu")
    _same_report(jrep, trep, _dense_ref_bytes((2, 4), len(sched.sample_writer)))


def test_preempt_dense_churn_matches_the_reference(tmp_path):
    jrep = jscenarios.run_preempt_scenario(checkpoint_dir=str(tmp_path / "ref"))
    trep, run = tscenarios.run_preempt_scenario(
        checkpoint_dir=str(tmp_path / "port"), device="cpu", _return_run=True
    )
    assert trep["ok"] and trep["machinery"]["fired"] and trep["machinery"]["gap_rounds_replayed"] == 13
    assert run.counters.preempts_fired == 2
    from corrosion_tpu_torch.sim import invariants as tinv

    cfg, _, sched = tinv._dense_scenario(tscenarios._preempt_plan(), 0, "cpu")
    state = tengine.init_cluster(cfg, len(sched.sample_writer), "cpu")
    mesh = treshard.virtual_mesh(8, "cpu")
    ref_bytes = tmesh.predicted_per_device_bytes(
        interop.to_numpy(state), tmesh.cluster_state_specs(state, mesh), mesh
    )
    _same_report(jrep, trep, ref_bytes)


@pytest.mark.parametrize("name", [
    n for n in tscenarios.scenario_names()
    if n not in ("reshard_dense_4to8", "preempt_dense_churn", "soak_preempt")
])
def test_the_rest_of_the_catalog_holds(name, tmp_path):
    rep = tscenarios.run_scenario(name, checkpoint_dir=str(tmp_path), device="cpu")
    assert rep["ok"] and rep["bit_identical"] and rep["reconcile"]["ok"], rep["mismatches"]
    assert rep["checkpoint"]["schema"] == "corro-checkpoint/1"


def test_soak_preempt_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tscenarios.run_scenario("soak_preempt", device="cpu")
    with pytest.raises(ValueError, match="unknown elastic scenario"):
        tscenarios.run_scenario("drill_nothing", device="cpu")


def test_checkpoints_resume_across_packages_and_meshes(reshard_pair):
    _, _, jpath, tpath = reshard_pair
    jcfg, jtopo, jsched = jscenarios._dense_setup()
    tcfg, ttopo, tsched = tscenarios._dense_setup("cpu")
    n_samples, split = len(tsched.sample_writer), tsched.rounds // 2
    jfinal, _ = jengine.simulate(jcfg, jtopo, jsched, seed=0)
    want = jax.device_get(jfinal)

    def same(port_state):
        got = interop.to_numpy(port_state)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = got
            for k in path:
                node = node[getattr(k, "name", getattr(k, "key", None))]
            assert np.array_equal(np.asarray(leaf), node), jax.tree_util.keystr(path)

    # The reference's file, written on its 2x2 mesh, resumes in the port on 2x4.
    header = jcheckpoint.read_header(str(jpath))
    assert header["mesh"] == [2, 2] and header["round"] == split
    mesh = interop.mesh_from_dims((2, 4), "cpu")
    placed, theader = interop.load_placed_checkpoint(
        str(jpath), tcfg, n_samples, mesh, expect_fingerprint=header["config_fingerprint"]
    )
    assert theader == header
    final, _ = tdriver.simulate_sharded(
        tcfg, ttopo, tsched.slice(split, tsched.rounds), mesh, seed=0, state=placed
    )
    same(final)

    # The port's file, written on its 2x2 mesh, resumes in the reference on 2x4.
    pheader = jcheckpoint.read_header(str(tpath))
    assert pheader == header  # the same config fingerprint, mesh and round
    state = jcheckpoint.load_state(
        str(tpath), jcfg, n_samples, expect_fingerprint=pheader["config_fingerprint"]
    )
    jm = jreshard.virtual_mesh(8)
    rfinal, _ = jdriver.simulate_sharded(
        jcfg, jtopo, jreshard.schedule_slice(jsched, split, jsched.rounds), jm, seed=0,
        state=jmesh.shard_cluster_state(state, jm),
    )
    assert jreport.diff_trees(jax.device_get(rfinal), want) == []


def _gate_scenario(**over):
    s = {
        "scenario": "drill", "bit_identical": True, "mismatches": [], "reconcile": {"ok": True},
        "violations": [], "machinery": {"fired": True}, "wall_s": {"run": 1.0}, "ok": True,
    }
    s.update(over)
    return s


@pytest.mark.parametrize("case", [
    {}, {"bit_identical": False}, {"reconcile": {"ok": False}}, {"violations": ["x"]},
    {"machinery": {"fired": False}}, {"wall_s": {"run": 500.0}}, {"ok": False}, "missing",
])
def test_budget_gate_gives_the_reference_verdicts(case):
    names = list(BUDGET["scenarios"])
    scen = [] if case == "missing" else [
        _gate_scenario(scenario=n, **({} if case == "missing" else case)) for n in names
    ]
    for report in ({"scenarios": scen}, {"scenarios": scen[:1]}):
        for budget in (BUDGET, dict(BUDGET, tolerance=0.01), dict(BUDGET, require_machinery_fired=0)):
            assert treport.check_elastic_budget(report, budget) == jreport.check_elastic_budget(
                report, budget
            )

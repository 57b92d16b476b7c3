"""The mixed engine (``sim/mixed_engine.py``) against the live JAX reference
on the CPU, bit for bit: ``mixed_storm``'s builder output field for field,
one ``mixed_round`` from a state carried across at a commit round, whole
runs without cells, with cells, under churn with a wipe and loss, and
adaptive with the propagation plane on, and the resume seam (a reference
state carried across mid-run, and the port's own split and chunked runs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import faults as jf
from corrosion_tpu.sim import health as jh
from corrosion_tpu.sim import mixed_engine as jm
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.sim import faults as tf
from corrosion_tpu_torch.sim import health as th
from corrosion_tpu_torch.sim import mixed_engine as tm
from corrosion_tpu_torch.sim import telemetry as tt

torch.set_num_threads(1)

KW = dict(n=64, streams=2, last_seq=255, rounds=24, samples=16)


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


def _assert_state_equal(js, ts):
    a, b = _flat(js), _flat(interop.to_numpy(ts))
    assert a.keys() == b.keys()
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"final state differs in {bad}"


def _assert_curves_equal(cj, ct, start=0):
    assert set(cj) == set(ct) == set(tt.ROUND_CURVE_KEYS)
    bad = [
        k for k in cj
        if not (np.asarray(cj[k]).dtype == ct[k].dtype and np.array_equal(np.asarray(cj[k])[start:], ct[k]))
    ]
    assert not bad, f"curves differ in {bad}"


def _builders(**kw):
    return jb.mixed_storm(**KW, **kw), tb.mixed_storm(device="cpu", **KW, **kw)


def _run_both(j_args, t_args, **kw):
    fj, cj = jm.simulate_mixed(*j_args, seed=0)
    ft, ct = tm.simulate_mixed(*t_args, seed=0, device="cpu", **kw)
    return fj, cj, ft, ct


@pytest.fixture(scope="module")
def with_cells():
    j_args, t_args = _builders()
    return (j_args, t_args, *_run_both(j_args, t_args))


@pytest.fixture(scope="module")
def mid(with_cells):
    """The reference's state at the last big commit round (stream 0 is in
    flight, stream 1 commits): (round, state)."""
    cfg, ccfg, topo, sched, spec = with_cells[0]
    r = int(spec.commit_round.max())
    assert r > int(spec.commit_round.min())
    state, _ = jm.simulate_mixed(
        cfg, ccfg, topo, dataclasses.replace(sched, writes=sched.writes[:r]), spec, seed=0
    )
    return r, state


def test_builder_output_matches_reference():
    """At the test size, without cells, and at the builder's full size."""
    for full, kw in ((False, {}), (False, {"n_cells": 0}), (True, {})):
        if full:
            (cj, ccj, topo_j, sj, spj), (ct, cct, topo_t, st, spt) = (
                jb.mixed_storm(), tb.mixed_storm(device="cpu"))
        else:
            (cj, ccj, topo_j, sj, spj), (ct, cct, topo_t, st, spt) = _builders(**kw)
        assert dataclasses.asdict(cj.gossip) == dataclasses.asdict(ct.gossip)
        assert dataclasses.asdict(cj.swim) == dataclasses.asdict(ct.swim)
        assert cj.round_ms == ct.round_ms
        assert dataclasses.asdict(ccj) == dataclasses.asdict(cct)
        for f in topo_j._fields:
            a, b = getattr(topo_j, f), getattr(topo_t, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.array_equal(np.asarray(a), b.numpy()), f
        for f in ("writes", "sample_writer", "sample_ver", "sample_round"):
            a, b = getattr(sj, f), getattr(st, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        for f in ("writer", "version", "commit_round", "last_seq"):
            a, b = getattr(spj, f), getattr(spt, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    # The shift past each big version reached the samples.
    assert any(st.sample_ver[i] > spt.version[w]
               for i, w in enumerate(st.sample_writer) if w < len(spt.writer))


def test_run_without_cells_matches_reference():
    j_args, t_args = _builders(n_cells=0)
    fj, cj, ft, ct = _run_both(j_args, t_args)
    assert ct["chunks_sent"].sum() > 0 and ct["vis_count"].sum() > 0
    _assert_curves_equal(cj, ct)
    _assert_state_equal(fj, ft)


def test_run_with_cells_matches_reference(with_cells):
    _, _, fj, cj, ft, ct = with_cells
    # Admission merged the big versions' cells, the sync served partial
    # needs, every pair reassembled.
    assert ct["cell_merges"].sum() > 0 and ct["seqs_granted"].sum() > 0
    assert ct["streams_applied"][-1] == 64 * 2
    _assert_curves_equal(cj, ct)
    _assert_state_equal(fj, ft)


def test_one_round_from_a_carried_state_at_a_commit_round(with_cells, mid):
    """The reference's state at a commit round, then that round's
    mixed_round on both sides."""
    (cfg_j, ccfg_j, topo_j, sched_j, spec_j), (cfg_t, ccfg_t, topo_t, sched_t, spec_t) = \
        with_cells[:2]
    r, mid_j = mid
    commit = np.asarray(spec_j.commit_round) == r
    n_regions = topo_j.region_rtt.shape[0]
    part = np.zeros((n_regions, n_regions), bool)
    key_j = jax.random.fold_in(jax.random.PRNGKey(0), r)
    nj, stats_j = jm.mixed_round(
        mid_j, topo_j, jnp.asarray(sched_j.writes[r]), jnp.asarray(commit), jnp.asarray(part),
        jnp.zeros((1,), bool), jnp.zeros((1,), bool), jnp.asarray(spec_j.writer),
        jnp.asarray(spec_j.version), jnp.asarray(spec_j.last_seq),
        jnp.asarray(sched_j.sample_writer), jnp.asarray(sched_j.sample_ver),
        jnp.asarray(sched_j.sample_round), key_j, cfg_j, ccfg_j, False,
    )
    mid_t = interop.mixed_state_from_numpy(_nested(mid_j), device="cpu")
    nt, stats_t = tm.mixed_round(
        mid_t, topo_t, torch.as_tensor(sched_t.writes[r].astype(np.int64)), commit,
        torch.as_tensor(part), None, None, tm._streams(spec_t, topo_t, "cpu"),
        torch.as_tensor(sched_t.sample_writer.astype(np.int64)),
        torch.as_tensor(sched_t.sample_ver.astype(np.int64)),
        torch.as_tensor(sched_t.sample_round.astype(np.int64)),
        trng.fold_in(trng.PRNGKey(0), r), cfg_t, ccfg_t,
    )
    assert int(nt.data.head[int(spec_t.writer[1])]) >= int(spec_t.version[1])
    _assert_state_equal(nj, nt)
    for k in tt.ROUND_CURVE_KEYS:
        assert float(stats_j[k]) == float(stats_t[k]), k


def _chaos(faults_mod, sched, cfg, n_regions, schedule_rounds):
    F = faults_mod.Fault
    # A wipe that spares the streams' origin nodes (0 and 1), a node that
    # stays down, receiver loss on region 0 and probe loss.
    plan = faults_mod.FaultPlan(schedule_rounds, (
        F("churn", 6, 7, nodes=(5, 6, 20), revive_at=14, wipe=True),
        F("churn", 4, 5, nodes=(40,)),
        F("loss", 3, 11, prob=0.5, regions=(0,)),
        F("probe_loss", 2, 9, prob=0.4),
    ))
    return faults_mod.apply_plan(sched, plan, cfg.n_nodes, n_regions)


def test_run_under_churn_wipe_and_loss_matches_reference():
    (cj, ccj, topo_j, sj, spj), (ct, cct, topo_t, st, spt) = _builders()
    sj = _chaos(jf, sj, cj, 4, KW["rounds"])
    st = _chaos(tf, st, ct, 4, KW["rounds"])
    assert st.wipe.sum() == 3
    fj, cj_, ft, ct_ = _run_both((cj, ccj, topo_j, sj, spj), (ct, cct, topo_t, st, spt))
    assert ct_["chaos_wiped"].sum() == 3 and ct_["chaos_lost_msgs"].sum() > 0
    _assert_curves_equal(cj_, ct_)
    _assert_state_equal(fj, ft)


def test_adaptive_run_with_propagation_matches_reference():
    """The reference's adaptive mixed case: ``ADAPTIVE_GOSSIP`` with
    ``prop_observe``; conservation holds and rumors die."""
    (cj, ccj, topo_j, sj, spj), (ct, cct, topo_t, st, spt) = _builders(n_cells=0)
    cj = dataclasses.replace(cj, gossip=dataclasses.replace(
        cj.gossip, prop_observe=True, **jh.ADAPTIVE_GOSSIP))
    ct = th.with_adaptive(ct, prop_observe=True)
    assert dataclasses.asdict(cj.gossip) == dataclasses.asdict(ct.gossip)
    fj, cj_, ft, ct_ = _run_both((cj, ccj, topo_j, sj, spj), (ct, cct, topo_t, st, spt))
    assert np.array_equal(ct_["prop_useful_msgs"] + ct_["prop_dup_msgs"], ct_["msgs"])
    link = sum(ct_[k].astype(np.int64) for k in tt.LINK_CURVE_KEYS)
    assert np.array_equal(link, ct_["msgs"].astype(np.int64))
    assert ct_["prop_rumor_kills"].sum() > 0
    _assert_curves_equal(cj_, ct_)
    _assert_state_equal(fj, ft)


def test_resume_seam(with_cells, mid):
    """A reference state carried across mid-run continues in the port as
    the reference's whole run; the port's own split and chunked runs equal
    its whole run, and the state passed in is left as it was."""
    _, _, fj, cj, ft, ct = with_cells
    cfg_t, ccfg_t, topo_t, sched_t, spec_t = with_cells[1]
    split, mid_j = mid
    mid_t = interop.mixed_state_from_numpy(_nested(mid_j), device="cpu")
    before = _flat(interop.to_numpy(mid_t))
    tail = sched_t.slice(split, KW["rounds"])
    end_t, curves_t = tm.simulate_mixed(cfg_t, ccfg_t, topo_t, tail, spec_t, seed=0,
                                        state=mid_t, device="cpu")
    _assert_curves_equal(cj, curves_t, start=split)
    _assert_state_equal(fj, end_t)
    after = _flat(interop.to_numpy(mid_t))
    assert all(np.array_equal(before[k], after[k]) for k in before)

    head_t, c1 = tm.simulate_mixed(cfg_t, ccfg_t, topo_t, sched_t.slice(0, split), spec_t,
                                   seed=0, device="cpu")
    end2, c2 = tm.simulate_mixed(cfg_t, ccfg_t, topo_t, tail, spec_t, seed=0, state=head_t,
                                 device="cpu")
    _assert_state_equal(fj, end2)
    for k in ct:
        assert np.array_equal(np.concatenate([c1[k], c2[k]]), ct[k]), k
    end3, c3 = tm.simulate_mixed(cfg_t, ccfg_t, topo_t, sched_t, spec_t, seed=0, max_chunk=10,
                                 device="cpu")
    _assert_state_equal(fj, end3)
    _assert_curves_equal(cj, c3)

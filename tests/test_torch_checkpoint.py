"""The ``corro-checkpoint/1`` format (``sim/checkpoint.py``) across
packages on the CPU: a checkpoint the reference saves loads in the port
and one the port saves loads in the reference, for states, schedules,
generic trees and sparse resume points, with the reference's paths,
leaf order and dtypes; a loaded state resumes a run equal to the
uninterrupted one; and the header checks raise the reference's messages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import chunks as jchunks
from corrosion_tpu.sim import checkpoint as jc
from corrosion_tpu.sim import engine as je
from corrosion_tpu.sim import mixed_engine as jm
from corrosion_tpu.sim import sparse_engine as js
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import chunks as tchunks
from corrosion_tpu_torch.sim import checkpoint as tc
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import mixed_engine as tm
from corrosion_tpu_torch.sim import sparse_engine as ts

torch.set_num_threads(1)

CHURN = dict(rounds=12, samples=8)
SPARSE = dict(n=48, w_hot=16, rounds=24, n_regions=4, epoch_rounds=8, cohort=5,
              burst_writes=1, samples=8, seed=0, k_dev=16)
MIXED = dict(n=64, streams=2, last_seq=255, rounds=6, samples=8)


def _leaves_equal(jtree, ttree):
    """Same paths, same reference dtypes, same values."""
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    jpaths = [jax.tree_util.keystr(p) for p, _ in flat]
    assert tc._paths(ttree) == jpaths == jc._paths(jtree)
    for (p, leaf), (_, tleaf, name) in zip(flat, tc._flatten(ttree)):
        a, b = np.asarray(leaf), tc._as_reference(tleaf, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), p


@pytest.fixture(scope="module")
def churn_states():
    jcfg, jtopo, jsched = jb.churn_32(**CHURN)
    tcfg, ttopo, tsched = tb.churn_32(**CHURN, device="cpu")
    jfinal, _ = je.simulate(jcfg, jtopo, jsched, seed=0)
    tfinal, _ = te.simulate(tcfg, ttopo, tsched, seed=0, device="cpu")
    return jcfg, jtopo, jsched, jfinal, tcfg, ttopo, tsched, tfinal


def test_state_crosses_both_ways(churn_states, tmp_path):
    jcfg, _, jsched, jfinal, tcfg, ttopo, tsched, tfinal = churn_states
    _leaves_equal(jfinal, tfinal)
    n = len(tsched.sample_writer)
    jc.save_state(str(tmp_path / "j.npz"), jfinal, fingerprint="fp", mesh_shape=(2, 4))
    loaded = tc.load_state(str(tmp_path / "j.npz"), tcfg, n, expect_fingerprint="fp",
                           device="cpu")
    _leaves_equal(jfinal, loaded)
    assert loaded.data.head.dtype == torch.int64 and loaded.swim.alive.dtype == torch.bool
    tc.save_state(str(tmp_path / "t.npz"), tfinal, fingerprint="fp", mesh_shape=(2, 4))
    back = jc.load_state(str(tmp_path / "t.npz"), jcfg, n, expect_fingerprint="fp")
    _leaves_equal(back, tfinal)
    assert tc.read_header(str(tmp_path / "t.npz")) == jc.read_header(str(tmp_path / "j.npz"))
    assert tc.read_header(str(tmp_path / "t.npz"))["round"] == 12
    # A resume from the loaded state equals the uninterrupted run.
    longer = dataclasses.replace(tsched, writes=np.concatenate([tsched.writes] * 2),
                                 kill=np.concatenate([tsched.kill] * 2),
                                 revive=np.concatenate([tsched.revive] * 2))
    whole, _ = te.simulate(tcfg, ttopo, longer, seed=0, device="cpu")
    resumed, _ = te.simulate(tcfg, ttopo, longer.slice(12, 24), seed=0, state=loaded,
                             device="cpu")
    _port_equal(whole, resumed)


def _port_equal(a, b):
    fa, fb = tc._flatten(a), tc._flatten(b)
    assert [p for p, _, _ in fa] == [p for p, _, _ in fb]
    for (p, x, _), (_, y, _) in zip(fa, fb):
        assert torch.equal(x, y), p


def test_schedule_crosses_both_ways(churn_states, tmp_path):
    jsched, tsched = churn_states[2], churn_states[6]
    lossy = dataclasses.replace(tsched, loss=np.full((12, 1), 0.25, np.float32),
                                probe_loss=np.linspace(0, 0.5, 12).astype(np.float32))
    jc.save_schedule(str(tmp_path / "j.npz"), jsched, fingerprint="a")
    tc.save_schedule(str(tmp_path / "t.npz"), lossy, fingerprint="a")
    got_t = tc.load_schedule(str(tmp_path / "j.npz"), expect_fingerprint="a")
    got_j = jc.load_schedule(str(tmp_path / "t.npz"), expect_fingerprint="a")
    for name in ("writes", "kill", "revive", "sample_writer", "sample_ver", "sample_round"):
        assert np.array_equal(getattr(got_t, name), getattr(jsched, name)), name
        assert np.array_equal(getattr(got_j, name), getattr(lossy, name)), name
    assert got_t.loss is None and got_t.partition is None and got_t.wipe is None
    assert np.array_equal(got_j.loss, lossy.loss)
    assert np.array_equal(got_j.probe_loss, lossy.probe_loss)


def test_trees_cross_both_ways(tmp_path):
    jargs, targs = jb.mixed_storm(**MIXED), tb.mixed_storm(**MIXED, device="cpu")
    jfinal, _ = jm.simulate_mixed(*jargs, seed=0)
    tfinal, _ = tm.simulate_mixed(*targs, seed=0, device="cpu")
    _leaves_equal(jfinal, tfinal)
    jc.save_tree(str(tmp_path / "j.npz"), jfinal, fingerprint="m", round_index=6)
    tc.save_tree(str(tmp_path / "t.npz"), tfinal, fingerprint="m", round_index=6)
    ttemplate = tm.init_mixed_state(*targs[:5], device="cpu")
    jtemplate = jm.init_mixed_state(*jargs[:5])
    _leaves_equal(jfinal, tc.load_tree(str(tmp_path / "j.npz"), ttemplate,
                                       expect_fingerprint="m"))
    _leaves_equal(jc.load_tree(str(tmp_path / "t.npz"), jtemplate, expect_fingerprint="m"),
                  tfinal)
    # A chunk-plane coverage tree, and a tuple of trees.
    ccfg, origin, last, _ = jb.anti_entropy_chunks(n=16, streams=2, last_seq=255, rounds=4)
    tcfg, torigin, tlast, _ = tb.anti_entropy_chunks(n=16, streams=2, last_seq=255, rounds=4,
                                                     device="cpu")
    jchunk = jchunks.init_chunks(ccfg, np.asarray(origin), np.asarray(last))
    tchunk = tchunks.init_chunks(tcfg, torigin, tlast, "cpu")
    pair_t, pair_j = (tchunk, tfinal.round), (jchunk, jfinal.round)
    tc.save_tree(str(tmp_path / "p.npz"), pair_t)
    _leaves_equal(jc.load_tree(str(tmp_path / "p.npz"), pair_j), pair_t)
    with pytest.raises(ValueError, match="tree checkpoint structure does not match the template"):
        tc.load_tree(str(tmp_path / "p.npz"), ttemplate)


def test_sparse_resume_crosses_both_ways(tmp_path):
    jargs, targs = jb.anywrite_sparse(**SPARSE), tb.anywrite_sparse(**SPARSE, device="cpu")
    jcfg, _, jsched = jargs
    tcfg, _, tsched = targs
    *_, jinfo = js.simulate_sparse(*jargs, seed=0, stop_after_epoch=0)
    *_, tinfo = ts.simulate_sparse(*targs, seed=0, stop_after_epoch=0, device="cpu")
    jres, tres = jinfo["resume"], tinfo["resume"]
    _leaves_equal((jres["sstate"], jres["swim"], jres["vis_round"]),
                  (tres["sstate"], tres["swim"], tres["vis_round"]))
    lossy = dataclasses.replace(tsched, loss=np.full((24, 4), 0.1, np.float32))
    jc.save_sparse_resume(str(tmp_path / "j.npz"), jres, jsched, fingerprint="s")
    tc.save_sparse_resume(str(tmp_path / "t.npz"), tres, lossy, fingerprint="s")
    n = len(tsched.sample_writer)
    got = tc.load_sparse_resume(str(tmp_path / "j.npz"), tcfg, n, expect_fingerprint="s",
                                device="cpu")
    jgot = jc.load_sparse_resume(str(tmp_path / "t.npz"), jcfg, n, expect_fingerprint="s")
    for res_j, res_t in ((jres, got), (jgot, tres)):
        _leaves_equal((res_j["sstate"], res_j["swim"], res_j["vis_round"]),
                      (res_t["sstate"], res_t["swim"], res_t["vis_round"]))
        assert res_j["next_epoch"] == res_t["next_epoch"] == 1
        assert res_j["planner"].keys() == res_t["planner"].keys()
        for k in res_j["planner"]:
            assert np.array_equal(res_j["planner"][k], res_t["planner"][k]), k
    assert got["faults"] == {} and set(jgot["faults"]) == {"loss"}
    # The loaded resume point finishes the run as the uninterrupted one.
    whole = ts.simulate_sparse(*targs, seed=0, device="cpu")
    rest = ts.simulate_sparse(*targs, seed=0, resume=got, device="cpu")
    _port_equal(whole[:3], rest[:3])
    with_faults = tc.attach_resume_faults(tsched, tc.load_sparse_resume(
        str(tmp_path / "t.npz"), tcfg, n, device="cpu"))
    assert np.array_equal(with_faults.loss, lossy.loss)
    assert tc.attach_resume_faults(tsched, got) is tsched
    with pytest.raises(ValueError, match="already carries a different 'loss'"):
        tc.attach_resume_faults(dataclasses.replace(tsched, loss=lossy.loss * 2), jgot)
    with pytest.raises(ValueError, match="unknown persisted fault axis"):
        tc.attach_resume_faults(tsched, {"faults": {"bogus": lossy.loss}})


def _messages(mod, path, **kw):
    try:
        mod.load_schedule(path, **kw)
    except ValueError as e:
        return str(e)
    return None


def test_header_checks_raise_the_reference_s_messages(churn_states, tmp_path):
    jsched, tsched = churn_states[2], churn_states[6]
    p = str(tmp_path / "s.npz")
    tc.save_schedule(p, tsched, fingerprint="abc")
    for kw in ({"expect_fingerprint": "other"}, {"expect_fingerprint": "abc"}, {}):
        assert _messages(tc, p, **kw) == _messages(jc, p, **kw)
    assert "does not match the running config 'other'" in _messages(
        tc, p, expect_fingerprint="other")
    # Wrong kind: a schedule through the state loader.
    cfg, tcfg = churn_states[0], churn_states[4]
    for mod, c in ((tc, tcfg), (jc, cfg)):
        kw = {"device": "cpu"} if mod is tc else {}
        with pytest.raises(ValueError, match="checkpoint kind 'schedule' is not 'state'"):
            mod.load_state(p, c, 8, **kw)
    # Unknown schema, and no header at all.
    data = dict(np.load(p))
    data["__header__"] = np.array(b'{"schema": "corro-checkpoint/9", "kind": "schedule"}')
    np.savez(str(tmp_path / "v9.npz"), **data)
    del data["__header__"]
    np.savez(str(tmp_path / "v0.npz"), **data)
    for name, kw in (("v9.npz", {}), ("v0.npz", {"expect_fingerprint": "abc"})):
        q = str(tmp_path / name)
        assert _messages(tc, q, **kw) == _messages(jc, q, **kw) is not None
    assert tc.read_header(str(tmp_path / "v0.npz")) is None
    assert tc.load_schedule(str(tmp_path / "v0.npz")).rounds == 12
    # A state from another config: the structure check names it.
    small = dataclasses.replace(tcfg, swim=dataclasses.replace(tcfg.swim, view_capacity=8))
    tc.save_state(str(tmp_path / "st.npz"), churn_states[7])
    n = len(tsched.sample_writer)
    with pytest.raises(ValueError, match="different SwimConfig/GossipConfig"):
        tc.load_state(str(tmp_path / "st.npz"), small, n, device="cpu")
    with pytest.raises(ValueError, match=rf"leaf \.vis_round has shape \({n}, 32\), config implies"):
        tc.load_state(str(tmp_path / "st.npz"), tcfg, n + 3, device="cpu")

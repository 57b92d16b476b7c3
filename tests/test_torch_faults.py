"""The port's own copy of the fault-plan module (``sim/faults.py``) against
the reference's: the named scenarios, random plans and their lowering at
several seeds and shapes, ``apply_plan`` onto each package's Schedule,
``shrink_plan`` under one predicate, ``axes_from_rates``, the JSON form
and the refusals — equal field for field and array for array.
"""

import numpy as np
import pytest

from corrosion_tpu.sim import engine as je
from corrosion_tpu.sim import faults as jf
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import faults as tf

ARRAYS = ("loss", "probe_loss", "partition", "kill", "revive", "wipe")


def _assert_compiled_equal(a, b):
    assert (a.rounds, a.heal_round, a.heals) == (b.rounds, b.heal_round, b.heals)
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    ls_a, ls_b = a.loss_scalar, b.loss_scalar
    assert (ls_a is None) == (ls_b is None)
    if ls_a is not None:
        assert np.array_equal(ls_a, ls_b)
    if a.kill is not None:
        assert np.array_equal(a.alive_curve(a.kill.shape[1]), b.alive_curve(b.kill.shape[1]))


def _assert_plan_equal(a, b):
    assert a.to_dict() == b.to_dict() and a.to_json() == b.to_json()
    assert a.describe() == b.describe()
    assert (a.heals, a.heal_round, a.max_region(), a.wipes(), a.killed_forever(),
            a.preempt_events()) == (b.heals, b.heal_round, b.max_region(), b.wipes(),
                                    b.killed_forever(), b.preempt_events())


@pytest.mark.parametrize("rounds,regions,nodes", [(24, 2, 24), (48, 4, 48), (120, 8, 300)])
def test_named_scenarios_match_reference(rounds, regions, nodes):
    protect = (0, 3, 5)
    pj = jf.named_scenarios(rounds, regions, nodes, protect=protect)
    pt = tf.named_scenarios(rounds, regions, nodes, protect=protect)
    assert pj.keys() == pt.keys()
    for name in pj:
        _assert_plan_equal(pj[name], pt[name])
        _assert_compiled_equal(pj[name].compile(nodes, regions), pt[name].compile(nodes, regions))
        _assert_compiled_equal(pj[name].compile(nodes, regions, allow_wipe=False),
                               pt[name].compile(nodes, regions, allow_wipe=False))


@pytest.mark.parametrize("seed", range(6))
def test_random_plans_match_reference(seed):
    for kw in ({}, {"max_faults": 5, "allow_wipe": False}, {"break_heal": True}):
        pj = jf.random_plan(np.random.default_rng(seed), 64, 4, 96, protect=(1, 2), **kw)
        pt = tf.random_plan(np.random.default_rng(seed), 64, 4, 96, protect=(1, 2), **kw)
        _assert_plan_equal(pj, pt)
        _assert_compiled_equal(pj.compile(96, 4), pt.compile(96, 4))
        back = tf.FaultPlan.from_json(pt.to_json())
        assert back == pt


def test_apply_plan_onto_each_schedule_matches_reference():
    g = np.random.default_rng(0)
    rounds, n, regions = 40, 32, 4
    writes = (g.random((rounds, 8)) < 0.2).astype(np.uint32)
    kill = np.zeros((rounds, n), bool)
    kill[3, 7] = True
    part = np.zeros((rounds, regions, regions), bool)
    part[10:12, 1, 2] = True
    loss = np.full((rounds, regions), 0.1, np.float32)
    plans_j = jf.named_scenarios(rounds, regions, n)
    plans_t = tf.named_scenarios(rounds, regions, n)
    for name, pj in plans_j.items():
        pt = plans_t[name]
        for extra in ({}, {"kill": kill, "revive": np.zeros_like(kill), "partition": part,
                          "loss": loss}):
            sj = je.Schedule(writes=writes, **extra).make_samples(16)
            st = te.Schedule(writes=writes, **extra).make_samples(16)
            aj = jf.apply_plan(sj, pj, n, regions)
            at = tf.apply_plan(st, pt, n, regions)
            assert isinstance(at, te.Schedule)
            for f in ("writes", "kill", "revive", "partition", "sample_writer", "sample_ver",
                      "sample_round", "loss", "probe_loss", "wipe"):
                x, y = getattr(aj, f), getattr(at, f)
                assert (x is None) == (y is None), (name, f)
                if x is not None:
                    assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
    with pytest.raises(ValueError, match="rounds"):
        tf.apply_plan(te.Schedule(writes=writes[:5]), pt, n, regions)


def test_shrink_plan_matches_reference():
    def fails(plan):
        # Fails while a partition of region 0 covers round 20 and some
        # churn remains.
        cut = any(f.kind == "partition" and 0 in f.a and f.start <= 20 < f.stop
                  for f in plan.faults)
        return cut and any(f.kind == "churn" for f in plan.faults)

    for seed in range(4):
        pj = jf.random_plan(np.random.default_rng(seed), 64, 4, 96, max_faults=5,
                            break_heal=True)
        pt = tf.random_plan(np.random.default_rng(seed), 64, 4, 96, max_faults=5,
                            break_heal=True)
        pj = jf.FaultPlan(pj.rounds, pj.faults + (jf.Fault("churn", 3, 4, nodes=(4, 9, 11),
                                                          revive_at=30),))
        pt = tf.FaultPlan(pt.rounds, pt.faults + (tf.Fault("churn", 3, 4, nodes=(4, 9, 11),
                                                          revive_at=30),))
        (mj, ej), (mt, et) = jf.shrink_plan(pj, fails), tf.shrink_plan(pt, fails)
        assert ej == et
        _assert_plan_equal(mj, mt)


def test_axes_from_rates_and_refusals_match_reference():
    for kw in ({}, {"loss_by_region": [0.0, 0.2, 0.0]}, {"probe_loss": 0.3},
               {"loss_by_region": np.full((12, 2), 0.05), "probe_loss": 1e-12},
               {"loss_by_region": [1e-12, 0.0]}):
        _assert_compiled_equal(jf.axes_from_rates(12, **kw), tf.axes_from_rates(12, **kw))
    for mod in (jf, tf):
        with pytest.raises(ValueError):
            mod.Fault("loss", 3, 2, prob=0.1)
        with pytest.raises(ValueError):
            mod.Fault("flap", 0, 4, a=(0,))
        with pytest.raises(ValueError):
            mod.FaultPlan(10, (mod.Fault("loss", 0, 12, prob=0.5),))
        with pytest.raises(ValueError):
            mod.FaultPlan(10, (mod.Fault("churn", 2, 3, nodes=(1,)),)).compile(1, 1)
        with pytest.raises(ValueError):
            mod.axes_from_rates(12, loss_by_region=np.full((11, 2), 0.1))
    pre = tf.FaultPlan(10, (tf.Fault("preempt", 4, 5, device=1), tf.Fault("loss", 0, 3, prob=0.2)))
    assert pre.preempt_events() == ((4, 1),) and len(pre.kernel_plan().faults) == 1
    assert pre.compile(4, 1).loss is not None

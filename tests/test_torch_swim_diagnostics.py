"""The SWIM diagnostics of both membership kernels against the live JAX
reference on the CPU: ``accuracy`` (to 1e-6 relative: XLA's float32
division is reciprocal-based, torch's exact), ``mismatches`` exactly,
``beliefs_about`` and ``state_bytes_per_node``, on states the reference
reached under churn and carried over through ``interop``.
"""

import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import swim as jswim
from corrosion_tpu.ops import swim_sparse as jss
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.ops import swim as tswim
from corrosion_tpu_torch.ops import swim_sparse as tss

torch.set_num_threads(1)


def _nested(tree):
    if hasattr(tree, "_fields"):
        return {k: _nested(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def states():
    """Reference states mid-churn and after it: dense SWIM (churn_32) and
    the sparse exception tables (a small wan_100k with churn)."""
    out = {}
    cfg, topo, sched = jb.churn_32(rounds=60, samples=8)
    for stop in (25, 60):
        final, _ = je.simulate(cfg, topo, sched.__class__(
            writes=sched.writes[:stop], kill=sched.kill[:stop], revive=sched.revive[:stop]))
        out[f"dense{stop}"] = final.swim
    wcfg, wtopo, wsched = jb.wan_100k(n=120, n_regions=4, n_writers=8, rounds=30, samples=8)
    g = np.random.default_rng(0)
    kill = np.zeros((30, 120), bool)
    revive = np.zeros((30, 120), bool)
    victims = g.choice(np.arange(8, 120), 10, replace=False)
    kill[5, victims[:6]] = True
    revive[20, victims[:2]] = True
    kill[27, victims[6:]] = True  # still being detected at the end
    wsched.kill, wsched.revive = kill, revive
    final, _ = je.simulate(wcfg, wtopo, wsched)
    out["sparse"] = final.swim
    return out


@pytest.mark.parametrize("name", ["dense25", "dense60", "sparse"])
def test_accuracy_mismatches_and_beliefs_equal_the_reference(states, name):
    js = states[name]
    jmod, tmod = (jss, tss) if name == "sparse" else (jswim, tswim)
    ts = interop._swim_state(_nested(js), torch.device("cpu"))
    assert int(tmod.mismatches(ts)) == int(jmod.mismatches(js))
    a, b = float(jmod.accuracy(js)), tmod.accuracy(ts)
    assert b.dtype == torch.float32
    assert float(b) == pytest.approx(a, rel=1e-6)
    assert 0.0 < a <= 1.0
    if name == "sparse":
        assert int(jss.mismatches(js)) > 0
        for target in (0, 7, 50, 119):
            assert np.array_equal(np.asarray(jss.beliefs_about(js, target)),
                                  tss.beliefs_about(ts, target).numpy())


def test_accuracy_of_fresh_and_all_dead_states():
    for n, cap in ((5, 0), (7, 4)):
        jcfg = jswim.SwimConfig(n_nodes=n, view_capacity=cap)
        tcfg = tswim.SwimConfig(n_nodes=n, view_capacity=cap)
        js = jswim.impl(jcfg).init_state(jcfg)
        ts = tswim.impl(tcfg).init_state(tcfg, "cpu")
        assert float(tswim.impl(tcfg).accuracy(ts)) == float(jswim.impl(jcfg).accuracy(js)) == 1.0
        dead_j = js._replace(alive=js.alive & False)
        dead_t = ts._replace(alive=ts.alive & False)
        assert float(tswim.impl(tcfg).accuracy(dead_t)) == float(jswim.impl(jcfg).accuracy(dead_j))


@pytest.mark.parametrize("kw", [{}, dict(view_capacity=64), dict(view_capacity=16, timers=4,
                                                                  backlog=32)])
def test_state_bytes_per_node_equals_the_reference(kw):
    assert tss.state_bytes_per_node(tswim.SwimConfig(n_nodes=10, **kw)) == \
           jss.state_bytes_per_node(jswim.SwimConfig(n_nodes=10, **kw))

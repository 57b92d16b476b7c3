"""Whole-run parity of merge_10k, the wide-writer flagship: the port's
``simulate`` equals the JAX reference bit for bit — every round curve and
every final-state leaf — on ``merge_10k(n=64, rounds=40, samples=64)``.

At n = 64 the writer axis is narrow, so both packages are forced onto the
paths the full size takes (``_FAST_MAX_WRITERS = 0`` in both, and the
reference's ``_BLOCK_ENUM_MIN_WRITERS = 1``), with JAX's caches cleared
around the forcing. At merge_10k's 1% write rate the out-of-order window
never opens at this size, so a burst variant (2 versions per writer per
round for rounds 0-11) drives the window: the test reads ``oo_any``
between 2-round chunks and counts the legacy window's gather and row-sum
calls.
"""

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.ops import onehot as to
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import telemetry as tt

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

KW = dict(n=64, rounds=40, samples=64)


@pytest.fixture(scope="module")
def wide_paths():
    saved = (jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS)
    jax.clear_caches()
    jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        yield
    finally:
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = saved
        jax.clear_caches()


def _burst(sched, schedule_cls):
    """Two versions per writer per round for rounds 0-11, resampled."""
    writes = sched.writes.copy()
    writes[:12, :] = 2
    return schedule_cls(writes=writes).make_samples(KW["samples"])


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_run_equal(final_j, curves_j, final_t, curves_t):
    assert set(curves_t) == set(tt.ROUND_CURVE_KEYS) == set(curves_j)
    bad = [
        k for k in curves_j
        if not (curves_j[k].dtype == curves_t[k].dtype
                and np.array_equal(curves_j[k], curves_t[k]))
    ]
    a, b = _flat(final_j), _flat(interop.to_numpy(final_t))
    assert a.keys() == b.keys()
    bad += [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"port differs from the reference in {bad}"


def test_merge_10k_run_matches_reference(wide_paths):
    cj, topo_j, sched_j = jb.merge_10k(**KW)
    ct, topo_t, sched_t = tb.merge_10k(device="cpu", **KW)
    assert np.array_equal(sched_j.writes, sched_t.writes)
    final_j, curves_j = je.simulate(cj, topo_j, sched_j, seed=0)
    final_t, curves_t = te.simulate(ct, topo_t, sched_t, seed=0, device="cpu")
    assert curves_j["cell_merges"].sum() > 0 and curves_j["applied_sync"].sum() > 0
    assert curves_j["need"][-1] == 0
    _assert_run_equal(final_j, curves_j, final_t, curves_t)


def test_merge_10k_burst_opens_the_window(wide_paths, monkeypatch):
    cj, topo_j, sched_j = jb.merge_10k(**KW)
    ct, topo_t, sched_t = tb.merge_10k(device="cpu", **KW)
    sched_j = _burst(sched_j, je.Schedule)
    sched_t = _burst(sched_t, te.Schedule)
    calls = {"rowgather_wide": 0, "rowsum": 0}
    for name in calls:
        fn = getattr(to, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(to, name, counted)
    final_j, curves_j = je.simulate(cj, topo_j, sched_j, seed=0)
    state, parts, oo_open = None, [], []
    for start in range(0, KW["rounds"], 2):
        state, c = te.simulate(
            ct, topo_t, sched_t.slice(start, start + 2), seed=0, state=state,
            device="cpu",
        )
        parts.append(c)
        oo_open.append(bool(state.data.oo_any))
    curves_t = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    assert any(oo_open), "the out-of-order window never opened"
    assert curves_j["sync_regrant"].sum() > 0 and curves_j["need"][-1] == 0
    # Every round gathers the base watermarks; window rounds gather the
    # old words and sum the new ones.
    assert calls["rowsum"] > 0 and calls["rowgather_wide"] > KW["rounds"]
    _assert_run_equal(final_j, curves_j, state, curves_t)

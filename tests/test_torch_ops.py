"""One broadcast round, one sync round and sparse-SWIM rounds of the port
against the JAX reference, both started from one state.

The shared state is a mid-run state of a shrunken wan_100k (lossy, so
the out-of-order window is live), carried into the reference through
``corrosion_tpu_torch.interop``. Every output leaf and stat must be
bit-equal. The JAX side runs its CPU-default native backend.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import crdt as jcrdt
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu.ops import routing as jr
from corrosion_tpu.ops import swim_sparse as jss
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.ops import routing as tr
from corrosion_tpu_torch.ops import swim_sparse as tss
from corrosion_tpu_torch.sim import engine as te

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

SMALL = dict(n=160, n_regions=4, n_writers=24, rounds=30, samples=16)


def _configs(**gossip_kw):
    cj, topo_j, sched = jb.wan_100k(**SMALL)
    ct, topo_t, sched_t = tb.wan_100k(device="cpu", **SMALL)
    cj = dataclasses.replace(cj, gossip=dataclasses.replace(cj.gossip, **gossip_kw))
    ct = dataclasses.replace(ct, gossip=dataclasses.replace(ct.gossip, **gossip_kw))
    return cj, topo_j, sched, ct, topo_t


def _mid_state(ct, topo_t, sched, rounds=20):
    """A port state after ``rounds`` rounds of a heavy write load (most
    writers commit 1-2 versions a round), so lossy configs leave gaps
    and live window bits behind. Cached per (gossip config, rounds)."""
    key = (ct.gossip, rounds)
    if key not in _MID_STATES:
        _MID_STATES[key] = _run_mid_state(ct, topo_t, rounds)
    return _MID_STATES[key]


_MID_STATES: dict = {}


def _run_mid_state(ct, topo_t, rounds):
    g = np.random.default_rng(rounds)
    writes = (g.random((rounds, ct.gossip.n_writers)) < 0.6) * g.integers(
        1, 3, (rounds, ct.gossip.n_writers)
    )
    part = te.Schedule(writes=writes.astype(np.uint32)).make_samples(16)
    final, _ = te.simulate(ct, topo_t, part, seed=3, device="cpu")
    return final


def _jax_tree(cls, d):
    """Reference NamedTuple from the port's numpy dict."""
    return cls(**{
        k: (jnp.asarray(v) if not isinstance(v, dict) else v) for k, v in d.items()
    })


def _to_jax_data(d):
    cells = _jax_tree(jcrdt.CellState, d["cells"])
    return jg.DataState(cells=cells, **{
        k: jnp.asarray(v) for k, v in d.items() if k != "cells"
    })


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _assert_equal(jax_tree, port_tree):
    a = _flat(jax_tree)
    b = _flat(interop.to_numpy(port_tree))
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), b[k]
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _assert_stats(js, ts):
    assert js.keys() == ts.keys()
    for k in js:
        assert int(np.asarray(js[k]).astype(np.int64)) == int(ts[k]), k


def _round_inputs(cj, topo_j, seed):
    g = np.random.default_rng(seed)
    r = int(np.asarray(topo_j.region).max()) + 1
    writes = g.integers(0, 3, cj.gossip.n_writers).astype(np.uint32)
    part = np.zeros((r, r), bool)
    part[0, 1:] = part[1:, 0] = True  # region 0 cut off, as wan_100k does
    return writes, part


def test_topology_and_schedule_match_reference():
    cj, topo_j, sched, ct, topo_t = _configs()
    _, _, sched_t = tb.wan_100k(device="cpu", **SMALL)
    assert dataclasses.asdict(cj.gossip) == dataclasses.asdict(ct.gossip)
    assert dataclasses.asdict(cj.swim) == dataclasses.asdict(ct.swim)
    for f in jg.Topology._fields:
        a, b = getattr(topo_j, f), getattr(topo_t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), f
    for f in ("writes", "partition", "sample_writer", "sample_ver", "sample_round"):
        assert np.array_equal(getattr(sched, f), getattr(sched_t, f)), f
    # interop's topology path reproduces the port's own builder.
    via = interop.topology_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in topo_j._asdict().items()},
        device="cpu",
    )
    for f in tg.Topology._fields:
        a, b = getattr(via, f), getattr(topo_t, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize(
    "window_k,n_cells,loss,queue",
    [
        (0, 0, 0.0, 48), (0, 256, 0.2, 48), (32, 0, 0.2, 48),
        (32, 256, 0.0, 48), (32, 256, 0.2, 48), (64, 64, 0.3, 48),
        # queue=4: kk = 12 < window, so far-ahead copies clamp to the
        # sentinel delta and the degraded count's version dedup matters.
        (32, 64, 0.3, 4), (0, 64, 0.3, 4),
    ],
)
def test_broadcast_round(window_k, n_cells, loss, queue):
    cj, topo_j, sched, ct, topo_t = _configs(
        window_k=window_k, n_cells=n_cells, loss_prob=loss, queue=queue
    )
    st = _mid_state(ct, topo_t, sched, rounds=20 if queue > 4 else 40)
    if window_k and loss:
        assert bool(st.data.oo_any), "the window path must be live"
    data = st.data
    if queue == 4:
        # Every fifth node restarts from empty: its arrivals run far
        # ahead of its watermark, past both the run and the window.
        lag = torch.zeros(ct.n_nodes, dtype=torch.bool)
        lag[::5] = True
        data = data._replace(
            contig=torch.where(lag[:, None], 0, data.contig),
            seen=torch.where(lag[:, None], 0, data.seen),
            oo=torch.where(lag[None, :, None], 0, data.oo),
        )
    data_j = _to_jax_data(interop.to_numpy(data))
    alive = np.ones(ct.n_nodes, bool)
    alive[::17] = False
    writes, part = _round_inputs(cj, topo_j, window_k + n_cells)
    # A chaos-plane per-region loss schedule on top of the config's loss
    # (the two compose as independent processes).
    dyn = np.array([0.0, 0.5, 0.1, 0.25], np.float32) if loss else None
    out_j, stats_j = jg.broadcast_round(
        data_j, topo_j, jnp.asarray(alive), jnp.asarray(part),
        jnp.asarray(writes), jax.random.PRNGKey(11), cj.gossip,
        loss=None if dyn is None else jnp.asarray(dyn),
    )
    out_t, stats_t = tg.broadcast_round(
        data, topo_t, torch.as_tensor(alive), torch.as_tensor(part),
        torch.as_tensor(writes.astype(np.int64)), trng.PRNGKey(11), ct.gossip,
        loss=None if dyn is None else torch.as_tensor(dyn),
    )
    _assert_equal(out_j, out_t)
    _assert_stats(stats_j, stats_t)
    if queue == 4:
        assert int(stats_j["window_degraded"]) > 0


@pytest.mark.parametrize("sync_budget", [512, 256, 255, 64])
def test_digest_quantize_saturation(sync_budget):
    defc = np.arange(0, 600, dtype=np.uint32)
    want = np.asarray(jg._digest_score(jnp.asarray(defc), sync_budget))
    got = tg._digest_score(torch.as_tensor(defc.astype(np.int64)), sync_budget)
    assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.fixture
def digest_mode(monkeypatch):
    """Force digest scoring in both packages (the 100k regime)."""
    monkeypatch.setattr(jg, "_EXACT_SCORE_MAX", 0)
    monkeypatch.setattr(tg, "_EXACT_SCORE_MAX", 0)
    jg.sync_round.clear_cache()
    yield
    jg.sync_round.clear_cache()


def _sync_case(sync_budget, round_idx):
    cj, topo_j, sched, ct, topo_t = _configs(loss_prob=0.2, sync_budget=sync_budget)
    st = _mid_state(ct, topo_t, sched)
    assert bool(st.data.oo_any), "the window absorb path must be live"
    data_j = _to_jax_data(interop.to_numpy(st.data))
    alive = np.ones(ct.n_nodes, bool)
    alive[5::23] = False
    _, part = _round_inputs(cj, topo_j, 1)
    out_j, stats_j = jg.sync_round(
        data_j, topo_j, jnp.asarray(alive), jnp.asarray(part),
        jnp.int32(round_idx), jax.random.PRNGKey(5), cj.gossip,
    )
    out_t, stats_t = tg.sync_round(
        st.data, topo_t, torch.as_tensor(alive), torch.as_tensor(part),
        torch.tensor(round_idx), trng.PRNGKey(5), ct.gossip,
    )
    assert int(stats_j["applied_sync"]) > 0
    _assert_equal(out_j, out_t)
    _assert_stats(stats_j, stats_t)


@pytest.mark.parametrize("round_idx", [20, 23])
def test_sync_round_exact(round_idx):
    _sync_case(512, round_idx)


@pytest.mark.parametrize("sync_budget", [512, 256, 64])
def test_sync_round_digest(digest_mode, sync_budget):
    # 512: i32 passthrough (wan_100k); <= 256: the bf16-quantized digest.
    _sync_case(sync_budget, 21)


@pytest.mark.parametrize("down_gc_rounds", [0, 3])
def test_swim_sparse_rounds(down_gc_rounds):
    cj, topo_j, sched, ct, topo_t = _configs()
    cj = dataclasses.replace(cj, swim=dataclasses.replace(cj.swim, down_gc_rounds=down_gc_rounds))
    ct = dataclasses.replace(ct, swim=dataclasses.replace(ct.swim, down_gc_rounds=down_gc_rounds))
    st = _mid_state(ct, topo_t, sched, rounds=4)
    dead = np.zeros(ct.n_nodes, bool)
    dead[::9] = True  # probes to dead nodes: suspicion, timers, downs
    sw_t = st.swim._replace(alive=torch.as_tensor(~dead))
    sw_j = _jax_tree(jss.SparseSwimState, interop.to_numpy(sw_t))
    for r in range(4, 14):
        kj = jax.random.fold_in(jax.random.PRNGKey(9), r)
        kt = trng.fold_in(trng.PRNGKey(9), r)
        # Odd rounds lose probe/acks (the chaos plane's probe_loss).
        pl = 0.3 if r % 2 else None
        sw_j = jss.swim_round(
            sw_j, kj, jnp.int32(r), cj.swim,
            probe_loss=None if pl is None else jnp.float32(pl),
        )
        sw_t = tss.swim_round(
            sw_t, kt, torch.tensor(r), ct.swim,
            probe_loss=None if pl is None else torch.tensor(pl, dtype=torch.float32),
        )
        _assert_equal(sw_j, sw_t)
        assert int(jss.mismatches(sw_j)) == int(tss.mismatches(sw_t))
        fa_j, ud_j = jss.health_counts(sw_j)
        fa_t, ud_t = tss.health_counts(sw_t)
        assert (int(fa_j), int(ud_j)) == (int(fa_t), int(ud_t))
    # The storm really exercised the tables: downs were declared.
    assert int(np.asarray(jss.health_counts(sw_j)[1])) < int(dead.sum()) * int((~dead).sum())


def test_bounded_intake():
    g = np.random.default_rng(2)
    m, n, k = 200, 17, 4
    recv = g.integers(0, n, m).astype(np.int32)
    valid = g.random(m) < 0.8
    pay = g.integers(0, 1 << 31, m).astype(np.uint32)
    mj, (pj,) = jr.bounded_intake(
        jnp.asarray(recv), jnp.asarray(valid), (jnp.asarray(pay),), n, k
    )
    mt, (pt,) = tr.bounded_intake(
        torch.as_tensor(recv.astype(np.int64)), torch.as_tensor(valid),
        (torch.as_tensor(pay.astype(np.int64)),), n, k,
    )
    assert np.array_equal(np.asarray(mj), mt.numpy())
    assert np.array_equal(np.asarray(pj).astype(np.int64), pt.numpy())


def test_staleness_sum_past_float32_integer_range():
    """Past 2^24 the reference's float32 sum depends on its reduction
    order; the port's sum is the exact total of the reference's per-node
    lags, rounded once to float32."""
    cj, topo_j, sched, ct, topo_t = _configs()
    data = _mid_state(ct, topo_t, sched, rounds=3).data
    n, w = data.contig.shape
    g = np.random.default_rng(7)
    head = g.integers(1 << 19, 1 << 20, w).astype(np.uint32)
    contig = (head[None, :].astype(np.int64) - g.integers(-8, 1 << 19, (n, w))).clip(0)
    contig = contig.astype(np.uint32)
    ts, tm = tg.staleness(data._replace(
        head=torch.as_tensor(head.astype(np.int64)),
        contig=torch.as_tensor(contig.astype(np.int64)),
    ))
    head_j, contig_j = jnp.asarray(head), jnp.asarray(contig)
    # The reference's node_lag, row by row: a one-node cluster's max lag.
    node_lag = np.asarray(jax.vmap(
        lambda c: jg.staleness(types.SimpleNamespace(head=head_j, contig=c[None]))[1]
    )(contig_j))
    total = node_lag.astype(np.float64).sum()
    assert total > 2**24
    assert ts.dtype == torch.float32 and np.float32(ts.item()) == np.float32(total)
    _, jm = jg.staleness(types.SimpleNamespace(head=head_j, contig=contig_j))
    assert int(tm) == int(np.asarray(jm)) == int(node_lag.max())


def test_cluster_state_round_trip():
    cj, topo_j, sched, ct, topo_t = _configs()
    st = _mid_state(ct, topo_t, sched, rounds=3)
    d = interop.to_numpy(st)
    back = interop.cluster_state_from_numpy(d, device="cpu")
    assert _flat(interop.to_numpy(back)).keys() == _flat(d).keys()
    for k, v in _flat(interop.to_numpy(back)).items():
        assert np.array_equal(v, _flat(d)[k]) and v.dtype == _flat(d)[k].dtype
    # The dict is exactly the reference's state layout.
    ref = je.init_cluster(cj, 16)
    ref_flat = _flat(ref)
    assert ref_flat.keys() == _flat(d).keys()
    for k in ref_flat:
        assert np.asarray(ref_flat[k]).dtype == _flat(d)[k].dtype, k

"""The legacy sort+scatter delivery and the wide-writer sync enumeration of
the port against the JAX reference, both started from one state.

Both packages are forced onto the wide-writer paths at a small size:
``_FAST_MAX_WRITERS = 0`` in both (legacy delivery) and, in the
reference, ``_BLOCK_ENUM_MIN_WRITERS = 1`` (its MXU block grant
enumeration; the port has one enumeration form for every width). The
reference reads both at trace time, so the fixture clears JAX's caches
before and after and restores the values even on failure. The shared
state is a lossy mid-run state of a shrunken merge_10k carried through
``corrosion_tpu_torch.interop``; every output leaf and stat must be
bit-equal.

Also: the configs of the wide-writer and legacy-intake paths construct,
and their state is sized as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import crdt as jcrdt
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.sim import engine as te

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

SMALL = dict(n=64, rounds=30, samples=16)


@pytest.fixture
def wide_paths():
    saved = (jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS)
    jax.clear_caches()
    jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        yield
    finally:
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = saved
        jax.clear_caches()


def _configs(**gossip_kw):
    cj, topo_j, _ = jb.merge_10k(**SMALL)
    ct, topo_t, _ = tb.merge_10k(device="cpu", **SMALL)
    cj = dataclasses.replace(cj, gossip=dataclasses.replace(cj.gossip, **gossip_kw))
    ct = dataclasses.replace(ct, gossip=dataclasses.replace(ct.gossip, **gossip_kw))
    return cj, topo_j, ct, topo_t


_MID_STATES: dict = {}


def _mid_state(ct, topo_t, rounds=16):
    """A port state after ``rounds`` rounds in which most writers commit
    1-2 versions a round (lossy configs leave gaps and live window bits
    behind). Cached per gossip config."""
    if ct.gossip not in _MID_STATES:
        g = np.random.default_rng(rounds)
        w = ct.gossip.n_writers
        writes = (g.random((rounds, w)) < 0.6) * g.integers(1, 3, (rounds, w))
        sched = te.Schedule(writes=writes.astype(np.uint32)).make_samples(16)
        final, _ = te.simulate(ct, topo_t, sched, seed=3, device="cpu")
        _MID_STATES[ct.gossip] = final
    return _MID_STATES[ct.gossip]


def _to_jax_data(d):
    cells = jcrdt.CellState(**{k: jnp.asarray(v) for k, v in d["cells"].items()})
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


def _cut(n_regions):
    part = np.zeros((n_regions, n_regions), bool)
    part[0, 1:] = part[1:, 0] = True
    return part


@pytest.mark.parametrize(
    "window_k,n_cells,fresh,stale,loss",
    [
        (0, 0, True, False, 0.0),
        (32, 0, True, False, 0.0),
        (0, 64, True, False, 0.3),
        (32, 64, True, False, 0.3),
        (32, 64, False, False, 0.3),  # inherited tx - 1 budgets
        (32, 0, False, True, 0.3),  # stale re-admission
        (64, 64, False, True, 0.3),
    ],
)
def test_legacy_broadcast_round(wide_paths, window_k, n_cells, fresh, stale, loss):
    cj, topo_j, ct, topo_t = _configs(
        window_k=window_k, n_cells=n_cells, loss_prob=loss,
        rebroadcast_fresh_budget=fresh, rebroadcast_stale=stale,
    )
    data = _mid_state(ct, topo_t).data
    if window_k and loss:
        assert bool(data.oo_any), "the window path must be live"
    g = np.random.default_rng(window_k + n_cells + 2 * fresh + stale)
    # Every fifth node restarts from empty, so most arrivals are first
    # receipts there, and queued budgets are spread over 1..max, so those
    # receipts come in duplicate copies with different budgets: the sort
    # must put the highest budget first for the intake to inherit it.
    lag = torch.zeros(ct.n_nodes, dtype=torch.bool)
    lag[::5] = True
    tx = torch.as_tensor(g.integers(1, ct.gossip.max_transmissions + 1, data.q_tx.shape))
    data = data._replace(
        contig=torch.where(lag[:, None], 0, data.contig),
        seen=torch.where(lag[:, None], 0, data.seen),
        oo=torch.where(lag[None, :, None], 0, data.oo),
        q_tx=torch.where(data.q_writer >= 0, tx, data.q_tx),
    )
    data_j = _to_jax_data(interop.to_numpy(data))
    alive = np.ones(ct.n_nodes, bool)
    alive[::13] = False
    writes = g.integers(0, 3, ct.gossip.n_writers).astype(np.uint32)
    r = int(np.asarray(topo_j.region).max()) + 1
    part = _cut(r)
    dyn = np.linspace(0.0, 0.5, r).astype(np.float32) if loss else None
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
    assert int(stats_j["msgs"]) > 0 and int(stats_j["applied_broadcast"]) > 0


@pytest.mark.parametrize("round_idx,exact", [(16, True), (17, True), (18, False)])
def test_wide_enumeration_sync_round(wide_paths, monkeypatch, round_idx, exact):
    if not exact:
        monkeypatch.setattr(jg, "_EXACT_SCORE_MAX", 0)
        monkeypatch.setattr(tg, "_EXACT_SCORE_MAX", 0)
    cj, topo_j, ct, topo_t = _configs(loss_prob=0.2, n_cells=64)
    data = _mid_state(ct, topo_t).data
    assert bool(data.oo_any), "the window absorb path must be live"
    data_j = _to_jax_data(interop.to_numpy(data))
    alive = np.ones(ct.n_nodes, bool)
    alive[5::11] = False
    part = _cut(int(np.asarray(topo_j.region).max()) + 1)
    out_j, stats_j = jg.sync_round(
        data_j, topo_j, jnp.asarray(alive), jnp.asarray(part),
        jnp.int32(round_idx), jax.random.PRNGKey(5), cj.gossip,
    )
    out_t, stats_t = tg.sync_round(
        data, topo_t, torch.as_tensor(alive), torch.as_tensor(part),
        torch.tensor(round_idx), trng.PRNGKey(5), ct.gossip,
    )
    assert int(stats_j["cell_merges"]) > 0
    _assert_equal(out_j, out_t)
    _assert_stats(stats_j, stats_t)


def _gossip(**kw):
    return tg.GossipConfig(n_nodes=8, n_writers=4, **kw)


@pytest.mark.parametrize(
    "kw",
    [
        dict(), dict(rebroadcast_fresh_budget=False),
        dict(rebroadcast_fresh_budget=False, rebroadcast_stale=True),
        dict(n_writers=10_000, n_cells=64), dict(track_writer_ids=True),
    ],
)
def test_check_slice_takes_wide_writers_and_legacy_intake(kw):
    cfg = dataclasses.replace(_gossip(), **kw)
    data_j = jg.init_data(dataclasses.replace(jg.GossipConfig(n_nodes=8, n_writers=4), **kw))
    data_t = tg.init_data(cfg, "cpu")
    for f in ("contig", "q_writer", "q_gw", "q_dup", "oo"):
        assert tuple(getattr(data_t, f).shape) == getattr(data_j, f).shape, f

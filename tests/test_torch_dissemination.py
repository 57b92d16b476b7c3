"""The adaptive-dissemination plane of the port against the JAX reference,
run live on the same inputs: the duplicate-receipt rumor kill
(``rumor_kill_k``), push->pull switching (``pull_switch_age``),
age-targeted intake (``age_forward``), bucketed sync sketches
(``sync_sketch_buckets``) and the propagation counters
(``prop_observe``).

- unit parity of ``bucket_sketch``, ``_sketch_score``, ``_intake_priority``
  (tie-heavy, through the queue rebuild too), ``_queue_saturation`` and
  ``_region_link_matrix``;
- one ``broadcast_round`` + ``sync_round`` per mechanism, alone and
  composed, on both delivery paths, in the exact, digest and sketch
  scoring branches, from one lossy mid-run state carried through
  ``corrosion_tpu_torch.interop``: every state leaf (``q_dup`` included)
  and every stat bit-equal;
- the two-node kill scenario of the reference's
  ``test_kill_frees_intake_slot_same_round``, held to what the reference
  computes live (not to that test's expectations);
- the config checks.

The legacy path is forced as in ``test_torch_legacy.py``
(``_FAST_MAX_WRITERS = 0`` in both packages, ``_BLOCK_ENUM_MIN_WRITERS =
1`` in the reference, JAX's caches cleared around it); sketch and digest
scoring by ``_EXACT_SCORE_MAX = 0`` in both.
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
from corrosion_tpu.ops import routing as jr
from corrosion_tpu.sim import health as jh
from corrosion_tpu.sim import telemetry as jt
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.ops import routing as tr
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import health as th
from corrosion_tpu_torch.sim import telemetry as tt

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

SMALL = dict(n=96, n_regions=4, n_writers=16, rounds=20, samples=16)
ADAPTIVE = dict(jh.ADAPTIVE_GOSSIP)
PROP = dict(prop_observe=True)
# (mechanisms, scoring branch); the composed cases also carry the
# propagation counters, so their stats hold prop_kills and prop_pulls.
CASES = {
    "kill": (dict(rumor_kill_k=2), "exact"),
    "pull": (dict(pull_switch_age=2), "exact"),
    "pull_digest": (dict(pull_switch_age=2), "digest"),
    "age": (dict(age_forward=True), "exact"),
    "composed": ({**ADAPTIVE, **PROP}, "exact"),
    "composed_sketch": ({**ADAPTIVE, **PROP, "sync_sketch_buckets": 8}, "sketch"),
    "prop": (PROP, "exact"),
}


@pytest.fixture(params=["fast", "legacy"])
def path(request):
    saved = (jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS)
    if request.param == "legacy":
        jax.clear_caches()
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        yield request.param
    finally:
        if request.param == "legacy":
            jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = saved
            jax.clear_caches()


def _to_jax_data(d):
    cells = jcrdt.CellState(**{k: jnp.asarray(v) for k, v in d["cells"].items()})
    return jg.DataState(cells=cells, **{k: jnp.asarray(v) for k, v in d.items() if k != "cells"})


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
    bad = [k for k in a if not (np.asarray(a[k]).dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"state differs in {bad}"


def _assert_stats(js, ts):
    assert js.keys() == ts.keys()
    for k in js:
        want = np.asarray(js[k]).astype(np.int64)
        got = np.asarray(ts[k].cpu() if torch.is_tensor(ts[k]) else ts[k]).astype(np.int64)
        assert np.array_equal(want, got), k


def _configs(mech):
    cj, topo_j, _ = jb.wan_100k(**SMALL)
    ct, topo_t, _ = tb.wan_100k(device="cpu", **SMALL)
    kw = dict(n_cells=32, loss_prob=0.2, **mech)
    cj = dataclasses.replace(cj, gossip=dataclasses.replace(cj.gossip, **kw))
    ct = dataclasses.replace(ct, gossip=dataclasses.replace(ct.gossip, **kw))
    return cj, topo_j, ct, topo_t


def _mid_state(ct, topo_t, rounds=14):
    """A port state after ``rounds`` rounds of heavy writes (1-2 versions
    for most writers each round) under loss: live window bits, queued
    rumors of every age, duplicate counters under the kill."""
    g = np.random.default_rng(rounds)
    w = ct.gossip.n_writers
    writes = (g.random((rounds, w)) < 0.6) * g.integers(1, 3, (rounds, w))
    sched = te.Schedule(writes=writes.astype(np.uint32)).make_samples(16)
    final, _ = te.simulate(ct, topo_t, sched, seed=3, device="cpu")
    return final.data


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_matches_reference(path, monkeypatch, request, case):
    mech, scoring = CASES[case]
    if scoring != "exact":
        # The reference reads the switch at trace time: its jitted rounds
        # retrace on the way in and on the way out.
        jax.clear_caches()
        request.addfinalizer(jax.clear_caches)
        monkeypatch.setattr(jg, "_EXACT_SCORE_MAX", 0)
        monkeypatch.setattr(tg, "_EXACT_SCORE_MAX", 0)
    cj, topo_j, ct, topo_t = _configs(mech)
    data = _mid_state(ct, topo_t)
    assert bool(data.oo_any), "the window path must be live"
    if ct.gossip.rumor_kill_k:
        assert int(data.q_dup.sum()) > 0, "duplicate counters must be live"
    g = np.random.default_rng(len(case))
    alive = np.ones(ct.n_nodes, bool)
    alive[5::17] = False
    if ct.gossip.pull_switch_age:
        sat = tg._queue_saturation(data.q_writer, data.q_ver, data.head,
                                   torch.as_tensor(alive), ct.gossip)
        assert bool(sat.any()), "some node must saturate"
    writes = g.integers(0, 3, ct.gossip.n_writers).astype(np.uint32)
    part = np.zeros((4, 4), bool)
    part[0, 1:] = part[1:, 0] = True
    data_j = _to_jax_data(interop.to_numpy(data))
    args_j = (topo_j, jnp.asarray(alive), jnp.asarray(part))
    args_t = (topo_t, torch.as_tensor(alive), torch.as_tensor(part))

    out_j, bs_j = jg.broadcast_round(
        data_j, *args_j, jnp.asarray(writes), jax.random.PRNGKey(11), cj.gossip
    )
    out_t, bs_t = tg.broadcast_round(
        data, *args_t, torch.as_tensor(writes.astype(np.int64)), trng.PRNGKey(11), ct.gossip
    )
    _assert_equal(out_j, out_t)
    _assert_stats(bs_j, bs_t)
    assert int(bs_j["msgs"]) > 0
    if "prop_kills" in bs_j and ct.gossip.rumor_kill_k:
        assert int(bs_j["prop_kills"]) > 0
    for round_idx in (14, 15):
        out_j, ss_j = jg.sync_round(
            out_j, *args_j, jnp.int32(round_idx), jax.random.PRNGKey(round_idx), cj.gossip
        )
        out_t, ss_t = tg.sync_round(
            out_t, *args_t, torch.tensor(round_idx), trng.PRNGKey(round_idx), ct.gossip
        )
        _assert_equal(out_j, out_t)
        _assert_stats(ss_j, ss_t)
        assert int(ss_j["sessions"]) > 0


# ---- the two-node kill scenario ---------------------------------------------


def _mk2(pkg, **kw):
    cfg = pkg.GossipConfig(
        n_nodes=2, n_writers=2, queue=1, max_writes_per_round=1, fanout_near=2,
        fanout_far=0, queue_priority="version", window_k=0, n_cells=0,
        prop_observe=True, **kw,
    )
    topo = jg.make_topology([2], [0, 1]) if pkg is jg else tg.make_topology([2], [0, 1], device="cpu")
    return cfg, topo


def _seeded(pkg, cfg, q_dup=None):
    base = dict(head=[1, 1], contig=[[1, 1], [0, 1]], seen=[[1, 1], [0, 1]],
                q_writer=[[0], [1]], q_ver=[[1], [1]], q_tx=[[6], [6]])
    if q_dup is not None:
        base["q_dup"] = q_dup
    if pkg is jg:
        u32 = {"head", "contig", "seen", "q_ver"}
        return jg.init_data(cfg)._replace(**{
            k: jnp.asarray(v, jnp.uint32 if k in u32 else jnp.int32) for k, v in base.items()
        })
    return tg.init_data(cfg, "cpu")._replace(**{
        k: torch.tensor(v, dtype=torch.int64) for k, v in base.items()
    })


@pytest.mark.parametrize("kill_k", [1, 0])
def test_kill_slot_scenario_matches_live_reference(kill_k):
    """The reference's kill-frees-intake-slot scenario, with the kill
    (k = 1, node 1's entry one receipt from it) and without: for each of
    the seeds the reference's test searches, one round of both packages
    from the same seeded queues is bit-equal."""
    kw = {"rumor_kill_k": kill_k} if kill_k else {}
    cj, topo_j = _mk2(jg, **kw)
    ct, topo_t = _mk2(tg, **kw)
    q_dup = [[0], [1]] if kill_k else None
    data_j, data_t = _seeded(jg, cj, q_dup), _seeded(tg, ct, q_dup)
    kills = 0
    for seed in range(4):
        out_j, s_j = jg.broadcast_round(
            data_j, topo_j, jnp.ones(2, bool), jnp.zeros((1, 1), bool),
            jnp.zeros(2, jnp.uint32), jax.random.PRNGKey(seed), cj,
        )
        out_t, s_t = tg.broadcast_round(
            data_t, topo_t, torch.ones(2, dtype=torch.bool), torch.zeros((1, 1), dtype=torch.bool),
            torch.zeros(2, dtype=torch.int64), trng.PRNGKey(seed), ct,
        )
        _assert_equal(out_j, out_t)
        _assert_stats(s_j, s_t)
        kills += int(s_t["prop_kills"])
    assert (kills > 0) == bool(kill_k)


# ---- units ------------------------------------------------------------------


def test_age_forward_edges_are_the_rumor_age_edges():
    assert tg.AGE_FORWARD_EDGES == tt.RUMOR_AGE_EDGES == jg.AGE_FORWARD_EDGES == jt.RUMOR_AGE_EDGES


@pytest.mark.parametrize("buckets,w", [(1, 16), (3, 16), (8, 512), (5, 37)])
def test_bucket_sketch_matches_reference(buckets, w):
    g = np.random.default_rng(w + buckets)
    contig = g.integers(0, 1 << 32, (23, w), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jg.bucket_sketch(jnp.asarray(contig), buckets))
    got = interop.to_numpy(tg.bucket_sketch(torch.as_tensor(contig.astype(np.int64)), buckets), "contig")
    assert np.array_equal(want, got)


@pytest.mark.parametrize("budget", [64, 256, 512])
def test_sketch_score_matches_reference(budget):
    g = np.random.default_rng(budget)
    # Deficits from 0 to past 2^31: the quantized and raw i32 forms, and
    # the int32 wraparound of the sum.
    skc = g.integers(0, 1 << 32, (17, 8, 6), dtype=np.uint64).astype(np.uint32)
    skc[:, :4] = g.integers(0, 600, (17, 4, 6))
    own = g.integers(0, 1 << 32, (17, 1, 6), dtype=np.uint64).astype(np.uint32)
    own[::2] = g.integers(0, 300, (9, 1, 6))
    want = np.asarray(jg._sketch_score(jnp.asarray(skc), jnp.asarray(own), budget))
    got = tg._sketch_score(
        torch.as_tensor(skc.astype(np.int64)), torch.as_tensor(own.astype(np.int64)), budget
    )
    assert want.dtype == np.int32 and np.array_equal(want, got.numpy())


def _tie_inputs(seed):
    """Tie-heavy intake candidates: few writers, versions in a narrow band
    near the heads (many equal ages and versions), plus versions past 2^24
    (the clamp) and past the head (age 0)."""
    g = np.random.default_rng(seed)
    head = g.integers(60, 90, 5).astype(np.uint32)
    head[4] = (1 << 24) + 40
    w = g.integers(0, 5, (31, 24)).astype(np.int32)
    v = (head[w].astype(np.int64) - g.integers(-2, 70, (31, 24))).clip(0).astype(np.uint32)
    return head, w, v


@pytest.mark.parametrize("age_forward", [True, False])
@pytest.mark.parametrize("backend", ["native", "pallas"])
def test_intake_priority_and_rebuild_with_ties(age_forward, backend):
    head, w, v = _tie_inputs(int(age_forward))
    cj = jg.GossipConfig(n_nodes=4, n_writers=5, age_forward=age_forward)
    ct = tg.GossipConfig(n_nodes=4, n_writers=5, age_forward=age_forward)
    pj = jg._intake_priority(jnp.asarray(head), jnp.asarray(w), jnp.asarray(v), cj, backend)
    head_t, w_t, v_t = (torch.as_tensor(x.astype(np.int64)) for x in (head, w, v))
    pt = tg._intake_priority(head_t, w_t, v_t, ct)
    assert np.array_equal(np.asarray(pj).astype(np.int64), pt.numpy())
    assert len(np.unique(np.asarray(pj))) < pj.size // 2  # ties abound
    # The queue rebuild's stable order keeps the same candidates in the
    # same slots from either priority.
    valid = np.random.default_rng(2).random(w.shape) < 0.8
    mj, (wj, vj) = jr.rebuild_bounded_queue(
        jnp.asarray(valid), pj, (jnp.asarray(w), jnp.asarray(v)), 9
    )
    mt, (wt, vt) = tr.rebuild_bounded_queue(torch.as_tensor(valid), pt, (w_t, v_t), 9)
    assert np.array_equal(np.asarray(mj), mt.numpy())
    assert np.array_equal(np.asarray(wj), wt.numpy()) and np.array_equal(np.asarray(vj), vt.numpy())


def test_age_bins_are_the_reference_loop():
    """``torch.bucketize`` counts the edges below each age exactly as the
    reference's loop of ``age > e`` passes, at every age 0-80."""
    age = torch.arange(81)
    loop = sum((age > e).to(torch.int64) for e in tg.AGE_FORWARD_EDGES)
    edges = torch.tensor(tg.AGE_FORWARD_EDGES)
    assert torch.equal(torch.bucketize(age, edges), loop)


@pytest.mark.parametrize("age", [0, 2, 5])
def test_queue_saturation_matches_reference(age):
    g = np.random.default_rng(age)
    n, q, w = 40, 6, 7
    head = g.integers(0, 12, w).astype(np.uint32)
    qw = g.integers(-1, w, (n, q)).astype(np.int32)
    qw[:4] = -1  # empty queues never saturate
    qv = (head[np.maximum(qw, 0)].astype(np.int64) - g.integers(0, 9, (n, q))).clip(0).astype(np.uint32)
    alive = g.random(n) < 0.9
    cj = jg.GossipConfig(n_nodes=n, n_writers=w, pull_switch_age=age)
    ct = tg.GossipConfig(n_nodes=n, n_writers=w, pull_switch_age=age)
    args = (qw, qv, head)
    for bk in (None, "native", "pallas"):
        want = np.asarray(jg._queue_saturation(*map(jnp.asarray, args), jnp.asarray(alive), cj, bk=bk))
        got = tg._queue_saturation(
            *(torch.as_tensor(x.astype(np.int64)) for x in args), torch.as_tensor(alive), ct
        )
        assert np.array_equal(want, got.numpy()), bk
    assert 0 < want.sum() < n or age == 5


@pytest.mark.parametrize("n_regions", [1, 3, 4])
def test_region_link_matrix_matches_reference(n_regions):
    g = np.random.default_rng(n_regions)
    n, f, q = 50, 3, 4
    m_ok = g.random((n, f * q)) < 0.6
    recv = np.sort(g.integers(0, n_regions, n)).astype(np.int32)
    src = g.integers(0, n_regions, (n, f)).astype(np.int32)
    want = np.asarray(jg._region_link_matrix(
        jnp.asarray(m_ok), jnp.asarray(recv), jnp.asarray(src), q, n_regions
    ))
    got = tg._region_link_matrix(
        torch.as_tensor(m_ok), torch.as_tensor(recv.astype(np.int64)),
        torch.as_tensor(src.astype(np.int64)), q, n_regions,
    )
    assert np.array_equal(want.astype(np.int64), got.numpy())
    assert int(got.sum()) == int(m_ok.sum())


@pytest.mark.parametrize(
    "bad",
    [
        {"rumor_kill_k": -1}, {"pull_switch_age": -2}, {"sync_sketch_buckets": -1},
        {"age_forward": True, "rebroadcast_stale": True, "rebroadcast_fresh_budget": False},
    ],
)
def test_config_checks_match_reference(bad):
    for pkg in (jg, tg):
        with pytest.raises(ValueError):
            pkg.GossipConfig(n_nodes=4, n_writers=2, **bad)


def test_config_takes_every_option():
    kw = dict(prop_observe=True, sync_sketch_buckets=8, **ADAPTIVE)
    cfg = tg.GossipConfig(n_nodes=4, n_writers=2, **kw)
    assert tg.init_data(cfg, "cpu").q_dup.shape == (4, cfg.queue)
    assert th.ADAPTIVE_GOSSIP == jh.ADAPTIVE_GOSSIP and th.GEO_REGIONS == jh.GEO_REGIONS

"""The any-node-writes path of the port (``ops/sparse_writers.py``,
``sim/sparse_engine.py``, ``track_writer_ids`` in ``ops/gossip.py``)
against the JAX reference run live on the same inputs. Every comparison
is bit-equal.

- ``demote_report``, ``rotate``, ``cold_sync``, ``cold_visibility`` and
  ``cold_need`` from seeded states carried across through ``interop``,
  with forced demotions (laggards insert deviation entries), promotions
  that consume entries, and a table too small (``dev_dropped``);
- ``simulate_sparse`` on the reference test's ``_small()`` shapes: steady
  rotation, forced demotion under partition (cold healing), pause-resume
  churn; every curve, every leaf of the final SparseState and SWIM state,
  ``vis_round`` and ``info``;
- a run stopped after an epoch and resumed twice from one dict equals the
  uninterrupted run, and each part equals the reference's own stopped and
  resumed parts;
- track ids through the legacy delivery (``_FAST_MAX_WRITERS = 0`` in
  both packages) and against the reference's block grant enumeration
  (``_BLOCK_ENUM_MIN_WRITERS = 1``), with JAX's caches cleared before and
  after.
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
from corrosion_tpu.ops import sparse_writers as jsw
from corrosion_tpu.sim import sparse_engine as jse
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.ops import sparse_writers as tsw
from corrosion_tpu_torch.sim import sparse_engine as tse

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_equal(jax_tree, port_tree):
    a, b = _flat(jax_tree), _flat(interop.to_numpy(port_tree))
    assert a.keys() == b.keys()
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, f"differs in {bad}"


def _assert_stats(js, ts):
    assert js.keys() == ts.keys()
    for k in js:
        assert int(np.asarray(js[k]).astype(np.int64)) == int(ts[k]), k


def _jax_tree(cls, d):
    """A reference NamedTuple (nested) from interop's numpy dicts."""
    sub = {"data": jg.DataState, "cells": jcrdt.CellState}
    return cls(**{
        k: _jax_tree(sub[k], v) if isinstance(v, dict) else jnp.asarray(v)
        for k, v in d.items()
    })


# ---- seeded states ------------------------------------------------------------

N, W, K, Q, CELLS = 40, 8, 6, 4, 16


def _configs(k_dev=K, n_cells=CELLS):
    kw = dict(
        n_nodes=N, n_writers=W, track_writer_ids=True, n_cells=n_cells,
        queue=Q, window_k=32,
    )
    sp = dict(epoch_rounds=4, k_dev=k_dev, d_max=6, p_max=6, cold_budget=12,
              cold_chunk=5)
    return (
        jg.GossipConfig(**kw), jsw.SparseConfig(**sp),
        tg.GossipConfig(**kw), tsw.SparseConfig(**sp),
    )


def _state(seed, k_dev=K, n_cells=CELLS):
    """A seeded port SparseState: slots 0-5 hot (writers 30-35), nodes
    lagging on them, deviation entries on writers 10-19 (some of which the
    plan promotes), queue entries on every slot, window bits set."""
    g = np.random.default_rng(seed)
    slot_writer = np.array([30, 31, 32, 33, 34, 35, -1, -1])
    head = np.where(slot_writer >= 0, g.integers(3, 20, W), 0)
    contig = np.minimum(g.integers(0, 25, (N, W)), head)
    # Slot 1 fully caught up: a zero-lag demotion candidate.
    contig[:, 1] = head[1]
    seen = np.minimum(contig + g.integers(0, 4, (N, W)), head)
    head_full = g.integers(0, 30, N)
    head_full[slot_writer[slot_writer >= 0]] = 0
    dev_w = np.full((N, k_dev), -1)
    dev_c = np.zeros((N, k_dev), np.int64)
    for i in range(N):
        ws = g.choice(np.arange(10, 20), size=g.integers(0, min(4, k_dev) + 1), replace=False)
        pos = g.choice(k_dev, size=len(ws), replace=False)
        dev_w[i, pos] = ws
        dev_c[i, pos] = g.integers(0, head_full[ws] + 1)
    q_writer = g.integers(-1, W, (N, Q))
    d = dict(
        data=dict(
            head=head, contig=contig, seen=seen,
            oo=g.integers(0, 1 << 32, (1, N, W), dtype=np.uint64).astype(np.int64),
            oo_any=np.array(True),
            q_writer=q_writer, q_ver=g.integers(1, 20, (N, Q)),
            q_tx=g.integers(1, 6, (N, Q)),
            q_gw=np.where(q_writer >= 0, np.maximum(slot_writer[np.maximum(q_writer, 0)], 0), 0),
            q_dup=np.zeros((N, 0), np.int64),
            cells=dict(
                cl=g.integers(0, 4, N * n_cells), col_version=g.integers(0, 30, N * n_cells),
                value_rank=g.integers(0, 1 << 32, N * n_cells, dtype=np.uint64).astype(np.int64),
            ),
        ),
        head_full=head_full, slot_writer=slot_writer, dev_writer=dev_w,
        dev_contig=dev_c, dev_any=np.array((dev_w >= 0).any()),
    )
    port = interop.sparse_state_from_numpy(d, device="cpu")
    return port, _jax_tree(jsw.SparseState, interop.to_numpy(port))


# Retire slots 0, 1, 2 (0 and 2 lag: forced), promote writers 12, 15 (with
# deviation entries) and 25 into slots 0, 6 and 7; pads are invalid.
PLAN = (
    np.array([0, 1, 2, 0, 0, 0]), np.array([1, 1, 1, 0, 0, 0], bool),
    np.array([0, 6, 7, 0, 0, 0]), np.array([12, 15, 25, 0, 0, 0]),
    np.array([1, 1, 1, 0, 0, 0], bool),
)


def _plan_args(plan, as_jax):
    if as_jax:
        return [jnp.asarray(x.astype(np.int32) if x.dtype != bool else x) for x in plan]
    return [torch.as_tensor(x) for x in plan]


@pytest.mark.parametrize("seed", [0, 1])
def test_demote_report(seed):
    port, ref = _state(seed)
    cand = (np.array([0, 2, 1, 3, 5, 0]), np.array([1, 1, 1, 1, 0, 0], bool))
    got = tsw.demote_report(port, *_plan_args(cand, False))
    want = jsw.demote_report(ref, *_plan_args(cand, True))
    assert not bool(want[0][0]) and bool(want[0][2])
    for x, y in zip(want, got):
        assert np.array_equal(np.asarray(x).astype(np.int64), y.numpy())


@pytest.mark.parametrize("seed,k_dev", [(0, K), (1, K), (2, 2)])
def test_rotate(seed, k_dev):
    port, ref = _state(seed, k_dev=k_dev)
    jcfg, _, tcfg, _ = _configs(k_dev=k_dev)
    out_j, st_j = jsw.rotate(ref, *_plan_args(PLAN, True), jcfg)
    out_t, st_t = tsw.rotate(port, *_plan_args(PLAN, False), tcfg)
    _assert_equal(out_j, out_t)
    _assert_stats(st_j, st_t)
    assert int(st_j["retired"]) == 3 and int(st_j["dev_entries"]) > 0
    # The table of two overflows (the engine raises on this); six holds.
    assert (int(st_j["dev_dropped"]) > 0) == (k_dev == 2)
    # Promoted writers 12 and 15 consumed their deviation entries.
    dev_w = out_t.dev_writer.numpy()
    assert not np.isin(dev_w, [12, 15]).any()
    assert np.isin(port.dev_writer.numpy(), [12, 15]).any()


@pytest.mark.parametrize("n_cells", [CELLS, 0])
def test_cold_sync_visibility_and_need(n_cells):
    port, ref = _state(3, n_cells=n_cells)
    jcfg, jsp, tcfg, tsp = _configs(n_cells=n_cells)
    g = np.random.default_rng(4)
    region = np.arange(N) % 4
    alive = g.random(N) < 0.85
    part = np.zeros((4, 4), bool)
    part[0, 1:] = part[1:, 0] = True
    out_j, st_j = jsw.cold_sync(
        ref, jnp.asarray(region.astype(np.int32)), jnp.asarray(alive),
        jnp.asarray(part), jcfg, jsp,
    )
    out_t, st_t = tsw.cold_sync(
        port, torch.as_tensor(region), torch.as_tensor(alive), torch.as_tensor(part),
        tcfg, tsp,
    )
    _assert_equal(out_j, out_t)
    _assert_stats(st_j, st_t)
    assert int(st_j["cold_healed"]) > 0
    assert (int(st_j["cold_merges"]) > 0) == (n_cells > 0)
    for r, t in ((ref, port), (out_j, out_t)):
        assert int(jsw.cold_need(r)) == int(tsw.cold_need(t))
    # 40 samples: three 16-sample chunks, writers with and without entries.
    sw_ = g.integers(8, 22, 40)
    sv = g.integers(0, 31, 40)
    vis_j = jsw.cold_visibility(
        ref, jnp.asarray(sw_.astype(np.int32)), jnp.asarray(sv.astype(np.uint32))
    )
    vis_t = tsw.cold_visibility(port, torch.as_tensor(sw_), torch.as_tensor(sv))
    assert np.array_equal(np.asarray(vis_j), vis_t.numpy())
    assert not vis_t.all()


def test_without_deviation_entries_the_cold_plane_is_skipped():
    port, _ = _state(5)
    port = port._replace(
        dev_writer=torch.full_like(port.dev_writer, -1),
        dev_any=torch.tensor(False),
    )
    _, _, tcfg, tsp = _configs()
    tg.reset_host_syncs()
    out, stats = tsw.cold_sync(
        port, torch.zeros(N, dtype=torch.int64), torch.ones(N, dtype=torch.bool),
        torch.zeros((1, 1), dtype=torch.bool), tcfg, tsp,
    )
    assert out is port and int(stats["cold_healed"]) == 0
    assert tsw.cold_visibility(port, torch.tensor([3]), torch.tensor([9])).all()
    assert int(tsw.cold_need(port)) == 0
    # Each skipped lax.cond is one counted host read.
    assert tg.HOST_SYNCS["branch"] == 2


# ---- whole runs ---------------------------------------------------------------


def _small(mod, n=96, w_hot=16, rounds=48, cohort=6, partition=False, k_dev=8, **kw):
    return mod.anywrite_sparse(
        n=n, w_hot=w_hot, rounds=rounds, n_regions=4, epoch_rounds=8,
        cohort=cohort, burst_writes=2, samples=64, k_dev=k_dev,
        partition=partition, **kw,
    )


def _churn(sched, n):
    """The reference test's pause-resume churn: six non-writer nodes flap
    for about three epochs mid-run."""
    rounds = sched.writes.shape[0]
    kill = np.zeros((rounds, n), bool)
    revive = np.zeros((rounds, n), bool)
    writers = set(np.nonzero(sched.writes.sum(axis=0))[0].tolist())
    flappers = [i for i in range(n) if i not in writers][:6]
    for j, node in enumerate(flappers):
        down = 16 + 2 * j
        kill[down, node] = True
        if down + 24 < rounds:
            revive[down + 24, node] = True
    sched.kill, sched.revive = kill, revive
    return sched


def _assert_runs_equal(out_j, out_t):
    cj, ct = out_j[3], out_t[3]
    assert cj.keys() == ct.keys()
    bad = [k for k in cj if not (cj[k].dtype == ct[k].dtype and np.array_equal(cj[k], ct[k]))]
    assert not bad, f"curves differ in {bad}"
    _assert_equal(out_j[0], out_t[0])
    _assert_equal(out_j[1], out_t[1])
    assert np.array_equal(np.asarray(out_j[2]), out_t[2].numpy().astype(np.int32))
    info_j = {k: v for k, v in out_j[4].items() if k != "resume"}
    info_t = {k: v for k, v in out_t[4].items() if k != "resume"}
    assert info_j == info_t


RUNS = {
    # label: (builder kwargs, seed, churn)
    "steady": (dict(), 0, False),
    "forced_demotion": (
        dict(n=96, w_hot=8, rounds=96, cohort=4, partition=True, k_dev=16), 2, False,
    ),
    "churn": (dict(n=96, w_hot=12, rounds=96, cohort=5, k_dev=24), 3, True),
}


@pytest.mark.parametrize("label", list(RUNS))
def test_simulate_sparse_matches_reference(label):
    kw, seed, churn = RUNS[label]
    cj, topo_j, sched_j = _small(jb, **kw)
    ct, topo_t, sched_t = _small(tb, device="cpu", **kw)
    if churn:
        sched_j, sched_t = _churn(sched_j, cj.n_nodes), _churn(sched_t, ct.n_nodes)
    for f in ("writes", "sample_writer", "sample_ver", "sample_round"):
        assert np.array_equal(getattr(sched_j, f), getattr(sched_t, f)), f
    out_j = jse.simulate_sparse(cj, topo_j, sched_j, seed=seed)
    out_t = tse.simulate_sparse(ct, topo_t, sched_t, seed=seed, device="cpu")
    _assert_runs_equal(out_j, out_t)
    info = out_t[4]
    assert info["retired"] > 0 and info["promoted"] > ct.w_hot
    assert tse.converged_sparse(out_t[0]) and bool((out_t[2] >= 0).all())
    if label == "forced_demotion":
        assert info["max_dev_entries"] > 0 and out_t[3]["cold_healed"].sum() > 0
    if label == "churn":
        assert out_t[3]["mismatches"].max() > 0
    # Cells follow global writer identity: the final head of every node
    # agrees, and every node holds the same registers.
    hf = tse.final_head_full(out_t[0])
    assert np.array_equal(hf, jse.final_head_full(out_j[0]))
    cells = tg.node_cells(out_t[0].data, ct.gossip)
    assert bool((cells.cl == cells.cl[:1]).all())


def test_resume_twice_from_one_dict_equals_uninterrupted():
    cj, topo_j, sched_j = _small(jb)
    ct, topo_t, sched_t = _small(tb, device="cpu")
    full = tse.simulate_sparse(ct, topo_t, sched_t, seed=5, device="cpu")
    _assert_runs_equal(jse.simulate_sparse(cj, topo_j, sched_j, seed=5), full)
    # An epoch-0 resume point starts the run like no resume at all.
    part1 = tse.simulate_sparse(
        ct, topo_t, sched_t, seed=5, stop_after_epoch=2, device="cpu",
        resume=tse.initial_resume(ct, len(sched_t.sample_writer), device="cpu"),
    )
    part1_j = jse.simulate_sparse(
        cj, topo_j, sched_j, seed=5, stop_after_epoch=2,
        resume=jse.initial_resume(cj, len(sched_j.sample_writer)),
    )
    _assert_runs_equal(part1_j, part1)
    part2_j = jse.simulate_sparse(cj, topo_j, sched_j, seed=5, resume=part1_j[4]["resume"])
    resume = part1[4]["resume"]
    assert resume["next_epoch"] == 3
    snap = _flat(interop.to_numpy(resume["sstate"]))
    for _ in range(2):
        part2 = tse.simulate_sparse(ct, topo_t, sched_t, seed=5, resume=resume, device="cpu")
        _assert_runs_equal(part2_j, part2)
        assert np.array_equal(
            np.concatenate([part1[3]["need"], part2[3]["need"]]), full[3]["need"]
        )
        for k in full[3]:
            assert np.array_equal(part2[3][k], full[3][k][3 * ct.sparse.epoch_rounds:]), k
        for a, b in ((full[0], part2[0]), (full[1], part2[1])):
            fa, fb = _flat(interop.to_numpy(a)), _flat(interop.to_numpy(b))
            assert all(np.array_equal(fa[k], fb[k]) for k in fa)
        assert torch.equal(full[2], part2[2])
        # The resume dict is left as it was.
        after = _flat(interop.to_numpy(resume["sstate"]))
        assert all(np.array_equal(snap[k], after[k]) for k in snap)
    # Past the end: no epochs, empty curves, the state handed back.
    done = tse.simulate_sparse(
        ct, topo_t, sched_t, seed=5, resume=full[4]["resume"], device="cpu"
    )
    assert done[3] == {} and done[4]["epochs"] == 0


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


def test_track_ids_through_legacy_delivery_and_block_enumeration(wide_paths):
    cj, topo_j, sched_j = _small(jb)
    ct, topo_t, sched_t = _small(tb, device="cpu")
    # A shorter queue: the legacy window's segment banding needs
    # (F * Q + 1) * 2^24 <= 2^32 in both packages.
    cj = dataclasses.replace(cj, gossip=dataclasses.replace(cj.gossip, queue=12))
    ct = dataclasses.replace(ct, gossip=dataclasses.replace(ct.gossip, queue=12))
    out_j = jse.simulate_sparse(cj, topo_j, sched_j, seed=0)
    out_t = tse.simulate_sparse(ct, topo_t, sched_t, seed=0, device="cpu")
    _assert_runs_equal(out_j, out_t)
    assert out_t[3]["cell_merges"].sum() > 0 and out_t[3]["applied_sync"].sum() > 0
    # Slots were reused across epochs under distinct global writers.
    assert out_t[4]["promoted"] > ct.w_hot


def test_sparse_engine_refuses_what_the_reference_refuses():
    ct, topo_t, sched_t = _small(tb, device="cpu")
    with pytest.raises(ValueError, match="track_writer_ids"):
        tse.SparseClusterConfig(
            swim=ct.swim, gossip=dataclasses.replace(ct.gossip, track_writer_ids=False),
            sparse=ct.sparse,
        )
    sched_t.wipe = np.zeros_like(sched_t.writes, bool)
    with pytest.raises(ValueError, match="wipe"):
        tse.simulate_sparse(ct, topo_t, sched_t, device="cpu")
    sched_t.wipe = None
    tight = dataclasses.replace(ct, gossip=dataclasses.replace(ct.gossip, n_writers=2))
    with pytest.raises(RuntimeError, match="slot exhaustion"):
        tse.simulate_sparse(tight, topo_t, sched_t, device="cpu")

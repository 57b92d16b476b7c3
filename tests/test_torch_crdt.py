"""The CRDT merge helpers (``ops/crdt.py``) and the serial-merge ground
truth (``gossip.serial_merge_reference``, ``cells_agree``) against the
live JAX reference on the CPU, bit for bit: random batches heavy in ties
(equal (cl, col_version) with different ranks) and duplicate keys, the
pack's domain edges, the local-write helpers, and the ground truth of
finished small dense runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import crdt as jc
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import crdt as tc
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.sim import engine as te

torch.set_num_threads(1)


def _cells(g, k, cl_hi=3, cv_hi=4, vr_hi=5):
    return (
        g.integers(0, cl_hi, k).astype(np.uint32),
        g.integers(0, cv_hi, k).astype(np.uint32),
        g.integers(0, vr_hi, k).astype(np.uint32),
    )


def _jcells(a):
    return jc.CellState(*(jnp.asarray(x) for x in a))


def _tcells(a):
    return tc.CellState(*(torch.as_tensor(x.astype(np.int64)) for x in a))


def _assert_cells(j, t):
    for f in jc.CellState._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == np.uint32 and np.array_equal(a, b), f


@pytest.mark.parametrize("seed", range(4))
def test_merge_cells_equals_the_reference(seed):
    g = np.random.default_rng(seed)
    a, b = _cells(g, 500), _cells(g, 500)
    _assert_cells(jc.merge_cells(_jcells(a), _jcells(b)), tc.merge_cells(_tcells(a), _tcells(b)))
    # Idempotent and commutative, as the reference's laws say.
    m = tc.merge_cells(_tcells(a), _tcells(b))
    _assert_cells(jc.merge_cells(_jcells(b), _jcells(a)), m)
    _assert_cells(jc.merge_cells(_jcells(a), _jcells(a)), _tcells(a))


def _batch(g, b, k, cl_hi=3, cv_hi=4, vr_hi=5, keys=None):
    key = g.integers(0, k, b) if keys is None else keys
    cl, cv, vr = _cells(g, b, cl_hi, cv_hi, vr_hi)
    mask = g.random(b) < 0.75
    return key.astype(np.int32), cl, cv, vr, mask


def _apply_both(state, batch):
    key, cl, cv, vr, mask = batch
    j = jc.apply_changes(_jcells(state), jc.ChangeBatch(
        key=jnp.asarray(key), cl=jnp.asarray(cl), col_version=jnp.asarray(cv),
        value_rank=jnp.asarray(vr), mask=jnp.asarray(mask)))
    t = tc.apply_changes(_tcells(state), tc.ChangeBatch(
        key=torch.as_tensor(key.astype(np.int64)), cl=torch.as_tensor(cl.astype(np.int64)),
        col_version=torch.as_tensor(cv.astype(np.int64)),
        value_rank=torch.as_tensor(vr.astype(np.int64)), mask=torch.as_tensor(mask)))
    return j, t


@pytest.mark.parametrize("seed,k,b", [(0, 8, 400), (1, 64, 64), (2, 300, 2000), (3, 1, 50)])
def test_apply_changes_ties_and_duplicate_keys(seed, k, b):
    """Few distinct (cl, col_version, rank) values over few keys: most keys
    see several entries of one batch, many with the winning (cl, cv) and
    different ranks, and masked entries on every key."""
    g = np.random.default_rng(seed)
    state = _cells(g, k)
    j, t = _apply_both(state, _batch(g, b, k))
    _assert_cells(j, t)


def test_apply_changes_domain_edges():
    """cl up to 2^8 - 1, col_version up to 2^24 - 1, ranks at 2^32 - 1;
    a masked entry that would win contributes 0; the state wins a tie of
    (cl, cv) with a higher rank only where it holds the packed winner."""
    k = 6
    state = (np.array([255, 1, 2, 0, 7, 3], np.uint32),
             np.array([(1 << 24) - 1, 5, 0, 0, 9, 4], np.uint32),
             np.array([1, 2**32 - 1, 3, 0, 8, 6], np.uint32))
    key = np.array([0, 0, 1, 1, 2, 3, 3, 4, 4, 5, 5, 5], np.int32)
    cl = np.array([255, 255, 1, 1, 2, 0, 0, 7, 7, 3, 3, 3], np.uint32)
    cv = np.array([(1 << 24) - 1] * 2 + [5, 5, 1, 0, 0, 9, 9, 4, 4, 5], np.uint32)
    vr = np.array([2**32 - 1, 5, 7, 2**32 - 1, 1, 4, 4, 9, 3, 6, 7, 0], np.uint32)
    mask = np.array([False, True, True, True, True, True, True, False, True, True, True, True])
    j, t = _apply_both(state, (key, cl, cv, vr, mask))
    _assert_cells(j, t)
    assert t.cl.tolist() == [255, 1, 2, 0, 7, 3]
    assert t.value_rank.tolist()[:2] == [5, 2**32 - 1]
    # A batch of nothing but masked entries leaves the state as it is.
    j, t = _apply_both(state, (key, cl, cv, vr, np.zeros(len(key), bool)))
    _assert_cells(j, t)
    _assert_cells(_jcells(state), t)


def test_local_writes_equal_the_reference():
    g = np.random.default_rng(5)
    state = _cells(g, 40)
    js, ts = _jcells(state), _tcells(state)
    assert np.array_equal(np.asarray(jc.row_live(js)), tc.row_live(ts).numpy())
    for key, rank in ((3, 77), (0, 2**32 - 1), (39, 0)):
        js, ts = jc.local_write(js, key, jnp.uint32(rank)), tc.local_write(ts, key, rank)
        _assert_cells(js, ts)
    keys = np.array([1, 2, 5, 6, 7, 11], np.int32)
    for step in (jc.local_insert_row, jc.local_delete_row, jc.local_insert_row,
                 jc.local_insert_row, jc.local_delete_row, jc.local_delete_row):
        js = step(js, jnp.asarray(keys))
        ts = getattr(tc, step.__name__)(ts, torch.as_tensor(keys.astype(np.int64)))
        _assert_cells(js, ts)
    assert np.array_equal(np.asarray(jc.row_live(js)), tc.row_live(ts).numpy())


def _small_dense(cells_per_write):
    kw = dict(sync_interval=3, n_cells=48, cells_per_write=cells_per_write)
    jcfg, jtopo = jb._cfg(24, writers=[0, 5, 9, 17], regions=[12, 12], **kw)
    tcfg, ttopo = tb._cfg(24, writers=[0, 5, 9, 17], regions=[12, 12], device="cpu", **kw)
    g = np.random.default_rng(cells_per_write)
    writes = (g.random((20, 4)) < 0.5).astype(np.uint32)
    writes[14:] = 0
    return jcfg, jtopo, tcfg, ttopo, je.Schedule(writes=writes), te.Schedule(writes=writes)


@pytest.mark.parametrize("cells_per_write", [1, 2])
def test_serial_merge_reference_and_cells_agree_on_a_finished_run(cells_per_write):
    jcfg, jtopo, tcfg, ttopo, jsched, tsched = _small_dense(cells_per_write)
    jfinal, _ = je.simulate(jcfg, jtopo, jsched, seed=1)
    tfinal, _ = te.simulate(tcfg, ttopo, tsched, seed=1, device="cpu")
    ref_j = jg.serial_merge_reference(jfinal.data.head, jcfg.gossip)
    ref_t = tg.serial_merge_reference(tfinal.data.head, tcfg.gossip)
    _assert_cells(ref_j, ref_t)
    assert int(tfinal.data.head.sum()) > 0 and int((ref_t.cl > 0).sum()) > 0
    assert bool(jg.cells_agree(jfinal.data, jcfg.gossip)) == bool(
        tg.cells_agree(tfinal.data, tcfg.gossip)) is True
    pc = tg.node_cells(tfinal.data, tcfg.gossip)
    for f in tc.CellState._fields:
        assert torch.equal(getattr(pc, f), getattr(ref_t, f)[None, :].expand_as(getattr(pc, f)))
    # One node's register off by one: the cells no longer agree.
    cells = tfinal.data.cells
    bumped = cells.value_rank.clone()
    bumped[tcfg.gossip.n_cells + 3] += 1
    broken = tfinal.data._replace(cells=cells._replace(value_rank=bumped))
    assert not bool(tg.cells_agree(broken, tcfg.gossip))
    jb_ = interop.to_numpy(broken)["cells"]["value_rank"]
    jbroken = jfinal.data._replace(cells=jfinal.data.cells._replace(value_rank=jnp.asarray(jb_)))
    assert not bool(jg.cells_agree(jbroken, jcfg.gossip))


def test_serial_merge_reference_of_no_writes_and_from_a_numpy_head():
    cfg = tg.GossipConfig(n_nodes=4, n_writers=3, n_cells=16)
    jcfg = jg.GossipConfig(n_nodes=4, n_writers=3, n_cells=16)
    empty = tg.serial_merge_reference(np.zeros(3, np.uint32), cfg, device="cpu")
    assert all(int(x.sum()) == 0 for x in empty)
    head = np.array([3, 0, 7], np.uint32)
    _assert_cells(jg.serial_merge_reference(head, jcfg),
                  tg.serial_merge_reference(head, cfg, device="cpu"))
    wide = dataclasses.replace(cfg, cells_per_write=3)
    jwide = dataclasses.replace(jcfg, cells_per_write=3)
    _assert_cells(jg.serial_merge_reference(head, jwide),
                  tg.serial_merge_reference(torch.as_tensor(head.astype(np.int64)), wide))

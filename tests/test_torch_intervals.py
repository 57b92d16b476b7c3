"""The port's interval sets (``ops/intervals.py``) against the reference's,
run live: the reference works on one set and is ``vmap``-ed over rows, the
port takes the rows as a leading axis. Random insert/remove sequences,
every query after every step, overflow with tied lengths, ``gaps`` at the
window's edges and ``union`` — bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import intervals as ji
from corrosion_tpu_torch.ops import intervals as ti

torch.set_num_threads(1)

ROWS, CAP = 48, 6

_j_insert = jax.vmap(ji.insert)
_j_remove = jax.vmap(ji.remove)
_j_gaps = jax.vmap(ji.gaps)
_j_union = jax.vmap(ji.union)
_j_watermark = jax.vmap(ji.contiguous_watermark)
_j_queries = {
    "count": jax.vmap(ji.count), "total": jax.vmap(ji.total),
    "is_empty": jax.vmap(ji.is_empty), "max_end": jax.vmap(ji.max_end),
    "min_start": jax.vmap(ji.min_start),
}


def _j(starts, ends):
    return ji.IntervalSet(jnp.asarray(starts, jnp.int32), jnp.asarray(ends, jnp.int32))


def _t(starts, ends):
    return ti.IntervalSet(
        torch.as_tensor(np.asarray(starts), dtype=torch.int64),
        torch.as_tensor(np.asarray(ends), dtype=torch.int64),
    )


def _assert_same(js, ts, what=""):
    for a, b in ((js.starts, ts.starts), (js.ends, ts.ends)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, (what, a.shape, b.shape)
        assert np.array_equal(a, b), f"{what}: {a[~(a == b).all(-1)][:3]} vs {b[~(a == b).all(-1)][:3]}"


def _empty(rows, cap):
    iv = ti.make(cap, (rows,), device="cpu")
    return _j(iv.starts.numpy(), iv.ends.numpy()), iv


def _check_queries(js, ts, g):
    for name, fn in _j_queries.items():
        assert np.array_equal(np.asarray(fn(js)), getattr(ti, name)(ts).numpy()), name
    x = g.integers(-2, 120, ROWS)
    e = x + g.integers(0, 9, ROWS)
    assert np.array_equal(
        np.asarray(jax.vmap(ji.contains)(js, jnp.asarray(x, jnp.int32))),
        ti.contains(ts, torch.as_tensor(x)).numpy(),
    )
    assert np.array_equal(
        np.asarray(jax.vmap(ji.contains_range)(js, jnp.asarray(x, jnp.int32), jnp.asarray(e, jnp.int32))),
        ti.contains_range(ts, torch.as_tensor(x), torch.as_tensor(e)).numpy(),
    )
    base = g.integers(0, 4, ROWS)
    assert np.array_equal(
        np.asarray(_j_watermark(js, jnp.asarray(base, jnp.int32))),
        ti.contiguous_watermark(ts, torch.as_tensor(base)).numpy(),
    )
    lo = g.integers(-1, 60, ROWS)
    hi = lo + g.integers(0, 70, ROWS)
    _assert_same(
        _j_gaps(js, jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32)),
        ti.gaps(ts, torch.as_tensor(lo), torch.as_tensor(hi)), "gaps",
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequences_match_reference(seed):
    """Per-row random inserts and removes into sets of 6 slots (overflow
    is frequent), every query compared after every step."""
    g = np.random.default_rng(seed)
    js, ts = _empty(ROWS, CAP)
    for step in range(40):
        s = g.integers(0, 100, ROWS)
        e = s + g.integers(0, 12, ROWS)
        if step % 5 == 4:
            js = _j_remove(js, jnp.asarray(s, jnp.int32), jnp.asarray(e, jnp.int32))
            ts = ti.remove(ts, torch.as_tensor(s), torch.as_tensor(e))
        else:
            js = _j_insert(js, jnp.asarray(s, jnp.int32), jnp.asarray(e, jnp.int32))
            ts = ti.insert(ts, torch.as_tensor(s), torch.as_tensor(e))
        _assert_same(js, ts, f"step {step}")
        _check_queries(js, ts, g)
    # The sequences did overflow: some rows hold a full set.
    assert (ti.count(ts) == CAP).any()


def test_overflow_drops_the_first_of_tied_shortest():
    """Sets full of equal-length intervals: insert's candidates are the
    kept slots then the merged one, remove's the left pieces then the
    right ones; the first shortest candidate goes, as the reference."""
    g = np.random.default_rng(7)
    rows, cap = 64, 4
    js, ts = _empty(rows, cap)
    for k in range(cap):  # four disjoint intervals of length 3 per row
        s = 10 * k + g.integers(0, 3, rows)
        js = _j_insert(js, jnp.asarray(s, jnp.int32), jnp.asarray(s + 2, jnp.int32))
        ts = ti.insert(ts, torch.as_tensor(s), torch.as_tensor(s + 2))
    for s, e in ((60, 62), (70, 71), (5, 5), (33, 35), (1, 2)):
        js = _j_insert(js, jnp.int32(s) + jnp.zeros(rows, jnp.int32), jnp.int32(e) + jnp.zeros(rows, jnp.int32))
        ts = ti.insert(ts, torch.full((rows,), s), torch.full((rows,), e))
        _assert_same(js, ts, f"insert {(s, e)}")
    for s, e in ((11, 11), (61, 61), (0, 200)):
        js = _j_remove(js, jnp.int32(s) + jnp.zeros(rows, jnp.int32), jnp.int32(e) + jnp.zeros(rows, jnp.int32))
        ts = ti.remove(ts, torch.full((rows,), s), torch.full((rows,), e))
        _assert_same(js, ts, f"remove {(s, e)}")


def test_gaps_at_the_window_edges():
    """Intervals that start at ``s``, end at ``e``, straddle either edge,
    lie outside the window or fill it; a window of one seq."""
    ranges = [
        [], [(0, 10)], [(0, 3)], [(7, 10)], [(-5, 2)], [(8, 20)], [(11, 30)],
        [(-9, -1)], [(0, 0), (10, 10)], [(1, 1), (3, 3), (5, 9)], [(2, 4), (6, 8)],
    ]
    starts = np.full((len(ranges), CAP), int(ti.EMPTY))
    ends = np.full((len(ranges), CAP), int(ti.EMPTY) - 1)
    for r, rs in enumerate(ranges):
        for j, (s, e) in enumerate(rs):
            starts[r, j], ends[r, j] = s, e
    js, ts = _j(starts, ends), _t(starts, ends)
    for lo, hi in ((0, 10), (3, 3), (10, 10), (0, 0), (-1, 11)):
        lo_a = np.full(len(ranges), lo)
        hi_a = np.full(len(ranges), hi)
        jg = _j_gaps(js, jnp.asarray(lo_a, jnp.int32), jnp.asarray(hi_a, jnp.int32))
        tg = ti.gaps(ts, torch.as_tensor(lo_a), torch.as_tensor(hi_a))
        _assert_same(jg, tg, f"gaps [{lo}, {hi}]")
        assert tg.capacity == CAP + 1
    g = ti.gaps(ti.from_ranges([(2, 3), (6, 7)], 8, device="cpu"), 0, 10)
    assert ti.to_host(g) == [(0, 1), (4, 5), (8, 10)]


def test_union_matches_reference():
    g = np.random.default_rng(3)
    sets = []
    for _ in range(2):
        js, ts = _empty(ROWS, CAP)
        for _ in range(5):
            s = g.integers(0, 80, ROWS)
            e = s + g.integers(0, 10, ROWS)
            js = _j_insert(js, jnp.asarray(s, jnp.int32), jnp.asarray(e, jnp.int32))
            ts = ti.insert(ts, torch.as_tensor(s), torch.as_tensor(e))
        sets.append((js, ts))
    (ja, ta), (jb, tb) = sets
    _assert_same(_j_union(ja, jb), ti.union(ta, tb), "union")


def test_single_set_helpers():
    s = ti.from_ranges([(1, 3), (5, 7), (4, 4)], 8, device="cpu")
    assert ti.to_host(s) == [(1, 7)]
    assert ti.to_host(ti.remove(s, 3, 5)) == [(1, 2), (6, 7)]
    assert int(ti.total(s)) == 7 and int(ti.count(s)) == 1
    assert bool(ti.contains(s, 4)) and not bool(ti.contains(s, 8))
    assert int(ti.contiguous_watermark(s, 1)) == 7 and int(ti.contiguous_watermark(s, 0)) == -1
    assert ti.to_host(ti.make(3, (2,), device="cpu")) == [[], []]
    assert int(ti.max_end(ti.make(3, device="cpu"))) == -1

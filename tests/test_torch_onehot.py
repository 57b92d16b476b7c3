"""The port's plain versions of the fast path's four kernelised
primitives are bit-equal to the JAX reference under its Pallas kernels
(interpret mode on the CPU) and its native scatter/gather backend.

Inputs come from a numpy seed: masked, negative and out-of-range
indices, u32 values with bit 31 set, 0-width axes, window_k 32 and 64.
The CPU tensors route every port wrapper to its plain version, so these
tests hold the plain versions; the CUDA kernels are held against the
plain versions on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import onehot as jo
from corrosion_tpu_torch.ops import onehot as to

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

BACKENDS = ("pallas", "native")
SHAPES = [(1, 1, 1), (9, 13, 7), (16, 40, 33), (5, 0, 4), (0, 6, 5), (6, 5, 0)]


def _inputs(seed, r, m, w):
    g = np.random.default_rng(seed)
    idx = g.integers(-3, w + 3, (r, m)).astype(np.int32)
    val = g.integers(0, 1 << 32, (r, m), dtype=np.uint64).astype(np.uint32)
    val[:, ::3] |= np.uint32(1 << 31)
    mask = g.random((r, m)) < 0.7
    return idx, val, mask


def _t(x):
    x = np.asarray(x)
    return torch.as_tensor(x if x.dtype == np.bool_ else x.astype(np.int64))


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    if a.dtype == np.bool_:
        return b.dtype == np.bool_ and np.array_equal(a, b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("r,m,w", SHAPES)
def test_rowmax(backend, r, m, w):
    idx, val, mask = _inputs(1, r, m, w)
    for msk in (mask, None):
        want = jo.rowmax(
            jnp.asarray(idx), jnp.asarray(val),
            None if msk is None else jnp.asarray(msk), w, backend=backend,
        )
        got = to.rowmax(_t(idx), _t(val), None if msk is None else _t(msk), w)
        assert _same(want, got)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("r,m,w", SHAPES)
def test_rowgather(backend, r, m, w):
    idx, val, _ = _inputs(2, r, m, w)
    table = np.random.default_rng(3).integers(
        0, 1 << 32, (r, w), dtype=np.uint64
    ).astype(np.uint32)
    want = jo.rowgather(jnp.asarray(table), jnp.asarray(idx), backend=backend)
    assert _same(want, to.rowgather(_t(table), _t(idx)))


@pytest.mark.parametrize("r,m,w", [(9, 13, 7), (4, 6, 1)])
def test_rowgather_broadcast_columns(r, m, w):
    # visibility's form: one column list broadcast over every row.
    cols = np.random.default_rng(4).integers(-1, w + 1, (m,)).astype(np.int32)
    table = np.random.default_rng(5).integers(0, 1 << 20, (r, w)).astype(np.uint32)
    want = jo.rowgather(
        jnp.asarray(table), jnp.broadcast_to(jnp.asarray(cols)[None, :], (r, m)),
        backend="pallas",
    )
    got = to.rowgather(_t(table), _t(cols)[None, :].expand(r, m))
    assert _same(want, got)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("r,m,w", SHAPES)
def test_delivery_reduce(backend, r, m, w):
    idx, v, valid = _inputs(6, r, m, w)
    g = np.random.default_rng(7)
    d = g.integers(0, 200, (r, m)).astype(np.uint32)
    applied = valid & (g.random((r, m)) < 0.6)
    seen = g.integers(0, 1 << 32, (r, w), dtype=np.uint64).astype(np.uint32)
    want = jo.delivery_reduce(
        jnp.asarray(idx), jnp.asarray(d), jnp.asarray(v), jnp.asarray(applied),
        jnp.asarray(valid), jnp.asarray(seen), w, backend=backend,
    )
    got = to.delivery_reduce(
        _t(idx), _t(d), _t(v), _t(applied), _t(valid), _t(seen), w
    )
    assert _same(want[0], got[0]) and _same(want[1], got[1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wk", (32, 64))
@pytest.mark.parametrize("r,m,w", SHAPES)
def test_window_delivery(backend, wk, r, m, w):
    idx, _, valid = _inputs(8, r, m, w)
    g = np.random.default_rng(9)
    b = wk // 32
    oo = g.integers(0, 1 << 32, (b, r, w), dtype=np.uint64).astype(np.uint32)
    adv_m = g.integers(0, 40, (r, m)).astype(np.uint32)
    # Deltas around the advance: below it (u32 wrap in d - adv_m), inside
    # the window, and beyond it; d = 0 wraps d - 1.
    d = (adv_m.astype(np.int64) + g.integers(-5, wk + 8, (r, m))).clip(0)
    d = d.astype(np.uint32)
    want = jo.window_delivery(
        jnp.asarray(oo), jnp.asarray(idx), jnp.asarray(d), jnp.asarray(adv_m),
        jnp.asarray(valid), wk, w, backend=backend,
    )
    got = to.window_delivery(_t(oo), _t(idx), _t(d), _t(adv_m), _t(valid), wk, w)
    assert _same(want[0], got[0]) and _same(want[1], got[1])


def test_cpu_tensors_never_count_launches():
    to.reset_launches()
    idx, val, mask = _inputs(10, 4, 5, 6)
    to.rowmax(_t(idx), _t(val), _t(mask), 6)
    to.rowgather(_t(val.reshape(4, 5)), _t(idx))
    assert all(v == 0 for v in to.LAUNCHES.values())


def test_wrapper_rejects_mixed_devices():
    # The CPU route takes CPU tensors only (the operators check CUDA ones).
    idx, val, _ = _inputs(11, 2, 3, 4)
    with pytest.raises(ValueError):
        to._check_cpu(_t(idx), _t(val).to("meta"))
    with pytest.raises(ValueError):
        to.rowmax(_t(idx), _t(val).to("meta"), None, 4)


# Every row-gather call on the three main paths at full size: (W, M,
# broadcast) and the form the rule picks: pairs where the call addresses
# its rows densely (M >= W/2), scalar on wide or sparse rows and broadcast
# indices (PERF.md §6 has both forms timed at each of these).
MAIN_PATH_GATHERS = {
    "wan_100k base gather": ((512, 144, False), "scalar"),
    "wan_100k CRDT winner check": ((256, 144, False), "pairs"),
    "wan_100k sync grants": ((512, 512, False), "pairs"),
    "wan_100k visibility": ((512, 128, True), "scalar"),
    "merge_10k CRDT winner check": ((1024, 144, False), "scalar"),
    "merge_10k sync grants": ((10_000, 512, False), "scalar"),
    "merge_10k visibility": ((10_000, 256, True), "scalar"),
    "merge_10k legacy base gather": ((10_000, 144, False), "scalar"),
    "anywrite_sparse base gather": ((2048, 320, False), "scalar"),
    "anywrite_sparse CRDT winner check": ((256, 320, False), "pairs"),
    "anywrite_sparse sync grants": ((2048, 512, False), "scalar"),
    "anywrite_sparse visibility": ((2048, 256, True), "scalar"),
    "anywrite_sparse cold_sync grants": ((256, 64, False), "scalar"),
}


@pytest.mark.parametrize("site", sorted(MAIN_PATH_GATHERS))
def test_gather_form_at_main_path_shapes(site):
    (w, m, broadcast), form = MAIN_PATH_GATHERS[site]
    assert to.gather_form(w, m, broadcast) == form


def test_gather_form_thresholds():
    # Pairs from m = W/2 up (odd W rounds the half up), never for a
    # broadcast index.
    assert [to.gather_form(512, m, False) for m in (255, 256, 257)] == [
        "scalar", "pairs", "pairs"]
    assert [to.gather_form(511, m, False) for m in (255, 256)] == ["scalar", "pairs"]
    assert to.gather_form(512, 4096, True) == "scalar"
    assert to.GATHER_FORMS == ("scalar", "pairs")

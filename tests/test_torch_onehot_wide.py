"""The port's plain versions of ``rowgather_wide`` and ``rowsum`` are
bit-equal to the JAX reference under its Pallas kernels (interpret mode
on the CPU) and its native backend.

Inputs come from a numpy seed: widths that are not a multiple of 128 and
widths above 2048, negative and out-of-range indices (``rowgather_wide``
clips them; ``rowsum`` drops them), u32 values with bit 31 set that
collide in one column so the sum wraps, masks, and 0-width axes. The CUDA
kernels are held against these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
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
SHAPES = [
    (1, 1, 1), (9, 13, 7), (8, 40, 130), (3, 24, 2100), (16, 144, 300),
    (5, 0, 4), (0, 6, 5), (6, 5, 0),
]


def _t(x):
    x = np.asarray(x)
    return torch.as_tensor(x if x.dtype == np.bool_ else x.astype(np.int64))


def _same(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    return a.shape == b.shape and np.array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("r,m,w", SHAPES)
def test_rowgather_wide(backend, r, m, w):
    g = np.random.default_rng(r * 7 + m + w)
    idx = g.integers(-4, w + 4, (r, m)).astype(np.int32)
    table = g.integers(0, 1 << 32, (r, w), dtype=np.uint64).astype(np.uint32)
    table[:, ::5] |= np.uint32(1 << 31)
    want = jo.rowgather_wide(jnp.asarray(table), jnp.asarray(idx), backend=backend)
    got = to.rowgather_wide(_t(table), _t(idx))
    assert _same(want, got)
    if r and m and w:
        # Out-of-range indices read the edge columns (clip), not 0.
        low = _t(np.full((r, m), -9, np.int32))
        high = _t(np.full((r, m), w + 9, np.int32))
        assert torch.equal(to.rowgather_wide(_t(table), low), _t(table)[:, :1].expand(r, m))
        assert torch.equal(to.rowgather_wide(_t(table), high), _t(table)[:, -1:].expand(r, m))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("r,m,w", SHAPES)
def test_rowsum(backend, r, m, w):
    g = np.random.default_rng(r * 11 + m + w)
    idx = g.integers(-3, w + 3, (r, m)).astype(np.int32)
    if w > 1 and m > 4:
        idx[:, :4] = w // 2  # collisions in one column: the sum wraps
    val = g.integers(0, 1 << 32, (r, m), dtype=np.uint64).astype(np.uint32)
    val[:, ::2] |= np.uint32(1 << 31)
    mask = g.random((r, m)) < 0.7
    for msk in (mask, None):
        want = jo.rowsum(
            jnp.asarray(idx), jnp.asarray(val),
            None if msk is None else jnp.asarray(msk), w, backend=backend,
        )
        got = to.rowsum(_t(idx), _t(val), None if msk is None else _t(msk), w)
        assert _same(want, got)
    if w > 1 and m > 4 and r:
        # The collided column really wrapped past 2^32.
        assert int(val[0, :4].astype(np.uint64).sum()) >= 1 << 32


def test_cpu_tensors_never_count_launches():
    to.reset_launches()
    g = np.random.default_rng(3)
    idx = _t(g.integers(0, 9, (4, 5)))
    val = _t(g.integers(0, 1 << 20, (4, 5)))
    to.rowsum(idx, val, None, 9)
    to.rowgather_wide(_t(g.integers(0, 99, (4, 9))), idx)
    assert all(v == 0 for v in to.LAUNCHES.values())
    assert {"rowgather_wide", "rowsum"} <= set(to.LAUNCHES)


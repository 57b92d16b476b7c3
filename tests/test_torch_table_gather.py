"""``onehot.table_gather`` (the port's counterpart of the reference's
``table_gather_u32``) against the JAX reference run live on the same
inputs: every comparison bit-equal.

The port follows the Pallas and native semantics, which CLIP indices to
the table's ends; those two backends are held on every case, out-of-range
indices included (the Pallas kernel in interpret mode, as the reference's
own CPU tests run it). The reference's dense backend reads a padded 0 for
W <= idx < ceil(W / 128) * 128, so it is held on in-range indices only.
On the CPU the wrapper takes the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import onehot as jo
from corrosion_tpu_torch.ops import onehot as to

torch.set_num_threads(1)


def _table(g, w):
    # u32 values, bit 31 set on about half of them.
    return g.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.uint32)


def _both(table, idx):
    port = to.table_gather(
        torch.as_tensor(table.astype(np.int64)), torch.as_tensor(idx.astype(np.int64))
    )
    assert port.dtype == torch.int64 and tuple(port.shape) == idx.shape
    return port.numpy().astype(np.uint32)


def _ref(table, idx, backend):
    out = jo.table_gather_u32(
        jnp.asarray(table), jnp.asarray(idx.astype(np.int32)), backend=backend
    )
    return np.asarray(out)


# (W, idx shape): widths off and on multiples of 128, the anywrite width,
# 1-D to 3-D index tensors.
CASES = [
    (1, (7,)), (5, (3, 4)), (127, (9, 33)), (128, (2, 3, 5)), (129, (64,)),
    (300, (17, 19)), (2048, (40, 64)), (2049, (8, 300)),
]


@pytest.mark.parametrize("w,shape", CASES)
def test_out_of_range_indices_clip_like_pallas_and_native(w, shape):
    g = np.random.default_rng(w)
    table = _table(g, w)
    # Negative and >= W indices at both ends, the rest in range.
    idx = g.integers(-3 * w - 2, 3 * w + 3, shape)
    got = _both(table, idx)
    for backend in ("pallas", "native"):
        want = _ref(table, idx, backend)
        assert want.dtype == np.uint32 and np.array_equal(got, want), backend
    assert np.array_equal(got, table[np.clip(idx, 0, w - 1)])


@pytest.mark.parametrize("w,shape", CASES)
def test_in_range_indices_match_every_backend(w, shape):
    g = np.random.default_rng(1000 + w)
    table = _table(g, w)
    idx = g.integers(0, w, shape)
    got = _both(table, idx)
    for backend in ("pallas", "native", "dense"):
        assert np.array_equal(got, _ref(table, idx, backend)), backend


@pytest.mark.parametrize(
    "w,shape", [(0, (4, 5)), (0, (0,)), (16, (0,)), (16, (3, 0)), (16, (0, 7))]
)
def test_empty_table_or_index_gives_zeros(w, shape):
    table = _table(np.random.default_rng(w), w)
    idx = np.ones(shape, np.int64)
    got = _both(table, idx)
    assert got.shape == shape and not got.any()
    for backend in ("pallas", "native", "dense"):
        want = _ref(table, idx, backend)
        assert want.shape == shape and np.array_equal(got, want), backend


def test_plain_version_is_the_cpu_path():
    g = np.random.default_rng(3)
    table = torch.as_tensor(_table(g, 77).astype(np.int64))
    idx = torch.as_tensor(g.integers(-10, 90, (6, 11)))
    to.reset_launches()
    assert torch.equal(to.table_gather(table, idx), to.table_gather_plain(table, idx))
    # CPU tensors take the plain version and count no launch.
    assert to.LAUNCHES["table_gather"] == 0

"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present and run
on the chip with

    python -m pytest tests/test_torch_cuda.py -m cuda

(chip_smoke.py runs the same comparisons at the main paths' full shapes).
"""

import numpy as np
import pytest
import torch

from corrosion_tpu_torch.ops import onehot

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, r, m, w, dev):
    g = np.random.default_rng(seed)
    idx = torch.as_tensor(g.integers(-3, w + 3, (r, m)), device=dev)
    val = torch.as_tensor(
        g.integers(0, 1 << 32, (r, m), dtype=np.uint64).astype(np.int64), device=dev
    )
    mask = torch.as_tensor(g.random((r, m)) < 0.7, device=dev)
    return idx, val, mask


# The last two widths take the shared-memory opt-in branch of every row
# kernel (rowmax/rowsum above 12,288 columns, delivery_reduce above 6,144).
SHAPES = [
    (1, 1, 1), (33, 17, 129), (300, 144, 512), (4, 64, 3000), (6, 144, 10_000),
    (3, 50, 16_384),
]


@pytest.mark.parametrize("r,m,w", SHAPES)
def test_kernels_equal_plain(cuda, r, m, w):
    idx, val, mask = _inputs(r + m + w, r, m, w, cuda)
    onehot.reset_launches()
    assert torch.equal(
        onehot.rowmax(idx, val, mask, w), onehot.rowmax_plain(idx, val, mask, w)
    )
    table = val[:, :1].expand(r, w).contiguous() ^ torch.arange(w, device=cuda)
    assert torch.equal(onehot.rowgather(table, idx), onehot.rowgather_plain(table, idx))
    seen = table & 0xFFFF
    d = val & 0xFF
    applied = mask & (d < 100)
    for got, want in zip(
        onehot.delivery_reduce(idx, d, val, applied, mask, seen, w),
        onehot.delivery_reduce_plain(idx, d, val, applied, mask, seen, w),
    ):
        assert torch.equal(got, want)
    for wk in (32, 64):
        oo = (table[None] * 2654435761 & 0xFFFFFFFF).expand(wk // 32, r, w).contiguous()
        adv_m = (val >> 8) & 0x3F
        for got, want in zip(
            onehot.window_delivery(oo, idx, d, adv_m, mask, wk, w),
            onehot.window_delivery_plain(oo, idx, d, adv_m, mask, wk, w),
        ):
            assert torch.equal(got, want)
    assert torch.equal(
        onehot.rowsum(idx, val, mask, w), onehot.rowsum_plain(idx, val, mask, w)
    )
    assert torch.equal(
        onehot.rowgather_wide(table, idx), onehot.rowgather_wide_plain(table, idx)
    )
    assert torch.equal(
        onehot.table_gather(val[0], idx), onehot.table_gather_plain(val[0], idx)
    )
    torch.cuda.synchronize()
    assert onehot.LAUNCHES == {
        "rowmax": 1, "rowgather": 1, "delivery_reduce": 1, "window_delivery": 2,
        "rowgather_wide": 1, "rowsum": 1, "table_gather": 1,
    }


# The row gathers in each form and both semantics: odd m (a scalar tail
# on every other row of the pairs form), odd W, row counts that are not a
# multiple of either form's tile (scalar: 256 outputs; pairs: 512), m at
# the form rule's threshold (W/2) and one either side, and wide rows
# (10,000 and 16,384 columns).
GATHER_SHAPES = [
    (1, 1, 1), (37, 19, 41), (33, 17, 130), (1001, 144, 512), (2001, 36, 256),
    (40, 128, 511), (40, 255, 512), (40, 256, 512), (40, 257, 512),
    (9, 144, 10_000), (3, 50, 16_384),
]


def _gather_cases(seed, r, m, w, dev):
    """(table, idx views): the plain [R, M] index with entries below 0 and
    at or above W, the same at an odd storage offset (not 16-byte
    aligned), and its first row broadcast as [1, M] and as a stride-0
    expand."""
    g = np.random.default_rng(seed)
    table = torch.as_tensor(
        g.integers(0, 1 << 32, (r, w), dtype=np.uint64).astype(np.int64), device=dev
    )
    flat = torch.as_tensor(g.integers(-3, w + 3, r * m + 1), device=dev)
    idx = flat[:-1].view(r, m)
    return table, (idx, flat[1:].view(r, m), idx[:1], idx[:1].expand(r, m))


@pytest.mark.parametrize("r,m,w", GATHER_SHAPES)
@pytest.mark.parametrize("form", [None, "scalar", "pairs"])
def test_row_gathers_equal_plain(cuda, r, m, w, form):
    # form None goes through the public wrappers (the rule picks); a named
    # form is forced through the wrappers' shared launcher.
    table, views = _gather_cases(r * m + w, r, m, w, cuda)
    onehot.reset_launches()
    for ix in views:
        want = onehot.rowgather_plain(table, ix)
        got = (onehot.rowgather(table, ix) if form is None
               else onehot._gather("rowgather", table, ix, False, form))
        assert torch.equal(got, want), ix.stride()
    for ix in views[:2]:
        want = onehot.rowgather_wide_plain(table, ix)
        got = (onehot.rowgather_wide(table, ix) if form is None
               else onehot._gather("rowgather_wide", table, ix, True, form))
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert onehot.LAUNCHES["rowgather"] == 4 and onehot.LAUNCHES["rowgather_wide"] == 2


# Shared-memory staging (16 KB, 128 KB by opt-in) and the global-memory
# path (800 KB); W not a multiple of 128; 1-D to 3-D indices.
@pytest.mark.parametrize(
    "w,shape", [(1, (5,)), (300, (7, 9)), (2048, (16_667, 512)), (16_384, (3, 50, 20)),
                (100_000, (1000, 64))],
)
def test_table_gather_equals_plain(cuda, w, shape):
    g = np.random.default_rng(w)
    table = torch.as_tensor(
        g.integers(0, 1 << 32, w, dtype=np.uint64).astype(np.int64), device=cuda
    )
    idx = torch.as_tensor(g.integers(-w - 3, 2 * w + 3, shape), device=cuda)
    onehot.reset_launches()
    assert torch.equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx))
    torch.cuda.synchronize()
    assert onehot.LAUNCHES["table_gather"] == 1


def test_wrappers_refuse_wrong_inputs(cuda):
    idx, val, mask = _inputs(0, 8, 9, 10, cuda)
    with pytest.raises(TypeError):
        onehot.rowmax(idx.to(torch.int32), val, mask, 10)
    with pytest.raises(ValueError):
        onehot.rowmax(idx, val[:, ::2].contiguous(), mask, 10)
    with pytest.raises(ValueError):
        onehot.rowmax(idx, val.cpu(), mask, 10)
    with pytest.raises(ValueError, match="shared memory"):
        onehot.rowsum(idx, val, mask, onehot.SMEM_LIMIT // 4 + 1)
    with pytest.raises(ValueError):
        onehot.rowgather_wide(val, idx[:, :1].expand(8, 9))
    with pytest.raises(ValueError, match="form"):
        onehot._gather("rowgather", val, idx, False, "tiled")
    with pytest.raises(ValueError):
        onehot.table_gather(val, idx)
    with pytest.raises(ValueError):
        onehot.table_gather(val[0], idx[:, ::2])

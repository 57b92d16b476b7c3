"""Row-local scatter/gather primitives of the data plane, with their CUDA
kernels.

Counterpart of corrosion_tpu/ops/onehot.py. The reference dispatches each
primitive over three backends (native scatter/gather, dense one-hot,
Pallas); all three are bit-identical. Here each primitive has:

- a **plain PyTorch version** (``*_plain``) in the reference's "native"
  form — a scatter or gather with a sentinel column for masked and
  out-of-range entries. It runs for CPU tensors and is what the CUDA
  kernels are held against;
- a **CUDA kernel** (in ``csrc/``, named in ``_SIGNATURES``) launched for
  CUDA tensors. There is no fallback: a CUDA tensor launches the kernel or
  raises.

``LAUNCHES`` counts kernel launches per primitive (never plain calls), so
a run can show that its main path went through the kernels.

Values are u32 carried in int64 (package convention); indices are int64.
"""

from __future__ import annotations

import ctypes

import torch

from corrosion_tpu_torch import cuda_build

MASK = 0xFFFFFFFF

LAUNCHES = {
    "rowmax": 0,
    "rowgather": 0,
    "delivery_reduce": 0,
    "window_delivery": 0,
    "rowgather_wide": 0,
    "rowsum": 0,
    "table_gather": 0,
}

# Shared memory one block may use on Hopper (227 KB of the SM's 256 KB,
# above 48 KB only by opt-in). The row kernels keep their [W] u32
# accumulators there; wider rows raise instead of failing at launch.
SMEM_LIMIT = 232_448

_P = ctypes.c_void_p
_I = ctypes.c_int64
# kernel: (source in csrc/, C symbol, argument types)
_SIGNATURES = {
    "rowmax": ("rowmax", "corro_rowmax", (_P, _P, _P, _P, _I, _I, _I, _P)),
    "rowgather": ("rowgather", "corro_rowgather", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    "delivery_reduce": (
        "delivery_reduce", "corro_delivery_reduce",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    ),
    "window_delivery": (
        "window_delivery", "corro_window_delivery",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    ),
    # One C entry point serves both gathers (a semantics flag).
    "rowgather_wide": (
        "rowgather", "corro_rowgather", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    ),
    "rowsum": ("rowsum", "corro_rowsum", (_P, _P, _P, _P, _I, _I, _I, _P)),
    "table_gather": (
        "table_gather", "corro_table_gather", (_P, _P, _P, _I, _I, _P),
    ),
}
_fns: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, sym, argtypes = _SIGNATURES[name]
        fn = getattr(cuda_build.library(source), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# The raw handle of PyTorch's current stream (an int), without building a
# torch.cuda.Stream object each launch; absent from CPU-only builds.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current device's current stream."""
    stream = (
        torch.cuda.current_stream().cuda_stream if _raw_stream is None
        else _raw_stream(torch._C._cuda_getDevice())
    )
    err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[name] += 1


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (kernel), False for CPU tensors (plain
    version); raises on any other device or a device mix."""
    first = ts[0]
    if first.is_cuda:
        dev = first.get_device()
        if all(t.is_cuda and t.get_device() == dev for t in ts):
            return True
    elif first.is_cpu and all(t.is_cpu for t in ts):
        return False
    devices = {str(t.device) for t in ts}
    if len(devices) > 1:
        raise ValueError(f"tensors span devices {[str(t.device) for t in ts]}")
    raise ValueError(f"unsupported device {first.device}")


def _check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_smem(name: str, n_bytes: int) -> None:
    if n_bytes > SMEM_LIMIT:
        raise ValueError(
            f"{name}: row accumulators need {n_bytes} bytes of shared memory, "
            f"above the {SMEM_LIMIT}-byte limit of one block"
        )


def _sentinel(idx: torch.Tensor, width: int) -> torch.Tensor:
    return torch.where((idx >= 0) & (idx < width), idx, width)


# -- rowmax -------------------------------------------------------------------


def rowmax_plain(idx, val, mask, width: int) -> torch.Tensor:
    """out[r, x] = max over masked m with idx[r, m] == x of val[r, m], 0
    when none (scatter-max into a sentinel-extended row)."""
    r = idx.shape[0]
    if mask is not None:
        idx = torch.where(mask, idx, -1)
        val = torch.where(mask, val, 0)
    out = torch.zeros((r, width + 1), dtype=torch.int64, device=idx.device)
    out.scatter_reduce_(1, _sentinel(idx, width), val, "amax")
    return out[:, :width].contiguous()


def rowmax(idx, val, mask, width: int) -> torch.Tensor:
    """Row-local scatter-max (reference ``onehot.rowmax``). Masked and
    out-of-range entries contribute nothing; int64[R, width]."""
    r, m = idx.shape
    if r == 0 or m == 0 or width == 0:
        return torch.zeros((r, width), dtype=torch.int64, device=idx.device)
    ts = (idx, val) if mask is None else (idx, val, mask)
    if not _on_cuda(*ts):
        return rowmax_plain(idx, val, mask, width)
    _check(idx, "idx", torch.int64)
    _check(val, "val", torch.int64, idx.shape)
    if mask is not None:
        _check(mask, "mask", torch.bool, idx.shape)
    _check_smem("rowmax", 4 * width)
    out = torch.empty((r, width), dtype=torch.int64, device=idx.device)
    _launch(
        "rowmax", idx.data_ptr(), val.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), r, m, width,
    )
    return out


# -- rowsum -------------------------------------------------------------------


def rowsum_plain(idx, val, mask, width: int) -> torch.Tensor:
    """out[r, x] = sum (mod 2^32) over masked m with idx[r, m] == x of
    val[r, m] (scatter-add into a sentinel-extended row)."""
    r, m = idx.shape
    if r == 0 or m == 0 or width == 0:
        return torch.zeros((r, width), dtype=torch.int64, device=idx.device)
    if mask is not None:
        idx = torch.where(mask, idx, -1)
        val = torch.where(mask, val, 0)
    out = torch.zeros((r, width + 1), dtype=torch.int64, device=idx.device)
    out.scatter_add_(1, _sentinel(idx, width), val)
    return (out[:, :width] & MASK).contiguous()


def rowsum(idx, val, mask, width: int) -> torch.Tensor:
    """Row-local scatter-add mod 2^32 (reference ``onehot.rowsum``).
    Masked and out-of-range entries add nothing; int64[R, width]."""
    r, m = idx.shape
    if r == 0 or m == 0 or width == 0:
        return torch.zeros((r, width), dtype=torch.int64, device=idx.device)
    ts = (idx, val) if mask is None else (idx, val, mask)
    if not _on_cuda(*ts):
        return rowsum_plain(idx, val, mask, width)
    _check(idx, "idx", torch.int64)
    _check(val, "val", torch.int64, idx.shape)
    if mask is not None:
        _check(mask, "mask", torch.bool, idx.shape)
    _check_smem("rowsum", 4 * width)
    out = torch.empty((r, width), dtype=torch.int64, device=idx.device)
    _launch(
        "rowsum", idx.data_ptr(), val.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), r, m, width,
    )
    return out


# -- rowgather / rowgather_wide -----------------------------------------------

# The row-gather kernel's forms (csrc/rowgather.cu `Form`, in order):
# "scalar" (one output a thread) and "pairs" (two outputs a thread, 16-byte
# index and output accesses, over tiles of whole rows).
GATHER_FORMS = ("scalar", "pairs")
_I32 = 1 << 31


def gather_form(width: int, m: int, broadcast: bool) -> str:
    """The form a [R, width] <- [R, m] row gather takes. Both were timed at
    every main-path shape in one chip call (PERF.md §6): pairs won where a
    call addresses its rows densely (m >= width / 2, the CRDT winner checks
    and wan_100k's grants), scalar on wide, sparsely addressed rows and
    broadcast indices (merge_10k, visibility), the two tied between."""
    return "pairs" if not broadcast and 2 * m >= width else "scalar"


def _gather(name: str, table, idx, clip: bool, form=None) -> torch.Tensor:
    """Launch the row-gather kernel on checked CUDA inputs in ``form``
    (None: ``gather_form``; tests and chip_smoke.py force each form);
    ``idx`` has unit column stride and row stride 0 (broadcast) or M."""
    r, width = table.shape
    m = idx.shape[1]
    if max(r, m, width) >= _I32:
        raise ValueError(f"{name}: rows, columns and width must each be below 2^31")
    broadcast = idx.shape[0] == 1 or idx.stride(0) == 0
    if form is None:
        form = gather_form(width, m, broadcast)
    elif form not in GATHER_FORMS:
        raise ValueError(f"{name}: form must be one of {GATHER_FORMS}, got {form!r}")
    out = table.new_empty((r, m))
    _launch(
        name, table.data_ptr(), idx.data_ptr(), out.data_ptr(), r, m, width,
        0 if broadcast else m, int(clip), GATHER_FORMS.index(form),
    )
    return out


def rowgather_plain(table, idx) -> torch.Tensor:
    """out[r, m] = table[r, idx[r, m]], 0 when idx < 0 or idx >= W."""
    r, width = table.shape
    idx = idx.expand(r, -1)
    if width == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=table.device)
    ok = (idx >= 0) & (idx < width)
    got = torch.gather(table, 1, torch.where(ok, idx, 0))
    return torch.where(ok, got, 0)


def rowgather(table, idx) -> torch.Tensor:
    """Row-local gather (reference ``onehot.rowgather``, native
    semantics). ``idx`` may broadcast one row over all rows (row stride
    0, e.g. ``cols[None, :].expand(N, S)``)."""
    r, width = table.shape
    m = idx.shape[1]
    if r == 0 or m == 0 or width == 0:
        return torch.zeros((r, m), dtype=torch.int64, device=table.device)
    if not _on_cuda(table, idx):
        return rowgather_plain(table, idx)
    _check(table, "table", torch.int64)
    if idx.dtype != torch.int64:
        raise TypeError(f"idx: expected torch.int64, got {idx.dtype}")
    if idx.shape[0] not in (1, r) or idx.stride(1) != 1 or idx.stride(0) not in (0, m):
        raise ValueError("idx: needs unit column stride and row stride 0 or M")
    return _gather("rowgather", table, idx, False)


def rowgather_wide_plain(table, idx) -> torch.Tensor:
    """out[r, m] = table[r, clip(idx[r, m], 0, W - 1)] (the reference's
    native ``take_along_axis`` on the clipped index)."""
    r, width = table.shape
    if r == 0 or idx.shape[1] == 0 or width == 0:
        return torch.zeros((r, idx.shape[1]), dtype=torch.int64, device=table.device)
    return torch.gather(table, 1, torch.clamp(idx, 0, width - 1))


def rowgather_wide(table, idx) -> torch.Tensor:
    """Per-row gather from a wide table (reference
    ``onehot.rowgather_wide``). Out-of-range indices CLIP to the edge
    columns, where ``rowgather`` reads 0."""
    r, width = table.shape
    m = idx.shape[1]
    if r == 0 or m == 0 or width == 0:
        return torch.zeros((r, m), dtype=torch.int64, device=table.device)
    if not _on_cuda(table, idx):
        return rowgather_wide_plain(table, idx)
    _check(table, "table", torch.int64)
    _check(idx, "idx", torch.int64, (r, m))
    return _gather("rowgather_wide", table, idx, True)


# -- table_gather -------------------------------------------------------------


def table_gather_plain(table, idx) -> torch.Tensor:
    """out[...] = table[clip(idx[...], 0, W - 1)]; zeros of ``idx``'s shape
    when W == 0 or ``idx`` is empty."""
    width = table.shape[0]
    if width == 0 or idx.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    return table[torch.clamp(idx, 0, width - 1)]


def table_gather(table, idx) -> torch.Tensor:
    """Gather from one shared 1-D table (reference
    ``onehot.table_gather_u32``, its Pallas and native semantics): indices
    CLIP to the table's ends. int64 of ``idx``'s shape."""
    width = table.shape[0]
    if width == 0 or idx.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    if not _on_cuda(table, idx):
        return table_gather_plain(table, idx)
    _check(table, "table", torch.int64, (width,))
    _check(idx, "idx", torch.int64)
    out = torch.empty(idx.shape, dtype=torch.int64, device=idx.device)
    _launch(
        "table_gather", table.data_ptr(), idx.data_ptr(), out.data_ptr(),
        idx.numel(), width,
    )
    return out


# -- delivery_reduce ----------------------------------------------------------


def delivery_reduce_plain(idx, d, v, applied, valid, seen, width: int):
    adv = rowmax_plain(idx, d, applied, width)
    return adv, torch.maximum(seen, rowmax_plain(idx, v, valid, width))


def delivery_reduce(idx, d, v, applied, valid, seen, width: int):
    """Fused delivery reductions (reference ``onehot.delivery_reduce``):
    ``(rowmax(idx, d, applied), max(seen, rowmax(idx, v, valid)))``. Both
    are new tensors, never ``seen`` itself."""
    r, m = idx.shape
    if r == 0 or m == 0 or width == 0:
        return (
            torch.zeros((r, width), dtype=torch.int64, device=idx.device),
            seen.clone(),
        )
    if not _on_cuda(idx, d, v, applied, valid, seen):
        return delivery_reduce_plain(idx, d, v, applied, valid, seen, width)
    _check(idx, "idx", torch.int64)
    for t, name in ((d, "d"), (v, "v")):
        _check(t, name, torch.int64, idx.shape)
    for t, name in ((applied, "applied"), (valid, "valid")):
        _check(t, name, torch.bool, idx.shape)
    _check(seen, "seen", torch.int64, (r, width))
    _check_smem("delivery_reduce", 8 * width)
    adv = torch.empty((r, width), dtype=torch.int64, device=idx.device)
    seen2 = torch.empty_like(adv)
    _launch(
        "delivery_reduce", idx.data_ptr(), d.data_ptr(), v.data_ptr(),
        applied.data_ptr(), valid.data_ptr(), seen.data_ptr(),
        adv.data_ptr(), seen2.data_ptr(), r, m, width,
    )
    return adv, seen2


# -- window_delivery ----------------------------------------------------------


def _window_empty(oo, idx):
    # Degenerate axes admit nothing (the reference's early return).
    return (
        torch.zeros(idx.shape, dtype=torch.bool, device=idx.device),
        torch.zeros(tuple(oo.shape), dtype=torch.int64, device=idx.device),
    )


def window_compose(oo, idx, d, adv_m, valid, wk: int, width: int, gather, assemble):
    """Out-of-order admission as a gather/sum composition (the reference's
    non-Pallas ``window_delivery`` and ``gossip._window_admit`` generic
    branch), u32 wraparound made explicit. ``gather(word_plane)`` reads
    each message's word ([R, W] -> [R, M]); ``assemble(contrib)`` sums the
    per-message bits into their columns ([R, M] -> [R, W])."""
    d_rel = (d - adv_m) & MASK
    in_win = valid & (d > adv_m) & (d_rel <= wk)
    bit_old = (d - 1) & MASK
    prev = torch.zeros_like(in_win)
    for b in range(oo.shape[0]):
        word = gather(oo[b])
        sh = torch.clamp((bit_old - 32 * b) & MASK, max=31)
        inb = (bit_old >= 32 * b) & (bit_old < 32 * (b + 1))
        prev = prev | (inb & (((word >> sh) & 1) == 1))
    new_poss = in_win & ~prev
    bit_new = (d_rel - 1) & MASK
    words = []
    for b in range(oo.shape[0]):
        sh = torch.clamp((bit_new - 32 * b) & MASK, max=31)
        inb = new_poss & (bit_new >= 32 * b) & (bit_new < 32 * (b + 1))
        words.append(assemble(torch.where(inb, 1 << sh, 0)))
    return new_poss, torch.stack(words)


def window_delivery_plain(oo, idx, d, adv_m, valid, wk: int, width: int):
    """The rowgather/rowsum composition of the reference's non-Pallas
    branch."""
    if min(idx.shape) == 0 or width == 0:
        return _window_empty(oo, idx)
    return window_compose(
        oo, idx, d, adv_m, valid, wk, width,
        lambda word: rowgather_plain(word, idx),
        lambda contrib: rowsum_plain(idx, contrib, None, width),
    )


def window_delivery(oo, idx, d, adv_m, valid, wk: int, width: int):
    """Out-of-order admission (reference ``onehot.window_delivery``):
    ``(new_poss bool[R, M], new_bits int64[B, R, W])``."""
    b_words = oo.shape[0]
    r, m = idx.shape
    if r == 0 or m == 0 or width == 0:
        return _window_empty(oo, idx)
    if not _on_cuda(oo, idx, d, adv_m, valid):
        return window_delivery_plain(oo, idx, d, adv_m, valid, wk, width)
    _check(oo, "oo", torch.int64, (b_words, r, width))
    _check(idx, "idx", torch.int64)
    for t, name in ((d, "d"), (adv_m, "adv_m")):
        _check(t, name, torch.int64, idx.shape)
    _check(valid, "valid", torch.bool, idx.shape)
    _check_smem("window_delivery", 4 * b_words * width)
    poss = torch.empty((r, m), dtype=torch.bool, device=idx.device)
    words = torch.empty((b_words, r, width), dtype=torch.int64, device=idx.device)
    _launch(
        "window_delivery", oo.data_ptr(), idx.data_ptr(), d.data_ptr(),
        adv_m.data_ptr(), valid.data_ptr(), poss.data_ptr(), words.data_ptr(),
        b_words, r, m, width, wk,
    )
    return poss, words

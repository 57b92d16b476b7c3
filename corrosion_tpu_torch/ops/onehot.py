"""Row-local scatter/gather primitives of the data plane, with their CUDA
kernels.

Counterpart of corrosion_tpu/ops/onehot.py. The reference dispatches each
primitive over three backends (native scatter/gather, dense one-hot,
Pallas); all three are bit-identical. Here each primitive has:

- a **plain PyTorch version** (``*_plain``) in the reference's "native"
  form — a scatter or gather with a sentinel column for masked and
  out-of-range entries. It runs for CPU tensors and is what the CUDA
  kernels are held against;
- a **CUDA kernel** (``csrc/*.cu``) launched for CUDA tensors through its
  PyTorch operator ``torch.ops.corro.<op>`` (``csrc/ops.cpp``, which checks
  the inputs, allocates the outputs and launches on the current stream).
  There is no fallback: a CUDA tensor launches the kernel or raises.

The wrappers stay as thin as a PyTorch call: whether the first tensor lies
on the card picks the route, and every other check is the operator's.
``LAUNCHES`` counts kernel launches per primitive (never plain calls), so
a run can show that its main path went through the kernels.

Values are u32 carried in int64 (package convention); indices are int64.
"""

from __future__ import annotations

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

# The operators of csrc/ops.cpp; rowgather serves both row gathers.
OPERATORS = (
    "rowmax", "rowsum", "rowgather", "table_gather", "delivery_reduce", "window_delivery",
)
# Operator name -> its OpOverload (torch.ops.corro.<name>.default), filled
# at the first launch, which builds and loads the library.
_OPS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ops() -> dict:
    if not _OPS:
        cuda_build.load()
        _OPS.update((name, getattr(torch.ops.corro, name).default) for name in OPERATORS)
    return _OPS


def _check_cpu(*ts) -> None:
    """The plain versions take CPU tensors (None: an absent mask); raises
    ValueError on a device mix or a device that is neither CPU nor CUDA."""
    if all(t is None or t.is_cpu for t in ts):
        return
    devices = [str(t.device) for t in ts if t is not None]
    if len(set(devices)) > 1:
        raise ValueError(f"tensors span devices {devices}")
    raise ValueError(f"unsupported device {devices[0]}")


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
    if not idx.is_cuda:
        _check_cpu(idx, val, mask)
        return rowmax_plain(idx, val, mask, width)
    if width == 0 or idx.numel() == 0:
        return torch.zeros((idx.shape[0], width), dtype=torch.int64, device=idx.device)
    out = (_OPS or _ops())["rowmax"](idx, val, mask, width)
    LAUNCHES["rowmax"] += 1
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
    if not idx.is_cuda:
        _check_cpu(idx, val, mask)
        return rowsum_plain(idx, val, mask, width)
    if width == 0 or idx.numel() == 0:
        return torch.zeros((idx.shape[0], width), dtype=torch.int64, device=idx.device)
    out = (_OPS or _ops())["rowsum"](idx, val, mask, width)
    LAUNCHES["rowsum"] += 1
    return out


# -- rowgather / rowgather_wide -----------------------------------------------

# The row-gather kernel's forms (csrc/rowgather.cu `Form`, in order):
# "scalar" (one output a thread) and "pairs" (two outputs a thread, 16-byte
# index and output accesses, over tiles of whole rows); the operator takes
# a form's position here.
GATHER_FORMS = ("scalar", "pairs")


def gather_form(width: int, m: int, broadcast: bool) -> str:
    """The form a [R, width] <- [R, m] row gather takes. Both were timed at
    every main-path shape in one chip call (PERF.md §6): pairs won where a
    call addresses its rows densely (m >= width / 2, the CRDT winner checks
    and wan_100k's grants), scalar on wide, sparsely addressed rows and
    broadcast indices (merge_10k, visibility), the two tied between."""
    return "pairs" if not broadcast and 2 * m >= width else "scalar"


def _gather(name: str, table, idx, clip: bool, form=None) -> torch.Tensor:
    """Launch the row-gather kernel on non-empty CUDA inputs (``clip``:
    ``rowgather_wide``'s semantics) in ``form`` (None: ``gather_form``'s
    rule; tests and chip_smoke.py force each form), counted under ``name``.
    The operator checks the inputs."""
    if form is None:
        broadcast = idx.shape[0] == 1 or idx.stride(0) == 0
        form = gather_form(table.shape[-1], idx.shape[1], broadcast)
    if form not in GATHER_FORMS:
        raise ValueError(f"{name}: form must be one of {GATHER_FORMS}, got {form!r}")
    out = (_OPS or _ops())["rowgather"](table, idx, clip, GATHER_FORMS.index(form))
    LAUNCHES[name] += 1
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
    if not table.is_cuda:
        _check_cpu(table, idx)
        return rowgather_plain(table, idx)
    if table.numel() == 0 or idx.shape[1] == 0:
        return torch.zeros((table.shape[0], idx.shape[1]), dtype=torch.int64, device=table.device)
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
    if not table.is_cuda:
        _check_cpu(table, idx)
        return rowgather_wide_plain(table, idx)
    if table.numel() == 0 or idx.shape[1] == 0:
        return torch.zeros((table.shape[0], idx.shape[1]), dtype=torch.int64, device=table.device)
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
    if not table.is_cuda:
        _check_cpu(table, idx)
        return table_gather_plain(table, idx)
    if table.shape[0] == 0 or idx.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    out = (_OPS or _ops())["table_gather"](table, idx)
    LAUNCHES["table_gather"] += 1
    return out


# -- delivery_reduce ----------------------------------------------------------


def delivery_reduce_plain(idx, d, v, applied, valid, seen, width: int):
    adv = rowmax_plain(idx, d, applied, width)
    return adv, torch.maximum(seen, rowmax_plain(idx, v, valid, width))


def delivery_reduce(idx, d, v, applied, valid, seen, width: int):
    """Fused delivery reductions (reference ``onehot.delivery_reduce``):
    ``(rowmax(idx, d, applied), max(seen, rowmax(idx, v, valid)))``. Both
    are new tensors, never ``seen`` itself."""
    if not idx.is_cuda:
        _check_cpu(idx, d, v, applied, valid, seen)
        return delivery_reduce_plain(idx, d, v, applied, valid, seen, width)
    if width == 0 or idx.numel() == 0:
        return (
            torch.zeros((idx.shape[0], width), dtype=torch.int64, device=idx.device),
            seen.clone(),
        )
    out = (_OPS or _ops())["delivery_reduce"](idx, d, v, applied, valid, seen, width)
    LAUNCHES["delivery_reduce"] += 1
    return out


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
    if not oo.is_cuda:
        _check_cpu(oo, idx, d, adv_m, valid)
        return window_delivery_plain(oo, idx, d, adv_m, valid, wk, width)
    if width == 0 or idx.numel() == 0:
        return _window_empty(oo, idx)
    out = (_OPS or _ops())["window_delivery"](oo, idx, d, adv_m, valid, wk, width)
    LAUNCHES["window_delivery"] += 1
    return out

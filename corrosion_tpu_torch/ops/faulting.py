"""Fault injection shared by the kernel planes (counterpart of
corrosion_tpu/ops/faulting.py).

``apply_loss``: receiver-side independent drop; a static config
probability and a dynamic per-round one compose as independent processes
(``p = a + b - a*b``). With no loss configured the mask passes through and
no random numbers are drawn — the reference's static zero-cost skip. A
shard body draws at the full row count and keeps its rows (``full_rows``).

``wipe_nodes``: crash-with-state-wipe on the data plane; the membership
twin is ``swim.apply_churn(..., wipe=...)``.
"""

from __future__ import annotations

import torch

from corrosion_tpu_torch import rng as rng_mod


def apply_loss(key, ok, static_prob: float, dyn_prob=None, full_rows=None):
    """Drop each deliverable message with the combined loss probability.
    Returns ``(ok', lost_count)``. ``full_rows`` = ``(n_total, row_start)``
    is a shard body's: the mask is drawn at the full leading-row shape and
    this shard's rows are sliced out, so the drops do not depend on the
    mesh."""
    if static_prob <= 0.0 and dyn_prob is None:
        return ok, torch.zeros((), dtype=torch.int64, device=ok.device)
    if full_rows is None:
        u = rng_mod.uniform(key, tuple(ok.shape))
    else:
        n_total, row_start = full_rows
        u = rng_mod.uniform(key, (n_total,) + tuple(ok.shape[1:]))
        u = u[row_start : row_start + ok.shape[0]]
    p = torch.tensor(static_prob, dtype=torch.float32, device=ok.device)
    if dyn_prob is not None:
        d = dyn_prob.to(torch.float32)
        p = p + d - p * d
    lost = ok & (u < p)
    return ok & ~lost, lost.sum()


def wipe_nodes(data, wipe, cfg):
    """Reset the wiped nodes' replica state as a restart from an empty
    disk would: ``contig``/``seen`` rows, window words, pending queue
    entries, duplicate counters and the CRDT cell shard. ``head`` — the
    cluster's ledger of committed versions — survives. Returns the new
    DataState."""
    w = wipe[:, None]
    oo, oo_any = data.oo, data.oo_any
    if oo.shape[0] > 0:
        oo = torch.where(wipe[None, :, None], 0, oo)
        # The reference recomputes the flag only when it was set (a
        # ``lax.cond``); AND-ing gives the same value without a host read.
        oo_any = oo_any & oo.any()
    cells = data.cells
    if cfg.n_cells > 0:
        keep = (~wipe).repeat_interleave(cfg.n_cells)
        cells = type(cells)(*(torch.where(keep, c, 0) for c in cells))
    return data._replace(
        contig=torch.where(w, 0, data.contig),
        seen=torch.where(w, 0, data.seen),
        oo=oo, oo_any=oo_any,
        q_writer=torch.where(w, -1, data.q_writer),
        q_tx=torch.where(w, 0, data.q_tx),
        q_dup=torch.where(w, 0, data.q_dup),
        cells=cells,
    )

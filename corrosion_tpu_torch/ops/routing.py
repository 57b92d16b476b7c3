"""Message-routing primitives shared by the gossip planes.

Counterpart of corrosion_tpu/ops/routing.py. The reference's
``lax.sort`` calls with payload operands become one stable ``torch.sort``
of the key plus a gather per payload; stability keeps the reference's
deterministic tie order.
"""

from __future__ import annotations

import torch


def bounded_intake(recv, valid, payloads, n_rows: int, k: int):
    """Route flat messages to per-receiver slots, at most ``k`` per
    receiver, lowest flat message index first. Returns
    ``(mask[N, k], payloads_out)`` with each payload as [N, k]."""
    m = recv.shape[0]
    dev = recv.device
    key = torch.where(valid, recv, n_rows)
    s_key, order = torch.sort(key, stable=True)
    idxs = torch.arange(m, device=dev)
    first = torch.ones(m, dtype=torch.bool, device=dev)
    first[1:] = s_key[1:] != s_key[:-1]
    run_first = torch.cummax(torch.where(first, idxs, 0), dim=0).values
    rank = idxs - run_first
    ok = (s_key < n_rows) & (rank < k)
    slot = torch.where(ok, s_key * k + rank, n_rows * k)
    mask = torch.zeros(n_rows * k + 1, dtype=torch.bool, device=dev)
    mask[slot] = ok
    outs = []
    for p in payloads:
        sp = p[order]
        out = torch.zeros(n_rows * k + 1, dtype=p.dtype, device=dev)
        out[slot] = torch.where(ok, sp, 0).to(p.dtype)
        outs.append(out[:-1].reshape(n_rows, k))
    return mask[:-1].reshape(n_rows, k), tuple(outs)


def segmented_prefix_and_rows(flags, seg_start):
    """Per-segment running AND of ``flags`` along each row (segments
    confined to a row, starts marked by ``seg_start``)."""
    notf = (~flags).to(torch.int64)
    bad = torch.cumsum(notf, dim=1)
    g = bad - notf  # bad count strictly before i
    bad_before = torch.cummax(torch.where(seg_start, g, -1), dim=1).values
    return (bad - bad_before) == 0


def segmented_running_max(vals, seg_start, band: int):
    """Per-segment inclusive running max of ``vals`` (< band) along each
    row, via a cummax over ``segment_id * band + val``."""
    k = vals.shape[1]
    if (k + 1) * band > (1 << 32):
        raise ValueError("segment banding overflows u32")
    seg_id = torch.cumsum(seg_start.to(torch.int64), dim=1)
    packed = seg_id * band + vals
    return torch.cummax(packed, dim=1).values % band


def rebuild_bounded_queue(cand_valid, cand_prio, payloads, capacity: int):
    """Keep the ``capacity`` highest-priority candidates per row, sorted
    by descending priority (invalid candidates last; stable ties).
    Priorities must be int32-safe. Returns (mask[N, cap], payloads)."""
    neg_inf = -(2**31) + 1
    prio = torch.where(
        cand_valid, torch.clamp(cand_prio, min=neg_inf + 1), neg_inf
    )
    s_key, order = torch.sort(-prio, dim=1, stable=True)
    order = order[:, :capacity]
    mask = s_key[:, :capacity] < -neg_inf
    outs = tuple(torch.gather(p, 1, order) for p in payloads)
    return mask, outs

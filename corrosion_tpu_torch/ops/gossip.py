"""Changeset broadcast + anti-entropy sync (the data plane), in PyTorch.

Counterpart of corrosion_tpu/ops/gossip.py for the dense engine's main
path: both delivery paths of ``_broadcast_round`` (the fast
one-hot path for W <= ``_FAST_MAX_WRITERS`` under fresh per-holder
budgets, and the legacy sort+scatter path for wider writer axes, stale
re-admission or inherited budgets), the anti-entropy sessions of
``_sync_round``/``_sync_rows`` with exact and digest candidate scoring,
``revive_sync``, the out-of-order possession window, and the tracking
reads (``visibility``, ``total_need``, ``staleness``, ``queue_backlog``).
``track_writer_ids`` carries each queued version's global writer id beside
its slot, for the rotating writer slots of ``ops/sparse_writers.py``.
The module docstring of the reference describes the model.

The underscored bodies (``_broadcast_round``, ``_sync_round``,
``_revive_sync``, ``_sync_rows``) run over one mesh position's rows of the
node axis (``ops/exchange.py``): the broadcast plane reads the gathered
queue tables, the sync sessions read their candidates' and peers' rows by
``Rows`` gathers from their owners and draw by session entry, and the
tracking reads give per-position partials (``_need_part``,
``_staleness_parts``). The public functions are the same bodies on one
position holding every row.

The adaptive-dissemination plane rides the same rounds, each mechanism
off by default: the duplicate-receipt rumor kill (``rumor_kill_k``, with
the per-entry counter ``q_dup``), push->pull switching
(``pull_switch_age``: far-slot suppression and an escalated pull),
age-targeted intake (``age_forward``), bucketed sync sketches
(``sync_sketch_buckets``), and the propagation observables
(``prop_observe``: the region link matrix and the useful/duplicate split).

Data-dependent ``lax.cond`` branches become Python ``if`` on a 0-d
tensor: one device-to-host sync each, counted in ``HOST_SYNCS`` together
with the row scatters that drop padded rows (``mode="drop"`` in the
reference), which read their row mask on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import crdt, exchange, faulting, onehot, routing

MASK = 0xFFFFFFFF

# Writer-axis width above which delivery switches from the fast one-hot
# path to the legacy sort+scatter path (module-level so tests can force
# either path at small sizes).
_FAST_MAX_WRITERS = 2048
# Row x writer x candidate volume above which candidate scoring falls
# back from the exact per-writer deficit to the total-progress digest
# (module-level so tests can force digest mode at small sizes).
_EXACT_SCORE_MAX = 1 << 25
# Digest quantization (reference ``_DIGEST_QUANT``/``_DIGEST_SAT``).
_DIGEST_QUANT: str | None = "bf16"
_DIGEST_SAT = {"u8": 255, "bf16": 256}

HOST_SYNCS = {"branch": 0, "drop_scatter": 0}


def reset_host_syncs() -> None:
    for k in HOST_SYNCS:
        HOST_SYNCS[k] = 0


# corro-lint: disable=CT004 reason=the round's counted sync: a lax.cond predicate read on the host, tallied in HOST_SYNCS["branch"]
def _branch(pred: torch.Tensor) -> bool:
    """A ``lax.cond`` predicate read on the host (one device sync)."""
    HOST_SYNCS["branch"] += 1
    return bool(pred)


# corro-lint: disable=CT001 reason=the round's counted sync: the drop-scatter's row mask read on the host, tallied in HOST_SYNCS["drop_scatter"]
def _ok_rows(rows: torch.Tensor, row_ok: torch.Tensor) -> torch.Tensor:
    """Positions of rows whose scatter lands (``mode="drop"`` on the
    rest); reads the mask on the host."""
    HOST_SYNCS["drop_scatter"] += 1
    return torch.nonzero(row_ok).squeeze(1)


@dataclass(frozen=True)
class GossipConfig:
    """Field for field the reference's GossipConfig (see its comments).
    ``kernel_backend`` is accepted and ignored: here the tensors' device
    picks the kernel (CUDA) or the plain version (CPU)."""

    n_nodes: int
    n_writers: int
    queue: int = 16
    max_writes_per_round: int = 4
    fanout_near: int = 2
    fanout_far: int = 2
    max_transmissions: int = 6
    loss_prob: float = 0.0
    sync_interval: int = 10
    sync_budget: int = 256
    sync_chunk: int = 64
    sync_peers: int = 3
    sync_candidates: int = 8
    rebroadcast_fresh_budget: bool = True
    rebroadcast_stale: bool = False
    rebroadcast_intake: int = 0
    queue_priority: str = "budget"
    n_cells: int = 0
    cells_per_write: int = 1
    window_k: int = 32
    track_writer_ids: bool = False
    kernel_backend: str | None = None
    prop_observe: bool = False
    rumor_kill_k: int = 0
    pull_switch_age: int = 0
    age_forward: bool = False
    sync_sketch_buckets: int = 0

    def __post_init__(self):
        if self.window_k < 0 or self.window_k % 32 != 0:
            raise ValueError(
                f"window_k must be a non-negative multiple of 32, got "
                f"{self.window_k}"
            )
        if self.sync_peers > self.sync_candidates:
            raise ValueError(
                f"sync_peers ({self.sync_peers}) must be <= "
                f"sync_candidates ({self.sync_candidates})"
            )
        if self.rebroadcast_fresh_budget and self.rebroadcast_stale:
            raise ValueError(
                "rebroadcast_fresh_budget requires rebroadcast_stale=False"
            )
        if self.queue_priority not in ("version", "budget"):
            raise ValueError(
                f"queue_priority must be 'version' or 'budget', got "
                f"{self.queue_priority!r}"
            )
        for name in ("rumor_kill_k", "pull_switch_age", "sync_sketch_buckets"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = off)")
        if self.age_forward and self.rebroadcast_stale:
            raise ValueError(
                "age_forward orders the intake by version age; under "
                "rebroadcast_stale the intake re-admits already-held old "
                "versions, which the age priority would starve: enable one "
                "or the other"
            )

    @property
    def fanout(self) -> int:
        return self.fanout_near + self.fanout_far


class Topology(NamedTuple):
    """Region layout + writer placement + rings (reference Topology)."""

    region: torch.Tensor  # [N] region id per node
    region_start: torch.Tensor  # [N] first node index of own region
    region_size: torch.Tensor  # [N] size of own region
    region_rtt: torch.Tensor  # [R, R] ring bucket per region pair (0-5)
    writer_nodes: torch.Tensor  # [W] node hosting each writer stream
    writer_of_node: torch.Tensor  # [N] writer index or -1
    sync_phase: torch.Tensor  # [N] per-node sync jitter offset
    sync_cohorts: torch.Tensor | None = None  # [interval, ceil(N/interval)]
    writer_ids: torch.Tensor | None = None  # [W] global id per writer column


def make_topology(
    region_sizes: list[int], writer_nodes, seed: int = 0, region_rtt=None,
    sync_interval: int | None = None, device=None,
) -> Topology:
    """Host-side topology builder, identical draws to the reference's
    (numpy ``default_rng(seed)``); ``region_rtt`` None = flat ring 1,
    "geo" = circle geography with graded rings, or an [R, R] matrix."""
    device = resolve_device(device)
    n = int(sum(region_sizes))
    r_count = len(region_sizes)
    region = np.zeros(n, np.int64)
    rstart = np.zeros(n, np.int64)
    rsize = np.zeros(n, np.int64)
    off = 0
    for rid, sz in enumerate(region_sizes):
        region[off : off + sz] = rid
        rstart[off : off + sz] = off
        rsize[off : off + sz] = sz
        off += sz
    if region_rtt is None:
        rtt = np.ones((r_count, r_count), np.int64)
        np.fill_diagonal(rtt, 0)
    elif isinstance(region_rtt, str) and region_rtt == "geo":
        d = np.abs(np.arange(r_count)[:, None] - np.arange(r_count)[None, :])
        d = np.minimum(d, r_count - d)
        max_d = max(int(d.max()), 1)
        rtt = np.ceil(d / max_d * 5).astype(np.int64)
    else:
        rtt = np.asarray(region_rtt, np.int64)
        if rtt.shape != (r_count, r_count):
            raise ValueError(f"region_rtt must be [{r_count}, {r_count}]")
    writer_nodes = np.asarray(writer_nodes, np.int64)
    won = np.full(n, -1, np.int64)
    won[writer_nodes] = np.arange(len(writer_nodes))
    rng = np.random.default_rng(seed)
    if sync_interval is None:
        phase = rng.integers(0, 1 << 30, n).astype(np.int64)
        cohorts = None
    else:
        perm = rng.permutation(n)
        phase = np.empty(n, np.int64)
        phase[perm] = np.arange(n) % sync_interval
        nc = -(-n // sync_interval)
        cohorts = np.full((sync_interval, nc), -1, np.int64)
        for c in range(sync_interval):
            members = np.nonzero(phase == c)[0]
            cohorts[c, : len(members)] = members

    def t(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    return Topology(
        region=t(region),
        region_start=t(rstart),
        region_size=t(rsize),
        region_rtt=t(rtt),
        writer_nodes=t(writer_nodes),
        writer_of_node=t(won),
        sync_phase=t(phase),
        sync_cohorts=None if cohorts is None else t(cohorts),
    )


class DataState(NamedTuple):
    """Per-node replica state (reference DataState; u32 in int64)."""

    head: torch.Tensor  # [W] writer's committed version head
    contig: torch.Tensor  # [N, W] contiguous watermark
    seen: torch.Tensor  # [N, W] highest version heard of
    oo: torch.Tensor  # [B, N, W] out-of-order window words
    oo_any: torch.Tensor  # bool[] any window bit set anywhere
    q_writer: torch.Tensor  # [N, Q] (-1 = empty)
    q_ver: torch.Tensor  # [N, Q]
    q_tx: torch.Tensor  # [N, Q] transmissions left
    q_gw: torch.Tensor  # [N, Q] global writer id (Q=0 unless track_writer_ids)
    q_dup: torch.Tensor  # [N, Q] duplicate receipts (Q=0 unless rumor_kill_k)
    cells: crdt.CellState  # [N * K] x3 per-node registers


def init_data(cfg: GossipConfig, device=None, n_rows: int | None = None) -> DataState:
    """The initial state; ``n_rows`` builds just a position's block of
    that many rows (the writer heads and the window flag whole)."""
    device = resolve_device(device)
    w, q = cfg.n_writers, cfg.queue
    n = cfg.n_nodes if n_rows is None else n_rows

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    return DataState(
        head=z(w),
        contig=z(n, w),
        seen=z(n, w),
        oo=z(cfg.window_k // 32, n, w),
        oo_any=torch.zeros((), dtype=torch.bool, device=device),
        q_writer=torch.full((n, q), -1, dtype=torch.int64, device=device),
        q_ver=z(n, q),
        q_tx=z(n, q),
        q_gw=z(n, q if cfg.track_writer_ids else 0),
        q_dup=z(n, q if cfg.rumor_kill_k > 0 else 0),
        cells=crdt.make_cells(n * cfg.n_cells, device),
    )


# -- out-of-order possession window -------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 (``lax.population_count``, which torch lacks)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def _trailing_ones(oo: torch.Tensor) -> torch.Tensor:
    """Consecutive set bits from bit 0 of the B-word field."""
    t = torch.zeros(oo.shape[1:], dtype=torch.int64, device=oo.device)
    carry = torch.ones(oo.shape[1:], dtype=torch.bool, device=oo.device)
    for b in range(oo.shape[0]):
        tb = popcount32(oo[b] & (((oo[b] + 1) & MASK) ^ MASK))
        t = t + torch.where(carry, tb, 0)
        carry = carry & (tb == 32)
    return t


def _window_shift(oo: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Right-shift the B-word bitfield by t (0 <= t <= 32B)."""
    nw = oo.shape[0]
    outs = []
    for i in range(nw):
        acc = torch.zeros_like(oo[i])
        for j in range(i, nw):
            s = t - 32 * (j - i)
            sr = torch.clamp(s, 0, 31)
            sl = torch.clamp(-s, 0, 31)
            acc = (
                acc
                | torch.where((s >= 0) & (s < 32), oo[j] >> sr, 0)
                | torch.where((s > -32) & (s < 0), (oo[j] << sl) & MASK, 0)
            )
        outs.append(acc)
    return torch.stack(outs) if nw else oo


def window_absorb(contig, oo, adv, new_bits):
    """Advance contig by ``adv``, fold ``new_bits`` into the window, then
    promote through the now-contiguous prefix. Returns (contig', oo')."""
    oo = _window_shift(oo, adv) | new_bits
    t = _trailing_ones(oo)
    return contig + adv + t, _window_shift(oo, t)


def _window_admit(oo, contig_pre, adv, adv_m, d, valid, wk: int, fast_idx, width: int):
    """Fast-path out-of-order admission: the fused window kernel decides
    and assembles, then the window absorbs. Returns (contig', oo',
    newly_possessed)."""
    new_poss, words = onehot.window_delivery(
        oo, fast_idx, d, adv_m, valid, wk, width
    )
    contig2, oo2 = window_absorb(contig_pre, oo, adv, words)
    return contig2, oo2, new_poss


def digest_quantize(defc: torch.Tensor, sync_budget: int) -> torch.Tensor:
    """u32 digest deficit -> its quantized form (u8 or bf16, saturating),
    or the i32 value when disabled or when ``sync_budget`` exceeds the
    saturation point."""
    if _DIGEST_QUANT is None or sync_budget > _DIGEST_SAT[_DIGEST_QUANT]:
        return _as_i32(defc)
    q = torch.clamp(defc, max=_DIGEST_SAT[_DIGEST_QUANT])
    if _DIGEST_QUANT == "u8":
        return q.to(torch.uint8)
    return q.to(torch.bfloat16)


def _digest_score(defc: torch.Tensor, sync_budget: int) -> torch.Tensor:
    return digest_quantize(defc, sync_budget).to(torch.int64)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 bits reinterpreted as int32 (``astype(int32)`` on u32)."""
    x = x & MASK
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def bucket_sketch(contig: torch.Tensor, buckets: int) -> torch.Tensor:
    """[N, B] set-reconciliation sketch of per-node progress: the writer
    axis folds into ``buckets`` contiguous blocks (zero-padded to a
    multiple) and each bucket sums its block's watermarks mod 2^32
    (reference ``bucket_sketch``)."""
    n, w = contig.shape
    wp = -(-w // buckets) * buckets
    c = torch.nn.functional.pad(contig, (0, wp - w))
    return c.reshape(n, buckets, wp // buckets).sum(2) & MASK


def _sketch_score(skc, sk_self, sync_budget: int) -> torch.Tensor:
    """Summed per-bucket one-sided sketch deficit, each bucket quantized
    like the scalar digest, summed with the reference's int32 wraparound."""
    d = skc - torch.minimum(skc, sk_self)
    return _as_i32(digest_quantize(d, sync_budget).to(torch.int64).sum(-1))


# Age-bin upper edges (versions behind the writer's head) of the
# age-targeted intake priority: the propagation plane's rumor-age edges
# (sim/telemetry.RUMOR_AGE_EDGES), duplicated because ops do not import sim.
AGE_FORWARD_EDGES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 48, 64)


def _intake_priority(head, w_idx, v, cfg) -> torch.Tensor:
    """Rebroadcast-intake keep-priority, higher kept (reference
    ``_intake_priority``): oldest version first, or under ``age_forward``
    the youngest age bin first, ``-(bin << 24) + min(v, 2^24 - 1)``.
    ``torch.bucketize`` (right=False) returns each age's count of edges
    below it: the reference's sum of ``age > e`` over the edges."""
    if not cfg.age_forward:
        return -v
    hw = onehot.table_gather(head, w_idx)
    age = hw - torch.minimum(v, hw)
    edges = torch.tensor(AGE_FORWARD_EDGES, dtype=torch.int64, device=v.device)
    b = torch.bucketize(age, edges)
    return -(b << 24) + torch.clamp(v, max=(1 << 24) - 1)


def _queue_saturation(q_writer, q_ver, head, alive, cfg) -> torch.Tensor:
    """bool[n]: push->pull saturation (reference ``_queue_saturation``): a
    live node whose pending queue is non-empty and holds only versions
    more than ``pull_switch_age`` behind their writer's head."""
    occ = q_writer >= 0
    hq = onehot.table_gather(head, torch.clamp(q_writer, min=0))
    young = occ & (hq - torch.minimum(q_ver, hq) <= cfg.pull_switch_age)
    return alive & occ.any(1) & ~young.any(1)


def _region_link_matrix(m_ok, recv_region, src_region, q_cap: int, n_regions: int):
    """[R, R] delivered copies, receiver region row by source region
    column (reference ``_region_link_matrix``, whose R^2 masked sums
    become one integer count over ``recv * R + src``; ``index_add_``, as
    ``bincount`` would read its input's maximum on the host)."""
    n, kk = m_ok.shape
    sr = src_region[:, :, None].expand(n, src_region.shape[1], q_cap).reshape(n, kk)
    rr = n_regions * n_regions
    pair = torch.where(m_ok, recv_region[:, None] * n_regions + sr, rr).reshape(-1)
    counts = torch.zeros(rr + 1, dtype=torch.int64, device=m_ok.device)
    counts.index_add_(0, pair, torch.ones_like(pair))
    return counts[:rr].reshape(n_regions, n_regions)


def _duplicate_hits(m_ok, m_w, m_v, q_writer, q_ver) -> torch.Tensor:
    """[n, Q] delivered copies matching each of the receiver's own pending
    entries (same writer, same version). One int64 key per (writer,
    version) makes the reference's [n, Q, kk] compare one bool pass, run
    over row tiles that keep it near 256 MB (the count is row-local)."""
    n, kk = m_w.shape
    q = q_writer.shape[1]
    # m_ok implies m_w >= 0, so a dropped copy's sentinel key (below every
    # (writer >= -1) << 32 key) matches no queue entry.
    mkey = torch.where(m_ok, (m_w << 32) | m_v, -(1 << 62))
    qkey = (q_writer << 32) | q_ver
    step = max(1, (1 << 28) // max(q * kk, 1))
    return torch.cat([
        (mkey[i : i + step, None, :] == qkey[i : i + step, :, None]).sum(2)
        for i in range(0, n, step)
    ]) if n else torch.zeros((0, q), dtype=torch.int64, device=m_w.device)


def _merge_versions_dense(cells, rows, writer, version, mask, row_ok, n_nodes: int, cfg):
    """Row-dense CRDT merge: lexicographic (cl, col_version, value_rank)
    max per cell via the packed (cl << 24 | col_version) word, then
    value_rank among winners — rowmax/rowgather over the cell axis."""
    k = cfg.n_cells
    cl2 = cells.cl.reshape(n_nodes, k)
    cv2 = cells.col_version.reshape(n_nodes, k)
    vr2 = cells.value_rank.reshape(n_nodes, k)
    if rows is not None:
        cl2, cv2, vr2 = cl2[rows], cv2[rows], vr2[rows]
    n_merges = mask.sum() * cfg.cells_per_write
    for j in range(cfg.cells_per_write):
        ckey, ccl, ccv, cvr = crdt.derive_change(writer, version, j, k)
        packed_state = ((cl2 << 24) | cv2) & MASK
        packed_in = ((ccl << 24) | ccv) & MASK
        p1 = torch.maximum(packed_state, onehot.rowmax(ckey, packed_in, mask, k))
        vr_seed = torch.where(p1 == packed_state, vr2, 0)
        in_win = mask & (packed_in == onehot.rowgather(p1, ckey))
        vr2 = torch.maximum(vr_seed, onehot.rowmax(ckey, cvr, in_win, k))
        cl2 = p1 >> 24
        cv2 = p1 & ((1 << 24) - 1)
    if rows is None:
        return crdt.CellState(
            cl=cl2.reshape(-1), col_version=cv2.reshape(-1),
            value_rank=vr2.reshape(-1),
        ), n_merges
    sel = _ok_rows(rows, row_ok) if row_ok is not None else None
    out = []
    for full, part in ((cells.cl, cl2), (cells.col_version, cv2), (cells.value_rank, vr2)):
        full = full.reshape(n_nodes, k).clone()
        if sel is None:
            full[rows] = part
        else:
            full[rows[sel]] = part[sel]
        out.append(full.reshape(-1))
    return crdt.CellState(*out), n_merges


def _fast_delivery(data, head, contig, cells, m_w, m_v, m_gw, m_ok, k_in, cfg):
    """Delta-packed one-hot delivery (reference ``_broadcast_round`` 3a and
    the intake step 4) for writer axes up to ``_FAST_MAX_WRITERS`` with
    fresh-budget, fresh-only intake. Returns what ``_legacy_delivery``
    returns."""
    w_count = cfg.n_writers
    n, kk = m_w.shape
    dev = m_w.device
    wk = cfg.window_k
    mw_safe = torch.clamp(m_w, min=0)
    contig_pre = contig
    base_m = onehot.rowgather(contig_pre, mw_safe)  # [N, kk]
    lim = max(kk, wk)
    k2 = lim + 3
    sent_key = w_count * k2
    # The reference sorts (pkd, v) with two u32 keys; here they ride
    # ONE int64 key pkd << 32 | v, which needs pkd < 2^31.
    if sent_key >= (1 << 31):
        raise ValueError("packed delivery key overflow")
    useful = m_ok & (m_v > base_m)
    d_raw = torch.where(useful, m_v - base_m, 0)
    dc = torch.clamp(d_raw, max=lim + 1)
    pkd = torch.where(useful, m_w * k2 + dc, sent_key)
    skey64, order = torch.sort((pkd << 32) | m_v, dim=1, stable=True)
    # Global writer ids ride as a payload (see broadcast_round).
    gw2 = None if m_gw is None else torch.gather(m_gw, 1, order)
    skey = skey64 >> 32
    v2 = skey64 & MASK
    valid2 = skey < sent_key
    w2 = torch.clamp(skey // k2, max=w_count - 1)
    d2 = skey % k2
    ones_col = torch.ones((n, 1), dtype=torch.bool, device=dev)
    zeros_col = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    seg_start = torch.cat([ones_col, w2[:, 1:] != w2[:, :-1]], dim=1)
    prev_d = torch.cat([zeros_col, d2[:, :-1]], dim=1)
    ok_link = torch.where(seg_start, d2 == 1, d2 <= prev_d + 1) & (d2 <= kk)
    run = routing.segmented_prefix_and_rows(ok_link & valid2, seg_start)
    applied = run & valid2
    adv, seen = onehot.delivery_reduce(w2, d2, v2, applied, valid2, data.seen, w_count)
    first_copy = ~((~seg_start) & (d2 == prev_d))
    fresh_run = applied & first_copy
    prev_v2 = torch.cat([zeros_col, v2[:, :-1]], dim=1)
    same_copy = (~seg_start) & (d2 == prev_d) & (v2 == prev_v2)
    n_degraded = (valid2 & (d2 == lim + 1) & ~same_copy).sum()
    if wk:
        oo_pred = data.oo_any | (valid2 & ~applied & (d2 <= lim)).any()
        if _branch(oo_pred):
            adv_m = routing.segmented_running_max(
                torch.where(applied, d2, 0), seg_start, lim + 2
            )
            admit = valid2 & first_copy & (d2 <= lim)
            contig, oo_new, new_poss = _window_admit(
                data.oo, contig_pre, adv, adv_m, d2, admit, wk, w2, w_count
            )
            near_deg = (admit & (d2 > adv_m) & (((d2 - adv_m) & MASK) > wk)).sum()
            fresh = fresh_run | new_poss
            oo_any_new = oo_new.any()
            n_degraded = n_degraded + near_deg
        else:
            contig = contig_pre + adv
            oo_new = data.oo
            fresh = fresh_run
            oo_any_new = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        contig = contig_pre + adv
        oo_new, oo_any_new = data.oo, data.oo_any
        fresh = fresh_run
        n_degraded = (valid2 & ~applied & ~same_copy).sum()
    n_merges = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.n_cells > 0:
        cells, n_merges = _merge_versions_dense(
            cells, None, w2 if gw2 is None else gw2, v2, fresh, None, n, cfg
        )
    in_mask, ins = routing.rebuild_bounded_queue(
        fresh, _intake_priority(head, w2, v2, cfg),
        (w2, v2) if gw2 is None else (w2, v2, gw2), k_in,
    )
    in_w, in_v = ins[0], ins[1]
    in_tx = torch.full(in_w.shape, cfg.max_transmissions, dtype=torch.int64, device=dev)
    in_w = torch.where(in_mask, in_w, -1)
    # Stale copies never reach ``fresh`` here: it is exactly the newly
    # possessed first receipts the propagation counter reads.
    return (
        contig, seen, oo_new, oo_any_new, n_degraded, cells, n_merges,
        in_mask, in_w, in_v, in_tx, None if gw2 is None else ins[2], fresh,
    )


def _legacy_delivery(data, head, contig, cells, m_w, m_v, m_tx, m_gw, m_ok, k_in, cfg):
    """Legacy sort+scatter delivery (reference ``_broadcast_round`` 3b and
    the intake step 4): needed for writer axes wider than
    ``_FAST_MAX_WRITERS``, stale re-admission and inherited budgets.
    Returns (contig, seen, oo, oo_any, n_degraded, cells, n_merges,
    in_mask, in_w, in_v, in_tx, in_gw, prop_fresh); ``in_gw`` is None
    unless ``m_gw`` carries global writer ids, ``prop_fresh`` masks the
    first receipts of newly possessed versions."""
    w_count = cfg.n_writers
    n, kk = m_w.shape
    dev = m_w.device
    wk = cfg.window_k
    # The reference sorts (wkey, m_v, -m_tx) as three keys. Every operand
    # is a key, so tied entries are identical tuples and any order of them
    # gives the same result: here the three ride one int64 key,
    # wkey << 40 | v << 8 | (255 - tx) (wkey <= W < 2^23, v a u32, tx in
    # [0, 255]), through one sort.
    if w_count >= (1 << 23) or cfg.max_transmissions > 255:
        raise ValueError("legacy delivery key overflow")
    torch._assert_async(((m_tx >= 0) & (m_tx <= 255)).all())
    wkey = torch.where(m_ok, m_w, w_count)
    skey, order = torch.sort((wkey << 40) | (m_v << 8) | (255 - m_tx), dim=1)
    gw2 = None if m_gw is None else torch.gather(m_gw, 1, order)
    w2 = skey >> 40
    v2 = (skey >> 8) & MASK
    tx2 = 255 - (skey & 255)
    valid2 = w2 < w_count
    ones_col = torch.ones((n, 1), dtype=torch.bool, device=dev)
    zeros_col = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    seg_start = torch.cat([ones_col, w2[:, 1:] != w2[:, :-1]], dim=1)
    w2c = torch.clamp(w2, max=w_count - 1)
    base = onehot.rowgather_wide(contig, w2c)
    prev_v = torch.cat([zeros_col, v2[:, :-1]], dim=1)
    # A message extends the run when it lands at or below one past the
    # better of (previous message in segment, already-held watermark).
    ok_link = torch.where(
        seg_start,
        v2 <= ((base + 1) & MASK),
        v2 <= ((torch.maximum(prev_v, base) + 1) & MASK),
    )
    run = routing.segmented_prefix_and_rows(ok_link & valid2, seg_start)
    applied = run & valid2
    contig_pre = contig
    # The reference's two flat [N*W] scatter-maxes (applied versions into
    # contig, heard-of versions into seen) are row-local: one fused
    # delivery_reduce computes both, bit for bit.
    applied_max, seen = onehot.delivery_reduce(
        w2c, v2, v2, applied, valid2, data.seen, w_count
    )
    contig_run = torch.maximum(contig, applied_max)
    prev_same = (~seg_start) & (v2 == prev_v)
    newer = v2 > base

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    extra_poss = torch.zeros_like(valid2)
    if wk:
        adv = contig_run - contig_pre
        oo_pred = data.oo_any | (valid2 & ~run & newer).any()
        if _branch(oo_pred):
            d_m = torch.where(valid2, (v2 - base) & MASK, 0)
            adv_m = routing.segmented_running_max(
                torch.where(applied & newer, d_m, 0), seg_start, 1 << 24
            )
            # The reference's generic admission: the wide-table gather reads
            # each message's old word, the row sum assembles the new bits.
            extra_poss, words = onehot.window_compose(
                data.oo, w2c, d_m, adv_m, valid2 & ~prev_same, wk, w_count,
                lambda word: onehot.rowgather_wide(word, w2c),
                lambda contrib: onehot.rowsum(w2c, contrib, None, w_count),
            )
            contig, oo_new = window_absorb(contig_pre, data.oo, adv, words)
            n_degraded = (
                valid2 & ~prev_same & newer & (d_m > adv_m)
                & (((d_m - adv_m) & MASK) > wk)
            ).sum()
            oo_any_new = oo_new.any()
        else:
            contig = contig_run
            oo_new = data.oo
            oo_any_new = torch.zeros((), dtype=torch.bool, device=dev)
            n_degraded = zero
    else:
        contig = contig_run
        oo_new, oo_any_new = data.oo, data.oo_any
        n_degraded = (valid2 & ~run & newer & ~prev_same).sum()

    n_merges = zero
    if cfg.n_cells > 0:
        cells, n_merges = _merge_versions_dense(
            cells, None, w2c if gw2 is None else gw2, v2, applied | extra_poss,
            None, n, cfg,
        )

    # ---- 4. rebroadcast intake ----------------------------------------------
    fresh = applied & ~prev_same
    # Under rebroadcast_stale the intake also re-admits held versions,
    # which the propagation counter counts as redundant.
    prop_fresh = (fresh & newer) | extra_poss
    if not cfg.rebroadcast_stale:
        fresh = fresh & newer
    fresh = fresh | extra_poss
    if cfg.rebroadcast_fresh_budget:
        intake_ok = fresh
        in_budget = torch.full_like(tx2, cfg.max_transmissions)
    else:
        intake_ok = fresh & (tx2 > 1)
        in_budget = tx2 - 1
    in_mask, ins = routing.rebuild_bounded_queue(
        intake_ok, _intake_priority(head, w2c, v2, cfg),
        (w2c, v2, in_budget) if gw2 is None else (w2c, v2, in_budget, gw2), k_in,
    )
    in_w, in_v, in_tx = ins[:3]
    in_w = torch.where(in_mask, in_w, -1)
    return (
        contig, seen, oo_new, oo_any_new, n_degraded, cells, n_merges,
        in_mask, in_w, in_v, in_tx, None if gw2 is None else ins[3], prop_fresh,
    )


def _raise_writer_cols_(plane, w_rows, head) -> None:
    """``plane[w_rows[w], w] = max(., head[w])`` in place for every writer
    w; a row index past the plane's rows (a writer hosted on another
    shard) drops out, as the reference's ``mode="drop"`` scatter. Each
    writer owns its column, so the clamped rows of dropped writers write
    back their own values."""
    n, w = plane.shape
    wi = torch.arange(w, device=plane.device)
    rows = torch.clamp(w_rows, max=n - 1)
    cur = plane[rows, wi]
    plane[rows, wi] = torch.where(w_rows < n, torch.maximum(cur, head), cur)


def broadcast_round(data, topo, alive, partition, writes, rng, cfg, loss=None):
    """One broadcast-plane round, unsharded (reference ``broadcast_round``):
    local writes, source sampling, queue gather, loss, the row sort,
    delivery reductions, window admission, the CRDT merge and the queue
    rebuild, with the adaptive-dissemination switches where the reference
    has them. Returns (DataState, stats).

    It is the position body on one position holding every row."""
    return exchange.solo(_broadcast_round(
        data, topo, alive, partition, writes, rng, cfg, loss, exchange.whole(cfg.n_nodes)
    ))


def _broadcast_round(data, topo, alive, partition, writes, rng, cfg, loss, pos):
    """The broadcast round's body (reference ``_broadcast_round``): a
    generator over one mesh position's rows (``pos``; ``data`` its block,
    ``topo``, ``alive``, ``partition``, ``writes`` and ``loss`` whole) that
    returns (DataState, stats). It asks for the gathered queue tables (the
    round's one batched exchange of the plane, whose wire bytes join the
    stats as ``xshard_bytes_*``), routes the rumor kill's sender feedback
    to the senders' owners, and reduces the pulled counts and the round's
    stats across positions."""
    track = cfg.track_writer_ids
    if track and topo.writer_ids is None:
        raise ValueError("track_writer_ids requires topo.writer_ids")
    w_count, q_cap = cfg.n_writers, cfg.queue
    n_total = cfg.n_nodes
    # Receiver rows owned by this body: the position's block (every
    # delivery tensor below is [n, ...] and the node vectors are read at
    # its rows); the queue tables are the gathered [N, Q] ones.
    n = data.contig.shape[0]
    dev = data.contig.device
    rs = pos.row_start
    rows = slice(rs, rs + n)
    region_r, rstart_r = topo.region[rows], topo.region_start[rows]
    rsize_r, won, alive_r = topo.region_size[rows], topo.writer_of_node[rows], alive[rows]
    wire = yield exchange.Queue(
        (data.q_writer, data.q_ver, data.q_tx) + ((data.q_gw,) if track else ())
    )
    qf_w, qf_v, qf_t = wire.tables[:3]
    qf_g = wire.tables[3] if track else None
    nodes = pos.nodes(dev)  # global node id of each row
    keys = rng_mod.split_keys(rng, 3)
    k_near, k_far, k_loss = keys[0], keys[1], keys[2]

    # ---- 1. local writes ---------------------------------------------------
    writes = torch.clamp(writes, max=cfg.max_writes_per_round) * alive[
        topo.writer_nodes
    ].to(torch.int64)
    head = data.head + writes
    # Writers hosted on other shards drop out of the scatters.
    w_rows = torch.where(
        (topo.writer_nodes >= rs) & (topo.writer_nodes < rs + n), topo.writer_nodes - rs, n
    )
    contig = data.contig.clone()
    _raise_writer_cols_(contig, w_rows, head)
    contig_before = contig

    mw = cfg.max_writes_per_round
    won_safe = torch.clamp(won, min=0)
    nw = torch.where(won >= 0, writes[won_safe], 0)
    head_old_n = torch.where(won >= 0, data.head[won_safe], 0)
    ar_mw = torch.arange(mw, device=dev)
    new_ver = head_old_n[:, None] + 1 + ar_mw[None, :]
    new_valid = (ar_mw[None, :] < nw[:, None]) & alive_r[:, None]
    new_writer = won[:, None].expand(n, mw)
    # Under rotating slots a node's global writer id IS its node id, so the
    # writer's own enqueue needs no table lookup.
    new_gw = nodes[:, None].expand(n, mw) if track else None

    cells = data.cells
    n_merges = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.n_cells > 0:
        cells, m = _merge_versions_dense(
            cells, None, new_gw if track else torch.clamp(new_writer, min=0),
            new_ver, new_valid, None, n, cfg,
        )
        n_merges = n_merges + m

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    f = cfg.fanout
    if f > 0:
        # ---- 2. source selection -------------------------------------------
        # The position's rows of the full [N, F] draws: every position
        # draws what the unsharded round draws for its rows.
        near_off = rng_mod.randint(k_near, (n_total, cfg.fanout_near), 0, 1 << 30, rows=pos.box)
        far = rng_mod.randint(k_far, (n_total, cfg.fanout_far), 0, n_total, rows=pos.box)
        near = rstart_r[:, None] + near_off % torch.clamp(rsize_r[:, None], min=1)
        src = torch.cat([near, far], dim=1)  # [N, F]
        link_ok = (
            ~partition[region_r[:, None], topo.region[src]]
            & alive_r[:, None]
            & alive[src]
            & (src != nodes[:, None])
        )
        n_pulls = zero
        if cfg.pull_switch_age > 0 and cfg.fanout_far > 0:
            # ---- (b) push->pull: saturated receivers drop their far slots
            # and escalate to a pull in this round's sync stage.
            sat = _queue_saturation(data.q_writer, data.q_ver, head, alive_r, cfg)
            link_ok = torch.cat(
                [link_ok[:, : cfg.fanout_near], link_ok[:, cfg.fanout_near :] & ~sat[:, None]],
                dim=1,
            )
            n_pulls = sat.sum()
        # ---- 3. delivery ---------------------------------------------------
        kk = f * q_cap
        m_w = qf_w[src].reshape(n, kk)
        m_v = qf_v[src].reshape(n, kk)
        # The global writer id of each message rides the delivery sorts as
        # a payload: the port's int64 sort keys have no room for it, and
        # need none. Within an epoch a slot has exactly one global writer,
        # and sparse_writers.rotate kills every queue entry of a reset slot,
        # so valid messages tied on (slot, version) carry equal ids. Ties
        # among invalid messages may order differently from the reference's
        # sort, but no mask admits them and the queue rebuild keeps none of
        # them (the old queue's own empty entries fill its tail first).
        m_gw = qf_g[src].reshape(n, kk) if track else None
        m_ok = (
            link_ok[:, :, None].expand(n, f, q_cap).reshape(n, kk) & (m_w >= 0)
        )
        dyn_loss = None if loss is None else loss[region_r][:, None]
        m_ok, n_lost = faulting.apply_loss(
            k_loss, m_ok, cfg.loss_prob, dyn_loss, full_rows=(n_total, rs)
        )
        n_msgs = m_ok.sum()
        if cfg.rumor_kill_k > 0:
            # ---- (a) duplicate receipts, counted per (node, slot) against
            # the pre-rebuild queues: copies matching the receiver's own
            # pending entries, plus copies the receiver already held,
            # added back onto the source's slot (integer adds, so the
            # order of the scatter's atomics does not matter).
            hits = _duplicate_hits(m_ok, m_w, m_v, data.q_writer, data.q_ver)
            cw = onehot.rowgather(contig_before, torch.clamp(m_w, min=0))
            red = (m_ok & (m_v <= cw)).reshape(n * f, q_cap).to(torch.int64)
            # Sources live on any position: the feedback goes to each
            # source's owner, which adds it onto its rows (the one
            # cross-position exchange of the kill).
            dest, valid, (fb_rows,) = yield exchange.Route(
                "feedback", src.reshape(n * f), red.any(1), (red,)
            )
            fb = torch.zeros((n, q_cap), dtype=torch.int64, device=dev)
            hits = hits + fb.index_add_(0, dest, torch.where(valid[:, None], fb_rows, 0))
        k_in = cfg.rebroadcast_intake or cfg.fanout * 2
        fast = (
            cfg.rebroadcast_fresh_budget
            and not cfg.rebroadcast_stale
            and w_count <= _FAST_MAX_WRITERS
        )
        if fast:
            # ---- 3a. delta-packed delivery ---------------------------------
            out = _fast_delivery(data, head, contig, cells, m_w, m_v, m_gw, m_ok, k_in, cfg)
        else:
            # ---- 3b. legacy sort+scatter delivery --------------------------
            m_tx = qf_t[src].reshape(n, kk)
            out = _legacy_delivery(
                data, head, contig, cells, m_w, m_v, m_tx, m_gw, m_ok, k_in, cfg
            )
        (contig, seen, oo_new, oo_any_new, n_degraded, cells, m, in_mask,
         in_w, in_v, in_tx, in_gw, prop_fresh) = out
        n_merges = n_merges + m
        if cfg.prop_observe:
            prop_useful = prop_fresh.sum()
            prop_link = _region_link_matrix(
                m_ok, region_r, topo.region[src], q_cap, partition.shape[0]
            )
        # A source's budgets burn when at least one receiver pulled it.
        # Sources live on any position: a position counts into the full
        # vector, sums across positions and keeps its rows.
        pulled = torch.bincount(
            torch.where(link_ok, src, n_total).reshape(-1), minlength=n_total + 1
        )[:n_total]
        pulled = (yield exchange.Reduce("pulled", sum=(pulled,))).sum[0][rows]
        sent_any = pulled > 0
    else:
        n_msgs = zero
        in_mask = torch.zeros((n, 0), dtype=torch.bool, device=dev)
        in_w = torch.zeros((n, 0), dtype=torch.int64, device=dev)
        in_v = in_w.clone()
        in_tx = in_w.clone()
        in_gw = in_w.clone() if track else None
        sent_any = torch.zeros((n,), dtype=torch.bool, device=dev)
        seen = data.seen.clone()
        oo_new, oo_any_new = data.oo, data.oo_any
        n_degraded = zero
        n_lost = zero
        n_pulls = zero
        hits = torch.zeros_like(data.q_dup)
        prop_useful = zero
        prop_link = torch.zeros(partition.shape, dtype=torch.int64, device=dev)

    # Each writer's own column of seen rises to its new head. max commutes,
    # so this can follow the delivery reductions, which return a new plane.
    _raise_writer_cols_(seen, w_rows, head)

    # ---- 5. queue rebuild --------------------------------------------------
    occ = data.q_writer >= 0
    old_tx = torch.where(
        occ & sent_any[:, None], data.q_tx - 1, torch.where(occ, data.q_tx, 0)
    )
    old_live = occ & (old_tx > 0)
    n_kills = zero
    if cfg.rumor_kill_k > 0:
        # ---- (a) rumor death: an entry whose duplicate receipts reach k
        # leaves this round's rebuild, so its slot is free for this round's
        # intake.
        q_dup2 = data.q_dup + hits
        kill = occ & (q_dup2 >= cfg.rumor_kill_k)
        n_kills = (kill & old_live).sum()
        old_live = old_live & ~kill
    cand_w = torch.cat([data.q_writer, new_writer, in_w], dim=1)
    cand_v = torch.cat([data.q_ver, new_ver, in_v], dim=1)
    cand_tx = torch.cat(
        [
            old_tx,
            torch.full((n, mw), cfg.max_transmissions, dtype=torch.int64, device=dev),
            in_tx,
        ],
        dim=1,
    )
    cand_ok = torch.cat([old_live, new_valid, in_mask], dim=1)
    prio = cand_tx if cfg.queue_priority == "budget" else -cand_v
    payloads = (cand_w, cand_v, cand_tx)
    if track:
        payloads += (torch.cat([data.q_gw, new_gw, in_gw], dim=1),)
    if cfg.rumor_kill_k > 0:
        # Surviving entries keep their counter; new entries start at 0.
        fresh_dup = torch.zeros((n, mw + in_w.shape[1]), dtype=torch.int64, device=dev)
        payloads += (torch.cat([q_dup2, fresh_dup], dim=1),)
    keep, out = routing.rebuild_bounded_queue(cand_ok, prio, payloads, q_cap)
    q_writer, q_ver, q_tx = out[:3]
    q_gw = out[3] if track else data.q_gw
    q_dup = out[-1] if cfg.rumor_kill_k > 0 else data.q_dup
    q_writer = torch.where(keep, q_writer, -1)

    # One coalesced cross-position sum of the round's stats, with the
    # window-live flag as a count (> 0 is the global OR) and, under
    # prop_observe, the propagation counters. The u32 counters wrap as the
    # reference's u32 psum does.
    part = ((contig - contig_before).sum(), n_msgs, n_merges, n_degraded, n_lost,
            oo_any_new.to(torch.int64))
    if cfg.prop_observe:
        part += (prop_useful, prop_link, n_kills, n_pulls)
    total = (yield exchange.Reduce("broadcast", sum=part)).sum
    applied_b, n_msgs, n_merges, n_degraded, n_lost, oo_cnt = total[:6]
    applied_b, n_merges = applied_b & MASK, n_merges & MASK
    oo_any_new = oo_cnt > 0
    if cfg.prop_observe:
        prop_useful, prop_link, n_kills, n_pulls = total[6:]
    stats = {
        "applied_broadcast": applied_b,
        "msgs": n_msgs,
        "cell_merges": n_merges,
        "window_degraded": n_degraded,
        "lost_msgs": n_lost,
    }
    if cfg.prop_observe:
        # Delivered copies split exactly into useful + duplicate, and the
        # link matrix's mass is msgs.
        stats.update(
            prop_link=prop_link, prop_useful=prop_useful,
            prop_dup=n_msgs - prop_useful, prop_kills=n_kills, prop_pulls=n_pulls,
        )
    if wire.ici_bytes is not None:
        stats["xshard_bytes_ici"] = torch.full((), wire.ici_bytes, dtype=torch.float64, device=dev)
        stats["xshard_bytes_dcn"] = torch.full((), wire.dcn_bytes, dtype=torch.float64, device=dev)
    return (
        DataState(
            head=head, contig=contig, seen=seen, oo=oo_new, oo_any=oo_any_new,
            q_writer=q_writer, q_ver=q_ver, q_tx=q_tx, q_gw=q_gw,
            q_dup=q_dup, cells=cells,
        ),
        stats,
    )


def sync_round(data, topo, alive, partition, round_idx, rng, cfg):
    """Anti-entropy pull sessions for the round's sync cohort (or, without
    cohorts, every due node). Under push->pull switching a second session
    follows over every saturated node not due this round, on a key split
    off first. Reference ``_sync_round``."""
    return exchange.solo(_sync_round(
        data, topo, alive, partition, round_idx, rng, cfg, exchange.whole(cfg.n_nodes)
    ))


def _sync_round(data, topo, alive, partition, round_idx, rng, cfg, pos):
    """``sync_round`` over one position's rows (``data`` its block,
    ``alive`` whole). Returns (data, the position's partial stats)."""
    if cfg.pull_switch_age > 0:
        keys = rng_mod.split_keys(rng, 2)
        rng, k_esc = keys[0], keys[1]
    data, stats = yield from _scheduled_sync(data, topo, alive, partition, round_idx, rng, cfg,
                                             pos)
    if cfg.pull_switch_age == 0:
        return data, stats
    # ---- (b) pull escalation: saturation re-read from the post-broadcast
    # queues; phase identity excludes the rows the session just served.
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    sat = _queue_saturation(data.q_writer, data.q_ver, data.head, alive[rows], cfg)
    already = torch.remainder(round_idx + topo.sync_phase[rows], cfg.sync_interval) == 0
    data, estats = yield from _sync_rows(
        data, topo, alive, partition, pos.nodes(data.contig.device), sat & ~already, k_esc,
        cfg, pos, draw_rows=pos.box, r_total=cfg.n_nodes,
    )
    return data, {k: stats[k] + estats[k] for k in stats}


def _scheduled_sync(data, topo, alive, partition, round_idx, rng, cfg, pos):
    """The round's scheduled sessions: one cohort, or every due node. A
    position serves the cohort entries whose node it owns (``pos.cohorts``)
    and draws by cohort entry."""
    if topo.sync_cohorts is not None:
        if topo.sync_cohorts.shape[0] != cfg.sync_interval:
            raise ValueError(
                f"topology cohorts were built for sync_interval="
                f"{topo.sync_cohorts.shape[0]} but cfg.sync_interval="
                f"{cfg.sync_interval}"
            )
        cohort = torch.remainder(-round_idx, cfg.sync_interval).reshape(1)
        members = torch.index_select(topo.sync_cohorts, 0, cohort)[0]
        ents = None
        rows = members
        if pos.cohorts is not None:
            ents = torch.index_select(pos.cohorts, 0, cohort)[0]
            rows = torch.where(ents >= 0, members[torch.clamp(ents, min=0)], -1)
        # Empty entries point at the position's first row, masked off.
        rows_safe = torch.clamp(rows, min=pos.row_start)
        row_ok = (rows >= 0) & alive[rows_safe]
        return (yield from _sync_rows(
            data, topo, alive, partition, rows_safe, row_ok, rng, cfg, pos, draw_rows=ents,
            r_total=members.shape[0],
        ))
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    due = alive[rows] & (
        torch.remainder(round_idx + topo.sync_phase[rows], cfg.sync_interval) == 0
    )
    return (yield from _sync_rows(
        data, topo, alive, partition, pos.nodes(data.contig.device), due, rng, cfg, pos,
        draw_rows=pos.box, r_total=cfg.n_nodes,
    ))


def _sync_rows(data, topo, alive, partition, rows, row_ok, rng, cfg, pos, draw_rows=None,
               r_total=None):
    """One pull session per row: score ``sync_candidates`` sampled peers
    by need (exact per-writer deficit, or above ``_EXACT_SCORE_MAX`` the
    bucketed sketch or the total-progress digest), pull the union of the
    top ``sync_peers`` plus the origin of the largest known gap under one
    budget, absorb the window, and merge the granted versions' cells.
    Reference ``_sync_rows``.

    A position body over its own session rows (``rows``, global ids it
    owns): the sessions are entries ``draw_rows`` (a range, an index
    tensor, or None for all) of the ``r_total`` sessions whose draws the
    reference makes, the candidates' and peers' rows come by ``Rows``
    gathers, and the window and cell branches turn on cross-position ORs.
    Returns (data, the position's partial stats)."""
    n = cfg.n_nodes
    r = rows.shape[0]
    r_total = r if r_total is None else r_total
    dev = data.contig.device
    keys = rng_mod.split_keys(rng, 2)
    k_near, k_far = keys[0], keys[1]
    local = rows - pos.row_start
    region_r = topo.region[rows]
    contig0 = data.contig[local]  # [R, W]
    seen_r = data.seen[local]

    c_count = cfg.sync_candidates
    c_near = c_count // 2
    c_far = c_count - c_near
    near = topo.region_start[rows][:, None] + rng_mod.randint(
        k_near, (r_total, c_near), 0, 1 << 30, rows=draw_rows
    ) % torch.clamp(topo.region_size[rows][:, None], min=1)
    far = rng_mod.randint(k_far, (r_total, c_far), 0, n, rows=draw_rows)
    cand = torch.cat([near, far], dim=1)  # [R, C]
    ok_c = (
        row_ok[:, None]
        & alive[cand]
        & (cand != rows[:, None])
        & ~partition[region_r[:, None], topo.region[cand]]
    )

    # The whole session count decides the scoring, as in the reference.
    exact = r_total * cfg.n_writers * c_count <= _EXACT_SCORE_MAX
    if not exact and cfg.sync_sketch_buckets > 0:
        # Bucketed sketch: B one-sided differences in place of one total.
        sketch = bucket_sketch(data.contig, cfg.sync_sketch_buckets)
        (sk_c,) = yield exchange.Rows("sync", (sketch,), cand)
        defc = _sketch_score(sk_c, sketch[local][:, None, :], cfg.sync_budget)
    elif exact:
        cc, sc = yield exchange.Rows("sync", (data.contig, data.seen), cand)  # [R, C, W]
        defc = _as_i32((cc - torch.minimum(cc, contig0[:, None, :])).sum(-1))
        seen_r = torch.maximum(seen_r, torch.where(ok_c[:, :, None], sc, 0).amax(dim=1))
        del sc
    else:
        total = data.contig.sum(1) & MASK
        total_r = total[local]
        (tc,) = yield exchange.Rows("sync", (total,), cand)
        defc = _digest_score(tc - torch.minimum(tc, total_r[:, None]), cfg.sync_budget)

    ring = topo.region_rtt[region_r[:, None], topo.region[cand]]
    ar_c = torch.arange(c_count, device=dev)
    tri = ar_c[None, :] < ar_c[:, None]  # tri[i, j] = j strictly before i
    dup = ((cand[:, :, None] == cand[:, None, :]) & tri[None]).any(dim=2)
    score = torch.where(ok_c & ~dup & (defc > 0), defc * 8 + (5 - ring), -1)
    order = torch.argsort(-score, dim=1, stable=True)[:, : cfg.sync_peers]
    sel = torch.gather(cand, 1, order)
    sel_ok = torch.gather(score, 1, order) > 0

    gap = _as_i32(seen_r - torch.minimum(seen_r, contig0))
    w_star = torch.argmax(gap, dim=1)
    origin = topo.writer_nodes[w_star]
    origin_ok = (
        row_ok
        & (gap.amax(dim=1) > 0)
        & alive[origin]
        & (origin != rows)
        & ~partition[region_r, topo.region[origin]]
    )
    peers = torch.cat([sel, origin[:, None]], dim=1)
    ok_p = torch.cat([sel_ok, origin_ok[:, None]], dim=1)
    # One [R, P, W] gather alive at a time, as in the reference.
    (got,) = yield exchange.Rows("sync", (data.contig,), peers)
    avail = torch.maximum(contig0, torch.where(ok_p[:, :, None], got, 0).amax(dim=1))
    del got
    if not exact:
        (got,) = yield exchange.Rows("sync", (data.seen,), peers)
        seen_r = torch.maximum(seen_r, torch.where(ok_p[:, :, None], got, 0).amax(dim=1))
        del got
    deficit = avail - torch.minimum(avail, contig0)
    per_w = torch.clamp(deficit, max=cfg.sync_chunk)
    cum = torch.cumsum(per_w, dim=1)
    grant = torch.minimum(
        torch.clamp(cfg.sync_budget - (cum - per_w), min=0), per_w
    )
    contig_r = contig0 + grant

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    oo_new, oo_any_new, n_regrant = data.oo, data.oo_any, zero
    # The window-live flag is replicated, so every position takes the
    # same branch.
    window = cfg.window_k > 0 and _branch(data.oo_any)
    if window:
        oo_r = data.oo[:, local]
        regrant = zero
        for b in range(oo_r.shape[0]):
            g = torch.clamp(grant - 32 * b, 0, 32)
            m = torch.where(g >= 32, MASK, (1 << torch.clamp(g, max=31)) - 1)
            regrant = regrant + torch.where(
                row_ok[:, None], popcount32(oo_r[b] & m), 0
            ).sum()
        c2, oo2 = window_absorb(contig0, oo_r, grant, torch.zeros_like(oo_r))
        sel_rows = _ok_rows(rows, row_ok)
        oo_new = data.oo.clone()
        oo_new[:, local[sel_rows]] = oo2[:, sel_rows]
        contig_r = torch.where(row_ok[:, None], c2, contig_r)
        n_regrant = regrant & MASK
    seen_r = torch.maximum(seen_r, contig_r)
    # Cross-position ORs: any grant (the cell merge runs where any
    # position granted) and, after the window, any live window bit.
    anys = ((grant > 0).any(),) if cfg.n_cells > 0 else ()
    if window:
        anys += (oo_new.any(),)
    if anys:
        anys = (yield exchange.Reduce("sync", any=anys)).any
    if window:
        oo_any_new = anys[-1]

    cells = data.cells
    n_merges = zero
    if cfg.n_cells > 0 and _branch(anys[0]):
        cum_g = torch.cumsum(grant, dim=1)
        total_g = cum_g[:, -1]
        e = torch.arange(cfg.sync_budget, device=dev)
        # Writer owning granted unit e: the count of span ends <= e (the
        # reference's CPU searchsorted form, at every writer width; it
        # enumerates exactly what the reference's dense count and its
        # wide-writer block decomposition do).
        w_idx = torch.searchsorted(
            cum_g, e[None, :].expand(r, -1).contiguous(), right=True
        )
        w_idx = torch.clamp(w_idx, max=cfg.n_writers - 1)
        prev = torch.where(
            w_idx > 0, onehot.rowgather(cum_g, torch.clamp(w_idx - 1, min=0)), 0
        )
        ver = (onehot.rowgather(contig0, w_idx) + 1 + (e[None, :] - prev)) & MASK
        mask = e[None, :] < total_g[:, None]
        # Under rotating slots the merge keys on each slot's global writer.
        w_merge = (
            onehot.table_gather(topo.writer_ids, w_idx)
            if cfg.track_writer_ids else w_idx
        )
        cells, n_merges = _merge_versions_dense(
            cells, local, w_merge, ver, mask, row_ok, pos.n_local, cfg
        )

    sel_rows = _ok_rows(rows, row_ok)
    tgt = local[sel_rows]
    contig = data.contig.clone()
    contig[tgt] = contig_r[sel_rows]
    seen = data.seen.clone()
    seen[tgt] = torch.maximum(seen[tgt], seen_r[sel_rows])

    stats = {
        "applied_sync": torch.where(row_ok[:, None], contig_r - contig0, 0).sum() & MASK,
        "sessions": ok_c.any(dim=1).sum(),
        "cell_merges": n_merges & MASK,
        "sync_regrant": n_regrant,
    }
    return (
        data._replace(
            contig=contig, seen=seen, cells=cells, oo=oo_new, oo_any=oo_any_new
        ),
        stats,
    )


def revive_sync(data, topo, alive, partition, revived, rng, cfg):
    """Immediate anti-entropy for nodes that just rejoined (or restarted
    from a wipe), instead of waiting out their cohort slot: one
    ``_sync_rows`` session over every node, with only the revived live
    rows taking part. Rounds without a revival skip it (the reference's
    ``lax.cond``). Reference ``revive_sync``."""
    return exchange.solo(_revive_sync(
        data, topo, alive, partition, revived, rng, cfg, exchange.whole(cfg.n_nodes)
    ))


def _revive_sync(data, topo, alive, partition, revived, rng, cfg, pos):
    """``revive_sync`` over one position's rows (``alive`` and ``revived``
    whole, so every position takes the same branch)."""
    if not _branch((revived & alive).any()):
        zero = torch.zeros((), dtype=torch.int64, device=alive.device)
        return data, {
            "applied_sync": zero, "sessions": zero, "cell_merges": zero,
            "sync_regrant": zero,
        }
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    return (yield from _sync_rows(
        data, topo, alive, partition, pos.nodes(alive.device), revived[rows] & alive[rows], rng,
        cfg, pos, draw_rows=pos.box, r_total=cfg.n_nodes,
    ))


def total_need(data: DataState) -> torch.Tensor:
    """Cluster-wide outstanding need (sum of heard-of minus possessed, u32
    wraparound); window-possessed versions are not needed."""
    return _need_part(data) & MASK


def _need_part(data: DataState) -> torch.Tensor:
    """A block's share of ``total_need`` before the u32 wrap (the shares
    sum to the need, mod 2^32)."""
    need = (data.seen - data.contig).sum()
    if data.oo.shape[0] == 0 or not _branch(data.oo_any):
        return need
    return need - popcount32(data.oo).sum()


def staleness(data: DataState) -> tuple[torch.Tensor, torch.Tensor]:
    """(staleness_sum float32, staleness_max): per-node watermark lag
    against the writers' heads. The sum is the exact integer total
    rounded once to float32 — equal to the reference's float32 sum
    whenever the mass stays below 2^24, and independent of the device's
    reduction order."""
    total, worst = _staleness_parts(data)
    return total.to(torch.float32), worst


def _staleness_parts(data: DataState) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's exact integer lag sum and its largest node lag: the sums
    add and the maxima max across positions, and the total rounds once."""
    gap = data.head[None, :] - torch.minimum(data.contig, data.head[None, :])
    node_lag = gap.sum(dim=1) & MASK
    return node_lag.sum(), node_lag.max()


def queue_backlog(data: DataState) -> torch.Tensor:
    """Occupied pending-broadcast queue slots cluster-wide."""
    return (data.q_writer >= 0).sum()


def node_cells(data: DataState, cfg: GossipConfig) -> crdt.CellState:
    """The flat cell plane as per-node [N, K] register arrays."""
    n, k = cfg.n_nodes, cfg.n_cells
    return crdt.CellState(
        cl=data.cells.cl.reshape(n, k),
        col_version=data.cells.col_version.reshape(n, k),
        value_rank=data.cells.value_rank.reshape(n, k),
    )


def cells_agree(data: DataState, cfg: GossipConfig) -> torch.Tensor:
    """True iff every node's merged cell state is identical (convergence
    over register contents, not watermarks)."""
    pc = node_cells(data, cfg)
    return (
        (pc.cl == pc.cl[:1]).all()
        & (pc.col_version == pc.col_version[:1]).all()
        & (pc.value_rank == pc.value_rank[:1]).all()
    )


# corro-lint: disable=CT001,CT005 reason=host ground truth, not a round: reads head once and builds the version list on the host
def serial_merge_reference(head, cfg: GossipConfig, device=None) -> crdt.CellState:
    """Ground truth: every committed version (w, v <= head[w]) merged into
    one fresh cell state (``cells_per_write`` change batches through
    ``crdt.apply_changes``), the order-independent serial merge all
    replicas must converge to. The version list is built on the host and
    moved once; the merge runs on ``device`` (default: ``head``'s when it
    is a tensor, else CUDA)."""
    if device is None and torch.is_tensor(head):
        device = head.device
    device = resolve_device(device)
    h = head.cpu().numpy() if torch.is_tensor(head) else np.asarray(head)
    h = h.astype(np.int64)
    state = crdt.make_cells(cfg.n_cells, device)
    if h.sum() == 0:
        return state
    # Each writer's versions 1..h[w], in writer order.
    ws = np.repeat(np.arange(len(h)), h)
    vs = np.arange(len(ws)) - np.repeat(np.cumsum(h) - h, h) + 1
    ws = torch.as_tensor(ws, device=device)
    vs = torch.as_tensor(vs, device=device)
    mask = torch.ones(ws.shape, dtype=torch.bool, device=device)
    for j in range(cfg.cells_per_write):
        key, cl, cv, vr = crdt.derive_change(ws, vs, j, cfg.n_cells)
        state = crdt.apply_changes(
            state, crdt.ChangeBatch(key=key, cl=cl, col_version=cv, value_rank=vr, mask=mask)
        )
    return state


def visibility(data: DataState, sample_writer, sample_ver) -> torch.Tensor:
    """bool[S, N]: sampled write s visible at each node (at or below the
    watermark, or possessed in the window). The reference's kernel branch:
    the per-sample column reads go through ``onehot.rowgather``."""
    n, w = data.contig.shape
    cols = torch.clamp(sample_writer, 0, max(w - 1, 0))[None, :].expand(n, -1)
    c_int = onehot.rowgather(data.contig, cols)
    vis = c_int >= sample_ver[None, :]
    if data.oo.shape[0] == 0 or not _branch(data.oo_any):
        return vis.T
    out = vis
    bit = (sample_ver[None, :] - c_int - 1) & MASK  # wraps when visible
    for b in range(data.oo.shape[0]):
        word = onehot.rowgather(data.oo[b], cols)
        sh = torch.clamp((bit - 32 * b) & MASK, max=31)
        inb = (bit >= 32 * b) & (bit < 32 * (b + 1))
        out = out | (inb & (((word >> sh) & 1) == 1))
    return out.T

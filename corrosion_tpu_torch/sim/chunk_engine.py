"""Engine driver of the seq-chunk plane (counterpart of
corrosion_tpu/sim/chunk_engine.py).

Runs ``ops/chunks.py`` — multi-chunk transactions gossiped as seq ranges
with partial-need sync — over a whole cluster with first-application
tracking. A stream is "applied" at a node when its coverage is gap-free
to ``last_seq``. Each round emits the canonical curves: ``msgs`` = chunks
sent, ``applied_broadcast`` = chunks accepted by bounded intake,
``applied_sync`` = seqs granted by partial-need sync, ``need`` and
``staleness_sum`` = remaining seq deficit, ``vis_count`` = (node, stream)
pairs newly reassembled; membership and CRDT keys zero-fill. The round
body is the reference's scan body, driven by an eager Python loop.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import chunks as chunk_ops
from corrosion_tpu_torch.ops.chunks import ChunkConfig
from corrosion_tpu_torch.sim import faults as faults_mod
from corrosion_tpu_torch.sim import telemetry as telemetry_mod

# The reference's curve dtypes on this plane: its stats are u32 counts
# (zero fills included) and float32 deficits.
CURVE_DTYPES = dict.fromkeys(telemetry_mod.ROUND_CURVE_KEYS, np.uint32)
CURVE_DTYPES.update(need=np.float32, staleness_sum=np.float32)


def _round(st, vis, last_seq, alive, r: int, key, cfg: ChunkConfig, loss=None, wipe=None):
    """One round of the reference's scan body: wipe, ``chunk_round``, the
    visibility latch, the curves. Returns (state, vis, curves)."""
    if wipe is not None:
        # Partial buffers are gone before the round's gossip.
        st = chunk_ops.wipe_coverage(st, wipe, cfg)
    st, stats = chunk_ops.chunk_round(st, last_seq, alive, r, key, cfg, loss=loss)
    with record_function("corro_track"):
        applied = chunk_ops.applied_mask(st, last_seq, cfg)
        newly = (vis < 0) & applied
        vis = torch.where(newly, r, vis)
    with record_function("corro_health"):
        # Streams commit at round 0, so a pair's delivery latency (and its
        # rumor age) is the round it completed.
        age = torch.full(newly.shape, r, dtype=torch.int64, device=newly.device)
        # The propagation plane's degenerate single-region form: every
        # gossiped chunk is link_00, intake-accepted chunks are useful.
        prop_stats = telemetry_mod.prop_curves(
            cfg.prop_observe,
            stats["chunks_sent"].reshape(1, 1),
            stats["chunks_applied"],
            stats["chunks_sent"] - stats["chunks_applied"],
            age,
            newly,
        )
        curves = telemetry_mod.round_curves(
            msgs=stats["chunks_sent"],
            applied_broadcast=stats["chunks_applied"],
            applied_sync=stats["seqs_granted"],
            sessions=stats["sessions"],
            need=stats["need_seqs"],
            vis_count=newly.sum(),
            staleness_sum=stats["need_seqs"],
            staleness_max=stats["need_node_max"],
            streams_applied=stats["applied_nodes"],
            chunks_sent=stats["chunks_sent"],
            seqs_granted=stats["seqs_granted"],
            chaos_lost_msgs=stats["lost_msgs"],
            chaos_wiped=0 if wipe is None else wipe.sum(),
            **telemetry_mod.delivery_latency_hist(age, newly),
            **prop_stats,
        )
    return st, vis, curves


def simulate_chunks(
    cfg: ChunkConfig,
    origin,
    last_seq,
    rounds: int,
    seed: int = 0,
    round_ms: float = 500.0,
    max_chunk: int | None = None,
    faults=None,
    state=None,
    vis=None,
    start_round: int = 0,
    device=None,
):
    """Run ``rounds`` chunk-plane rounds; returns (state, metrics).

    Metrics: applied coverage fraction, p50/p99 first-application latency
    in simulated seconds over the applied (node, stream) pairs (the rest
    counted in ``unapplied``), run totals, the curves under ``curves`` and
    the visibility latch under ``vis``.

    ``max_chunk`` copies the curves to the host every that many rounds
    (results are identical either way). ``faults`` (a ``sim.faults``
    FaultPlan or CompiledFaults) injects chunk loss (the worst region's
    scalar), kill/revive churn (dead nodes neither gossip nor sync) and
    crash-with-state-wipe; a partition raises, as there is no region
    topology to cut. ``state``/``vis`` resume a run (never modified) and
    ``start_round`` anchors it in absolute rounds: running [0, k) then
    [k, R) with the carried state and ``metrics["vis"]`` equals the
    uninterrupted run; a resumed call takes the tail of any fault arrays.
    Runs on ``device`` (default CUDA; raises when CUDA is absent and no
    device is given)."""
    device = resolve_device(device)
    origin = torch.as_tensor(origin, device=device).to(torch.int64)
    last_seq = torch.as_tensor(last_seq, device=device).to(torch.int64)
    if state is None:
        state = chunk_ops.init_chunks(cfg, origin, last_seq, device)
    alive = torch.ones((cfg.n_nodes,), dtype=torch.bool, device=device)
    if vis is None:
        vis = torch.full((cfg.n_nodes, cfg.n_streams), -1, dtype=torch.int64, device=device)
    base_key = rng_mod.PRNGKey(seed, device)

    alive_np = loss_np = wipe_np = None
    if faults is not None:
        # A FaultPlan compiles at the regions it names (region-targeted loss
        # degrades to its worst-region scalar); CompiledFaults pass through.
        c = (
            faults.compile(cfg.n_nodes, max(1, faults.max_region() + 1))
            if isinstance(faults, faults_mod.FaultPlan) else faults
        )
        if c.rounds != rounds:
            raise ValueError(f"fault plan rounds {c.rounds} != run rounds {rounds}")
        if c.partition is not None:
            raise ValueError(
                "the chunk plane has no region topology; partition/flap "
                "components cannot apply here (use loss or churn)"
            )
        loss_np = c.loss_scalar
        if c.kill is not None or c.revive is not None:
            alive_np = c.alive_curve(cfg.n_nodes)
        wipe_np = c.wipe

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    alive_t = None if alive_np is None else dev(alive_np, torch.bool)
    loss_t = None if loss_np is None else dev(loss_np, torch.float32)
    wipe_t = None if wipe_np is None else dev(wipe_np, torch.bool)

    step = max_chunk if max_chunk is not None else max(rounds, 1)
    parts = [] if rounds > 0 else [
        {k: np.zeros((0,)) for k in telemetry_mod.ROUND_CURVE_KEYS}
    ]
    for r0 in range(0, rounds, step):
        rows = []
        for i in range(r0, min(r0 + step, rounds)):
            r = start_round + i
            state, vis, curves = _round(
                state, vis, last_seq, alive if alive_t is None else alive_t[i], r,
                rng_mod.fold_in(base_key, r), cfg,
                loss=None if loss_t is None else loss_t[i],
                wipe=None if wipe_t is None else wipe_t[i],
            )
            rows.append(curves)
        parts.append(telemetry_mod.stack_curves(rows, CURVE_DTYPES))
    merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    vis_np = vis.cpu().numpy()
    applied = vis_np >= 0
    lat = vis_np[applied].astype(np.float64) * (round_ms / 1000.0)
    metrics = {
        "applied_frac": float(applied.mean()),
        "unapplied": int((~applied).sum()),
        "p50_s": float(np.percentile(lat, 50)) if lat.size else float("nan"),
        "p99_s": float(np.percentile(lat, 99)) if lat.size else float("nan"),
        "seqs_granted": int(merged["applied_sync"].sum()),
        "chunks_sent": int(merged["msgs"].sum()),
        "curves": merged,
        # Part of the resume carry: pass it back as ``vis``.
        "vis": vis,
    }
    return state, metrics

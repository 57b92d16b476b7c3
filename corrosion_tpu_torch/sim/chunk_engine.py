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
body is the reference's scan body, driven by an eager Python loop: a
generator over one mesh position's rows (``_round``), which
``simulate_chunks`` runs on one position holding every row and the shard
driver (``parallel.simulate_chunks_sharded``) once a position in
lockstep.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import chunks as chunk_ops
from corrosion_tpu_torch.ops import exchange
from corrosion_tpu_torch.ops.chunks import ChunkConfig
from corrosion_tpu_torch.sim import engine
from corrosion_tpu_torch.sim import faults as faults_mod
from corrosion_tpu_torch.sim import telemetry as telemetry_mod

# The reference's curve dtypes on this plane: its stats are u32 counts
# (zero fills included) and float32 deficits.
CURVE_DTYPES = dict.fromkeys(telemetry_mod.ROUND_CURVE_KEYS, np.uint32)
CURVE_DTYPES.update(need=np.float32, staleness_sum=np.float32)


def _round(st, vis, last_seq, alive, r: int, key, cfg: ChunkConfig, pos: exchange.Pos,
           phases: tuple, loss=None, wipe=None):
    """One round of the reference's scan body over one mesh position's
    rows (a generator over ``pos``: ``st`` and ``vis`` its blocks,
    ``alive`` and ``wipe`` whole): wipe, ``_chunk_round``, the visibility
    latch, then the chunk plane's and the latch's partial stats summed
    across positions in one reduction. Returns ((state, vis), curves)."""
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    if wipe is not None:
        # Partial buffers are gone before the round's gossip.
        st = chunk_ops.wipe_coverage(st, wipe[rows], cfg)
    st, part, peak = yield from chunk_ops._chunk_round(st, last_seq, alive, r, key, cfg, pos,
                                                       phases, loss=loss)
    plane = record_function if pos.whole else (lambda name: contextlib.nullcontext())
    with plane("corro_track"):
        applied = chunk_ops.applied_mask(st, last_seq, cfg)
        newly = (vis < 0) & applied
        vis = torch.where(newly, r, vis)
    with plane("corro_health"):
        # Streams commit at round 0, so a pair's delivery latency (and its
        # rumor age) is the round it completed.
        age = torch.full(newly.shape, r, dtype=torch.int64, device=newly.device)
        lat_hist = telemetry_mod.delivery_latency_hist(age, newly)
        sums = dict(part, **lat_hist)
        if cfg.prop_observe:
            sums.update(telemetry_mod.rumor_age_hist(age, newly))
        sums["vis_count"] = newly.sum()
        if wipe is not None:
            sums["chaos_wiped"] = wipe[rows].sum()
        total = yield exchange.Reduce("chunks", sum=tuple(sums.values()), max=tuple(peak.values()))
        t = dict(zip(sums, total.sum))
        lat_hist.update((k, t[k]) for k in lat_hist)
        stats = chunk_ops.chunk_stats(t, dict(zip(peak, total.max)))
        # The propagation plane's degenerate single-region form: every
        # gossiped chunk is link_00, intake-accepted chunks are useful.
        prop_stats = telemetry_mod.prop_curves(
            cfg.prop_observe,
            stats["chunks_sent"].reshape(1, 1),
            stats["chunks_applied"],
            stats["chunks_sent"] - stats["chunks_applied"],
            age_hist={k: t[k] for k in telemetry_mod.RUMOR_AGE_KEYS if k in t},
        )
        curves = telemetry_mod.round_curves(
            msgs=stats["chunks_sent"],
            applied_broadcast=stats["chunks_applied"],
            applied_sync=stats["seqs_granted"],
            sessions=stats["sessions"],
            need=stats["need_seqs"],
            vis_count=t["vis_count"],
            staleness_sum=stats["need_seqs"],
            staleness_max=stats["need_node_max"],
            streams_applied=stats["applied_nodes"],
            chunks_sent=stats["chunks_sent"],
            seqs_granted=stats["seqs_granted"],
            chaos_lost_msgs=stats["lost_msgs"],
            chaos_wiped=t.get("chaos_wiped", 0),
            **lat_hist,
            **prop_stats,
        )
    return (st, vis), curves


def fault_arrays(cfg: ChunkConfig, faults, rounds: int) -> tuple:
    """(alive curve, loss scalar, wipe mask) of a fault plan as host arrays
    (each None when the plan has none): a FaultPlan compiles at the regions
    it names (region-targeted loss degrades to its worst-region scalar);
    CompiledFaults pass through. A partition raises."""
    if faults is None:
        return None, None, None
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
    alive = c.alive_curve(cfg.n_nodes) if c.kill is not None or c.revive is not None else None
    return alive, c.loss_scalar, c.wipe


def run_rounds(cfg: ChunkConfig, last_seq, rounds: int, seed: int, box: list, start_round: int,
               positions: list, devices: list, drive, faults=None, max_chunk: int | None = None,
               telemetry=None, after_round=None):
    """The round loop of ``simulate_chunks`` over mesh positions: ``box``
    holds the list of each position's (coverage, vis) block (popped, so
    each round's input blocks are freed as the next are made),
    ``positions`` their ``exchange.Pos`` and ``devices`` their devices.
    ``drive(bodies)`` runs one ``_round`` body a position to its end,
    answering their exchanges, and returns their results
    (``exchange.solo`` on one position; the shard driver's lockstep over a
    mesh). ``after_round(blocks)`` sees every round's blocks. Returns (the
    final blocks, the merged curves)."""
    alive_np, loss_np, wipe_np = fault_arrays(cfg, faults, rounds)

    def consts(d):
        # The run's constants: the alive curve, the loss scalar and the
        # wipe mask stay whole.
        def on(x, dtype):
            return None if x is None else torch.as_tensor(np.asarray(x), device=d).to(dtype)

        return dict(
            last=torch.as_tensor(last_seq, device=d).to(torch.int64),
            key=rng_mod.PRNGKey(seed, d),
            alive=torch.ones((cfg.n_nodes,), dtype=torch.bool, device=d),
            alive_t=on(alive_np, torch.bool), loss_t=on(loss_np, torch.float32),
            wipe_t=on(wipe_np, torch.bool),
        )

    on_dev = engine.per_device(devices, consts)
    phases = [chunk_ops.phase_rows(p, cfg, d) for p, d in zip(positions, devices)]

    def bodies(i, blocks):
        r = start_round + i
        return [
            _round(st, vis, c["last"], c["alive"] if c["alive_t"] is None else c["alive_t"][i],
                   r, rng_mod.fold_in(c["key"], r), cfg, p, ph, loss=engine.at(c["loss_t"], i),
                   wipe=engine.at(c["wipe_t"], i))
            for (st, vis), p, ph, c in zip(blocks, positions, phases, on_dev)
        ]

    return engine.run_in_chunks(
        rounds, box, max_chunk or max(rounds, 1), start_round, telemetry,
        lambda start, stop, box: engine.run_positions(
            box.pop(), range(start, stop), bodies, drive, after_round, CURVE_DTYPES),
    )


def run_metrics(vis_np: np.ndarray, curves: dict, round_ms: float) -> dict:
    """A run's metrics from its whole [N, S] visibility latch on the host
    and its curves: applied coverage fraction, p50/p99 first-application
    latency in simulated seconds over the applied (node, stream) pairs
    (the rest counted in ``unapplied``), run totals and the curves."""
    applied = vis_np >= 0
    lat = vis_np[applied].astype(np.float64) * (round_ms / 1000.0)
    return {
        "applied_frac": float(applied.mean()),
        "unapplied": int((~applied).sum()),
        "p50_s": float(np.percentile(lat, 50)) if lat.size else float("nan"),
        "p99_s": float(np.percentile(lat, 99)) if lat.size else float("nan"),
        "seqs_granted": int(curves["applied_sync"].sum()),
        "chunks_sent": int(curves["msgs"].sum()),
        "curves": curves,
    }


def simulate_chunks(
    cfg: ChunkConfig,
    origin,
    last_seq,
    rounds: int,
    seed: int = 0,
    round_ms: float = 500.0,
    max_chunk: int | None = None,
    telemetry: telemetry_mod.KernelTelemetry | None = None,
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
    (results are identical either way), and ``telemetry``
    (``KernelTelemetry``) times and flushes each such piece as a chunk
    and takes the run's curves at the end (empty ones for a zero-round
    run). ``faults`` (a ``sim.faults``
    FaultPlan or CompiledFaults) injects chunk loss (the worst region's
    scalar), kill/revive churn (dead nodes neither gossip nor sync) and
    crash-with-state-wipe; a partition raises, as there is no region
    topology to cut. ``state``/``vis`` resume a run (never modified) and
    ``start_round`` anchors it in absolute rounds: running [0, k) then
    [k, R) with the carried state and ``metrics["vis"]`` equals the
    uninterrupted run; a resumed call takes the tail of any fault arrays.
    Runs on ``device`` (default CUDA; raises when CUDA is absent and no
    device is given). The round body is the partitioned run's
    (``parallel.simulate_chunks_sharded``) on one position holding every
    row."""
    device = resolve_device(device)
    if state is None:
        state = chunk_ops.init_chunks(cfg, origin, last_seq, device)
    if vis is None:
        vis = torch.full((cfg.n_nodes, cfg.n_streams), -1, dtype=torch.int64, device=device)
    box = [[(state, vis)]]
    state = vis = None
    blocks, merged = run_rounds(
        cfg, last_seq, rounds, seed, box, start_round, [exchange.whole(cfg.n_nodes)],
        [torch.device(device)], lambda bodies: [exchange.solo(b) for b in bodies],
        faults=faults, max_chunk=max_chunk, telemetry=telemetry,
    )
    state, vis = blocks[0]
    metrics = run_metrics(vis.cpu().numpy(), merged, round_ms)
    # Part of the resume carry: pass it back as ``vis``.
    metrics["vis"] = vis
    return state, metrics

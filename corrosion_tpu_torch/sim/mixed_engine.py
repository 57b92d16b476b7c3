"""Mixed workload engine: multi-chunk transactions and version-granular
writes in one cluster round (counterpart of
corrosion_tpu/sim/mixed_engine.py).

S large streams, each one (writer, version) pair, disseminate their
content seq by seq on the chunk plane (``ops/chunks.py``); the version
number takes a slot in the writer's ordinary version sequence but never
enters the broadcast queues. The version plane (``ops/gossip.py``)
carries everything else. A node's watermark crosses a big version either
when the chunk plane reports it reassembled there (the round's admission
step then promotes ``contig`` or sets the window bit, and merges the
version's cells) or when anti-entropy grants it whole (the crossing is
found after the sync and the node's chunk coverage is back-filled).

The stream specs stay on the host: stream s's writer, version and origin
node are Python ints, so indexing by them costs no device sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import chunks as chunk_ops
from corrosion_tpu_torch.ops import faulting
from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops import intervals
from corrosion_tpu_torch.ops import swim as swim_ops
from corrosion_tpu_torch.ops.chunks import ChunkConfig, ChunkState
from corrosion_tpu_torch.ops.gossip import MASK, DataState, Topology
from corrosion_tpu_torch.sim import telemetry as telemetry_mod
from corrosion_tpu_torch.sim.engine import ClusterConfig, Schedule

# The reference's curve dtypes here: the dense engine's, with ``need``
# (both planes' outstanding mass) in float32.
CURVE_DTYPES = dict(telemetry_mod.CURVE_DTYPES, need=np.float32)


@dataclass(frozen=True)
class StreamSpec:
    """The large transactions: stream s is version ``version[s]`` of
    writer ``writer[s]``, committed at ``commit_round[s]`` with
    ``last_seq[s] + 1`` seqs of content (host numpy arrays)."""

    writer: np.ndarray  # i32[S] writer column
    version: np.ndarray  # u32[S]
    commit_round: np.ndarray  # i32[S]
    last_seq: np.ndarray  # i32[S]


class MixedState(NamedTuple):
    data: DataState
    swim: NamedTuple
    chunks: ChunkState
    applied_before: torch.Tensor  # bool[N, S] chunk-complete as of last round
    round: torch.Tensor  # int64[]
    vis_round: torch.Tensor  # [Samples, N]


class _Streams(NamedTuple):
    """A StreamSpec as the round uses it: host ints for per-stream
    indexing, device tensors for the vector ops."""

    writer: tuple  # writer column per stream
    version: tuple
    node: tuple  # the writer's node
    writer_t: torch.Tensor  # [S]
    version_t: torch.Tensor  # [S]
    last_t: torch.Tensor  # [S]


def _streams(streams: StreamSpec, topo: Topology, device) -> _Streams:
    writer = np.asarray(streams.writer).astype(np.int64)
    nodes = topo.writer_nodes.cpu().numpy()

    def t(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)

    return _Streams(
        writer=tuple(int(w) for w in writer),
        version=tuple(int(v) for v in np.asarray(streams.version)),
        node=tuple(int(nodes[w]) for w in writer),
        writer_t=t(np.maximum(writer, 0)), version_t=t(streams.version),
        last_t=t(streams.last_seq),
    )


def _admit_big(data: DataState, newly, s_writer, s_version, cfg):
    """Version-plane admission of newly reassembled big versions, stream
    by stream: rows whose watermark sits just below promote (plus window
    coalesce); rows further back set the window bit; rows beyond the
    window stay seen-only. Cells merge for every newly possessing row.
    ``s_writer``/``s_version`` are host ints. Returns (data, merges)."""
    n = data.contig.shape[0]
    wk = cfg.window_k
    contig, seen, oo = data.contig.clone(), data.seen.clone(), data.oo.clone()
    cells = data.cells
    n_merges = 0
    for s, (w, v) in enumerate(zip(s_writer, s_version)):
        col = contig[:, w]
        new_s = newly[:, s]
        adv = (new_s & (((col + 1) & MASK) == v)).to(torch.int64)  # direct promote
        # The window bit position wraps in u32 when col >= v; the mask keeps
        # every shift count in [0, 31].
        d_rel = (v - col - 1) & MASK
        in_win = new_s & (((col + 1) & MASK) < v) & (v <= ((col + wk + 1) & MASK))
        if wk:
            bits = []
            for b in range(oo.shape[0]):
                sh = torch.clamp((d_rel - 32 * b) & MASK, max=31)
                inb = in_win & (d_rel >= 32 * b) & (d_rel < 32 * (b + 1))
                bits.append(torch.where(inb, (1 << sh) & MASK, 0))
            col2, oo2 = gossip_ops.window_absorb(col, oo[:, :, w], adv, torch.stack(bits))
            oo[:, :, w] = oo2
        else:
            col2 = col + adv
        contig[:, w] = col2 & MASK
        seen[:, w] = torch.maximum(seen[:, w], torch.where(new_s, v, 0))
        if cfg.n_cells > 0:
            cells, m = gossip_ops._merge_versions_dense(
                cells, None,
                torch.full((n, 1), w, dtype=torch.int64, device=col.device),
                torch.full((n, 1), v, dtype=torch.int64, device=col.device),
                new_s[:, None].contiguous(), None, n, cfg,
            )
            n_merges = n_merges + m
    oo_any = (data.oo_any | oo.any()) if wk else data.oo_any
    return (
        data._replace(contig=contig, seen=seen, oo=oo, oo_any=oo_any, cells=cells),
        n_merges,
    )


def _backfill_coverage(chunks: ChunkState, crossed, s_last, cfg: ChunkConfig) -> ChunkState:
    """Anti-entropy granted the whole version: the node now holds all its
    content, so its seq coverage becomes [0, last_seq]."""
    dev = crossed.device
    row_stream = torch.arange(cfg.rows, device=dev) % cfg.n_streams
    mask = crossed.reshape(cfg.rows)[:, None]
    first = torch.arange(cfg.cap, device=dev)[None, :] == 0
    starts = torch.where(mask, torch.where(first, 0, intervals.EMPTY), chunks.have.starts)
    ends = torch.where(
        mask,
        torch.where(first, s_last[row_stream][:, None], intervals.EMPTY - 1),
        chunks.have.ends,
    )
    return ChunkState(have=intervals.IntervalSet(starts=starts, ends=ends))


def mixed_round(
    state: MixedState,
    topo: Topology,
    writes,  # [W] SMALL writes per writer this round
    big_commit,  # bool[S] host: streams committing this round
    part,  # bool[R, R] directional region link cuts
    kill,  # bool[N] (ignored when has_churn=False)
    revive,
    streams: _Streams,
    sample_writer,
    sample_ver,
    sample_round,
    rng,
    cfg: ClusterConfig,
    ccfg: ChunkConfig,
    has_churn: bool = False,
    loss=None,  # float32[R] chaos receiver-region loss
    probe_loss=None,  # float32[]
    wipe=None,  # bool[N] crash-with-state-wipe
    bcast_fn=None,  # broadcast override (parallel/shard_driver)
) -> tuple[MixedState, dict]:
    """One composite round: commits, the chunk plane, admission of the
    reassembled big versions, broadcast, SWIM, sync (and the rejoin sync
    under churn), the sync-crossing back-fill, visibility and the
    curves. Returns the next state and the round's stats."""
    # Churn configs split 6 keys, the others 4, as the reference.
    keys = rng_mod.split(rng, 6 if has_churn else 4)
    if has_churn:
        k_churn, k_b, k_sw, k_sy, k_ck, k_rejoin = (keys[i] for i in range(6))
    else:
        k_b, k_sw, k_sy, k_ck = (keys[i] for i in range(4))
    swim_impl = swim_ops.impl(cfg.swim)
    sw = state.swim
    data = state.data
    chunks_pre = state.chunks
    applied_before = state.applied_before
    if wipe is not None:
        if not has_churn:
            raise ValueError("wipe masks require a churn schedule")
        # Both planes restart empty; the completion latch resets so the
        # rebuilt coverage re-admits the big versions.
        data = faulting.wipe_nodes(data, wipe, cfg.gossip)
        chunks_pre = chunk_ops.wipe_coverage(chunks_pre, wipe, ccfg)
        applied_before = applied_before & ~wipe[:, None]
    if has_churn:
        sw = swim_impl.apply_churn(
            sw, kill, revive, k_churn, cfg.swim.max_transmissions, wipe=wipe
        )
    inc_pre = sw.incarnation
    alive = sw.alive

    # Big-version commit: head, and the writer node's contig and seen, bump
    # without a queue entry (the chunk plane carries the content). A stream
    # not committing this round is a no-op (a max with 0), so only the
    # committing ones run.
    commits = np.flatnonzero(np.asarray(big_commit))
    if len(commits):
        head, contig, seen = data.head.clone(), data.contig.clone(), data.seen.clone()
        for s in commits:
            w, v, node = streams.writer[s], streams.version[s], streams.node[s]
            head[w] = torch.clamp(head[w], min=v)
            contig[node, w] = torch.clamp(contig[node, w], min=v)
            seen[node, w] = torch.clamp(seen[node, w], min=v)
        data = data._replace(head=head, contig=contig, seen=seen)

    # The chunk plane (no region structure: a regional loss schedule
    # degrades to its worst region).
    with record_function("corro_chunks"):
        chunks, cstats = chunk_ops.chunk_round(
            chunks_pre, streams.last_t, alive, state.round, k_ck, ccfg,
            loss=None if loss is None else loss.max(),
        )
        # A stream counts once committed: this round's commits bumped head
        # to the version, so ``head >= version`` covers both of the
        # reference's terms.
        committed = data.head[streams.writer_t] >= streams.version_t
        applied_now = chunk_ops.applied_mask(chunks, streams.last_t, ccfg) & committed[None, :]
        newly = applied_now & ~applied_before
        data, admit_merges = _admit_big(
            data, newly, streams.writer, streams.version, cfg.gossip
        )

    bfn = gossip_ops.broadcast_round if bcast_fn is None else bcast_fn
    with record_function("corro_broadcast"):
        data, bstats = bfn(data, topo, alive, part, writes, k_b, cfg.gossip, loss=loss)
    with record_function("corro_swim"):
        sw = swim_impl.swim_round(sw, k_sw, state.round, cfg.swim, probe_loss=probe_loss)
    with record_function("corro_sync"):
        contig_pre = data.contig
        data, sstats = gossip_ops.sync_round(
            data, topo, alive, part, state.round, k_sy, cfg.gossip
        )
        if has_churn:
            # Rejoining nodes pull at once; wiped ones bootstrap from empty.
            data, rstats = gossip_ops.revive_sync(
                data, topo, alive, part, revive, k_rejoin, cfg.gossip
            )
            sstats = {k: sstats[k] + rstats[k] for k in sstats}
        # Sync crossings: nodes granted a whole big version back-fill their
        # chunk coverage.
        col_pre = contig_pre[:, streams.writer_t]
        col_now = data.contig[:, streams.writer_t]
        crossed = (col_pre < streams.version_t) & (col_now >= streams.version_t)
        chunks = _backfill_coverage(chunks, crossed, streams.last_t, ccfg)
        applied_after = chunk_ops.applied_mask(chunks, streams.last_t, ccfg) & committed[None, :]

    with record_function("corro_track"):
        # Visibility of sampled small writes and big versions alike rides
        # the version plane.
        vis_now = gossip_ops.visibility(data, sample_writer, sample_ver)
        active = state.round >= sample_round
        vis_round = torch.where(
            (state.vis_round < 0) & vis_now & active[:, None],
            state.round, state.vis_round,
        )
        newly_vis = (vis_round >= 0) & (state.vis_round < 0)

    with record_function("corro_health"):
        lat = state.round - sample_round[:, None]
        stale_sum, stale_max = gossip_ops.staleness(data)
        false_alarms, undetected = swim_impl.health_counts(sw)
        # The propagation plane over the version plane's traffic (the chunk
        # plane's copies are outside the link matrix).
        prop_stats = telemetry_mod.prop_curves(
            cfg.gossip.prop_observe, bstats.get("prop_link"),
            bstats.get("prop_useful"), bstats.get("prop_dup"), lat, newly_vis,
            kills=bstats.get("prop_kills"), pulls=bstats.get("prop_pulls"),
        )
        stats = telemetry_mod.round_curves(
            msgs=bstats["msgs"],
            applied_broadcast=bstats["applied_broadcast"],
            applied_sync=sstats["applied_sync"],
            cell_merges=(bstats["cell_merges"] + sstats["cell_merges"] + admit_merges) & MASK,
            sessions=sstats["sessions"],
            mismatches=swim_impl.mismatches(sw),
            chunks_sent=cstats["chunks_sent"],
            seqs_granted=cstats["seqs_granted"],
            streams_applied=applied_after.sum(),
            # Both planes' outstanding mass, a float32 add as the reference.
            need=gossip_ops.total_need(data).to(torch.float32) + cstats["need_seqs"],
            window_degraded=bstats["window_degraded"],
            sync_regrant=sstats["sync_regrant"],
            vis_count=newly_vis.sum(),
            staleness_sum=stale_sum,
            staleness_max=stale_max,
            swim_false_alarms=false_alarms,
            swim_undetected_deaths=undetected,
            swim_flaps=(sw.incarnation != inc_pre).sum(),
            queue_backlog=gossip_ops.queue_backlog(data),
            chaos_lost_msgs=(bstats["lost_msgs"] + cstats["lost_msgs"]) & MASK,
            chaos_wiped=0 if wipe is None else wipe.sum(),
            xshard_bytes_ici=bstats.get("xshard_bytes_ici", 0),
            xshard_bytes_dcn=bstats.get("xshard_bytes_dcn", 0),
            **telemetry_mod.delivery_latency_hist(lat, newly_vis),
            **prop_stats,
        )
    return (
        MixedState(
            data=data, swim=sw, chunks=chunks, applied_before=applied_after,
            round=state.round + 1, vis_round=vis_round,
        ),
        stats,
    )


def init_mixed_state(
    cfg: ClusterConfig,
    ccfg: ChunkConfig,
    topo: Topology,
    schedule: Schedule,
    streams: StreamSpec,
    device=None,
) -> MixedState:
    """Fresh composite state for ``simulate_mixed``: each stream's writer
    node holds its full coverage."""
    device = resolve_device(device)
    origin = topo.writer_nodes.cpu().numpy()[np.asarray(streams.writer)]
    return MixedState(
        data=gossip_ops.init_data(cfg.gossip, device),
        swim=swim_ops.impl(cfg.swim).init_state(cfg.swim, device),
        chunks=chunk_ops.init_chunks(ccfg, origin, np.asarray(streams.last_seq), device),
        applied_before=torch.zeros(
            (cfg.n_nodes, len(streams.writer)), dtype=torch.bool, device=device
        ),
        round=torch.zeros((), dtype=torch.int64, device=device),
        vis_round=torch.full(
            (len(schedule.sample_writer), cfg.n_nodes), -1, dtype=torch.int64, device=device
        ),
    )


def simulate_mixed(
    cfg: ClusterConfig,
    ccfg: ChunkConfig,
    topo: Topology,
    schedule: Schedule,  # SMALL writes only
    streams: StreamSpec,
    seed: int = 0,
    max_chunk: int | None = None,
    telemetry: telemetry_mod.KernelTelemetry | None = None,
    state: MixedState | None = None,
    device=None,
    bcast_fn=None,
):
    """Run ``mixed_round`` over the schedule. Returns (final, curves).

    ``max_chunk`` copies the curves to the host every that many rounds
    (results are identical either way), and ``telemetry``
    (``KernelTelemetry``) times and flushes each such piece as a chunk
    and takes the run's curves at the end. ``state`` resumes a run (never
    modified): a state whose ``round`` is k continues at absolute round k
    over the schedule's remaining rounds (pass its tail), with round keys
    and the stream commits indexed by k + r, equal to the uninterrupted
    run. ``bcast_fn`` replaces the version plane's broadcast driver
    (``parallel.make_sharded_broadcast``). Runs on ``device`` (default
    CUDA; raises when CUDA is absent and no device is given)."""
    device = resolve_device(device)
    topo = Topology(*(None if x is None else x.to(device) for x in topo))
    if state is None:
        state = init_mixed_state(cfg, ccfg, topo, schedule, streams, device)
    offset = int(state.round)
    rounds = schedule.rounds
    spec = _streams(streams, topo, device)
    commit = np.zeros((rounds, len(streams.writer)), bool)
    for s, r in enumerate(streams.commit_round):
        if offset <= r < offset + rounds:
            commit[r - offset, s] = True

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    writes = dev(schedule.writes, torch.int64)
    s_w = dev(schedule.sample_writer, torch.int64)
    s_v = dev(schedule.sample_ver, torch.int64)
    s_r = dev(schedule.sample_round, torch.int64)
    n_regions = topo.region_rtt.shape[0]
    has_churn = (
        schedule.kill is not None or schedule.revive is not None
        or schedule.wipe is not None
    )
    kill = revive = None
    if has_churn:
        quiet = np.zeros((rounds, cfg.n_nodes), bool)
        kill = dev(quiet if schedule.kill is None else schedule.kill, torch.bool)
        revive = dev(quiet if schedule.revive is None else schedule.revive, torch.bool)
    if schedule.partition is not None:
        partition = dev(schedule.partition, torch.bool)
    else:
        partition = torch.zeros(
            (rounds, n_regions, n_regions), dtype=torch.bool, device=device
        )
    loss = None if schedule.loss is None else dev(schedule.loss, torch.float32)
    probe_loss = (
        None if schedule.probe_loss is None else dev(schedule.probe_loss, torch.float32)
    )
    wipe = None if schedule.wipe is None else dev(schedule.wipe, torch.bool)
    base_key = rng_mod.PRNGKey(seed, device)

    step = max_chunk if max_chunk is not None else max(rounds, 1)
    parts = [] if rounds > 0 else [
        {k: np.zeros((0,)) for k in telemetry_mod.ROUND_CURVE_KEYS}
    ]
    for r0 in range(0, rounds, step):
        # run() takes the only reference to the chunk's start, so each
        # round's input state is freed as the next is made.
        box = [state]
        state = None

        def run():
            state = box.pop()
            rows = []
            for i in range(r0, min(r0 + step, rounds)):
                state, stats = mixed_round(
                    state, topo, writes[i], commit[i], partition[i],
                    None if kill is None else kill[i],
                    None if revive is None else revive[i],
                    spec, s_w, s_v, s_r, rng_mod.fold_in(base_key, offset + i),
                    cfg, ccfg, has_churn,
                    loss=None if loss is None else loss[i],
                    probe_loss=None if probe_loss is None else probe_loss[i],
                    wipe=None if wipe is None else wipe[i],
                    bcast_fn=bcast_fn,
                )
                rows.append(stats)
            return state, telemetry_mod.stack_curves(rows, CURVE_DTYPES)

        if telemetry is None:
            state, curves = run()
        else:
            state, curves = telemetry.run_chunk(offset + r0, run)
        parts.append(curves)
    merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    if telemetry is not None:
        telemetry.on_run_end(merged)
    return state, merged

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

The round is ``_mixed_round``: a generator over one mesh position's rows
(``ops/exchange.py``) that composes the chunk plane's position body with
the dense round's. ``simulate_mixed`` runs it on one position holding
every row; the shard driver (``parallel.simulate_mixed_sharded``) runs one
body a position in lockstep on state that stays in the positions' blocks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import chunks as chunk_ops
from corrosion_tpu_torch.ops import exchange, faulting
from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops import intervals
from corrosion_tpu_torch.ops import swim as swim_ops
from corrosion_tpu_torch.ops.chunks import ChunkConfig, ChunkState
from corrosion_tpu_torch.ops.gossip import MASK, DataState, Topology
from corrosion_tpu_torch.sim import telemetry as telemetry_mod
from corrosion_tpu_torch.sim import engine
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
    by stream, on a block's rows (a generator: every row of the cluster,
    or a mesh position's): rows whose watermark sits just below promote
    (plus window coalesce); rows further back set the window bit; rows
    beyond the window stay seen-only. Cells merge for every newly
    possessing row. ``s_writer``/``s_version`` are host ints. The
    window-live flag stays replicated: an OR across positions. Returns
    (data, the block's merge count)."""
    n = data.contig.shape[0]
    wk = cfg.window_k
    contig, seen, oo = data.contig.clone(), data.seen.clone(), data.oo.clone()
    cells = data.cells
    n_merges = torch.zeros((), dtype=torch.int64, device=contig.device)
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
    oo_any = data.oo_any
    if wk:
        oo_any = oo_any | (yield exchange.Reduce("admit", any=(oo.any(),))).any[0]
    return (
        data._replace(contig=contig, seen=seen, oo=oo, oo_any=oo_any, cells=cells),
        n_merges,
    )


def _backfill_coverage(chunks: ChunkState, crossed, s_last, cfg: ChunkConfig) -> ChunkState:
    """Anti-entropy granted the whole version: the node now holds all its
    content, so its seq coverage becomes [0, last_seq] (``crossed`` the
    block's [n, S] crossings)."""
    dev = crossed.device
    rows = crossed.numel()
    row_stream = torch.arange(rows, device=dev) % cfg.n_streams
    mask = crossed.reshape(rows)[:, None]
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
) -> tuple[MixedState, dict]:
    """One composite round: commits, the chunk plane, admission of the
    reassembled big versions, broadcast, SWIM, sync (and the rejoin sync
    under churn), the sync-crossing back-fill, visibility and the
    curves. Returns the next state and the round's stats. ``_mixed_round``
    on one position holding every row."""
    pos = exchange.whole(cfg.n_nodes)
    return exchange.solo(_mixed_round(
        state, topo, writes, big_commit, part, kill, revive, streams, sample_writer, sample_ver,
        sample_round, rng, cfg, ccfg, has_churn, pos, int(state.round), None, loss=loss,
        probe_loss=probe_loss, wipe=wipe,
    ))


def _mixed_round(
    state: MixedState, topo: Topology, writes, big_commit, partition, kill, revive,
    streams: _Streams, sample_writer, sample_ver, sample_round, rng, cfg: ClusterConfig,
    ccfg: ChunkConfig, has_churn: bool, pos: exchange.Pos, r: int, phases, loss=None,
    probe_loss=None, wipe=None,
):
    """``mixed_round`` over one mesh position's rows: a generator that
    returns (the position's next state, the round's stats). ``state`` is
    the position's block (its rows of every node-major leaf and of the
    chunk coverage, its columns of ``vis_round``, the replicated leaves
    whole); the topology and the round's inputs, the churn masks included,
    are whole; ``r`` is the round as a host int and ``phases`` the
    position's ``chunks.phase_rows``. The planes run in the
    reference's order, each on the position's rows: wipe and churn, the
    big-version commits (``head`` replicated, a writer node's ``contig``/
    ``seen`` at its owner), the chunk plane (``chunks._chunk_round``), the
    admission (its window flag an OR across positions), broadcast, SWIM,
    sync with the rejoin sync, the sync-crossing back-fill, visibility and
    one reduction of both planes' health."""
    # Churn configs split 6 keys, the others 4, as the reference.
    keys = rng_mod.split_keys(rng, 6 if has_churn else 4)
    if has_churn:
        k_churn, k_bcast, k_swim, k_sync, k_ck, k_rejoin = (keys[i] for i in range(6))
    else:
        k_bcast, k_swim, k_sync, k_ck = (keys[i] for i in range(4))
    swim_impl = swim_ops.impl(cfg.swim)
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    # Profiler ranges as the reference's named scopes; lockstepped
    # positions would interleave them, so only a whole position opens them.
    plane = record_function if pos.whole else (lambda name: contextlib.nullcontext())
    sw = state.swim
    data = state.data
    chunks_pre = state.chunks
    applied_before = state.applied_before
    if wipe is not None:
        if not has_churn:
            raise ValueError("wipe masks require a churn schedule")
        # Both planes restart empty; the completion latch resets so the
        # rebuilt coverage re-admits the big versions.
        data = yield from faulting._wipe_nodes(data, wipe[rows], cfg.gossip)
        chunks_pre = chunk_ops.wipe_coverage(chunks_pre, wipe[rows], ccfg)
        applied_before = applied_before & ~wipe[rows][:, None]
    if has_churn:
        sw, alive = yield from swim_impl._apply_churn(
            sw, kill, revive, k_churn, cfg.swim.max_transmissions, wipe, pos
        )
    else:
        (alive,) = yield exchange.Gather("alive", (sw.alive,))
    inc_pre = sw.incarnation

    # Big-version commit: head, and the writer node's contig and seen, bump
    # without a queue entry (the chunk plane carries the content). A stream
    # not committing this round is a no-op (a max with 0), so only the
    # committing ones run; the writer node's row changes at its owner.
    commits = np.flatnonzero(np.asarray(big_commit))  # corro-lint: disable=CT001 reason=the host schedule's row, no tensor
    if len(commits):
        head, contig, seen = data.head.clone(), data.contig.clone(), data.seen.clone()
        for s in commits:
            w, v, node = streams.writer[s], streams.version[s], streams.node[s] - pos.row_start
            head[w] = torch.clamp(head[w], min=v)
            if 0 <= node < pos.n_local:
                contig[node, w] = torch.clamp(contig[node, w], min=v)
                seen[node, w] = torch.clamp(seen[node, w], min=v)
        data = data._replace(head=head, contig=contig, seen=seen)

    # The chunk plane (no region structure: a regional loss schedule
    # degrades to its worst region).
    with plane("corro_chunks"):
        chunks, cpart, _ = yield from chunk_ops._chunk_round(
            chunks_pre, streams.last_t, alive, r, k_ck, ccfg, pos, phases,
            loss=None if loss is None else loss.max(),
        )
        # A stream counts once committed: this round's commits bumped head
        # to the version, so ``head >= version`` covers both of the
        # reference's terms.
        committed = data.head[streams.writer_t] >= streams.version_t
        applied_now = chunk_ops.applied_mask(chunks, streams.last_t, ccfg) & committed[None, :]
        reassembled = applied_now & ~applied_before
        data, admit_merges = yield from _admit_big(
            data, reassembled, streams.writer, streams.version, cfg.gossip
        )

    with plane("corro_broadcast"):
        data, bstats = yield from gossip_ops._broadcast_round(
            data, topo, alive, partition, writes, k_bcast, cfg.gossip, loss, pos
        )
    with plane("corro_swim"):
        sw = yield from swim_impl._swim_round(
            sw, alive, k_swim, state.round, cfg.swim, probe_loss, pos
        )
    with plane("corro_sync"):
        contig_pre = data.contig
        data, sstats = yield from gossip_ops._sync_round(
            data, topo, alive, partition, state.round, k_sync, cfg.gossip, pos
        )
        if has_churn:
            # Rejoining nodes pull at once; wiped ones bootstrap from empty.
            data, rstats = yield from gossip_ops._revive_sync(
                data, topo, alive, partition, revive, k_rejoin, cfg.gossip, pos
            )
            sstats = {k: sstats[k] + rstats[k] for k in sstats}
        # Sync crossings: nodes granted a whole big version back-fill their
        # chunk coverage.
        col_pre = contig_pre[:, streams.writer_t]
        col_now = data.contig[:, streams.writer_t]
        crossed = (col_pre < streams.version_t) & (col_now >= streams.version_t)
        del contig_pre, col_pre, col_now
        chunks = _backfill_coverage(chunks, crossed, streams.last_t, ccfg)
        applied_after = chunk_ops.applied_mask(chunks, streams.last_t, ccfg) & committed[None, :]

    with plane("corro_track"):
        # Visibility of sampled small writes and big versions alike rides
        # the version plane.
        vis_now = gossip_ops.visibility(data, sample_writer, sample_ver)
        active = state.round >= sample_round
        vis_round = torch.where(
            (state.vis_round < 0) & vis_now & active[:, None],
            state.round, state.vis_round,
        )
        newly = (vis_round >= 0) & (state.vis_round < 0)

    with plane("corro_health"):
        # The position's shares of every summed stat of both planes, summed
        # across positions in one reduction (integers, so the order does not
        # matter; each plane's need is exact, and the float32 sums round
        # once, after).
        lat = state.round - sample_round[:, None]
        lat_hist = telemetry_mod.delivery_latency_hist(lat, newly)
        part = dict(lat_hist)
        if cfg.gossip.prop_observe:
            part.update(telemetry_mod.rumor_age_hist(lat, newly))
        stale_sum, stale_max = gossip_ops._staleness_parts(data)
        false_alarms, undetected = swim_impl._health_counts(sw, alive, pos)
        part.update(
            mismatches=swim_impl._mismatches(sw, alive, pos),
            need=gossip_ops._need_part(data),
            need_seqs=cpart["need_seqs"],
            vis_count=newly.sum(),
            staleness_sum=stale_sum,
            swim_false_alarms=false_alarms,
            swim_undetected_deaths=undetected,
            swim_flaps=(sw.incarnation != inc_pre).sum(),
            queue_backlog=gossip_ops.queue_backlog(data),
            sync_cells=sstats["cell_merges"],
            admit_merges=admit_merges,
            chunks_sent=cpart["chunks_sent"],
            seqs_granted=cpart["seqs_granted"],
            chunk_lost=cpart["lost_msgs"],
            streams_applied=applied_after.sum(),
            **{k: sstats[k] for k in ("applied_sync", "sessions", "sync_regrant")},
        )
        if wipe is not None:
            part["chaos_wiped"] = wipe[rows].sum()
        total = yield exchange.Reduce("health", sum=tuple(part.values()), max=(stale_max,))
        t = dict(zip(part, total.sum))
        lat_hist.update((k, t[k]) for k in lat_hist)
        # The propagation plane over the version plane's traffic (the chunk
        # plane's copies are outside the link matrix).
        prop_stats = telemetry_mod.prop_curves(
            cfg.gossip.prop_observe, bstats.get("prop_link"),
            bstats.get("prop_useful"), bstats.get("prop_dup"),
            kills=bstats.get("prop_kills"), pulls=bstats.get("prop_pulls"),
            age_hist={k: t[k] for k in telemetry_mod.RUMOR_AGE_KEYS if k in t},
        )
        stats = telemetry_mod.round_curves(
            msgs=bstats["msgs"],
            applied_broadcast=bstats["applied_broadcast"],
            applied_sync=t["applied_sync"] & MASK,
            cell_merges=(bstats["cell_merges"] + t["sync_cells"] + t["admit_merges"]) & MASK,
            sessions=t["sessions"],
            mismatches=t["mismatches"],
            chunks_sent=t["chunks_sent"],
            seqs_granted=t["seqs_granted"] & MASK,
            streams_applied=t["streams_applied"],
            # Both planes' outstanding mass, a float32 add as the reference.
            need=(t["need"] & MASK).to(torch.float32) + t["need_seqs"].to(torch.float32),
            window_degraded=bstats["window_degraded"],
            sync_regrant=t["sync_regrant"] & MASK,
            vis_count=t["vis_count"],
            staleness_sum=t["staleness_sum"].to(torch.float32),
            staleness_max=total.max[0],
            swim_false_alarms=t["swim_false_alarms"],
            swim_undetected_deaths=t["swim_undetected_deaths"] & MASK,
            swim_flaps=t["swim_flaps"],
            queue_backlog=t["queue_backlog"],
            chaos_lost_msgs=(bstats["lost_msgs"] + t["chunk_lost"]) & MASK,
            chaos_wiped=t.get("chaos_wiped", 0),
            xshard_bytes_ici=bstats.get("xshard_bytes_ici", 0),
            xshard_bytes_dcn=bstats.get("xshard_bytes_dcn", 0),
            **lat_hist,
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
    pos: exchange.Pos | None = None,
) -> MixedState:
    """Fresh composite state for ``simulate_mixed``: each stream's writer
    node holds its full coverage. ``pos`` builds just a mesh position's
    block (its rows of every node-major leaf and of the coverage, its
    columns of ``vis_round``)."""
    device = resolve_device(device)
    pos = exchange.whole(cfg.n_nodes) if pos is None else pos
    n_rows = None if pos.whole else pos.n_local
    origin = topo.writer_nodes.cpu().numpy()[np.asarray(streams.writer)]
    return MixedState(
        data=gossip_ops.init_data(cfg.gossip, device, n_rows=n_rows),
        swim=swim_ops.impl(cfg.swim).init_state(cfg.swim, device, n_rows=n_rows),
        chunks=chunk_ops.init_chunks(ccfg, origin, np.asarray(streams.last_seq), device, pos),
        applied_before=torch.zeros(
            (pos.n_local, len(streams.writer)), dtype=torch.bool, device=device
        ),
        round=torch.zeros((), dtype=torch.int64, device=device),
        vis_round=torch.full(
            (len(schedule.sample_writer), pos.n_local), -1, dtype=torch.int64, device=device
        ),
    )


def run_rounds(
    cfg: ClusterConfig, ccfg: ChunkConfig, topo: Topology, schedule: Schedule,
    streams: StreamSpec, seed: int, box: list, positions: list, devices: list, drive,
    max_chunk: int | None = None, telemetry=None, after_round=None,
):
    """The round loop of ``simulate_mixed`` over mesh positions: ``box``
    holds the list of each position's ``MixedState`` block (popped, so
    each round's input blocks are freed as the next are made),
    ``positions`` their ``exchange.Pos`` and ``devices`` their devices;
    the run resumes at the blocks' carried ``round``. ``drive(bodies)``
    runs one ``_mixed_round`` body a position to its end, answering their
    exchanges, and returns their results (``exchange.solo`` on one
    position; the shard driver's lockstep over a mesh).
    ``after_round(blocks)`` sees every round's blocks. Returns (the final
    blocks, the merged curves)."""
    offset = int(box[0][0].round)
    rounds = schedule.rounds
    commit = np.zeros((rounds, len(streams.writer)), bool)
    for s, r in enumerate(streams.commit_round):
        if offset <= r < offset + rounds:
            commit[r - offset, s] = True
    has_churn = (
        schedule.kill is not None or schedule.revive is not None
        or schedule.wipe is not None
    )
    # The schedule's tables, the topology and the streams once per distinct
    # device; the churn masks and the loss stay whole.
    on_dev = engine.per_device(devices, lambda d: (
        engine.round_inputs(cfg, topo, schedule, d), _streams(streams, topo, d),
        rng_mod.PRNGKey(seed, d),
    ))
    phases = [chunk_ops.phase_rows(p, ccfg, d) for p, d in zip(positions, devices)]

    def bodies(i, blocks):
        return [
            _mixed_round(b, big_commit=commit[i], streams=spec,
                         rng=rng_mod.fold_in(key, offset + i), cfg=cfg, ccfg=ccfg,
                         has_churn=has_churn, pos=p, r=offset + i, phases=ph, **inp.at(i))
            for b, p, ph, (inp, spec, key) in zip(blocks, positions, phases, on_dev)
        ]

    return engine.run_in_chunks(
        rounds, box, max_chunk or max(rounds, 1), offset, telemetry,
        lambda start, stop, box: engine.run_positions(
            box.pop(), range(start, stop), bodies, drive, after_round, CURVE_DTYPES),
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
):
    """Run ``mixed_round`` over the schedule. Returns (final, curves).

    ``max_chunk`` copies the curves to the host every that many rounds
    (results are identical either way), and ``telemetry``
    (``KernelTelemetry``) times and flushes each such piece as a chunk
    and takes the run's curves at the end. ``state`` resumes a run (never
    modified): a state whose ``round`` is k continues at absolute round k
    over the schedule's remaining rounds (pass its tail), with round keys
    and the stream commits indexed by k + r, equal to the uninterrupted
    run. Runs on ``device`` (default CUDA; raises when CUDA is absent and
    no device is given). The round body is the partitioned run's
    (``parallel.simulate_mixed_sharded``) on one position holding every
    row."""
    device = resolve_device(device)
    if state is None:
        state = init_mixed_state(cfg, ccfg, topo, schedule, streams, device)
    box = [[state]]
    state = None
    blocks, merged = run_rounds(
        cfg, ccfg, topo, schedule, streams, seed, box, [exchange.whole(cfg.n_nodes)],
        [torch.device(device)], lambda bodies: [exchange.solo(b) for b in bodies],
        max_chunk=max_chunk, telemetry=telemetry,
    )
    return blocks[0], merged

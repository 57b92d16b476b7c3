"""Whole-cluster simulation engine (dense data plane), in PyTorch.

Counterpart of corrosion_tpu/sim/engine.py: ``cluster_round`` composes the
broadcast plane, SWIM, anti-entropy sync, visibility tracking and the
round curves into one bulk-synchronous round, and ``simulate`` runs it
over a scripted ``Schedule`` (a Python loop where the reference has
``lax.scan``). Per-round keys fold the absolute round index into the
seed's key, so chunked runs (``max_chunk``) equal unchunked ones bit for
bit, and a run equals the reference's at the same seed. Schedules with
churn (kill/revive masks, optionally wipe) take the reference's churn
branch: a 5-way key split, wipe before churn, and a rejoin sync.

The round itself is ``round_body``: a generator over one mesh position's
rows of the node axis (``ops/exchange.py``) that yields where the round
reads what other positions own. ``cluster_round`` runs it on one position
holding every row, answering each request itself; the shard driver
(``parallel.simulate_sharded``) runs one body per position in lockstep on
state that stays in the positions' blocks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import exchange, faulting
from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops import swim as swim_ops
from corrosion_tpu_torch.ops.gossip import MASK, DataState, GossipConfig, Topology
from corrosion_tpu_torch.ops.swim import SwimConfig
from corrosion_tpu_torch.sim import telemetry as telemetry_mod


@dataclass(frozen=True)
class ClusterConfig:
    swim: SwimConfig
    gossip: GossipConfig
    round_ms: float = 500.0  # simulated wall-clock per round

    @property
    def n_nodes(self) -> int:
        return self.gossip.n_nodes


class ClusterState(NamedTuple):
    swim: NamedTuple  # SwimState or SparseSwimState (swim_ops.impl(cfg.swim))
    data: DataState
    round: torch.Tensor  # int64[] round counter
    vis_round: torch.Tensor  # [S, N] first round sample s visible at node, -1


@dataclass
class Schedule:
    """Scripted workload (host numpy arrays; see the reference's
    Schedule): per-round writer commits, optional churn masks, optional
    directional region cuts ``partition[t, i, j]``, tracked samples, and
    the chaos axes ``loss``/``probe_loss``/``wipe``."""

    writes: np.ndarray
    kill: np.ndarray | None = None
    revive: np.ndarray | None = None
    partition: np.ndarray | None = None
    sample_writer: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    sample_ver: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    sample_round: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    loss: np.ndarray | None = None
    probe_loss: np.ndarray | None = None
    wipe: np.ndarray | None = None

    @property
    def rounds(self) -> int:
        return self.writes.shape[0]

    def make_samples(self, cap: int = 256) -> "Schedule":
        """Sample up to ``cap`` committed writes, evenly over the schedule."""
        rs, ws = np.nonzero(self.writes)
        if len(rs) == 0:
            return self
        heads = np.zeros(self.writes.shape[1], np.uint32)
        trip = []
        for r, w in zip(rs, ws):
            for _ in range(int(self.writes[r, w])):
                heads[w] += 1
                trip.append((w, heads[w], r))
        idx = np.linspace(0, len(trip) - 1, min(cap, len(trip))).astype(int)
        sel = [trip[i] for i in idx]
        self.sample_writer = np.array([s[0] for s in sel], np.int32)
        self.sample_ver = np.array([s[1] for s in sel], np.uint32)
        self.sample_round = np.array([s[2] for s in sel], np.int32)
        return self

    def slice(self, start: int, stop: int) -> "Schedule":
        """Rounds [start, stop) of the schedule, samples unchanged."""

        def cut(x):
            return None if x is None else x[start:stop]

        return Schedule(
            writes=self.writes[start:stop], kill=cut(self.kill),
            revive=cut(self.revive), partition=cut(self.partition),
            sample_writer=self.sample_writer, sample_ver=self.sample_ver,
            sample_round=self.sample_round, loss=cut(self.loss),
            probe_loss=cut(self.probe_loss), wipe=cut(self.wipe),
        )


def init_cluster(
    cfg: ClusterConfig, n_samples: int, device=None, n_rows: int | None = None
) -> ClusterState:
    """The initial cluster state; ``n_rows`` builds just a mesh position's
    block of that many node rows (the shard driver's resident state)."""
    device = resolve_device(device)
    nr = cfg.n_nodes if n_rows is None else n_rows
    return ClusterState(
        swim=swim_ops.impl(cfg.swim).init_state(cfg.swim, device, n_rows=n_rows),
        data=gossip_ops.init_data(cfg.gossip, device, n_rows=n_rows),
        round=torch.zeros((), dtype=torch.int64, device=device),
        vis_round=torch.full((n_samples, nr), -1, dtype=torch.int64, device=device),
    )


def cluster_round(
    state: ClusterState,
    topo: Topology,
    writes,  # [W] versions committed per writer this round
    partition,  # bool[R, R]
    sample_writer,  # [S]
    sample_ver,  # [S]
    sample_round,  # [S]
    rng,  # key of this round
    cfg: ClusterConfig,
    loss=None,  # float32[R] chaos receiver-region loss
    probe_loss=None,  # float32[] chaos probe/ack loss
    kill=None,  # bool[N] churn: processes that die this round
    revive=None,  # bool[N] churn: processes that come back
    wipe=None,  # bool[N] crash-with-state-wipe (needs kill/revive)
) -> tuple[ClusterState, dict]:
    """One bulk-synchronous cluster round. Returns the next state and the
    round's stats dict (``ROUND_CURVE_KEYS``). Passing ``kill`` and
    ``revive`` selects the churn branch, whose 5-way key split differs
    from the churn-free 4-way one, as in the reference. ``round_body`` on
    one position holding every row."""
    return exchange.solo(round_body(
        state, topo, writes, partition, sample_writer, sample_ver, sample_round, rng, cfg,
        exchange.whole(cfg.n_nodes), loss=loss, probe_loss=probe_loss, kill=kill,
        revive=revive, wipe=wipe,
    ))


def round_body(
    state: ClusterState, topo: Topology, writes, partition, sample_writer, sample_ver,
    sample_round, rng, cfg: ClusterConfig, pos: exchange.Pos, loss=None, probe_loss=None,
    kill=None, revive=None, wipe=None,
):
    """``cluster_round`` over one mesh position's rows: a generator that
    returns (the position's next state, the round's stats). ``state`` is
    the position's block (its rows of every node-major leaf, its columns of
    ``vis_round``, the replicated leaves whole); the topology and the
    round's inputs, the churn masks included, are whole. The planes run in
    the reference's order (wipe and churn, broadcast, SWIM, sync with the
    rejoin sync, visibility, the health reductions), each on the
    position's rows; the whole liveness vector comes from one gather a
    round, and the stats from one cross-position reduction."""
    has_churn = kill is not None
    if (revive is not None) != has_churn:
        raise ValueError("kill and revive masks go together")
    if wipe is not None and not has_churn:
        raise ValueError("wipe masks require a churn schedule")
    keys = rng_mod.split_keys(rng, 5 if has_churn else 4)
    k_churn, k_bcast, k_swim, k_sync = keys[0], keys[1], keys[2], keys[3]
    swim_impl = swim_ops.impl(cfg.swim)
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    # Profiler ranges named like the reference's jax.named_scope blocks
    # (scripts/torch_round_profile.py attributes device time by them);
    # lockstepped positions would interleave them, so only a position
    # holding every row opens them.
    plane = record_function if pos.whole else (lambda name: contextlib.nullcontext())
    sw = state.swim
    data_pre = state.data
    if wipe is not None:
        # The replica state resets BEFORE this round's protocol work.
        data_pre = yield from faulting._wipe_nodes(data_pre, wipe[rows], cfg.gossip)
    if has_churn:
        sw, alive = yield from swim_impl._apply_churn(
            sw, kill, revive, k_churn, cfg.swim.max_transmissions, wipe, pos
        )
    else:
        (alive,) = yield exchange.Gather("alive", (sw.alive,))

    with plane("corro_broadcast"):
        data, bstats = yield from gossip_ops._broadcast_round(
            data_pre, topo, alive, partition, writes, k_bcast, cfg.gossip, loss, pos
        )
    with plane("corro_swim"):
        # Incarnations after churn: revive bumps are rejoins, not flaps.
        inc_pre = sw.incarnation
        sw = yield from swim_impl._swim_round(
            sw, alive, k_swim, state.round, cfg.swim, probe_loss, pos
        )
    with plane("corro_sync"):
        data, sstats = yield from gossip_ops._sync_round(
            data, topo, alive, partition, state.round, k_sync, cfg.gossip, pos
        )
        if has_churn:
            # Rejoining nodes pull at once instead of waiting for their
            # cohort slot.
            data, rstats = yield from gossip_ops._revive_sync(
                data, topo, alive, partition, revive, keys[4], cfg.gossip, pos
            )
            sstats = {k: sstats[k] + rstats[k] for k in sstats}

    with plane("corro_track"):
        active = state.round >= sample_round  # [S]
        vis_now = gossip_ops.visibility(data, sample_writer, sample_ver)  # [S, n]
        vis_round = torch.where(
            (state.vis_round < 0) & vis_now & active[:, None],
            state.round, state.vis_round,
        )
    with plane("corro_health"):
        # The position's shares of every summed stat, summed across
        # positions in one reduction (integers, so the order does not
        # matter; the float32 staleness rounds once, after).
        newly = (vis_round >= 0) & (state.vis_round < 0)
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
            vis_count=newly.sum(),
            staleness_sum=stale_sum,
            swim_false_alarms=false_alarms,
            swim_undetected_deaths=undetected,
            swim_flaps=(sw.incarnation != inc_pre).sum(),
            queue_backlog=gossip_ops.queue_backlog(data),
            sync_cells=sstats["cell_merges"],
            **{k: sstats[k] for k in ("applied_sync", "sessions", "sync_regrant")},
        )
        if wipe is not None:
            part["chaos_wiped"] = wipe[rows].sum()
        total = yield exchange.Reduce("health", sum=tuple(part.values()), max=(stale_max,))
        t = dict(zip(part, total.sum))
        lat_hist.update((k, t[k]) for k in lat_hist)
        prop_stats = telemetry_mod.prop_curves(
            cfg.gossip.prop_observe, bstats.get("prop_link"),
            bstats.get("prop_useful"), bstats.get("prop_dup"),
            kills=bstats.get("prop_kills"), pulls=bstats.get("prop_pulls"),
            age_hist={k: t[k] for k in telemetry_mod.RUMOR_AGE_KEYS if k in t},
        )
    stats = telemetry_mod.round_curves(
        mismatches=t["mismatches"],
        need=t["need"] & MASK,
        applied_broadcast=bstats["applied_broadcast"],
        applied_sync=t["applied_sync"] & MASK,
        msgs=bstats["msgs"],
        sessions=t["sessions"],
        cell_merges=(bstats["cell_merges"] + t["sync_cells"]) & MASK,
        window_degraded=bstats["window_degraded"],
        sync_regrant=t["sync_regrant"] & MASK,
        vis_count=t["vis_count"],
        staleness_sum=t["staleness_sum"].to(torch.float32),
        staleness_max=total.max[0],
        swim_false_alarms=t["swim_false_alarms"],
        swim_undetected_deaths=t["swim_undetected_deaths"] & MASK,
        swim_flaps=t["swim_flaps"],
        queue_backlog=t["queue_backlog"],
        chaos_lost_msgs=bstats["lost_msgs"],
        chaos_wiped=t.get("chaos_wiped", 0),
        xshard_bytes_ici=bstats.get("xshard_bytes_ici", 0),
        xshard_bytes_dcn=bstats.get("xshard_bytes_dcn", 0),
        **lat_hist,
        **prop_stats,
    )
    return (
        ClusterState(swim=sw, data=data, round=state.round + 1, vis_round=vis_round),
        stats,
    )


def at(x, i: int):
    """Row ``i`` of a per-round table, None where the run has none."""
    return None if x is None else x[i]


class RoundInputs(NamedTuple):
    """A schedule's per-round tables on one device, the topology with
    them; ``at(i)`` gives round i's keyword arguments of ``cluster_round``
    and ``round_body``."""

    topo: Topology
    writes: torch.Tensor
    partition: torch.Tensor
    sample_writer: torch.Tensor
    sample_ver: torch.Tensor
    sample_round: torch.Tensor
    loss: torch.Tensor | None
    probe_loss: torch.Tensor | None
    kill: torch.Tensor | None
    revive: torch.Tensor | None
    wipe: torch.Tensor | None

    def at(self, i: int) -> dict:
        return dict(
            topo=self.topo, writes=self.writes[i], partition=self.partition[i],
            sample_writer=self.sample_writer, sample_ver=self.sample_ver,
            sample_round=self.sample_round, loss=at(self.loss, i),
            probe_loss=at(self.probe_loss, i), kill=at(self.kill, i), revive=at(self.revive, i),
            wipe=at(self.wipe, i),
        )


def round_inputs(cfg: ClusterConfig, topo: Topology, schedule: Schedule, device) -> RoundInputs:
    """The schedule's tables and the topology on ``device``."""
    topo = Topology(*(None if x is None else x.to(device) for x in topo))
    n_regions = int(topo.region.max()) + 1
    rounds = schedule.rounds

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    if schedule.partition is not None:
        partition = dev(schedule.partition, torch.bool)
    else:
        partition = torch.zeros(
            (rounds, n_regions, n_regions), dtype=torch.bool, device=device
        )
    # A wipe mask implies churn (the wipe applies at the kill round).
    kill = revive = wipe = None
    if (
        schedule.kill is not None or schedule.revive is not None
        or schedule.wipe is not None
    ):
        quiet = np.zeros((rounds, cfg.n_nodes), bool)
        kill = dev(quiet if schedule.kill is None else schedule.kill, torch.bool)
        revive = dev(
            quiet if schedule.revive is None else schedule.revive, torch.bool
        )
        if schedule.wipe is not None:
            wipe = dev(schedule.wipe, torch.bool)
    return RoundInputs(
        topo=topo,
        writes=dev(schedule.writes, torch.int64),
        partition=partition,
        sample_writer=dev(schedule.sample_writer, torch.int64),
        sample_ver=dev(schedule.sample_ver, torch.int64),
        sample_round=dev(schedule.sample_round, torch.int64),
        loss=None if schedule.loss is None else dev(schedule.loss, torch.float32),
        probe_loss=(
            None if schedule.probe_loss is None
            else dev(schedule.probe_loss, torch.float32)
        ),
        kill=kill, revive=revive, wipe=wipe,
    )


def check_head_domain(cfg: ClusterConfig, start_round: int, rounds: int) -> None:
    """Raise when the run could reach a version head past the CRDT pack
    domain."""
    max_head = (start_round + rounds) * max(cfg.gossip.max_writes_per_round, 1)
    if cfg.gossip.n_cells > 0 and max_head >= (1 << 24):
        raise ValueError(
            f"reachable version head {max_head} exceeds the CRDT pack "
            f"domain (< 2^24); shorten the run or disable the cell plane"
        )


def per_device(devices: list, make) -> list:
    """``make(device)`` for each position's device, made once per distinct
    device (the positions on one device share it)."""
    made: dict = {}
    for d in devices:
        if str(d) not in made:
            made[str(d)] = make(d)
    return [made[str(d)] for d in devices]


def run_positions(blocks: list, rounds, bodies, drive, after_round=None, dtypes=None):
    """Rounds ``rounds`` (host ints) of one round body a mesh position:
    ``bodies(i, blocks)`` makes round i's bodies over the positions'
    blocks, ``drive`` runs them to their ends (``exchange.solo`` on one
    position holding every row, the shard driver's lockstep over a mesh),
    and each body returns (its position's next block, the round's curves).
    The caller hands over its only reference to ``blocks``, so each round's
    input blocks are freed as the next are made. ``after_round(blocks)``
    sees every round's blocks. Returns (the last blocks, the curves stacked
    in ``dtypes``)."""
    rows = []
    for i in rounds:
        outs = drive(bodies(i, blocks))
        blocks = [o[0] for o in outs]
        rows.append(outs[0][1])
        del outs
        if after_round is not None:
            after_round(blocks)
    return blocks, telemetry_mod.stack_curves(rows, dtypes)


def run_in_chunks(rounds: int, box: list, max_chunk: int, start_round: int, telemetry,
                  run_piece):
    """``run_piece(start, stop, box) -> (state, curves)`` over pieces of at
    most ``max_chunk`` of the ``rounds`` rounds, each timed and flushed as
    a chunk by ``telemetry`` when given; returns the last state and the
    merged curves (empty ones for a zero-round run). ``box`` is a list
    holding a piece's start state, which the piece pops: it takes the only
    reference, so each round's input state is freed as the next is
    made."""
    parts = []
    for start in range(0, rounds, max_chunk):
        stop = min(start + max_chunk, rounds)
        if telemetry is None:
            cur, curves = run_piece(start, stop, box)
        else:
            cur, curves = telemetry.run_chunk(start_round + start,
                                              lambda: run_piece(start, stop, box))
        box = [cur]
        cur = None
        parts.append(curves)
    if not parts:
        parts = [{k: np.zeros((0,)) for k in telemetry_mod.ROUND_CURVE_KEYS}]
    merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    if telemetry is not None:
        telemetry.on_run_end(merged)
    return box.pop(), merged


def simulate(
    cfg: ClusterConfig,
    topo: Topology,
    schedule: Schedule,
    seed: int = 0,
    state: ClusterState | None = None,
    max_chunk: int | None = None,
    telemetry: telemetry_mod.KernelTelemetry | None = None,
    device=None,
) -> tuple[ClusterState, dict]:
    """Run ``cluster_round`` over the schedule. Returns the final state and
    per-round curves (numpy arrays of length ``schedule.rounds``, in the
    reference's dtypes). ``state`` resumes a run (never modified);
    ``max_chunk`` splits the run into pieces of at most that many rounds
    with identical results. ``telemetry`` (``KernelTelemetry``) times and
    flushes each piece as a chunk (the whole run is one chunk when
    unchunked) and takes the merged curves at the end; curves and state
    are the same with it or without. Runs on ``device`` (default CUDA;
    raises when CUDA is absent and no device is given). The partitioned
    run over a mesh is ``parallel.simulate_sharded``."""
    device = resolve_device(device)
    start_round = 0 if state is None else int(state.round)
    check_head_domain(cfg, start_round, schedule.rounds)
    if max_chunk is not None and schedule.rounds > max_chunk:
        return run_in_chunks(
            schedule.rounds, [state], max_chunk, start_round, telemetry,
            lambda start, stop, box: simulate(cfg, topo, schedule.slice(start, stop), seed=seed,
                                              state=box.pop(), device=device),
        )

    inp = round_inputs(cfg, topo, schedule, device)
    if state is None:
        state = init_cluster(cfg, len(schedule.sample_writer), device)
    offset = int(state.round)
    base_key = rng_mod.PRNGKey(seed, device)
    # run() takes the only reference to the start state, so each round's
    # input state is freed as the next is made.
    box = [state]
    state = None

    def run():
        state = box.pop()
        rows = []
        for i in range(schedule.rounds):
            key = rng_mod.fold_in(base_key, offset + i)
            state, stats = cluster_round(state, rng=key, cfg=cfg, **inp.at(i))
            rows.append(stats)
        return state, telemetry_mod.stack_curves(rows)

    if telemetry is None:
        return run()
    final, curves = telemetry.run_chunk(offset, run)
    telemetry.on_run_end(curves)
    return final, curves


def visibility_latencies(
    final: ClusterState, schedule: Schedule, cfg: ClusterConfig,
    alive_only: bool = True,
) -> dict:
    """p50/p99/mean change-visibility latency (seconds) over sampled
    writes; unseen (sample, node) pairs are reported, not timed."""
    vis = final.vis_round.cpu().numpy()
    if vis.size == 0:
        return {"p50_s": float("nan"), "p99_s": float("nan"),
                "mean_s": float("nan"), "unseen": 0, "pairs": 0}
    if alive_only:
        vis = vis[:, final.swim.alive.cpu().numpy()]
    lat_rounds = vis - schedule.sample_round[:, None]
    seen = vis >= 0
    lat = lat_rounds[seen].astype(np.float64) * (cfg.round_ms / 1000.0)
    return {
        "p50_s": float(np.percentile(lat, 50)) if lat.size else float("nan"),
        "p99_s": float(np.percentile(lat, 99)) if lat.size else float("nan"),
        "mean_s": float(lat.mean()) if lat.size else float("nan"),
        "unseen": int((~seen).sum()),
        "pairs": int(seen.size),
    }

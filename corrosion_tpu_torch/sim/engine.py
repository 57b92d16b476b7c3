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
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import faulting
from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops import swim as swim_ops
from corrosion_tpu_torch.ops.gossip import DataState, GossipConfig, Topology
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


def init_cluster(cfg: ClusterConfig, n_samples: int, device=None) -> ClusterState:
    device = resolve_device(device)
    return ClusterState(
        swim=swim_ops.impl(cfg.swim).init_state(cfg.swim, device),
        data=gossip_ops.init_data(cfg.gossip, device),
        round=torch.zeros((), dtype=torch.int64, device=device),
        vis_round=torch.full(
            (n_samples, cfg.n_nodes), -1, dtype=torch.int64, device=device
        ),
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
    bcast_fn=None,  # broadcast override (parallel/shard_driver)
) -> tuple[ClusterState, dict]:
    """One bulk-synchronous cluster round. Returns the next state and the
    round's stats dict (``ROUND_CURVE_KEYS``). Passing ``kill`` and
    ``revive`` selects the churn branch, whose 5-way key split differs
    from the churn-free 4-way one, as in the reference. ``bcast_fn``
    replaces ``gossip.broadcast_round`` (the shard driver's, whose
    exchange bytes join the curves)."""
    has_churn = kill is not None
    if (revive is not None) != has_churn:
        raise ValueError("kill and revive masks go together")
    if wipe is not None and not has_churn:
        raise ValueError("wipe masks require a churn schedule")
    keys = rng_mod.split(rng, 5 if has_churn else 4)
    k_churn, k_bcast, k_swim, k_sync = keys[0], keys[1], keys[2], keys[3]
    swim_impl = swim_ops.impl(cfg.swim)
    sw = state.swim
    data_pre = state.data
    if wipe is not None:
        # The replica state resets BEFORE this round's protocol work.
        data_pre = faulting.wipe_nodes(data_pre, wipe, cfg.gossip)
    if has_churn:
        sw = swim_impl.apply_churn(
            sw, kill, revive, k_churn, cfg.swim.max_transmissions, wipe=wipe
        )
    alive = sw.alive

    # Profiler ranges named like the reference's jax.named_scope blocks
    # (scripts/torch_round_profile.py attributes device time by them).
    bfn = gossip_ops.broadcast_round if bcast_fn is None else bcast_fn
    with record_function("corro_broadcast"):
        data, bstats = bfn(
            data_pre, topo, alive, partition, writes, k_bcast, cfg.gossip,
            loss=loss,
        )
    with record_function("corro_swim"):
        # Incarnations after churn: revive bumps are rejoins, not flaps.
        inc_pre = sw.incarnation
        sw = swim_impl.swim_round(
            sw, k_swim, state.round, cfg.swim, probe_loss=probe_loss
        )
    with record_function("corro_sync"):
        data, sstats = gossip_ops.sync_round(
            data, topo, alive, partition, state.round, k_sync, cfg.gossip
        )
        if has_churn:
            # Rejoining nodes pull at once instead of waiting for their
            # cohort slot.
            k_rejoin = keys[4]
            data, rstats = gossip_ops.revive_sync(
                data, topo, alive, partition, revive, k_rejoin, cfg.gossip
            )
            sstats = {k: sstats[k] + rstats[k] for k in sstats}

    with record_function("corro_track"):
        active = state.round >= sample_round  # [S]
        vis_now = gossip_ops.visibility(data, sample_writer, sample_ver)  # [S, N]
        vis_round = torch.where(
            (state.vis_round < 0) & vis_now & active[:, None],
            state.round, state.vis_round,
        )
    with record_function("corro_health"):
        newly = (vis_round >= 0) & (state.vis_round < 0)
        lat_hist = telemetry_mod.delivery_latency_hist(
            state.round - sample_round[:, None], newly
        )
        stale_sum, stale_max = gossip_ops.staleness(data)
        false_alarms, undetected = swim_impl.health_counts(sw)
        prop_stats = telemetry_mod.prop_curves(
            cfg.gossip.prop_observe, bstats.get("prop_link"),
            bstats.get("prop_useful"), bstats.get("prop_dup"),
            state.round - sample_round[:, None], newly,
            kills=bstats.get("prop_kills"), pulls=bstats.get("prop_pulls"),
        )
        mism = swim_impl.mismatches(sw)
        need = gossip_ops.total_need(data)
        backlog = gossip_ops.queue_backlog(data)
    stats = telemetry_mod.round_curves(
        mismatches=mism,
        need=need,
        applied_broadcast=bstats["applied_broadcast"],
        applied_sync=sstats["applied_sync"],
        msgs=bstats["msgs"],
        sessions=sstats["sessions"],
        cell_merges=(bstats["cell_merges"] + sstats["cell_merges"]) & 0xFFFFFFFF,
        window_degraded=bstats["window_degraded"],
        sync_regrant=sstats["sync_regrant"],
        vis_count=newly.sum(),
        staleness_sum=stale_sum,
        staleness_max=stale_max,
        swim_false_alarms=false_alarms,
        swim_undetected_deaths=undetected,
        swim_flaps=(sw.incarnation != inc_pre).sum(),
        queue_backlog=backlog,
        chaos_lost_msgs=bstats["lost_msgs"],
        chaos_wiped=0 if wipe is None else wipe.sum(),
        xshard_bytes_ici=bstats.get("xshard_bytes_ici", 0),
        xshard_bytes_dcn=bstats.get("xshard_bytes_dcn", 0),
        **lat_hist,
        **prop_stats,
    )
    return (
        ClusterState(swim=sw, data=data, round=state.round + 1, vis_round=vis_round),
        stats,
    )


def simulate(
    cfg: ClusterConfig,
    topo: Topology,
    schedule: Schedule,
    seed: int = 0,
    state: ClusterState | None = None,
    max_chunk: int | None = None,
    telemetry: telemetry_mod.KernelTelemetry | None = None,
    device=None,
    bcast_fn=None,
) -> tuple[ClusterState, dict]:
    """Run ``cluster_round`` over the schedule. Returns the final state and
    per-round curves (numpy arrays of length ``schedule.rounds``, in the
    reference's dtypes). ``state`` resumes a run (never modified);
    ``max_chunk`` splits the run into pieces of at most that many rounds
    with identical results. ``telemetry`` (``KernelTelemetry``) times and
    flushes each piece as a chunk (the whole run is one chunk when
    unchunked) and takes the merged curves at the end; curves and state
    are the same with it or without. ``bcast_fn`` replaces the broadcast
    plane's driver (``parallel.make_sharded_broadcast``). Runs on
    ``device`` (default CUDA; raises when CUDA is absent and no device is
    given)."""
    device = resolve_device(device)
    start_round = 0 if state is None else int(state.round)
    max_head = (start_round + schedule.rounds) * max(
        cfg.gossip.max_writes_per_round, 1
    )
    if cfg.gossip.n_cells > 0 and max_head >= (1 << 24):
        raise ValueError(
            f"reachable version head {max_head} exceeds the CRDT pack "
            f"domain (< 2^24); shorten the run or disable the cell plane"
        )
    if max_chunk is not None and schedule.rounds > max_chunk:
        cur = state
        parts = []
        for start in range(0, schedule.rounds, max_chunk):
            part = schedule.slice(start, min(start + max_chunk, schedule.rounds))
            box = [cur]  # the piece takes the only reference to its start
            cur = None

            def run():
                return simulate(cfg, topo, part, seed=seed, state=box.pop(), device=device,
                                bcast_fn=bcast_fn)

            if telemetry is None:
                cur, curves = run()
            else:
                cur, curves = telemetry.run_chunk(start_round + start, run)
            parts.append(curves)
        merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        if telemetry is not None:
            telemetry.on_run_end(merged)
        return cur, merged

    topo = Topology(*(None if x is None else x.to(device) for x in topo))
    n_regions = int(topo.region.max()) + 1
    rounds = schedule.rounds

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    writes = dev(schedule.writes, torch.int64)
    if schedule.partition is not None:
        partition = dev(schedule.partition, torch.bool)
    else:
        partition = torch.zeros(
            (rounds, n_regions, n_regions), dtype=torch.bool, device=device
        )
    loss = None if schedule.loss is None else dev(schedule.loss, torch.float32)
    probe_loss = (
        None if schedule.probe_loss is None
        else dev(schedule.probe_loss, torch.float32)
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
    s_writer = dev(schedule.sample_writer, torch.int64)
    s_ver = dev(schedule.sample_ver, torch.int64)
    s_round = dev(schedule.sample_round, torch.int64)
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
        for i in range(rounds):
            key = rng_mod.fold_in(base_key, offset + i)
            state, stats = cluster_round(
                state, topo, writes[i], partition[i], s_writer, s_ver, s_round,
                key, cfg,
                loss=None if loss is None else loss[i],
                probe_loss=None if probe_loss is None else probe_loss[i],
                kill=None if kill is None else kill[i],
                revive=None if revive is None else revive[i],
                wipe=None if wipe is None else wipe[i],
                bcast_fn=bcast_fn,
            )
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

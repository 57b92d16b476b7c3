"""Any-node-writes cluster simulation over the rotating-slot writer plane,
in PyTorch.

Counterpart of corrosion_tpu/sim/sparse_engine.py (its docstring describes
the model): every node may write; the run is split into EPOCHS of
``sparse.epoch_rounds`` rounds, and at each boundary a host planner
retires quiescent slots and promotes newly active writers, with the
device checking feasibility first (``demote_report``). Inside an epoch
the gossip kernels run over the slot axis (broadcast, SWIM, anti-entropy
sync) plus ``cold_sync`` for deviation entries. Samples of hot writers
resolve per round on the slot plane; samples of demoted writers resolve
at epoch granularity against the deviation tables.

Each round folds its absolute index into the seed's key and splits it
3 ways (5 under churn) as the reference does, so a run, and a resumed
run, equals the reference's bit for bit. The epoch's ``lax.scan`` is a
Python loop; nothing updates a caller's tensors in place, so a resume
dict replays as often as it is passed in.

The round (``_sparse_round``) and the epoch boundary's device work
(``sparse_writers._demote_report``, ``_rotate``, the cold visibility) are
bodies over one mesh position's rows (``ops/exchange.py``), driven by
``run_epochs``: ``simulate_sparse`` runs them on one position holding
every row, the shard driver (``parallel.simulate_sparse_sharded``) one a
position in lockstep on state that stays in the positions' blocks.
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
from corrosion_tpu_torch.ops import exchange
from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops import sparse_writers as sw_ops
from corrosion_tpu_torch.ops import swim as swim_ops
from corrosion_tpu_torch.ops.gossip import MASK, GossipConfig, Topology
from corrosion_tpu_torch.ops.sparse_writers import SparseConfig, SparseState
from corrosion_tpu_torch.ops.swim import SwimConfig
from corrosion_tpu_torch.sim import telemetry as telemetry_mod
from corrosion_tpu_torch.sim.engine import Schedule


@dataclass(frozen=True)
class SparseClusterConfig:
    swim: SwimConfig
    gossip: GossipConfig  # n_writers == w_hot slots; track_writer_ids=True
    sparse: SparseConfig
    round_ms: float = 500.0

    def __post_init__(self):
        if not self.gossip.track_writer_ids:
            raise ValueError(
                "sparse engine requires gossip.track_writer_ids=True "
                "(cell keys must follow global writer identity)"
            )

    @property
    def n_nodes(self) -> int:
        return self.gossip.n_nodes

    @property
    def w_hot(self) -> int:
        return self.gossip.n_writers


class _Planner:
    """Host-side slot allocator (a copy of the reference's). Device state
    is consulted through demote_report before any forced retirement is
    committed."""

    def __init__(self, n: int, w_hot: int, sp: SparseConfig):
        self.n = n
        self.w_hot = w_hot
        self.sp = sp
        self.slot_of = np.full(n, -1, np.int32)  # writer node -> slot
        self.writer_of = np.full(w_hot, -1, np.int32)  # slot -> writer
        self.last_active = np.full(w_hot, -(10**9), np.int64)
        self.free: list[int] = list(range(w_hot))

    def plan(self, epoch: int, writes_ep: np.ndarray, check):
        """writes_ep: [E, N]. ``check(cand_slots, cand_ok)`` runs
        demote_report on the device. Returns (retire, promote) host arrays
        (padded to d_max/p_max) for ``sparse_writers.rotate``."""
        sp = self.sp
        active = np.nonzero(writes_ep.sum(axis=0))[0]
        new = [int(w) for w in active if self.slot_of[w] < 0]
        active_set = set(int(w) for w in active)

        # Retirement candidates: occupied, writer quiescent long enough,
        # not active this epoch. Most-quiescent first.
        occ = np.nonzero(self.writer_of >= 0)[0]
        cands = [
            int(s)
            for s in occ
            if int(self.writer_of[s]) not in active_set
            and self.last_active[s] <= epoch - sp.demote_after
        ]
        cands.sort(key=lambda s: self.last_active[s])
        cands = cands[: sp.d_max]
        retire: list[int] = []
        diag = {"cands": len(cands), "zero_lag": 0, "forced_pool": 0,
                "take": 0, "f_load_head": []}
        if cands:
            cand_arr = np.full(sp.d_max, 0, np.int32)
            cand_ok = np.zeros(sp.d_max, bool)
            cand_arr[: len(cands)] = cands
            cand_ok[: len(cands)] = True
            caught_up, maxload = check(cand_arr, cand_ok)
            caught_up = np.asarray(caught_up)[: len(cands)]
            # Zero-lag retirements are free: take them all.
            retire = [s for s, c in zip(cands, caught_up) if c]
            diag["zero_lag"] = len(retire)
            shortage = len(new) - (len(self.free) + len(retire))
            if shortage > 0:
                # Forced demotions, only as many as needed and only while
                # every node's deviation table provably has headroom.
                forced_pool = [s for s, c in zip(cands, caught_up) if not c]
                diag["forced_pool"] = len(forced_pool)
                if forced_pool:
                    f_arr = np.full(sp.d_max, 0, np.int32)
                    f_ok = np.zeros(sp.d_max, bool)
                    f_arr[: len(forced_pool)] = forced_pool
                    f_ok[: len(forced_pool)] = True
                    _, f_load = check(f_arr, f_ok)
                    f_load = np.asarray(f_load)[: len(forced_pool)]
                    take = 0
                    while (
                        take < len(forced_pool)
                        and take < shortage
                        and f_load[take] <= sp.k_dev
                    ):
                        take += 1
                    retire += forced_pool[:take]
                    diag["take"] = take
                    diag["f_load_head"] = f_load[:8].tolist()

        free_after = len(self.free) + len(retire)
        if len(new) > free_after:
            raise RuntimeError(
                f"slot exhaustion at epoch {epoch}: {len(new)} new "
                f"writers, {free_after} slots available (w_hot="
                f"{self.w_hot}); size w_hot to the workload's "
                f"concurrent-writer envelope [diag: {diag}]"
            )
        if len(new) > sp.p_max or len(retire) > sp.d_max:
            raise RuntimeError(
                f"epoch {epoch} churn exceeds static pads: "
                f"{len(new)} promotions (p_max={sp.p_max}), "
                f"{len(retire)} retirements (d_max={sp.d_max})"
            )

        # Commit host bookkeeping.
        slots_avail = list(retire) + self.free
        promote_slots, promote_writers = [], []
        for s in retire:
            w_old = int(self.writer_of[s])
            self.slot_of[w_old] = -1
            self.writer_of[s] = -1
        for w in new:
            s = slots_avail.pop(0)
            promote_slots.append(s)
            promote_writers.append(w)
            self.slot_of[w] = s
            self.writer_of[s] = w
        self.free = slots_avail
        for w in active:
            s = self.slot_of[w]
            self.last_active[s] = epoch

        def pad(vals, size, fill=0):
            out = np.full(size, fill, np.int32)
            out[: len(vals)] = vals
            return out

        return (
            pad(retire, sp.d_max),
            np.arange(sp.d_max) < len(retire),
            pad(promote_slots, sp.p_max),
            pad(promote_writers, sp.p_max),
            np.arange(sp.p_max) < len(promote_slots),
        )

    def writes_to_slots(self, writes_ep: np.ndarray) -> np.ndarray:
        """[E, N] -> [E, w_hot] via the current slot map."""
        out = np.zeros((writes_ep.shape[0], self.w_hot), writes_ep.dtype)
        occ = np.nonzero(self.writer_of >= 0)[0]
        out[:, occ] = writes_ep[:, self.writer_of[occ]]
        return out

    def topology_arrays(self):
        """(writer_nodes, writer_of_node, writer_ids) for this epoch."""
        wn = np.maximum(self.writer_of, 0)
        return wn, self.slot_of.copy(), wn.copy()

    def snapshot(self) -> dict:
        """Host planner state for resume."""
        return {
            "slot_of": self.slot_of.copy(),
            "writer_of": self.writer_of.copy(),
            "last_active": self.last_active.copy(),
            "free": np.asarray(self.free, np.int32),
        }

    def restore(self, snap: dict) -> None:
        self.slot_of = np.asarray(snap["slot_of"], np.int32).copy()
        self.writer_of = np.asarray(snap["writer_of"], np.int32).copy()
        self.last_active = np.asarray(snap["last_active"], np.int64).copy()
        self.free = [int(x) for x in snap["free"]]


def _sparse_round(st, sw, vr, topo, writes, partition, kill, revive, r: int, loss, probe_loss,
                  s_slot, s_ver, s_round, rng, cfg: SparseClusterConfig, pos: exchange.Pos):
    """One round of the epoch body (reference ``_epoch_scan_impl.body``)
    over one mesh position's rows: a generator (``ops/exchange.py``) that
    returns (sparse state, swim state, vis_round, stats). ``st``, ``sw``
    and ``vr`` are the position's blocks (its rows, its columns of
    ``vis_round``, the slot vectors whole); the topology and the round's
    inputs are whole; ``rng`` is the round's key (the seed's folded with
    ``r``). The planes run in the reference's order (churn, broadcast,
    SWIM, sync, the rejoin sync, cold sync, hot visibility), each on the
    position's rows, and every summed and maxed curve comes from one
    cross-position reduction."""
    swim_impl = swim_ops.impl(cfg.swim)
    has_churn = kill is not None
    # Pause-resume churn only (simulate_sparse refuses wipe schedules).
    keys = rng_mod.split_keys(rng, 5 if has_churn else 3)
    if has_churn:
        k_churn, k_bcast, k_swim, k_sync, k_rejoin = keys
        sw, alive = yield from swim_impl._apply_churn(
            sw, kill, revive, k_churn, cfg.swim.max_transmissions, None, pos
        )
    else:
        k_bcast, k_swim, k_sync = keys
        (alive,) = yield exchange.Gather("alive", (sw.alive,))
    r_t = torch.tensor(r, dtype=torch.int64, device=alive.device)
    # Profiler ranges only where one position holds every row (lockstepped
    # positions would interleave them).
    plane = record_function if pos.whole else (lambda name: contextlib.nullcontext())

    with plane("corro_broadcast"):
        data, bstats = yield from gossip_ops._broadcast_round(
            st.data, topo, alive, partition, writes, k_bcast, cfg.gossip, loss, pos
        )
    with plane("corro_swim"):
        # After churn: revive bumps are rejoins, not flaps.
        inc_pre = sw.incarnation
        sw = yield from swim_impl._swim_round(sw, alive, k_swim, r_t, cfg.swim, probe_loss, pos)
    with plane("corro_sync"):
        data, sstats = yield from gossip_ops._sync_round(
            data, topo, alive, partition, r_t, k_sync, cfg.gossip, pos
        )
        if has_churn:
            data, rstats = yield from gossip_ops._revive_sync(
                data, topo, alive, partition, revive, k_rejoin, cfg.gossip, pos
            )
            sstats = {k: sstats[k] + rstats[k] for k in sstats}
        st, cstats, head_full = yield from sw_ops._cold_sync(
            st._replace(data=data), topo.region, alive, partition, cfg.gossip, cfg.sparse, pos
        )
        data = st.data

    # Hot-plane visibility for samples whose writer holds a slot.
    with plane("corro_track"):
        hot = s_slot >= 0
        vis_now = gossip_ops.visibility(data, torch.clamp(s_slot, min=0), s_ver)
        active_s = r >= s_round
        vr_new = torch.where((vr < 0) & vis_now & (hot & active_s)[:, None], r, vr)
        del vis_now

    # Staleness is measured on the hot slot plane; the cold plane's residue
    # is in `need` through the cold lag.
    with plane("corro_health"):
        newly = (vr_new >= 0) & (vr < 0)
        lat = r - s_round[:, None]
        lat_hist = telemetry_mod.delivery_latency_hist(lat, newly)
        part = dict(lat_hist)
        if cfg.gossip.prop_observe:
            # Rumor ages track the hot-plane samples, like vis_count.
            part.update(telemetry_mod.rumor_age_hist(lat, newly))
        stale_sum, stale_max = gossip_ops._staleness_parts(data)
        false_alarms, undetected = swim_impl._health_counts(sw, alive, pos)
        part.update(
            mismatches=swim_impl._mismatches(sw, alive, pos),
            need=gossip_ops._need_part(data) + sw_ops._cold_need_part(st, head_full),
            vis_count=newly.sum(),
            staleness_sum=stale_sum,
            swim_false_alarms=false_alarms,
            swim_undetected_deaths=undetected,
            swim_flaps=(sw.incarnation != inc_pre).sum(),
            queue_backlog=gossip_ops.queue_backlog(data),
            sync_cells=sstats["cell_merges"],
            **{k: sstats[k] for k in ("applied_sync", "sessions", "sync_regrant")},
            **cstats,
        )
        del newly, head_full
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
        cell_merges=(bstats["cell_merges"] + t["sync_cells"] + t["cold_merges"]) & MASK,
        window_degraded=bstats["window_degraded"],
        sync_regrant=t["sync_regrant"] & MASK,
        cold_healed=t["cold_healed"] & MASK,
        # Hot-plane visibility events only; demoted-writer samples resolve
        # at epoch granularity outside the round.
        vis_count=t["vis_count"],
        staleness_sum=t["staleness_sum"].to(torch.float32),
        staleness_max=total.max[0],
        swim_false_alarms=t["swim_false_alarms"],
        swim_undetected_deaths=t["swim_undetected_deaths"] & MASK,
        swim_flaps=t["swim_flaps"],
        queue_backlog=t["queue_backlog"],
        chaos_lost_msgs=bstats["lost_msgs"],
        xshard_bytes_ici=bstats.get("xshard_bytes_ici", 0),
        xshard_bytes_dcn=bstats.get("xshard_bytes_dcn", 0),
        **lat_hist,
        **prop_stats,
    )
    return st, sw, vr_new, stats


def _cold_vis_update(sstate: SparseState, vis_round, s_writer, s_ver, s_cold, round_now: int):
    """The epoch-end cold visibility of a position's block: its columns of
    ``vis_round`` (row-local, no exchange)."""
    vis = sw_ops.cold_visibility(sstate, s_writer, s_ver)
    return torch.where((vis_round < 0) & vis & s_cold[:, None], round_now, vis_round)


def initial_resume(cfg: SparseClusterConfig, n_samples: int, device=None) -> dict:
    """An epoch-0 resume point."""
    sstate, swim_state, vis_round = init_position(cfg, n_samples, device, cfg.n_nodes)
    return {
        "planner": _Planner(cfg.n_nodes, cfg.w_hot, cfg.sparse).snapshot(),
        "sstate": sstate,
        "swim": swim_state,
        "vis_round": vis_round,
        "next_epoch": 0,
    }


def init_position(cfg: SparseClusterConfig, n_samples: int, device, n_rows: int) -> tuple:
    """A mesh position's initial (sparse state, swim state, vis_round)
    block of ``n_rows`` node rows, built where it sits."""
    device = resolve_device(device)
    return (
        sw_ops.init_sparse(cfg.gossip, cfg.sparse, device, n_rows=n_rows),
        swim_ops.impl(cfg.swim).init_state(cfg.swim, device, n_rows=n_rows),
        torch.full((n_samples, n_rows), -1, dtype=torch.int64, device=device),
    )


def check_schedule(cfg: SparseClusterConfig, schedule: Schedule) -> None:
    """Raise on a schedule the sparse engine does not run."""
    if schedule.writes.shape[1] != cfg.n_nodes:
        raise ValueError(
            f"sparse schedule writes must be [rounds, n_nodes], got "
            f"{schedule.writes.shape}"
        )
    if schedule.wipe is not None:
        raise ValueError(
            "the sparse engine does not support crash-with-state-wipe: a "
            "total wipe exceeds its bounded deviation tables"
        )


class _EpochInputs(NamedTuple):
    """An epoch's per-round tables and the epoch's topology on one device;
    ``at(i, r)`` gives round i's (absolute round r's) positional arguments
    of ``_sparse_round`` from ``topo`` to ``s_slot``."""

    topo: Topology
    writes: torch.Tensor
    part: torch.Tensor
    kill: torch.Tensor | None
    revive: torch.Tensor | None
    loss: torch.Tensor | None
    probe: torch.Tensor | None
    s_slot: torch.Tensor

    def at(self, i: int, r: int) -> tuple:
        def row(x):
            return None if x is None else x[i]

        return (self.topo, self.writes[i], self.part[i], row(self.kill), row(self.revive), r,
                row(self.loss), row(self.probe), self.s_slot)


def run_epochs(cfg: SparseClusterConfig, topo_base: Topology, schedule: Schedule, seed: int,
               box: list, planner: _Planner, start_epoch: int, positions: list, devices: list,
               drive, telemetry=None, stop_after_epoch: int | None = None, watch=None,
               after_round=None):
    """The epoch loop of ``simulate_sparse`` over mesh positions: ``box``
    holds the list of each position's (sparse state, swim state,
    vis_round) block (popped, so each round's input blocks are freed as
    the next are made), ``positions`` their ``exchange.Pos`` and
    ``devices`` their devices. ``drive(bodies)`` runs one generator body a
    position to its end, answering their exchanges, and returns their
    results (``exchange.solo`` on one position; the shard driver's
    lockstep over a mesh). Every epoch: the planner's feasibility check
    (``_demote_report`` a position) and its one host read, the rotation
    (``_rotate`` a position) and the one read of its stats, the rounds
    (``_sparse_round`` a position), then the epoch-end cold visibility a
    position (under ``watch`` when given, as the drive's steps are).
    ``after_round(blocks)`` sees every round's blocks. Returns (the final
    blocks, the merged curves, info)."""
    sp = cfg.sparse
    n = cfg.n_nodes
    rounds = schedule.rounds
    e_len = sp.epoch_rounds
    has_churn = schedule.kill is not None or schedule.revive is not None
    n_samples = len(schedule.sample_writer)
    s_round_np = np.asarray(schedule.sample_round)
    local = watch if watch is not None else contextlib.nullcontext()

    def dev(x, device, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    # The run's constants, once per distinct device.
    on = {}
    for d in devices:
        if str(d) not in on:
            t = Topology(*(None if x is None else x.to(d) for x in topo_base))
            on[str(d)] = dict(
                device=d, topo=t, n_regions=int(t.region.max()) + 1, key=rng_mod.PRNGKey(seed, d),
                s_writer=dev(schedule.sample_writer, d), s_ver=dev(schedule.sample_ver, d),
                s_round=dev(s_round_np, d),
            )
    cur = box.pop()

    def check(cand, ok):
        at = {k: (dev(cand, c["device"]), dev(ok, c["device"], torch.bool))
              for k, c in on.items()}
        (caught_up, maxload) = drive([
            sw_ops._demote_report(b[0], *at[str(d)], p)
            for b, p, d in zip(cur, positions, devices)
        ])[0]
        return caught_up.cpu().numpy(), maxload.cpu().numpy()

    curve_parts = []
    info = {"epochs": 0, "retired": 0, "promoted": 0, "dev_dropped": 0,
            "max_dev_entries": 0}
    for e0 in range(start_epoch * e_len, rounds, e_len):
        e1 = min(e0 + e_len, rounds)
        epoch = e0 // e_len
        el = e1 - e0
        w_ep = schedule.writes[e0:e1]
        plan = planner.plan(epoch, w_ep, check)
        plan_on = {
            k: tuple(dev(x, c["device"], torch.bool if x.dtype == bool else torch.int64)
                     for x in plan)
            for k, c in on.items()
        }
        outs = drive([
            sw_ops._rotate(b[0], *plan_on[str(d)], cfg.gossip, p)
            for b, p, d in zip(cur, positions, devices)
        ])
        cur = [(o[0],) + tuple(b[1:]) for o, b in zip(outs, cur)]
        rstats = outs[0][1]
        del outs
        # One read for the epoch's rotation stats.
        dropped, retired, promoted, entries = torch.stack([
            rstats[k] for k in ("dev_dropped", "retired", "promoted", "dev_entries")
        ]).tolist()
        if dropped:
            raise RuntimeError(
                f"rotate dropped {dropped} deviation entries at epoch "
                f"{epoch}: demote_report feasibility was violated"
            )
        info["epochs"] += 1
        info["retired"] += retired
        info["promoted"] += promoted
        info["max_dev_entries"] = max(info["max_dev_entries"], entries)

        wn, won, wid = planner.topology_arrays()
        writes_slots = planner.writes_to_slots(w_ep)
        s_slot = (planner.slot_of[np.asarray(schedule.sample_writer)] if n_samples
                  else np.zeros(0, np.int32))
        inputs = {}
        for k, c in on.items():
            d = c["device"]
            kill = revive = None
            if has_churn:
                zeros_n = np.zeros((el, n), bool)
                kill = dev(schedule.kill[e0:e1] if schedule.kill is not None else zeros_n, d,
                           torch.bool)
                revive = dev(schedule.revive[e0:e1] if schedule.revive is not None
                             else zeros_n, d, torch.bool)
            if schedule.partition is not None:
                part = dev(schedule.partition[e0:e1], d, torch.bool)
            else:
                part = torch.zeros((el, c["n_regions"], c["n_regions"]), dtype=torch.bool,
                                   device=d)
            inputs[k] = _EpochInputs(
                topo=c["topo"]._replace(writer_nodes=dev(wn, d), writer_of_node=dev(won, d),
                                        writer_ids=dev(wid, d)),
                writes=dev(writes_slots, d), part=part, kill=kill, revive=revive,
                loss=None if schedule.loss is None else dev(schedule.loss[e0:e1], d,
                                                            torch.float32),
                probe=(None if schedule.probe_loss is None
                       else dev(schedule.probe_loss[e0:e1], d, torch.float32)),
                s_slot=dev(s_slot, d),
            )
        # run() takes the only reference to the epoch's start blocks, so
        # each round's input blocks are freed as the next are made.
        epoch_box = [cur]
        cur = None

        def run():
            blocks, rows = epoch_box.pop(), []
            for i in range(el):
                r = e0 + i
                keys = {k: rng_mod.fold_in(c["key"], r) for k, c in on.items()}
                bodies = []
                for b, p, d in zip(blocks, positions, devices):
                    c = on[str(d)]
                    bodies.append(_sparse_round(
                        *b, *inputs[str(d)].at(i, r), c["s_ver"], c["s_round"], keys[str(d)],
                        cfg, p,
                    ))
                outs = drive(bodies)
                del bodies
                blocks = [o[:3] for o in outs]
                rows.append(outs[0][3])
                del outs
                if after_round is not None:
                    after_round(blocks)
            return blocks, telemetry_mod.stack_curves(rows)

        if telemetry is None:
            cur, curves = run()
        else:
            # An epoch boundary is a chunk boundary.
            cur, curves = telemetry.run_chunk(e0, run)
        curve_parts.append(curves)

        # Epoch-end cold visibility at epoch granularity (exact for
        # zero-lag demotions: those were visible everywhere while hot).
        if n_samples:
            s_cold = (planner.slot_of[np.asarray(schedule.sample_writer)] < 0) & (
                s_round_np <= e1 - 1
            )
            cold_on = {k: dev(s_cold, c["device"], torch.bool) for k, c in on.items()}
            with local:
                cur = [
                    (b[0], b[1], _cold_vis_update(b[0], b[2], on[str(d)]["s_writer"],
                                                  on[str(d)]["s_ver"], cold_on[str(d)], e1 - 1))
                    for b, d in zip(cur, devices)
                ]
        if stop_after_epoch is not None and epoch >= stop_after_epoch:
            break

    # A zero-epoch run (resume cursor at or past the schedule's end) returns
    # the resumed blocks with empty curves.
    merged = (
        {k: np.concatenate([p[k] for p in curve_parts]) for k in curve_parts[0]}
        if curve_parts else {}
    )
    if telemetry is not None and curve_parts:
        telemetry.on_run_end(merged)
    return cur, merged, info


def simulate_sparse(
    cfg: SparseClusterConfig,
    topo_base: Topology,
    schedule: Schedule,  # writes [rounds, N]: every node may write
    seed: int = 0,
    resume: dict | None = None,
    stop_after_epoch: int | None = None,
    telemetry: telemetry_mod.KernelTelemetry | None = None,
    device=None,
):
    """Run the epoch-rotated any-node-writes simulation. Returns
    (final SparseState, swim state, vis_round, curves, info). ``resume``
    (``info["resume"]`` of an earlier run, or ``initial_resume``) continues
    from its next epoch and is never modified; ``stop_after_epoch`` ends
    the run after that epoch. ``telemetry`` (``KernelTelemetry``) treats
    every epoch as a chunk: timed and flushed, the run's curves taken at
    the end (a resumed run appends with a ``mode="a"`` recorder). Runs on
    ``device`` (default CUDA; raises when CUDA is absent and no device is
    given). The epoch and round bodies are the partitioned run's
    (``parallel.simulate_sparse_sharded``) on one position holding every
    row."""
    device = resolve_device(device)
    check_schedule(cfg, schedule)
    planner = _Planner(cfg.n_nodes, cfg.w_hot, cfg.sparse)
    start_epoch = 0
    if resume is None:
        block = init_position(cfg, len(schedule.sample_writer), device, cfg.n_nodes)
    else:
        planner.restore(resume["planner"])
        block = (resume["sstate"], resume["swim"], resume["vis_round"])
        start_epoch = int(resume["next_epoch"])
    box = [[block]]
    block = None
    blocks, merged, info = run_epochs(
        cfg, topo_base, schedule, seed, box, planner, start_epoch,
        [exchange.whole(cfg.n_nodes)], [torch.device(device)],
        lambda bodies: [exchange.solo(b) for b in bodies],
        telemetry=telemetry, stop_after_epoch=stop_after_epoch,
    )
    sstate, swim_state, vis_round = blocks[0]
    info["resume"] = {
        "planner": planner.snapshot(),
        "sstate": sstate,
        "swim": swim_state,
        "vis_round": vis_round,
        "next_epoch": info["epochs"] + start_epoch,
    }
    return sstate, swim_state, vis_round, merged, info


def final_head_full(sstate: SparseState) -> np.ndarray:
    """head_full with the still-hot slots written back: the global
    committed head per node at the end of a run."""
    hf = sstate.head_full.cpu().numpy().copy()
    slot_writer = sstate.slot_writer.cpu().numpy()
    head = sstate.data.head.cpu().numpy()
    occ = slot_writer >= 0
    hf[slot_writer[occ]] = head[occ]
    return hf


def converged_sparse(sstate: SparseState) -> bool:
    """Hot slots at head everywhere and no deviation entries."""
    occ = sstate.slot_writer >= 0
    hot_ok = bool((sstate.data.contig[:, occ] == sstate.data.head[occ][None, :]).all())
    return hot_ok and not bool(sstate.dev_any)

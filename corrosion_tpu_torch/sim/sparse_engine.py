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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
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


def _sparse_round(st, sw, vr, topo, w_slots, part, kill, revive, r: int, loss,
                  probe_loss, s_slot, s_ver, s_round, base_key,
                  cfg: SparseClusterConfig, sp: SparseConfig):
    """One round of the epoch body (reference ``_epoch_scan_impl.body``).
    Returns (sparse state, swim state, vis_round, stats)."""
    swim_impl = swim_ops.impl(cfg.swim)
    key = rng_mod.fold_in(base_key, r)
    has_churn = kill is not None
    if has_churn:
        keys = rng_mod.split(key, 5)
        k_churn, k_b, k_sw, k_sy, k_rejoin = (keys[i] for i in range(5))
        # Pause-resume churn only (simulate_sparse refuses wipe schedules).
        sw = swim_impl.apply_churn(sw, kill, revive, k_churn, cfg.swim.max_transmissions)
    else:
        keys = rng_mod.split(key, 3)
        k_b, k_sw, k_sy = keys[0], keys[1], keys[2]
    alive = sw.alive
    r_t = torch.tensor(r, dtype=torch.int64, device=alive.device)

    with record_function("corro_broadcast"):
        data, bstats = gossip_ops.broadcast_round(
            st.data, topo, alive, part, w_slots, k_b, cfg.gossip, loss=loss
        )
    with record_function("corro_swim"):
        # After churn: revive bumps are rejoins, not flaps.
        inc_pre = sw.incarnation
        sw = swim_impl.swim_round(sw, k_sw, r_t, cfg.swim, probe_loss=probe_loss)
    with record_function("corro_sync"):
        data, ssta = gossip_ops.sync_round(data, topo, alive, part, r_t, k_sy, cfg.gossip)
        if has_churn:
            data, rsta = gossip_ops.revive_sync(
                data, topo, alive, part, revive, k_rejoin, cfg.gossip
            )
            ssta = {k: ssta[k] + rsta[k] for k in ssta}
        st = st._replace(data=data)
        st, csta = sw_ops.cold_sync(st, topo.region, alive, part, cfg.gossip, sp)

    # Hot-plane visibility for samples whose writer holds a slot.
    with record_function("corro_track"):
        hot = s_slot >= 0
        vis_now = gossip_ops.visibility(st.data, torch.clamp(s_slot, min=0), s_ver)
        active_s = r >= s_round
        vr_new = torch.where((vr < 0) & vis_now & (hot & active_s)[:, None], r, vr)

    # Staleness is measured on the hot slot plane; the cold plane's residue
    # is in `need` through cold_need.
    with record_function("corro_health"):
        newly = (vr_new >= 0) & (vr < 0)
        lat_hist = telemetry_mod.delivery_latency_hist(r - s_round[:, None], newly)
        stale_sum, stale_max = gossip_ops.staleness(st.data)
        false_alarms, undetected = swim_impl.health_counts(sw)
        # Rumor ages track the hot-plane samples, like vis_count.
        prop_stats = telemetry_mod.prop_curves(
            cfg.gossip.prop_observe, bstats.get("prop_link"),
            bstats.get("prop_useful"), bstats.get("prop_dup"),
            r - s_round[:, None], newly,
            kills=bstats.get("prop_kills"), pulls=bstats.get("prop_pulls"),
        )
        mism = swim_impl.mismatches(sw)
        need = (gossip_ops.total_need(st.data) + sw_ops.cold_need(st)) & MASK
        backlog = gossip_ops.queue_backlog(st.data)
    stats = telemetry_mod.round_curves(
        mismatches=mism,
        need=need,
        applied_broadcast=bstats["applied_broadcast"],
        applied_sync=ssta["applied_sync"],
        msgs=bstats["msgs"],
        sessions=ssta["sessions"],
        cell_merges=(
            bstats["cell_merges"] + ssta["cell_merges"] + csta["cold_merges"]
        ) & MASK,
        window_degraded=bstats["window_degraded"],
        sync_regrant=ssta["sync_regrant"],
        cold_healed=csta["cold_healed"],
        # Hot-plane visibility events only; demoted-writer samples resolve
        # at epoch granularity outside the round.
        vis_count=newly.sum(),
        staleness_sum=stale_sum,
        staleness_max=stale_max,
        swim_false_alarms=false_alarms,
        swim_undetected_deaths=undetected,
        swim_flaps=(sw.incarnation != inc_pre).sum(),
        queue_backlog=backlog,
        chaos_lost_msgs=bstats["lost_msgs"],
        **lat_hist,
        **prop_stats,
    )
    return st, sw, vr_new, stats


def _cold_vis_update(sstate: SparseState, vis_round, s_writer, s_ver, s_cold, round_now: int):
    vis = sw_ops.cold_visibility(sstate, s_writer, s_ver)
    return torch.where((vis_round < 0) & vis & s_cold[:, None], round_now, vis_round)


def initial_resume(cfg: SparseClusterConfig, n_samples: int, device=None) -> dict:
    """An epoch-0 resume point."""
    device = resolve_device(device)
    planner = _Planner(cfg.n_nodes, cfg.w_hot, cfg.sparse)
    return {
        "planner": planner.snapshot(),
        "sstate": sw_ops.init_sparse(cfg.gossip, cfg.sparse, device),
        "swim": swim_ops.impl(cfg.swim).init_state(cfg.swim, device),
        "vis_round": torch.full(
            (n_samples, cfg.n_nodes), -1, dtype=torch.int64, device=device
        ),
        "next_epoch": 0,
    }


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
    given)."""
    device = resolve_device(device)
    sp = cfg.sparse
    n = cfg.n_nodes
    rounds = schedule.rounds
    e_len = sp.epoch_rounds
    if schedule.writes.shape[1] != n:
        raise ValueError(
            f"sparse schedule writes must be [rounds, n_nodes], got "
            f"{schedule.writes.shape}"
        )
    if schedule.wipe is not None:
        raise ValueError(
            "the sparse engine does not support crash-with-state-wipe: a "
            "total wipe exceeds its bounded deviation tables"
        )
    has_churn = schedule.kill is not None or schedule.revive is not None
    topo_base = Topology(*(None if x is None else x.to(device) for x in topo_base))
    n_regions = int(topo_base.region.max()) + 1

    def dev(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    planner = _Planner(n, cfg.w_hot, sp)
    n_samples = len(schedule.sample_writer)
    start_epoch = 0
    if resume is None:
        sstate = sw_ops.init_sparse(cfg.gossip, sp, device)
        swim_state = swim_ops.impl(cfg.swim).init_state(cfg.swim, device)
        vis_round = torch.full((n_samples, n), -1, dtype=torch.int64, device=device)
    else:
        planner.restore(resume["planner"])
        sstate, swim_state = resume["sstate"], resume["swim"]
        vis_round = resume["vis_round"]
        start_epoch = int(resume["next_epoch"])
    s_writer = dev(schedule.sample_writer)
    s_ver = dev(schedule.sample_ver)
    s_round_np = np.asarray(schedule.sample_round)
    s_round = dev(s_round_np)
    base_key = rng_mod.PRNGKey(seed, device)

    def check(cand, ok):
        cu, ml = sw_ops.demote_report(sstate, dev(cand), dev(ok, torch.bool))
        return cu.cpu().numpy(), ml.cpu().numpy()

    curve_parts = []
    info = {"epochs": 0, "retired": 0, "promoted": 0, "dev_dropped": 0,
            "max_dev_entries": 0}
    for e0 in range(start_epoch * e_len, rounds, e_len):
        e1 = min(e0 + e_len, rounds)
        epoch = e0 // e_len
        w_ep = schedule.writes[e0:e1]
        plan = planner.plan(epoch, w_ep, check)
        sstate, rstats = sw_ops.rotate(
            sstate, dev(plan[0]), dev(plan[1], torch.bool), dev(plan[2]),
            dev(plan[3]), dev(plan[4], torch.bool), cfg.gossip,
        )
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
        topo = topo_base._replace(
            writer_nodes=dev(wn), writer_of_node=dev(won), writer_ids=dev(wid),
        )
        writes_slots = dev(planner.writes_to_slots(w_ep))
        el = e1 - e0
        kill = revive = None
        if has_churn:
            zeros_n = np.zeros((el, n), bool)
            kill = dev(schedule.kill[e0:e1] if schedule.kill is not None else zeros_n,
                       torch.bool)
            revive = dev(schedule.revive[e0:e1] if schedule.revive is not None
                         else zeros_n, torch.bool)
        if schedule.partition is not None:
            part = dev(schedule.partition[e0:e1], torch.bool)
        else:
            part = torch.zeros((el, n_regions, n_regions), dtype=torch.bool, device=device)
        loss = None if schedule.loss is None else dev(schedule.loss[e0:e1], torch.float32)
        probe = (
            None if schedule.probe_loss is None
            else dev(schedule.probe_loss[e0:e1], torch.float32)
        )
        s_slot = dev(
            planner.slot_of[np.asarray(schedule.sample_writer)]
            if n_samples else np.zeros(0, np.int32)
        )
        # run() takes the only reference to the epoch's start, so each
        # round's input state is freed as the next is made.
        box = [(sstate, swim_state, vis_round)]
        sstate = swim_state = vis_round = None

        def run():
            carry, rows = box.pop(), []
            for i in range(el):
                *carry, stats = _sparse_round(
                    *carry, topo, writes_slots[i], part[i],
                    None if kill is None else kill[i],
                    None if revive is None else revive[i],
                    e0 + i,
                    None if loss is None else loss[i],
                    None if probe is None else probe[i],
                    s_slot, s_ver, s_round, base_key, cfg, sp,
                )
                rows.append(stats)
            return tuple(carry), telemetry_mod.stack_curves(rows)

        if telemetry is None:
            (sstate, swim_state, vis_round), curves = run()
        else:
            # An epoch boundary is a chunk boundary.
            (sstate, swim_state, vis_round), curves = telemetry.run_chunk(e0, run)
        curve_parts.append(curves)

        # Epoch-end cold visibility at epoch granularity (exact for
        # zero-lag demotions: those were visible everywhere while hot).
        if n_samples:
            s_cold = dev(
                (planner.slot_of[np.asarray(schedule.sample_writer)] < 0)
                & (s_round_np <= e1 - 1),
                torch.bool,
            )
            vis_round = _cold_vis_update(sstate, vis_round, s_writer, s_ver, s_cold, e1 - 1)
        if stop_after_epoch is not None and epoch >= stop_after_epoch:
            break

    # A zero-epoch run (resume cursor at or past the schedule's end) returns
    # the resumed state with empty curves.
    merged = (
        {k: np.concatenate([p[k] for p in curve_parts]) for k in curve_parts[0]}
        if curve_parts else {}
    )
    if telemetry is not None and curve_parts:
        telemetry.on_run_end(merged)
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

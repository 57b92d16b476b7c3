"""Post-heal invariant checking and the seeded chaos fuzzer (counterpart
of corrosion_tpu/sim/invariants.py).

The chaos plane's judge: run an engine under a ``sim.faults.FaultPlan``
on a small standard scenario, then, after the last fault clears, verify
the protocol recovered correctly:

- **recovery**: the record goes quiet after the heal round
  (``health.recovery_after_heal``);
- **durability**: every live node's watermark reaches every writer's
  committed head;
- **agreement**: live nodes' CRDT cells equal the serial-merge ground
  truth (``gossip.serial_merge_reference``,
  ``sparse_writers.serial_merge_reference_sparse``);
- **membership**: no undetected deaths at the end, liveness as the plan
  says, and no resurrection of a wiped identity (a wiped and revived
  node rejoins at a higher incarnation). Mismatched beliefs about live
  nodes are not asserted: down beliefs stay until down-GC.

The sparse engine degrades crash-with-wipe to pause-resume and the chunk
plane drops partition, flap and probe-loss components; the report's
``facts`` name each degradation. ``fuzz`` samples random healing plans,
runs the suite, and shrinks a failing plan (``faults.shrink_plan``) to a
``corro-chaos-repro/1`` JSON that ``replay_repro`` re-runs.

Each runner takes ``device=`` (default CUDA; raises when CUDA is absent
and no device is given) and reads the final state through
``interop.to_numpy``, so every check sees the reference's dtypes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from corrosion_tpu_torch import interop, resolve_device
from corrosion_tpu_torch.ops.crdt import CellState
from corrosion_tpu_torch.sim import faults as faults_mod
from corrosion_tpu_torch.sim import health as health_mod
from corrosion_tpu_torch.sim.faults import CompiledFaults, Fault, FaultPlan

REPRO_SCHEMA = "corro-chaos-repro/1"

# One standard cluster shape for every engine scenario: plans are
# portable across engines and a fuzz batch reuses each engine's compile.
STD_NODES = 48
STD_REGIONS = 4
# Writer / stream-origin nodes — churn must not take out the
# acknowledgers the durability invariant is stated for (and the chunk
# plane's origins are each stream's only guaranteed full holder).
DENSE_WRITERS = (0, 12, 24, 36, 1, 13)
MIXED_WRITERS = (0, 12, 24, 36)
CHUNK_ORIGINS = (2, 14, 26)
PROTECTED = tuple(sorted(set(DENSE_WRITERS + MIXED_WRITERS + CHUNK_ORIGINS)))

ENGINES = ("dense", "sparse", "chunk", "mixed")


@dataclass
class InvariantReport:
    engine: str
    ok: bool
    violations: list = field(default_factory=list)
    heal_round: int = 0
    recovery: dict = field(default_factory=dict)
    facts: dict = field(default_factory=dict)
    plan: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "engine": self.engine, "ok": self.ok,
            "violations": list(self.violations),
            "heal_round": self.heal_round, "recovery": self.recovery,
            "facts": self.facts, "plan": self.plan,
        }

    def render(self) -> str:
        head = f"[{self.engine}] {'OK' if self.ok else 'FAIL'}"
        rec = self.recovery.get("recovery_rounds")
        head += (
            f" heal@{self.heal_round}"
            + (f" recovered +{rec} rounds" if rec is not None
               else " NOT RECOVERED")
        )
        lines = [head]
        lines += [f"  violation: {v}" for v in self.violations]
        if self.facts.get("degraded"):
            lines.append(f"  degraded: {', '.join(self.facts['degraded'])}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Plan portability: per-engine degradation + dense fault-axis threading.


def plan_for_engine(plan: FaultPlan, engine: str) -> tuple[FaultPlan, list]:
    """Degrade a plan to what ``engine`` can express. Returns
    (plan, notes); notes name every dropped/weakened component."""
    notes: list = []
    out = []
    for f in plan.faults:
        if engine == "chunk" and f.kind in ("partition", "flap"):
            notes.append(f"{f.kind} dropped (chunk plane has no regions)")
            continue
        if engine == "chunk" and f.kind == "probe_loss":
            notes.append("probe_loss dropped (chunk plane has no SWIM)")
            continue
        if engine == "sparse" and f.kind == "churn" and f.wipe:
            notes.append(
                "wipe degraded to pause-resume (sparse engine's bounded "
                "deviation tables)"
            )
            f = Fault(
                "churn", f.start, f.stop, nodes=f.nodes,
                revive_at=f.revive_at, wipe=False,
            )
        out.append(f)
    return FaultPlan(plan.rounds, tuple(out), plan.name), notes


def _densify(c: CompiledFaults, n_nodes: int, n_regions: int,
             wipe: bool = True) -> CompiledFaults:
    """Thread EVERY fault axis (zeros where the plan is silent) so all
    plans of one batch share one engine trace. Zero masks are
    behavior-identical to absent ones within that trace."""
    r = c.rounds
    if c.loss is None:
        c.loss = np.zeros((r, n_regions), np.float32)
    if c.probe_loss is None:
        c.probe_loss = np.zeros(r, np.float32)
    if c.kill is None:
        c.kill = np.zeros((r, n_nodes), bool)
        c.revive = np.zeros((r, n_nodes), bool)
    if c.revive is None:
        c.revive = np.zeros((r, n_nodes), bool)
    if wipe and c.wipe is None:
        c.wipe = np.zeros((r, n_nodes), bool)
    return c


# ---------------------------------------------------------------------------
# Standard scenarios. Shapes depend only on ``rounds`` so a fuzz batch
# (fixed rounds) compiles each engine once.


def _write_window(plan: FaultPlan) -> int:
    """Writes stop at the later of the heal round and ~55% of the run,
    leaving a drain tail that can prove recovery."""
    drain = max(plan.rounds // 3, 8)
    return max(min(plan.heal_round + 2, plan.rounds - drain), 4)


def _dense_scenario(plan: FaultPlan, seed: int, device):
    from corrosion_tpu_torch.models.baselines import _cfg
    from corrosion_tpu_torch.sim.engine import Schedule

    cfg, topo = _cfg(
        STD_NODES, writers=list(DENSE_WRITERS),
        regions=[STD_NODES // STD_REGIONS] * STD_REGIONS,
        sync_interval=5, sync_budget=512, sync_chunk=128,
        n_cells=64,
        # down-GC keeps sticky down beliefs from pinning memory forever.
        swim_kw={"down_gc_rounds": 24}, device=device,
    )
    rng = np.random.default_rng(seed)
    writes = np.zeros((plan.rounds, len(DENSE_WRITERS)), np.uint32)
    w_stop = _write_window(plan)
    writes[:w_stop] = (
        rng.random((w_stop, len(DENSE_WRITERS))) < 0.25
    ).astype(np.uint32)
    writes[0, :] = 1  # every stream exists before any fault can start
    sched = Schedule(writes=writes).make_samples(32)
    return cfg, topo, sched


def _node_cells(cells: dict, n: int, k: int) -> CellState:
    """A numpy cell dict (``interop.to_numpy``) as [N, K] registers."""
    return CellState(*(np.asarray(cells[f]).reshape(n, k) for f in CellState._fields))


def _ground_truth(cells: CellState) -> CellState:
    return CellState(**interop.to_numpy(cells))


def run_dense(plan: FaultPlan, seed: int = 0, device=None) -> InvariantReport:
    from corrosion_tpu_torch.ops import gossip
    from corrosion_tpu_torch.sim.engine import simulate, visibility_latencies

    device = resolve_device(device)
    cfg, topo, sched = _dense_scenario(plan, seed, device)
    compiled = _densify(
        plan.compile(STD_NODES, STD_REGIONS), STD_NODES, STD_REGIONS
    )
    sched = faults_mod.apply_plan(sched, compiled, STD_NODES, STD_REGIONS)
    final, curves = simulate(cfg, topo, sched, seed=seed, device=device)

    rep = _base_report("dense", plan, compiled, curves, cfg.round_ms)
    fs = interop.to_numpy(final)
    alive = fs["swim"]["alive"]
    _check_liveness(rep, plan, alive)
    _check_durability(rep, alive, fs["data"]["head"], fs["data"]["contig"])
    if cfg.gossip.n_cells > 0:
        ref = _ground_truth(gossip.serial_merge_reference(final.data.head, cfg.gossip))
        pc = _node_cells(fs["data"]["cells"], cfg.n_nodes, cfg.gossip.n_cells)
        _check_cell_agreement(
            rep, pc.cl, pc.col_version, pc.value_rank, ref, alive, "serial merge",
        )
    _check_no_resurrection(rep, plan, fs["swim"]["incarnation"])
    if rep.recovery.get("recovered_round") is not None:
        lat = visibility_latencies(final, sched, cfg, alive_only=True)
        if lat["unseen"] > 0:
            rep.violations.append(
                f"{lat['unseen']} sampled (write, live node) pairs never "
                f"became visible despite recovery"
            )
        rep.facts["vis_p99_s"] = lat["p99_s"]
    rep.ok = not rep.violations
    return rep


def _sparse_scenario(plan: FaultPlan, seed: int, device):
    from corrosion_tpu_torch.models.baselines import anywrite_sparse

    return anywrite_sparse(
        n=STD_NODES, w_hot=16, rounds=plan.rounds,
        n_regions=STD_REGIONS, epoch_rounds=8, cohort=5, burst_writes=1,
        samples=0, seed=seed, k_dev=16, demote_after=1, device=device,
    )


def run_sparse(plan: FaultPlan, seed: int = 0, device=None) -> InvariantReport:
    from corrosion_tpu_torch.ops.sparse_writers import serial_merge_reference_sparse
    from corrosion_tpu_torch.sim.sparse_engine import final_head_full, simulate_sparse

    device = resolve_device(device)
    plan_e, notes = plan_for_engine(plan, "sparse")
    cfg, topo, sched = _sparse_scenario(plan_e, seed, device)
    compiled = _densify(
        plan_e.compile(STD_NODES, STD_REGIONS, allow_wipe=False),
        STD_NODES, STD_REGIONS, wipe=False,
    )
    sched = faults_mod.apply_plan(sched, compiled, STD_NODES, STD_REGIONS)
    sstate, swim_state, _vis, curves, info = simulate_sparse(
        cfg, topo, sched, seed=seed, device=device,
    )

    rep = _base_report("sparse", plan_e, compiled, curves, cfg.round_ms)
    rep.facts["degraded"] = notes
    fs, sw = interop.to_numpy(sstate), interop.to_numpy(swim_state)
    alive = sw["alive"]
    _check_liveness(rep, plan_e, alive)

    # Durability on the rotating-slot plane: hot slots at head for live
    # nodes, no outstanding deviation entries anywhere.
    occ = fs["slot_writer"] >= 0
    contig = fs["data"]["contig"][:, occ]
    head = fs["data"]["head"][occ]
    lag = (contig < head[None, :]) & alive[:, None]
    if lag.any():
        n_bad = int(lag.any(axis=1).sum())
        rep.violations.append(
            f"acknowledged writes lost on the hot plane: {n_bad} live "
            f"node(s) below a writer's committed head"
        )
    if bool(fs["dev_any"]):
        rep.violations.append(
            "cold-plane deviation entries outstanding at record end"
        )
    if cfg.gossip.n_cells > 0:
        hf = final_head_full(sstate)
        ref = _ground_truth(serial_merge_reference_sparse(hf, cfg.gossip, device))
        pc = _node_cells(fs["data"]["cells"], cfg.n_nodes, cfg.gossip.n_cells)
        _check_cell_agreement(
            rep, pc.cl, pc.col_version, pc.value_rank, ref, alive,
            "sparse serial merge",
        )
    _check_no_resurrection(rep, plan_e, sw["incarnation"])
    rep.facts["epochs"] = info["epochs"]
    rep.ok = not rep.violations
    return rep


def run_chunks(plan: FaultPlan, seed: int = 0, device=None) -> InvariantReport:
    from corrosion_tpu_torch.ops import chunks as chunk_ops
    from corrosion_tpu_torch.ops.chunks import ChunkConfig
    from corrosion_tpu_torch.sim.chunk_engine import simulate_chunks

    device = resolve_device(device)
    plan_e, notes = plan_for_engine(plan, "chunk")
    ccfg = ChunkConfig(
        n_nodes=STD_NODES, n_streams=len(CHUNK_ORIGINS), cap=16,
        chunk_len=128, fanout=3, k_in=6, sync_interval=4,
        gap_requests=4, sync_seq_budget=2048,
    )
    last_seq = np.full(len(CHUNK_ORIGINS), 1023, np.int32)
    # Compiled at the standard region count: the chunk engine reads the
    # worst-region ``loss_scalar``, so region-targeted loss still applies.
    compiled = _densify(
        plan_e.compile(STD_NODES, STD_REGIONS), STD_NODES, STD_REGIONS
    )
    compiled.partition = None  # plan_for_engine dropped the components
    state, metrics = simulate_chunks(
        ccfg, np.asarray(CHUNK_ORIGINS, np.int32), last_seq,
        rounds=plan_e.rounds, seed=seed, faults=compiled, device=device,
    )
    curves = metrics["curves"]

    rep = _base_report("chunk", plan_e, compiled, curves, 500.0)
    rep.facts["degraded"] = notes
    alive = compiled.alive_curve(STD_NODES)[-1]
    applied = chunk_ops.applied_mask(
        state, torch.as_tensor(last_seq, dtype=torch.int64, device=device), ccfg
    ).cpu().numpy()
    missing = (~applied) & alive[:, None]
    if missing.any():
        rep.violations.append(
            f"{int(missing.sum())} live (node, stream) pairs never "
            f"reassembled their stream"
        )
    rep.facts["applied_frac"] = metrics["applied_frac"]
    rep.ok = not rep.violations
    return rep


def _mixed_scenario(plan: FaultPlan, seed: int, device):
    """Small mixed workload: MIXED_WRITERS background writers, two of
    them each committing one large multi-chunk transaction before the
    fault window closes (the mixed_storm recipe at suite scale)."""
    from corrosion_tpu_torch.models.baselines import _cfg
    from corrosion_tpu_torch.ops.chunks import ChunkConfig
    from corrosion_tpu_torch.sim.engine import Schedule
    from corrosion_tpu_torch.sim.mixed_engine import StreamSpec

    rounds = plan.rounds
    streams = 2
    cfg, topo = _cfg(
        STD_NODES, writers=list(MIXED_WRITERS),
        regions=[STD_NODES // STD_REGIONS] * STD_REGIONS,
        sync_interval=5, sync_budget=512, sync_chunk=128,
        n_cells=64, swim_kw={"down_gc_rounds": 24}, device=device,
    )
    rng = np.random.default_rng(seed)
    w_stop = _write_window(plan)
    writes = np.zeros((rounds, len(MIXED_WRITERS)), np.uint32)
    writes[:w_stop] = (
        rng.random((w_stop, len(MIXED_WRITERS))) < 0.2
    ).astype(np.uint32)
    writes[0, :] = 1
    commit_round = np.asarray(
        sorted(rng.integers(2, max(w_stop - 2, 3), streams)), np.int32
    )
    version = np.zeros(streams, np.uint32)
    for s in range(streams):
        version[s] = writes[: commit_round[s], s].sum() + 1
    spec = StreamSpec(
        writer=np.arange(streams, dtype=np.int32),
        version=version,
        commit_round=commit_round,
        last_seq=np.full(streams, 511, np.int32),
    )
    ccfg = ChunkConfig(
        n_nodes=STD_NODES, n_streams=streams, cap=16, chunk_len=128,
        fanout=3, k_in=6, sync_interval=4, gap_requests=4,
        sync_seq_budget=2048,
    )
    sched = Schedule(writes=writes).make_samples(16)
    # Samples at/after a big version shift up one slot (mixed_storm's
    # bookkeeping rule).
    for i in range(len(sched.sample_writer)):
        w = sched.sample_writer[i]
        if w < streams and sched.sample_ver[i] >= version[w]:
            sched.sample_ver[i] += 1
    return cfg, ccfg, topo, sched, spec


def run_mixed(plan: FaultPlan, seed: int = 0, device=None) -> InvariantReport:
    from corrosion_tpu_torch.ops import gossip
    from corrosion_tpu_torch.sim.mixed_engine import simulate_mixed

    device = resolve_device(device)
    cfg, ccfg, topo, sched, spec = _mixed_scenario(plan, seed, device)
    compiled = _densify(
        plan.compile(STD_NODES, STD_REGIONS), STD_NODES, STD_REGIONS
    )
    sched = faults_mod.apply_plan(sched, compiled, STD_NODES, STD_REGIONS)
    final, curves = simulate_mixed(
        cfg, ccfg, topo, sched, spec, seed=seed, device=device,
    )

    rep = _base_report("mixed", plan, compiled, curves, cfg.round_ms)
    fs = interop.to_numpy(final)
    alive = fs["swim"]["alive"]
    _check_liveness(rep, plan, alive)
    heads = fs["data"]["head"]
    _check_durability(rep, alive, heads, fs["data"]["contig"])
    # The big versions really occupy their slots and reassembled at
    # every live node (directly or via sync backfill).
    for s in range(len(spec.writer)):
        if heads[spec.writer[s]] < spec.version[s]:
            rep.violations.append(
                f"big version {int(spec.version[s])} of writer "
                f"{int(spec.writer[s])} never committed"
            )
    not_applied = (~fs["applied_before"]) & alive[:, None]
    if not_applied.any():
        rep.violations.append(
            f"{int(not_applied.sum())} live (node, stream) pairs never "
            f"applied their big version"
        )
    if cfg.gossip.n_cells > 0:
        ref = _ground_truth(gossip.serial_merge_reference(final.data.head, cfg.gossip))
        pc = _node_cells(fs["data"]["cells"], cfg.n_nodes, cfg.gossip.n_cells)
        _check_cell_agreement(
            rep, pc.cl, pc.col_version, pc.value_rank, ref, alive,
            "serial merge (big versions included)",
        )
    _check_no_resurrection(rep, plan, fs["swim"]["incarnation"])
    rep.ok = not rep.violations
    return rep


# ---------------------------------------------------------------------------
# Shared checks.


def _base_report(engine, plan, compiled, curves, round_ms):
    rep = InvariantReport(
        engine=engine, ok=False, heal_round=plan.heal_round,
        plan=plan.to_dict(),
    )
    rep.recovery = health_mod.recovery_after_heal(
        curves, plan.heal_round, round_ms=round_ms
    )
    if not plan.heals:
        rep.violations.append(
            "plan never heals (a fault component has no clear round) — "
            "post-heal invariants are unsatisfiable"
        )
    if rep.recovery["recovered_round"] is None:
        need = np.asarray(curves["need"], dtype=np.float64)
        stale = np.asarray(curves["staleness_sum"], dtype=np.float64)
        undet = np.asarray(
            curves["swim_undetected_deaths"], dtype=np.float64
        )
        rep.violations.append(
            f"did not recover after heal@{plan.heal_round}: record ends "
            f"with need={need[-1]:g} staleness={stale[-1]:g} "
            f"undetected_deaths={undet[-1]:g}"
        )
    rep.facts["msgs_total"] = float(
        np.asarray(curves["msgs"], dtype=np.float64).sum()
    )
    rep.facts["chaos_lost_msgs"] = float(
        np.asarray(curves["chaos_lost_msgs"], dtype=np.float64).sum()
    )
    rep.facts["chaos_wiped"] = float(
        np.asarray(curves["chaos_wiped"], dtype=np.float64).sum()
    )
    return rep


def _check_liveness(rep, plan, alive):
    dead_forever = set(plan.killed_forever())
    expect = np.asarray(
        [i not in dead_forever for i in range(len(alive))], bool
    )
    if not (alive == expect).all():
        drift = np.nonzero(alive != expect)[0][:8]
        rep.violations.append(
            f"ground-truth liveness drifted from the plan at nodes "
            f"{drift.tolist()}"
        )


def _check_cell_agreement(rep, cl, cv, vr, ref, alive, label):
    """Live nodes' CRDT registers must equal the serial-merge ground
    truth ``ref`` (one shared comparison for all three engines that
    carry a cell plane)."""
    bad = ~(
        (np.asarray(cl) == np.asarray(ref.cl)[None, :])
        & (np.asarray(cv) == np.asarray(ref.col_version)[None, :])
        & (np.asarray(vr) == np.asarray(ref.value_rank)[None, :])
    ).all(axis=1)
    bad &= alive
    if bad.any():
        rep.violations.append(
            f"CRDT cell disagreement vs {label} on {int(bad.sum())} live "
            f"node(s), first node {int(np.nonzero(bad)[0][0])}"
        )


def _check_durability(rep, alive, head, contig):
    lag = (contig < head[None, :]) & alive[:, None]
    if lag.any():
        i, w = np.nonzero(lag)
        rep.violations.append(
            f"acknowledged writes lost: {int(lag.any(axis=1).sum())} live "
            f"node(s) below a committed head (first: node {int(i[0])} "
            f"holds {int(contig[i[0], w[0]])}/{int(head[w[0]])} of writer "
            f"{int(w[0])})"
        )


def _check_no_resurrection(rep, plan, incarnation):
    """A wiped+revived node must rejoin as a NEW identity (incarnation
    strictly above the wiped one's floor of 0) — stale pre-wipe beliefs
    must never outrank it back to life."""
    wiped = [
        n for n in plan.wipes() if n not in set(plan.killed_forever())
    ]
    if not wiped:
        return
    inc = np.asarray(incarnation)[wiped]
    if (inc < 1).any():
        rep.violations.append(
            f"wiped node(s) {np.asarray(wiped)[inc < 1].tolist()} rejoined "
            f"without an incarnation bump — resurrection of the wiped "
            f"identity"
        )


RUNNERS = {
    "dense": run_dense,
    "sparse": run_sparse,
    "chunk": run_chunks,
    "mixed": run_mixed,
}


def run_suite(
    plan: FaultPlan, engines=ENGINES, seed: int = 0, progress=None, device=None,
) -> list:
    reports = []
    for eng in engines:
        if progress is not None:
            progress.write(f"[chaos] {eng}: {plan.describe()}\n")
            progress.flush()
        reports.append(RUNNERS[eng](plan, seed=seed, device=device))
    return reports


# ---------------------------------------------------------------------------
# The fuzzer.


def fuzz(
    seed: int = 0,
    plans: int = 4,
    engines=ENGINES,
    rounds: int = 64,
    out_dir: str | None = None,
    break_heal: bool = False,
    shrink_evals: int = 24,
    allow_wipe: bool = True,
    progress=None,
    device=None,
) -> dict:
    """Seeded chaos fuzz: ``plans`` random fault plans through the
    invariant suite on ``engines``. On a failure, shrink the plan
    against the first failing engine and (with ``out_dir``) write a
    minimal JSON repro artifact. Returns a summary dict with
    ``failures`` (count) and ``repros`` (artifact paths/dicts)."""
    rng = np.random.default_rng(seed)
    results = []
    repros = []
    for i in range(plans):
        plan = faults_mod.random_plan(
            rng, rounds, STD_REGIONS, STD_NODES, protect=PROTECTED,
            allow_wipe=allow_wipe, break_heal=break_heal,
        )
        plan = FaultPlan(plan.rounds, plan.faults, name=f"fuzz-{seed}-{i}")
        reports = run_suite(plan, engines, seed=seed, progress=progress, device=device)
        failed = [r for r in reports if not r.ok]
        entry = {
            "plan": plan.to_dict(),
            "describe": plan.describe(),
            "reports": [r.to_dict() for r in reports],
            "ok": not failed,
        }
        if failed:
            eng = failed[0].engine
            runner = RUNNERS[eng]

            def still_fails(p, runner=runner):
                return not runner(p, seed=seed, device=device).ok

            minimal, evals = faults_mod.shrink_plan(
                plan, still_fails, max_evals=shrink_evals
            )
            final_rep = runner(minimal, seed=seed, device=device)
            repro = {
                "schema": REPRO_SCHEMA,
                "seed": seed,
                "engine": eng,
                "scenario": {
                    "nodes": STD_NODES, "regions": STD_REGIONS,
                    "protected": list(PROTECTED),
                },
                "original_plan": plan.to_dict(),
                "plan": minimal.to_dict(),
                "shrink_evals": evals,
                "violations": list(final_rep.violations),
            }
            entry["repro"] = repro
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir, f"chaos_repro_{seed}_{i}_{eng}.json"
                )
                with open(path, "w") as f:
                    json.dump(repro, f, indent=2)
                entry["repro_path"] = path
                repros.append(path)
            else:
                repros.append(repro)
            if progress is not None:
                progress.write(
                    f"[chaos] plan {i} FAILED on {eng}; shrunk "
                    f"{len(plan.faults)} -> {len(minimal.faults)} "
                    f"component(s) in {evals} eval(s)\n"
                )
                progress.flush()
        results.append(entry)
    return {
        "seed": seed,
        "plans": results,
        "failures": sum(1 for r in results if not r["ok"]),
        "repros": repros,
    }


def replay_repro(path: str, progress=None, device=None) -> InvariantReport:
    """Re-run a shrunk repro artifact's plan on its engine — the
    round-trip that makes the fuzzer's output actionable."""
    with open(path) as f:
        repro = json.load(f)
    if repro.get("schema") != REPRO_SCHEMA:
        raise ValueError(f"{path}: not a {REPRO_SCHEMA} artifact")
    plan = FaultPlan.from_dict(repro["plan"])
    if progress is not None:
        progress.write(
            f"[chaos] replaying {repro['engine']} repro: "
            f"{plan.describe()}\n"
        )
    return RUNNERS[repro["engine"]](
        plan, seed=int(repro.get("seed", 0)), device=device
    )

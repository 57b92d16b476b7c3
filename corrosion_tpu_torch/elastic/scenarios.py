"""The elastic scenario catalog: named survival drills with their oracles
built in (counterpart of corrosion_tpu/elastic/scenarios.py).

- **reshard_<engine>_<D>to<D'>**: checkpoint at a chunk boundary on a
  D-position mesh, re-place on D', resume. Oracles: the final state equals
  the uninterrupted same-seed run on the target mesh, the tail curves
  equal its tail (the prefix's too, but for the mesh-dependent xshard
  keys), and the byte reconcile of ``elastic/reshard.py``. The dense
  matrix is ``RESHARD_MATRIX``; the other engines run one 4->8 drill each.
- **preempt_dense_churn**: the invariant suite's dense churn scenario with
  two ``preempt`` events on the fault plane. The run must pass every dense
  invariant, end equal to the never-preempted run, and show its recovery
  machinery fired.

``soak_preempt``, the endurance tie-in, needs the metric-series recorder
and the endurance detectors (``obs/series``, ``obs/endurance``), which
the port does not hold yet: ``run_scenario`` refuses it by name.
"""

from __future__ import annotations

import numpy as np

from corrosion_tpu_torch import interop, resolve_device
from corrosion_tpu_torch.elastic import preempt as preempt_mod
from corrosion_tpu_torch.elastic import report as report_mod
from corrosion_tpu_torch.elastic import reshard as reshard_mod
from corrosion_tpu_torch.elastic.report import ELASTIC_SCHEMA
from corrosion_tpu_torch.sim import benchlib

# Grow, shrink, deep shrink (8->2 leaves the 2-D mesh for the 1-D) and a
# cold one-position restore onto a full mesh.
RESHARD_MATRIX = ((4, 8), (8, 4), (8, 2), (1, 8))

RESHARD_ENGINES = ("dense", "sparse", "chunk", "mixed")

# One preempted position per event; two events, so the second recovery
# proves a checkpoint taken after a recovery works too.
PREEMPT_EVENTS = ((18, 6), (31, 1))
PREEMPT_ROUNDS = 48
PREEMPT_CHECKPOINT_EVERY = 12


def scenario_names() -> list:
    names = [f"reshard_dense_{a}to{b}" for a, b in RESHARD_MATRIX] + [
        f"reshard_{e}_4to8" for e in RESHARD_ENGINES if e != "dense"
    ]
    return names + ["preempt_dense_churn", "soak_preempt"]


def _dense_setup(device):
    """The partitioned 4-region WAN workload at n=64 (divisible by every
    mesh size of the matrix): 16 writers, 24 rounds."""
    from corrosion_tpu_torch.models import baselines

    cfg, topo, sched = baselines.wan_100k(
        n=64, n_regions=4, n_writers=16, rounds=24, samples=16, device=device
    )
    sched.writes[:8, :] = 1
    return cfg, topo, sched.make_samples(16)


def run_reshard_scenario(
    engine: str, d_from: int, d_to: int, seed: int = 0, checkpoint_dir: str | None = None,
    device=None,
) -> dict:
    """One reshard drill on meshes of positions on ``device`` (default
    CUDA)."""
    from corrosion_tpu_torch.parallel import shard_driver

    device = resolve_device(device)
    name = f"reshard_{engine}_{d_from}to{d_to}"
    mesh_from = reshard_mod.virtual_mesh(d_from, device)
    mesh_to = reshard_mod.virtual_mesh(d_to, device)

    if engine == "dense":
        cfg, topo, sched = _dense_setup(device)
        split = sched.rounds // 2
        fp = benchlib.config_fingerprint("elastic", engine, cfg, d_from, d_to, seed)
        run = reshard_mod.run_dense_resharded(
            cfg, topo, sched, mesh_from, mesh_to, split, seed=seed,
            checkpoint_dir=checkpoint_dir, fingerprint=fp,
        )
        ref_final, ref_curves = shard_driver.simulate_sharded(cfg, topo, sched, mesh_to, seed=seed)
    elif engine == "sparse":
        from corrosion_tpu_torch.models.baselines import anywrite_sparse

        cfg, topo, sched = anywrite_sparse(
            n=64, w_hot=8, rounds=32, n_regions=4, epoch_rounds=8, cohort=4, burst_writes=2,
            samples=32, k_dev=16, partition=True, seed=seed, device=device,
        )
        fp = benchlib.config_fingerprint("elastic", engine, cfg, d_from, d_to, seed)
        run = reshard_mod.run_sparse_resharded(
            cfg, topo, sched, mesh_from, mesh_to, split_epoch=2, seed=seed,
            checkpoint_dir=checkpoint_dir, fingerprint=fp,
        )
        split = run.split
        *ref_state, ref_curves, _info = shard_driver.simulate_sparse_sharded(
            cfg, topo, sched, mesh_to, seed=seed
        )
        ref_final = tuple(ref_state)
    elif engine == "chunk":
        from corrosion_tpu_torch.ops.chunks import ChunkConfig

        ccfg = ChunkConfig(
            n_nodes=64, n_streams=3, cap=16, chunk_len=128, fanout=3, k_in=6,
            sync_interval=4, gap_requests=4, sync_seq_budget=2048,
        )
        origin = np.asarray([0, 21, 42], np.int32)
        last_seq = np.full(3, 1023, np.int32)
        rounds, split = 24, 12
        fp = benchlib.config_fingerprint("elastic", engine, ccfg, d_from, d_to, seed)
        run = reshard_mod.run_chunks_resharded(
            ccfg, origin, last_seq, rounds, mesh_from, mesh_to, split, seed=seed,
            checkpoint_dir=checkpoint_dir, fingerprint=fp,
        )
        ref_state, ref_m = shard_driver.simulate_chunks_sharded(
            ccfg, origin, last_seq, rounds, mesh_to, seed=seed
        )
        ref_final, ref_curves = (ref_state, ref_m["vis"]), ref_m["curves"]
    elif engine == "mixed":
        from corrosion_tpu_torch.sim import invariants as inv
        from corrosion_tpu_torch.sim.faults import FaultPlan

        cfg, ccfg, topo, sched, spec = inv._mixed_scenario(
            FaultPlan(rounds=24, name="elastic-mixed"), seed, device
        )
        split = 12
        fp = benchlib.config_fingerprint("elastic", engine, cfg, ccfg, d_from, d_to, seed)
        run = reshard_mod.run_mixed_resharded(
            cfg, ccfg, topo, sched, spec, mesh_from, mesh_to, split, seed=seed,
            checkpoint_dir=checkpoint_dir, fingerprint=fp,
        )
        ref_final, ref_curves = shard_driver.simulate_mixed_sharded(
            cfg, ccfg, topo, sched, spec, mesh_to, seed=seed
        )
    else:
        raise ValueError(f"unknown engine {engine!r}")

    mismatches = report_mod.diff_trees(run.final, ref_final, "final.")
    # The prefix ran on the source mesh: compared without the
    # mesh-dependent wire-volume keys. The tail ran on the reference's
    # mesh: every key, xshard included.
    mismatches += [
        f"prefix {m}" for m in report_mod.diff_curves(
            run.prefix_curves, report_mod.slice_curves(ref_curves, 0, split),
            skip=report_mod.XSHARD_CURVE_KEYS,
        )
    ]
    mismatches += [
        f"tail {m}" for m in report_mod.diff_curves(
            run.tail_curves, report_mod.slice_curves(ref_curves, split)
        )
    ]
    ok = not mismatches and run.reconcile.get("ok", False)
    return {
        "schema": ELASTIC_SCHEMA,
        "scenario": name,
        "kind": "reshard",
        "engine": engine,
        "d_from": d_from,
        "d_to": d_to,
        "split": run.split,
        "bit_identical": not mismatches,
        "mismatches": mismatches[:20],
        "reconcile": run.reconcile,
        "checkpoint": run.checkpoint,
        "violations": [],
        "wall_s": run.wall_s,
        "seed": seed,
        "ok": bool(ok),
    }


def _preempt_plan():
    from corrosion_tpu_torch.sim.faults import Fault, FaultPlan

    (r0, d0), (r1, d1) = PREEMPT_EVENTS
    return FaultPlan(
        rounds=PREEMPT_ROUNDS,
        name="preempt_dense_churn",
        faults=(
            Fault("churn", 10, 11, nodes=(5, 29), revive_at=22),
            Fault("loss", 12, 24, prob=0.3, regions=(1,)),
            Fault("preempt", r0, r0 + 1, device=d0),
            Fault("preempt", r1, r1 + 1, device=d1),
        ),
    )


def run_preempt_scenario(
    seed: int = 0, devices: int = 8, checkpoint_dir: str | None = None, device=None,
    _return_run: bool = False,
):
    """Preemption over the invariant suite's dense churn workload, on a
    mesh of ``devices`` positions on ``device`` (default CUDA). Oracles:
    the dense invariant suite on the final state, equality with the
    never-preempted run, recovery machinery fired, gap replays equal."""
    from corrosion_tpu_torch.ops import gossip
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.parallel import shard_driver
    from corrosion_tpu_torch.sim import faults as faults_mod
    from corrosion_tpu_torch.sim import invariants as inv

    device = resolve_device(device)
    plan = _preempt_plan()
    cfg, topo, sched = inv._dense_scenario(plan, seed, device)
    compiled = inv._densify(
        plan.kernel_plan().compile(inv.STD_NODES, inv.STD_REGIONS),
        inv.STD_NODES, inv.STD_REGIONS,
    )
    sched = faults_mod.apply_plan(sched, compiled, inv.STD_NODES, inv.STD_REGIONS)
    mesh = reshard_mod.virtual_mesh(devices, device)
    fp = benchlib.config_fingerprint("elastic", "preempt", cfg, devices, seed)
    run = preempt_mod.run_dense_preempted(
        cfg, topo, sched, mesh, plan.preempt_events(), PREEMPT_CHECKPOINT_EVERY, seed=seed,
        checkpoint_dir=checkpoint_dir, fingerprint=fp,
    )

    # Oracle 1: equal to the uninterrupted run on the same mesh.
    ref_final, ref_curves = shard_driver.simulate_sharded(cfg, topo, sched, mesh, seed=seed)
    mismatches = report_mod.diff_trees(run.final, ref_final, "final.")
    mismatches += report_mod.diff_curves(run.curves, ref_curves)

    # Oracle 2: the dense invariant suite still holds after two
    # recoveries (serial-merge agreement, durability, monotone
    # incarnations).
    final = mesh_mod.to_host(run.final)
    fs = interop.to_numpy(final)
    rep = inv._base_report("dense", plan, compiled, run.curves, cfg.round_ms)
    alive = fs["swim"]["alive"]
    inv._check_liveness(rep, plan, alive)
    inv._check_durability(rep, alive, fs["data"]["head"], fs["data"]["contig"])
    if cfg.gossip.n_cells > 0:
        ref = inv._ground_truth(gossip.serial_merge_reference(final.data.head, cfg.gossip))
        pc = inv._node_cells(fs["data"]["cells"], cfg.n_nodes, cfg.gossip.n_cells)
        inv._check_cell_agreement(
            rep, pc.cl, pc.col_version, pc.value_rank, ref, alive, "serial merge",
        )
    inv._check_no_resurrection(rep, plan, fs["swim"]["incarnation"])
    rep.ok = not rep.violations

    # Oracle 3: the machinery fired, and the kill was real.
    machinery = {
        **run.counters.to_dict(),
        "poison_changed": run.facts["poison_changed"],
        "replay_identical": run.facts["replay_identical"],
    }
    recs = run.facts["reconciles"]
    reconcile = {
        "ok": bool(recs) and all(r.get("ok") for r in recs),
        "count": len(recs),
        "predicted_per_device_bytes": recs[0]["predicted_per_device_bytes"] if recs else None,
    }
    ok = (
        rep.ok and not mismatches and run.counters.fired()
        and run.facts["poison_changed"] and run.facts["replay_identical"] and reconcile["ok"]
    )
    result = {
        "schema": ELASTIC_SCHEMA,
        "scenario": "preempt_dense_churn",
        "kind": "preempt",
        "engine": "dense",
        "devices": devices,
        "rounds": run.rounds,
        "round_ms": float(cfg.round_ms),
        "checkpoint_every": run.checkpoint_every,
        "events": [list(e) for e in run.events],
        "plan": plan.describe(),
        "bit_identical": not mismatches,
        "mismatches": mismatches[:20],
        "violations": list(rep.violations),
        "recovery": rep.recovery,
        "machinery": machinery,
        "reconcile": reconcile,
        "checkpoints": run.facts["checkpoints"],
        "wall_s": run.wall_s,
        "seed": seed,
        "ok": bool(ok),
    }
    return (result, run) if _return_run else result


def run_scenario(name: str, seed: int = 0, checkpoint_dir: str | None = None, device=None) -> dict:
    """Dispatch a catalog name to its runner."""
    if name.startswith("reshard_"):
        engine, pair = name[len("reshard_"):].rsplit("_", 1)
        d_from, d_to = (int(x) for x in pair.split("to"))
        return run_reshard_scenario(
            engine, d_from, d_to, seed=seed, checkpoint_dir=checkpoint_dir, device=device
        )
    if name == "preempt_dense_churn":
        return run_preempt_scenario(seed=seed, checkpoint_dir=checkpoint_dir, device=device)
    if name == "soak_preempt":
        raise NotImplementedError(
            "soak_preempt needs the metric-series recorder and the endurance "
            "detectors (obs/series, obs/endurance, utils/metrics), which the "
            "port has not taken over yet: ROADMAP Queue 1 item 5, the host planes"
        )
    raise ValueError(f"unknown elastic scenario {name!r}; one of {scenario_names()}")

"""The three standing fidelity scenarios (docs/FIDELITY.md).

- :func:`steady_load`: a constant-rate write stream across every live
  writer — the baseline mixed-mode comparison (live cluster vs kernel
  replay, calibrated and uncalibrated).
- :func:`burst_drain`: every write packed into one instant, then an idle
  drain — the shape that stresses round bucketing hardest (all events in
  one ``round_ms`` window; the zero-duration trace case
  ``schedule_from_trace`` must bucket into a valid 1-round schedule).
- :func:`dcn_partition`: the DCN-scale scenario the 2-D mesh makes
  natural (ROADMAP item 5's widened-chaos clause): a synthetic-WAN
  kernel cluster (geo ring classes → ring-occupancy model), one whole
  region group partitioned then healed. No loopback cluster can realize
  WAN rings, so this scenario is kernel-vs-kernel — calibrated axes vs
  none under the identical partition plan — cross-checked against the
  chaos plane's post-heal invariant suite (``sim.invariants.run_dense``
  must pass the plan standalone, pinning the scenario inside the chaos
  plane's validated envelope).

``full_report`` is the standing lane's measurement
(``scripts/fidelity_smoke.py`` and the ``fidelity`` CI job).

Counterpart of corrosion_tpu/fidelity/scenarios.py.
"""

from __future__ import annotations

import os

import numpy as np

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.fidelity.calibrate import (
    RoundModel,
    from_ring_occupancy,
    trace_fingerprint,
)
from corrosion_tpu_torch.fidelity.compare import compare_live_kernel

# Mixed-mode scenario shapes (CI-feasible; the CLI scales them up).
STEADY_WRITES = 24
STEADY_RATE_HZ = 12.0
BURST_WRITES = 24

# DCN scenario shape — the chaos plane's standard dense scenario shape
# (sim/invariants.py) so the invariant cross-check and the fidelity run
# agree on geography.
DCN_NODES = 48
DCN_REGIONS = 4
DCN_ROUNDS = 64


def steady_arrivals(
    writes: int = STEADY_WRITES, rate_hz: float = STEADY_RATE_HZ,
    writers: int = 3,
) -> list:
    """Open-loop constant-rate grid, round-robin over writers."""
    return [
        (i / rate_hz, i % writers) for i in range(writes)
    ]


def burst_arrivals(writes: int = BURST_WRITES) -> list:
    """Every write scheduled at t=0 on ONE writer (back-to-back commits,
    the same regime the apply-rate calibration train measures), then
    nothing: the drain is pure propagation. A multi-writer burst would
    make every receiver also a bursting writer, so its store writer
    would be busy with its own commits — a contention scenario, not a
    dissemination one."""
    return [(0.0, 0)] * writes


async def steady_load(
    data_dir: str,
    writes: int = STEADY_WRITES,
    rate_hz: float = STEADY_RATE_HZ,
    n_agents: int = 3,
    model: RoundModel | None = None,
    seed: int = 0,
    progress=None,
    device=None,
) -> dict:
    rep = await compare_live_kernel(
        os.path.join(data_dir, "steady"),
        steady_arrivals(writes, rate_hz, writers=n_agents),
        n_agents=n_agents, model=model, seed=seed, progress=progress,
        device=device,
    )
    rep["scenario"] = "steady"
    return rep


async def burst_drain(
    data_dir: str,
    writes: int = BURST_WRITES,
    n_agents: int = 3,
    model: RoundModel | None = None,
    seed: int = 0,
    progress=None,
    device=None,
) -> dict:
    rep = await compare_live_kernel(
        os.path.join(data_dir, "burst"),
        burst_arrivals(writes),
        n_agents=n_agents, model=model, seed=seed, progress=progress,
        device=device,
    )
    rep["scenario"] = "burst"
    return rep


# ---------------------------------------------------------------------------
# DCN-scale partition scenario (kernel-side, invariant-cross-checked).


def wan_ring_model(flush_ms: float = 500.0) -> RoundModel:
    """The synthetic-WAN round model: geo ring classes (the kernel's
    ``region_rtt="geo"`` circle geography at the DCN scenario shape)
    turned into one-hot ring occupancy — members.rs:33 ring semantics as
    a calibration input. The topology is built on the host: only its
    ring classes are read."""
    from corrosion_tpu_torch.fidelity.calibrate import RING_REPR_MS
    from corrosion_tpu_torch.ops import gossip

    topo = gossip.make_topology(
        [DCN_NODES // DCN_REGIONS] * DCN_REGIONS,
        [0], region_rtt="geo", device="cpu",
    )
    rings = topo.region_rtt.numpy()  # [R, R] ring classes 0-5
    occ = np.zeros(
        (DCN_REGIONS, DCN_REGIONS, len(RING_REPR_MS)), np.int64
    )
    for i in range(DCN_REGIONS):
        for j in range(DCN_REGIONS):
            occ[i, j, int(rings[i, j])] = 1
    return from_ring_occupancy(
        occ, flush_ms=flush_ms,
        provenance={
            "source": "geo-ring-occupancy",
            "nodes": DCN_NODES,
            "regions": DCN_REGIONS,
        },
    )


def dcn_partition(
    rounds: int = DCN_ROUNDS, seed: int = 0, progress=None, device=None
) -> dict:
    """Partition one whole region group then heal, with and without the
    WAN ring model's calibrated axes, cross-checked against the chaos
    invariant suite. Returns the scenario report block. The cross-check
    and both runs go on ``device`` (default CUDA; raises when CUDA is
    absent and no device is given)."""
    from corrosion_tpu_torch.models.baselines import _cfg
    from corrosion_tpu_torch.sim import invariants as inv
    from corrosion_tpu_torch.sim.engine import Schedule, simulate
    from corrosion_tpu_torch.sim.faults import Fault, FaultPlan, apply_plan
    from corrosion_tpu_torch.sim.health import recovery_after_heal

    device = resolve_device(device)

    def note(msg):
        if progress is not None:
            progress.write(f"[fidelity dcn] {msg}\n")
            progress.flush()

    model = wan_ring_model()
    plan = FaultPlan(rounds, (
        Fault("partition", rounds // 6, rounds // 2, a=(0,)),
    ), name="dcn-partition-heal")

    # Cross-check: the bare plan must pass the chaos plane's post-heal
    # invariant suite on the standard dense scenario — the calibrated
    # run below then only ADDS the model's ambient-loss axes on top of
    # an envelope the invariant suite has validated.
    note("invariant cross-check (chaos suite, dense)")
    inv_rep = inv.run_dense(plan, seed=seed, device=device)

    writers = list(range(4))
    cfg, topo = _cfg(
        DCN_NODES, writers=writers,
        regions=[DCN_NODES // DCN_REGIONS] * DCN_REGIONS,
        region_rtt="geo", sync_interval=5, n_cells=0, device=device,
    )
    rng = np.random.default_rng(seed)
    w_stop = max(plan.heal_round + 2, rounds // 2)
    writes = np.zeros((rounds, len(writers)), np.uint32)
    writes[:w_stop] = (
        rng.random((w_stop, len(writers))) < 0.25
    ).astype(np.uint32)
    writes[0, :] = 1

    def run(with_model: bool) -> dict:
        sched = Schedule(writes=writes.copy()).make_samples(64)
        sched = apply_plan(sched, plan, DCN_NODES, DCN_REGIONS)
        if with_model:
            sched = model.apply(sched, n_nodes=DCN_NODES)
        final, curves = simulate(cfg, topo, sched, seed=seed, device=device)
        rec = recovery_after_heal(
            curves, plan.heal_round, round_ms=model.round_ms
        )
        vis = final.vis_round.cpu().numpy()
        seen = vis >= 0
        lat = (
            vis.astype(np.float64)
            - sched.sample_round[:, None].astype(np.float64)
        )[seen]
        return {
            "recovered_round": rec["recovered_round"],
            "recovery_rounds": rec["recovery_rounds"],
            "unseen": int((~seen).sum()),
            "vis_p99_rounds": (
                round(float(np.percentile(lat, 99)), 2) if lat.size else None
            ),
            "need_last": float(np.asarray(curves["need"])[-1]),
        }

    note("calibrated run (partition + model axes)")
    cal = run(with_model=True)
    note("uncalibrated run (partition only)")
    uncal = run(with_model=False)
    recovery_delta = (
        None
        if cal["recovery_rounds"] is None or uncal["recovery_rounds"] is None
        else cal["recovery_rounds"] - uncal["recovery_rounds"]
    )
    return {
        "scenario": "dcn",
        "model": model.to_dict(),
        "plan": plan.to_dict(),
        "invariants_ok": bool(inv_rep.ok),
        "invariant_violations": list(inv_rep.violations),
        "calibrated": cal,
        "uncalibrated": uncal,
        # The WAN model injects ambient miss, so calibrated recovery may
        # lag the ideal run — the gate ceilings bound by how much.
        "recovery_delta_rounds": recovery_delta,
        "both_recovered": (
            cal["recovered_round"] is not None
            and uncal["recovered_round"] is not None
        ),
    }


# ---------------------------------------------------------------------------
# The standing lane's measurement.


async def full_report(
    data_dir: str,
    scenario: str = "ci_smoke",
    steady_writes: int = STEADY_WRITES,
    burst_writes: int = BURST_WRITES,
    n_agents: int = 3,
    dcn_rounds: int = DCN_ROUNDS,
    seed: int = 0,
    progress=None,
    device=None,
) -> dict:
    """Run all three standing scenarios and assemble the self-describing
    fidelity report (``fidelity.report.emit_fidelity_report`` asserts
    its provenance). Every kernel run goes on ``device`` (default CUDA;
    raises when CUDA is absent and no device is given)."""
    from corrosion_tpu_torch.fidelity.report import fidelity_context

    device = resolve_device(device)
    steady = await steady_load(
        data_dir, writes=steady_writes, n_agents=n_agents, seed=seed,
        progress=progress, device=device,
    )
    burst = await burst_drain(
        data_dir, writes=burst_writes, n_agents=n_agents, seed=seed,
        progress=progress, device=device,
    )
    dcn = dcn_partition(
        rounds=dcn_rounds, seed=seed, progress=progress, device=device
    )
    # The report-level fingerprint ties the gate to the workloads that
    # produced it (each scenario block carries its own too).
    fp = trace_fingerprint([
        (0, steady["trace_fingerprint"], 0),
        (1, burst["trace_fingerprint"], 1),
    ])
    return {
        **fidelity_context(
            scenario, n_agents, fp,
            steady_writes, burst_writes, dcn_rounds, seed, device=device,
        ),
        "scenarios": {
            "steady": steady,
            "burst": burst,
            "dcn": dcn,
        },
    }

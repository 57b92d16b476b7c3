"""Shared bench harness pieces (counterpart of corrosion_tpu/sim/benchlib.py).

One place owns the plane-attribution composite (the cumulative-prefix
stage timing), the provenance block every bench report carries, the
emit-site rounding, the multi-device lane and the budget-gate arithmetic,
so a bench and its gate can never drift onto different measurement paths.

Where the port differs from the reference:

- ``bench_context`` takes the device the numbers were measured on:
  ``platform`` is ``"gpu"`` on a CUDA device (the JAX platform name of the
  same card) and ``"cpu"`` on the CPU.
- The multi-device lane runs the port's shard driver on a mesh of
  ``torch.device`` positions, one controller driving every position
  (``parallel/__init__.py``); on one card every position shares it, so its
  step times claim no speed-up.
- There is no compilation: a report's ``kernels`` field says whether the
  CUDA kernels (``"cuda"``) or their plain PyTorch versions (``"plain"``)
  ran.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.parallel.mesh import multichip_mesh  # noqa: F401

# Execution order of the composite's stages: mirrors cluster_round.
PLANE_STAGES = ("broadcast", "swim", "sync", "track")
# Gate tolerance applied when a budget file omits the key.
DEFAULT_TOLERANCE = 1.5


def get_path(measured: dict, dotted: str):
    """Dotted-path lookup into a nested measurement dict (None when any
    segment is missing)."""
    cur = measured
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def config_fingerprint(*parts) -> str:
    """Stable short hash of the measured configuration: sha256 over the
    parts' reprs (dataclass and NamedTuple reprs list every field in
    declaration order), so two runs fingerprint equal iff every config
    field and shape parameter matches."""
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _platform(device) -> str:
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def bench_context(*fingerprint_parts, device) -> dict:
    """The provenance block every bench report carries (and
    ``telemetry.check_bench_invariants`` asserts): the platform the
    numbers were measured on (``"gpu"`` for a CUDA ``device``, ``"cpu"``
    for the CPU), the device count, and the config fingerprint."""
    device = torch.device(device)
    return {
        "platform": _platform(device),
        "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
        "config_fingerprint": config_fingerprint(*fingerprint_parts),
    }


def rounded_step_report(step_ms: float, plane: dict) -> dict:
    """Round step and planes to 0.1 ms and derive the residual from the
    ROUNDED values, so ``sum(plane_ms) + residual_ms == step_ms`` holds
    exactly on the published numbers."""
    step_r = round(step_ms, 1)
    plane_r = {k: round(v, 1) for k, v in plane.items()}
    return {
        "step_ms": step_r,
        "plane_ms": plane_r,
        "residual_ms": round(step_r - sum(plane_r.values()), 1),
    }


def roofline_report(stage_costs: dict, plane_ms: dict) -> dict:
    """Join the cost model's per-stage flops and bytes
    (``obs.costs.roofline_stage_costs``) with the measured, emit-rounded
    ``plane_ms``: achieved FLOP/s, B/s and arithmetic intensity per plane,
    derived from the emitted numbers (a plane at 0.0 ms publishes null
    rates)."""
    out = {}
    for name, ms in plane_ms.items():
        cost = stage_costs.get(name, {"flops": 0.0, "bytes": 0.0})
        flops = float(cost["flops"])
        nbytes = float(cost["bytes"])
        out[name] = {
            "flops": flops,
            "bytes": nbytes,
            "flops_per_s": (flops / (ms / 1000.0)) if ms else None,
            "bytes_per_s": (nbytes / (ms / 1000.0)) if ms else None,
            "intensity": round(flops / nbytes, 4) if nbytes else None,
        }
    return out


def compile_split_report(first_run_s: float, compile_ms: float) -> dict:
    """The ledger's split of the first run, from the ROUNDED values so
    ``compile_ms + first_step_ms == first_run_incl_compile_s * 1000``
    holds exactly on the published numbers. In the port ``compile_ms`` is
    the kernel library's build and load (``obs.ledger``)."""
    first_run_r = round(first_run_s, 1)
    compile_r = round(min(compile_ms, first_run_r * 1000.0), 1)
    return {
        "first_run_incl_compile_s": first_run_r,
        "compile_ms": compile_r,
        "first_step_ms": round(first_run_r * 1000.0 - compile_r, 1),
    }


def plane_composite(cfg, topo, sched, final, bcast_fn=None):
    """The cumulative-prefix attribution inputs for a finished run:
    ``(make_step, stages, carry0)`` for ``telemetry.attribute_planes``. A
    composite round step over the run's FINAL state (fresh state would
    flatter sync: no deficits to score or grant) whose stages enable one
    at a time in execution order; ``make_step(enabled)(carry, i)`` takes
    the round index ``i``.

    Each step draws its keys as the reference's does (``PRNGKey(0)``,
    ``fold_in(i)``, ``split(3)``) through ``rng``, so every prefix's
    carry equals the reference's bit for bit. ``bcast_fn`` swaps the
    broadcast stage's driver (``parallel.make_sharded_broadcast(mesh)``,
    with ``final`` whole on the mesh's home)."""
    from corrosion_tpu_torch.ops import gossip as gossip_ops
    from corrosion_tpu_torch.ops import swim as swim_ops

    if bcast_fn is None:
        bcast_fn = gossip_ops.broadcast_round
    swim_impl = swim_ops.impl(cfg.swim)
    device = final.data.contig.device
    n_regions = int(topo.region.max()) + 1
    part = torch.zeros((n_regions, n_regions), dtype=torch.bool, device=device)

    def dev(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)

    writes = dev(sched.writes[0])
    key = rng_mod.PRNGKey(0, device)
    s_writer, s_ver, s_round = dev(sched.sample_writer), dev(sched.sample_ver), dev(sched.sample_round)

    def composite(enabled):
        def step(carry, i):
            d, sw, vr = carry
            r = torch.tensor(int(i), dtype=torch.int64, device=device)
            ks = rng_mod.split(rng_mod.fold_in(key, int(i)), 3)
            k_b, k_sw, k_sy = ks[0], ks[1], ks[2]
            if "broadcast" in enabled:
                d, _ = bcast_fn(d, topo, sw.alive, part, writes, k_b, cfg.gossip)
            if "swim" in enabled:
                sw = swim_impl.swim_round(sw, k_sw, r, cfg.swim)
            if "sync" in enabled:
                d, _ = gossip_ops.sync_round(d, topo, sw.alive, part, r, k_sy, cfg.gossip)
            if "track" in enabled:
                vis_now = gossip_ops.visibility(d, s_writer, s_ver)
                active = r >= s_round
                vr = torch.where((vr < 0) & vis_now & active[:, None], r, vr)
                need = gossip_ops.total_need(d)
                vr = vr + (need * 0).to(vr.dtype)
            return d, sw, vr

        return step

    carry0 = (final.data, final.swim, final.vis_round)
    return composite, PLANE_STAGES, carry0


# The multi-device lane's fixed shape: big enough that the broadcast queue
# exchange moves real bytes.
MULTICHIP_DEVICE_COUNTS = (1, 2, 4, 8)
MULTICHIP_NODES = 512
MULTICHIP_ROUNDS = 32
MULTICHIP_SPARSE_NODES = 256
MULTICHIP_SEED = 0
# The O(N/D) bound on the placement at rest: the largest position's state
# bytes at D=8 at most this fraction of the D=1 state (1/8 split plus the
# replicated writer heads and slot metadata).
MULTICHIP_STATE_FRACTION = 1.0 / 6.0


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_multichip(
    device_counts=MULTICHIP_DEVICE_COUNTS,
    large_nodes: int | None = None,
    large_rounds: int = 96,
    progress=None,
    device=None,
) -> dict:
    """The multi-device lane: the dense and sparse planes under the shard
    driver at every requested position count D, on meshes of positions on
    ``device`` (default: the visible cards in turn).

    Per D: the warm per-round ``step_ms`` of both planes (the second of two
    runs, until the card has finished; the host's enqueue is inside). At
    max(D) also: the cumulative-prefix plane split measured on the sharded
    step (``plane_composite`` with the sharded broadcast) with its roofline
    block, the queue exchange's bytes a round (equal to ``traffic_model``,
    or the lane raises), the largest position's state bytes at rest
    against the D=1 state (O(N/D)), and dense convergence. Final states
    and curves (but the exchange's byte keys) must be equal across every D,
    or the lane raises.

    ``large_nodes`` appends a dense convergence run at that node count on
    the max-D mesh, under ``large``. Returns the report (the caller passes
    it through ``telemetry.check_bench_invariants``)."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.obs import costs as costs_mod
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import telemetry

    def note(msg):
        if progress is not None:
            progress.write(f"[multichip] {msg}\n")
            progress.flush()

    def timed(fn):
        fn()
        _synchronize(home)
        t0 = time.perf_counter()
        out = fn()
        _synchronize(home)
        return out, (time.perf_counter() - t0) / MULTICHIP_ROUNDS * 1000.0

    cfg, topo, sched = baselines.merge_10k(
        n=MULTICHIP_NODES, rounds=MULTICHIP_ROUNDS, samples=64, device=device
    )
    s_cfg, s_topo, s_sched = baselines.anywrite_sparse(
        n=MULTICHIP_SPARSE_NODES, w_hot=16, rounds=MULTICHIP_ROUNDS, n_regions=4,
        epoch_rounds=8, cohort=10, burst_writes=2, samples=16, k_dev=8, device=device,
    )
    dmax = max(device_counts)
    report: dict = {}
    ref_contig = ref_curves = s_ref = None
    state_mib: dict = {}
    home = None
    for d in sorted(device_counts):
        mesh = multichip_mesh(d, device=device)
        home = mesh.home
        note(f"D={d}: dense")
        (final, curves), step_ms = timed(
            lambda: parallel.simulate_sharded(cfg, topo, sched, mesh, seed=MULTICHIP_SEED)
        )
        contig = mesh_mod.to_host(final.data.contig).numpy()
        if ref_contig is None:
            ref_contig, ref_curves = contig, curves
        else:
            if not np.array_equal(contig, ref_contig):
                raise AssertionError(f"dense final state diverged at D={d}")
            for k in ref_curves:
                if not k.startswith("xshard") and not np.array_equal(ref_curves[k], curves[k]):
                    raise AssertionError(f"dense curve {k} diverged at D={d}")
        state_mib[d] = max(parallel.per_device_state_bytes(final).values()) / 2**20
        note(f"D={d}: sparse")
        s_final, s_step_ms = timed(
            lambda: parallel.simulate_sparse_sharded(s_cfg, s_topo, s_sched, mesh, seed=MULTICHIP_SEED)
        )
        s_contig = mesh_mod.to_host(s_final[0].data.contig).numpy()
        if s_ref is None:
            s_ref = s_contig
        elif not np.array_equal(s_contig, s_ref):
            raise AssertionError(f"sparse final state diverged at D={d}")
        sfx = "" if d == dmax else f"_d{d}"
        if d == dmax:
            # The plane split measured on the sharded step: the composite's
            # broadcast stage is the shard driver with its queue exchange.
            note(f"D={d}: plane attribution")
            composite, stages, carry0 = plane_composite(
                cfg, topo, sched, mesh_mod.assemble(final, home),
                bcast_fn=parallel.make_sharded_broadcast(mesh),
            )
            attr = telemetry.attribute_planes(composite, stages, carry0, iters=10)
            plane, _ = attr.scale(step_ms)
            report.update(rounded_step_report(step_ms, plane))
            report["roofline"] = roofline_report(
                costs_mod.roofline_stage_costs(composite, stages, carry0), report["plane_ms"],
            )
            tm = parallel.traffic_model(cfg.gossip, mesh)
            got_ici = float(curves["xshard_bytes_ici"][0])
            got_dcn = float(curves["xshard_bytes_dcn"][0])
            if (got_ici, got_dcn) != (tm["xshard_bytes_ici"], tm["xshard_bytes_dcn"]):
                raise AssertionError(
                    f"measured cross-shard bytes ({got_ici}, {got_dcn}) != static traffic "
                    f"model ({tm['xshard_bytes_ici']}, {tm['xshard_bytes_dcn']})"
                )
            heads = mesh_mod.to_host(final.data.head).numpy()
            report.update({
                "xshard_bytes_per_round_ici": got_ici,
                "xshard_bytes_per_round_dcn": got_dcn,
                "traffic_model": tm["detail"],
                "converged": bool((contig == heads[None, :]).all()),
            })
        else:
            report[f"step_ms{sfx}"] = round(step_ms, 1)
        report[f"step_ms_sparse{sfx or '_d' + str(d)}"] = round(s_step_ms, 1)
    frac = state_mib[dmax] / state_mib[min(device_counts)]
    report.update({
        **bench_context(
            cfg, s_cfg, MULTICHIP_NODES, MULTICHIP_ROUNDS, MULTICHIP_SEED,
            tuple(sorted(device_counts)), device=home,
        ),
        "kernels": "cuda" if home.type == "cuda" else "plain",
        "metric": "multichip_step_scaling",
        "nodes": MULTICHIP_NODES,
        "sparse_nodes": MULTICHIP_SPARSE_NODES,
        "rounds": MULTICHIP_ROUNDS,
        "seed": MULTICHIP_SEED,
        "device_counts": sorted(device_counts),
        "device_count": dmax,
        "state_mib_per_device": {f"d{d}": round(v, 3) for d, v in state_mib.items()},
        "state_fraction_dmax": round(frac, 4),
        "bit_identical_across_device_counts": True,
    })
    if len(device_counts) > 1 and frac > MULTICHIP_STATE_FRACTION:
        raise AssertionError(
            f"per-position state at D={dmax} holds {frac:.3f} of the D={min(device_counts)} "
            f"state bytes; O(N/D) placement requires <= {MULTICHIP_STATE_FRACTION:.3f}"
        )
    if large_nodes:
        note(f"large: {large_nodes} nodes on D={dmax}")
        report["large"] = _measure_large(
            large_nodes, large_rounds, multichip_mesh(dmax, device=device), note
        )
    return report


def _measure_large(n_nodes: int, rounds: int, mesh, note) -> dict:
    """The largest sharded run's tail: a dense convergence run at
    ``n_nodes`` on the lane's max mesh, light early writes then drain,
    queue depth 16. ``step_ms_incl_compile`` keeps the reference's name:
    in the port it is the first run's wall a round (no compilation; the
    kernel library's load when it happens there)."""
    from dataclasses import replace as dc_replace

    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.parallel import mesh as mesh_mod

    cfg, topo, sched = baselines.wan_100k(
        n=n_nodes, n_regions=8, n_writers=min(128, n_nodes // 4), rounds=rounds, samples=16,
        partition=False, device=mesh.home,
    )
    cfg = dc_replace(cfg, gossip=dc_replace(cfg.gossip, queue=16))
    sched.writes[:, :] = 0
    sched.writes[:6, :] = 1
    sched = sched.make_samples(16)
    t0 = time.perf_counter()
    final, curves = parallel.simulate_sharded(cfg, topo, sched, mesh, seed=MULTICHIP_SEED)
    _synchronize(mesh.home)
    wall = time.perf_counter() - t0
    contig = mesh_mod.to_host(final.data.contig).numpy()
    heads = mesh_mod.to_host(final.data.head).numpy()
    per_dev = parallel.per_device_state_bytes(final)
    note(f"large: {wall:.0f}s wall, need={int(curves['need'][-1])}")
    return {
        "nodes": n_nodes,
        "rounds": rounds,
        "step_ms_incl_compile": round(wall / rounds * 1000.0, 1),
        "converged": bool((contig == heads[None, :]).all()),
        "need_last": int(curves["need"][-1]),
        "state_mib_per_device_max": round(max(per_dev.values()) / 2**20, 2),
        "xshard_bytes_per_round_ici": float(curves["xshard_bytes_ici"][0]),
        "xshard_bytes_per_round_dcn": float(curves["xshard_bytes_dcn"][0]),
    }


def check_budget(measured: dict, budget: dict) -> tuple[bool, list[str]]:
    """Gate a measured ``{step_ms, plane_ms: {...}}`` report against a
    budget (``bench_budget.json``'s form): a key breaches when ``measured >
    budget_ms * tolerance``; a budget key missing from the measurement is a
    breach, and so is a measurement taken at other ``nodes``/``rounds``/
    ``platform``/``kernels``/``device_count`` than the budget's. Returns
    ``(ok, breaches)``, one line per breach."""
    tol = float(budget.get("tolerance", DEFAULT_TOLERANCE))
    breaches: list[str] = []
    for dim in ("nodes", "rounds", "platform", "kernels", "device_count"):
        if dim in budget and measured.get(dim) != budget[dim]:
            breaches.append(
                f"{dim}: measured at {measured.get(dim)} but the budget "
                f"was refreshed at {budget[dim]} — rerun with --update"
            )

    def gate(name: str, got, limit) -> None:
        if got is None:
            breaches.append(f"{name}: missing from measurement")
        elif float(got) > float(limit) * tol:
            breaches.append(
                f"{name}: {float(got):.1f} ms > budget {float(limit):.1f} ms x{tol}"
            )

    gate("step_ms", measured.get("step_ms"), budget["step_ms"])
    for plane, limit in budget.get("plane_ms", {}).items():
        gate(f"plane_ms.{plane}", measured.get("plane_ms", {}).get(plane), limit)
    return not breaches, breaches

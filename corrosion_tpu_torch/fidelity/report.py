"""Fidelity-plane report emit path + the ``fidelity`` budget gate.

Every divergence report funnels through the ONE self-describing emit
path (``telemetry.check_bench_invariants``, the PR 6 rule): platform,
nodes, device_count, config fingerprint — plus ``scenario`` and
``trace_fingerprint`` for this report class — are asserted at the emit
site, so a fidelity verdict can no more be published without saying
which workload produced it than a kernel bench can be published without
its platform.

``check_fidelity_budget`` mirrors the serving gate's shape for the
fidelity surface: dimension mismatches (platform / scenario) are
breaches, divergence ceilings get the budget's tolerance multiplier, and
two checks are absolute — the **calibrated-beats-uncalibrated CDF
ordering** (the subsystem's reason to exist; a tolerance-scaled version
would gate nothing) and the DCN scenario's **chaos-invariant
cross-check**.

Counterpart of corrosion_tpu/fidelity/report.py.
"""

from __future__ import annotations

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.sim import benchlib, telemetry

# Dimensions that must match the budget exactly.
FIDELITY_DIMS = ("platform", "scenario")

# Provenance this report class requires beyond the base four.
FIDELITY_PROVENANCE = ("scenario", "trace_fingerprint")


def emit_fidelity_report(report: dict) -> dict:
    """The fidelity plane's emit site: assert self-description (base
    provenance + scenario + trace fingerprint) and return the report
    unchanged."""
    return telemetry.check_bench_invariants(
        report, extra_provenance=FIDELITY_PROVENANCE
    )


def fidelity_context(
    scenario: str, nodes: int, trace_fp: str, *fingerprint_parts, device=None
) -> dict:
    """Provenance block for a fidelity report: ``nodes`` is the live
    agent cluster size, ``trace_fingerprint`` ties the verdict to the
    recorded workload, the rest comes from the shared benchlib context
    (platform, device_count, config fingerprint). ``device`` is the one
    the report's kernel replays ran on (default CUDA; raises when CUDA is
    absent and no device is given)."""
    return {
        **benchlib.bench_context(
            scenario, nodes, *fingerprint_parts, device=resolve_device(device)
        ),
        "scenario": scenario,
        "nodes": nodes,
        "trace_fingerprint": trace_fp,
    }


_get = benchlib.get_path


def check_fidelity_budget(
    measured: dict, budget: dict
) -> tuple[bool, list[str]]:
    """Gate a fidelity report against the ``fidelity`` entry of
    bench_budget.json. Returns ``(ok, breaches)``.

    Budget keys:

    - ``tolerance``: multiplier on every ``ceilings`` value.
    - dimension keys (``FIDELITY_DIMS``): must equal the measurement.
    - ``ceilings``: dotted-path -> max value (e.g.
      ``"scenarios.steady.calibrated.cdf_distance"``); a missing
      measurement is a breach (a silently vanished scenario is how
      regressions hide).
    - ``require_calibrated_closer`` (default True): on every mixed-mode
      scenario block, the calibrated replay's CDF distance must be
      STRICTLY below the uncalibrated one's — never tolerance-scaled.
    - ``require_invariants_ok`` (default True): every scenario block
      carrying an ``invariants_ok`` fact (the DCN cross-check) must
      report it true — never tolerance-scaled.
    - ``unseen_max`` (default 0): total never-became-visible pairs
      across live runs and calibrated replays (non-convergence is a
      correctness question, not a tolerance one).
    """
    tol = float(budget.get("tolerance", benchlib.DEFAULT_TOLERANCE))
    breaches: list[str] = []
    for dim in FIDELITY_DIMS:
        if dim in budget and measured.get(dim) != budget[dim]:
            breaches.append(
                f"{dim}: measured at {measured.get(dim)!r} but the budget "
                f"was refreshed at {budget[dim]!r} — rerun with --update"
            )
    for path, limit in budget.get("ceilings", {}).items():
        got = _get(measured, path)
        if got is None:
            breaches.append(f"{path}: missing from measurement")
        elif float(got) > float(limit) * tol:
            breaches.append(
                f"{path}: {float(got):.4f} > budget {float(limit):.4f} "
                f"x{tol:g}"
            )
    scen = measured.get("scenarios", {})
    if budget.get("require_calibrated_closer", True):
        for name, block in sorted(scen.items()):
            if "calibrated_closer" not in block:
                continue  # kernel-vs-kernel scenarios have no live CDF
            if not block["calibrated_closer"]:
                cal = _get(block, "calibrated.cdf_distance")
                unc = _get(block, "uncalibrated.cdf_distance")
                breaches.append(
                    f"scenarios.{name}: calibrated replay is NOT strictly "
                    f"closer to the live CDF ({cal} vs uncalibrated {unc}) "
                    f"— the round-length calibration buys nothing here"
                )
    if budget.get("require_invariants_ok", True):
        for name, block in sorted(scen.items()):
            if "invariants_ok" in block and not block["invariants_ok"]:
                breaches.append(
                    f"scenarios.{name}: chaos invariant cross-check failed: "
                    f"{block.get('invariant_violations')}"
                )
    unseen_max = int(budget.get("unseen_max", 0))
    unseen = sum(
        int(v)
        for name, block in scen.items()
        for v in (
            _get(block, "live.unseen"),
            _get(block, "calibrated.unseen"),
        )
        if v is not None
    )
    if unseen > unseen_max:
        breaches.append(
            f"unseen pairs: {unseen} > {unseen_max} — some writes never "
            f"became visible (live or calibrated replay did not converge)"
        )
    return not breaches, breaches

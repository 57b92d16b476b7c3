"""Serving-plane report emit path + the ``serving`` budget gate.

Every loadgen report funnels through the ONE self-describing emit path
(``telemetry.check_bench_invariants``, the PR 6 rule): platform, nodes,
device_count, config fingerprint — plus ``scenario`` for this report
class — are asserted at the emit site, so a load report can no more be
published without provenance than a kernel bench can.

``check_serving_budget`` mirrors ``benchlib.check_budget``'s shape for
the serving surface: dimension mismatches (platform / scenario /
subscription count) are breaches so a shrunk smoke config can't silently
loosen the gate, latency ceilings get the budget's tolerance multiplier,
and two keys are absolute: ``oracle_violations`` must be 0 (correctness
is never a tolerance question) and the sweep's ``shed_engaged`` must be
True (a sweep that never tripped admission control did not test it).

Counterpart of corrosion_tpu/loadgen/report.py.
"""

from __future__ import annotations

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.sim import benchlib, telemetry

# Dimensions that must match the budget exactly (cf. benchlib gate dims).
SERVING_DIMS = ("platform", "scenario", "subs")


def emit_serving_report(report: dict) -> dict:
    """The serving plane's emit site: assert self-description (base
    provenance + ``scenario``) and return the report unchanged."""
    return telemetry.check_bench_invariants(
        report, extra_provenance=("scenario",)
    )


def serving_context(
    scenario: str, nodes: int, *fingerprint_parts, device=None
) -> dict:
    """Provenance block for a serving report: ``nodes`` is the agent
    cluster size (the serving plane's scale axis), the rest comes from
    the shared benchlib context (platform, device_count, fingerprint).
    ``device`` is the one the report's kernel sections ran on (default
    CUDA; raises when CUDA is absent and no device is given)."""
    return {
        **benchlib.bench_context(
            scenario, nodes, *fingerprint_parts, device=resolve_device(device)
        ),
        "scenario": scenario,
        "nodes": nodes,
    }


_get = benchlib.get_path


def check_serving_budget(
    measured: dict, budget: dict
) -> tuple[bool, list[str]]:
    """Gate a serving report against the ``serving`` entry of
    bench_budget.json. Returns ``(ok, breaches)``.

    Budget keys:

    - ``tolerance``: multiplier on every ``*_ms`` ceiling.
    - dimension keys (``SERVING_DIMS``): must equal the measurement.
    - ``ceilings_ms``: dotted-path -> max milliseconds (e.g.
      ``"run.oracle.fanout_lag_ms.p99"``); a missing measurement is a
      breach (a silently vanished surface is how regressions hide).
    - ``oracle_violations_max`` (default 0): total oracle violations
      across scenarios, NOT tolerance-scaled.
    - ``require_shed_engaged`` (default True): the sweep must report
      ``shed_engaged`` true.
    """
    tol = float(budget.get("tolerance", benchlib.DEFAULT_TOLERANCE))
    breaches: list[str] = []
    for dim in SERVING_DIMS:
        if dim in budget and measured.get(dim) != budget[dim]:
            breaches.append(
                f"{dim}: measured at {measured.get(dim)!r} but the budget "
                f"was refreshed at {budget[dim]!r} — rerun with --update"
            )
    for path, limit in budget.get("ceilings_ms", {}).items():
        got = _get(measured, path)
        if got is None:
            breaches.append(f"{path}: missing from measurement")
        elif float(got) > float(limit) * tol:
            breaches.append(
                f"{path}: {float(got):.1f} ms > budget "
                f"{float(limit):.1f} ms x{tol}"
            )
    viol_max = int(budget.get("oracle_violations_max", 0))
    total_viol = sum(
        int(v)
        for v in (
            _get(measured, "run.oracle.violations"),
            _get(measured, "sweep.oracle.violations"),
        )
        if v is not None
    )
    if total_viol > viol_max:
        breaches.append(
            f"oracle violations: {total_viol} > {viol_max} — exactly-once "
            f"delivery or change-id monotonicity broke under load"
        )
    if budget.get("require_shed_engaged", True):
        if not _get(measured, "sweep.shed_engaged"):
            breaches.append(
                "sweep.shed_engaged: false — the ramp never tripped "
                "admission control, so the 503 fast-fail promise went "
                "untested"
            )
    return not breaches, breaches

"""Host-chaos report emit path + the ``hostchaos`` budget gate.

Same contract as the serving plane's (loadgen/report.py): every report
funnels through ``telemetry.check_bench_invariants`` with ``scenario``
provenance, and :func:`check_hostchaos_budget` gates the CI smoke
against the ``hostchaos`` entry of bench_budget.json. Two classes of
key are NEVER tolerance-scaled:

- ``oracle_violations_max`` (default 0): exactly-once delivery and
  change-id monotonicity under chaos are correctness, not performance;
- ``require_machinery_fired`` / ``require_converged``: a scenario whose
  forced defenses stayed idle, or that ended unconverged/with
  bookkeeping gaps, is a failed experiment regardless of how fast it
  ran.

Drain/convergence wall-time ceilings are tolerance-scaled like every
other latency surface.

Counterpart of corrosion_tpu/hostchaos/report.py.
"""

from __future__ import annotations

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.sim import benchlib, telemetry

HOSTCHAOS_DIMS = ("platform", "scenario")


def emit_hostchaos_report(report: dict) -> dict:
    """The host-chaos emit site: assert self-description (base
    provenance + ``scenario``) and return the report unchanged."""
    return telemetry.check_bench_invariants(
        report, extra_provenance=("scenario",)
    )


def hostchaos_context(nodes: int, *fingerprint_parts, device=None) -> dict:
    """Provenance block for a host-chaos report. ``device`` names the
    platform the report is filed under (default CUDA; raises when CUDA is
    absent and no device is given)."""
    return {
        **benchlib.bench_context(
            "host_chaos_smoke", nodes, *fingerprint_parts,
            device=resolve_device(device),
        ),
        "scenario": "host_chaos_smoke",
        "nodes": nodes,
    }


_get = benchlib.get_path


def check_hostchaos_budget(
    measured: dict, budget: dict
) -> tuple[bool, list[str]]:
    """Gate a host-chaos smoke report against the ``hostchaos`` budget
    entry. Returns ``(ok, breaches)``."""
    tol = float(budget.get("tolerance", benchlib.DEFAULT_TOLERANCE))
    breaches: list[str] = []
    for dim in HOSTCHAOS_DIMS:
        if dim in budget and measured.get(dim) != budget[dim]:
            breaches.append(
                f"{dim}: measured at {measured.get(dim)!r} but the budget "
                f"was refreshed at {budget[dim]!r} — rerun with --update"
            )
    scenarios = budget.get("scenarios", [])
    blocks = measured.get("scenarios", {})
    missing = [s for s in scenarios if s not in blocks]
    if missing:
        breaches.append(
            f"scenarios missing from measurement: {missing} — a silently "
            f"vanished scenario is how regressions hide"
        )
    for path, limit in budget.get("ceilings_s", {}).items():
        got = _get(measured, path)
        if got is None:
            breaches.append(f"{path}: missing from measurement")
        elif float(got) > float(limit) * tol:
            breaches.append(
                f"{path}: {float(got):.1f} s > budget "
                f"{float(limit):.1f} s x{tol}"
            )
    viol_max = int(budget.get("oracle_violations_max", 0))
    total_viol = sum(
        int(_get(blk, "oracle.violations") or 0) for blk in blocks.values()
    )
    if total_viol > viol_max:
        breaches.append(
            f"oracle violations: {total_viol} > {viol_max} — exactly-once "
            f"delivery or change-id monotonicity broke under chaos"
        )
    if budget.get("require_machinery_fired", True):
        for name, blk in blocks.items():
            if not blk.get("machinery_ok", False):
                breaches.append(
                    f"{name}: required machinery never fired "
                    f"(required={blk.get('machinery_required')}, "
                    f"counters={blk.get('machinery')}) — the scenario "
                    f"did not actually stress its defenses"
                )
    if budget.get("require_converged", True):
        for name, blk in blocks.items():
            if not (
                blk.get("converged")
                and blk.get("bookkeeping_contiguous")
                and blk.get("ok")
            ):
                breaches.append(
                    f"{name}: post-heal invariants failed: "
                    f"{blk.get('failures')}"
                )
    return not breaches, breaches

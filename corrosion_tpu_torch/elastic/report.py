"""Elastic-plane artifacts and the budget gate (counterpart of
corrosion_tpu/elastic/report.py).

Scenario reports (``elastic/scenarios.py``) carry ``corro-elastic/1``.
``check_elastic_budget`` gates a batch of them against the ``elastic``
entry of ``bench_budget.json``: wall ceilings scale with the budget's
tolerance, the survival invariants never do — bit-identity, the byte
reconcile, zero oracle violations and the machinery-fired rule are pass
or fail at any tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

# Per-round wire-volume keys legitimately differ across meshes; every
# cross-mesh curve compare skips them, same-mesh compares keep them.
from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS  # noqa: F401

ELASTIC_SCHEMA = "corro-elastic/1"


def _host(leaf) -> np.ndarray:
    from corrosion_tpu_torch.parallel.mesh import Placed

    if isinstance(leaf, Placed):
        leaf = leaf.whole("cpu")
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def diff_trees(a, b, label: str = "") -> list:
    """Leaf-by-leaf bit-exact comparison of two state trees (placed, on a
    device or on the host; NaN != NaN). Returns mismatch strings, empty
    when identical. Paths are the checkpoint's keystr paths."""
    from corrosion_tpu_torch.sim.checkpoint import _flatten

    fa, fb = _flatten(a), _flatten(b)
    if len(fa) != len(fb):
        return [f"{label}: structure differs ({len(fa)} vs {len(fb)} leaves)"]
    out = []
    for (pa, la, _), (_pb, lb, _) in zip(fa, fb):
        xa, xb = _host(la), _host(lb)
        where = f"{label}{pa or '<root>'}"
        if xa.shape != xb.shape or xa.dtype != xb.dtype:
            out.append(f"{where}: {xa.dtype}{xa.shape} vs {xb.dtype}{xb.shape}")
        elif not np.array_equal(xa, xb):
            out.append(f"{where}: {int(np.sum(xa != xb))}/{xa.size} elements differ")
    return out


def slice_curves(curves: dict, start: int, stop: int | None = None) -> dict:
    """Round-window view of a per-round curve dict."""
    return {k: np.asarray(v)[start:stop] for k, v in curves.items()}


def diff_curves(a: dict, b: dict, skip: tuple = ()) -> list:
    """Bit-exact comparison of two per-round curve dicts; ``skip`` names
    keys excused from it (``XSHARD_CURVE_KEYS`` when the two sides ran on
    different meshes)."""
    out = []
    for k in sorted(set(a) | set(b)):
        if k in skip:
            continue
        if k not in a or k not in b:
            out.append(f"curve {k}: present on one side only")
            continue
        xa, xb = np.asarray(a[k]), np.asarray(b[k])
        if xa.shape != xb.shape:
            out.append(f"curve {k}: shape {xa.shape} vs {xb.shape}")
        elif not np.array_equal(xa, xb):
            first = int(np.flatnonzero(
                np.any((xa != xb).reshape(xa.shape[0], -1), axis=1)
            )[0])
            out.append(f"curve {k}: diverges at round {first}")
    return out


def wall_total(scenario: dict) -> float:
    return float(sum((scenario.get("wall_s") or {}).values()))


def check_elastic_budget(report: dict, budget: dict) -> dict:
    """Gate a batch report (``{"scenarios": [...]}``) against the
    ``elastic`` budget entry. Scaled by ``tolerance``: the per-scenario
    wall ceilings. Never scaled: ``require_bit_identical``,
    ``require_reconcile``, ``require_machinery_fired``,
    ``oracle_violations_max``. A scenario the budget names but the report
    lacks is a breach."""
    tol = float(budget.get("tolerance", 1.0))
    breaches: list = []
    checks: list = []
    by_name = {s.get("scenario"): s for s in report.get("scenarios", [])}
    for name, sb in (budget.get("scenarios") or {}).items():
        s = by_name.get(name)
        if s is None:
            breaches.append(f"{name}: scenario missing from report")
            continue
        if budget.get("require_bit_identical", 1) and not s.get("bit_identical", False):
            breaches.append(
                f"{name}: NOT bit-identical to the uninterrupted run "
                f"({len(s.get('mismatches', []))} mismatches)"
            )
        if budget.get("require_reconcile", 1) and not (
            (s.get("reconcile") or {}).get("ok", False)
        ):
            breaches.append(f"{name}: predicted_per_device_bytes did not reconcile")
        viol = len(s.get("violations") or [])
        if viol > int(budget.get("oracle_violations_max", 0)):
            breaches.append(f"{name}: {viol} oracle violation(s)")
        mach = s.get("machinery")
        if mach is not None and budget.get("require_machinery_fired", 1):
            if not mach.get("fired", False):
                breaches.append(
                    f"{name}: passed with recovery machinery idle — "
                    f"harness failure ({mach})"
                )
        ceiling = sb.get("wall_ceiling_s")
        if ceiling is not None:
            wall = wall_total(s)
            checks.append({"scenario": name, "wall_s": wall, "wall_ceiling_s": ceiling * tol})
            if wall > ceiling * tol:
                breaches.append(
                    f"{name}: wall {wall:.1f}s > ceiling {ceiling * tol:.1f}s "
                    f"(tolerance {tol}x)"
                )
        if not s.get("ok", False):
            breaches.append(f"{name}: scenario reported not ok")
    return {"ok": not breaches, "breaches": breaches, "checks": checks, "tolerance": tol}

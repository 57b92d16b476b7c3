"""Bench trajectory: the committed ``BENCH_r*.json`` /
``MULTICHIP_r*.json`` artifacts read as one provenance-checked series.

Every bench artifact in the repo was captured from a run's output, but until this tool
nothing read them AS A SERIES — which is exactly how the r04→r05
incident survived review: round 5's artifact was a 512-node CPU
fallback published under the 10k-TPU metric name, and only a human
diffing two JSON files could notice. The trajectory report makes that
class mechanical:

- Each artifact is parsed into one row: metric, value, step fields,
  and the provenance the emit sites now assert (platform / nodes /
  kernels / device_count). The earliest artifacts carry no provenance in
  the emitted JSON, so the parser recovers it from the captured
  stderr ``[bench]`` diagnostic line — recovered fields are labeled
  ``provenance: "stderr"``, never silently promoted to first-class.
- Consecutive rows are comparable ONLY when platform, nodes, and
  kernel backend all match; a mismatch is a **comparability break**:
  no delta is computed across it, and the row is flagged
  (``flags: ["platform tpu->cpu", "nodes 10000->512"]`` — the r05
  artifact, mechanically). The same refuse-to-compare rule the budget
  gate applies (``benchlib.check_budget`` shape dims), applied
  backwards over history.
- Multichip artifacts are a separate lane: per round, did the sharded
  dryrun run, at what device count, and did every plane converge.

``corrosion obs trajectory`` renders the report; the JSON form is
``corro-bench-trajectory/1``. Counterpart of corrosion_tpu/obs/trajectory.py;
the artifacts it reads are the reference's, so their platforms are the
reference's too.
"""

from __future__ import annotations

import glob
import json
import os
import re

TRAJECTORY_SCHEMA = "corro-bench-trajectory/1"

#: Provenance dims that must match for two rows to be comparable — the
#: same dims ``benchlib.check_budget`` refuses to gate across.
COMPARABILITY_DIMS = ("platform", "nodes", "kernels")


def _diag_from_tail(tail: str) -> dict:
    """Recover provenance from the captured stderr: the
    ``[bench] {json}`` diagnostic line (r02+) or the prose
    ``[bench] platform=tpu nodes=10000 ...`` form (r01)."""
    out: dict = {}
    for line in tail.splitlines():
        line = line.strip()
        if not line.startswith("[bench]"):
            continue
        body = line[len("[bench]"):].strip()
        if body.startswith("{"):
            try:
                out.update(json.loads(body))
                continue
            except ValueError:
                pass
        for key, cast in (("platform", str), ("nodes", int),
                          ("rounds", int)):
            m = re.search(rf"\b{key}=(\S+)", body)
            if m:
                try:
                    out.setdefault(key, cast(m.group(1)))
                except ValueError:
                    pass
    return out


def parse_bench_artifact(path: str) -> dict:
    """One trajectory row from a captured BENCH_r*.json."""
    with open(path) as f:
        wrapper = json.load(f)
    parsed = wrapper.get("parsed") or {}
    row = {
        "file": os.path.basename(path),
        "round": wrapper.get("n"),
        "rc": wrapper.get("rc"),
        "metric": parsed.get("metric"),
        "value": parsed.get("value"),
        "unit": parsed.get("unit"),
        "step_ms": parsed.get("step_ms"),
        "step_inner_ms": parsed.get("step_inner_ms"),
        "converged": parsed.get("converged"),
        "throughput_changes_per_s": parsed.get("throughput_changes_per_s"),
        "compile_ms": parsed.get("compile_ms"),
    }
    # Self-describing artifacts (the later ones) carry provenance in the emitted
    # JSON; older rounds only in the stderr diagnostics.
    diag = _diag_from_tail(wrapper.get("tail", ""))
    for dim in ("platform", "nodes", "kernels", "device_count"):
        if parsed.get(dim) is not None:
            row[dim] = parsed[dim]
            row.setdefault("provenance", "emitted")
        elif diag.get(dim) is not None:
            row[dim] = diag[dim]
            row["provenance"] = "stderr"
    row.setdefault("provenance", "missing")
    return row


def parse_multichip_artifact(path: str) -> dict:
    """One multichip-lane row from a captured MULTICHIP_r*.json
    (dryrun prose tails in the committed rounds; JSON tails for the
    self-describing era)."""
    with open(path) as f:
        wrapper = json.load(f)
    m = re.search(r"MULTICHIP_r(\d+)", os.path.basename(path))
    row = {
        "file": os.path.basename(path),
        "round": int(m.group(1)) if m else None,
        "rc": wrapper.get("rc"),
        "ok": wrapper.get("ok"),
        "device_count": wrapper.get("n_devices"),
    }
    tail = wrapper.get("tail", "").strip()
    last = tail.splitlines()[-1].strip() if tail else ""
    if last.startswith("{"):
        try:
            parsed = json.loads(last)
            row["converged"] = all(
                p.get("converged") for p in parsed.get("planes", {}).values()
            ) if "planes" in parsed else parsed.get("converged")
            row["nodes"] = parsed.get("nodes")
            row["provenance"] = "emitted"
            return row
        except ValueError:
            pass
    nm = re.search(r"(\d+) nodes", last)
    row["nodes"] = int(nm.group(1)) if nm else None
    row["converged"] = (
        "need=0" in last or "converged=True" in last
    ) if last else None
    row["provenance"] = "stderr" if last else "missing"
    return row


def _compare(prev: dict, row: dict) -> tuple[bool, list[str], list[str]]:
    """Comparability verdict between consecutive rows of one metric.

    A dim breaks comparability only when KNOWN on both sides and
    different — the r05 shape (platform tpu→cpu, nodes 10000→512). A
    dim the era's artifacts never recorded (``kernels`` in the earliest ones)
    is a warning: the comparison is unverifiable on that axis, not
    provably wrong."""
    flags = []
    warnings = []
    for dim in COMPARABILITY_DIMS:
        a, b = prev.get(dim), row.get(dim)
        if a is not None and b is not None and a != b:
            flags.append(f"{dim} {a}->{b}")
        elif a is None or b is None:
            warnings.append(f"{dim} unverifiable (not recorded)")
    if prev.get("metric") != row.get("metric"):
        flags.append(f"metric {prev.get('metric')}->{row.get('metric')}")
    return not flags, flags, warnings


def build_trajectory(root: str = ".") -> dict:
    """Aggregate every committed bench/multichip artifact under
    ``root`` into the ``corro-bench-trajectory/1`` report."""
    bench = sorted(
        glob.glob(os.path.join(root, "BENCH_r*.json")),
        key=lambda p: p,
    )
    multi = sorted(glob.glob(os.path.join(root, "MULTICHIP_r*.json")))
    rows = [parse_bench_artifact(p) for p in bench]
    breaks = []
    prev = None
    for row in rows:
        if prev is None:
            row["comparable_with_prev"] = None
            row["flags"] = []
            row["warnings"] = []
        else:
            ok, flags, warnings = _compare(prev, row)
            row["comparable_with_prev"] = ok
            row["flags"] = flags
            row["warnings"] = warnings
            if ok and isinstance(prev.get("value"), (int, float)) and \
                    isinstance(row.get("value"), (int, float)):
                row["value_delta"] = round(row["value"] - prev["value"], 3)
                if isinstance(prev.get("step_ms"), (int, float)) and \
                        isinstance(row.get("step_ms"), (int, float)):
                    row["step_ms_delta"] = round(
                        row["step_ms"] - prev["step_ms"], 1
                    )
            elif not ok:
                breaks.append({
                    "from": prev["file"],
                    "to": row["file"],
                    "flags": flags,
                })
        prev = row
    mrows = [parse_multichip_artifact(p) for p in multi]
    return {
        "schema": TRAJECTORY_SCHEMA,
        "root": os.path.abspath(root),
        "bench": rows,
        "comparability_breaks": breaks,
        "multichip": mrows,
    }


def render_trajectory(traj: dict) -> str:
    lines = ["bench trajectory:"]
    for r in traj["bench"]:
        mark = (
            "    " if r["comparable_with_prev"] is None
            else " ok " if r["comparable_with_prev"] else "BRK "
        )
        step = f" step_ms={r['step_ms']}" if r.get("step_ms") else ""
        delta = (
            f" (Δ{r['value_delta']:+})" if "value_delta" in r else ""
        )
        lines.append(
            f"  [{mark}] {r['file']}: {r.get('metric')}="
            f"{r.get('value')}{r.get('unit') or ''}{delta}{step} "
            f"platform={r.get('platform')} nodes={r.get('nodes')} "
            f"kernels={r.get('kernels')} [{r.get('provenance')}]"
        )
        for f in r.get("flags", []):
            lines.append(f"         ! not comparable: {f}")
        for w in r.get("warnings", []):
            lines.append(f"         ~ {w}")
    if traj["comparability_breaks"]:
        lines.append(
            f"  {len(traj['comparability_breaks'])} comparability "
            f"break(s) — deltas across them are refused, not computed"
        )
    lines.append("multichip lane:")
    for r in traj["multichip"]:
        lines.append(
            f"  {r['file']}: devices={r.get('device_count')} "
            f"nodes={r.get('nodes')} converged={r.get('converged')} "
            f"ok={r.get('ok')} [{r.get('provenance')}]"
        )
    return "\n".join(lines)

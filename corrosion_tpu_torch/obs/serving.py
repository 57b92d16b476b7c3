"""Serving query-cost plane: the fallback-cliff heatmap + standing gate.

Input: a ``fanout_storm`` run block produced with ``sub_costs=True`` —
its ``sub_costs`` block carries the ``corro-sub-cost/1`` ledger snapshot
(per-subscription counters + the query-plan classifier's record), the
oracle-group -> matcher-sub mapping, and the oracle's delivery records
(per-stream delivered mass + wall/mono-stamped deliveries).

:func:`build_serving_report` joins them into per-subscription
lag-vs-cost attribution:

- **top-K slow subscriptions** by total eval seconds, with their class
  and cost counters;
- **fallback share**: what fraction of all matcher eval seconds the
  fallback-bound population burned — the number ROADMAP item 3's
  incremental matcher must drive down;
- **per-class delivery-lag percentiles** (window / aggregate / join /
  simple), computed per delivery against the commit's monotonic ack;
- **exact mass reconciliation**: each mapped subscription's ledger
  fan-out events (+ replayed rows) must equal the oracle's delivered
  change count for its streams — the ledger cannot under- or
  over-report what the oracle independently observed.

:func:`check_serving_cost_budget` gates the report against the
``serving_cost`` entry of bench_budget.json, including the
machinery-fired rule: a storm where no fallback-bound subscription was
ever observed evaluating is a **test-harness failure** (the gate exists
to measure the cliff; green-with-idle-machinery means the storm never
reached it). :func:`diff_serving_reports` compares a candidate report
against the committed ``SERVING_COST_BASELINE.json``.

Host code only: pure dicts and files, no torch (obs analyzers run on
any host). Counterpart of corrosion_tpu/obs/serving.py.
"""

from __future__ import annotations

import json

LEDGER_KIND = "corro-sub-cost"
LEDGER_VERSION = 1
REPORT_KIND = "corro-serving-cost"
REPORT_VERSION = 1

# Dimensions the budget must match exactly (cf. loadgen/report.py
# SERVING_DIMS): a shrunk smoke config cannot silently loosen the gate.
SERVING_COST_DIMS = ("platform", "scenario", "streams")


def _get(obj, path: str):
    cur = obj
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def write_cost_ledger(path: str, snapshot: dict, context: dict | None = None) -> None:
    """Write a SubsManager.cost_snapshot() as a self-describing
    ``corro-sub-cost/1`` JSONL artifact: one header record, then one
    record per subscription."""
    header = {
        "kind": LEDGER_KIND,
        "version": LEDGER_VERSION,
        "enabled": snapshot.get("enabled", False),
        "subs_total": snapshot.get("subs_total"),
        "totals": snapshot.get("totals", {}),
    }
    if context:
        header["context"] = context
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(header, separators=(",", ":")) + "\n")
        for rec in snapshot.get("subs", ()):
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


def read_cost_ledger(path: str) -> dict:
    """Read a ``corro-sub-cost/1`` artifact back into snapshot shape;
    refuses files of the wrong kind/version."""
    with open(path, encoding="utf-8") as f:
        lines = [ln for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty cost-ledger file")
    header = json.loads(lines[0])
    if header.get("kind") != LEDGER_KIND:
        raise ValueError(
            f"{path}: kind {header.get('kind')!r}, expected {LEDGER_KIND!r}"
        )
    if header.get("version") != LEDGER_VERSION:
        raise ValueError(
            f"{path}: version {header.get('version')!r}, expected "
            f"{LEDGER_VERSION}"
        )
    return {
        "kind": LEDGER_KIND,
        "version": LEDGER_VERSION,
        "enabled": header.get("enabled", False),
        "subs_total": header.get("subs_total"),
        "totals": header.get("totals", {}),
        "subs": [json.loads(ln) for ln in lines[1:]],
    }


def _pct(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def _lag_block(lags_ms: list[float]) -> dict:
    s = sorted(lags_ms)
    return {
        "count": len(s),
        "p50": round(_pct(s, 0.50), 3) if s else None,
        "p90": round(_pct(s, 0.90), 3) if s else None,
        "p99": round(_pct(s, 0.99), 3) if s else None,
        "max": round(s[-1], 3) if s else None,
    }


def build_serving_report(run: dict, top_k: int = 10) -> dict:
    """Join the run's cost ledger with its oracle delivery records into
    the ``corro-serving-cost/1`` attribution report (see module
    docstring). Raises ``ValueError`` when the run carries no
    ``sub_costs`` block — a heatmap without a ledger would silently
    attribute nothing."""
    sc = run.get("sub_costs")
    if not sc or not sc.get("ledger"):
        raise ValueError(
            "run has no sub_costs ledger — rerun the storm with the "
            "query-cost plane armed (loadgen run --sub-costs)"
        )
    ledger = sc["ledger"]
    records = sc.get("oracle_records") or {}
    streams = records.get("streams") or []
    if not streams:
        raise ValueError(
            "run has no oracle stream records — the serving-cost join "
            "needs delivery counts per stream (keep_deliveries)"
        )
    groups_map = {int(g): sid for g, sid in (sc.get("groups") or {}).items()}
    subs_by_id = {rec["sub_id"]: rec for rec in ledger.get("subs", ())}

    # sub_id -> [oracle groups]; every mapped group is one distinct query
    # hence one matcher handle.
    groups_of: dict[str, list[int]] = {}
    for g, sid in groups_map.items():
        groups_of.setdefault(sid, []).append(g)

    # Per-group delivered change mass + per-group delivery lags.
    delivered_by_group: dict[int, int] = {}
    group_of_sid: dict[int, int | None] = {}
    for st in streams:
        group_of_sid[st["sid"]] = st.get("group")
        g = st.get("group")
        if g is not None:
            delivered_by_group[g] = (
                delivered_by_group.get(g, 0) + st.get("delivered_changes", 0)
            )
    ack_by_key_group: dict[tuple, float] = {}
    for w in records.get("writes", ()):
        if w.get("t_ack_mono") is not None:
            ack_by_key_group[(w["key"], w.get("group"))] = w["t_ack_mono"]
    lags_by_group: dict[int, list[float]] = {}
    for d in records.get("deliveries", ()):
        if d.get("kind") != "change" or d.get("t_mono") is None:
            continue
        g = group_of_sid.get(d["sid"])
        if g is None:
            continue
        t_ack = ack_by_key_group.get((d["key"], g))
        if t_ack is None:
            continue
        lags_by_group.setdefault(g, []).append(
            max(0.0, d["t_mono"] - t_ack) * 1000.0
        )

    # Per-subscription rows: cost + class + delivered + lag + exact
    # reconciliation (fan-out enqueued + replayed == oracle delivered).
    per_sub: list[dict] = []
    mismatches: list[str] = []
    classes: dict[str, dict] = {}
    fallback_observed = False
    eval_total = eval_fallback = 0.0
    for rec in ledger.get("subs", ()):
        cost = rec.get("cost") or {}
        plan = rec.get("plan") or {}
        cls = plan.get("class", "unknown")
        eval_s = cost.get("eval_seconds_total", 0.0)
        eval_total += eval_s
        eval_fallback += cost.get("eval_seconds_fallback", 0.0)
        if plan.get("fallback_bound") and cost.get("fallback_evals", 0) > 0:
            fallback_observed = True
        sub_groups = groups_of.get(rec["sub_id"], [])
        delivered = sum(delivered_by_group.get(g, 0) for g in sub_groups)
        lags = sorted(
            lag for g in sub_groups for lag in lags_by_group.get(g, ())
        )
        row = {
            "sub_id": rec["sub_id"],
            "sql": rec.get("sql"),
            "class": cls,
            "fallback_bound": bool(plan.get("fallback_bound")),
            "groups": sub_groups,
            "eval_ms": round(eval_s * 1000.0, 3),
            "eval_ms_fallback": round(
                cost.get("eval_seconds_fallback", 0.0) * 1000.0, 3
            ),
            "fallback_evals": cost.get("fallback_evals", 0),
            "candidate_evals": cost.get("candidate_evals", 0),
            "rows_scanned": cost.get("rows_scanned", 0),
            "fanout_events": cost.get("fanout_events", 0),
            "fanout_bytes": cost.get("fanout_bytes", 0),
            "replay_rows": cost.get("replay_rows", 0),
            "queue_depth_hwm": cost.get("queue_depth_hwm", 0),
            "delivered_changes": delivered,
            "lag_ms": _lag_block(lags),
        }
        if sub_groups:
            expected = (
                cost.get("fanout_events", 0) + cost.get("replay_rows", 0)
            )
            row["mass_reconciled"] = expected == delivered
            if not row["mass_reconciled"]:
                mismatches.append(
                    f"sub {rec['sub_id'][:8]} ({cls}): ledger enqueued+"
                    f"replayed {expected} != oracle delivered {delivered}"
                )
        per_sub.append(row)
        c = classes.setdefault(cls, {
            "subs": 0, "fallback_bound": 0, "eval_ms": 0.0,
            "delivered_changes": 0, "_lags": [],
        })
        c["subs"] += 1
        c["fallback_bound"] += 1 if plan.get("fallback_bound") else 0
        c["eval_ms"] += eval_s * 1000.0
        c["delivered_changes"] += delivered
        c["_lags"].extend(lags)

    for c in classes.values():
        c["lag_ms"] = _lag_block(c.pop("_lags"))
        c["eval_ms"] = round(c["eval_ms"], 3)

    per_sub.sort(key=lambda r: r["eval_ms"], reverse=True)
    checked = [r for r in per_sub if "mass_reconciled" in r]
    n_streams = len(streams)
    fallback_bound_subs = sum(1 for r in per_sub if r["fallback_bound"])
    return {
        "kind": REPORT_KIND,
        "version": REPORT_VERSION,
        "streams": n_streams,
        "subs": len(per_sub),
        "eval_ms": {
            "total": round(eval_total * 1000.0, 3),
            "fallback": round(eval_fallback * 1000.0, 3),
            "candidate": round((eval_total - eval_fallback) * 1000.0, 3),
        },
        "fallback": {
            "bound_subs": fallback_bound_subs,
            "observed": fallback_observed,
            "share_of_eval_seconds": round(
                eval_fallback / eval_total, 4
            ) if eval_total > 0 else 0.0,
        },
        "classes": classes,
        "top": per_sub[:top_k],
        "reconciliation": {
            "ok": not mismatches,
            "checked": len(checked),
            "mismatches": mismatches[:16],
        },
        "oracle": {
            "violations": _get(run, "oracle.violations"),
            "delivered_changes": _get(run, "oracle.delivered_changes"),
            "fanout_lag_ms": _get(run, "oracle.fanout_lag_ms"),
        },
    }


def render_serving_report(rep: dict) -> str:
    lines = [
        f"serving query-cost report ({rep['subs']} subs, "
        f"{rep['streams']} streams)",
        f"  eval total {rep['eval_ms']['total']:.1f} ms — fallback "
        f"{rep['eval_ms']['fallback']:.1f} ms "
        f"({rep['fallback']['share_of_eval_seconds'] * 100:.1f}% of eval "
        f"burn, {rep['fallback']['bound_subs']} fallback-bound subs, "
        f"observed={rep['fallback']['observed']})",
        f"  reconciliation: "
        f"{'ok' if rep['reconciliation']['ok'] else 'MISMATCH'} "
        f"({rep['reconciliation']['checked']} subs checked)",
        "  per-class lag:",
    ]
    for cls in sorted(rep.get("classes", {})):
        c = rep["classes"][cls]
        lag = c["lag_ms"]
        lines.append(
            f"    {cls:<10} subs={c['subs']:<4} eval={c['eval_ms']:.1f} ms "
            f"lag p50={lag['p50']} p99={lag['p99']} max={lag['max']} ms"
        )
    lines.append("  top subscriptions by eval cost:")
    for r in rep.get("top", ())[:5]:
        lines.append(
            f"    {r['sub_id'][:8]} {r['class']:<9} "
            f"{'fallback' if r['fallback_bound'] else 'incremental'} "
            f"eval={r['eval_ms']:.1f} ms rows={r['rows_scanned']} "
            f"fanout={r['fanout_events']}"
        )
    for m in rep.get("reconciliation", {}).get("mismatches", ()):
        lines.append(f"  MISMATCH: {m}")
    return "\n".join(lines)


def diff_serving_reports(
    base: dict, cand: dict, tolerance: float = 1.5, floor_ms: float = 5.0
) -> tuple[bool, list[dict]]:
    """Compare a candidate serving-cost report against the committed
    baseline. Latency/eval paths regress when the candidate exceeds
    ``max(base * tolerance, floor_ms)`` (the floor keeps a 0.3 ms
    loopback baseline from weaponizing scheduler noise); the fallback
    share regresses past ``base + 0.15`` absolute. Returns
    ``(ok, rows)``; rows carry ``{path, base, cand, ok}``."""
    rows: list[dict] = []

    def num(path: str):
        b, c = _get(base, path), _get(cand, path)
        if b is None or c is None:
            return
        limit = max(float(b) * tolerance, floor_ms)
        rows.append({
            "path": path, "base": b, "cand": c,
            "limit": round(limit, 3), "ok": float(c) <= limit,
        })

    num("eval_ms.total")
    num("eval_ms.fallback")
    for cls in sorted(set(base.get("classes", {})) | set(cand.get("classes", {}))):
        num(f"classes.{cls}.lag_ms.p99")
    b_share = _get(base, "fallback.share_of_eval_seconds")
    c_share = _get(cand, "fallback.share_of_eval_seconds")
    if b_share is not None and c_share is not None:
        limit = min(1.0, float(b_share) + 0.15)
        rows.append({
            "path": "fallback.share_of_eval_seconds",
            "base": b_share, "cand": c_share, "limit": round(limit, 4),
            "ok": float(c_share) <= limit,
        })
    return all(r["ok"] for r in rows), rows


def check_serving_cost_budget(
    measured: dict, budget: dict
) -> tuple[bool, list[str]]:
    """Gate a serving-cost measurement against the ``serving_cost``
    entry of bench_budget.json. ``measured`` is the emitted smoke report
    (provenance + ``run`` + ``serving``). Returns ``(ok, breaches)``.

    Budget keys:

    - dimension keys (``SERVING_COST_DIMS``): exact match required;
    - ``tolerance``: multiplier on every ``ceilings_ms`` entry;
    - ``ceilings_ms``: dotted-path -> max ms; missing measurement is a
      breach;
    - ``fallback_share_max``: absolute ceiling on
      ``serving.fallback.share_of_eval_seconds``;
    - ``oracle_violations_max`` (default 0): absolute, never scaled;
    - ``require_fallback_observed`` (default True): the machinery-fired
      rule — a storm where no fallback-bound subscription ever
      evaluated is a harness failure, not a pass;
    - ``require_mass_reconciled`` (default True): the ledger must
      reconcile exactly against oracle delivery counts.
    """
    tol = float(budget.get("tolerance", 1.25))
    breaches: list[str] = []
    for dim in SERVING_COST_DIMS:
        if dim in budget and _get(measured, dim) != budget[dim]:
            breaches.append(
                f"{dim}: measured at {_get(measured, dim)!r} but the "
                f"budget was refreshed at {budget[dim]!r} — rerun with "
                f"--update"
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
    share_max = budget.get("fallback_share_max")
    share = _get(measured, "serving.fallback.share_of_eval_seconds")
    if share_max is not None:
        if share is None:
            breaches.append(
                "serving.fallback.share_of_eval_seconds: missing"
            )
        elif float(share) > float(share_max):
            breaches.append(
                f"fallback share: {float(share):.3f} > "
                f"{float(share_max):.3f} — the fallback-bound population "
                f"burns more of the eval budget than budgeted"
            )
    viol_max = int(budget.get("oracle_violations_max", 0))
    viol = _get(measured, "run.oracle.violations")
    if viol is not None and int(viol) > viol_max:
        breaches.append(
            f"oracle violations: {viol} > {viol_max} — exactly-once "
            f"delivery broke under the cost-plane storm"
        )
    if budget.get("require_fallback_observed", True):
        if not _get(measured, "serving.fallback.observed"):
            breaches.append(
                "test-harness failure: no fallback-bound subscription was "
                "ever observed evaluating — the storm never exercised the "
                "fallback cliff this gate exists to measure (add window-"
                "function subscriptions / check fallback_subs)"
            )
    if budget.get("require_mass_reconciled", True):
        if not _get(measured, "serving.reconciliation.ok"):
            breaches.append(
                "mass reconciliation failed: per-sub ledger fan-out mass "
                "!= oracle delivered counts ("
                + "; ".join(
                    (_get(measured, "serving.reconciliation.mismatches")
                     or ["no detail"])[:3]
                )
                + ")"
            )
    return not breaches, breaches

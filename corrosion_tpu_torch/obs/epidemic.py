"""Epidemic-model analyzer: propagation-plane curves -> SI-fit verdicts
(``corro-epidemic/1``; counterpart of corrosion_tpu/obs/epidemic.py,
host-side numpy as there).

The engines' propagation plane (``telemetry.PROP_CURVE_KEYS``, on when
``prop_observe`` is set) records per round which region pairs carried
the broadcast load (``link_ij``), how many delivered copies were new or
redundant, and a rumor-age histogram of first deliveries on the
``RUMOR_AGE_EDGES`` buckets. From those curves alone:

- **coverage curve S(t)**: the run-total rumor-age histogram is the
  derivative of the commit-aligned mean coverage, so its CDF samples
  S(t)/N at the bucket edges;
- **SI / logistic fit**: logit(S/N) is linear in t with slope beta for
  push gossip; ``fit_si`` regresses it (``np.polyfit``) and reports the
  spread exponent, half-coverage age and r^2 beside the push-gossip
  prediction beta = ln(1 + F);
- **traffic structure**: per-region-pair shares, same against cross
  region, ring shares on the geo geography, and the redundancy ratio;
- **conservation checks**: link mass == ``msgs``, rumor buckets ==
  ``vis_count`` and useful + dup == ``msgs`` every round, or the report
  refuses to stand (``checks_ok``);
- ``oracle_coverage`` buckets a live cluster's delivery records on the
  same axis.

``diff_reports`` flags regressions between two reports.
"""

from __future__ import annotations

import json
import math

import numpy as np

from corrosion_tpu_torch.sim.telemetry import (
    LINK_CURVE_KEYS,
    PROP_REGIONS,
    RUMOR_AGE_EDGES,
    RUMOR_AGE_KEYS,
    curve_array,
    replay_flight,
)

EPIDEMIC_SCHEMA = "corro-epidemic/1"

# Default fanout for theory comparison when the caller doesn't pass the
# config's: the reference-shaped 2 near + 2 far.
DEFAULT_FANOUT = 4


# Shared zero-fill curve accessor (telemetry.curve_array) — one fallback
# convention with sim/health.py's analyzers.
_arr = curve_array


def rumor_age_histogram(curves: dict) -> np.ndarray:
    """Run-total first-delivery counts per rumor-age bucket
    (len(RUMOR_AGE_KEYS); the last bucket is the overflow past the
    final edge)."""
    return np.asarray(
        [_arr(curves, k).sum() for k in RUMOR_AGE_KEYS], dtype=np.float64
    )


def link_matrix(curves: dict) -> np.ndarray:
    """Run-total [PROP_REGIONS, PROP_REGIONS] delivered-copies matrix
    (receiver region row, source region column)."""
    m = np.zeros((PROP_REGIONS, PROP_REGIONS), dtype=np.float64)
    for k in LINK_CURVE_KEYS:
        i, j = int(k[-2]), int(k[-1])
        m[i, j] = _arr(curves, k).sum()
    return m


def conservation_checks(curves: dict) -> tuple[bool, list[str]]:
    """The on-device accounting identities, per round: the link matrix's
    mass equals ``msgs``, the rumor buckets' mass equals ``vis_count``,
    and ``useful + dup == msgs``. A violation means the instrument is
    broken (or the flight predates the plane) — the report must not
    publish numbers it cannot reconcile."""
    problems: list[str] = []
    msgs = _arr(curves, "msgs")
    link = sum(_arr(curves, k) for k in LINK_CURVE_KEYS)
    if not np.array_equal(link, msgs):
        bad = int(np.sum(link != msgs))
        problems.append(
            f"link-matrix mass != msgs on {bad} round(s): the traffic "
            f"matrix must partition the delivered copies exactly"
        )
    rumor = sum(_arr(curves, k) for k in RUMOR_AGE_KEYS)
    vis = _arr(curves, "vis_count")
    if not np.array_equal(rumor, vis):
        bad = int(np.sum(rumor != vis))
        problems.append(
            f"rumor-age mass != vis_count on {bad} round(s): every first "
            f"delivery must land in exactly one age bucket"
        )
    useful = _arr(curves, "prop_useful_msgs")
    dup = _arr(curves, "prop_dup_msgs")
    if not np.array_equal(useful + dup, msgs):
        bad = int(np.sum(useful + dup != msgs))
        problems.append(
            f"useful + dup != msgs on {bad} round(s): the effective-"
            f"fanout split must partition the delivered copies"
        )
    return not problems, problems


def coverage_points(hist: np.ndarray) -> list[tuple[float, float]]:
    """(age upper edge, cumulative coverage fraction) per finite bucket
    — the reconstructed S(t)/N sampled at the bucket edges. The
    overflow bucket has no finite edge and is excluded (it still counts
    in the total, so its mass depresses the finite CDF — honest:
    never-finishing spread shows up as a curve that plateaus < 1)."""
    total = float(hist.sum())
    if total <= 0:
        return []
    cdf = np.cumsum(hist) / total
    return [
        (float(e), float(cdf[b])) for b, e in enumerate(RUMOR_AGE_EDGES)
    ]


def fit_si(points: list[tuple[float, float]]) -> dict:
    """Least-squares logit fit of the SI/logistic model to the coverage
    points: logit(S_frac) = intercept + beta * t. Points at 0 or 1
    carry no logit information and are dropped; with fewer than two
    interior points the fit abstains (``fitted: false``) rather than
    extrapolating from a degenerate curve.

    Returns measured ``spread_exponent`` (beta, per round),
    ``half_coverage_round`` (the fitted t where S = N/2), ``r2``, and
    the (t, frac, logit) triples used.
    """
    interior = [
        (t, f) for t, f in points if 1e-9 < f < 1.0 - 1e-9
    ]
    if len(interior) < 2:
        return {
            "fitted": False,
            "spread_exponent": None,
            "half_coverage_round": None,
            "r2": None,
            "points": [
                {"age": t, "coverage": f} for t, f in points
            ],
        }
    x = np.asarray([t for t, _ in interior], dtype=np.float64)
    y = np.asarray(
        [math.log(f / (1.0 - f)) for _, f in interior], dtype=np.float64
    )
    beta, intercept = np.polyfit(x, y, 1)
    pred = intercept + beta * x
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    half = -intercept / beta if beta != 0 else None
    return {
        "fitted": True,
        "spread_exponent": float(beta),
        "half_coverage_round": None if half is None else float(half),
        "r2": float(r2),
        "points": [
            {
                "age": t,
                "coverage": f,
                "logit": math.log(f / (1.0 - f))
                if 1e-9 < f < 1.0 - 1e-9 else None,
            }
            for t, f in points
        ],
    }


def push_gossip_theory(fanout: int, n_nodes: int | None) -> dict:
    """The SI-model prediction for push gossip with per-round fanout F:
    each informed node pushes F copies per round, so pre-saturation
    growth is (1 + F)^t — spread exponent beta = ln(1 + F) — and the
    logistic half-coverage from a single seed sits at
    t_half = ln(N - 1) / beta. Collisions and redundancy only slow the
    tail, so the measured exponent is expected AT OR BELOW theory;
    WAN rings, loss, and sparse writers push it further down — exactly
    the gap the diff gate watches."""
    beta = math.log(1.0 + fanout)
    return {
        "fanout": fanout,
        "spread_exponent": beta,
        "half_coverage_round": (
            math.log(max(n_nodes - 1, 2)) / beta
            if n_nodes is not None else None
        ),
    }


def geo_rings(n_regions: int) -> np.ndarray:
    """The synthetic circle geography's ring classes per region pair —
    the same arithmetic as ``ops.gossip.make_topology(region_rtt="geo")``
    so ring-resolved traffic shares need no topology file."""
    d = np.abs(
        np.arange(n_regions)[:, None] - np.arange(n_regions)[None, :]
    )
    d = np.minimum(d, n_regions - d)
    max_d = max(int(d.max()), 1)
    return np.ceil(d / max_d * 5).astype(np.int32)


def traffic_structure(curves: dict, geo_regions: int | None = None) -> dict:
    """Per-link traffic shares from the run-total link matrix: the raw
    [R, R] share matrix, the same- vs cross-region split, and — when
    ``geo_regions`` names the geo scenario's region count — per-RTT-ring
    shares under the deterministic circle geography."""
    m = link_matrix(curves)
    total = float(m.sum())
    used = [
        i for i in range(PROP_REGIONS)
        if m[i, :].sum() > 0 or m[:, i].sum() > 0
    ]
    r = (max(used) + 1) if used else 1
    shares = (m / total) if total > 0 else m
    out = {
        "total_copies": total,
        "regions": r,
        "matrix": [
            [float(m[i, j]) for j in range(r)] for i in range(r)
        ],
        "share_matrix": [
            [round(float(shares[i, j]), 6) for j in range(r)]
            for i in range(r)
        ],
        "same_region_share": (
            round(float(np.trace(m) / total), 6) if total > 0 else None
        ),
        "cross_region_share": (
            round(float((total - np.trace(m)) / total), 6)
            if total > 0 else None
        ),
    }
    if geo_regions:
        rings = geo_rings(geo_regions)
        ring_share: dict[int, float] = {}
        for i in range(min(geo_regions, PROP_REGIONS)):
            for j in range(min(geo_regions, PROP_REGIONS)):
                ring_share[int(rings[i, j])] = (
                    ring_share.get(int(rings[i, j]), 0.0) + float(m[i, j])
                )
        out["ring_shares"] = {
            str(k): round(v / total, 6) if total > 0 else 0.0
            for k, v in sorted(ring_share.items())
        }
    return out


def build_report(
    curves: dict,
    engine: str = "unknown",
    fanout: int = DEFAULT_FANOUT,
    nodes: int | None = None,
    round_ms: float = 500.0,
    geo_regions: int | None = None,
) -> dict:
    """The ``corro-epidemic/1`` artifact from per-round curves (any
    engine's output, or a ``replay_flight`` reconstruction)."""
    hist = rumor_age_histogram(curves)
    total = float(hist.sum())
    overflow = float(hist[-1])
    points = coverage_points(hist)
    fit = fit_si(points)
    theory = push_gossip_theory(fanout, nodes)
    msgs = float(_arr(curves, "msgs").sum())
    useful = float(_arr(curves, "prop_useful_msgs").sum())
    dup = float(_arr(curves, "prop_dup_msgs").sum())
    checks_ok, problems = conservation_checks(curves)
    beta = fit.get("spread_exponent")
    return {
        "schema": EPIDEMIC_SCHEMA,
        "engine": engine,
        "rounds": int(len(_arr(curves, "msgs"))),
        "round_ms": round_ms,
        "fanout": fanout,
        "nodes": nodes,
        # Coverage / fit
        "coverage_events": int(total),
        "coverage_overflow_events": int(overflow),
        "coverage_overflow_frac": (
            round(overflow / total, 6) if total > 0 else None
        ),
        "rumor_age_hist": hist.astype(np.int64).tolist(),
        "rumor_age_edges": list(RUMOR_AGE_EDGES),
        "fit": fit,
        "spread_exponent": beta,
        "half_coverage_round": fit.get("half_coverage_round"),
        "fit_r2": fit.get("r2"),
        "theory": theory,
        "spread_vs_theory": (
            round(beta / theory["spread_exponent"], 6)
            if beta is not None else None
        ),
        # Effective fanout / redundancy
        "msgs_total": msgs,
        "useful_msgs_total": useful,
        "dup_msgs_total": dup,
        "redundancy_ratio": round(dup / msgs, 6) if msgs > 0 else None,
        "effective_fanout": (
            round(fanout * useful / msgs, 6) if msgs > 0 else None
        ),
        # Traffic topology
        "traffic": traffic_structure(curves, geo_regions=geo_regions),
        # Conservation
        "checks_ok": checks_ok,
        "check_problems": problems,
    }


def report_from_flight(
    path: str,
    fanout: int = DEFAULT_FANOUT,
    nodes: int | None = None,
    round_ms: float = 500.0,
    geo_regions: int | None = None,
) -> dict:
    """corro-epidemic/1 from a flight JSONL alone (rotated segments
    included). Raises ValueError when the flight carries no propagation
    keys — the run was recorded with ``prop_observe`` off."""
    from corrosion_tpu_torch.sim.health import flight_header

    curves, _chunks = replay_flight(path)
    # The canonical schema zero-fills disabled planes, so key presence
    # alone cannot distinguish "plane off" from "plane on, quiet run" —
    # but a record with visibility events and NO rumor-age mass can
    # only be a disabled plane (the per-round conservation identity
    # rumor == vis_count holds whenever the plane ran).
    rumor = sum(_arr(curves, k).sum() for k in RUMOR_AGE_KEYS)
    vis = _arr(curves, "vis_count").sum()
    if rumor == 0 and vis > 0:
        raise ValueError(
            f"{path}: flight has visibility events but no rumor-age "
            f"mass — it was recorded with prop_observe off "
            f"(GossipConfig.prop_observe=True turns it on)"
        )
    engine = flight_header(path).get("engine", "unknown")
    return build_report(
        curves, engine=engine, fanout=fanout, nodes=nodes,
        round_ms=round_ms, geo_regions=geo_regions,
    )


def load_report(path: str, **kw) -> dict:
    """Load a saved corro-epidemic/1 JSON, or derive one from a flight
    JSONL."""
    with open(path) as f:
        first = f.readline().strip()
    obj = None
    try:
        obj = json.loads(first)
    except ValueError:
        try:
            with open(path) as f:
                obj = json.load(f)
        except ValueError:
            pass
    if isinstance(obj, dict) and "kind" not in obj:
        if obj.get("schema") != EPIDEMIC_SCHEMA:
            raise ValueError(
                f"{path}: not a flight JSONL or {EPIDEMIC_SCHEMA} report"
            )
        return obj
    return report_from_flight(path, **kw)


def render_report(rep: dict) -> str:
    """Human-readable report."""
    rm = rep["round_ms"] / 1000.0

    def s(x, fmt="{:g}"):
        return "n/a" if x is None else fmt.format(x)

    fit = rep["fit"]
    th = rep["theory"]
    lines = [
        f"engine={rep['engine']} rounds={rep['rounds']} "
        f"round_ms={rep['round_ms']:g} fanout={rep['fanout']}"
        + (f" nodes={rep['nodes']}" if rep["nodes"] else ""),
        (
            f"spread: beta={s(rep['spread_exponent'], '{:.4f}')}/round "
            f"(theory ln(1+F)={th['spread_exponent']:.4f}, ratio "
            f"{s(rep['spread_vs_theory'], '{:.2f}')}) r2="
            f"{s(rep['fit_r2'], '{:.3f}')}"
            if fit["fitted"]
            else "spread: fit abstained (fewer than 2 interior coverage "
            "points)"
        ),
        f"half-coverage: {s(rep['half_coverage_round'], '{:.1f}')} rounds"
        + (
            f" ({rep['half_coverage_round'] * rm:.1f}s simulated; theory "
            f"{th['half_coverage_round']:.1f} rounds)"
            if rep["half_coverage_round"] is not None
            and th["half_coverage_round"] is not None
            else ""
        ),
        f"coverage: {rep['coverage_events']} first deliveries, "
        f"overflow>{RUMOR_AGE_EDGES[-1]} rounds: "
        f"{rep['coverage_overflow_events']} "
        f"({s(rep['coverage_overflow_frac'], '{:.1%}')})",
        f"redundancy: {s(rep['redundancy_ratio'], '{:.1%}')} of "
        f"{rep['msgs_total']:g} copies were wasted pushes "
        f"(effective fanout {s(rep['effective_fanout'], '{:.2f}')} "
        f"of {rep['fanout']})",
    ]
    tr = rep["traffic"]
    if tr["total_copies"] > 0:
        lines.append(
            f"traffic: same-region {tr['same_region_share']:.1%}, "
            f"cross-region {tr['cross_region_share']:.1%} over "
            f"{tr['regions']} region(s)"
        )
        if "ring_shares" in tr:
            lines.append(
                "  ring shares: " + " ".join(
                    f"ring{k}:{v:.1%}" for k, v in tr["ring_shares"].items()
                )
            )
    lines.append(
        "accounting: OK" if rep["checks_ok"]
        else "accounting: BROKEN — " + "; ".join(rep["check_problems"])
    )
    return "\n".join(lines)


# Metrics compared by ``diff_reports``: (field, larger-is-worse,
# absolute slack added to the relative tolerance band).
DIFF_METRICS = (
    # Slower spread = regression (smaller beta is worse).
    ("spread_exponent", False, 0.02),
    ("half_coverage_round", True, 1.0),
    # Redundancy gates through its monotone twin: effective_fanout =
    # F * useful / msgs. A redundancy fraction sitting near 1 (the
    # saturated steady state) has no relative headroom to regress
    # within, while the useful fraction scales cleanly.
    ("effective_fanout", False, 0.02),
    ("coverage_overflow_frac", True, 0.01),
    ("fit_r2", False, 0.05),
)


def diff_reports(base: dict, cand: dict, tolerance: float = 0.25) -> dict:
    """BENCH-style regression diff between two corro-epidemic/1 reports.

    A candidate whose accounting checks fail, or whose fit abstains
    where the baseline's fitted, is always a regression — tolerance
    never scales a broken instrument into passing."""
    rows = []
    regressions = []
    if not cand.get("checks_ok", False):
        regressions.append(
            "candidate conservation checks failed: "
            + "; ".join(cand.get("check_problems", ["(no detail)"]))
        )
    if base.get("fit", {}).get("fitted") and not cand.get("fit", {}).get(
        "fitted"
    ):
        regressions.append(
            "candidate SI fit abstained (baseline fitted) — the spread "
            "curve lost its interior"
        )
    for name, larger_worse, slack in DIFF_METRICS:
        a, b = base.get(name), cand.get(name)
        row = {"metric": name, "baseline": a, "candidate": b, "ok": True}
        if a is not None and b is not None:
            af, bf = float(a), float(b)
            if larger_worse:
                worse = bf > af * (1.0 + tolerance) + slack
            else:
                worse = bf < af * (1.0 - tolerance) - slack
            if worse:
                row["ok"] = False
                regressions.append(
                    f"{name}: {b} vs baseline {a} "
                    f"(tolerance {tolerance:.0%} + {slack:g})"
                )
        rows.append(row)
    return {"regressions": regressions, "rows": rows}


def publish_epidemic(registry, rep: dict, engine: str | None = None) -> None:
    """Fold the run-level epidemic verdicts into a MetricsRegistry as
    ``corro_kernel_epidemic_*`` gauges (-1 sentinels where the fit
    abstained or no traffic flowed)."""
    eng = engine or rep.get("engine", "unknown")

    def g(name: str, value, help_: str) -> None:
        registry.gauge(
            f"corro_kernel_epidemic_{name}",
            f"epidemic plane: {help_}",
        ).set(-1.0 if value is None else float(value), engine=eng)

    g("spread_exponent", rep.get("spread_exponent"),
      "fitted SI spread exponent, per round (-1 = fit abstained)")
    g("half_coverage_round", rep.get("half_coverage_round"),
      "fitted half-coverage age in rounds (-1 = fit abstained)")
    g("fit_r2", rep.get("fit_r2"), "logit-fit r² (-1 = fit abstained)")
    g("redundancy_ratio", rep.get("redundancy_ratio"),
      "wasted-push fraction of delivered copies (-1 = no traffic)")
    g("coverage_events", rep.get("coverage_events", 0),
      "first deliveries the rumor-age histogram bucketed")


def oracle_coverage(records: dict, round_ms: float = 500.0) -> dict:
    """The host plane's view of the same spread curve: from loadgen
    oracle delivery records (``FanoutOracle.delivery_records`` with
    ``keep_deliveries``), bucket each change event's commit-ack-to-
    delivery wall age (in rounds of ``round_ms``) on the SAME
    ``RUMOR_AGE_EDGES`` axis and fit the SI model — the mixed-mode
    cross-validation path (docs/FIDELITY.md): kernel and live runs of
    one scenario land on one comparable bucket axis."""
    ack_by_key = {
        w["key"]: w.get("t_ack_wall")
        for w in records.get("writes", [])
        if w.get("t_ack_wall") is not None
    }
    hist = np.zeros(len(RUMOR_AGE_KEYS), dtype=np.float64)
    matched = 0
    for d in records.get("deliveries", []):
        if d.get("kind") != "change":
            continue
        ack = ack_by_key.get(d.get("key"))
        t = d.get("t_wall")
        if ack is None or t is None:
            continue
        age_rounds = max(t - ack, 0.0) / (round_ms / 1000.0)
        b = 0
        for e in RUMOR_AGE_EDGES:
            if age_rounds > e:
                b += 1
        hist[b] += 1
        matched += 1
    fit = fit_si(coverage_points(hist))
    return {
        "source": "loadgen-oracle",
        "round_ms": round_ms,
        "events": matched,
        "rumor_age_hist": hist.astype(np.int64).tolist(),
        "fit": fit,
        "spread_exponent": fit.get("spread_exponent"),
        "half_coverage_round": fit.get("half_coverage_round"),
    }

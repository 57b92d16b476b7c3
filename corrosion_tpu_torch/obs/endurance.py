"""Endurance detectors over recorded metric series (``corro-endurance/1``).

The analysis half of the endurance plane: given the samples of a
``corro-metric-series/1`` record (:mod:`corrosion_tpu_torch.obs.series`),
derive the verdicts an hours-long soak needs — without trusting any
end-of-run point:

- **Leak trends**: robust Theil–Sen slope fits (median of pairwise
  slopes — one GC pause or compaction spike cannot drag the fit) over
  the process gauges (``corro_runtime_rss_bytes``/``_open_fds``),
  queue-backlog and staleness watermarks, reported in units/hour and
  flagged against per-series ceilings.
- **Counter-reset handling**: monotonic cumulatives are rebased across
  discontinuities, each classified as *restart* (an agent relaunched —
  hostchaos ``kill_restart`` — drops its counters to ~0), *wraparound*
  (the value sat near a 2^32/2^64 base), or *genuine decrease* (a
  monotonic-contract violation; the cumulative holds flat). Relaunches
  therefore don't fake leaks or un-fake wedges.
- **Wedge detection**: progress counters (changes applied/committed)
  flat across a sustained run of samples while the workload side says
  work was offered.
- **Loop-lag stall runs**: consecutive samples with the event-loop lag
  gauge above threshold — the blocked-loop signal, as a run length
  rather than a point.
- **SLO burn rates**: service objectives (fan-out lag p99, convergence
  staleness, probe false-alarm budget) evaluated as MULTI-WINDOW burn
  rates over the series (the production SRE slow-burn methodology: a
  breach requires both the fast and the slow window to burn budget
  above threshold), not end-of-run points.

``check_soak_budget`` gates a soak report against the ``soak`` entry of
bench_budget.json: leak-slope ceilings are tolerance-scaled; wedge /
SLO-breach / stall maxima, the detectors-armed rule (a soak passing
with detectors never armed is a harness failure), and the kernel series
determinism requirement are NEVER tolerance-scaled.

Host code only, like obs/series.py. Counterpart of
corrosion_tpu/obs/endurance.py.
"""

from __future__ import annotations

ENDURANCE_SCHEMA = "corro-endurance/1"
SOAK_SCHEMA = "corro-soak/1"

# Wrap bases a monotonic counter can legitimately fall back from.
WRAP_BASES = (2.0 ** 32, 2.0 ** 64)

# Leak-scan targets, by series-name stem (labels aggregated): the
# process self-observability gauges plus the host/kernel backlog and
# staleness watermarks ROADMAP item 6 names as leak/wedge oracles.
DEFAULT_LEAK_SERIES = (
    "corro_runtime_rss_bytes",
    "corro_runtime_open_fds",
    "corro_broadcast_pending",
    "corro_sync_needs",
    "corro_kernel_health_queue_backlog_last",
    "corro_kernel_health_staleness_sum_last",
)

# Units-per-hour ceilings for standalone `obs soak report` use; the CI
# lane's committed budget (bench_budget.json `soak`) is authoritative
# there and refreshed with x3 headroom like every other gate. Generous:
# a CI-sized window extrapolated to an hour amplifies sampling noise.
DEFAULT_LEAK_CEILINGS = {
    "corro_runtime_rss_bytes": 512 * 2 ** 20,  # 512 MiB/h
    "corro_runtime_open_fds": 600.0,
    "corro_broadcast_pending": 20000.0,
    "corro_sync_needs": 20000.0,
    "corro_kernel_health_queue_backlog_last": 50000.0,
    "corro_kernel_health_staleness_sum_last": 50000.0,
}

# (offered, progress) counter-stem pairs for wedge detection: local
# commits keep arriving while the apply pipeline delivers nothing.
DEFAULT_WEDGE_PAIRS = (
    ("corro_changes_committed", "corro_changes_applied"),
)

DEFAULT_WINDOWS = (("fast", 0.1), ("slow", 0.5))

# Host-plane SLO catalog (agent runtime series). Kernel-plane lanes
# pass their own (engine-labeled level gauges, round-unit clock).
DEFAULT_SLOS = (
    {
        "name": "fanout_lag_p99",
        "kind": "histogram",
        "series": "corro_broadcast_recv_lag_seconds",
        "threshold_s": 2.0,
        "objective": 0.99,
    },
    {
        "name": "convergence_staleness",
        "kind": "gauge",
        "series": "corro_sync_needs",
        "ceiling": 500.0,
        "objective": 0.90,
    },
    {
        "name": "probe_false_alarm_budget",
        "kind": "counter_budget",
        "series": "corro_gossip_member_removed",
        "allowed_per_hour": 720.0,
    },
)


# -- robust trend fit --------------------------------------------------------


def theil_sen(
    ts: list[float], ys: list[float], max_pairs: int = 4000,
) -> float | None:
    """Theil–Sen slope: the median of all pairwise slopes. Robust to
    ~29% outlier contamination, which is what a soak series needs — a
    single compaction spike or GC pause must not set the verdict. Past
    ``max_pairs`` the pair set is thinned by a DETERMINISTIC stride (no
    RNG: seeded reruns must reproduce the verdict bit for bit)."""
    n = len(ts)
    if n < 2:
        return None
    total = n * (n - 1) // 2
    step = max(1, total // max_pairs)
    slopes: list[float] = []
    idx = 0
    for i in range(n - 1):
        for j in range(i + 1, n):
            if idx % step == 0:
                dt = ts[j] - ts[i]
                if dt > 0:
                    slopes.append((ys[j] - ys[i]) / dt)
            idx += 1
    if not slopes:
        return None
    slopes.sort()
    m = len(slopes)
    return 0.5 * (slopes[m // 2] + slopes[(m - 1) // 2])


# -- counter-reset / restart discontinuities ---------------------------------


def rebase_counter(
    values: list[float], wrap_slack: float = 0.05,
) -> tuple[list[float], list[dict]]:
    """Rebase a monotonic-cumulative series across discontinuities.

    Every decrease is classified and absorbed so downstream deltas stay
    meaningful across agent relaunches:

    - *wraparound*: the previous value sat within ``wrap_slack`` of a
      wrap base (2^32 / 2^64) — the base is added, so the true delta
      ``base - prev + new`` survives;
    - *restart*: the value fell to (at most half of) its previous level
      with no wrap base in reach — a new life counting from ~0; the
      previous cumulative becomes the new base;
    - *decrease*: anything else is a monotonic-contract violation; the
      cumulative holds flat rather than inventing negative work.

    Returns ``(rebased, events)`` with one event per discontinuity.
    """
    out: list[float] = []
    events: list[dict] = []
    base = 0.0
    prev: float | None = None
    for i, v in enumerate(values):
        if prev is not None and v < prev:
            wrapped = next(
                (
                    wb for wb in WRAP_BASES
                    if prev <= wb and prev >= (1.0 - wrap_slack) * wb
                ),
                None,
            )
            if wrapped is not None:
                kind = "wraparound"
                base += wrapped
            elif v <= 0.5 * prev:
                kind = "restart"
                base += prev
            else:
                kind = "decrease"
                base += prev - v
            events.append(
                {"i": i, "kind": kind, "prev": prev, "value": v}
            )
        prev = v
        out.append(base + v)
    return out, events


# -- series extraction helpers -----------------------------------------------


def _stem(name: str) -> str:
    return name.split("{", 1)[0]


def stem_values(
    samples: list[dict], stem: str, families=("counters", "gauges"),
) -> tuple[list[float], list[float]]:
    """Aggregated ``(ts, values)`` for every labeled variant of a series
    stem, summed per sample (an agent restart drops ALL its labelsets at
    once, so the summed series still rebases cleanly)."""
    ts: list[float] = []
    vals: list[float] = []
    for s in samples:
        total = 0.0
        hit = False
        for fam in families:
            for k, v in s.get(fam, {}).items():
                if _stem(k) == stem:
                    total += float(v)
                    hit = True
        if hit:
            ts.append(float(s["t"]))
            vals.append(total)
    return ts, vals


def stem_histograms(
    samples: list[dict], stem: str,
) -> tuple[list[float], list[dict]]:
    """Aggregated ``(ts, hists)`` for a histogram stem: per sample, the
    labeled variants' bucket vectors summed edge-wise."""
    ts: list[float] = []
    hists: list[dict] = []
    for s in samples:
        agg: dict | None = None
        for k, h in s.get("histograms", {}).items():
            if _stem(k) != stem:
                continue
            if agg is None:
                agg = {
                    "le": list(h["le"]),
                    "counts": list(h["counts"]),
                    "sum": float(h["sum"]),
                    "count": int(h["count"]),
                }
            elif agg["le"] == h["le"]:
                agg["counts"] = [
                    a + b for a, b in zip(agg["counts"], h["counts"])
                ]
                agg["sum"] += float(h["sum"])
                agg["count"] += int(h["count"])
        if agg is not None:
            ts.append(float(s["t"]))
            hists.append(agg)
    return ts, hists


# -- detectors ---------------------------------------------------------------


def fit_leaks(
    samples: list[dict],
    *,
    t_scale_s: float = 1.0,
    leak_series=DEFAULT_LEAK_SERIES,
    ceilings: dict | None = None,
    min_points: int = 4,
) -> dict:
    """Theil–Sen units-per-hour verdicts for every leak-scan stem that
    appears in the series."""
    ceilings = dict(DEFAULT_LEAK_CEILINGS, **(ceilings or {}))
    out: dict[str, dict] = {}
    for stem in leak_series:
        ts, vals = stem_values(samples, stem)
        if not ts:
            continue
        slope_t = theil_sen(ts, vals)
        entry: dict = {
            "points": len(ts),
            "first": vals[0],
            "last": vals[-1],
            "growth": vals[-1] - vals[0],
        }
        if slope_t is None or len(ts) < min_points:
            entry.update(
                {"slope_per_hour": None, "flagged": False,
                 "armed": False}
            )
        else:
            per_hour = slope_t / t_scale_s * 3600.0
            ceiling = ceilings.get(stem)
            entry.update({
                "slope_per_hour": round(per_hour, 3),
                "ceiling_per_hour": ceiling,
                "armed": True,
                "flagged": bool(
                    ceiling is not None
                    and per_hour > ceiling
                    and entry["growth"] > 0
                ),
            })
        out[stem] = entry
    return out


def detect_wedges(
    samples: list[dict],
    *,
    t_scale_s: float = 1.0,
    pairs=DEFAULT_WEDGE_PAIRS,
    min_samples: int = 3,
    min_span_s: float = 5.0,
) -> tuple[dict, dict]:
    """Longest offered-but-no-progress run per (offered, progress)
    counter pair; a pair is wedged when the run spans at least
    ``min_samples`` intervals AND ``min_span_s`` seconds. Returns
    ``(wedges, resets)`` — resets aggregates the rebase discontinuities
    seen on the way (the relaunch evidence)."""
    wedges: dict[str, dict] = {}
    resets: dict[str, list] = {}
    for offered_stem, progress_stem in pairs:
        ts_o, off = stem_values(samples, offered_stem, ("counters",))
        ts_p, prog = stem_values(samples, progress_stem, ("counters",))
        label = f"{offered_stem}->{progress_stem}"
        if len(ts_o) < 2 or len(ts_p) < 2:
            wedges[label] = {"armed": False, "wedged": False}
            continue
        off_rb, ev_o = rebase_counter(off)
        prog_rb, ev_p = rebase_counter(prog)
        if ev_o:
            resets[offered_stem] = ev_o
        if ev_p:
            resets[progress_stem] = ev_p
        # Align on sample timestamps both series cover.
        by_t_p = dict(zip(ts_p, prog_rb))
        t_al = [t for t in ts_o if t in by_t_p]
        o_al = [off_rb[i] for i, t in enumerate(ts_o) if t in by_t_p]
        p_al = [by_t_p[t] for t in t_al]
        best = {"samples": 0, "span_s": 0.0, "offered": 0.0}
        run_start = None
        run_offered = 0.0
        offered_any = False
        for i in range(1, len(t_al)):
            d_off = o_al[i] - o_al[i - 1]
            d_prog = p_al[i] - p_al[i - 1]
            offered_any = offered_any or d_off > 0
            if d_off > 0 and d_prog <= 0:
                if run_start is None:
                    run_start = i - 1
                    run_offered = 0.0
                run_offered += d_off
                span = (t_al[i] - t_al[run_start]) * t_scale_s
                if i - run_start > best["samples"]:
                    best = {
                        "samples": i - run_start,
                        "span_s": round(span, 3),
                        "offered": run_offered,
                    }
            else:
                run_start = None
        wedges[label] = {
            "armed": offered_any,
            "wedged": bool(
                best["samples"] >= min_samples
                and best["span_s"] >= min_span_s
            ),
            "longest_run": best,
        }
    return wedges, resets


def detect_stalls(
    samples: list[dict],
    *,
    t_scale_s: float = 1.0,
    gauge: str = "corro_runtime_loop_lag_last_seconds",
    threshold_s: float = 0.5,
    min_run: int = 3,
) -> dict:
    """Loop-lag stall runs: consecutive samples with the lag gauge above
    ``threshold_s``. Reports the longest run and how many qualifying
    runs (length >= min_run) occurred."""
    ts, vals = stem_values(samples, gauge, ("gauges",))
    if len(ts) < 2:
        return {"armed": False, "runs": 0, "longest": 0}
    runs = 0
    longest = 0
    longest_span = 0.0
    cur = 0
    start_t = None
    for t, v in zip(ts, vals):
        if v > threshold_s:
            if cur == 0:
                start_t = t
            cur += 1
            if cur > longest:
                longest = cur
                longest_span = (t - start_t) * t_scale_s
            if cur == min_run:
                runs += 1
        else:
            cur = 0
    return {
        "armed": True,
        "threshold_s": threshold_s,
        "runs": runs,
        "longest": longest,
        "longest_span_s": round(longest_span, 3),
    }


# -- SLO burn rates ----------------------------------------------------------


def _hist_bad_cum(hist: dict, threshold_s: float) -> int:
    """Events strictly above the threshold bucket, cumulatively: total
    minus the cumulative count at the first edge >= threshold."""
    good = 0
    for edge, c in zip(hist["le"], hist["counts"]):
        if edge >= threshold_s:
            good = c
            break
    else:
        good = hist["counts"][-1] if hist["counts"] else 0
    return int(hist["count"]) - int(good)


def eval_slo(
    samples: list[dict], slo: dict, *, t_scale_s: float = 1.0,
    windows=DEFAULT_WINDOWS, burn_threshold: float = 1.0,
) -> dict:
    """One SLO's multi-window burn rates. ``breached`` requires EVERY
    armed window to burn at or above threshold — and at least one window
    to be armed — so a single late blip (fast window only) or ancient
    history (slow window only) cannot breach alone."""
    kind = slo["kind"]
    out: dict = {
        "kind": kind, "series": slo["series"], "windows": {},
    }
    win_results: list[dict] = []

    def window_start(n: int, frac: float) -> int:
        k = max(3, int(round(n * frac)))
        return max(0, n - k)

    if kind == "histogram":
        ts, hists = stem_histograms(samples, slo["series"])
        budget = max(1e-9, 1.0 - float(slo["objective"]))
        for wname, frac in windows:
            if len(ts) < 2:
                win_results.append({"name": wname, "armed": False})
                continue
            i0 = window_start(len(ts), frac)
            d_total = hists[-1]["count"] - hists[i0]["count"]
            d_bad = (
                _hist_bad_cum(hists[-1], slo["threshold_s"])
                - _hist_bad_cum(hists[i0], slo["threshold_s"])
            )
            if d_total <= 0:
                win_results.append({"name": wname, "armed": False})
                continue
            bad_frac = max(0.0, d_bad / d_total)
            win_results.append({
                "name": wname, "armed": True, "events": int(d_total),
                "bad_frac": round(bad_frac, 5),
                "burn": round(bad_frac / budget, 3),
            })
    elif kind == "gauge":
        ts, vals = stem_values(samples, slo["series"], ("gauges",))
        budget = max(1e-9, 1.0 - float(slo["objective"]))
        for wname, frac in windows:
            if len(ts) < 2:
                win_results.append({"name": wname, "armed": False})
                continue
            i0 = window_start(len(ts), frac)
            wvals = vals[i0:]
            bad_frac = sum(
                1 for v in wvals if v > slo["ceiling"]
            ) / len(wvals)
            win_results.append({
                "name": wname, "armed": True, "samples": len(wvals),
                "bad_frac": round(bad_frac, 5),
                "burn": round(bad_frac / budget, 3),
            })
    elif kind == "counter_budget":
        ts, vals = stem_values(samples, slo["series"])
        if vals:
            vals, _ev = rebase_counter(vals)
        for wname, frac in windows:
            if len(ts) < 2:
                win_results.append({"name": wname, "armed": False})
                continue
            i0 = window_start(len(ts), frac)
            span_h = (ts[-1] - ts[i0]) * t_scale_s / 3600.0
            if span_h <= 0:
                win_results.append({"name": wname, "armed": False})
                continue
            events = max(0.0, vals[-1] - vals[i0])
            rate = events / span_h
            win_results.append({
                "name": wname, "armed": True, "events": events,
                "per_hour": round(rate, 3),
                "burn": round(rate / float(slo["allowed_per_hour"]), 3),
            })
    else:
        raise ValueError(f"unknown SLO kind {kind!r}")

    armed = [w for w in win_results if w.get("armed")]
    out["windows"] = {w["name"]: w for w in win_results}
    out["armed"] = bool(armed)
    out["breached"] = bool(armed) and all(
        w["burn"] >= burn_threshold for w in armed
    )
    return out


# -- the corro-endurance/1 report --------------------------------------------


def build_report(
    samples: list[dict],
    *,
    t_scale_s: float = 1.0,
    label: str = "",
    leak_series=DEFAULT_LEAK_SERIES,
    leak_ceilings: dict | None = None,
    min_points: int = 4,
    wedge_pairs=DEFAULT_WEDGE_PAIRS,
    wedge_min_samples: int = 3,
    wedge_min_span_s: float = 5.0,
    stall_gauge: str = "corro_runtime_loop_lag_last_seconds",
    stall_threshold_s: float = 0.5,
    stall_min_run: int = 3,
    slos=DEFAULT_SLOS,
    windows=DEFAULT_WINDOWS,
    burn_threshold: float = 1.0,
) -> dict:
    """Run every detector over one series' samples and assemble the
    self-describing verdict artifact."""
    span_s = (
        (float(samples[-1]["t"]) - float(samples[0]["t"])) * t_scale_s
        if len(samples) >= 2 else 0.0
    )
    leaks = fit_leaks(
        samples, t_scale_s=t_scale_s, leak_series=leak_series,
        ceilings=leak_ceilings, min_points=min_points,
    )
    wedges, resets = detect_wedges(
        samples, t_scale_s=t_scale_s, pairs=wedge_pairs,
        min_samples=wedge_min_samples, min_span_s=wedge_min_span_s,
    )
    stalls = detect_stalls(
        samples, t_scale_s=t_scale_s, gauge=stall_gauge,
        threshold_s=stall_threshold_s, min_run=stall_min_run,
    )
    slo_out = {
        s["name"]: eval_slo(
            samples, s, t_scale_s=t_scale_s, windows=windows,
            burn_threshold=burn_threshold,
        )
        for s in slos
    }

    breaches: list[str] = []
    for stem, e in leaks.items():
        if e.get("flagged"):
            breaches.append(
                f"leak: {stem} slope {e['slope_per_hour']:g}/h > "
                f"ceiling {e['ceiling_per_hour']:g}/h"
            )
    for pair, w in wedges.items():
        if w.get("wedged"):
            breaches.append(
                f"wedge: {pair} flat for {w['longest_run']['span_s']}s "
                f"while {w['longest_run']['offered']:g} offered"
            )
    if stalls.get("runs", 0) > 0:
        breaches.append(
            f"stall: {stalls['runs']} loop-lag runs >= "
            f"{stall_min_run} samples above {stall_threshold_s}s "
            f"(longest {stalls['longest']})"
        )
    for name, s in slo_out.items():
        if s["breached"]:
            burns = {
                w: s["windows"][w].get("burn")
                for w in s["windows"] if s["windows"][w].get("armed")
            }
            breaches.append(f"slo: {name} burn over threshold: {burns}")

    return {
        "schema": ENDURANCE_SCHEMA,
        "label": label,
        "samples": len(samples),
        "span_s": round(span_s, 3),
        "t_scale_s": t_scale_s,
        "resets": {
            stem: {
                "events": len(evs),
                "kinds": sorted({e["kind"] for e in evs}),
            }
            for stem, evs in resets.items()
        },
        "leaks": leaks,
        "wedges": wedges,
        "stalls": stalls,
        "slo": slo_out,
        "detectors_armed": {
            "leak": any(e.get("armed") for e in leaks.values()),
            "wedge": any(w.get("armed") for w in wedges.values()),
            "stall": bool(stalls.get("armed")),
            "slo": any(s.get("armed") for s in slo_out.values()),
        },
        "breaches": breaches,
        "ok": not breaches,
    }


def render_report(report: dict) -> str:
    """Human-readable form of a corro-endurance/1 report."""
    lines = [
        f"endurance[{report.get('label') or '-'}]: "
        f"{report['samples']} samples over {report['span_s']}s "
        f"({'ok' if report['ok'] else 'BREACHED'})"
    ]
    for stem, e in sorted(report["leaks"].items()):
        if e.get("slope_per_hour") is None:
            continue
        mark = "LEAK" if e["flagged"] else "ok"
        lines.append(
            f"  leak {stem}: {e['slope_per_hour']:+g}/h "
            f"(ceiling {e.get('ceiling_per_hour')}) [{mark}]"
        )
    for pair, w in sorted(report["wedges"].items()):
        if not w.get("armed"):
            continue
        mark = "WEDGE" if w["wedged"] else "ok"
        lines.append(
            f"  wedge {pair}: longest run "
            f"{w['longest_run']['samples']} samples/"
            f"{w['longest_run']['span_s']}s [{mark}]"
        )
    st = report["stalls"]
    if st.get("armed"):
        lines.append(
            f"  stalls: {st['runs']} runs, longest {st['longest']} "
            f"samples [{'STALL' if st['runs'] else 'ok'}]"
        )
    for name, s in sorted(report["slo"].items()):
        if not s.get("armed"):
            continue
        burns = ", ".join(
            f"{w}={s['windows'][w].get('burn')}"
            for w in s["windows"] if s["windows"][w].get("armed")
        )
        lines.append(
            f"  slo {name}: {burns} "
            f"[{'BREACH' if s['breached'] else 'ok'}]"
        )
    for b in report["breaches"]:
        lines.append(f"  BREACH: {b}")
    return "\n".join(lines)


# -- soak report diff + budget gate ------------------------------------------


def endurance_blocks(report: dict) -> dict[str, dict]:
    """Every corro-endurance/1 block inside a report, keyed by path
    label: a bare endurance report maps to ``{"": report}``; a
    corro-soak/1 report contributes ``kernel`` and ``host.n<i>``."""
    if report.get("schema") == ENDURANCE_SCHEMA:
        return {"": report}
    out: dict[str, dict] = {}
    k = (report.get("kernel") or {}).get("endurance")
    if k:
        out["kernel"] = k
    host_end = (report.get("host") or {}).get("endurance") or {}
    for name, blk in (host_end.get("agents") or {}).items():
        out[f"host.{name}"] = blk
    return out


def _slope_floor(stem: str) -> float:
    """Absolute noise floor for slope diffs: a quarter of the default
    ceiling (short windows extrapolated to /hour jitter hard)."""
    return 0.25 * DEFAULT_LEAK_CEILINGS.get(stem, 800.0)


def diff_soak(base: dict, cand: dict, tolerance: float = 0.5) -> dict:
    """Diff two soak (or bare endurance) reports: leak-slope regressions
    at ``tolerance`` above an absolute noise floor; NEW breaches, lost
    detector arming, and series-coverage collapse are never tolerated."""
    rows: list[dict] = []
    regressions: list[str] = []
    bb, cb = endurance_blocks(base), endurance_blocks(cand)
    if not bb:
        regressions.append("baseline carries no endurance blocks")
    for label, b in bb.items():
        c = cb.get(label)
        if c is None:
            regressions.append(f"{label}: endurance block missing")
            continue
        if c["samples"] < max(2, b["samples"] // 2):
            regressions.append(
                f"{label}: series coverage collapsed "
                f"({b['samples']} -> {c['samples']} samples)"
            )
        for stem, be in b["leaks"].items():
            ce = (c["leaks"] or {}).get(stem)
            if (
                ce is None or be.get("slope_per_hour") is None
                or ce.get("slope_per_hour") is None
            ):
                continue
            bs, cs = be["slope_per_hour"], ce["slope_per_hour"]
            limit = max(bs, 0.0) * (1.0 + tolerance) + _slope_floor(stem)
            ok = cs <= limit
            rows.append({
                "metric": f"{label}:{stem}.slope_per_hour",
                "baseline": bs, "candidate": cs, "ok": ok,
            })
            if not ok:
                regressions.append(
                    f"{label}: {stem} leak slope {bs:g}/h -> {cs:g}/h "
                    f"(limit {limit:g}/h)"
                )
        if not b["breaches"] and c["breaches"]:
            regressions.append(
                f"{label}: new breaches: {c['breaches'][:3]}"
            )
        for det, was in b["detectors_armed"].items():
            if was and not c["detectors_armed"].get(det):
                regressions.append(
                    f"{label}: detector {det!r} no longer armed — "
                    f"harness coverage regressed"
                )
    if (
        (base.get("kernel") or {}).get("determinism_ok")
        and not (cand.get("kernel") or {}).get("determinism_ok")
    ):
        regressions.append("kernel series replay determinism lost")
    return {"rows": rows, "regressions": regressions}


def check_soak_budget(report: dict, budget: dict) -> tuple[bool, list]:
    """Gate a corro-soak/1 report against the bench_budget.json ``soak``
    entry. Leak-slope ceilings and the wall ceiling are tolerance-
    scaled; wedge/SLO/stall maxima, the detectors-armed rule, and the
    determinism requirement never are."""
    breaches: list[str] = []
    tol = float(budget.get("tolerance", 1.0))

    for k in ("platform", "scenario"):
        want = budget.get(k)
        if want is not None and report.get(k) != want:
            breaches.append(
                f"dims: {k} {report.get(k)!r} != budget {want!r}"
            )

    blocks = endurance_blocks(report)
    if not blocks:
        breaches.append("report carries no endurance blocks")

    wedge_max = int(budget.get("wedge_max", 0))
    slo_max = int(budget.get("slo_breach_max", 0))
    stall_max = int(budget.get("stall_runs_max", 0))
    for label, blk in sorted(blocks.items()):
        wedged = sum(
            1 for w in blk["wedges"].values() if w.get("wedged")
        )
        if wedged > wedge_max:  # never tolerance-scaled
            breaches.append(
                f"{label}: {wedged} wedge(s) > max {wedge_max}"
            )
        slo_breached = sum(
            1 for s in blk["slo"].values() if s.get("breached")
        )
        if slo_breached > slo_max:  # never tolerance-scaled
            breaches.append(
                f"{label}: {slo_breached} SLO breach(es) > max {slo_max}"
            )
        if blk["stalls"].get("runs", 0) > stall_max:
            breaches.append(
                f"{label}: {blk['stalls']['runs']} stall run(s) > max "
                f"{stall_max}"
            )

    for path, ceiling in (
        budget.get("leak_ceilings_per_hour") or {}
    ).items():
        prefix, _, stem = path.partition(":")
        matched = False
        for label, blk in blocks.items():
            if not (label == prefix or label.startswith(prefix + ".")):
                continue
            e = blk["leaks"].get(stem)
            if e is None or e.get("slope_per_hour") is None:
                continue
            matched = True
            if e["slope_per_hour"] > ceiling * tol:
                breaches.append(
                    f"{label}: {stem} slope {e['slope_per_hour']:g}/h "
                    f"> budget {ceiling:g}/h x{tol:g}"
                )
        if not matched:
            breaches.append(
                f"budget ceiling {path!r} matched no measured series — "
                f"coverage hole"
            )

    if budget.get("require_detectors_armed", True):
        armed: set[str] = set()
        for blk in blocks.values():
            armed.update(
                d for d, on in blk["detectors_armed"].items() if on
            )
        unarmed = sorted(
            {"leak", "wedge", "stall", "slo"} - armed
        )
        if unarmed:
            # Machinery-fired rule: green verdicts from detectors that
            # never evaluated anything mean the harness failed to apply
            # coverage, not that the system holds.
            breaches.append(
                f"test-harness failure: soak passed with detectors "
                f"never armed: {unarmed}"
            )

    if budget.get("require_determinism", False):
        if not (report.get("kernel") or {}).get("determinism_ok"):
            breaches.append(
                "kernel series file is not replay-deterministic"
            )

    ceiling_s = budget.get("wall_ceiling_s")
    if ceiling_s is not None:
        wall = float(report.get("wall_s", 0.0))
        if wall > float(ceiling_s) * tol:
            breaches.append(
                f"wall {wall:g}s > ceiling {ceiling_s:g}s x{tol:g}"
            )

    return not breaches, breaches

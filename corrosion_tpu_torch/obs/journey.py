"""Kernel-plane write-journey reconstruction — no new traced code.

The kernel engines already emit everything needed to answer "where did
this write's simulated latency go" — they just emit it aggregated: the
per-round delivery-latency histogram (``vis_lat_b0..bN``, pairs that
became visible this round bucketed by commit-to-visible rounds), the
pending-queue backlog mass (``queue_backlog``), and the per-round
traffic (``msgs``). A recorded ``sim/trace.py`` workload says exactly
which writes committed in which round. This module inverts the two into
a per-write view:

- **commit round**: the write's trace-time bucket (the same arithmetic
  ``schedule_from_trace`` uses, so replayed schedules and reconstructed
  journeys can never disagree on round placement);
- **delivery-round profile**: visibility events at flight round ``t``
  in latency bucket ``b`` came from commits in rounds
  ``(t - hi_edge, t - lo_edge]``; each event mass is attributed across
  that window proportionally to how many writes the trace committed in
  each candidate round, then divided per write. Writes get an expected
  delivery count and a delivery-round distribution — a distributional
  reconstruction, exact in aggregate (the reconciliation total pins
  attributed + unattributed == observed events);
- **queue-dwell estimate**: Little's-law rounds of pending-queue
  residence at the write's commit round
  (``queue_backlog[r] / max(msgs[r], 1)``).

Unattributable mass (events whose whole commit window precedes the
trace, e.g. warm-up traffic) is reported, never silently dropped.

Counterpart of corrosion_tpu/obs/journey.py; the flight it reads is
the port's (``sim/telemetry.py``).
"""

from __future__ import annotations

JOURNEY_SCHEMA = "corro-write-journey/1"


def _trace_commit_rounds(trace, round_ms: float):
    """Per-event commit rounds + per-round write counts, using the exact
    ``schedule_from_trace`` bucketing arithmetic."""
    if not trace.events:
        raise ValueError("empty trace")
    if not round_ms > 0.0:
        raise ValueError(f"round_ms must be positive, got {round_ms}")
    events = sorted(trace.events)
    t0 = events[0][0]
    per_event = [
        (a, v, int((t - t0) // round_ms)) for t, a, v in events
    ]
    counts: dict[int, int] = {}
    for _a, _v, r in per_event:
        counts[r] = counts.get(r, 0) + 1
    return per_event, counts


def reconstruct_write_journeys(
    flight_path: str, trace, round_ms: float = 500.0,
    max_writes: int | None = None,
) -> dict:
    """Join a flight JSONL with a recorded write trace into the
    ``corro-write-journey/1`` dict. ``trace`` is a
    :class:`corrosion_tpu_torch.sim.trace.Trace` (or anything with a
    compatible ``events`` list)."""
    from corrosion_tpu_torch.sim.telemetry import (
        VIS_LAT_EDGES,
        VIS_LAT_KEYS,
        replay_flight,
    )

    curves, _chunks = replay_flight(flight_path)
    rounds = [int(r) for r in curves.get("round", [])]
    per_event, commit_counts = _trace_commit_rounds(trace, round_ms)

    def col(key):
        arr = curves.get(key)
        return (
            {r: float(arr[i]) for i, r in enumerate(rounds)}
            if arr is not None else {}
        )

    vis = {k: col(k) for k in VIS_LAT_KEYS if k in curves}
    backlog = col("queue_backlog")
    msgs = col("msgs")

    # Latency-bucket windows in rounds: bucket b covers commit-to-
    # visible latencies (lo_excl, hi] — b0 additionally admits latency 0
    # (visible the commit round itself).
    windows = []
    for b, _k in enumerate(VIS_LAT_KEYS):
        lo = 0 if b == 0 else VIS_LAT_EDGES[b - 1]
        hi = (
            VIS_LAT_EDGES[b]
            if b < len(VIS_LAT_EDGES)
            # Overflow: anything older, bounded by the record length.
            else (rounds[-1] + 1 if rounds else 0)
        )
        windows.append((lo, hi, b == 0))

    # Attribute each (visible-round, bucket) event mass across its
    # commit-round window, weighted by the trace's per-round write
    # counts. profile[c][t] = expected deliveries at round t for ALL
    # writes committed in round c.
    profile: dict[int, dict[int, float]] = {}
    total_events = attributed = 0.0
    for b, key in enumerate(VIS_LAT_KEYS):
        series = vis.get(key)
        if not series:
            continue
        lo, hi, incl_zero = windows[b]
        for t, count in series.items():
            if count <= 0:
                continue
            total_events += count
            c_lo = t - hi
            c_hi = t if incl_zero else t - lo - 1
            window = [
                c for c in range(c_lo, c_hi + 1) if commit_counts.get(c)
            ]
            weight = sum(commit_counts[c] for c in window)
            if weight <= 0:
                continue  # unattributable (pre-trace traffic)
            attributed += count
            for c in window:
                share = count * commit_counts[c] / weight
                profile.setdefault(c, {})[t] = (
                    profile.get(c, {}).get(t, 0.0) + share
                )

    writes_out = []
    for a, v, r in per_event[:max_writes] if max_writes else per_event:
        prof = profile.get(r, {})
        n_at_r = commit_counts[r]
        exp = sum(prof.values()) / n_at_r
        dist = {
            int(t): round(m / n_at_r, 4) for t, m in sorted(prof.items())
        }
        lat_mean = (
            sum((t - r) * m for t, m in prof.items())
            / sum(prof.values())
            if prof else None
        )
        writes_out.append({
            "actor": a[:8],
            "version": v,
            "commit_round": r,
            "expected_deliveries": round(exp, 4),
            "delivery_rounds": dist,
            "latency_rounds_mean": (
                round(lat_mean, 3) if lat_mean is not None else None
            ),
            "queue_dwell_rounds": round(
                backlog.get(r, 0.0) / max(msgs.get(r, 0.0), 1.0), 3
            ),
        })

    return {
        "schema": JOURNEY_SCHEMA,
        "round_ms": round_ms,
        "flight_rounds": len(rounds),
        "trace_writes": len(per_event),
        "writes": writes_out,
        "totals": {
            "vis_events": total_events,
            "attributed": round(attributed, 6),
            "unattributed": round(total_events - attributed, 6),
            "attribution_fraction": round(
                attributed / total_events, 5
            ) if total_events else None,
        },
    }

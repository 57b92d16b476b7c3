"""Open-loop arrival schedules.

A closed-loop generator (request, wait, request) measures the server's
latency only while the server is keeping up: once it saturates, the
generator itself slows down and the recorded tail silently excludes
exactly the requests that would have queued — coordinated omission. An
open-loop schedule fixes every arrival time up front; the runner fires
each request at its scheduled instant whether or not earlier ones have
completed, and latency is measured from the *scheduled* arrival. A
saturated server then shows up as it should: as latency, shed, or
timeout — never as a quietly thinner sample.

Schedules here are plain lists of :class:`Arrival` (seconds from run
start + ramp stage index), built deterministically so two runs of the
same scenario fire the identical workload.

Counterpart of corrosion_tpu/loadgen/schedule.py.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: offset from run start + ramp stage index."""

    t: float
    stage: int = 0


def open_loop(
    rate_hz: float,
    count: int,
    *,
    burst: int = 1,
    start: float = 0.0,
    stage: int = 0,
) -> list[Arrival]:
    """``count`` arrivals at ``rate_hz`` on a fixed grid from ``start``.

    ``burst`` groups arrivals: ``burst`` requests share one instant and
    instants are spaced ``burst / rate_hz`` apart, so the long-run rate
    is unchanged but at least ``burst`` requests are concurrently
    in-flight at each instant. The saturation sweep uses this to make
    load-shed engagement deterministic: a burst wider than the route's
    admission limit *must* shed, independent of service-time jitter.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    out: list[Arrival] = []
    for i in range(count):
        slot = i // burst
        out.append(Arrival(t=start + slot * burst / rate_hz, stage=stage))
    return out


def ramp(
    stages: list[tuple[float, float]], *, burst: int = 1
) -> list[Arrival]:
    """Concatenated open-loop stages: ``[(rate_hz, duration_s), ...]``.

    Each stage contributes ``round(rate * duration)`` arrivals tagged
    with its index; the saturation sweep ramps the rate past the route's
    capacity and reads per-stage shed/latency from the tags.
    """
    out: list[Arrival] = []
    t = 0.0
    for idx, (rate, duration) in enumerate(stages):
        n = max(1, round(rate * duration))
        out.extend(open_loop(rate, n, burst=burst, start=t, stage=idx))
        t += duration
    return out

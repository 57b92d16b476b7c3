"""Device time from a ``torch.profiler`` session, by profiler range.

A device event (kernel, copy or set) belongs to the ``record_function``
range in which the host launched it: its correlation id names the
runtime call that launched it, and that call's host timestamp falls
inside the range. The trace can lose a launch record (the profiler drops
some while a session starts); such an event is placed by its own start
only where the caller asks. Used by ``scripts/torch_round_profile.py``
(device time a plane).
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(prof) -> list:
    """The chrome-trace events of a finished profiler session (exported
    into a temporary directory under the working directory)."""
    with tempfile.TemporaryDirectory(dir=".") as td:
        trace = Path(td) / "trace.json"
        prof.export_chrome_trace(str(trace))
        return json.loads(trace.read_text())["traceEvents"]


def launch_times(events: list) -> dict:
    """Host timestamp of each runtime call, by correlation id."""
    return {
        e["args"]["correlation"]: e["ts"] for e in events
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
    }


def device_events_by_range(events: list, names, by_own_start: bool = False) -> list:
    """(range name or None, device event) for every device event, the
    name being that of the outermost ``names`` range holding its launch
    (the mixed engine's ``corro_chunks`` holds the chunk round's own
    ranges). An event
    whose launch record the trace lost has no range, unless
    ``by_own_start``: then the range holding its own start. That is sound
    only where every range waits for the card before it closes (as
    ``chip_smoke.py``'s timed runs do); where the host runs ahead of the
    card, a kernel often runs while a later range is open."""
    ranges = [
        (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
        if e.get("cat") == "user_annotation" and e.get("name") in names
    ]
    launch_ts = launch_times(events)
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None and by_own_start:
            ts = e["ts"]
        holding = [] if ts is None else [(s, n) for s, t, n in ranges if s <= ts <= t]
        plane = min(holding)[1] if holding else None
        out.append((plane, e))
    return out

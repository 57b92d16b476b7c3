"""Metric time-series recorder — the endurance plane's temporal half.

Every observability plane so far is point-in-time or per-run: /metrics
is a live scrape and reports summarize one bounded run. This module
records how a :class:`~corrosion_tpu_torch.utils.metrics.MetricsRegistry`
MOVES: periodic whole-registry snapshots (counters as monotonic
cumulatives, gauges as points, histograms as bucket vectors) streamed
to a self-describing ``corro-metric-series/1`` JSONL with the
FlightRecorder's rotation/resume contract (sim/telemetry.py):

- a ``{"kind": "series", "schema": ..., "segment": N}`` header per
  open, so a reader can refuse a future incompatible format;
- one flushed line per sample — a crashed run loses at most the
  in-flight line, and ``replay_series`` skips unparsable tails;
- rotation past ``max_bytes`` to ``path.N`` (oldest = ``.1``) with a
  resume-aware segment counter: ``mode="a"`` appends to an already-
  rotated record without renaming the live file over an old segment,
  ``mode="w"`` deletes stale segments so a fresh record never merges a
  previous run's chain into its replay.

Install points (both zero-cost when not installed — one ``is None``
branch, pinned like the chaos/prop axes):

- the agent runtime loop (``AgentConfig.metric_series_path``): one
  sample per runtime-metrics tick, wall-clock ``t``;
- ``KernelTelemetry`` chunk boundaries (``telemetry.series``): one
  sample per chunk with ``t`` = absolute round index, so a seeded run's
  series file is byte-reproducible.

Host code only: it imports no torch, so reading a recorded JSONL
does not pay the kernel import. The detectors over recorded series live in
:mod:`corrosion_tpu_torch.obs.endurance`. Counterpart of
corrosion_tpu/obs/series.py.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import IO

SERIES_SCHEMA = "corro-metric-series/1"

# Record kinds owned by the recorder itself; record_event refuses them
# so replay_series' row semantics cannot be spoofed (the FlightRecorder
# reserved-kind contract).
_RESERVED_KINDS = ("series", "sample")


def series_segments(path: str) -> list[str]:
    """Every file of a (possibly rotated) series record, oldest first:
    ``path.1``, ``path.2``, ..., then the live ``path``. Non-numeric
    suffixes are not segments. (The flight_segments contract, local so
    this module stays free of the simulator's imports.)"""
    segs = []
    for p in glob.glob(path + ".*"):
        sfx = p[len(path) + 1:]
        if sfx.isdigit():
            segs.append((int(sfx), p))
    out = [p for _n, p in sorted(segs)]
    if os.path.exists(path):
        out.append(path)
    return out


class MetricSeriesRecorder:
    """Streams typed registry snapshots to a corro-metric-series/1 JSONL.

    ``clock`` stamps samples (and the header) with wall time by default;
    pass ``clock=None`` for a fully deterministic record — the header
    carries no timestamp and every ``sample()`` must supply an explicit
    ``t`` (the kernel plane passes the absolute round index, so a seeded
    rerun reproduces the file byte for byte).

    **Idempotent installs**: open through :meth:`attach` wherever two
    installs can race the same path in one process — an agent relaunched
    in-process (hostchaos ``kill_restart``) whose previous life was
    hard-killed without closing adopts the live recorder instead of
    opening a second handle (no raise, no duplicate header, no
    double-sampling). ``close()`` is refcounted to match.
    """

    _live: dict[str, "MetricSeriesRecorder"] = {}
    _live_lock = threading.Lock()

    def __init__(
        self, path: str, source: str = "", mode: str = "a",
        max_bytes: int | None = None, clock=time.time,
    ):
        self.path = path
        self.source = source
        self.max_bytes = max_bytes
        self.clock = clock
        self._refs = 1
        self._seq = 0
        self._lock = threading.Lock()
        existing = series_segments(path)
        if mode == "w":
            # A truncating open starts a FRESH record: stale rotated
            # segments from a previous capped run at the same path must
            # not survive to be merged into this record's replay.
            for p in existing:
                if p != path:
                    os.remove(p)
            self._segment = 0
        else:
            # Resume-aware segment counter: appending to an already-
            # rotated record must not rename the live file over an old
            # segment.
            self._segment = max(
                (
                    int(p[len(path) + 1:]) for p in existing
                    if p != path
                ),
                default=0,
            )
        self._f: IO[str] | None = open(path, mode)
        self._write_header()

    @classmethod
    def attach(cls, path: str, **kw) -> "MetricSeriesRecorder":
        """Idempotent open: adopt the live recorder already holding
        ``path`` in this process (bumping its refcount) or open a new
        one. The install path for anything that can be re-installed —
        the agent runtime loop on relaunch, repeated harness wiring."""
        key = os.path.abspath(path)
        with cls._live_lock:
            rec = cls._live.get(key)
            if rec is not None and rec._f is not None:
                rec._refs += 1
                return rec
            rec = cls(path, **kw)
            cls._live[key] = rec
            return rec

    def _write_header(self) -> None:
        hdr = {
            "kind": "series", "schema": SERIES_SCHEMA, "version": 1,
            "source": self.source, "segment": self._segment,
        }
        if self.clock is not None:
            hdr["t_unix"] = self.clock()
        self._write(hdr)

    def _write(self, obj: dict) -> None:
        # Flush every record: a live `tail -f` (and the soak harness
        # reading mid-run) sees whole lines; only the final in-flight
        # line of a crash can be torn, and replay_series skips it.
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def sample(
        self, registry, t: float | None = None, exclude: tuple = (),
        extra: dict | None = None,
    ) -> dict:
        """Flush one whole-registry snapshot line. ``t`` defaults to
        ``clock()``; ``exclude`` drops series by NAME stem (labels
        ignored) — the kernel plane excludes its wall-clock chunk
        histogram so seeded reruns stay byte-identical. Returns the
        written record."""
        if self._f is None:
            raise ValueError("MetricSeriesRecorder is closed")
        if t is None:
            if self.clock is None:
                raise ValueError(
                    "clock-less (deterministic) recorder needs an "
                    "explicit t per sample"
                )
            t = self.clock()
        snap = registry.series_snapshot()
        if exclude:
            for fam in snap.values():
                for k in [
                    k for k in fam if k.split("{", 1)[0] in exclude
                ]:
                    del fam[k]
        with self._lock:
            obj = {"kind": "sample", "t": float(t), "seq": self._seq}
            obj.update(snap)
            if extra:
                obj["extra"] = extra
            self._seq += 1
            self._write(obj)
            if (
                self.max_bytes is not None
                and self._f.tell() >= self.max_bytes
            ):
                self._rotate()
        return obj

    def record_event(self, obj: dict) -> None:
        """Append one out-of-band event line (e.g. a scenario phase
        marker). The reserved kinds stay owned by the recorder."""
        if self._f is None:
            raise ValueError("MetricSeriesRecorder is closed")
        if obj.get("kind") in _RESERVED_KINDS:
            raise ValueError(
                f"record_event cannot write reserved kind "
                f"{obj.get('kind')!r}"
            )
        with self._lock:
            self._write(obj)

    def _rotate(self) -> None:
        """Roll the live file to ``path.N`` and open a fresh segment.
        Called only at sample boundaries (under the lock), so every
        segment holds whole samples and replays standalone."""
        self._f.close()
        self._segment += 1
        os.replace(self.path, f"{self.path}.{self._segment}")
        self._f = open(self.path, "w")
        self._write_header()

    def close(self) -> None:
        """Refcounted close: the file actually closes when the last
        attach() reference releases."""
        cls = type(self)
        with cls._live_lock:
            self._refs -= 1
            if self._refs > 0:
                return
            key = os.path.abspath(self.path)
            if cls._live.get(key) is self:
                del cls._live[key]
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricSeriesRecorder":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def replay_series(path: str) -> dict:
    """Rebuild ``{"headers", "samples", "events"}`` from a metric-series
    JSONL — including every rotated segment, oldest first. Crash-
    tolerant: unparsable lines (a write cut mid-line) are skipped. An
    incompatible schema raises instead of misparsing. Samples keep
    append order (the chain is chronological by construction)."""
    headers: list[dict] = []
    samples: list[dict] = []
    events: list[dict] = []
    segs = series_segments(path)
    if not segs:
        raise OSError(f"no metric-series record at {path}")
    for seg in segs:
        with open(seg) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue  # truncated tail from a crash — ignore
                kind = obj.get("kind")
                if kind == "series":
                    schema = obj.get("schema")
                    if schema != SERIES_SCHEMA:
                        raise ValueError(
                            f"{seg}: unsupported series schema "
                            f"{schema!r} (want {SERIES_SCHEMA})"
                        )
                    headers.append(obj)
                elif kind == "sample":
                    samples.append(obj)
                else:
                    events.append(obj)
    return {"headers": headers, "samples": samples, "events": events}


def series_values(
    samples: list[dict], name: str, family: str | None = None,
) -> tuple[list[float], list[float]]:
    """One series' ``(ts, values)`` by exact rendered name (labels
    included, e.g. ``corro_runtime_rss_bytes`` or
    ``corro_kernel_health_need_last{engine="dense"}``). Samples missing
    the series are skipped — a restarted life may register it late."""
    fams = (family,) if family else ("counters", "gauges")
    ts: list[float] = []
    vals: list[float] = []
    for s in samples:
        for fam in fams:
            v = s.get(fam, {}).get(name)
            if v is not None:
                ts.append(float(s["t"]))
                vals.append(float(v))
                break
    return ts, vals


def series_names(samples: list[dict], family: str) -> list[str]:
    """Every rendered name appearing in ``family`` across the samples,
    sorted (the detectors' discovery surface)."""
    names: set[str] = set()
    for s in samples:
        names.update(s.get(family, {}))
    return sorted(names)


def record_process_sample(
    recorder: MetricSeriesRecorder, registry, t: float | None = None,
    lag_s: float | None = None,
) -> None:
    """Set the process self-observability gauges from live /proc reads
    and flush one sample — the one sampling path `loadgen soak` and
    ad-hoc harnesses share with the agent runtime loop (which sets the
    same gauges each tick before sampling)."""
    from corrosion_tpu_torch.utils.metrics import (
        process_open_fds,
        process_rss_bytes,
        register_process_gauges,
    )

    rss_g, fds_g, lag_g = register_process_gauges(registry)
    rss = process_rss_bytes()
    if rss is not None:
        rss_g.set(rss)
    fds = process_open_fds()
    if fds is not None:
        fds_g.set(fds)
    if lag_s is not None:
        lag_g.set(lag_s)
    recorder.sample(registry, t=t)

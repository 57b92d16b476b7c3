"""Metrics facade + Prometheus text exposition.

The reference uses the `metrics` crate with a Prometheus exporter (custom
histogram buckets 1 ms-60 s, corrosion/src/command/agent.rs:65-85) and ~45
documented series (doc/telemetry/prometheus.md). This module provides the
same shape: process-local registries of counters/gauges/histograms with
label sets, rendered in the Prometheus text format, served by a tiny
asyncio HTTP endpoint when `[telemetry] prometheus_addr` is configured.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from dataclasses import dataclass, field

# command/agent.rs:70-80: 1 ms … 60 s
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Label-cardinality cap per metric (registry-created metrics only).
# Per-peer series (corro_peer_breaker_trips_total{addr=...}) grow one
# labelset per address forever, so under churn+relaunch soaks the
# registry itself leaks; past the cap, NEW labelsets fold into an
# `other` overflow bucket and corro_metrics_labelsets_dropped_total
# counts the folded samples. 64 is an order of magnitude above any
# legitimate labelset count in this codebase (routes, engines, planes).
DEFAULT_MAX_LABELSETS = 64


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _overflow_key(key: tuple) -> tuple:
    """The `other` bucket for a folded labelset: same label NAMES, every
    value replaced — the series keeps its shape for scrapers while the
    value-space cardinality stays bounded."""
    return tuple((k, "other") for k, _v in key)


def _admit_key(key: tuple, container: dict, max_labelsets) -> tuple[tuple, bool]:
    """Storage key for ``key`` under the cardinality cap (call holding
    the metric's lock). Existing labelsets always pass; a NEW one past
    the cap folds into the overflow bucket. Returns (key, folded)."""
    if (
        not key
        or max_labelsets is None
        or key in container
        or len(container) < max_labelsets
    ):
        return key, False
    return _overflow_key(key), True


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


@dataclass
class Counter:
    name: str
    help: str = ""
    max_labelsets: int | None = None
    on_fold: object = None  # callable, invoked OUTSIDE the lock
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            key, folded = _admit_key(key, self._values, self.max_labelsets)
            self._values[key] = self._values.get(key, 0.0) + value
        if folded and self.on_fold is not None:
            self.on_fold()

    def get(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def render(self) -> list[str]:
        out = [f"# TYPE {self.name} counter"]
        if self.help:
            out.insert(0, f"# HELP {self.name} {self.help}")
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        if len(out) <= (2 if self.help else 1):
            out.append(f"{self.name} 0")
        return out


@dataclass
class Gauge:
    name: str
    help: str = ""
    max_labelsets: int | None = None
    on_fold: object = None
    _values: dict[tuple, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def set(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            key, folded = _admit_key(key, self._values, self.max_labelsets)
            self._values[key] = float(value)
        if folded and self.on_fold is not None:
            self.on_fold()

    def add(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            key, folded = _admit_key(key, self._values, self.max_labelsets)
            self._values[key] = self._values.get(key, 0.0) + value
        if folded and self.on_fold is not None:
            self.on_fold()

    def get(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def render(self) -> list[str]:
        out = [f"# TYPE {self.name} gauge"]
        if self.help:
            out.insert(0, f"# HELP {self.name} {self.help}")
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        if len(out) <= (2 if self.help else 1):
            out.append(f"{self.name} 0")
        return out


@dataclass
class Histogram:
    name: str
    help: str = ""
    buckets: tuple = DEFAULT_BUCKETS
    max_labelsets: int | None = None
    on_fold: object = None
    _counts: dict[tuple, list] = field(default_factory=dict)
    _sums: dict[tuple, float] = field(default_factory=dict)
    _totals: dict[tuple, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            key, folded = _admit_key(key, self._totals, self.max_labelsets)
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
        if folded and self.on_fold is not None:
            self.on_fold()

    def count(self, **labels: str) -> int:
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def quantile(self, q: float, **labels: str) -> float:
        """Approximate quantile from bucket counts (diagnostics).

        Interpolates linearly WITHIN the winning bucket (Prometheus'
        histogram_quantile rule) instead of returning its upper bound —
        the latter biased p50/p99 up by as much as one bucket width.
        Observations beyond the last bucket still report +inf.
        """
        key = _label_key(labels)
        with self._lock:
            total = self._totals.get(key, 0)
            if total == 0:
                return float("nan")
            counts = list(self._counts[key])
        target = q * total
        for i, b in enumerate(self.buckets):
            if counts[i] >= target:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                below = counts[i - 1] if i > 0 else 0
                in_bucket = counts[i] - below
                if in_bucket <= 0:
                    return lo
                frac = (target - below) / in_bucket
                return lo + frac * (b - lo)
        return float("inf")

    def render(self) -> list[str]:
        out = [f"# TYPE {self.name} histogram"]
        if self.help:
            out.insert(0, f"# HELP {self.name} {self.help}")
        # Snapshot under the lock so a concurrent observe() can neither
        # resize the dicts mid-iteration nor tear a bucket/sum/count trio.
        with self._lock:
            snap = [
                (key, list(self._counts[key]), self._sums[key],
                 self._totals[key])
                for key in sorted(self._totals)
            ]
        for key, counts, total_sum, total in snap:
            for i, b in enumerate(self.buckets):
                lk = key + (("le", f"{b:g}"),)
                out.append(
                    f"{self.name}_bucket{_fmt_labels(lk)} {counts[i]}"
                )
            lk = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lk)} {total}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {total_sum:g}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {total}")
        return out


class MetricsRegistry:
    """Per-agent metric registry (the `metrics` facade role).

    Registration is get-or-create BY NAME and type-checked: re-requesting
    an existing series returns the same object (so re-registration on an
    in-process agent relaunch is idempotent), while re-requesting it as
    a different metric kind raises instead of handing back an object
    whose API the caller will misuse. Registry-created metrics carry the
    label-cardinality cap (``max_labelsets``); samples folded into the
    `other` overflow bucket tick ``corro_metrics_labelsets_dropped_total``.
    """

    def __init__(self, max_labelsets: int | None = DEFAULT_MAX_LABELSETS):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()
        self.max_labelsets = max_labelsets
        self._labelsets_dropped = self.counter(
            "corro_metrics_labelsets_dropped_total",
            "samples folded into the `other` overflow labelset by the "
            "label-cardinality cap",
        )

    def _note_fold(self) -> None:
        self._labelsets_dropped.inc()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(
            name, Counter,
            lambda: Counter(
                name, help, max_labelsets=self.max_labelsets,
                on_fold=self._note_fold,
            ),
        )

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(
            name, Gauge,
            lambda: Gauge(
                name, help, max_labelsets=self.max_labelsets,
                on_fold=self._note_fold,
            ),
        )

    def histogram(
        self, name: str, help: str = "", buckets: tuple = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get(
            name, Histogram,
            lambda: Histogram(
                name, help, buckets, max_labelsets=self.max_labelsets,
                on_fold=self._note_fold,
            ),
        )

    def _get(self, name: str, kind: type, mk):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = mk()
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} is already registered as a "
                    f"{type(m).__name__}, not a {kind.__name__}"
                )
            return m

    def render(self) -> str:
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Flat dict for the admin RPC / tests."""
        out: dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, (Counter, Gauge)):
                with m._lock:
                    items = list(m._values.items())
                for key, v in items:
                    out[name + _fmt_labels(key)] = v
            elif isinstance(m, Histogram):
                with m._lock:
                    items = [
                        (key, t, m._sums[key])
                        for key, t in m._totals.items()
                    ]
                for key, t, s in items:
                    out[name + "_count" + _fmt_labels(key)] = t
                    out[name + "_sum" + _fmt_labels(key)] = s
        return out

    def series_snapshot(self) -> dict:
        """Typed whole-registry snapshot for the endurance plane's
        MetricSeriesRecorder (obs/series.py): counters and gauges as
        ``{rendered_name: value}``, histograms as bucket VECTORS — the
        flat ``snapshot()`` collapses them to ``_count``/``_sum``, which
        loses the distribution the SLO burn-rate windows need. Each
        metric is read under its own lock so a bucket/sum/total trio can
        never tear; cross-metric skew is bounded by one sampling pass."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Counter):
                with m._lock:
                    items = list(m._values.items())
                for key, v in items:
                    out["counters"][name + _fmt_labels(key)] = v
            elif isinstance(m, Gauge):
                with m._lock:
                    items = list(m._values.items())
                for key, v in items:
                    out["gauges"][name + _fmt_labels(key)] = v
            elif isinstance(m, Histogram):
                with m._lock:
                    snap = [
                        (key, list(m._counts[key]), m._sums[key],
                         m._totals[key])
                        for key in sorted(m._totals)
                    ]
                for key, counts, s, t in snap:
                    out["histograms"][name + _fmt_labels(key)] = {
                        "le": [float(b) for b in m.buckets],
                        "counts": counts,
                        "sum": s,
                        "count": t,
                    }
        return out


async def serve_prometheus(
    registry: MetricsRegistry, host: str, port: int
) -> tuple[asyncio.AbstractServer, tuple[str, int]]:
    """Minimal GET /metrics endpoint (setup_prometheus, command/agent.rs:65)."""

    async def on_conn(reader: asyncio.StreamReader, writer):
        try:
            line = await reader.readline()
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            # Parse the request line properly: "METHOD SP PATH SP VERSION".
            # Substring matching (`b"/metrics" in line`) accepted any URL
            # merely containing "metrics".
            parts = line.split()
            method = parts[0] if len(parts) >= 1 else b""
            path = parts[1].split(b"?", 1)[0] if len(parts) >= 2 else b""
            ok = method == b"GET" and path in (b"/metrics", b"/")
            body = registry.render().encode() if ok else b""
            status = (
                b"HTTP/1.1 200 OK\r\n" if ok else b"HTTP/1.1 404 Not Found\r\n"
            )
            writer.write(
                status
                + b"content-type: text/plain; version=0.0.4\r\n"
                + f"content-length: {len(body)}\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(on_conn, host, port)
    sock = server.sockets[0].getsockname()
    return server, (sock[0], sock[1])


def process_rss_bytes() -> int | None:
    """Resident set size of this process, or None where unknowable.
    /proc is authoritative on Linux; the resource fallback (macOS)
    reports ru_maxrss (peak, in bytes there) — close enough for a
    soak-growth signal."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except Exception:
        return None


def process_open_fds() -> int | None:
    """Open file descriptors of this process (None where /proc-less and
    uncountable). The serving plane is FD-bound — one client + one
    server socket per subscription — so fd growth is the leak signal
    hours-long soaks need."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def process_stats() -> dict:
    """One self-observability sample: RSS + open-fd count, JSON-ready.
    Event-loop lag is measured where a loop runs (the agent's runtime
    metrics loop exports it; soak reports record how long their
    synchronous kernel sections held the loop)."""
    return {
        "rss_bytes": process_rss_bytes(),
        "open_fds": process_open_fds(),
    }


def register_process_gauges(registry: "MetricsRegistry") -> tuple:
    """Create the process self-observability gauges on ``registry``:
    ``corro_runtime_rss_bytes``, ``corro_runtime_open_fds``, and
    ``corro_runtime_loop_lag_last_seconds`` (the most recent event-loop
    wakeup lag — the gauge companion of the existing
    ``corro_runtime_loop_lag_seconds`` histogram). Returns the three
    gauges; the caller's sampling loop sets them.

    Idempotent: registration is get-or-create by name, so calling this
    again (an agent relaunched in the same process, a second recorder
    install) returns the SAME gauge objects — no raise, no duplicate
    series, no double-sampling."""
    return (
        registry.gauge(
            "corro_runtime_rss_bytes", "process resident set size"
        ),
        registry.gauge(
            "corro_runtime_open_fds", "open file descriptors"
        ),
        registry.gauge(
            "corro_runtime_loop_lag_last_seconds",
            "most recent event-loop wakeup lag sample",
        ),
    )


class StepTimer:
    """Wall-clock section timer feeding a histogram (tokio-metrics role)."""

    def __init__(self, hist: Histogram, **labels: str) -> None:
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0, **self.labels)
        return False

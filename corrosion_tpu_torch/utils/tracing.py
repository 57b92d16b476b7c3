"""Span tracing with cross-node propagation.

The reference instruments everything with `tracing` spans and exports OTLP
(corrosion/src/main.rs:64-117); sync sessions carry W3C traceparent inside
the wire protocol (SyncTraceContextV1, corro-types/src/sync.rs:32-67,
injected peer.rs:941-944, extracted peer.rs:1296-1298). This module is the
in-process analogue: explicit span context managers backed by contextvars,
a bounded in-memory ring of finished spans, optional JSON-lines file
export, an optional batched OTLP/JSON exporter POSTing to a collector's
``/v1/traces`` (the `main.rs` OTLP pipeline's role), and W3C traceparent
strings for carrying trace context across agents in sync frames.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "corro_current_span", default=None
)


@dataclass
class Span:
    tracer: "Tracer"
    name: str
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    parent_id: str | None
    attrs: dict = field(default_factory=dict)
    start_ns: int = 0
    end_ns: int = 0
    _token: object = None

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self.start_ns = time.time_ns()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        if exc_type is not None:
            self.attrs["error"] = repr(exc)
        _current_span.reset(self._token)
        self.tracer._record(self)
        return False

    def start(self) -> "Span":
        """Begin timing WITHOUT becoming the ambient span. For batched
        span sets whose lifetimes overlap non-LIFO (the ingest loop opens
        one span per changeset in a batch and closes them all after the
        flush) — contextvar tokens must reset LIFO, so the context
        manager cannot model that shape. Pair with :meth:`finish`."""
        self.start_ns = time.time_ns()
        return self

    def finish(self) -> None:
        self.end_ns = time.time_ns()
        self.tracer._record(self)

    @property
    def traceparent(self) -> str:
        """W3C traceparent header value (version 00, sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_json_obj(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            # Which agent emitted this span — the timeline correlator
            # separates same-trace spans from different cluster members
            # by it (OTLP carries it at the resource level instead).
            "service": self.tracer.service if self.tracer else None,
            "start_ns": self.start_ns,
            "duration_us": (self.end_ns - self.start_ns) // 1000,
            "attrs": self.attrs,
        }


def spans_to_otlp(service: str, spans: list[dict]) -> dict:
    """Batch finished spans into an OTLP/JSON ExportTraceServiceRequest
    (the shape `main.rs:64-117`'s OTLP pipeline emits: resourceSpans →
    scopeSpans → spans with hex ids, unix-nano times, and key-value
    attributes) so any OTLP/HTTP collector ingests the file or POST body
    as-is."""
    return {
        "resourceSpans": [{
            "resource": {
                "attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": service},
                }],
            },
            "scopeSpans": [{
                "scope": {"name": "corrosion-tpu"},
                "spans": [
                    {
                        "traceId": s["trace_id"],
                        "spanId": s["span_id"],
                        **(
                            {"parentSpanId": s["parent_id"]}
                            if s.get("parent_id") else {}
                        ),
                        "name": s["name"],
                        "kind": 1,  # SPAN_KIND_INTERNAL
                        "startTimeUnixNano": str(s["start_ns"]),
                        "endTimeUnixNano": str(
                            s["start_ns"] + s["duration_us"] * 1000
                        ),
                        "attributes": [
                            {"key": k, "value": {"stringValue": str(v)}}
                            for k, v in s.get("attrs", {}).items()
                        ],
                    }
                    for s in spans
                ],
            }],
        }],
    }


def trace_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic trace-id-keyed sampling decision.

    Hash-based (the first 8 hex chars of the trace id against the rate),
    not random-per-call: every hop of a multi-hop write chain — and every
    agent of a cluster — makes the SAME keep/drop decision for a given
    trace without propagating a sampled flag, so a kept trace is kept
    end-to-end and a dropped one costs nothing anywhere. The W3C
    tail-sampling consistency trick; rate 1.0 keeps everything, 0.0
    drops everything.
    """
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) < rate * 0x100000000


class Tracer:
    """Per-agent tracer: bounded finished-span ring + optional export.

    ``export_path`` appends one JSON object per span; with
    ``otlp_endpoint`` set, a single long-lived worker thread batches
    finished spans (256 spans or 5 s idle, whichever first — the
    reference's batch exporter, main.rs:103-109) and POSTs OTLP/JSON to
    ``<endpoint>/v1/traces``; close() drains the queue so shutdown never
    drops buffered spans.

    ``sample`` (0.0–1.0) gates :meth:`maybe_span` by trace id
    (``trace_sampled``): high-rate span sources (the write path under a
    2k-subscription storm) thin deterministically and consistently
    across hops. Explicit :meth:`span` calls always record — sampling is
    opt-in per call site."""

    OTLP_BATCH = 256
    OTLP_FLUSH_S = 5.0

    def __init__(
        self, service: str = "corrosion-tpu", capacity: int = 4096,
        export_path: str | None = None, otlp_endpoint: str | None = None,
        sample: float = 1.0,
    ) -> None:
        import queue

        self.service = service
        self.sample = sample
        self.finished: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._export_path = export_path
        self._export_f = None
        self._otlp_endpoint = otlp_endpoint
        self.otlp_export_errors = 0
        self._otlp_q: "queue.Queue | None" = None
        self._otlp_thread: threading.Thread | None = None
        if otlp_endpoint is not None:
            self._otlp_q = queue.Queue(maxsize=10240)
            self._otlp_thread = threading.Thread(
                target=self._otlp_worker, daemon=True
            )
            self._otlp_thread.start()

    def _otlp_worker(self) -> None:
        import queue

        batch: list[dict] = []
        while True:
            try:
                # Read per-iteration: tests shrink the flush window live.
                item = self._otlp_q.get(timeout=self.OTLP_FLUSH_S or 0.05)
            except queue.Empty:
                if batch:
                    self._otlp_post(batch)
                    batch = []
                continue
            if item is None:  # close sentinel: drain and exit
                if batch:
                    self._otlp_post(batch)
                return
            batch.append(item)
            if len(batch) >= self.OTLP_BATCH:
                self._otlp_post(batch)
                batch = []

    def _otlp_post(self, batch: list[dict]) -> None:
        import urllib.request

        body = json.dumps(
            spans_to_otlp(self.service, batch), default=str
        ).encode()
        req = urllib.request.Request(
            self._otlp_endpoint.rstrip("/") + "/v1/traces",
            data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=5).read()
        except Exception:
            # Collectors come and go; drop the batch. Only the worker
            # thread touches this counter.
            self.otlp_export_errors += 1

    def span(self, name: str, traceparent: str | None = None, **attrs) -> Span:
        """Open a span. Parentage: explicit ``traceparent`` (remote
        continuation) > ambient current span > fresh trace."""
        parent = _current_span.get()
        if traceparent is not None:
            ctx = parse_traceparent(traceparent)
            trace_id = ctx[0] if ctx else os.urandom(16).hex()
            parent_id = ctx[1] if ctx else None
        elif parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        else:
            trace_id = os.urandom(16).hex()
            parent_id = None
        return Span(
            tracer=self,
            name=name,
            trace_id=trace_id,
            span_id=os.urandom(8).hex(),
            parent_id=parent_id,
            attrs=dict(attrs),
        )

    def maybe_span(
        self, name: str, traceparent: str | None = None, **attrs
    ) -> Span | None:
        """Sampled :meth:`span`: resolve the trace id exactly as span()
        would (explicit remote parent > ambient parent > fresh trace),
        then return None when the trace is not kept at this tracer's
        ``sample`` rate. Callers guard with ``if span is not None`` —
        an unsampled write allocates no Span at all."""
        parent = _current_span.get()
        if traceparent is not None:
            ctx = parse_traceparent(traceparent)
            trace_id = ctx[0] if ctx else os.urandom(16).hex()
            parent_id = ctx[1] if ctx else None
        elif parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        else:
            trace_id = os.urandom(16).hex()
            parent_id = None
        # Decide on the id the span will actually CARRY (a fresh root's
        # random id included): downstream hops re-check the propagated
        # id, so deciding on any other value would let a kept root's
        # children drop mid-chain.
        if not trace_sampled(trace_id, self.sample):
            return None
        return Span(
            tracer=self,
            name=name,
            trace_id=trace_id,
            span_id=os.urandom(8).hex(),
            parent_id=parent_id,
            attrs=dict(attrs),
        )

    def current_traceparent(self) -> str | None:
        span = _current_span.get()
        return span.traceparent if span is not None else None

    def _record(self, span: Span) -> None:
        obj = span.to_json_obj() if (
            self._export_path is not None or self._otlp_q is not None
        ) else None
        # Open the export file OUTSIDE the lock (first record only): disk
        # I/O under the tracer lock would stall every span-finishing
        # thread behind one slow open (corro lint CT020). Double-checked:
        # a losing racer closes its handle.
        opened = None
        if self._export_path is not None and self._export_f is None:
            opened = open(self._export_path, "a")
        with self._lock:
            self.finished.append(span)
            if opened is not None:
                if self._export_f is None:
                    self._export_f = opened
                else:
                    opened.close()
            if self._export_f is not None:
                self._export_f.write(json.dumps(obj, default=str) + "\n")
                self._export_f.flush()
        if self._otlp_q is not None:
            try:
                self._otlp_q.put_nowait(obj)
            except Exception:
                self.otlp_export_errors += 1  # queue full: shed

    def recent(self, limit: int = 100, name: str | None = None) -> list[dict]:
        with self._lock:
            spans = list(self.finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return [s.to_json_obj() for s in spans[-limit:]]

    def close(self) -> None:
        if self._export_f is not None:
            self._export_f.close()
            self._export_f = None
        if self._otlp_q is not None:
            self._otlp_q.put(None)  # drain sentinel
            self._otlp_thread.join(timeout=5.0)
            self._otlp_q = None
            self._otlp_thread = None


def current_span() -> "Span | None":
    """The calling context's ambient span, if any — the guard fan-out
    instrumentation uses to attach only inside an already-traced write
    instead of minting noise root traces."""
    return _current_span.get()


def parse_traceparent(value: str) -> tuple[str, str] | None:
    """(trace_id, span_id) from a W3C traceparent, or None if malformed."""
    parts = value.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id

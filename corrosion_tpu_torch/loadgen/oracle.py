"""Fan-out correctness oracle.

The subscription plane's contract (agent/subs.py, mirroring the
reference's Matcher): every committed transaction that matches a live
subscription's query is delivered to every attached stream **exactly
once**, with **monotonically increasing change ids** per stream, either
as a live change event or — for commits that raced the stream's attach —
inside the initial snapshot. The oracle checks that contract while the
load generator is deliberately trying to break it, so a loadgen run is a
robustness test, not just a benchmark.

Commits are registered by the write path as ``(key, payload)`` pairs
(each generated write uses a fresh primary key and a unique payload, so
identity is unambiguous); streams report snapshot rows and change events
as they arrive. A commit acked *after* a stream finished its snapshot
(the end-of-query frame) MUST eventually reach that stream; commits that
raced the attach may arrive via snapshot instead. Violations recorded:

- ``duplicate``: a stream saw the same committed row as a change event
  twice (replay overlap after reconnect, listener-queue double-publish);
- ``non_monotonic``: a change id on a stream failed to strictly
  increase;
- ``missing`` (at :meth:`finish`): an expected delivery never arrived
  within the drain window — a silently dropped event.

Delivery lag (commit-ack to event-receipt) feeds a shared
``utils.metrics.Histogram`` so fan-out percentiles ride the same bucket
machinery as every other latency surface.

Counterpart of corrosion_tpu/loadgen/oracle.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from corrosion_tpu_torch.utils.metrics import Histogram

# Fan-out lag buckets: 1 ms .. 30 s (finer low end than the default
# request buckets — loopback fan-out sits in single-digit ms).
LAG_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


@dataclass
class _Commit:
    key: object
    payload: object
    t_ack: float
    group: int | None = None
    # Causal-trace join keys (traced runs only): the client-minted trace
    # id this write's HTTP request carried, and wall-clock send/ack
    # times in the same epoch domain as the agent's span export — the
    # obs timeline correlator joins spans <-> commits <-> deliveries on
    # (trace_id, key). t_send_mono is the monotonic-clock send time
    # (same clock as t_ack): the correlator's reconciliation measures
    # the wall on the monotonic domain so the epoch-derived stage sum
    # has an INDEPENDENT measurement to answer to.
    trace_id: str | None = None
    t_send_wall: float | None = None
    t_ack_wall: float | None = None
    t_send_mono: float | None = None


@dataclass
class _Stream:
    sid: int
    group: int | None = None
    label: str = ""
    attached_t: float | None = None  # end-of-snapshot time; None = pending
    last_change_id: int | None = None
    seen_change: dict = field(default_factory=dict)  # (key, payload) -> cid
    seen_snapshot: set = field(default_factory=set)
    reconnects: int = 0


class FanoutOracle:
    """Tracks commits vs per-stream deliveries; see module docstring."""

    def __init__(self, registry=None, keep_deliveries: bool = False) -> None:
        """``keep_deliveries`` retains one record per observed delivery
        (stream, key, change id, wall time) for the obs timeline
        correlator — off by default, a 2k-stream storm's 40k deliveries
        should not be held unless a traced run asked for them."""
        self._commits: dict[tuple, _Commit] = {}
        self._streams: dict[int, _Stream] = {}
        self.keep_deliveries = keep_deliveries
        self.delivery_log: list[dict] = []
        # Deliveries observed BEFORE their commit registered: fan-out
        # regularly beats the writer's own HTTP ack (the matcher pushes
        # to listener queues before the execute response is written), so
        # lag resolves when commit() arrives — clamped at 0.
        self._early_deliveries: dict[tuple, list[float]] = {}
        self._next_sid = 0
        self.violations: list[str] = []
        self.lag_hist = (
            registry.histogram(
                "loadgen_fanout_lag_seconds",
                "commit-ack to subscription-event delivery lag",
                buckets=LAG_BUCKETS,
            )
            if registry is not None
            else Histogram(
                "loadgen_fanout_lag_seconds",
                "commit-ack to subscription-event delivery lag",
                buckets=LAG_BUCKETS,
            )
        )
        self.lag_max_s = 0.0
        self.delivered_changes = 0
        self.delivered_snapshot = 0

    # -- write side ----------------------------------------------------------

    def commit(
        self, key, payload, t_ack: float, group: int | None = None,
        trace_id: str | None = None, t_send_wall: float | None = None,
        t_ack_wall: float | None = None, t_send_mono: float | None = None,
    ) -> None:
        """Register an acked transaction. ``group`` partitions commits
        onto the subscription group whose query matches them (None =
        matches every stream). Traced runs also pass the write's
        ``trace_id`` and wall/monotonic send/ack times (see _Commit)."""
        k = (key, payload)
        if k in self._commits:
            raise ValueError(f"commit {k} registered twice by the harness")
        self._commits[k] = _Commit(
            key, payload, t_ack, group,
            trace_id=trace_id, t_send_wall=t_send_wall,
            t_ack_wall=t_ack_wall, t_send_mono=t_send_mono,
        )
        for t in self._early_deliveries.pop(k, ()):
            lag = max(0.0, t - t_ack)
            self.lag_hist.observe(lag)
            self.lag_max_s = max(self.lag_max_s, lag)

    def committed(self) -> dict:
        """Acked commits as ``{key: payload}`` — the ground-truth row
        set a converged cluster must contain (the host chaos harness's
        serial-merge analogue)."""
        return {c.key: c.payload for c in self._commits.values()}

    # -- subscription side ---------------------------------------------------

    def attach_stream(
        self, group: int | None = None, label: str = ""
    ) -> int:
        """Register a stream; returns its oracle id. The stream stays in
        "attaching" state (no delivery obligations yet) until
        :meth:`snapshot_done`."""
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = _Stream(sid=sid, group=group, label=label)
        return sid

    def snapshot_done(self, sid: int, t: float) -> None:
        """The stream received its end-of-query frame: from here on,
        every commit acked at or after ``t`` is an obligation."""
        st = self._streams[sid]
        if st.attached_t is None:
            st.attached_t = t

    def snapshot_row(
        self, sid: int, key, payload, t_wall: float | None = None
    ) -> None:
        """A row in the initial snapshot (or a snapshot-restart replay
        after deep reconnect). Set semantics: snapshot re-sends of the
        same row are not duplicates."""
        self._streams[sid].seen_snapshot.add((key, payload))
        self.delivered_snapshot += 1
        if self.keep_deliveries and t_wall is not None:
            self.delivery_log.append({
                "kind": "snapshot", "sid": sid, "key": key,
                "t_wall": t_wall,
            })

    def change(
        self, sid: int, kind: str, key, payload, change_id: int, t: float,
        t_wall: float | None = None,
    ) -> None:
        """A live change event on a stream."""
        st = self._streams[sid]
        if self.keep_deliveries and t_wall is not None:
            self.delivery_log.append({
                "kind": "change", "sid": sid, "key": key,
                "change_id": change_id, "t_wall": t_wall, "t_mono": t,
            })
        if st.last_change_id is not None and change_id <= st.last_change_id:
            self.violations.append(
                f"non_monotonic: stream {sid}{st.label and f' ({st.label})'} "
                f"change_id {change_id} after {st.last_change_id}"
            )
        st.last_change_id = change_id
        k = (key, payload)
        if k in st.seen_change:
            self.violations.append(
                f"duplicate: stream {sid}{st.label and f' ({st.label})'} "
                f"saw {k} as change twice (cid {st.seen_change[k]} then "
                f"{change_id})"
            )
            return
        st.seen_change[k] = change_id
        self.delivered_changes += 1
        c = self._commits.get(k)
        if c is not None:
            lag = max(0.0, t - c.t_ack)
            self.lag_hist.observe(lag)
            self.lag_max_s = max(self.lag_max_s, lag)
        else:
            self._early_deliveries.setdefault(k, []).append(t)

    def reconnected(self, sid: int) -> None:
        self._streams[sid].reconnects += 1

    # -- correlator export ---------------------------------------------------

    def delivery_records(self) -> dict:
        """The obs timeline correlator's input: every registered commit
        (with its trace id + wall send/ack times when the run was
        traced) and — with ``keep_deliveries`` — every observed delivery
        wall-timestamped. Keys must be JSON-scalar for the artifact (the
        loadgen scenarios use integer row ids)."""
        return {
            "writes": [
                {
                    "key": c.key,
                    "group": c.group,
                    "trace_id": c.trace_id,
                    "t_send_wall": c.t_send_wall,
                    "t_ack_wall": c.t_ack_wall,
                    "t_send_mono": c.t_send_mono,
                    # Monotonic ack time is exported unconditionally: the
                    # serving-cost join measures per-delivery lag against
                    # it even on untraced runs (the correlator still
                    # guards on t_send_mono for its reconciliation).
                    "t_ack_mono": c.t_ack,
                }
                for c in self._commits.values()
            ],
            "deliveries": list(self.delivery_log),
            # Per-stream identity + delivered mass: the serving-cost
            # report reconciles each subscription handle's ledger against
            # exactly these counts.
            "streams": [
                {
                    "sid": st.sid,
                    "group": st.group,
                    "label": st.label,
                    "delivered_changes": len(st.seen_change),
                    "delivered_snapshot": len(st.seen_snapshot),
                    "reconnects": st.reconnects,
                }
                for st in self._streams.values()
            ],
        }

    # -- verdict -------------------------------------------------------------

    def _expected(self, st: _Stream):
        """Commits this stream is obliged to deliver: matching group,
        acked after the stream's snapshot completed."""
        if st.attached_t is None:
            return
        for k, c in self._commits.items():
            if c.group is not None and st.group is not None \
                    and c.group != st.group:
                continue
            if c.t_ack >= st.attached_t:
                yield k

    def pending(self, limit: int | None = None) -> int:
        """Outstanding (stream, commit) obligations — the drain loop
        polls this to zero before declaring a scenario done. ``limit``
        short-circuits the count (the drain loop only needs "any?", and
        a 2k-stream storm makes the full scan non-trivial)."""
        n = 0
        for st in self._streams.values():
            for k in self._expected(st):
                if k not in st.seen_change and k not in st.seen_snapshot:
                    n += 1
                    if limit is not None and n >= limit:
                        return n
        return n

    def finish(self, max_examples: int = 8) -> dict:
        """Final verdict. Converts any still-missing obligation into a
        ``missing`` violation and returns the oracle block of the
        serving report."""
        missing = 0
        for st in self._streams.values():
            for k in self._expected(st):
                if k not in st.seen_change and k not in st.seen_snapshot:
                    missing += 1
                    if missing <= max_examples:
                        self.violations.append(
                            f"missing: stream {st.sid}"
                            f"{st.label and f' ({st.label})'} never saw {k}"
                        )
        if missing > max_examples:
            self.violations.append(
                f"missing: ... and {missing - max_examples} more"
            )
        lag_count = self.lag_hist.count()

        def q_ms(q: float) -> float:
            # Observations past the last bucket interpolate to +inf;
            # clamp to the exactly-tracked max so the report stays
            # strict-JSON and never overstates beyond what was measured.
            return round(
                min(self.lag_hist.quantile(q), self.lag_max_s) * 1000.0, 3
            )

        return {
            "streams": len(self._streams),
            "commits": len(self._commits),
            "delivered_changes": self.delivered_changes,
            "delivered_snapshot": self.delivered_snapshot,
            "reconnects": sum(
                s.reconnects for s in self._streams.values()
            ),
            "violations": len(self.violations),
            "violation_examples": self.violations[:max_examples],
            "missing": missing,
            "fanout_lag_ms": {
                "count": lag_count,
                "p50": q_ms(0.50) if lag_count else None,
                "p90": q_ms(0.90) if lag_count else None,
                "p99": q_ms(0.99) if lag_count else None,
                "max": round(self.lag_max_s * 1000.0, 3),
            },
        }

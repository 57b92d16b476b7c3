"""The calibrated round-length model (``corro-round-model/1``).

Every kernel number this repo publishes rests on one identification: one
round-synchronous simulator step ≙ ``round_ms`` of the reference's
event-driven, jitter-timed reality (500 ms, the broadcast flush tick,
broadcast/mod.rs:373). SURVEY.md's open "hard part (b)" is that nothing
ever VALIDATED that identification. This module derives the
identification from measured signals instead of assuming it:

- **the broadcast flush tick** (the live agent's configured
  ``broadcast_interval`` — the cadence at which committed writes actually
  leave the node);
- **per-region-pair RTT distributions**, either as raw probe samples
  (live calibration actively pings through the real SWIM UDP plane, like
  ``scripts/transport_characterization.py``) or as **ring occupancy** —
  sample counts per the reference's RTT ring buckets
  (members.rs:33 edges, ``agent/membership.RING_BUCKETS_MS``) — so host
  ``MemberState.rtt``/``rtt_ring`` state is a calibration input;
- **probe timeout tails**, which become the SWIM probe-plane loss rate.

The derived :class:`RoundModel` maps wall-clock asynchrony into
kernel-consumable data:

- ``round_ms``: the measured **delivery-pipeline tick** — broadcast
  flush tick + receiver-side apply/ingest batching tick
  (``AgentConfig.ingest_linger``, the handle_changes batching the
  reference also pays, agent.rs:2450-2518) + one-way p50 transit — the
  calibrated round length ``schedule_from_trace`` should bucket at
  instead of a hardcoded 500. One kernel round aggregates
  commit→flush→transit→apply, so the calibrated round must cover that
  whole pipeline, not the flush alone;
- ``vis_offset_rounds``: the continuous→round-synchronous correction. A
  write commits uniformly WITHIN a round, and "delivered in round r"
  means visible at r's closing flush — so a kernel latency of ``k``
  rounds corresponds to ``(k + 0.5) * round_ms`` of expected wall
  clock. The offset applies SYMMETRICALLY to calibrated and
  uncalibrated replays in the comparison (each with its own round
  length), so it can never favor one side;
- ``pair_miss[receiver][source]``: the probability a message's one-way
  latency straddles a round boundary (commit uniform in the round, so
  ``P(miss) = E[min(one_way / round_ms, 1)]``) and slips past this
  round's flush — the kernel's loss-then-recover axes model exactly
  that (a lost broadcast is recovered by rebroadcast/anti-entropy, i.e.
  delivered later);
- ``probe_loss``: the fraction of SWIM probes that exceeded the probe
  timeout.

Critically the model compiles into the EXISTING chaos-plane axes
(:func:`corrosion_tpu_torch.sim.faults.axes_from_rates` →
``Schedule.loss``/``probe_loss``): calibration is data flowing through
already-tested static-skip machinery, and zero new traced code enters
the engines. The identity model (all rates ~0) compiles to absent axes,
so calibrated-but-lossless runs trace bit-identically to uncalibrated
ones. Everything here is host-side stdlib + numpy.

Counterpart of corrosion_tpu/fidelity/calibrate.py.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from corrosion_tpu_torch.agent.membership import RING_BUCKETS_MS, rtt_ring
from corrosion_tpu_torch.sim.faults import CompiledFaults, axes_from_rates

MODEL_SCHEMA = "corro-round-model/1"

# Representative RTT per ring bucket: the bucket midpoint for the five
# bounded buckets, and the last reference edge (300 ms) for the
# open-ended top ring (members.rs:33 stops enumerating there).
RING_REPR_MS = tuple(
    (lo + hi) / 2.0
    for lo, hi in zip((0.0,) + RING_BUCKETS_MS[:-1], RING_BUCKETS_MS[:-1])
) + (RING_BUCKETS_MS[-1],)

# The reference's flush tick — the uncalibrated identification every
# pre-fidelity artifact used (sim/engine.py round model docstring).
REFERENCE_ROUND_MS = 500.0


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def trace_fingerprint(events) -> str:
    """Stable short hash of a trace's (t, actor, version) events — the
    provenance field tying a divergence report to the workload that
    produced it."""
    h = hashlib.sha256()
    for t, a, v in sorted(events):
        h.update(f"{t}:{a}:{v}".encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


@dataclass
class RoundModel:
    """Calibrated round-length model. ``pair_*`` matrices are
    [receiver_region][source_region]; region 0 alone for a loopback
    cluster."""

    round_ms: float
    flush_ms: float
    regions: int
    pair_rtt_p50_ms: list = field(default_factory=list)  # [R][R]
    pair_rtt_p99_ms: list = field(default_factory=list)  # [R][R]
    ring_occupancy: list = field(default_factory=list)  # [R][R][rings]
    pair_miss: list = field(default_factory=list)  # [R][R] in [0, 1]
    probe_loss: float = 0.0
    apply_ms: float = 0.0  # receiver-side ingest/apply batching tick
    vis_offset_rounds: float = 0.5  # round→wall discretization offset
    # Measured receiver apply drain rate (applies/s through the store
    # writer, sampled on a back-to-back calibration train DISJOINT from
    # any compared workload). 0 = unmeasured/unbounded: no backlog term.
    apply_rate_per_s: float = 0.0
    provenance: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.round_ms > 0.0:
            raise ValueError(f"round_ms must be positive: {self.round_ms}")
        if self.regions < 1:
            raise ValueError(f"regions must be >= 1: {self.regions}")
        for name in ("pair_rtt_p50_ms", "pair_rtt_p99_ms", "pair_miss"):
            m = getattr(self, name)
            if len(m) != self.regions or any(
                len(row) != self.regions for row in m
            ):
                raise ValueError(
                    f"{name} must be [{self.regions}][{self.regions}]"
                )
        if not 0.0 <= self.probe_loss <= 1.0:
            raise ValueError(f"probe_loss must be in [0, 1]: {self.probe_loss}")
        if self.apply_ms < 0.0:
            raise ValueError(f"apply_ms must be >= 0: {self.apply_ms}")
        if self.apply_rate_per_s < 0.0:
            raise ValueError(
                f"apply_rate_per_s must be >= 0: {self.apply_rate_per_s}"
            )
        if not 0.0 <= self.vis_offset_rounds <= 1.0:
            raise ValueError(
                f"vis_offset_rounds must be in [0, 1]: {self.vis_offset_rounds}"
            )

    # -- derived views -------------------------------------------------------

    @property
    def is_identity(self) -> bool:
        """True when compiling attaches NO fault axes (the static-skip
        fast path: the engines trace bit-identically to no model)."""
        return (
            self.loss_by_region().max() <= 1e-9
            and self.probe_loss <= 1e-9
            and self.apply_rate_per_s <= 0.0
        )

    def loss_by_region(self) -> np.ndarray:
        """f32[R] receiver-region delivery-miss probability — the mean
        over source regions of ``pair_miss`` (the Schedule loss axis is
        per receiver region; sources are sampled ~uniformly by the
        broadcast plane)."""
        return np.asarray(self.pair_miss, np.float32).mean(axis=1)

    def compile_axes(self, rounds: int) -> CompiledFaults:
        """Lower to the chaos plane's per-round arrays
        (``sim.faults.axes_from_rates``). Bit-identical across calls for
        equal inputs; the identity model compiles to all-``None`` axes."""
        return axes_from_rates(
            rounds,
            loss_by_region=self.loss_by_region(),
            probe_loss=self.probe_loss,
        )

    def apply(self, schedule, n_nodes: int):
        """Merge the compiled axes into a ``sim.engine.Schedule`` via the
        chaos plane's ``apply_plan`` (the one tested merge path). The
        schedule's region count must equal the model's."""
        from corrosion_tpu_torch.sim.faults import apply_plan

        return apply_plan(
            schedule, self.compile_axes(schedule.rounds),
            n_nodes=n_nodes, n_regions=self.regions,
        )

    def defer_schedule(self, schedule):
        """Apply the measured dissemination capacity MECHANICALLY: each
        round admits at most ``apply_rate_per_s * round_ms`` writes into
        the kernel schedule; a burst's overflow carries to later rounds
        in FIFO commit order (round-robin across same-round writers).

        The schedule's SAMPLES are untouched — they keep the true commit
        rounds — so replay visibility latencies measure commit→visible
        including the modeled backlog delay, exactly as the live
        measurement does. Per-writer version order is preserved (the
        ``schedule_from_trace`` count-per-bucket encoding stays valid).
        Deterministic; a no-op when the rate is unmeasured (0) or the
        schedule never exceeds capacity. Rounds extend if the backlog
        outlives the schedule."""
        if self.apply_rate_per_s <= 0.0:
            return schedule
        from collections import deque

        from corrosion_tpu_torch.sim.engine import Schedule

        cap = self.apply_rate_per_s * self.round_ms / 1000.0
        writes = np.asarray(schedule.writes)
        rounds, n_writers = writes.shape
        if writes.sum(axis=1).max() <= cap:
            return schedule  # never over capacity: bit-identical schedule
        queue: deque = deque()
        out_rows = []
        credit = 0.0
        r = 0
        while r < rounds or queue:
            if r < rounds:
                remaining = writes[r].astype(np.int64).copy()
                while remaining.sum() > 0:  # round-robin across writers
                    for w in range(n_writers):
                        if remaining[w] > 0:
                            queue.append(w)
                            remaining[w] -= 1
            credit += cap
            admit = int(credit)
            credit -= admit
            row = np.zeros(n_writers, writes.dtype)
            while admit > 0 and queue:
                row[queue.popleft()] += 1
                admit -= 1
            out_rows.append(row)
            r += 1
        if len(out_rows) != rounds and any(
            ax is not None for ax in (
                schedule.kill, schedule.revive, schedule.partition,
                schedule.loss, schedule.probe_loss, schedule.wipe,
            )
        ):
            raise ValueError(
                "defer_schedule extended the round count but per-round "
                "fault axes are already attached — defer BEFORE applying "
                "plans/models (kernel_replay's order)"
            )
        return Schedule(
            writes=np.stack(out_rows),
            kill=schedule.kill,
            revive=schedule.revive,
            partition=schedule.partition,
            sample_writer=schedule.sample_writer,
            sample_ver=schedule.sample_ver,
            sample_round=schedule.sample_round,
            loss=schedule.loss,
            probe_loss=schedule.probe_loss,
            wipe=schedule.wipe,
        )

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "schema": MODEL_SCHEMA,
            "round_ms": self.round_ms,
            "flush_ms": self.flush_ms,
            "regions": self.regions,
            "pair_rtt_p50_ms": self.pair_rtt_p50_ms,
            "pair_rtt_p99_ms": self.pair_rtt_p99_ms,
            "ring_occupancy": self.ring_occupancy,
            "pair_miss": self.pair_miss,
            "probe_loss": self.probe_loss,
            "apply_ms": self.apply_ms,
            "vis_offset_rounds": self.vis_offset_rounds,
            "apply_rate_per_s": self.apply_rate_per_s,
            "provenance": self.provenance,
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "RoundModel":
        if d.get("schema") != MODEL_SCHEMA:
            raise ValueError(f"not a {MODEL_SCHEMA} model: {d.get('schema')}")
        if not d.get("provenance"):
            raise ValueError(
                "round model has no provenance block — a calibration "
                "whose inputs are unstated cannot back a wall-clock claim"
            )
        return cls(
            round_ms=float(d["round_ms"]),
            flush_ms=float(d["flush_ms"]),
            regions=int(d["regions"]),
            pair_rtt_p50_ms=d["pair_rtt_p50_ms"],
            pair_rtt_p99_ms=d["pair_rtt_p99_ms"],
            ring_occupancy=d["ring_occupancy"],
            pair_miss=d["pair_miss"],
            probe_loss=float(d.get("probe_loss", 0.0)),
            apply_ms=float(d.get("apply_ms", 0.0)),
            vis_offset_rounds=float(d.get("vis_offset_rounds", 0.5)),
            apply_rate_per_s=float(d.get("apply_rate_per_s", 0.0)),
            provenance=dict(d["provenance"]),
        )

    @classmethod
    def from_json(cls, s: str) -> "RoundModel":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path: str) -> "RoundModel":
        with open(path) as f:
            return cls.from_json(f.read())

    def describe(self) -> str:
        lb = self.loss_by_region()
        return (
            f"round_ms={self.round_ms:.2f} (flush {self.flush_ms:g} ms) "
            f"regions={self.regions} "
            f"miss(max region)={float(lb.max()):.4f} "
            f"probe_loss={self.probe_loss:.4f} "
            f"apply_rate={self.apply_rate_per_s:.0f}/s"
            + (" [identity]" if self.is_identity else "")
        )


# ---------------------------------------------------------------------------
# Derivations.


def _miss_from_one_way(one_way_ms: np.ndarray, round_ms: float) -> float:
    """P(delivery slips past the round boundary) for measured one-way
    transit samples: a write commits uniformly within the round, so a
    message with transit ``d`` misses the closing flush with probability
    ``min(d / round_ms, 1)``; average over the samples."""
    d = np.asarray(one_way_ms, np.float64)
    return float(np.minimum(d / round_ms, 1.0).mean()) if d.size else 0.0


def derive_model(
    rtt_samples_by_pair: dict,
    flush_ms: float,
    apply_ms: float = 0.0,
    apply_rate_per_s: float = 0.0,
    regions: int = 1,
    probe_attempts: int = 0,
    probe_timeouts: int = 0,
    provenance: dict | None = None,
) -> RoundModel:
    """Build a :class:`RoundModel` from raw probe-RTT samples.

    ``rtt_samples_by_pair`` maps ``(receiver_region, source_region)`` to a
    list of measured RTTs in ms; a missing pair reuses the worst measured
    pair (conservative). ``round_ms`` is derived as the delivery-pipeline
    tick — flush tick + receiver apply/ingest tick + cluster-wide one-way
    p50 (messages must transit AND be applied before they are visible) —
    then ``pair_miss`` is evaluated against that calibrated round length.
    """
    if not rtt_samples_by_pair:
        raise ValueError("need at least one measured region pair")
    if not flush_ms > 0.0:
        raise ValueError(f"flush_ms must be positive: {flush_ms}")
    all_rtts = np.concatenate([
        np.asarray(v, np.float64) for v in rtt_samples_by_pair.values()
    ])
    if all_rtts.size == 0:
        raise ValueError("every measured pair is empty")
    one_way_p50 = _percentile(all_rtts, 50) / 2.0
    round_ms = flush_ms + apply_ms + one_way_p50

    worst_pair = max(
        rtt_samples_by_pair,
        key=lambda k: _percentile(rtt_samples_by_pair[k], 50)
        if len(rtt_samples_by_pair[k]) else -1.0,
    )
    p50 = [[0.0] * regions for _ in range(regions)]
    p99 = [[0.0] * regions for _ in range(regions)]
    occ = [
        [[0] * len(RING_REPR_MS) for _ in range(regions)]
        for _ in range(regions)
    ]
    miss = [[0.0] * regions for _ in range(regions)]
    for i in range(regions):
        for j in range(regions):
            xs = rtt_samples_by_pair.get(
                (i, j), rtt_samples_by_pair[worst_pair]
            )
            xs = np.asarray(xs, np.float64)
            if xs.size == 0:
                xs = np.asarray(rtt_samples_by_pair[worst_pair], np.float64)
            p50[i][j] = round(_percentile(xs, 50), 4)
            p99[i][j] = round(_percentile(xs, 99), 4)
            for x in xs:
                occ[i][j][rtt_ring(float(x))] += 1
            miss[i][j] = round(_miss_from_one_way(xs / 2.0, round_ms), 6)
    probe_loss = (
        probe_timeouts / probe_attempts if probe_attempts > 0 else 0.0
    )
    return RoundModel(
        round_ms=round(round_ms, 4),
        flush_ms=float(flush_ms),
        regions=regions,
        pair_rtt_p50_ms=p50,
        pair_rtt_p99_ms=p99,
        ring_occupancy=occ,
        pair_miss=miss,
        probe_loss=round(probe_loss, 6),
        apply_ms=float(apply_ms),
        apply_rate_per_s=round(float(apply_rate_per_s), 2),
        provenance=dict(provenance or {}),
    )


def from_ring_occupancy(
    occupancy,
    flush_ms: float,
    apply_ms: float = 0.0,
    probe_loss: float = 0.0,
    provenance: dict | None = None,
) -> RoundModel:
    """Build a model from RTT **ring occupancy** alone — sample counts
    per the reference's ring buckets, [R][R][rings]. This is how host
    ``Members`` state (``MemberState.rtts`` bucketed by ``rtt_ring``) or
    a kernel topology's ring-class matrix (``Topology.region_rtt``,
    one-hot occupancy) becomes a calibration input: each bucket is
    represented by ``RING_REPR_MS``."""
    occ = np.asarray(occupancy, np.float64)
    if occ.ndim != 3 or occ.shape[0] != occ.shape[1] or (
        occ.shape[2] != len(RING_REPR_MS)
    ):
        raise ValueError(
            f"occupancy must be [R][R][{len(RING_REPR_MS)}], got {occ.shape}"
        )
    if occ.sum(axis=2).min() <= 0:
        raise ValueError("every region pair needs >= 1 ring sample")
    regions = occ.shape[0]
    repr_ms = np.asarray(RING_REPR_MS, np.float64)
    w = occ / occ.sum(axis=2, keepdims=True)  # [R][R][rings] weights
    pair_mean = (w * repr_ms).sum(axis=2)  # [R][R] representative RTT
    one_way_p50 = float(np.median(pair_mean)) / 2.0
    round_ms = flush_ms + apply_ms + one_way_p50
    miss = (w * np.minimum((repr_ms / 2.0) / round_ms, 1.0)).sum(axis=2)
    # Bucket-resolution percentiles: the edge of the bucket where the
    # weighted CDF crosses the quantile.
    cdf = np.cumsum(w, axis=2)

    def q_edge(q: float) -> np.ndarray:
        idx = (cdf < q).sum(axis=2)
        idx = np.minimum(idx, len(repr_ms) - 1)
        return repr_ms[idx]

    return RoundModel(
        round_ms=round(round_ms, 4),
        flush_ms=float(flush_ms),
        regions=regions,
        pair_rtt_p50_ms=np.round(q_edge(0.5), 4).tolist(),
        pair_rtt_p99_ms=np.round(q_edge(0.99), 4).tolist(),
        ring_occupancy=occ.astype(np.int64).tolist(),
        pair_miss=np.round(miss, 6).tolist(),
        probe_loss=float(probe_loss),
        apply_ms=float(apply_ms),
        provenance=dict(provenance or {"source": "ring-occupancy"}),
    )


def from_characterization(
    char: dict,
    flush_ms: float,
    apply_ms: float = 0.0,
    provenance: dict | None = None,
) -> RoundModel:
    """Build a single-region model from a
    ``scripts/transport_characterization.py`` artifact (the under-bulk
    probe percentiles and probe-loss tail — the worst case the probe
    plane measured). The two percentiles stand in for the distribution
    as a two-point approximation: 3/4 of the mass at p50, 1/4 at p99
    (documented in docs/FIDELITY.md)."""
    under = char.get("probe_rtt_under_bulk_ms") or {}
    p50, p99 = under.get("p50"), under.get("p99")
    if p50 is None or p99 is None:
        raise ValueError(
            "characterization artifact lacks probe_rtt_under_bulk_ms "
            "p50/p99 — cannot calibrate from it"
        )
    samples = {(0, 0): [float(p50)] * 3 + [float(p99)]}
    model = derive_model(
        samples, flush_ms=flush_ms, apply_ms=apply_ms, regions=1,
        provenance=provenance or {
            "source": "transport-characterization",
            "rows": char.get("rows"),
        },
    )
    # dataclasses.replace re-runs __post_init__, so an out-of-range loss
    # in a corrupted artifact is rejected HERE, not at a later load of
    # the saved model.
    from dataclasses import replace as _replace

    return _replace(
        model,
        probe_loss=float(char.get("probe_loss_under_bulk", 0.0) or 0.0),
    )


def identity_model(regions: int = 1) -> RoundModel:
    """The uncalibrated identification as a model: the reference 500 ms
    round, zero miss, zero probe loss — compiles to NO fault axes, so
    replays under it are bit-identical to pre-fidelity replays."""
    z = [[0.0] * regions for _ in range(regions)]
    occ = [
        [[1] + [0] * (len(RING_REPR_MS) - 1) for _ in range(regions)]
        for _ in range(regions)
    ]
    return RoundModel(
        round_ms=REFERENCE_ROUND_MS,
        flush_ms=REFERENCE_ROUND_MS,
        regions=regions,
        pair_rtt_p50_ms=z,
        pair_rtt_p99_ms=[row[:] for row in z],
        ring_occupancy=occ,
        pair_miss=[row[:] for row in z],
        probe_loss=0.0,
        provenance={"source": "identity"},
    )


# ---------------------------------------------------------------------------
# Live measurement: active probe sampling through the real SWIM plane.


async def _measure_apply_rate(agents, train: int = 12) -> float:
    """Measured receiver apply drain rate: a back-to-back calibration
    write train into ``tests2`` (DISJOINT from every compared workload's
    ``tests`` table) on agent 0, its deliveries timestamped on a remote
    agent's subscription. The drain rate — (train-1) / spread of the
    remote arrival times — is the under-load signal the burst scenario's
    apply-backlog term needs. Returns 0.0 (unmeasured) for a 1-agent
    cluster or a degenerate spread."""
    import asyncio
    import time

    if len(agents) < 2 or train < 2:
        return 0.0
    stream = await agents[1].client.subscribe("SELECT id, text FROM tests2")
    arrivals: list[float] = []

    async def consume() -> None:
        async for ev in stream:
            if "change" in ev:
                arrivals.append(time.perf_counter())
                if len(arrivals) >= train:
                    return

    task = asyncio.ensure_future(consume())
    try:
        await asyncio.sleep(0.05)  # let the empty snapshot drain
        # One transaction per row: the train must be `train` COMMITS
        # (each its own version + broadcast frame), not one batched one.
        for i in range(train):
            await agents[0].client.execute([
                ["INSERT INTO tests2 (id, text) VALUES (?, 'cal')", [i]]
            ])
        await asyncio.wait_for(task, 20.0)
    except (asyncio.TimeoutError, ConnectionError, OSError):
        task.cancel()
        return 0.0
    finally:
        stream.close()
    if len(arrivals) < 2:
        return 0.0
    spread_s = arrivals[-1] - arrivals[0]
    return (len(arrivals) - 1) / spread_s if spread_s > 0 else 0.0


async def measure_live(agents, probes: int = 40, gap_s: float = 0.01) -> dict:
    """Sample probe RTTs between every ordered pair of live test agents
    through the real SWIM UDP plane (``swim._probe``, the same path
    ``scripts/transport_characterization.py`` measures), measure the
    receiver apply drain rate on a disjoint write train, and read the
    configured flush tick. Returns the raw measurement dict
    :func:`calibrate_live` derives a model from."""
    import asyncio
    import time

    samples: dict = {}
    attempts = timeouts = 0
    for a in agents:
        for b in agents:
            if a is b:
                continue
            key = (0, 0)  # loopback cluster: one region
            rtts = samples.setdefault(key, [])
            for _ in range(probes):
                t0 = time.perf_counter()
                ok = await a.agent.swim._probe(b.agent.gossip_addr)
                attempts += 1
                if ok:
                    rtts.append((time.perf_counter() - t0) * 1000.0)
                else:
                    timeouts += 1
                await asyncio.sleep(gap_s)
    # Fold in any passively accumulated host membership RTT state too —
    # the rtt_ring buckets the probe loop has been feeding.
    member_samples = [
        float(r)
        for a in agents
        for m in a.agent.members.states.values()
        for r in m.rtts
    ]
    if member_samples:
        samples.setdefault((0, 0), []).extend(member_samples)
    apply_rate = await _measure_apply_rate(agents)
    return {
        "rtt_samples_by_pair": samples,
        "flush_ms": agents[0].agent.cfg.broadcast_interval * 1000.0,
        # Receiver-side apply batching: handle_changes ingest linger —
        # part of the delivery pipeline a kernel round aggregates.
        "apply_ms": agents[0].agent.cfg.ingest_linger * 1000.0,
        "apply_rate_per_s": apply_rate,
        "probe_attempts": attempts,
        "probe_timeouts": timeouts,
        "nodes": len(agents),
    }


async def calibrate_live(
    agents, probes: int = 40, provenance: dict | None = None
) -> RoundModel:
    """Measure a live cluster and derive its :class:`RoundModel`."""
    m = await measure_live(agents, probes=probes)
    prov = {
        "source": "live",
        "nodes": m["nodes"],
        "probe_attempts": m["probe_attempts"],
        "probe_timeouts": m["probe_timeouts"],
        **(provenance or {}),
    }
    return derive_model(
        m["rtt_samples_by_pair"],
        flush_ms=m["flush_ms"],
        apply_ms=m["apply_ms"],
        apply_rate_per_s=m["apply_rate_per_s"],
        regions=1,
        probe_attempts=m["probe_attempts"],
        probe_timeouts=m["probe_timeouts"],
        provenance=prov,
    )

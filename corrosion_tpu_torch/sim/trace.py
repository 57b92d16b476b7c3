"""Record real host-agent write traffic and replay it in the kernel
cluster (counterpart of corrosion_tpu/sim/trace.py).

Each agent's committed writes are recorded as (time, actor, version)
events through its ``on_local_write`` hook, and ``replay`` re-executes
the same write workload in the whole-cluster simulator: the scripted
``Schedule`` becomes a transcript of real traffic. One simulator round is
``round_ms`` of recorded wall time; every recorded actor becomes one
writer stream, and silent observer nodes can be added.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from corrosion_tpu_torch.sim.engine import Schedule, simulate, visibility_latencies

# The hybrid logical clock's layout (a timestamp is physical_ms <<
# LOGICAL_BITS | logical), as the reference's core/hlc.py has it.
LOGICAL_BITS = 20


def ts_physical_ms(ts: int) -> int:
    return ts >> LOGICAL_BITS


@dataclass
class Trace:
    """Ordered (t_ms, actor_id, version) write events."""

    events: list[tuple[int, str, int]] = field(default_factory=list)

    def record(self, agent) -> None:
        """Attach to a live Agent: every committed local write appends an
        event (hook installed on Agent.on_local_write).

        The hook CHAINS with any previously installed one — a second
        recorder (or a user's own hook) must not silently disable the
        first, so the new hook calls the previous hook before appending.
        Detach with :meth:`unrecord`.
        """
        prev = getattr(agent, "on_local_write", None)

        def hook(actor_id: str, version: int, ts) -> None:
            if prev is not None:
                prev(actor_id, version, ts)
            self.events.append((ts_physical_ms(ts), actor_id, version))

        hook._trace_prev = prev  # unrecord support
        hook._trace_owner = self
        agent.on_local_write = hook

    def unrecord(self, agent) -> bool:
        """Detach this trace's hook from ``agent`` if it is the most
        recently installed one, restoring the previous hook. Returns
        False (and leaves the chain alone) when another hook was
        installed on top — unwinding out of order would drop it."""
        hook = getattr(agent, "on_local_write", None)
        if getattr(hook, "_trace_owner", None) is not self:
            return False
        agent.on_local_write = hook._trace_prev
        return True

    def merge(self, other: "Trace") -> "Trace":
        out = Trace(events=sorted(self.events + other.events))
        return out

    @property
    def actors(self) -> list[str]:
        return sorted({a for _, a, _ in self.events})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for t, a, v in sorted(self.events):
                f.write(json.dumps([t, a, v]) + "\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        events = []
        with open(path) as f:
            for line in f:
                t, a, v = json.loads(line)
                events.append((int(t), a, int(v)))
        return cls(events=sorted(events))


def schedule_from_trace(
    trace: Trace, round_ms: float = 500.0, drain_rounds: int = 40,
    samples: int = 256,
):
    """Bucket recorded writes into simulator rounds.

    Returns (actor_ids, Schedule): actor i of the sorted actor list becomes
    writer stream i; writes[r, i] counts the versions actor i committed in
    round r's wall-time window. Versions must be each actor's contiguous
    1..n sequence (they are — the agent allocates them that way); the
    count-per-bucket encoding preserves exactly that order.

    Robust to degenerate inputs: a zero-duration trace (every event in one
    ``round_ms`` window) buckets into a single write round, and sub-ms
    ``round_ms`` values bucket with the same float arithmetic used to size
    the array — the round count is derived from the max bucket index, so a
    boundary event can never index past the array.
    """
    if not trace.events:
        raise ValueError("empty trace")
    if not round_ms > 0.0:
        raise ValueError(f"round_ms must be positive, got {round_ms}")
    if drain_rounds < 0:
        raise ValueError(f"drain_rounds must be >= 0, got {drain_rounds}")
    events = sorted(trace.events)
    actors = trace.actors
    a_idx = {a: i for i, a in enumerate(actors)}
    # Sanity: contiguous per-actor version sequences — from the FIRST
    # recorded version, not necessarily 1 (a recorder attached mid-life
    # of an agent starts at whatever version the agent is up to).
    seen: dict[str, int] = {}
    for _, a, v in events:
        if a in seen and v != seen[a] + 1:
            raise ValueError(
                f"trace gap: actor {a[:8]} version {v}, expected "
                f"{seen[a] + 1}"
            )
        seen[a] = v
    t0 = events[0][0]
    # Bucket every event FIRST, then size the array from the max bucket:
    # deriving the round count independently (duration // round_ms) can
    # disagree with per-event float floor-division at the last boundary
    # for fractional round_ms, and a zero-duration trace must still give
    # one write round.
    buckets = [int((t - t0) // round_ms) for t, _a, _v in events]
    rounds = max(buckets) + 1
    writes = np.zeros((rounds + drain_rounds, len(actors)), np.uint32)
    for (_t, a, _v), r in zip(events, buckets):
        writes[r, a_idx[a]] += 1
    return actors, Schedule(writes=writes).make_samples(samples)


def replay(
    trace: Trace, round_ms: float = 500.0, observers: int = 0,
    drain_rounds: int = 40, seed: int = 0, device=None, **gossip_kw,
):
    """Re-run a recorded workload in the kernel cluster.

    The recorded actors become writer nodes 0..W-1; ``observers`` adds
    silent nodes that only receive. Returns (actors, final, curves, lat).
    Runs on ``device`` (default CUDA; raises when CUDA is absent and no
    device is given).
    """
    from corrosion_tpu_torch.models.baselines import _cfg

    actors, sched = schedule_from_trace(
        trace, round_ms=round_ms, drain_rounds=drain_rounds
    )
    w = len(actors)
    n = w + observers
    max_writes = int(sched.writes.max())
    cfg, topo = _cfg(
        n,
        writers=list(range(w)),
        sync_interval=4,
        n_cells=256,
        max_writes_per_round=max(4, max_writes),
        device=device,
        **gossip_kw,
    )
    final, curves = simulate(cfg, topo, sched, seed=seed, device=device)
    lat = visibility_latencies(final, sched, cfg)
    return actors, final, curves, lat

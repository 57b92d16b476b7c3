"""Deterministic network impairment for the host gossip transport.

The kernel plane got a declarative chaos language in ``sim/faults.py``;
this is its host-plane sibling: a :class:`HostFaultPlan`
(``corro-host-fault-plan/1``, JSON round-trip like the kernel's
``corro-fault-plan/1``) of typed impairment components over the agent
transport's three planes — the SWIM **probe** datagrams, one-shot
**bcast** changeset frames, and **sync** session streams
(agent/transport.py's plane split of the reference's QUIC multiplexing).
``agent.transport.Transport`` consults an armed :class:`NetemShim` at
every outbound operation; with no shim installed the hooks are a single
``is None`` branch — the impaired and unimpaired paths share every byte
of frame encoding (pinned by tests).

Component kinds (windows are ``[start_s, stop_s)`` seconds relative to
:meth:`NetemShim.arm`; ``stop_s=None`` = end of run):

- ``delay``: one-way latency ``delay_ms`` ± uniform ``jitter_ms`` on the
  matched planes/links — 40 ms each way ≈ an 80 ms-RTT WAN. On UDP the
  delay is a scheduled late send (so unequal jitter reorders packets,
  like a real WAN); on streams it paces the send call, which is what the
  sync plane's adaptive chunker and stall guard actually observe.
- ``loss``: silent drop with ``prob`` (planes ``probe``/``bcast`` only:
  a TCP byte stream does not lose application frames — loss there
  manifests as delay, which ``delay`` models).
- ``dup``: duplicate datagram delivery with ``prob`` (``probe`` only —
  that's where the wire can duplicate; SWIM seq matching must absorb
  it).
- ``reorder``: with ``prob``, hold a probe datagram back ``extra_ms``
  so it lands after its successors (UDP only).
- ``blackhole``: the matched ``src``→``dst`` direction stops completely.
  Datagrams vanish; stream operations stall ``stall_s`` (a dropped SYN
  burning the dial timeout) and then fail — the path that feeds the
  per-peer circuit breaker.
- ``partition`` / ``flap``: link cut between name sides ``a`` and ``b``
  (``b`` empty = everyone not in ``a``), symmetric unless ``one_way``
  (cuts only a→b, the asymmetric case — sim/faults semantics). ``flap``
  toggles every ``period_s`` inside its window, first half-cycle cut.

**Determinism.** Every probabilistic decision is a pure function of
``(seed, src, dst, plane, event_index, component)`` via sha256 — no RNG
state, no call-order coupling. The shim records an impairment trace
(event index, link, plane, active components, resulting decision);
:func:`replay_schedule` recomputes each recorded decision from the plan
+ seed alone and must reproduce it exactly — the mechanical form of
"replaying the same seed reproduces the identical fault schedule".

Link names: components match symbolic node names (``n0``, ``n1``, ...).
Each agent's shim knows its own name (``local``) and resolves peer
gossip addresses registered via :meth:`register_peer`; unresolved
addresses (inbound ephemeral ports, pre-registration traffic) match only
wildcard components and never sit inside a partition side.

Counterpart of corrosion_tpu/agent/netem.py.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field

PLAN_SCHEMA = "corro-host-fault-plan/1"

PLANES = ("probe", "bcast", "sync")

KINDS = ("delay", "loss", "dup", "reorder", "blackhole", "partition", "flap")

# Probability-bearing kinds (planes restricted to the lossy planes).
_PROB_KINDS = ("loss", "dup", "reorder")


@dataclass(frozen=True)
class HostFault:
    """One impairment component. Only the fields its ``kind`` reads
    matter; the rest keep defaults (and serialize compactly)."""

    kind: str
    start_s: float = 0.0
    stop_s: float | None = None  # None = until the run ends
    planes: tuple = ()  # () = every plane the kind supports
    src: tuple = ()  # directional kinds: sender node names (() = any)
    dst: tuple = ()  # directional kinds: receiver node names (() = any)
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    prob: float = 1.0  # loss / dup / reorder
    extra_ms: float = 50.0  # reorder hold-back
    stall_s: float = 0.3  # blackhole/partition: dial stall before failing
    a: tuple = ()  # partition/flap side A
    b: tuple = ()  # () = every node not in a
    one_way: bool = False  # cut a->b only
    period_s: float = 0.0  # flap half-cycle

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown host fault kind {self.kind!r}; one of {KINDS}"
            )
        if self.start_s < 0 or (
            self.stop_s is not None and self.stop_s <= self.start_s
        ):
            raise ValueError(
                f"{self.kind}: need 0 <= start_s < stop_s, got "
                f"[{self.start_s}, {self.stop_s})"
            )
        for p in self.planes:
            if p not in PLANES:
                raise ValueError(
                    f"{self.kind}: unknown plane {p!r}; one of {PLANES}"
                )
        if self.kind in _PROB_KINDS:
            if not (0.0 < self.prob <= 1.0):
                raise ValueError(
                    f"{self.kind}: prob must be in (0, 1], got {self.prob}"
                )
            lossy = (
                ("probe", "bcast") if self.kind == "loss" else ("probe",)
            )
            bad = [p for p in self.planes if p not in lossy]
            if bad:
                raise ValueError(
                    f"{self.kind}: planes {bad} unsupported — a TCP stream "
                    f"does not lose/duplicate frames (model it as delay); "
                    f"allowed: {lossy}"
                )
        if self.kind == "delay" and self.delay_ms <= 0:
            raise ValueError("delay: delay_ms must be > 0")
        if self.kind == "delay" and self.jitter_ms > self.delay_ms:
            raise ValueError(
                "delay: jitter_ms > delay_ms would mean negative latency"
            )
        if self.kind in ("partition", "flap") and not self.a:
            raise ValueError(f"{self.kind}: side `a` must name >= 1 node")
        if self.kind == "flap" and self.period_s <= 0:
            raise ValueError("flap: period_s must be > 0")

    def effective_planes(self, kind_default: tuple = PLANES) -> tuple:
        if self.planes:
            return self.planes
        if self.kind == "loss":
            return ("probe", "bcast")
        if self.kind in ("dup", "reorder"):
            return ("probe",)
        return kind_default

    def active_at(self, t: float) -> bool:
        if t < self.start_s:
            return False
        if self.stop_s is not None and t >= self.stop_s:
            return False
        if self.kind == "flap":
            # First half-cycle inside the window is the cut phase.
            return int((t - self.start_s) / self.period_s) % 2 == 0
        return True

    def cuts(self, src: str, dst: str) -> bool:
        """Partition/flap: does this component cut the src->dst link?"""
        def in_b(x: str) -> bool:
            # Unresolved peers ("?") never belong to a side: a component
            # cannot cut traffic whose endpoint it cannot name.
            if x == "?":
                return False
            return x in self.b if self.b else x not in self.a

        if src in self.a and in_b(dst):
            return True
        if not self.one_way and in_b(src) and dst in self.a:
            return True
        return False

    def matches_dir(self, src: str, dst: str) -> bool:
        """Directional kinds: does (src -> dst) match the link filter?"""
        return (not self.src or src in self.src) and (
            not self.dst or dst in self.dst
        )

    def to_dict(self) -> dict:
        d: dict = {"kind": self.kind, "start_s": self.start_s}
        if self.stop_s is not None:
            d["stop_s"] = self.stop_s
        if self.planes:
            d["planes"] = list(self.planes)
        if self.src:
            d["src"] = list(self.src)
        if self.dst:
            d["dst"] = list(self.dst)
        if self.kind == "delay":
            d["delay_ms"] = self.delay_ms
            if self.jitter_ms:
                d["jitter_ms"] = self.jitter_ms
        if self.kind in _PROB_KINDS:
            d["prob"] = self.prob
        if self.kind == "reorder":
            d["extra_ms"] = self.extra_ms
        if self.kind in ("blackhole", "partition", "flap"):
            d["stall_s"] = self.stall_s
        if self.kind in ("partition", "flap"):
            d["a"] = list(self.a)
            if self.b:
                d["b"] = list(self.b)
            if self.one_way:
                d["one_way"] = True
        if self.kind == "flap":
            d["period_s"] = self.period_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HostFault":
        return cls(
            kind=d["kind"],
            start_s=float(d.get("start_s", 0.0)),
            stop_s=(
                None if d.get("stop_s") is None else float(d["stop_s"])
            ),
            planes=tuple(d.get("planes", ())),
            src=tuple(d.get("src", ())),
            dst=tuple(d.get("dst", ())),
            # No defaulting games: a delay component whose JSON lacks a
            # positive delay_ms must FAIL validation, not quietly become
            # a near-zero impairment that reports green.
            delay_ms=float(d.get("delay_ms", 0.0)),
            jitter_ms=float(d.get("jitter_ms", 0.0)),
            prob=float(d.get("prob", 1.0)),
            extra_ms=float(d.get("extra_ms", 50.0)),
            stall_s=float(d.get("stall_s", 0.3)),
            a=tuple(d.get("a", ())),
            b=tuple(d.get("b", ())),
            one_way=bool(d.get("one_way", False)),
            period_s=float(d.get("period_s", 0.0)),
        )


@dataclass(frozen=True)
class HostFaultPlan:
    faults: tuple = ()
    name: str = ""

    @property
    def empty(self) -> bool:
        return not self.faults

    def horizon_s(self) -> float:
        """First instant with every windowed component over (0 when the
        plan is empty or purely always-on)."""
        stops = [
            f.stop_s for f in self.faults
            if not (f.start_s == 0.0 and f.stop_s is None)
        ]
        if any(s is None for s in stops):
            return float("inf")
        return max((float(s) for s in stops), default=0.0)

    def to_json_obj(self) -> dict:
        return {
            "schema": PLAN_SCHEMA,
            "name": self.name,
            "faults": [f.to_dict() for f in self.faults],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_obj(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, src) -> "HostFaultPlan":
        d = json.loads(src) if isinstance(src, str) else src
        if d.get("schema") != PLAN_SCHEMA:
            raise ValueError(
                f"not a {PLAN_SCHEMA} document: schema={d.get('schema')!r}"
            )
        return cls(
            name=d.get("name", ""),
            faults=tuple(HostFault.from_dict(f) for f in d.get("faults", ())),
        )


@dataclass
class UdpVerdict:
    """Impairment decision for one outbound datagram."""

    drop: bool = False
    dup: bool = False
    delay_s: float = 0.0


@dataclass
class StreamVerdict:
    """Impairment decision for one stream operation (frame send, session
    open, session send). ``block_s`` set = the link is cut: stall that
    long, then fail (the dropped-SYN shape the circuit breaker exists
    for). ``drop`` = the frame silently vanishes (bcast loss)."""

    block_s: float | None = None
    drop: bool = False
    delay_s: float = 0.0


_NOOP_UDP = UdpVerdict()
_NOOP_STREAM = StreamVerdict()


class NetemShim:
    """Seeded per-link/per-plane impairment schedule (module docstring).

    ``clock`` is injectable for deterministic unit tests. Before
    :meth:`arm` only always-on components (``start_s == 0``,
    ``stop_s is None``) apply, so a scheduled partition can never fire
    while the harness is still launching the cluster; ``arm`` pins the
    window origin to "storm start".
    """

    TRACE_CAP = 20000

    def __init__(
        self,
        plan,
        seed: int = 0,
        local: str = "?",
        clock=time.monotonic,
    ) -> None:
        self.plan = (
            plan if isinstance(plan, HostFaultPlan)
            else HostFaultPlan.from_json(plan)
        )
        self.seed = int(seed)
        self.local = local
        self._clock = clock
        self._t0 = clock()
        self._armed = False
        self._peers: dict[tuple, str] = {}
        self._n: dict[tuple, int] = {}
        self.trace: list[dict] = []
        self.trace_overflow = 0
        self.stats = {
            "events": 0, "dropped": 0, "duplicated": 0, "delayed": 0,
            "blocked": 0,
        }

    @property
    def enabled(self) -> bool:
        return not self.plan.empty

    # -- wiring ---------------------------------------------------------------

    def register_peer(self, addr, name: str) -> None:
        self._peers[tuple(addr)] = name

    def arm(self, at: float | None = None) -> None:
        """Start the fault windows. ``at`` (a prior ``clock()`` reading)
        lets a restarted agent's fresh shim share the original origin so
        its windows line up with the rest of the cluster."""
        self._t0 = self._clock() if at is None else at
        self._armed = True

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def _peer(self, addr) -> str:
        try:
            return self._peers.get(tuple(addr), "?")
        except TypeError:
            return "?"

    # -- deterministic draws --------------------------------------------------

    def _u(self, plane: str, dst: str, n: int, salt: str) -> float:
        """Uniform in [0, 1): a pure function of the decision key — no
        RNG state, so the schedule replays from (plan, seed) alone."""
        h = hashlib.sha256(
            f"{self.seed}|{self.local}>{dst}|{plane}|{n}|{salt}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def _active(self, t: float):
        for i, f in enumerate(self.plan.faults):
            if not self._armed and not (
                f.start_s == 0.0 and f.stop_s is None
            ):
                continue  # scheduled windows wait for arm()
            if f.active_at(t):
                yield i, f

    # -- decision core --------------------------------------------------------

    def _verdict(self, plane: str, dst: str, n: int, t: float):
        """Compute (active component idxs, drop, dup, block_s, delay_s)
        for one event. Pure given (plan, seed, plane, dst, n, active
        set) — the replay contract."""
        idxs: list[int] = []
        drop = dup = False
        block: float | None = None
        delay = 0.0
        for i, f in self._active(t):
            if plane not in f.effective_planes():
                continue
            if f.kind in ("partition", "flap"):
                if f.cuts(self.local, dst):
                    idxs.append(i)
                    block = max(block or 0.0, f.stall_s)
                continue
            if not f.matches_dir(self.local, dst):
                continue
            if f.kind == "blackhole":
                idxs.append(i)
                block = max(block or 0.0, f.stall_s)
            elif f.kind == "delay":
                idxs.append(i)
                u = self._u(plane, dst, n, f"delay{i}")
                delay += max(
                    0.0, f.delay_ms + (2.0 * u - 1.0) * f.jitter_ms
                ) / 1000.0
            elif f.kind == "loss":
                idxs.append(i)
                if self._u(plane, dst, n, f"loss{i}") < f.prob:
                    drop = True
            elif f.kind == "dup":
                idxs.append(i)
                if self._u(plane, dst, n, f"dup{i}") < f.prob:
                    dup = True
            elif f.kind == "reorder":
                idxs.append(i)
                if self._u(plane, dst, n, f"reorder{i}") < f.prob:
                    delay += f.extra_ms / 1000.0
        return idxs, drop, dup, block, delay

    def _record(self, plane, dst, n, t, idxs, drop, dup, block, delay):
        self.stats["events"] += 1
        if drop or (block is not None and plane == "probe"):
            self.stats["dropped"] += 1
        if dup:
            self.stats["duplicated"] += 1
        if delay > 0:
            self.stats["delayed"] += 1
        if block is not None and plane != "probe":
            self.stats["blocked"] += 1
        if len(self.trace) >= self.TRACE_CAP:
            self.trace_overflow += 1
            return
        self.trace.append({
            "n": n, "plane": plane, "src": self.local, "dst": dst,
            "f": idxs, "drop": drop, "dup": dup,
            "block_s": block,
            "delay_ms": round(delay * 1000.0, 3),
            "t": round(t, 3),
        })

    def _next_n(self, plane: str, dst: str) -> int:
        key = (plane, dst)
        n = self._n.get(key, 0)
        self._n[key] = n + 1
        return n

    def udp_fault(self, addr) -> UdpVerdict:
        """Decision for one outbound SWIM datagram. A cut link (blackhole
        or partition) drops datagrams silently — UDP has no dial to
        stall."""
        t = self.elapsed()
        dst = self._peer(addr)
        n = self._next_n("probe", dst)
        idxs, drop, dup, block, delay = self._verdict("probe", dst, n, t)
        if not idxs:
            return _NOOP_UDP
        if block is not None:
            drop = True
        self._record("probe", dst, n, t, idxs, drop, dup, block, delay)
        return UdpVerdict(drop=drop, dup=dup, delay_s=delay)

    def stream_fault(self, plane: str, addr) -> StreamVerdict:
        """Decision for one stream operation on ``plane`` ("bcast" frame
        send or "sync" open/send) toward ``addr``."""
        t = self.elapsed()
        dst = self._peer(addr)
        n = self._next_n(plane, dst)
        idxs, drop, dup, block, delay = self._verdict(plane, dst, n, t)
        if not idxs:
            return _NOOP_STREAM
        self._record(plane, dst, n, t, idxs, drop, dup, block, delay)
        return StreamVerdict(block_s=block, drop=drop, delay_s=delay)

    # -- replay ---------------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable hash over the decision-relevant part of the trace
        (wall times excluded — they jitter; decisions must not)."""
        return trace_fingerprint(self.trace)

    def replay_event(self, entry: dict):
        """Recompute one recorded decision from the plan + seed alone.
        Returns the (drop, dup, block_s, delay_ms) tuple the schedule
        dictates for that event."""
        plane, dst, n = entry["plane"], entry["dst"], entry["n"]
        drop = dup = False
        block: float | None = None
        delay = 0.0
        for i in entry["f"]:
            f = self.plan.faults[i]
            if f.kind in ("partition", "flap", "blackhole"):
                block = max(block or 0.0, f.stall_s)
            elif f.kind == "delay":
                u = self._u(plane, dst, n, f"delay{i}")
                delay += max(
                    0.0, f.delay_ms + (2.0 * u - 1.0) * f.jitter_ms
                ) / 1000.0
            elif f.kind == "loss":
                if self._u(plane, dst, n, f"loss{i}") < f.prob:
                    drop = True
            elif f.kind == "dup":
                if self._u(plane, dst, n, f"dup{i}") < f.prob:
                    dup = True
            elif f.kind == "reorder":
                if self._u(plane, dst, n, f"reorder{i}") < f.prob:
                    delay += f.extra_ms / 1000.0
        if block is not None and plane == "probe":
            drop = True
        return drop, dup, block, round(delay * 1000.0, 3)


def trace_fingerprint(trace: list[dict]) -> str:
    canon = [
        [e["n"], e["plane"], e["src"], e["dst"], list(e["f"]),
         bool(e["drop"]), bool(e["dup"]), e["block_s"], e["delay_ms"]]
        for e in trace
    ]
    return hashlib.sha256(
        json.dumps(canon, separators=(",", ":")).encode()
    ).hexdigest()


def replay_schedule(
    plan, seed: int, local: str, trace: list[dict]
) -> tuple[bool, list[str]]:
    """Mechanical schedule-replay check: every recorded decision must be
    reproduced exactly by the pure (plan, seed) function. Returns
    ``(ok, mismatches)``."""
    shim = NetemShim(plan, seed=seed, local=local)
    mismatches: list[str] = []
    for e in trace:
        try:
            if e["src"] != local:
                mismatches.append(
                    f"event n={e['n']}: src {e['src']!r} != shim local "
                    f"{local!r}"
                )
                continue
            drop, dup, block, delay_ms = shim.replay_event(e)
            got = (
                bool(e["drop"]), bool(e["dup"]), e["block_s"], e["delay_ms"]
            )
        except (KeyError, IndexError, TypeError) as err:
            # A tampered/corrupt entry (component index outside the
            # plan, missing keys) is a mismatch to DIAGNOSE, not a
            # traceback.
            mismatches.append(
                f"structurally invalid trace entry {e!r}: {err!r}"
            )
            continue
        want = (drop, dup, block, delay_ms)
        if got != want:
            mismatches.append(
                f"event n={e['n']} {e['plane']} {e['src']}->{e['dst']}: "
                f"recorded {got} != replayed {want}"
            )
    return not mismatches, mismatches

"""Declarative fault injection: the chaos plane's plan language (the
port's own copy of corrosion_tpu/sim/faults.py, numpy only).

A :class:`FaultPlan` is a list of typed fault components over a run of
``rounds`` rounds. :meth:`FaultPlan.compile` lowers it to per-round
numpy arrays — the exact shapes the engines thread through their scan
bodies — and :func:`apply_plan` merges those arrays into a
``sim.engine.Schedule`` so every engine consumes faults through the one
schedule object it already takes. A plan with no components compiles to
``None`` arrays everywhere, which keeps the engines' static zero-cost
skip: fault-free runs trace bit-identically to the pre-chaos kernels.

Component kinds (all windows are ``[start, stop)`` in rounds):

- ``loss``: receiver-side message loss with probability ``prob`` for
  the listed receiver ``regions`` (empty = every region). Composes with
  a config's ambient ``loss_prob`` as independent processes
  (ops/faulting.apply_loss).
- ``partition``: link cut between region sides ``a`` and ``b`` (``b``
  empty = every region not in ``a``). ``one_way=True`` cuts only the
  a→b direction — ``b`` stops hearing ``a`` while a keeps hearing b —
  the asymmetric-partition case a symmetric mask can't express.
- ``flap``: a partition that toggles every ``period`` rounds inside its
  window (first half-cycle: cut) — the flapping-WAN-link scenario.
- ``churn``: kill ``nodes`` at ``start``; revive them at ``revive_at``
  (``None`` = never — such a plan does not heal). ``wipe=True`` makes
  the kill a crash-with-state-wipe (restart from empty replica state,
  ops/faulting.wipe_nodes) instead of the default pause-resume.
  NOTE: the sparse engine degrades wipe to pause-resume — its bounded
  deviation tables cannot represent a node that lags on EVERY cold
  writer — and sim/invariants.py records that degradation in its
  report facts.
- ``probe_loss``: drops SWIM probe/ack exchanges only (``prob``),
  leaving the data plane untouched — membership stress in isolation.
- ``preempt``: hard-kills one DEVICE shard of the kernel state at round
  ``start`` (no graceful drain, mirroring ``Agent.abort`` crash
  semantics). This is a host/elastic-plane axis: :meth:`FaultPlan.compile`
  does NOT lower it to kernel arrays — the elastic survival driver
  (the reference's ``elastic`` package) consumes it via
  :meth:`FaultPlan.preempt_events` and must recover the lost shard from
  the last checkpoint + gap replay. A preempt plan run without the
  elastic driver is a harness bug, which the machinery-fired rule
  (recovery counters staying at zero) catches.

Everything here is host-side numpy; the arrays become device inputs
inside the engines. JSON round-trip (``to_json``/``from_json``) is the
chaos fuzzer's repro-artifact format (docs/CHAOS.md).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

import numpy as np

PLAN_SCHEMA = "corro-fault-plan/1"

# Kernel kinds lower to per-round schedule arrays; "preempt" is the
# elastic plane's device-shard axis and never reaches the scan bodies.
KERNEL_KINDS = ("loss", "partition", "flap", "churn", "probe_loss")
KINDS = KERNEL_KINDS + ("preempt",)


@dataclass(frozen=True)
class Fault:
    """One fault component. Only the fields its ``kind`` reads matter;
    the rest keep their defaults (and serialize compactly)."""

    kind: str
    start: int
    stop: int  # exclusive
    prob: float = 0.0  # loss / probe_loss
    regions: tuple = ()  # loss: receiver regions (() = all)
    a: tuple = ()  # partition/flap: side A region ids
    b: tuple = ()  # partition/flap: side B (() = all regions not in a)
    one_way: bool = False  # cut a->b only (b stops hearing a)
    period: int = 0  # flap: rounds per on/off half-cycle
    nodes: tuple = ()  # churn victims
    revive_at: int | None = None  # churn (None = never revived)
    wipe: bool = False  # churn: crash-with-state-wipe
    device: int = -1  # preempt: device shard index to hard-kill

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if not (0 <= self.start < self.stop):
            raise ValueError(
                f"{self.kind}: need 0 <= start < stop, got "
                f"[{self.start}, {self.stop})"
            )
        if self.kind in ("loss", "probe_loss") and not (0.0 < self.prob <= 1.0):
            raise ValueError(f"{self.kind}: prob must be in (0, 1], got {self.prob}")
        if self.kind in ("partition", "flap") and not self.a:
            raise ValueError(f"{self.kind}: side `a` must name >= 1 region")
        if self.kind == "flap" and self.period <= 0:
            raise ValueError("flap: period must be >= 1 round")
        if self.kind == "churn":
            if not self.nodes:
                raise ValueError("churn: needs >= 1 victim node")
            if self.revive_at is not None and self.revive_at <= self.start:
                raise ValueError(
                    f"churn: revive_at {self.revive_at} must be after the "
                    f"kill round {self.start}"
                )
        if self.wipe and self.kind != "churn":
            raise ValueError("wipe is a churn-only flag")
        if self.kind == "preempt":
            if self.device < 0:
                raise ValueError("preempt: needs a device shard index >= 0")
            if self.stop != self.start + 1:
                raise ValueError(
                    "preempt is instantaneous: stop must be start + 1, "
                    f"got [{self.start}, {self.stop})"
                )
        elif self.device >= 0:
            raise ValueError("device is a preempt-only field")

    @property
    def clears_at(self) -> int | None:
        """First round with this component fully healed, None = never."""
        if self.kind == "churn":
            return None if self.revive_at is None else self.revive_at + 1
        return self.stop

    def to_dict(self) -> dict:
        d: dict = {"kind": self.kind, "start": self.start, "stop": self.stop}
        if self.kind in ("loss", "probe_loss"):
            d["prob"] = self.prob
        if self.kind == "loss" and self.regions:
            d["regions"] = list(self.regions)
        if self.kind in ("partition", "flap"):
            d["a"] = list(self.a)
            if self.b:
                d["b"] = list(self.b)
            if self.one_way:
                d["one_way"] = True
        if self.kind == "flap":
            d["period"] = self.period
        if self.kind == "churn":
            d["nodes"] = list(self.nodes)
            d["revive_at"] = self.revive_at
            if self.wipe:
                d["wipe"] = True
        if self.kind == "preempt":
            d["device"] = self.device
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        return cls(
            kind=d["kind"], start=int(d["start"]), stop=int(d["stop"]),
            prob=float(d.get("prob", 0.0)),
            regions=tuple(d.get("regions", ())),
            a=tuple(d.get("a", ())), b=tuple(d.get("b", ())),
            one_way=bool(d.get("one_way", False)),
            period=int(d.get("period", 0)),
            nodes=tuple(d.get("nodes", ())),
            revive_at=(
                None if d.get("revive_at") is None else int(d["revive_at"])
            ),
            wipe=bool(d.get("wipe", False)),
            device=int(d.get("device", -1)),
        )


@dataclass
class CompiledFaults:
    """FaultPlan lowered to the per-round arrays the engines thread.
    ``None`` means that fault axis is absent — the trace-time flag the
    engines' static zero-cost skip keys on."""

    rounds: int
    loss: np.ndarray | None = None  # f32[rounds, R] receiver-region loss
    probe_loss: np.ndarray | None = None  # f32[rounds]
    partition: np.ndarray | None = None  # bool[rounds, R, R] directional
    kill: np.ndarray | None = None  # bool[rounds, N]
    revive: np.ndarray | None = None  # bool[rounds, N]
    wipe: np.ndarray | None = None  # bool[rounds, N] (subset of kill)
    heal_round: int = 0  # first round with every fault cleared
    heals: bool = True  # False: some component never clears

    @property
    def loss_scalar(self) -> np.ndarray | None:
        """f32[rounds] worst-region loss — the no-region chunk plane's
        view of the loss schedule."""
        return None if self.loss is None else self.loss.max(axis=1)

    def alive_curve(self, n_nodes: int) -> np.ndarray:
        """bool[rounds, N] ground-truth liveness per round (kill/revive
        folded cumulatively) — for engines without a SWIM plane."""
        alive = np.ones((self.rounds, n_nodes), bool)
        cur = np.ones(n_nodes, bool)
        for r in range(self.rounds):
            if self.kill is not None:
                cur &= ~self.kill[r]
            if self.revive is not None:
                cur |= self.revive[r]
            alive[r] = cur
        return alive


@dataclass(frozen=True)
class FaultPlan:
    rounds: int
    faults: tuple = ()
    name: str = ""

    def __post_init__(self):
        if self.rounds <= 0:
            raise ValueError("plan needs rounds >= 1")
        for f in self.faults:
            if f.stop > self.rounds and f.kind != "churn":
                raise ValueError(
                    f"{f.kind} window [{f.start}, {f.stop}) exceeds the "
                    f"plan's {self.rounds} rounds"
                )
            if f.start >= self.rounds:
                raise ValueError(
                    f"{f.kind} starts at {f.start}, past the plan's "
                    f"{self.rounds} rounds"
                )
            if (
                f.kind == "churn"
                and f.revive_at is not None
                and f.revive_at >= self.rounds
            ):
                raise ValueError(
                    f"churn revive_at {f.revive_at} is past the plan's "
                    f"{self.rounds} rounds"
                )

    @property
    def is_free(self) -> bool:
        return not self.faults

    @property
    def heals(self) -> bool:
        return all(f.clears_at is not None for f in self.faults)

    @property
    def heal_round(self) -> int:
        """First round with every fault cleared (= the plan's ``rounds``
        when some component never clears)."""
        h = 0
        for f in self.faults:
            h = max(h, self.rounds if f.clears_at is None else f.clears_at)
        return min(h, self.rounds)

    def max_region(self) -> int:
        """Highest region id any component references (-1 = none) — the
        minimum region count the plan needs to compile."""
        m = -1
        for f in self.faults:
            for r in tuple(f.regions) + tuple(f.a) + tuple(f.b):
                m = max(m, int(r))
        return m

    def wipes(self) -> tuple:
        """Node ids any component crash-wipes (invariant bookkeeping)."""
        out: set = set()
        for f in self.faults:
            if f.kind == "churn" and f.wipe:
                out.update(f.nodes)
        return tuple(sorted(out))

    def killed_forever(self) -> tuple:
        out: set = set()
        for f in self.faults:
            if f.kind == "churn" and f.revive_at is None:
                out.update(f.nodes)
        return tuple(sorted(out))

    def preempt_events(self) -> tuple:
        """Device-shard preemptions as sorted ``(round, device)`` pairs —
        the elastic driver's worklist. The kernel compile skips these;
        if this is non-empty the run MUST go through
        the elastic driver so recovery machinery fires."""
        return tuple(sorted(
            (f.start, f.device) for f in self.faults if f.kind == "preempt"
        ))

    def kernel_plan(self) -> "FaultPlan":
        """The plan with elastic-plane (preempt) components stripped —
        what actually lowers onto the scan bodies."""
        kernel = tuple(f for f in self.faults if f.kind != "preempt")
        if len(kernel) == len(self.faults):
            return self
        return FaultPlan(self.rounds, kernel, self.name)

    # -- lowering -----------------------------------------------------------

    def compile(
        self, n_nodes: int, n_regions: int, allow_wipe: bool = True
    ) -> CompiledFaults:
        """Lower to per-round arrays. ``allow_wipe=False`` degrades wipe
        churn to pause-resume (the sparse engine's bounded-table
        limitation; see the module docstring)."""
        c = CompiledFaults(
            rounds=self.rounds, heal_round=self.heal_round, heals=self.heals
        )
        for f in self.faults:
            stop = min(f.stop, self.rounds)
            if f.kind == "preempt":
                # Elastic-plane axis: consumed by the survival driver via
                # preempt_events(), never lowered to kernel arrays.
                continue
            if f.kind == "loss":
                if c.loss is None:
                    c.loss = np.zeros((self.rounds, n_regions), np.float32)
                regions = f.regions or tuple(range(n_regions))
                for r in regions:
                    if not (0 <= r < n_regions):
                        raise ValueError(f"loss region {r} out of range")
                    c.loss[f.start:stop, r] = np.maximum(
                        c.loss[f.start:stop, r], np.float32(f.prob)
                    )
            elif f.kind == "probe_loss":
                if c.probe_loss is None:
                    c.probe_loss = np.zeros(self.rounds, np.float32)
                c.probe_loss[f.start:stop] = np.maximum(
                    c.probe_loss[f.start:stop], np.float32(f.prob)
                )
            elif f.kind in ("partition", "flap"):
                if c.partition is None:
                    c.partition = np.zeros(
                        (self.rounds, n_regions, n_regions), bool
                    )
                side_a = list(f.a)
                side_b = list(f.b) or [
                    r for r in range(n_regions) if r not in f.a
                ]
                for r in side_a + side_b:
                    if not (0 <= r < n_regions):
                        raise ValueError(f"partition region {r} out of range")
                for t in range(f.start, stop):
                    if f.kind == "flap" and (
                        ((t - f.start) // f.period) % 2 == 1
                    ):
                        continue  # off half-cycle: link up
                    for ra in side_a:
                        for rb in side_b:
                            if ra == rb:
                                continue
                            # partition[receiver, source]: b can't hear a.
                            c.partition[t, rb, ra] = True
                            if not f.one_way:
                                c.partition[t, ra, rb] = True
            elif f.kind == "churn":
                if c.kill is None:
                    c.kill = np.zeros((self.rounds, n_nodes), bool)
                    c.revive = np.zeros((self.rounds, n_nodes), bool)
                nodes = np.asarray(f.nodes, np.int64)
                if nodes.min() < 0 or nodes.max() >= n_nodes:
                    raise ValueError(f"churn node out of range: {f.nodes}")
                c.kill[f.start, nodes] = True
                if f.revive_at is not None:
                    c.revive[f.revive_at, nodes] = True
                if f.wipe and allow_wipe:
                    if c.wipe is None:
                        c.wipe = np.zeros((self.rounds, n_nodes), bool)
                    c.wipe[f.start, nodes] = True
        return c

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "schema": PLAN_SCHEMA,
            "rounds": self.rounds,
            "faults": [f.to_dict() for f in self.faults],
        }
        if self.name:
            d["name"] = self.name
        return d

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if d.get("schema", PLAN_SCHEMA) != PLAN_SCHEMA:
            raise ValueError(f"not a {PLAN_SCHEMA} plan: {d.get('schema')}")
        return cls(
            rounds=int(d["rounds"]),
            faults=tuple(Fault.from_dict(f) for f in d.get("faults", ())),
            name=str(d.get("name", "")),
        )

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    def describe(self) -> str:
        if not self.faults:
            return f"fault-free ({self.rounds} rounds)"
        parts = []
        for f in self.faults:
            if f.kind == "loss":
                where = f"regions {list(f.regions)}" if f.regions else "all"
                parts.append(
                    f"loss p={f.prob:g} {where} [{f.start},{f.stop})"
                )
            elif f.kind == "probe_loss":
                parts.append(f"probe_loss p={f.prob:g} [{f.start},{f.stop})")
            elif f.kind in ("partition", "flap"):
                arrow = "->" if f.one_way else "<->"
                b = list(f.b) if f.b else "rest"
                extra = f" period={f.period}" if f.kind == "flap" else ""
                parts.append(
                    f"{f.kind} {list(f.a)}{arrow}{b}{extra} "
                    f"[{f.start},{f.stop})"
                )
            elif f.kind == "preempt":
                parts.append(f"preempt device {f.device} @{f.start}")
            else:
                w = "wipe" if f.wipe else "pause"
                rv = "never" if f.revive_at is None else f.revive_at
                parts.append(
                    f"churn {len(f.nodes)} nodes ({w}) kill@{f.start} "
                    f"revive@{rv}"
                )
        heal = (
            f"heals@{self.heal_round}" if self.heals else "NEVER HEALS"
        )
        return "; ".join(parts) + f" | {heal}/{self.rounds} rounds"


# ---------------------------------------------------------------------------
# Named scenarios — the curated chaos catalog (docs/CHAOS.md).


def named_scenarios(
    rounds: int, n_regions: int, n_nodes: int, protect: tuple = ()
) -> dict:
    """The curated fault catalog at a given cluster shape. ``protect``
    lists node ids churn must not touch (writer/origin nodes — the
    durability invariant is stated for surviving writers)."""
    if n_regions < 2 or rounds < 24:
        raise ValueError("scenarios need >= 2 regions and >= 24 rounds")
    f0, f1 = rounds // 6, rounds // 2  # fault window; the rest drains
    victims = tuple(
        n for n in range(n_nodes) if n not in set(protect)
    )[: max(2, n_nodes // 16)]
    revive = (f0 + f1) // 2
    plans = {
        "partition-heal": FaultPlan(rounds, (
            Fault("partition", f0, f1, a=(0,)),
        ), name="partition-heal"),
        "oneway-blackout": FaultPlan(rounds, (
            Fault("partition", f0, f1, a=(0,), one_way=True),
        ), name="oneway-blackout"),
        "flaky-link": FaultPlan(rounds, (
            Fault("flap", f0, f1, a=(0,), b=(1,), period=3),
        ), name="flaky-link"),
        "loss-burst": FaultPlan(rounds, (
            Fault("loss", f0, f1, prob=0.4),
        ), name="loss-burst"),
        "region-brownout": FaultPlan(rounds, (
            Fault("loss", f0, f1, prob=0.7, regions=(0,)),
        ), name="region-brownout"),
        "probe-storm": FaultPlan(rounds, (
            Fault("probe_loss", f0, f1, prob=0.6),
        ), name="probe-storm"),
        "crash-pause": FaultPlan(rounds, (
            Fault("churn", f0, f0 + 1, nodes=victims, revive_at=revive),
        ), name="crash-pause"),
        "crash-wipe": FaultPlan(rounds, (
            Fault("churn", f0, f0 + 1, nodes=victims, revive_at=revive,
                  wipe=True),
        ), name="crash-wipe"),
        "kitchen-sink": FaultPlan(rounds, (
            Fault("loss", f0, f1, prob=0.25),
            Fault("partition", f0 + 2, f1 - 2, a=(0,), one_way=True),
            Fault("churn", f0 + 1, f0 + 2, nodes=victims[:2],
                  revive_at=revive, wipe=True),
            Fault("probe_loss", f0, f1, prob=0.3),
        ), name="kitchen-sink"),
    }
    return plans


# ---------------------------------------------------------------------------
# Random plan generation + shrinking — the chaos fuzzer's core.


def random_plan(
    rng: np.random.Generator,
    rounds: int,
    n_regions: int,
    n_nodes: int,
    protect: tuple = (),
    max_faults: int = 3,
    allow_wipe: bool = True,
    break_heal: bool = False,
) -> FaultPlan:
    """Sample a healing fault plan: every component clears by ~5/8 of the
    run so the drain tail can prove recovery. ``break_heal=True``
    deliberately generates a NON-healing plan (a partition held to the
    final round) — the invariant suite must fail on it, and the shrinker
    must reduce it to a minimal repro (the chaos plane's self-test)."""
    heal_by = max(rounds * 5 // 8, 8)
    eligible = [n for n in range(n_nodes) if n not in set(protect)]
    faults: list[Fault] = []
    n_faults = int(rng.integers(1, max_faults + 1))
    # Fuzz over kernel kinds only: preempt needs the elastic driver's
    # recovery path and would be a silent no-op under plain simulate().
    kinds = list(KERNEL_KINDS)
    for _ in range(n_faults):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        start = int(rng.integers(2, max(heal_by // 2, 3)))
        stop = int(rng.integers(start + 2, heal_by + 1))
        if kind == "loss":
            all_regions = rng.random() < 0.5
            regions = (
                () if all_regions
                else tuple(
                    int(r) for r in rng.choice(
                        n_regions, size=max(1, n_regions // 2),
                        replace=False,
                    )
                )
            )
            faults.append(Fault(
                "loss", start, stop,
                prob=float(rng.uniform(0.2, 0.6)), regions=regions,
            ))
        elif kind == "probe_loss":
            faults.append(Fault(
                "probe_loss", start, stop,
                prob=float(rng.uniform(0.3, 0.7)),
            ))
        elif kind in ("partition", "flap"):
            a = (int(rng.integers(0, n_regions)),)
            rest = [r for r in range(n_regions) if r != a[0]]
            b = (
                () if rng.random() < 0.5
                else (int(rng.choice(rest)),)
            )
            if kind == "flap":
                faults.append(Fault(
                    "flap", start, stop, a=a, b=b,
                    period=int(rng.integers(2, 5)),
                ))
            else:
                faults.append(Fault(
                    "partition", start, stop, a=a, b=b,
                    one_way=bool(rng.random() < 0.5),
                ))
        else:  # churn
            if not eligible:
                continue
            k = int(rng.integers(1, max(2, len(eligible) // 8)))
            nodes = tuple(
                int(x) for x in rng.choice(eligible, size=k, replace=False)
            )
            revive_at = int(rng.integers(start + 3, heal_by + 1))
            faults.append(Fault(
                "churn", start, start + 1, nodes=nodes,
                revive_at=min(revive_at, rounds - 1),
                wipe=bool(allow_wipe and rng.random() < 0.5),
            ))
    if break_heal or not faults:
        # A partition that never clears: the canonical non-healing fault.
        faults.append(Fault(
            "partition", max(rounds // 4, 1), rounds, a=(0,),
        ))
    return FaultPlan(rounds=rounds, faults=tuple(faults))


def shrink_plan(plan: FaultPlan, still_fails, max_evals: int = 32):
    """Reduce a failing plan to a minimal repro: greedily drop whole
    components, then bisect each survivor's round window (and halve
    churn victim sets), as long as the reduced plan ``still_fails``.
    Returns ``(minimal_plan, evals_used)``."""
    evals = 0

    def check(p: FaultPlan) -> bool:
        nonlocal evals
        if evals >= max_evals:
            return False
        evals += 1
        return bool(still_fails(p))

    # Pass 1: greedy component drop (reverse order: later components are
    # more likely incidental riders on the failing window).
    faults = list(plan.faults)
    i = len(faults) - 1
    while i >= 0 and len(faults) > 1:
        cand = FaultPlan(
            plan.rounds, tuple(faults[:i] + faults[i + 1:]), plan.name
        )
        if check(cand):
            faults = list(cand.faults)
        i -= 1
    plan = FaultPlan(plan.rounds, tuple(faults), plan.name)

    # Pass 2: per-component window bisection / victim halving.
    changed = True
    while changed and evals < max_evals:
        changed = False
        for i, f in enumerate(plan.faults):
            cands: list[Fault] = []
            width = f.stop - f.start
            if width > 1 and f.kind != "churn":
                mid = f.start + width // 2
                cands.append(replace(f, stop=mid))
                cands.append(replace(f, start=mid))
            if f.kind == "churn" and len(f.nodes) > 1:
                half = len(f.nodes) // 2
                cands.append(replace(f, nodes=f.nodes[:half]))
                cands.append(replace(f, nodes=f.nodes[half:]))
            for cf in cands:
                cand = FaultPlan(
                    plan.rounds,
                    plan.faults[:i] + (cf,) + plan.faults[i + 1:],
                    plan.name,
                )
                if check(cand):
                    plan = cand
                    changed = True
                    break
            if changed:
                break
    return plan, evals


# ---------------------------------------------------------------------------
# Constant-rate axes — the fidelity plane's model→axes compiler entry.


def axes_from_rates(
    rounds: int,
    loss_by_region=None,
    probe_loss: float = 0.0,
    eps: float = 1e-9,
) -> CompiledFaults:
    """Lower constant per-round rates to :class:`CompiledFaults` — the
    entry the fidelity plane's calibrated :class:`RoundModel` compiles
    through (``fidelity/calibrate.py``), so calibration data flows into
    the engines via the chaos plane's already-tested axes instead of any
    new traced code.

    ``loss_by_region`` is a length-R array of receiver-region
    delivery-miss probabilities (a message whose wall-clock latency
    straddles the round boundary misses this round's flush and is
    recovered by rebroadcast/anti-entropy — exactly the loss axis's
    semantics), or a [rounds, R] matrix when the rate varies per round
    (the fidelity model's apply-backlog term under bursts);
    ``probe_loss`` is the SWIM probe-plane loss derived from probe
    timeout tails. Rates at or below ``eps`` compile to ABSENT axes
    (``None``), preserving the engines' static zero-cost fault-free
    skip: the identity model's schedule is bit-identical to no model at
    all. Deterministic: equal inputs compile to bit-identical arrays.
    """
    if rounds <= 0:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    c = CompiledFaults(rounds=rounds, heal_round=0, heals=True)
    if loss_by_region is not None:
        arr = np.asarray(loss_by_region, np.float32)
        if arr.ndim == 2 and arr.shape[0] != rounds:
            raise ValueError(
                f"per-round loss_by_region must have {rounds} rows, got "
                f"shape {arr.shape}"
            )
        if arr.ndim not in (1, 2):
            raise ValueError(
                f"loss_by_region must be [regions] or [rounds, regions], "
                f"got shape {arr.shape}"
            )
        if arr.size and (arr.min() < 0.0 or arr.max() > 1.0):
            raise ValueError(
                f"loss_by_region probabilities must be in [0, 1]: {arr}"
            )
        if arr.size and float(arr.max()) > eps:
            c.loss = (
                np.repeat(arr[None, :], rounds, axis=0)
                if arr.ndim == 1 else arr.copy()
            )
    if not 0.0 <= probe_loss <= 1.0:
        raise ValueError(f"probe_loss must be in [0, 1], got {probe_loss}")
    if probe_loss > eps:
        c.probe_loss = np.full(rounds, np.float32(probe_loss), np.float32)
    return c


# ---------------------------------------------------------------------------
# Schedule integration.


def apply_plan(schedule, plan, n_nodes: int, n_regions: int,
               allow_wipe: bool = True):
    """Merge a FaultPlan (or CompiledFaults) into a ``sim.engine.Schedule``:
    churn masks OR with the schedule's own, partitions OR, and the
    loss/probe_loss/wipe axes attach. Returns a new Schedule; the input
    is not mutated."""
    from corrosion_tpu_torch.sim.engine import Schedule

    c = (
        plan.compile(n_nodes, n_regions, allow_wipe=allow_wipe)
        if isinstance(plan, FaultPlan) else plan
    )
    if c.rounds != schedule.rounds:
        raise ValueError(
            f"plan rounds {c.rounds} != schedule rounds {schedule.rounds}"
        )

    def _or(a, b):
        if a is None:
            return None if b is None else b.copy()
        if b is None:
            return a.copy()
        return a | b

    partition = schedule.partition
    if c.partition is not None:
        if partition is None:
            partition = c.partition.copy()
        elif partition.shape != c.partition.shape:
            raise ValueError(
                f"partition shape {c.partition.shape} != schedule's "
                f"{partition.shape} (region count mismatch?)"
            )
        else:
            partition = partition | c.partition
    return Schedule(
        writes=schedule.writes,
        kill=_or(schedule.kill, c.kill),
        revive=_or(schedule.revive, c.revive),
        partition=partition,
        sample_writer=schedule.sample_writer,
        sample_ver=schedule.sample_ver,
        sample_round=schedule.sample_round,
        loss=_max_merge(schedule.loss, c.loss),
        probe_loss=_max_merge(schedule.probe_loss, c.probe_loss),
        wipe=_or(schedule.wipe, c.wipe),
    )


def _max_merge(a, b):
    if a is None:
        return None if b is None else b.copy()
    if b is None:
        return a.copy()
    return np.maximum(a, b)

"""The host chaos runner: netem plan + loadgen storm + oracle + post-heal
invariants + machinery-fired assertions.

One :func:`run_scenario` call is a complete experiment:

1. launch a real loopback cluster (agent/testing) with the scenario's
   ``corro-host-fault-plan/1`` installed as a NetemShim on every agent's
   transport (per-agent link names ``n0..n{k}``);
2. attach oracle-checked NDJSON subscriptions (loadgen.SubscriptionPump
   with auto-reconnect — durable-sub resume is part of the contract);
3. arm the fault windows and drive an open-loop write storm through the
   HTTP API, round-robin over the agents that are currently alive;
4. optionally SIGKILL one agent mid-storm (Agent.abort — no graceful
   leave, no final flushes) and relaunch it on the same data_dir/ports;
5. wait for the plan horizon, drain the fan-out, and check the post-heal
   invariants: ZERO fan-out-oracle violations, identical CRDT table
   state on every agent (and ⊇ every acked commit), identical per-actor
   bookkeeping heads with no version gaps or dangling partials;
6. assert the defensive machinery the scenario was built to force
   actually fired (``require_fired``): a chaos scenario that passes with
   its defenses idle is a test-harness failure, not a success — the
   report says so explicitly.

The report embeds the plan, per-agent impairment traces + fingerprints,
and the machinery counters, so ``hostchaos replay`` can mechanically
verify that the same seed reproduces the identical fault schedule.

Counterpart of corrosion_tpu/hostchaos/harness.py.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass, field

from corrosion_tpu_torch.agent.netem import HostFaultPlan, replay_schedule
from corrosion_tpu_torch.agent.testing import (
    hard_kill,
    launch_test_cluster,
    relaunch_test_agent,
    stop_cluster,
)
from corrosion_tpu_torch.core.bookkeeping import generate_sync
from corrosion_tpu_torch.loadgen.harness import (
    LoadHarness,
    SubscriptionPump,
    stop_pumps,
)
from corrosion_tpu_torch.loadgen.oracle import FanoutOracle
from corrosion_tpu_torch.loadgen.schedule import Arrival, open_loop

# Harness key -> metric series (summed across every agent life,
# including the pre-kill snapshot of a crashed agent's registry).
MACHINERY = {
    "stall_aborts": "corro_sync_stall_aborts_total",
    "chunk_halvings": "corro_sync_chunk_halvings_total",
    "breaker_trips": "corro_peer_breaker_trips_total",
    "breaker_recoveries": "corro_peer_breaker_recoveries_total",
    "backoff_retries": "corro_peer_backoff_retries_total",
}

# Trace entries embedded per agent in the report (fingerprints cover the
# FULL trace; the prefix keeps report JSONs reviewable).
REPORT_TRACE_CAP = 300


@dataclass(frozen=True)
class KillSpec:
    """SIGKILL agent ``agent`` at ``t_kill_s`` (storm-relative) and
    relaunch it on the same data_dir/ports at ``t_restart_s``."""

    agent: int
    t_kill_s: float
    t_restart_s: float


@dataclass(frozen=True)
class HostScenario:
    name: str
    plan: HostFaultPlan
    n_agents: int = 3
    writes: int = 40
    write_rate: float = 8.0
    subs: int = 9
    sub_groups: int = 3
    subs_on: int = 0
    kill: KillSpec | None = None
    require_fired: tuple = ()  # MACHINERY keys that MUST be >= 1
    agent_cfg: dict = field(default_factory=dict)
    drain_timeout_s: float = 45.0
    notes: str = ""

    def summary(self) -> str:
        kinds = ",".join(sorted({f.kind for f in self.plan.faults})) or "none"
        kill = (
            f"; kill n{self.kill.agent}@{self.kill.t_kill_s}s"
            f"->restart@{self.kill.t_restart_s}s" if self.kill else ""
        )
        req = ",".join(self.require_fired) or "-"
        return (
            f"{self.n_agents} agents, {self.writes} writes @ "
            f"{self.write_rate:g}/s, faults[{kinds}]{kill}; must fire: {req}"
        )


def _counter_total(snapshots: list[dict], series: str) -> float:
    """Sum a (possibly labeled) counter series across metric snapshots."""
    total = 0.0
    for snap in snapshots:
        for key, v in snap.items():
            if key == series or key.startswith(series + "{"):
                total += v
    return total


def _wire_netem(agents, arm_at: float | None = None) -> None:
    """Resolve every peer's gossip addr to its plan-space name on every
    shim, then start the fault windows (shared origin: a restarted
    agent's fresh shim arms at the ORIGINAL origin so its windows line
    up with the rest of the cluster)."""
    for i, ta in enumerate(agents):
        shim = ta.agent.netem
        if shim is None:
            continue
        for j, tb in enumerate(agents):
            if j != i and tb is not None and tb.gossip_addr is not None:
                shim.register_peer(tb.gossip_addr, f"n{j}")
        if arm_at is not None:
            shim.arm(at=arm_at)


async def _rows_of(ta) -> dict:
    _cols, rows = await ta.client.query(
        "SELECT id, text FROM tests ORDER BY id"
    )
    return {r[0]: r[1] for r in rows}


def _bookkeeping_check(agents) -> tuple[bool, list[str], dict]:
    """Post-heal bookkeeping contiguity + cross-agent head agreement."""
    failures: list[str] = []
    heads: dict[str, dict[int, int]] = {}
    for i, ta in enumerate(agents):
        st = generate_sync(ta.agent.bookie, ta.agent.actor_id)
        gaps = {a: rs for a, rs in st.need.items() if rs}
        partials = {a: p for a, p in st.partial_need.items() if p}
        if gaps:
            failures.append(f"n{i}: version gaps remain: {gaps}")
        if partials:
            failures.append(f"n{i}: dangling partials: {partials}")
        for actor, head in st.heads.items():
            heads.setdefault(actor, {})[i] = head
    for actor, per_agent in heads.items():
        if len(per_agent) != len(agents):
            missing = [i for i in range(len(agents)) if i not in per_agent]
            failures.append(
                f"actor {actor[:8]}: unknown to agents {missing}"
            )
        elif len(set(per_agent.values())) != 1:
            failures.append(
                f"actor {actor[:8]}: heads disagree: {per_agent}"
            )
    summary = {
        a[:8]: sorted(set(pa.values()))[-1] for a, pa in heads.items()
    }
    return not failures, failures, summary


async def run_scenario(
    spec: HostScenario,
    data_dir: str,
    seed: int = 0,
    progress=None,
    series_dir: str | None = None,
    series_interval: float = 0.25,
    endurance_kw: dict | None = None,
    sub_costs: bool = False,
) -> dict:
    """Run one scenario end to end; returns the report dict (``ok`` is
    the overall verdict — oracle, convergence, bookkeeping, machinery).

    ``series_dir`` arms the ENDURANCE plane: every agent streams one
    whole-registry snapshot per ``series_interval`` to
    ``<series_dir>/n<i>.series.jsonl`` (obs/series.py; a killed+
    relaunched agent reopens its series ``mode="a"`` so the restart
    discontinuity lands in ONE record), and the report gains an
    ``endurance`` block with one corro-endurance/1 verdict per agent
    (obs/endurance.py detectors, tuned via ``endurance_kw``).

    ``sub_costs`` arms the serving query-cost plane on every agent
    (``AgentConfig.sub_costs``): the report gains a ``sub_costs`` block
    with the subs-hosting agent's ``corro-sub-cost/1`` ledger, and crash
    scenarios additionally prove ledger ADOPTION — the relaunched agent
    re-reads its persisted per-subscription counters from the sub dbs
    (the same restart-survival contract as the series recorder), so a
    kill cannot silently zero the cost attribution."""

    def note(msg: str) -> None:
        if progress is not None:
            progress.write(f"[hostchaos {spec.name}] {msg}\n")
            progress.flush()

    loop = asyncio.get_running_loop()
    plan_obj = spec.plan.to_json_obj()
    netem_on = not spec.plan.empty
    cluster_kw: dict = dict(spec.agent_cfg)
    cfg_for = None
    if netem_on or series_dir is not None or sub_costs:
        def cfg_for(i, _plan=plan_obj, _seed=seed):
            cfg: dict = {}
            if netem_on:
                cfg.update({
                    "netem_plan": _plan, "netem_seed": _seed,
                    "netem_node": f"n{i}",
                })
            if series_dir is not None:
                cfg.update({
                    "metric_series_path": os.path.join(
                        series_dir, f"n{i}.series.jsonl"
                    ),
                    "runtime_metrics_interval": series_interval,
                })
            if sub_costs:
                cfg["sub_costs"] = True
            return cfg
    note(f"launching {spec.n_agents} agents (netem={netem_on}, seed={seed})")
    agents = await launch_test_cluster(
        data_dir, spec.n_agents, wait_membership=True,
        membership_timeout=30.0, cfg_for=cfg_for, **cluster_kw,
    )
    harness = LoadHarness()
    oracle = FanoutOracle(registry=harness.registry)
    pumps: list[SubscriptionPump] = []
    pre_kill_snapshots: list[dict] = []
    failures: list[str] = []
    kill_report: dict = {}
    live: set[int] = set(range(spec.n_agents))
    try:
        # Subscriptions on the designated agent (the kill target in
        # crash scenarios — durable-sub resume is under test).
        note(f"attaching {spec.subs} subscriptions on n{spec.subs_on}")
        sub_client = agents[spec.subs_on].client
        for i in range(spec.subs):
            g = i % spec.sub_groups
            pump = SubscriptionPump(
                sub_client,
                f"SELECT id, text FROM tests WHERE id % {spec.sub_groups}"
                f" = {g}",
                oracle, group=g, label=f"sub{i}",
                reconnect_retries=150, reconnect_delay_s=0.2,
            )
            pumps.append(pump)
        await asyncio.gather(*(p.start() for p in pumps))

        # Arm the fault windows: storm-relative time starts NOW.
        t_arm = time.monotonic()
        _wire_netem(agents, arm_at=t_arm)
        note("armed fault windows; storm starts")

        next_key = iter(range(10**9))

        async def fire_write(a: Arrival):
            k = next(next_key)
            payload = f"chaos-w{k}"
            # Round-robin over agents currently alive: a crashed agent
            # takes no writes while down (its API is gone), exactly like
            # a load balancer pulling a dead backend.
            order = [
                (k + off) % spec.n_agents for off in range(spec.n_agents)
            ]
            idx = next((i for i in order if i in live), None)
            if idx is None:
                return
            ta = agents[idx]

            async def go():
                await ta.client.execute(
                    [["INSERT INTO tests (id, text) VALUES (?, ?)",
                      [k, payload]]]
                )
                oracle.commit(
                    k, (payload,), loop.time(), group=k % spec.sub_groups
                )

            await harness.timed("transactions", a, go, deadline_s=30.0)

        async def kill_task():
            ks = spec.kill
            if ks is None:
                return
            await asyncio.sleep(max(0.0, ks.t_kill_s))
            victim = agents[ks.agent]
            note(f"hard-killing n{ks.agent} (SIGKILL semantics)")
            live.discard(ks.agent)
            t0 = time.monotonic()
            pre_kill_snapshots.append(victim.agent.metrics.snapshot())
            if sub_costs and victim.agent.subs is not None:
                kill_report["cost_pre_kill"] = (
                    victim.agent.subs.cost_snapshot()["totals"]
                )
            await hard_kill(victim)
            await asyncio.sleep(
                max(0.0, ks.t_restart_s - ks.t_kill_s
                    - (time.monotonic() - t0))
            )
            boot = [
                agents[i].gossip_addr
                for i in sorted(live) if i != ks.agent
            ][:2]
            note(f"relaunching n{ks.agent} on its data_dir/ports")
            agents[ks.agent] = await relaunch_test_agent(
                victim, bootstrap=boot
            )
            # The fresh shim shares the ORIGINAL window origin.
            _wire_netem(agents, arm_at=None)
            shim = agents[ks.agent].agent.netem
            if shim is not None:
                shim.arm(at=t_arm)
            if sub_costs and agents[ks.agent].agent.subs is not None:
                # Snapshot BEFORE the agent rejoins the write rotation:
                # nonzero counters here can only have come from the
                # persisted ledger (modulo gossip catch-up), proving the
                # relaunch adopted the previous life's attribution.
                kill_report["cost_adopted"] = (
                    agents[ks.agent].agent.subs.cost_snapshot()["totals"]
                )
            live.add(ks.agent)
            kill_report.update({
                "agent": ks.agent,
                "killed_at_s": round(ks.t_kill_s, 2),
                "restarted_after_s": round(time.monotonic() - t0, 2),
            })

        await asyncio.gather(
            harness.run_arrivals(
                open_loop(spec.write_rate, spec.writes), fire_write
            ),
            kill_task(),
        )
        note("storm done")

        # Let every scheduled fault window clear before judging heal.
        horizon = spec.plan.horizon_s()
        if horizon != float("inf"):
            remaining = horizon - (time.monotonic() - t_arm)
            if remaining > 0:
                note(f"waiting {remaining:.1f}s for fault windows to clear")
                await asyncio.sleep(remaining)

        # Drain: every acked commit must reach every obliged stream.
        t_drain = time.monotonic()
        deadline = t_drain + spec.drain_timeout_s
        while oracle.pending(limit=1) and time.monotonic() < deadline:
            await asyncio.sleep(0.1)
        drain_s = time.monotonic() - t_drain
        note(f"fan-out drained in {drain_s:.1f}s "
             f"(pending={oracle.pending(limit=50)})")

        # Post-heal CRDT agreement: identical table state everywhere,
        # covering every acked commit (the host plane's serial-merge
        # oracle: the acked-commit set IS the ground truth).
        expected = {k: p[0] for k, p in oracle.committed().items()}
        t_conv = time.monotonic()
        agree = False
        rows_by_agent: list[dict] = []
        while time.monotonic() < deadline + 10.0:
            rows_by_agent = [await _rows_of(ta) for ta in agents]
            covered = all(
                all(r.get(k) == v for k, v in expected.items())
                for r in rows_by_agent
            )
            identical = all(r == rows_by_agent[0] for r in rows_by_agent)
            if covered and identical:
                agree = True
                break
            await asyncio.sleep(0.2)
        convergence_s = time.monotonic() - t_conv
        if not agree:
            counts = [len(r) for r in rows_by_agent]
            failures.append(
                f"CRDT state disagrees post-heal: row counts {counts}, "
                f"expected >= {len(expected)} identical everywhere"
            )

        book_ok, book_fail, heads = _bookkeeping_check(agents)
        failures.extend(book_fail)

        verdict = oracle.finish()
        if verdict["violations"]:
            failures.append(
                f"fan-out oracle: {verdict['violations']} violations: "
                f"{verdict['violation_examples'][:3]}"
            )
        if verdict["commits"] == 0 or verdict["delivered_changes"] == 0:
            failures.append(
                "vacuous run: no commit/delivery traffic — the storm "
                "never exercised anything"
            )

        snapshots = pre_kill_snapshots + [
            ta.agent.metrics.snapshot() for ta in agents
        ]
        machinery = {
            key: _counter_total(snapshots, series)
            for key, series in MACHINERY.items()
        }
        unfired = [
            key for key in spec.require_fired if machinery.get(key, 0) < 1
        ]
        machinery_ok = not unfired
        if unfired:
            # The scenario exists to FORCE these defenses; green
            # invariants with idle defenses mean the harness failed to
            # apply stress, not that the system is robust.
            failures.append(
                f"test-harness failure: scenario was built to force "
                f"{list(spec.require_fired)} but {unfired} never fired "
                f"(machinery={machinery})"
            )

        sub_cost_block = None
        if sub_costs:
            mgr = agents[spec.subs_on].agent.subs
            ledger = mgr.cost_snapshot() if mgr is not None else None
            sub_cost_block = {"enabled": True, "ledger": ledger}
            pre = kill_report.get("cost_pre_kill")
            adopted = kill_report.get("cost_adopted")
            if (
                spec.kill is not None and spec.kill.agent == spec.subs_on
                and pre is not None and pre.get("fanout_events", 0) > 0
                and adopted is not None
                and adopted.get("fanout_events", 0) == 0
                and adopted.get("candidate_evals", 0)
                + adopted.get("fallback_evals", 0) == 0
            ):
                # The previous life demonstrably published (and
                # publishing persists the cost row in the same sub-db
                # transaction as the events), yet the relaunched agent
                # came back with an all-zero ledger: adoption broke.
                failures.append(
                    f"cost-ledger adoption failed: n{spec.kill.agent} "
                    f"relaunched with an empty ledger despite "
                    f"{pre['fanout_events']} pre-kill fan-out events"
                )

        endurance_block = None
        if series_dir is not None:
            # Judge each agent's recorded series (flush-per-line: the
            # record is complete up to the last tick even though the
            # recorders are still open). Replay + detectors live in the
            # jax-free obs modules.
            from corrosion_tpu_torch.obs.endurance import build_report
            from corrosion_tpu_torch.obs.series import replay_series

            per_agent_end: dict[str, dict] = {}
            for i in range(spec.n_agents):
                path = os.path.join(series_dir, f"n{i}.series.jsonl")
                try:
                    samples = replay_series(path)["samples"]
                except OSError:
                    samples = []
                per_agent_end[f"n{i}"] = build_report(
                    samples, label=f"{spec.name}:n{i}",
                    **(endurance_kw or {}),
                )
            endurance_block = {
                "dir": series_dir,
                "interval_s": series_interval,
                "agents": per_agent_end,
            }

        netem_block = {}
        if netem_on:
            per_agent = {}
            for i, ta in enumerate(agents):
                shim = ta.agent.netem
                if shim is None:
                    continue
                per_agent[f"n{i}"] = {
                    "stats": dict(shim.stats),
                    "trace_fingerprint": shim.fingerprint(),
                    "trace_len": len(shim.trace),
                    "trace_overflow": shim.trace_overflow,
                    "trace": shim.trace[:REPORT_TRACE_CAP],
                }
            netem_block = {"seed": seed, "agents": per_agent}

        return {
            "scenario": spec.name,
            "seed": seed,
            "agents": spec.n_agents,
            "plan": plan_obj,
            "writes_requested": spec.writes,
            "routes": {"transactions": harness.route_report("transactions")},
            "oracle": verdict,
            "kill": kill_report or None,
            "drain_s": round(drain_s, 2),
            "convergence_s": round(convergence_s, 2),
            "converged": agree,
            "bookkeeping_contiguous": book_ok,
            "heads": heads,
            "machinery": machinery,
            "machinery_required": list(spec.require_fired),
            "machinery_ok": machinery_ok,
            "endurance": endurance_block,
            "sub_costs": sub_cost_block,
            "netem": netem_block,
            "ok": not failures,
            "failures": failures,
        }
    finally:
        await stop_pumps(pumps)
        await stop_cluster([ta for ta in agents if ta is not None])


def verify_schedule_determinism(report: dict) -> tuple[bool, list[str]]:
    """Replay the fault schedule recorded in a scenario report from its
    (plan, seed) alone: every embedded trace entry must reproduce
    exactly (``hostchaos replay``; docs/CHAOS.md "Host plane")."""
    if "plan" not in report:
        return False, [
            "not a scenario report (no `plan`): pass a `hostchaos run` "
            "report, not the smoke aggregate"
        ]
    netem = report.get("netem") or {}
    plan = HostFaultPlan.from_json(report["plan"])
    seed = int(netem.get("seed", report.get("seed", 0)))
    problems: list[str] = []
    agents = netem.get("agents") or {}
    if not agents:
        if plan.empty:
            # A netem-free scenario (e.g. kill_restart) legitimately
            # records zero decisions: nothing to replay, vacuously green.
            return True, []
        return False, [
            "plan has fault components but the report carries no netem "
            "traces to replay"
        ]
    for name, blk in agents.items():
        ok, mismatches = replay_schedule(plan, seed, name, blk["trace"])
        if not ok:
            problems.extend(f"{name}: {m}" for m in mismatches[:5])
    return not problems, problems

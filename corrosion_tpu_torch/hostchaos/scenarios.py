"""The standing host-chaos scenarios (docs/CHAOS.md "Host plane").

Each is a :class:`~corrosion_tpu_torch.hostchaos.harness.HostScenario`: a
``corro-host-fault-plan/1`` over the transport planes, a write storm +
oracle-checked subscriptions, optional SIGKILL-then-restart, and the
list of defenses the scenario is BUILT to force (``require_fired``) —
windows and agent knobs are tuned together so each required counter is
mechanically guaranteed to tick on a 2-vCPU CI box:

- ``wan_steady``: the 80 ms-RTT / 1 %-loss WAN baseline. Nothing is cut;
  the invariant under test is that ordinary WAN impairment alone causes
  zero oracle violations and full convergence.
- ``partition_heal``: n3 cut from the cluster, then healed into a slow
  sync window. Forces breaker trips (cut link), chunk halvings (sync
  sends slower than the adapt threshold), and stall aborts (sends
  slower than the stall timeout) during n3's catch-up.
- ``link_flap``: one node's links toggle every 0.7 s. Forces breaker
  trips AND recoveries — the flap cadence sits exactly where a breaker
  without success-reset would wedge the link permanently.
- ``kill_restart``: SIGKILL mid-storm (no graceful leave), same-dir
  restart. Forces breaker trips (connection-refused bursts at the dead
  peer) and proves store rehydration + durable-subscription resume.
- ``wan_full``: the acceptance scenario — WAN steady-state impairment +
  partition-then-heal + SIGKILL-then-restart in ONE run, all three
  headline defenses required to fire.
- ``flap_soak``: the long flap/partition churn soak (slow-marked out of
  the tier-1 lane and the CI smoke; the chaos job and `hostchaos run`
  territory).

Counterpart of corrosion_tpu/hostchaos/scenarios.py.
"""

from __future__ import annotations

from corrosion_tpu_torch.agent.netem import HostFault, HostFaultPlan
from corrosion_tpu_torch.hostchaos.harness import HostScenario, KillSpec

# Chaos-compressed agent knobs shared by every scenario: faster probe /
# sync cadence and a sub-second breaker schedule so seconds-long fault
# windows exercise machinery tuned for minutes-long production faults.
_BASE_CFG = dict(
    probe_interval=0.2,
    sync_interval=0.4,
    breaker_base_s=0.5,
    breaker_max_s=2.0,
    announce_backoff_min_s=0.5,
    announce_backoff_max_s=4.0,
    member_persist_interval=2.0,
)

# Sync-defense knobs for scenarios that force the chunker/stall guard:
# halving window sends (~330 ms) sit above the adapt threshold, stall
# window sends (~2.4 s) above the stall timeout.
_SYNC_DEFENSE_CFG = dict(
    _BASE_CFG, sync_adapt_threshold=0.15, sync_stall_timeout=1.2,
)


def _wan(delay_ms: float = 40.0, jitter_ms: float = 10.0,
         loss: float = 0.01) -> tuple:
    """Always-on WAN baseline: one-way delay ± jitter on every plane
    (2x delay ≈ the RTT) + loss on the lossy planes."""
    comps = [HostFault(kind="delay", delay_ms=delay_ms, jitter_ms=jitter_ms)]
    if loss > 0:
        comps.append(
            HostFault(kind="loss", prob=loss, planes=("probe", "bcast"))
        )
    return tuple(comps)


def wan_steady() -> HostScenario:
    return HostScenario(
        name="wan_steady",
        plan=HostFaultPlan(name="wan_steady", faults=_wan()),
        n_agents=3, writes=36, write_rate=8.0, subs=9, sub_groups=3,
        agent_cfg=dict(_BASE_CFG),
        require_fired=(),
        notes="80 ms RTT ± jitter, 1% loss; oracle + convergence only",
    )


def partition_heal() -> HostScenario:
    plan = HostFaultPlan(
        name="partition_heal",
        faults=_wan(10.0, 3.0, 0.0) + (
            HostFault(kind="partition", a=("n3",), start_s=0.5,
                      stop_s=2.5, stall_s=0.25),
            HostFault(kind="delay", planes=("sync",), start_s=2.5,
                      stop_s=6.0, delay_ms=320.0, jitter_ms=40.0),
            HostFault(kind="delay", planes=("sync",), start_s=6.0,
                      stop_s=7.5, delay_ms=2400.0),
        ),
    )
    return HostScenario(
        name="partition_heal",
        plan=plan,
        n_agents=4, writes=70, write_rate=10.0, subs=9, sub_groups=3,
        agent_cfg=dict(_SYNC_DEFENSE_CFG),
        require_fired=("breaker_trips", "chunk_halvings", "stall_aborts"),
        notes="cut n3, heal into a slow-sync window, then a stalled one",
    )


def link_flap() -> HostScenario:
    plan = HostFaultPlan(
        name="link_flap",
        faults=_wan(20.0, 5.0, 0.0) + (
            HostFault(kind="flap", a=("n2",), start_s=0.5, stop_s=4.7,
                      period_s=0.7, stall_s=0.12),
        ),
    )
    return HostScenario(
        name="link_flap",
        plan=plan,
        n_agents=3, writes=40, write_rate=8.0, subs=9, sub_groups=3,
        agent_cfg=dict(_BASE_CFG),
        require_fired=("breaker_trips", "breaker_recoveries"),
        notes="n2's links toggle every 0.7 s: trips AND recoveries",
    )


def kill_restart() -> HostScenario:
    return HostScenario(
        name="kill_restart",
        plan=HostFaultPlan(name="kill_restart"),  # no netem: pure crash
        n_agents=3, writes=50, write_rate=10.0, subs=9, sub_groups=3,
        subs_on=0,
        kill=KillSpec(agent=0, t_kill_s=1.5, t_restart_s=2.7),
        agent_cfg=dict(_BASE_CFG),
        require_fired=("breaker_trips",),
        notes="SIGKILL n0 mid-storm (subs live on it), same-dir restart",
    )


def wan_full() -> HostScenario:
    """The acceptance scenario (ISSUE 14): WAN steady-state + partition-
    then-heal + SIGKILL-then-restart in one seeded run; stall abort,
    chunk halving, and breaker trip must all fire."""
    plan = HostFaultPlan(
        name="wan_full",
        faults=_wan(40.0, 10.0, 0.01) + (
            HostFault(kind="partition", a=("n2",), start_s=2.0,
                      stop_s=4.0, stall_s=0.25),
            HostFault(kind="delay", planes=("sync",), start_s=4.0,
                      stop_s=7.5, delay_ms=320.0, jitter_ms=40.0),
            HostFault(kind="delay", planes=("sync",), start_s=7.5,
                      stop_s=9.0, delay_ms=2400.0),
        ),
    )
    return HostScenario(
        name="wan_full",
        plan=plan,
        n_agents=4, writes=90, write_rate=10.0, subs=12, sub_groups=3,
        subs_on=0,
        kill=KillSpec(agent=0, t_kill_s=3.0, t_restart_s=4.2),
        agent_cfg=dict(_SYNC_DEFENSE_CFG),
        require_fired=("breaker_trips", "chunk_halvings", "stall_aborts"),
        drain_timeout_s=60.0,
        notes="80 ms WAN + 1% loss + partition-heal + SIGKILL-restart",
    )


def flap_soak() -> HostScenario:
    """Long churn soak: minutes-scale flapping + repeated partitions
    under WAN impairment. Slow-marked out of tier-1 AND the CI smoke."""
    plan = HostFaultPlan(
        name="flap_soak",
        faults=_wan(30.0, 8.0, 0.01) + (
            HostFault(kind="flap", a=("n1",), start_s=1.0, stop_s=12.0,
                      period_s=0.9, stall_s=0.12),
            HostFault(kind="partition", a=("n2",), start_s=13.0,
                      stop_s=15.5, stall_s=0.25),
            HostFault(kind="flap", a=("n2",), start_s=17.0, stop_s=24.0,
                      period_s=1.1, stall_s=0.12),
        ),
    )
    return HostScenario(
        name="flap_soak",
        plan=plan,
        n_agents=3, writes=200, write_rate=8.0, subs=9, sub_groups=3,
        agent_cfg=dict(_BASE_CFG),
        require_fired=("breaker_trips", "breaker_recoveries"),
        drain_timeout_s=90.0,
        notes="25 s of flap/partition churn under WAN impairment (soak)",
    )


def soak_churn(scale: float = 1.0) -> HostScenario:
    """The ENDURANCE soak composition (docs/OBSERVABILITY.md "Endurance
    plane"): churn (SIGKILL + same-dir restart) + write storm + WAN
    netem over a CI-sized horizon, run with the metric-series recorder
    armed (``run_scenario(series_dir=...)``) so every agent's registry
    movement feeds the leak/wedge/stall/SLO detectors. ``scale``
    stretches the horizon for the slow-marked long variant (the storm,
    fault windows, and kill schedule all scale together; rates stay
    fixed so total traffic grows with the horizon)."""
    s = scale
    plan = HostFaultPlan(
        name="soak_churn",
        faults=_wan(30.0, 8.0, 0.01) + (
            HostFault(kind="flap", a=("n1",), start_s=1.0 * s,
                      stop_s=4.0 * s, period_s=0.7, stall_s=0.12),
            HostFault(kind="delay", planes=("sync",), start_s=5.0 * s,
                      stop_s=7.0 * s, delay_ms=280.0, jitter_ms=40.0),
        ),
    )
    return HostScenario(
        name="soak_churn",
        plan=plan,
        n_agents=3, writes=int(80 * s), write_rate=10.0,
        subs=9, sub_groups=3, subs_on=0,
        kill=KillSpec(agent=0, t_kill_s=2.0 * s, t_restart_s=3.2 * s),
        agent_cfg=dict(_BASE_CFG),
        require_fired=("breaker_trips", "breaker_recoveries"),
        drain_timeout_s=60.0 * max(1.0, s),
        notes="WAN + flap churn + SIGKILL-restart with the metric-series "
              "recorder armed: the standing endurance lane",
    )


SCENARIOS = {
    "wan_steady": wan_steady,
    "partition_heal": partition_heal,
    "link_flap": link_flap,
    "kill_restart": kill_restart,
    "wan_full": wan_full,
    "flap_soak": flap_soak,
    "soak_churn": soak_churn,
}


def get_scenario(name: str) -> HostScenario:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise ValueError(
            f"unknown host-chaos scenario {name!r}; one of "
            f"{sorted(SCENARIOS)}"
        ) from None

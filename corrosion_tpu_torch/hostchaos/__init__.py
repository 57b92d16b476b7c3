"""Host-plane chaos: deterministic WAN fault injection against real
agents (docs/CHAOS.md "Host plane").

The kernel plane's chaos subsystem (sim/faults.py + sim/invariants.py)
proves the SIMULATED protocol heals; this package proves the HOST
implementation does — the sync stall abort, adaptive chunk halving,
per-peer circuit breaker, announcer backoff, and durable-subscription
resume, all exercised under a seeded network-impairment schedule
(agent/netem.py) composed with the loadgen write storm and fan-out
oracle, ending in post-heal invariants AND a mechanical proof that the
defensive machinery actually fired.

Counterpart of corrosion_tpu/hostchaos/__init__.py.
"""

from corrosion_tpu_torch.hostchaos.harness import (  # noqa: F401
    HostScenario,
    KillSpec,
    MACHINERY,
    run_scenario,
)
from corrosion_tpu_torch.hostchaos.scenarios import SCENARIOS, get_scenario  # noqa: F401

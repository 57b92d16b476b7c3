"""Serving-plane load subsystem: open-loop load generation against a live
agent cluster, with a built-in fan-out correctness oracle.

The agent plane speaks HTTP (/v1/transactions, /v1/queries, NDJSON
subscriptions), PG wire, and per-route admission control (RouteLimit,
agent/api.py) — this package is what exercises all of it above
single-test concurrency and turns the serving behavior into a measured,
CI-gated surface (docs/SERVING.md):

- ``schedule``: fixed **open-loop** arrival schedules. Arrivals fire on a
  wall-clock grid regardless of how fast earlier requests complete, and
  latency is measured from the *scheduled* arrival — so a saturated
  server cannot slow the generator down and hide its own queueing delay
  (the coordinated-omission failure mode of closed-loop harnesses).
- ``oracle``: the fan-out correctness oracle. Every committed transaction
  is registered; every live subscription stream must deliver each
  matching commit exactly once with monotonically increasing change ids.
  The harness is a robustness test first and a benchmark second.
- ``harness``: per-route open-loop drivers with latency histograms
  (``utils.metrics`` bucket machinery) and shed/error accounting split by
  cause (503 load-shed vs transport error vs timeout), plus the
  subscription pump that keeps thousands of NDJSON streams drained and
  reconnects through ``SubscriptionStream.reconnect``.
- ``pgread``: a minimal asyncio PG-wire simple-query client so the PG
  server sits under the same open-loop load as the HTTP routes.
- ``scenarios``: the three standing scenarios behind the ``loadgen`` CLI
  group — ``fanout_storm`` (run), ``saturation_sweep`` (sweep), and
  ``intake_policy`` (soak).
- ``report``: the one self-describing emit path (funnels through
  ``telemetry.check_bench_invariants``) plus the ``serving`` budget gate
  used by the loadgen-smoke CI job.

Counterpart of corrosion_tpu/loadgen/__init__.py.
"""

from corrosion_tpu_torch.loadgen.harness import LoadHarness, SubscriptionPump
from corrosion_tpu_torch.loadgen.oracle import FanoutOracle
from corrosion_tpu_torch.loadgen.schedule import Arrival, open_loop, ramp
from corrosion_tpu_torch.loadgen.report import check_serving_budget, emit_serving_report

__all__ = [
    "Arrival",
    "FanoutOracle",
    "LoadHarness",
    "SubscriptionPump",
    "check_serving_budget",
    "emit_serving_report",
    "open_loop",
    "ramp",
]

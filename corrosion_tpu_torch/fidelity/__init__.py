"""Fidelity plane: calibrated round-length model + mixed-mode
live-vs-kernel validation (docs/FIDELITY.md).

Every kernel artifact rests on the identification "one round-synchronous
simulator step ≙ 500 ms of the reference's event-driven reality"
(SURVEY.md hard part (b)). This package validates and replaces that
identification with a measured one:

- ``calibrate``: the :class:`RoundModel` — a calibrated ``round_ms``
  derived from the broadcast flush tick + measured probe-RTT
  distributions (raw samples or members.rs:33 ring occupancy), plus
  per-region-pair delivery-miss probabilities and SWIM probe-plane loss
  from probe timeout tails. Compiles into the EXISTING chaos-plane
  Schedule axes (``sim.faults.axes_from_rates`` → ``apply_plan``): zero
  new traced code, and the identity model keeps engine traces
  bit-identical.
- ``compare``: the mixed-mode harness — one recorded write workload run
  through BOTH a live loopback agent cluster (traced via
  ``sim.trace.Trace``, per-write visibility sampled from NDJSON
  subscriptions) and the kernel replay, calibrated vs uncalibrated, with
  the divergence quantified in the existing delivery-latency bucket
  space.
- ``scenarios``: the three standing scenarios (steady write load, write
  burst + idle drain, DCN-scale partition-and-heal cross-checked against
  the chaos invariant suite) behind the ``fidelity`` CLI group.
- ``report``: the self-describing emit path
  (``telemetry.check_bench_invariants`` + ``trace_fingerprint``
  provenance) and the ``fidelity`` budget gate used by the fidelity CI
  job — the calibrated-beats-uncalibrated ordering is never
  tolerance-scaled.

``calibrate`` and ``report`` are host-side numpy/stdlib logic; the
heavy halves (live agents, engine runs) load lazily inside
``compare``/``scenarios`` functions. Loading the package imports torch
(through ``sim.faults`` and ``sim.benchlib``) but builds no kernel and
touches no device: the kernel library is built on the first launch.

Counterpart of corrosion_tpu/fidelity/__init__.py.
"""

from corrosion_tpu_torch.fidelity.calibrate import (
    MODEL_SCHEMA,
    REFERENCE_ROUND_MS,
    RoundModel,
    derive_model,
    from_characterization,
    from_ring_occupancy,
    identity_model,
    trace_fingerprint,
)
from corrosion_tpu_torch.fidelity.report import (
    check_fidelity_budget,
    emit_fidelity_report,
    fidelity_context,
)

__all__ = [
    "MODEL_SCHEMA",
    "REFERENCE_ROUND_MS",
    "RoundModel",
    "check_fidelity_budget",
    "derive_model",
    "emit_fidelity_report",
    "fidelity_context",
    "from_characterization",
    "from_ring_occupancy",
    "identity_model",
    "trace_fingerprint",
]

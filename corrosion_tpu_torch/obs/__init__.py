"""Observability plane of the PyTorch/CUDA port (counterpart of
corrosion_tpu/obs/):

- :mod:`~corrosion_tpu_torch.obs.timeline` — causal write timelines
  (``corro-timeline/1``) joined from agent span exports and load-generator
  delivery records, with the latency-budget report;
- :mod:`~corrosion_tpu_torch.obs.journey` — per-write journeys
  reconstructed from a flight record and a recorded write trace;
- :mod:`~corrosion_tpu_torch.obs.costs` — the device-cost plane (the cost
  model counted over dispatched ops, watermarks, the capacity curve);
- :mod:`~corrosion_tpu_torch.obs.ledger` — the kernel library's build and
  load ledger;
- :mod:`~corrosion_tpu_torch.obs.trajectory` — the committed
  ``BENCH_r*``/``MULTICHIP_r*`` artifacts as one series;
- :mod:`~corrosion_tpu_torch.obs.serving` — the ``corro-sub-cost/1``
  ledger, the serving report and its gate;
- :mod:`~corrosion_tpu_torch.obs.epidemic` — the propagation analyzer;
- :mod:`~corrosion_tpu_torch.obs.series` and
  :mod:`~corrosion_tpu_torch.obs.endurance` — metric series and the
  endurance detectors.

``timeline``, ``trajectory``, ``serving``, ``series`` and ``endurance``
import no torch; ``journey`` imports the port's ``sim.telemetry`` when it
runs.
"""

from corrosion_tpu_torch.obs.timeline import (  # noqa: F401
    TIMELINE_SCHEMA,
    build_timeline,
    load_spans,
    timeline_from_run,
)

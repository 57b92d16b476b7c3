"""Elastic survival plane: live mesh resharding and the preemption of a
mesh position, held to the uninterrupted run bit for bit (counterpart of
corrosion_tpu/elastic/).

- ``elastic.reshard``: checkpoint, re-place on another mesh, resume, with
  ``predicted_per_device_bytes`` reconciled exactly before every resume;
- ``elastic.preempt``: a hard kill of one position's block, then recovery
  from the last checkpoint and a replay of the gap;
- ``elastic.scenarios``: the named drills (the reshard matrix,
  ``preempt_dense_churn`` and ``soak_preempt``);
- ``elastic.report``: the bit-exact diff helpers and the ``elastic`` gate
  of ``bench_budget.json``.

The drills run on the card, or on the CPU with ``device="cpu"``.
"""

from corrosion_tpu_torch.elastic.preempt import (
    PreemptRun,
    RecoveryCounters,
    poison_lost_shard,
    run_dense_preempted,
)
from corrosion_tpu_torch.elastic.report import (
    ELASTIC_SCHEMA,
    check_elastic_budget,
    diff_curves,
    diff_trees,
)
from corrosion_tpu_torch.elastic.reshard import (
    ReshardRun,
    place_reconciled,
    run_chunks_resharded,
    run_dense_resharded,
    run_mixed_resharded,
    run_sparse_resharded,
    schedule_slice,
    virtual_mesh,
)
from corrosion_tpu_torch.elastic.scenarios import (
    RESHARD_MATRIX,
    run_preempt_scenario,
    run_reshard_scenario,
    run_scenario,
    scenario_names,
)

__all__ = [
    "ELASTIC_SCHEMA",
    "PreemptRun",
    "RecoveryCounters",
    "ReshardRun",
    "RESHARD_MATRIX",
    "check_elastic_budget",
    "diff_curves",
    "diff_trees",
    "place_reconciled",
    "poison_lost_shard",
    "run_chunks_resharded",
    "run_dense_preempted",
    "run_dense_resharded",
    "run_mixed_resharded",
    "run_preempt_scenario",
    "run_reshard_scenario",
    "run_scenario",
    "run_sparse_resharded",
    "schedule_slice",
    "scenario_names",
    "virtual_mesh",
]

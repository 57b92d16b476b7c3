"""Device-mesh sharding of the cluster simulation (counterpart of
corrosion_tpu/parallel/).

The parallel axis is the virtual node dimension: O(N) and O(N·W) state is
split along its node rows over a ``Mesh`` of positions, and writer heads
and slot metadata replicate. All four engines run partitioned (``simulate_sharded``,
``simulate_sparse_sharded``, ``simulate_chunks_sharded``,
``simulate_mixed_sharded``): every plane of the round (wipe and churn, the
broadcast, SWIM, sync, the sparse engine's cold sync, the chunk plane's
send and partial-need sync, the mixed round's commits, admission and
back-fill, visibility, the health reductions) and of the sparse engine's
epoch boundary (the feasibility check, the rotation, the cold visibility)
runs once per position on its rows, on state that stays in the position's
blocks from the first round to the last. Where a plane reads what other positions own,
the positions exchange it: partial sums, maxima and ORs; the gather of the
``[N]`` alive and incarnation vectors; rows by global index, served by
their owners; entries routed to the owners of their rows; and the
broadcast plane's batched exchange of the pending-queue tables
(``shard_driver``'s module docstring names each).

One controller drives every position, as in the reference, whose tests
run 8 virtual devices in one process. A mesh is a grid of ``torch.device``
positions filled from the visible cards in turn: on one card every
position sits on ``cuda:0``, and the CPU stands in with ``device="cpu"``.

Where the port differs from the reference: the reference lets XLA
partition SWIM, sync, churn and visibility over the sharded state (GSPMD);
the port partitions them by hand, and its results are the same bit for
bit.
"""

from corrosion_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    P,
    Placed,
    make_mesh,
    make_wan_mesh,
    multichip_mesh,
    shard_chunk_state,
    shard_cluster_state,
    shard_mixed_state,
    shard_node_major,
    shard_sparse_state,
    shard_topology,
)
from corrosion_tpu_torch.parallel.shard_driver import (  # noqa: F401
    WholePlaneCheck,
    init_sharded,
    make_sharded_broadcast,
    per_device_state_bytes,
    replicate,
    simulate_chunks_sharded,
    simulate_mixed_sharded,
    simulate_sharded,
    simulate_sparse_sharded,
    traffic_model,
)

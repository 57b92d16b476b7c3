"""Device-mesh sharding of the cluster simulation (counterpart of
corrosion_tpu/parallel/).

The parallel axis is the virtual node dimension: O(N) and O(N·W) state is
split along its node rows over a ``Mesh`` of positions, writer heads and
slot metadata replicate, and the broadcast plane's delivery chain runs
once per position on its rows, fed by one batched exchange of the
pending-queue tables a round (``shard_driver``).

One controller drives every position, as in the reference, whose tests
run 8 virtual devices in one process. A mesh is a grid of ``torch.device``
positions filled from the visible cards in turn: on one card every
position sits on ``cuda:0``, and the CPU stands in with ``device="cpu"``.

Where the port differs from the reference on purpose: the reference lets
XLA partition SWIM, anti-entropy sync, churn and visibility over the
sharded state (GSPMD). The port has no partitioner, so the controller runs
those planes on whole tensors assembled from the position blocks, and only
the broadcast plane runs per position. Results are the same bit for bit;
the placement of those planes' work is not.
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
    make_sharded_broadcast,
    per_device_state_bytes,
    replicate,
    simulate_chunks_sharded,
    simulate_mixed_sharded,
    simulate_sharded,
    simulate_sparse_sharded,
    traffic_model,
)

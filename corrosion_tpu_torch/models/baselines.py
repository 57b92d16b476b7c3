"""Builders for the five BASELINE scenarios, the any-node-writes
variant and the chunk-plane configs (counterpart of
corrosion_tpu/models/baselines.py): ``three_node``, ``churn_32``,
``anti_entropy_1k``, ``merge_10k``, ``wan_100k``, ``anywrite_sparse``,
``mixed_storm`` and ``anti_entropy_chunks``. Each draws what the
reference draws from the same seed, so both packages build identical
configs, topologies and schedules; the dense ones return (config,
Topology, Schedule) with the topology on ``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.ops.chunks import ChunkConfig
from corrosion_tpu_torch.ops.gossip import GossipConfig, make_topology
from corrosion_tpu_torch.ops.swim import SwimConfig
from corrosion_tpu_torch.sim.engine import ClusterConfig, Schedule
from corrosion_tpu_torch.sim.mixed_engine import StreamSpec


def _max_tx(n: int) -> int:
    # foca scales retransmissions ~ log2(cluster size) + margin.
    return max(4, int(math.ceil(math.log2(max(n, 2)))) + 2)


def _cfg(
    n, writers, regions=None, region_rtt=None, swim_kw=None, device=None,
    **gossip_kw,
):
    regions = regions or [n]
    gossip_kw.setdefault("max_transmissions", _max_tx(n))
    g = GossipConfig(n_nodes=n, n_writers=len(writers), **gossip_kw)
    s = SwimConfig(
        n_nodes=n,
        max_transmissions=_max_tx(n),
        suspect_rounds=3,
        gossip_fanout=3,
        **(swim_kw or {}),
    )
    topo = make_topology(
        regions, writers, region_rtt=region_rtt,
        sync_interval=g.sync_interval, device=device,
    )
    return ClusterConfig(swim=s, gossip=g), topo


def three_node(n_inserts: int = 1000, samples: int = 256, device=None):
    """Config 1: 3-node local cluster, single-table schema, 1k INSERTs.
    All three nodes write round-robin, 4 versions per writer per round,
    then the run drains for 30 rounds."""
    cfg, topo = _cfg(3, writers=[0, 1, 2], sync_interval=4, n_cells=256,
                     device=device)
    per_round = 3 * 4
    write_rounds = (n_inserts + per_round - 1) // per_round
    drain = 30
    writes = np.zeros((write_rounds + drain, 3), np.uint32)
    writes[:write_rounds, :] = 4
    # Trim the tail so exactly n_inserts versions commit.
    extra = write_rounds * per_round - n_inserts
    w = 2
    r = write_rounds - 1
    while extra > 0:
        take = min(extra, 4)
        writes[r, w] -= take
        extra -= take
        w -= 1
        if w < 0:
            w, r = 2, r - 1
    sched = Schedule(writes=writes).make_samples(samples)
    return cfg, topo, sched


def churn_32(rounds: int = 400, samples: int = 128, seed: int = 1, device=None):
    """Config 2: 32-node membership churn storm. Ten nodes flap on a
    staggered cadence (down at 40 + 25 i, back 60 rounds later) under a
    light 2% write load; dead writers commit nothing."""
    n = 32
    cfg, topo = _cfg(n, writers=list(range(n)), sync_interval=8, n_cells=256,
                     device=device)
    rng = np.random.default_rng(seed)
    writes = np.zeros((rounds, n), np.uint32)
    write_mask = rng.random((rounds, n)) < 0.02
    writes[write_mask] = 1
    drain = min(40, max(rounds // 4, 1))
    writes[rounds - drain :, :] = 0
    kill = np.zeros((rounds, n), bool)
    revive = np.zeros((rounds, n), bool)
    flappers = rng.choice(n, size=10, replace=False)
    for i, node in enumerate(flappers):
        down_at = 40 + i * 25
        up_at = down_at + 60
        if down_at < rounds:
            kill[down_at, node] = True
        if up_at < rounds:
            revive[up_at, node] = True
    dead = np.zeros(n, bool)
    for r in range(rounds):
        dead |= kill[r]
        dead &= ~revive[r]
        writes[r, dead] = 0
    sched = Schedule(writes=writes, kill=kill, revive=revive).make_samples(samples)
    return cfg, topo, sched


def anti_entropy_1k(n: int = 1000, burst: int = 2000, samples: int = 256,
                    device=None):
    """Config 3: 1k-node anti-entropy. A burst of versions from 16 hot
    writers overwhelms the broadcast budgets; convergence comes through
    version-vector diff and budgeted sync replay (4 regions, sync budget
    512, chunk 128)."""
    writers = list(range(16))
    cfg, topo = _cfg(
        n,
        writers=writers,
        regions=[n // 4] * 4,
        sync_interval=8,
        sync_budget=512,
        sync_chunk=128,
        queue=16,
        n_cells=512,
        device=device,
    )
    per_round = len(writers) * 4
    burst_rounds = (burst + per_round - 1) // per_round
    drain = 120
    writes = np.zeros((burst_rounds + drain, len(writers)), np.uint32)
    writes[:burst_rounds, :] = 4
    sched = Schedule(writes=writes).make_samples(samples)
    return cfg, topo, sched


def merge_10k(n: int = 10_000, rounds: int = 120, samples: int = 256,
              seed: int = 3, device=None):
    """Config 4: 10k nodes, every node a writer (LWW merge storm), 1% of
    writers committing a round, 8 regions, 1024-cell CRDT plane with two
    cells per write, sparse SWIM (``view_capacity=64``), a 40-round drain.
    W = n > ``_FAST_MAX_WRITERS``, so delivery takes the legacy
    sort+scatter path."""
    writers = list(range(n))
    cfg, topo = _cfg(
        n,
        writers=writers,
        regions=[n // 8] * 8,
        sync_interval=5,
        sync_budget=512,
        sync_chunk=128,
        fanout_near=3,
        fanout_far=3,
        queue=24,
        max_transmissions=6,
        rebroadcast_intake=200,
        n_cells=1024,
        cells_per_write=2,
        swim_kw={"view_capacity": 64},
        device=device,
    )
    rng = np.random.default_rng(seed)
    writes = (rng.random((rounds, n)) < 0.01).astype(np.uint32)
    drain = min(40, max(rounds // 3, 1))
    writes[rounds - drain :, :] = 0
    sched = Schedule(writes=writes).make_samples(samples)
    return cfg, topo, sched


def wan_100k(n: int = 100_000, n_regions: int = 20, n_writers: int = 512,
             rounds: int = 240, samples: int = 128, seed: int = 4,
             partition: bool = True, device=None):
    """Config 5: 100k-node partitioned WAN topology — 20 regions on graded
    rings, 512 writers, a region-0 cut at rounds 60-120 (``partition=
    False`` for the steady variant). Same draws and knobs as the
    reference, so both packages build identical configs, topologies and
    schedules from one seed. Returns (ClusterConfig, Topology, Schedule)."""
    rng = np.random.default_rng(seed)
    region_size = n // n_regions
    writers = sorted(rng.choice(n, size=n_writers, replace=False).tolist())
    cfg, topo = _cfg(
        n,
        writers=writers,
        regions=[region_size] * n_regions,
        region_rtt="geo",
        sync_interval=6,
        sync_budget=512,
        sync_chunk=64,
        fanout_near=2,
        fanout_far=1,
        n_cells=256,
        queue=48,
        max_transmissions=6,
        rebroadcast_intake=26,
        rebroadcast_fresh_budget=True,
        rebroadcast_stale=False,
        queue_priority="budget",
        swim_kw={"view_capacity": 64},
        device=device,
    )
    writes = (rng.random((rounds, n_writers)) < 0.05).astype(np.uint32)
    drain = min(80, max(rounds // 3, 1))
    writes[rounds - drain :, :] = 0
    part = None
    if partition:
        part = np.zeros((rounds, n_regions, n_regions), bool)
        part[60:120, 0, :] = True
        part[60:120, :, 0] = True
        part[60:120, 0, 0] = False
    sched = Schedule(writes=writes, partition=part).make_samples(samples)
    return cfg, topo, sched


def anywrite_sparse(
    n: int = 100_000, w_hot: int = 2048, rounds: int = 320,
    n_regions: int = 20, epoch_rounds: int = 16, cohort: int = 768,
    burst_writes: int = 2, samples: int = 256, seed: int = 7,
    k_dev: int = 256, demote_after: int = 1, partition: bool = False,
    device=None,
):
    """Config 5s: any-node-writes at scale over the rotating-slot sparse
    writer plane. Every node may write; each epoch a fresh cohort of
    ``cohort`` random nodes commits ``burst_writes`` versions at distinct
    rounds of its first epoch, then goes quiescent, and the planner rotates
    them through ``w_hot`` hot slots. The last third of the epochs (at
    least two) drain. ``partition=True`` cuts region 0 off for a stretch
    from a quarter of the run. Returns (SparseClusterConfig, Topology,
    Schedule), same draws as the reference."""
    from corrosion_tpu_torch.ops.sparse_writers import SparseConfig
    from corrosion_tpu_torch.sim.sparse_engine import SparseClusterConfig

    rng = np.random.default_rng(seed)
    region_size = n // n_regions
    g = GossipConfig(
        n_nodes=n,
        n_writers=w_hot,
        track_writer_ids=True,
        sync_interval=6,
        sync_budget=512,
        sync_chunk=64,
        fanout_near=3,
        fanout_far=2,
        queue=64,
        max_transmissions=_max_tx(n),
        rebroadcast_intake=8 + cohort * burst_writes // epoch_rounds,
        rebroadcast_fresh_budget=True,
        rebroadcast_stale=False,
        queue_priority="budget",
        n_cells=256,
    )
    s = SwimConfig(
        n_nodes=n,
        max_transmissions=_max_tx(n),
        suspect_rounds=3,
        gossip_fanout=3,
        view_capacity=64,
    )
    sp = SparseConfig(
        epoch_rounds=epoch_rounds, k_dev=k_dev,
        d_max=max(256, cohort + cohort // 2),
        p_max=max(256, cohort + cohort // 2),
        demote_after=demote_after,
    )
    topo = make_topology(
        [region_size] * n_regions,
        np.zeros(w_hot, np.int64),  # slots; rebound per epoch by the engine
        region_rtt="geo",
        sync_interval=g.sync_interval,
        device=device,
    )
    n_epochs = rounds // epoch_rounds
    drain_epochs = max(2, n_epochs // 3)
    writes = np.zeros((rounds, n), np.uint32)
    pool = rng.permutation(n)
    used = 0
    for e in range(n_epochs - drain_epochs):
        take = min(cohort, n - used)
        writers = pool[used:used + take]
        used += take
        for w in writers:
            rs = rng.choice(
                epoch_rounds, size=min(burst_writes, epoch_rounds), replace=False,
            )
            writes[e * epoch_rounds + rs, w] = 1
    part = None
    if partition:
        part = np.zeros((rounds, n_regions, n_regions), bool)
        p0 = rounds // 4
        p1 = p0 + min(60, max(rounds // 4, epoch_rounds))
        part[p0:p1, 0, :] = True
        part[p0:p1, :, 0] = True
        part[p0:p1, 0, 0] = False
    sched = Schedule(writes=writes, partition=part).make_samples(samples)
    return SparseClusterConfig(swim=s, gossip=g, sparse=sp), topo, sched


def mixed_storm(
    n: int = 1000, streams: int = 16, last_seq: int = 2047,
    rounds: int = 200, samples: int = 256, seed: int = 13,
    n_cells: int = 512, device=None,
):
    """Config 3c: the mixed workload. ``streams`` large multi-chunk
    transactions disseminate seq by seq while a background version-
    granular write storm (64 writers at ~4% a round, 4 regions, a drained
    last third) flows through the same rounds; stream s is writer s's one
    large transaction, committed between rounds/8 and rounds/2. Its
    version is the writer's next version at the commit round, and sampled
    small versions at or after it shift up by one. ``n_cells=0`` drops the
    CRDT plane. Same draws as the reference. Returns (ClusterConfig,
    ChunkConfig, Topology, Schedule, StreamSpec)."""
    writers = list(range(64))
    cfg, topo = _cfg(
        n,
        writers=writers,
        regions=[n // 4] * 4,
        sync_interval=8,
        sync_budget=512,
        sync_chunk=128,
        queue=16,
        n_cells=n_cells,
        device=device,
    )
    rng = np.random.default_rng(seed)
    writes = (rng.random((rounds, len(writers))) < 0.04).astype(np.uint32)
    drain = min(60, max(rounds // 3, 1))
    writes[rounds - drain :, :] = 0
    commit_round = np.sort(
        rng.integers(rounds // 8, rounds // 2, streams)
    ).astype(np.int32)
    version = np.zeros(streams, np.uint32)
    for s in range(streams):
        version[s] = writes[: commit_round[s], s].sum() + 1
    spec = StreamSpec(
        writer=np.arange(streams, dtype=np.int32),
        version=version,
        commit_round=commit_round,
        last_seq=np.full(streams, last_seq, np.int32),
    )
    ccfg = ChunkConfig(
        n_nodes=n, n_streams=streams, cap=16, chunk_len=256, fanout=3, k_in=6,
        sync_interval=5, gap_requests=4, sync_seq_budget=4096,
    )
    sched = Schedule(writes=writes).make_samples(samples)
    # The big version takes the slot the per-column count would give.
    for i in range(len(sched.sample_writer)):
        w = sched.sample_writer[i]
        if w < streams and sched.sample_ver[i] >= version[w]:
            sched.sample_ver[i] += 1
    return cfg, ccfg, topo, sched, spec


def anti_entropy_chunks(
    n: int = 1000, streams: int = 16, last_seq: int = 8191,
    rounds: int = 240, device=None,
):
    """Config 3b: the seq-chunk plane at BASELINE-3 scale. ``streams``
    distinct origin nodes each commit one large transaction of
    ``last_seq + 1`` seqs that disseminates as 256-seq chunks with
    partial-need sync reassembling the gaps. Same draws as the reference.
    Returns (ChunkConfig, origin[S], last_seq[S], rounds), the two arrays
    as int64 tensors on ``device``, for ``sim.chunk_engine.simulate_chunks``."""
    device = resolve_device(device)
    rng = np.random.default_rng(11)
    cfg = ChunkConfig(
        n_nodes=n, n_streams=streams, cap=16, chunk_len=256, fanout=3, k_in=6,
        sync_interval=5, gap_requests=4, sync_seq_budget=4096,
    )
    origin = np.sort(rng.choice(n, size=streams, replace=False))
    ls = np.full((streams,), last_seq, np.int64)
    return (
        cfg,
        torch.as_tensor(origin.astype(np.int64), device=device),
        torch.as_tensor(ls, device=device),
        rounds,
    )

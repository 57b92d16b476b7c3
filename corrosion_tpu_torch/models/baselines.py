"""Builders for the BASELINE scenarios (counterpart of
corrosion_tpu/models/baselines.py). This slice ports ``wan_100k``, the
north-star deployment; the other builders need the dense SWIM view,
churn or the legacy delivery path and come with later slices.
"""

from __future__ import annotations

import math

import numpy as np

from corrosion_tpu_torch.ops.gossip import GossipConfig, make_topology
from corrosion_tpu_torch.ops.swim import SwimConfig
from corrosion_tpu_torch.sim.engine import ClusterConfig, Schedule


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

"""The geo epidemic scenario family and its adaptive-dissemination tuning
(the scenario part of corrosion_tpu/sim/health.py).

``churned_demo_cluster`` builds the reference's committed convergence and
epidemic scenarios, drawing what the reference draws from the same seed.
``ADAPTIVE_GOSSIP`` is the reference's committed tuning of the three
adaptive mechanisms, and ``with_adaptive`` sets it on a config. The rest
of the reference's module (the convergence analyzer ``ConvergenceReport``,
flight replay, report diffs) is not ported yet.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from corrosion_tpu_torch.models.baselines import _cfg
from corrosion_tpu_torch.sim.engine import Schedule

GEO_REGIONS = 4  # region count of the geo scenario family (<= PROP_REGIONS)

# The three mechanisms composed, as the reference's epidemic smoke, its
# `obs record --adaptive` and its tests run them.
ADAPTIVE_GOSSIP = {
    "rumor_kill_k": 2,
    "pull_switch_age": 2,
    "age_forward": True,
}


def churned_demo_cluster(
    nodes: int = 128,
    rounds: int = 64,
    samples: int = 64,
    churn: bool = True,
    seed: int = 0,
    geo: bool = False,
    adaptive: bool = False,
    device=None,
):
    """Small dense cluster with a kill/revive wave of ``nodes // 16``
    non-writer nodes (killed at ``rounds // 4``, revived by ``rounds //
    2``), writers at 15% a round and a drained last third. ``geo=True``:
    ``GEO_REGIONS`` regions on the circle geography, writers spread
    around it, ``prop_observe`` on; ``adaptive=True`` (geo only) adds
    ``ADAPTIVE_GOSSIP``. Returns (ClusterConfig, Topology, Schedule,
    kill_rounds), the topology on ``device``."""
    n_writers = max(4, min(16, nodes // 8))
    if adaptive and not geo:
        raise ValueError(
            "adaptive=True is defined for the geo scenario family only "
            "(the flat variant's RNG stream is pinned pre-adaptive)"
        )
    adaptive_kw = dict(ADAPTIVE_GOSSIP) if adaptive else {}
    if geo:
        sizes = [nodes // GEO_REGIONS] * GEO_REGIONS
        sizes[-1] += nodes - sum(sizes)
        writers = sorted({
            min(round(i * nodes / n_writers), nodes - 1) for i in range(n_writers)
        })
        n_writers = len(writers)
        cfg, topo = _cfg(
            nodes, writers=writers, regions=sizes, region_rtt="geo",
            sync_interval=5, n_cells=0, prop_observe=True, device=device,
            **adaptive_kw,
        )
        writer_set = set(writers)
        non_writers = np.asarray([i for i in range(nodes) if i not in writer_set])
    else:
        cfg, topo = _cfg(
            nodes, writers=list(range(n_writers)), sync_interval=5, n_cells=0,
            device=device,
        )
        non_writers = np.arange(n_writers, nodes)
    rng = np.random.default_rng(seed)
    writes = (rng.random((rounds, n_writers)) < 0.15).astype(np.uint32)
    drain = max(rounds // 3, 1)
    writes[rounds - drain :, :] = 0
    kill = revive = None
    kill_rounds: list[int] = []
    if churn and rounds >= 16:
        kill = np.zeros((rounds, nodes), bool)
        revive = np.zeros((rounds, nodes), bool)
        victims = rng.choice(non_writers, size=max(nodes // 16, 1), replace=False)
        k_at = rounds // 4
        r_at = min(rounds // 2, rounds - drain)
        kill[k_at, victims] = True
        revive[r_at, victims] = True
        kill_rounds = [k_at]
    sched = Schedule(writes=writes, kill=kill, revive=revive).make_samples(samples)
    return cfg, topo, sched, kill_rounds


def with_adaptive(cfg, **gossip_kw):
    """``cfg`` (any engine's config) with ``ADAPTIVE_GOSSIP`` and
    ``gossip_kw`` set on its gossip config: ``with_adaptive(cfg,
    sync_sketch_buckets=8)`` is the reference tests' ``composed_sketch``
    tuning."""
    return replace(cfg, gossip=replace(cfg.gossip, **ADAPTIVE_GOSSIP, **gossip_kw))

"""Preemption of one mesh position: its block of the state is destroyed
mid-run, the run recovers from its last checkpoint, and nothing is lost
(counterpart of corrosion_tpu/elastic/preempt.py).

The fault model is a hard kill (``Agent.abort``): the preempted
position's block of every split leaf is destroyed at the event round,
with no drain. Recovery re-places the latest checkpoint and replays the
gap rounds. The kill is made real (the poisoned state is built and held
against the live one: a preemption that changes no bytes is a harness
fault) and the recovery honest (each replayed segment's curves must equal
the first pass's).

Preempt events live on the fault plane (``sim/faults.py``, kind
``preempt``) but execute here: ``FaultPlan.kernel_plan()`` strips them
from what the engines see and ``preempt_events()`` is this driver's
worklist.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from corrosion_tpu_torch.elastic.reshard import (
    _ckpt_path,
    mesh_dims,
    place_reconciled,
    schedule_slice,
)
from corrosion_tpu_torch.parallel import mesh as mesh_mod
from corrosion_tpu_torch.parallel import shard_driver
from corrosion_tpu_torch.parallel.mesh import P
from corrosion_tpu_torch.sim import checkpoint as checkpoint_mod


@dataclass
class RecoveryCounters:
    """Did the recovery machinery run? A preemption scenario that passes
    with these at zero proves nothing (the machinery-fired rule)."""

    preempts_fired: int = 0
    checkpoint_loads: int = 0
    shards_rematerialized: int = 0
    gap_rounds_replayed: int = 0

    def fired(self) -> bool:
        return (
            self.preempts_fired > 0
            and self.checkpoint_loads > 0
            and self.shards_rematerialized > 0
        )

    def to_dict(self) -> dict:
        return {
            "preempts_fired": self.preempts_fired,
            "checkpoint_loads": self.checkpoint_loads,
            "shards_rematerialized": self.shards_rematerialized,
            "gap_rounds_replayed": self.gap_rounds_replayed,
            "fired": self.fired(),
        }


def _garbage(dtype):
    """The dtype's extreme value: True, the integer maximum, NaN."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).max


def poison_lost_shard(host_tree, specs, mesh, device_index: int):
    """Destroy position ``device_index``'s block of every split leaf of a
    host copy of the state (dtype-extreme garbage, no drain); replicated
    leaves survive, as the other replicas still hold them. Returns
    ``(poisoned_tree, n_leaves_poisoned)``. Every split leaf must split
    one dimension by the full mesh size (the node-major row blocks of the
    spec builders), so block i is position i."""
    d = int(mesh.size)
    if not 0 <= device_index < d:
        raise ValueError(f"device {device_index} outside mesh of {d}")
    count = [0]

    def one(leaf, spec):
        arr = mesh_mod._as_tensor(leaf).clone()
        split = [
            (dim, mesh_mod.spec_shard_factor(P(e), mesh)) for dim, e in enumerate(spec)
            if e is not None and mesh_mod.spec_shard_factor(P(e), mesh) > 1
        ]
        if not split:
            return arr
        if len(split) != 1 or split[0][1] != d:
            raise NotImplementedError(
                f"poison_lost_shard only handles one dim split {d} ways; got "
                f"{spec} on {mesh_dims(mesh)}"
            )
        dim, f = split[0]
        block = arr.shape[dim] // f
        arr.narrow(dim, device_index * block, block).fill_(_garbage(arr.dtype))
        count[0] += 1
        return arr

    poisoned = mesh_mod.tree_map(one, host_tree, specs)
    return poisoned, count[0]


@dataclass
class PreemptRun:
    """One preempted-and-recovered dense run: the final state, the
    stitched curves (replayed segments held to the first pass first) and
    the recovery evidence."""

    rounds: int
    events: list  # [(round, position)]
    checkpoint_every: int
    final: object
    curves: dict
    counters: RecoveryCounters
    facts: dict = field(default_factory=dict)
    wall_s: dict = field(default_factory=dict)


def run_dense_preempted(
    cfg, topo, sched, mesh, events, checkpoint_every: int, seed: int = 0,
    checkpoint_dir: str | None = None, fingerprint: str = "", telemetry=None,
) -> PreemptRun:
    """A dense run under preemption: advance in ``checkpoint_every``-
    aligned segments, snapshot at each boundary, and at each ``(round,
    position)`` event kill that position's block, reload the latest
    checkpoint, replay the gap (its curves held to the first pass) and go
    on. ``events`` is a ``FaultPlan.preempt_events()`` worklist."""
    ce = int(checkpoint_every)
    if ce <= 0:
        raise ValueError("checkpoint_every must be positive")
    events = sorted((int(r), int(d)) for r, d in events)
    rounds = sched.rounds
    for p_round, _dev in events:
        if not 0 <= p_round < rounds:
            raise ValueError(f"preempt round {p_round} outside run")

    counters = RecoveryCounters()
    wall = {"advance": 0.0, "checkpoint": 0.0, "recover": 0.0}
    segs: dict = {}  # start round -> curves, for the replay compare
    replay_mismatches: list = []
    checkpoints_taken: list = []
    reconciles: list = []
    n_samples = len(sched.sample_writer)

    state = shard_driver.init_sharded(cfg, n_samples, mesh)
    ckpt = {"round": 0, "host": mesh_mod.to_host(state)}

    def specs_for(host):
        return mesh_mod.cluster_state_specs(host, mesh)

    def take_checkpoint(state, r):
        t = time.perf_counter()
        host = mesh_mod.to_host(state)
        path = _ckpt_path(checkpoint_dir, f"preempt_r{r}.npz")
        if path is not None:
            checkpoint_mod.save_state(path, host, fingerprint=fingerprint, mesh_shape=mesh_dims(mesh))
            host = checkpoint_mod.load_state(
                path, cfg, n_samples, expect_fingerprint=fingerprint, device="cpu"
            )
        ckpt.update(round=r, host=host)
        checkpoints_taken.append(r)
        wall["checkpoint"] += time.perf_counter() - t

    def advance(state, r_from, r_to, replay: bool):
        """Segment by segment over every grid boundary, so checkpoints land
        where the first pass took them."""
        kind = "recover" if replay else "advance"
        r = r_from
        while r < r_to:
            t = time.perf_counter()
            nxt = min(r_to, (r // ce + 1) * ce)
            state, curves = shard_driver.simulate_sharded(
                cfg, topo, schedule_slice(sched, r, nxt), mesh, seed=seed, state=state,
                telemetry=telemetry,
            )
            if replay and r in segs:
                bad = [k for k in segs[r] if not np.array_equal(segs[r][k], curves[k])]
                if bad:
                    replay_mismatches.append({"round": r, "keys": bad})
            segs[r] = curves
            wall[kind] += time.perf_counter() - t
            r = nxt
            if not replay and r % ce == 0 and r < r_to:
                take_checkpoint(state, r)
        return state

    poison_changed = True
    r = 0
    for p_round, device in events:
        state = advance(state, r, p_round, replay=False)
        if p_round % ce == 0 and p_round > r:
            # advance() skips the boundary at its own end; the event
            # interrupts the run exactly there, so take that snapshot.
            take_checkpoint(state, p_round)

        # The kill: what the cluster would hold with this position's block
        # destroyed, held against the live state.
        counters.preempts_fired += 1
        live_host = mesh_mod.to_host(state)
        poisoned, n_leaves = poison_lost_shard(live_host, specs_for(live_host), mesh, device)
        changed = any(
            not torch.equal(a, b)
            for a, b in zip(mesh_mod.tree_leaves(live_host), mesh_mod.tree_leaves(poisoned))
        )
        poison_changed = poison_changed and changed and n_leaves > 0
        del state, poisoned  # the live state died with the position

        # Recovery: the latest checkpoint and a replay of the gap. The
        # poisoned state is never read.
        t = time.perf_counter()
        counters.checkpoint_loads += 1
        state, rec = place_reconciled(ckpt["host"], specs_for(ckpt["host"]), mesh)
        reconciles.append({**rec, "round": ckpt["round"]})
        counters.shards_rematerialized += 1
        wall["recover"] += time.perf_counter() - t
        counters.gap_rounds_replayed += p_round - ckpt["round"]
        state = advance(state, ckpt["round"], p_round, replay=True)
        r = p_round

    state = advance(state, r, rounds, replay=False)
    starts = sorted(segs)
    curves = {
        k: np.concatenate([segs[s][k] for s in starts]) for k in segs[starts[0]]
    } if starts else {}
    return PreemptRun(
        rounds=rounds, events=events, checkpoint_every=ce, final=state, curves=curves,
        counters=counters,
        facts={
            "poison_changed": bool(poison_changed),
            "replay_identical": not replay_mismatches,
            "replay_mismatches": replay_mismatches,
            "checkpoints": checkpoints_taken,
            "reconciles": reconciles,
        },
        wall_s=wall,
    )

"""Live mesh resharding: checkpoint, re-place, resume, held to the
uninterrupted run bit for bit (counterpart of
corrosion_tpu/elastic/reshard.py).

1. run the prefix ``[0, split)`` sharded on ``mesh_from``;
2. gather the carried state to the host at the chunk boundary
   (optionally through the ``corro-checkpoint/1`` file format,
   ``sim/checkpoint.py``, with the source mesh's dims in its header);
3. re-place it under the same ``*_specs`` builders on ``mesh_to`` and
   hold ``predicted_per_device_bytes`` to the bytes every position
   holds, exactly, before resuming (a placement that misses its
   prediction is refused);
4. resume the driver over the tail ``[split, rounds)``.

The resharded run's curves (the mesh-dependent xshard keys of the
prefix excepted) and final state must equal the uninterrupted run's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from corrosion_tpu_torch.parallel import mesh as mesh_mod
from corrosion_tpu_torch.parallel import shard_driver
from corrosion_tpu_torch.parallel.mesh import P, mesh_dims
from corrosion_tpu_torch.sim import checkpoint as checkpoint_mod


def virtual_mesh(d: int, device=None):
    """The standard mesh of ``d`` positions: 2-D (dcn, ici) from 4 up, 1-D
    below (``parallel.multichip_mesh``), so pairs like 4->8 cross the
    multi-axis placement."""
    return mesh_mod.multichip_mesh(d, device=device)


def schedule_slice(sched, start: int, stop: int):
    """The ``[start, stop)`` window of a Schedule: writes and every fault
    axis sliced, samples kept absolute (the engines track visibility in
    absolute rounds)."""
    return sched.slice(start, stop)


def place_reconciled(host_tree, specs, mesh):
    """Place a host state tree on ``mesh`` under ``specs`` and hold the
    arithmetic to the placement: ``predicted_per_device_bytes`` must equal
    every position's ``per_device_state_bytes`` exactly, or this raises.
    Returns ``(placed_tree, reconcile_dict)``."""
    predicted = mesh_mod.predicted_per_device_bytes(host_tree, specs, mesh)
    placed = mesh_mod.place(host_tree, specs, mesh)
    measured = shard_driver.per_device_state_bytes(placed)
    bad = {str(pos): int(b) for pos, b in measured.items() if b != predicted}
    if len(measured) != mesh.size or bad:
        raise ValueError(
            f"reshard byte reconcile failed on {mesh_dims(mesh)}: predicted "
            f"{predicted} B/position, live mismatches {bad}, "
            f"{len(measured)}/{mesh.size} positions reporting"
        )
    return placed, {
        "predicted_per_device_bytes": int(predicted),
        "devices": int(mesh.size),
        "mesh": list(mesh_dims(mesh)),
        "ok": True,
    }


@dataclass
class ReshardRun:
    """One checkpoint -> reshard -> resume run (engine-specific
    ``final``; the scenario layer compares it with the uninterrupted
    run)."""

    engine: str
    mesh_from: tuple
    mesh_to: tuple
    split: int  # rounds before the reshard (epochs * e_len for sparse)
    final: object
    prefix_curves: dict
    tail_curves: dict
    reconcile: dict
    checkpoint: dict | None  # corro-checkpoint/1 header of the round trip
    wall_s: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)


def _ckpt_path(checkpoint_dir: str | None, name: str) -> str | None:
    if checkpoint_dir is None:
        return None
    os.makedirs(checkpoint_dir, exist_ok=True)
    return os.path.join(checkpoint_dir, name)


def run_dense_resharded(
    cfg, topo, sched, mesh_from, mesh_to, split_round: int, seed: int = 0,
    checkpoint_dir: str | None = None, fingerprint: str = "", telemetry=None,
) -> ReshardRun:
    """Dense engine: ``[0, split_round)`` on ``mesh_from``, checkpoint and
    reshard, ``[split_round, rounds)`` on ``mesh_to``."""
    if not (0 < split_round < sched.rounds):
        raise ValueError(f"split_round must be inside (0, {sched.rounds}), got {split_round}")
    wall: dict = {}
    t = time.perf_counter()
    state = shard_driver.init_sharded(cfg, len(sched.sample_writer), mesh_from)
    state, prefix_curves = shard_driver.simulate_sharded(
        cfg, topo, schedule_slice(sched, 0, split_round), mesh_from, seed=seed,
        state=state, telemetry=telemetry,
    )
    wall["prefix"] = time.perf_counter() - t

    t = time.perf_counter()
    host = mesh_mod.to_host(state)
    header = None
    path = _ckpt_path(checkpoint_dir, "dense_reshard.npz")
    if path is not None:
        checkpoint_mod.save_state(path, host, fingerprint=fingerprint, mesh_shape=mesh_dims(mesh_from))
        host = checkpoint_mod.load_state(
            path, cfg, len(sched.sample_writer), expect_fingerprint=fingerprint, device="cpu"
        )
        header = checkpoint_mod.read_header(path)
    wall["checkpoint"] = time.perf_counter() - t

    t = time.perf_counter()
    placed, reconcile = place_reconciled(host, mesh_mod.cluster_state_specs(host, mesh_to), mesh_to)
    wall["reshard"] = time.perf_counter() - t

    t = time.perf_counter()
    final, tail_curves = shard_driver.simulate_sharded(
        cfg, topo, schedule_slice(sched, split_round, sched.rounds), mesh_to, seed=seed,
        state=placed, telemetry=telemetry,
    )
    wall["tail"] = time.perf_counter() - t
    return ReshardRun(
        engine="dense", mesh_from=mesh_dims(mesh_from), mesh_to=mesh_dims(mesh_to),
        split=split_round, final=final, prefix_curves=prefix_curves,
        tail_curves=tail_curves, reconcile=reconcile, checkpoint=header, wall_s=wall,
    )


def run_sparse_resharded(
    cfg, topo, sched, mesh_from, mesh_to, split_epoch: int, seed: int = 0,
    checkpoint_dir: str | None = None, fingerprint: str = "", telemetry=None,
) -> ReshardRun:
    """Sparse (any-node-writes) engine, whose epochs are its chunk
    boundaries: ``split_epoch`` epochs on ``mesh_from``, the resume point
    persisted with the schedule's fault axes, reshard, the remaining
    epochs on ``mesh_to`` against the full schedule."""
    wall: dict = {}
    t = time.perf_counter()
    *_pre, prefix_curves, info = shard_driver.simulate_sparse_sharded(
        cfg, topo, sched, mesh_from, seed=seed, stop_after_epoch=split_epoch - 1,
        telemetry=telemetry,
    )
    resume = info["resume"]
    wall["prefix"] = time.perf_counter() - t

    t = time.perf_counter()
    host = {
        "sstate": mesh_mod.to_host(resume["sstate"]),
        "swim": mesh_mod.to_host(resume["swim"]),
        "vis_round": mesh_mod.to_host(resume["vis_round"]),
        "planner": resume["planner"],
        "next_epoch": int(resume["next_epoch"]),
    }
    header = None
    path = _ckpt_path(checkpoint_dir, "sparse_reshard.npz")
    if path is not None:
        checkpoint_mod.save_sparse_resume(
            path, host, schedule=sched, fingerprint=fingerprint, mesh_shape=mesh_dims(mesh_from),
        )
        host = checkpoint_mod.load_sparse_resume(
            path, cfg, len(sched.sample_writer), expect_fingerprint=fingerprint, device="cpu",
        )
        # The persisted fault axes must agree with (or restore) the
        # schedule the resumed run replays.
        sched = checkpoint_mod.attach_resume_faults(sched, host)
        header = checkpoint_mod.read_header(path)
    wall["checkpoint"] = time.perf_counter() - t

    t = time.perf_counter()
    tree = (host["sstate"], host["swim"], host["vis_round"])
    placed, reconcile = place_reconciled(tree, shard_driver.sparse_specs(tree, mesh_to), mesh_to)
    resume2 = {
        "sstate": placed[0], "swim": placed[1], "vis_round": placed[2],
        "planner": host["planner"], "next_epoch": int(host["next_epoch"]),
    }
    wall["reshard"] = time.perf_counter() - t

    t = time.perf_counter()
    sstate, swim_state, vis_round, tail_curves, info2 = shard_driver.simulate_sparse_sharded(
        cfg, topo, sched, mesh_to, seed=seed, resume=resume2, telemetry=telemetry,
    )
    wall["tail"] = time.perf_counter() - t
    return ReshardRun(
        engine="sparse", mesh_from=mesh_dims(mesh_from), mesh_to=mesh_dims(mesh_to),
        split=split_epoch * int(cfg.sparse.epoch_rounds), final=(sstate, swim_state, vis_round),
        prefix_curves=prefix_curves, tail_curves=tail_curves, reconcile=reconcile,
        checkpoint=header, wall_s=wall,
        extra={"split_epoch": split_epoch, "epochs": info2["epochs"]},
    )


def run_chunks_resharded(
    ccfg, origin, last_seq, rounds: int, mesh_from, mesh_to, split_round: int, seed: int = 0,
    checkpoint_dir: str | None = None, fingerprint: str = "", telemetry=None,
) -> ReshardRun:
    """Seq-chunk engine: the coverage state and the visibility latch carry
    across the reshard; the resumed call folds ``start_round`` into its
    round keys."""
    from corrosion_tpu_torch.ops import chunks as chunk_ops

    wall: dict = {}
    t = time.perf_counter()
    state, m1 = shard_driver.simulate_chunks_sharded(
        ccfg, origin, last_seq, split_round, mesh_from, seed=seed, telemetry=telemetry,
    )
    wall["prefix"] = time.perf_counter() - t

    t = time.perf_counter()
    host = mesh_mod.to_host((state, m1["vis"]))
    header = None
    path = _ckpt_path(checkpoint_dir, "chunk_reshard.npz")
    if path is not None:
        checkpoint_mod.save_tree(
            path, host, fingerprint=fingerprint, mesh_shape=mesh_dims(mesh_from),
            round_index=split_round,
        )
        template = (
            chunk_ops.init_chunks(ccfg, np.asarray(origin), np.asarray(last_seq), "cpu"),
            host[1],
        )
        host = checkpoint_mod.load_tree(path, template, expect_fingerprint=fingerprint, device="cpu")
        header = checkpoint_mod.read_header(path)
    wall["checkpoint"] = time.perf_counter() - t

    t = time.perf_counter()
    node = shard_driver.node_spec_entry(mesh_to)
    specs = (mesh_mod.node_major_specs(host[0], mesh_to), P(node, None))
    placed, reconcile = place_reconciled(host, specs, mesh_to)
    wall["reshard"] = time.perf_counter() - t

    t = time.perf_counter()
    final, m2 = shard_driver.simulate_chunks_sharded(
        ccfg, origin, last_seq, rounds - split_round, mesh_to, seed=seed,
        state=placed[0], vis=placed[1], start_round=split_round, telemetry=telemetry,
    )
    wall["tail"] = time.perf_counter() - t
    return ReshardRun(
        engine="chunk", mesh_from=mesh_dims(mesh_from), mesh_to=mesh_dims(mesh_to),
        split=split_round, final=(final, m2["vis"]), prefix_curves=m1["curves"],
        tail_curves=m2["curves"], reconcile=reconcile, checkpoint=header, wall_s=wall,
        extra={"metrics": {k: v for k, v in m2.items() if k not in ("curves", "vis")}},
    )


def run_mixed_resharded(
    cfg, ccfg, topo, sched, streams, mesh_from, mesh_to, split_round: int, seed: int = 0,
    checkpoint_dir: str | None = None, fingerprint: str = "", telemetry=None,
) -> ReshardRun:
    """Mixed chunk+version engine: the carried MixedState's ``round``
    anchors the tail in absolute rounds."""
    from corrosion_tpu_torch.sim import mixed_engine

    wall: dict = {}
    t = time.perf_counter()
    state, prefix_curves = shard_driver.simulate_mixed_sharded(
        cfg, ccfg, topo, schedule_slice(sched, 0, split_round), streams, mesh_from, seed=seed,
        telemetry=telemetry,
    )
    wall["prefix"] = time.perf_counter() - t

    t = time.perf_counter()
    host = mesh_mod.to_host(state)
    header = None
    path = _ckpt_path(checkpoint_dir, "mixed_reshard.npz")
    if path is not None:
        checkpoint_mod.save_tree(
            path, host, fingerprint=fingerprint, mesh_shape=mesh_dims(mesh_from),
            round_index=split_round,
        )
        template = mixed_engine.init_mixed_state(cfg, ccfg, topo, sched, streams, "cpu")
        host = checkpoint_mod.load_tree(path, template, expect_fingerprint=fingerprint, device="cpu")
        header = checkpoint_mod.read_header(path)
    wall["checkpoint"] = time.perf_counter() - t

    t = time.perf_counter()
    placed, reconcile = place_reconciled(host, mesh_mod.mixed_state_specs(host, mesh_to), mesh_to)
    wall["reshard"] = time.perf_counter() - t

    t = time.perf_counter()
    final, tail_curves = shard_driver.simulate_mixed_sharded(
        cfg, ccfg, topo, schedule_slice(sched, split_round, sched.rounds), streams, mesh_to,
        seed=seed, state=placed, telemetry=telemetry,
    )
    wall["tail"] = time.perf_counter() - t
    return ReshardRun(
        engine="mixed", mesh_from=mesh_dims(mesh_from), mesh_to=mesh_dims(mesh_to),
        split=split_round, final=final, prefix_curves=prefix_curves, tail_curves=tail_curves,
        reconcile=reconcile, checkpoint=header, wall_s=wall,
    )

"""Simulation checkpoint / resume and schedule persistence (counterpart of
corrosion_tpu/sim/checkpoint.py).

A state snapshot plus its scripted ``Schedule`` is a replayable trace:
``simulate(state=...)`` chains runs and folds the absolute round into
each round's key, so a save/resume sequence equals an uninterrupted run.

The file format is the reference's ``corro-checkpoint/1``, so a
checkpoint written by either package loads in the other: one
compressed ``.npz`` per snapshot holding the leaves as ``leaf0``,
``leaf1``, ... in the reference's pytree order, their paths under
``__paths__`` (``jax.tree_util.keystr`` strings: ``.data.head`` for a
NamedTuple field, ``[0]`` for a tuple item, ``['k']`` for a dict key;
``None`` leaves dropped), and a JSON ``__header__`` with the schema,
kind, config fingerprint, mesh dims and round. Leaves are stored in the
reference's dtypes (u32, i32, bool: ``interop.to_numpy``) and load back
into the port's int64 carriers; a state placed over a mesh saves whole.
The fingerprint is a string the caller passes; loaders refuse a
mismatched one.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from corrosion_tpu_torch import interop, resolve_device
from corrosion_tpu_torch.sim.engine import ClusterState, Schedule, init_cluster

CHECKPOINT_SCHEMA = "corro-checkpoint/1"

# Fault axes save_schedule persists and sparse resume points carry: a
# resumed run must replay its fault plan.
FAULT_AXES = ("kill", "revive", "partition", "loss", "probe_loss", "wipe")


def _flatten(tree, prefix: str = "", name: str = ""):
    """[(keystr path, leaf, field name)] in the reference's pytree order:
    NamedTuple fields and sequence items in order, dict keys sorted,
    ``None`` dropped. The field name picks a leaf's reference dtype."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _flatten(getattr(tree, f), f"{prefix}.{f}", f)]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}[{i}]", name)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], f"{prefix}[{k!r}]", k)]
    return [(prefix, tree, name)]


def _paths(tree) -> list[str]:
    return [p for p, _, _ in _flatten(tree)]


def _as_reference(leaf, name: str) -> np.ndarray:
    """A leaf as the reference stores it (u32, i32 or bool)."""
    if torch.is_tensor(leaf):
        return interop.to_numpy(leaf, name)
    return np.asarray(leaf)


def _unflatten(template, leaves, device):
    """``template``'s structure with its tensor leaves replaced, in order,
    by ``leaves`` moved into the port's carriers (int64; bool stays)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        a = np.asarray(next(it))
        return torch.as_tensor(
            a.astype(np.bool_ if a.dtype == np.bool_ else np.int64), device=device
        )

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more checkpoint leaves than the template holds")
    return out


def _header_array(kind: str, fingerprint: str, mesh_shape, round_index):
    header = {
        "schema": CHECKPOINT_SCHEMA,
        "kind": kind,
        "config_fingerprint": str(fingerprint),
        "mesh": [int(d) for d in tuple(mesh_shape or ())],
        "round": int(round_index),
    }
    return np.array(json.dumps(header, sort_keys=True).encode())


def read_header(path: str) -> dict | None:
    """The ``corro-checkpoint/1`` header of a snapshot, or ``None`` for a
    checkpoint without one."""
    with np.load(path) as data:
        if "__header__" not in data.files:
            return None
        return json.loads(bytes(data["__header__"].item()).decode())


def _check_header(path: str, data, kind: str, expect_fingerprint: str | None) -> None:
    """Refuse a load whose header disagrees with what the caller expects.
    ``expect_fingerprint=None`` skips the fingerprint check; a checkpoint
    without a header passes only when no fingerprint is demanded."""
    if "__header__" not in data.files:
        if expect_fingerprint is not None:
            raise ValueError(
                f"{path}: checkpoint has no {CHECKPOINT_SCHEMA} header, "
                "cannot verify the config fingerprint "
                f"{expect_fingerprint!r}; re-save it or pass "
                "expect_fingerprint=None"
            )
        return
    header = json.loads(bytes(data["__header__"].item()).decode())
    if header.get("schema") != CHECKPOINT_SCHEMA:
        raise ValueError(
            f"{path}: unknown checkpoint schema {header.get('schema')!r} "
            f"(this build reads {CHECKPOINT_SCHEMA})"
        )
    if header.get("kind") != kind:
        raise ValueError(
            f"{path}: checkpoint kind {header.get('kind')!r} is not "
            f"{kind!r} — wrong loader for this file"
        )
    if (
        expect_fingerprint is not None
        and header.get("config_fingerprint") != expect_fingerprint
    ):
        raise ValueError(
            f"{path}: checkpoint config fingerprint "
            f"{header.get('config_fingerprint')!r} does not match the "
            f"running config {expect_fingerprint!r}; refusing to load "
            "state from a different configuration"
        )


def _whole(tree):
    """A tree whose leaves may be placed per mesh position, as whole
    tensors (``parallel.mesh.assemble``)."""
    from corrosion_tpu_torch.parallel.mesh import assemble

    return assemble(tree)


def _leaf_arrays(tree) -> dict:
    flat = _flatten(_whole(tree))
    arrays = {f"leaf{i}": _as_reference(leaf, name) for i, (_, leaf, name) in enumerate(flat)}
    arrays["__paths__"] = np.array(json.dumps([p for p, _, _ in flat]).encode())
    return arrays


def _load_leaves(data, template, what: str, implied: str, hint: str = "",
                 check_dtype: bool = True) -> list:
    """The saved leaves, checked against ``template``'s paths, shapes and
    (with ``check_dtype``) reference dtypes; the messages name the file
    as ``what`` and the template as ``implied``."""
    saved_paths = json.loads(bytes(data["__paths__"].item()).decode())
    flat = _flatten(template)
    tmpl_paths = [p for p, _, _ in flat]
    if saved_paths != tmpl_paths:
        raise ValueError(
            f"{what} structure does not match the {implied.split()[0]} "
            f"(saved {len(saved_paths)} leaves, {implied} "
            f"{len(tmpl_paths)}){hint}"
        )
    leaves = []
    for idx, (p, leaf, name) in enumerate(flat):
        arr = data[f"leaf{idx}"]
        want = _as_reference(leaf, name)
        if arr.shape != want.shape:
            raise ValueError(f"{what} leaf {p} has shape {arr.shape}, {implied} {want.shape}")
        if check_dtype and arr.dtype != want.dtype:
            raise ValueError(f"{what} leaf {p} has dtype {arr.dtype}, {implied} {want.dtype}")
        leaves.append(arr)
    return leaves


def save_state(path: str, state: ClusterState, *, fingerprint: str = "", mesh_shape=()) -> None:
    arrays = _leaf_arrays(state)
    arrays["__header__"] = _header_array("state", fingerprint, mesh_shape, int(_whole(state.round)))
    np.savez_compressed(path, **arrays)


def load_state(
    path: str, cfg, n_samples: int, *, expect_fingerprint: str | None = None, device=None,
) -> ClusterState:
    """Load a snapshot written by ``save_state`` (by either package) onto
    ``device``; ``cfg``/``n_samples`` must describe the same cluster."""
    device = resolve_device(device)
    with np.load(path) as data:
        _check_header(path, data, "state", expect_fingerprint)
        template = init_cluster(cfg, n_samples, device)
        leaves = _load_leaves(
            data, template, "checkpoint", "config implies",
            hint="; was it written with a different SwimConfig/GossipConfig?",
        )
        return _unflatten(template, leaves, device)


def save_schedule(path: str, schedule: Schedule, *, fingerprint: str = "") -> None:
    arrays = {"writes": schedule.writes}
    for name in FAULT_AXES:
        v = getattr(schedule, name)
        if v is not None:
            arrays[name] = v
    arrays["sample_writer"] = schedule.sample_writer
    arrays["sample_ver"] = schedule.sample_ver
    arrays["sample_round"] = schedule.sample_round
    arrays["__header__"] = _header_array("schedule", fingerprint, (), schedule.rounds)
    np.savez_compressed(path, **arrays)


def load_schedule(path: str, *, expect_fingerprint: str | None = None) -> Schedule:
    with np.load(path) as data:
        _check_header(path, data, "schedule", expect_fingerprint)
        return Schedule(
            writes=data["writes"],
            sample_writer=data["sample_writer"],
            sample_ver=data["sample_ver"],
            sample_round=data["sample_round"],
            **{name: data[name] if name in data else None for name in FAULT_AXES},
        )


def save_tree(
    path: str, tree, *, fingerprint: str = "", mesh_shape=(), round_index: int = 0,
) -> None:
    """Persist any state tree (chunk coverage, MixedState, ...) with the
    self-describing header."""
    arrays = _leaf_arrays(tree)
    arrays["__header__"] = _header_array("tree", fingerprint, mesh_shape, round_index)
    np.savez_compressed(path, **arrays)


def load_tree(path: str, template, *, expect_fingerprint: str | None = None, device=None):
    """Load a ``save_tree`` snapshot against a template tree (typically a
    freshly built state), onto ``device`` (default: the template's)."""
    if device is None:
        first = next((leaf for _, leaf, _ in _flatten(template) if torch.is_tensor(leaf)), None)
        device = None if first is None else first.device
    device = resolve_device(device)
    with np.load(path) as data:
        _check_header(path, data, "tree", expect_fingerprint)
        leaves = _load_leaves(data, template, "tree checkpoint", "template implies")
        return _unflatten(template, leaves, device)


def save_sparse_resume(
    path: str, resume: dict, schedule: Schedule | None = None, *,
    fingerprint: str = "", mesh_shape=(),
) -> None:
    """Persist a ``simulate_sparse`` resume point: the device trees, the
    host planner's arrays unchanged and the epoch cursor, with the
    ``schedule``'s fault axes when one is given (``attach_resume_faults``
    puts them back)."""
    arrays = _leaf_arrays((resume["sstate"], resume["swim"], resume["vis_round"]))
    for k, v in resume["planner"].items():
        arrays[f"planner_{k}"] = np.asarray(v)
    arrays["next_epoch"] = np.asarray(int(resume["next_epoch"]))
    if schedule is not None:
        for name in FAULT_AXES:
            v = getattr(schedule, name)
            if v is not None:
                arrays[f"fault_{name}"] = v
    arrays["__header__"] = _header_array(
        "sparse-resume", fingerprint, mesh_shape, int(resume["next_epoch"])
    )
    np.savez_compressed(path, **arrays)


def load_sparse_resume(
    path: str, cfg, n_samples: int, *, expect_fingerprint: str | None = None, device=None,
) -> dict:
    """Load a resume point for the given SparseClusterConfig onto
    ``device``; structure and shapes are checked against the config. The
    persisted fault axes come back under ``"faults"`` (empty when the run
    was fault-free)."""
    from corrosion_tpu_torch.ops import sparse_writers as sw_ops
    from corrosion_tpu_torch.ops import swim as swim_ops

    device = resolve_device(device)
    template = (
        sw_ops.init_sparse(cfg.gossip, cfg.sparse, device),
        swim_ops.impl(cfg.swim).init_state(cfg.swim, device),
        torch.zeros((n_samples, cfg.n_nodes), dtype=torch.int64, device=device),
    )
    with np.load(path) as data:
        _check_header(path, data, "sparse-resume", expect_fingerprint)
        leaves = _load_leaves(data, template, "sparse resume", "config implies",
                              check_dtype=False)
        sstate, swim_state, vis_round = _unflatten(template, leaves, device)
        return {
            "sstate": sstate,
            "swim": swim_state,
            "vis_round": vis_round,
            "planner": {k[len("planner_"):]: data[k] for k in data.files
                        if k.startswith("planner_")},
            "next_epoch": int(data["next_epoch"]),
            "faults": {k[len("fault_"):]: data[k] for k in data.files if k.startswith("fault_")},
        }


def attach_resume_faults(schedule: Schedule, resume: dict) -> Schedule:
    """Re-attach the fault axes ``save_sparse_resume`` persisted to a
    schedule rebuilt at resume time. Refuses to override an axis the
    schedule already carries differently."""
    faults = resume.get("faults", {})
    if not faults:
        return schedule
    updates = {}
    for name, arr in faults.items():
        if name not in FAULT_AXES:
            raise ValueError(f"unknown persisted fault axis {name!r}")
        existing = getattr(schedule, name)
        if existing is not None and not np.array_equal(existing, arr):
            raise ValueError(
                f"schedule already carries a different {name!r} axis; "
                "refusing to overwrite it with the checkpoint's"
            )
        if arr.shape[0] != schedule.rounds:
            raise ValueError(
                f"persisted {name!r} axis covers {arr.shape[0]} rounds, "
                f"schedule has {schedule.rounds}"
            )
        updates[name] = arr
    return dataclasses.replace(schedule, **updates)

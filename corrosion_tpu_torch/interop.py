"""State carried across between the reference and the port.

The reference's state and topology travel as nested dicts of numpy
arrays keyed by the reference's field names (``{"swim": {...}, "data":
{..., "cells": {...}}, "round": ..., "vis_round": ...}``, a sparse
engine's ``{"data": {...}, "head_full": ..., "slot_writer": ...,
"dev_writer": ..., "dev_contig": ..., "dev_any": ...}``, a chunk plane's
``{"have": {"starts": ..., "ends": ...}}`` or a mixed engine's, which
holds a cluster's ``data`` and ``swim`` beside ``chunks``). These helpers
turn such dicts into the port's tensors and back, without importing
JAX: the caller flattens the reference's NamedTuples (``_asdict``) and
hands over numpy arrays.

Across meshes: ``placed_state_from_numpy`` puts a reference state (a
sharded array read whole) on a port mesh, ``to_numpy`` reads a placed
state back whole, ``mesh_dims``/``mesh_from_dims`` carry a mesh's layout
either way, and ``load_placed_checkpoint`` resumes a ``corro-checkpoint/1``
file written on any mesh, by either package, on a port mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.ops.chunks import ChunkState
from corrosion_tpu_torch.ops.crdt import CellState
from corrosion_tpu_torch.ops.gossip import DataState, Topology
from corrosion_tpu_torch.ops.intervals import IntervalSet
from corrosion_tpu_torch.ops.sparse_writers import SparseState
from corrosion_tpu_torch.ops.swim import SwimState
from corrosion_tpu_torch.ops.swim_sparse import SparseSwimState
from corrosion_tpu_torch.parallel import mesh as mesh_mod
from corrosion_tpu_torch.parallel.mesh import Placed, mesh_dims, mesh_from_dims  # noqa: F401
from corrosion_tpu_torch.sim.engine import ClusterState
from corrosion_tpu_torch.sim.mixed_engine import MixedState

# Fields the reference stores as uint32 (everything else integer is int32).
U32_FIELDS = frozenset({
    "head", "contig", "seen", "oo", "q_ver", "q_gw", "cl", "col_version",
    "value_rank", "view", "exc_pkd", "incarnation", "susp_inc", "upd_packed",
    "writer_ids", "head_full", "dev_contig",
})


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    # astype copies, so read-only exports (np.asarray of a device array)
    # never alias the tensor.
    return torch.as_tensor(
        a.astype(np.bool_ if a.dtype == np.bool_ else np.int64), device=device
    )


def _build(cls, d: dict, device):
    return cls(**{f: _tensor(d[f], device) for f in cls._fields})


def _data_state(d: dict, device) -> DataState:
    return DataState(
        cells=_build(CellState, d["cells"], device),
        **{f: _tensor(d[f], device) for f in DataState._fields if f != "cells"},
    )


def cluster_state_from_numpy(d: dict, device=None) -> ClusterState:
    """ClusterState from the reference's state as nested numpy dicts (the
    dense ``SwimState`` when the swim dict holds a ``view``, else the
    sparse exception tables)."""
    device = resolve_device(device)
    return ClusterState(
        swim=_swim_state(d["swim"], device),
        data=_data_state(d["data"], device),
        round=_tensor(d["round"], device),
        vis_round=_tensor(d["vis_round"], device),
    )


def _swim_state(d: dict, device):
    # The dense SwimState when the dict holds a ``view``, else the sparse
    # exception tables.
    return _build(SwimState if "view" in d else SparseSwimState, d, device)


def chunk_state_from_numpy(d: dict, device=None) -> ChunkState:
    """ChunkState (seq-chunk plane) from the reference's as a nested numpy
    dict ``{"have": {"starts": ..., "ends": ...}}``."""
    device = resolve_device(device)
    return ChunkState(have=_build(IntervalSet, d["have"], device))


def mixed_state_from_numpy(d: dict, device=None) -> MixedState:
    """MixedState (mixed engine) from the reference's as nested numpy
    dicts."""
    device = resolve_device(device)
    return MixedState(
        data=_data_state(d["data"], device),
        swim=_swim_state(d["swim"], device),
        chunks=chunk_state_from_numpy(d["chunks"], device),
        **{f: _tensor(d[f], device) for f in ("applied_before", "round", "vis_round")},
    )


def sparse_state_from_numpy(d: dict, device=None) -> SparseState:
    """SparseState (any-node-writes engine) from the reference's as nested
    numpy dicts."""
    device = resolve_device(device)
    return SparseState(
        data=_data_state(d["data"], device),
        **{f: _tensor(d[f], device) for f in SparseState._fields if f != "data"},
    )


def topology_from_numpy(d: dict, device=None) -> Topology:
    """Topology from the reference's topology as a numpy dict."""
    device = resolve_device(device)
    return Topology(**{
        f: None if d.get(f) is None else _tensor(d[f], device)
        for f in Topology._fields
    })


def to_numpy(tree, name: str = ""):
    """Any of the port's NamedTuples (nested, or in tuples), plain or
    placed over a mesh -> nested dicts of whole numpy arrays in the
    reference's dtypes (u32, i32, bool)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return {f: to_numpy(getattr(tree, f), f) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(t, name) for t in tree)
    if isinstance(tree, Placed):
        tree = tree.whole("cpu")
    a = tree.detach().cpu().numpy()
    if a.dtype == np.bool_:
        return a
    return a.astype(np.uint32 if name in U32_FIELDS else np.int32)


_FROM_NUMPY = {
    "cluster": (cluster_state_from_numpy, mesh_mod.cluster_state_specs),
    "sparse": (sparse_state_from_numpy, mesh_mod.sparse_state_specs),
    "chunk": (chunk_state_from_numpy, mesh_mod.node_major_specs),
    "mixed": (mixed_state_from_numpy, mesh_mod.mixed_state_specs),
}


def placed_state_from_numpy(d: dict, mesh, kind: str = "cluster"):
    """A reference state as nested numpy dicts (``kind``: cluster, sparse,
    chunk or mixed) placed over the port's ``mesh`` under the spec tree
    of that state."""
    build, specs = _FROM_NUMPY[kind]
    state = build(d, mesh.home)
    return mesh_mod.place(state, specs(state, mesh), mesh)


def load_placed_checkpoint(path: str, cfg, n_samples: int, mesh, *,
                           expect_fingerprint: str | None = None):
    """Resume a dense ``corro-checkpoint/1`` state written on any mesh by
    either package: the state placed over the port's ``mesh``, and the
    file's header (whose ``mesh`` names the mesh it was written on)."""
    from corrosion_tpu_torch.sim import checkpoint

    state = checkpoint.load_state(
        path, cfg, n_samples, expect_fingerprint=expect_fingerprint, device=mesh.home
    )
    return (
        mesh_mod.shard_cluster_state(state, mesh),
        checkpoint.read_header(path),
    )

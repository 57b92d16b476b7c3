"""The port's device mesh and the placement of state over it (counterpart
of corrosion_tpu/parallel/mesh.py).

A ``Mesh`` is a grid of positions, each a ``torch.device``, with named
axes (``("nodes",)``, or ``("dcn", "ici")`` for the partitioned-WAN
layout, dcn outer). One controller process drives every position, as the
reference's single controller drives a JAX mesh. ``make_mesh`` and
``make_wan_mesh`` fill the positions from the visible CUDA devices in
turn, so on one card a (2, 4) mesh has 8 positions on ``cuda:0``: the
counterpart of the reference's 8 virtual host devices. A mesh with more
positions than cards says so in its ``repr``.

Placement policy (the reference's, spec for spec):

- per-node vectors (alive, incarnation, region, ...):      P(node)
- node-major matrices (SWIM view, contig, seen, queues):   P(node, None)
- window words [B, N, W] and visibility samples [S, N]:    P(None, node)
- writer-indexed vectors, slot metadata and scalars:       P() (replicated)

where ``node`` is the mesh's full axis tuple (dcn-major, ici-minor) on a
multi-axis mesh, else its one axis name. A placed leaf is a ``Placed``:
one block per position (a row block of the sharded dimension, or a whole
copy when replicated). Where positions share a device, a block is a view
of one tensor; the byte counts are per position all the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch.ops.crdt import CellState
from corrosion_tpu_torch.ops.gossip import DataState, Topology
from corrosion_tpu_torch.ops.sparse_writers import SparseState
from corrosion_tpu_torch.sim.engine import ClusterState
from corrosion_tpu_torch.sim.mixed_engine import MixedState


class P(tuple):
    """A PartitionSpec: one entry per leading dimension of a leaf, each an
    axis name, a tuple of axis names (split over their product, the first
    outermost) or None (not split). Trailing dimensions are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Positions ``devices`` (an object ndarray of ``torch.device`` shaped
    by the axis sizes) under ``axis_names``. Hashable: equal meshes have
    equal axes, sizes and devices."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._key = (
            self.axis_names, devices.shape, tuple(str(d) for d in devices.flat),
        )

    @property
    def shape(self) -> dict:
        """Axis name -> size, outer first (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The controller's device: position 0's."""
        return self.devices.flat[0]

    def cards(self) -> list:
        """The distinct CUDA devices the positions sit on."""
        return sorted({str(d) for d in self.devices.flat if d.type == "cuda"})

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        where = sorted({str(d) for d in self.devices.flat})
        cards = self.cards()
        note = ""
        if cards and self.size > len(cards):
            note = (f"; {self.size} positions share {len(cards)} card"
                    f"{'s' if len(cards) > 1 else ''}")
        return f"Mesh({dims}; {self.size} positions on {', '.join(where)}{note})"


def _positions(count: int, device) -> list:
    """``count`` position devices: all ``device`` when given, else the
    visible CUDA devices in turn (raises without CUDA)."""
    if device is not None:
        return [torch.device(device)] * count
    resolve_device(None)
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(count)]


def make_mesh(n_devices: int | None = None, axis: str = "nodes", device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` positions (default: one per visible
    card, or one on ``device``)."""
    if n_devices is None:
        n_devices = 1 if device is not None else max(torch.cuda.device_count(), 1)
    return Mesh(np.array(_positions(n_devices, device), dtype=object), (axis,))


def make_wan_mesh(n_dcn: int, n_ici: int, device=None) -> Mesh:
    """The 2-D (dcn, ici) mesh of the partitioned-WAN configs. Node
    indices are region-blocked, and the node axis splits dcn-major, so
    whole regions land inside one dcn group when n_regions is a multiple
    of n_dcn (the reference's ``make_wan_mesh``)."""
    devs = np.empty(n_dcn * n_ici, dtype=object)
    devs[:] = _positions(n_dcn * n_ici, device)
    return Mesh(devs.reshape(n_dcn, n_ici), ("dcn", "ici"))


def multichip_mesh(d: int, device=None) -> Mesh:
    """The multi-device lane's mesh for ``d`` positions: 2-D (dcn, ici)
    from 4 up, so the coalesced outer hop of the queue exchange runs,
    else 1-D (the reference's ``sim/benchlib.multichip_mesh``)."""
    if d >= 4:
        return make_wan_mesh(2, d // 2, device=device)
    return make_mesh(d, device=device)


def mesh_dims(mesh) -> tuple:
    """The axis sizes of a mesh, outer first (a checkpoint header's
    ``mesh``); the reference's meshes answer the same."""
    return tuple(int(mesh.shape[a]) for a in mesh.axis_names)


def mesh_from_dims(dims, device=None) -> Mesh:
    """The mesh a checkpoint header's ``mesh`` dims name: 1-D ("nodes")
    or 2-D (dcn, ici)."""
    dims = tuple(int(x) for x in dims)
    if len(dims) == 1:
        return make_mesh(dims[0], device=device)
    if len(dims) == 2:
        return make_wan_mesh(*dims, device=device)
    raise ValueError(f"no mesh layout for dims {dims}")


def _node_axis(mesh: Mesh, axis):
    """Node-dimension spec entry: the full axis tuple on a multi-axis mesh
    (dcn outer, ici inner), else the one axis name."""
    if axis is not None:
        return axis
    return mesh.axis_names if len(mesh.axis_names) > 1 else mesh.axis_names[0]


def _names(entry) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_shard_factor(spec: P, mesh: Mesh) -> int:
    """How many ways a leaf under ``spec`` splits over ``mesh``: the
    product of the sizes of the axes it names."""
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        for name in _names(entry):
            factor *= int(mesh.shape[name])
    return factor


# ---- trees -----------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, (P, Placed, np.ndarray, np.generic)) or torch.is_tensor(x)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (tensors, arrays, ``Placed``,
    ``P``) and the matching leaves of ``rest``; NamedTuples, tuples, lists
    and dicts are nodes, ``None`` an empty subtree."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
            for f in tree._fields
        ))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# ---- placement -------------------------------------------------------------


def _block_index(mesh: Mesh, entry) -> np.ndarray:
    """Per position (C order), the index of its block along a dimension
    split over the axes ``entry`` names (the first outermost)."""
    coords = np.indices(mesh.devices.shape).reshape(len(mesh.axis_names), -1)
    idx = np.zeros(mesh.size, dtype=np.int64)
    for name in _names(entry):
        a = mesh.axis_names.index(name)
        idx = idx * mesh.devices.shape[a] + coords[a]
    return idx


def _split_dim(spec: P, mesh: Mesh):
    """(dim, entry) of the one dimension ``spec`` splits more than one
    way, or None for a leaf every position holds whole."""
    split = [(d, e) for d, e in enumerate(spec)
             if e is not None and spec_shard_factor(P(e), mesh) > 1]
    if len(split) > 1:
        raise NotImplementedError(f"spec {spec} splits more than one dimension")
    return split[0] if split else None


class Placed:
    """One state leaf held per mesh position: ``blocks[i]`` is position
    i's (C order of ``mesh.devices``), a row block of the split dimension
    ``dim``, or the whole leaf when ``dim`` is None (replicated)."""

    __slots__ = ("blocks", "dim", "spec", "mesh")

    def __init__(self, blocks, dim, spec: P, mesh: Mesh):
        self.blocks = tuple(blocks)
        self.dim = dim
        self.spec = spec
        self.mesh = mesh

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def shape(self) -> tuple:
        shape = list(self.blocks[0].shape)
        if self.dim is not None:
            shape[self.dim] *= spec_shard_factor(P(self.spec[self.dim]), self.mesh)
        return tuple(shape)

    def whole(self, device=None) -> torch.Tensor:
        """The leaf as one tensor on ``device`` (default: the home
        position's)."""
        device = self.mesh.home if device is None else torch.device(device)
        if self.dim is None:
            return self.blocks[0].to(device)
        order = _block_index(self.mesh, self.spec[self.dim])
        firsts = [int(np.flatnonzero(order == b)[0]) for b in range(int(order.max()) + 1)]
        return torch.cat([self.blocks[i].to(device) for i in firsts], dim=self.dim)

    def __repr__(self) -> str:
        return f"Placed({list(self.shape)} {self.dtype}, {self.spec}, {len(self.blocks)} positions)"


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    return torch.as_tensor(a.astype(np.bool_ if a.dtype == np.bool_ else np.int64))


def place_leaf(x, spec: P, mesh: Mesh) -> Placed:
    """``x`` (a tensor, array or ``Placed``) held per position under
    ``spec``. Raises when the split dimension does not divide."""
    if isinstance(x, Placed):
        x = x.whole()
    x = _as_tensor(x)
    on = {}  # the leaf once per distinct device; blocks are views of it

    def at(dev):
        if str(dev) not in on:
            on[str(dev)] = x.to(dev)
        return on[str(dev)]

    split = _split_dim(spec, mesh)
    if split is None:
        return Placed([at(dev) for dev in mesh.devices.flat], None, spec, mesh)
    dim, entry = split
    factor = spec_shard_factor(P(entry), mesh)
    if x.shape[dim] % factor:
        raise ValueError(
            f"leaf {tuple(x.shape)}/{x.dtype} dimension {dim} ({x.shape[dim]}) "
            f"does not divide its mesh factor {factor}"
        )
    size = x.shape[dim] // factor
    blocks = [
        at(dev).narrow(dim, int(b) * size, size)
        for dev, b in zip(mesh.devices.flat, _block_index(mesh, entry))
    ]
    return Placed(blocks, dim, spec, mesh)


def place(tree, specs, mesh: Mesh):
    """Place every leaf of ``tree`` under its matching spec leaf."""
    return tree_map(lambda x, s: place_leaf(x, s, mesh), tree, specs)


def assemble(tree, device=None):
    """Whole tensors from a placed tree (``Placed.whole``), on ``device``
    (default: each leaf's home position); plain tensors pass through, moved
    to ``device`` when one is given."""
    def one(x):
        if isinstance(x, Placed):
            return x.whole(device)
        if torch.is_tensor(x) and device is not None:
            return x.to(device)
        return x

    return tree_map(one, tree)


def position_tree(tree, i: int):
    """Position ``i``'s blocks of a placed tree: each ``Placed`` leaf
    replaced by its block there (plain leaves pass through)."""
    return tree_map(lambda x: x.blocks[i] if isinstance(x, Placed) else x, tree)


def from_positions(trees: list, specs, mesh: Mesh):
    """The placed tree whose position ``i`` holds ``trees[i]``'s leaves,
    each the block its spec leaf splits (or a whole copy where the spec
    replicates): ``position_tree``'s inverse."""
    def one(spec, *blocks):
        split = _split_dim(spec, mesh)
        return Placed(blocks, None if split is None else split[0], spec, mesh)

    return tree_map(one, specs, *trees)


def specs_of(tree):
    """The spec tree of a placed tree."""
    return tree_map(lambda x: x.spec, tree)


def owner_of(rows, n_nodes: int, mesh: Mesh):
    """(position, local row) of global node rows on ``mesh``: position i
    owns the i-th of its equal row blocks (C order of ``mesh.devices``,
    the node axis split dcn-major). Works on ints, arrays and tensors."""
    n_local = n_nodes // mesh.size
    return rows // n_local, rows % n_local


def to_host(tree):
    """A placed (or plain) state tree as whole CPU tensors: the port's
    counterpart of ``jax.device_get``."""
    return assemble(tree, "cpu")


def predicted_per_device_bytes(shapes, specs, mesh: Mesh) -> int:
    """Per-position state bytes of a tree of tensors, arrays or
    ``Placed`` under a matching spec tree, by arithmetic, at the port's
    own itemsizes (int64 carriers are 8 bytes). Every split dimension must
    divide its mesh factor, as placement requires."""
    total = 0
    for leaf, spec in zip(tree_leaves(shapes), tree_leaves(specs)):
        shape = tuple(leaf.shape)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            factor = spec_shard_factor(P(entry), mesh)
            if shape[dim] % factor:
                raise ValueError(
                    f"leaf {shape}/{leaf.dtype} dimension {dim} ({shape[dim]}) "
                    f"does not divide its mesh factor {factor} — this placement "
                    f"is not expressible (pad the node count)"
                )
        total += math.prod(shape or (1,)) * _itemsize(leaf) // spec_shard_factor(spec, mesh)
    return total


def _itemsize(leaf) -> int:
    dtype = leaf.dtype
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


# ---- spec trees ------------------------------------------------------------


def topology_specs(topo: Topology, mesh: Mesh, axis=None) -> Topology:
    axis = _node_axis(mesh, axis)
    n, r = P(axis), P()
    return Topology(
        region=n, region_start=n, region_size=n, region_rtt=r,
        writer_nodes=r, writer_of_node=n, sync_phase=n,
        sync_cohorts=None if topo.sync_cohorts is None else r,
        writer_ids=None if topo.writer_ids is None else r,
    )


def shard_topology(topo: Topology, mesh: Mesh, axis=None) -> Topology:
    return place(topo, topology_specs(topo, mesh, axis), mesh)


def data_state_specs(d: DataState, mesh: Mesh, axis=None) -> DataState:
    """The spec tree of a DataState (shared by the dense, sparse and mixed
    helpers): node-major tensors split their row axis, writer heads and
    the window-live flag replicate, window words split dim 1 ([B, N, W]),
    and the flat cell plane splits on node boundaries."""
    axis = _node_axis(mesh, axis)
    row, vec, rep = P(axis, None), P(axis), P()
    return DataState(
        head=rep, contig=row, seen=row, oo=P(None, axis, None), oo_any=rep,
        q_writer=row, q_ver=row, q_tx=row, q_gw=row, q_dup=row,
        cells=CellState(vec, vec, vec),
    )


def node_major_specs(tree, mesh: Mesh, axis=None):
    """Leading-axis split of every leaf (SWIM state, chunk coverage)."""
    axis = _node_axis(mesh, axis)
    return tree_map(lambda x: P(axis, *([None] * (len(x.shape) - 1))), tree)


def shard_node_major(tree, mesh: Mesh, axis=None):
    return place(tree, node_major_specs(tree, mesh, axis), mesh)


def cluster_state_specs(state: ClusterState, mesh: Mesh, axis=None) -> ClusterState:
    """The dense engine's ClusterState: the one placement rule
    ``shard_cluster_state`` applies and byte predictions read."""
    axis = _node_axis(mesh, axis)
    return ClusterState(
        swim=node_major_specs(state.swim, mesh, axis),
        data=data_state_specs(state.data, mesh, axis),
        round=P(),
        vis_round=P(None, axis),
    )


def shard_cluster_state(state: ClusterState, mesh: Mesh, axis=None) -> ClusterState:
    return place(state, cluster_state_specs(state, mesh, axis), mesh)


def sparse_state_specs(sstate: SparseState, mesh: Mesh, axis=None) -> SparseState:
    """The sparse writer plane: node-major tensors split like the dense
    plane; slot-indexed vectors replicate."""
    axis = _node_axis(mesh, axis)
    return SparseState(
        data=data_state_specs(sstate.data, mesh, axis),
        head_full=P(axis),
        slot_writer=P(),
        dev_writer=P(axis, None),
        dev_contig=P(axis, None),
        dev_any=P(),
    )


def shard_sparse_state(sstate: SparseState, mesh: Mesh, axis=None) -> SparseState:
    return place(sstate, sparse_state_specs(sstate, mesh, axis), mesh)


def shard_chunk_state(state, mesh: Mesh, axis=None):
    """The seq-chunk plane: coverage rows are node-major [N * S, C], so a
    row split lands on node boundaries when the mesh size divides N."""
    return shard_node_major(state, mesh, axis)


def mixed_state_specs(state: MixedState, mesh: Mesh, axis=None) -> MixedState:
    """The mixed engine: the version plane as the dense engine, coverage as
    the chunk plane, the completion latch node-major, the round
    replicated."""
    axis = _node_axis(mesh, axis)
    return MixedState(
        data=data_state_specs(state.data, mesh, axis),
        swim=node_major_specs(state.swim, mesh, axis),
        chunks=node_major_specs(state.chunks, mesh, axis),
        applied_before=P(axis, None),
        round=P(),
        vis_round=P(None, axis),
    )


def shard_mixed_state(state: MixedState, mesh: Mesh, axis=None) -> MixedState:
    return place(state, mixed_state_specs(state, mesh, axis), mesh)

"""The shard driver: the four engines' rounds partitioned over a mesh of
positions (counterpart of corrosion_tpu/parallel/shard_driver.py, whose
docstring describes the design; there XLA partitions SWIM, sync, churn and
visibility over the sharded state, here every plane runs per position).

- **Resident state.** ``simulate_sharded`` carries the ``Placed`` blocks
  of ``mesh.shard_cluster_state`` from the first round to the last, across
  rounds and ``max_chunk`` pieces: each position's round body
  (``sim.engine.round_body``) reads and writes only its own rows of every
  node-major leaf, its columns of ``vis_round`` and its copy of the
  replicated leaves. ``simulate_sparse_sharded`` does the same for the
  any-node-writes engine across rounds and epochs: its round body
  (``sim.sparse_engine._sparse_round``) and its epoch bodies
  (``ops.sparse_writers._demote_report``, ``_rotate``, the cold
  visibility) run per position, and only the host planner's slot
  metadata is replicated. ``simulate_chunks_sharded`` runs the seq-chunk
  plane's round (``sim.chunk_engine._round`` over
  ``ops.chunks._chunk_round``) on each position's (node, stream) rows and
  its rows of the visibility latch, and ``simulate_mixed_sharded`` the
  mixed round (``sim.mixed_engine._mixed_round``: the chunk plane's body,
  the big versions' commit and admission, the dense round's planes, the
  back-fill) on its blocks of the ``MixedState``. Nothing assembles the
  whole state during a run.
- **Typed exchanges.** The bodies run in lockstep (``_lockstep``); where
  the round reads what other positions own, every body yields the same
  request (``ops/exchange.py``) and the driver answers them together:
  ``Reduce`` (partial sums, maxima, ORs: the broadcast's and the round's
  stats, the pulled counts, the window, grant and deviation flags, the
  rotation's and the feasibility check's counts), ``Gather`` (the ``[N]``
  alive and incarnation vectors, the reference's alive-vector gather at
  the shard_map boundary, and the sparse engine's ``head_full`` where a
  rotation's claims or a cold sync read it at global writer ids), ``Rows``
  (rows by global node index, each owner serving what was asked of it:
  sync's candidates and peers, the sparse SWIM sources' backlogs, a
  revived node's seed view, the coverage rows of the chunk plane's due
  nodes' peers), ``Route`` (entries addressed to rows, delivered to their
  owners in sender order: the dense view's push merge, the rumor kill's
  feedback, the chunk send) and ``Queue`` (the pending-queue tables).
- **The queue wire.** ``Queue`` is the broadcast plane's one batched
  exchange a round: each position publishes its queue tables in the
  reference's 32-bit wire form (``q_writer``/``q_tx`` as int32,
  ``q_ver``/``q_gw`` as their u32 bit patterns in int32), gathered over
  the inner (ici) axis, then in one coalesced hop over each outer (dcn)
  axis, and widened back on receipt. Its bytes are the
  ``xshard_bytes_ici``/``xshard_bytes_dcn`` curves, equal to
  ``traffic_model``.
- **Measured exchange bytes.** Every exchange counts the bytes that cross
  from one position to another (each position stands for a device:
  positions that share a card still count), by kind and by tag, returned
  in ``info["exchange_bytes"]`` and ``info["exchange_bytes_by_tag"]``;
  ``traffic_model``'s ``detail`` holds the reference's estimates of the
  same traffic (``alive_gather_bytes``, ``pulled_reduce_bytes``,
  ``sync_gather_bytes_est``).
- **Bit-identity by construction.** A position draws its own rows (or
  its sync cohort entries) of the reference's full-shape draws (``rng``'s
  sub-box draws), sums are integer and exact, float32 stats round once
  after the sum, and every branch a body takes is decided on replicated
  values or on a cross-position OR, so a partitioned run equals the
  unsharded one on any mesh.

``make_sharded_broadcast`` remains for the plane composites
(``sim.benchlib.plane_composite``), which step a whole state; no engine's
run calls it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import exchange
from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops.gossip import MASK, Topology
from corrosion_tpu_torch.parallel import mesh as mesh_mod
from corrosion_tpu_torch.parallel.mesh import Mesh, P, Placed


def node_spec_entry(mesh: Mesh):
    """The spec entry that splits a node-major dimension over every mesh
    axis (dcn outer, ici inner)."""
    names = mesh.axis_names
    return names if len(names) > 1 else names[0]


def replicate(tree, mesh: Mesh):
    """Every leaf of ``tree`` held whole by every position (P())."""
    return mesh_mod.tree_map(lambda x: mesh_mod.place_leaf(x, P(), mesh), tree)


def traffic_model(cfg: gossip_ops.GossipConfig, mesh: Mesh) -> dict:
    """Per-round cross-shard bytes of the queue exchange from the config
    alone, with the reference's estimates of the control-plane collectives
    and the sync plane in ``detail`` (the reference's ``traffic_model``,
    number for number: the wire format is 32-bit, 12 bytes a queue entry,
    16 with writer ids)."""
    axes = tuple(mesh.axis_names)
    sizes = tuple(int(mesh.shape[a]) for a in axes)
    d = int(np.prod(sizes))
    n, q = cfg.n_nodes, cfg.queue
    if d <= 1:
        return {
            "xshard_bytes_ici": 0.0,
            "xshard_bytes_dcn": 0.0,
            "detail": {"device_count": d},
        }
    nl = n // d
    per_entry = 12 + (4 if cfg.track_writer_ids else 0)
    block = float(nl * q * per_entry)
    per_hop = []
    cur = block
    ici_bytes = dcn_bytes = 0.0
    for a, s in zip(reversed(axes), reversed(sizes)):
        hop = d * (s - 1) * cur
        per_hop.append({"axis": a, "group": s, "bytes": hop})
        if a == axes[-1]:
            ici_bytes += hop
        else:
            dcn_bytes += hop
        cur *= s
    alive_gather = float(d * (n - nl) * 1)
    pulled_reduce = float(2 * (d - 1) * n * 4)
    cohort = -(-n // max(cfg.sync_interval, 1))
    sync_rows = cohort * (2 * cfg.sync_candidates + cfg.sync_peers + 1)
    sync_est = float(sync_rows * cfg.n_writers * 4) * (d - 1) / d
    return {
        "xshard_bytes_ici": ici_bytes,
        "xshard_bytes_dcn": dcn_bytes,
        "detail": {
            "device_count": d,
            "queue_block_bytes": block,
            "per_hop": per_hop,
            "alive_gather_bytes": alive_gather,
            "pulled_reduce_bytes": pulled_reduce,
            "sync_gather_bytes_est": sync_est,
        },
    }


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """A u32 value held in int64 as the int32 with the same bit pattern."""
    x = x & MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _wire(tables: tuple) -> list:
    """A position's queue tables in the 32-bit wire form."""
    qs = [tables[0].to(torch.int32), _u32_bits(tables[1]), tables[2].to(torch.int32)]
    if len(tables) > 3:
        qs.append(_u32_bits(tables[3]))
    return qs


def _widen(qs: list) -> tuple:
    """Gathered wire tables back into the port's int64 carriers."""
    out = (qs[0].to(torch.int64), qs[1].to(torch.int64) & MASK, qs[2].to(torch.int64))
    return out + ((qs[3].to(torch.int64) & MASK,) if len(qs) > 3 else ())


def _exchange(wire: list, mesh: Mesh):
    """The staged all-gather of the positions' wire tables: inner axis
    first, then each outer axis, a group's blocks concatenated in mesh
    order and handed to each member. Returns the gathered tables per
    position and the bytes received over the innermost axis and over the
    outer ones (each position receives its group peers' blocks)."""
    grid = np.arange(mesh.size).reshape(mesh.devices.shape)
    devs = list(mesh.devices.flat)
    held = list(wire)
    ici = dcn = 0.0
    for a in reversed(range(len(mesh.axis_names))):
        s = mesh.devices.shape[a]
        moved = 0
        nxt = [None] * mesh.size
        # Each group: the positions that differ only in their coordinate
        # on axis a, in coordinate order.
        joined = {}  # groups holding the same blocks join them once
        for group in np.moveaxis(grid, a, -1).reshape(-1, s):
            key = tuple(id(held[p][0]) for p in group)
            if key not in joined:
                joined[key] = [
                    torch.cat([held[p][j].to(devs[group[0]]) for p in group])
                    for j in range(len(held[group[0]]))
                ]
            tables = joined[key]
            for p in group:
                moved += (s - 1) * sum(t.numel() * t.element_size() for t in held[p])
                nxt[p] = [t.to(devs[p]) for t in tables]
        held = nxt
        if a == len(mesh.axis_names) - 1:
            ici += moved
        else:
            dcn += moved
    return held, float(ici), float(dcn)


# ---- the exchanges ----------------------------------------------------------


class ExchangeTally:
    """Bytes the exchanges moved between positions, by kind and by tag,
    and each position's state bytes after every round."""

    def __init__(self):
        self.by_kind: dict = {}
        self.by_tag: dict = {}
        self.state_bytes: list = []

    def add(self, kind: str, tag: str, nbytes) -> None:
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + float(nbytes)
        key = f"{kind}:{tag}"
        self.by_tag[key] = self.by_tag.get(key, 0.0) + float(nbytes)

    def record_state(self, blocks: list) -> None:
        """Each position's state bytes, after a round."""
        self.state_bytes.append([
            sum(_nbytes(x) for x in mesh_mod.tree_leaves(b)) for b in blocks
        ])

    def export(self, info: dict | None) -> None:
        """The tallies into a driver's ``info``: ``exchange_bytes`` by
        kind, ``exchange_bytes_by_tag`` by kind and tag, ``state_bytes``
        a position after every round."""
        if info is not None:
            info["exchange_bytes"] = dict(self.by_kind)
            info["exchange_bytes_by_tag"] = dict(self.by_tag)
            info["state_bytes"] = self.state_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _row_bytes(t: torch.Tensor) -> int:
    return _nbytes(t) // max(t.shape[0], 1) if t.dim() else t.element_size()


def _on_devices(values: tuple, devices: list) -> list:
    """``values`` (a tuple of tensors) on each position's device, moved
    once per distinct device."""
    at: dict = {}
    out = []
    for dev in devices:
        if str(dev) not in at:
            at[str(dev)] = tuple(v.to(dev) for v in values)
        out.append(at[str(dev)])
    return out


def _host_counts(counts: list, home) -> list:
    """Small per-position count vectors read on the host in one
    transfer."""
    flat = torch.cat([c.to(home) for c in counts]).tolist()
    d = len(flat) // len(counts)
    return [flat[i * d : (i + 1) * d] for i in range(len(counts))]


def _answer_reduce(reqs, devices, tally):
    home = devices[0]

    def total(parts, op):
        return functools.reduce(op, (p.to(home) for p in parts))

    first = reqs[0]
    sums = tuple(total([r.sum[j] for r in reqs], torch.add) for j in range(len(first.sum)))
    maxes = tuple(total([r.max[j] for r in reqs], torch.maximum) for j in range(len(first.max)))
    anys = tuple(total([r.any[j] for r in reqs], torch.logical_or) for j in range(len(first.any)))
    d = len(reqs)
    # Every position sends its partials in and takes the totals back.
    tally.add("reduce", first.tag, 2 * (d - 1) * sum(_nbytes(t) for t in first.sum + first.max
                                                      + first.any))
    k, m = len(sums), len(maxes)
    return [exchange.Reduce(first.tag, v[:k], v[k : k + m], v[k + m :])
            for v in _on_devices(sums + maxes + anys, devices)]


def _answer_gather(reqs, devices, tally):
    home = devices[0]
    whole = tuple(
        torch.cat([r.parts[j].to(home) for r in reqs]) for j in range(len(reqs[0].parts))
    )
    d = len(reqs)
    # Each position receives the other positions' blocks.
    tally.add("gather", reqs[0].tag, d * (d - 1) * sum(_nbytes(t) for t in reqs[0].parts))
    return _on_devices(whole, devices)


def _answer_rows(reqs, devices, n_nodes, tally, mesh):
    d = len(reqs)
    owned = [mesh_mod.owner_of(r.index.reshape(-1), n_nodes, mesh) for r in reqs]
    orders = [torch.argsort(o, stable=True) for o, _ in owned]
    counts = _host_counts([torch.bincount(o, minlength=d) for o, _ in owned], devices[0])
    out = []
    for a, req in enumerate(reqs):
        dev = devices[a]
        got = [torch.empty((req.index.numel(),) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
               for t in req.tables]
        start = 0
        for o in range(d):
            c = counts[a][o]
            if c == 0:
                continue
            sel = orders[a][start : start + c]  # the asker's entries that o owns
            start += c
            ask = owned[a][1][sel].to(devices[o])
            for j, t in enumerate(reqs[o].tables):
                got[j][sel] = t[ask].to(dev)
            if o != a:
                tally.add("rows", req.tag, c * (8 + sum(_row_bytes(t) for t in req.tables)))
        out.append(tuple(
            g.reshape(tuple(req.index.shape) + tuple(t.shape[1:]))
            for g, t in zip(got, req.tables)
        ))
    return out


def _answer_route(reqs, devices, n_nodes, tally, mesh):
    d = len(reqs)
    owned = [mesh_mod.owner_of(r.dest, n_nodes, mesh) for r in reqs]
    # Invalid entries go to no owner (d), sorted last and dropped.
    owners = [torch.where(r.valid, o, d) for r, (o, _) in zip(reqs, owned)]
    orders = [torch.argsort(o, stable=True) for o in owners]
    counts = _host_counts([torch.bincount(o, minlength=d + 1) for o in owners], devices[0])
    dests = [[] for _ in range(d)]
    pays = [[[] for _ in reqs[0].payloads] for _ in range(d)]
    for s, req in enumerate(reqs):
        start = 0
        for o in range(d):
            c = counts[s][o]
            if c == 0:
                continue
            sel = orders[s][start : start + c]
            start += c
            dests[o].append(owned[s][1][sel].to(devices[o]))
            for j, p in enumerate(req.payloads):
                pays[o][j].append(p[sel].to(devices[o]))
            if o != s:
                tally.add("route", req.tag, c * (8 + sum(_row_bytes(p) for p in req.payloads)))
    out = []
    for o, dev in enumerate(devices):
        dest = torch.cat(dests[o]) if dests[o] else reqs[o].dest[:0]
        payloads = tuple(
            torch.cat(pays[o][j]) if pays[o][j] else p[:0]
            for j, p in enumerate(reqs[o].payloads)
        )
        out.append((dest, torch.ones(dest.shape, dtype=torch.bool, device=dev), payloads))
    return out


def _answer_queue(reqs, devices, mesh, tally):
    tables, ici, dcn = _exchange([_wire(r.tables) for r in reqs], mesh)
    tally.add("queue", "broadcast", ici + dcn)
    widened = {}  # positions that share a gathered table widen it once
    out = []
    for t in tables:
        if id(t[0]) not in widened:
            widened[id(t[0])] = _widen(t)
        out.append(exchange.QueueAnswer(widened[id(t[0])], ici, dcn))
    return out


def _answer(reqs: list, mesh: Mesh, n_nodes: int, tally: ExchangeTally) -> list:
    """Every position's answer to the positions' requests (one of each)."""
    first = reqs[0]
    tag = getattr(first, "tag", None)
    if any(type(r) is not type(first) or getattr(r, "tag", None) != tag for r in reqs):
        raise RuntimeError("shard bodies disagree on the round's exchanges: "
                           f"{sorted({type(r).__name__ for r in reqs})}")
    if len(reqs) == 1:
        return [exchange.answer_solo(first)]
    devices = list(mesh.devices.flat)
    if isinstance(first, exchange.Reduce):
        return _answer_reduce(reqs, devices, tally)
    if isinstance(first, exchange.Gather):
        return _answer_gather(reqs, devices, tally)
    if isinstance(first, exchange.Rows):
        return _answer_rows(reqs, devices, n_nodes, tally, mesh)
    if isinstance(first, exchange.Route):
        return _answer_route(reqs, devices, n_nodes, tally, mesh)
    if isinstance(first, exchange.Queue):
        return _answer_queue(reqs, devices, mesh, tally)
    raise TypeError(f"not an exchange request: {type(first).__name__}")


def _lockstep(bodies: list, mesh: Mesh, n_nodes: int, tally: ExchangeTally, watch=None) -> list:
    """Drive the positions' round bodies together: every body runs to its
    next request, then the driver answers them all and hands each its
    answer. ``watch`` (a context manager, entered around every step of
    every body and never around the driver's exchanges) is the structural
    check's hook. Returns each body's result."""
    sends = [None] * len(bodies)
    while True:
        steps = []
        for body, value in zip(bodies, sends):
            with watch if watch is not None else contextlib.nullcontext():
                try:
                    steps.append((False, body.send(value)))
                except StopIteration as done:
                    steps.append((True, done.value))
        finished = {f for f, _ in steps}
        if finished == {True}:
            return [v for _, v in steps]
        if len(finished) > 1:
            raise RuntimeError("shard bodies disagree on the round's exchanges")
        sends = _answer([v for _, v in steps], mesh, n_nodes, tally)


@functools.lru_cache(maxsize=None)
def make_sharded_broadcast(mesh: Mesh):
    """A drop-in for ``gossip.broadcast_round`` where a whole state is
    stepped (the plane composites of ``sim.benchlib``):
    it places the whole DataState it is given over ``mesh``, runs the
    broadcast body once per position on its blocks in lockstep, and
    returns the whole next DataState and the round's stats plus
    ``xshard_bytes_ici``/``xshard_bytes_dcn``, the queue exchange's bytes
    this round. Cached per mesh."""
    devices = list(mesh.devices.flat)
    d = mesh.size

    def bcast(data, topo, alive, partition, writes, rng, cfg, loss=None):
        n_total = cfg.n_nodes
        if n_total % d:
            raise ValueError(
                f"the shard driver needs n_nodes divisible by the mesh size: "
                f"{n_total} % {d} != 0"
            )
        nl = n_total // d
        home = data.contig.device
        specs = mesh_mod.data_state_specs(data, mesh)
        placed = mesh_mod.place(data, specs, mesh)
        bodies = []
        for i, dev in enumerate(devices):
            block = mesh_mod.position_tree(placed, i)

            def at(x, dev=dev):
                return None if x is None else x.to(dev)

            bodies.append(gossip_ops._broadcast_round(
                # The kernels take contiguous operands: a row block of the
                # [B, N, W] window words is one only at B = 1.
                block._replace(oo=block.oo.contiguous()), Topology(*(at(x) for x in topo)),
                at(alive), at(partition), at(writes), at(rng), cfg, at(loss),
                exchange.Pos(i * nl, nl, n_total),
            ))
        outs = _lockstep(bodies, mesh, n_total, ExchangeTally())
        stats = {k: v.to(home) for k, v in outs[0][1].items()}
        if d == 1:
            for k in ("xshard_bytes_ici", "xshard_bytes_dcn"):
                stats[k] = torch.zeros((), dtype=torch.float64, device=home)
        out = mesh_mod.from_positions([o[0] for o in outs], specs, mesh)
        return mesh_mod.assemble(out, home), stats

    return bcast


def per_device_state_bytes(tree) -> dict:
    """Bytes each mesh position holds of a placed state tree (position
    index in the C order of ``mesh.devices`` -> bytes): the measured side
    of the per-position memory claim. Replicated leaves count whole at
    every position, split leaves their block.

    This is also what a position holds of the state during a run: every
    ``simulate_*_sharded`` carries these blocks from round to round, and
    its ``info["state_bytes"]`` reads them after every round."""
    out: dict = {}
    for leaf in mesh_mod.tree_leaves(tree):
        if not isinstance(leaf, Placed):
            continue
        for i, b in enumerate(leaf.blocks):
            out[i] = out.get(i, 0) + b.numel() * b.element_size()
    return out


class WholePlaneCheck(TorchDispatchMode):
    """The partitioned round's structural check: a dispatch mode that the
    shard drivers (``watch=``) enter around every step of every position
    body (never around the driver's exchanges). It records each operation
    whose output is a whole node plane: a tensor of two or more dimensions
    (size-1 dimensions aside) with an extent of ``n_nodes``, other than a
    position's ``[n_local, n_nodes]`` block of the dense SWIM view; the
    flat ``[n_nodes * n_cells]`` cell plane; or, given ``n_streams``, any
    tensor with an extent of ``n_nodes * n_streams`` (the chunk plane's
    whole (node, stream) row plane, flat or ``[N * S, C]``). ``[N]``
    control vectors pass. Choose a mesh where no other per-position extent
    equals ``n_nodes`` or ``n_nodes * n_streams``."""

    def __init__(self, n_nodes: int, n_local: int, n_cells: int = 0, n_streams: int = 0):
        super().__init__()
        self.n, self.nl, self.k, self.s = n_nodes, n_local, n_cells, n_streams
        self.ops = 0
        self.found: list = []

    def _whole(self, shape: tuple) -> bool:
        dims = tuple(x for x in shape if x != 1)
        if self.s > 1 and self.n * self.s in dims:
            return True
        if len(dims) >= 2:
            return self.n in dims and dims != (self.nl, self.n)
        return self.k > 1 and dims == (self.n * self.k,)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if torch.is_tensor(t) and self._whole(tuple(t.shape)):
                self.found.append((str(func), tuple(t.shape)))
        return out


def _positions(topo: Topology | None, mesh: Mesh, n_nodes: int) -> list:
    """Each position's ``exchange.Pos``: its row block and, under the
    topology's sync cohorts, the entries of each cohort whose node it owns
    (built once on the host from the replicated topology)."""
    d = mesh.size
    if d == 1:
        return [exchange.whole(n_nodes)]
    nl = n_nodes // d
    cohorts = (None if topo is None or topo.sync_cohorts is None
               else topo.sync_cohorts.cpu().numpy())
    out = []
    for i, dev in enumerate(mesh.devices.flat):
        ents = None
        if cohorts is not None:
            own = [np.flatnonzero((c >= i * nl) & (c < (i + 1) * nl)) for c in cohorts]
            table = np.full((len(own), max(1, max(len(e) for e in own))), -1, np.int64)
            for c, e in enumerate(own):
                table[c, : len(e)] = e
            ents = torch.as_tensor(table, device=dev)
        out.append(exchange.Pos(i * nl, nl, n_nodes, ents))
    return out


def _check_divisible(n: int, mesh: Mesh) -> None:
    if n % mesh.size:
        raise ValueError(
            f"the shard driver needs n_nodes divisible by the mesh size: "
            f"{n} % {mesh.size} != 0"
        )


def _is_placed_on(tree, mesh: Mesh) -> bool:
    leaves = mesh_mod.tree_leaves(tree)
    return bool(leaves) and all(isinstance(x, Placed) and x.mesh == mesh for x in leaves)


def _run_rounds(cfg, topo, sched, mesh: Mesh, positions: list, seed: int, box: list, tally,
                watch):
    """The schedule's rounds on the placed state ``box`` holds (popped: the
    only reference, so each round's input blocks are freed as the next are
    made): one ``round_body`` a position a round, in lockstep. Returns the
    placed next state and the curves."""
    from corrosion_tpu_torch.sim import engine

    devices = list(mesh.devices.flat)
    state = box.pop()
    specs = mesh_mod.specs_of(state)
    inputs, keys = {}, {}
    for dev in devices:
        if str(dev) not in inputs:
            inputs[str(dev)] = engine.round_inputs(cfg, topo, sched, dev)
            keys[str(dev)] = rng_mod.PRNGKey(seed, dev)
    blocks = []
    for i in range(mesh.size):
        b = mesh_mod.position_tree(state, i)
        # The kernels take contiguous operands: a row block of the [B, N,
        # W] window words is one only at B = 1.
        blocks.append(b._replace(data=b.data._replace(oo=b.data.oo.contiguous())))
    del state
    offset = int(blocks[0].round)

    def bodies(r, blocks):
        round_keys = {k: rng_mod.fold_in(v, offset + r) for k, v in keys.items()}
        return [
            engine.round_body(blocks[i], rng=round_keys[str(dev)], cfg=cfg, pos=positions[i],
                              **inputs[str(dev)].at(r))
            for i, dev in enumerate(devices)
        ]

    # run_positions takes the only reference to the start blocks.
    box.append(blocks)
    del blocks
    blocks, curves = engine.run_positions(
        box.pop(), range(sched.rounds), bodies,
        lambda bs: _lockstep(bs, mesh, cfg.n_nodes, tally, watch), tally.record_state,
    )
    return mesh_mod.from_positions(blocks, specs, mesh), curves


def init_sharded(cfg, n_samples: int, mesh: Mesh):
    """The dense engine's initial state placed on ``mesh``, each position's
    block built where it sits (``engine.init_cluster(n_rows=)``): no device
    holds the whole state."""
    from corrosion_tpu_torch.sim import engine

    d = mesh.size
    _check_divisible(cfg.n_nodes, mesh)
    blocks = [engine.init_cluster(cfg, n_samples, dev, n_rows=cfg.n_nodes // d)
              for dev in mesh.devices.flat]
    return mesh_mod.from_positions(blocks, mesh_mod.cluster_state_specs(blocks[0], mesh), mesh)


def simulate_sharded(
    cfg, topo, sched, mesh: Mesh, seed: int = 0, state=None, max_chunk: int | None = None,
    telemetry=None, info: dict | None = None, watch=None,
):
    """The dense engine partitioned over ``mesh``: every plane of the round
    (wipe and churn, broadcast, SWIM in either form, sync with the rejoin
    sync and the pull escalation, visibility, the health reductions) runs
    once per position on its rows, the positions in lockstep through the
    typed exchanges (module docstring). The state stays in the positions'
    blocks across rounds and ``max_chunk`` pieces: a fresh run builds each
    position's block where it sits, ``state`` (placed on ``mesh``, or
    whole or placed elsewhere and then re-placed once) resumes, and the
    final state comes back placed. Equal to ``sim.engine.simulate`` on one
    device, bit for bit.

    ``info`` (a dict) receives the exchanges' bytes between positions by
    kind (``exchange_bytes``: reduce, gather, rows, route, queue) and by
    kind and tag (``exchange_bytes_by_tag``, e.g. ``gather:alive``), and
    each position's state bytes after every round (``state_bytes``).
    ``watch`` is the structural check's hook (``WholePlaneCheck``)."""
    from corrosion_tpu_torch.sim import engine

    n = cfg.n_nodes
    _check_divisible(n, mesh)
    if state is None:
        state = init_sharded(cfg, len(sched.sample_writer), mesh)
    elif not _is_placed_on(state, mesh):
        state = mesh_mod.shard_cluster_state(state, mesh)
    start_round = int(state.round.blocks[0])
    engine.check_head_domain(cfg, start_round, sched.rounds)
    positions = _positions(topo, mesh, n)
    tally = ExchangeTally()
    box = [state]
    state = None
    final, curves = engine.run_in_chunks(
        sched.rounds, box, max_chunk or max(sched.rounds, 1), start_round, telemetry,
        lambda start, stop, box: _run_rounds(cfg, topo, sched.slice(start, stop), mesh,
                                             positions, seed, box, tally, watch),
    )
    tally.export(info)
    return final, curves


def sparse_specs(tree: tuple, mesh: Mesh) -> tuple:
    """The spec tree of the sparse engine's (sparse state, swim state,
    vis_round), whole, placed or a position's block: the one placement its
    resume points and byte predictions read."""
    return (
        mesh_mod.sparse_state_specs(tree[0], mesh),
        mesh_mod.node_major_specs(tree[1], mesh),
        P(None, node_spec_entry(mesh)),
    )


def _sparse_blocks(resume: dict, mesh: Mesh) -> list:
    """Each position's (sparse state, swim state, vis_round) block of a
    resume point: its blocks where the point is placed on ``mesh``, else
    the point placed once (whole, or placed on another mesh)."""
    tree = (resume["sstate"], resume["swim"], resume["vis_round"])
    if not _is_placed_on(tree, mesh):
        tree = mesh_mod.place(tree, sparse_specs(tree, mesh), mesh)
    blocks = []
    for i in range(mesh.size):
        st, sw, vr = mesh_mod.position_tree(tree, i)
        # The kernels take contiguous operands: a row block of the [B, N,
        # W] window words is one only at B = 1.
        blocks.append((st._replace(data=st.data._replace(oo=st.data.oo.contiguous())), sw, vr))
    return blocks


def simulate_sparse_sharded(
    cfg, topo, sched, mesh: Mesh, seed: int = 0, telemetry=None, resume: dict | None = None,
    stop_after_epoch: int | None = None, info: dict | None = None, watch=None,
):
    """The any-node-writes engine partitioned over ``mesh``: every plane of
    the round (``sparse_engine._sparse_round``: churn, broadcast with
    ``q_gw`` on the queue exchange, SWIM, sync, the rejoin sync, cold sync,
    hot visibility, the health reductions) and of the epoch boundary (the
    planner's feasibility check, ``_demote_report``; the rotation,
    ``_rotate``; the epoch-end cold visibility) runs once per position on
    its rows, the positions in lockstep through the typed exchanges. The
    host planner stays on the host (slot metadata, replicated). The state
    stays in the positions' blocks across rounds and epochs: a fresh run
    builds each position's block where it sits, and ``resume`` (placed on
    ``mesh``, or whole or placed elsewhere and then placed once)
    continues. Returns what ``simulate_sparse`` returns, with the states
    (and ``info["resume"]``'s) placed per position; equal to it bit for
    bit.

    ``info`` (a dict) receives the exchanges' bytes between positions by
    kind and by tag and each position's state bytes after every round, as
    ``simulate_sharded``'s does; ``watch`` is the structural check's hook
    (``WholePlaneCheck``)."""
    from corrosion_tpu_torch.sim import sparse_engine

    d = mesh.size
    n = cfg.n_nodes
    _check_divisible(n, mesh)
    sparse_engine.check_schedule(cfg, sched)
    devices = list(mesh.devices.flat)
    planner = sparse_engine._Planner(n, cfg.w_hot, cfg.sparse)
    start_epoch = 0
    if resume is None:
        blocks = [sparse_engine.init_position(cfg, len(sched.sample_writer), dev, n // d)
                  for dev in devices]
    else:
        planner.restore(resume["planner"])
        start_epoch = int(resume["next_epoch"])
        blocks = _sparse_blocks(resume, mesh)
    specs = sparse_specs(blocks[0], mesh)
    tally = ExchangeTally()
    box = [blocks]
    blocks = None
    final, curves, out = sparse_engine.run_epochs(
        cfg, topo, sched, seed, box, planner, start_epoch, _positions(topo, mesh, n), devices,
        lambda bodies: _lockstep(bodies, mesh, n, tally, watch),
        telemetry=telemetry, stop_after_epoch=stop_after_epoch, watch=watch,
        after_round=tally.record_state,
    )
    sstate, swim_state, vis_round = mesh_mod.from_positions(final, specs, mesh)
    del final
    out["resume"] = {
        "planner": planner.snapshot(),
        "sstate": sstate,
        "swim": swim_state,
        "vis_round": vis_round,
        "next_epoch": out["epochs"] + start_epoch,
    }
    tally.export(info)
    return sstate, swim_state, vis_round, curves, out


def chunk_specs(tree: tuple, mesh: Mesh) -> tuple:
    """The spec tree of the chunk engine's (coverage state, vis), whole,
    placed or a position's block: coverage rows are node-major [N * S, C],
    so a row split lands on node boundaries, and the [N, S] visibility
    latch splits its node axis."""
    return (mesh_mod.node_major_specs(tree[0], mesh), P(node_spec_entry(mesh), None))


def simulate_chunks_sharded(
    ccfg, origin, last_seq, rounds: int, mesh: Mesh, seed: int = 0,
    max_chunk: int | None = None, telemetry=None, faults=None, state=None, vis=None,
    start_round: int = 0, round_ms: float = 500.0, info: dict | None = None, watch=None,
):
    """The seq-chunk plane partitioned over ``mesh``: the round
    (``chunk_engine._round``: wipe, the chunk send, the partial-need sync,
    the visibility latch, the health reductions) runs once per position on
    its (node, stream) rows, the positions in lockstep through the typed
    exchanges (the chunk send a ``Route`` to the targets' owners, the sync
    a ``Rows`` of the due nodes' peers' coverage, the stats one
    ``Reduce``). The coverage state and ``vis`` stay in the positions'
    blocks across rounds and ``max_chunk`` pieces: a fresh run builds each
    position's blocks where they sit, and ``state``/``vis``/``start_round``
    (the elastic resume seam; placed on ``mesh``, or whole or placed
    elsewhere and then placed once) resume. The kill/revive alive curve
    and the loss scalar stay whole, the wipe mask is read at each
    position's rows; a partition raises. It has no broadcast queue to
    exchange, so the xshard curves stay zero, as in the reference. Returns
    (placed state, metrics) with ``metrics["vis"]`` placed, equal to
    ``sim.chunk_engine.simulate_chunks`` bit for bit (``round_ms`` is its
    simulated round length, for p50/p99).

    ``info`` (a dict) receives the exchanges' bytes between positions by
    kind and by tag and each position's state bytes (coverage and vis)
    after every round, as ``simulate_sharded``'s does; ``watch`` is the
    structural check's hook (``WholePlaneCheck``)."""
    from corrosion_tpu_torch.ops import chunks as chunk_ops
    from corrosion_tpu_torch.sim import chunk_engine

    d = mesh.size
    n, s_count = ccfg.n_nodes, ccfg.n_streams
    _check_divisible(n, mesh)
    devices = list(mesh.devices.flat)
    positions = _positions(None, mesh, n)
    if state is None:
        cov = [chunk_ops.init_chunks(ccfg, origin, last_seq, dev, p)
               for p, dev in zip(positions, devices)]
    else:
        placed = state if _is_placed_on(state, mesh) else mesh_mod.shard_chunk_state(state, mesh)
        cov = [mesh_mod.position_tree(placed, i) for i in range(d)]
        del placed
    if vis is None:
        vb = [torch.full((p.n_local, s_count), -1, dtype=torch.int64, device=dev)
              for p, dev in zip(positions, devices)]
    else:
        placed = vis if _is_placed_on(vis, mesh) else mesh_mod.place_leaf(
            vis, P(node_spec_entry(mesh), None), mesh)
        vb = list(placed.blocks)
        del placed
    specs = chunk_specs((cov[0], vb[0]), mesh)
    tally = ExchangeTally()
    box = [list(zip(cov, vb))]
    cov = vb = None
    final, merged = chunk_engine.run_rounds(
        ccfg, last_seq, rounds, seed, box, start_round, positions, devices,
        lambda bodies: _lockstep(bodies, mesh, n, tally, watch),
        faults=faults, max_chunk=max_chunk, telemetry=telemetry, after_round=tally.record_state,
    )
    # The metrics read the positions' vis blocks on the host, in row order.
    metrics = chunk_engine.run_metrics(
        np.concatenate([b[1].cpu().numpy() for b in final]), merged, round_ms
    )
    state, metrics["vis"] = mesh_mod.from_positions(final, specs, mesh)
    tally.export(info)
    return state, metrics


def simulate_mixed_sharded(
    cfg, ccfg, topo, sched, streams, mesh: Mesh, seed: int = 0, max_chunk: int | None = None,
    telemetry=None, state=None, info: dict | None = None, watch=None,
):
    """The mixed chunk+version engine partitioned over ``mesh``: every
    plane of the round (``mixed_engine._mixed_round``: wipe and churn, the
    big-version commits, the chunk plane, the admission, broadcast with the
    queue exchange, SWIM, sync with the rejoin sync, the sync-crossing
    back-fill, visibility, the health reduction) runs once per position on
    its rows, the positions in lockstep through the typed exchanges. The
    state stays in the positions' blocks across rounds and ``max_chunk``
    pieces: a fresh run builds each position's ``MixedState`` block where
    it sits, and ``state`` (placed on ``mesh``, or whole or placed
    elsewhere and then placed once) resumes at its carried ``round``. The
    final state comes back placed; equal to ``sim.mixed_engine.
    simulate_mixed`` bit for bit, with the xshard curves the queue
    exchange's bytes (``traffic_model``).

    ``info`` (a dict) receives the exchanges' bytes between positions by
    kind and by tag and each position's state bytes after every round, as
    ``simulate_sharded``'s does; ``watch`` is the structural check's hook
    (``WholePlaneCheck``)."""
    from corrosion_tpu_torch.sim import mixed_engine

    d = mesh.size
    n = cfg.n_nodes
    _check_divisible(n, mesh)
    devices = list(mesh.devices.flat)
    positions = _positions(topo, mesh, n)
    if state is None:
        blocks = [mixed_engine.init_mixed_state(cfg, ccfg, topo, sched, streams, dev, pos=p)
                  for p, dev in zip(positions, devices)]
    else:
        if not _is_placed_on(state, mesh):
            state = mesh_mod.shard_mixed_state(state, mesh)
        blocks = [mesh_mod.position_tree(state, i) for i in range(d)]
    state = None
    # The kernels take contiguous operands: a row block of the [B, N, W]
    # window words is one only at B = 1.
    blocks = [b._replace(data=b.data._replace(oo=b.data.oo.contiguous())) for b in blocks]
    specs = mesh_mod.mixed_state_specs(blocks[0], mesh)
    tally = ExchangeTally()
    box = [blocks]
    blocks = None
    final, curves = mixed_engine.run_rounds(
        cfg, ccfg, topo, sched, streams, seed, box, positions, devices,
        lambda bodies: _lockstep(bodies, mesh, n, tally, watch),
        max_chunk=max_chunk, telemetry=telemetry, after_round=tally.record_state,
    )
    tally.export(info)
    return mesh_mod.from_positions(final, specs, mesh), curves

"""The explicit shard driver of the broadcast plane (counterpart of
corrosion_tpu/parallel/shard_driver.py; its docstring describes the
design).

- **One batched queue exchange a round.** The pending-broadcast queue
  tables (``q_writer``/``q_ver``/``q_tx``, and ``q_gw`` under rotating
  slots) are the whole wire format of the delivery plane. Each position
  publishes its row block once: a gather over the inner (ici) axis, then
  one coalesced hop over the outer (dcn) axis, each a concatenation of
  the blocks of a group of positions in mesh order. The tables travel in
  the reference's 32-bit wire form (``q_writer``/``q_tx`` as int32,
  ``q_ver``/``q_gw`` as their u32 bit patterns in int32) and are widened
  back on receipt; each hop's bytes are counted from the operands it
  moved and emitted as ``xshard_bytes_ici``/``xshard_bytes_dcn``.
  ``traffic_model`` derives the same numbers from the config alone. These
  curves count the queue wire only: the controller cuts the whole
  DataState into the positions' blocks before the bodies run and joins
  their output blocks back after (``_data_block``, ``_join``), and those
  copies, which move the whole [N, W] data plane between positions on
  different devices, are counted nowhere.
- **The round body per position.** ``gossip._broadcast_round`` under a
  ``ShardCtx`` runs once per position on its row block; the bodies run in
  lockstep, and at each cross-shard sum (the reference's ``lax.psum``) the
  driver sums the positions' partials and hands the total back to each.
- **Bit-identity by construction.** Draws whose shape would depend on the
  shard are made at the full shape and row-sliced, so a sharded run
  equals the unsharded one on any mesh.

SWIM, anti-entropy sync, churn and visibility run in the controller on
whole tensors (see ``parallel/__init__.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from corrosion_tpu_torch.ops import gossip as gossip_ops
from corrosion_tpu_torch.ops.gossip import MASK, DataState, ShardCtx
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


def _wire(block: DataState, track: bool) -> list:
    """A block's queue tables in the 32-bit wire form."""
    qs = [block.q_writer.to(torch.int32), _u32_bits(block.q_ver), block.q_tx.to(torch.int32)]
    if track:
        qs.append(_u32_bits(block.q_gw))
    return qs


def _widen(qs: list, track: bool) -> tuple:
    """Gathered wire tables back into the port's int64 carriers."""
    q_w, q_v, q_t = qs[0].to(torch.int64), qs[1].to(torch.int64) & MASK, qs[2].to(torch.int64)
    return q_w, q_v, q_t, (qs[3].to(torch.int64) & MASK) if track else None


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


def _data_block(data: DataState, start: int, n: int, device) -> DataState:
    """A position's block of a whole DataState: its rows of every
    node-major leaf (its cells on node boundaries), the replicated leaves
    whole; views where the position shares the data's device."""
    k = data.cells.cl.shape[0] // max(data.contig.shape[0], 1)

    def rows(x):
        return x[start : start + n].to(device)

    return DataState(
        head=data.head.to(device), contig=rows(data.contig), seen=rows(data.seen),
        # The window words' rows are a view only while there is one word
        # (the kernels take contiguous operands).
        oo=data.oo[:, start : start + n].to(device).contiguous(), oo_any=data.oo_any.to(device),
        q_writer=rows(data.q_writer), q_ver=rows(data.q_ver), q_tx=rows(data.q_tx),
        q_gw=rows(data.q_gw), q_dup=rows(data.q_dup),
        cells=type(data.cells)(*(c[start * k : (start + n) * k].to(device) for c in data.cells)),
    )


def _join(blocks: list, home) -> DataState:
    """The whole DataState on ``home`` from the positions' output blocks
    (replicated leaves from position 0)."""
    def cat(xs, dim=0):
        return torch.cat([x.to(home) for x in xs], dim=dim)

    first = blocks[0]
    return DataState(
        head=first.head.to(home), contig=cat([b.contig for b in blocks]),
        seen=cat([b.seen for b in blocks]), oo=cat([b.oo for b in blocks], 1),
        oo_any=first.oo_any.to(home),
        q_writer=cat([b.q_writer for b in blocks]), q_ver=cat([b.q_ver for b in blocks]),
        q_tx=cat([b.q_tx for b in blocks]), q_gw=cat([b.q_gw for b in blocks]),
        q_dup=cat([b.q_dup for b in blocks]),
        cells=type(first.cells)(*(cat(list(c)) for c in zip(*(b.cells for b in blocks)))),
    )


def _lockstep(bodies: list, devices: list) -> list:
    """Drive the positions' round bodies together. At each cross-shard sum
    every body yields a tuple of partials; their sum (in position order,
    on position 0's device) goes back to each body on its own device.
    Returns each body's result."""
    sends = [None] * len(bodies)
    while True:
        steps = []
        for body, value in zip(bodies, sends):
            try:
                steps.append((False, body.send(value)))
            except StopIteration as done:
                steps.append((True, done.value))
        finished = {f for f, _ in steps}
        if finished == {True}:
            return [v for _, v in steps]
        if len(finished) > 1:
            raise RuntimeError("shard bodies disagree on the round's cross-shard sums")
        parts = [v for _, v in steps]
        total = tuple(
            functools.reduce(torch.add, (p[j].to(devices[0]) for p in parts))
            for j in range(len(parts[0]))
        )
        sends = [tuple(t.to(dev) for t in total) for dev in devices]


@functools.lru_cache(maxsize=None)
def make_sharded_broadcast(mesh: Mesh):
    """A drop-in for ``gossip.broadcast_round`` that runs the delivery
    chain once per mesh position on its row block. It takes the whole
    DataState (the controller's), and returns the whole next DataState and
    the unsharded round's stats plus ``xshard_bytes_ici``/
    ``xshard_bytes_dcn``, the exchange's bytes this round. Cached per
    mesh."""
    axes = tuple(mesh.axis_names)
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
        track = cfg.track_writer_ids
        home = data.contig.device
        blocks = [_data_block(data, i * nl, nl, dev) for i, dev in enumerate(devices)]
        tables, ici, dcn = _exchange([_wire(b, track) for b in blocks], mesh)
        widened = {}  # positions that share a gathered table widen it once
        bodies = []
        for i, (block, dev) in enumerate(zip(blocks, devices)):
            key = id(tables[i][0])
            if key not in widened:
                widened[key] = _widen(tables[i], track)
            q_w, q_v, q_t, q_g = widened[key]

            def at(x, dev=dev):
                return None if x is None else x.to(dev)

            ctx = ShardCtx(axes=axes, row_start=i * nl, q_writer=q_w, q_ver=q_v, q_tx=q_t, q_gw=q_g)
            bodies.append(gossip_ops._broadcast_round(
                block, type(topo)(*(at(x) for x in topo)), at(alive), at(partition),
                at(writes), at(rng), cfg, loss=at(loss), shard=ctx,
            ))
        outs = _lockstep(bodies, devices)
        stats = {k: v.to(home) for k, v in outs[0][1].items()}
        stats["xshard_bytes_ici"] = torch.full((), ici, dtype=torch.float64, device=home)
        stats["xshard_bytes_dcn"] = torch.full((), dcn, dtype=torch.float64, device=home)
        return _join([o[0] for o in outs], home), stats

    return bcast


def per_device_state_bytes(tree) -> dict:
    """Bytes each mesh position holds of a placed state tree (position
    index in the C order of ``mesh.devices`` -> bytes): the measured side
    of the per-position memory claim. Replicated leaves count whole at
    every position, split leaves their block.

    This is the placement at rest, as a ``simulate_*_sharded`` call
    returns it. It is not what a position holds during a run: each round
    the controller assembles the whole state on the mesh's home device
    and runs SWIM, sync and visibility on it, and the broadcast plane's
    blocks are cut from it and joined back into it."""
    out: dict = {}
    for leaf in mesh_mod.tree_leaves(tree):
        if not isinstance(leaf, Placed):
            continue
        for i, b in enumerate(leaf.blocks):
            out[i] = out.get(i, 0) + b.numel() * b.element_size()
    return out


def simulate_sharded(
    cfg, topo, sched, mesh: Mesh, seed: int = 0, state=None, max_chunk: int | None = None,
    telemetry=None,
):
    """The dense engine's run under the shard driver: the broadcast plane
    runs through ``make_sharded_broadcast``, SWIM/sync/visibility run in
    the controller. ``state`` (placed or whole) resumes; the final state
    comes back placed per position. Equal to ``sim.engine.simulate`` on
    one device, bit for bit."""
    from corrosion_tpu_torch.sim import engine

    home = mesh.home
    if state is None:
        state = engine.init_cluster(cfg, len(sched.sample_writer), home)
    final, curves = engine.simulate(
        cfg, topo, sched, seed=seed, state=mesh_mod.assemble(state, home),
        max_chunk=max_chunk, telemetry=telemetry, device=home,
        bcast_fn=make_sharded_broadcast(mesh),
    )
    return mesh_mod.shard_cluster_state(final, mesh), curves


def _place_sparse_resume(resume: dict, mesh: Mesh) -> dict:
    node = node_spec_entry(mesh)
    return dict(
        resume,
        sstate=mesh_mod.shard_sparse_state(resume["sstate"], mesh),
        swim=mesh_mod.shard_node_major(resume["swim"], mesh),
        vis_round=mesh_mod.place_leaf(resume["vis_round"], P(None, node), mesh),
    )


def simulate_sparse_sharded(
    cfg, topo, sched, mesh: Mesh, seed: int = 0, telemetry=None, resume: dict | None = None,
    stop_after_epoch: int | None = None,
):
    """The any-node-writes engine under the shard driver: the slot plane's
    broadcast goes through the exchange (``q_gw`` rides it); rotation,
    cold sync and SWIM run in the controller. Returns what
    ``simulate_sparse`` returns, with the states (and ``info["resume"]``'s)
    placed per position."""
    from corrosion_tpu_torch.sim import sparse_engine

    home = mesh.home
    if resume is not None:
        resume = dict(
            resume, sstate=mesh_mod.assemble(resume["sstate"], home),
            swim=mesh_mod.assemble(resume["swim"], home),
            vis_round=mesh_mod.assemble(resume["vis_round"], home),
        )
    sstate, swim_state, vis_round, curves, info = sparse_engine.simulate_sparse(
        cfg, topo, sched, seed=seed, resume=resume, stop_after_epoch=stop_after_epoch,
        telemetry=telemetry, device=home, bcast_fn=make_sharded_broadcast(mesh),
    )
    info["resume"] = _place_sparse_resume(info["resume"], mesh)
    r = info["resume"]
    return r["sstate"], r["swim"], r["vis_round"], curves, info


def simulate_chunks_sharded(
    ccfg, origin, last_seq, rounds: int, mesh: Mesh, seed: int = 0,
    max_chunk: int | None = None, telemetry=None, faults=None, state=None, vis=None,
    start_round: int = 0,
):
    """The seq-chunk plane with its coverage placed per position. The
    plane has no broadcast queue to exchange, so the xshard curves stay
    zero; ``state``/``vis``/``start_round`` resume a run (the elastic
    seam). Returns (placed state, metrics) with ``metrics["vis"]``
    placed."""
    from corrosion_tpu_torch.sim import chunk_engine

    home = mesh.home
    state, m = chunk_engine.simulate_chunks(
        ccfg, origin, last_seq, rounds, seed=seed, max_chunk=max_chunk, telemetry=telemetry,
        faults=faults,
        state=None if state is None else mesh_mod.assemble(state, home),
        vis=None if vis is None else mesh_mod.assemble(vis, home),
        start_round=start_round, device=home,
    )
    m["vis"] = mesh_mod.place_leaf(m["vis"], P(node_spec_entry(mesh), None), mesh)
    return mesh_mod.shard_chunk_state(state, mesh), m


def simulate_mixed_sharded(
    cfg, ccfg, topo, sched, streams, mesh: Mesh, seed: int = 0, max_chunk: int | None = None,
    telemetry=None, state=None,
):
    """The mixed chunk+version engine under the shard driver: the version
    plane's delivery chain through the exchange, the chunk plane and the
    big versions' admission in the controller. ``state`` resumes at its
    carried ``round``; the final state comes back placed."""
    from corrosion_tpu_torch.sim import mixed_engine

    home = mesh.home
    final, curves = mixed_engine.simulate_mixed(
        cfg, ccfg, topo, sched, streams, seed=seed, max_chunk=max_chunk, telemetry=telemetry,
        state=None if state is None else mesh_mod.assemble(state, home), device=home,
        bcast_fn=make_sharded_broadcast(mesh),
    )
    return mesh_mod.shard_mixed_state(final, mesh), curves

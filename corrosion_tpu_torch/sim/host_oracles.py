"""The host oracles against the simulator's planes.

Each check replays one trace through a plane of the simulator on
``device`` and through the protocol's host bookkeeping (``core/``) in
lockstep, and returns what it compared; a disagreement raises
``AssertionError``. The reference package runs the same traces as tests
(tests/test_ops_window.py, tests/test_sparse_writers.py,
tests/test_mixed_engine.py); here they run on the card as well.

- ``window_trace``: a delivery order replayed through the real broadcast
  round of a 3-node harness (queue surgery) and into ``BookedVersions``;
  possession and need sets compared after every delivered round, on the
  fast delivery path or the legacy one;
- ``rotation_trace``: slot promotion, forced demotion, ``cold_sync`` and
  hot-slot delivery of the sparse writer plane, every possession event
  mirrored into bookies, claims compared after every step;
- ``coverage_trials`` and ``coverage_full_width``: batched chunk arrivals
  into the chunk plane's interval sets against ``Partial``/``RangeSet``;
- ``native_codec``: the native PK codec and value order against the
  Python ones;
- the agent's host oracles: the SQLite CRDT ``Store`` against the cell
  merges (``store_crdt_trials``: the reference's random-stream trials
  against ``crdt.apply_changes``; ``store_crdt_plane``: the engines'
  row-dense merge; ``store_crdt_full``: a run's cells, converged rows
  against a store of every committed version and short rows against a
  store of exactly what they hold), the host ``Swim``'s down-member GC
  beside the kernels' (``membership_gc``), sync's ring preference
  (``membership_rings``), write journeys over a flight
  (``journey_check``) and the transport's frames and a loopback exchange
  (``transport_frames``, ``transport_loopback``). The stores' databases
  go under ``DEFAULT_STORE_ROOT`` (``build/host_oracles``) or ``root``;
- the agent runtime: a live cluster of the port's agents on 127.0.0.1,
  every agent's rows against the card's merge of every change log, the
  subscription and a restored backup against the table
  (``agent_cluster_live``), and its recorded traffic replayed in the
  simulator at 10,000 nodes (``agent_trace_replay``);
- the serving plane: ``loadgen soak`` on ``device`` against its CPU run
  and at 10,000 nodes, each run held to the watermark invariants
  (``loadgen_soak``); the 2,000-subscription fan-out storm, its table
  against the card's merge of its change log and a read through the PG
  wire (``loadgen_storm``); the saturation sweep (``loadgen_sweep``); and
  gossip over mutual TLS (``agent_tls``).
"""

from __future__ import annotations

import asyncio
import math
import os
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from corrosion_tpu_torch import resolve_device, rng
from corrosion_tpu_torch.core.bookkeeping import BookedVersions, Current, Partial
from corrosion_tpu_torch.core.intervals import RangeSet
from corrosion_tpu_torch.ops import crdt, gossip, intervals
from corrosion_tpu_torch.ops import sparse_writers as sw

# -- the possession window against BookedVersions -----------------------------

# Writer 0 carries the trace; writer 1 is the per-round beacon that makes
# "did node 1 pull node 0 this round?" observable from ``seen``.
WINDOW_QUEUE = 8
# The reference traces' window and broadcast key seed.
WINDOW_K = 32
WINDOW_SEED = 0
# (name, order seed, versions, displacement, prefix, batch cap): the
# reference's two differential traces, bounded gaps and a mid-trace cut.
WINDOW_TRACES = (
    ("bounded_gaps", 3, 60, 8.0, 60, 5),
    ("mid_trace", 11, 40, 10.0, 25, 4),
)


def local_shuffle(h: int, disp: float, gen: np.random.Generator) -> np.ndarray:
    """Versions 1..h in an order where element i lands within ``disp`` of
    its sorted position, which bounds every transient gap below 2*disp."""
    keys = np.arange(1, h + 1) + gen.uniform(0, disp, h)
    return np.array(sorted(range(1, h + 1), key=lambda v: keys[v - 1]))


def _window_harness(device):
    cfg = gossip.GossipConfig(
        n_nodes=3, n_writers=2, queue=WINDOW_QUEUE, fanout_near=0, fanout_far=4,
        max_transmissions=6, sync_interval=2, sync_budget=16, sync_chunk=16,
        window_k=WINDOW_K,
    )
    topo = gossip.make_topology([3], [0, 2], device=device)
    return cfg, topo, gossip.init_data(cfg, device)


def _seed_queue(data, batch, head: int, rnd: int):
    """Surgery: node 0's queue holds ``batch`` of writer-0 versions plus the
    round beacon (writer 1, version rnd+1); node 0 possesses everything."""
    dev = data.contig.device
    qw = np.full((3, WINDOW_QUEUE), -1, np.int64)
    qv = np.zeros((3, WINDOW_QUEUE), np.int64)
    qt = np.zeros((3, WINDOW_QUEUE), np.int64)
    k = len(batch)
    qw[0, :k], qv[0, :k], qt[0, :k] = 0, batch, 5
    qw[0, k], qv[0, k], qt[0, k] = 1, rnd + 1, 5
    contig = data.contig.cpu().numpy().copy()
    seen = data.seen.cpu().numpy().copy()
    contig[0, 0] = seen[0, 0] = head
    contig[0, 1] = seen[0, 1] = rnd + 1

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    return data._replace(
        head=t([head, rnd + 1]), contig=t(contig), seen=t(seen),
        q_writer=t(qw), q_ver=t(qv), q_tx=t(qt),
    )


def possessed(contig: np.ndarray, oo: np.ndarray, node: int, ver: int, wk: int) -> bool:
    """Possession of (writer 0, ``ver``) at ``node``: at or below the
    watermark, or bit-set in the window (host copies of the state)."""
    c = int(contig[node, 0])
    if ver <= c:
        return True
    d = ver - c - 1
    if wk and d < wk:
        return bool((int(oo[d // 32, node, 0]) >> (d % 32)) & 1)
    return False


def _compare_window(data, book: BookedVersions, h: int, wk: int, where: str) -> dict:
    """Node 1's possession and need sets against the bookie's."""
    contig, oo = data.contig.cpu().numpy(), data.oo.cpu().numpy()
    plane = {v for v in range(1, h + 1) if possessed(contig, oo, 1, v, wk)}
    host = {v for v in range(1, h + 1) if book.contains_version(v)}
    assert plane == host, f"{where}: possession differs: plane-only {sorted(plane - host)}, " \
        f"bookie-only {sorted(host - plane)}"
    seen = int(data.seen[1, 0])
    assert seen == (book.last() or 0), f"{where}: seen {seen} != bookie last {book.last()}"
    plane_need = {v for v in range(1, seen + 1) if v not in plane}
    host_need = {v for s, e in book.sync_need() for v in range(s, e + 1)}
    assert plane_need == host_need, f"{where}: need sets differ"
    return {"possessed": len(plane), "need": len(plane_need)}


@contextmanager
def legacy_delivery(on: bool):
    """Force the legacy sort+scatter delivery (``_FAST_MAX_WRITERS = 0``)
    for the body when ``on``."""
    old = gossip._FAST_MAX_WRITERS
    if on:
        gossip._FAST_MAX_WRITERS = 0
    try:
        yield
    finally:
        gossip._FAST_MAX_WRITERS = old


def window_trace(order, batch_cap: int, versions: int, legacy: bool = False, device=None):
    """Replay ``order`` through the real broadcast round and the bookie in
    lockstep, comparing node 1's possession of versions 1..``versions``
    and its need set after every delivered round. Returns (data, book,
    stats)."""
    device = resolve_device(device)
    cfg, topo, data = _window_harness(device)
    dev = data.contig.device
    order = np.asarray(order)
    h = len(order)
    alive = torch.ones(3, dtype=torch.bool, device=dev)
    part = torch.zeros((1, 1), dtype=torch.bool, device=dev)
    zero_w = torch.zeros(2, dtype=torch.int64, device=dev)
    key = rng.PRNGKey(WINDOW_SEED, device=dev)
    book = BookedVersions()
    sent = rnd = delivered_rounds = 0
    last = {}
    with legacy_delivery(legacy):
        while sent < h and rnd < 400:
            batch = order[sent:sent + batch_cap]
            data = _seed_queue(data, batch, h, rnd)
            key, k1 = rng.split(key)
            data, _ = gossip.broadcast_round(data, topo, alive, part, zero_w, k1, cfg)
            if int(data.seen[1, 1]) == rnd + 1:
                for v in batch:
                    book.insert_many(int(v), int(v), Current(db_version=int(v), last_seq=0, ts=0))
                sent += len(batch)
                delivered_rounds += 1
                last = _compare_window(data, book, versions, WINDOW_K, f"round {rnd}")
            rnd += 1
    assert sent == h, "trace did not finish (source never sampled?)"
    return data, book, {"rounds": rnd, "delivered_rounds": delivered_rounds, **last}


def window_bookie(device=None, legacy: bool = False) -> dict:
    """The reference's two differential traces on the fast delivery path
    (or the legacy one), each compared after every delivered round."""
    device = resolve_device(device)
    out = {}
    for name, seed, h, disp, prefix, cap in WINDOW_TRACES:
        order = local_shuffle(h, disp, np.random.default_rng(seed))[:prefix]
        data, book, stats = window_trace(order, cap, h, legacy=legacy, device=device)
        if prefix == h:
            # Everything was delivered: node 1 holds every version and its
            # window drains fully.
            assert all(book.contains_version(v) for v in range(1, h + 1))
            assert int(data.contig[1, 0]) == h and int(data.oo[:, 1, 0].sum()) == 0
        out[name] = stats
    return out


# -- writer rotation against the bookies --------------------------------------


def claims(sstate, writer: int, n: int) -> np.ndarray:
    """Possession claim per node for global ``writer`` from a sparse state:
    the hot slot's contig, else a deviation entry, else ``head_full``."""
    slot_writer = sstate.slot_writer.cpu().numpy()
    hot = np.nonzero(slot_writer == writer)[0]
    if len(hot):
        return sstate.data.contig.cpu().numpy()[:, hot[0]].copy()
    out = np.full(n, int(sstate.head_full[writer]), np.int64)
    dev_w = sstate.dev_writer.cpu().numpy()
    dev_c = sstate.dev_contig.cpu().numpy()
    for i in range(n):
        hit = np.nonzero(dev_w[i] == writer)[0]
        if len(hit):
            out[i] = dev_c[i, hit[0]]
    return out


def _assert_claims_match(sstate, bookies, writers, n: int, where: str) -> list:
    got = []
    for w in writers:
        claim = claims(sstate, w, n)
        for i in range(n):
            bv = bookies[i][w]
            c = int(claim[i])
            assert (bv.last() or 0) == c, \
                f"{where}: node {i} writer {w}: plane claims {c}, bookie has {bv.last()}"
            assert all(bv.contains_version(v) for v in range(1, c + 1)), where
            assert not bv.contains_version(c + 1), where
        got.append(claim.tolist())
    return got


def rotation_trace(device=None) -> dict:
    """The reference's rotation trace on 4 nodes and 2 hot slots: promote
    writers 1 and 2; writer 1 commits 6 versions with node 3 lagging at 2;
    force-demote slot 0 and promote writer 3 there (a deviation entry for
    node 3); ``cold_sync`` heals node 3 from the origin; writer 3 commits
    through the real broadcast round. Every possession event goes into the
    bookies, and the claims are compared after every step. Returns the
    claims of writers 1-3 after each step."""
    device = resolve_device(device)
    n, w_hot = 4, 2
    g = gossip.GossipConfig(
        n_nodes=n, n_writers=w_hot, track_writer_ids=True, n_cells=0,
        queue=4, fanout_near=2, fanout_far=1, sync_interval=4,
    )
    sp = sw.SparseConfig(epoch_rounds=4, k_dev=4, d_max=2, p_max=2)
    st = sw.init_sparse(g, sp, device)
    dev = st.data.contig.device
    bookies = [{w: BookedVersions() for w in range(n)} for _ in range(n)]
    steps = {}

    def t(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def record(node, writer, start, end):
        # Current applies to a single version: insert each delivered
        # version as the ingest path does.
        for v in range(start, end + 1):
            bookies[node][writer].insert(v, Current(db_version=v, last_seq=0, ts=0))

    def check(step):
        steps[step] = _assert_claims_match(st, bookies, [1, 2, 3], n, step)

    zeros2, false2 = t([0, 0]), t([False, False], torch.bool)
    st, _ = sw.rotate(st, zeros2, false2, t([0, 1]), t([1, 2]), t([True, True], torch.bool), g)
    check("promote")

    contig = st.data.contig.cpu().numpy().copy()
    contig[:, 0] = [6, 6, 6, 2]
    head = st.data.head.cpu().numpy().copy()
    head[0] = 6
    st = st._replace(data=st.data._replace(contig=t(contig), head=t(head), seen=t(contig)))
    for i, c in enumerate([6, 6, 6, 2]):
        record(i, 1, 1, c)
    check("commit")

    caught, maxload = sw.demote_report(st, t([0, 0]), t([True, False], torch.bool))
    assert not bool(caught[0]) and int(maxload[0]) <= sp.k_dev
    st, stats = sw.rotate(
        st, t([0, 0]), t([True, False], torch.bool), t([0, 0]), t([3, 0]),
        t([True, False], torch.bool), g,
    )
    assert int(stats["dev_dropped"]) == 0 and int(stats["dev_entries"]) == 1
    check("demote")  # rotation changes no possession

    st, cstats = sw.cold_sync(
        st, t(np.zeros(n, np.int64)), torch.ones(n, dtype=torch.bool, device=dev),
        torch.zeros((1, 1), dtype=torch.bool, device=dev), g, sp,
    )
    assert int(cstats["cold_healed"]) == 4
    record(3, 1, 3, 6)
    check("cold_sync")
    assert not bool(st.dev_any)

    # Writer 3 (now hot in slot 0) commits through the real broadcast
    # round; in-order deliveries go into the bookies from the contig deltas.
    topo = gossip.make_topology([n], np.array([3, 2]), device=dev)
    topo = topo._replace(writer_ids=t([3, 2]), writer_of_node=t([-1, -1, 1, 0]))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    part = torch.zeros((1, 1), dtype=torch.bool, device=dev)
    key = rng.PRNGKey(5, device=dev)
    for r in range(6):
        key, k = rng.split(key)
        writes = t([1 if r < 2 else 0, 0])
        before = st.data.contig.cpu().numpy().copy()
        data, _ = gossip.broadcast_round(st.data, topo, alive, part, writes, k, g)
        st = st._replace(data=data)
        after = st.data.contig.cpu().numpy()
        for i in range(n):
            for s, w in ((0, 3), (1, 2)):
                if after[i, s] > before[i, s]:
                    record(i, w, int(before[i, s]) + 1, int(after[i, s]))
    check("broadcast")
    return steps


# -- chunk coverage against Partial / RangeSet --------------------------------


def _host_gaps(iv_starts: np.ndarray, iv_ends: np.ndarray) -> list:
    return [(int(a), int(b)) for a, b in zip(iv_starts, iv_ends) if a <= b]


# The reference's eight trials over seqs 0..4095, and the order seed.
COVERAGE_TRIALS = 8
COVERAGE_SEED = 3
COVERAGE_LAST_SEQ = 4095
# The full-width check's arrivals and its generator's seed.
FULL_WIDTH_ARRIVALS = 32
FULL_WIDTH_SEED = 0


def coverage_trials(device=None) -> dict:
    """The reference's eight trials: shuffled 256-seq chunks (each running
    0-63 seqs past its end) with a third of them again as duplicates, into
    one 16-slot interval set on ``device`` and one ``Partial``; the gap
    sets and completeness compared after every arrival."""
    device = resolve_device(device)
    gen = np.random.default_rng(COVERAGE_SEED)
    last_seq = COVERAGE_LAST_SEQ
    arrivals = 0
    for trial in range(COVERAGE_TRIALS):
        iv = intervals.make(16, device=device)
        part = Partial(seqs=RangeSet(), last_seq=last_seq, ts=0)
        chunks = [
            (s, min(s + 255 + int(gen.integers(0, 64)), last_seq))
            for s in range(0, last_seq + 1, 256)
        ]
        gen.shuffle(chunks)
        chunks = chunks + chunks[: len(chunks) // 3]
        for s, e in chunks:
            iv = intervals.insert(iv, s, e)
            part.seqs.insert(s, e)
            kg = intervals.gaps(iv, 0, last_seq)
            plane = _host_gaps(kg.starts.cpu().numpy(), kg.ends.cpu().numpy())
            host = list(part.seqs.gaps(0, last_seq))
            assert plane == host, f"trial {trial}: plane {plane} vs host {host}"
            done = int(intervals.contiguous_watermark(iv, 0)) >= last_seq
            assert done == part.is_complete()
            arrivals += 1
        assert part.is_complete()
    return {"trials": COVERAGE_TRIALS, "arrivals": arrivals}


def coverage_full_width(device, rows: int, cap: int = 16, last_seq: int = 8191,
                        chunk_len: int = 256, sample: int = 2000) -> dict:
    """``FULL_WIDTH_ARRIVALS`` batched chunk arrivals into ``rows``
    interval sets at once (the chunk plane's (node, stream) rows): each
    arrival gives every row one chunk, its index drawn from a seeded
    ``torch.Generator`` (so rows see duplicates), running 0-63 seqs past
    its end. Then ``sample`` rows,
    drawn with the same generator, replay their arrivals through
    ``RangeSet``: the gap sets over [0, last_seq] and the contiguous
    watermark must be equal. Consecutive chunks touch, so a row holds at
    most ceil(chunks / 2) disjoint runs, within ``cap``."""
    dev = resolve_device(device)
    n_chunks = -(-(last_seq + 1) // chunk_len)
    assert -(-n_chunks // 2) <= cap, "the arrivals could overflow the interval sets"
    arrivals = FULL_WIDTH_ARRIVALS
    gen = torch.Generator(device="cpu").manual_seed(FULL_WIDTH_SEED)
    idx = torch.randint(0, n_chunks, (arrivals, rows), generator=gen)
    ext = torch.randint(0, 64, (arrivals, rows), generator=gen)
    starts = idx * chunk_len
    ends = torch.clamp(starts + chunk_len - 1 + ext, max=last_seq)
    pick = torch.randperm(rows, generator=gen)[:sample]
    s_dev, e_dev = starts.to(dev), ends.to(dev)

    iv = intervals.make(cap, (rows,), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for a in range(arrivals):
        iv = intervals.insert(iv, s_dev[a], e_dev[a])
    kg = intervals.gaps(iv, 0, last_seq)
    wm = intervals.contiguous_watermark(iv, 0)
    p_dev = pick.to(dev)
    g_s, g_e = kg.starts[p_dev].cpu().numpy(), kg.ends[p_dev].cpu().numpy()
    wm_s = wm[p_dev].cpu().numpy()
    counts = intervals.count(iv).cpu().numpy()

    s_np, e_np = starts[:, pick].numpy(), ends[:, pick].numpy()
    for j in range(sample):
        rs = RangeSet()
        for a in range(arrivals):
            rs.insert(int(s_np[a, j]), int(e_np[a, j]))
        host = list(rs.gaps(0, last_seq))
        plane = _host_gaps(g_s[j], g_e[j])
        assert plane == host, f"row {int(pick[j])}: plane {plane} vs host {host}"
        first = next(iter(rs), None)
        host_wm = first[1] if first is not None and first[0] <= 0 else -1
        assert int(wm_s[j]) == host_wm, f"row {int(pick[j])}: watermark {int(wm_s[j])} vs {host_wm}"
    return {
        "rows": rows, "arrivals": arrivals, "sample": sample,
        "max_intervals": int(counts.max()), "complete_rows": int((wm.cpu() >= last_seq).sum()),
    }


# -- the native codec against the Python codec --------------------------------

# tests/test_native.py's samples and comparison values.
CODEC_SAMPLES = (
    (),
    (None,),
    (0,), (1,), (-1,), (63,), (64,), (-64,), (-65,),
    (2**62, -(2**62), 2**63 - 1, -(2**63)),
    (0.0, -0.0, 1.5, -2.75, 1e300, -1e300, math.inf, -math.inf),
    ("", "hi", "héllo wörld", "☃" * 100),
    (b"", b"\x00\xff", bytes(range(256))),
    (None, 42, 2.5, "mixed", b"blob", True, False),
)
CMP_VALUES = (
    None, -(2**63), -5, -1, 0, 1, 5, 2**63 - 1,
    -1e300, -2.5, -0.5, 0.0, 0.5, 2.5, 1e300,
    2**53 + 1, float(2**53),
    "", "a", "ab", "b", "é",
    b"", b"a", b"ab", b"b", b"\xff",
)


def native_codec() -> dict:
    """Build the native artifacts, then hold
    the native PK codec to the Python one on ``CODEC_SAMPLES`` (equal bytes,
    equal round trips) and ``value_cmp`` to ``value_cmp_key`` pairwise.
    Raises when the codec is not built."""
    from corrosion_tpu_torch import native
    from corrosion_tpu_torch.core import values as V

    native.build()
    status = native.build_status()
    assert native.available(), f"the native codec did not build: {status}"
    mod = native.native
    for vals in CODEC_SAMPLES:
        nb = mod.pack_columns(list(vals))
        assert nb == V._py_pack_columns(vals), vals
        want = tuple(int(v) if isinstance(v, bool) else v for v in vals)
        assert mod.unpack_columns(nb) == want == V._py_unpack_columns(nb), vals
    for a in CMP_VALUES:
        for b in CMP_VALUES:
            ka, kb = V.value_cmp_key(a), V.value_cmp_key(b)
            want = -1 if ka < kb else (1 if ka > kb else 0)
            assert mod.value_cmp(a, b) == want, (a, b)
    return {**status, "samples": len(CODEC_SAMPLES), "cmp_pairs": len(CMP_VALUES) ** 2}


# -- the CRDT store against the cell merges -----------------------------------

# One simulated cell is one row of this table (tests/test_crdt_differential.py's
# mapping): key k, value ``value_rank``.
CELLS_TABLE = "cells"
CELLS_SCHEMA = f"CREATE TABLE {CELLS_TABLE} (k INTEGER NOT NULL PRIMARY KEY, v INTEGER)"
# The store's own actor id; remote changes carry their writer's (``site_id``).
STORE_SITE = b"\xff" * 16
# The reference's random-stream trials: seed, trials, keys, changes a site.
TRIAL_SEED = 7
TRIALS = 6
TRIAL_KEYS = 8
TRIAL_CHANGES = 40
# The 16-node plane: 8 writers of up to 64 versions, 4 delivery batches of
# 64 entries a node, two cells a version.
PLANE_NODES = 16
PLANE_CELLS = 256
PLANE_WRITERS = 8
PLANE_MAX_VERSION = 64
PLANE_BATCHES = 4
PLANE_WIDTH = 64
PLANE_CELLS_PER_WRITE = 2
PLANE_SEED = 13
# Rows of a full-width state held to a store of exactly their versions.
FULL_SAMPLE = 16
FULL_SEED = 5
# The engines' round length (``ClusterConfig.round_ms``, which every
# baseline keeps): a schedule's round r is wall time r * ROUND_MS.
ROUND_MS = 500.0
# The limit on each host exchange (the Swim checks, the loopback).
HOST_LIMIT_S = 10.0
DEFAULT_STORE_ROOT = Path(__file__).resolve().parents[2] / "build" / "host_oracles"


def site_id(writer: int) -> bytes:
    """Writer ``writer``'s fixed 16-byte site id."""
    return int(writer).to_bytes(16, "big")


def fresh_store(root, name: str):
    """A new ``Store`` with the cells table at ``root/name``; any earlier
    database of that name (and its WAL files) is removed first."""
    from corrosion_tpu_torch.agent.store import Store

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    path = root / name
    for p in (path, path.with_name(path.name + "-wal"), path.with_name(path.name + "-shm")):
        p.unlink(missing_ok=True)
    store = Store(str(path), STORE_SITE)
    store.apply_schema(CELLS_SCHEMA)
    return store


def cell_change(key: int, cl: int, cv: int, val: int, site: bytes, db_version: int,
                seq: int):
    """One ``Change`` of cell ``key``: an odd ``cl`` writes column ``v``, an
    even one is the row's delete marker."""
    from corrosion_tpu_torch.core.values import Change, pack_columns

    pk = pack_columns([int(key)])
    if cl % 2 == 0:
        return Change(table=CELLS_TABLE, pk=pk, cid=Change.DELETE_CID, val=None,
                      col_version=int(cv), db_version=db_version, seq=seq, site_id=site,
                      cl=int(cl))
    return Change(table=CELLS_TABLE, pk=pk, cid="v", val=int(val), col_version=int(cv),
                  db_version=db_version, seq=seq, site_id=site, cl=int(cl))


def derived_changes(writers, versions, n_cells: int, cells_per_write: int) -> list:
    """The changes of committed versions (``writers[i]``, ``versions[i]``),
    in that order: slot j of a version is ``crdt.derive_change(w, v, j,
    n_cells)`` as ``Change`` ``seq`` j of the writer's ``db_version`` v."""
    w = torch.as_tensor(np.asarray(writers, np.int64))
    v = torch.as_tensor(np.asarray(versions, np.int64))
    slots = [[t.tolist() for t in crdt.derive_change(w, v, j, n_cells)]
             for j in range(cells_per_write)]
    out = []
    for i, (wi, vi) in enumerate(zip(w.tolist(), v.tolist())):
        site = site_id(wi)
        for j, (key, cl, cv, vr) in enumerate(slots):
            out.append(cell_change(key[i], cl[i], cv[i], vr[i], site, vi, j))
    return out


def store_cells(store, n_cells: int) -> tuple:
    """The store's cells as three int64 arrays (cl, col_version, value):
    cl from the causal-length table (0 where the store never saw the key),
    col_version from the clock of column ``v``, the value from the table
    (0 where the row is gone)."""
    from corrosion_tpu_torch.core.values import unpack_columns

    cl = np.zeros(n_cells, np.int64)
    cv = np.zeros(n_cells, np.int64)
    val = np.zeros(n_cells, np.int64)
    conn = store.conn
    for pk, c in conn.execute(f'SELECT pk, cl FROM "{CELLS_TABLE}__crdt_rows"'):
        cl[unpack_columns(pk)[0]] = c
    for pk, c in conn.execute(
        f'SELECT pk, col_version FROM "{CELLS_TABLE}__crdt_clock" WHERE cid = \'v\''
    ):
        cv[unpack_columns(pk)[0]] = c
    for k, v in conn.execute(f'SELECT k, v FROM "{CELLS_TABLE}"'):
        val[k] = 0 if v is None else v
    return cl, cv, val


def cells_mismatch(cl, cv, vr, want: tuple) -> torch.Tensor:
    """bool per row of the plane's cells ``cl``/``cv``/``vr`` ([..., K] on
    any device) that differ from the store's ``want`` (``store_cells``),
    as tests/test_crdt_differential.py compares them: the causal length
    everywhere (0 where the store never saw the key), the col_version and
    the value where the row is live (odd)."""
    dev = cl.device
    w_cl, w_cv, w_val = (torch.as_tensor(a, device=dev) for a in want)
    live = (w_cl % 2) == 1
    ok = (cl == w_cl) & (~live | ((cv == w_cv) & (vr == w_val)))
    return ~ok.all(dim=-1)


def _assert_stores_equal(a: tuple, b: tuple, where: str) -> None:
    bad = [name for name, x, y in zip(("cl", "col_version", "value"), a, b)
           if not np.array_equal(x, y)]
    assert not bad, f"{where}: the two stores differ in {bad}"


def store_merge(root=DEFAULT_STORE_ROOT) -> bool:
    """Whether this host's store merges through the native CRDT helpers."""
    store = fresh_store(root, "probe.db")
    try:
        return store.native_crdt
    finally:
        store.close()


def random_changes(gen: np.random.Generator, n: int, site: bytes) -> list:
    """tests/test_crdt_differential.py's stream: (key, cl, col_version,
    value, site), about a sixth of them deletes (even cl)."""
    out = []
    for _ in range(n):
        key = int(gen.integers(0, TRIAL_KEYS))
        cl = int(gen.integers(1, 4))
        cl = cl * 2 if gen.random() < 1 / 6 else cl * 2 - 1
        cv = int(gen.integers(1, 6))
        val = int(gen.integers(0, 1000))
        out.append((key, cl, cv, val, site))
    return out


def _trial_changes(stream: list) -> list:
    # A delete carries col_version 1 (the store's sentinel), as the
    # reference test writes it; db_version is the stream position.
    return [cell_change(k, cl, 1 if cl % 2 == 0 else cv, val, site, i + 1, 0)
            for i, (k, cl, cv, val, site) in enumerate(stream)]


def store_crdt_trials(device=None, root=DEFAULT_STORE_ROOT) -> dict:
    """The reference's six random-stream trials: 40 + 40 changes of two
    sites over 8 keys, through two ``Store``s in two orders and through
    ``crdt.apply_changes`` on ``device`` in one batch; the stores must be
    equal and the cells equal to them."""
    device = resolve_device(device)
    gen = np.random.default_rng(TRIAL_SEED)
    merges = "native" if store_merge(root) else "python"
    for trial in range(TRIALS):
        site_a, site_b = site_id(2 * trial + 1), site_id(2 * trial + 2)
        stream = (random_changes(gen, TRIAL_CHANGES, site_a)
                  + random_changes(gen, TRIAL_CHANGES, site_b))
        order = gen.permutation(len(stream))
        states = []
        for name, chs in ((f"trial{trial}_a.db", stream),
                          (f"trial{trial}_b.db", [stream[i] for i in order])):
            store = fresh_store(root, name)
            try:
                store.apply_changes(_trial_changes(chs))
                states.append(store_cells(store, TRIAL_KEYS))
            finally:
                store.close()
        _assert_stores_equal(*states, f"trial {trial}")
        key, cl, cv, val = torch.as_tensor([c[:4] for c in stream], device=device).T.contiguous()
        # A delete carries no cell write: col_version and value 0 in the
        # kernel, as the reference test gives them.
        dele = cl % 2 == 0
        batch = crdt.ChangeBatch(
            key=key, cl=cl, col_version=torch.where(dele, 0, cv),
            value_rank=torch.where(dele, 0, val),
            mask=torch.ones(len(stream), dtype=torch.bool, device=device),
        )
        cells = crdt.apply_changes(crdt.make_cells(TRIAL_KEYS, device), batch)
        assert not bool(cells_mismatch(*cells, states[0])), f"trial {trial}: cells differ"
    return {"trials": TRIALS, "changes": TRIALS * 2 * TRIAL_CHANGES, "merge": merges}


def plane_batches(device=None) -> tuple:
    """The 16-node plane's delivery batches, drawn on the host from one
    seeded ``torch.Generator``: per writer a head in [1, 64], per batch and
    node 64 entries (writer, a version at or below its head) and a mask
    that keeps a node-specific share of them. Returns (head, [(writer,
    version, mask) on ``device``, ...])."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(PLANE_SEED)
    head = torch.randint(1, PLANE_MAX_VERSION + 1, (PLANE_WRITERS,), generator=g)
    keep = torch.rand(PLANE_NODES, 1, generator=g)
    out = []
    for _ in range(PLANE_BATCHES):
        w = torch.randint(0, PLANE_WRITERS, (PLANE_NODES, PLANE_WIDTH), generator=g)
        v = 1 + (torch.rand(PLANE_NODES, PLANE_WIDTH, generator=g, dtype=torch.float64)
                 * head[w]).long()
        mask = torch.rand(PLANE_NODES, PLANE_WIDTH, generator=g) < keep
        out.append(tuple(x.to(device) for x in (w, v, mask)))
    return head, out


def store_crdt_plane(device=None, root=DEFAULT_STORE_ROOT) -> dict:
    """``plane_batches`` through the engines' row-dense cell merge
    (``gossip._merge_versions_dense``, every row) on ``device``, each node's
    row held to a ``Store`` fed that node's derived changes in a shuffled
    order."""
    device = resolve_device(device)
    cfg = gossip.GossipConfig(n_nodes=PLANE_NODES, n_writers=PLANE_WRITERS,
                              n_cells=PLANE_CELLS, cells_per_write=PLANE_CELLS_PER_WRITE)
    _, batches = plane_batches(device)
    cells = crdt.make_cells(PLANE_NODES * PLANE_CELLS, device)
    merges = 0
    for w, v, mask in batches:
        cells, m = gossip._merge_versions_dense(cells, None, w, v, mask, None,
                                                PLANE_NODES, cfg)
        merges += int(m)
    rows = [c.reshape(PLANE_NODES, PLANE_CELLS) for c in cells]
    host = [tuple(x.cpu().numpy() for x in b) for b in batches]
    gen = np.random.default_rng(PLANE_SEED)
    changes = 0
    for node in range(PLANE_NODES):
        pairs = [(int(w[node, i]), int(v[node, i])) for w, v, mask in host
                 for i in np.nonzero(mask[node])[0]]
        pairs = [pairs[i] for i in gen.permutation(len(pairs))]
        chs = derived_changes([p[0] for p in pairs], [p[1] for p in pairs],
                              PLANE_CELLS, PLANE_CELLS_PER_WRITE)
        changes += len(chs)
        store = fresh_store(root, f"plane_node{node}.db")
        try:
            store.apply_changes(chs)
            want = store_cells(store, PLANE_CELLS)
        finally:
            store.close()
        bad = cells_mismatch(*(r[node] for r in rows), want)
        assert not bool(bad), f"node {node}: cells differ from its store"
    return {"nodes": PLANE_NODES, "cells": PLANE_CELLS, "cell_merges": merges,
            "store_changes": changes}


def held_versions(contig_row: np.ndarray, oo_row: np.ndarray) -> tuple:
    """(writers, versions) a node holds: each writer's prefix 1..contig and
    the versions whose window bit is set (``oo_row`` [B, W], bit b of word
    k is version contig + 1 + 32k + b)."""
    ws, vs = [], []
    for w, c in enumerate(contig_row.tolist()):
        ws += [w] * c
        vs += range(1, c + 1)
        for k in range(oo_row.shape[0]):
            word = int(oo_row[k, w]) & 0xFFFFFFFF
            for b in range(32):
                if (word >> b) & 1:
                    ws.append(w)
                    vs.append(c + 1 + 32 * k + b)
    return ws, vs


def store_crdt_full(cells, head, contig, oo, alive, cfg, root=DEFAULT_STORE_ROOT,
                    sample: int = FULL_SAMPLE) -> dict:
    """A run's cells (``crdt.CellState`` of [N * K] planes) against the
    SQLite store, on the device that holds them, with the run's ``head``
    [W], ``contig`` [N, W], window words ``oo`` [B, N, W] and ``alive`` [N]
    (a ``DataState``'s fields). One store takes every
    committed (w, v <= head[w]) in two seeded orders: the two must be equal,
    and equal to ``gossip.serial_merge_reference(head)`` on ``device``.
    Every alive row whose ``contig`` equals ``head`` must equal that store
    (one broadcast compare on the device). Then ``sample`` rows whose
    ``contig`` falls short of ``head`` (drawn with a seeded generator) are
    each held to a store fed exactly the versions they hold, their prefix
    and their window bits."""
    k, n = cfg.n_cells, contig.shape[0]
    h = head.cpu().numpy().astype(np.int64)
    ws = np.repeat(np.arange(len(h)), h)
    vs = np.arange(len(ws)) - np.repeat(np.cumsum(h) - h, h) + 1
    gen = np.random.default_rng(FULL_SEED)
    states = []
    for name in ("full_a.db", "full_b.db"):
        order = gen.permutation(len(ws))
        store = fresh_store(root, name)
        try:
            store.apply_changes(derived_changes(ws[order], vs[order], k, cfg.cells_per_write))
            states.append(store_cells(store, k))
        finally:
            store.close()
    _assert_stores_equal(*states, "the committed versions")
    want = states[0]
    ref = gossip.serial_merge_reference(head, cfg, head.device)
    assert not bool(cells_mismatch(*ref, want)), "serial_merge_reference differs from the store"
    rows = [c.reshape(n, k) for c in cells]
    conv = alive & (contig == head[None, :]).all(dim=1)
    n_conv = int(conv.sum())
    n_bad = int((cells_mismatch(*rows, want) & conv).sum())
    assert n_bad == 0, f"{n_bad} of {n_conv} converged rows differ from the store"
    out = {"versions": int(len(ws)), "store_changes": int(len(ws)) * cfg.cells_per_write,
           "converged_rows": n_conv, "rows": n}
    short = torch.nonzero((contig < head[None, :]).any(dim=1)).flatten().cpu()
    out["short_rows"] = int(short.numel())
    g = torch.Generator().manual_seed(FULL_SEED)
    picks = short[torch.randperm(short.numel(), generator=g)[:sample]].tolist()
    contig_h = contig[picks].cpu().numpy()
    oo_h = oo[:, picks].cpu().numpy()
    held = 0
    for i, row in enumerate(picks):
        rws, rvs = held_versions(contig_h[i], oo_h[:, i])
        held += len(rws)
        order = gen.permutation(len(rws))
        store = fresh_store(root, f"row{row}.db")
        try:
            store.apply_changes(derived_changes(np.asarray(rws, np.int64)[order],
                                                np.asarray(rvs, np.int64)[order],
                                                k, cfg.cells_per_write))
            got = store_cells(store, k)
        finally:
            store.close()
        assert not bool(cells_mismatch(*(r[row] for r in rows), got)), \
            f"row {row}: cells differ from its store"
    out.update(short_rows_checked=len(picks), short_rows_versions=held)
    return out


# -- SWIM: the host's down-member GC against the kernels' ---------------------


def kernel_gc_states(device=None) -> dict:
    """tests/test_membership_adaptive.py's kernel GC cases on ``device``:
    every node believes node 3 down at incarnation 2, then one SWIM round
    at ``down_gc_rounds`` 1 (dense view; sparse exception tables) and 0
    (sparse, GC off). Returns the three states after the round."""
    device = resolve_device(device)
    from corrosion_tpu_torch.ops import swim, swim_sparse

    key = rng.PRNGKey(0, device)
    rnd = torch.zeros((), dtype=torch.int64, device=device)
    down = swim.pack(torch.tensor(2, device=device), swim.SEV_DOWN)
    cfg = swim.SwimConfig(n_nodes=8, down_gc_rounds=1)
    st = swim.init_state(cfg, device)
    view = st.view.clone()
    view[:, 3] = down
    alive = st.alive.clone()
    alive[3] = False
    out = {"dense": swim.swim_round(st._replace(view=view, alive=alive), key, rnd, cfg)}
    for name, gc in (("sparse", 1), ("sparse_gc_off", 0)):
        cfg = swim.SwimConfig(n_nodes=8, view_capacity=4, down_gc_rounds=gc)
        st = swim_sparse.init_state(cfg, device)
        tgt, pkd, alive = st.exc_tgt.clone(), st.exc_pkd.clone(), st.alive.clone()
        tgt[:, 0] = 3
        pkd[:, 0] = down
        alive[3] = False
        out[name] = swim_sparse.swim_round(
            st._replace(exc_tgt=tgt, exc_pkd=pkd, alive=alive), key, rnd, cfg)
    return out


# _noop_send never acks, so every probe waits this out (the indirect ones
# twice); the checks read the GC and the transmissions, not the waits.
PROBE_TIMEOUT_S = 0.05


async def _noop_send(addr, msg):
    return True


async def _host_gc(membership) -> dict:
    members = membership.Members("me")
    sw = membership.Swim(members, ("127.0.0.1", 0), _noop_send, max_transmissions=4,
                         probe_timeout=PROBE_TIMEOUT_S)
    sw.down_gc_s = 0.05
    a, b = "aa" * 16, "bb" * 16
    members.apply_update(a, ("10.0.0.1", 1), membership.ALIVE, 0)
    members.apply_update(b, ("10.0.0.2", 1), membership.ALIVE, 0)
    members.apply_update(b, ("10.0.0.2", 1), membership.DOWN, 0)
    assert b in members.states
    await asyncio.sleep(0.1)
    await sw.probe_round()
    assert b not in members.states, "the down member outlived the GC horizon"
    assert a in members.states, "the GC forgot an alive member"
    return {"forgotten": 1, "kept": 1}


async def _host_adaptive(membership) -> dict:
    members = membership.Members("me")
    sw = membership.Swim(members, ("127.0.0.1", 0), _noop_send, max_transmissions=4,
                         probe_timeout=PROBE_TIMEOUT_S)
    for i in range(2):  # 3 nodes: self and two
        members.apply_update(f"{i:032x}", ("10.0.0.1", i + 1), membership.ALIVE, 0)
    await sw.probe_round()
    tx_small, ind_small = sw.max_transmissions, sw.indirect_probes
    for i in range(2, 31):  # 32 members
        members.apply_update(f"{i:032x}", ("10.0.0.1", i + 1), membership.ALIVE, 0)
    await sw.probe_round()
    assert sw.max_transmissions > tx_small and sw.max_transmissions >= 7
    assert sw.indirect_probes >= ind_small
    return {"max_transmissions": [tx_small, sw.max_transmissions],
            "indirect_probes": [ind_small, sw.indirect_probes]}


def membership_gc(device=None) -> dict:
    """The kernels' down-member GC (``kernel_gc_states``: the dense view and
    the sparse tables forget node 3's down beliefs, and keep them with the
    GC off) beside the host ``Swim``'s (a down member forgotten after
    ``down_gc_s``, an alive one kept) and its cluster-size-adaptive
    transmissions (3 -> 32 members), the two host checks side by side,
    each under ``HOST_LIMIT_S`` seconds."""
    device = resolve_device(device)
    from corrosion_tpu_torch.agent import membership
    from corrosion_tpu_torch.ops import swim

    st = kernel_gc_states(device)
    assert not bool((swim.packed_sev(st["dense"].view[:, 3]) == swim.SEV_DOWN).any()), \
        "dense: down beliefs survived the GC horizon"
    for name, kept in (("sparse", False), ("sparse_gc_off", True)):
        s = st[name]
        slots = (swim.packed_sev(s.exc_pkd) == swim.SEV_DOWN) & (s.exc_tgt == 3)
        assert bool(slots.any()) == kept, f"{name}: down slots {'freed' if kept else 'kept'}"

    async def host():
        # Both wait out probe timeouts, so they run side by side.
        return await asyncio.gather(
            asyncio.wait_for(_host_gc(membership), HOST_LIMIT_S),
            asyncio.wait_for(_host_adaptive(membership), HOST_LIMIT_S),
        )

    gc, adaptive = asyncio.run(host())
    return {"kernel_cases": len(st), "host_gc": gc, "host_adaptive": adaptive}


# -- sync's ring preference and the host ring classifier ----------------------

RING_SEEDS = 40
# The harness carries cells, so the sync's grants go through the engines'
# cell merge (rowmax, rowgather) and node 0's row can be held to a store.
RING_CELLS = 64


def ring_config(cfg_cls=None):
    """The ring harness's gossip config (``cfg_cls`` builds it: the port's
    ``GossipConfig`` by default)."""
    return (cfg_cls or gossip.GossipConfig)(
        n_nodes=9, n_writers=2, fanout_near=0, fanout_far=0, sync_interval=1,
        sync_budget=4, sync_chunk=4, sync_peers=1, sync_candidates=8, n_cells=RING_CELLS,
    )


def ring_sync(device=None) -> list:
    """tests/test_rtt_rings.py's need tie: node 0 may pull writer 0 from two
    ring-0 holders in its own region or writer 1 from six ring-5 holders;
    one ``gossip.sync_round`` a seed over ``RING_SEEDS`` seeds on
    ``device``. Returns node 0's (contig, cells) after each."""
    device = resolve_device(device)
    rtt = np.array([[0, 5, 5], [5, 0, 5], [5, 5, 0]], np.int32)
    cfg = ring_config()
    topo = gossip.make_topology([3, 3, 3], [1, 3], region_rtt=rtt, device=device)
    data = gossip.init_data(cfg, device)
    contig = data.contig.clone()
    contig[[1, 2], 0] = 4
    contig[[3, 4, 5, 6, 7, 8], 1] = 4
    data = data._replace(head=torch.tensor([4, 4], device=device), contig=contig,
                         seen=torch.maximum(data.seen, contig))
    alive = torch.ones(9, dtype=torch.bool, device=device)
    part = torch.zeros((3, 3), dtype=torch.bool, device=device)
    rnd = torch.zeros((), dtype=torch.int64, device=device)
    out = []
    for seed in range(RING_SEEDS):
        d, _ = gossip.sync_round(data, topo, alive, part, rnd, rng.PRNGKey(seed, device), cfg)
        out.append((d.contig[0].tolist(),
                    [c.reshape(9, RING_CELLS)[0].tolist() for c in d.cells]))
    return out


def membership_rings(device=None, root=DEFAULT_STORE_ROOT) -> dict:
    """``ring_sync`` with the reference's margins (the ring-0 holder wins in
    at least 35 of 40 seeds, a ring-5 holder alone in at most 3), node 0's
    cells after each sync equal to a ``Store`` of the versions its contig
    holds, and the host ``rtt_ring``'s exact edges (an RTT at an edge opens
    the next ring)."""
    device = resolve_device(device)
    from corrosion_tpu_torch.agent.membership import RING_BUCKETS_MS, rtt_ring

    rows = ring_sync(device)
    near = sum(c[0] > 0 for c, _ in rows)
    far = sum(c[1] > 0 and not c[0] > 0 for c, _ in rows)
    for seed, (contig, cells) in enumerate(rows):
        ws, vs = held_versions(np.asarray(contig), np.zeros((0, 2), np.int64))
        store = fresh_store(root, "ring.db")
        try:
            store.apply_changes(derived_changes(ws, vs, RING_CELLS, 1))
            want = store_cells(store, RING_CELLS)
        finally:
            store.close()
        got = [torch.as_tensor(c) for c in cells]
        assert not bool(cells_mismatch(*got, want)), f"seed {seed}: node 0's cells"
    assert near >= 35, f"ring 0 won {near} of {RING_SEEDS}"
    assert far <= 3, f"ring 5 alone won {far} of {RING_SEEDS}"
    for i, edge in enumerate(RING_BUCKETS_MS[:-1]):
        assert rtt_ring(edge) == i + 1 and rtt_ring(edge - 0.001) == i, edge
    assert rtt_ring(RING_BUCKETS_MS[-1]) == len(RING_BUCKETS_MS) - 1 and rtt_ring(0.0) == 0
    return {"seeds": RING_SEEDS, "near": near, "far": far, "edges": len(RING_BUCKETS_MS)}


# -- write journeys over a flight ---------------------------------------------


def schedule_trace(writes: np.ndarray):
    """The write ``Trace`` of a schedule: event (r * ROUND_MS, writer w's
    hex id, v) for each version v writer w commits in round r."""
    from corrosion_tpu_torch.sim.trace import Trace

    writes = np.asarray(writes, np.int64)
    head = np.zeros(writes.shape[1], np.int64)
    events = []
    for r, w in zip(*np.nonzero(writes)):
        for _ in range(int(writes[r, w])):
            head[w] += 1
            events.append((int(r * ROUND_MS), f"{int(w):032x}", int(head[w])))
    return Trace(events=events)


def journey_check(flight_path: str, writes: np.ndarray) -> dict:
    """``obs.journey.reconstruct_write_journeys`` of a flight against the
    schedule's trace: one journey a committed version, the visibility
    events the flight's ``vis_lat_b*`` sums, and attributed plus
    unattributed equal to them. Returns the totals."""
    from corrosion_tpu_torch.obs.journey import reconstruct_write_journeys
    from corrosion_tpu_torch.sim.telemetry import VIS_LAT_KEYS, replay_flight

    j = reconstruct_write_journeys(flight_path, schedule_trace(writes),
                                   round_ms=ROUND_MS)
    curves, _ = replay_flight(flight_path)
    n_writes = int(np.asarray(writes, np.int64).sum())
    assert j["trace_writes"] == len(j["writes"]) == n_writes, (j["trace_writes"], n_writes)
    vis = float(sum(np.asarray(curves[k], np.float64).sum() for k in VIS_LAT_KEYS))
    t = j["totals"]
    assert t["vis_events"] == vis, (t["vis_events"], vis)
    assert math.isclose(t["attributed"] + t["unattributed"], vis, rel_tol=1e-12, abs_tol=1e-6)
    return {"trace_writes": j["trace_writes"], "flight_rounds": j["flight_rounds"], **t}


# -- the transport's frames and a loopback exchange ---------------------------


def transport_frames() -> dict:
    """Frames of kind 1 (the native encoder) and kind 0 (JSON), each
    decoded by the pure-Python decoder and by ``decode_frame_body``."""
    import json

    from corrosion_tpu_torch import native
    from corrosion_tpu_torch.agent import transport as T

    native.build()
    assert native.available(), native.build_status()
    msg = {"t": "bcast", "actor": b"\xab" * 16, "version": -3, "ok": True,
           "changes": [["t", b"p", "c", 1.5, 1, 2, 3, b"s" * 16, 1]],
           "nested": {"a": {"b": [2**62, None, False]}}}
    frame = T.encode_frame(msg)
    assert frame[4] == T.FRAME_BIN
    obj, end = T._py_wire_decode(frame[5:])
    assert end == len(frame) - 5 and obj == msg == T.decode_frame_body(frame[4:])
    body = bytes([T.FRAME_JSON]) + json.dumps(T.encode_value(msg),
                                              separators=(",", ":")).encode()
    assert T.decode_frame_body(body) == msg
    return {"binary_bytes": len(frame), "json_bytes": len(body) + 4}


async def _loopback(server_mod, client_mod) -> dict:
    got = {"frame": asyncio.get_running_loop().create_future(),
           "datagram": asyncio.get_running_loop().create_future()}

    async def handler(session, msg):
        kind = msg.get("t")
        if kind == "sync":
            await session.send({"t": "sync_reply", "n": msg["n"] + 1, "blob": msg["blob"]})
        elif kind in got and not got[kind].done():
            got[kind].set_result(msg)

    server, client = server_mod.Transport(), client_mod.Transport()
    try:
        addr = await server.serve("127.0.0.1", 0, handler)
        frame = {"t": "frame", "actor": b"\x01" * 16, "changes": [[1, "v", None]]}
        assert await client.send_frame(addr, frame)
        assert await got["frame"] == frame
        # The client's own datagram sockets are bound by serve().
        await client.serve("127.0.0.1", 0, handler)
        dgram = {"t": "datagram", "from": b"\x02" * 16, "inc": 3}
        assert client.send_datagram(addr, dgram)
        assert await got["datagram"] == dgram
        session = await client.open_session(addr, {"t": "sync", "n": 41, "blob": b"\x00\xff"})
        assert session is not None
        try:
            reply = await session.recv(timeout=5.0)
        finally:
            session.close()
        assert reply == {"t": "sync_reply", "n": 42, "blob": b"\x00\xff"}, reply
        return {"frame": True, "datagram": True, "session": True}
    finally:
        client.close()
        server.close()


def transport_loopback(server_mod=None, client_mod=None) -> dict:
    """One exchange between two ``Transport``s on 127.0.0.1 (the port's
    unless modules are given): a stream frame, a UDP datagram and a sync
    session's request and reply, under ``HOST_LIMIT_S`` seconds."""
    from corrosion_tpu_torch.agent import transport as T

    return asyncio.run(asyncio.wait_for(
        _loopback(server_mod or T, client_mod or T), HOST_LIMIT_S))


# -- the agent runtime live on 127.0.0.1, merged and replayed on the card -----

# tests/test_agent_cluster.py's randomized stress test on 16 agents:
# agents bootstrapped at random from LIVE_SEED, writes fired at random
# agents over HTTP LIVE_CONCURRENCY at a time, each upserting a row drawn
# from the same generator among LIVE_ROWS, so writers of one batch and of
# successive batches conflict. At 16 agents one write costs the event loop
# ~140 ms on an H100 machine's host (chip_smoke.py phase 15): every peer on
# 127.0.0.1 is in ring 0, so each frame goes eagerly to all of them. That
# sizes LIVE_WRITES.
LIVE_AGENTS = 16
LIVE_WRITES = 48
LIVE_ROWS = 32
LIVE_CONCURRENCY = 16
LIVE_SEED = 11
LIVE_SYNC_INTERVAL = 0.4
LIVE_CONVERGE_S = 60.0
LIVE_WRITE_SQL = "INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)"
LIVE_SUB_SQL = "SELECT id, text FROM tests"
LIVE_DIGEST_SQL = ("SELECT group_concat(id || '=' || text, ',') FROM"
                   " (SELECT id, text FROM tests ORDER BY id)")
# The replay's cluster: the recorded writers plus silent observers, the
# reference's 10,000-node scale (merge_10k, geo_10k).
REPLAY_NODES = 10_000


def agent_digest(ta) -> str | None:
    """The ``tests`` table of a launched agent as one string (the
    reference stress test's convergence digest)."""
    from corrosion_tpu_torch.core.values import Statement

    _, rows = ta.agent.store.query(Statement(LIVE_DIGEST_SQL))
    return rows[0][0]


def text_ranks(stores) -> dict:
    """Rank (from 1) of every text the stores' change logs hold, in
    SQLite's BINARY order (Python's order for these ASCII strings). A
    table's text missing from every log is a lost winner: ``agent_cells``
    then raises ``KeyError``."""
    texts = set()
    for s in stores:
        texts.update(v for (v,) in s.conn.execute(
            "SELECT val FROM __crdt_changes WHERE tbl = 'tests' AND val IS NOT NULL"))
    return {t: i + 1 for i, t in enumerate(sorted(texts))}


def agent_change_batch(stores, ranks: dict, device=None):
    """Every store's logged changes to ``tests``, shuffled from
    ``LIVE_SEED`` into one ``crdt.ChangeBatch``: the key is the row id,
    the value rank the text's (a delete writes no cell: col_version and
    value 0, as ``store_crdt_trials`` gives them)."""
    from corrosion_tpu_torch.core.values import unpack_columns

    rows = []
    for s in stores:
        for pk, cl, cv, val in s.conn.execute(
            "SELECT pk, cl, col_version, val FROM __crdt_changes WHERE tbl = 'tests'"
        ):
            live = cl % 2 == 1
            rows.append((unpack_columns(pk)[0], cl, cv if live else 0,
                         ranks[val] if live else 0))
    order = np.random.default_rng(LIVE_SEED).permutation(len(rows))
    key, cl, cv, vr = torch.as_tensor(np.asarray(rows, np.int64)[order],
                                      device=device).T.contiguous()
    return crdt.ChangeBatch(key=key, cl=cl, col_version=cv, value_rank=vr,
                            mask=torch.ones_like(key, dtype=torch.bool))


def agent_cells(store, ranks: dict, n_rows: int) -> tuple:
    """A store's ``tests`` rows as cells (``store_cells``' form): the
    causal length, the col_version of column ``text``, the text's rank."""
    from corrosion_tpu_torch.core.values import unpack_columns

    cl, cv, val = (np.zeros(n_rows, np.int64) for _ in range(3))
    for pk, c in store.conn.execute("SELECT pk, cl FROM tests__crdt_rows"):
        cl[unpack_columns(pk)[0]] = c
    for pk, c in store.conn.execute(
            "SELECT pk, col_version FROM tests__crdt_clock WHERE cid = 'text'"):
        cv[unpack_columns(pk)[0]] = c
    for k, t in store.conn.execute("SELECT id, text FROM tests"):
        val[k] = ranks[t]
    return cl, cv, val


async def _subscription_view(sub, view: dict, events: list) -> None:
    async for ev in sub:
        events.append(ev)
        if "row" in ev:
            view[ev["row"][1][0]] = ev["row"][1][1]
        elif "change" in ev:
            kind, _rowid, cells, _cid = ev["change"]
            if kind in ("insert", "update"):
                view[cells[0]] = cells[1]
            else:
                view.pop(cells[0], None)


async def _live_cluster(root: Path, agents: int, writes: int, device) -> tuple:
    import random

    from corrosion_tpu_torch.agent.admin import AdminClient
    from corrosion_tpu_torch.agent.backup import backup
    from corrosion_tpu_torch.agent.testing import launch_test_agent, poll_until
    from corrosion_tpu_torch.core.values import Statement
    from corrosion_tpu_torch.sim.trace import Trace

    rng = random.Random(LIVE_SEED)
    trace = Trace()
    cluster, fresh, sub, reader = [], None, None, None
    try:
        cluster.append(await launch_test_agent(str(root / "a0")))
        for i in range(1, agents):
            cluster.append(await launch_test_agent(
                str(root / f"a{i}"), bootstrap=[rng.choice(cluster).gossip_addr],
                sync_interval=LIVE_SYNC_INTERVAL))
        for ta in cluster:
            trace.record(ta.agent)
        sub = await cluster[0].client.subscribe(LIVE_SUB_SQL)
        view, events = {}, []
        reader = asyncio.ensure_future(_subscription_view(sub, view, events))

        t0 = time.perf_counter()
        ids, conflicts = [], 0
        for base in range(0, writes, LIVE_CONCURRENCY):
            batch = [(rng.randrange(LIVE_ROWS), rng.choice(cluster))
                     for _ in range(base, min(base + LIVE_CONCURRENCY, writes))]
            ids += [k for k, _ in batch]
            conflicts += len(batch) - len({k for k, _ in batch})
            await asyncio.gather(*[
                ta.client.execute([[LIVE_WRITE_SQL, [k, f"v{base + j}"]]])
                for j, (k, ta) in enumerate(batch)])
        write_s = time.perf_counter() - t0

        async def converged():
            digests = {agent_digest(ta) for ta in cluster}
            return len(digests) == 1 and None not in digests

        await poll_until(converged, timeout=LIVE_CONVERGE_S, interval=0.1)
        converge_s = time.perf_counter() - t0
        table = dict(cluster[0].agent.store.query(Statement(LIVE_SUB_SQL))[1])
        assert sorted(table) == sorted(set(ids)), (len(table), len(set(ids)))

        async def sub_caught_up():
            return view == table

        await poll_until(sub_caught_up, timeout=LIVE_CONVERGE_S)

        stores = [ta.agent.store for ta in cluster]
        ranks = text_ranks(stores)
        batch = agent_change_batch(stores, ranks, device)
        cells = crdt.apply_changes(crdt.make_cells(LIVE_ROWS, device), batch)
        for i, s in enumerate(stores):
            assert not bool(cells_mismatch(*cells, agent_cells(s, ranks, LIVE_ROWS))), (
                f"agent {i}: its rows differ from the card's merge of every change log")

        bk = root / "a0.backup.db"
        backup(cluster[0].agent.store.path, str(bk))
        # An abstract socket: a path under a deep checkout could pass
        # AF_UNIX's 107-byte limit.
        uds = f"\0corro-host-oracles-{os.getpid()}"
        fresh = await launch_test_agent(str(root / "restored"), admin_uds=uds)
        (frame,) = await AdminClient(uds).call({"c": "restore", "path": str(bk)})
        assert frame["restored"], frame
        assert agent_digest(fresh) == agent_digest(cluster[0]), "the restored backup differs"

        versions = {ta.agent.actor_id: ta.agent.bookie.for_actor(ta.agent.actor_id).last() or 0
                    for ta in cluster}
        out = {
            "agents": agents, "writes": writes, "rows": len(table),
            "same_batch_conflicts": conflicts,
            "write_s": round(write_s, 2), "converge_s": round(converge_s, 2),
            "sub_events": len(events), "changes_merged": int(batch.key.numel()),
            "store_merge": "native" if stores[0].native_crdt else "python",
        }
        return out, trace, versions
    finally:
        if reader is not None:
            reader.cancel()
        if sub is not None:
            sub.close()
        for ta in cluster + ([fresh] if fresh is not None else []):
            await ta.stop()


def agent_cluster_live(device=None, root=DEFAULT_STORE_ROOT, agents: int = LIVE_AGENTS,
                       writes: int = LIVE_WRITES) -> tuple:
    """A live cluster of the port's agents on 127.0.0.1 against the card's
    CRDT merge (tests/test_agent_cluster.py's randomized stress test):
    ``agents`` agents bootstrapped at random, each recorded by one
    ``sim.trace.Trace``; a subscription on agent 0 through the client;
    ``writes`` upserts over HTTP; then, once every agent's table digest
    agrees (within ``LIVE_CONVERGE_S``): the table holds exactly the rows
    written, the subscription's view equals it, every agent's change log
    merged on ``device`` in one shuffled batch through
    ``crdt.apply_changes`` equals every agent's rows (causal length,
    col_version, winning text), and an online backup of agent 0 restored
    into a fresh agent through ``AdminClient`` has its digest.
    Returns (summary, trace, versions committed by actor id from each
    agent's own bookkeeping). Data directories go under
    ``root/agent_cluster``, emptied first."""
    device = resolve_device(device)
    import shutil

    base = Path(root) / "agent_cluster"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    return asyncio.run(_live_cluster(base, agents, writes, device))


def agent_trace_replay(trace, versions: dict, nodes: int, device=None) -> dict:
    """The live cluster's recorded traffic re-run in the simulator
    (``sim.trace.replay`` with its defaults) on ``nodes`` nodes, the
    recorded writers and silent observers: each writer's head equals the
    versions its agent committed (an agent that committed none is not a
    writer), and at the end every alive node holds every version
    (``contig == head``) with ``need`` 0. Returns the sizes and the
    visibility percentiles in rounds."""
    from corrosion_tpu_torch.sim.trace import replay

    actors, final, curves, lat = replay(trace, observers=nodes - len(trace.actors),
                                        device=device)
    head = final.data.head.cpu().numpy()
    assert [versions[a] for a in actors] == head.tolist(), (head, versions)
    assert all(v == 0 for a, v in versions.items() if a not in actors), versions
    alive = final.swim.alive.cpu().numpy()
    contig = final.data.contig.cpu().numpy()
    assert (contig[alive] == head[None, :]).all(), "a node did not converge in the replay"
    need = np.asarray(curves["need"])
    assert need[-1] == 0, need[-5:]
    round_s = ROUND_MS / 1000.0
    return {
        "nodes": int(contig.shape[0]), "writers": len(actors), "versions": int(head.sum()),
        "rounds": int(len(need)), "alive": int(alive.sum()),
        "vis_p50_rounds": lat["p50_s"] / round_s, "vis_p99_rounds": lat["p99_s"] / round_s,
        "unseen": lat["unseen"],
    }


# -- the serving plane: loadgen's scenarios, the PG wire, gossip TLS -----------

# tests/test_loadgen.py's acceptance bar (test_fanout_storm_2k_subscriptions):
# 2,000 subscriptions in four groups, 60 writes at 10/s, reads over HTTP
# and the PG wire at the scenario's rates.
STORM = dict(subs=2000, writes=60, write_rate=10.0, drain_timeout_s=60.0)
STORM_SELECT = "SELECT id, text FROM tests ORDER BY id"
# ``loadgen soak`` at the scale of the reference's merge_10k and geo_10k.
SOAK_10K_NODES = 10_000
TLS_AGENTS = 3


@contextmanager
def watched_simulate(runs: list):
    """``sim.engine.simulate`` wrapped while the block runs (the scenarios
    import it when called): each run's final state is held to the
    watermark invariants (``contig <= head``, ``seen >= contig``) and
    only a summary is kept in ``runs`` (intake, rounds, versions, wall
    seconds, the chaos axes the schedule carries), so the [N, W] planes
    are freed with the run."""
    from corrosion_tpu_torch.sim import engine

    real = engine.simulate

    def simulate(cfg, topo, sched, *a, **kw):
        t0 = time.perf_counter()
        final, curves = real(cfg, topo, sched, *a, **kw)
        d = final.data
        assert bool((d.contig <= d.head[None, :]).all()), "contig > head"
        assert bool((d.seen >= d.contig).all()), "seen < contig"
        if d.head.is_cuda:
            torch.cuda.synchronize()
        runs.append({
            "intake": cfg.gossip.rebroadcast_intake, "rounds": int(sched.rounds),
            "nodes": cfg.n_nodes, "writers": int(d.head.numel()),
            "versions": int(d.head.sum()), "s": round(time.perf_counter() - t0, 2),
            "axes": [k for k in ("loss", "probe_loss") if getattr(sched, k) is not None],
        })
        return final, curves

    engine.simulate = simulate
    try:
        yield runs
    finally:
        engine.simulate = real


def loadgen_soak(device=None, cpu_report: dict | None = None, **kw) -> tuple:
    """``loadgen soak`` (``scenarios.intake_policy``, its defaults unless
    ``kw`` names them) on ``device``, each of its two runs held to the
    watermark invariants; with ``cpu_report`` (the same call on the
    CPU), the dicts are equal key for key but ``process`` (it reads
    ``/proc`` and the wall clock). Returns (the report without
    ``process``, the runs' summaries)."""
    from corrosion_tpu_torch.loadgen import scenarios

    device = resolve_device(device)
    runs = []
    with watched_simulate(runs):
        rep = scenarios.intake_policy(device=device, **kw)
    rep.pop("process")
    if cpu_report is not None:
        want = {k: v for k, v in cpu_report.items() if k != "process"}
        bad = sorted(k for k in set(rep) | set(want) if rep.get(k) != want.get(k))
        assert not bad, f"intake_policy on {device} differs from the CPU's in {bad}"
    assert [r["intake"] for r in runs] == [rep["sized"]["intake"], rep["starved"]["intake"]]
    return rep, runs


def held_to_merge(db_paths, device) -> tuple:
    """The ``tests`` table of each agent database in ``db_paths``, each
    held to all their change logs merged on ``device``
    (``crdt.apply_changes`` in one shuffled batch: causal length,
    col_version and winning text). Returns (the tables, the changes
    merged)."""
    import sqlite3
    from types import SimpleNamespace

    dbs = [SimpleNamespace(conn=sqlite3.connect(str(p))) for p in db_paths]
    try:
        tables = [dict(db.conn.execute(STORM_SELECT).fetchall()) for db in dbs]
        ranks = text_ranks(dbs)
        n_rows = max(max(t, default=0) for t in tables) + 1
        batch = agent_change_batch(dbs, ranks, device)
        cells = crdt.apply_changes(crdt.make_cells(n_rows, device), batch)
        for path, db in zip(db_paths, dbs):
            assert not bool(cells_mismatch(*cells, agent_cells(db, ranks, n_rows))), (
                f"{path}: its rows differ from the card's merge of the change logs")
        return tables, int(batch.key.numel())
    finally:
        for db in dbs:
            db.conn.close()


def storm_cells(db_path: Path, device) -> dict:
    """The storm's ``tests`` table in its agent's database, held to the
    change log merged on ``device`` (``held_to_merge``). Returns the
    table."""
    (table,), _ = held_to_merge([db_path], device)
    return table


async def _pg_select(data_dir: Path, sql: str) -> list:
    """``sql`` through a fresh agent on ``data_dir``, its ``serve_pg`` and
    the connection of a ``PgReadClient`` (whose ``query`` counts rows):
    the DataRows as text."""
    import struct

    from corrosion_tpu_torch.agent.pg import serve_pg
    from corrosion_tpu_torch.agent.testing import launch_test_agent
    from corrosion_tpu_torch.loadgen.pgread import PgReadClient

    ta = await launch_test_agent(str(data_dir))
    server, (host, port) = await serve_pg(ta.agent)
    try:
        client = await PgReadClient.connect(host, port)
        try:
            body = sql.encode() + b"\x00"
            client.writer.write(b"Q" + struct.pack(">I", len(body) + 4) + body)
            await client.writer.drain()
            rows = []
            for tag, p in await client._read_until(b"Z"):
                assert tag != b"E", p
                if tag != b"D":
                    continue
                off, row = 2, []
                for _ in range(struct.unpack_from(">H", p)[0]):
                    (ln,) = struct.unpack_from(">i", p, off)
                    row.append(None if ln < 0 else p[off + 4:off + 4 + ln].decode())
                    off += 4 + max(ln, 0)
                rows.append(tuple(row))
            return rows
        finally:
            client.close()
    finally:
        server.close()
        await server.wait_closed()
        await ta.stop()


def loadgen_storm(device=None, root=DEFAULT_STORE_ROOT) -> dict:
    """``loadgen run`` (``scenarios.fanout_storm``) at ``STORM``, the
    reference's acceptance bar: the oracle sees every stream and commit,
    no violation and nothing missing, at least a quarter of the streams'
    worth of changes a write, and reads through the PG wire; then the
    storm's table, read from its agent's database, equals the change log
    merged on ``device`` and one ``SELECT`` through a fresh agent's
    ``serve_pg`` and ``PgReadClient`` on that directory. The scenario
    lifts the soft ``RLIMIT_NOFILE`` to the hard one (two descriptors a
    stream); both are in the summary. The cluster's directory is
    ``root/loadgen_storm``, emptied first."""
    import resource
    import shutil

    from corrosion_tpu_torch.loadgen import scenarios

    device = resolve_device(device)
    base = Path(root) / "loadgen_storm"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    soft0, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    t0 = time.perf_counter()
    rep = asyncio.run(scenarios.fanout_storm(str(base), **STORM))
    wall = time.perf_counter() - t0
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    o, subs, writes = rep["oracle"], STORM["subs"], STORM["writes"]
    assert (o["streams"], o["commits"]) == (subs, writes), o
    assert o["violations"] == 0, o["violation_examples"]
    assert o["missing"] == 0, o
    assert o["delivered_changes"] >= writes * (subs // 4), o
    assert rep["routes"]["pg"]["ok"] > 0, rep["routes"]
    table = storm_cells(base / "agent0" / "state.db", device)
    assert sorted(table) == list(range(writes)), sorted(table)
    pg_rows = asyncio.run(_pg_select(base / "agent0", STORM_SELECT))
    assert pg_rows == [(str(k), v) for k, v in sorted(table.items())], "the PG read differs"
    return {
        "streams": o["streams"], "commits": o["commits"], "violations": o["violations"],
        "missing": o["missing"], "delivered_changes": o["delivered_changes"],
        "fanout_lag_ms": o["fanout_lag_ms"], "routes": {
            k: {"ok": v["ok"], "p50_ms": v["latency_ms"]["p50"], "p99_ms": v["latency_ms"]["p99"]}
            for k, v in rep["routes"].items()},
        "rows": len(table), "pg_rows": len(pg_rows), "wall_s": round(wall, 2),
        "nofile": {"soft_before": soft0, "soft": soft, "hard": hard},
    }


def loadgen_sweep(root=DEFAULT_STORE_ROOT) -> dict:
    """``loadgen sweep`` (``scenarios.saturation_sweep``) at its defaults:
    shed engaged, the client's shed count equal to the server's, the
    admitted p99 under its bound. Returns the stages' offered rates, shed
    and admitted p99, and those flags. The agent's directory is
    ``root/loadgen_sweep``, emptied first."""
    import shutil

    from corrosion_tpu_torch.loadgen import scenarios

    base = Path(root) / "loadgen_sweep"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    rep = asyncio.run(scenarios.saturation_sweep(str(base)))
    for flag in ("shed_engaged", "shed_accounting_consistent", "admitted_p99_bounded"):
        assert rep[flag], (flag, rep)
    return {
        "stages": [{"rate_hz": s["offered_rate_hz"], "shed": s["shed"],
                    "p99_ms": s.get("latency_ms", {}).get("p99")} for s in rep["stages"]],
        **{k: rep[k] for k in ("api_concurrency", "burst", "shed_total", "server_shed_total",
                               "shed_engaged", "shed_accounting_consistent",
                               "admitted_p99_bounded", "admitted_p99_ms_max")},
    }


async def _tls_cluster(base: Path, tls) -> dict:
    from corrosion_tpu_torch.agent.agent import AgentTls
    from corrosion_tpu_torch.agent.testing import launch_test_agent, poll_until
    from corrosion_tpu_torch.agent.transport import Transport

    ca_dir = str(base / "ca")
    tls.generate_ca(ca_dir)
    ca = str(base / "ca" / tls.CA_CERT)
    server = tls.generate_server_cert(str(base / "server"), ca_dir, "127.0.0.1")
    client = tls.generate_client_cert(str(base / "client"), ca_dir)
    cfg = AgentTls(cert=server.cert, key=server.key, ca=ca, client_cert=client.cert,
                   client_key=client.key, mtls=True)
    cluster = []
    t0 = time.perf_counter()
    try:
        for i in range(TLS_AGENTS):
            boot = [cluster[0].gossip_addr] if cluster else None
            cluster.append(await launch_test_agent(str(base / f"a{i}"), bootstrap=boot, tls=cfg))
        await cluster[0].client.execute([[LIVE_WRITE_SQL, [1, "over-mtls"]]])

        async def converged():
            return {agent_digest(ta) for ta in cluster} == {"1=over-mtls"}

        await poll_until(converged, timeout=LIVE_CONVERGE_S)
        converge_s = time.perf_counter() - t0
        # A peer whose certificate another CA signed gets no session.
        other = str(base / "other_ca")
        tls.generate_ca(other)
        rogue = tls.generate_client_cert(str(base / "rogue"), other)
        t = Transport(ssl_client=tls.client_ssl_context(ca, rogue.cert, rogue.key))
        try:
            session = await t.open_session(cluster[1].gossip_addr, {"n": 1}, timeout=5)
            refused = session is None or await session.recv(timeout=5) is None
        finally:
            t.close()
        assert refused, "a peer with an untrusted certificate got a session"
        return {"agents": TLS_AGENTS, "converge_s": round(converge_s, 2), "untrusted_refused": True}
    finally:
        for ta in cluster:
            await ta.stop()


def agent_tls(root=DEFAULT_STORE_ROOT) -> dict:
    """Gossip over mutual TLS with certificates from the port's ``tls``:
    ``TLS_AGENTS`` agents, a write on one reaches every one, and a peer
    holding a certificate of another CA is refused. Where the
    ``cryptography`` package is absent (the reference's own tests skip
    then), nothing runs and the summary says so. Directories go under
    ``root/agent_tls``, emptied first."""
    import importlib.util
    import shutil

    if importlib.util.find_spec("cryptography") is None:
        return {"tls": "cryptography absent"}
    from corrosion_tpu_torch.agent import tls

    base = Path(root) / "agent_tls"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    return {"tls": "ran", **asyncio.run(_tls_cluster(base, tls))}


# -- the chaos and fidelity planes: live agents against the card's replays -----

# The committed WAN round model (one region, round 541.17 ms) that the
# fidelity replay at 10,000 nodes is calibrated with, and the reference's
# budgets the chaos and fidelity checks read their ceilings from.
ROUND_MODEL_WAN = Path(__file__).resolve().parents[2] / "ROUND_MODEL_WAN.json"
BENCH_BUDGET = Path(__file__).resolve().parents[2] / "bench_budget.json"
# The reference's per-PR host-chaos pair (scripts/hostchaos_smoke.py).
HOSTCHAOS_PAIR = ("wan_steady", "kill_restart")
HOSTCHAOS_SEED = 0
# The endurance soak's host lane (scripts/soak_smoke.py: its series
# interval and detector settings, HOST_ENDURANCE_KW).
SOAK_SERIES_INTERVAL = 0.2
SOAK_ENDURANCE_KW = dict(
    wedge_min_span_s=6.0,
    stall_threshold_s=0.75,
    leak_ceilings={"corro_runtime_rss_bytes": 4 * 2 ** 30, "corro_runtime_open_fds": 20000.0},
    slos=(
        {"name": "fanout_lag_p99", "kind": "histogram",
         "series": "corro_broadcast_recv_lag_seconds", "threshold_s": 10.0, "objective": 0.90},
        {"name": "convergence_staleness", "kind": "gauge", "series": "corro_sync_needs",
         "ceiling": 500.0, "objective": 0.90},
        {"name": "probe_false_alarm_budget", "kind": "counter_budget",
         "series": "corro_gossip_member_removed", "allowed_per_hour": 3600.0},
    ),
)
REPLAY_KEYS = ("round_ms", "rounds", "vis_offset_rounds", "unseen", "pairs", "ttc_ms",
               "need_last")


@contextmanager
def recorded_replays(calls: list):
    """``fidelity.compare.kernel_replay`` wrapped while the block runs:
    each call's trace, arguments and result go into ``calls``."""
    from corrosion_tpu_torch.fidelity import compare

    real = compare.kernel_replay

    def kernel_replay(trace, *a, **kw):
        out = real(trace, *a, **kw)
        calls.append((trace, a, kw, out))
        return out

    compare.kernel_replay = kernel_replay
    try:
        yield calls
    finally:
        compare.kernel_replay = real


def replays_equal(a: dict, b: dict) -> bool:
    """Two ``kernel_replay`` dicts are equal: the latencies bit for bit,
    every other key exactly."""
    return (np.array_equal(a["lat_rounds"], b["lat_rounds"])
            and all(a[k] == b[k] for k in REPLAY_KEYS))


def budget(entry: str) -> dict:
    """One entry of the reference's ``bench_budget.json``."""
    import json

    return json.loads(BENCH_BUDGET.read_text())[entry]


def _fresh_dir(root, name: str) -> Path:
    import shutil

    base = Path(root) / name
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    return base


def fidelity_live(kind: str, device=None, root=DEFAULT_STORE_ROOT) -> tuple:
    """``fidelity.scenarios.steady_load`` (``kind`` "steady") or
    ``burst_drain`` ("burst") at its defaults: three of the port's agents
    on 127.0.0.1 calibrate their own ``RoundModel`` and take the workload,
    whose recorded trace is replayed on ``device`` calibrated and
    uncalibrated. The calibrated replay's CDF is strictly closer to the
    live one (the reference's own assertion), the model was measured live,
    nothing is unseen live or in either replay, and each replay's dict
    equals the port's plain path on the CPU on the same trace. Returns
    (the summary, the recorded trace). The agents' directories go under
    ``root/fidelity_<kind>``, emptied first."""
    from corrosion_tpu_torch.fidelity import compare, scenarios

    device = resolve_device(device)
    run = {"steady": scenarios.steady_load, "burst": scenarios.burst_drain}[kind]
    base = _fresh_dir(root, f"fidelity_{kind}")
    calls = []
    with recorded_replays(calls):
        rep = asyncio.run(run(str(base), device=device))
    assert len(calls) == 2, len(calls)
    for trace, a, kw, got in calls:
        want = compare.kernel_replay(trace, *a, **dict(kw, device="cpu"))
        assert replays_equal(got, want), f"{kind}: a replay on {device} differs from the CPU's"
    cal, unc = rep["calibrated"], rep["uncalibrated"]
    assert rep["calibrated_closer"], (cal.get("cdf_distance"), unc.get("cdf_distance"))
    unseen = {side: rep[side]["unseen"] for side in ("live", "calibrated", "uncalibrated")}
    assert not any(unseen.values()), unseen
    model = rep["model"]
    assert model["provenance"]["source"] == "live", model["provenance"]
    live = rep["live"]
    sides = ("rounds", "cdf_distance", "kolmogorov", "p50_bucket_delta", "p99_bucket_delta",
             "p50_ratio", "p99_ratio", "ttc_ms", "ttc_delta_ms")
    return {
        "trace_fingerprint": rep["trace_fingerprint"], "writes": live["writes"],
        "pairs": live["pairs"],
        "model": {k: model[k] for k in ("round_ms", "pair_miss", "probe_loss",
                                        "apply_rate_per_s")},
        "live": {k: live[k] for k in ("lat_p50_ms", "lat_p99_ms", "ttc_ms")},
        "calibrated": {k: cal.get(k) for k in sides},
        "uncalibrated": {k: unc.get(k) for k in sides},
        "calibrated_closer": True, "replays_equal_cpu": len(calls),
    }, calls[0][0]


def fidelity_replay_10k(trace, device=None, nodes: int = REPLAY_NODES) -> dict:
    """``fidelity.compare.kernel_replay`` of a recorded trace at ``nodes``
    nodes on ``device`` (the recorded writers and silent observers, the
    reference CLI's ``fidelity replay --observers``), twice: calibrated
    with the committed ``ROUND_MODEL_WAN``, and uncalibrated at
    ``REFERENCE_ROUND_MS``. Nothing is unseen in either; the calibrated
    run's schedule carries the loss and probe-loss axes and the
    uncalibrated one's none; each run holds the watermark invariants.
    Returns each run's rounds, latencies in rounds and ms (the wall
    projection ``(rounds + vis_offset) * round_ms``), time to convergence
    and ms a round."""
    from corrosion_tpu_torch.fidelity.calibrate import REFERENCE_ROUND_MS, RoundModel
    from corrosion_tpu_torch.fidelity.compare import kernel_replay

    device = resolve_device(device)
    model = RoundModel.load(str(ROUND_MODEL_WAN))
    offset = model.vis_offset_rounds
    out = {"nodes": nodes, "writers": len(trace.actors), "writes": len(trace.events)}
    for side, mdl, round_ms in (("calibrated", model, model.round_ms),
                                ("uncalibrated", None, REFERENCE_ROUND_MS)):
        runs = []
        with watched_simulate(runs):
            rep = kernel_replay(trace, round_ms, n_nodes=nodes, model=mdl,
                                vis_offset_rounds=offset, device=device)
        (run,) = runs
        want = ["loss", "probe_loss"] if mdl is not None else []
        assert run["axes"] == want, (side, run["axes"])
        assert run["nodes"] == nodes and rep["unseen"] == 0 and rep["ttc_ms"] is not None, rep
        p50, p99 = (float(np.percentile(rep["lat_rounds"], q)) for q in (50, 99))
        out[side] = {
            "round_ms": round_ms, "rounds": rep["rounds"], "pairs": rep["pairs"],
            "unseen": rep["unseen"], "axes": run["axes"],
            "p50_rounds": p50, "p99_rounds": p99,
            "p50_ms": round((p50 + offset) * round_ms, 2),
            "p99_ms": round((p99 + offset) * round_ms, 2),
            "ttc_ms": round(rep["ttc_ms"], 2), "s": run["s"],
            "ms_per_round": round(1000.0 * run["s"] / rep["rounds"], 1),
        }
    return out


def fidelity_dcn(device=None, cpu_report: dict | None = None) -> tuple:
    """``fidelity.scenarios.dcn_partition`` at its shape (48 nodes, 4 geo
    regions, 4 writers, 64 rounds) on ``device``: the chaos invariant
    cross-check holds, both runs recover, the calibrated run leaves
    nothing unseen and recovers at most the ``fidelity`` budget's ceiling
    of rounds (unscaled) after the uncalibrated one; with ``cpu_report``
    (the same call on the CPU) the dicts are equal. Returns (the summary,
    the report)."""
    from corrosion_tpu_torch.fidelity import scenarios

    device = resolve_device(device)
    rep = scenarios.dcn_partition(device=device)
    assert rep["invariants_ok"], rep["invariant_violations"]
    assert rep["both_recovered"], (rep["calibrated"], rep["uncalibrated"])
    assert rep["calibrated"]["unseen"] == 0, rep["calibrated"]
    delta = rep["recovery_delta_rounds"]
    ceiling = budget("fidelity")["ceilings"]["scenarios.dcn.recovery_delta_rounds"]
    assert delta is not None and delta <= ceiling, (delta, ceiling)
    if cpu_report is not None:
        bad = sorted(k for k in set(rep) | set(cpu_report) if rep.get(k) != cpu_report.get(k))
        assert not bad, f"dcn_partition on {device} differs from the CPU's in {bad}"
    return {
        "invariants_ok": True, "both_recovered": True, "recovery_delta_rounds": delta,
        "model_round_ms": rep["model"]["round_ms"],
        "calibrated": rep["calibrated"], "uncalibrated": rep["uncalibrated"],
        "equal_to_cpu": cpu_report is not None,
    }, rep


def hostchaos_pair(device=None, root=DEFAULT_STORE_ROOT) -> dict:
    """The reference's per-PR host-chaos pair (``HOSTCHAOS_PAIR``:
    ``wan_steady``, ``kill_restart``) through ``hostchaos.run_scenario``
    on the port's agents, gated on the rules the reference never scales:
    no oracle violation; converged, bookkeeping contiguous and ``ok``; the
    machinery each scenario requires fired (``kill_restart``: a breaker
    trip). Then every agent's ``tests`` table, read from its database,
    equals all the agents' change logs merged on ``device``. The report
    goes through the emit path with ``hostchaos_context`` on ``device``,
    and its breaches of the ``hostchaos`` budget are returned, not raised
    (that entry was recorded on the CPU). Directories go under
    ``root/hostchaos``, emptied first."""
    from corrosion_tpu_torch.hostchaos import get_scenario, run_scenario
    from corrosion_tpu_torch.hostchaos.report import (
        check_hostchaos_budget, emit_hostchaos_report, hostchaos_context,
    )

    device = resolve_device(device)
    base = _fresh_dir(root, "hostchaos")
    blocks, out = {}, {}
    for name in HOSTCHAOS_PAIR:
        t0 = time.perf_counter()
        rep = asyncio.run(run_scenario(get_scenario(name), str(base / name),
                                       seed=HOSTCHAOS_SEED))
        wall = time.perf_counter() - t0
        assert rep["oracle"]["violations"] == 0, rep["oracle"]["violation_examples"]
        assert rep["converged"] and rep["bookkeeping_contiguous"] and rep["ok"], rep["failures"]
        assert rep["machinery_ok"], (rep["machinery_required"], rep["machinery"])
        if name == "kill_restart":
            assert rep["machinery"]["breaker_trips"] >= 1, rep["machinery"]
            assert rep["kill"] and rep["kill"]["agent"] == 0, rep["kill"]
        paths = [base / name / f"agent{i}" / "state.db" for i in range(rep["agents"])]
        tables, merged = held_to_merge(paths, device)
        assert all(t == tables[0] for t in tables), f"{name}: the agents' tables differ"
        blocks[name] = rep
        out[name] = {
            "agents": rep["agents"], "writes": rep["writes_requested"],
            "commits": rep["oracle"]["commits"], "violations": rep["oracle"]["violations"],
            "delivered_changes": rep["oracle"]["delivered_changes"],
            "reconnects": rep["oracle"].get("reconnects"),
            "drain_s": rep["drain_s"], "convergence_s": rep["convergence_s"],
            "machinery": rep["machinery"], "rows": len(tables[0]), "changes_merged": merged,
            "wall_s": round(wall, 2),
        }
    report = emit_hostchaos_report({
        **hostchaos_context(max(b["agents"] for b in blocks.values()), *HOSTCHAOS_PAIR,
                            HOSTCHAOS_SEED, device=device),
        "seed": HOSTCHAOS_SEED, "scenarios": blocks,
    })
    out["budget_breaches"] = check_hostchaos_budget(report, budget("hostchaos"))[1]
    return out


def hostchaos_soak(root=DEFAULT_STORE_ROOT) -> dict:
    """The endurance soak's host lane (``hostchaos.scenarios.soak_churn``
    with the metric-series recorder armed, as scripts/soak_smoke.py runs
    it): three agents under WAN netem, a flap and a SIGKILL-restart of
    n0. Each agent has an endurance block with no wedge, stall or SLO
    breach, and n0's counter drops are classified as ``restart`` resets.
    Returns each agent's verdicts and leak slopes (per hour), and the
    slopes over the ``host:`` ceilings of the ``soak`` budget (logged, not
    gated). Directories go under ``root/hostchaos_soak``, emptied first."""
    from corrosion_tpu_torch.hostchaos import run_scenario
    from corrosion_tpu_torch.hostchaos.scenarios import soak_churn

    base = _fresh_dir(root, "hostchaos_soak")
    series_dir = base / "series"
    series_dir.mkdir()
    spec = soak_churn()
    rep = asyncio.run(run_scenario(
        spec, str(base / "cluster"), seed=HOSTCHAOS_SEED, series_dir=str(series_dir),
        series_interval=SOAK_SERIES_INTERVAL, endurance_kw=SOAK_ENDURANCE_KW, sub_costs=True,
    ))
    assert rep["ok"], rep["failures"]
    agents = rep["endurance"]["agents"]
    assert sorted(agents) == [f"n{i}" for i in range(spec.n_agents)], sorted(agents)
    out = {"drain_s": rep["drain_s"], "convergence_s": rep["convergence_s"],
           "machinery": rep["machinery"], "agents": {}}
    ceilings = budget("soak")["leak_ceilings_per_hour"]
    for name, end in agents.items():
        assert end["samples"] > 0, name
        wedged = [p for p, w in end["wedges"].items() if w.get("wedged")]
        assert not wedged, (name, wedged)
        assert not end["stalls"].get("runs"), (name, end["stalls"])
        breached = [k for k, v in end["slo"].items() if v.get("breached")]
        assert not breached, (name, breached)
        leaks = {k: v["slope_per_hour"] for k, v in end["leaks"].items()
                 if v.get("slope_per_hour") is not None}
        out["agents"][name] = {
            "samples": end["samples"], "ok": end["ok"], "breaches": end["breaches"],
            "resets": end["resets"], "leak_slopes_per_hour": leaks,
            "over_budget": sorted(k for k, v in leaks.items()
                                  if f"host:{k}" in ceilings and v > ceilings[f"host:{k}"]),
        }
    killed = f"n{spec.kill.agent}"
    resets = agents[killed]["resets"]
    assert resets and all(r["kinds"] == ["restart"] for r in resets.values()), (killed, resets)
    return out

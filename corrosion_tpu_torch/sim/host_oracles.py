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
  Python ones.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from corrosion_tpu_torch import rng
from corrosion_tpu_torch.core.bookkeeping import BookedVersions, Current, Partial
from corrosion_tpu_torch.core.intervals import RangeSet
from corrosion_tpu_torch.ops import gossip, intervals
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
    dev = torch.device(device)
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

"""The host oracles (``corrosion_tpu_torch/sim/host_oracles.py``) on the
CPU through the port's plain path, each beside the same trace through the
reference, its JAX plane and its ``core/``:

- ``window_bookie``: the two differential traces of
  ``tests/test_ops_window.py`` on the fast and the legacy delivery; the
  port's final plane state and bookie equal the reference's;
- ``rotation_trace``: the rotation trace of ``tests/test_sparse_writers.py``;
  the port's claims after every step equal the reference plane's;
- ``coverage_trials`` and ``coverage_full_width``: chunk arrivals into the
  port's interval sets equal the reference's interval sets slot for slot,
  one set at a time and batched;
- ``native_codec``: the check ``chip_smoke.py`` runs on the card host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.ops import gossip as jgossip
from corrosion_tpu.ops import intervals as jintervals
from corrosion_tpu.ops import sparse_writers as jsw
from corrosion_tpu_torch.ops import gossip as tgossip
from corrosion_tpu_torch.ops import intervals as tintervals
from corrosion_tpu_torch.sim import host_oracles as H
from test_ops_window import _local_shuffle, _run_trace
from test_sparse_writers import _claims as jclaims

torch.set_num_threads(1)


def _book_state(bv) -> tuple:
    return ({v: repr(c) for v, c in bv.current.items()}, list(bv.cleared), bv.last(),
            list(bv.sync_need()))


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("trace", H.WINDOW_TRACES, ids=[t[0] for t in H.WINDOW_TRACES])
def test_window_trace_equals_the_reference(trace, legacy):
    name, seed, h, disp, prefix, cap = trace
    order = H.local_shuffle(h, disp, np.random.default_rng(seed))
    assert np.array_equal(order, _local_shuffle(h, disp, np.random.default_rng(seed)))
    order = order[:prefix]
    data, book, stats = H.window_trace(order, cap, h, legacy=legacy, device="cpu")
    _, _, jdata, jbook = _run_trace(np.asarray(order), batch_cap=cap, window_k=H.WINDOW_K, legacy=legacy)
    for f in ("head", "contig", "seen", "oo", "q_writer", "q_ver", "q_tx"):
        want = np.asarray(getattr(jdata, f)).astype(np.int64)
        assert np.array_equal(getattr(data, f).numpy(), want), f
    assert _book_state(book) == _book_state(jbook)
    assert stats["delivered_rounds"] >= len(order) // cap
    assert tgossip._FAST_MAX_WRITERS == 2048  # restored


def test_window_bookie_runs_both_paths():
    fast, legacy = H.window_bookie("cpu"), H.window_bookie("cpu", legacy=True)
    assert set(fast) == set(legacy) == {n for n, *_ in H.WINDOW_TRACES}
    assert fast["bounded_gaps"]["possessed"] == 60 and fast["bounded_gaps"]["need"] == 0
    assert fast == legacy and fast["mid_trace"]["need"] > 0


def _reference_rotation_claims() -> dict:
    """The reference test's rotation trace on its JAX plane, the claims of
    writers 1-3 after each step (its bookies are its own test's)."""
    n = 4
    g = jgossip.GossipConfig(n_nodes=n, n_writers=2, track_writer_ids=True, n_cells=0,
                             queue=4, fanout_near=2, fanout_far=1, sync_interval=4)
    sp = jsw.SparseConfig(epoch_rounds=4, k_dev=4, d_max=2, p_max=2)
    st = jsw.init_sparse(g, sp)
    out = {}

    def snap(step):
        out[step] = [jclaims(st, w, n).astype(np.int64).tolist() for w in (1, 2, 3)]

    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    st, _ = jsw.rotate(st, i32([0, 0]), jnp.zeros(2, bool), i32([0, 1]), i32([1, 2]),
                       jnp.asarray([True, True]), g)
    snap("promote")
    contig = np.asarray(st.data.contig).copy()
    contig[:, 0] = [6, 6, 6, 2]
    head = np.asarray(st.data.head).copy()
    head[0] = 6
    st = st._replace(data=st.data._replace(contig=jnp.asarray(contig), head=jnp.asarray(head),
                                           seen=jnp.asarray(contig)))
    snap("commit")
    st, _ = jsw.rotate(st, i32([0, 0]), jnp.asarray([True, False]), i32([0, 0]), i32([3, 0]),
                       jnp.asarray([True, False]), g)
    snap("demote")
    st, _ = jsw.cold_sync(st, jnp.zeros(n, jnp.int32), jnp.ones(n, bool), jnp.zeros((1, 1), bool),
                          g, sp)
    snap("cold_sync")
    topo = jgossip.make_topology([n], np.array([3, 2], np.int32))
    topo = topo._replace(writer_ids=jnp.asarray([3, 2], jnp.uint32),
                         writer_of_node=jnp.asarray([-1, -1, 1, 0], jnp.int32))
    key = jax.random.PRNGKey(5)
    for r in range(6):
        key, k = jax.random.split(key)
        writes = jnp.asarray([1 if r < 2 else 0, 0], jnp.uint32)
        data, _ = jgossip.broadcast_round(st.data, topo, jnp.ones(n, bool),
                                          jnp.zeros((1, 1), bool), writes, k, g)
        st = st._replace(data=data)
    snap("broadcast")
    return out


def test_rotation_trace_equals_the_reference():
    got = H.rotation_trace("cpu")
    assert got == _reference_rotation_claims()
    assert got["broadcast"][2] == [2, 2, 2, 2]  # writer 3 committed twice, delivered everywhere


def test_coverage_trials_equal_the_reference_sets():
    """The eight trials' arrivals into the port's and the reference's
    16-slot sets: equal slots and gaps after every arrival."""
    assert H.coverage_trials("cpu") == {"trials": 8, "arrivals": 168}
    gen = np.random.default_rng(H.COVERAGE_SEED)
    last_seq = H.COVERAGE_LAST_SEQ
    for _ in range(H.COVERAGE_TRIALS):
        t_iv = tintervals.make(16, device="cpu")
        j_iv = jintervals.make(16)
        chunks = [(s, min(s + 255 + int(gen.integers(0, 64)), last_seq))
                  for s in range(0, last_seq + 1, 256)]
        gen.shuffle(chunks)
        for s, e in chunks + chunks[: len(chunks) // 3]:
            t_iv = tintervals.insert(t_iv, s, e)
            j_iv = jintervals.insert(j_iv, jnp.int32(s), jnp.int32(e))
            assert t_iv.starts.tolist() == np.asarray(j_iv.starts).tolist()
            assert t_iv.ends.tolist() == np.asarray(j_iv.ends).tolist()
            tg, jg = tintervals.gaps(t_iv, 0, last_seq), jintervals.gaps(j_iv, 0, last_seq)
            assert tintervals.to_host(tg) == jintervals.to_host(jg)


def test_coverage_full_width_batched_equals_the_reference():
    """The full-width check at 4,096 rows on the CPU, and the same
    arrivals for 256 rows through the reference's sets (vmapped)."""
    rows, arrivals = 4096, H.FULL_WIDTH_ARRIVALS
    out = H.coverage_full_width("cpu", rows=rows, sample=512)
    assert out["rows"] == rows and out["arrivals"] == 32 and 1 <= out["max_intervals"] <= 16
    gen = torch.Generator().manual_seed(H.FULL_WIDTH_SEED)
    idx = torch.randint(0, 32, (arrivals, rows), generator=gen)
    ext = torch.randint(0, 64, (arrivals, rows), generator=gen)
    starts = (idx * 256)[:, :256]
    ends = torch.clamp(idx * 256 + 255 + ext, max=8191)[:, :256]
    t_iv = tintervals.make(16, (256,), device="cpu")
    j_iv = jax.vmap(lambda _: jintervals.make(16))(jnp.arange(256))
    jins = jax.jit(jax.vmap(jintervals.insert))
    for a in range(arrivals):
        t_iv = tintervals.insert(t_iv, starts[a], ends[a])
        j_iv = jins(j_iv, jnp.asarray(starts[a].numpy(), jnp.int32),
                    jnp.asarray(ends[a].numpy(), jnp.int32))
    assert np.array_equal(t_iv.starts.numpy(), np.asarray(j_iv.starts))
    assert np.array_equal(t_iv.ends.numpy(), np.asarray(j_iv.ends))
    wm_t = tintervals.contiguous_watermark(t_iv, 0).numpy()
    wm_j = np.asarray(jax.vmap(lambda iv: jintervals.contiguous_watermark(iv, jnp.int32(0)))(j_iv))
    assert np.array_equal(wm_t, wm_j)


def test_native_codec_check_on_the_host():
    out = H.native_codec()
    assert out["codec"] and out["codec_loaded"]
    assert out["samples"] == 14 and out["cmp_pairs"] == 27 * 27

"""The seq-chunk plane (``ops/chunks.py``, ``sim/chunk_engine.py``) against
the live JAX reference on the CPU, bit for bit: one round from a state
carried across mid-run (under loss, dead nodes and a wipe), a whole run
(curves, state, visibility, metrics), a run under a fault plan, and the
port's chunked and resumed runs against its whole run. Also the int32
sync phase at 60,000 nodes, the tie rules of the two argmax picks, and
``need`` held to the exact sum above 2^24, where the port stops following
the reference's float32 sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import chunks as jc
from corrosion_tpu.sim import chunk_engine as jce
from corrosion_tpu.sim import faults as jf
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import rng as trng
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.ops import chunks as tc
from corrosion_tpu_torch.sim import chunk_engine as tce
from corrosion_tpu_torch.sim import faults as tf

torch.set_num_threads(1)

KW = dict(n_nodes=48, n_streams=4, cap=16, chunk_len=64, fanout=3, k_in=6,
          sync_interval=4, gap_requests=4, sync_seq_budget=1024)
ORIGIN = [0, 11, 23, 40]
LAST = [1023, 1023, 511, 2047]
ROUNDS = 60
SPLIT = 25


def _state_np(st):
    return {"have": {"starts": np.asarray(st.have.starts), "ends": np.asarray(st.have.ends)}}


def _assert_state_equal(js, ts):
    got = interop.to_numpy(ts)["have"]
    for k in ("starts", "ends"):
        want = np.asarray(getattr(js.have, k))
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k


def _assert_curves_equal(cj, ct):
    assert cj.keys() == ct.keys()
    bad = [k for k in cj if not (cj[k].dtype == ct[k].dtype and np.array_equal(cj[k], ct[k]))]
    assert not bad, f"curves differ in {bad}"


def _assert_metrics_equal(mj, mt):
    _assert_curves_equal(mj["curves"], mt["curves"])
    assert np.array_equal(np.asarray(mj["vis"]), mt["vis"].numpy())
    for k in ("applied_frac", "unapplied", "p50_s", "p99_s", "seqs_granted", "chunks_sent"):
        assert mj[k] == mt[k] or (np.isnan(mj[k]) and np.isnan(mt[k])), k


@pytest.fixture(scope="module")
def reference():
    return jce.simulate_chunks(jc.ChunkConfig(**KW), ORIGIN, LAST, rounds=ROUNDS, seed=3)


@pytest.fixture(scope="module")
def port_run():
    return tce.simulate_chunks(tc.ChunkConfig(**KW), ORIGIN, LAST, rounds=ROUNDS, seed=3,
                               device="cpu")


def test_run_matches_reference(reference, port_run):
    (sj, mj), (st, mt) = reference, port_run
    # Gossip, intake and partial-need sync all act; some pairs complete.
    c = mt["curves"]
    assert c["msgs"].sum() > 0 and c["applied_sync"].sum() > 0 and c["vis_count"].sum() > 0
    assert 0 < mt["unapplied"] < 48 * 4
    _assert_metrics_equal(mj, mt)
    _assert_state_equal(sj, st)


def test_chunked_and_resumed_runs_equal_the_whole_run(port_run):
    st, mt = port_run
    cfg = tc.ChunkConfig(**KW)
    sc, mc = tce.simulate_chunks(cfg, ORIGIN, LAST, rounds=ROUNDS, seed=3, max_chunk=16,
                                 device="cpu")
    _assert_metrics_equal(mt, mc)
    assert torch.equal(sc.have.starts, st.have.starts) and torch.equal(sc.have.ends, st.have.ends)
    s1, m1 = tce.simulate_chunks(cfg, ORIGIN, LAST, rounds=SPLIT, seed=3, device="cpu")
    before = (s1.have.starts.clone(), m1["vis"].clone())
    s2, m2 = tce.simulate_chunks(cfg, ORIGIN, LAST, rounds=ROUNDS - SPLIT, seed=3, state=s1,
                                 vis=m1["vis"], start_round=SPLIT, device="cpu")
    # The carried state is never modified.
    assert torch.equal(s1.have.starts, before[0]) and torch.equal(m1["vis"], before[1])
    assert torch.equal(s2.have.starts, st.have.starts) and torch.equal(s2.have.ends, st.have.ends)
    assert torch.equal(m2["vis"], mt["vis"])
    for k, v in mt["curves"].items():
        assert np.array_equal(np.concatenate([m1["curves"][k], m2["curves"][k]]), v), k


@pytest.mark.parametrize("static,dynamic", [(0.0, 0.3), (0.15, None), (0.15, 0.3)])
def test_one_round_from_a_carried_state(static, dynamic):
    """A reference state from round 20, then one wipe + chunk_round on both
    sides with loss, dead nodes (origins among them) and wiped nodes."""
    cfg_j = jc.ChunkConfig(**dict(KW, loss_prob=static))
    cfg_t = tc.ChunkConfig(**dict(KW, loss_prob=static))
    mid, _ = jce.simulate_chunks(jc.ChunkConfig(**KW), ORIGIN, LAST, rounds=20, seed=3)
    g = np.random.default_rng(5)
    alive = g.random(48) > 0.2
    alive[11] = False
    wipe = np.zeros(48, bool)
    wipe[[2, 30, 31]] = True
    last = np.asarray(LAST, np.int32)

    sj = jc.wipe_coverage(mid, jnp.asarray(wipe), cfg_j)
    sj, stats_j = jc.chunk_round(
        sj, jnp.asarray(last), jnp.asarray(alive), jnp.int32(20), jax.random.PRNGKey(9), cfg_j,
        loss=None if dynamic is None else jnp.float32(dynamic),
    )
    st = interop.chunk_state_from_numpy(_state_np(mid), device="cpu")
    st = tc.wipe_coverage(st, torch.as_tensor(wipe), cfg_t)
    st, stats_t = tc.chunk_round(
        st, torch.as_tensor(last, dtype=torch.int64), torch.as_tensor(alive), 20,
        trng.PRNGKey(9), cfg_t,
        loss=None if dynamic is None else torch.tensor(dynamic, dtype=torch.float32),
    )
    _assert_state_equal(sj, st)
    assert stats_j.keys() == stats_t.keys()
    for k in stats_j:
        assert float(stats_j[k]) == float(stats_t[k]), k
    assert int(stats_t["lost_msgs"]) > 0 and int(stats_t["seqs_granted"]) > 0
    np.testing.assert_array_equal(
        np.asarray(jc.applied_mask(sj, jnp.asarray(last), cfg_j)),
        tc.applied_mask(st, torch.as_tensor(last, dtype=torch.int64), cfg_t).numpy(),
    )


def _plan(faults_mod, rounds):
    F = faults_mod.Fault
    # Loss over every region, a wipe that spares the origins, a node that
    # stays down, and a loss burst on one region only (its worst-region
    # scalar reaches the chunk plane).
    return faults_mod.FaultPlan(rounds, (
        F("loss", 5, 30, prob=0.4),
        F("churn", 8, 9, nodes=(3, 4, 5, 30), revive_at=20, wipe=True),
        F("churn", 10, 11, nodes=(7,)),
        F("loss", 35, 40, prob=0.6, regions=(1,)),
    ), name="chunk-mix")


def test_fault_plan_run_matches_reference():
    cfg_j, cfg_t = jc.ChunkConfig(**KW), tc.ChunkConfig(**KW)
    sj, mj = jce.simulate_chunks(cfg_j, ORIGIN, LAST, rounds=ROUNDS, seed=4,
                                 faults=_plan(jf, ROUNDS))
    st, mt = tce.simulate_chunks(cfg_t, ORIGIN, LAST, rounds=ROUNDS, seed=4,
                                 faults=_plan(tf, ROUNDS), device="cpu")
    c = mt["curves"]
    assert c["chaos_lost_msgs"].sum() > 0 and c["chaos_wiped"].sum() == 4
    _assert_metrics_equal(mj, mt)
    _assert_state_equal(sj, st)
    # CompiledFaults pass through; a partition is refused.
    compiled = _plan(tf, ROUNDS).compile(48, 2)
    _, mc = tce.simulate_chunks(cfg_t, ORIGIN, LAST, rounds=ROUNDS, seed=4, faults=compiled,
                                device="cpu")
    _assert_curves_equal(mt["curves"], mc["curves"])
    cut = tf.FaultPlan(ROUNDS, (tf.Fault("partition", 2, 9, a=(0,)),))
    with pytest.raises(ValueError, match="region topology"):
        tce.simulate_chunks(cfg_t, ORIGIN, LAST, rounds=ROUNDS, faults=cut, device="cpu")
    with pytest.raises(ValueError, match="rounds"):
        tce.simulate_chunks(cfg_t, ORIGIN, LAST, rounds=ROUNDS - 1, faults=compiled,
                            device="cpu")


def test_sync_phase_wraps_in_int32_at_60000_nodes():
    n = 60_000
    want = np.asarray((jnp.arange(n, dtype=jnp.int32) * jnp.int32(40503)) % jnp.int32(5))
    got = tc._phase(torch.arange(n), 5).numpy()
    assert np.array_equal(got, want)
    # Nodes from 53,021 up wrap; the wide product would phase them otherwise.
    assert not np.array_equal(want, (np.arange(n, dtype=np.int64) * 40503) % 5)


def test_tie_rules_of_the_slot_pick_and_the_overlap_pick():
    """Scores on four levels (ties in most rows) and bool overlaps: the
    first maximum wins in both, as in the reference."""
    g = np.random.default_rng(2)
    live = g.random((4000, 16)) < 0.6
    u = (g.integers(0, 4, (4000, 3, 16)) / 4).astype(np.float32)
    want = np.asarray(jnp.argmax(jnp.where(jnp.asarray(live)[:, None, :], jnp.asarray(u), -1.0), -1))
    got = tc._pick_slot(torch.as_tensor(live), torch.as_tensor(u)).numpy()
    assert np.array_equal(got, want)
    overlap = g.random((4000, 16)) < 0.3
    want = np.asarray(jnp.argmax(jnp.asarray(overlap), axis=1))
    assert np.array_equal(tc._first_overlap(torch.as_tensor(overlap))[:, 0].numpy(), want)


def test_need_is_the_exact_sum_above_2_24():
    """4,096 seqs x 16,384 (node, stream) rows of deficit: the sum passes
    2^24, where a float32 sum rounds at every step. The port rounds the
    exact integer sum once."""
    cfg = tc.ChunkConfig(n_nodes=4096, n_streams=4, sync_interval=3)
    last = torch.tensor([4095, 4094, 4093, 4092])
    st = tc.init_chunks(cfg, [0, 1, 2, 3], last, device="cpu")
    st, stats = tc.chunk_round(st, last, torch.ones(4096, dtype=torch.bool), 0,
                               trng.PRNGKey(1), cfg)
    covered = tc.intervals.total(st.have)
    exact = int(torch.clamp(last.repeat(4096) + 1 - covered, min=0).sum())
    assert exact > 1 << 24 and int(np.float32(exact)) != exact
    assert stats["need_seqs"].dtype == torch.float32
    assert float(stats["need_seqs"]) == float(np.float32(exact))


def test_anti_entropy_chunks_builder_matches_reference():
    cj, oj, lj, rj = jb.anti_entropy_chunks()
    ct, ot, lt, rt = tb.anti_entropy_chunks(device="cpu")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct) and rj == rt == 240
    assert np.array_equal(oj, ot.numpy()) and np.array_equal(lj, lt.numpy())
    assert ot.dtype == lt.dtype == torch.int64


def test_zero_rounds_give_empty_curves():
    _, m = tce.simulate_chunks(tc.ChunkConfig(n_nodes=8, n_streams=1), [0], [63], rounds=0,
                               device="cpu")
    assert all(len(v) == 0 for v in m["curves"].values())
    assert m["unapplied"] == 8 and m["applied_frac"] == 0.0

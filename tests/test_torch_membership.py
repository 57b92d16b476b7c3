"""The port's host membership and config (``corrosion_tpu_torch/agent/
membership.py``, ``agent/config.py``) against the reference's, and the
oracles ``sim/host_oracles.py`` holds the SWIM and sync planes to:

- the host cases of ``tests/test_membership_adaptive.py`` and
  ``tests/test_rtt_rings.py`` run against the port (``run_against``),
  each under its own time limit;
- the kernel cases of ``tests/test_membership_adaptive.py`` (down-member
  GC, dense and sparse) as ``kernel_gc_states`` on the CPU, equal state
  for state to the reference's on the same inputs;
- the sync's ring preference: the port's ``gossip.sync_round`` equal to
  the reference's over the same 40 seeds (contig and cells), with the
  reference's margins, and the geo ring table equal to the reference's;
- ``Config`` parsed from one TOML file and one environment equal to the
  reference's, field by field; ``parse_addr`` and ``resolve_bootstrap``
  on literal addresses.

``tests/test_rtt_rings.py::test_ring_repr_table_matches_ring_edges`` reads
``RING_REPR_MS`` from the port's ``fidelity.calibrate``.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_membership_adaptive as ref_adaptive_tests
import test_rtt_rings as ref_ring_tests
from corrosion_tpu.agent import config as jconfig
from corrosion_tpu.agent import membership as jmembership
from corrosion_tpu.ops import gossip as jgossip
from corrosion_tpu.ops import swim as jswim
from corrosion_tpu.ops import swim_sparse as jswim_sparse
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.agent import config as tconfig
from corrosion_tpu_torch.agent import membership as tmembership
from corrosion_tpu_torch.fidelity import calibrate as tcalibrate
from corrosion_tpu_torch.ops import gossip as tgossip
from corrosion_tpu_torch.sim import host_oracles as H
from test_torch_core import run_against

torch.set_num_threads(1)

SWAPS = {"corrosion_tpu.agent.membership": tmembership,
         "corrosion_tpu.fidelity.calibrate": tcalibrate}
CASE_TIMEOUT_S = 20.0


def run_with_limit(fn, seconds: float = CASE_TIMEOUT_S):
    """Run ``fn`` (which may drive its own event loop) in a thread and fail
    if it has not returned within ``seconds``."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the test's thread
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


HOST_CASES = (
    (ref_adaptive_tests, "test_config_adapts_3_to_32"),
    (ref_adaptive_tests, "test_host_down_member_gc"),
    (ref_ring_tests, "test_host_rtt_ring_exact_edges"),
    (ref_ring_tests, "test_member_empty_sample_buffer_and_churn_recalc"),
    (ref_ring_tests, "test_host_rtt_buckets_match_reference_edges"),
    (ref_ring_tests, "test_ring_repr_table_matches_ring_edges"),
)


@pytest.mark.parametrize("module,case", HOST_CASES, ids=[c for _, c in HOST_CASES])
def test_reference_host_cases_hold_on_the_port(module, case, monkeypatch):
    run_with_limit(lambda: run_against(module, case, SWAPS, monkeypatch))


def test_the_swap_reaches_the_ports_membership(monkeypatch):
    run_against(ref_ring_tests, "test_host_rtt_buckets_match_reference_edges", SWAPS,
                monkeypatch)
    assert ref_ring_tests.rtt_ring is tmembership.rtt_ring
    assert ref_ring_tests.MemberState is tmembership.MemberState


# -- the kernels' down-member GC ----------------------------------------------


def reference_gc_states() -> dict:
    """tests/test_membership_adaptive.py's three kernel cases, on the
    reference."""
    from corrosion_tpu.ops.swim import SEV_DOWN, SwimConfig, pack

    key, rnd = jax.random.PRNGKey(0), jnp.int32(0)
    down = pack(jnp.uint32(2), SEV_DOWN)
    cfg = SwimConfig(n_nodes=8, down_gc_rounds=1)
    st = jswim.init_state(cfg)
    st = st._replace(view=st.view.at[:, 3].set(down), alive=st.alive.at[3].set(False))
    out = {"dense": jswim.swim_round(st, key, rnd, cfg)}
    for name, gc in (("sparse", 1), ("sparse_gc_off", 0)):
        cfg = SwimConfig(n_nodes=8, view_capacity=4, down_gc_rounds=gc)
        st = jswim_sparse.init_state(cfg)
        st = st._replace(exc_tgt=st.exc_tgt.at[:, 0].set(3),
                         exc_pkd=st.exc_pkd.at[:, 0].set(down),
                         alive=st.alive.at[3].set(False))
        out[name] = jswim_sparse.swim_round(st, key, rnd, cfg)
    return out


def test_kernel_gc_states_equal_the_reference():
    want = reference_gc_states()
    got = H.kernel_gc_states("cpu")
    assert set(got) == set(want)
    for name in want:
        a, b = want[name]._asdict(), interop.to_numpy(got[name])
        assert set(a) == set(b), name
        bad = [k for k in a if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]
        assert not bad, f"{name}: {bad}"


def test_membership_gc_on_the_cpu():
    out = run_with_limit(lambda: H.membership_gc("cpu"))
    assert out["kernel_cases"] == 3
    assert out["host_gc"] == {"forgotten": 1, "kept": 1}
    lo, hi = out["host_adaptive"]["max_transmissions"]
    assert hi > lo and hi >= 7


# -- sync's ring preference -----------------------------------------------------


def reference_ring_sync(n_cells: int = H.RING_CELLS) -> list:
    """The reference's ``gossip.sync_round`` on ``ring_sync``'s harness
    (``n_cells`` 0 is tests/test_rtt_rings.py's own), seed by seed: node
    0's (contig, cells)."""
    rtt = np.array([[0, 5, 5], [5, 0, 5], [5, 5, 0]], np.int32)
    cfg = dataclasses.replace(H.ring_config(jgossip.GossipConfig), n_cells=n_cells)
    topo = jgossip.make_topology([3, 3, 3], [1, 3], region_rtt=rtt)
    data = jgossip.init_data(cfg)
    contig = data.contig.at[jnp.array([1, 2]), 0].set(4)
    contig = contig.at[jnp.array([3, 4, 5, 6, 7, 8]), 1].set(4)
    data = data._replace(head=jnp.array([4, 4], jnp.uint32), contig=contig,
                         seen=jnp.maximum(data.seen, contig))
    alive, part = jnp.ones(9, bool), jnp.zeros((3, 3), bool)
    out = []
    for seed in range(H.RING_SEEDS):
        d, _ = jgossip.sync_round(data, topo, alive, part, jnp.int32(0),
                                  jax.random.PRNGKey(seed), cfg)
        out.append((np.asarray(d.contig[0]).astype(int).tolist(),
                    [np.asarray(c).reshape(9, n_cells)[0].astype(int).tolist()
                     for c in d.cells]))
    return out


def test_ring_sync_equals_the_reference_over_40_seeds():
    got, want = H.ring_sync("cpu"), reference_ring_sync()
    assert len(got) == len(want) == 40
    bad = [s for s, (a, b) in enumerate(zip(got, want)) if a != b]
    assert not bad, f"seeds {bad} differ"
    # The harness pulls something in every seed, and the cells moved.
    assert all(sum(c) > 0 and any(cl) for c, (cl, _, _) in got)
    # The cells change no pull: on the reference test's own harness (no
    # cells) the reference's sync pulls what the port's pulls here.
    assert [c for c, _ in reference_ring_sync(n_cells=0)] == [c for c, _ in got]


def test_membership_rings_on_the_cpu(tmp_path):
    out = H.membership_rings("cpu", tmp_path)
    assert out["near"] >= 35 and out["far"] <= 3 and out["seeds"] == 40


def test_geo_rings_equal_the_reference():
    a = np.asarray(jgossip.make_topology([4] * 10, [0], region_rtt="geo").region_rtt)
    b = tgossip.make_topology([4] * 10, [0], region_rtt="geo", device="cpu").region_rtt.numpy()
    assert np.array_equal(a, b)
    assert b.min() == 0 and b.max() == 5 and (np.diag(b) == 0).all() and (b == b.T).all()


# -- config ---------------------------------------------------------------------

TOML = """
[db]
path = "/var/lib/corrosion/state.db"
schema_paths = ["/etc/corrosion/schema", "extra.sql"]

[api]
addr = "0.0.0.0:8080"

[gossip]
addr = "10.0.0.5:8787"
bootstrap = ["10.0.0.6:8787", "10.0.0.7:8787"]
plaintext = false
max_transmissions = 9
probe_interval_ms = 300

[gossip.tls]
cert_file = "/etc/corrosion/cert.pem"
key_file = "/etc/corrosion/key.pem"
mtls = true

[gossip.tls.client]
cert_file = "/etc/corrosion/client.pem"
key_file = "/etc/corrosion/client.key"

[admin]
uds_path = "/run/corrosion/admin.sock"

[telemetry]
prometheus_addr = "0.0.0.0:9090"

[log]
format = "json"
colors = true

[consul]
enabled = true
interval_ms = 250
unknown_key = 1
"""

ENV = {
    "CORRO_DB__PATH": "/tmp/override.db",
    "CORRO_GOSSIP__SYNC_INTERVAL_MS": "750",
    "CORRO_GOSSIP__BOOTSTRAP": "10.0.0.8:1, 10.0.0.9:2",
    "CORRO_GOSSIP__TLS_INSECURE": "yes",
    "CORRO_LOG__COLORS": "0",
    "CORRO_NOPE__X": "1",
    "OTHER": "2",
}


@pytest.mark.parametrize("env", [{}, ENV], ids=["file", "file+env"])
def test_config_equals_the_reference_field_by_field(env, tmp_path):
    p = tmp_path / "config.toml"
    p.write_text(TOML)
    a, b = jconfig.Config.load(str(p), env=env), tconfig.Config.load(str(p), env=env)
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        sa, sb = getattr(a, f.name), getattr(b, f.name)
        assert dataclasses.asdict(sa) == dataclasses.asdict(sb), f.name
    assert b.gossip.tls_client_cert_file == "/etc/corrosion/client.pem"
    if env:
        assert b.db.path == "/tmp/override.db" and b.gossip.sync_interval_ms == 750
        assert b.gossip.bootstrap == ["10.0.0.8:1", "10.0.0.9:2"] and b.gossip.tls_insecure


def test_config_defaults_and_schema_sql_equal_the_reference(tmp_path):
    d = tmp_path / "schema"
    d.mkdir()
    (d / "b.sql").write_text("CREATE TABLE b (id INTEGER PRIMARY KEY);")
    (d / "a.sql").write_text("CREATE TABLE a (id INTEGER PRIMARY KEY);")
    (d / "skip.txt").write_text("nope")
    one = tmp_path / "one.sql"
    one.write_text("CREATE TABLE c (id INTEGER PRIMARY KEY);")
    a, b = jconfig.Config.load(env={}), tconfig.Config.load(env={})
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for cfg in (a, b):
        cfg.db.schema_paths = [str(d), str(one), str(tmp_path / "missing.sql")]
    assert a.schema_sql() == b.schema_sql()
    assert b.schema_sql().index("TABLE a") < b.schema_sql().index("TABLE b")


def test_addresses_equal_the_reference():
    for addr in ("127.0.0.1:8787", ":9000", "[::1]:7", "10.1.2.3:0"):
        assert tconfig.parse_addr(addr) == jconfig.parse_addr(addr)
    entries = ["127.0.0.1:1", "10.0.0.2:2", "127.0.0.1:3@127.0.0.1:53"]
    assert tconfig.resolve_bootstrap(entries) == jconfig.resolve_bootstrap(entries)
    assert tconfig.resolve_bootstrap(entries)[:2] == [("127.0.0.1", 1), ("10.0.0.2", 2)]


def test_members_and_rumors_equal_the_reference():
    """The same updates through both packages' ``Members``: equal states,
    rings and alive sets."""
    out = []
    for mod in (jmembership, tmembership):
        m = mod.Members("me")
        for i in range(6):
            m.apply_update(f"{i:032x}", ("10.0.0.1", i + 1), mod.ALIVE, 0)
        m.apply_update(f"{2:032x}", ("10.0.0.1", 3), mod.SUSPECT, 1)
        m.apply_update(f"{3:032x}", ("10.0.0.1", 4), mod.DOWN, 2)
        m.apply_update(f"{3:032x}", ("10.0.0.1", 4), mod.ALIVE, 1)  # stale
        for i, rtt in enumerate((2.0, 10.0, 30.0, 70.0, 150.0, 250.0)):
            m.states[f"{i:032x}"].add_rtt(rtt)
        out.append({k: (v.state, v.incarnation, v.ring, v.addr) for k, v in m.states.items()})
    assert out[0] == out[1]

"""The port's CRDT SQLite store (``corrosion_tpu_torch/agent/store.py``)
against the reference's, and against the simulator's cell merges:

- the reference's own cases (``tests/test_agent_store.py``) run against
  the port, once with the CRDT extension's merge and once with the
  Python merge; the reference's differential (``tests/test_crdt_
  differential.py``) runs with the port's store against the reference's
  kernel;
- the same operations through both packages' stores leave byte-equal
  databases (every table, the change log, the clocks, ``db_version``) and
  serve equal ``changes_for``; each package's store opens a database the
  other wrote and goes on from it as the writer would;
- the native and the Python merge leave equal databases;
- the plane oracles of ``sim/host_oracles.py`` at small size on the CPU:
  the six trials, the 16 x 256 plane through the port's merge and the
  reference's, and whole states of churn_32 (run to its end, and cut at
  round 20) and anti_entropy_1k (cut at round 8) from both packages'
  engines, converged rows and the rows that fall short of ``head`` alike.

Every site id is fixed, so two runs write the same bytes.
"""

import dataclasses
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_agent_store as ref_store_tests
import test_crdt_differential as ref_crdt_tests
from corrosion_tpu.agent import store as jstore
from corrosion_tpu.core import values as jvalues
from corrosion_tpu.models import baselines as jb
from corrosion_tpu.ops import crdt as jcrdt
from corrosion_tpu.ops import gossip as jgossip
from corrosion_tpu.sim import engine as je
from corrosion_tpu_torch import interop
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.agent import store as tstore
from corrosion_tpu_torch.core import values as tvalues
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import host_oracles as H
from test_torch_core import reference_cases, run_against

torch.set_num_threads(1)

STORE_SWAPS = {
    "corrosion_tpu.agent.store": tstore,
    "corrosion_tpu.core.values": tvalues,
    "corrosion_tpu.native": tnative,
}


@pytest.fixture(scope="module")
def built():
    assert tnative.build(), tnative.build_status()
    return tnative.crdt_ext_available()


@pytest.fixture(params=["native", "python"])
def merge(request, built, monkeypatch):
    """The port's store on the CRDT extension's merge or the Python one."""
    if request.param == "native":
        if not built:
            pytest.skip("no sqlite3ext.h on this host: crdt_ext.so is not built")
    else:
        monkeypatch.setattr(tnative, "load_crdt_extension", lambda conn: False)
    return request.param


@pytest.mark.parametrize("case", reference_cases(ref_store_tests))
def test_reference_store_cases_hold_on_the_port(case, merge, tmp_path, monkeypatch):
    run_against(ref_store_tests, case, STORE_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_the_reference_store_cases_are_all_here():
    assert len(reference_cases(ref_store_tests)) == 12


def test_reference_differential_holds_with_the_ports_store(built, tmp_path, monkeypatch):
    """tests/test_crdt_differential.py with the port's ``Store``: the
    reference's kernel merge lands on the port's store's winners."""
    run_against(ref_crdt_tests, "test_store_and_kernel_agree_on_random_streams",
                STORE_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_the_ports_store_loads_only_its_own_extension(built, tmp_path, monkeypatch):
    """The store's merge follows the port's ``build/native/crdt_ext.so``
    alone: with the reference's extension path broken it still loads, and
    with the port's own path broken it does not, whatever the reference
    has built."""
    from corrosion_tpu import native as jnative

    assert tnative.CRDT_EXT_PATH.endswith("build/native/crdt_ext")
    assert tnative.CRDT_EXT_PATH != jnative.CRDT_EXT_PATH

    def native_crdt(name):
        s = tstore.Store(str(tmp_path / name), H.site_id(1))
        try:
            return s.native_crdt
        finally:
            s.close()

    monkeypatch.setattr(jnative, "CRDT_EXT_PATH", str(tmp_path / "missing"))
    assert native_crdt("a.db") == built
    monkeypatch.undo()
    monkeypatch.setattr(tnative, "CRDT_EXT_PATH", str(tmp_path / "missing"))
    assert native_crdt("b.db") is False


# -- the port's store against the reference's, operation for operation -------

SCHEMA = ref_store_tests.SCHEMA + H.CELLS_SCHEMA + ";\n"


def dump(path) -> dict:
    """Every table of a database file, its rows sorted."""
    conn = sqlite3.connect(str(path))
    try:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return {n: sorted(conn.execute(f'SELECT * FROM "{n}"').fetchall(), key=repr)
                for n in names}
    finally:
        conn.close()


def drive(store_mod, values_mod, path, site: bytes) -> dict:
    """Local writes, deletes, a resurrection, remote changes of two sites
    (the reference trials' streams), a cleared range and a schema
    migration through one store; returns what it answered."""
    S = values_mod.Statement
    s = store_mod.Store(str(path), site)
    out = {}
    try:
        out["schema"] = s.apply_schema(SCHEMA)
        txs = [
            [S("INSERT INTO tests (id, text) VALUES (?, ?)", params=[1, "one"]),
             S("INSERT INTO tests (id, text) VALUES (?, ?)", params=[2, "two"])],
            [S("UPDATE tests SET text = 'uno' WHERE id = 1")],
            [S("DELETE FROM tests WHERE id = 2")],
            [S("INSERT INTO tests (id, text) VALUES (2, 'again')")],
            [S("INSERT INTO testsblob (id, text) VALUES (?, ?)", params=[b"\x00\x01", "b"])],
            [S("UPDATE tests SET text = 'uno' WHERE id = 1")],  # no change
        ]
        out["txs"] = []
        for tx in txs:
            res, dbv, last, chs = s.execute_transaction(tx)
            out["txs"].append(([r.rows_affected for r in res], dbv, last,
                               [c.to_tuple() for c in chs]))
        gen = np.random.default_rng(H.TRIAL_SEED)
        stream = (H.random_changes(gen, H.TRIAL_CHANGES, H.site_id(1))
                  + H.random_changes(gen, H.TRIAL_CHANGES, H.site_id(2)))
        changes = [values_mod.Change(*c.to_tuple()) for c in H._trial_changes(stream)]
        out["applied"] = [s.apply_changes(changes[i:i + 16]) for i in range(0, len(changes), 16)]
        out["changes_for"] = {
            (site_, dbv): [c.to_tuple() for c in s.changes_for(site_, dbv)]
            for site_ in (site, H.site_id(1), H.site_id(2)) for dbv in (1, 3, 5, 17, 40)
        }
        out["cleared"] = sorted(s.find_cleared_versions(H.site_id(1)))
        out["empty"] = s.store_empty_changeset(H.site_id(2), 3, 6)
        out["migrate"] = s.apply_schema(SCHEMA.replace(
            "CREATE TABLE tests2 (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');",
            "CREATE TABLE tests2 (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL "
            "DEFAULT '', extra INTEGER DEFAULT 0);"))
        out["db_version"] = s.db_version()
        out["cells"] = [a.tolist() for a in H.store_cells(s, H.TRIAL_KEYS)]
        out["query"] = s.query(S("SELECT * FROM tests ORDER BY id"))
    finally:
        s.close()
    return out


def test_port_store_equals_the_reference_store(merge, tmp_path):
    site = H.site_id(9)
    want = drive(jstore, jvalues, tmp_path / "ref.db", site)
    got = drive(tstore, tvalues, tmp_path / "port.db", site)
    assert got == want
    assert dump(tmp_path / "port.db") == dump(tmp_path / "ref.db")


def test_native_and_python_merges_leave_equal_databases(built, tmp_path, monkeypatch):
    if not built:
        pytest.skip("no sqlite3ext.h on this host: crdt_ext.so is not built")
    a = drive(tstore, tvalues, tmp_path / "native.db", H.site_id(9))
    monkeypatch.setattr(tnative, "load_crdt_extension", lambda conn: False)
    b = drive(tstore, tvalues, tmp_path / "python.db", H.site_id(9))
    assert a == b
    assert dump(tmp_path / "native.db") == dump(tmp_path / "python.db")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_store_reads_and_continues_the_others_database(writer, merge, tmp_path):
    """A database written by one package, opened by the other: the same
    rows, change log, clocks and ``db_version`` (opening changes nothing),
    and one more transaction and merge land as the writer's own store
    would land them."""
    mods = {"reference": (jstore, jvalues), "port": (tstore, tvalues)}
    other = "port" if writer == "reference" else "reference"
    site = H.site_id(9)
    for name in ("a.db", "b.db"):
        drive(*mods[writer], tmp_path / name, site)
    before = dump(tmp_path / "a.db")

    def go_on(store_mod, values_mod, path):
        S = values_mod.Statement
        s = store_mod.Store(str(path), H.site_id(77))  # the file's id wins
        try:
            seen = (s.site_id, s.db_version(), sorted(s.tables()),
                    [c.to_tuple() for c in s.changes_for(site, 1)],
                    [c.to_tuple() for c in s.changes_for(H.site_id(1), 7)],
                    [a.tolist() for a in H.store_cells(s, H.TRIAL_KEYS)])
            mid = dump(path)
            res = s.execute_transaction([S("UPDATE tests SET text = 'later' WHERE id = 2"),
                                         S("INSERT INTO tests2 (id, text, extra) VALUES (1, 'x', 3)")])
            ch = values_mod.Change(*H.cell_change(3, 5, 9, 999, H.site_id(4), 1, 0).to_tuple())
            applied = s.apply_changes([ch])
        finally:
            s.close()
        return seen, mid, ([r.rows_affected for r in res[0]], res[1], res[2],
                           [c.to_tuple() for c in res[3]]), applied

    seen_o, mid_o, res_o, app_o = go_on(*mods[other], tmp_path / "a.db")
    seen_w, mid_w, res_w, app_w = go_on(*mods[writer], tmp_path / "b.db")
    assert seen_o == seen_w and seen_o[0] == site
    assert mid_o == mid_w == before
    assert (res_o, app_o) == (res_w, app_w)
    assert dump(tmp_path / "a.db") == dump(tmp_path / "b.db")


# -- the plane oracles at small size -----------------------------------------


def test_store_crdt_trials_on_the_cpu(built, tmp_path):
    out = H.store_crdt_trials("cpu", tmp_path)
    assert out["trials"] == 6 and out["changes"] == 480
    assert out["merge"] == ("native" if built else "python")


def test_trials_stores_equal_the_references(built, tmp_path):
    """The trials' streams through the reference's store and the port's
    give the same cells, trial by trial."""
    gen = np.random.default_rng(H.TRIAL_SEED)
    for trial in range(H.TRIALS):
        stream = (H.random_changes(gen, H.TRIAL_CHANGES, H.site_id(2 * trial + 1))
                  + H.random_changes(gen, H.TRIAL_CHANGES, H.site_id(2 * trial + 2)))
        gen.permutation(len(stream))
        chs = H._trial_changes(stream)
        cells = []
        for mod, vmod, name in ((jstore, jvalues, "j"), (tstore, tvalues, "t")):
            s = mod.Store(str(tmp_path / f"{name}{trial}.db"), H.STORE_SITE)
            try:
                s.apply_schema(H.CELLS_SCHEMA)
                s.apply_changes([vmod.Change(*c.to_tuple()) for c in chs])
                cells.append([a.tolist() for a in H.store_cells(s, H.TRIAL_KEYS)])
            finally:
                s.close()
        assert cells[0] == cells[1], f"trial {trial}"


def test_store_crdt_plane_port_and_reference(built, tmp_path):
    """The 16 x 256 plane: the port's merge equals its stores (the oracle),
    and the reference's ``_merge_versions_dense`` on the same batches gives
    the port's cells."""
    out = H.store_crdt_plane("cpu", tmp_path)
    assert out["nodes"] == 16 and out["cells"] == 256 and out["cell_merges"] > 1000
    cfg_t = H.gossip.GossipConfig(n_nodes=H.PLANE_NODES, n_writers=H.PLANE_WRITERS,
                                  n_cells=H.PLANE_CELLS,
                                  cells_per_write=H.PLANE_CELLS_PER_WRITE)
    cfg_j = jgossip.GossipConfig(n_nodes=H.PLANE_NODES, n_writers=H.PLANE_WRITERS,
                                 n_cells=H.PLANE_CELLS,
                                 cells_per_write=H.PLANE_CELLS_PER_WRITE)
    _, batches = H.plane_batches("cpu")
    ct = H.crdt.make_cells(H.PLANE_NODES * H.PLANE_CELLS, "cpu")
    cj = jcrdt.make_cells(H.PLANE_NODES * H.PLANE_CELLS)
    for w, v, mask in batches:
        ct, mt = H.gossip._merge_versions_dense(ct, None, w, v, mask, None, H.PLANE_NODES, cfg_t)
        cj, mj = jgossip._merge_versions_dense(
            cj, None, jnp.asarray(w.numpy(), jnp.int32), jnp.asarray(v.numpy(), jnp.uint32),
            jnp.asarray(mask.numpy()), None, H.PLANE_NODES, cfg_j)
        assert int(mt) == int(mj)
    for a, b in zip(ct, cj):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def _cut(sched, stop: int):
    """The first ``stop`` rounds of either package's Schedule."""
    kw = {}
    for f in dataclasses.fields(sched):
        x = getattr(sched, f.name)
        if f.name in ("writes", "kill", "revive", "partition", "loss", "probe_loss", "wipe"):
            x = None if x is None else x[:stop]
        kw[f.name] = x
    return type(sched)(**kw)


def _nested(tree):
    if hasattr(tree, "_fields"):
        return {k: _nested(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


FULL_CASES = (
    # (model, kwargs, cut rounds: None = the whole schedule)
    ("churn_32", {}, (20, None)),
    ("anti_entropy_1k", dict(n=200, burst=400), (8,)),
)


@pytest.mark.parametrize("model,kw,cuts", FULL_CASES, ids=[c[0] for c in FULL_CASES])
def test_store_crdt_full_on_both_engines(model, kw, cuts, built, tmp_path):
    """Whole states of both packages' engines, at the end of the schedule
    and at mid-run cuts, through ``store_crdt_full``: every converged row
    and every row short of ``head`` (up to 64 a state) equal to a store of
    exactly the versions it holds. The reference's states hold as the
    port's do, so the short-row check is the protocol's, not the port's."""
    cfg_t, topo_t, sched_t = getattr(tb, model)(device="cpu", **kw)
    cfg_j, topo_j, sched_j = getattr(jb, model)(**kw)
    short = 0
    for cut in cuts:
        stop = sched_t.rounds if cut is None else cut
        final_t, _ = te.simulate(cfg_t, topo_t, _cut(sched_t, stop), seed=0, device="cpu")
        final_j, _ = je.simulate(cfg_j, topo_j, _cut(sched_j, stop), seed=0)
        port = interop.to_numpy(final_t)
        ref = interop.cluster_state_from_numpy(_nested(final_j), "cpu")
        assert all(np.array_equal(a, b) for a, b in zip(
            _leaves(port), _leaves(interop.to_numpy(ref))))
        for label, st in (("port", final_t), ("reference", ref)):
            d = st.data
            out = H.store_crdt_full(d.cells, d.head, d.contig, d.oo, st.swim.alive,
                                    cfg_t.gossip, tmp_path / label, sample=64)
            assert out["versions"] == int(sched_t.writes[:stop].sum())
        short += out["short_rows_checked"]
        if cut is None:
            assert out["converged_rows"] == out["rows"] and out["short_rows"] == 0
    assert short > 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]

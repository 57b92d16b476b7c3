"""The port's agent runtime against the live reference on the CPU, and
the two packages' agents working together:

- one reference agent and one port agent, each alone, with fixed site
  ids and one fixed HLC clock in both packages, answer the same HTTP
  transactions, queries and subscriptions with equal JSON (the elapsed
  ``time`` fields and the subscription's random id aside) and leave
  equal rows, clocks, change logs and bookkeeping;
- ``netem``: the same plan and seed give the same fault decisions and
  trace in both packages, and each package replays the other's trace;
- ``backup``: both packages' backups of one live database are the same
  bytes, and a backup taken by either restores under the other to an
  equal digest;
- ``_rehydrate``: an agent of either package restarts from a data
  directory the other wrote and goes on with its versions;
- a mixed cluster of two reference and two port agents on 127.0.0.1
  converges, so the wire and the sync protocol interoperate;
- a 3-agent port cluster's recorded trace replays to equal curves and
  final state through the port's ``replay`` on the CPU and the
  reference's;
- ``sim/host_oracles.py``'s ``agent_cluster_live`` and
  ``agent_trace_replay`` at small size on the CPU.
"""

import asyncio
import json
import sqlite3

import numpy as np
import pytest
import torch

from corrosion_tpu.agent import backup as jbackup
from corrosion_tpu.agent import netem as jnetem
from corrosion_tpu.agent import store as jstore
from corrosion_tpu.agent import testing as jtesting
from corrosion_tpu.client import ApiError as JApiError
from corrosion_tpu.core import hlc as jhlc
from corrosion_tpu.sim import trace as jtrace
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.agent import backup as tbackup
from corrosion_tpu_torch.agent import netem as tnetem
from corrosion_tpu_torch.agent import store as tstore
from corrosion_tpu_torch.agent import testing as ttesting
from corrosion_tpu_torch.client import ApiError as TApiError
from corrosion_tpu_torch.core import hlc as thlc
from corrosion_tpu_torch.sim import host_oracles as H
from corrosion_tpu_torch.sim import trace as ttrace
from test_torch_engine import _assert_curves_equal, _assert_state_equal

torch.set_num_threads(1)

SIDE = {"ref": (jtesting, jstore), "port": (ttesting, tstore)}
FIXED_MS = 1_700_000_000_000


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' HLCs read one fixed wall clock: timestamps then
    advance only by the logical counter, so equal operations stamp equal
    times."""
    for mod in (jhlc, thlc):
        monkeypatch.setattr(mod.HLC, "_now_ms", lambda self: FIXED_MS)


async def launch(side: str, data_dir, site: int = 1, **kw):
    """An agent of ``side`` whose store was first created with the fixed
    site id ``site`` (the agent adopts a persisted site id)."""
    testing, store = SIDE[side]
    data_dir.mkdir(parents=True, exist_ok=True)
    store.Store(str(data_dir / "state.db"), H.site_id(site)).close()
    return await testing.launch_test_agent(str(data_dir), **kw)


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k != "time"}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


TABLES = ("tests", "tests2", "tests__crdt_rows", "tests__crdt_clock", "tests2__crdt_clock",
          "__crdt_changes", "__corro_bookkeeping", "__corro_seq_bookkeeping")


def db_tables(path) -> dict:
    conn = sqlite3.connect(str(path))
    try:
        return {t: sorted(conn.execute(f'SELECT * FROM "{t}"').fetchall(), key=repr)
                for t in TABLES}
    finally:
        conn.close()


TRANSACTIONS = (
    [["INSERT INTO tests (id, text) VALUES (?, ?)", [1, "one"]]],
    [["INSERT INTO tests (id, text) VALUES (?, ?)", [2, "two"]],
     ["INSERT INTO tests2 (id, text) VALUES (?, ?)", [2, "deux"]]],
    [["INSERT OR REPLACE INTO tests (id, text) VALUES (?, ?)", [1, "uno"]]],
    [["UPDATE tests SET text = ? WHERE id = ?", ["dos", 2]]],
    [["INSERT INTO tests (id, text) VALUES (3, 'three'), (4, 'four'), (5, 'five')"]],
    [["DELETE FROM tests WHERE id = ?", [4]]],
    [["INSERT INTO tests (id, text) VALUES (?, ?)", [4, "four again"]]],
    [["UPDATE tests SET text = text || '!' WHERE id > 2"]],
    [["INSERT INTO tests (id, text) VALUES (?, ?)", [1, "duplicate key"]]],
    [["INSERT INTO no_such_table VALUES (1)"]],
    [["INSERT INTO tests (id, text) VALUES (?, ?)", [6, "é ünïcode"]]],
    [["DELETE FROM tests2"]],
)
QUERIES = (
    "SELECT id, text FROM tests ORDER BY id",
    "SELECT count(*), group_concat(text, '|') FROM tests",
    "SELECT t.id, t.text, u.text FROM tests t LEFT JOIN tests2 u ON u.id = t.id ORDER BY t.id",
    "SELECT * FROM tests2",
    "SELECT nope FROM tests",
)
SUBSCRIPTIONS = ("SELECT id, text FROM tests", "SELECT id, text FROM tests WHERE id >= 3")


async def _drive(side: str, root, events_wanted: int) -> dict:
    ta = await launch(side, root / side)
    errors = (JApiError, TApiError)
    out = {"tx": [], "queries": [], "subs": []}
    subs, readers = [], []
    try:
        for sql in SUBSCRIPTIONS:
            sub = await ta.client.subscribe(sql)
            events = []

            async def read(sub=sub, events=events):
                async for ev in sub:
                    events.append(ev)

            subs.append(sub)
            readers.append(asyncio.ensure_future(read()))
            out["subs"].append(events)
        for tx in TRANSACTIONS:
            try:
                out["tx"].append(_untimed(await ta.client.execute(tx)))
            except errors as e:
                out["tx"].append(["error", e.args])
        for q in QUERIES:
            try:
                out["queries"].append(list(await ta.client.query(q)))
            except errors as e:
                out["queries"].append(["error", e.args])

        async def delivered():
            return all(sum("change" in ev for ev in evs) >= n
                       for evs, n in zip(out["subs"], events_wanted))

        await jtesting.poll_until(delivered, timeout=10)
        out["subs"] = [_untimed(evs) for evs in out["subs"]]
        out["db"] = ta.agent.store.path
    finally:
        for r in readers:
            r.cancel()
        for s in subs:
            s.close()
        await ta.stop()
    out["tables"] = db_tables(out["db"])
    return out


def test_http_api_answers_equal_the_reference(tmp_path, fixed_clock):
    """Transactions (including a conflict and an unknown table), queries
    (including an error), two subscriptions' event streams, and the
    rows, clocks, change logs and bookkeeping they leave."""
    ref = run(_drive("ref", tmp_path, (13, 9)))
    port = run(_drive("port", tmp_path, (13, 9)))
    assert port["tx"] == ref["tx"]
    assert sum(isinstance(t, list) for t in ref["tx"]) == 2  # the two refused
    assert port["queries"] == ref["queries"]
    assert port["subs"] == ref["subs"]
    assert [len(s) for s in ref["subs"]] == [15, 11]
    assert port["tables"] == ref["tables"]
    assert len(ref["tables"]["__crdt_changes"]) >= 10


# -- netem ---------------------------------------------------------------------

PLAN = {
    "schema": "corro-host-fault-plan/1",
    "faults": [
        {"kind": "delay", "delay_ms": 40.0, "jitter_ms": 15.0},
        {"kind": "loss", "prob": 0.2, "planes": ["probe", "bcast"]},
        {"kind": "dup", "prob": 0.1},
        {"kind": "reorder", "prob": 0.15, "extra_ms": 30.0},
        {"kind": "blackhole", "src": ["n0"], "dst": ["n2"], "start_s": 1.0, "stop_s": 2.0,
         "stall_s": 0.5},
        {"kind": "partition", "a": ["n0", "n1"], "b": ["n3"], "start_s": 3.0, "stop_s": 4.0},
        {"kind": "flap", "a": ["n4"], "period_s": 0.5, "start_s": 0.5, "one_way": True},
    ],
}
NETEM_DRAWS = 3000


def _netem_run(mod, seed: int) -> tuple:
    plan = mod.HostFaultPlan.from_json(json.dumps(PLAN))
    clock = iter(i * 0.002 for i in range(10 * NETEM_DRAWS))
    shim = mod.NetemShim(plan, seed=seed, local="n0", clock=lambda: next(clock))
    for i in range(1, 5):
        shim.register_peer(("127.0.0.1", 7000 + i), f"n{i}")
    shim.arm()
    verdicts = []
    for k in range(NETEM_DRAWS):
        addr = ("127.0.0.1", 7000 + k % 6)  # 7000 and 7005 stay unresolved
        if k % 3 == 0:
            v = shim.udp_fault(addr)
            verdicts.append(("probe", v.drop, v.dup, v.delay_s))
        else:
            plane = "bcast" if k % 3 == 1 else "sync"
            v = shim.stream_fault(plane, addr)
            verdicts.append((plane, v.block_s, v.drop, v.delay_s))
    return plan.to_json(), verdicts, shim.trace, shim.stats, shim.fingerprint()


@pytest.mark.parametrize("seed", (0, 7))
def test_netem_decisions_equal_the_reference(seed):
    ref, port = _netem_run(jnetem, seed), _netem_run(tnetem, seed)
    assert port == ref
    _, verdicts, trace, stats, _ = port
    assert stats["dropped"] and stats["duplicated"] and stats["delayed"] and stats["blocked"]
    assert len(verdicts) == NETEM_DRAWS and len(trace) > NETEM_DRAWS // 2
    for mod in (jnetem, tnetem):
        ok, bad = mod.replay_schedule(PLAN, seed, "n0", trace)
        assert ok, bad[:3]


# -- backup and restore across packages ----------------------------------------


def _digest(db_path) -> str:
    conn = sqlite3.connect(str(db_path))
    try:
        return conn.execute(H.LIVE_DIGEST_SQL).fetchone()[0]
    finally:
        conn.close()


async def _write_rows(ta, start: int, n: int) -> None:
    for i in range(start, start + n):
        await ta.client.execute([[H.LIVE_WRITE_SQL, [i, f"v{i}"]]])


def test_backups_restore_across_packages(tmp_path):
    async def main():
        ta = await launch("port", tmp_path / "live")
        try:
            await _write_rows(ta, 0, 12)
            # Taken while the agent runs (VACUUM INTO from its WAL database).
            jbackup.backup(ta.agent.store.path, str(tmp_path / "ref.bk"))
            tbackup.backup(ta.agent.store.path, str(tmp_path / "port.bk"))
            return _digest(ta.agent.store.path)
        finally:
            await ta.stop()

    want = run(main())
    assert (tmp_path / "ref.bk").read_bytes() == (tmp_path / "port.bk").read_bytes()
    for bk, restore in (("ref.bk", tbackup.restore), ("port.bk", jbackup.restore)):
        target = tmp_path / f"restored_{bk}.db"
        target.write_bytes(b"")
        site = restore(str(tmp_path / bk), str(target), self_actor_id=True)
        assert site == H.site_id(1)
        assert _digest(target) == want


def test_online_restore_of_the_other_packages_backup(tmp_path):
    """Each package's running agent swaps in the other's backup in place
    and serves it."""
    async def main():
        src = await launch("ref", tmp_path / "src")
        try:
            await _write_rows(src, 0, 5)
        finally:
            await src.stop()
        jbackup.backup(src.agent.store.path, str(tmp_path / "bk.db"))
        for side in ("ref", "port"):
            ta = await launch(side, tmp_path / f"dst_{side}", site=2)
            try:
                actor = await ta.agent.restore_online(str(tmp_path / "bk.db"))
                assert actor != H.site_id(2).hex()
                _, rows = await ta.client.query("SELECT count(*) FROM tests")
                assert rows == [[5]]
            finally:
                await ta.stop()

    run(main())


# -- restart from the other package's data directory --------------------------


def _booked(agent) -> dict:
    return {a: sorted(b.current_versions().items()) for a, b in agent.bookie.items()}


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_restart_from_the_other_packages_data_dir(tmp_path, first, second):
    async def main():
        a = await launch(first, tmp_path / "d", site=3)
        try:
            await _write_rows(a, 0, 6)
            before = _booked(a.agent)
        finally:
            await a.stop()
        b = await SIDE[second][0].launch_test_agent(str(tmp_path / "d"))
        try:
            assert b.agent.actor_id == H.site_id(3).hex()
            assert _booked(b.agent) == before
            assert b.agent.bookie.for_actor(b.agent.actor_id).last() == 6
            await _write_rows(b, 6, 3)
            assert b.agent.bookie.for_actor(b.agent.actor_id).last() == 9
            _, rows = await b.client.query("SELECT count(*) FROM tests")
            assert rows == [[9]]
        finally:
            await b.stop()

    run(main())


# -- a mixed cluster ------------------------------------------------------------


def test_mixed_cluster_of_both_packages_converges(tmp_path):
    async def main():
        cluster = []
        try:
            for i, side in enumerate(("ref", "port", "ref", "port")):
                boot = [cluster[-1].gossip_addr] if cluster else None
                cluster.append(await launch(side, tmp_path / f"a{i}", site=10 + i,
                                            bootstrap=boot, sync_interval=0.2))
            for i, ta in enumerate(cluster):
                await _write_rows(ta, 8 * i, 8)
            # Conflicting upserts from every agent.
            await asyncio.gather(*[ta.client.execute([[H.LIVE_WRITE_SQL, [0, f"w{i}"]]])
                                   for i, ta in enumerate(cluster)])

            async def converged():
                digests = {H.agent_digest(ta) for ta in cluster}
                return len(digests) == 1 and None not in digests

            await jtesting.poll_until(converged, timeout=30)
            _, rows = await cluster[1].client.query("SELECT count(*) FROM tests")
            assert rows == [[32]]
            return [ta.agent.store.path for ta in cluster]
        finally:
            for ta in cluster:
                await ta.stop()

    paths = run(main())
    # Every agent holds each cell at the same causal length and
    # col_version (db_version and site are each store's own).
    cells = [sorted((pk, cid, cv) for pk, cid, cv, *_ in db_tables(p)["tests__crdt_clock"])
             + db_tables(p)["tests__crdt_rows"] for p in paths]
    assert all(c == cells[0] for c in cells) and len(cells[0]) == 64


# -- a port cluster's trace through both replays -------------------------------


def test_port_cluster_trace_replays_equal_in_both_packages(tmp_path):
    async def main():
        trace = ttrace.Trace()
        cluster = []
        try:
            for i in range(3):
                boot = [cluster[0].gossip_addr] if cluster else None
                cluster.append(await ttesting.launch_test_agent(str(tmp_path / f"a{i}"),
                                                                bootstrap=boot))
                trace.record(cluster[-1].agent)
            for i in range(30):
                await cluster[i % 3].client.execute([[H.LIVE_WRITE_SQL, [i % 8, f"v{i}"]]])
        finally:
            for ta in cluster:
                await ta.stop()
        return trace

    trace = run(main())
    assert len(trace.events) == 30
    ja, jfinal, jcurves, jlat = jtrace.replay(jtrace.Trace(events=list(trace.events)),
                                              observers=5, drain_rounds=12)
    ta, tfinal, tcurves, tlat = ttrace.replay(trace, observers=5, drain_rounds=12,
                                              device="cpu")
    assert ta == ja and tlat == jlat
    _assert_curves_equal({k: np.asarray(v) for k, v in jcurves.items()},
                         {k: np.asarray(v) for k, v in tcurves.items()})
    _assert_state_equal(jfinal, tfinal)


# -- the host oracles' new paths at small size ---------------------------------


def test_agent_cluster_live_and_its_replay_small(tmp_path):
    out, trace, versions = H.agent_cluster_live("cpu", root=tmp_path, agents=4, writes=64)
    assert 0 < out["rows"] <= H.LIVE_ROWS and out["agents"] == 4
    assert out["changes_merged"] >= 64 and out["sub_events"] >= out["rows"] + 2
    assert sum(versions.values()) == 64 == len(trace.events)
    rep = H.agent_trace_replay(trace, versions, 36, "cpu")
    assert rep["nodes"] == 36 and rep["versions"] == 64 and rep["unseen"] == 0
    assert rep["alive"] == rep["nodes"]


def test_agent_trace_replay_refuses_a_wrong_head(tmp_path):
    """The replay's head check is live: a version count off by one fails."""
    events = [(i * 100, "aa" * 16, i + 1) for i in range(5)]
    with pytest.raises(AssertionError):
        H.agent_trace_replay(ttrace.Trace(events=events), {"aa" * 16: 4}, 4, "cpu")

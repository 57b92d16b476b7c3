"""The port's Postgres wire server (``agent/pg.py``) against the
reference's, on the CPU:

- every case of ``tests/test_pg_wire.py`` and
  ``tests/test_pg_wire_corpus.py``, run against the port's modules
  (``test_torch_core.run_against``): the cases launch the port's agents
  and its ``serve_pg`` on 127.0.0.1;
- the same sessions sent to a reference agent's ``serve_pg`` and to a
  port agent's, with fixed site ids and one fixed HLC clock in both
  packages: an SSLRequest (refused), the simple flow (writes, reads,
  multi-statement strings, catalog queries, errors), the extended flow
  with text and binary parameters and results, Describe of statements
  and portals, and an error inside a transaction block in both flows.
  Every response byte is equal, and so are the rows the sessions leave.
"""

import asyncio
import sqlite3
import struct

import pytest

import test_pg_wire as ref_pg_wire
import test_pg_wire_corpus as ref_pg_corpus
from corrosion_tpu.agent import pg as jpg
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.agent import pg as tpg
from test_pg_wire_corpus import (
    QUERY,
    STARTUP_PARAMS,
    SYNC,
    _m,
    bind_msg,
    describe_msg,
    execute_msg,
    parse_msg,
)
from test_torch_agent_interop import fixed_clock, launch  # noqa: F401
from test_torch_agent_runtime import RUNTIME_SWAPS
from test_torch_core import reference_cases, run_against

CASES = ([(ref_pg_wire, c) for c in reference_cases(ref_pg_wire)]
         + [(ref_pg_corpus, c) for c in reference_cases(ref_pg_corpus)])


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


@pytest.mark.parametrize(
    "module,case", CASES, ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_pg_wire_cases_hold_on_the_port(module, case, tmp_path, monkeypatch):
    run_against(module, case, RUNTIME_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_every_pg_wire_case_is_run():
    assert len([c for m, c in CASES if m is ref_pg_wire]) == 10
    assert len([c for m, c in CASES if m is ref_pg_corpus]) == 6


def test_the_cases_serve_the_ports_pg(tmp_path, monkeypatch):
    """A swapped case serves through the port's ``serve_pg``, never the
    reference's."""
    served = []
    port_serve = tpg.serve_pg

    async def serve(agent, *a, **k):
        served.append(type(agent).__module__)
        return await port_serve(agent, *a, **k)

    async def refuse(*a, **k):
        raise AssertionError("the reference's serve_pg was called")

    monkeypatch.setattr(tpg, "serve_pg", serve)
    monkeypatch.setattr(jpg, "serve_pg", refuse)
    run_against(ref_pg_wire, "test_pg_select_insert_and_parity", RUNTIME_SWAPS, monkeypatch,
                tmp_path=tmp_path)
    assert served == ["corrosion_tpu_torch.agent.agent"]


# -- the same sessions against both packages ------------------------------------

SCHEMA = (
    "CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');\n"
    "CREATE TABLE kinds (id INTEGER NOT NULL PRIMARY KEY, i INTEGER DEFAULT 0,"
    " f REAL DEFAULT 0.0, t TEXT DEFAULT '', b BLOB, n NUMERIC DEFAULT 0);"
)


TABLES = ("tests", "kinds", "tests__crdt_rows", "tests__crdt_clock", "kinds__crdt_rows",
          "kinds__crdt_clock", "__crdt_changes", "__corro_bookkeeping")


def db_tables(path) -> dict:
    conn = sqlite3.connect(str(path))
    try:
        return {t: sorted(conn.execute(f'SELECT * FROM "{t}"').fetchall(), key=repr)
                for t in TABLES}
    finally:
        conn.close()


def _startup() -> bytes:
    payload = struct.pack(">I", 196608) + STARTUP_PARAMS
    return struct.pack(">I", len(payload) + 4) + payload


SSL_REQUEST = struct.pack(">II", 8, 80877103)
I8 = lambda v: struct.pack(">q", v)  # noqa: E731
I4 = lambda v: struct.pack(">i", v)  # noqa: E731
F8 = lambda v: struct.pack(">d", v)  # noqa: E731

# What the client sends, step by step; each reply ends with one ReadyForQuery.
SESSION = (
    QUERY("INSERT INTO tests (id, text) VALUES (1, 'one'), (2, 'two')"),
    QUERY("SELECT id, text FROM tests ORDER BY id"),
    QUERY("INSERT INTO kinds (id, i, f, t, b, n) VALUES (1, 7, 1.5, 'x', X'00ff', 3);"
          " UPDATE tests SET text = 'uno' WHERE id = 1; SELECT * FROM kinds"),
    QUERY("SELECT 'a;b'::text AS s, 1 + 1 AS two, true AS yes, NULL AS nothing"),
    QUERY("SELECT relname, relkind FROM pg_catalog.pg_class ORDER BY relname"),
    QUERY("SELECT a.attname, a.atttypid, a.attnum, a.attnotnull FROM pg_attribute a"
          " JOIN pg_class c ON c.oid = a.attrelid WHERE c.relname = 'kinds'"
          " ORDER BY a.attnum"),
    QUERY("SELECT typname, typlen FROM pg_type ORDER BY oid"),
    QUERY("SELECT nope FROM tests"),
    QUERY("SELECT * FROM no_such_table"),
    QUERY("SET application_name = 'x'"),
    QUERY("COPY tests FROM STDIN"),
    # An error inside a simple-flow transaction block, then ROLLBACK.
    QUERY("BEGIN"),
    QUERY("INSERT INTO tests (id, text) VALUES (3, 'three')"),
    QUERY("INSERT INTO no_such_table VALUES (1)"),
    QUERY("SELECT 1"),
    QUERY("ROLLBACK"),
    # A committed block with several deferred writes.
    QUERY("BEGIN; INSERT INTO tests (id, text) VALUES (4, 'four'), (5, 'five');"
          " UPDATE tests SET text = 'dos' WHERE id = 2; COMMIT"),
    # The extended flow: a named statement with typed binary parameters,
    # Describe of the statement and the portal, binary results.
    parse_msg(b"P", "ins", "INSERT INTO kinds (id, i, f, t, b) VALUES ($1, $2, $3, $4, $5)",
              (20, 23, 701, 25, 17))
    + describe_msg(b"S", "ins")
    + bind_msg("", "ins", [1, 1, 1, 0, 1], [I8(2), I4(-9), F8(2.25), b"zwei", b"\x01\x02"], [])
    + execute_msg("") + SYNC,
    parse_msg(b"P", "sel", "SELECT id, i, f, t, b, n FROM kinds WHERE id >= $1 ORDER BY id",
              (20,))
    + describe_msg(b"S", "sel")
    + bind_msg("p1", "sel", [0], [b"1"], [1])
    + describe_msg(b"P", "p1") + execute_msg("p1") + SYNC,
    bind_msg("", "sel", [1], [I8(0)], [0, 1, 1, 0, 1, 0]) + execute_msg("", 1) + SYNC,
    parse_msg(b"P", "", "SELECT t.id, t.text, k.t FROM tests t LEFT JOIN kinds k"
              " ON k.id = t.id WHERE t.id <> $1 ORDER BY t.id")
    + bind_msg("", "", [], [b"5"], []) + describe_msg(b"P", "") + execute_msg("") + SYNC,
    parse_msg(b"P", "", "SELECT relname FROM pg_class WHERE relname = $1")
    + describe_msg(b"S", "") + bind_msg("", "", [], [b"tests"], [1])
    + execute_msg("") + SYNC,
    parse_msg(b"P", "bad", "SELECT nope FROM tests WHERE id = $1")
    + bind_msg("", "bad", [], [b"1"], []) + execute_msg("") + SYNC,
    # An error inside an extended-flow transaction, the aborted state, and
    # the rollback that ends it.
    QUERY("BEGIN"),
    parse_msg(b"P", "", "INSERT INTO tests (id, text) VALUES ($1, $2)")
    + bind_msg("", "", [], [b"6", b"six"], []) + execute_msg("") + SYNC,
    parse_msg(b"P", "", "INSERT INTO tests (nope) VALUES ($1)")
    + bind_msg("", "", [], [b"7"], []) + execute_msg("") + SYNC,
    parse_msg(b"P", "", "SELECT 1") + bind_msg("", "", [], [], []) + execute_msg("") + SYNC,
    QUERY("COMMIT"),
    _m(b"C", b"Sins\x00") + SYNC,
    _m(b"?", b""),
    QUERY("SELECT id, text FROM tests ORDER BY id; SELECT count(*) FROM kinds"),
)


async def _read_reply(reader) -> bytes:
    """Messages up to and including the next ReadyForQuery."""
    out, tag = b"", b""
    while tag != b"Z":
        header = await reader.readexactly(5)
        tag, (length,) = header[0:1], struct.unpack(">I", header[1:5])
        out += header + await reader.readexactly(length - 4)
    return out


async def _session(side: str, root) -> tuple[list[bytes], dict]:
    serve_pg = {"ref": jpg, "port": tpg}[side].serve_pg
    ta = await launch(side, root / side, schema=SCHEMA)
    server, (host, port) = await serve_pg(ta.agent)
    replies = []
    try:
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(SSL_REQUEST)
        await writer.drain()
        replies.append(await reader.readexactly(1))
        writer.write(_startup())
        await writer.drain()
        replies.append(await _read_reply(reader))
        for sent in SESSION:
            writer.write(sent)
            await writer.drain()
            replies.append(await _read_reply(reader))
        writer.write(_m(b"X", b""))
        await writer.drain()
        assert await reader.read() == b""
        writer.close()
        path = ta.agent.store.path
    finally:
        server.close()
        await server.wait_closed()
        await ta.stop()
    return replies, db_tables(path)


def test_pg_sessions_answer_byte_equal_to_the_reference(tmp_path, fixed_clock):
    ref, ref_db = asyncio.run(_session("ref", tmp_path))
    port, port_db = asyncio.run(_session("port", tmp_path))
    assert ref[0] == b"N"  # the SSLRequest is refused: the wire has no TLS
    for i, (got, want) in enumerate(zip(port, ref)):
        assert got == want, (i, got, want)
    assert len(port) == len(ref) == len(SESSION) + 2
    assert port_db == ref_db
    # The session reached what it meant to reach: errors in both flows,
    # the aborted-block refusal, binary rows and committed writes.
    joined = b"".join(ref)
    for code in (b"C42703\x00", b"C42P01\x00", b"C0A000\x00", b"C25P02\x00"):
        assert code in joined, code
    assert I8(2) + struct.pack(">i", 8) + I8(-9) in ref[2 + 18]  # binary int8 cells
    assert sorted(r[:2] for r in ref_db["tests"]) == [(1, "uno"), (2, "dos"), (4, "four"),
                                                      (5, "five")]
    assert [r[0] for r in sorted(ref_db["kinds"])] == [1, 2]

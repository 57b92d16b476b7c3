"""PostgreSQL wire-protocol server — the corro-pg analogue.

The reference serves the pgwire protocol, translating PG SQL to SQLite and
executing against the agent DB with full bookkeeping + broadcast parity
(corro-pg/src/lib.rs:474-1769). This implementation speaks protocol v3's
startup + simple-query flow (plus SSLRequest refusal and Terminate):
SELECTs run on the store's read connection; writes run through
Agent.execute so version allocation, bookkeeping, and dissemination are
identical to the HTTP path (the parity that matters, lib.rs write path).

Both protocol flows are served: the simple-query flow ('Q') and the
extended flow (Parse/Bind/Describe/Execute/Close/Sync/Flush — what libpq's
PQexecParams and most drivers send), with PG's ``$N`` placeholders
translated to SQLite ``?N``. Parameters and results support both wire
formats: text (psql's default rendering) and binary (format code 1) for
the core scalar types (int2/4/8, float4/8, bool, bytea, text). SQL
translation is token-level (agent/pgsql.py's lexer), mirroring corro-pg's
parse-before-rewrite approach.

Counterpart of corrosion_tpu/agent/pg.py.
"""

from __future__ import annotations

import asyncio
import logging
import re
import sqlite3
import struct
from typing import TYPE_CHECKING

from corrosion_tpu_torch.agent import pgsql
from corrosion_tpu_torch.core.values import Statement

if TYPE_CHECKING:
    from corrosion_tpu_torch.agent.agent import Agent

SSL_REQUEST = 80877103
PROTOCOL_V3 = 196608
TEXT_OID = 25
BOOL_OID = 16
BYTEA_OID = 17
INT2_OID, INT4_OID, INT8_OID = 21, 23, 20
FLOAT4_OID, FLOAT8_OID = 700, 701

# Parameter OIDs we coerce from text (ints/floats/bool); everything else
# stays a string and relies on SQLite column affinity.
_INT_OIDS = {20, 21, 23, 26}
_FLOAT_OIDS = {700, 701, 1700}
_BOOL_OID = BOOL_OID


# SQLSTATE mapping for SQLite error text (the role of corro-pg's
# sql_state.rs, 1336 LoC of codes; these are the ones SQLite can actually
# produce through this server).
_SQLSTATE_PATTERNS = [
    (re.compile(r"(?i)no such table"), "42P01"),  # undefined_table
    (re.compile(r"(?i)no such column"), "42703"),  # undefined_column
    (re.compile(r"(?i)syntax error"), "42601"),  # syntax_error
    (re.compile(r"(?i)ambiguous column"), "42702"),  # ambiguous_column
    (re.compile(r"(?i)UNIQUE constraint failed"), "23505"),  # unique_violation
    (re.compile(r"(?i)NOT NULL constraint failed"), "23502"),  # not_null
    (re.compile(r"(?i)CHECK constraint failed"), "23514"),  # check_violation
    (re.compile(r"(?i)FOREIGN KEY constraint failed"), "23503"),  # fk
    (re.compile(r"(?i)datatype mismatch"), "22P02"),  # invalid_text_rep
    (re.compile(r"(?i)attempt to write a readonly"), "25006"),  # read_only
    (re.compile(r"(?i)database is locked"), "55P03"),  # lock_not_available
    (re.compile(r"(?i)too many terms|parser stack overflow"), "54001"),
]


def sqlstate_for(message: str) -> str:
    """Best-fit SQLSTATE for an engine error message (sql_state.rs role)."""
    for pat, code in _SQLSTATE_PATTERNS:
        if pat.search(message):
            return code
    return "XX000"


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _error(message: str, code: str = "XX000") -> bytes:
    fields = b"S" + _cstr("ERROR") + b"C" + _cstr(code) + b"M" + _cstr(message) + b"\x00"
    return _msg(b"E", fields)


def _infer_oids(rows: list, n_cols: int) -> list[int]:
    """Column type oids from the first non-NULL value per column (SQLite is
    dynamically typed; drivers want real oids for type mapping)."""
    oids = [TEXT_OID] * n_cols
    for c in range(n_cols):
        for row in rows:
            v = row[c]
            if v is None:
                continue
            if isinstance(v, bool):
                oids[c] = BOOL_OID
            elif isinstance(v, int):
                oids[c] = INT8_OID
            elif isinstance(v, float):
                oids[c] = FLOAT8_OID
            elif isinstance(v, bytes):
                oids[c] = BYTEA_OID
            break
    return oids


def _row_description(
    cols: list[str], oids: list[int] | None = None,
    fmts: list[int] | None = None,
) -> bytes:
    body = struct.pack(">H", len(cols))
    for i, name in enumerate(cols):
        oid = oids[i] if oids else TEXT_OID
        fmt = fmts[i] if fmts else 0
        body += _cstr(name)
        body += struct.pack(">IhIhih", 0, 0, oid, -1, -1, fmt)
    return _msg(b"T", body)


def _encode_binary(v, oid: int) -> bytes:
    """Binary result encoding per oid (the formats real drivers request)."""
    if oid == INT8_OID and isinstance(v, int):
        return struct.pack(">q", v)
    if oid == INT4_OID and isinstance(v, int):
        return struct.pack(">i", v)
    if oid == INT2_OID and isinstance(v, int):
        return struct.pack(">h", v)
    if oid == FLOAT8_OID and isinstance(v, (int, float)):
        return struct.pack(">d", float(v))
    if oid == FLOAT4_OID and isinstance(v, (int, float)):
        return struct.pack(">f", float(v))
    if oid == BOOL_OID:
        return b"\x01" if v else b"\x00"
    if isinstance(v, bytes):
        return v  # bytea binary = raw bytes
    # text/varchar binary representation == utf-8 text
    return str(v).encode()


def _text_cell(v) -> bytes:
    if isinstance(v, bytes):
        return ("\\x" + v.hex()).encode()
    if isinstance(v, bool):
        return b"t" if v else b"f"
    return str(v).encode()


def _data_row(
    row, rfmts: list[int] | None = None, oids: list[int] | None = None
) -> bytes:
    body = struct.pack(">H", len(row))
    for i, v in enumerate(row):
        if v is None:
            body += struct.pack(">i", -1)
            continue
        fmt = rfmts[i] if rfmts else 0
        if fmt == 1:
            raw = _encode_binary(v, oids[i] if oids else TEXT_OID)
        else:
            raw = _text_cell(v)
        body += struct.pack(">i", len(raw)) + raw
    return body and _msg(b"D", body)


def _command_complete(tag: str) -> bytes:
    return _msg(b"C", _cstr(tag))


def _ready(status: bytes = b"I") -> bytes:
    return _msg(b"Z", status)


def _write_verb_tokens(sql: str) -> list:
    """Write keywords appearing as real statement verbs: identifier
    tokens (never inside strings/comments) whose next significant token
    is NOT ``(`` — ``replace(x, 'a', 'b')`` is the SQL function, not the
    REPLACE statement, and must not drag a read-only query onto the
    write path (it bypasses the read pool AND mislabels the
    CommandComplete tag)."""
    toks = pgsql.tokenize(sql)
    verbs = []
    for i, t in enumerate(toks):
        if t.kind != "ident" or t.text.lower() not in (
            "insert", "update", "delete", "replace"
        ):
            continue
        j = pgsql._sig(toks, i, 1)
        if j >= 0 and toks[j].text == "(":
            continue  # function-call form, e.g. replace(col, 'a', 'b')
        verbs.append(t)
    return verbs


def _contains_write_tokens(sql: str) -> bool:
    """Any write keyword as a real statement verb (not inside strings/
    comments, not a function call) — the shape check for CTEs feeding
    writes (WITH ... INSERT ...), which a head-word test misroutes to
    the read pool, bypassing version assignment."""
    return bool(_write_verb_tokens(sql))


def _is_query(sql: str) -> bool:
    head = sql.lstrip().split(None, 1)
    word = head[0].upper() if head else ""
    if word == "WITH":
        return not _contains_write_tokens(sql)
    return word in ("SELECT", "EXPLAIN", "PRAGMA", "VALUES", "SHOW")


# Explicit-transaction control + features the server deliberately does
# not speak (corro-pg supports txns, lib.rs:518-720; COPY/LISTEN have no
# analogue here and must fail with a clean SQLSTATE instead of a parse
# error deep in SQLite).
_TXN_BEGIN = ("BEGIN", "START")
_TXN_COMMIT = ("COMMIT", "END")
_TXN_ROLLBACK = ("ROLLBACK", "ABORT")
_UNSUPPORTED_WORDS = {
    "COPY": "COPY is not supported",
    "LISTEN": "LISTEN/NOTIFY is not supported",
    "UNLISTEN": "LISTEN/NOTIFY is not supported",
    "NOTIFY": "LISTEN/NOTIFY is not supported",
    "DECLARE": "server-side cursors are not supported",
    "FETCH": "server-side cursors are not supported",
    "MOVE": "server-side cursors are not supported",
}


class _Txn:
    """Per-connection explicit-transaction state.

    Statements inside BEGIN..COMMIT queue up (validated with EXPLAIN at
    queue time) and apply ATOMICALLY through one agent batch at COMMIT —
    the agent's multi-statement execute is transactional end-to-end.
    Divergences from a held server-side txn, documented: reads inside
    the block see the pre-transaction snapshot (not own writes), and
    runtime constraint violations surface at COMMIT rather than at the
    offending statement. After any in-block error the connection enters
    the failed state: every statement until ROLLBACK/COMMIT gets
    SQLSTATE 25P02, and COMMIT of a failed block reports ROLLBACK —
    exactly libpq's recovery flow."""

    def __init__(self) -> None:
        self.mode = "idle"  # idle | txn | failed
        self.queue: list[Statement] = []
        self.has_ddl = False  # queued DDL: later EXPLAIN probes can't see it

    @property
    def status(self) -> bytes:
        return {"idle": b"I", "txn": b"T", "failed": b"E"}[self.mode]

    def begin(self) -> None:
        self.mode = "txn"
        self.queue = []
        self.has_ddl = False

    def reset(self) -> None:
        self.mode = "idle"
        self.queue = []
        self.has_ddl = False

    def fail(self) -> None:
        if self.mode == "txn":
            self.mode = "failed"


_ABORTED_MSG = (
    "current transaction is aborted, commands ignored until end of "
    "transaction block"
)


def translate_pg_sql(sql: str) -> str:
    """PG->SQLite surface translation (corro-pg's parse_query,
    lib.rs:306-472 via sqlparser). Token-level — see agent/pgsql.py for
    the lexer: strings, comments, dollar-quotes, and identifiers are
    single tokens, so nothing inside them can be rewritten."""
    return pgsql.translate(sql)


def _mentions_catalog(sql: str) -> bool:
    return pgsql.mentions_catalog(sql)


# -- pg_catalog (the reference's vtabs: corro-pg/src/vtab/{pg_type 405,
# pg_class 113, pg_namespace 108, pg_database 166, pg_range} LoC) ----------

# (oid, typname, typlen): the types the wire layer speaks.
_PG_TYPES = [
    (16, "bool", 1), (17, "bytea", -1), (20, "int8", 8), (21, "int2", 2),
    (23, "int4", 4), (25, "text", -1), (700, "float4", 4),
    (701, "float8", 8), (1043, "varchar", -1), (1700, "numeric", -1),
]
_NS_CATALOG, _NS_PUBLIC = 11, 2200
_FIRST_REL_OID = 16384


def catalog_conn(agent: "Agent") -> sqlite3.Connection:
    """A pg_catalog snapshot derived from the live schema, built as TEMP
    tables on a fresh read connection to the real database — so catalog
    queries can also join user tables, like the reference's virtual tables
    (which live on every connection).

    Per-query construction keeps it automatically in sync with migrations;
    introspection traffic (psql \\d, ORM table listing at connect) is rare
    enough that rebuild cost is irrelevant.
    """
    c = sqlite3.connect(agent.store.path)
    c.executescript(
        """
        CREATE TEMP TABLE pg_type (oid INT, typname TEXT, typlen INT,
          typtype TEXT, typnamespace INT);
        CREATE TEMP TABLE pg_namespace (oid INT, nspname TEXT);
        CREATE TEMP TABLE pg_database (oid INT, datname TEXT);
        CREATE TEMP TABLE pg_class (oid INT, relname TEXT, relnamespace INT,
          relkind TEXT);
        CREATE TEMP TABLE pg_attribute (attrelid INT, attname TEXT,
          atttypid INT, attnum INT, attnotnull INT, attisdropped INT);
        CREATE TEMP TABLE pg_range (rngtypid INT, rngsubtype INT);
        CREATE TEMP TABLE pg_tables (schemaname TEXT, tablename TEXT);
        """
    )
    c.executemany(
        "INSERT INTO pg_type VALUES (?, ?, ?, 'b', ?)",
        [(o, n, l, _NS_CATALOG) for o, n, l in _PG_TYPES],
    )
    c.executemany(
        "INSERT INTO pg_namespace VALUES (?, ?)",
        [(_NS_CATALOG, "pg_catalog"), (_NS_PUBLIC, "public")],
    )
    c.execute("INSERT INTO pg_database VALUES (1, 'corrosion')")
    oid = _FIRST_REL_OID
    for name, info in sorted(agent.store.tables().items()):
        c.execute(
            "INSERT INTO pg_class VALUES (?, ?, ?, 'r')",
            (oid, name, _NS_PUBLIC),
        )
        c.execute("INSERT INTO pg_tables VALUES ('public', ?)", (name,))
        decl = {
            row[1]: (row[2] or "") for row in c.execute(
                f'PRAGMA table_info("{name}")'
            )
        }
        for attnum, col in enumerate(
            [*info.pk_cols, *info.data_cols], start=1
        ):
            c.execute(
                "INSERT INTO pg_attribute VALUES (?, ?, ?, ?, ?, 0)",
                (oid, col, _affinity_oid(decl.get(col, "")), attnum,
                 int(col in info.pk_cols)),
            )
        oid += 1
    return c


def _affinity_oid(decl_type: str) -> int:
    """SQLite declared type → pg_type oid, by SQLite's affinity rules."""
    t = decl_type.upper()
    if "INT" in t:
        return 20  # int8
    if "CHAR" in t or "CLOB" in t or "TEXT" in t:
        return 25
    if "BLOB" in t or not t:
        return 17
    if "REAL" in t or "FLOA" in t or "DOUB" in t:
        return 701
    return 1700  # NUMERIC affinity


async def _run_query(
    agent: "Agent", sql: str, params: list | None = None
) -> tuple[list[str], list]:
    """Route a read: queries touching pg_catalog names (outside string
    literals) go to the catalog-snapshot connection — which also sees the
    user tables — everything else to the agent's read pool."""
    if _mentions_catalog(sql):
        def run():
            c = catalog_conn(agent)
            try:
                cur = c.execute(
                    pgsql.strip_catalog_prefix(sql),
                    tuple(params or ()),
                )
                cols = (
                    [d[0] for d in cur.description] if cur.description else []
                )
                return cols, cur.fetchall()
            finally:
                c.close()

        return await asyncio.to_thread(run)
    return await agent.pool.query(Statement(sql, params=params))


def translate_placeholders(sql: str) -> str:
    """PG ``$N`` → SQLite ``?N``, outside string/identifier literals and
    comments (token-level, agent/pgsql.py)."""
    return pgsql.translate_placeholders(sql)


class _Prepared:
    def __init__(self, sql: str, param_oids: list[int]):
        self.raw = sql
        self.translated = translate_pg_sql(translate_placeholders(sql))
        self.param_oids = param_oids


class _Portal:
    def __init__(
        self, prepared: _Prepared, params: list,
        rfmts: list[int] | None = None,
    ):
        self.prepared = prepared
        self.params = params
        self.rfmts = rfmts or []
        self.described: tuple[list[str], list[tuple]] | None = None

    def col_fmts(self, n_cols: int) -> list[int]:
        """Expand Bind's result-format list per protocol: empty = all text,
        one entry = applies to every column, else per column."""
        if not self.rfmts:
            return [0] * n_cols
        if len(self.rfmts) == 1:
            return [self.rfmts[0]] * n_cols
        return (self.rfmts + [0] * n_cols)[:n_cols]


class _PgError(Exception):
    def __init__(self, message: str, code: str = "XX000"):
        super().__init__(message)
        self.code = code


async def serve_pg(agent: "Agent", host: str = "127.0.0.1", port: int = 0):
    async def on_conn(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        prepared: dict[str, _Prepared] = {}
        portals: dict[str, _Portal] = {}
        txn = _Txn()
        in_error = False  # extended-protocol error state: skip until Sync
        try:
            await _handshake(reader, writer)
            writer.write(_msg(b"R", struct.pack(">I", 0)))  # AuthenticationOk
            for k, v in (
                ("server_version", "14.0 (corrosion-tpu)"),
                ("server_encoding", "UTF8"),
                ("client_encoding", "UTF8"),
            ):
                writer.write(_msg(b"S", _cstr(k) + _cstr(v)))
            writer.write(_msg(b"K", struct.pack(">II", 1, 0)))  # BackendKeyData
            writer.write(_ready())
            await writer.drain()
            while True:
                header = await reader.readexactly(5)
                tag, length = header[0:1], struct.unpack(">I", header[1:5])[0]
                payload = await reader.readexactly(length - 4)
                if tag == b"X":
                    break
                if tag == b"Q":
                    in_error = False
                    await _simple_query(
                        agent, writer, payload[:-1].decode(), txn
                    )
                elif tag == b"S":  # Sync: end of extended batch
                    in_error = False
                    portals.clear()
                    writer.write(_ready(txn.status))
                elif tag == b"H":  # Flush
                    pass
                elif in_error:
                    pass  # discard until Sync (protocol error recovery)
                elif tag in (b"P", b"B", b"D", b"E", b"C"):
                    try:
                        await _extended(
                            agent, writer, tag, payload, prepared,
                            portals, txn,
                        )
                    except _PgError as e:
                        txn.fail()
                        writer.write(_error(str(e), e.code))
                        in_error = True
                    except Exception as e:
                        txn.fail()
                        writer.write(_error(str(e), sqlstate_for(str(e))))
                        in_error = True
                else:
                    writer.write(
                        _error(f"unsupported message {tag!r}", "0A000")
                    )
                    writer.write(_ready(txn.status))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(on_conn, host, port)
    sock = server.sockets[0].getsockname()
    return server, (sock[0], sock[1])


def _read_cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode(), end + 1


async def _extended(
    agent: "Agent", writer, tag: bytes, payload: bytes,
    prepared: dict[str, _Prepared], portals: dict[str, _Portal],
    txn: _Txn,
) -> None:
    """One extended-protocol message (the pgwire flows of corro-pg's
    on_query/on_describe handlers, lib.rs:474-1769)."""
    if txn.mode == "failed" and tag in (b"P", b"B", b"D"):
        # An aborted transaction refuses Parse/Bind/Describe outright
        # (real PostgreSQL performs no query work in this state;
        # Describe(portal) here would otherwise execute the query).
        raise _PgError(_ABORTED_MSG, "25P02")
    if tag == b"P":  # Parse: name, query, param oids
        name, off = _read_cstr(payload, 0)
        query, off = _read_cstr(payload, off)
        (n_oids,) = struct.unpack_from(">H", payload, off)
        off += 2
        oids = [
            struct.unpack_from(">I", payload, off + 4 * i)[0]
            for i in range(n_oids)
        ]
        prepared[name] = _Prepared(query, oids)
        writer.write(_msg(b"1", b""))  # ParseComplete
        return

    if tag == b"B":  # Bind: portal, stmt, formats, params, result formats
        portal_name, off = _read_cstr(payload, 0)
        stmt_name, off = _read_cstr(payload, off)
        stmt = prepared.get(stmt_name)
        if stmt is None:
            raise _PgError(f"unknown prepared statement {stmt_name!r}", "26000")
        (n_fmt,) = struct.unpack_from(">H", payload, off)
        off += 2
        fmts = [
            struct.unpack_from(">H", payload, off + 2 * i)[0]
            for i in range(n_fmt)
        ]
        off += 2 * n_fmt
        (n_params,) = struct.unpack_from(">H", payload, off)
        off += 2
        params: list = []
        for i in range(n_params):
            (plen,) = struct.unpack_from(">i", payload, off)
            off += 4
            if plen < 0:
                params.append(None)
                continue
            raw = payload[off : off + plen]
            off += plen
            fmt = fmts[i] if i < len(fmts) else (fmts[0] if len(fmts) == 1 else 0)
            oid = stmt.param_oids[i] if i < len(stmt.param_oids) else 0
            if fmt != 0:
                params.append(_decode_binary_param(raw, oid))
            else:
                params.append(_coerce_param(raw.decode(), oid))
        (n_rfmt,) = struct.unpack_from(">H", payload, off)
        off += 2
        rfmts = [
            struct.unpack_from(">H", payload, off + 2 * i)[0]
            for i in range(n_rfmt)
        ]
        portals[portal_name] = _Portal(stmt, params, rfmts)
        writer.write(_msg(b"2", b""))  # BindComplete
        return

    if tag == b"D":  # Describe: 'S' statement | 'P' portal
        kind, name = payload[0:1], _read_cstr(payload, 1)[0]
        if kind == b"S":
            stmt = prepared.get(name)
            if stmt is None:
                raise _PgError(f"unknown prepared statement {name!r}", "26000")
            body = struct.pack(">H", len(stmt.param_oids))
            for oid in stmt.param_oids:
                body += struct.pack(">I", oid or TEXT_OID)
            writer.write(_msg(b"t", body))  # ParameterDescription
            # Off-loop: the probe may build a catalog snapshot (fresh
            # connection + temp tables) — not event-loop work.
            cols = await asyncio.to_thread(_try_describe, agent, stmt)
            writer.write(_row_description(cols) if cols else _msg(b"n", b""))
            return
        portal = portals.get(name)
        if portal is None:
            raise _PgError(f"unknown portal {name!r}", "34000")
        if _is_query(portal.prepared.translated):
            cols, rows = await _run_query(
                agent, portal.prepared.translated, portal.params
            )
            portal.described = (cols, rows)
            writer.write(
                _row_description(
                    cols, _infer_oids(rows, len(cols)),
                    portal.col_fmts(len(cols)),
                )
            )
        else:
            writer.write(_msg(b"n", b""))  # NoData
        return

    if tag == b"E":  # Execute: portal, max rows (portal suspension unsupported)
        name, off = _read_cstr(payload, 0)
        portal = portals.get(name)
        if portal is None:
            raise _PgError(f"unknown portal {name!r}", "34000")
        raw_word = _head_word(portal.prepared.raw)
        if txn.mode == "failed" and raw_word not in (
            *_TXN_COMMIT, *_TXN_ROLLBACK
        ):
            raise _PgError(_ABORTED_MSG, "25P02")
        if raw_word in _UNSUPPORTED_WORDS:
            raise _PgError(_UNSUPPORTED_WORDS[raw_word], "0A000")
        if raw_word in (*_TXN_BEGIN, *_TXN_COMMIT, *_TXN_ROLLBACK):
            await _txn_control(agent, writer, raw_word, txn)
            return
        sql = portal.prepared.translated
        if not sql:
            writer.write(_command_complete("SET"))
            return
        if txn.mode == "txn" and not _is_query(sql):
            writer.write(_command_complete(
                _queue_deferred_write(agent, txn, sql, portal.params)
            ))
            return
        if _is_query(sql):
            if portal.described is not None:
                cols, rows = portal.described
            else:
                cols, rows = await _run_query(agent, sql, portal.params)
            oids = _infer_oids(rows, len(cols))
            fmts = portal.col_fmts(len(cols))
            for row in rows:
                writer.write(_data_row(row, fmts, oids))
            writer.write(_command_complete(f"SELECT {len(rows)}"))
        else:
            resp = await agent.execute_async(
                [Statement(sql, params=portal.params)]
            )
            bad = [r for r in resp.results if r.error]
            if bad:
                raise _PgError(bad[0].error, sqlstate_for(bad[0].error))
            n = sum(r.rows_affected or 0 for r in resp.results)
            writer.write(
                _command_complete(_command_tag(_dml_word(sql), n, sql))
            )
        return

    if tag == b"C":  # Close statement/portal
        kind, name = payload[0:1], _read_cstr(payload, 1)[0]
        (prepared if kind == b"S" else portals).pop(name, None)
        writer.write(_msg(b"3", b""))  # CloseComplete
        return


def _decode_binary_param(raw: bytes, oid: int):
    """Binary Bind parameter decode (the formats drivers actually send:
    PQexecParams with paramFormats=1, psycopg binary adapters)."""
    try:
        if oid == INT2_OID:
            return struct.unpack(">h", raw)[0]
        if oid == INT4_OID or oid == 26:  # oid type rides int4's format
            return struct.unpack(">i", raw)[0]
        if oid == INT8_OID:
            return struct.unpack(">q", raw)[0]
        if oid == FLOAT4_OID:
            return struct.unpack(">f", raw)[0]
        if oid == FLOAT8_OID:
            return struct.unpack(">d", raw)[0]
        if oid == BOOL_OID:
            return raw != b"\x00"
        if oid == BYTEA_OID or oid == 0:
            return raw
    except struct.error as e:
        raise _PgError(
            f"invalid binary parameter for oid {oid}", "22P03"
        ) from e
    try:
        return raw.decode()  # text-family binary repr == utf-8 text
    except UnicodeDecodeError:
        return raw


def _coerce_param(text: str, oid: int):
    try:
        if oid in _INT_OIDS:
            return int(text)
        if oid in _FLOAT_OIDS:
            return float(text)
        if oid == _BOOL_OID:
            return text in ("t", "true", "1", "on", "y", "yes")
    except ValueError:
        pass
    return text


def _try_describe(agent: "Agent", stmt: _Prepared) -> list[str] | None:
    """Result columns for Describe(statement): probe with a LIMIT-0 wrapper
    and NULL params; None (→ NoData) when the probe cannot run."""
    if not _is_query(stmt.translated):
        return None
    n_params = max(
        (int(m) for m in re.findall(r"\?(\d+)", stmt.translated)), default=0
    )
    try:
        if _mentions_catalog(stmt.translated):
            c = catalog_conn(agent)
            try:
                cur = c.execute(
                    "SELECT * FROM ("
                    + pgsql.strip_catalog_prefix(stmt.translated)
                    + ") LIMIT 0",
                    tuple([None] * n_params),
                )
                return (
                    [d[0] for d in cur.description]
                    if cur.description else None
                )
            finally:
                c.close()
        # Fresh connection: this probe runs in a to_thread worker, and the
        # store's shared read_conn belongs to the event loop. query_only
        # makes the probe structurally incapable of executing a write
        # smuggled through a shape the lexer missed.
        c = sqlite3.connect(agent.store.path)
        c.execute("PRAGMA query_only=1")
        try:
            cur = c.execute(
                f"SELECT * FROM ({stmt.translated}) LIMIT 0",
                tuple([None] * n_params),
            )
            return [d[0] for d in cur.description] if cur.description else None
        finally:
            c.close()
    except Exception:
        # NoData is the protocol fallback; keep a debug trail so a broken
        # probe doesn't silently degrade every prepared query.
        logging.getLogger(__name__).debug(
            "describe probe failed", exc_info=True
        )
        return None


async def _handshake(reader, writer) -> None:
    while True:
        (length,) = struct.unpack(">I", await reader.readexactly(4))
        payload = await reader.readexactly(length - 4)
        (code,) = struct.unpack(">I", payload[:4])
        if code == SSL_REQUEST:
            writer.write(b"N")  # no TLS
            await writer.drain()
            continue
        if code != PROTOCOL_V3:
            raise ConnectionError(f"unsupported protocol {code}")
        return


def _split_statements(sql: str) -> list[str]:
    """Split on top-level semicolons only — token-aware (';' inside
    strings, quoted identifiers, comments, and dollar-quoted blocks never
    splits)."""
    return pgsql.split_statements(sql)


def _head_word(sql: str) -> str:
    head = sql.lstrip().split(None, 1)
    return head[0].upper().rstrip(";") if head else ""


def _nominal_insert_count(sql: str) -> int:
    """Rows a queued `INSERT ... VALUES (...), (...)` will insert — the
    CommandComplete tag for deferred in-transaction writes. Shapes whose
    count depends on data (INSERT .. SELECT) report 0 ("unknown") rather
    than asserting a false exact count."""
    toks = pgsql.tokenize(sql)
    depth = 0
    groups = 0
    seen_values = False
    for t in toks:
        if t.kind == "ident" and t.text.lower() == "values" and depth == 0:
            seen_values = True
        elif t.text == "(":
            if depth == 0 and seen_values:
                groups += 1
            depth += 1
        elif t.text == ")":
            depth -= 1
    return groups


def _dml_word(sql: str) -> str:
    """The top-level DML verb for the CommandComplete tag: a WITH-headed
    write reports its underlying INSERT/UPDATE/DELETE like PostgreSQL.
    Function-call uses of the verb words (``replace(...)`` inside a CTE
    body) are skipped, so the tag names the real top-level verb."""
    word = sql.split(None, 1)[0].upper() if sql.split(None, 1) else ""
    if word != "WITH":
        return word
    for t in _write_verb_tokens(sql):
        return t.text.upper()
    return word


def _command_tag(word: str, n: int, sql: str = "") -> str:
    if word in ("CREATE", "DROP", "ALTER"):
        # DDL tags carry the object kind, never a count ("CREATE TABLE").
        parts = sql.split(None, 2)
        kind = parts[1].upper() if len(parts) > 1 else "TABLE"
        return f"{word} {kind}"
    return f"INSERT 0 {n}" if word == "INSERT" else f"{word} {n}"


def _queue_deferred_write(
    agent: "Agent", txn: _Txn, sql: str, params=None
) -> str:
    """Validate (when the schema is still probeable) + queue a write for
    the COMMIT batch; returns the CommandComplete tag."""
    word = _dml_word(sql)
    head = sql.split(None, 1)[0].upper() if sql.split(None, 1) else ""
    is_ddl = head in ("CREATE", "ALTER", "DROP")
    if not txn.has_ddl:
        # EXPLAIN sees the pre-transaction schema: once the block queued
        # DDL, later statements may legitimately reference it — defer
        # ALL their errors to COMMIT instead of spuriously failing the
        # standard migration pattern (CREATE TABLE; INSERT INTO it).
        _validate_statement(agent, sql)
    if is_ddl:
        txn.has_ddl = True
    txn.queue.append(Statement(sql, params=params))
    n = _nominal_insert_count(sql) if word == "INSERT" else 0
    return _command_tag(word, n, sql)


async def _txn_control(
    agent: "Agent", writer, word: str, txn: _Txn
) -> None:
    if word in _TXN_BEGIN:
        if txn.mode == "idle":
            txn.begin()
        writer.write(_command_complete("BEGIN"))
        return
    if word in _TXN_ROLLBACK:
        txn.reset()
        writer.write(_command_complete("ROLLBACK"))
        return
    # COMMIT/END: a failed block rolls back (libpq's recovery flow).
    if txn.mode == "failed":
        txn.reset()
        writer.write(_command_complete("ROLLBACK"))
        return
    queued, txn.queue = txn.queue, []
    txn.mode = "idle"
    if queued:
        resp = await agent.execute_async(queued)
        err = next((r.error for r in resp.results if r.error), None)
        if err:
            raise _PgError(err, sqlstate_for(err))
    writer.write(_command_complete("COMMIT"))


async def _one_statement(
    agent: "Agent", writer, part: str, txn: _Txn
) -> None:
    """Execute one statement under the connection's transaction state.
    Raises _PgError on failure (caller marks the txn failed)."""
    word = _head_word(part)
    if txn.mode == "failed" and word not in (
        *_TXN_COMMIT, *_TXN_ROLLBACK
    ):
        raise _PgError(_ABORTED_MSG, "25P02")
    if word in _UNSUPPORTED_WORDS:
        raise _PgError(_UNSUPPORTED_WORDS[word], "0A000")
    if word in (*_TXN_BEGIN, *_TXN_COMMIT, *_TXN_ROLLBACK):
        await _txn_control(agent, writer, word, txn)
        return
    translated = translate_pg_sql(part)
    if not translated:
        writer.write(_command_complete("SET"))
        return
    if _is_query(translated):
        cols, rows = await _run_query(agent, translated)
        writer.write(_row_description(cols, _infer_oids(rows, len(cols))))
        for row in rows:
            writer.write(_data_row(row))
        writer.write(_command_complete(f"SELECT {len(rows)}"))
        return
    if txn.mode == "txn":
        # Deferred write: prepare-time errors fail the block at the
        # offending statement; application is atomic at COMMIT.
        writer.write(_command_complete(
            _queue_deferred_write(agent, txn, translated)
        ))
        return
    resp = await agent.execute_async([Statement(translated)])
    err = next((r.error for r in resp.results if r.error), None)
    if err:
        raise _PgError(err, sqlstate_for(err))
    n = sum(r.rows_affected for r in resp.results)
    writer.write(
        _command_complete(_command_tag(_dml_word(translated), n, translated))
    )


def _validate_statement(agent: "Agent", sql: str) -> None:
    """Prepare (EXPLAIN) without executing: syntax + schema errors
    surface at queue time; runtime constraint violations defer to
    COMMIT (documented divergence of the deferred-batch txn)."""
    import sqlite3 as _sq

    try:
        agent.store.read_conn.execute(f"EXPLAIN {sql}")
    except _sq.Error as e:
        raise _PgError(str(e), sqlstate_for(str(e)))


async def _simple_query(
    agent: "Agent", writer, sql: str, txn: _Txn
) -> None:
    for part in _split_statements(sql):
        try:
            await _one_statement(agent, writer, part, txn)
        except _PgError as e:
            txn.fail()
            writer.write(_error(str(e), e.code))
            break
        except Exception as e:
            txn.fail()
            writer.write(_error(str(e), sqlstate_for(str(e))))
            break
    writer.write(_ready(txn.status))

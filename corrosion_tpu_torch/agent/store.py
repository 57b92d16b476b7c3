"""CRDT SQLite store — the host-side replacement for cr-sqlite's C engine.

The reference vendors cr-sqlite as a prebuilt C extension
(corro-types/src/sqlite.rs:20-26) providing per-table clock tables, the
`crsql_changes` virtual table, and LWW + causal-length merge
(doc/crdts.md:11-28). This module implements the same replication contract
natively over stock SQLite:

- ``apply_schema`` marks user tables as CRRs: a ``{t}__crdt_rows`` causal-
  length table, a ``{t}__crdt_clock`` per-cell version table, and AFTER
  INSERT/UPDATE/DELETE triggers that record every local cell write into the
  ``__crdt_changes`` log (the `crsql_changes` analogue) with
  (col_version, db_version, seq, site_id, cl).
- ``execute_transaction`` wraps user statements with db_version/seq
  allocation, mirroring the write path of api_v1_transactions
  (corro-agent/src/api/public/mod.rs:33-142: crsql_next_db_version, MAX(seq),
  read-back of the changeset).
- ``apply_changes`` merges remote changes with exact cr-sqlite precedence:
  causal length first (bigger cl wins; even = deleted), then col_version,
  then value order (`value_cmp_key` — "biggest value wins",
  doc/crdts.md:15-16). Equivalent to `INSERT INTO crsql_changes` per change
  (agent.rs:2192-2214) and returns the applied count
  (`crsql_rows_impacted`, agent.rs:2215-2231).

The merge math itself also exists as the simulator's batched merge
(ops/crdt.py, and ops/gossip.py ``_merge_versions_dense`` on the card's
``rowmax``/``rowgather`` kernels); this store materializes per-node state
for the product surface (queries, subscriptions) and is the host oracle
those merges are held to (sim/host_oracles.py). The CRDT SQL helpers are
the port's own ``build/native/crdt_ext.so`` (``native.py``). Counterpart of
corrosion_tpu/agent/store.py.
"""

from __future__ import annotations

import sqlite3
import threading
from dataclasses import dataclass

from corrosion_tpu_torch import native
from corrosion_tpu_torch.core.intervals import RangeSet
from corrosion_tpu_torch.core.values import (
    Change,
    Statement,
    ExecResult,
    SqliteValue,
    pack_columns,
    unpack_columns,
    value_le,
)


class StoreError(Exception):
    pass


class SchemaError(StoreError):
    pass


INTERNAL_PREFIXES = ("__corro_", "__crdt_", "sqlite_")


@dataclass(frozen=True)
class TableInfo:
    name: str
    pk_cols: tuple[str, ...]
    data_cols: tuple[str, ...]
    create_sql: str


def _q(ident: str) -> str:
    """Quote an SQL identifier."""
    return '"' + ident.replace('"', '""') + '"'


def _qs(text: str) -> str:
    """Escape a string for single-quoted SQL literal position."""
    return text.replace("'", "''")


def _info_from_meta(
    name: str, meta: dict[str, tuple], create_sql: str
) -> TableInfo:
    rows = sorted(meta.values(), key=lambda r: r[0])
    pk = tuple(r[1] for r in sorted(rows, key=lambda r: r[5]) if r[5] > 0)
    data = tuple(r[1] for r in rows if r[5] == 0)
    if not pk:
        raise SchemaError(
            f"table {name} has no primary key — every CRR needs one "
            "(schema.rs requires non-null PKs)"
        )
    return TableInfo(name=name, pk_cols=pk, data_cols=data, create_sql=create_sql)


class Store:
    """One node's materialized database + CRDT change tracking.

    Thread-safety: a single writer lock serializes write transactions over
    the write connection (the SplitPool's one-writer discipline,
    corro-types/src/agent.rs:353-547); reads run on a separate connection so
    WAL gives them a committed snapshot, never a writer's in-flight state.
    """

    def __init__(self, path: str, site_id: bytes) -> None:
        if len(site_id) != 16:
            raise StoreError("site_id must be 16 bytes")
        self.path = path
        self.site_id = site_id
        self._write_lock = threading.Lock()
        self.lock_registry = None  # optional utils.locks.LockRegistry
        self._retired_read_conns: list[sqlite3.Connection] = []
        self._open_connections()
        self._tables: dict[str, TableInfo] = {}
        self._migrate()
        # Adopt the PERSISTED identity: on a pre-existing database the
        # INSERT OR IGNORE in _migrate keeps the original site_id, and the
        # triggers stamp changes with the meta row — a restarted node must
        # read its own local writes back with that id, not the fresh one
        # the caller passed (ActorId = crsql_site_id(), agent.rs:115-120).
        self._adopt_persisted_site_id()
        self._load_schema()

    def _open_connections(self) -> None:
        self.conn = sqlite3.connect(self.path, check_same_thread=False)
        # Explicit transaction control (BEGIN IMMEDIATE below); the library's
        # implicit-transaction mode would fight it.
        self.conn.isolation_level = None
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        # setup_conn pragmas (corro-types/src/sqlite.rs:107-118)
        self.conn.create_function("corro_pack", -1, _sql_pack, deterministic=True)
        # Native CRDT helpers (crdt_value_cmp, …) — the cr-sqlite loading
        # seam (init_cr_conn, corro-types/src/sqlite.rs:87-105). When the
        # built extension is absent the pure-Python merge path is used.
        self.native_crdt = native.load_crdt_extension(self.conn)
        # Dedicated read connection (the read pool's role): WAL snapshot
        # isolation from in-flight write transactions.
        self.read_conn = self.open_read_connection()

    def open_read_connection(self) -> sqlite3.Connection:
        """A fresh snapshot-read connection with the store's SQL surface
        (corro_pack + native CRDT helpers) registered — for worker threads
        that must not share the event loop's connections."""
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.isolation_level = None
        conn.create_function(
            "corro_pack", -1, _sql_pack, deterministic=True
        )
        native.load_crdt_extension(conn)
        return conn

    def _adopt_persisted_site_id(self) -> None:
        (db_site,) = self.conn.execute(
            "SELECT value FROM __corro_meta WHERE key='site_id'"
        ).fetchone()
        self.site_id = bytes(db_site)

    def reload_after_restore(self) -> None:
        """Re-adopt identity + schema after an online restore swapped the
        database content (sqlite3-restore's seam). SQLite page caches do
        not track external same-inode rewrites in WAL mode, so the store's
        own connections are reopened. The old READ connection is retired,
        not closed: event-loop code (subscription evaluation, pg describe)
        may be mid-query on it from another thread, and closing a live
        connection under a cursor raises in the reader — the retired
        handle drains naturally and is closed with the store."""
        with self._wlock("reload_after_restore"):
            self.conn.close()
            self._retired_read_conns.append(self.read_conn)
            self._open_connections()
            self._adopt_persisted_site_id()
            self._tables = {}
            self._load_schema()

    def close(self) -> None:
        self.conn.close()
        self.read_conn.close()
        for c in self._retired_read_conns:
            try:
                c.close()
            except Exception:
                pass
        self._retired_read_conns.clear()

    def _wlock(self, label: str):
        """Writer lock, registered for lock diagnostics when a registry is
        attached (CountedTokioRwLock's role, corro-types/agent.rs:593-650)."""
        if self.lock_registry is not None:
            return self.lock_registry.acquire(self._write_lock, label)
        return self._write_lock

    # -- internal tables (migrate framework, sqlite.rs:120-168) -------------

    def _migrate(self) -> None:
        c = self.conn
        with self._wlock("migrate"):
            c.execute(
                "CREATE TABLE IF NOT EXISTS __corro_meta "
                "(key TEXT PRIMARY KEY, value) WITHOUT ROWID"
            )
            for k, v in (
                ("db_version", 0),
                ("seq", -1),
                ("apply_remote", 0),
            ):
                c.execute(
                    "INSERT OR IGNORE INTO __corro_meta VALUES (?, ?)", (k, v)
                )
            c.execute(
                "INSERT OR IGNORE INTO __corro_meta VALUES ('site_id', ?)",
                (self.site_id,),
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS __crdt_changes ("
                " tbl TEXT NOT NULL, pk BLOB NOT NULL, cid TEXT NOT NULL,"
                " val, col_version INTEGER NOT NULL,"
                " db_version INTEGER NOT NULL, seq INTEGER NOT NULL,"
                " site_id BLOB NOT NULL, cl INTEGER NOT NULL)"
            )
            # Upgrade path: an earlier schema created this index non-unique;
            # IF NOT EXISTS would silently keep it and break the
            # INSERT OR REPLACE dedup in _log_change.
            idx_sql = c.execute(
                "SELECT sql FROM sqlite_master WHERE type='index'"
                " AND name='__crdt_changes_site_dbv'"
            ).fetchone()
            if idx_sql is not None and "UNIQUE" not in (idx_sql[0] or ""):
                c.execute(
                    "DELETE FROM __crdt_changes WHERE rowid NOT IN ("
                    " SELECT MIN(rowid) FROM __crdt_changes"
                    " GROUP BY site_id, db_version, seq)"
                )
                c.execute("DROP INDEX __crdt_changes_site_dbv")
            c.execute(
                "CREATE UNIQUE INDEX IF NOT EXISTS __crdt_changes_site_dbv"
                " ON __crdt_changes (site_id, db_version, seq)"
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS __corro_schema ("
                " tbl_name TEXT PRIMARY KEY, create_sql TEXT NOT NULL"
                ") WITHOUT ROWID"
            )
            # Replication bookkeeping persisted for restart rehydration
            # (agent.rs:147-268; tables at corro-types/src/agent.rs:232-314).
            c.execute(
                "CREATE TABLE IF NOT EXISTS __corro_bookkeeping ("
                " actor_id BLOB NOT NULL, start_version INTEGER NOT NULL,"
                " end_version INTEGER, db_version INTEGER,"
                " last_seq INTEGER, ts INTEGER,"
                " PRIMARY KEY (actor_id, start_version)) WITHOUT ROWID"
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS __corro_buffered_changes ("
                " actor_id BLOB NOT NULL, version INTEGER NOT NULL,"
                " tbl TEXT NOT NULL, pk BLOB NOT NULL, cid TEXT NOT NULL,"
                " val, col_version INTEGER NOT NULL,"
                " db_version INTEGER NOT NULL, seq INTEGER NOT NULL,"
                " site_id BLOB NOT NULL, cl INTEGER NOT NULL,"
                " PRIMARY KEY (actor_id, version, seq)) WITHOUT ROWID"
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS __corro_seq_bookkeeping ("
                " actor_id BLOB NOT NULL, version INTEGER NOT NULL,"
                " start_seq INTEGER NOT NULL, end_seq INTEGER NOT NULL,"
                " last_seq INTEGER NOT NULL, ts INTEGER NOT NULL,"
                " PRIMARY KEY (actor_id, version, start_seq)) WITHOUT ROWID"
            )
            # SWIM member states persisted for restart rejoin + operator
            # introspection (diff_member_states upserts into
            # __corro_members every 60 s, broadcast/mod.rs:570-702; loaded
            # back at setup, agent.rs:772-831).
            c.execute(
                "CREATE TABLE IF NOT EXISTS __corro_members ("
                " actor_id TEXT PRIMARY KEY, addr TEXT NOT NULL,"
                " state TEXT NOT NULL, incarnation INTEGER NOT NULL,"
                " updated_at REAL NOT NULL) WITHOUT ROWID"
            )
            # A crash between apply_changes' COMMIT and its flag reset would
            # otherwise leave apply_remote=1 persisted, silently muting all
            # local-change triggers on restart.
            c.execute(
                "UPDATE __corro_meta SET value = 0 WHERE key='apply_remote'"
            )

    def _load_schema(self) -> None:
        for name, sql in self.conn.execute(
            "SELECT tbl_name, create_sql FROM __corro_schema"
        ):
            self._tables[name] = self._introspect(name, sql)

    # -- schema management (schema.rs apply_schema, :266-628) ----------------

    def _introspect(self, name: str, create_sql: str) -> TableInfo:
        rows = list(self.conn.execute(f"PRAGMA table_info({_q(name)})"))
        pk = tuple(r[1] for r in sorted(rows, key=lambda r: r[5]) if r[5] > 0)
        data = tuple(r[1] for r in rows if r[5] == 0)
        if not pk:
            raise SchemaError(
                f"table {name} has no primary key — every CRR needs one "
                "(schema.rs requires non-null PKs)"
            )
        return TableInfo(name=name, pk_cols=pk, data_cols=data, create_sql=create_sql)

    def apply_schema(self, schema_sql: str) -> list[str]:
        """Parse DDL, diff vs the current schema, apply additive changes and
        CRR-ify new tables. Destructive changes (dropped tables/columns,
        changed PKs) are rejected (schema.rs:266-628 forbids them).

        Returns the list of new/changed table names.
        """
        tmp = sqlite3.connect(":memory:")
        try:
            tmp.executescript(schema_sql)
            desired: dict[str, str] = {
                name: sql
                for name, sql in tmp.execute(
                    "SELECT name, sql FROM sqlite_master"
                    " WHERE type='table' AND name NOT LIKE 'sqlite_%'"
                )
            }
            colmeta: dict[str, dict[str, tuple]] = {
                name: {
                    r[1]: r  # (cid, name, type, notnull, dflt, pk)
                    for r in tmp.execute(f"PRAGMA table_info({_q(name)})")
                }
                for name in desired
            }
        except sqlite3.Error as e:
            raise SchemaError(f"bad schema sql: {e}") from e
        finally:
            tmp.close()

        changed: list[str] = []
        for name in self._tables:
            if name not in desired:
                raise SchemaError(f"cannot drop table {name} (destructive)")

        # One explicit transaction so a rejected/broken schema leaves no
        # partial DDL behind (apply_schema is all-or-nothing in the
        # reference too, schema.rs:266-628).
        with self._wlock("apply_schema"):
            c = self.conn
            c.execute("BEGIN IMMEDIATE")
            staged: dict[str, TableInfo] = {}
            try:
                for name, sql in desired.items():
                    if name.startswith(INTERNAL_PREFIXES):
                        raise SchemaError(f"reserved table name {name}")
                    meta = colmeta[name]
                    new_info = _info_from_meta(name, meta, sql)
                    if name not in self._tables:
                        c.execute(sql)
                        self._create_crr(c, new_info)
                        c.execute(
                            "INSERT OR REPLACE INTO __corro_schema VALUES (?, ?)",
                            (name, sql),
                        )
                        staged[name] = new_info
                        changed.append(name)
                    else:
                        old = self._tables[name]
                        if new_info.pk_cols != old.pk_cols:
                            raise SchemaError(
                                f"cannot change primary key of {name}"
                            )
                        dropped = set(old.data_cols) - set(new_info.data_cols)
                        if dropped:
                            raise SchemaError(
                                f"cannot drop columns {sorted(dropped)} of {name}"
                            )
                        added = [
                            col for col in new_info.data_cols
                            if col not in old.data_cols
                        ]
                        if added:
                            for col in added:
                                r = meta[col]
                                type_ = r[2] or ""
                                dflt = (
                                    f" DEFAULT {r[4]}" if r[4] is not None else ""
                                )
                                c.execute(
                                    f"ALTER TABLE {_q(name)} ADD COLUMN"
                                    f" {_q(col)} {type_}{dflt}"
                                )
                            self._drop_triggers(c, old)
                            self._create_triggers(c, new_info)
                            c.execute(
                                "UPDATE __corro_schema SET create_sql=?"
                                " WHERE tbl_name=?",
                                (sql, name),
                            )
                            staged[name] = new_info
                            changed.append(name)
                c.execute("COMMIT")
            except Exception:
                c.execute("ROLLBACK")
                raise
            self._tables.update(staged)
        return changed

    # -- CRR machinery (crsql_as_crr analogue) -------------------------------

    def _create_crr(self, c: sqlite3.Connection, info: TableInfo) -> None:
        t = info.name
        c.execute(
            f"CREATE TABLE IF NOT EXISTS {_q(t + '__crdt_rows')} ("
            " pk BLOB PRIMARY KEY, cl INTEGER NOT NULL) WITHOUT ROWID"
        )
        c.execute(
            f"CREATE TABLE IF NOT EXISTS {_q(t + '__crdt_clock')} ("
            " pk BLOB NOT NULL, cid TEXT NOT NULL,"
            " col_version INTEGER NOT NULL, db_version INTEGER NOT NULL,"
            " seq INTEGER NOT NULL, site_id BLOB,"
            " PRIMARY KEY (pk, cid)) WITHOUT ROWID"
        )
        # Compaction probes scan (site_id, db_version); the reference
        # creates the same index for find_cleared_db_versions
        # (agent.rs:3238-3239).
        c.execute(
            f"CREATE INDEX IF NOT EXISTS {_q(t + '__crdt_clock_site_dbv')}"
            f" ON {_q(t + '__crdt_clock')} (site_id, db_version)"
        )
        self._create_triggers(c, info)

    def _drop_triggers(self, c: sqlite3.Connection, info: TableInfo) -> None:
        t = info.name
        for suffix in (
            ["ins", "del"] + [f"upd_{col}" for col in info.data_cols]
        ):
            c.execute(f"DROP TRIGGER IF EXISTS {_q(t + '__crdt_' + suffix)}")

    def _create_triggers(self, c: sqlite3.Connection, info: TableInfo) -> None:
        t = info.name
        pk_expr = "corro_pack(" + ", ".join(
            f"NEW.{_q(col)}" for col in info.pk_cols
        ) + ")"
        old_pk_expr = "corro_pack(" + ", ".join(
            f"OLD.{_q(col)}" for col in info.pk_cols
        ) + ")"
        dbv = "(SELECT value FROM __corro_meta WHERE key='db_version')"
        seq = "(SELECT value FROM __corro_meta WHERE key='seq')"
        local_guard = (
            "WHEN (SELECT value FROM __corro_meta WHERE key='apply_remote') = 0"
        )
        rows_t = _q(t + "__crdt_rows")
        clock_t = _q(t + "__crdt_clock")

        def cell_sql(col: str, new_pk: str) -> str:
            qc = _q(col)
            lc = _qs(col)
            lt = _qs(t)
            return (
                "UPDATE __corro_meta SET value = value + 1 WHERE key='seq';\n"
                f"INSERT INTO {clock_t} (pk, cid, col_version, db_version, seq, site_id)"
                f" VALUES ({new_pk}, '{lc}', 1, {dbv}, {seq}, NULL)"
                " ON CONFLICT (pk, cid) DO UPDATE SET"
                "  col_version = col_version + 1,"
                "  db_version = excluded.db_version,"
                "  seq = excluded.seq, site_id = NULL;\n"
                "INSERT INTO __crdt_changes"
                " (tbl, pk, cid, val, col_version, db_version, seq, site_id, cl)"
                f" SELECT '{lt}', {new_pk}, '{lc}', NEW.{qc},"
                f"  (SELECT col_version FROM {clock_t} WHERE pk = {new_pk} AND cid = '{lc}'),"
                f"  {dbv}, {seq},"
                "  (SELECT value FROM __corro_meta WHERE key='site_id'),"
                f"  (SELECT cl FROM {rows_t} WHERE pk = {new_pk});\n"
            )

        # INSERT: resurrect-or-create the row's causal length, then record
        # every data column (or a pk-only marker). A resurrection retires the
        # delete sentinel: its version stops being referenced by any clock
        # row and becomes compactable (find_cleared_db_versions semantics,
        # agent.rs:1250-1299).
        body = (
            f"INSERT INTO {rows_t} (pk, cl) VALUES ({pk_expr}, 1)"
            " ON CONFLICT (pk) DO UPDATE SET"
            "  cl = CASE WHEN cl % 2 = 0 THEN cl + 1 ELSE cl END;\n"
            f"DELETE FROM {clock_t} WHERE pk = {pk_expr}"
            f" AND cid = '{Change.DELETE_CID}';\n"
        )
        if info.data_cols:
            for col in info.data_cols:
                body += cell_sql(col, pk_expr)
        else:
            # PK-only rows keep a sentinel clock entry so their creating
            # version stays "live" for compaction purposes: cr-sqlite models
            # this with a __crsql_pko clock row — without it the version
            # would look overwritten immediately and peers that missed the
            # broadcast would never receive the row.
            body += (
                "UPDATE __corro_meta SET value = value + 1 WHERE key='seq';\n"
                f"INSERT INTO {clock_t} (pk, cid, col_version, db_version, seq, site_id)"
                f" VALUES ({pk_expr}, '{Change.PKONLY_CID}', 1, {dbv}, {seq}, NULL)"
                " ON CONFLICT (pk, cid) DO UPDATE SET"
                "  db_version = excluded.db_version,"
                "  seq = excluded.seq, site_id = NULL;\n"
                "INSERT INTO __crdt_changes"
                " (tbl, pk, cid, val, col_version, db_version, seq, site_id, cl)"
                f" SELECT '{_qs(t)}', {pk_expr}, '{Change.PKONLY_CID}', NULL, 1,"
                f" {dbv}, {seq},"
                " (SELECT value FROM __corro_meta WHERE key='site_id'),"
                f" (SELECT cl FROM {rows_t} WHERE pk = {pk_expr});\n"
            )
        c.execute(
            f"CREATE TRIGGER {_q(t + '__crdt_ins')} AFTER INSERT ON {_q(t)}"
            f" {local_guard} BEGIN\n{body}END"
        )

        # UPDATE: one trigger per data column, firing only on real change.
        for col in info.data_cols:
            qc = _q(col)
            c.execute(
                f"CREATE TRIGGER {_q(t + '__crdt_upd_' + col)}"
                f" AFTER UPDATE OF {qc} ON {_q(t)}"
                f" {local_guard} AND (NEW.{qc} IS NOT OLD.{qc})"
                f" BEGIN\n{cell_sql(col, pk_expr)}END"
            )

        # DELETE: causal length goes even, cell clocks clear, and a delete
        # sentinel clock row keeps the tombstone's db_version live — cr-sqlite
        # keeps a __crsql_del clock entry for exactly this reason: if the
        # delete's version were compacted away, a peer that missed the delete
        # broadcast would get "cleared" from sync and keep the row forever.
        c.execute(
            f"CREATE TRIGGER {_q(t + '__crdt_del')} AFTER DELETE ON {_q(t)}"
            f" {local_guard} BEGIN\n"
            f"UPDATE {rows_t} SET cl = cl + 1 WHERE pk = {old_pk_expr} AND cl % 2 = 1;\n"
            f"DELETE FROM {clock_t} WHERE pk = {old_pk_expr};\n"
            "UPDATE __corro_meta SET value = value + 1 WHERE key='seq';\n"
            f"INSERT INTO {clock_t} (pk, cid, col_version, db_version, seq, site_id)"
            f" VALUES ({old_pk_expr}, '{Change.DELETE_CID}', 1, {dbv}, {seq}, NULL);\n"
            "INSERT INTO __crdt_changes"
            " (tbl, pk, cid, val, col_version, db_version, seq, site_id, cl)"
            f" SELECT '{_qs(t)}', {old_pk_expr}, '{Change.DELETE_CID}', NULL, 1,"
            f" {dbv}, {seq},"
            " (SELECT value FROM __corro_meta WHERE key='site_id'),"
            f" (SELECT cl FROM {rows_t} WHERE pk = {old_pk_expr});\n"
            "END"
        )

    # -- reads ---------------------------------------------------------------

    def query(self, stmt: Statement) -> tuple[list[str], list[tuple]]:
        cur = self.read_conn.execute(stmt.sql, _bind(stmt))
        cols = [d[0] for d in cur.description] if cur.description else []
        return cols, cur.fetchall()

    def db_version(self) -> int:
        (v,) = self.conn.execute(
            "SELECT value FROM __corro_meta WHERE key='db_version'"
        ).fetchone()
        return v

    def tables(self) -> dict[str, TableInfo]:
        return dict(self._tables)

    # -- local writes (make_broadcastable_changes, public/mod.rs:33-191) -----

    def execute_transaction(
        self, statements: list[Statement]
    ) -> tuple[list[ExecResult], int, int, list[Change]]:
        """Run statements in one write txn; allocate a db_version; read back
        the changeset. Returns (results, db_version, last_seq, changes);
        db_version is 0 and changes empty when nothing was recorded."""
        c = self.conn
        with self._wlock("execute_transaction"):
            try:
                c.execute("BEGIN IMMEDIATE")
                c.execute(
                    "UPDATE __corro_meta SET value = value + 1"
                    " WHERE key='db_version'"
                )
                c.execute("UPDATE __corro_meta SET value = -1 WHERE key='seq'")
                dbv = self.db_version()
                results = []
                for st in statements:
                    cur = c.execute(st.sql, _bind(st))
                    results.append(
                        ExecResult(rows_affected=max(cur.rowcount, 0))
                    )
                changes = self._read_changes(dbv)
                if not changes:
                    # No CRR rows touched: give the db_version back
                    # (the has_changes check, public/mod.rs:67-80).
                    c.execute(
                        "UPDATE __corro_meta SET value = value - 1"
                        " WHERE key='db_version'"
                    )
                    dbv = 0
                c.execute("COMMIT")
            except Exception:
                c.execute("ROLLBACK")
                raise
        last_seq = max((ch.seq for ch in changes), default=0)
        return results, dbv, last_seq, changes

    def _read_changes(self, dbv: int) -> list[Change]:
        rows = self.conn.execute(
            "SELECT tbl, pk, cid, val, col_version, db_version, seq, site_id, cl"
            " FROM __crdt_changes WHERE db_version = ? AND site_id = ?"
            " ORDER BY seq",
            (dbv, self.site_id),
        ).fetchall()
        return [Change.from_tuple(r) for r in rows]

    def changes_for(
        self, site_id: bytes, db_version: int,
        seqs: tuple[int, int] | None = None,
    ) -> list[Change]:
        """Serve a changeset for sync (handle_known_version's read,
        peer.rs:358-562), optionally restricted to a seq range."""
        sql = (
            "SELECT tbl, pk, cid, val, col_version, db_version, seq, site_id, cl"
            " FROM __crdt_changes WHERE site_id = ? AND db_version = ?"
        )
        args: list = [site_id, db_version]
        if seqs is not None:
            sql += " AND seq BETWEEN ? AND ?"
            args += [seqs[0], seqs[1]]
        sql += " ORDER BY seq"
        # Read connection, not the writer: sync serving runs on the event
        # loop while the pool's writer thread may hold an open BEGIN
        # IMMEDIATE on ``conn`` — joining that in-flight transaction could
        # serve uncommitted state. WAL gives this snapshot committed
        # versions only, which is exactly what booked.current describes.
        return [
            Change.from_tuple(r)
            for r in self.read_conn.execute(sql, args).fetchall()
        ]

    # -- compaction (clear_overwritten_versions, agent.rs:995-1299) ----------

    def find_cleared_versions(self, site_id: bytes) -> set[int]:
        """db_versions of ``site_id`` that no live clock row references —
        every cell they wrote has been overwritten by a newer version
        (find_cleared_db_versions, agent.rs:1250-1299). Delete/pk-only
        sentinel clock rows keep tombstone versions live until superseded.
        Local writes store NULL in clock site_id (like crsql ordinal 0), so
        the probe uses ``IS ?``.
        """
        if not self._tables:
            return set()
        probe = None if site_id == self.site_id else site_id
        parts: list[str] = []
        params: list = [site_id]
        for name in self._tables:
            clock_t = _q(name + "__crdt_clock")
            parts.append(
                f"SELECT DISTINCT db_version FROM {clock_t} WHERE site_id IS ?"
            )
            params.append(probe)
        sql = (
            "SELECT DISTINCT db_version FROM __corro_bookkeeping"
            " WHERE actor_id = ? AND db_version IS NOT NULL"
            " EXCEPT SELECT db_version FROM ("
            + " UNION ".join(parts)
            + ")"
        )
        return {row[0] for row in self.read_conn.execute(sql, params)}

    def store_empty_changeset(
        self, actor_id: bytes, start: int, end: int
    ) -> int:
        """Collapse [start, end] into one cleared (db_version-less)
        bookkeeping range row, merging overlapping/adjacent rows — the
        range-collapsing DELETE+INSERT of store_empty_changeset
        (agent.rs:1588-1664) — then prune the change log and partial
        buffers those versions owned. Returns the number of range rows
        written (1, or 0 if the merge produced nothing new)."""
        c = self.conn
        with self._wlock("store_empty_changeset"):
            try:
                c.execute("BEGIN IMMEDIATE")
                # Overlap/adjacency predicate (store_empty_changeset's
                # DELETE, agent.rs:1598-1614, with its straddle-the-start
                # hole closed): current singles (end_version NULL) inside
                # the range, and cleared ranges (end_version set) that
                # overlap or touch [start-1, end+1] — contained, straddling
                # either end, containing, or exactly adjacent.
                pred = (
                    " actor_id = ? AND ("
                    "  (end_version IS NULL AND start_version BETWEEN ? AND ?)"
                    "  OR (end_version IS NOT NULL AND start_version <= ?"
                    "      AND end_version >= ?))"
                )
                args = (actor_id, start, end, end + 1, start - 1)
                rows = c.execute(
                    "SELECT start_version, end_version, db_version"
                    " FROM __corro_bookkeeping WHERE" + pred,
                    args,
                ).fetchall()
                merged = RangeSet([(start, end)])
                for sv, ev, _dbv in rows:
                    merged.insert(sv, ev if ev is not None else sv)
                if len(merged) > 1:
                    # Failsafe mirrored from the reference: deleting
                    # non-contiguous ranges means bookkeeping is corrupt.
                    raise StoreError(
                        f"store_empty_changeset would merge non-contiguous"
                        f" ranges: {list(merged)}"
                    )
                c.execute(
                    "DELETE FROM __corro_bookkeeping WHERE" + pred, args
                )
                inserted = 0
                for s, e in merged:
                    c.execute(
                        "INSERT INTO __corro_bookkeeping (actor_id,"
                        " start_version, end_version, db_version, last_seq, ts)"
                        " VALUES (?, ?, ?, NULL, NULL, NULL)",
                        (actor_id, s, e),
                    )
                    inserted += 1
                # Prune: the change log rows for the cleared db_versions (the
                # actual space reclaim — the crsql vtab does this implicitly
                # because overwritten clock rows vanish), and any stale
                # partial buffers within the cleared span.
                dbvs = [r[2] for r in rows if r[2] is not None]
                if dbvs:
                    qs = ",".join("?" for _ in dbvs)
                    c.execute(
                        f"DELETE FROM __crdt_changes WHERE site_id = ?"
                        f" AND db_version IN ({qs})",
                        (actor_id, *dbvs),
                    )
                c.execute(
                    "DELETE FROM __corro_buffered_changes"
                    " WHERE actor_id = ? AND version BETWEEN ? AND ?",
                    (actor_id, start, end),
                )
                c.execute(
                    "DELETE FROM __corro_seq_bookkeeping"
                    " WHERE actor_id = ? AND version BETWEEN ? AND ?",
                    (actor_id, start, end),
                )
                c.execute("COMMIT")
            except Exception:
                c.execute("ROLLBACK")
                raise
        return inserted

    # -- remote merge (process_multiple_changes, agent.rs:1809-2060) ---------

    def apply_changes(self, changes: list[Change]) -> int:
        """Merge remote changes in one txn; returns the applied count."""
        c = self.conn
        applied = 0
        with self._wlock("apply_changes"):
            try:
                c.execute("BEGIN IMMEDIATE")
                c.execute(
                    "UPDATE __corro_meta SET value = 1 WHERE key='apply_remote'"
                )
                for ch in changes:
                    if self._apply_one(c, ch):
                        applied += 1
                c.execute("COMMIT")
            except Exception:
                c.execute("ROLLBACK")
                raise
            finally:
                c.execute(
                    "UPDATE __corro_meta SET value = 0 WHERE key='apply_remote'"
                )
        return applied

    def _apply_one(self, c: sqlite3.Connection, ch: Change) -> bool:
        info = self._tables.get(ch.table)
        if info is None:
            return False  # unknown table (schema lag): drop, sync re-serves
        rows_t = _q(ch.table + "__crdt_rows")
        clock_t = _q(ch.table + "__crdt_clock")
        # One point read for both the causal length and the cell's clock
        # (the apply path runs per change; two separate SELECTs measurably
        # dominated the receiver side of the host bench). The joined
        # col_version is only valid in the same-epoch branch — the
        # adoption branch wipes the clock table first.
        row = c.execute(
            f"SELECT r.cl, cc.col_version FROM {rows_t} r"
            f" LEFT JOIN {clock_t} cc ON cc.pk = r.pk AND cc.cid = ?"
            " WHERE r.pk = ?",
            (ch.cid, ch.pk),
        ).fetchone()
        local_cl = row[0] if row else 0
        local_cv_joined = row[1] if row else None

        if ch.cl < local_cl:
            return False  # stale causal epoch
        if ch.cl > local_cl:
            # Adopt the newer epoch.
            c.execute(
                f"INSERT INTO {rows_t} (pk, cl) VALUES (?, ?)"
                " ON CONFLICT (pk) DO UPDATE SET cl = excluded.cl",
                (ch.pk, ch.cl),
            )
            c.execute(f"DELETE FROM {clock_t} WHERE pk = ?", (ch.pk,))
            if ch.cl % 2 == 0:
                self._delete_row(c, info, ch.pk)
                # Tombstone sentinel: keeps the delete's db_version live in
                # the clock so compaction can't clear it (see _create_crr).
                self._upsert_clock_sentinel(c, clock_t, Change.DELETE_CID, ch)
                self._log_change(c, ch)
                return True
            self._ensure_row(c, info, ch.pk)
            if ch.cid in (Change.DELETE_CID, Change.PKONLY_CID):
                if ch.cid == Change.PKONLY_CID:
                    self._upsert_clock_sentinel(
                        c, clock_t, Change.PKONLY_CID, ch
                    )
                self._log_change(c, ch)
                return True
            # fall through: apply (and log) the cell in the fresh epoch
        else:
            if ch.cl % 2 == 0:
                return False  # duplicate delete
            if ch.cid == Change.DELETE_CID:
                return False  # delete sentinel for an epoch we've superseded
            if ch.cid == Change.PKONLY_CID:
                self._ensure_row(c, info, ch.pk)
                self._upsert_clock_sentinel(c, clock_t, Change.PKONLY_CID, ch)
                self._log_change(c, ch)
                return True

        if ch.cid not in info.data_cols:
            return False  # column we don't know (additive schema lag)

        if ch.cl > local_cl:
            # Epoch adoption wiped the clock above: no LWW compare.
            local_cv_joined = None
        if local_cv_joined is not None:
            local_cv = local_cv_joined
            if ch.col_version < local_cv:
                return False
            if ch.col_version == local_cv:
                if self.native_crdt:
                    # In-DB tie-break: the local value never leaves SQLite.
                    where = " AND ".join(
                        f"{_q(k)} = ?" for k in info.pk_cols
                    )
                    row = c.execute(
                        f"SELECT crdt_value_cmp(?, {_q(ch.cid)}) <= 0"
                        f" FROM {_q(info.name)} WHERE {where}",
                        (ch.val, *unpack_columns(ch.pk)),
                    ).fetchone()
                    # Missing row ⇒ local cell is NULL: only a NULL ties.
                    lose = bool(row[0]) if row is not None else ch.val is None
                else:
                    local_val = self._cell_value(c, info, ch.pk, ch.cid)
                    lose = value_le(ch.val, local_val)
                if lose:
                    return False  # we win or tie exactly (idempotent)
        self._ensure_row(c, info, ch.pk)
        c.execute(
            f"UPDATE {_q(info.name)} SET {_q(ch.cid)} = ? WHERE "
            + " AND ".join(f"{_q(k)} = ?" for k in info.pk_cols),
            (ch.val, *unpack_columns(ch.pk)),
        )
        c.execute(
            f"INSERT INTO {clock_t} (pk, cid, col_version, db_version, seq, site_id)"
            " VALUES (?, ?, ?, ?, ?, ?)"
            " ON CONFLICT (pk, cid) DO UPDATE SET"
            "  col_version = excluded.col_version,"
            "  db_version = excluded.db_version,"
            "  seq = excluded.seq, site_id = excluded.site_id",
            (ch.pk, ch.cid, ch.col_version, ch.db_version, ch.seq, ch.site_id),
        )
        self._log_change(c, ch)
        return True

    def _upsert_clock_sentinel(
        self, c: sqlite3.Connection, clock_t: str, cid: str, ch: Change
    ) -> None:
        c.execute(
            f"INSERT INTO {clock_t} (pk, cid, col_version, db_version, seq, site_id)"
            " VALUES (?, ?, 1, ?, ?, ?)"
            " ON CONFLICT (pk, cid) DO UPDATE SET"
            "  db_version = excluded.db_version,"
            "  seq = excluded.seq, site_id = excluded.site_id",
            (ch.pk, cid, ch.db_version, ch.seq, ch.site_id),
        )

    def _log_change(self, c: sqlite3.Connection, ch: Change) -> None:
        # Keep the winning change re-servable for third-party sync
        # (the crsql_changes vtab serves merged state by (site, db_version)).
        c.execute(
            "INSERT OR REPLACE INTO __crdt_changes"
            " (tbl, pk, cid, val, col_version, db_version, seq, site_id, cl)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
            ch.to_tuple(),
        )

    def _ensure_row(self, c: sqlite3.Connection, info: TableInfo, pk: bytes) -> None:
        cols = ", ".join(_q(k) for k in info.pk_cols)
        ph = ", ".join("?" for _ in info.pk_cols)
        c.execute(
            f"INSERT OR IGNORE INTO {_q(info.name)} ({cols}) VALUES ({ph})",
            unpack_columns(pk),
        )

    def _delete_row(self, c: sqlite3.Connection, info: TableInfo, pk: bytes) -> None:
        c.execute(
            f"DELETE FROM {_q(info.name)} WHERE "
            + " AND ".join(f"{_q(k)} = ?" for k in info.pk_cols),
            unpack_columns(pk),
        )

    def _cell_value(
        self, c: sqlite3.Connection, info: TableInfo, pk: bytes, cid: str
    ) -> SqliteValue:
        row = c.execute(
            f"SELECT {_q(cid)} FROM {_q(info.name)} WHERE "
            + " AND ".join(f"{_q(k)} = ?" for k in info.pk_cols),
            unpack_columns(pk),
        ).fetchone()
        return row[0] if row else None


def _bind(st: Statement):
    if st.named_params is not None:
        return st.named_params
    return st.params or ()


def _sql_pack(*values: SqliteValue) -> bytes:
    return pack_columns(values)

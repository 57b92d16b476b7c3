"""API value types: SQL values, changes, statements, query events.

Mirrors corro-api-types/src/lib.rs: `Change` (:210-238), `Statement`
(:168-195), `ExecResponse`/`ExecResult` (:197-208), `QueryEvent` (:25-62),
`SqliteValue` (:255-530), and the column packing used for primary keys
(corro-types/src/pubsub.rs:2115-2283). Counterpart of
corrosion_tpu/core/values.py.

SqliteValue is represented natively: None | int | float | str | bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Iterable, Union

SqliteValue = Union[None, int, float, str, bytes]

# type tags for pack_columns — ordered like SQLite's cross-type ordering
# (NULL < numeric < text < blob), so tag comparison gives type precedence.
T_NULL, T_INT, T_REAL, T_TEXT, T_BLOB = 0, 1, 2, 3, 4


def _tag(v: SqliteValue) -> int:
    if v is None:
        return T_NULL
    if isinstance(v, bool):
        return T_INT
    if isinstance(v, int):
        return T_INT
    if isinstance(v, float):
        return T_REAL
    if isinstance(v, str):
        return T_TEXT
    if isinstance(v, bytes):
        return T_BLOB
    raise TypeError(f"unsupported SQL value type: {type(v)}")


def _write_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


class MalformedBlobError(ValueError):
    """Raised when a packed-column blob is truncated or corrupt."""


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    n = 0
    while True:
        if i >= len(buf):
            raise MalformedBlobError(f"truncated varint at offset {i}")
        if shift > 63:
            raise MalformedBlobError(f"varint overflow at offset {i}")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _py_pack_columns(values: Iterable[SqliteValue]) -> bytes:
    out = bytearray()
    for v in values:
        tag = _tag(v)
        out.append(tag)
        if tag == T_NULL:
            continue
        if tag == T_INT:
            n = int(v)
            if not -(1 << 63) <= n < (1 << 63):
                raise ValueError(f"integer out of SQLite i64 range: {n}")
            _write_varint(out, (n << 1) ^ (n >> 63))  # zigzag
        elif tag == T_REAL:
            out += struct.pack(">d", v)
        else:
            data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            _write_varint(out, len(data))
            out += data
    return bytes(out)


def _py_unpack_columns(blob: bytes) -> tuple[SqliteValue, ...]:
    values: list[SqliteValue] = []
    i = 0
    while i < len(blob):
        tag = blob[i]
        i += 1
        if tag == T_NULL:
            values.append(None)
        elif tag == T_INT:
            z, i = _read_varint(blob, i)
            values.append((z >> 1) ^ -(z & 1))  # un-zigzag
        elif tag == T_REAL:
            if i + 8 > len(blob):
                raise MalformedBlobError(f"truncated real at offset {i}")
            values.append(struct.unpack_from(">d", blob, i)[0])
            i += 8
        elif tag in (T_TEXT, T_BLOB):
            n, i = _read_varint(blob, i)
            if i + n > len(blob):
                raise MalformedBlobError(
                    f"declared length {n} overruns blob at offset {i}"
                )
            data = blob[i : i + n]
            values.append(data.decode("utf-8") if tag == T_TEXT else bytes(data))
            i += n
        else:
            raise MalformedBlobError(f"bad column tag {tag} at offset {i-1}")
    return tuple(values)


# Native fast path (build/native, built from native/): byte-exact
# with the Python codec above; MalformedError translates to
# MalformedBlobError so callers see one exception type.
from corrosion_tpu_torch import native as _native_mod  # noqa: E402


def pack_columns(values: Iterable[SqliteValue]) -> bytes:
    """Serialize a tuple of SQL values into one blob (PK encoding).

    Deterministic: equal tuples produce equal blobs, so blobs are usable as
    dictionary keys and DB-stored primary-key identities, like the packed pk
    column in the reference (pubsub.rs:2115+).
    """
    if _native_mod.native is not None:
        return _native_mod.native.pack_columns(values)
    return _py_pack_columns(values)


def unpack_columns(blob: bytes) -> tuple[SqliteValue, ...]:
    if _native_mod.native is not None:
        try:
            return _native_mod.native.unpack_columns(blob)
        except _native_mod.native.MalformedError as e:
            raise MalformedBlobError(str(e)) from None
    return _py_unpack_columns(blob)


def value_le(a: SqliteValue, b: SqliteValue) -> bool:
    """a <= b under the LWW total order (native when built)."""
    if _native_mod.native is not None:
        return _native_mod.native.value_cmp(a, b) <= 0
    return value_cmp_key(a) <= value_cmp_key(b)


def value_cmp_key(v: SqliteValue) -> tuple[int, Any]:
    """Total order over SQL values for LWW tie-breaking.

    "Biggest value wins" on col_version ties (reference doc/crdts.md:15-16):
    SQLite cross-type ordering (NULL < numbers < text < blob), numeric order
    within numbers, lexicographic within text/blob.
    """
    if v is None:
        return (T_NULL, 0)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return (T_INT, v)  # ints and reals share the numeric class
    if isinstance(v, bool):
        return (T_INT, int(v))
    if isinstance(v, str):
        return (T_TEXT, v)
    return (T_BLOB, v)


@dataclass(frozen=True)
class Change:
    """One CRR cell change (corro-api-types lib.rs:210-238).

    A changeset row: (table, pk, cid) identifies a cell; val/col_version carry
    the LWW payload; db_version/seq place it in the originating actor's
    history; site_id is the originating actor; cl is the row's causal length
    (odd = live, even = deleted).
    """

    table: str
    pk: bytes  # pack_columns of the primary key tuple
    cid: str  # column name; DELETE_CID/PKONLY_CID sentinels for row markers
    val: SqliteValue
    col_version: int
    db_version: int
    seq: int
    site_id: bytes
    cl: int

    # sentinel cid used by the CRR layer for row-level (create/delete) records
    DELETE_CID = "__crsql_del"
    PKONLY_CID = "__crsql_pko"

    def estimated_byte_size(self) -> int:
        """Rough wire size, used for chunking (change.rs byte accounting)."""
        if self.val is None:
            val_len = 0
        elif isinstance(self.val, bytes):
            val_len = len(self.val)
        elif isinstance(self.val, str):
            val_len = len(self.val.encode("utf-8"))
        else:
            val_len = 8
        return 40 + len(self.table) + len(self.pk) + len(self.cid) + val_len

    def to_tuple(self) -> tuple:
        return (
            self.table,
            self.pk,
            self.cid,
            self.val,
            self.col_version,
            self.db_version,
            self.seq,
            self.site_id,
            self.cl,
        )

    @classmethod
    def from_tuple(cls, t: tuple) -> "Change":
        return cls(*t)


@dataclass
class Statement:
    """A SQL statement with optional positional or named params
    (corro-api-types lib.rs:168-195)."""

    sql: str
    params: list[SqliteValue] | None = None
    named_params: dict[str, SqliteValue] | None = None

    @classmethod
    def parse(cls, obj: Any) -> "Statement":
        """Accepts the reference's JSON forms: "sql", ["sql", [params]],
        ["sql", {named}]."""
        if isinstance(obj, str):
            return cls(obj)
        if isinstance(obj, (list, tuple)):
            if len(obj) == 1:
                return cls(obj[0])
            if len(obj) != 2:
                raise ValueError(
                    f"statement array must be [sql], [sql, [params]] or "
                    f"[sql, {{named}}], got {len(obj)} elements"
                )
            sql, second = obj[0], obj[1]
            if isinstance(second, dict):
                return cls(sql, named_params=second)
            if isinstance(second, (list, tuple)):
                return cls(sql, params=list(second))
            raise ValueError(f"statement params must be a list or dict, got {second!r}")
        if isinstance(obj, dict):
            return cls(
                obj["query"],
                params=obj.get("params"),
                named_params=obj.get("named_params"),
            )
        raise ValueError(f"cannot parse statement from {obj!r}")

    def to_json_obj(self) -> Any:
        if self.named_params is not None:
            return [self.sql, self.named_params]
        if self.params is not None:
            return [self.sql, self.params]
        return self.sql


@dataclass
class ExecResult:
    """One statement's outcome inside an /v1/transactions response."""

    rows_affected: int | None = None
    time: float | None = None
    error: str | None = None

    def to_json_obj(self) -> dict:
        if self.error is not None:
            return {"error": self.error}
        return {"rows_affected": self.rows_affected, "time": self.time}


@dataclass
class ExecResponse:
    results: list[ExecResult] = field(default_factory=list)
    time: float = 0.0
    version: int | None = None

    def to_json_obj(self) -> dict:
        out: dict[str, Any] = {
            "results": [r.to_json_obj() for r in self.results],
            "time": self.time,
        }
        if self.version is not None:
            out["version"] = self.version
        return out


# --- Query events (subscription stream frames, corro-api-types lib.rs:25-62) ---


@dataclass(frozen=True)
class QueryEventColumns:
    columns: list[str]

    def to_json_obj(self) -> dict:
        return {"columns": self.columns}


@dataclass(frozen=True)
class QueryEventRow:
    rowid: int
    cells: list[SqliteValue]

    def to_json_obj(self) -> dict:
        return {"row": [self.rowid, self.cells]}


@dataclass(frozen=True)
class QueryEventEndOfQuery:
    time: float
    change_id: int | None = None

    def to_json_obj(self) -> dict:
        return {"eoq": {"time": self.time, "change_id": self.change_id}}


# row-change kinds on the live stream
CHANGE_INSERT, CHANGE_UPDATE, CHANGE_DELETE = "insert", "update", "delete"


@dataclass(frozen=True)
class QueryEventChange:
    kind: str  # insert | update | delete
    rowid: int
    cells: list[SqliteValue]
    change_id: int

    def to_json_obj(self) -> dict:
        return {"change": [self.kind, self.rowid, self.cells, self.change_id]}


@dataclass(frozen=True)
class QueryEventError:
    error: str

    def to_json_obj(self) -> dict:
        return {"error": self.error}


QueryEvent = Union[
    QueryEventColumns,
    QueryEventRow,
    QueryEventEndOfQuery,
    QueryEventChange,
    QueryEventError,
]


def query_event_from_json(obj: dict) -> QueryEvent:
    if "columns" in obj:
        return QueryEventColumns(obj["columns"])
    if "row" in obj:
        rowid, cells = obj["row"]
        return QueryEventRow(rowid, cells)
    if "eoq" in obj:
        eoq = obj["eoq"]
        if isinstance(eoq, dict):
            return QueryEventEndOfQuery(eoq.get("time", 0.0), eoq.get("change_id"))
        return QueryEventEndOfQuery(eoq)
    if "change" in obj:
        kind, rowid, cells, change_id = obj["change"]
        return QueryEventChange(kind, rowid, cells, change_id)
    if "error" in obj:
        return QueryEventError(obj["error"])
    raise ValueError(f"unknown query event {obj!r}")

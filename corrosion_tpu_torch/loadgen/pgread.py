"""Minimal asyncio PG-wire simple-query client.

Just enough protocol v3 for the load generator to put the PG server
(agent/pg.py) under the same open-loop read load as the HTTP routes:
startup + simple query ('Q') + DataRow counting. One connection per
client, reused across queries — the PG path is the pooled-read surface,
so connection reuse (not per-request connects) is the realistic shape.

Counterpart of corrosion_tpu/loadgen/pgread.py.
"""

from __future__ import annotations

import asyncio
import struct


class PgQueryError(Exception):
    pass


class PgReadClient:
    def __init__(self, reader, writer) -> None:
        self.reader = reader
        self.writer = writer

    @classmethod
    async def connect(
        cls, host: str, port: int, user: str = "loadgen",
        database: str = "main",
    ) -> "PgReadClient":
        reader, writer = await asyncio.open_connection(host, port)
        params = (
            b"user\x00" + user.encode() + b"\x00"
            b"database\x00" + database.encode() + b"\x00\x00"
        )
        payload = struct.pack(">I", 196608) + params
        writer.write(struct.pack(">I", len(payload) + 4) + payload)
        await writer.drain()
        self = cls(reader, writer)
        msgs = await self._read_until(b"Z")
        if not any(t == b"R" for t, _ in msgs):
            raise PgQueryError("no AuthenticationOk in startup response")
        return self

    async def _read_msg(self):
        header = await self.reader.readexactly(5)
        (length,) = struct.unpack(">I", header[1:5])
        return header[0:1], await self.reader.readexactly(length - 4)

    async def _read_until(self, end_tag: bytes):
        out = []
        while True:
            tag, payload = await self._read_msg()
            out.append((tag, payload))
            if tag == end_tag:
                return out

    async def query(self, sql: str) -> int:
        """Simple-query flow; returns the DataRow count. An ErrorResponse
        raises (the flow still drains to ReadyForQuery first, so the
        connection stays usable)."""
        body = sql.encode() + b"\x00"
        self.writer.write(b"Q" + struct.pack(">I", len(body) + 4) + body)
        await self.writer.drain()
        msgs = await self._read_until(b"Z")
        errs = [p for t, p in msgs if t == b"E"]
        if errs:
            raise PgQueryError(errs[0].decode("utf-8", "replace"))
        return sum(1 for t, _ in msgs if t == b"D")

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

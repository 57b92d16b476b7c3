"""Async HTTP client SDK — the corro-client analogue.

Mirrors crates/corro-client (lib.rs:32-315): execute/query/schema against an
agent's HTTP API, plus `subscribe` returning a line-decoded QueryEvent
stream with reconnect-from-change-id (sub.rs:59-277). Uses raw asyncio
streams (HTTP/1.1 with chunked decoding) so it has zero dependencies.

Counterpart of corrosion_tpu/client.py.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, AsyncIterator

from corrosion_tpu_torch.core.values import Statement


class ApiError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


class _Response:
    def __init__(self, status: int, headers: dict, reader, writer):
        self.status = status
        self.headers = headers
        self._reader = reader
        self._writer = writer

    async def body(self) -> bytes:
        if "content-length" in self.headers:
            return await self._reader.readexactly(
                int(self.headers["content-length"])
            )
        if self.headers.get("transfer-encoding") == "chunked":
            out = b""
            async for chunk in self.chunks():
                out += chunk
            return out
        return await self._reader.read()

    async def chunks(self) -> AsyncIterator[bytes]:
        while True:
            size_line = await self._reader.readline()
            n = int(size_line.strip() or b"0", 16)
            if n == 0:
                await self._reader.readline()
                return
            data = await self._reader.readexactly(n)
            await self._reader.readexactly(2)  # trailing \r\n
            yield data

    async def lines(self) -> AsyncIterator[bytes]:
        """NDJSON lines across chunk boundaries (LinesBytesCodec)."""
        buf = b""
        async for chunk in self.chunks():
            buf += chunk
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                if line.strip():
                    yield line
        if buf.strip():
            yield buf

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass


class CorrosionApiClient:
    """corro-client's CorrosionApiClient (lib.rs:32-315)."""

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port

    async def _request(
        self, method: str, path: str, body: bytes | None = None,
        headers: dict | None = None,
    ) -> _Response:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        extra = "".join(
            f"{k}: {v}\r\n" for k, v in (headers or {}).items()
        )
        head = (
            f"{method} {path} HTTP/1.1\r\n"
            f"host: {self.host}:{self.port}\r\n"
            "content-type: application/json\r\n"
            f"content-length: {len(body or b'')}\r\n"
            f"{extra}\r\n"
        )
        writer.write(head.encode() + (body or b""))
        await writer.drain()
        status_line = await reader.readline()
        status = int(status_line.split()[1])
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        return _Response(status, headers, reader, writer)

    async def execute(
        self, statements: list[Statement | str | list],
        traceparent: str | None = None,
    ) -> dict:
        """POST /v1/transactions. ``traceparent`` (a W3C header value)
        seeds the server's causal write trace with the CALLER's trace id
        — how a load generator's delivery records later join the agent's
        span export (docs/OBSERVABILITY.md "Causal tracing")."""
        body = json.dumps(
            [
                s.to_json_obj() if isinstance(s, Statement) else s
                for s in statements
            ]
        ).encode()
        resp = await self._request(
            "POST", "/v1/transactions", body,
            headers=(
                {"traceparent": traceparent} if traceparent else None
            ),
        )
        data = await resp.body()
        resp.close()
        if resp.status != 200:
            raise ApiError(resp.status, data.decode())
        return json.loads(data)

    async def query(
        self, statement: Statement | str
    ) -> tuple[list[str], list[list[Any]]]:
        st = (
            statement
            if isinstance(statement, Statement)
            else Statement(statement)
        )
        resp = await self._request(
            "POST", "/v1/queries", json.dumps(st.to_json_obj()).encode()
        )
        if resp.status != 200:
            data = await resp.body()
            resp.close()
            raise ApiError(resp.status, data.decode())
        cols: list[str] = []
        rows: list[list[Any]] = []
        async for line in resp.lines():
            ev = json.loads(line)
            if "columns" in ev:
                cols = ev["columns"]
            elif "row" in ev:
                rows.append(ev["row"][1])
            elif "eoq" in ev:
                break
            elif "error" in ev:
                resp.close()
                raise ApiError(500, ev["error"])
        resp.close()
        return cols, rows

    async def schema(self, ddl: list[str]) -> dict:
        resp = await self._request(
            "POST", "/v1/migrations", json.dumps(ddl).encode()
        )
        data = await resp.body()
        resp.close()
        if resp.status != 200:
            raise ApiError(resp.status, data.decode())
        return json.loads(data)

    async def subscribe(
        self, sql: str, skip_rows: bool = False
    ) -> "SubscriptionStream":
        q = "?skip_rows=true" if skip_rows else ""
        resp = await self._request(
            "POST", f"/v1/subscriptions{q}",
            json.dumps(sql).encode(),
        )
        if resp.status != 200:
            data = await resp.body()
            resp.close()
            raise ApiError(resp.status, data.decode())
        return SubscriptionStream(self, resp)

    async def resubscribe(
        self, sub_id: str, from_change: int | None = None
    ) -> "SubscriptionStream":
        q = f"?from={from_change}" if from_change is not None else ""
        resp = await self._request("GET", f"/v1/subscriptions/{sub_id}{q}")
        if resp.status != 200:
            data = await resp.body()
            resp.close()
            raise ApiError(resp.status, data.decode())
        return SubscriptionStream(self, resp, sub_id=sub_id)


class SubscriptionStream:
    """Decoded QueryEvent stream with observed-change-id tracking, so a
    dropped connection can resume via `?from=` (corro-client sub.rs:59-277)."""

    def __init__(self, client, resp: _Response, sub_id: str | None = None):
        self._client = client
        self._resp = resp
        self.sub_id = sub_id
        self.last_change_id: int | None = None
        self._lines = resp.lines()

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        async for line in self._lines:
            ev = json.loads(line)
            if "sub_id" in ev:
                self.sub_id = ev["sub_id"]
                continue
            if "change" in ev:
                self.last_change_id = ev["change"][3]
            return ev
        raise StopAsyncIteration

    async def reconnect(
        self, retries: int = 0, delay_s: float = 0.2
    ) -> None:
        """Resume from the last observed change id.

        ``retries`` re-attempts the resubscribe on connection failure
        (an agent mid-restart refuses connections for a moment; the
        durable sub-db makes the resume valid once it is back). The
        stream's resume state (sub_id, last_change_id) is untouched on
        failure, so a later call retries from the same point.
        """
        if self.sub_id is None:
            raise ApiError(400, "no sub_id observed yet")
        self.close()
        attempt = 0
        while True:
            try:
                fresh = await self._client.resubscribe(
                    self.sub_id, from_change=self.last_change_id
                )
                break
            except (ConnectionError, OSError):
                if attempt >= retries:
                    raise
                attempt += 1
                await asyncio.sleep(delay_s)
        self._resp = fresh._resp
        self._lines = fresh._lines

    def close(self) -> None:
        self._resp.close()

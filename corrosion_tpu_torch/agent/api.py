"""HTTP public API over asyncio streams.

The reference serves axum routes /v1/transactions, /v1/queries,
/v1/migrations, /v1/subscriptions (corro-agent/src/agent.rs:833-931,
api/public/mod.rs). Python's stdlib has no async HTTP server, so this is a
deliberately small HTTP/1.1 implementation: enough for JSON request bodies,
JSON responses, and chunked NDJSON streaming for queries and subscriptions
(the reference streams QueryEvents as newline-delimited JSON,
api/public/pubsub.rs).

Counterpart of corrosion_tpu/agent/api.py.
"""

from __future__ import annotations

import asyncio
import json
from typing import TYPE_CHECKING
from urllib.parse import parse_qs, urlparse

from corrosion_tpu_torch.core.values import Statement

if TYPE_CHECKING:
    from corrosion_tpu_torch.agent.agent import Agent

MAX_BODY = 64 * 1024 * 1024
# Header-section caps: an abusive or buggy client must not be able to
# buffer unbounded memory on the server by streaming headers forever.
# asyncio's stream limit (64 KiB) already bounds any SINGLE line; these
# bound the count and the section total, answered with 431.
MAX_HEADER_COUNT = 128
MAX_HEADER_BYTES = 32 * 1024


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class RouteLimit:
    """Admission control per route: the reference wraps every /v1 route in
    a concurrency limit + load-shed (128 per route, 4 for migrations;
    agent.rs:836-902). Handlers run on one event loop, so a plain counter
    suffices; over-limit requests shed immediately with 503.

    When a ``MetricsRegistry`` is wired (``rebuild_api_limits``), shed
    decisions and the live admission count are visible on /metrics as
    ``corro_api_shed_total{route=...}`` / ``corro_api_inflight{route=...}``
    — so a load generator's client-side 503 accounting can be
    cross-checked against the server's own."""

    def __init__(self, limit: int, route: str = "", metrics=None):
        self.limit = limit
        self.active = 0
        self.route = route
        self._shed = (
            metrics.counter(
                "corro_api_shed_total",
                "requests shed (503) by per-route admission control",
            )
            if metrics is not None else None
        )
        self._inflight = (
            metrics.gauge(
                "corro_api_inflight",
                "requests currently holding a per-route admission slot",
            )
            if metrics is not None else None
        )

    def __enter__(self):
        if self.active >= self.limit:
            if self._shed is not None:
                self._shed.inc(route=self.route)
            raise HttpError(503, "concurrency limit reached (load shed)")
        self.active += 1
        if self._inflight is not None:
            # add(), not set(self.active): after a config hot-reload
            # (rebuild_api_limits) old and new RouteLimit instances
            # briefly coexist on the same gauge label — deltas keep the
            # published value equal to TOTAL in-flight across both,
            # where a set() from a draining old instance would clobber
            # the new one's count.
            self._inflight.add(1, route=self.route)
        return self

    def __exit__(self, *exc):
        self.active -= 1
        if self._inflight is not None:
            self._inflight.add(-1, route=self.route)


async def _read_request(reader: asyncio.StreamReader):
    try:
        line = await reader.readline()
    except ValueError:
        # asyncio stream-limit overrun: a request line longer than the
        # 64 KiB buffer. The read side is no longer line-synchronized,
        # so the caller closes the connection after responding.
        raise HttpError(431, "request line too long")
    if not line:
        return None
    try:
        method, target, _version = line.decode().split()
    except ValueError:
        raise HttpError(400, "bad request line")
    headers = {}
    header_bytes = 0
    while True:
        try:
            h = await reader.readline()
        except ValueError:
            raise HttpError(431, "header line too long")
        if h in (b"\r\n", b"\n", b""):
            break
        header_bytes += len(h)
        if (
            len(headers) >= MAX_HEADER_COUNT
            or header_bytes > MAX_HEADER_BYTES
        ):
            raise HttpError(431, "too many request headers")
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    body = b""
    try:
        n = int(headers.get("content-length", 0))
    except ValueError:
        raise HttpError(400, "bad content-length")
    if n < 0:
        raise HttpError(400, "bad content-length")
    if n:
        if n > MAX_BODY:
            raise HttpError(413, "body too large")
        body = await reader.readexactly(n)
    return method, target, headers, body


def _resp(writer, status: int, body: bytes, content_type="application/json"):
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              413: "Payload Too Large",
              431: "Request Header Fields Too Large",
              500: "Internal Server Error",
              501: "Not Implemented",
              503: "Service Unavailable"}.get(status, "?")
    writer.write(
        f"HTTP/1.1 {status} {reason}\r\n"
        f"content-type: {content_type}\r\n"
        f"content-length: {len(body)}\r\n"
        "connection: keep-alive\r\n\r\n".encode() + body
    )


def _json_resp(writer, status: int, obj) -> None:
    _resp(writer, status, json.dumps(obj).encode())


async def _start_stream(writer, content_type="application/json"):
    writer.write(
        "HTTP/1.1 200 OK\r\n"
        f"content-type: {content_type}\r\n"
        "transfer-encoding: chunked\r\n"
        "connection: close\r\n\r\n".encode()
    )
    await writer.drain()


async def _stream_chunk(writer, data: bytes) -> None:
    writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
    await writer.drain()


async def _end_stream(writer) -> None:
    writer.write(b"0\r\n\r\n")
    await writer.drain()


async def serve_api(agent: "Agent") -> tuple[str, int]:
    async def on_conn(reader, writer):
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except HttpError as e:
                    _json_resp(writer, e.status, {"error": e.message})
                    await writer.drain()
                    if e.status in (431, 413):
                        # Bounded best-effort input drain before close,
                        # ONLY for the desync statuses whose request
                        # bytes are known-unread: closing with unread
                        # input RSTs the connection and can destroy the
                        # error response before the client reads it.
                        # Other errors (400s from a clean read) must not
                        # pay a 0.2 s lingering read per connection.
                        # Hard-capped — this must never become the
                        # unbounded read it guards against.
                        try:
                            for _ in range(16):
                                chunk = await asyncio.wait_for(
                                    reader.read(65536), 0.2
                                )
                                if not chunk:
                                    break
                        except (asyncio.TimeoutError, ConnectionError,
                                ValueError):
                            pass
                    break
                if req is None:
                    break
                method, target, headers, body = req
                url = urlparse(target)
                try:
                    keep = await _route(
                        agent, reader, writer, method, url.path,
                        parse_qs(url.query), body, headers,
                    )
                except HttpError as e:
                    _json_resp(writer, e.status, {"error": e.message})
                    keep = True
                except Exception as e:  # 500 (load-shed analogue is upstream)
                    _json_resp(writer, 500, {"error": repr(e)})
                    keep = True
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    rebuild_api_limits(agent)
    server = await asyncio.start_server(
        on_conn, agent.cfg.api_host, agent.cfg.api_port
    )
    agent._api_server = server
    sock = server.sockets[0].getsockname()
    return sock[0], sock[1]


def rebuild_api_limits(agent) -> None:
    """(Re)build the per-route admission limits from the current config —
    called at serve time and by config hot-reload so a changed
    api_concurrency takes effect without restart. In-flight requests keep
    their old limiter; new requests see the new one."""
    n = agent.cfg.api_concurrency
    metrics = getattr(agent, "metrics", None)

    def rl(route: str, limit: int) -> RouteLimit:
        return RouteLimit(limit, route=route, metrics=metrics)

    agent._api_limits = {
        "/v1/transactions": rl("/v1/transactions", n),
        "/v1/queries": rl("/v1/queries", n),
        "/v1/migrations": rl(
            "/v1/migrations", agent.cfg.migration_concurrency
        ),
        "/v1/subscriptions": rl("/v1/subscriptions", n),
    }


async def _route(
    agent, reader, writer, method, path, query, body, headers=None
) -> bool:
    """Dispatch; returns False when the connection was turned into a stream
    (and must close when the stream ends)."""
    route_key = "/".join(path.split("/")[:3])  # /v1/<route>
    limit = agent._api_limits.get(route_key)
    if limit is None:
        return await _dispatch(
            agent, reader, writer, method, path, query, body, lambda: None,
            headers,
        )
    # The limit bounds request SETUP, not stream lifetime: the reference's
    # ConcurrencyLimitLayer releases its permit when the handler returns
    # the response, before the body streams — a long-lived subscription
    # must not pin an admission slot (the 129th subscriber would shed).
    # Streaming branches call ``release`` once setup is done; the finally
    # covers every other path (idempotent via the once-guard).
    limit.__enter__()
    released = False

    def release() -> None:
        nonlocal released
        if not released:
            released = True
            limit.__exit__(None, None, None)

    try:
        return await _dispatch(
            agent, reader, writer, method, path, query, body, release,
            headers,
        )
    finally:
        release()


async def _dispatch(
    agent, reader, writer, method, path, query, body, release, headers=None
) -> bool:
    if method == "POST" and path == "/v1/transactions":
        stmts = [Statement.parse(o) for o in _json_body(body)]
        # Causal write tracing (opt-in, AgentConfig.trace_writes): every
        # write gets a trace id HERE, at ingest — continuing the client's
        # W3C `traceparent` header when one came in, so an end-to-end
        # journey joins on the caller's trace id. The root `api_write`
        # span covers request handling through the response body build;
        # the commit/fan-out children open inside execute_async. The
        # default path allocates no spans (pinned by tests).
        span = (
            agent.tracer.maybe_span(
                "api_write",
                traceparent=(headers or {}).get("traceparent"),
                route=path,
            )
            if getattr(agent, "_trace_writes", False) else None
        )
        if span is None:
            resp = await agent.execute_async(stmts)
        else:
            with span:
                resp = await agent.execute_async(stmts)
        _json_resp(writer, 200, resp.to_json_obj())
        return True
    if method == "POST" and path == "/v1/queries":
        stmt = Statement.parse(_json_body(body))
        # Pooled snapshot read (SplitPool read pool): large results never
        # stall the gossip loops.
        cols, rows = await agent.pool.query(stmt)
        await _start_stream(writer)
        await _stream_chunk(
            writer, json.dumps({"columns": cols}).encode() + b"\n"
        )
        for i, row in enumerate(rows):
            await _stream_chunk(
                writer,
                json.dumps({"row": [i + 1, _jsonable(row)]}).encode() + b"\n",
            )
        await _stream_chunk(writer, b'{"eoq":{}}\n')
        await _end_stream(writer)
        return False
    if method == "POST" and path == "/v1/migrations":
        stmts = _json_body(body)
        changed = agent.store.apply_schema(
            "\n".join(stmts if isinstance(stmts, list) else [stmts])
        )
        _json_resp(writer, 200, {"changed": changed})
        return True
    if method == "POST" and path == "/v1/subscriptions":
        if agent.subs is None:
            raise HttpError(501, "subscriptions not enabled")
        stmt = Statement.parse(_json_body(body))
        handle = agent.subs.subscribe(stmt.sql)
        release()  # setup done; the stream must not hold an admission slot
        await _stream_sub(agent, reader, writer, handle, from_change=None,
                          skip_rows=query.get("skip_rows") == ["true"])
        return False
    if method == "GET" and path == "/v1/subs/costs":
        # Live cost-ledger snapshot (docs/SERVING.md "Query-cost plane"):
        # top-K subscriptions by total eval seconds plus ledger-wide
        # totals. Works with the plane disarmed too — plan records are
        # always present; counters appear once enable_costs armed it.
        if agent.subs is None:
            raise HttpError(501, "subscriptions not enabled")
        top_q = query.get("top")
        try:
            top = int(top_q[0]) if top_q else None
        except ValueError as e:
            raise HttpError(400, f"bad top= value: {top_q[0]!r}") from e
        if top is not None and top < 0:
            raise HttpError(400, "top= must be >= 0")
        _json_resp(writer, 200, agent.subs.cost_snapshot(top=top))
        return True
    if method == "GET" and path.startswith("/v1/subscriptions/"):
        if agent.subs is None:
            raise HttpError(501, "subscriptions not enabled")
        sub_id = path.rsplit("/", 1)[1]
        handle = agent.subs.get(sub_id)
        if handle is None:
            raise HttpError(404, f"no such subscription {sub_id}")
        frm = query.get("from")
        release()  # setup done; the stream must not hold an admission slot
        await _stream_sub(
            agent, reader, writer, handle,
            from_change=int(frm[0]) if frm else None,
            skip_rows=query.get("skip_rows") == ["true"],
        )
        return False
    raise HttpError(404, f"no route for {method} {path}")


async def _stream_sub(
    agent, reader, writer, handle, from_change, skip_rows
) -> None:
    """NDJSON QueryEvent stream (api/public/pubsub.rs:36-180)."""
    await _start_stream(writer)
    queue = handle.attach()
    # Disconnect watch: an idle stream never writes, so a vanished client
    # would otherwise hold the handler (and its admission-control slot)
    # forever. Clients send nothing after the request, so any read
    # completion — EOF included — means the peer is gone. Deliberate
    # trade-off: a client that half-closes its write side (SHUT_WR) while
    # still reading gets its stream ended — admission-control slots must
    # not leak, and the SDK never half-closes; reconnect via ?from= covers
    # the exotic client.
    eof = asyncio.ensure_future(reader.read(1))
    try:
        for ev in handle.backlog(from_change=from_change, skip_rows=skip_rows):
            await _stream_chunk(
                writer, json.dumps(_json_safe(ev.to_json_obj())).encode() + b"\n"
            )
        while not agent.tripwire.tripped and not eof.done():
            if handle.lossy(queue):
                # The listener queue overflowed: events were dropped, so
                # continuing would silently violate exactly-once
                # delivery. Flush what IS queued (all older than the
                # drop), then end the stream — the client reconnects
                # with ?from= and the durable log replays the gap.
                while True:
                    try:
                        ev = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    await _stream_chunk(
                        writer,
                        json.dumps(
                            _json_safe(ev.to_json_obj())
                        ).encode() + b"\n",
                    )
                break
            try:
                ev = await asyncio.wait_for(queue.get(), timeout=0.5)
            except asyncio.TimeoutError:
                continue
            await _stream_chunk(
                writer, json.dumps(_json_safe(ev.to_json_obj())).encode() + b"\n"
            )
    finally:
        eof.cancel()
        handle.detach(queue)
        try:
            await _end_stream(writer)
        except (ConnectionError, OSError):
            pass


def _json_body(body: bytes):
    if not body:
        raise HttpError(400, "empty body")
    try:
        return json.loads(body)
    except json.JSONDecodeError as e:
        raise HttpError(400, f"bad json: {e}")


def _jsonable(row):
    return [
        v.hex() if isinstance(v, bytes) else v for v in row
    ]


def _json_safe(obj):
    """Recursive bytes -> hex for event payloads (BLOB cells)."""
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj

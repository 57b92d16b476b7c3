"""Gossip transport: UDP datagrams + length-delimited frames over TCP.

The reference multiplexes three planes over QUIC (SURVEY.md §5: datagrams =
SWIM, uni streams = broadcast, bi streams = sync) with a cached
connection-per-addr pool (corro-agent/src/transport.rs:26-63). Python's
stdlib has no QUIC, so the host agent keeps the same plane split:

- an **unreliable datagram plane** for SWIM packets (send_datagram — one
  UDP socket bound beside the TCP gossip port, ≤1178 B per packet like
  foca's max_packet_size, broadcast/mod.rs:710). UDP sends never connect
  and never block, so a black-holing peer cannot stall the probe loop;
  oversized or UDP-less sends fall back to the stream plane transparently.
- one-shot stream frames for broadcast changesets (send_frame, pooled
  connections, reconnect-once semantics like transport.rs:75-89);
- a request/stream exchange for sync sessions (open_session), the
  bi-stream analogue of peer.rs:925-1527.

Per-addr **circuit breaker**: a peer whose sends keep failing (or whose
connect black-holes past the timeout) trips open after
``BREAKER_THRESHOLD`` consecutive failures and fails fast for an
exponentially growing cooldown — the transport-level complement of the
reference's reconnect-once + backoff (transport.rs:75-89). Without it a
SYN-dropping peer costs every caller the full connect timeout.

Frames are 4-byte big-endian length + a kind byte + body (datagrams carry
kind + body without the length prefix — the packet delimits itself). Kind 1
is the compact binary codec (the speedy-encoding role of
corro-types/src/broadcast.rs), encoded by the native runtime
(the port's ``native.py``, built into build/native) when built; kind 0 is JSON with bytes values as
{"$b": hex}, the encode fallback without a C toolchain. Decoding accepts
both kinds on every peer — a pure-Python binary decoder below keeps mixed
native/non-native clusters fully interoperable. Counterpart of
corrosion_tpu/agent/transport.py.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
from typing import Any, Callable, Awaitable

from corrosion_tpu_torch import native as _native

MAX_FRAME = 32 * 1024 * 1024
MAX_DATAGRAM = 1178  # foca max_packet_size (broadcast/mod.rs:710)

FRAME_JSON = 0
FRAME_BIN = 1

# Causal-trace wire header: broadcast changeset frames may carry a W3C
# traceparent under this key (the SyncTraceContextV1 role for the
# broadcast plane, sync.rs:32-67) so a write's dissemination chain
# reconstructs across hops — each relay re-stamps the frame with ITS
# ingest span's traceparent, parenting the next hop's span on this one.
# Absent on untraced/unsampled writes; relays without tracing forward it
# untouched (the chain skips them but stays connected by trace id).
TRACE_KEY = "trace"


def attach_trace(frame: dict, traceparent: str | None) -> dict:
    """Stamp (or re-stamp) a frame's trace header in place; a None
    traceparent leaves the frame untouched."""
    if traceparent is not None:
        frame[TRACE_KEY] = traceparent
    return frame


def extract_trace(frame: dict) -> str | None:
    """The frame's traceparent header, or None. Malformed values are
    dropped here (one validation point) so ingest never parents a span
    on garbage a peer sent."""
    tp = frame.get(TRACE_KEY)
    if isinstance(tp, str):
        from corrosion_tpu_torch.utils.tracing import parse_traceparent

        if parse_traceparent(tp) is not None:
            return tp
    return None

# Circuit breaker: consecutive failures before tripping, and the cooldown
# schedule (doubles per further failure, capped).
BREAKER_THRESHOLD = 3
BREAKER_BASE_S = 1.0
BREAKER_MAX_S = 30.0


def encode_value(o: Any) -> Any:
    if isinstance(o, bytes):
        return {"$b": o.hex()}
    if isinstance(o, (list, tuple)):
        return [encode_value(x) for x in o]
    if isinstance(o, dict):
        return {k: encode_value(v) for k, v in o.items()}
    return o


def decode_value(o: Any) -> Any:
    if isinstance(o, dict):
        if set(o.keys()) == {"$b"}:
            return bytes.fromhex(o["$b"])
        return {k: decode_value(v) for k, v in o.items()}
    if isinstance(o, list):
        return [decode_value(x) for x in o]
    return o


def encode_frame(msg: dict) -> bytes:
    if _native.native is not None:
        body = bytes([FRAME_BIN]) + _native.native.encode(msg)
    else:
        body = bytes([FRAME_JSON]) + json.dumps(
            encode_value(msg), separators=(",", ":")
        ).encode()
    return struct.pack(">I", len(body)) + body


# Binary wire tags (native/corro_native.c W_*; keep in sync).
_W_NULL, _W_FALSE, _W_TRUE, _W_INT = 0, 1, 2, 3
_W_FLOAT, _W_STR, _W_BYTES, _W_LIST, _W_DICT = 4, 5, 6, 7, 8


def _py_read_varint(b: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(b) or shift > 63:
            raise ValueError("truncated wire varint")
        byte = b[i]
        i += 1
        n |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return n, i
        shift += 7


def _py_wire_decode(b: bytes, i: int = 0, depth: int = 0) -> tuple[Any, int]:
    """Pure-Python decoder for the binary wire format (parity with the C
    decoder; used when the native module is not built)."""
    if depth > 64 or i >= len(b):
        raise ValueError("bad wire value")
    tag = b[i]
    i += 1
    if tag == _W_NULL:
        return None, i
    if tag == _W_FALSE:
        return False, i
    if tag == _W_TRUE:
        return True, i
    if tag == _W_INT:
        z, i = _py_read_varint(b, i)
        return (z >> 1) ^ -(z & 1), i
    if tag == _W_FLOAT:
        if i + 8 > len(b):
            raise ValueError("truncated wire float")
        return struct.unpack_from(">d", b, i)[0], i + 8
    if tag in (_W_STR, _W_BYTES):
        n, i = _py_read_varint(b, i)
        if i + n > len(b):
            raise ValueError("truncated wire string")
        raw = b[i : i + n]
        return (raw.decode("utf-8") if tag == _W_STR else raw), i + n
    if tag == _W_LIST:
        n, i = _py_read_varint(b, i)
        out = []
        for _ in range(n):
            v, i = _py_wire_decode(b, i, depth + 1)
            out.append(v)
        return out, i
    if tag == _W_DICT:
        n, i = _py_read_varint(b, i)
        d: dict = {}
        for _ in range(n):
            kn, i = _py_read_varint(b, i)
            if i + kn > len(b):
                raise ValueError("truncated wire key")
            key = b[i : i + kn].decode("utf-8")
            i += kn
            d[key], i = _py_wire_decode(b, i, depth + 1)
        return d, i
    raise ValueError(f"bad wire tag {tag}")


def decode_frame_body(body: bytes) -> dict:
    if not body:
        raise ValueError("empty frame")
    kind, payload = body[0], body[1:]
    if kind == FRAME_BIN:
        if _native.native is not None:
            return _native.native.decode(payload)
        obj, end = _py_wire_decode(payload)
        if end != len(payload):
            raise ValueError("trailing bytes after wire value")
        return obj
    if kind == FRAME_JSON:
        return decode_value(json.loads(payload))
    raise ValueError(f"unknown frame kind {kind}")


async def read_frame(reader: asyncio.StreamReader) -> dict | None:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (n,) = struct.unpack(">I", header)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    try:
        body = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return decode_frame_body(body)


class Breaker:
    """Per-peer circuit breaker state (see module docstring). The
    threshold/cooldown schedule is instance-configurable so chaos
    harnesses can compress the cooldown into test time; defaults are
    the module constants."""

    __slots__ = ("fails", "open_until", "threshold", "base_s", "max_s")

    def __init__(
        self,
        threshold: int = BREAKER_THRESHOLD,
        base_s: float = BREAKER_BASE_S,
        max_s: float = BREAKER_MAX_S,
    ) -> None:
        self.fails = 0
        self.open_until = 0.0
        self.threshold = threshold
        self.base_s = base_s
        self.max_s = max_s

    def available(self) -> bool:
        return time.monotonic() >= self.open_until

    def ok(self) -> bool:
        """Reset on success. Returns True when this closed a previously
        tripped breaker (a recovery — the observability counterpart of
        the trip edge)."""
        recovered = self.fails >= self.threshold
        self.fails = 0
        self.open_until = 0.0
        return recovered

    def fail(self) -> bool:
        """Record a failure. Returns True on an available→open edge (a
        trip) — including a re-trip after a cooldown expired — so the
        caller can count trips without re-deriving the transition."""
        tripped = self.fails + 1 >= self.threshold and self.available()
        self.fails += 1
        if self.fails >= self.threshold:
            over = self.fails - self.threshold
            cooldown = min(self.base_s * (2.0 ** over), self.max_s)
            self.open_until = time.monotonic() + cooldown
        return tripped


class _DatagramPlane(asyncio.DatagramProtocol):
    """Inbound side of the UDP gossip socket; frames dispatch to the same
    handler as stream frames, with a reply-less session."""

    # In-flight dispatch cap: past this, inbound packets drop (the
    # unreliable plane's legitimate response to a flood).
    MAX_PENDING = 1024

    def __init__(self, handler, owner: "Transport | None" = None) -> None:
        self._handler = handler
        self._owner = owner
        self.transport: asyncio.DatagramTransport | None = None
        # Strong refs: the event loop only weak-refs tasks, and a GC'd
        # dispatch task would silently swallow a ping/ack.
        self._pending: set[asyncio.Task] = set()

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        if self._owner is not None:
            self._owner._count("datagrams_recv")
            self._owner._count("bytes_recv", len(data))
        if len(self._pending) >= self.MAX_PENDING:
            return  # flood: drop like any saturated datagram socket
        try:
            msg = decode_frame_body(data)
        except (ValueError, UnicodeDecodeError):
            return  # malformed packet: drop (unreliable plane)
        task = asyncio.ensure_future(self._dispatch(msg))
        self._pending.add(task)
        task.add_done_callback(self._pending.discard)

    async def _dispatch(self, msg: dict) -> None:
        try:
            await self._handler(DatagramSession(), msg)
        except Exception:
            pass  # handler errors must not kill the UDP protocol


class DatagramSession:
    """Session stand-in for datagram-delivered frames: replies flow via
    explicit peer addresses (SWIM carries from_addr), never the session."""

    async def send(self, msg: dict) -> None:
        raise ConnectionError("datagram session cannot stream replies")

    async def recv(self, timeout: float = 0.0) -> None:
        return None

    def close(self) -> None:
        pass


class Transport:
    """Pooled one-shot sender + datagram plane + session opener + server.

    Optional TLS (agent/tls.py): pass an ``ssl.SSLContext`` for the server
    (inbound gossip) and/or client (outbound) side — the rustls configs of
    peer.rs:132-313. mTLS comes from the contexts themselves. With TLS the
    datagram plane is disabled (plaintext UDP would downgrade the gossip
    plane; QUIC datagrams in the reference are encrypted) and SWIM rides
    the TLS stream path.
    """

    # Outbound datagram sockets, addr-hashed (the reference's 8 QUIC
    # client endpoints, transport.rs:54-57): spreads kernel socket-buffer
    # pressure across sockets under gossip bursts.
    N_CLIENT_ENDPOINTS = 8

    def __init__(
        self,
        ssl_server=None,
        ssl_client=None,
        connect_timeout: float = 3.0,
        send_timeout: float = 5.0,
        metrics=None,
        netem=None,
        breaker_threshold: int = BREAKER_THRESHOLD,
        breaker_base_s: float = BREAKER_BASE_S,
        breaker_max_s: float = BREAKER_MAX_S,
    ) -> None:
        self._pool: dict[tuple[str, int], tuple[asyncio.StreamReader, asyncio.StreamWriter]] = {}
        # Per-addr dial serialization: two tasks missing the pool at
        # once must not both dial — the loser's socket would be
        # overwritten in the pool and leak (never closed by _drop).
        self._dial_locks: dict[tuple[str, int], asyncio.Lock] = {}
        self._locks: dict[tuple[str, int], asyncio.Lock] = {}
        self._breakers: dict[tuple[str, int], Breaker] = {}
        # ACCEPTED connections, tracked so close() kills them too. An
        # asyncio server's close() only stops LISTENING; in-process the
        # event loop would keep serving already-accepted peers of a
        # "dead" agent forever — peers' pooled sends would keep
        # succeeding against a corpse, which no real process death
        # allows (and which kept the circuit breaker from ever seeing
        # the crash in the chaos harness).
        self._accepted: set[asyncio.StreamWriter] = set()
        self._server: asyncio.AbstractServer | None = None
        self._udp: asyncio.DatagramTransport | None = None
        self._client_udp: list[asyncio.DatagramTransport] = []
        self._ssl_server = ssl_server
        self._ssl_client = ssl_client
        self.connect_timeout = connect_timeout
        # Blocking-send abort (the reference aborts a sync send blocked
        # > 5 s, peer.rs:352-355; same guard here for any frame send).
        self.send_timeout = send_timeout
        # Deterministic impairment shim (agent/netem.py); None = the
        # bit-identical unimpaired path (a single branch per operation).
        self._netem = netem
        self._breaker_threshold = breaker_threshold
        self._breaker_base_s = breaker_base_s
        self._breaker_max_s = breaker_max_s
        # Aggregate transport metrics (Transport::emit_metrics,
        # transport.rs:225+): frames/datagrams/bytes both ways, pooled
        # connections, open breakers.
        self._m = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, registry) -> None:
        self._m = {
            "frames_sent": registry.counter(
                "corro_peer_streams_sent", "stream frames sent"
            ),
            "frames_recv": registry.counter(
                "corro_peer_streams_recv", "stream frames received"
            ),
            "datagrams_sent": registry.counter(
                "corro_peer_datagrams_sent", "UDP datagrams sent"
            ),
            "datagrams_recv": registry.counter(
                "corro_peer_datagrams_recv", "UDP datagrams received"
            ),
            "bytes_sent": registry.counter(
                "corro_peer_bytes_sent", "wire bytes sent (frames+datagrams)"
            ),
            "bytes_recv": registry.counter(
                "corro_peer_bytes_recv", "wire bytes received"
            ),
            "send_failures": registry.counter(
                "corro_peer_send_failures", "failed frame sends"
            ),
            "conns": registry.gauge(
                "corro_peer_connections", "pooled outbound connections"
            ),
            "breakers_open": registry.gauge(
                "corro_peer_breakers_open", "peers with an open circuit breaker"
            ),
            # Trip/recovery EDGES, per peer: the open-breaker gauge shows
            # the steady state but a trip that opens and cools down
            # between scrapes was invisible — the host chaos harness
            # asserts on these to prove the defense actually fired.
            "breaker_trips": registry.counter(
                "corro_peer_breaker_trips_total",
                "circuit-breaker open transitions, by peer addr",
            ),
            "breaker_recoveries": registry.counter(
                "corro_peer_breaker_recoveries_total",
                "circuit-breaker recoveries (first success after a trip)",
            ),
        }

    def _count(self, key: str, n: int = 1) -> None:
        if self._m is not None:
            self._m[key].inc(n)

    def _sample_gauges(self) -> None:
        if self._m is not None:
            self._m["conns"].set(len(self._pool))
            self._m["breakers_open"].set(
                sum(1 for b in self._breakers.values() if not b.available())
            )

    # -- circuit breaker -----------------------------------------------------

    def breaker(self, addr: tuple[str, int]) -> Breaker:
        br = self._breakers.get(addr)
        if br is None:
            br = self._breakers[addr] = Breaker(
                threshold=self._breaker_threshold,
                base_s=self._breaker_base_s,
                max_s=self._breaker_max_s,
            )
        return br

    def _breaker_fail(self, addr: tuple[str, int], br: Breaker) -> None:
        """One failed operation: breaker bookkeeping + the failure/trip
        counters (shared by frame sends and session opens)."""
        if br.fail() and self._m is not None:
            self._m["breaker_trips"].inc(addr=f"{addr[0]}:{addr[1]}")
        self._count("send_failures")
        self._sample_gauges()

    def _breaker_ok(self, addr: tuple[str, int], br: Breaker) -> None:
        if br.ok() and self._m is not None:
            self._m["breaker_recoveries"].inc(addr=f"{addr[0]}:{addr[1]}")

    # -- outbound ------------------------------------------------------------

    def send_datagram(self, addr: tuple[str, int], msg: dict) -> bool:
        """Unreliable, non-blocking single-packet send (the SWIM plane,
        Transport::send_datagram, transport.rs:66-90) over one of the
        addr-hashed client endpoints. Returns False when the packet
        exceeds MAX_DATAGRAM or the UDP sockets are absent — callers
        needing delivery-or-fallback use ``send_packet``."""
        if self._udp is None or not self._client_udp:
            return False
        body = encode_frame(msg)[4:]  # kind + payload; packet self-delimits
        if len(body) > MAX_DATAGRAM:
            return False
        sock = self._client_udp[hash(addr) % len(self._client_udp)]
        if self._netem is not None:
            v = self._netem.udp_fault(addr)
            if v.drop:
                # Lost in the (simulated) network: the sender cannot
                # tell, exactly like a real dropped datagram.
                return True
            if v.delay_s > 0.0 or v.dup:
                return self._udp_send_impaired(sock, body, addr, v)
        try:
            sock.sendto(body, addr)
            self._count("datagrams_sent")
            self._count("bytes_sent", len(body))
            return True
        except OSError:
            return False

    def _udp_send_impaired(self, sock, body, addr, v) -> bool:
        """Delayed/duplicated datagram emission: late sends are
        scheduled, so unequal jitter across packets reorders them on the
        wire like a real WAN path would. Counters tick at the ACTUAL
        send, never for scheduled copies that die with the socket."""
        copies = 2 if v.dup else 1
        if v.delay_s > 0.0:
            def emit() -> None:
                # A delayed send may fire after the transport closed
                # (agent stop/crash mid-jitter): a late datagram into a
                # closed socket is just a lost packet, never an error.
                if sock.is_closing():
                    return
                try:
                    sock.sendto(body, addr)
                except Exception:
                    return
                self._count("datagrams_sent")
                self._count("bytes_sent", len(body))

            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return False
            for _ in range(copies):
                loop.call_later(v.delay_s, emit)
            return True  # in flight; a WAN sender can't know its fate
        sent = False
        for _ in range(copies):
            try:
                sock.sendto(body, addr)
            except OSError:
                continue  # same contract as the unimpaired path
            sent = True
            self._count("datagrams_sent")
            self._count("bytes_sent", len(body))
        return sent

    async def send_packet(self, addr: tuple[str, int], msg: dict) -> bool:
        """SWIM packet send: datagram when possible, stream fallback for
        oversized packets (bootstrap `known` dumps) or UDP-less/TLS mode."""
        if self.send_datagram(addr, msg):
            return True
        return await self.send_frame(addr, msg)

    async def send_frame(self, addr: tuple[str, int], msg: dict) -> bool:
        """Fire-and-forget frame (uni-stream analogue). One retry with a
        fresh connection on failure (transport.rs:75-89); fails fast while
        the peer's circuit breaker is open."""
        br = self.breaker(addr)
        if not br.available():
            return False
        if self._netem is not None:
            v = self._netem.stream_fault("bcast", addr)
            if v.drop:
                return True  # frame vanished in the impaired network
            if v.block_s is not None:
                # Cut link: burn the dial stall, then take the normal
                # failure path — exactly what feeds the breaker.
                await asyncio.sleep(v.block_s)
                self._breaker_fail(addr, br)
                return False
            if v.delay_s > 0.0:
                await asyncio.sleep(v.delay_s)
        lock = self._locks.setdefault(addr, asyncio.Lock())
        async with lock:
            if not br.available():
                return False  # tripped while we waited on the lock
            for attempt in (0, 1):
                try:
                    _, writer = await self._conn(addr, fresh=attempt > 0)
                    frame = encode_frame(msg)
                    writer.write(frame)
                    await asyncio.wait_for(writer.drain(), self.send_timeout)
                    self._breaker_ok(addr, br)
                    self._count("frames_sent")
                    self._count("bytes_sent", len(frame))
                    self._sample_gauges()
                    return True
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    self._drop(addr)
        self._breaker_fail(addr, br)
        return False

    async def open_session(
        self, addr: tuple[str, int], first: dict, timeout: float = 10.0
    ) -> "Session | None":
        """Dedicated connection for a sync exchange (bi-stream analogue)."""
        br = self.breaker(addr)
        if not br.available():
            return None
        if self._netem is not None:
            v = self._netem.stream_fault("sync", addr)
            if v.block_s is not None:
                await asyncio.sleep(v.block_s)
                self._breaker_fail(addr, br)
                return None
            if v.delay_s > 0.0:
                await asyncio.sleep(v.delay_s)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(*addr, ssl=self._ssl_client), timeout
            )
            frame = encode_frame(first)
            writer.write(frame)
            await writer.drain()
            self._breaker_ok(addr, br)
            self._count("frames_sent")
            self._count("bytes_sent", len(frame))
            return Session(
                reader, writer, counter=self._count,
                netem=self._netem, peer=addr,
            )
        except (ConnectionError, OSError, asyncio.TimeoutError):
            self._breaker_fail(addr, br)
            return None

    async def _conn(self, addr, fresh=False):
        if fresh:
            self._drop(addr)
        lock = self._dial_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            if addr not in self._pool:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*addr, ssl=self._ssl_client),
                    self.connect_timeout,
                )
                self._pool[addr] = (reader, writer)
            return self._pool[addr]

    def _drop(self, addr) -> None:
        pair = self._pool.pop(addr, None)
        if pair:
            try:
                pair[1].close()
            except Exception:
                pass

    # -- inbound -------------------------------------------------------------

    async def serve(
        self,
        host: str,
        port: int,
        handler: Callable[["Session", dict], Awaitable[None]],
    ) -> tuple[str, int]:
        """Accept connections; dispatch each inbound frame to ``handler``.
        The handler may keep the session for a streaming exchange. Also
        binds the UDP datagram plane on the same port (plaintext mode
        only); if the UDP bind fails, gossip degrades to stream-only."""

        async def on_conn(reader, writer):
            # Inbound sessions stream sync replies back to the dialer;
            # their peer is an ephemeral client port the shim cannot
            # name, so netem impairment on them matches wildcard-link
            # components only (documented in agent/netem.py).
            session = Session(
                reader, writer, counter=self._count,
                netem=self._netem,
                peer=writer.get_extra_info("peername"),
            )
            self._accepted.add(writer)
            try:
                while True:
                    msg = await read_frame(reader)
                    if msg is None:
                        break
                    self._count("frames_recv")
                    await handler(session, msg)
            except ConnectionError:
                pass
            except asyncio.CancelledError:
                raise  # server shutdown: cleanup runs, cancellation flows
            except ValueError:
                pass  # malformed frame: drop the connection cleanly
            finally:
                self._accepted.discard(writer)
                session.close()

        self._server = await asyncio.start_server(
            on_conn, host, port, ssl=self._ssl_server
        )
        sock = self._server.sockets[0].getsockname()
        if self._ssl_server is None:
            try:
                loop = asyncio.get_running_loop()
                self._udp, _ = await loop.create_datagram_endpoint(
                    lambda: _DatagramPlane(handler, self),
                    local_addr=(sock[0], sock[1]),
                )
                # Addr-hashed outbound endpoints (transport.rs:54-57's 8
                # client endpoints). SWIM replies target the peer's
                # ADVERTISED addr (from_addr in the packet), never the
                # packet's source, so ephemeral-port client sockets are
                # send-only.
                for _ in range(self.N_CLIENT_ENDPOINTS):
                    t, _p = await loop.create_datagram_endpoint(
                        asyncio.DatagramProtocol,
                        local_addr=(sock[0], 0),
                    )
                    self._client_udp.append(t)
            except OSError:
                # Atomic: a failed client-endpoint bind must not leave a
                # recv-only gossip socket behind (or leak it past close()).
                if self._udp is not None:
                    self._udp.close()
                self._udp = None  # corro-lint: disable=CT040 reason=serve() runs once at startup; the OSError unwind must null the shared handle it just closed
                for t in self._client_udp:
                    t.close()
                self._client_udp = []
        return sock[0], sock[1]

    def close(self) -> None:
        for addr in list(self._pool):
            self._drop(addr)
        for w in list(self._accepted):
            try:
                w.close()
            except Exception:
                pass
        self._accepted.clear()
        if self._udp is not None:
            self._udp.close()
        for t in self._client_udp:
            t.close()
        self._client_udp = []
        if self._server is not None:
            self._server.close()


class Session:
    """One connection usable for framed request/stream exchanges. The
    optional counter keeps sync-session traffic visible to the transport
    metrics (emit_metrics parity — sync dominates wire bytes during
    catch-up)."""

    def __init__(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
        counter=None, netem=None, peer=None,
    ):
        self.reader = reader
        self.writer = writer
        self._count = counter or (lambda key, n=1: None)
        # Session sends are the sync plane's wire surface (the only
        # streaming exchange): the netem shim paces them with "sync"
        # delay components — which is exactly what the adaptive chunker
        # and the blocking-send stall guard observe — and a cut link
        # fails them after the stall.
        self._netem = netem
        self._peer = peer

    async def send(self, msg: dict) -> int:
        if self._netem is not None and self._peer is not None:
            v = self._netem.stream_fault("sync", self._peer)
            if v.block_s is not None:
                await asyncio.sleep(v.block_s)
                raise ConnectionError("netem: sync link cut")
            if v.delay_s > 0.0:
                await asyncio.sleep(v.delay_s)
        frame = encode_frame(msg)
        self.writer.write(frame)
        await self.writer.drain()
        self._count("frames_sent")
        self._count("bytes_sent", len(frame))
        return len(frame)

    async def recv(self, timeout: float = 30.0) -> dict | None:
        try:
            msg = await asyncio.wait_for(read_frame(self.reader), timeout)
        except asyncio.TimeoutError:
            return None
        if msg is not None:
            self._count("frames_recv")
        return msg

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

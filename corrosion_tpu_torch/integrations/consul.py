"""Consul bridge: poll the local Consul agent, upsert diffs into corrosion.

The reference polls Consul every 1 s, hashes services/checks (seahash), and
writes only changed rows into the `consul_services` / `consul_checks`
tables, remembering hashes in `__corro_consul_*` node-local tables
(corrosion/src/command/consul/sync.rs:20-246,408-530; HTTP client in
consul-client). Same structure here with a stdlib HTTP client and blake2b
hashing.

Counterpart of corrosion_tpu/integrations/consul.py.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging

from corrosion_tpu_torch.agent.config import Config, parse_addr
from corrosion_tpu_torch.client import CorrosionApiClient

SETUP_SQL = """
CREATE TABLE IF NOT EXISTS __corro_consul_services (
  node TEXT NOT NULL, id TEXT NOT NULL, hash TEXT NOT NULL,
  PRIMARY KEY (node, id)
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS __corro_consul_checks (
  node TEXT NOT NULL, id TEXT NOT NULL, hash TEXT NOT NULL,
  PRIMARY KEY (node, id)
) WITHOUT ROWID;
"""

# The replicated tables the operator's schema must provide (doc'd by the
# reference's consul docs): consul_services(node, id, name, tags, meta,
# port, address, updated_at) / consul_checks(node, id, service_id,
# service_name, name, status, output, updated_at).


def hash_service(svc: dict) -> bytes:
    """Stable digest over the identity-relevant fields (sync.rs:214-233)."""
    key = json.dumps(
        {
            "id": svc.get("ID"),
            "name": svc.get("Service"),
            "tags": sorted(svc.get("Tags") or []),
            "meta": svc.get("Meta") or {},
            "port": svc.get("Port"),
            "address": svc.get("Address"),
        },
        sort_keys=True,
    )
    return hashlib.blake2b(key.encode(), digest_size=8).digest()


def hash_check(chk: dict) -> bytes:
    """Checks hash on status-relevant fields only (sync.rs:235-246)."""
    key = json.dumps(
        {
            "id": chk.get("CheckID"),
            "service_id": chk.get("ServiceID"),
            "status": chk.get("Status"),
            "output": chk.get("Output"),
        },
        sort_keys=True,
    )
    return hashlib.blake2b(key.encode(), digest_size=8).digest()


def diff_statements(
    node: str,
    services: dict[str, dict],
    checks: dict[str, dict],
    known_services: dict[str, bytes],
    known_checks: dict[str, bytes],
) -> tuple[list[list], dict[str, bytes], dict[str, bytes]]:
    """Compute upsert/delete statements + the new hash tables
    (update_consul/execute, sync.rs:408-530). Pure, for testing."""
    stmts: list[list] = []
    new_svc_hashes: dict[str, bytes] = {}
    for sid, svc in services.items():
        h = hash_service(svc)
        new_svc_hashes[sid] = h
        if known_services.get(sid) == h:
            continue
        stmts.append(
            [
                "INSERT INTO consul_services"
                " (node, id, name, tags, meta, port, address, updated_at)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, strftime('%s','now'))"
                " ON CONFLICT (node, id) DO UPDATE SET"
                " name=excluded.name, tags=excluded.tags, meta=excluded.meta,"
                " port=excluded.port, address=excluded.address,"
                " updated_at=excluded.updated_at",
                [
                    node, sid, svc.get("Service") or "",
                    json.dumps(svc.get("Tags") or []),
                    json.dumps(svc.get("Meta") or {}),
                    svc.get("Port") or 0, svc.get("Address") or "",
                ],
            ]
        )
    for sid in known_services:
        if sid not in services:
            stmts.append(
                ["DELETE FROM consul_services WHERE node = ? AND id = ?",
                 [node, sid]]
            )
    new_chk_hashes: dict[str, bytes] = {}
    for cid, chk in checks.items():
        h = hash_check(chk)
        new_chk_hashes[cid] = h
        if known_checks.get(cid) == h:
            continue
        stmts.append(
            [
                "INSERT INTO consul_checks"
                " (node, id, service_id, service_name, name, status, output,"
                "  updated_at)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, strftime('%s','now'))"
                " ON CONFLICT (node, id) DO UPDATE SET"
                " service_id=excluded.service_id,"
                " service_name=excluded.service_name, name=excluded.name,"
                " status=excluded.status, output=excluded.output,"
                " updated_at=excluded.updated_at",
                [
                    node, cid, chk.get("ServiceID") or "",
                    chk.get("ServiceName") or "", chk.get("Name") or "",
                    chk.get("Status") or "", chk.get("Output") or "",
                ],
            ]
        )
    for cid in known_checks:
        if cid not in checks:
            stmts.append(
                ["DELETE FROM consul_checks WHERE node = ? AND id = ?",
                 [node, cid]]
            )
    return stmts, new_svc_hashes, new_chk_hashes


class ConsulHttp:
    """Minimal Consul agent HTTP client (consul-client's role)."""

    def __init__(self, address: str):
        self.host, self.port = parse_addr(address)

    async def _get(self, path: str):
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            writer.write(
                f"GET {path} HTTP/1.1\r\nhost: {self.host}\r\n"
                "connection: close\r\n\r\n".encode()
            )
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        status = int(head.split()[1])
        if status != 200:
            raise RuntimeError(f"consul HTTP {status}")
        if b"chunked" in head.lower():
            body = _dechunk(body)
        return json.loads(body)

    async def agent_services(self) -> dict:
        return await self._get("/v1/agent/services")

    async def agent_checks(self) -> dict:
        return await self._get("/v1/agent/checks")


def _dechunk(body: bytes) -> bytes:
    out = b""
    while body:
        size_line, _, rest = body.partition(b"\r\n")
        n = int(size_line, 16)
        if n == 0:
            break
        out += rest[:n]
        body = rest[n + 2:]
    return out


async def _setup(
    client: CorrosionApiClient, node: str
) -> tuple[dict, dict]:
    """Create the node-local hash tables and load persisted hashes
    (sync.rs setup, :119-160). ``__corro_*`` tables are not CRRs, so these
    writes stay node-local — exactly the reference's split between the
    replicated consul_* tables and the local bookkeeping. Hashes key by
    (node, id): a hostname change must re-upsert everything under the new
    node name, not silently skip it."""
    stmts = [s for s in SETUP_SQL.split(";") if s.strip()]
    await client.execute([[s] for s in stmts])
    # Hash tables are pure caches: a layout mismatch (e.g. the pre-node
    # id-keyed schema — CREATE IF NOT EXISTS cannot migrate it) is fixed
    # by dropping and recreating; worst case one full re-upsert.
    try:
        await client.query(
            "SELECT node FROM __corro_consul_services LIMIT 0"
        )
        await client.query(
            "SELECT node FROM __corro_consul_checks LIMIT 0"
        )
    except Exception:
        await client.execute(
            [["DROP TABLE IF EXISTS __corro_consul_services"],
             ["DROP TABLE IF EXISTS __corro_consul_checks"]]
            + [[s] for s in stmts]
        )
    known_services: dict[str, bytes] = {}
    known_checks: dict[str, bytes] = {}
    from corrosion_tpu_torch.core.values import Statement

    _, rows = await client.query(Statement(
        "SELECT id, hash FROM __corro_consul_services WHERE node = ?",
        params=[node],
    ))
    for sid, h in rows:
        known_services[sid] = bytes.fromhex(h)
    _, rows = await client.query(Statement(
        "SELECT id, hash FROM __corro_consul_checks WHERE node = ?",
        params=[node],
    ))
    for cid, h in rows:
        known_checks[cid] = bytes.fromhex(h)
    return known_services, known_checks


def _hash_persist_statements(
    node: str, old: dict[str, bytes], new: dict[str, bytes], table: str
) -> list[list]:
    stmts: list[list] = []
    for key, h in new.items():
        if old.get(key) != h:
            # Hex: blobs don't ride the JSON statement API.
            stmts.append(
                [f"INSERT OR REPLACE INTO {table} (node, id, hash)"
                 " VALUES (?, ?, ?)",
                 [node, key, h.hex()]]
            )
    for key in old:
        if key not in new:
            stmts.append(
                [f"DELETE FROM {table} WHERE node = ? AND id = ?",
                 [node, key]]
            )
    return stmts


async def run_consul_sync(cfg: Config, iterations: int | None = None) -> None:
    """Poll-and-upsert loop (sync.rs run, :20-117). Diff hashes persist in
    ``__corro_consul_*`` so a bridge restart does not re-upsert the world
    (and churn every subscription on consul_services)."""
    import socket

    node = socket.gethostname()
    consul = ConsulHttp(cfg.consul.address)
    host, port = parse_addr(cfg.api.addr)
    client = CorrosionApiClient(host, port)
    known = None  # lazily set up: the API may not be listening yet
    warned = False
    i = 0
    while iterations is None or i < iterations:
        i += 1
        try:
            if known is None:
                known = await _setup(client, node)
            known_services, known_checks = known
            services = await consul.agent_services()
            checks = await consul.agent_checks()
            stmts, new_services, new_checks = diff_statements(
                node, services, checks, known_services, known_checks
            )
            stmts += _hash_persist_statements(
                node, known_services, new_services, "__corro_consul_services"
            )
            stmts += _hash_persist_statements(
                node, known_checks, new_checks, "__corro_consul_checks"
            )
            if stmts:
                await client.execute(stmts)
            # Adopt the hash state only after the corrosion write succeeded;
            # a failed tick must re-diff (and re-send) next tick.
            known = (new_services, new_checks)
        except Exception:
            # Unreachable consul/corrosion or a rejected write: retry next
            # tick — but leave a VISIBLE trail (warning on the first
            # failure, debug on repeats), or a permanently failing bridge
            # looks identical to a healthy idle one.
            log = logging.getLogger(__name__)
            if not warned:
                warned = True
                log.warning("consul sync tick failed", exc_info=True)
            else:
                log.debug("consul sync tick failed", exc_info=True)
        else:
            warned = False
        await asyncio.sleep(cfg.consul.interval_ms / 1000.0)

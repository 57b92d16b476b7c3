"""Admin RPC over a unix socket.

The corro-admin analogue (corro-admin/src/lib.rs:35-243): length-delimited
JSON command frames on a UDS. Commands: ping, sync (generate), locks
(top-N), cluster (membership states), reload (re-apply schema paths).
Responses stream as JSON frames ending with {"done": true}.

Counterpart of corrosion_tpu/agent/admin.py.
"""

from __future__ import annotations

import asyncio
import os
from typing import TYPE_CHECKING

from corrosion_tpu_torch.agent.agent import _state_to_wire
from corrosion_tpu_torch.agent.transport import Session, encode_frame, read_frame
from corrosion_tpu_torch.core.bookkeeping import generate_sync

if TYPE_CHECKING:
    from corrosion_tpu_torch.agent.agent import Agent


async def start_admin(agent: "Agent", uds_path: str) -> asyncio.AbstractServer:
    if os.path.exists(uds_path):
        os.unlink(uds_path)

    async def on_conn(reader, writer):
        session = Session(reader, writer)
        try:
            while True:
                msg = await read_frame(reader)
                if msg is None:
                    break
                try:
                    await _handle(agent, session, msg)
                except (ConnectionError, asyncio.CancelledError):
                    raise
                except Exception as e:  # command failed: report, stay up
                    await session.send({"error": str(e), "done": True})
        except ConnectionError:
            pass
        except asyncio.CancelledError:
            raise  # server shutdown: cleanup runs, cancellation flows
        finally:
            session.close()

    server = await asyncio.start_unix_server(on_conn, uds_path)
    agent._admin_server = server
    return server


async def _handle(agent: "Agent", session: Session, msg: dict) -> None:
    cmd = msg.get("c")
    if cmd == "ping":
        await session.send({"pong": True, "actor_id": agent.actor_id})
    elif cmd == "sync":
        state = generate_sync(agent.bookie, agent.actor_id)
        await session.send(
            {"sync": _state_to_wire(state), "need_len": state.need_len()}
        )
    elif cmd == "locks":
        await session.send(
            {"locks": agent.lock_registry.snapshot(msg.get("top", 10))}
        )
    elif cmd == "cluster":
        members = [
            {
                "actor_id": m.actor_id,
                "addr": list(m.addr),
                "state": m.state,
                "incarnation": m.incarnation,
                "ring": m.ring,
            }
            for m in agent.members.states.values()
        ]
        members.append(
            {
                "actor_id": agent.actor_id,
                "addr": list(agent.gossip_addr),
                "state": "alive",
                "incarnation": agent.swim.incarnation if agent.swim else 0,
                "ring": 0,
            }
        )
        await session.send({"members": members})
    elif cmd == "reload":
        sql = msg.get("schema_sql", "")
        changed = agent.store.apply_schema(sql) if sql else []
        if "api_concurrency" in msg:
            agent.cfg.api_concurrency = int(msg["api_concurrency"])
        if "migration_concurrency" in msg:
            agent.cfg.migration_concurrency = int(msg["migration_concurrency"])
        from corrosion_tpu_torch.agent.api import rebuild_api_limits

        rebuild_api_limits(agent)  # config hot-reload reaches admission
        await session.send({"reloaded": changed})
    elif cmd == "restore":
        actor = await agent.restore_online(
            msg["path"], self_actor_id=bool(msg.get("self_actor_id"))
        )
        await session.send({"restored": True, "actor_id": actor})
    elif cmd == "metrics":
        await session.send({"metrics": agent.metrics.snapshot()})
    elif cmd == "trace":
        await session.send(
            {"spans": agent.tracer.recent(
                limit=msg.get("limit", 100), name=msg.get("name")
            )}
        )
    else:
        await session.send({"error": f"unknown command {cmd!r}"})
    await session.send({"done": True})


class AdminClient:
    """Client side of the admin protocol (corrosion/src/command/admin.rs)."""

    def __init__(self, uds_path: str):
        self.uds_path = uds_path

    async def call(self, command: dict) -> list[dict]:
        reader, writer = await asyncio.open_unix_connection(self.uds_path)
        try:
            writer.write(encode_frame(command))
            await writer.drain()
            frames = []
            while True:
                msg = await asyncio.wait_for(read_frame(reader), 10.0)
                if msg is None or msg.get("done"):
                    break
                frames.append(msg)
            return frames
        finally:
            writer.close()

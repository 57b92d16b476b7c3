"""In-process multi-agent test harness.

The corro-tests analogue (crates/corro-tests/src/lib.rs:11-66): launch a real
agent on ephemeral localhost ports with a tempdir and the canonical test
schema, hand back agent + client. All multi-node tests run real TCP over
loopback, like the reference's integration tests (SURVEY.md §4).

Counterpart of corrosion_tpu/agent/testing.py. Where it differs: an agent on
an ephemeral gossip port is served again on a fresh one while that port's
UDP number is held by another socket (``_serve_with_datagrams``), where the
reference keeps an agent without its datagram plane.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass

from corrosion_tpu_torch.agent.agent import Agent, AgentConfig
from corrosion_tpu_torch.client import CorrosionApiClient

# corro-tests/src/lib.rs:11-26
TEST_SCHEMA = """
CREATE TABLE tests (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');
CREATE TABLE tests2 (id INTEGER NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');
CREATE TABLE testsblob (id BLOB NOT NULL PRIMARY KEY, text TEXT NOT NULL DEFAULT '');
"""


@dataclass
class TestAgent:
    agent: Agent
    client: CorrosionApiClient

    @property
    def gossip_addr(self) -> tuple[str, int]:
        return self.agent.gossip_addr

    async def stop(self) -> None:
        await self.agent.stop()

    async def hard_kill(self) -> None:
        """SIGKILL semantics: no graceful leave, no final flushes — see
        Agent.abort. The TestAgent keeps its cfg and last-known addrs so
        :func:`relaunch_test_agent` can resurrect it in place."""
        await self.agent.abort()


# Gossip ports a launch tries before it keeps one without a datagram plane.
GOSSIP_BIND_TRIES = 8


def _serve_with_datagrams(transport):
    """``transport.serve`` that, for an ephemeral gossip port, serves again
    on a fresh port while the datagram bind of the listener's port fails.
    The stream listener takes a port that is free for TCP only, so a UDP
    socket of another process (any agent holds nine) can already own that
    number; the agent then has no datagram plane, the SWIM probes its
    peers send it are lost, and they take it for dead."""
    serve = transport.serve

    async def retry(host, port, handler):
        for _ in range(GOSSIP_BIND_TRIES - 1):
            addr = await serve(host, port, handler)
            if port != 0 or transport._ssl_server is not None or transport._udp is not None:
                return addr
            transport._server.close()
            await transport._server.wait_closed()
        return await serve(host, port, handler)

    return retry


async def _launch_from_cfg(cfg: AgentConfig, subs: bool = True) -> TestAgent:
    agent = Agent(cfg)
    agent.transport.serve = _serve_with_datagrams(agent.transport)
    if subs:
        from corrosion_tpu_torch.agent.subs import SubsManager

        agent.subs = SubsManager(agent.store)
    await agent.start()
    host, port = agent.api_addr
    return TestAgent(agent=agent, client=CorrosionApiClient(host, port))


async def launch_test_agent(
    data_dir: str,
    bootstrap: list[tuple[str, int]] | None = None,
    schema: str = TEST_SCHEMA,
    subs: bool = True,
    **cfg_overrides,
) -> TestAgent:
    cfg = AgentConfig(
        data_dir=data_dir,
        bootstrap=list(bootstrap or []),
        schema_sql=schema,
        **cfg_overrides,
    )
    return await _launch_from_cfg(cfg, subs=subs)


async def hard_kill(ta: TestAgent) -> None:
    """Module-level alias for :meth:`TestAgent.hard_kill` (crash-recovery
    scenarios read better as ``await hard_kill(victim)``)."""
    await ta.agent.abort()


async def relaunch_test_agent(
    ta: TestAgent,
    bootstrap: list[tuple[str, int]] | None = None,
    subs: bool = True,
    **cfg_overrides,
) -> TestAgent:
    """Restart a (hard-)killed agent on the SAME data_dir, gossip port,
    and API port — the crash-recovery path every chaos scenario needs:
    clients and subscription pumps reconnect to the address they already
    hold, and the store/bookkeeping rehydrate from whatever the previous
    life persisted. ``bootstrap`` defaults to the previous life's list
    (pass a live peer when the original seed may itself be dead)."""
    import dataclasses

    old = ta.agent.cfg
    gossip = ta.agent.gossip_addr
    api = ta.agent.api_addr
    cfg = dataclasses.replace(
        old,
        gossip_port=gossip[1] if gossip else old.gossip_port,
        api_port=api[1] if api else old.api_port,
        bootstrap=(
            [tuple(a) for a in bootstrap]
            if bootstrap is not None else list(old.bootstrap)
        ),
        **cfg_overrides,
    )
    return await _launch_from_cfg(cfg, subs=subs)


async def launch_test_cluster(
    data_dir: str,
    n: int,
    wait_membership: bool = True,
    membership_timeout: float = 20.0,
    cfg_for=None,
    **cfg_overrides,
) -> list[TestAgent]:
    """``n`` agents over loopback, chained via bootstrap through the
    first — the cluster-launch loop the loadgen scenarios, the fidelity
    harness, and the CLI all share. With ``wait_membership`` (default)
    it returns only once every agent believes the other ``n - 1`` alive,
    so callers can start measuring immediately. Launched agents are
    stopped on a launch/poll failure (no orphaned listeners).

    ``cfg_for`` (``index -> dict``) merges per-agent config over the
    shared ``cfg_overrides`` — e.g. a distinct ``trace_export_path`` per
    agent so traced clusters don't interleave span files."""
    agents: list[TestAgent] = []
    try:
        for i in range(n):
            per_agent = dict(cfg_overrides)
            if cfg_for is not None:
                per_agent.update(cfg_for(i))
            agents.append(await launch_test_agent(
                os.path.join(data_dir, f"agent{i}"),
                bootstrap=[agents[0].gossip_addr] if agents else None,
                **per_agent,
            ))
        if wait_membership and n > 1:
            await poll_until(
                lambda: asyncio.sleep(0, all(
                    len(a.agent.members.alive()) == n - 1 for a in agents
                )),
                timeout=membership_timeout,
            )
    except BaseException:
        await stop_cluster(agents)
        raise
    return agents


async def stop_cluster(agents) -> None:
    """Best-effort stop of every agent (teardown must not mask the
    test's own failure)."""
    for ta in agents:
        try:
            await ta.stop()
        except Exception:
            pass


async def poll_until(cond, timeout: float = 15.0, interval: float = 0.1):
    """Await an async predicate until truthy or timeout (the polling loops
    the reference tests use for convergence checks)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = await cond()
        if value:
            return value
        await asyncio.sleep(interval)
    raise TimeoutError("condition not met within timeout")

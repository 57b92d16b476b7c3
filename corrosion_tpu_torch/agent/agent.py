"""Agent: setup/run, change-ingest pipeline, background loops.

The host counterpart of corro-agent/src/agent.rs (setup :105-336, run
:354-970): owns the Store, the Bookie, the HLC, the transport, SWIM
membership, the broadcast pending queue, and the sync loop; exposes the
write path used by the HTTP API (make_broadcastable_changes,
api/public/mod.rs:33-191) and the ingest path for remote changesets
(process_multiple_changes, agent.rs:1809-2060) including partial-version
buffering (process_incomplete_version :2063-2151,
process_fully_buffered_changes :1667-1806).

Counterpart of corrosion_tpu/agent/agent.py.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
from dataclasses import dataclass, field

from corrosion_tpu_torch.agent.membership import Members, Swim
from corrosion_tpu_torch.agent.store import Store
from corrosion_tpu_torch.agent.transport import (
    Session,
    Transport,
    attach_trace,
    extract_trace,
)
from corrosion_tpu_torch.core.bookkeeping import (
    Bookie,
    CLEARED,
    Current,
    FullNeed,
    Partial,
    PartialNeed,
    generate_sync,
)
from corrosion_tpu_torch.core.changes import AdaptiveChunker, chunk_changes
from corrosion_tpu_torch.core.hlc import HLC, ts_physical_ms
from corrosion_tpu_torch.core.intervals import RangeSet
from corrosion_tpu_torch.core.values import Change, ExecResponse, ExecResult, Statement
from corrosion_tpu_torch.utils.locks import LockRegistry
from corrosion_tpu_torch.utils.metrics import MetricsRegistry
from corrosion_tpu_torch.utils.spawn import TaskRegistry
from corrosion_tpu_torch.utils.tracing import Tracer
from corrosion_tpu_torch.utils.tracing import current_span as tracing_current_span
from corrosion_tpu_torch.utils.tripwire import Tripwire


@dataclass
class AgentConfig:
    data_dir: str
    gossip_host: str = "127.0.0.1"
    gossip_port: int = 0
    api_host: str = "127.0.0.1"
    api_port: int = 0
    bootstrap: list[tuple[str, int]] = field(default_factory=list)
    # Raw bootstrap specs ("host:port" or "name:port@dns") re-resolved by
    # the announcer loop until peers appear — DNS may not be published yet
    # at startup (resolve_bootstrap, agent.rs:1494-1586 + announcer
    # backoff, agent.rs:726-768).
    bootstrap_raw: list[str] = field(default_factory=list)
    schema_sql: str = ""
    probe_interval: float = 0.25
    broadcast_interval: float = 0.05  # flush tick (500 ms in the reference)
    # Pending-broadcast byte budget (the reference cuts its broadcast
    # buffer at 64 KiB, broadcast/mod.rs:357): over budget, oldest
    # retransmission backlog sheds first; never-sent local frames survive
    # to 8x this before shedding — so a member-less agent under sustained
    # write load holds bounded memory (see _pending_push).
    broadcast_buffer_bytes: int = 64 * 1024
    sync_interval: float = 0.5  # backoff floor 1 s in the reference
    fanout: int = 3  # num_indirect_probes analogue
    max_transmissions: int = 4
    sync_peers: int = 3  # 3-10 by need desc / ring asc (agent.rs:2383-2423)
    # Concurrent sync-session scheduling (parallel_sync, peer.rs:1108-1223):
    # need blocks requested per wave per session, and the server's per-wave
    # version budget (fairness across concurrent sessions).
    sync_wave_needs: int = 10
    sync_serve_budget: int = 512
    # Adaptive chunk sizing + stall abort (peer.rs:352-355, 638-653).
    sync_chunk_max_bytes: int = 8 * 1024
    sync_chunk_min_bytes: int = 1024
    sync_adapt_threshold: float = 0.5
    sync_stall_timeout: float = 5.0
    ingest_batch: int = 1000  # handle_changes batching (agent.rs:2450-2518)
    ingest_linger: float = 0.05
    # Admission control: per-route concurrency + load-shed (128 per route,
    # 4 for migrations; agent.rs:836-902).
    api_concurrency: int = 128
    migration_concurrency: int = 4
    admin_uds: str = ""  # unix socket path for admin RPC ("" = disabled)
    # Compaction cadence. The reference runs clear_overwritten_versions
    # every 300 s and batches empties for 120 s (agent.rs:86, :2520);
    # scaled down to in-process test time.
    compact_interval: float = 5.0
    empties_flush_interval: float = 0.5
    # Orphaned-partial reconcile cadence (clear_buffered_meta_loop runs
    # every 300 s in the reference, agent.rs:2575-2619; scaled to
    # in-process test time like compact_interval).
    buffered_meta_interval: float = 10.0
    # Row-count sampling cadence (collect_metrics runs every 10 s in the
    # reference, agent.rs:1138-1187). Full COUNT(*) scans ride the read
    # pool, but at millions of log rows even pooled scans are not free —
    # the cadence is its own knob, not derived from compact_interval.
    metrics_interval: float = 10.0
    # WAL truncation cadence (the reference checkpoints + times WAL
    # truncation in its db_cleanup loop, agent.rs:956-967, 1413-1435).
    wal_checkpoint_interval: float = 15.0
    # Member-state persistence cadence (diff_member_states every 60 s,
    # broadcast/mod.rs:570-702); persisted members seed rejoin at restart.
    member_persist_interval: float = 60.0
    # Gossip transport dial/send guards + circuit-breaker schedule
    # (transport.py module constants by default; chaos scenarios compress
    # them into test time).
    connect_timeout: float = 3.0
    send_timeout: float = 5.0
    breaker_threshold: int = 3
    breaker_base_s: float = 1.0
    breaker_max_s: float = 30.0
    # Announcer-loop backoff (agent.rs:726-768): how fast an agent with
    # an EMPTY alive set re-announces to its bootstrap seeds — both at
    # startup (DNS lag) and after a partition/suspicion cascade emptied
    # the membership.
    announce_backoff_min_s: float = 1.0
    announce_backoff_max_s: float = 30.0
    # Deterministic WAN impairment (agent/netem.py, docs/CHAOS.md "Host
    # plane"): a corro-host-fault-plan/1 dict installs a NetemShim on the
    # gossip transport. None = no shim, bit-identical transport path.
    netem_plan: dict | None = None
    netem_seed: int = 0
    netem_node: str = ""  # this node's name in the plan's link space
    tls: "AgentTls | None" = None  # gossip-plane TLS (None = plaintext)
    prometheus_addr: str = ""  # host:port for /metrics ("" = disabled)
    trace_export_path: str = ""  # JSON-lines span export ("" = in-memory)
    # OTLP/HTTP collector base URL (spans POST to <url>/v1/traces as
    # OTLP/JSON, batched — main.rs:64-117's exporter). "" = disabled.
    otlp_endpoint: str = ""
    # Causal write tracing (docs/OBSERVABILITY.md "Causal tracing"): give
    # every /v1/transactions write a trace id at API ingest and propagate
    # it through commit, inter-node rebroadcast (a traceparent header in
    # the bcast frame), and subscription fan-out. OFF by default: the
    # write path allocates no spans at all unless enabled (pinned by
    # tests), so the serving bench is untouched.
    trace_writes: bool = False
    # Trace-id-keyed sampling rate for write spans (tracing.trace_sampled)
    # — deterministic per trace id, so every hop of a kept trace keeps it
    # and a 2k-subscription storm can thin its span volume consistently.
    trace_sample: float = 1.0
    # Endurance plane (docs/OBSERVABILITY.md "Endurance plane"): stream
    # one whole-registry snapshot per runtime-metrics tick to a
    # corro-metric-series/1 JSONL (obs/series.py). None = not installed;
    # the loop takes ONE `is None` branch and is otherwise bit-identical
    # (pinned). Relaunch in the same process reattaches (mode="a"), so
    # kill_restart soaks keep one continuous, reset-annotated series.
    metric_series_path: str | None = None
    metric_series_max_bytes: int | None = None
    # Runtime-metrics/series sampling cadence; soak lanes compress it
    # into test time like every other interval knob.
    runtime_metrics_interval: float = 1.0
    # Serving query-cost plane (docs/SERVING.md "Query-cost plane"): arm
    # the per-subscription cost ledger (SubsManager.enable_costs) at
    # startup. OFF by default — handles carry ``cost=None``, the matcher
    # hot path takes single ``is None`` branches, and behavior is
    # bit-identical (pinned), the same contract as trace_writes and
    # metric_series_path.
    sub_costs: bool = False


@dataclass
class AgentTls:
    """Gossip-plane TLS material (peer.rs:132-313; agent/tls.py builds the
    contexts). ``mtls`` requires client certs on inbound and presents
    ``client_cert``/``client_key`` on outbound."""

    cert: str
    key: str
    ca: str | None = None
    client_cert: str | None = None
    client_key: str | None = None
    mtls: bool = False
    insecure: bool = False


class _StreakLogger:
    """Failure logging for periodic loops: WARNING on the first failure of
    a streak, DEBUG on repeats — a permanently failing loop stays visible
    without log spam (the reference warns on loop errors)."""

    def __init__(self, msg: str) -> None:
        self._log = logging.getLogger(__name__)
        self._msg = msg
        self._failing = False

    def ok(self) -> None:
        self._failing = False

    def fail(self) -> None:
        self._log.log(
            logging.DEBUG if self._failing else logging.WARNING,
            self._msg,
            exc_info=True,
        )
        self._failing = True


@dataclass
class PendingBroadcast:
    """An entry in the broadcast pending queue (broadcast/mod.rs:716-738)."""

    frame: dict
    tx_left: int
    size: int = 0  # encoded-size estimate, counted against the byte budget


class Agent:
    def __init__(self, cfg: AgentConfig) -> None:
        self.cfg = cfg
        os.makedirs(cfg.data_dir, exist_ok=True)
        site_id = os.urandom(16)
        self.store = Store(os.path.join(cfg.data_dir, "state.db"), site_id)
        self.actor_id = self.store.site_id.hex()
        self.bookie = Bookie()
        self.hlc = HLC()
        self.netem = None
        if cfg.netem_plan:
            from corrosion_tpu_torch.agent.netem import NetemShim

            shim = NetemShim(
                cfg.netem_plan, seed=cfg.netem_seed,
                local=cfg.netem_node or self.actor_id[:8],
            )
            # An empty plan installs nothing: the transport keeps its
            # bit-identical unimpaired path.
            self.netem = shim if shim.enabled else None
        transport_kw = dict(
            connect_timeout=cfg.connect_timeout,
            send_timeout=cfg.send_timeout,
            breaker_threshold=cfg.breaker_threshold,
            breaker_base_s=cfg.breaker_base_s,
            breaker_max_s=cfg.breaker_max_s,
            netem=self.netem,
        )
        if cfg.tls is not None:
            from corrosion_tpu_torch.agent import tls as tls_mod

            self.transport = Transport(
                ssl_server=tls_mod.server_ssl_context(
                    cfg.tls.cert, cfg.tls.key, cfg.tls.ca,
                    require_client_cert=cfg.tls.mtls,
                ),
                ssl_client=tls_mod.client_ssl_context(
                    cfg.tls.ca, cfg.tls.client_cert, cfg.tls.client_key,
                    insecure=cfg.tls.insecure,
                ),
                **transport_kw,
            )
        else:
            self.transport = Transport(**transport_kw)
        self.members = Members(self.actor_id)
        self.tasks = TaskRegistry()
        self.tripwire = Tripwire()
        self.lock_registry = LockRegistry()
        self.metrics = MetricsRegistry()
        # Aggregate transport metrics (Transport::emit_metrics parity).
        self.transport.bind_metrics(self.metrics)
        _added = self.metrics.counter(
            "corro_gossip_member_added", "members learned (first sighting)"
        )
        _removed = self.metrics.counter(
            "corro_gossip_member_removed", "members forgotten (down GC)"
        )
        # Zero-seed: a churn-free life must still EXPOSE the series (a 0
        # on the scrape and in every metric-series snapshot), so the
        # endurance plane's probe-false-alarm budget arms on a clean
        # soak instead of silently never evaluating.
        _added.inc(0)
        _removed.inc(0)
        self.members.on_added = lambda _aid: _added.inc()
        self.members.on_removed = lambda _aid: _removed.inc()
        self.tracer = Tracer(
            service=f"corrosion-{self.actor_id[:8]}",
            export_path=cfg.trace_export_path or None,
            otlp_endpoint=cfg.otlp_endpoint or None,
            sample=cfg.trace_sample,
        )
        self._trace_writes = cfg.trace_writes
        self._prom_server = None
        self._series_recorder = None  # endurance plane, installed lazily
        self.pool = None  # SplitPool, started with the event loop
        # Hot-path metric handles, resolved once.
        self._m_recv_lag = self.metrics.histogram(
            "corro_broadcast_recv_lag_seconds",
            "HLC age of received changesets (agent.rs:1238-1240)",
        )
        self._m_applied = self.metrics.counter(
            "corro_changes_applied", "changesets applied to the store"
        )
        self._m_buffered = self.metrics.counter(
            "corro_changes_buffered", "partial changesets buffered"
        )
        self.store.lock_registry = self.lock_registry
        self._admin_server = None
        self.gossip_addr: tuple[str, int] | None = None
        self.api_addr: tuple[str, int] | None = None
        self.swim: Swim | None = None
        self._pending: list[PendingBroadcast] = []
        self._pending_bytes = 0
        self._m_bcast_pending_bytes = self.metrics.gauge(
            "corro_broadcast_pending_bytes",
            "bytes queued in the pending-broadcast buffer",
        )
        self._m_bcast_dropped = self.metrics.counter(
            "corro_broadcast_dropped",
            "pending broadcasts dropped over the byte budget (sync heals)",
        )
        # Cleared version ranges awaiting persistence, batched like
        # write_empties_loop (agent.rs:2522-2571).
        self._empties: dict[str, RangeSet] = {}
        self._m_cleared = self.metrics.counter(
            "corro_versions_cleared",
            "versions compacted to Cleared (clear_overwritten_versions)",
        )
        self._m_bcast_recv = self.metrics.counter(
            "corro_broadcast_recv_count",
            "broadcast changeset frames received",
        )
        self._m_committed = self.metrics.counter(
            "corro_changes_committed",
            "local write transactions committed",
        )
        # Sync-plane series pre-registered so an idle agent still exposes
        # them at 0 (doc/telemetry/prometheus.md parity).
        self._m_sync_sent = self.metrics.counter(
            "corro_sync_changes_sent", "changes served through sync"
        )
        self._m_sync_sent_bytes = self.metrics.counter(
            "corro_sync_chunk_sent_bytes",
            "wire bytes of sync change chunks served",
        )
        self.metrics.counter(
            "corro_sync_attempts_count", "sync sessions attempted"
        )
        self.metrics.counter(
            "corro_sync_client_member", "sync sessions established, by peer"
        )
        self.metrics.counter(
            "corro_sync_changes_recv", "changes received through sync"
        )
        # Defensive-machinery visibility (docs/CHAOS.md "Host plane"):
        # the stall abort, adaptive chunk halving, and announcer backoff
        # all fire silently without these — and the chaos harness's
        # "prove the defense engaged" assertions read exactly them.
        # (Breaker trip/recovery edges live in transport.bind_metrics.)
        self._m_stall_aborts = self.metrics.counter(
            "corro_sync_stall_aborts_total",
            "sync sessions aborted by the blocking-send stall guard "
            "(peer.rs:352-355)",
        )
        self._m_chunk_halvings = self.metrics.counter(
            "corro_sync_chunk_halvings_total",
            "adaptive sync chunk-size halvings (peer.rs:638-653)",
        )
        self.metrics.counter(
            "corro_peer_backoff_retries_total",
            "backoff waits taken by the bootstrap announcer loop",
        )
        self._ingest: asyncio.Queue = asyncio.Queue(maxsize=4096)
        self._addr_of: dict[str, tuple[str, int]] = {}
        self._api_server = None
        self.subs = None  # SubsManager, attached by api/subs wiring
        # Optional (actor_id, version, hlc_ts) hook on every committed
        # local write — the trace-recording seam for kernel replay.
        self.on_local_write = None
        self._rehydrate()
        if cfg.schema_sql:
            self.store.apply_schema(cfg.schema_sql)

    # -- setup (agent.rs:105-336) -------------------------------------------

    def _rehydrate(self) -> None:
        """Rebuild BookedVersions from __corro_bookkeeping +
        __corro_seq_bookkeeping (agent.rs:147-268)."""
        for actor, sv, ev, dbv, last_seq, ts in self.store.conn.execute(
            "SELECT actor_id, start_version, end_version, db_version,"
            " last_seq, ts FROM __corro_bookkeeping"
        ):
            booked = self.bookie.for_actor(bytes(actor).hex())
            if dbv is None:
                booked.insert_many(sv, ev if ev is not None else sv, CLEARED)
            else:
                booked.insert(
                    sv, Current(db_version=dbv, last_seq=last_seq, ts=ts or 0)
                )
        for actor, ver, ss, es, last_seq, ts in self.store.conn.execute(
            "SELECT actor_id, version, start_seq, end_seq, last_seq, ts"
            " FROM __corro_seq_bookkeeping"
        ):
            booked = self.bookie.for_actor(bytes(actor).hex())
            known = booked.get(ver)
            if isinstance(known, Partial):
                known.seqs.insert(ss, es)
            else:
                booked.insert(
                    ver,
                    Partial(seqs=RangeSet([(ss, es)]), last_seq=last_seq, ts=ts),
                )

    async def start(self) -> None:
        from corrosion_tpu_torch.agent.pool import SplitPool

        self.pool = SplitPool(self.store)
        self.pool.metrics = self.metrics
        self.pool.start()
        self.gossip_addr = await self.transport.serve(
            self.cfg.gossip_host, self.cfg.gossip_port, self._on_gossip
        )
        # SWIM rides the unreliable datagram plane (foca over QUIC
        # datagrams, broadcast/mod.rs:710 + transport.rs:66-90): UDP sends
        # never connect, so a black-holing peer cannot stall the probe
        # cadence. Oversized packets / TLS mode fall back to streams.
        self.swim = Swim(
            self.members,
            self.gossip_addr,
            self.transport.send_packet,
            probe_interval=self.cfg.probe_interval,
            max_transmissions=self.cfg.max_transmissions,
        )
        # Identity freshness across restarts (actor.rs:169-194's renew-on-
        # rejoin): the own-incarnation row persisted at shutdown seeds the
        # next life one higher, so ALIVE@n+1 beats any durable DOWN@n a
        # graceful leave taught the cluster.
        row = self.store.conn.execute(  # corro-lint: disable=CT042 reason=boot path; the loop serves no sessions until start() returns
            "SELECT incarnation FROM __corro_members WHERE actor_id = ?",
            (self.actor_id,),
        ).fetchone()
        if row is not None:
            self.swim.incarnation = int(row[0]) + 1
        from corrosion_tpu_torch.agent.api import serve_api

        self.api_addr = await serve_api(self)
        if self.subs is not None:
            # Restore persisted subscriptions (agent.rs:373-419).
            self.subs.restore()
            if self._trace_writes:
                # Fan-out spans ride the same tracer as the write path;
                # left unwired (the default) match_changes costs nothing.
                self.subs.tracer = self.tracer
            if self.cfg.sub_costs:
                # Arm the per-subscription cost ledger AFTER restore so
                # durable handles re-adopt their persisted counters
                # (kill/relaunch continues the ledger, like the series
                # recorder's mode="a" reattach).
                self.subs.enable_costs(self.metrics)
        # Rejoin via persisted member states (agent.rs:772-831): a restarted
        # node reaches its old cluster even when the bootstrap seeds are
        # gone. The failure detector prunes any that died while we were
        # down.
        self._members_persisted: dict[str, tuple] = {}
        # Serializes diff-persist passes: stop()'s final pass can run
        # concurrently with the loop's, and an interleaved snapshot swap
        # would regress _members_persisted behind rows already written.
        self._members_persist_lock = asyncio.Lock()
        restored_members = self._load_members()
        for m in restored_members[:10]:
            await self.swim.announce(m.addr)
        self.tasks.spawn(self._swim_loop(), name="swim_loop")
        self.tasks.spawn(
            self._members_persist_loop(), name="diff_member_states"
        )
        self.tasks.spawn(self._broadcast_loop(), name="broadcast_loop")
        self.tasks.spawn(self._ingest_loop(), name="handle_changes")
        self.tasks.spawn(self._sync_loop(), name="sync_loop")
        self.tasks.spawn(
            self._compact_loop(), name="clear_overwritten_versions"
        )
        self.tasks.spawn(self._empties_loop(), name="write_empties_loop")
        self.tasks.spawn(
            self._buffered_meta_loop(), name="clear_buffered_meta_loop"
        )
        self.tasks.spawn(self._metrics_loop(), name="metrics_loop")
        self.tasks.spawn(
            self._runtime_metrics_loop(), name="runtime_metrics"
        )
        self.tasks.spawn(self._wal_checkpoint_loop(), name="db_cleanup")
        if self.cfg.admin_uds:
            from corrosion_tpu_torch.agent.admin import start_admin

            await start_admin(self, self.cfg.admin_uds)
        if self.cfg.prometheus_addr:
            from corrosion_tpu_torch.agent.config import parse_addr
            from corrosion_tpu_torch.utils.metrics import serve_prometheus

            host, port = parse_addr(self.cfg.prometheus_addr)
            self._prom_server, self.prometheus_addr = await serve_prometheus(
                self.metrics, host, port
            )
        # Static config/build series (doc/telemetry/prometheus.md).
        self.metrics.gauge(
            "corro_build_info", "build identity"
        ).set(1, version="corrosion-tpu")
        self.metrics.gauge(
            "corro_gossip_config_max_transmissions",
            "configured broadcast retransmission budget",
        ).set(self.cfg.max_transmissions)
        self.metrics.gauge(
            "corro_gossip_config_num_indirect_probes",
            "configured indirect probe count",
        ).set(self.swim.indirect_probes)
        self.metrics.gauge(
            "corro_broadcast_buffer_capacity",
            "pending-broadcast buffer byte budget",
        ).set(self.cfg.broadcast_buffer_bytes)
        for addr in self.cfg.bootstrap:
            await self.swim.announce(tuple(addr))
        if self.cfg.bootstrap_raw or self.cfg.bootstrap:
            self.tasks.spawn(
                self._bootstrap_loop(), name="bootstrap_announcer"
            )

    async def _bootstrap_loop(self) -> None:
        """Announcer loop (agent.rs:726-768): re-resolve + re-announce
        the bootstrap seeds with backoff WHENEVER the alive member set is
        empty — at startup (a seed name may not be DNS-published yet) and
        again after a partition or suspicion cascade empties the
        membership. The SWIM plane never probes members it believes
        down, so a fully isolated node can only re-enter the cluster by
        announcing its way back in; the announce reply carries the
        cluster's belief about the announcer so it can refute a stale
        DOWN with a higher incarnation (membership.on_message)."""
        from corrosion_tpu_torch.agent.config import resolve_bootstrap
        from corrosion_tpu_torch.utils.backoff import Backoff

        retries = self.metrics.counter("corro_peer_backoff_retries_total")
        backoff = Backoff(
            min_wait=self.cfg.announce_backoff_min_s,
            max_wait=self.cfg.announce_backoff_max_s,
            on_wait=lambda _w: retries.inc(),
        )
        while not self.tripwire.tripped:
            if self.members.alive():
                backoff.reset()
                await asyncio.sleep(1.0)
                continue
            addrs = [tuple(a) for a in self.cfg.bootstrap]
            if self.cfg.bootstrap_raw:
                addrs.extend(resolve_bootstrap(self.cfg.bootstrap_raw))
            for addr in addrs:
                if addr != self.gossip_addr:
                    await self.swim.announce(addr)
            await asyncio.sleep(next(backoff))

    async def stop(self) -> None:
        # Graceful departure first, while the transport is still up
        # (foca.leave_cluster, broadcast/mod.rs:306): peers learn DOWN now
        # instead of after a probe-timeout + suspect window.
        if self.swim is not None:
            try:
                await asyncio.wait_for(self.swim.leave_cluster(), 1.0)
            except Exception:
                pass
        self.tripwire.trip()
        await self.tasks.cancel_all()
        await self.tasks.wait_for_all_pending_handles(cap=5.0)
        # Drain unpersisted cleared ranges (write_empties_loop drains its
        # queue before shutdown, agent.rs:2558-2570).
        if self._empties:
            try:
                await self._flush_empties()
            except Exception:
                pass
        # Final member-state flush: a node cleanly restarted within the
        # persist interval must still find its cluster in __corro_members.
        if getattr(self, "_members_persisted", None) is not None:
            try:
                await self._persist_members_once()
            except Exception:
                pass
        await self._close_resources()

    async def _close_resources(self) -> None:
        """The ungraceful tail shared by stop() and abort(): release
        every in-process resource (sockets, sqlite handles, threads) so
        the same data_dir can relaunch immediately. Anything added here
        closes on BOTH paths; graceful-only work (leave, flushes) stays
        in stop()."""
        self.transport.close()
        if self.subs is not None:
            self.subs.close()
        for srv in (self._api_server, self._admin_server, self._prom_server):
            if srv is not None:
                srv.close()
        if self.pool is not None:
            await self.pool.close()
        if self._series_recorder is not None:
            # Refcounted release (obs/series.py): closing on BOTH the
            # stop() and abort() paths means a same-process relaunch
            # reopens the series mode="a" and the record continues.
            self._series_recorder.close()
            self._series_recorder = None
        self.tracer.close()
        self.store.close()

    async def abort(self) -> None:
        """Crash-style shutdown — the in-process stand-in for SIGKILL
        (agent/testing.hard_kill). Deliberately NOT stop(): no graceful
        SWIM leave (peers must detect the death), no empties drain, no
        final member-state flush — the restarted life gets only what a
        dead process would have left behind: the store's committed WAL
        state and whatever the periodic loops happened to persist."""
        self.tripwire.trip()
        await self.tasks.cancel_all()
        await self._close_resources()

    # -- write path (make_broadcastable_changes) ------------------------------

    def execute(self, statements: list[Statement]) -> ExecResponse:
        """Synchronous local write (tests, tooling): store txn inline."""
        t0 = time.monotonic()
        results, dbv, last_seq, changes = self.store.execute_transaction(
            statements
        )
        resp, persist, frames = self._finish_local_write(
            results, dbv, last_seq, changes, t0
        )
        if persist is not None:
            persist()
        for frame in frames:
            self._queue_broadcast(frame)
        return resp

    async def execute_async(self, statements: list[Statement]) -> ExecResponse:
        """API-path local write: the SQLite transaction runs on the
        SplitPool's writer at HIGH priority (pool.write_priority ≈
        `pool.write_priority()` at public/mod.rs:41), keeping the event
        loop free; bookkeeping/subs/broadcast stay loop-confined.

        With causal write tracing on, a ``commit`` span (child of the API
        layer's ``api_write`` root when one is ambient) covers the store
        transaction through bookkeeping persistence; its traceparent is
        stamped onto every broadcast frame so remote hops chain onto it.
        The default path allocates no spans."""
        t0 = time.monotonic()
        # Child of the ambient api_write root ONLY: when the root was
        # dropped (sampling said no, or a non-API caller), minting a
        # fresh root here would re-roll the sampling decision on a new
        # random id — orphan commit/fan-out/hop trees for writes the
        # sampler already dropped, defeating the thinning. With an
        # ambient parent, maybe_span re-checks the SAME trace id, so
        # the whole tree keeps or drops together.
        span = (
            self.tracer.maybe_span("commit")
            if self._trace_writes and tracing_current_span() is not None
            else None
        )
        if span is None:
            return await self._execute_async_inner(statements, t0, None)
        with span:
            return await self._execute_async_inner(statements, t0, span)

    async def _execute_async_inner(
        self, statements, t0, span
    ) -> ExecResponse:
        if self.pool is not None:
            results, dbv, last_seq, changes = await self.pool.write_priority(
                lambda: self.store.execute_transaction(statements)
            )
        else:
            results, dbv, last_seq, changes = self.store.execute_transaction(
                statements
            )
        resp, persist, frames = self._finish_local_write(
            results, dbv, last_seq, changes, t0, span=span
        )
        if persist is not None:
            # Persist BEFORE dissemination: a frame on the wire whose
            # version is not in __corro_bookkeeping could be re-allocated
            # after a crash-restart — peers would dedupe the reused number
            # and silently diverge.
            await self._store_write(persist)
        for frame in frames:
            self._queue_broadcast(frame)
        return resp

    def _finish_local_write(
        self, results, dbv, last_seq, changes, t0, span=None
    ):
        """Loop-confined bookkeeping; returns (response, persist_closure,
        broadcast_frames). The closure is store-only work the caller runs on
        the pool writer (or inline for the sync path) — and MUST complete
        before the frames are queued for dissemination."""
        persist = None
        frames: list[dict] = []
        if dbv and changes:
            ts = self.hlc.new_timestamp()
            booked = self.bookie.for_actor(self.actor_id)
            version = (booked.last() or 0) + 1
            booked.insert(
                version, Current(db_version=dbv, last_seq=last_seq, ts=ts)
            )
            self._m_committed.inc()
            if span is not None:
                span.set_attr("actor", self.actor_id[:8])
                span.set_attr("version", version)
                span.set_attr("changes", len(changes))
            if self.on_local_write is not None:
                # Trace hook: real write traffic recorded for kernel replay
                # (sim/trace.py; SURVEY §7 step 7's dispatch-seam bridge).
                self.on_local_write(self.actor_id, version, ts)
            dirty = (
                self.subs.match_changes(changes)
                if self.subs is not None else []
            )
            actor = self.actor_id

            def persist() -> None:
                self._persist_bookkeeping(actor, version, dbv, last_seq, ts)
                if self.subs is not None:
                    self.subs.persist_watermarks_sync(dirty)

            # Chunk for dissemination (public/mod.rs:128-187); queued by
            # the caller after the bookkeeping row is durable. Traced
            # writes stamp the commit span's traceparent on every frame
            # (transport.TRACE_KEY) so the first gossip hop parents on it.
            tp = span.traceparent if span is not None else None
            frames = [
                attach_trace(
                    self._changeset_frame(
                        self.actor_id, version, chunk, (s, e), last_seq, ts
                    ),
                    tp,
                )
                for chunk, (s, e) in chunk_changes(changes, last_seq)
            ]
        return (
            ExecResponse(results=results, time=time.monotonic() - t0),
            persist,
            frames,
        )

    async def restore_online(
        self, backup_path: str, self_actor_id: bool = False
    ) -> str:
        """Swap in a backup while running (`corrosion restore` against a
        live node; sqlite3-restore's role). The content swap runs on the
        SplitPool writer — serialized with every other write — then the
        agent re-reads identity/schema and rebuilds its bookkeeping.
        Returns the actor id now in effect."""
        from corrosion_tpu_torch.agent.backup import online_restore

        def do() -> None:
            # One pooled job: swap, retire stale readers, reload — so no
            # queued write can ever run between the content swap and the
            # store reopening on the restored content. The fcntl locks
            # exclude OTHER processes; same-process readers are quiesced
            # by the caller (pool read slots) and the write lock below.
            with self.store._wlock("online_restore"):
                online_restore(
                    backup_path, self.store.path, self_actor_id=self_actor_id
                )
                if self.pool is not None:
                    self.pool.flush_read_conns()
            self.store.reload_after_restore()

        if self.pool is not None:
            async with self.pool.quiesce_reads():
                await self.pool.write_priority(do)
        else:
            do()
        self.actor_id = self.store.site_id.hex()
        self.bookie = Bookie()
        self._rehydrate()
        if self.subs is not None:
            # Backups strip __corro_subs (node-local): recreate it and
            # re-persist this node's live subscriptions.
            self.subs.reinit_after_restore()
        # Backups also strip __corro_members: recreate it and force the
        # next persist pass to rewrite every live member (an empty diff
        # snapshot makes all rows "changed"), or member persistence would
        # die silently until the next full restart.
        with self.store._wlock("members_reinit"):
            self.store.conn.execute(  # corro-lint: disable=CT042 reason=rare admin-driven restore; one DDL statement under the writer lock
                "CREATE TABLE IF NOT EXISTS __corro_members ("
                " actor_id TEXT PRIMARY KEY, addr TEXT NOT NULL,"
                " state TEXT NOT NULL, incarnation INTEGER NOT NULL,"
                " updated_at REAL NOT NULL) WITHOUT ROWID"
            )
        self._members_persisted = {}
        return self.actor_id

    def _persist_bookkeeping(self, actor, version, dbv, last_seq, ts) -> None:
        # Under the writer lock: the pool writer thread may hold an open
        # BEGIN IMMEDIATE on this connection, and joining a foreign
        # transaction would tie this row's fate to it.
        with self.store._wlock("persist_bookkeeping"):
            self.store.conn.execute(
                "INSERT OR REPLACE INTO __corro_bookkeeping"
                " (actor_id, start_version, end_version, db_version, last_seq, ts)"
                " VALUES (?, ?, NULL, ?, ?, ?)",
                (bytes.fromhex(actor), version, dbv, last_seq, ts),
            )

    def _changeset_frame(self, actor, version, changes, seqs, last_seq, ts):
        return {
            "t": "bcast",
            "actor": actor,
            "version": version,
            "changes": [list(c.to_tuple()) for c in changes],
            "seqs": list(seqs),
            "last_seq": last_seq,
            "ts": ts,
        }

    def _queue_broadcast(self, frame: dict) -> None:
        self._pending_push(
            PendingBroadcast(
                frame=frame,
                tx_left=self.cfg.max_transmissions,
                # Size estimate for the byte budget; blob values count at
                # their hex length (the codec encodes them binary — close
                # enough for a budget, no second encode at send time).
                size=len(
                    json.dumps(
                        frame,
                        separators=(",", ":"),
                        default=lambda o: o.hex()
                        if isinstance(o, (bytes, bytearray, memoryview))
                        else str(o),
                    )
                ),
            )
        )

    def _pending_push(self, pb: PendingBroadcast) -> None:
        """Append to the pending buffer under the byte budget.

        Two-tier shed, mirroring what the reference's 64 KiB buffer cutoff
        (broadcast/mod.rs:357) actually loses: over the soft budget, drop
        oldest RETRANSMISSION backlog first — frames already sent at least
        once, whose lost redundancy anti-entropy covers. Never-sent frames
        are the only broadcast copy of local writes (the reference never
        drops those), so they survive up to a hard multiple of the budget;
        only a member-less agent under sustained write load reaches that,
        and a late-joining peer recovers the difference via sync."""
        self._pending.append(pb)
        self._pending_bytes += pb.size
        soft = self.cfg.broadcast_buffer_bytes
        if self._pending_bytes > soft:
            kept = []
            last = len(self._pending) - 1
            for i, p in enumerate(self._pending):
                if (
                    self._pending_bytes > soft
                    and i < last
                    and p.tx_left < self.cfg.max_transmissions
                ):
                    self._pending_bytes -= p.size
                    self._m_bcast_dropped.inc()
                else:
                    kept.append(p)
            self._pending = kept
        hard = soft * 8
        while self._pending_bytes > hard and len(self._pending) > 1:
            dropped = self._pending.pop(0)
            self._pending_bytes -= dropped.size
            self._m_bcast_dropped.inc()
        self._m_bcast_pending_bytes.set(self._pending_bytes)

    # -- gossip inbound -------------------------------------------------------

    async def _on_gossip(self, session: Session, msg: dict) -> None:
        kind = msg.get("t")
        if kind == "swim":
            frm = msg.get("from")
            if frm and "from_addr" in msg:
                self._addr_of[frm] = tuple(msg["from_addr"])
            await self.swim.on_message(msg)
        elif kind == "bcast":
            self._m_bcast_recv.inc()
            try:
                self._ingest.put_nowait((msg, "broadcast"))
            except asyncio.QueueFull:
                pass  # broadcast is lossy; sync heals
        elif kind == "sync_start":
            await self._serve_sync(session, msg)

    # -- broadcast loop (broadcast/mod.rs:356-567) ----------------------------

    async def _broadcast_loop(self) -> None:
        pending_gauge = self.metrics.gauge(
            "corro_broadcast_pending", "pending-broadcast queue depth"
        )
        members_gauge = self.metrics.gauge(
            "corro_gossip_members", "peers currently believed alive"
        )
        sent_ctr = self.metrics.counter(
            "corro_broadcast_sent", "broadcast frames transmitted"
        )
        # Transmits are SPAWNED, not awaited inline (transmit_broadcast
        # tasks, broadcast/mod.rs:741-756): one black-holing peer must not
        # stall the whole dissemination tick for its connect timeout. The
        # semaphore bounds in-flight sends; the transport's per-peer
        # circuit breaker makes repeat failures fail fast.
        sem = asyncio.Semaphore(32)

        async def transmit(addr: tuple, frame: dict) -> None:
            async with sem:
                if await self.transport.send_frame(addr, frame):
                    sent_ctr.inc()

        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.broadcast_interval)
            pending_gauge.set(len(self._pending))
            members_gauge.set(len(self.members.alive()))
            if not self._pending:
                continue
            if not self.members.alive():
                # No peers yet: entries stay queued, budgets intact
                # (sendable gating); _pending_push's byte budget is what
                # bounds a member-less agent under sustained writes.
                continue
            pending, self._pending = self._pending, []
            self._pending_bytes = 0
            members = self.members.alive()
            ring0 = self.members.ring0()
            for pb in pending:
                # Ring-0 eager + random far targets (mod.rs:465-473,522-537).
                targets = {m.actor_id: m for m in ring0}
                others = [m for m in members if m.actor_id not in targets]
                random.shuffle(others)
                for m in others[: self.cfg.fanout]:
                    targets[m.actor_id] = m
                for m in targets.values():
                    self.tasks.spawn(
                        transmit(m.addr, pb.frame), name="transmit_broadcast"
                    )
                pb.tx_left -= 1
                if pb.tx_left > 0:
                    self._pending_push(pb)

    # -- ingest pipeline (handle_changes + process_multiple_changes) ----------

    async def _ingest_loop(self) -> None:
        while not self.tripwire.tripped:
            batch: list[tuple[dict, str]] = []
            try:
                item = await asyncio.wait_for(
                    self._ingest.get(), timeout=0.25
                )
                batch.append(item)
            except asyncio.TimeoutError:
                continue
            t0 = time.monotonic()
            while (
                len(batch) < self.cfg.ingest_batch
                and time.monotonic() - t0 < self.cfg.ingest_linger
            ):
                try:
                    batch.append(self._ingest.get_nowait())
                except asyncio.QueueEmpty:
                    await asyncio.sleep(0.005)
            await self._process_changes(batch)

    async def _store_write(self, fn):
        """Run store-only work on the pool writer (NORMAL tier — the change
        ingest class, agent.rs:2450); inline when the pool isn't up.
        Bookie and subscription state stay event-loop-confined."""
        if self.pool is not None:
            return await self.pool.write(fn)
        return fn()

    async def _process_changes(self, batch: list[tuple[dict, str]]) -> None:
        """One writer transaction per ingest batch (process_multiple_changes,
        agent.rs:1847-1851): complete changesets accumulate and flush as a
        single pooled store job; partial-version buffering (rare) flushes
        the pending run first, then takes its own pooled job. Bookie and
        subscription state stay loop-confined throughout. Duplicate copies
        of a changeset inside ONE accumulation window bypass the dedupe
        check; the CRDT store and bookie inserts are idempotent, so that
        only costs the double work, never correctness."""
        now_ms = int(time.time() * 1000)
        pending: list[tuple[str, int, list[Change], int, int]] = []
        # Causal-trace hop spans: one ``ingest_apply`` per traced
        # changeset actually applied this batch, parented on the
        # upstream hop via the frame's traceparent header. Opened with
        # Span.start() (not the context manager — batch lifetimes
        # overlap non-LIFO) and closed after the final flush, so each
        # span covers queue-drain through store apply + fan-out.
        hop_spans: list = []

        async def flush() -> None:
            if not pending:
                return
            flat = [ch for _, _, changes, _, _ in pending for ch in changes]
            # All bookkeeping rows ride the same pooled job as the merge:
            # no store write ever runs on the event loop.
            rows = [
                (actor, version, changes[0].db_version if changes else 0,
                 last_seq, ts)
                for actor, version, changes, last_seq, ts in pending
            ]

            def db_work() -> None:
                self.store.apply_changes(flat)
                for actor, version, dbv, last_seq, ts in rows:
                    self._persist_bookkeeping(actor, version, dbv, last_seq, ts)

            await self._store_write(db_work)
            dirty: list[tuple[str, int]] = []
            for (actor, version, changes, last_seq, ts), (_, _, dbv, _, _) in zip(
                pending, rows
            ):
                self._m_applied.inc()
                self.bookie.for_actor(actor).insert(
                    version, Current(db_version=dbv, last_seq=last_seq, ts=ts)
                )
                if self.subs is not None:
                    dirty.extend(self.subs.match_changes(changes))
            if dirty:
                await self._store_write(
                    lambda: self.subs.persist_watermarks_sync(dirty)
                )
            pending.clear()

        for msg, source in batch:
            actor = msg["actor"]
            if actor == self.actor_id:
                continue
            version = msg["version"]
            seqs = tuple(msg["seqs"])
            last_seq = msg["last_seq"]
            booked = self.bookie.for_actor(actor)
            if booked.contains(version, seqs):
                continue  # already known (agent.rs:1817-1843 dedupe)
            span = None
            if self._trace_writes:
                tp = extract_trace(msg)
                if tp is not None:
                    span = self.tracer.maybe_span(
                        "ingest_apply", traceparent=tp,
                        actor=actor[:8], version=version, source=source,
                    )
                    if span is not None:
                        hop_spans.append(span.start())
            self._m_recv_lag.observe(
                max(now_ms - ts_physical_ms(msg["ts"]), 0) / 1000.0,
                source=source,
            )
            self.hlc.update_with_timestamp(msg["ts"])
            changes = [Change.from_tuple(tuple(t)) for t in msg["changes"]]
            complete = seqs[0] == 0 and seqs[1] >= last_seq
            known = booked.get(version)
            if complete and not isinstance(known, Partial):
                pending.append((actor, version, changes, last_seq, msg["ts"]))
            else:
                await flush()
                self._m_buffered.inc(source=source)
                await self._buffer_partial(
                    actor, version, changes, seqs, last_seq, msg["ts"]
                )
            if source == "broadcast":
                # Rebroadcast applied changesets (agent.rs:2040-2057).
                # A traced hop re-stamps the frame with ITS span's
                # traceparent so the next hop parents here and the
                # multi-hop chain reconstructs; untraced/unsampled
                # relays forward the header untouched (the chain skips
                # them but stays connected by trace id).
                pb = dict(msg)
                if span is not None:
                    attach_trace(pb, span.traceparent)
                self._queue_broadcast(pb)
        await flush()
        for s in hop_spans:
            s.finish()

    async def _apply_complete(self, actor, version, changes, last_seq, ts) -> None:
        dbv = changes[0].db_version if changes else 0

        def db_work() -> None:
            self.store.apply_changes(changes)
            self._persist_bookkeeping(actor, version, dbv, last_seq, ts)

        await self._store_write(db_work)
        self._m_applied.inc()
        self.bookie.for_actor(actor).insert(
            version, Current(db_version=dbv, last_seq=last_seq, ts=ts)
        )
        if self.subs is not None:
            dirty = self.subs.match_changes(changes)
            if dirty:
                await self._store_write(
                    lambda: self.subs.persist_watermarks_sync(dirty)
                )

    async def _buffer_partial(
        self, actor, version, changes, seqs, last_seq, ts
    ) -> None:
        """process_incomplete_version: stash rows + seq ranges; apply once
        gap-free (agent.rs:2063-2151, 1667-1806)."""
        booked = self.bookie.for_actor(actor)
        known = booked.get(version)
        if isinstance(known, Partial):
            known.seqs.insert(seqs[0], seqs[1])
            partial = known
        else:
            partial = Partial(
                seqs=RangeSet([tuple(seqs)]), last_seq=last_seq, ts=ts
            )
            booked.insert(version, partial)
        promote = partial.is_complete()

        def db_work():
            c = self.store.conn
            with self.store._wlock("buffer_partial"):
                for ch in changes:
                    c.execute(
                        "INSERT OR IGNORE INTO __corro_buffered_changes VALUES"
                        " (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                        (
                            bytes.fromhex(actor), version, ch.table, ch.pk,
                            ch.cid, ch.val, ch.col_version, ch.db_version,
                            ch.seq, ch.site_id, ch.cl,
                        ),
                    )
                c.execute(
                    "INSERT OR REPLACE INTO __corro_seq_bookkeeping VALUES"
                    " (?, ?, ?, ?, ?, ?)",
                    (bytes.fromhex(actor), version, seqs[0], seqs[1],
                     last_seq, ts),
                )
                if not promote:
                    return None
                rows = c.execute(
                    "SELECT tbl, pk, cid, val, col_version, db_version, seq,"
                    " site_id, cl FROM __corro_buffered_changes"
                    " WHERE actor_id = ? AND version = ? ORDER BY seq",
                    (bytes.fromhex(actor), version),
                ).fetchall()
                c.execute(
                    "DELETE FROM __corro_buffered_changes"
                    " WHERE actor_id = ? AND version = ?",
                    (bytes.fromhex(actor), version),
                )
                c.execute(
                    "DELETE FROM __corro_seq_bookkeeping"
                    " WHERE actor_id = ? AND version = ?",
                    (bytes.fromhex(actor), version),
                )
                return rows

        rows = await self._store_write(db_work)
        if rows is not None:
            all_changes = [Change.from_tuple(tuple(r)) for r in rows]
            await self._apply_complete(
                actor, version, all_changes, last_seq, ts
            )

    # -- compaction (clear_overwritten_versions + write_empties_loop) ----------

    def _queue_empty(self, actor: str, start: int, end: int) -> None:
        self._empties.setdefault(actor, RangeSet()).insert(start, end)

    async def _compact_loop(self) -> None:
        """Periodically find fully-overwritten versions and clear them
        (clear_overwritten_versions, agent.rs:995-1126)."""
        streak = _StreakLogger("clear_overwritten_versions failed")
        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.compact_interval)
            try:
                await self._compact_once()
                streak.ok()
            except Exception:
                streak.fail()

    async def _buffered_meta_loop(self) -> None:
        """Periodically drop buffered partial data for versions that were
        CLEARED out-of-band (clear_buffered_meta_loop, agent.rs:2575-2619):
        an empty changeset normally prunes its buffers inline, but a crash
        between the bookkeeping write and the buffer prune — or a
        compaction that raced a partial — leaves orphaned
        __corro_buffered_changes/__corro_seq_bookkeeping rows that would
        otherwise resurrect a dead partial at the next boot."""
        streak = _StreakLogger("clear_buffered_meta failed")
        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.buffered_meta_interval)
            try:
                await self._clear_buffered_meta_once()
                streak.ok()
            except Exception:
                streak.fail()

    async def _clear_buffered_meta_once(self) -> None:
        # Work from what is actually BUFFERED (like agent.rs:2575-2619's
        # SELECT over the buffer tables), not from the full cleared
        # history: steady-state cost scales with outstanding orphans —
        # normally zero rows — not with how much was ever compacted.
        present = self.store.conn.execute(  # corro-lint: disable=CT042 reason=indexed read over normally-zero orphan rows; an executor round-trip costs more than the scan
            "SELECT actor_id, version FROM __corro_seq_bookkeeping"
            " UNION SELECT DISTINCT actor_id, version"
            " FROM __corro_buffered_changes"
        ).fetchall()
        orphans: list[tuple[bytes, int]] = []
        for site, version in present:
            booked = self.bookie.get(site.hex())
            if booked is not None and booked.cleared.contains(version):
                orphans.append((site, version))
                booked.partials.pop(version, None)
        # In-memory partials whose version was cleared (no buffered rows
        # left — e.g. restored state) reconcile too.
        for actor, booked in list(self.bookie.items()):
            for v in [
                v for v in booked.partials if booked.cleared.contains(v)
            ]:
                booked.partials.pop(v, None)
        if not orphans:
            return

        def db_work() -> None:
            with self.store._wlock("clear_buffered_meta"):
                self.store.conn.executemany(
                    "DELETE FROM __corro_buffered_changes"
                    " WHERE actor_id = ? AND version = ?",
                    orphans,
                )
                self.store.conn.executemany(
                    "DELETE FROM __corro_seq_bookkeeping"
                    " WHERE actor_id = ? AND version = ?",
                    orphans,
                )

        if self.pool is not None:
            await self.pool.write_low(db_work)
        else:
            db_work()

    async def _compact_once(self) -> None:
        for actor, booked in list(self.bookie.items()):
            versions = booked.current_versions()  # db_version -> version
            if not versions:
                continue
            site = bytes.fromhex(actor)
            # Read-side probe (the reference uses a read txn off the writer,
            # agent.rs:1046-1057); cheap enough to run on the loop here.
            cleared_dbvs = self.store.find_cleared_versions(site)
            to_clear = [
                v for dbv, v in versions.items() if dbv in cleared_dbvs
            ]
            if not to_clear:
                continue
            for v in to_clear:
                # Re-check Current: an interleaved await may have changed it.
                if isinstance(booked.get(v), Current):
                    booked.insert(v, CLEARED)
                    self._m_cleared.inc()
            # Queue each affected cleared RANGE (versions coalesce with
            # neighbours already cleared) for batched persistence.
            seen: set[tuple[int, int]] = set()
            for v in to_clear:
                for s, e in booked.cleared:
                    if s <= v <= e and (s, e) not in seen:
                        seen.add((s, e))
                        self._queue_empty(actor, s, e)
            await asyncio.sleep(0)  # yield between actors (agent.rs:1114)

    async def _empties_loop(self) -> None:
        """Batch queued cleared ranges into collapsed bookkeeping rows
        (write_empties_loop, agent.rs:2522-2571)."""
        streak = _StreakLogger("write_empties flush failed; batch re-queued")
        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.empties_flush_interval)
            if self._empties:
                try:
                    await self._flush_empties()
                    streak.ok()
                except Exception:
                    streak.fail()

    async def _flush_empties(self) -> None:
        empties, self._empties = self._empties, {}

        def db_work() -> None:
            for actor, ranges in empties.items():
                site = bytes.fromhex(actor)
                for s, e in list(ranges):
                    self.store.store_empty_changeset(site, s, e)

        try:
            # Background write tier, like process_completed_empties' low-pri
            # txn.
            if self.pool is not None:
                await self.pool.write_low(db_work)
            else:
                db_work()
        except Exception:
            # A transient write failure (busy/disk) must not lose the batch:
            # the bookie already says Cleared, so these ranges would never be
            # rediscovered. Re-merge for the next flush tick.
            for actor, ranges in empties.items():
                dst = self._empties.setdefault(actor, RangeSet())
                for s, e in ranges:
                    dst.insert(s, e)
            raise

    # -- periodic metrics (collect_metrics, agent.rs:1126-1187) ----------------

    async def _metrics_loop(self) -> None:
        """Per-table row counts, change-log size, and pool queue depths,
        sampled on the read side every few seconds (the reference's
        metrics_loop runs collect_metrics every 10 s)."""
        rows_g = self.metrics.gauge(
            "corro_db_table_rows", "rows per user table"
        )
        log_g = self.metrics.gauge(
            "corro_db_change_log_rows", "rows in the __crdt_changes log"
        )
        queue_g = self.metrics.gauge(
            "corro_sqlite_write_queue", "queued writer jobs per priority"
        )
        cluster_g = self.metrics.gauge(
            "corro_gossip_cluster_size", "known live members incl. self"
        )
        backlog_g = self.metrics.gauge(
            "corro_gossip_updates_backlog", "membership rumors awaiting send"
        )
        buffered_g = self.metrics.gauge(
            "corro_db_buffered_changes_rows_total",
            "rows in __corro_buffered_changes (partial versions)",
        )
        read_conns_g = self.metrics.gauge(
            "corro_sqlite_pool_read_connections", "read pool size"
        )
        read_idle_g = self.metrics.gauge(
            "corro_sqlite_pool_read_connections_idle", "idle read conns"
        )
        write_conns_g = self.metrics.gauge(
            "corro_sqlite_pool_write_connections", "writer connections"
        )
        subs_dropped_g = self.metrics.gauge(
            "corro_subs_dropped_events",
            "subscription listener-queue overflow drops (each evicts "
            "its stream; clients resume via ?from=)",
        )
        interval = self.cfg.metrics_interval
        while not self.tripwire.tripped:
            await asyncio.sleep(interval)
            cluster_g.set(len(self.members.alive()) + 1)
            if self.subs is not None:
                subs_dropped_g.set(
                    sum(
                        h.dropped_events
                        for h in self.subs._by_id.values()
                    )
                )
            if self.swim is not None:
                backlog_g.set(len(self.swim.rumors))
            if self.pool is None:
                continue  # pool-less agent: nothing to sample
            try:
                # Full-table counts ride the read POOL (off the event
                # loop): at millions of log rows an on-loop scan would
                # stall gossip/API for its duration.
                for name in self.store.tables():
                    _, rows = await self.pool.query(
                        Statement(f'SELECT count(*) FROM "{name}"')
                    )
                    rows_g.set(rows[0][0], table=name)
                _, rows = await self.pool.query(
                    Statement("SELECT count(*) FROM __crdt_changes")
                )
                log_g.set(rows[0][0])
                _, rows = await self.pool.query(
                    Statement(
                        "SELECT count(*) FROM __corro_buffered_changes"
                    )
                )
                buffered_g.set(rows[0][0])
                for label, depth in self.pool.queue_depths().items():
                    queue_g.set(depth, priority=label)
                read_conns_g.set(self.pool._n_read)
                read_idle_g.set(len(self.pool._read_pool))
                write_conns_g.set(1)  # single-writer discipline
            except Exception:
                # Keep sampling; stale gauges with no signal would hide
                # the failure entirely.
                logging.getLogger(__name__).debug(
                    "metrics sample failed", exc_info=True
                )

    # -- member-state persistence (diff_member_states) -------------------------

    def _load_members(self) -> list:
        """Seed Members from __corro_members (setup-time, before loops)."""
        from corrosion_tpu_torch.agent.config import parse_addr
        from corrosion_tpu_torch.agent.membership import DOWN, SUSPECT

        restored = []
        with self.store._wlock("members_load"):
            # Down rows are last-run corpses: the live cluster re-teaches
            # anything real, and without this a restart before the 48 h GC
            # horizon would orphan them forever (no in-memory entry means
            # the persist loop's `gone` diff never covers them).
            self.store.conn.execute(
                "DELETE FROM __corro_members WHERE state = ?", (DOWN,)
            )
        for aid, addr_s, state, inc, _ts in self.store.conn.execute(
            "SELECT actor_id, addr, state, incarnation, updated_at"
            " FROM __corro_members"
        ).fetchall():
            if aid == self.actor_id:
                continue
            addr = parse_addr(addr_s)
            if self.members.apply_update(aid, addr, state, inc):
                m = self.members.states[aid]
                if state == SUSPECT:
                    # Fresh suspicion timer: a stale persisted suspect_at
                    # of 0 would expire to DOWN on the first probe round
                    # and gossip a spurious DOWN rumor cluster-wide.
                    m.suspect_at = time.monotonic()
                restored.append(m)
        return restored

    async def _persist_members_once(self) -> None:
        """One diff-persist pass: only rows whose (addr, state,
        incarnation) moved are written; members GC'd from the in-memory
        table are deleted."""
        async with self._members_persist_lock:
            current = {
                aid: (f"{m.addr[0]}:{m.addr[1]}", m.state, m.incarnation)
                for aid, m in self.members.states.items()
            }
            if self.swim is not None and self.gossip_addr is not None:
                # Own-incarnation row: seeds identity freshness at the
                # next boot (see start()); state ALIVE so the load-time
                # DOWN purge never eats it.
                from corrosion_tpu_torch.agent.membership import ALIVE

                current[self.actor_id] = (
                    f"{self.gossip_addr[0]}:{self.gossip_addr[1]}",
                    ALIVE,
                    self.swim.incarnation,
                )
            changed = [
                (aid, v) for aid, v in current.items()
                if self._members_persisted.get(aid) != v
            ]
            gone = [
                aid for aid in self._members_persisted if aid not in current
            ]
            if not changed and not gone:
                return
            now = time.time()

            def db_work() -> None:
                with self.store._wlock("members_persist"):
                    self.store.conn.executemany(
                        "INSERT OR REPLACE INTO __corro_members"
                        " VALUES (?, ?, ?, ?, ?)",
                        [
                            (aid, addr, state, inc, now)
                            for aid, (addr, state, inc) in changed
                        ],
                    )
                    self.store.conn.executemany(
                        "DELETE FROM __corro_members WHERE actor_id = ?",
                        [(aid,) for aid in gone],
                    )

            if self.pool is not None:
                await self.pool.write_low(db_work)
            else:
                db_work()
            self._members_persisted = current

    async def _members_persist_loop(self) -> None:
        """Persist member-state diffs on a cadence (diff_member_states,
        broadcast/mod.rs:570-702); stop() runs a final pass so a clean
        shutdown loses nothing."""
        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.member_persist_interval)
            try:
                await self._persist_members_once()
            except Exception:
                logging.getLogger(__name__).debug(
                    "member persist failed", exc_info=True
                )

    async def _runtime_metrics_loop(self) -> None:
        """Event-loop/runtime profiling — the tokio-metrics reporter's role
        (command/agent.rs:87-213: scheduled/idle/poll durations, task
        counts). asyncio's equivalents: loop LAG (how late a 1 s sleep
        fires — the 'scheduled duration' signal that catches a blocked
        loop), live task count, and the counted-handle registry depth."""
        from corrosion_tpu_torch.utils.metrics import (
            process_open_fds,
            process_rss_bytes,
            register_process_gauges,
        )

        lag_hist = self.metrics.histogram(
            "corro_runtime_loop_lag_seconds",
            "event-loop wakeup lag of a 1s timer (blocked-loop detector)",
        )
        tasks_g = self.metrics.gauge(
            "corro_runtime_tasks", "live asyncio tasks in this process"
        )
        counted_g = self.metrics.gauge(
            "corro_runtime_counted_handles",
            "tasks tracked by the counted-spawn registry",
        )
        # Process self-observability (docs/OBSERVABILITY.md): RSS,
        # open-fd count, and the last loop-lag sample as gauges, so an
        # hours-long soak's leak signals are on /metrics, not just in
        # post-hoc reports.
        rss_g, fds_g, lag_g = register_process_gauges(self.metrics)
        if (
            self.cfg.metric_series_path
            and self._series_recorder is None
        ):
            # Endurance plane install: attach() is idempotent per path,
            # so an in-process relaunch (kill_restart) adopts the
            # previous life's live recorder instead of raising or
            # double-sampling; a cleanly-closed life reopens mode="a"
            # and the series continues across the restart discontinuity
            # (obs/endurance.py rebases the counter drop).
            from corrosion_tpu_torch.obs.series import MetricSeriesRecorder

            self._series_recorder = MetricSeriesRecorder.attach(
                self.cfg.metric_series_path,
                source=f"agent:{self.actor_id[:8]}",
                max_bytes=self.cfg.metric_series_max_bytes,
            )
        log = logging.getLogger(__name__)
        interval = self.cfg.runtime_metrics_interval
        while not self.tripwire.tripped:
            t0 = time.monotonic()
            await asyncio.sleep(interval)
            lag = max(time.monotonic() - t0 - interval, 0.0)
            lag_hist.observe(lag)
            lag_g.set(lag)
            if lag > 1.0:
                # Slow-turn watchdog (the foca loop warns past 1 s,
                # broadcast/mod.rs:296-300): something blocked the loop.
                log.warning("event loop blocked for %.2fs", lag)
            try:
                tasks_g.set(len(asyncio.all_tasks()))
            except RuntimeError:
                pass
            counted_g.set(self.tasks.pending)
            rss = process_rss_bytes()
            if rss is not None:
                rss_g.set(rss)
            fds = process_open_fds()
            if fds is not None:
                fds_g.set(fds)
            if self._series_recorder is not None:
                try:
                    self._series_recorder.sample(self.metrics)
                except ValueError:
                    # Closed under us (abort racing the tick) — the
                    # loop is about to see the tripwire anyway.
                    pass

    async def _wal_checkpoint_loop(self) -> None:
        """Periodic WAL truncation on the writer, timed (the reference's
        db_cleanup loop: PRAGMA wal_checkpoint(TRUNCATE) every 15 min with
        a duration histogram, agent.rs:956-967, 1413-1435). Background
        write tier: user writes always preempt it."""
        hist = self.metrics.histogram(
            "corro_db_wal_truncate_seconds", "WAL truncation duration"
        )
        bytes_g = self.metrics.gauge(
            "corro_db_wal_bytes_truncated",
            "WAL size reclaimed by the last truncation",
        )
        wal_path = self.store.path + "-wal"
        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.wal_checkpoint_interval)
            try:
                t0 = time.monotonic()

                def ckpt():
                    # Size BEFORE truncating: the pragma reports the
                    # post-truncation log (0 on success), not the amount
                    # reclaimed.
                    try:
                        before = os.path.getsize(wal_path)
                    except OSError:
                        before = 0
                    with self.store._wlock("wal_checkpoint"):
                        row = self.store.conn.execute(
                            "PRAGMA wal_checkpoint(TRUNCATE)"
                        ).fetchone()
                    return before, row

                before, row = await self.pool.write_low(ckpt)
                busy = bool(row and row[0])
                if not busy:
                    # Only a real truncation counts — with busy=1 the
                    # pragma returns without reclaiming anything and the
                    # metrics would show healthy truncations while the
                    # WAL grows.
                    hist.observe(time.monotonic() - t0)
                    bytes_g.set(before)
            except Exception:
                logging.getLogger(__name__).debug(
                    "wal checkpoint failed", exc_info=True
                )

    # -- SWIM loop -------------------------------------------------------------

    async def _swim_loop(self) -> None:
        streak = _StreakLogger("SWIM probe round failed")
        while not self.tripwire.tripped:
            await asyncio.sleep(self.cfg.probe_interval)
            try:
                await self.swim.probe_round()
                streak.ok()
            except Exception:
                streak.fail()

    # -- sync (client: handle_sync/parallel_sync; server: serve_sync) ---------

    async def _sync_loop(self) -> None:
        streak = _StreakLogger("sync session failed")
        while not self.tripwire.tripped:
            await asyncio.sleep(
                self.cfg.sync_interval * (0.75 + random.random() * 0.5)
            )
            try:
                await self._sync_once()
                streak.ok()
            except Exception:
                streak.fail()

    async def _sync_once(self) -> None:
        """Concurrent multi-peer sync (parallel_sync, peer.rs:925-1286):
        sessions to the chosen peers run CONCURRENTLY, a shared claim set
        dedups in-flight need blocks across them (scheduler peer.rs:1108-
        1223), and each session pulls in waves of ``sync_wave_needs``
        blocks so one slow peer never delays the others."""
        peers = self.members.by_ring()  # ring asc (agent.rs:2383-2423)
        if not peers:
            return
        peers = peers[: self.cfg.sync_peers]
        in_flight: set = set()
        await asyncio.gather(
            *(self._sync_with_peer(m, in_flight) for m in peers)
        )

    # Need blocks align to an absolute 10-version grid so concurrent
    # sessions claim identical keys for identical work even when the
    # bookie moved between their waves (chunked ranges, peer.rs:833-841).
    _NEED_BLOCK = 10

    def _claim_needs(
        self, needs: dict, in_flight: set, cap: int
    ) -> tuple[dict, list]:
        """Split needs into grid-aligned blocks, claim up to ``cap`` blocks
        not already in flight elsewhere. Returns (wire-ready needs by
        actor, claimed keys)."""
        out: dict[str, list] = {}
        keys: list = []
        b = self._NEED_BLOCK
        for actor, lst in needs.items():
            for need in lst:
                if isinstance(need, FullNeed):
                    start = need.start
                    while start <= need.end:
                        block_end = min(((start - 1) // b + 1) * b, need.end)
                        key = (actor, "full", (start - 1) // b)
                        if key not in in_flight:
                            in_flight.add(key)
                            keys.append(key)
                            out.setdefault(actor, []).append(
                                FullNeed(start, block_end)
                            )
                            if len(keys) >= cap:
                                return out, keys
                        start = block_end + 1
                else:
                    key = (actor, "part", need.version)
                    if key not in in_flight:
                        in_flight.add(key)
                        keys.append(key)
                        out.setdefault(actor, []).append(need)
                        if len(keys) >= cap:
                            return out, keys
        return out, keys

    async def _sync_with_peer(self, m, in_flight: set) -> None:
        needs_gauge = self.metrics.gauge(
            "corro_sync_needs", "version gaps at last sync generation"
        )
        sess_hist = self.metrics.histogram(
            "corro_sync_client_seconds", "client-side sync session duration"
        )
        attempts_ctr = self.metrics.counter(
            "corro_sync_attempts_count", "sync sessions attempted"
        )
        member_ctr = self.metrics.counter(
            "corro_sync_client_member", "sync sessions established, by peer"
        )
        head_gauge = self.metrics.gauge(
            "corro_sync_client_head",
            "peer-advertised head per actor at session start",
        )
        need_hist = self.metrics.histogram(
            "corro_sync_client_request_operations_need_count",
            "need blocks per sync request wave",
            buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000),
        )
        recv_ctr = self.metrics.counter(
            "corro_sync_changes_recv", "changes received through sync"
        )
        attempts_ctr.inc()
        # Cross-node trace propagation: the session span's traceparent
        # travels in the wire protocol (SyncTraceContextV1, sync.rs:32-67
        # injected peer.rs:941-944).
        span = self.tracer.span("sync_client", peer=m.actor_id[:8])
        span.__enter__()
        t_start = time.monotonic()
        session = await self.transport.open_session(
            m.addr,
            {"t": "sync_start", "actor": self.actor_id,
             "clock": self.hlc.new_timestamp(),
             "trace": span.traceparent},
        )
        if session is None:
            span.__exit__(None, None, None)
            return
        claimed: list = []
        try:
            reply = await session.recv(timeout=5.0)
            if not reply or reply.get("t") != "sync_state":
                return
            member_ctr.inc(peer=m.actor_id[:8])
            self.hlc.update_with_timestamp(reply.get("clock", 0))
            server_state = _state_from_wire(reply["state"])
            # The peer's OWN advertised head only, and a hard series cap:
            # one gauge series per actor in heads would grow with cluster
            # size and never shrink (label cardinality explosion at the
            # 100k target; scrapes render every series).
            peer_head = server_state.heads.get(server_state.actor_id)
            if peer_head is not None:
                lbl = (("actor", server_state.actor_id[:8]),)
                if lbl in head_gauge._values or len(head_gauge._values) < 128:
                    head_gauge.set(
                        peer_head, actor=server_state.actor_id[:8]
                    )
            while not self.tripwire.tripped:
                # Regenerate per wave: blocks ingested from concurrent
                # sessions (and this one's earlier waves) shrink the next
                # request; claims cover what's served but not yet ingested.
                my_state = generate_sync(self.bookie, self.actor_id)
                needs_gauge.set(my_state.need_len())
                needs = my_state.compute_available_needs(server_state)
                wave, keys = self._claim_needs(
                    needs, in_flight, self.cfg.sync_wave_needs
                )
                claimed.extend(keys)
                if not wave:
                    break
                need_hist.observe(sum(len(v) for v in wave.values()))
                await session.send(
                    {"t": "sync_request", "needs": _needs_to_wire(wave)}
                )
                done = False
                while True:
                    frame = await session.recv(timeout=10.0)
                    if frame is None or frame.get("t") == "sync_done":
                        done = True
                        break
                    t = frame.get("t")
                    if t == "sync_wave_done":
                        break
                    if t == "sync_changes":
                        recv_ctr.inc(len(frame.get("changes", ())))
                        inner = dict(frame)
                        inner["t"] = "bcast"
                        try:
                            self._ingest.put_nowait((inner, "sync"))
                        except asyncio.QueueFull:
                            done = True
                            break
                    elif t == "sync_cleared":
                        booked = self.bookie.for_actor(frame["actor"])
                        for s, e in frame["versions"]:
                            booked.insert_many(s, e, CLEARED)
                            # Persist via the empties batcher so the range
                            # survives restart (store path of
                            # process_multiple_changes' empty handling).
                            self._queue_empty(frame["actor"], s, e)
                if done:
                    break
                # Let the ingest batcher absorb this wave before computing
                # the next (smaller) one.
                await asyncio.sleep(self.cfg.ingest_linger * 2)
            try:
                await session.send({"t": "sync_finish"})
            except (ConnectionError, OSError):
                pass
        finally:
            # Release claims so a failed session's blocks become requestable
            # by the next round (in-flight dedup is session-lifetime only).
            for k in claimed:
                in_flight.discard(k)
            session.close()
            sess_hist.observe(time.monotonic() - t_start)
            span.__exit__(None, None, None)

    async def _serve_sync(self, session: Session, start: dict) -> None:
        """Server side (peer.rs:1289-1527): serves request waves until the
        client finishes, under a per-wave version budget (fairness: a peer
        requesting a huge range cannot monopolize the server; the reference
        caps concurrent jobs and chunks adaptively, peer.rs:675-686) with
        adaptive chunk sizing and a 5 s blocking-send abort
        (peer.rs:352-355, 638-653). Continues the client's trace via the
        frame's traceparent (extracted like peer.rs:1296-1298)."""
        with self.tracer.span(
            "sync_server", traceparent=start.get("trace"),
            peer=str(start.get("actor", ""))[:8],
        ):
            self.hlc.update_with_timestamp(start.get("clock", 0))
            state = generate_sync(self.bookie, self.actor_id)
            await session.send(
                {"t": "sync_state", "state": _state_to_wire(state),
                 "clock": self.hlc.new_timestamp()}
            )
            chunker = AdaptiveChunker(
                max_bytes=self.cfg.sync_chunk_max_bytes,
                min_bytes=self.cfg.sync_chunk_min_bytes,
                threshold_s=self.cfg.sync_adapt_threshold,
            )
            try:
                while not self.tripwire.tripped:
                    req = await session.recv(timeout=5.0)
                    if not req or req.get("t") != "sync_request":
                        break  # sync_finish, timeout, or disconnect
                    served = 0
                    budget = self.cfg.sync_serve_budget
                    for actor, needs in _needs_from_wire(
                        req["needs"]
                    ).items():
                        booked = self.bookie.get(actor)
                        if booked is None:
                            continue
                        for need in needs:
                            if served >= budget:
                                break
                            served += await self._serve_need(
                                session, actor, booked, need,
                                chunker=chunker,
                                budget=budget - served,
                            )
                    await session.send(
                        {"t": "sync_wave_done", "served": served}
                    )
                await session.send({"t": "sync_done"})
            except asyncio.TimeoutError:
                # Blocking-send stall: abort the session (the client
                # re-requests unserved blocks next round).
                session.close()

    async def _timed_send(self, session, frame, chunker) -> None:
        """Send with the stall abort + chunk-size feedback loop. Both
        defenses count when they engage: the abort edge here, the
        halving edge via AdaptiveChunker.record's return."""
        t0 = time.monotonic()
        try:
            nbytes = await asyncio.wait_for(
                session.send(frame), self.cfg.sync_stall_timeout
            )
        except asyncio.TimeoutError:
            self._m_stall_aborts.inc()
            raise
        if chunker is not None and chunker.record(time.monotonic() - t0):
            self._m_chunk_halvings.inc()
        if frame.get("t") == "sync_changes":
            self._m_sync_sent_bytes.inc(nbytes or 0)
            self._m_sync_sent.inc(len(frame.get("changes", ())))

    async def _serve_need(
        self, session, actor, booked, need, chunker=None, budget=None
    ) -> int:
        """Serve one need; returns the number of versions streamed (cleared
        spans are range metadata, not streamed rows, and don't count).
        ``budget`` truncates a large FullNeed — the client's claim
        machinery re-requests the rest next round."""
        served = 0
        if isinstance(need, FullNeed):
            # Cleared spans come straight from the interval set — a large
            # compacted range must not be walked version-by-version (it
            # would block the event loop and stall SWIM probes).
            cleared = [
                (max(s, need.start), min(e, need.end))
                for s, e in booked.cleared
                if s <= need.end and e >= need.start
            ]
            if cleared:
                await self._timed_send(
                    session,
                    {"t": "sync_cleared", "actor": actor, "versions": cleared},
                    chunker,
                )
            for v, known in sorted(booked.current.items()):
                if v < need.start or v > need.end:
                    continue
                if budget is not None and served >= budget:
                    break
                changes = self.store.changes_for(
                    bytes.fromhex(actor), known.db_version
                )
                max_bytes = chunker.max_bytes if chunker else None
                for chunk, (s, e) in chunk_changes(
                    changes, known.last_seq,
                    **({"max_bytes": max_bytes} if max_bytes else {}),
                ):
                    await self._timed_send(
                        session,
                        self._sync_changes_frame(
                            actor, v, chunk, (s, e), known.last_seq, known.ts,
                        ),
                        chunker,
                    )
                served += 1
        elif isinstance(need, PartialNeed):
            known = booked.get(need.version)
            if isinstance(known, Partial):
                # Read connection (not the writer): the pool's writer
                # thread may hold an open BEGIN IMMEDIATE on store.conn,
                # and this read runs on the event loop — same discipline
                # as changes_for.
                rows = self.store.read_conn.execute(  # corro-lint: disable=CT042 reason=WAL read connection off the writer; bounded rows per need frame (changes_for discipline)
                    "SELECT tbl, pk, cid, val, col_version, db_version,"
                    " seq, site_id, cl FROM __corro_buffered_changes"
                    " WHERE actor_id = ? AND version = ? ORDER BY seq",
                    (bytes.fromhex(actor), need.version),
                ).fetchall()
                by_seq = {r[6]: Change.from_tuple(tuple(r)) for r in rows}
                last_seq, ts = known.last_seq, known.ts
            elif isinstance(known, Current):
                # The version is COMPLETE here: a partial need must still
                # be answerable (sync.rs:248-266 — the requester's gaps
                # came from lossy dissemination; holders of the applied
                # version are exactly who can fill them). Without this
                # branch a node whose partial buffer lost chunks stalls
                # FOREVER once every peer has compacted the version to
                # Current (measured: a 2-node catch-up wedged at
                # 39/40 versions permanently).
                changes = self.store.changes_for(
                    bytes.fromhex(actor), known.db_version
                )
                by_seq = {c.seq: c for c in changes}
                last_seq, ts = known.last_seq, known.ts
            else:
                return 0
            for s, e in need.seqs:
                have = [by_seq[q] for q in range(s, e + 1) if q in by_seq]
                if not have:
                    continue
                lo = min(c.seq for c in have)
                hi = max(c.seq for c in have)
                await self._timed_send(
                    session,
                    self._sync_changes_frame(
                        actor, need.version, have, (lo, hi),
                        last_seq, ts,
                    ),
                    chunker,
                )
            served = 1
        return served

    def _sync_changes_frame(self, actor, version, changes, seqs, last_seq, ts):
        f = self._changeset_frame(actor, version, changes, seqs, last_seq, ts)
        f["t"] = "sync_changes"
        return f


# -- sync state wire codec ---------------------------------------------------


def _state_to_wire(state) -> dict:
    return {
        "actor_id": state.actor_id,
        "heads": dict(state.heads),
        "need": {a: [list(r) for r in rs] for a, rs in state.need.items()},
        "partial_need": {
            a: {str(v): [list(r) for r in rs] for v, rs in partials.items()}
            for a, partials in state.partial_need.items()
        },
    }


def _state_from_wire(w: dict):
    from corrosion_tpu_torch.core.bookkeeping import SyncState

    return SyncState(
        actor_id=w["actor_id"],
        heads=dict(w["heads"]),
        need={a: [tuple(r) for r in rs] for a, rs in w["need"].items()},
        partial_need={
            a: {int(v): [tuple(r) for r in rs] for v, rs in partials.items()}
            for a, partials in w["partial_need"].items()
        },
    )


def _needs_to_wire(needs) -> dict:
    out: dict = {}
    for actor, lst in needs.items():
        items = []
        for n in lst:
            if isinstance(n, FullNeed):
                items.append({"full": [n.start, n.end]})
            else:
                items.append(
                    {"partial": {"version": n.version,
                                 "seqs": [list(s) for s in n.seqs]}}
                )
        out[actor] = items
    return out


def _needs_from_wire(w: dict):
    out: dict = {}
    for actor, lst in w.items():
        items = []
        for n in lst:
            if "full" in n:
                items.append(FullNeed(n["full"][0], n["full"][1]))
            else:
                items.append(
                    PartialNeed(
                        n["partial"]["version"],
                        [tuple(s) for s in n["partial"]["seqs"]],
                    )
                )
        out[actor] = items
    return out

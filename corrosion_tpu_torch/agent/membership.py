"""Host-side SWIM membership + RTT rings.

The role foca plays for the reference (corro-agent/src/broadcast/mod.rs
runtime_loop + corro-types/src/members.rs), for real (non-simulated) agents:

- probe/ack with indirect probes, suspicion with timeout -> down,
  incarnation-based refutation (foca semantics; the batched kernel version
  of the same state machine is ops/swim.py).
- membership updates piggyback on probe traffic with a retransmission
  budget (~log2(n) like make_foca_config, broadcast/mod.rs:704-713).
- per-member RTT ring buckets 0-5/5-15/15-50/50-100/100-200/200-300 ms
  (members.rs:33,101-136); ring 0 gets eager broadcasts and sync priority.

Counterpart of corrosion_tpu/agent/membership.py.
"""

from __future__ import annotations

import asyncio
import math
import random
import time
from dataclasses import dataclass, field

RING_BUCKETS_MS = (5.0, 15.0, 50.0, 100.0, 200.0, 300.0)  # members.rs:33

ALIVE, SUSPECT, DOWN = "alive", "suspect", "down"


def rtt_ring(rtt_ms: float) -> int:
    for i, edge in enumerate(RING_BUCKETS_MS):
        if rtt_ms < edge:
            return i
    return len(RING_BUCKETS_MS) - 1


@dataclass
class MemberState:
    actor_id: str
    addr: tuple[str, int]
    state: str = ALIVE
    incarnation: int = 0
    rtts: list[float] = field(default_factory=list)  # ms, circular (cap 20)
    ring: int | None = None
    suspect_at: float = 0.0
    down_at: float = 0.0  # monotonic time the member was declared down

    def add_rtt(self, ms: float) -> None:
        self.rtts.append(ms)
        if len(self.rtts) > 20:
            self.rtts.pop(0)
        self.ring = rtt_ring(sum(self.rtts) / len(self.rtts))


class Members:
    """Known peers, keyed by actor id (corro-types/src/members.rs:12-137)."""

    def __init__(self, self_id: str) -> None:
        self.self_id = self_id
        self.states: dict[str, MemberState] = {}
        # Optional event hooks (the agent wires these to the
        # corro_gossip_member_added/_removed counters).
        self.on_added = None
        self.on_removed = None

    def alive(self) -> list[MemberState]:
        return [m for m in self.states.values() if m.state != DOWN]

    def ring0(self) -> list[MemberState]:
        return [m for m in self.alive() if m.ring == 0]

    def by_ring(self) -> list[MemberState]:
        return sorted(
            self.alive(), key=lambda m: m.ring if m.ring is not None else 99
        )

    def apply_update(
        self, actor_id: str, addr: tuple[str, int], state: str, inc: int
    ) -> bool:
        """Merge a membership rumor; returns True if it changed anything
        (and so should keep disseminating)."""
        if actor_id == self.self_id:
            return False
        m = self.states.get(actor_id)
        if m is None:
            if state == DOWN:
                return False
            self.states[actor_id] = MemberState(
                actor_id=actor_id, addr=addr, state=state, incarnation=inc
            )
            if self.on_added is not None:
                self.on_added(actor_id)
            return True
        # foca precedence: higher incarnation wins; same incarnation,
        # down > suspect > alive.
        rank = {ALIVE: 0, SUSPECT: 1, DOWN: 2}
        if inc < m.incarnation:
            return False
        if inc == m.incarnation and rank[state] <= rank[m.state]:
            return False
        m.state = state
        m.incarnation = inc
        m.addr = addr
        if state == SUSPECT:
            m.suspect_at = time.monotonic()
        elif state == DOWN:
            m.down_at = time.monotonic()
        return True

    def gc_down(self, horizon_s: float) -> list[str]:
        """Forget members down longer than ``horizon_s`` (foca's
        remove_down_after, 48 h in the WAN preset, broadcast/mod.rs:704-713)
        so a long-lived cluster's member table doesn't accumulate corpses.
        Returns the removed actor ids."""
        now = time.monotonic()
        gone = [
            aid for aid, m in self.states.items()
            if m.state == DOWN and m.down_at and now - m.down_at > horizon_s
        ]
        for aid in gone:
            del self.states[aid]
            if self.on_removed is not None:
                self.on_removed(aid)
        return gone


@dataclass
class Rumor:
    actor_id: str
    addr: tuple[str, int]
    state: str
    incarnation: int
    tx_left: int

    def wire(self) -> dict:
        return {
            "id": self.actor_id,
            "addr": list(self.addr),
            "state": self.state,
            "inc": self.incarnation,
        }


class Swim:
    """Probe scheduler + rumor queue. The owning agent wires `send` to the
    transport and calls `on_message` for inbound swim frames."""

    def __init__(
        self,
        members: Members,
        self_addr: tuple[str, int],
        send,  # async (addr, dict) -> bool
        probe_interval: float = 1.0,
        probe_timeout: float = 0.5,
        suspect_timeout: float = 3.0,
        indirect_probes: int = 2,
        max_transmissions: int = 6,
    ) -> None:
        self.members = members
        self.self_addr = self_addr
        self.send = send
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.suspect_timeout = suspect_timeout
        self.indirect_probes = indirect_probes
        self.max_transmissions = max_transmissions
        # Cluster-size-adaptive dissemination (the reference resizes foca's
        # config on every cluster-size notification, agent.rs:1345-1358 →
        # make_foca_config, broadcast/mod.rs:704-713): retransmission budget
        # scales ~log2 of the cluster so rumors still infect everyone, and
        # down members are forgotten after ``down_gc_s`` (remove_down_after,
        # 48 h in the WAN preset).
        self._base_max_transmissions = max_transmissions
        self._base_indirect = indirect_probes
        self._last_size = 0
        self.down_gc_s = 48 * 3600.0
        self.incarnation = 0
        self.rumors: list[Rumor] = []
        self._acks: dict[int, asyncio.Event] = {}
        self._seq = 0

    def _adapt_config(self) -> None:
        """Recompute dissemination parameters from the current cluster size
        (called every probe round; cheap, idempotent)."""
        size = len(self.members.alive()) + 1
        if size == self._last_size:
            return
        self._last_size = size
        self.max_transmissions = max(
            self._base_max_transmissions, math.ceil(1.5 * math.log2(size + 1))
        )
        self.indirect_probes = max(
            self._base_indirect, min(5, math.ceil(math.log2(size + 1) / 2))
        )

    # -- dissemination -------------------------------------------------------

    def queue_rumor(self, actor_id, addr, state, inc) -> None:
        self.rumors = [r for r in self.rumors if r.actor_id != actor_id]
        self.rumors.append(
            Rumor(actor_id, tuple(addr), state, inc, self.max_transmissions)
        )

    def _piggyback(self) -> list[dict]:
        sent, out = self.rumors[:8], []
        for r in sent:
            out.append(r.wire())
            r.tx_left -= 1
        # Rotate: spent rumors drop, unsent ones move to the front so a
        # deep backlog still disseminates everything over later packets.
        keep = [r for r in sent if r.tx_left > 0]
        self.rumors = self.rumors[8:] + keep
        return out

    def _absorb(self, updates: list[dict]) -> None:
        for u in updates:
            aid, addr = u["id"], tuple(u["addr"])
            if aid == self.members.self_id:
                # Refutation: bump incarnation and re-announce
                # (actor.rs:184-194's renew-on-down).
                if u["state"] in (SUSPECT, DOWN) and u["inc"] >= self.incarnation:
                    self.incarnation = u["inc"] + 1
                    self.queue_rumor(
                        aid, self.self_addr, ALIVE, self.incarnation
                    )
                continue
            if self.members.apply_update(aid, addr, u["state"], u["inc"]):
                self.queue_rumor(aid, addr, u["state"], u["inc"])

    async def leave_cluster(self) -> None:
        """Graceful departure (foca.leave_cluster on shutdown,
        broadcast/mod.rs:306): announce self DOWN at the CURRENT
        incarnation directly to a handful of alive peers, so the cluster
        learns immediately instead of paying a probe-timeout + suspect
        window. Peers won't refute it (only the node itself refutes), and
        a later restart re-announces alive at a higher incarnation."""
        peers = [m for m in self.members.alive() if m.state == ALIVE]
        random.shuffle(peers)
        frame = {
            "t": "swim",
            "k": "leave",
            "from": self.members.self_id,
            "from_addr": list(self.self_addr),
            "updates": [
                {
                    "id": self.members.self_id,
                    "addr": list(self.self_addr),
                    "state": DOWN,
                    "inc": self.incarnation,
                }
            ],
        }
        for m in peers[: max(self.indirect_probes * 2, 4)]:
            try:
                await self.send(m.addr, frame)
            except Exception:
                continue

    # -- probe loop ----------------------------------------------------------

    async def probe_round(self) -> None:
        self._adapt_config()
        self.members.gc_down(self.down_gc_s)
        alive = [m for m in self.members.alive() if m.state == ALIVE]
        # Expire suspects first (suspect -> down).
        now = time.monotonic()
        for m in list(self.members.states.values()):
            if m.state == SUSPECT and now - m.suspect_at > self.suspect_timeout:
                m.state = DOWN
                m.down_at = now
                self.queue_rumor(m.actor_id, m.addr, DOWN, m.incarnation)
        if not alive:
            return
        target = random.choice(alive)
        t0 = time.monotonic()
        ok = await self._probe(target.addr)
        if ok:
            target.add_rtt((time.monotonic() - t0) * 1000.0)
            return
        # Indirect probes (num_indirect_probes, foca config).
        others = [m for m in alive if m.actor_id != target.actor_id]
        random.shuffle(others)
        for via in others[: self.indirect_probes]:
            if await self._probe_req(via.addr, target):
                return
        if target.state == ALIVE:
            target.state = SUSPECT
            target.suspect_at = time.monotonic()
            self.queue_rumor(
                target.actor_id, target.addr, SUSPECT, target.incarnation
            )

    async def _probe(self, addr) -> bool:
        self._seq += 1
        seq = self._seq
        ev = asyncio.Event()
        self._acks[seq] = ev
        try:
            sent = await self.send(
                addr,
                {
                    "t": "swim",
                    "k": "ping",
                    "seq": seq,
                    "from": self.members.self_id,
                    "from_addr": list(self.self_addr),
                    "inc": self.incarnation,
                    "updates": self._piggyback(),
                },
            )
            if not sent:
                return False
            await asyncio.wait_for(ev.wait(), self.probe_timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._acks.pop(seq, None)

    async def _probe_req(self, via_addr, target: MemberState) -> bool:
        self._seq += 1
        seq = self._seq
        ev = asyncio.Event()
        self._acks[seq] = ev
        try:
            sent = await self.send(
                via_addr,
                {
                    "t": "swim",
                    "k": "ping_req",
                    "seq": seq,
                    "from": self.members.self_id,
                    "from_addr": list(self.self_addr),
                    "target": list(target.addr),
                    "updates": self._piggyback(),
                },
            )
            if not sent:
                return False
            await asyncio.wait_for(ev.wait(), self.probe_timeout * 2)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            self._acks.pop(seq, None)

    # -- inbound -------------------------------------------------------------

    async def on_message(self, msg: dict) -> None:
        kind = msg.get("k")
        self._absorb(msg.get("updates", []))
        if kind == "ping":
            frm = msg["from"]
            addr = tuple(msg["from_addr"])
            if self.members.apply_update(frm, addr, ALIVE, msg.get("inc", 0)):
                self.queue_rumor(frm, addr, ALIVE, msg.get("inc", 0))
            updates = self._piggyback()
            m = self.members.states.get(frm)
            if m is not None and m.state != ALIVE:
                # Suspicion feedback (the announce handler's about_frm
                # rule, applied to pings): a ping from a peer we believe
                # SUSPECT/DOWN is refused by incarnation precedence, so
                # without telling the pinger what we believe about IT the
                # peer pings forever without learning it must refute —
                # and a healed partition never heals the membership.
                # The suspect rumor's own retransmission budget is spent
                # long before a multi-second partition clears; this
                # feedback is deterministic, not budget-gated.
                updates.append(
                    Rumor(frm, m.addr, m.state, m.incarnation, 1).wire()
                )
            await self.send(
                addr,
                {
                    "t": "swim",
                    "k": "ack",
                    "seq": msg["seq"],
                    "from": self.members.self_id,
                    "from_addr": list(self.self_addr),
                    "updates": updates,
                },
            )
        elif kind == "ack":
            ev = self._acks.get(msg.get("seq"))
            if ev:
                ev.set()
        elif kind == "ping_req":
            # Probe the target on the requester's behalf; relay the ack.
            target = tuple(msg["target"])
            ok = await self._probe(target)
            if ok:
                await self.send(
                    tuple(msg["from_addr"]),
                    {
                        "t": "swim",
                        "k": "ack",
                        "seq": msg["seq"],
                        "from": self.members.self_id,
                        "from_addr": list(self.self_addr),
                        "updates": [],
                    },
                )
        elif kind == "announce":
            frm = msg["from"]
            addr = tuple(msg["from_addr"])
            inc = msg.get("inc", 0)
            if self.members.apply_update(frm, addr, ALIVE, inc):
                self.queue_rumor(frm, addr, ALIVE, inc)
            # Reply with everything we know (bootstrap catch-up) — and,
            # crucially, our belief about the ANNOUNCER itself when it is
            # not plain alive: a node that left gracefully and restarted
            # must learn it is believed DOWN so it can refute with a
            # higher incarnation (otherwise it stays invisible until the
            # down-member GC).
            known = [
                Rumor(m.actor_id, m.addr, m.state, m.incarnation, 1).wire()
                for m in self.members.alive()
            ]
            about_frm = self.members.states.get(frm)
            if about_frm is not None and about_frm.state != ALIVE:
                known.append(
                    Rumor(
                        frm, about_frm.addr, about_frm.state,
                        about_frm.incarnation, 1,
                    ).wire()
                )
            known.append(
                Rumor(
                    self.members.self_id, self.self_addr, ALIVE,
                    self.incarnation, 1,
                ).wire()
            )
            await self.send(
                addr,
                {"t": "swim", "k": "known", "updates": known},
            )
        elif kind == "known":
            pass  # updates already absorbed above

    async def announce(self, addr: tuple[str, int]) -> None:
        await self.send(
            addr,
            {
                "t": "swim",
                "k": "announce",
                "from": self.members.self_id,
                "from_addr": list(self.self_addr),
                "inc": self.incarnation,
                "updates": [],
            },
        )

"""Identity and version newtypes.

Mirrors corro-base-types/src/lib.rs (Version/CrsqlDbVersion/CrsqlSeq u64
newtypes) and corro-types/src/actor.rs (ActorId = 16-byte site id; Actor =
id + gossip addr + join timestamp + cluster id).

In the TPU sim, an ActorId maps to a dense node index (int32); the host agent
uses the full 16-byte id on the wire and as the CRR site_id.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

# u64 newtypes — plain ints with semantic aliases. Version is the per-actor
# logical version (one per committed local transaction); DbVersion is the CRR
# database version assigned by the storage layer; Seq orders the rows of one
# changeset so large transactions can stream in chunks.
Version = int
DbVersion = int
Seq = int


@dataclass(frozen=True, order=True)
class ActorId:
    """16-byte actor identity (== the CRR site_id), like actor.rs:26."""

    bytes: bytes = field(default=b"\x00" * 16)

    def __post_init__(self) -> None:
        if len(self.bytes) != 16:
            raise ValueError(f"ActorId must be 16 bytes, got {len(self.bytes)}")

    @classmethod
    def random(cls) -> "ActorId":
        return cls(uuid.uuid4().bytes)

    @classmethod
    def from_hex(cls, s: str) -> "ActorId":
        return cls(uuid.UUID(s.replace("-", "")).bytes)

    @property
    def hex(self) -> str:
        return self.bytes.hex()

    @property
    def uuid(self) -> uuid.UUID:
        return uuid.UUID(bytes=self.bytes)

    def to_node_index(self, n_nodes: int) -> int:
        """Stable dense-index hash for sim-side sharding."""
        return int.from_bytes(self.bytes[:8], "big") % n_nodes

    def __str__(self) -> str:
        return str(self.uuid)

    def __repr__(self) -> str:
        return f"ActorId({self.uuid})"


@dataclass(frozen=True)
class Actor:
    """Cluster identity carried in SWIM messages (actor.rs:134-194).

    ``bump`` mirrors the renew counter: when a node is declared down it renews
    its identity (same id/addr, bumped counter) and auto-rejoins.
    """

    id: ActorId
    addr: tuple[str, int]  # (host, port) of the gossip endpoint
    ts: int = 0  # HLC timestamp at join/renew
    bump: int = 0

    def renew(self, ts: int) -> "Actor":
        return Actor(self.id, self.addr, ts, self.bump + 1)

    def same_node(self, other: "Actor") -> bool:
        return self.id == other.id

    def wins_over(self, other: "Actor") -> bool:
        """Higher bump (then ts) replaces an older identity for the same id."""
        return (self.bump, self.ts) > (other.bump, other.ts)

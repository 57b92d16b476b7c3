"""Host agent: the product surface around the simulator.

Python/SQLite equivalent of the reference's corro-agent + corro-types host
runtime: a CRDT SQLite store (cr-sqlite's role), version bookkeeping, gossip
broadcast + anti-entropy sync over a TCP transport, an HTTP API with
streaming subscriptions, and the background loops that tie them together.

The port's copy of corrosion_tpu/agent/ holds its first layer so far:
``store``, ``membership``, ``config``, ``pgsql`` and ``transport``, the
modules that import nothing of the agent runtime; they are the host
oracles of the simulator's CRDT merge, SWIM and sync planes.
"""

from corrosion_tpu_torch.agent.store import Store, StoreError, SchemaError  # noqa: F401

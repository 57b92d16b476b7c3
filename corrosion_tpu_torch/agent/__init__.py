"""Host agent: the product surface around the simulator.

Python/SQLite equivalent of the reference's corro-agent + corro-types host
runtime: a CRDT SQLite store (cr-sqlite's role), version bookkeeping, gossip
broadcast + anti-entropy sync over a TCP transport, an HTTP API with
streaming subscriptions, and the background loops that tie them together.

The port's copy of corrosion_tpu/agent/ holds the first layer (``store``,
``membership``, ``config``, ``pgsql``, ``transport``: the host oracles of
the simulator's CRDT merge, SWIM and sync planes) and the runtime
(``pool``, ``subs``, ``backup``, ``netem``, ``agent``, ``api``, ``admin``,
``testing``). ``pg`` (the Postgres wire server) and ``tls`` are not ported
yet.
"""

from corrosion_tpu_torch.agent.store import Store, StoreError, SchemaError  # noqa: F401

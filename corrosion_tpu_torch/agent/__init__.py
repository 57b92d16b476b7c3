"""Host agent: the product surface around the simulator.

Python/SQLite equivalent of the reference's corro-agent + corro-types host
runtime: a CRDT SQLite store (cr-sqlite's role), version bookkeeping, gossip
broadcast + anti-entropy sync over a TCP transport, an HTTP API with
streaming subscriptions, and the background loops that tie them together.

The port's copy of corrosion_tpu/agent/ holds the first layer (``store``,
``membership``, ``config``, ``pgsql``, ``transport``: the host oracles of
the simulator's CRDT merge, SWIM and sync planes), the runtime
(``pool``, ``subs``, ``backup``, ``netem``, ``agent``, ``api``, ``admin``,
``testing``) and the serving plane (``pg``, the Postgres wire server;
``tls``, imported only where a config asks for gossip TLS, since it needs
the ``cryptography`` package).
"""

from corrosion_tpu_torch.agent.store import Store, StoreError, SchemaError  # noqa: F401

"""What a mesh position's round body asks of its driver, and the driver
of a body that holds every row.

A round body (``sim.engine.round_body``, ``sim.sparse_engine._sparse_round``,
``sim.chunk_engine._round``, ``sim.mixed_engine._mixed_round`` and the
plane bodies they call: ``gossip._broadcast_round``, ``gossip._sync_round``,
the SWIM modules' ``_swim_round``/``_apply_churn``,
``faulting._wipe_nodes``, ``chunks._chunk_round``) is a generator over one
position's rows of the node axis (a ``Pos``). Where the round
reads what other positions own, the body yields one of the requests below
and takes the answer back from ``yield``:

- ``Reduce``: partial sums, maxima and ORs, answered with their totals;
- ``Gather``: the position's rows of ``[N]`` control vectors (alive,
  incarnation), answered with the whole vectors;
- ``Rows``: rows by global node index, each owner serving the rows asked
  of it from its own block of each table;
- ``Route``: entries addressed to global rows, delivered to the rows'
  owners in sender order (the dense view's push merge, the rumor kill's
  feedback, the chunk send);
- ``Queue``: the pending-queue tables, answered with every position's,
  gathered (the broadcast plane's wire).

The shard driver (``parallel/shard_driver.py``) answers the positions'
requests together. ``solo`` drives a body that holds every row: there each
request is its own answer, so the unsharded engine runs the same bodies
with no exchange.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pos(NamedTuple):
    """A position's rows of the node axis: global rows ``[row_start,
    row_start + n_local)`` of ``n_total``. ``cohorts`` [interval, m] lists,
    for each sync cohort, the cohort entries whose node this position owns
    (-1 pads); None means every entry (a position holding every row)."""

    row_start: int
    n_local: int
    n_total: int
    cohorts: torch.Tensor | None = None

    @property
    def whole(self) -> bool:
        return self.n_local == self.n_total

    @property
    def box(self):
        """The position's rows as a draw's sub-box (``rng``'s ``rows``),
        None when it holds them all."""
        return None if self.whole else (self.row_start, self.row_start + self.n_local)

    def nodes(self, device) -> torch.Tensor:
        """Global node id of each local row."""
        return self.row_start + torch.arange(self.n_local, device=device)


def whole(n: int) -> Pos:
    """The position of an unsharded round: every row."""
    return Pos(row_start=0, n_local=n, n_total=n)


class Reduce(NamedTuple):
    """Partials answered with their totals over every position: ``sum``
    (integer adds, so the order does not matter), ``max`` and ``any``."""

    tag: str
    sum: tuple = ()
    max: tuple = ()
    any: tuple = ()


class Gather(NamedTuple):
    """The position's ``[n_local, ...]`` blocks of control vectors,
    answered with the whole ``[N, ...]`` vectors."""

    tag: str
    parts: tuple


class Rows(NamedTuple):
    """Rows ``index`` (global node ids, any shape) of each table, where
    every position offers its own ``[n_local, ...]`` block of ``tables``.
    Answered with one ``index.shape + row`` tensor per table."""

    tag: str
    tables: tuple
    index: torch.Tensor


class Route(NamedTuple):
    """Entries ``payloads[j][e]`` addressed to global row ``dest[e]``
    where ``valid[e]``. Answered, at each position, with the entries
    addressed to its rows, every position's in position order and each in
    its own order: ``(local_dest, valid, payloads)``."""

    tag: str
    dest: torch.Tensor
    valid: torch.Tensor
    payloads: tuple


class Queue(NamedTuple):
    """The position's pending-queue tables (``q_writer``, ``q_ver``,
    ``q_tx`` and, with writer ids, ``q_gw``), answered with a
    ``QueueAnswer`` of every position's, gathered."""

    tables: tuple


class QueueAnswer(NamedTuple):
    tables: tuple  # [N, Q] int64 each
    ici_bytes: float | None  # the exchange's wire bytes; None unsharded
    dcn_bytes: float | None


def answer_solo(req):
    """A request's answer where one position holds every row."""
    if isinstance(req, Reduce):
        return req
    if isinstance(req, Gather):
        return req.parts
    if isinstance(req, Rows):
        return tuple(t[req.index] for t in req.tables)
    if isinstance(req, Route):
        return req.dest, req.valid, req.payloads
    if isinstance(req, Queue):
        return QueueAnswer(req.tables, None, None)
    raise TypeError(f"not an exchange request: {type(req).__name__}")


def solo(body):
    """Run a round body that holds every row, answering each of its
    requests itself; returns the body's result."""
    value = None
    try:
        while True:
            value = answer_solo(body.send(value))
    except StopIteration as done:
        return done.value

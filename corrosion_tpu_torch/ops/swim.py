"""Batched SWIM membership over a dense packed view, in PyTorch.

Counterpart of corrosion_tpu/ops/swim.py (its module docstring describes
the model). A belief packs into one u32 as ``inc << 2 | severity``
(0 alive, 1 suspect, 2 down), so SWIM's merge rule is ``max`` and every
dissemination step is one scatter-max into the u32[N, N] view (row i =
node i's beliefs). Configs with ``view_capacity > 0`` run the sparse
exception-table kernel instead (``swim_sparse``); ``impl`` picks one.

``_swim_round``, ``_apply_churn`` and the ``_mismatches``/``_health_counts``
partials run over one mesh position's rows (``ops/exchange.py``): a block
of the view is ``[n_local, N]`` (its nodes' beliefs about every node), the
incarnations come in by a control-vector gather, the push merge into other
positions' rows is a ``Route`` to their owners, and a revived node's seed
view a ``Rows`` gather. The public functions are the same bodies on one
position holding every row.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import exchange, faulting, routing

SEV_ALIVE = 0
SEV_SUSPECT = 1
SEV_DOWN = 2


def pack(inc: torch.Tensor, sev: int) -> torch.Tensor:
    return ((inc << 2) | sev) & 0xFFFFFFFF


def packed_inc(p: torch.Tensor) -> torch.Tensor:
    return p >> 2


def packed_sev(p: torch.Tensor) -> torch.Tensor:
    return p & 3


@dataclass(frozen=True)
class SwimConfig:
    """Static round-model parameters (field for field the reference's)."""

    n_nodes: int
    suspect_rounds: int = 3
    gossip_fanout: int = 3
    max_transmissions: int = 6
    backlog: int = 16
    timers: int = 8
    probe_tries: int = 4
    loss_prob: float = 0.0
    view_capacity: int = 0
    view_intake: int = 0
    down_gc_rounds: int = 0


def impl(cfg: SwimConfig):
    """Kernel module for this config: the sparse exception tables when
    ``view_capacity > 0``, else this dense-view module. Both expose
    init_state / swim_round / apply_churn / mismatches / health_counts."""
    if cfg.view_capacity > 0:
        from corrosion_tpu_torch.ops import swim_sparse

        return swim_sparse
    return sys.modules[__name__]


class SwimState(NamedTuple):
    view: torch.Tensor  # [N, N] packed beliefs; row i = node i's view
    incarnation: torch.Tensor  # [N] own incarnation
    alive: torch.Tensor  # bool[N] ground-truth process liveness
    susp_target: torch.Tensor  # [N, S] (-1 = empty)
    susp_inc: torch.Tensor  # [N, S]
    susp_started: torch.Tensor  # [N, S]
    upd_target: torch.Tensor  # [N, U] (-1 = empty)
    upd_packed: torch.Tensor  # [N, U]
    upd_tx: torch.Tensor  # [N, U] transmissions left


def init_state(cfg: SwimConfig, device=None, n_rows: int | None = None) -> SwimState:
    """The initial state; ``n_rows`` builds just a position's block of
    that many rows."""
    device = resolve_device(device)
    n, s, u = cfg.n_nodes, cfg.timers, cfg.backlog
    nr = n if n_rows is None else n_rows

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=device)

    return SwimState(
        view=full((nr, n), 0),  # everyone alive @ inc 0
        incarnation=full((nr,), 0),
        alive=torch.ones((nr,), dtype=torch.bool, device=device),
        susp_target=full((nr, s), -1),
        susp_inc=full((nr, s), 0),
        susp_started=full((nr, s), 0),
        upd_target=full((nr, u), -1),
        upd_packed=full((nr, u), 0),
        upd_tx=full((nr, u), 0),
    )


def _merge_scatter(view, recv, tgt, packed, valid):
    """view[recv, tgt] = max(view[recv, tgt], packed) where valid (``recv``
    a row of the block). Invalid entries scatter 0 into flat index 0, a
    no-op under max, as in the reference."""
    n = view.shape[1]
    idx = torch.where(valid, recv * n + tgt, 0).reshape(-1)
    val = torch.where(valid, packed, 0).reshape(-1)
    flat = view.reshape(-1).clone()
    flat.scatter_reduce_(0, idx, val, "amax", include_self=True)
    return flat.reshape(view.shape)


def swim_round(state: SwimState, rng, round_idx, cfg: SwimConfig, probe_loss=None):
    """One bulk-synchronous SWIM protocol period for all N nodes
    (reference ``swim.swim_round``). ``probe_loss`` drops probe/ack
    exchanges only."""
    return exchange.solo(_swim_round(
        state, state.alive, rng, round_idx, cfg, probe_loss, exchange.whole(cfg.n_nodes)
    ))


def _swim_round(state: SwimState, alive, rng, round_idx, cfg: SwimConfig, probe_loss, pos):
    """``swim_round`` over one position's rows (``state`` its block,
    ``alive`` the whole liveness vector)."""
    n = cfg.n_nodes
    nl = pos.n_local
    dev = state.view.device
    nodes = pos.nodes(dev)  # global id of each row
    local = torch.arange(nl, device=dev)
    keys = rng_mod.split_keys(rng, 3)
    k_probe, k_loss, k_goss = keys[0], keys[1], keys[2]
    view = state.view
    alive_r = state.alive
    (inc_all,) = yield exchange.Gather("incarnation", (state.incarnation,))
    inc_self = state.incarnation
    cand_tgt, cand_pkd, cand_tx, cand_ok = [], [], [], []

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=dev)

    # ---- 1. probe: rejection-sample a target != self not believed down ----
    tries = rng_mod.randint(k_probe, (cfg.probe_tries, n), 0, n, rows=pos.box, axis=1)
    probe_tgt = full((nl,), -1)
    for i in range(cfg.probe_tries):
        t = tries[i]
        ok = (t != nodes) & (packed_sev(view[local, t]) < SEV_DOWN) & (probe_tgt < 0)
        probe_tgt = torch.where(ok, t, probe_tgt)
    has_probe = (probe_tgt >= 0) & alive_r
    pt = torch.clamp(probe_tgt, min=0)
    ack, _ = faulting.apply_loss(k_loss, has_probe & alive[pt], cfg.loss_prob, probe_loss,
                                 full_rows=(n, pos.row_start))
    ack_pkd = pack(inc_all[pt], SEV_ALIVE)
    known = view[local, pt]
    susp_pkd = pack(packed_inc(known), SEV_SUSPECT)
    probe_pkd = torch.where(ack, ack_pkd, susp_pkd)
    probe_new = probe_pkd > known
    view = _merge_scatter(view, local, pt, probe_pkd, has_probe)
    cand_tgt.append(pt[:, None])
    cand_pkd.append(probe_pkd[:, None])
    cand_tx.append(full((nl, 1), cfg.max_transmissions))
    cand_ok.append((has_probe & probe_new)[:, None])

    # New suspicion -> start a timer in a free/oldest slot.
    new_susp = has_probe & ~ack & probe_new
    slot_score = torch.where(state.susp_target < 0, -(2**30), state.susp_started)
    slot = torch.argmin(slot_score, dim=1)
    susp_target = state.susp_target.clone()
    susp_inc = state.susp_inc.clone()
    susp_started = state.susp_started.clone()
    susp_target[local, slot] = torch.where(new_susp, pt, susp_target[local, slot])
    susp_inc[local, slot] = torch.where(new_susp, packed_inc(known), susp_inc[local, slot])
    susp_started[local, slot] = torch.where(new_susp, round_idx, susp_started[local, slot])

    # ---- 2. suspect->down timer expiry -------------------------------------
    active = susp_target >= 0
    expired = active & (round_idx - susp_started >= cfg.suspect_rounds)
    exp_tgt = torch.clamp(susp_target, min=0)
    down_pkd = pack(susp_inc, SEV_DOWN)
    # Only fire while still believed below down at that incarnation.
    still = view[local[:, None], exp_tgt] < down_pkd
    fire = expired & still & alive_r[:, None]
    view = _merge_scatter(
        view, local[:, None].expand_as(exp_tgt), exp_tgt, down_pkd, fire
    )
    cand_tgt.append(exp_tgt)
    cand_pkd.append(down_pkd)
    cand_tx.append(full(exp_tgt.shape, cfg.max_transmissions))
    cand_ok.append(fire)
    susp_target = torch.where(expired, -1, susp_target)

    # ---- 3. gossip dissemination (bounded piggyback) -----------------------
    sendable = (state.upd_target >= 0) & (state.upd_tx > 0) & alive_r[:, None]
    g_tgts = rng_mod.randint(k_goss, (n, cfg.gossip_fanout), 0, n, rows=pos.box)
    shape = (nl, cfg.gossip_fanout, cfg.backlog)
    recv = g_tgts[:, :, None].expand(shape)
    tgt = state.upd_target[:, None, :].expand(shape)
    pkd = state.upd_packed[:, None, :].expand(shape)
    ok = sendable[:, None, :] & (recv != nodes[:, None, None]) & alive[recv]
    # The receivers' rows live at their owners: the pushed entries go to
    # them, each owner taking its rows' entries in sender order.
    dest, valid, (in_tgt, in_pkd) = yield exchange.Route(
        "swim", recv.reshape(-1), ok.reshape(-1),
        (torch.clamp(tgt, min=0).reshape(-1), pkd.reshape(-1)),
    )
    pre = view  # the receiver's view before this merge
    view = _merge_scatter(view, dest, in_tgt, in_pkd, valid)
    upd_tx = torch.where(sendable, state.upd_tx - 1, state.upd_tx)
    # Received entries that raised the receiver's belief re-enter its
    # backlog (bounded intake).
    changed = valid & (in_pkd > pre[dest, in_tgt])
    r_in = cfg.gossip_fanout * 2
    in_mask, (pool_tgt, pool_pkd) = routing.bounded_intake(
        dest, changed, (in_tgt, in_pkd), nl, r_in
    )
    cand_tgt.append(torch.where(in_mask, pool_tgt, -1))
    cand_pkd.append(pool_pkd)
    cand_tx.append(full((nl, r_in), cfg.max_transmissions))
    cand_ok.append(in_mask)

    # ---- 4. refutation -----------------------------------------------------
    self_belief = view[local, nodes]
    refute = alive_r & (packed_sev(self_belief) >= SEV_SUSPECT) & (
        packed_inc(self_belief) >= inc_self
    )
    new_inc = torch.where(refute, (packed_inc(self_belief) + 1) & 0xFFFFFFFF, inc_self)
    refute_pkd = pack(new_inc, SEV_ALIVE)
    view = _merge_scatter(view, local, nodes, refute_pkd, refute)
    cand_tgt.append(nodes[:, None])
    cand_pkd.append(refute_pkd[:, None])
    cand_tx.append(full((nl, 1), cfg.max_transmissions))
    cand_ok.append(refute[:, None])

    # ---- 5. rebuild backlog by priority ------------------------------------
    cand_tgt.append(state.upd_target)
    cand_pkd.append(state.upd_packed)
    cand_tx.append(upd_tx)
    cand_ok.append((state.upd_target >= 0) & (upd_tx > 0))
    ct = torch.cat(cand_tgt, dim=1)
    cp = torch.cat(cand_pkd, dim=1)
    cx = torch.cat(cand_tx, dim=1)
    co = torch.cat(cand_ok, dim=1)
    keep, (upd_target, upd_packed, upd_tx2) = routing.rebuild_bounded_queue(
        co, cx, (ct, cp, cx), cfg.backlog
    )
    upd_target = torch.where(keep, upd_target, -1)

    # ---- 6. down-member GC (stateless ageing) ------------------------------
    if cfg.down_gc_rounds > 0:
        k_gc = rng_mod.fold_in(k_goss, 7)
        drop = (packed_sev(view) == SEV_DOWN) & (
            rng_mod.uniform(k_gc, (n, n), rows=pos.box)
            < torch.tensor(1.0 / cfg.down_gc_rounds, dtype=torch.float32)
        )
        view = torch.where(drop, 0, view)

    return SwimState(
        view=view, incarnation=new_inc, alive=alive_r, susp_target=susp_target,
        susp_inc=susp_inc, susp_started=susp_started, upd_target=upd_target,
        upd_packed=upd_packed, upd_tx=upd_tx2,
    )


def _seed_pick(rng, alive, revive, pos):
    """A random alive, non-revived seed per node of the position (global
    ids) from 4 pre-drawn tries (the reference's ``lax.scan`` pick); self
    where none qualifies. ``alive``/``revive`` are the whole vectors."""
    n = alive.shape[0]
    nodes = pos.nodes(alive.device)
    cand = rng_mod.randint(rng, (4, n), 0, n, rows=pos.box, axis=1)
    seed = torch.full((pos.n_local,), -1, dtype=torch.int64, device=alive.device)
    for i in range(4):
        t = cand[i]
        seed = torch.where(alive[t] & ~revive[t] & (seed < 0), t, seed)
    return torch.where(seed < 0, nodes, seed)


def _queue_announce(state, revive, self_pkd, max_transmissions: int, nodes):
    """Queue each revived node's self-announce in its last backlog slot
    (``revive`` the rows' mask, ``nodes`` their global ids)."""
    out = []
    for field, v in (
        (state.upd_target, nodes), (state.upd_packed, self_pkd),
        (state.upd_tx, max_transmissions),
    ):
        field = field.clone()
        field[:, -1] = torch.where(revive, v, field[:, -1])
        out.append(field)
    return out


def apply_churn(state: SwimState, kill, revive, rng=None,
                max_transmissions: int = 6, wipe=None) -> SwimState:
    """Ground-truth churn between rounds (reference ``swim.apply_churn``):
    a revived node bumps its incarnation, repairs its self-belief, queues a
    self-announce and, when ``rng`` is given, bootstrap-pulls the view of
    one random alive peer. ``wipe`` marks kills as crash-with-state-wipe:
    the node forgets its beliefs, timers and queue but keeps its
    incarnation."""
    pos = exchange.whole(state.alive.shape[0])
    return exchange.solo(_apply_churn(state, kill, revive, rng, max_transmissions, wipe, pos))[0]


def _apply_churn(state: SwimState, kill, revive, rng, max_transmissions: int, wipe, pos):
    """``apply_churn`` over one position's rows (``kill``/``revive``/
    ``wipe`` the whole masks). Returns (state, the whole post-churn
    liveness vector: the round's control-vector gather)."""
    rows = slice(pos.row_start, pos.row_start + pos.n_local)
    kill_r, revive_r = kill[rows], revive[rows]
    if wipe is not None:
        w = wipe[rows][:, None]
        state = state._replace(
            view=torch.where(w, 0, state.view),
            susp_target=torch.where(w, -1, state.susp_target),
            upd_target=torch.where(w, -1, state.upd_target),
            upd_tx=torch.where(w, 0, state.upd_tx),
        )
    alive_r = (state.alive & ~kill_r) | revive_r
    inc = torch.where(revive_r, (state.incarnation + 1) & 0xFFFFFFFF, state.incarnation)
    nodes = pos.nodes(alive_r.device)
    local = torch.arange(pos.n_local, device=alive_r.device)
    self_pkd = pack(inc, SEV_ALIVE)
    view = _merge_scatter(state.view, local, nodes, self_pkd, revive_r)
    (alive,) = yield exchange.Gather("alive", (alive_r,))
    if rng is not None:
        seed = _seed_pick(rng, alive, revive, pos)
        (seed_view,) = yield exchange.Rows("churn", (view,), seed)
        view = torch.where(revive_r[:, None], torch.maximum(view, seed_view), view)
    upd_target, upd_packed, upd_tx = _queue_announce(
        state, revive_r, self_pkd, max_transmissions, nodes
    )
    return state._replace(
        alive=alive_r, incarnation=inc, view=view, upd_target=upd_target,
        upd_packed=upd_packed, upd_tx=upd_tx,
    ), alive


def _observers(alive_r: torch.Tensor, nodes: torch.Tensor, n: int) -> torch.Tensor:
    """(live observer, non-self target) pairs of the observer rows
    ``nodes`` (global ids) over all ``n`` targets."""
    cols = torch.arange(n, device=alive_r.device)
    return alive_r[:, None] & (cols[None, :] != nodes[:, None])


def mismatches(state: SwimState) -> torch.Tensor:
    """Exact count of (live observer, peer) beliefs that contradict truth."""
    return _mismatches(state, state.alive, exchange.whole(state.alive.shape[0]))


def _mismatches(state: SwimState, alive, pos) -> torch.Tensor:
    """The position's observers' share of ``mismatches`` (``alive`` the
    whole vector): the shares sum to the count."""
    believed_up = packed_sev(state.view) < SEV_DOWN
    obs = _observers(state.alive, pos.nodes(alive.device), alive.shape[0])
    return ((believed_up != alive[None, :]) & obs).sum()


def health_counts(state: SwimState) -> tuple[torch.Tensor, torch.Tensor]:
    """(false_alarms, undetected_deaths) over (live observer, non-self
    target) pairs: alive targets believed suspect or down, and dead
    targets still believed up."""
    return _health_counts(state, state.alive, exchange.whole(state.alive.shape[0]))


def _health_counts(state: SwimState, alive, pos) -> tuple[torch.Tensor, torch.Tensor]:
    """The position's observers' shares of ``health_counts``."""
    sev = packed_sev(state.view)
    obs = _observers(state.alive, pos.nodes(alive.device), alive.shape[0])
    alive_t = alive[None, :]
    false_alarms = (obs & alive_t & (sev >= SEV_SUSPECT)).sum()
    undetected = (obs & ~alive_t & (sev < SEV_DOWN)).sum()
    return false_alarms, undetected


def accuracy(state: SwimState) -> torch.Tensor:
    """Approximate fraction of correct beliefs (float32; ``mismatches`` is
    the exact convergence check). Torch divides IEEE-exactly where the
    reference's XLA division is reciprocal-based, so the two agree to
    float32 rounding, not bit for bit."""
    n = state.alive.shape[0]
    nodes = torch.arange(n, device=state.alive.device)
    total = torch.clamp(_observers(state.alive, nodes, n).sum(), min=1)
    return 1.0 - mismatches(state).to(torch.float32) / total.to(torch.float32)

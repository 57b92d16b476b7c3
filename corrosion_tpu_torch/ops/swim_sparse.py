"""Scalable SWIM membership over bounded exception tables, in PyTorch.

Counterpart of corrosion_tpu/ops/swim_sparse.py (its module docstring
describes the model): each node stores up to K (target, packed belief)
exceptions above the all-alive@inc0 baseline; probes, suspect->down
timers, bounded piggyback dissemination and refutation run as batched
table merges (``_merge_scan``); ``apply_churn`` applies kills, revivals
and wipes between rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corrosion_tpu_torch import resolve_device
from corrosion_tpu_torch import rng as rng_mod
from corrosion_tpu_torch.ops import faulting, routing
from corrosion_tpu_torch.ops.swim import (
    SEV_ALIVE,
    SEV_DOWN,
    SEV_SUSPECT,
    SwimConfig,
    _queue_announce,
    _seed_pick,
    pack,
    packed_inc,
    packed_sev,
)

_NEG_INF = -(2**31) + 1


class SparseSwimState(NamedTuple):
    exc_tgt: torch.Tensor  # [N, K] exception target (-1 = empty slot)
    exc_pkd: torch.Tensor  # [N, K] packed belief (> baseline 0)
    incarnation: torch.Tensor  # [N] own incarnation
    alive: torch.Tensor  # bool[N] ground-truth process liveness
    susp_target: torch.Tensor  # [N, S] (-1 = empty)
    susp_inc: torch.Tensor  # [N, S]
    susp_started: torch.Tensor  # [N, S]
    upd_target: torch.Tensor  # [N, U] (-1 = empty)
    upd_packed: torch.Tensor  # [N, U]
    upd_tx: torch.Tensor  # [N, U] transmissions left


def init_state(cfg: SwimConfig, device=None) -> SparseSwimState:
    device = resolve_device(device)
    n, s, u, k = cfg.n_nodes, cfg.timers, cfg.backlog, cfg.view_capacity
    if k <= 0:
        raise ValueError("sparse kernel needs SwimConfig.view_capacity > 0")

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=device)

    return SparseSwimState(
        exc_tgt=full((n, k), -1),
        exc_pkd=full((n, k), 0),
        incarnation=full((n,), 0),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        susp_target=full((n, s), -1),
        susp_inc=full((n, s), 0),
        susp_started=full((n, s), 0),
        upd_target=full((n, u), -1),
        upd_packed=full((n, u), 0),
        upd_tx=full((n, u), 0),
    )


def _lookup(exc_tgt, exc_pkd, tgt):
    """Belief each row holds about its (per-row) target; baseline 0."""
    return torch.where(exc_tgt == tgt[:, None], exc_pkd, 0).amax(dim=1)


def _evict_score(pkd):
    """Keep-priority: severity first, then incarnation."""
    inc = torch.clamp(packed_inc(pkd), max=2**27 - 1)
    return (packed_sev(pkd) << 27) | inc


def _merge_one(exc_tgt, exc_pkd, tgt, pkd, valid):
    """Merge one (target, belief) per row. Returns (tgt, pkd, raised)."""
    n, k = exc_tgt.shape
    old = _lookup(exc_tgt, exc_pkd, tgt)
    raised = valid & (pkd > old)
    hit = (exc_tgt == tgt[:, None]) & raised[:, None]
    any_hit = hit.any(dim=1)
    exc_pkd = torch.where(hit, torch.maximum(exc_pkd, pkd[:, None]), exc_pkd)
    ins = raised & ~any_hit & (pkd > 0)
    score = torch.where(exc_tgt < 0, -1, _evict_score(exc_pkd))
    slot = torch.argmin(score, dim=1)
    slot_score = score.amin(dim=1)
    ok = ins & (slot_score < _evict_score(pkd))
    sl = (torch.arange(k, device=exc_tgt.device)[None, :] == slot[:, None]) & ok[:, None]
    exc_tgt = torch.where(sl, tgt[:, None], exc_tgt)
    exc_pkd = torch.where(sl, pkd[:, None], exc_pkd)
    raised = raised & (any_hit | ~ins | ok)
    return exc_tgt, exc_pkd, raised


def _merge_scan(exc_tgt, exc_pkd, tgts, pkds, valids):
    """Merge C per-row entries in one batched pass (duplicates collapse
    to their max; inserts pair strongest-first with weakest slots).
    Returns (tgt, pkd, raised[N, C])."""
    n, k = exc_tgt.shape
    c = tgts.shape[1]
    dev = exc_tgt.device
    valid = valids & (pkds > 0)
    cc = torch.arange(c, device=dev)
    kk = torch.arange(k, device=dev)

    # 1. Collapse duplicate targets to the max-(pkd, lowest index) entry.
    same = tgts[:, :, None] == tgts[:, None, :]
    pj = pkds[:, None, :]
    pi = pkds[:, :, None]
    dom = (
        same
        & valid[:, None, :]
        & ((pj > pi) | ((pj == pi) & (cc[None, None, :] < cc[None, :, None])))
    )
    winner = valid & ~dom.any(dim=2)

    # 2. Old belief + hit detection against the table. [N, C, K]
    hitck = exc_tgt[:, None, :] == tgts[:, :, None]
    old = torch.where(hitck, exc_pkd[:, None, :], 0).amax(dim=2)
    raised = winner & (pkds > old)
    any_hit = hitck.any(dim=2)

    # 3. Existing slots rise to the max raising entry targeting them.
    upd = torch.where(hitck & raised[:, :, None], pkds[:, :, None], 0).amax(dim=1)
    exc_pkd = torch.maximum(exc_pkd, upd)

    # 4. Inserts: strongest candidates pair with weakest slots.
    ins = raised & ~any_hit
    score_slot = torch.where(exc_tgt < 0, -1, _evict_score(exc_pkd))
    score_ins = torch.where(ins, _evict_score(pkds), _NEG_INF)
    ss_i = score_slot[:, :, None]
    ss_j = score_slot[:, None, :]
    slot_rank = (
        (ss_j < ss_i) | ((ss_j == ss_i) & (kk[None, None, :] < kk[None, :, None]))
    ).sum(dim=2)
    si_i = score_ins[:, :, None]
    si_j = score_ins[:, None, :]
    ins_rank = (
        (si_j > si_i) | ((si_j == si_i) & (cc[None, None, :] < cc[None, :, None]))
    ).sum(dim=2)
    pair = (ins_rank[:, :, None] == slot_rank[:, None, :]) & ins[:, :, None]
    paired_slot_score = torch.where(pair, score_slot[:, None, :], _NEG_INF).amax(dim=2)
    land = ins & pair.any(dim=2) & (score_ins > paired_slot_score)
    put = pair & land[:, :, None]
    landed = put.any(dim=1)
    exc_tgt = torch.where(
        landed, torch.where(put, tgts[:, :, None], -1).amax(dim=1), exc_tgt
    )
    exc_pkd = torch.where(
        landed, torch.where(put, pkds[:, :, None], 0).amax(dim=1), exc_pkd
    )
    return exc_tgt, exc_pkd, raised & (any_hit | land)


def swim_round(state: SparseSwimState, rng, round_idx, cfg: SwimConfig, probe_loss=None):
    """One bulk-synchronous SWIM protocol period for all N nodes."""
    n = cfg.n_nodes
    dev = state.exc_tgt.device
    nodes = torch.arange(n, device=dev)
    keys = rng_mod.split(rng, 3)
    k_probe, k_loss, k_goss = keys[0], keys[1], keys[2]
    exc_tgt, exc_pkd = state.exc_tgt, state.exc_pkd
    alive = state.alive
    inc_self = state.incarnation
    cand_tgt, cand_pkd, cand_tx, cand_ok = [], [], [], []

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=dev)

    # ---- 1. probe ----------------------------------------------------------
    tries = rng_mod.randint(k_probe, (cfg.probe_tries, n), 0, n)
    probe_tgt = full((n,), -1)
    for i in range(cfg.probe_tries):
        t = tries[i]
        sev_t = packed_sev(_lookup(exc_tgt, exc_pkd, t))
        ok = (t != nodes) & (sev_t < SEV_DOWN) & (probe_tgt < 0)
        probe_tgt = torch.where(ok, t, probe_tgt)
    has_probe = (probe_tgt >= 0) & alive
    pt = torch.clamp(probe_tgt, min=0)
    ack, _ = faulting.apply_loss(k_loss, has_probe & alive[pt], cfg.loss_prob, probe_loss)
    ack_pkd = pack(inc_self[pt], SEV_ALIVE)
    known = _lookup(exc_tgt, exc_pkd, pt)
    susp_pkd = pack(packed_inc(known), SEV_SUSPECT)
    probe_pkd = torch.where(ack, ack_pkd, susp_pkd)
    exc_tgt, exc_pkd, probe_new = _merge_one(exc_tgt, exc_pkd, pt, probe_pkd, has_probe)
    cand_tgt.append(pt[:, None])
    cand_pkd.append(probe_pkd[:, None])
    cand_tx.append(full((n, 1), cfg.max_transmissions))
    cand_ok.append(probe_new[:, None])

    # New suspicion -> start a timer in a free/oldest slot.
    new_susp = has_probe & ~ack & probe_new
    slot_score = torch.where(state.susp_target < 0, -(2**30), state.susp_started)
    slot = torch.argmin(slot_score, dim=1)
    susp_target = state.susp_target.clone()
    susp_inc = state.susp_inc.clone()
    susp_started = state.susp_started.clone()
    susp_target[nodes, slot] = torch.where(new_susp, pt, susp_target[nodes, slot])
    susp_inc[nodes, slot] = torch.where(new_susp, packed_inc(known), susp_inc[nodes, slot])
    susp_started[nodes, slot] = torch.where(new_susp, round_idx, susp_started[nodes, slot])

    # ---- 2. suspect->down timer expiry -------------------------------------
    active = susp_target >= 0
    expired = active & (round_idx - susp_started >= cfg.suspect_rounds)
    exp_tgt = torch.clamp(susp_target, min=0)
    down_pkd = pack(susp_inc, SEV_DOWN)
    fire = expired & alive[:, None]
    exc_tgt, exc_pkd, fired = _merge_scan(exc_tgt, exc_pkd, exp_tgt, down_pkd, fire)
    cand_tgt.append(exp_tgt)
    cand_pkd.append(down_pkd)
    cand_tx.append(full(exp_tgt.shape, cfg.max_transmissions))
    cand_ok.append(fired)
    susp_target = torch.where(expired, -1, susp_target)

    # ---- 3. gossip dissemination (bounded piggyback, pull model) -----------
    sendable = (state.upd_target >= 0) & (state.upd_tx > 0) & alive[:, None]
    src = rng_mod.randint(k_goss, (n, cfg.gossip_fanout), 0, n)
    m_tgt = state.upd_target[src].reshape(n, -1)
    m_pkd = state.upd_packed[src].reshape(n, -1)
    m_tx = state.upd_tx[src].reshape(n, -1)
    src_ok = alive[src] & (src != nodes[:, None])
    m_ok = (
        (m_tgt >= 0)
        & (m_tx > 0)
        & src_ok[:, :, None].expand(n, cfg.gossip_fanout, cfg.backlog).reshape(n, -1)
        & alive[:, None]
    )
    upd_tx = torch.where(sendable, state.upd_tx - 1, state.upd_tx)
    r_view = cfg.view_intake if cfg.view_intake > 0 else cfg.gossip_fanout * cfg.backlog
    in_mask, (in_tgt, in_pkd) = routing.rebuild_bounded_queue(
        m_ok & (m_tgt >= 0), _evict_score(m_pkd), (m_tgt, m_pkd), r_view
    )
    in_tgt = torch.clamp(in_tgt, min=0)
    exc_tgt, exc_pkd, raised = _merge_scan(exc_tgt, exc_pkd, in_tgt, in_pkd, in_mask)
    r_bk = cfg.gossip_fanout * 2
    keep, (bk_tgt, bk_pkd) = routing.rebuild_bounded_queue(
        raised, torch.ones_like(in_tgt), (in_tgt, in_pkd), r_bk
    )
    cand_tgt.append(torch.where(keep, bk_tgt, -1))
    cand_pkd.append(bk_pkd)
    cand_tx.append(full((n, keep.shape[1]), cfg.max_transmissions))
    cand_ok.append(keep)

    # ---- 4. refutation -----------------------------------------------------
    self_belief = _lookup(exc_tgt, exc_pkd, nodes)
    refute = alive & (packed_sev(self_belief) >= SEV_SUSPECT) & (
        packed_inc(self_belief) >= inc_self
    )
    new_inc = torch.where(refute, packed_inc(self_belief) + 1, inc_self)
    refute_pkd = pack(new_inc, SEV_ALIVE)
    exc_tgt, exc_pkd, _ = _merge_one(exc_tgt, exc_pkd, nodes, refute_pkd, refute)
    cand_tgt.append(nodes[:, None])
    cand_pkd.append(refute_pkd[:, None])
    cand_tx.append(full((n, 1), cfg.max_transmissions))
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
        drop = (packed_sev(exc_pkd) == SEV_DOWN) & (
            rng_mod.uniform(k_gc, tuple(exc_pkd.shape))
            < torch.tensor(1.0 / cfg.down_gc_rounds, dtype=torch.float32)
        )
        exc_tgt = torch.where(drop, -1, exc_tgt)
        exc_pkd = torch.where(drop, 0, exc_pkd)

    return SparseSwimState(
        exc_tgt=exc_tgt, exc_pkd=exc_pkd, incarnation=new_inc, alive=alive,
        susp_target=susp_target, susp_inc=susp_inc, susp_started=susp_started,
        upd_target=upd_target, upd_packed=upd_packed, upd_tx=upd_tx2,
    )


def apply_churn(state: SparseSwimState, kill, revive, rng=None,
                max_transmissions: int = 6, wipe=None) -> SparseSwimState:
    """Ground-truth churn between rounds (reference
    ``swim_sparse.apply_churn``), mirroring the dense kernel: a revived
    node bumps its incarnation, repairs its self-belief, queues a
    self-announce and, when ``rng`` is given, bootstrap-pulls one random
    alive peer's exception table. ``wipe`` resets the wiped nodes'
    tables, timers and queues; incarnations are kept."""
    if wipe is not None:
        w = wipe[:, None]
        state = state._replace(
            exc_tgt=torch.where(w, -1, state.exc_tgt),
            exc_pkd=torch.where(w, 0, state.exc_pkd),
            susp_target=torch.where(w, -1, state.susp_target),
            upd_target=torch.where(w, -1, state.upd_target),
            upd_tx=torch.where(w, 0, state.upd_tx),
        )
    alive = (state.alive & ~kill) | revive
    inc = torch.where(revive, (state.incarnation + 1) & 0xFFFFFFFF, state.incarnation)
    nodes = torch.arange(alive.shape[0], device=alive.device)
    self_pkd = pack(inc, SEV_ALIVE)
    exc_tgt, exc_pkd, _ = _merge_one(state.exc_tgt, state.exc_pkd, nodes, self_pkd, revive)
    if rng is not None:
        seed = _seed_pick(rng, alive, revive)
        pull_ok = revive & (seed != nodes)
        exc_tgt, exc_pkd, _ = _merge_scan(
            exc_tgt, exc_pkd, exc_tgt[seed], exc_pkd[seed],
            pull_ok[:, None] & (exc_tgt[seed] >= 0),
        )
    upd_target, upd_packed, upd_tx = _queue_announce(
        state, revive, self_pkd, max_transmissions
    )
    return state._replace(
        alive=alive, incarnation=inc, exc_tgt=exc_tgt, exc_pkd=exc_pkd,
        upd_target=upd_target, upd_packed=upd_packed, upd_tx=upd_tx,
    )


def mismatches(state: SparseSwimState) -> torch.Tensor:
    """Exact count of (live observer, peer) beliefs contradicting truth."""
    n = state.exc_tgt.shape[0]
    alive = state.alive
    alive_count = alive.sum()
    dead_count = n - alive_count
    ent_valid = (
        (state.exc_tgt >= 0)
        & alive[:, None]
        & (state.exc_tgt != torch.arange(n, device=alive.device)[:, None])
    )
    truth = alive[torch.clamp(state.exc_tgt, min=0)]
    believed_up = packed_sev(state.exc_pkd) < SEV_DOWN
    ent_mis = (ent_valid & (believed_up != truth)).sum()
    ent_default_mis = (ent_valid & ~truth).sum()
    return alive_count * dead_count + ent_mis - ent_default_mis


def health_counts(state: SparseSwimState) -> tuple[torch.Tensor, torch.Tensor]:
    """(false_alarms, undetected_deaths) without materializing N x N."""
    n = state.exc_tgt.shape[0]
    alive = state.alive
    alive_count = alive.sum()
    dead_count = n - alive_count
    ent_valid = (
        (state.exc_tgt >= 0)
        & alive[:, None]
        & (state.exc_tgt != torch.arange(n, device=alive.device)[:, None])
    )
    sev = packed_sev(state.exc_pkd)
    truth = alive[torch.clamp(state.exc_tgt, min=0)]
    false_alarms = (ent_valid & truth & (sev >= SEV_SUSPECT)).sum()
    detected = (ent_valid & ~truth & (sev == SEV_DOWN)).sum()
    return false_alarms, (alive_count * dead_count - detected) & 0xFFFFFFFF

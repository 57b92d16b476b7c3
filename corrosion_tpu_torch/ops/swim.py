"""SWIM membership: the packed-belief helpers, the config and the kernel
dispatch of corrosion_tpu/ops/swim.py.

A belief packs into one u32 as ``inc << 2 | severity`` (0 alive,
1 suspect, 2 down), so SWIM's merge rule is ``max``. The dense
u32[N, N]-view kernel comes with a later slice; configs with
``view_capacity > 0`` run the sparse exception-table kernel
(``swim_sparse``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

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
    ``view_capacity > 0``; the dense view is not ported yet."""
    if cfg.view_capacity > 0:
        from corrosion_tpu_torch.ops import swim_sparse

        return swim_sparse
    raise NotImplementedError(
        "the dense SWIM view (view_capacity=0) is not ported to "
        "corrosion_tpu_torch yet"
    )

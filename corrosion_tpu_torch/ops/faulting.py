"""Loss injection shared by the kernel planes (counterpart of
corrosion_tpu/ops/faulting.py ``apply_loss``; ``wipe_nodes`` comes with
the churn slice).

Receiver-side independent drop; a static config probability and a
dynamic per-round one compose as independent processes
(``p = a + b - a*b``). With no loss configured the mask passes through and
no random numbers are drawn — the reference's static zero-cost skip.
"""

from __future__ import annotations

import torch

from corrosion_tpu_torch import rng as rng_mod


def apply_loss(key, ok, static_prob: float, dyn_prob=None):
    """Drop each deliverable message with the combined loss probability.
    Returns ``(ok', lost_count)``."""
    if static_prob <= 0.0 and dyn_prob is None:
        return ok, torch.zeros((), dtype=torch.int64, device=ok.device)
    u = rng_mod.uniform(key, tuple(ok.shape))
    p = torch.tensor(static_prob, dtype=torch.float32, device=ok.device)
    if dyn_prob is not None:
        d = dyn_prob.to(torch.float32)
        p = p + d - p * d
    lost = ok & (u < p)
    return ok & ~lost, lost.sum()

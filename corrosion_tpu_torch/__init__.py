"""PyTorch/CUDA port of the corrosion-tpu cluster simulator.

A second package beside ``corrosion_tpu`` (the JAX reference, which it
never imports). The layout mirrors the reference module for module —
``ops/{onehot,routing,crdt,faulting,gossip,swim,swim_sparse}.py``,
``sim/{telemetry,engine}.py``, ``models/baselines.py`` — so each piece
has an obvious counterpart to be checked against.

Conventions:

- Every JAX ``uint32`` is carried as ``torch.int64`` holding the u32
  value (this torch build has no max/add/compare/shift/gather on
  ``torch.uint32``); code masks with ``& 0xFFFFFFFF`` wherever the
  reference relies on 32-bit wraparound. JAX ``int32`` is ``int64`` too.
- Random draws go through ``rng`` — a bit-exact port of JAX's
  partitionable threefry2x32 — with keys passed exactly where the
  reference passes them, so a run reproduces the reference bit for bit.
- The reference's seven Pallas kernels are hand-written CUDA kernels
  (``csrc/``), launched for CUDA tensors through PyTorch operators
  (``torch.ops.corro.*``, ``csrc/ops.cpp``); their plain PyTorch versions
  run for CPU tensors.
- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
  and raise when no device is given and CUDA is absent.
"""

from __future__ import annotations


def resolve_device(device=None):
    """The device an entry point runs on (a ``torch.device``): ``device``
    when given, else CUDA. Raises when neither is available — never a
    silent CPU run. torch is imported here, not at package import, so the
    host-only command line (``lint``, the flight reports) starts without
    it."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")

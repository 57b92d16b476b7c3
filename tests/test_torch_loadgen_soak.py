"""``loadgen soak`` (``scenarios.intake_policy``) in both packages at small
size on the CPU: the reference's runs through JAX, the port's through its
plain PyTorch versions, on the fast delivery path and on the legacy one
(forced with ``_FAST_MAX_WRITERS = 0`` in both packages and
``_BLOCK_ENUM_MIN_WRITERS = 1`` in the reference, JAX's caches cleared
around it). The dicts are equal key for key, ``process`` aside (it reads
``/proc`` and the wall clock); so is what ``sim/host_oracles.loadgen_soak``
(the card's check in ``chip_smoke.py``) returns, and it refuses a report
that differs.

Each path compiles the reference's engine, so these cases have a file of
their own.
"""

import jax
import pytest

from corrosion_tpu.loadgen import scenarios as jscenarios
from corrosion_tpu.ops import gossip as jg
from corrosion_tpu_torch.loadgen import scenarios as tscenarios
from corrosion_tpu_torch.ops import gossip as tg
from corrosion_tpu_torch.sim import host_oracles as H

SMALL = dict(nodes=32, rounds=24)


@pytest.fixture(params=["fast", "legacy"])
def path(request):
    saved = (jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS)
    if request.param == "legacy":
        jax.clear_caches()
        jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = 0, 1, 0
    try:
        yield request.param
    finally:
        if request.param == "legacy":
            jg._FAST_MAX_WRITERS, jg._BLOCK_ENUM_MIN_WRITERS, tg._FAST_MAX_WRITERS = saved
            jax.clear_caches()


def test_intake_policy_equals_the_reference(path):
    want = jscenarios.intake_policy(**SMALL)
    got = tscenarios.intake_policy(device="cpu", **SMALL)
    assert want.pop("process")["samples"] == got.pop("process")["samples"] == 3
    assert got == want
    assert got["kernel_nodes"] == 32 and got["rounds"] == 24
    assert got["starved"]["intake"] == 1
    assert got["sized"]["intake"] == round(got["write_rate_per_round"]) + 8
    # The card's oracle, run here on the CPU and held to the reference's
    # dict; each run's watermark invariants hold.
    rep, runs = H.loadgen_soak("cpu", cpu_report=dict(want, process={}), **SMALL)
    assert rep == want
    assert [(r["intake"], r["rounds"], r["nodes"]) for r in runs] == [
        (want["sized"]["intake"], 24, 32), (1, 24, 32)]
    doctored = dict(want, divergence_ratio=want["divergence_ratio"] + 1)
    with pytest.raises(AssertionError, match="divergence_ratio"):
        H.loadgen_soak("cpu", cpu_report=doctored, **SMALL)


def test_intake_policy_needs_a_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscenarios.intake_policy(**SMALL)

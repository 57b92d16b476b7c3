"""Runtime sanitizer: dtype promotion, NaNs and a rebuild tripwire
(counterpart of corrosion_tpu/analysis/sanitize.py).

The static lints can't see a promotion that happens inside an operation
or a rebuild triggered at run time. This module runs a *tiny* instance
of each engine twice, same shape, under a ``TorchDispatchMode`` that
sees every aten operation of the round:

- **CT031, promotion**: an operation whose tensor operands of ``dim >=
  1`` have different dtypes raises :class:`TypePromotionError` (the name
  the reference matches on). The port carries every u32 plane as int64;
  an int64 x float32 or int64 x int32 operation widens or converts a
  whole plane silently. 0-d tensors are exempt, like the reference's
  weak-typed scalars. Exemptions the port needs, by operand role:

  * ``condition`` (``where``), ``mask`` (``masked_fill``,
    ``masked_scatter``) and ``index``/``indices`` (``gather``,
    ``scatter*``, ``index_select``, ``index``, ``index_put``, ``take``,
    ``index_add``): a bool mask or an int64 index selects, it is not a
    value that promotes;
  * conversions (``_to_copy``, ``copy_``, ``to``): an explicit cast is
    the fix, not the hazard;
  * the kernel library's operators (``torch.ops.corro.*``): they check
    their dtypes themselves (a TypeError in ``csrc/ops.cpp``).
- **CT032, NaNs**: the first floating operation whose output holds a NaN
  raises ``FloatingPointError`` naming the operation (the analogue of
  ``jax.debug_nans``).
- **CT030, rebuild tripwire**: the port compiles nothing per shape; its
  analogue of a silent recompile is a rebuild or reload of the kernel
  library. A ``CompileLedger`` watches both runs in their own windows;
  the second run must show 0 builds and 0 loads, and
  ``obs.ledger.cache_sizes(obs.ledger.jitted_functions(module), ledger)``
  must report each watched entry compiled at most once — and must watch
  something: on the CPU no library is loaded, so the tripwire is blind
  there and says so.
- **CT033**: anything else that fails the tiny run.

``_RUNNERS`` holds zero-argument runners; :func:`sanitize_engines` binds
them to the resolved device (CUDA unless given; raises without it).
Imports torch and the engines lazily: `corrosion lint` without
``--sanitize`` never pays for them.
"""

from __future__ import annotations

import time

from corrosion_tpu_torch.analysis.findings import Finding

ENGINES = ("dense", "sparse", "chunk", "mixed")

# The device the runners build and run on, bound by sanitize_engines.
_DEVICE = None
# Per-engine record of the last sanitize_engines call: each run's
# seconds, builds and loads of the kernel library.
LAST_RUN: dict[str, dict] = {}


def _run_dense():
    from corrosion_tpu_torch.models import baselines as models
    from corrosion_tpu_torch.sim import engine

    cfg, topo, sched = models.merge_10k(n=32, rounds=8, samples=8, device=_DEVICE)
    engine.simulate(cfg, topo, sched, seed=0, max_chunk=4, device=_DEVICE)
    return engine


def _run_sparse():
    from corrosion_tpu_torch.models import baselines as models
    from corrosion_tpu_torch.sim import sparse_engine

    cfg, topo, sched = models.anywrite_sparse(
        n=96, w_hot=16, n_regions=4, rounds=16, cohort=8, epoch_rounds=8,
        k_dev=8, samples=16, device=_DEVICE,
    )
    sparse_engine.simulate_sparse(cfg, topo, sched, seed=0, device=_DEVICE)
    return sparse_engine


def _run_chunk():
    from corrosion_tpu_torch.ops.chunks import ChunkConfig
    from corrosion_tpu_torch.sim import chunk_engine

    cfg = ChunkConfig(
        n_nodes=16, n_streams=2, chunk_len=64, fanout=3, sync_interval=4,
        gap_requests=4,
    )
    chunk_engine.simulate_chunks(
        cfg, [0, 5], [511, 255], rounds=8, seed=1, max_chunk=4, device=_DEVICE
    )
    return chunk_engine


def _run_mixed():
    from corrosion_tpu_torch.models.baselines import mixed_storm
    from corrosion_tpu_torch.sim import mixed_engine

    cfg, ccfg, topo, sched, spec = mixed_storm(
        n=64, streams=2, last_seq=255, rounds=8, samples=8, n_cells=0,
        device=_DEVICE,
    )
    mixed_engine.simulate_mixed(cfg, ccfg, topo, sched, spec, seed=0, device=_DEVICE)
    return mixed_engine


_RUNNERS = {
    "dense": _run_dense,
    "sparse": _run_sparse,
    "chunk": _run_chunk,
    "mixed": _run_mixed,
}


class TypePromotionError(Exception):
    """An operation mixed the dtypes of its tensor operands. Not a
    ``TypeError``: torch's binary operators turn a ``TypeError`` into
    ``NotImplemented``, and Python would report its own instead."""


# Schema argument names that select rather than promote.
_SELECTOR_ARGS = {"condition", "mask", "index", "indices"}
# Explicit conversions.
_CONVERSIONS = {"_to_copy", "copy_", "copy", "to", "_copy_from"}


def _sanitize_mode(strict_dtypes: bool, check_nans: bool):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def tensors(value):
        if isinstance(value, torch.Tensor):
            yield value
        elif isinstance(value, (list, tuple)):
            for v in value:
                yield from tensors(v)

    class SanitizeMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if strict_dtypes and func.namespace == "aten" and name not in _CONVERSIONS:
                dtypes = {}
                for arg, value in zip(func._schema.arguments, args):
                    if arg.name not in _SELECTOR_ARGS:
                        for t in tensors(value):
                            if t.dim() >= 1:
                                dtypes.setdefault(t.dtype, arg.name)
                for key, value in kwargs.items():
                    if key not in _SELECTOR_ARGS:
                        for t in tensors(value):
                            if t.dim() >= 1:
                                dtypes.setdefault(t.dtype, key)
                if len(dtypes) > 1:
                    mixed = ", ".join(f"{a}: {d}" for d, a in dtypes.items())
                    raise TypePromotionError(
                        f"{func} mixes operand dtypes ({mixed}) — implicit promotion"
                    )
            out = func(*args, **kwargs)
            if check_nans:
                for t in tensors(out):
                    if t.is_floating_point() and bool(torch.isnan(t).any()):
                        raise FloatingPointError(f"NaN produced by {func}")
            return out

    return SanitizeMode()


def sanitize_engines(
    engines: tuple[str, ...] = ENGINES, strict_dtypes: bool = True,
    check_nans: bool = True, device=None,
) -> list[Finding]:
    """Run the tiny-instance sanitizer for ``engines`` on ``device`` (CUDA
    unless given; raises without it); returns findings
    (CT030/CT031/CT032/CT033), empty when every engine is clean."""
    global _DEVICE

    import contextlib

    from corrosion_tpu_torch import resolve_device
    # The ONE registry of watched entries, shared with the runtime
    # compile ledger (obs/ledger.py) — the offline tripwire and the live
    # one can never watch different sets.
    from corrosion_tpu_torch.obs.ledger import (
        CompileLedger,
        cache_sizes,
        jitted_functions,
    )

    dev = resolve_device(device)
    findings: list[Finding] = []
    LAST_RUN.clear()
    for name in engines:
        run = _RUNNERS[name]
        led = CompileLedger()
        record = LAST_RUN[name] = {"seconds": [], "builds": [], "loads": []}
        try:
            _DEVICE = dev
            with led:
                for i in range(2):  # two same-shape runs
                    ctx = contextlib.ExitStack()
                    if strict_dtypes or check_nans:
                        ctx.enter_context(_sanitize_mode(strict_dtypes, check_nans))
                    t0 = time.perf_counter()
                    with led.window(f"{name}:run{i}") as win, ctx:
                        module = run()
                    record["seconds"].append(time.perf_counter() - t0)
                    record["builds"].append(win.kinds.get("build", 0))
                    record["loads"].append(win.kinds.get("load", 0))
        except FloatingPointError as e:
            findings.append(Finding(
                rule="CT032", path=f"<engine:{name}>", line=0,
                message=f"NaN produced in the {name} round graph: {e}",
            ))
            continue
        except Exception as e:
            # Matched by name, as in the reference. Anything else is a
            # broken tiny-config run, not a promotion finding — label it
            # honestly (CT033) so triage doesn't chase phantom dtypes.
            rule = (
                "CT031" if type(e).__name__ == "TypePromotionError"
                else "CT033"
            )
            findings.append(Finding(
                rule=rule, path=f"<engine:{name}>", line=0,
                message=f"{name} engine failed under the sanitizer "
                f"({type(e).__name__}): {e}",
            ))
            continue
        finally:
            _DEVICE = None
        sizes = cache_sizes(jitted_functions(module), led)
        if not any(sizes.values()):
            # A refactor that renames the entry points (or a device with
            # no kernel library) would turn the tripwire into a no-op;
            # that must be loud, not green.
            findings.append(Finding(
                rule="CT030", path=f"<engine:{name}>", line=0,
                message=f"{module.__name__} exposes no compiled entry points "
                f"after the run on {dev} — the retrace tripwire is watching "
                "nothing",
            ))
        for fn_name, size in sizes.items():
            if size > 1:
                findings.append(Finding(
                    rule="CT030", path=f"<engine:{name}>", line=0,
                    message=f"{module.__name__}.{fn_name} compiled "
                    f"{size} times across same-shape runs — the kernel "
                    "library was built or loaded again (retrace tripwire)",
                ))
    return findings

"""Device-cost observability: the counted cost model, memory watermarks,
roofline stage costs and the state-capacity curve (counterpart of
corrosion_tpu/obs/costs.py).

The reference reads XLA's ``cost_analysis()`` and ``memory_analysis()`` of
a lowered step. The port lowers nothing, so it counts while one round
actually runs:

- **Cost model** (``corro-cost-model/1``): each engine's run at the
  reference's tiny configs goes once under :class:`CostCounter`, a
  ``TorchDispatchMode``. ``bytes_accessed`` sums each op's input and output
  bytes (views count 0; a move between devices that converts no dtype and
  a read of a scalar to the host count 0: the same call on the CPU
  dispatches nothing); ``flops`` counts one
  per output element, and a reduction or sort its input elements. Each
  kernel-bearing function of ``ops.onehot`` counts as ONE op at the byte
  and operation formulas of ``chip_smoke.py``'s bound, whichever
  implementation runs (its plain composition on the CPU is not counted),
  so an entry is the same on the CPU and on the card. ``peak_bytes`` is
  the counter's high-water mark of live storage (the arguments
  included), ``temp_bytes`` that of the storage the run allocated; on the
  card ``allocator_peak_bytes`` gives the allocator's view
  (``torch.cuda.max_memory_allocated``). The port donates no buffer, so
  there is one variant, ``plain``. Device counts are positions of the
  port's mesh: an entry at D > 1 counts the whole mesh's work, every
  position's body and the controller's planes, which run in one process.
- **Roofline stage costs**: the same cumulative-prefix composite the
  timing attribution uses (``benchlib.plane_composite``), one counted step
  a prefix; a stage's flops and bytes are the increment.
- **Memory watermarks** (:class:`MemoryWatermarks`): live bytes per device
  sampled at chunk and epoch boundaries (``KernelTelemetry``), reconciled
  against the placement at rest (:func:`reconcile_memory`).
- **Capacity curve** (``corro-capacity/1``): nodes -> predicted state bytes
  a position for the flagship sharded config, from the state's shapes on
  the ``meta`` device and the one placement-spec source the shard helpers
  use, validated against a live 512-node placement (to the byte) and a
  measured 100,352-node placement, against the memory of the card the
  model is made for.
"""

from __future__ import annotations

import functools
import json
import math
import time
import weakref
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

COST_SCHEMA = "corro-cost-model/1"
CAPACITY_SCHEMA = "corro-capacity/1"

ENGINES = ("dense", "sparse", "chunk", "mixed")
VARIANTS = ("plain",)
#: Device counts the model covers: the unsharded anchor and the 8-position
#: mesh.
DEVICE_COUNTS = (1, 8)

#: Fraction of the memory the capacity verdict leaves for the round's
#: working set.
CAPACITY_HEADROOM = 0.5

#: The kernel-bearing functions of ``ops.onehot``, each counted as one op.
KERNEL_FUNCTIONS = (
    "rowmax", "rowsum", "rowgather", "rowgather_wide", "table_gather", "delivery_reduce",
    "window_delivery",
)

# Reductions and sorts: their operations are their input's elements.
_REDUCTIONS = frozenset({
    "sum", "prod", "mean", "amax", "amin", "max", "min", "aminmax", "any", "all", "argmax",
    "argmin", "sort", "argsort", "topk", "count_nonzero", "nonzero", "_unique2", "unique_dim",
    "unique_consecutive", "cumsum", "cumprod", "cummax", "cummin", "median", "kthvalue", "std",
    "var", "logsumexp", "bincount",
})
# The read of a scalar to the host.
_HOST_READS = frozenset({"_local_scalar_dense"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of nested tuples, lists and dicts, in order; a placed
    leaf (``parallel.mesh.Placed``) gives its blocks."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    elif hasattr(tree, "blocks"):
        _tensors(tree.blocks, out)
    return out


@functools.lru_cache(maxsize=None)
def _op_kind(func) -> tuple[str, bool]:
    """(the op's name without its namespace, whether it returns a view)."""
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    return func._schema.name.split("::", 1)[-1], view


def _distinct(idx, ok, width: int) -> int:
    """Distinct (row, column) pairs of ``idx`` where ``ok``."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)
    return int(torch.unique((rows * max(width, 1) + idx)[ok]).numel())


def _index_reads(idx, item: int) -> int:
    """Bytes of a row index of ``item``-byte elements read once: one row
    when it broadcasts (row stride 0, or a single row)."""
    if idx.dim() == 2 and (idx.shape[0] == 1 or idx.stride(0) == 0):
        return idx.shape[1] * item
    return idx.numel() * item


def kernel_cost(name: str, args: tuple, out, int64_as: int | None = None) -> tuple[int, int]:
    """(bytes, operations) of one call of the kernel-bearing function
    ``name`` on ``args`` giving ``out``: each input the kernel reads once,
    each output written once, and the table words a gather addresses. An
    int64 element counts ``int64_as`` bytes where given (4: the
    reference's u32 width for the port's int64-carried values). The one
    formula of the cost model and of ``chip_smoke.py``'s kernel bounds."""

    def item(t) -> int:
        return int64_as if int64_as is not None and t.dtype == torch.int64 else t.element_size()

    def size(t) -> int:
        return 0 if t is None else t.numel() * item(t)

    written = sum(size(t) for t in _tensors(out))
    if name in ("rowmax", "rowsum"):
        idx, val, mask = args[:3]
        return size(idx) + size(val) + size(mask) + written, (2 if name == "rowmax" else 1) * idx.numel()
    if name in ("rowgather", "rowgather_wide"):
        table, idx = args
        r, width = table.shape
        full = idx.expand(r, idx.shape[-1])
        if name == "rowgather_wide":
            cols, ok = full.clamp(0, max(width - 1, 0)), torch.ones_like(full, dtype=torch.bool)
        else:
            cols, ok = full, (full >= 0) & (full < width)
        ok = ok & (width > 0)
        words = _distinct(cols, ok, width)
        return _index_reads(idx, item(idx)) + written + words * item(table), full.numel()
    if name == "table_gather":
        table, idx = args
        return size(table) + size(idx) + written, idx.numel()
    if name == "delivery_reduce":
        idx = args[0]
        return sum(size(t) for t in args[:6]) + written, 4 * idx.numel()
    if name == "window_delivery":
        oo, idx, d, adv_m, valid, wk, width = args
        ok = valid & (idx >= 0) & (idx < width)
        words = oo.shape[0] * _distinct(idx, ok, width)
        reads = size(idx) + size(d) + size(adv_m) + size(valid)
        return reads + written + words * item(oo), 8 * idx.numel()
    raise ValueError(f"no cost formula for {name!r}")


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (module docstring):
    ``flops``, ``bytes`` and ``ops`` (by op name in ``by_op``: calls,
    flops, bytes), each kernel-bearing function's calls in
    ``kernel_calls``, and the high-water marks of live storage
    (``peak_bytes`` with the registered arguments, ``temp_bytes`` of the
    storage allocated while counting). Use :meth:`counting`, which also
    routes ``ops.onehot``'s kernel-bearing functions through the counter."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernel_calls: Counter = Counter()
        self.by_op: dict = {}  # op name -> [calls, flops, bytes]
        self.peak_bytes = 0
        self.temp_bytes = 0
        self._depth = 0  # > 0 inside a kernel-bearing function
        self._live: dict = {}  # storage key -> [bytes, tensors, allocated here]
        self._live_bytes = 0
        self._temp_live = 0

    # -- live storage ---------------------------------------------------------

    def _track(self, tensors, allocated: bool = True) -> None:
        for t in tensors:
            st = t.untyped_storage()
            n = st.nbytes()
            if n == 0:
                continue
            key = (str(t.device), st.data_ptr())
            entry = self._live.get(key)
            if entry is None:
                entry = self._live[key] = [n, 0, allocated]
                self._live_bytes += n
                self._temp_live += n if allocated else 0
            entry[1] += 1
            weakref.finalize(t, self._release, key)
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        self.temp_bytes = max(self.temp_bytes, self._temp_live)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self._live_bytes -= entry[0]
            self._temp_live -= entry[0] if entry[2] else 0

    def register(self, tree) -> None:
        """Count ``tree``'s tensors (the entry's arguments) as live."""
        self._track(_tensors(tree), allocated=False)

    # -- the tap --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        name, view = _op_kind(func)
        outs = _tensors(out)
        if view:
            self._track(outs)
            return out
        ins = _tensors((args, kwargs))
        if name in _HOST_READS or (
            name == "_to_copy" and ins[0].device != outs[0].device
            and ins[0].dtype == outs[0].dtype
        ):
            # A host read, or a move between devices that converts nothing
            # (the same call on the CPU dispatches no op at all).
            return out
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        flops = ins[0].numel() if name in _REDUCTIONS and ins else sum(t.numel() for t in outs)
        self._add(name, nbytes, flops)
        self._track(outs)
        return out

    def _add(self, name: str, nbytes: int, flops: int) -> None:
        self.ops += 1
        self.bytes += nbytes
        self.flops += flops
        tally = self.by_op.setdefault(name, [0, 0, 0])
        tally[0] += 1
        tally[1] += flops
        tally[2] += nbytes

    def _costed(self, name: str, fn):
        def call(*args, **kwargs):
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
                nbytes, flops = kernel_cost(name, args, out)
            finally:
                self._depth -= 1
            self._add(name, nbytes, flops)
            self.kernel_calls[name] += 1
            self._track(_tensors(out))
            return out

        return call

    def counting(self):
        """Context manager: the counter active, and ``ops.onehot``'s
        kernel-bearing functions counted as one op each (their module
        attributes, which every caller reads at the call, are restored on
        exit)."""
        import contextlib

        from corrosion_tpu_torch.ops import onehot

        @contextlib.contextmanager
        def scope():
            saved = {name: getattr(onehot, name) for name in KERNEL_FUNCTIONS}
            try:
                for name, fn in saved.items():
                    setattr(onehot, name, self._costed(name, fn))
                with self:
                    yield self
            finally:
                for name, fn in saved.items():
                    setattr(onehot, name, fn)

        return scope()


def count(fn, args_tree=None) -> tuple[object, CostCounter]:
    """Run ``fn()`` under a fresh :class:`CostCounter` (``args_tree``
    registered as its live arguments); returns (result, counter)."""
    counter = CostCounter()
    with counter.counting():
        counter.register(args_tree)
        out = fn()
    return out, counter


# ---------------------------------------------------------------------------
# The reference's tiny fixed configs, and one run of each engine.


def _tiny_dense(device):
    from corrosion_tpu_torch.models import baselines

    return baselines.merge_10k(n=32, rounds=8, samples=8, device=device)


def _tiny_sparse(device):
    from corrosion_tpu_torch.models import baselines

    return baselines.anywrite_sparse(
        n=96, w_hot=16, n_regions=4, rounds=16, cohort=8, epoch_rounds=8, k_dev=8, samples=16,
        device=device,
    )


def _tiny_chunk():
    from corrosion_tpu_torch.ops.chunks import ChunkConfig

    cfg = ChunkConfig(n_nodes=16, n_streams=2, chunk_len=64, fanout=3, sync_interval=4,
                      gap_requests=4)
    return cfg, [0, 5], [511, 255], 8


def _tiny_mixed(device):
    from corrosion_tpu_torch.models import baselines

    return baselines.mixed_storm(n=64, streams=2, last_seq=255, rounds=8, samples=8, n_cells=0,
                                 device=device)


def _mesh_for(d: int, device):
    from corrosion_tpu_torch.parallel.mesh import multichip_mesh

    return None if d <= 1 else multichip_mesh(d, device=device)


def _run_dense(mesh, device):
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.sim import benchlib, engine

    cfg, topo, sched = _tiny_dense(device)
    if mesh is None:
        run, entry = (lambda: engine.simulate(cfg, topo, sched, seed=0, device=device)), "simulate"
    else:
        run, entry = (lambda: parallel.simulate_sharded(cfg, topo, sched, mesh, seed=0)), \
            "simulate_sharded"
    return run, topo, entry, sched.rounds, benchlib.config_fingerprint(
        cfg, sched.rounds, len(sched.sample_writer))


def _run_sparse(mesh, device):
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.sim import benchlib, sparse_engine

    cfg, topo, sched = _tiny_sparse(device)
    el = cfg.sparse.epoch_rounds
    if mesh is None:
        def run():
            return sparse_engine.simulate_sparse(cfg, topo, sched, seed=0, stop_after_epoch=0,
                                                 device=device)
        entry = "simulate_sparse"
    else:
        def run():
            return parallel.simulate_sparse_sharded(cfg, topo, sched, mesh, seed=0,
                                                    stop_after_epoch=0)
        entry = "simulate_sparse_sharded"
    return run, topo, entry, el, benchlib.config_fingerprint(cfg, el, len(sched.sample_writer))


def _run_chunk(mesh, device):
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.sim import benchlib, chunk_engine

    cfg, origin, last_seq, rounds = _tiny_chunk()
    origin, last_seq = np.asarray(origin, np.int32), np.asarray(last_seq, np.int32)
    if mesh is None:
        def run():
            return chunk_engine.simulate_chunks(cfg, origin, last_seq, rounds, seed=0,
                                                device=device)
        entry = "simulate_chunks"
    else:
        def run():
            return parallel.simulate_chunks_sharded(cfg, origin, last_seq, rounds, mesh, seed=0)
        entry = "simulate_chunks_sharded"
    return run, None, entry, rounds, benchlib.config_fingerprint(cfg, rounds)


def _run_mixed(mesh, device):
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.sim import benchlib, mixed_engine

    cfg, ccfg, topo, sched, spec = _tiny_mixed(device)
    if mesh is None:
        def run():
            return mixed_engine.simulate_mixed(cfg, ccfg, topo, sched, spec, seed=0, device=device)
        entry = "simulate_mixed"
    else:
        def run():
            return parallel.simulate_mixed_sharded(cfg, ccfg, topo, sched, spec, mesh, seed=0)
        entry = "simulate_mixed_sharded"
    return run, topo, entry, sched.rounds, benchlib.config_fingerprint(
        cfg, ccfg, sched.rounds, len(sched.sample_writer))


_RUNNERS = {"dense": _run_dense, "sparse": _run_sparse, "chunk": _run_chunk, "mixed": _run_mixed}


def entry_key(engine: str, variant: str, device_count: int) -> str:
    return f"{engine}/{variant}/d{device_count}"


def _unique_bytes(tree) -> int:
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[(str(t.device), st.data_ptr())] = st.nbytes()
    return sum(seen.values())


def extract_entry(run, rounds: int, args_tree=None, **meta) -> dict:
    """One counted run of ``run()`` as a cost entry (``meta`` first)."""
    device = torch.device(meta.get("device", "cpu"))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out, c = count(run, args_tree)
    if on_card:
        torch.cuda.synchronize(device)
    entry = {
        **{k: v for k, v in meta.items() if k != "device"},
        "rounds": int(rounds),
        "flops": float(c.flops),
        "bytes_accessed": float(c.bytes),
        "ops": c.ops,
        "kernel_calls": dict(sorted(c.kernel_calls.items())),
        "by_op": {k: c.by_op[k] for k in sorted(c.by_op)},
        "argument_bytes": _unique_bytes(args_tree),
        "output_bytes": _unique_bytes(out),
        "temp_bytes": c.temp_bytes,
        "peak_bytes": c.peak_bytes,
        "count_s": round(time.perf_counter() - t0, 2),
    }
    if on_card:
        entry["allocator_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return entry


def cost_entry(engine: str, variant: str = "plain", device_count: int = 1, device=None) -> dict:
    """One counted run of ``engine``'s driver at its tiny config on
    ``device`` (default CUDA), on a mesh of ``device_count`` positions
    there when above 1."""
    from corrosion_tpu_torch import resolve_device

    if variant not in VARIANTS:
        raise ValueError(f"the port has the {VARIANTS} variants only, not {variant!r}")
    device = resolve_device(device)
    run, args_tree, entry, rounds, fingerprint = _RUNNERS[engine](
        _mesh_for(device_count, device), device
    )
    return extract_entry(
        run, rounds, args_tree, engine=engine, entry=entry, variant=variant,
        device_count=device_count, config_fingerprint=fingerprint, device=device,
    )


def build_cost_model(engines=ENGINES, variants=VARIANTS, device_counts=(1,), progress=None,
                     device=None) -> dict:
    """The ``corro-cost-model/1`` artifact: one cost entry per engine,
    variant and device count on ``device`` (default CUDA), with its
    provenance (``platform`` ``"gpu"`` or ``"cpu"``, ``backend`` ``"cuda"``
    for the kernels or ``"plain"`` for their plain versions)."""
    from corrosion_tpu_torch import resolve_device

    device = resolve_device(device)
    entries: dict[str, dict] = {}
    for d in sorted(device_counts):
        for eng in engines:
            for var in variants:
                key = entry_key(eng, var, d)
                if progress is not None:
                    progress.write(f"[cost] counting {key}\n")
                    progress.flush()
                entries[key] = cost_entry(eng, var, device_count=d, device=device)
    return {
        "schema": COST_SCHEMA,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
        "backend": "cuda" if device.type == "cuda" else "plain",
        "torch_version": torch.__version__,
        "tolerance": DEFAULT_COST_TOLERANCE,
        "engines": list(engines),
        "variants": list(variants),
        "device_counts": sorted(device_counts),
        "entries": entries,
    }


def save_model(model: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(model, f, indent=2)
        f.write("\n")


def load_model(path: str) -> dict:
    with open(path) as f:
        model = json.load(f)
    if model.get("schema") != COST_SCHEMA:
        raise ValueError(f"{path}: schema {model.get('schema')!r} is not {COST_SCHEMA}")
    return model


#: Metrics the baseline diff gates on (an increase beyond tolerance fails).
GATED_METRICS = ("flops", "bytes_accessed", "peak_bytes", "temp_bytes")
#: Default relative-increase tolerance: structural regressions (a lost
#: kernel route, a widened dtype), not noise.
DEFAULT_COST_TOLERANCE = 0.25


def diff_cost_models(base: dict, cand: dict, tolerance: float | None = None
                     ) -> tuple[bool, list[str], list[str]]:
    """Gate a freshly built model against a baseline: ``(ok, breaches,
    notes)``. Breaches: another platform or backend (refused outright),
    entries missing from the candidate, config-fingerprint drift, and a
    gated metric increasing beyond ``tolerance`` (relative). Decreases and
    a torch version drift are notes."""
    tol = float(base.get("tolerance", DEFAULT_COST_TOLERANCE)) if tolerance is None else tolerance
    breaches: list[str] = []
    notes: list[str] = []
    for dim in ("platform", "backend"):
        if base.get(dim) != cand.get(dim):
            breaches.append(
                f"{dim}: baseline {base.get(dim)!r} vs measured {cand.get(dim)!r} — cost "
                f"baselines do not compare across {dim}s; rebuild the baseline on the "
                f"target {dim}"
            )
    if base.get("torch_version") != cand.get("torch_version"):
        notes.append(
            f"torch_version drift: baseline {base.get('torch_version')} vs "
            f"{cand.get('torch_version')}"
        )
    for key, b in base.get("entries", {}).items():
        c = cand.get("entries", {}).get(key)
        if c is None:
            breaches.append(f"{key}: missing from measurement")
            continue
        if b.get("config_fingerprint") != c.get("config_fingerprint"):
            breaches.append(
                f"{key}: config fingerprint {c.get('config_fingerprint')} != baseline "
                f"{b.get('config_fingerprint')} — the fixed tiny shapes changed; refresh "
                f"the baseline with the change"
            )
            continue
        for m in GATED_METRICS:
            bv, cv = float(b.get(m, 0.0)), float(c.get(m, 0.0))
            if bv <= 0:
                continue
            rel = (cv - bv) / bv
            if rel > tol:
                breaches.append(
                    f"{key}.{m}: {cv:.0f} > baseline {bv:.0f} (+{rel:.0%}, tolerance {tol:.0%})"
                )
            elif rel < -tol:
                notes.append(
                    f"{key}.{m}: {cv:.0f} improved {rel:.0%} vs baseline — refresh the "
                    f"baseline to lock it in"
                )
    for key in cand.get("entries", {}):
        if key not in base.get("entries", {}):
            notes.append(f"{key}: new entry (not in baseline)")
    return not breaches, breaches, notes


# ---------------------------------------------------------------------------
# Roofline stage costs: the cumulative-prefix composite, in flops and bytes.


def roofline_stage_costs(composite, stages, carry0) -> dict:
    """Per-stage flops and bytes from one counted step of each cumulative
    prefix of ``composite`` (``benchlib.plane_composite``) from
    ``carry0``, round 0: a stage's cost is the increment (clamped at 0),
    so the partition matches the milliseconds' stage for stage. Returns
    ``{stage: {flops, bytes}}``."""
    cum = []
    for k in range(len(stages) + 1):
        step = composite(tuple(stages[:k]))
        _, c = count(lambda: step(carry0, 0), carry0)
        cum.append((float(c.flops), float(c.bytes)))
    return {
        s: {
            "flops": max(cum[k + 1][0] - cum[k][0], 0.0),
            "bytes": max(cum[k + 1][1] - cum[k][1], 0.0),
        }
        for k, s in enumerate(stages)
    }


# ---------------------------------------------------------------------------
# Live memory watermarks and the reconcile-or-fail check.


def _cpu_live_bytes() -> int:
    import gc

    seen = {}
    for obj in gc.get_objects():
        # type(), not isinstance: some module objects warn on __class__.
        if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
            st = obj.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def live_device_bytes() -> dict:
    """Live bytes per device (``str(torch.device)`` -> bytes): each card's
    allocated bytes (``torch.cuda.memory_allocated``) when a card is in
    use, else the CPU's, the unique storages of its live tensors."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return {f"cuda:{i}": torch.cuda.memory_allocated(i)
                for i in range(torch.cuda.device_count())}
    return {"cpu": _cpu_live_bytes()}


class MemoryWatermarks:
    """Live-byte high-water marks per device, sampled at chunk and epoch
    boundaries by ``KernelTelemetry`` (``watermarks=``); on the card,
    ``allocator_peak`` beside them (``torch.cuda.max_memory_allocated``)."""

    def __init__(self):
        self.peak: dict = {}
        self.allocator_peak: dict = {}
        self.samples = 0

    def sample(self) -> dict:
        live = live_device_bytes()
        for dev, n in live.items():
            if n > self.peak.get(dev, 0):
                self.peak[dev] = n
            if dev.startswith("cuda"):
                pk = torch.cuda.max_memory_allocated(dev)
                if pk > self.allocator_peak.get(dev, 0):
                    self.allocator_peak[dev] = pk
        self.samples += 1
        return live

    def to_dict(self) -> dict:
        return {
            "samples": self.samples,
            "peak_bytes": dict(sorted(self.peak.items())),
            "allocator_peak_bytes": dict(sorted(self.allocator_peak.items())),
        }


def _placement_bytes_by_device(tree) -> dict:
    """The storage bytes a placed state keeps on each device: its blocks'
    unique storages (a leaf's blocks on one device are views of one
    tensor)."""
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.parallel.mesh import Placed

    seen = {}
    for leaf in mesh_mod.tree_leaves(tree):
        for b in (leaf.blocks if isinstance(leaf, Placed) else ()):
            st = b.untyped_storage()
            seen[(str(b.device), st.data_ptr())] = st.nbytes()
    out: dict = {}
    for (dev, _), n in seen.items():
        out[dev] = out.get(dev, 0) + n
    return out


def reconcile_memory(final_state, watermarks: MemoryWatermarks | None = None,
                     predicted_per_device: int | None = None, cost: dict | None = None,
                     tol: float = 0.01) -> dict:
    """Reconcile the views of a placed state's memory AT REST, as a
    ``simulate_*_sharded`` call returns it; breaks raise ValueError. During
    a run the controller holds the whole state on the mesh's home device
    (``parallel/__init__.py``), so nothing here claims a position's peak.

    1. Each position's state bytes (``parallel.per_device_state_bytes``)
       equal ``predicted_per_device`` within ``tol``.
    2. Each device's live watermark covers the storage the placement keeps
       on it (positions on one card share it, and a replicated leaf is one
       copy there).
    3. A cost entry's ``output_bytes`` covers the largest position's state.
    """
    from corrosion_tpu_torch import parallel

    measured = parallel.per_device_state_bytes(final_state)
    if not measured:
        raise ValueError("reconcile_memory: the state holds no placed leaf; pass a placed state")
    problems: list[str] = []
    per_dev = sorted(measured.values())
    if predicted_per_device is not None:
        for pos, got in sorted(measured.items()):
            if abs(got - predicted_per_device) > tol * max(predicted_per_device, 1):
                problems.append(
                    f"position {pos}: measured state {got} B != predicted "
                    f"{predicted_per_device} B (tol {tol:.0%})"
                )
    held = _placement_bytes_by_device(final_state)
    if watermarks is not None:
        if not watermarks.samples:
            problems.append("watermarks were never sampled")
        for dev, got in sorted(held.items()):
            wm = watermarks.peak.get(dev, 0)
            if wm + 1 < got:
                problems.append(
                    f"{dev}: live watermark {wm} B below the {got} B the placement keeps "
                    f"there — the sampler missed this device"
                )
    if cost is not None:
        out_b = int(cost.get("output_bytes", 0))
        if out_b and out_b + 1 < max(per_dev):
            problems.append(
                f"cost entry output_bytes {out_b} B does not cover the per-position state "
                f"{max(per_dev)} B — the counted run and this state disagree about shapes"
            )
    if problems:
        raise ValueError("memory reconciliation failed:\n  " + "\n  ".join(problems))
    return {
        "at": "rest",
        "positions": len(measured),
        "state_bytes_per_position_max": max(per_dev),
        "state_bytes_per_position_min": min(per_dev),
        "predicted_per_position": predicted_per_device,
        "held_bytes_by_device": dict(sorted(held.items())),
        "watermarks": None if watermarks is None else watermarks.to_dict(),
    }


# ---------------------------------------------------------------------------
# Capacity curve: nodes -> predicted state bytes a position, validated.


def flagship_cfg(n_nodes: int, samples: int = 16, device="cpu"):
    """The flagship sharded config family (``benchlib._measure_large``'s
    shape): wan_100k at 8 regions, queue depth 16, ``min(128, n/4)``
    writers; the topology on ``device``."""
    from dataclasses import replace as dc_replace

    from corrosion_tpu_torch.models import baselines

    cfg, topo, sched = baselines.wan_100k(
        n=n_nodes, n_regions=8, n_writers=min(128, n_nodes // 4), rounds=16, samples=samples,
        partition=False, device=device,
    )
    cfg = dc_replace(cfg, gossip=dc_replace(cfg.gossip, queue=16))
    return cfg, topo, sched


def predicted_state_bytes(cfg, n_samples: int, mesh) -> int:
    """State bytes a position of a dense ClusterState under the standard
    placement, by arithmetic over its shapes on the ``meta`` device (no
    allocation), at the port's itemsizes (int64 carriers count 8 bytes)."""
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import engine

    shapes = engine.init_cluster(cfg, n_samples, device="meta")
    specs = mesh_mod.cluster_state_specs(shapes, mesh)
    return mesh_mod.predicted_per_device_bytes(shapes, specs, mesh)


#: The capacity curve's node grid: multiples of 8 regions x 8 positions
#: from 100,352 to about a million.
CAPACITY_NODE_GRID = (100_352, 250_880, 401_408, 501_760, 802_816, 1_003_520)
def measure_placement(cfg, n_samples: int, mesh) -> dict:
    """Place a fresh dense state of ``cfg`` on ``mesh`` and measure it: the
    largest position's state bytes at rest and, on a card, the bytes the
    allocator gained."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import engine

    home = mesh.home
    on_card = home.type == "cuda"
    before = torch.cuda.memory_allocated(home) if on_card else 0
    st = mesh_mod.shard_cluster_state(engine.init_cluster(cfg, n_samples, home), mesh)
    out = {"per_device_bytes": max(parallel.per_device_state_bytes(st).values())}
    if on_card:
        out["allocated_bytes"] = torch.cuda.memory_allocated(home) - before
    del st
    return out


def capacity_model(node_counts=CAPACITY_NODE_GRID, device_count: int = 8,
                   memory_bytes: int | None = None, measured_100k: dict | None = None,
                   tol: float = 0.05, device=None) -> dict:
    """The ``corro-capacity/1`` artifact: predicted state bytes a position
    over ``node_counts`` for the flagship config on the ``device_count``-
    position mesh on ``device`` (default CUDA), validated, with a verdict a
    count against ``memory_bytes`` (default: the card's
    ``total_memory``; required on the CPU).

    Validation (a failed point raises):

    - the lane's 512-node point (``benchlib.MULTICHIP_NODES``), placed
      live: the prediction must equal the measured bytes of the largest
      position exactly;
    - ``measured_100k`` (``{"nodes", "device_count", "per_device_bytes",
      "source"}``), a measured placement of ``flagship_cfg(100_352)``:
      within ``tol``.
    """
    from corrosion_tpu_torch import resolve_device
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import benchlib

    device = resolve_device(device)
    if memory_bytes is None:
        if device.type != "cuda":
            raise ValueError("capacity_model on the CPU needs memory_bytes")
        memory_bytes = torch.cuda.get_device_properties(device).total_memory
    mesh = _mesh_for(device_count, device)
    if mesh is None:
        raise ValueError("capacity_model needs device_count > 1")

    lane = benchlib.MULTICHIP_NODES
    cfg512, _, sched512 = baselines.merge_10k(n=lane, rounds=8, samples=64, device=device)
    n_s = len(sched512.sample_writer)
    measured512 = measure_placement(cfg512, n_s, mesh)["per_device_bytes"]
    predicted512 = predicted_state_bytes(cfg512, n_s, mesh)
    if measured512 != predicted512:
        raise ValueError(
            f"capacity validation failed at the {lane}-node lane point: predicted "
            f"{predicted512} B != measured {measured512} B a position — the placement "
            f"specs and the shard helpers have drifted"
        )
    validation: dict = {"lane_512": {
        "nodes": lane, "predicted_bytes": predicted512, "measured_bytes": measured512,
        "exact": True,
    }}
    if measured_100k is not None:
        cfg100k, _, sched100k = flagship_cfg(measured_100k["nodes"])
        pred = predicted_state_bytes(cfg100k, len(sched100k.sample_writer), mesh)
        rec = measured_100k["per_device_bytes"]
        rel = abs(pred - rec) / rec
        if rel > tol:
            raise ValueError(
                f"capacity validation failed at the measured {measured_100k['nodes']}-node "
                f"point: predicted {pred / 2**20:.1f} MiB vs measured {rec / 2**20:.1f} MiB "
                f"({rel:.1%} > {tol:.0%}) — {measured_100k.get('source')}"
            )
        validation["large_100k"] = {**measured_100k, "predicted_bytes": pred,
                                    "relative_error": round(rel, 4)}

    budget = int(memory_bytes * (1 - CAPACITY_HEADROOM))
    curve = []
    for n in sorted(node_counts):
        cfg, _, sched = flagship_cfg(n)
        per_dev = predicted_state_bytes(cfg, len(sched.sample_writer), mesh)
        curve.append({
            "nodes": n,
            "per_device_bytes": per_dev,
            "per_device_mib": round(per_dev / 2**20, 1),
            "memory_fraction": round(per_dev / memory_bytes, 4),
            "verdict": "fits" if per_dev <= budget else "tight" if per_dev <= memory_bytes
            else "exceeds",
        })
    model = {
        "schema": CAPACITY_SCHEMA,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_count": device_count,
        "mesh": {a: int(mesh.shape[a]) for a in mesh.axis_names},
        "engine": "dense",
        "config_family": "wan_100k(n_regions=8, queue=16, n_writers=min(128, n/4))",
        "memory_bytes": int(memory_bytes),
        "memory_headroom_fraction": CAPACITY_HEADROOM,
        "validation": validation,
        "curve": curve,
    }
    if len(curve) > 1:
        model["state_bytes_per_node"] = round(bytes_per_node(model), 1)
    return model


def bytes_per_node(model: dict) -> float:
    """Marginal state bytes per node, over the whole mesh, from the
    capacity curve's endpoints (the replicated floor cancels)."""
    c = model["curve"]
    lo, hi = c[0], c[-1]
    d = math.prod(model["mesh"].values())
    return (hi["per_device_bytes"] - lo["per_device_bytes"]) / (hi["nodes"] - lo["nodes"]) * d

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each raises on failure; the exit code is nonzero on any fault):

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the one kernel library from the sources in
   ``corrosion_tpu_torch/csrc``: one nvcc per ``.cu`` (sm_90a) and one
   host-compiler run of ``ops.cpp`` (the ``torch.ops.corro`` operators
   every kernel launches through), all at once, then one link; load it.
   The kernel-library ledger (``obs.ledger``) is installed first, so the
   build and the load land in its window;
3. each kernel against its plain PyTorch version on the same CUDA inputs,
   on edge cases (0-width axes, out-of-range indices, bit 31, and widths
   10,000 and 16,384, which take every row kernel's shared-memory opt-in;
   the row gathers in each form and both semantics, with a broadcast
   index, odd M and W, an index at an odd storage offset and M either side
   of the form rule; ``table_gather`` at W = 1, 2,048 and 100,000, the
   latter served from L2, with n from 0 to 3, one block of 1,024 outputs
   either side and several blocks and one, and an index at an odd storage
   offset) and at every shape each main path gives it
   (wan_100k and anywrite_sparse: the fast path's kernels with every
   ``rowgather`` site — base gather, CRDT winner check, sync grants,
   ``visibility``, and anywrite's ``cold_sync`` grants; merge_10k:
   ``rowmax`` and ``rowgather`` in the CRDT merge, ``rowgather`` in the
   sync grants and ``visibility``, ``delivery_reduce`` at W = 10,000,
   ``rowgather_wide`` and ``rowsum``; anywrite_sparse also ``table_gather``
   in the sync grants and in ``rotate``) — exact equality required. Each is
   timed beside its plain version, one PyTorch library call where one
   computes the same function, and the byte/operation bound: CUDA events
   around runs of back-to-back calls (at least 50 and 20 ms) rotating over
   input copies that together exceed the 50 MB L2 (``ms``, median of three
   such runs taken in turns with the other functions timed at that shape),
   the host's enqueue time a call
   (``host_ms``, beside the library call's ``library_host_ms``),
   the kernel's device time a call from torch.profiler with the CUDA
   activity alone (``device_ms``, the kernel only) and
   the old single-call window (``single_ms``); a log line gives the
   phase's seconds by part (``Split``). The row gathers are also
   timed in each form (``scalar_ms``, ``pairs_ms``), ``table_gather``
   beside a copy of its index (``clone_ms``: its bytes, no gather),
   ``delivery_reduce``
   at merge_10k against two ``rowmax`` and a max pass, and ``rowsum``
   against ``torch.zeros`` + ``scatter_add_`` (no single call makes its
   fresh plane). The adaptive-dissemination paths add ``table_gather`` at
   the intake priority ([512] <- [100000, 144]) and the saturation test
   ([512] <- [100000, 48]), with a 2-D index at an odd storage offset and a
   non-contiguous one (refused), and ``rowgather`` at the rumor kill's
   watermark lookup; the geo scenario's shapes (10,000 rows, 16 writers)
   for every kernel it launches; ``mixed_storm``'s (1,000 rows, 64
   writers, 512 cells) for the fast path's kernels, the sync sessions'
   CRDT merge ([125, 512]) and the big versions' admission merge, one
   column a stream ([1000, 1] -> [1000, 512]), and the adaptive mixed
   run's ``table_gather`` at n = 64;
4. small runs on the card (kernels) and on the CPU (plain versions), with
   identical curves and final state: ``wan_100k(n=2000, ...)``,
   ``three_node()``, ``churn_32()`` and its wipe variant,
   ``anti_entropy_1k()``, a merge_10k burst variant at n=2560 (wider than
   2048 writers, so it takes the legacy delivery and launches
   ``rowgather_wide`` and ``rowsum``), and ``anywrite_sparse(n=2000, ...)``
   with fewer hot slots than active writers under a partition (forced
   demotions, cold healing, ``table_gather``); then the adaptive plane
   (``health.ADAPTIVE_GOSSIP``): ``wan_100k(n=2000, rounds=48)`` with
   8-bucket sketches (sketch scoring forced), the merge_10k burst at
   n=2560 over 24 rounds (the legacy delivery; its CPU side is the slow
   one), ``churned_demo_cluster(96, 48, geo=True,
   adaptive=True)`` and the anywrite run with ``prop_observe``; then the
   chunk plane's tie-sensitive picks at 1.6 M rows, ``anti_entropy_chunks(
   n=48, streams=4)`` plain and under a fault plan (loss, churn, a wipe
   that spares the origins), and ``mixed_storm(n=64, streams=2, rounds=24)``
   without cells, with cells, under kill/revive/wipe and adaptive with
   ``prop_observe`` (conservation). The CPU side of every small run goes
   in one worker process while the card runs its side;
5. full-size ``wan_100k()`` (100,000 nodes, 20 regions, 512 writers), all
   240 rounds in chunks of 12: its four kernels launched, the watermark
   invariants;
6. full-size ``merge_10k()`` (10,000 nodes, 10,000 writers), all 120
   rounds in chunks of 12: ``rowgather_wide``, ``rowmax``, ``rowgather``
   and ``delivery_reduce`` launched, the watermark invariants;
7. full-size ``anywrite_sparse()`` (100,000 nodes, any of them a writer,
   2,048 hot slots), all 320 rounds, epoch by epoch: converged, no
   deviation entry dropped, ``table_gather``, ``rowmax``, ``rowgather``
   and ``delivery_reduce`` launched, the watermark invariants;
8. ``wan_100k_adaptive``: full-size ``wan_100k()`` with
   ``ADAPTIVE_GOSSIP`` and 8-bucket sync sketches, all 240 rounds in
   chunks of 12: its five kernels launched (``table_gather`` among them),
   the watermark invariants;
9. ``geo_10k``: ``churned_demo_cluster(nodes=10_000, rounds=64, geo=True)``
   (4 regions, 16 writers, a kill/revive wave of 625 nodes, dense SWIM,
   ``prop_observe``), push-only and adaptive: the propagation plane's
   conservation identities on the card's curves, rumor kills in the
   adaptive run, and each run's delivered copies, peak backlog and
   convergence round;
10. the chunk plane: ``anti_entropy_chunks()`` (1,000 nodes, 16 streams
   of 8,192 seqs, 240 rounds: converged), then at 100,000 nodes (1.6 M
   (node, stream) rows, the first 48 rounds: the interval invariants,
   reassembly that never falls), 24 rounds a call; no kernel launched;
11. ``mixed_storm()`` (1,000 nodes, 64 writers, 16 big transactions of
   2,048 seqs, 512 cells, 200 rounds), 25 rounds a call: converged on both
   planes with every node's cells equal to the serial-merge ground truth
   of the final heads, ``rowmax``, ``rowgather``, ``delivery_reduce`` and
   ``window_delivery`` launched;
12. the curve consumers: the committed demo flights (96 nodes, 48 rounds,
   churn, seed 0; flat, geo, geo adaptive) recorded on the card, their
   convergence and epidemic reports held to ``CONVERGENCE_BASELINE.json``,
   ``EPIDEMIC_BASELINE.json`` and ``EPIDEMIC_BASELINE_ADAPTIVE.json`` at
   the reference CI's tolerance 0.35; the invariant suite on the
   ``kitchen-sink`` fault plan on all four engines, every report ok and
   the card's facts, violations and recovery equal to the CPU's; and a
   ``save_state``/``load_state`` round trip of the churn_32 run on the card;
13. the shard driver and the elastic plane: full-width ``wan_100k()`` on
   a (2, 2) mesh of card positions (all on one card when there is one),
   48 rounds in calls of 12: curves equal to phase 5's first 48 rounds but
   the exchange's byte keys, the final state equal to phase 5's at round
   48, the exchange bytes equal to ``traffic_model`` and each position's
   state bytes equal to the prediction; ``anywrite_sparse(n=2000, ...)``
   on 4 positions and the merge_10k burst at n=2560 (the legacy delivery)
   on 2, each equal to its unsharded card run; the elastic drills
   (``reshard_{dense,sparse,chunk,mixed}_4to8``, ``preempt_dense_churn``)
   on the card, each equal to its uninterrupted run, the preemption's
   recovery machinery fired, the budget gate ok on its survival fields,
   each report equal to the CPU's. Phase 3 times the kernels at the shard
   bodies' row blocks;
14. the bench harness and the device-cost plane: merge_10k in full (seed
   1) with the ledger armed and ``KernelTelemetry(ledger=, watermarks=)``,
   its plane attribution and roofline stage costs, the bench report put
   together as the reference bench does and passed through
   ``check_bench_invariants`` (``steady_compiles`` 0); the multi-device lane
   (``measure_multichip``) at D = 1, 2, 4, 8 on card positions, equal
   across D with exchange bytes equal to ``traffic_model``; the cost model
   of the four engines at their tiny configs on the card, equal in flops,
   bytes and kernel calls to the CPU's (built by phase 4's worker); and the
   capacity curve against the card's memory, its 512-node point exact and
   its 100,352-node point a placement measured here.

Phases 5 (wan_100k), 10 (anti_entropy_chunks at 1,000 nodes) and 11 pass
``telemetry=KernelTelemetry(recorder=FlightRecorder(...), progress=
sys.stderr)`` to every call: each flight record (under ``build/flights``)
must replay to the run's curves, key for key and round for round, and the
recorder's ``device_step_ms`` is logged beside the CUDA-event ms/round.

The launch counts are reset just before each main-path run (phases 5-8
and 11, the pairs of runs of phases 9 and 10, phase 12, each of phase
13's four paths and each of phase 14's paths: the merge_10k run, its plane
attribution, the multi-device lane's sharded runs, read at the lane's note
that its attribution begins, that attribution, and the cost model) and
read just after it. Each phase logs its wall time. The last lines are a ``kernels`` JSON line,
the nvidia-smi line, and the result line ``{"ok": true, "device": {...}}``.
Each kernel's entry carries its launches summed over the paths and,
under ``by_path``, each path's launches and the times and bound of every
shape measured on it; its top-level times are those of its first shape.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# INT32 outside the tensor cores: half the data sheet's 67 TFLOP/s float32,
# since a Hopper SM issues 64 INT32 lanes a clock against 128 FP32 lanes.
H100_INT_OPS_PER_S = 33.5e12
L2_BYTES = 50 * 2**20  # H100 L2 cache
RUN_CALLS = 50  # back-to-back calls a timed run at least (in whole cycles of copies)
MIN_RUN_MS = 20.0  # and at least this long
RUNS = 3  # timed runs a function, in turns with the others; the median counts

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "rowmax": ("corrosion_tpu_torch/csrc/rowmax.cu",
               "corrosion_tpu/ops/onehot.py:177"),
    "rowgather": ("corrosion_tpu_torch/csrc/rowgather.cu",
                  "corrosion_tpu/ops/onehot.py:561"),
    "delivery_reduce": ("corrosion_tpu_torch/csrc/delivery_reduce.cu",
                        "corrosion_tpu/ops/onehot.py:637"),
    "window_delivery": ("corrosion_tpu_torch/csrc/window_delivery.cu",
                        "corrosion_tpu/ops/onehot.py:729"),
    "rowgather_wide": ("corrosion_tpu_torch/csrc/rowgather.cu",
                       "corrosion_tpu/ops/onehot.py:261"),
    "rowsum": ("corrosion_tpu_torch/csrc/rowsum.cu",
               "corrosion_tpu/ops/onehot.py:487"),
    "table_gather": ("corrosion_tpu_torch/csrc/table_gather.cu",
                     "corrosion_tpu/ops/onehot.py:383"),
}
# Kernels each main path must launch.
PATH_KERNELS = {
    "wan_100k": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "merge_10k": ("rowgather_wide", "rowmax", "rowgather", "delivery_reduce"),
    "anywrite_sparse": ("table_gather", "rowmax", "rowgather", "delivery_reduce"),
    "wan_100k_adaptive": ("rowmax", "rowgather", "delivery_reduce", "window_delivery",
                          "table_gather"),
    "geo_10k": ("rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    "anti_entropy_chunks": (),
    "mixed_storm": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "consumers": ("rowmax", "rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    # Phase 13: the shard driver's bodies and the elastic drills.
    "wan_100k_sharded": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "anywrite_sparse_sharded": ("table_gather", "rowmax", "rowgather", "delivery_reduce"),
    "merge_10k_sharded": ("rowgather_wide", "rowsum", "rowmax", "rowgather", "delivery_reduce"),
    "elastic": ("rowmax", "rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    # Phase 14: the bench harness (merge_10k's legacy delivery, the
    # multi-device lane's 512-node fast path and its sparse plane, the
    # cost model's tiny configs), and the plane attribution after each of
    # the two runs (the composite steps over the final state).
    "bench_merge_10k": ("rowgather_wide", "rowsum", "rowmax", "rowgather", "delivery_reduce"),
    "bench_attribution": ("rowgather_wide", "rowmax", "rowgather", "delivery_reduce"),
    "bench_multichip": ("rowmax", "rowgather", "delivery_reduce", "window_delivery",
                        "table_gather"),
    "bench_multichip_attribution": ("rowmax", "rowgather", "delivery_reduce"),
    "bench_costs": ("rowmax", "rowgather", "delivery_reduce", "table_gather"),
}
# Phase 13 runs wan_100k's first rounds sharded; phase 5 keeps its state
# and curves there to hold them to.
SHARDED_ROUNDS = 48
ELASTIC_DRILLS = ("reshard_dense_4to8", "reshard_sparse_4to8", "reshard_chunk_4to8",
                  "reshard_mixed_4to8", "preempt_dense_churn")
CHUNK_100K_ROUNDS = 48  # phase 10's 100,000-node run (the 1,000-node run takes all 240)
REPO = Path(__file__).resolve().parent
FLIGHTS = REPO / "build" / "flights"  # flight records of the telemetry-carrying phases


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event windows of
    one call each: what the host does before the launch falls inside."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _prefix(key: str) -> str:
    return key[: -len("ms")]  # "ms" -> "", "plain_ms" -> "plain_"


class Split:
    """Seconds of phase 3 by part, summed over its sites (``PARTS``);
    ``other`` is what the parts leave of the phase's wall: making the
    inputs, the bounds' touched-word counts, logging."""

    PARTS = ("equality checks", "input copies", "timed event runs", "collector", "single_ms",
             "device_ms")

    def __init__(self):
        self.s = dict.fromkeys(self.PARTS, 0.0)
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] += time.perf_counter() - t0

    def line(self) -> str:
        total = time.perf_counter() - self.t0
        parts = dict(self.s, other=total - sum(self.s.values()))
        return f"{total:.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())


def kernel_device_ms(fn, run, calls: int) -> tuple[float, int]:
    """Device ms a call of ``fn`` from torch.profiler with the CUDA
    activity alone, read from the profiler's own event list: one run of
    ``calls`` calls while tracing starts (the schedule's warm-up step,
    discarded), then one recorded run; every device event (kernel, copy,
    set) of the recorded step counts. Returns (ms, device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            run(fn, calls)
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls, len(events)


def run_ms(fns: dict, inputs: tuple, bytes_per_call: int, split: Split) -> dict:
    """Milliseconds a call of each ``fns[key](*inputs)`` (``fns["ms"]`` the
    kernel), three ways, and the kernel's device time:

    - ``key``: CUDA events around a run of back-to-back calls (at least
      ``RUN_CALLS`` and ``MIN_RUN_MS``), divided by the count; the median
      of ``RUNS`` such runs, taken in turns over the functions. The calls
      rotate over enough copies of ``inputs`` that one cycle moves more
      than the L2 holds, so each finds its data cold;
    - ``<prefix>host_ms``: host time a call to enqueue those runs (median;
      a function of one launch never waits on the card here, one of many
      may once the launch queue fills);
    - ``<prefix>single_ms``: the median single-call window (``cuda_ms``);
    - ``device_ms``: the kernel's device time a call (every kernel, copy
      and set it launches) from torch.profiler over one more run
      (``kernel_device_ms``), and ``device_events``, the device events
      that run recorded.

    Where ``ms`` exceeds ``device_ms`` and meets ``host_ms``, the host
    sets the pace."""
    with split.part("input copies"):
        copies = [inputs] + [
            tuple(t.clone() for t in inputs) for _ in range(L2_BYTES // max(bytes_per_call, 1))
        ]

    def run(fn, calls):
        for i in range(calls):
            fn(*copies[i % len(copies)])

    # The warm-up run (allocator, clocks, caches) also sizes each function's
    # timed runs: at least RUN_CALLS calls and MIN_RUN_MS of events, in whole
    # cycles of the copies, so one host hiccup moves a run little.
    calls = {}
    runs = {key: [] for key in fns}
    with split.part("timed event runs"):
        for key, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(fn, RUN_CALLS)
            b.record()
            b.synchronize()
            want = max(RUN_CALLS, math.ceil(MIN_RUN_MS * RUN_CALLS / max(a.elapsed_time(b), 1e-3)))
            calls[key] = len(copies) * -(-want // len(copies))
    # No collector pause inside a timed run (as timeit): one collection
    # first, the collector off through the site's runs.
    with split.part("collector"):
        gc.collect()
    gc.disable()
    try:
        with split.part("timed event runs"):
            for _ in range(RUNS):
                for key, fn in fns.items():
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    t0 = time.perf_counter()
                    run(fn, calls[key])
                    host = time.perf_counter() - t0
                    b.record()
                    b.synchronize()
                    runs[key].append((a.elapsed_time(b) / calls[key], host * 1e3 / calls[key]))
    finally:
        gc.enable()
    out = {}
    for key, fn in fns.items():
        out[key] = statistics.median(t for t, _ in runs[key])
        out[_prefix(key) + "host_ms"] = statistics.median(h for _, h in runs[key])
        with split.part("single_ms"):
            out[_prefix(key) + "single_ms"] = cuda_ms(lambda: fn(*inputs))
    with split.part("device_ms"):
        out["device_ms"], out["device_events"] = kernel_device_ms(fns["ms"], run, calls["ms"])
    return out


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    tb = bytes_moved / H100_BYTES_PER_S * 1e3
    to = ops / H100_INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs (exactness requires 0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        for g, w in zip(got, want)
    )


# ---- phase 3: kernels against their plain versions -------------------------


def _inputs(g, r, m, w, device):
    """Random kernel inputs: indices with negatives and out-of-range
    columns, u32 values with bit 31 set, random masks."""
    idx = torch.randint(-2, w + 3, (r, m), generator=g).to(device)
    val = torch.randint(0, 1 << 32, (r, m), generator=g).to(device)
    mask = (torch.rand((r, m), generator=g) < 0.7).to(device)
    return idx, val, mask


GATHER_EDGES = (
    (1, 1, 1), (37, 19, 41), (33, 17, 130), (1001, 144, 512), (2001, 36, 256),
    (40, 128, 511), (40, 127, 512), (40, 255, 512), (40, 256, 512), (40, 257, 512),
    (9, 144, 10_000), (3, 50, 16_384),
)


def check_gathers(onehot, table, idx, where: str) -> None:
    """``rowgather`` and ``rowgather_wide`` equal their plain versions
    through the public wrappers (the rule's form) and in each form forced
    (``onehot._gather``, on non-empty inputs), with ``idx`` and with its
    first row broadcast (row stride 0) as ``[1, M]`` and as an expanded
    view."""
    r, w = table.shape
    forms = onehot.GATHER_FORMS if idx.numel() and w else ()
    bcast = idx[:1]
    for ix in (idx, bcast, bcast.expand(r, -1)) if r else (idx,):
        want = onehot.rowgather_plain(table, ix)
        assert equal(onehot.rowgather(table, ix), want), \
            f"rowgather differs at {where}, idx strides {ix.stride()}"
        for f in forms:
            assert equal(onehot._gather("rowgather", table, ix, False, f), want), \
                f"rowgather ({f}) differs at {where}, idx strides {ix.stride()}"
        if ix is idx:  # rowgather_wide takes a contiguous [R, M] index only
            want = onehot.rowgather_wide_plain(table, ix)
            assert equal(onehot.rowgather_wide(table, ix), want), f"rowgather_wide differs at {where}"
            for f in forms:
                assert equal(onehot._gather("rowgather_wide", table, ix, True, f), want), \
                    f"rowgather_wide ({f}) differs at {where}"


def check_kernels(onehot, device) -> list:
    """Exact equality kernel vs plain on edge cases and at the shapes each
    main path gives each kernel; returns one measurement per kernel and
    shape, in path order."""
    from corrosion_tpu_torch.obs import costs

    g = torch.Generator().manual_seed(0)
    split = Split()
    t_edges = time.perf_counter()
    # Edge cases: 0-width axes, odd small shapes, both window widths, and
    # widths past every row kernel's 48 KB shared-memory default (16,384
    # columns: 64 KB for rowmax/rowsum and window_delivery at wk=32, 128 KB
    # for delivery_reduce and window_delivery at wk=64), one of them not a
    # multiple of 128.
    for r, m, w in (
        (0, 5, 7), (5, 0, 7), (5, 7, 0), (3, 1, 1), (37, 19, 41), (64, 300, 2049),
        (48, 144, 10_000), (24, 144, 16_384),
    ):
        idx, val, mask = _inputs(g, r, m, w, device)
        for msk in (mask, None):
            got, want = onehot.rowmax(idx, val, msk, w), onehot.rowmax_plain(idx, val, msk, w)
            assert equal(got, want), f"rowmax differs at {(r, m, w)}"
            got, want = onehot.rowsum(idx, val, msk, w), onehot.rowsum_plain(idx, val, msk, w)
            assert equal(got, want), f"rowsum differs at {(r, m, w)}"
        table = torch.randint(0, 1 << 32, (r, w), generator=g).to(device)
        check_gathers(onehot, table, idx, f"{(r, m, w)}")
        seen = torch.randint(0, 1 << 32, (r, w), generator=g).to(device)
        d = torch.randint(0, 200, (r, m), generator=g).to(device)
        applied = mask & (d < 150)
        got = onehot.delivery_reduce(idx, d, val, applied, mask, seen, w)
        want = onehot.delivery_reduce_plain(idx, d, val, applied, mask, seen, w)
        assert all(equal(x, y) for x, y in zip(got, want)), f"delivery_reduce differs at {(r, m, w)}"
        for wk in (32, 64):
            oo = torch.randint(0, 1 << 32, (wk // 32, r, w), generator=g).to(device)
            adv_m = torch.randint(0, 70, (r, m), generator=g).to(device)
            dd = torch.randint(0, 140, (r, m), generator=g).to(device)
            got = onehot.window_delivery(oo, idx, dd, adv_m, mask, wk, w)
            want = onehot.window_delivery_plain(oo, idx, dd, adv_m, mask, wk, w)
            assert all(equal(x, y) for x, y in zip(got, want)), f"window_delivery differs at {(r, m, w, wk)}"
    # The row gathers' forms: odd m (scalar pair tails), odd W, row counts
    # off the tiles, m at the form rule's threshold (W/2) and one either
    # side, W = 10,000 and 16,384.
    for r, m, w in GATHER_EDGES:
        table = torch.randint(0, 1 << 32, (r, w), generator=g).to(device)
        flat = torch.randint(-3, w + 3, (r * m + 1,), generator=g).to(device)
        check_gathers(onehot, table, flat[:-1].view(r, m), f"{(r, m, w)}")
        # A view at an odd storage offset: idx not 16-byte aligned.
        check_gathers(onehot, table, flat[1:].view(r, m), f"{(r, m, w)} offset idx")
    # table_gather: an empty table or index, widths off multiples of 128,
    # 1-D to 3-D indices past both ends; then, at W = 1, 2,048 and 100,000
    # (a table served from L2), n from 0 to 3, one block of 1,024 outputs
    # either side and several blocks and one (the pairs' scalar tail), each
    # index also at an odd storage offset (scalar index loads).
    for w, shape in (
        (0, (4, 5)), (9, (0,)), (9, (3, 0)), (1, (7,)), (37, (19, 41)),
        (2049, (64, 300)), (16_384, (24, 144)), (100_000, (3, 50, 200)),
    ):
        table = torch.randint(0, 1 << 32, (w,), generator=g).to(device)
        idx = torch.randint(-w - 3, 2 * w + 3, shape, generator=g).to(device)
        assert equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx)), \
            f"table_gather differs at W={w}, idx {shape}"
    for w in (1, 2048, 100_000):
        table = torch.randint(0, 1 << 32, (w,), generator=g).to(device)
        for n in (0, 1, 2, 3, 1023, 1024, 1025, 5 * 1024 + 1):
            base = torch.randint(-w - 3, 2 * w + 3, (n + 1,), generator=g).to(device)
            for at, idx in (("aligned", base[:n]), ("odd offset", base[1:])):
                assert equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx)), \
                    f"table_gather differs at W={w}, n={n}, {at} idx"
    # 2-D indices at the adaptive plane's widths: at an odd storage offset
    # (scalar index loads), and a non-contiguous view, which the operator
    # refuses (its contiguous copy gathers).
    for w, r, m in ((512, 1001, 144), (512, 999, 48), (16, 301, 64), (16, 3, 16)):
        table = torch.randint(0, 1 << 32, (w,), generator=g).to(device)
        flat = torch.randint(-w - 3, 2 * w + 3, (r * m + 1,), generator=g).to(device)
        for at, idx in (("aligned", flat[:-1].view(r, m)), ("odd offset", flat[1:].view(r, m))):
            assert equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx)), \
                f"table_gather differs at W={w}, idx [{r},{m}] {at}"
        strided = flat[: r * (m // 2) * 2].view(r, -1)[:, ::2]
        try:
            onehot.table_gather(table, strided)
        except ValueError:
            pass
        else:
            raise AssertionError("table_gather took a non-contiguous index")
        assert equal(onehot.table_gather(table, strided.contiguous()),
                     onehot.table_gather_plain(table, strided)), f"table_gather differs at W={w}, strided"
    torch.cuda.synchronize()
    split.s["equality checks"] += time.perf_counter() - t_edges
    log("phase 3: edge cases equal (0-width axes, out-of-range, bit 31, wk 32/64, "
        "W 10,000 and 16,384; every gather form and semantics, row stride 0 and M, "
        "odd m and W, offset idx; table_gather W 0 to 100,000, n 0-3, one block +-1, "
        "several blocks + 1, odd-offset idx, 2-D odd-offset idx, non-contiguous idx refused)")

    out = []

    def measure(name, path, shape, inputs, kernel, plain, library, args, **extra):
        """Exact equality of ``kernel(*inputs)`` and ``plain(*inputs)``, then
        the times of both, of ``library`` and of each ``extra`` function
        (``run_ms``); the bound is the cost model's formula
        (``costs.kernel_cost``) for the kernel-bearing function ``name``
        called on ``args``: each input read once, the table words a gather
        addresses, the outputs written once, at int64 (``bound``) and at
        the reference's u32 (``bound_u32``, informational)."""
        with split.part("equality checks"):
            got, want = kernel(*inputs), plain(*inputs)
            err = max_abs_err(got, want)
        assert err == 0, f"{name} differs from its plain version at {path} {shape}"
        outs = got if isinstance(got, tuple) else (got,)
        del got, want
        moved, ops = costs.kernel_cost(name, args, outs)
        moved_u32 = costs.kernel_cost(name, args, outs, int64_as=4)[0]
        fns = {"ms": kernel, "plain_ms": plain, **extra}
        if library is not None:
            fns["library_ms"] = library
        times = run_ms(fns, inputs, moved, split)
        times.setdefault("library_ms", None)
        out.append(dict(name=name, path=path, shape=shape, err=err,
                        bound=bound(moved, ops), bound_u32=bound(moved_u32, ops), **times))

    def rowmax_case(path, n, kk, k):
        idx, val, mask = _inputs(g, n, kk, k, device)
        idx = idx.clamp(0, k - 1)  # merge keys are always in range
        val = val & ((1 << 26) - 1)  # packed (cl << 24 | col_version) words
        safe = torch.where(mask, idx, k)
        zeros = torch.zeros((n, k + 1), dtype=torch.int64, device=device)
        measure(
            "rowmax", path, f"[{n},{kk}]->[{n},{k}]", (idx, val, mask, safe, zeros),
            lambda idx, val, mask, safe, zeros: onehot.rowmax(idx, val, mask, k),
            lambda idx, val, mask, safe, zeros: onehot.rowmax_plain(idx, val, mask, k),
            # amax is idempotent, so repeating it in place times the call alone.
            lambda idx, val, mask, safe, zeros: zeros.scatter_reduce_(1, safe, val, "amax"),
            (idx, val, mask, k),
        )
        return idx

    def gather_case(path, site, table, gidx, wide=False):
        """One row gather at ``site``; ``gidx`` 1-D is one column list
        broadcast over every row (row stride 0, as ``visibility`` passes
        it). The bound reads only the table words the gather addresses."""
        r, w = table.shape
        m = gidx.shape[-1]
        full = gidx.expand(r, m)
        name = "rowgather_wide" if wide else "rowgather"
        kern = onehot.rowgather_wide if wide else onehot.rowgather
        plain = onehot.rowgather_wide_plain if wide else onehot.rowgather_plain
        # Each form forced through the operator (``onehot._gather``), each
        # exact as well; the kernel's own entry is the public wrapper, in the
        # form the rule picks.
        forms = {}
        with split.part("equality checks"):
            want = plain(table, full)
            for f in onehot.GATHER_FORMS:
                got = onehot._gather(name, table, full, wide, f)
                assert equal(got, want), f"{name} {f} differs at {site}"
                forms[f"{f}_ms"] = lambda t, i, f=f: onehot._gather(name, t, i.expand(r, m), wide, f)
            del want, got
        measure(
            name, path, f"{site} [{r},{w}]<-"
            + (f"[{m}] broadcast" if gidx.dim() == 1 else f"[{r},{m}]")
            + f" ({onehot.gather_form(w, m, gidx.dim() == 1)})",
            (table, gidx),
            lambda t, i: kern(t, i.expand(r, m)),
            lambda t, i: plain(t, i.expand(r, m)),
            # Every index is in range, so gather on it needs no mask or clip.
            lambda t, i: torch.gather(t, 1, i.expand(r, m)),
            (table, full),
            **forms,
        )

    def u24(*shape):
        return torch.randint(0, 1 << 24, shape, generator=g).to(device)

    def sorted_idx(r, budget, w):
        # A grant enumeration's columns: ascending along each row.
        return torch.sort(torch.randint(0, w, (r, budget), generator=g).to(device), dim=1).values

    def reduce_case(path, n, kk, w, d_hi, v_hi, **extra_fns):
        widx = torch.randint(0, w, (n, kk), generator=g).to(device)
        d = torch.randint(0, d_hi, (n, kk), generator=g).to(device)
        v = torch.randint(0, v_hi, (n, kk), generator=g).to(device)
        valid = torch.rand((n, kk), generator=g).to(device) < 0.8
        applied = valid & (d < d_hi // 10)
        seen = torch.randint(0, v_hi, (n, w), generator=g).to(device)
        measure(
            "delivery_reduce", path, f"[{n},{kk}]x5,[{n},{w}]->2x[{n},{w}]",
            (widx, d, v, applied, valid, seen),
            lambda *a: onehot.delivery_reduce(*a, w),
            lambda *a: onehot.delivery_reduce_plain(*a, w),
            None,
            (widx, d, v, applied, valid, seen, w),
            **extra_fns,
        )
        return widx, d, valid

    def fast_path(path, n, kk, w, k, samples, r_sync, budget):
        """The fast delivery path's kernels at one path's shapes: the CRDT
        merge's rowmax, every rowgather site, the delivery reductions and
        the window."""
        idx = rowmax_case(path, n, kk, k)
        gather_case(path, "base gather", u24(n, w), torch.randint(0, w, (n, kk), generator=g).to(device))
        gather_case(path, "CRDT winner check", u24(n, k), idx)
        gather_case(path, "sync grants", u24(r_sync, w), sorted_idx(r_sync, budget, w))
        gather_case(path, "visibility", u24(n, w), torch.randint(0, w, (samples,), generator=g).to(device))
        window_case(path, n, kk, w)

    def window_case(path, n, kk, w):
        """The delivery reductions and the window at one path's shapes."""
        widx, d, valid = reduce_case(path, n, kk, w, 40, 1 << 20)
        oo = torch.randint(0, 1 << 32, (1, n, w), generator=g).to(device)
        adv_m = torch.randint(0, 8, (n, kk), generator=g).to(device)
        measure(
            "window_delivery", path, f"[1,{n},{w}],[{n},{kk}]x4->[{n},{kk}],[1,{n},{w}]",
            (oo, widx, d, adv_m, valid),
            lambda *a: onehot.window_delivery(*a, 32, w),
            lambda *a: onehot.window_delivery_plain(*a, 32, w),
            None,
            (oo, widx, d, adv_m, valid, 32, w),
        )

    def table_case(path, site, table, tidx):
        measure(
            "table_gather", path, f"{site} [{table.shape[0]}]<-{list(tidx.shape)}", (table, tidx),
            onehot.table_gather, onehot.table_gather_plain,
            # The index is already in range, so take on it needs no clip.
            torch.take,
            (table, tidx),
            # A copy of the index: the same bytes read and written, no gather.
            clone_ms=lambda table, tidx: tidx.clone(),
        )

    # wan_100k: N=100,000 rows, kk=144 messages, W=512 writers, K=256 cells,
    # S=128 samples, sync cohort 16,667 rows (interval 6) with budget 512.
    fast_path("wan_100k", 100_000, 144, 512, 256, 128, 16_667, 512)

    # merge_10k: N = W = 10,000 rows and writers, kk = 144 messages,
    # K = 1,024 cells, S = 256 samples, sync cohort R = 2,000 rows with
    # budget 512.
    n, kk, w, k, r_sync, budget = 10_000, 144, 10_000, 1024, 2_000, 512
    idx = rowmax_case("merge_10k", n, kk, k)
    gather_case("merge_10k", "CRDT winner check", torch.randint(0, 1 << 26, (n, k), generator=g).to(device), idx)
    gather_case("merge_10k", "sync grants", u24(r_sync, w), sorted_idx(r_sync, budget, w))
    gather_case("merge_10k", "visibility", u24(n, w), torch.randint(0, w, (256,), generator=g).to(device))

    # The legacy contig_run/seen reductions, and the two-rowmax form of the
    # same function (two launches and a max pass) timed beside them.
    def two_rowmax(widx, d, v, applied, valid, seen):
        return (onehot.rowmax(widx, d, applied, w),
                torch.maximum(seen, onehot.rowmax(widx, v, valid, w)))

    reduce_case("merge_10k", n, kk, w, 1 << 20, 1 << 20, two_rowmax_ms=two_rowmax)

    # The legacy base gather (and the window's word reads, same shape).
    widx = torch.randint(0, w, (n, kk), generator=g).to(device)
    gather_case("merge_10k", "legacy base gather", u24(n, w), widx, wide=True)

    # The legacy window assembly: one power of two per admitted message.
    def rowsum_case(path, widx, w):
        n, kk = widx.shape
        bits = torch.where(
            torch.rand((n, kk), generator=g).to(device) < 0.5,
            1 << torch.randint(0, 32, (n, kk), generator=g).to(device), 0,
        )
        measure(
            "rowsum", path, f"[{n},{kk}]->[{n},{w}]", (widx, bits),
            lambda widx, bits: onehot.rowsum(widx, bits, None, w),
            lambda widx, bits: onehot.rowsum_plain(widx, bits, None, w),
            # No one PyTorch call makes a fresh zero-filled plane holding the
            # sums: the two-call composition is timed beside it.
            None,
            (widx, bits, None, w),
            zeros_scatter_add_ms=lambda widx, bits: torch.zeros(
                (n, w), dtype=torch.int64, device=device).scatter_add_(1, widx, bits),
        )

    rowsum_case("merge_10k", widx, w)
    del widx, idx

    # anywrite_sparse: N = 100,000 rows, kk = 320 messages (fanout 5 x queue
    # 64), W = 2,048 hot slots, K = 256 cells, S = 256 samples, sync cohort
    # 16,667 rows with budget 512. The fast path's kernels, cold_sync's
    # grant gathers ([N, k_dev = 256] deviation tables, 64 units a node),
    # then table_gather: the grant enumeration maps each granted unit's slot
    # to its global writer, rotate maps every queue entry's slot through the
    # reset-slot mask.
    w_hot, r_sync, n, q = 2048, 16_667, 100_000, 64
    fast_path("anywrite_sparse", n, 5 * q, w_hot, 256, 256, r_sync, budget)
    gather_case("anywrite_sparse", "cold_sync grants", u24(n, 256), sorted_idx(n, 64, 256))
    table_case("anywrite_sparse", "sync grants", torch.randint(0, n, (w_hot,), generator=g).to(device),
               sorted_idx(r_sync, budget, w_hot))
    table_case("anywrite_sparse", "rotate",
               (torch.rand((w_hot,), generator=g) < 0.4).to(torch.int64).to(device),
               torch.randint(0, w_hot, (n, q), generator=g).to(device))

    # wan_100k_adaptive (its other sites are wan_100k's): the intake
    # priority reads the head of each delivered copy's writer (the sorted
    # writer column, [N, kk = 144]), the saturation test each queue
    # entry's ([N, Q = 48], twice a round), the rumor kill each copy's
    # receiver watermark.
    n, w, kk, q = 100_000, 512, 144, 48
    heads = torch.randint(0, 1 << 20, (w,), generator=g).to(device)
    table_case("wan_100k_adaptive", "intake priority", heads, sorted_idx(n, kk, w))
    table_case("wan_100k_adaptive", "queue saturation", heads,
               torch.randint(0, w, (n, q), generator=g).to(device))
    gather_case("wan_100k_adaptive", "rumor-kill watermarks", u24(n, w),
                torch.randint(0, w, (n, kk), generator=g).to(device))

    # geo_10k: N = 10,000 rows, W = 16 writers, kk = 64 messages (fanout
    # 2+2 x queue 16), S = 64 samples, no cells (no rowmax, no grant
    # gathers); the base gather and the kill's watermark lookup share a
    # shape.
    n, w, kk, q = 10_000, 16, 64, 16
    gather_case("geo_10k", "base gather, rumor-kill watermarks", u24(n, w),
                torch.randint(0, w, (n, kk), generator=g).to(device))
    gather_case("geo_10k", "visibility", u24(n, w), torch.randint(0, w, (64,), generator=g).to(device))
    window_case("geo_10k", n, kk, w)
    heads = torch.randint(0, 1 << 10, (w,), generator=g).to(device)
    table_case("geo_10k", "intake priority", heads, sorted_idx(n, kk, w))
    table_case("geo_10k", "queue saturation", heads, torch.randint(0, w, (n, q), generator=g).to(device))
    # mixed_storm: N = 1,000 rows, W = 64 writers, kk = 64 messages (fanout
    # 2+2 x queue 16), K = 512 cells, S = 256 samples, sync cohort 125 rows
    # (interval 8) with budget 512: the fast path's kernels; then the CRDT
    # merge of the sync sessions ([125, 512] grants) and the admission of
    # each reassembled big version, one column a stream ([1000, 1], 16
    # times a round); then the adaptive mixed run's table_gather sites at
    # its n = 64 (phase 4).
    n, kk, w, k = 1000, 64, 64, 512
    fast_path("mixed_storm", n, kk, w, k, 256, 125, 512)
    idx = rowmax_case("mixed_storm", 125, 512, k)
    gather_case("mixed_storm", "sync CRDT winner check", u24(125, k), idx)
    idx = rowmax_case("mixed_storm", n, 1, k)
    gather_case("mixed_storm", "admission CRDT winner check", u24(n, k), idx)
    heads = torch.randint(0, 1 << 10, (w,), generator=g).to(device)
    table_case("mixed_storm", "adaptive n=64 intake priority", heads, sorted_idx(64, kk, w))
    table_case("mixed_storm", "adaptive n=64 queue saturation", heads,
               torch.randint(0, w, (64, 16), generator=g).to(device))
    del idx, heads

    # The shard bodies of phase 13, one row block a position (the sync
    # grants, visibility and rotate run whole, at their paths' shapes):
    # wan_100k on 4 positions, [25,000, 144] a body over 512 writers and
    # 256 cells; anywrite_sparse n=2000 on 4, [500, 320] over 56 hot
    # slots and 256 cells, with rotate's table_gather at [2000, 64];
    # the merge_10k burst n=2560 on 2, [1280, 144] over 2,560 writers and
    # 1,024 cells (the legacy delivery); the elastic drills' dense wan
    # workload n=64 on 8, [8, 144] over 16 writers and 256 cells.
    for path, n, kk, w, k in (("wan_100k_sharded", 25_000, 144, 512, 256),
                              ("anywrite_sparse_sharded", 500, 320, 56, 256),
                              ("elastic", 8, 144, 16, 256)):
        idx = rowmax_case(path, n, kk, k)
        gather_case(path, "base gather", u24(n, w), torch.randint(0, w, (n, kk), generator=g).to(device))
        gather_case(path, "CRDT winner check", u24(n, k), idx)
        window_case(path, n, kk, w)
    table_case("anywrite_sparse_sharded", "rotate",
               (torch.rand((56,), generator=g) < 0.4).to(torch.int64).to(device),
               torch.randint(0, 56, (2000, 64), generator=g).to(device))
    # The sparse drill's rotate: 8 hot slots, n=64, queue 64.
    table_case("elastic", "rotate", (torch.rand((8,), generator=g) < 0.4).to(torch.int64).to(device),
               torch.randint(0, 8, (64, 64), generator=g).to(device))
    n, kk, w, k = 1280, 144, 2560, 1024
    idx = rowmax_case("merge_10k_sharded", n, kk, k)
    gather_case("merge_10k_sharded", "CRDT winner check", u24(n, k), idx)
    reduce_case("merge_10k_sharded", n, kk, w, 1 << 20, 1 << 20)
    widx = torch.randint(0, w, (n, kk), generator=g).to(device)
    gather_case("merge_10k_sharded", "legacy base gather", u24(n, w), widx, wide=True)
    rowsum_case("merge_10k_sharded", widx, w)
    del idx, widx
    for row in out:
        times = ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("ms") and v is not None
        )
        lib_host = row.get("library_host_ms")
        log(f"phase 3: {row['name']} {row['path']} {row['shape']} equal; host ms a call "
            f"{row['host_ms']:.4f} (library {'—' if lib_host is None else f'{lib_host:.4f}'}); "
            f"{times}; device events {row['device_events']}; bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}), at u32 {row['bound_u32'][0]:.4f}")
    log(f"phase 3: split {split.line()}")
    return out


# ---- phase 4/5: the engine --------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _burst(sched, schedule_cls):
    """Two versions per writer per round for rounds 0-11: enough out-of-
    order arrivals to open the legacy window (merge_10k's 1% rate alone
    leaves it shut at small sizes)."""
    writes = sched.writes.copy()
    writes[:12, :] = 2
    return schedule_cls(writes=writes).make_samples(256)


def _wiped(sched, schedule_cls):
    """The same churn schedule with every kill a crash-with-state-wipe."""
    return schedule_cls(
        writes=sched.writes, kill=sched.kill, revive=sched.revive,
        wipe=sched.kill.copy(), sample_writer=sched.sample_writer,
        sample_ver=sched.sample_ver, sample_round=sched.sample_round,
    )


def _chunk_faults(rounds, origin):
    """Loss, a node that stays down, and a wipe that spares the origins."""
    from corrosion_tpu_torch.sim import faults

    spared = set(origin.tolist())
    victims = tuple(x for x in range(5, 40) if x not in spared)[:6]
    return faults.FaultPlan(rounds, (
        faults.Fault("loss", 10, 40, prob=0.4),
        faults.Fault("churn", 12, 13, nodes=victims, revive_at=30, wipe=True),
        faults.Fault("churn", 15, 16, nodes=(victims[-1] + 1,)),
    ))


def _mixed_churn(sched, n_nodes):
    """A kill/revive/wipe schedule that spares the streams' origin nodes
    (0 and 1), with receiver loss on region 0."""
    from corrosion_tpu_torch.sim import faults

    plan = faults.FaultPlan(sched.rounds, (
        faults.Fault("churn", 6, 7, nodes=(5, 6, 20), revive_at=14, wipe=True),
        faults.Fault("churn", 4, 5, nodes=(40,)),
        faults.Fault("loss", 3, 11, prob=0.5, regions=(0,)),
    ))
    return faults.apply_plan(sched, plan, n_nodes, 4)


# Fewer hot slots (56) than an epoch's writers need under a partition:
# forced demotions, deviation entries and cold healing.
SPARSE_SMALL = dict(n=2000, w_hot=56, rounds=64, n_regions=4, epoch_rounds=8,
                    cohort=32, k_dev=96, partition=True, samples=64)
CHUNK_SMALL = dict(n=48, streams=4, last_seq=2047, rounds=120)
MIXED_SMALL = dict(n=64, streams=2, last_seq=255, rounds=24, samples=16)
SMALL_RUNS = (
    # (label, builder, builder kwargs, schedule transform, chunk, gossip
    # fields set with health.with_adaptive (None: the builder's config),
    # ops.gossip module settings for the run)
    ("wan_100k n=2000", "wan_100k", dict(n=2000, n_regions=4, n_writers=64, rounds=72), None, 24,
     None, {}),
    ("three_node", "three_node", {}, None, None, None, {}),
    ("churn_32", "churn_32", {}, None, 100, None, {}),
    ("churn_32 wipe", "churn_32", {}, _wiped, 100, None, {}),
    ("anti_entropy_1k", "anti_entropy_1k", {}, None, 50, None, {}),
    ("merge_10k burst n=2560", "merge_10k", dict(n=2560, rounds=48), _burst, 24, None, {}),
    ("anywrite_sparse n=2000", "anywrite_sparse", SPARSE_SMALL, None, None, None, {}),
    # The adaptive plane: sketch scoring forced (the escalated pull scores
    # exactly below _EXACT_SCORE_MAX at this size), the legacy delivery, the
    # geo scenario with its propagation curves, and the sparse engine.
    ("wan_100k adaptive sketch n=2000", "wan_100k", dict(n=2000, rounds=48), None, 24,
     dict(sync_sketch_buckets=8), {"_EXACT_SCORE_MAX": 0}),
    ("merge_10k burst adaptive n=2560", "merge_10k", dict(n=2560, rounds=24), _burst, 12, {}, {}),
    ("geo churned_demo_cluster adaptive n=96", "churned_demo_cluster",
     dict(nodes=96, rounds=48, geo=True, adaptive=True), None, None, None, {}),
    ("anywrite_sparse adaptive prop n=2000", "anywrite_sparse", SPARSE_SMALL, None, None,
     dict(prop_observe=True), {}),
    # The chunk plane and the mixed engine: plain and under faults, the
    # mixed storm without and with cells, and its adaptive twin (the
    # reference's test_mixed_engine_adaptive_counters_and_conservation).
    ("anti_entropy_chunks n=48", "anti_entropy_chunks", CHUNK_SMALL, None, 40, None, {}),
    ("anti_entropy_chunks n=48 faults", "anti_entropy_chunks", CHUNK_SMALL, _chunk_faults, None,
     None, {}),
    ("mixed_storm n=64 no cells", "mixed_storm", dict(MIXED_SMALL, n_cells=0), None, None, None,
     {}),
    ("mixed_storm n=64", "mixed_storm", MIXED_SMALL, None, 10, None, {}),
    ("mixed_storm n=64 churn", "mixed_storm", MIXED_SMALL, _mixed_churn, None, None, {}),
    ("mixed_storm n=64 adaptive prop", "mixed_storm", dict(MIXED_SMALL, n_cells=0), None, None,
     dict(prop_observe=True), {}),
)


def _small_run(builder, kw, transform, chunk, adapt, dev):
    """One small run on ``dev``: its flattened final state, curves and
    info (the sparse engine's, without the resume point; the chunk
    engine's metrics; {} otherwise)."""
    from corrosion_tpu_torch import interop
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import chunk_engine, engine, health, mixed_engine, sparse_engine

    if builder == "anti_entropy_chunks":
        ccfg, origin, last, rounds = baselines.anti_entropy_chunks(device=dev, **kw)
        plan = None if transform is None else transform(rounds, origin.cpu())
        state, m = chunk_engine.simulate_chunks(
            ccfg, origin, last, rounds, seed=0, max_chunk=chunk, faults=plan, device=dev
        )
        flat = _flat(interop.to_numpy(state))
        flat["vis"] = m.pop("vis").cpu().numpy()
        curves = m.pop("curves")
        return flat, curves, m, rounds
    if builder == "mixed_storm":
        cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device=dev, **kw)
        if adapt is not None:
            cfg = health.with_adaptive(cfg, **adapt)
        if transform is not None:
            sched = transform(sched, cfg.n_nodes)
        final, curves = mixed_engine.simulate_mixed(
            cfg, ccfg, topo, sched, spec, seed=0, max_chunk=chunk, device=dev
        )
        return _flat(interop.to_numpy(final)), curves, {}, sched.rounds
    if builder == "churned_demo_cluster":
        cfg, topo, sched, _ = health.churned_demo_cluster(device=dev, **kw)
    else:
        cfg, topo, sched = getattr(baselines, builder)(device=dev, **kw)
    if adapt is not None:
        cfg = health.with_adaptive(cfg, **adapt)
    if transform is not None:
        sched = transform(sched, engine.Schedule)
    if builder != "anywrite_sparse":
        final, curves = engine.simulate(cfg, topo, sched, seed=0, max_chunk=chunk, device=dev)
        return _flat(interop.to_numpy(final)), curves, {}, sched.rounds
    sstate, swim, vis, curves, info = sparse_engine.simulate_sparse(
        cfg, topo, sched, seed=0, device=dev
    )
    assert sparse_engine.converged_sparse(sstate)
    flat = _flat(interop.to_numpy(sstate))
    flat.update(_flat(interop.to_numpy(swim), "swim."))
    flat["vis_round"] = vis.cpu().numpy()
    info.pop("resume")
    return flat, curves, info, sched.rounds


def _with_knobs(gossip, knobs: dict, fn):
    """``fn()`` with the ``ops.gossip`` module settings ``knobs`` in force."""
    saved = {k: getattr(gossip, k) for k in knobs}
    try:
        for k, v in knobs.items():
            setattr(gossip, k, v)
        return fn()
    finally:
        for k, v in saved.items():
            setattr(gossip, k, v)


def cpu_small_runs(out: str) -> int:
    """``python3 chip_smoke.py --cpu-small-runs OUT``: every run of
    ``SMALL_RUNS`` on the CPU (the plain versions), in order, each one's
    ``_small_run`` result and its seconds, then the cost model of the four
    engines on the CPU (phase 14 holds the card's to it), pickled into
    ``OUT``. Phase 4 starts it as a worker process."""
    from corrosion_tpu_torch.obs import costs
    from corrosion_tpu_torch.ops import gossip

    runs = []
    for _, builder, kw, transform, chunk, adapt, knobs in SMALL_RUNS:
        t0 = time.perf_counter()
        run = _with_knobs(gossip, knobs,
                          lambda: _small_run(builder, kw, transform, chunk, adapt, "cpu"))
        runs.append((*run, time.perf_counter() - t0))
    t0 = time.perf_counter()
    model = costs.build_cost_model(device_counts=costs.DEVICE_COUNTS, device="cpu")
    Path(out).write_bytes(pickle.dumps(
        {"runs": runs, "cost_model": model, "cost_model_s": time.perf_counter() - t0}
    ))
    return 0


def check_small_runs(onehot, gossip) -> dict:
    """Each small run on the card (kernels) equals the CPU run (plain
    versions); the merge_10k runs launch the two wide-path kernels, the
    anywrite runs demote, heal and launch ``table_gather``, the adaptive
    runs launch ``table_gather`` and kill rumors. The CPU runs go in one
    worker process (``cpu_small_runs``, no card visible to it) while the
    card runs its side; the worker has ended before the checks, so the
    timed phases after this one have the host to themselves. Returns the
    worker's CPU cost model (phase 14)."""
    out_path = REPO / "build" / "small_runs_cpu.pkl"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.unlink(missing_ok=True)
    worker = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cpu-small-runs", str(out_path)],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    card = []
    try:
        for _, builder, kw, transform, chunk, adapt, knobs in SMALL_RUNS:
            onehot.reset_launches()
            t0 = time.perf_counter()
            out = _with_knobs(gossip, knobs,
                              lambda: _small_run(builder, kw, transform, chunk, adapt, "cuda"))
            torch.cuda.synchronize()
            card.append((*out, time.perf_counter() - t0, dict(onehot.LAUNCHES)))
        rc = worker.wait()
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    assert rc == 0, f"phase 4: the CPU side of the small runs failed (exit code {rc})"
    worker_out = pickle.loads(out_path.read_bytes())
    cpu = worker_out["runs"]
    for (label, builder, kw, transform, chunk, adapt, knobs), ra, rb in zip(SMALL_RUNS, card, cpu):
        (fa, ca, ia, rounds, ta, launches), (fb, cb, ib, _, tb) = ra, rb
        bad = [k for k in ca if not np.array_equal(ca[k], cb[k])]
        bad += [k for k in fa if not np.array_equal(fa[k], fb[k])]
        assert not bad and json.dumps(ia) == json.dumps(ib), \
            f"{label}: card run differs from the CPU run in {bad}"
        assert ca["vis_count"].sum() > 0 and ca["msgs"].sum() > 0, label
        if builder == "anti_entropy_chunks":
            # The chunk plane is plain PyTorch: no kernel of its own.
            assert not any(launches.values()), launches
            assert ca["applied_sync"].sum() > 0, label
            if transform is not None:
                assert ca["chaos_wiped"].sum() > 0 and ca["chaos_lost_msgs"].sum() > 0, label
        if builder == "mixed_storm":
            need = ("rowgather", "delivery_reduce") + (("rowmax",) if kw.get("n_cells", 1) else ())
            assert all(launches[k] > 0 for k in need), launches
            assert ca["chunks_sent"].sum() > 0 and ca["seqs_granted"].sum() > 0, label
            if transform is not None:
                assert ca["chaos_wiped"].sum() > 0, label
        if builder == "merge_10k":
            for k in ("rowgather_wide", "rowsum"):
                assert launches[k] > 0, f"{label}: {k} never launched"
        if builder == "anywrite_sparse":
            assert ia["max_dev_entries"] > 0 and ca["cold_healed"].sum() > 0, ia
            assert launches["table_gather"] > 0, launches
        if adapt is not None or kw.get("adaptive"):
            assert launches["table_gather"] > 0, launches
            assert fa["data.q_dup"].shape[1] > 0 and fa["data.q_dup"].any(), label
            if builder == "churned_demo_cluster" or adapt.get("prop_observe"):
                check_conservation(label, ca)
                assert ca["prop_rumor_kills"].sum() > 0, label
        extra = f"; info {json.dumps(ia)}; cold_healed={int(ca['cold_healed'].sum())}" if ia else ""
        log(f"phase 4: {label} ({rounds} rounds): card {ta:.1f} s == CPU (worker) "
            f"{tb:.1f} s ({len(ca)} curves, {len(fa)} state leaves); "
            f"need[-1]={int(ca['need'][-1])}{extra}; launches {json.dumps(launches)}")
    log(f"phase 4: the worker built the CPU cost model in {worker_out['cost_model_s']:.1f} s")
    return worker_out["cost_model"]


def check_tie_rules() -> None:
    """The chunk plane's tie-sensitive picks on the card equal the CPU's on
    tie-heavy inputs at the 100,000-node run's 1.6 M rows: the slot pick
    (argmax over scores on four levels), the first overlapping peer slot
    (argmax over bool) and the interval overflow (argmin over tied lengths,
    through ``insert`` into full sets)."""
    from corrosion_tpu_torch.ops import chunks, intervals

    g = torch.Generator().manual_seed(5)
    rows, cap = 1_600_000, 16
    live = torch.rand((rows, cap), generator=g) < 0.6
    u = torch.randint(0, 4, (rows, 3, cap), generator=g).to(torch.float32) / 4
    cpu = chunks._pick_slot(live, u)
    assert torch.equal(chunks._pick_slot(live.cuda(), u.cuda()).cpu(), cpu), "slot pick"
    overlap = torch.rand((rows, cap), generator=g) < 0.3
    assert torch.equal(chunks._first_overlap(overlap.cuda()).cpu(), chunks._first_overlap(overlap))
    # Full sets of 16 length-3 intervals, then an insert of another length-3
    # one: every candidate ties on length.
    starts = (torch.arange(cap) * 10)[None, :].expand(rows, cap) + torch.randint(0, 3, (rows, 1), generator=g)
    iv = intervals.IntervalSet(starts.contiguous(), (starts + 2).contiguous())
    s = torch.randint(0, 200, (rows,), generator=g)
    want = intervals.insert(iv, s, s + 2)
    got = intervals.insert(intervals.IntervalSet(iv.starts.cuda(), iv.ends.cuda()), s.cuda(), s.cuda() + 2)
    assert torch.equal(got.starts.cpu(), want.starts) and torch.equal(got.ends.cpu(), want.ends), \
        "interval overflow"
    log(f"phase 4: chunk-plane tie rules card == CPU at {rows:,} rows (slot pick, first "
        f"overlap, overflow of tied lengths)")


def check_conservation(label: str, curves: dict) -> None:
    """The propagation plane's identities, round by round: the link
    matrix's mass and useful + duplicate copies are ``msgs``, the rumor-age
    histogram's mass is ``vis_count``."""
    from corrosion_tpu_torch.sim import telemetry

    def mass(keys):
        return sum(curves[k].astype(np.int64) for k in keys)

    msgs = curves["msgs"].astype(np.int64)
    assert np.array_equal(mass(telemetry.LINK_CURVE_KEYS), msgs), f"{label}: link mass != msgs"
    assert np.array_equal(mass(("prop_useful_msgs", "prop_dup_msgs")), msgs), \
        f"{label}: useful + dup != msgs"
    assert np.array_equal(mass(telemetry.RUMOR_AGE_KEYS), curves["vis_count"].astype(np.int64)), \
        f"{label}: rumor-age mass != vis_count"


def flight_telemetry(name: str, engine: str):
    """A ``KernelTelemetry`` recording a fresh flight at ``FLIGHTS/name``
    and writing one progress line a chunk to stderr."""
    from corrosion_tpu_torch.sim import telemetry

    FLIGHTS.mkdir(parents=True, exist_ok=True)
    rec = telemetry.FlightRecorder(str(FLIGHTS / f"{name}.jsonl"), engine=engine, mode="w")
    return telemetry.KernelTelemetry(engine=engine, recorder=rec, progress=sys.stderr)


def check_flight(tele, curves: dict, phase: int, label: str, ms_per_round: float) -> None:
    """Close ``tele``'s recorder and hold its flight record to the run's
    curves, key for key and round for round; log ``device_step_ms`` beside
    the CUDA-event ms/round and the record's size."""
    from corrosion_tpu_torch.sim import telemetry

    tele.recorder.close()
    path = tele.recorder.path
    replayed, chunks = telemetry.replay_flight(path)
    rounds = len(curves["need"])
    assert set(replayed) == set(curves) | {"round"}, f"{label}: flight keys differ"
    assert list(replayed["round"]) == list(range(rounds)), f"{label}: flight rounds differ"
    bad = [k for k in curves if not np.array_equal(replayed[k], curves[k])]
    assert not bad, f"{label}: the flight record differs from the curves in {bad}"
    assert sum(c["rounds"] for c in chunks) == rounds == sum(n for n, _ in tele.chunk_walls)
    size = sum(os.path.getsize(p) for p in telemetry.flight_segments(path))
    log(f"phase {phase}: {label} flight record ({len(chunks)} chunks, {size / 2**20:.2f} MiB) "
        f"replays equal to the curves; device_step_ms {tele.device_step_ms:.1f} against "
        f"{ms_per_round:.1f} ms/round (CUDA events)")


def dense_chunks(cfg, topo, sched, chunk: int = 12, telemetry=None):
    """``engine.simulate`` over ``chunk`` rounds at a time, each call
    resuming the last (and a chunk of ``telemetry``); yields (state,
    curves, info) per call."""
    from corrosion_tpu_torch.sim import engine

    state, done = None, 0
    while done < sched.rounds:
        stop = min(done + chunk, sched.rounds)
        state, curves = engine.simulate(cfg, topo, sched.slice(done, stop), seed=0,
                                        state=state, telemetry=telemetry, device="cuda")
        done = stop
        yield state, curves, {}


def sparse_epochs(cfg, topo, sched):
    """``simulate_sparse`` one epoch at a time, each call resuming the last;
    yields (SparseState, curves, info) per epoch."""
    from corrosion_tpu_torch.sim import sparse_engine

    resume = None
    for epoch in range(-(-sched.rounds // cfg.sparse.epoch_rounds)):
        sstate, _, vis, curves, info = sparse_engine.simulate_sparse(
            cfg, topo, sched, seed=0, resume=resume, stop_after_epoch=epoch, device="cuda"
        )
        resume = info.pop("resume")  # only the latest state stays alive
        yield sstate, curves, dict(info, unseen=int((vis < 0).sum()))


def build_path(path: str):
    """(config, topology, schedule) of a full-size main path on the card."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import health

    if path == "wan_100k_adaptive":
        # The reference tests' composed_sketch tuning; prop_observe stays
        # off (20 regions exceed the plane's PROP_REGIONS = 4).
        cfg, topo, sched = baselines.wan_100k(device="cuda")
        return health.with_adaptive(cfg, sync_sketch_buckets=8), topo, sched
    return getattr(baselines, path)(device="cuda")


def full_run(onehot, gossip, phase: int, builder: str, keep: dict | None = None,
             walls: dict | None = None):
    """A main path at full size, every round of its schedule, one call per
    chunk (dense engine) or epoch (sparse engine), with the launch counts
    reset just before and read just after. ``keep`` takes the state, the
    curves and the CUDA-event ms after ``SHARDED_ROUNDS`` rounds; ``walls``
    the run's wall seconds under ``builder``."""
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import sparse_engine

    cfg, topo, sched = build_path(builder)
    sparse = builder == "anywrite_sparse"
    # wan_100k carries the flight recorder: one chunk a 12-round call.
    tele = flight_telemetry(builder, "dense") if builder == "wan_100k" else None
    if sparse:
        chunks = sparse_epochs(cfg, topo, sched)
    else:
        chunks = dense_chunks(cfg, topo, sched, telemetry=tele)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    parts, infos, done, elapsed = [], [], 0, 0.0
    t_wall = time.perf_counter()
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step = next(chunks, None)
        if step is None:
            break
        b.record()
        b.synchronize()
        state, curves, info = step
        ms, rounds = a.elapsed_time(b), len(curves["need"])
        elapsed += ms
        parts.append(curves)
        infos.append(info)
        log(f"phase {phase}: rounds {done}-{done + rounds - 1}: {ms / rounds:.1f} ms/round"
            + "".join(f", {k} {v}" for k, v in info.items()))
        done += rounds
        if keep is not None and done == SHARDED_ROUNDS:
            # Held on the host, so the later phases' peaks stay their own.
            keep.update(state=mesh_mod.to_host(state), ms=elapsed,
                        curves={k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    wall = time.perf_counter() - t_wall
    if walls is not None:
        walls[builder] = wall
    launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    assert done == sched.rounds
    d = state.data
    assert bool((d.contig <= d.head[None, :]).all()), "contig > head"
    assert bool((d.seen >= d.contig).all()), "seen < contig"
    for k in ("need", "staleness_sum", "msgs"):
        assert np.isfinite(curves[k].astype(np.float64)).all()
    assert curves["msgs"].sum() > 0 and curves["vis_count"].sum() > 0
    missing = [k for k in PATH_KERNELS[builder] if launches[k] == 0]
    assert not missing, f"{builder}: kernels never launched on its path: {missing}"
    peak = torch.cuda.max_memory_allocated()
    log(f"phase {phase}: {builder} N={cfg.n_nodes} W={cfg.gossip.n_writers} "
        f"{done} rounds: {elapsed / done:.1f} ms/round (CUDA events), "
        f"wall {wall:.1f} s, peak memory {peak / 2**30:.2f} GiB")
    if tele is not None:
        check_flight(tele, curves, phase, builder, elapsed / done)
    if sparse:
        assert sum(i["dev_dropped"] for i in infos) == 0, "deviation entries dropped"
        assert sparse_engine.converged_sparse(state), "anywrite_sparse did not converge"
        conv = np.nonzero(curves["need"] != 0)[0]
        log(f"phase {phase}: converged (need 0 from round "
            f"{int(conv[-1]) + 1 if len(conv) else 0}), unseen sample pairs "
            f"{infos[-1]['unseen']}, retired {sum(i['retired'] for i in infos)}, promoted "
            f"{sum(i['promoted'] for i in infos)}, max dev entries "
            f"{max(i['max_dev_entries'] for i in infos)}, cold_healed "
            f"{int(curves['cold_healed'].sum())}")
    log(f"phase {phase}: launches {json.dumps(launches)}; host syncs {json.dumps(syncs)}")
    log(f"phase {phase}: need[-1]={int(curves['need'][-1])} "
        f"vis_count={int(curves['vis_count'].sum())} msgs={int(curves['msgs'].sum())}")
    return launches


def geo_run(onehot, gossip, phase: int = 9) -> dict:
    """The geo epidemic scenario at 10,000 nodes, push-only then adaptive,
    each in one call: every round completes, the watermark invariants and
    the propagation identities hold on the card's curves, the adaptive
    run kills rumors. The launch counts are reset before the pair and read
    after it. Returns them."""
    from corrosion_tpu_torch.sim import engine, health

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    copies = {}
    for adaptive in (False, True):
        label = "adaptive" if adaptive else "push"
        cfg, topo, sched, kill_rounds = health.churned_demo_cluster(
            nodes=10_000, rounds=64, samples=64, geo=True, adaptive=adaptive, device="cuda"
        )
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        final, curves = engine.simulate(cfg, topo, sched, seed=0, device="cuda")
        b.record()
        b.synchronize()
        d = final.data
        assert len(curves["msgs"]) == sched.rounds
        assert bool((d.contig <= d.head[None, :]).all()), f"{label}: contig > head"
        assert bool((d.seen >= d.contig).all()), f"{label}: seen < contig"
        assert curves["msgs"].sum() > 0 and curves["vis_count"].sum() > 0, label
        check_conservation(f"geo_10k {label}", curves)
        kills = int(curves["prop_rumor_kills"].sum())
        pulls = int(curves["prop_pull_rounds"].sum())
        assert kills > 0 if adaptive else kills == pulls == 0, (label, kills, pulls)
        # The data plane's convergence: need stays 0 from this round on.
        lagging = np.nonzero(curves["need"] != 0)[0]
        converged = int(lagging[-1]) + 1 if len(lagging) else 0
        msgs = int(curves["msgs"].astype(np.int64).sum())
        copies[label] = msgs
        log(f"phase {phase}: geo_10k {label} N={cfg.n_nodes} W={cfg.gossip.n_writers} "
            f"{sched.rounds} rounds (kill/revive of {int(sched.kill.sum())} nodes at round "
            f"{kill_rounds[0]}): {a.elapsed_time(b) / sched.rounds:.1f} ms/round (CUDA events); "
            f"delivered copies {msgs}, useful {int(curves['prop_useful_msgs'].sum())}, "
            f"duplicate {int(curves['prop_dup_msgs'].sum())}; peak queue_backlog "
            f"{int(curves['queue_backlog'].max())} ({curves['queue_backlog'].max() / cfg.n_nodes:.2f} "
            f"a node); rumor kills {kills}, pull rounds {pulls}; "
            + (f"need 0 from round {converged}" if converged < sched.rounds
               else "need not 0 by the last round")
            + f"; SWIM mismatches in the last round {int(curves['mismatches'][-1])}")
    launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["geo_10k"] if launches[k] == 0]
    assert not missing, f"geo_10k: kernels never launched on its path: {missing}"
    log(f"phase {phase}: geo_10k delivered copies push {copies['push']} -> adaptive "
        f"{copies['adaptive']} ({copies['adaptive'] / copies['push']:.3f}x); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase {phase}: launches {json.dumps(launches)}; host syncs {json.dumps(dict(gossip.HOST_SYNCS))}")
    return launches


def check_intervals(have, last_seq, n_streams: int) -> None:
    """The interval invariants of a final chunk state, every row: live slots
    first, sorted, disjoint and non-adjacent, inside [0, last_seq]; empty
    slots hold (EMPTY, EMPTY - 1)."""
    from corrosion_tpu_torch.ops import intervals

    s, e = have.starts, have.ends
    live = s <= e
    assert bool((live[:, :-1] | ~live[:, 1:]).all()), "an empty slot before a live one"
    assert bool(((s[:, 1:] > e[:, :-1] + 1) | ~live[:, 1:]).all()), "slots overlap, touch or unsorted"
    row_last = last_seq[torch.arange(s.shape[0], device=s.device) % n_streams][:, None]
    assert bool(((s >= 0) & (e <= row_last) | ~live).all()), "a slot outside [0, last_seq]"
    assert bool(((s == intervals.EMPTY) & (e == intervals.EMPTY - 1) | live).all()), "a bad empty slot"


def chunk_runs(onehot, gossip, phase: int = 10) -> dict:
    """``anti_entropy_chunks()`` at the reference's size (1,000 nodes, 16
    streams of 8,192 seqs, 240 rounds: converged) and at 100,000 nodes
    (1.6 M (node, stream) rows, ``CHUNK_100K_ROUNDS`` rounds: the interval
    invariants, reassembly that never falls), 24 rounds a call, each call
    resuming the last. The
    launch counts are reset before the pair and read after it (the plane
    launches no kernel). Returns them."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import chunk_engine

    onehot.reset_launches()
    for n in (1000, 100_000):
        cfg, origin, last, rounds = baselines.anti_entropy_chunks(n=n, device="cuda")
        if n == 100_000:
            rounds = CHUNK_100K_ROUNDS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gossip.reset_host_syncs()
        state = vis = None
        parts, elapsed = [], 0.0
        tele = flight_telemetry("anti_entropy_chunks", "chunk") if n == 1000 else None
        for r0 in range(0, rounds, 24):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = chunk_engine.simulate_chunks(
                cfg, origin, last, min(24, rounds - r0), seed=0, state=state, vis=vis,
                start_round=r0, telemetry=tele, device="cuda",
            )
            b.record()
            b.synchronize()
            vis = m["vis"]
            parts.append(m["curves"])
            elapsed += a.elapsed_time(b)
        curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        peak = torch.cuda.max_memory_allocated()
        applied = curves["streams_applied"].astype(np.int64)
        assert len(applied) == rounds and np.isfinite(curves["need"]).all()
        assert (np.diff(applied) >= 0).all(), "streams_applied fell without a wipe"
        check_intervals(state.have, last, cfg.n_streams)
        if n == 1000:
            assert m["unapplied"] == 0, f"anti_entropy_chunks did not converge: {m['unapplied']}"
        lagging = np.nonzero(curves["need"] != 0)[0]
        done = int(lagging[-1]) + 1 if len(lagging) else 0
        log(f"phase {phase}: anti_entropy_chunks N={n} S={cfg.n_streams} last_seq="
            f"{int(last[0])} ({cfg.rows:,} rows) {rounds} rounds: {elapsed / rounds:.1f} ms/round "
            f"(CUDA events), peak memory {peak / 2**30:.2f} GiB, host syncs a round "
            f"{sum(gossip.HOST_SYNCS.values()) / rounds:.2f} (branches; plus one curve copy a "
            f"24-round call); applied_frac {m['applied_frac']:.6f}, unapplied {m['unapplied']}, "
            f"p50 {m['p50_s']:.1f} s, p99 {m['p99_s']:.1f} s, "
            + (f"need 0 from round {done}" if done < rounds else f"need[-1] {curves['need'][-1]:.0f}")
            + f"; chunks sent {int(curves['msgs'].astype(np.int64).sum())}, seqs granted "
            f"{int(curves['applied_sync'].astype(np.int64).sum())}; intervals sorted, disjoint, "
            f"non-adjacent, inside [0, last_seq]")
        if tele is not None:
            check_flight(tele, curves, phase, f"anti_entropy_chunks N={n}", elapsed / rounds)
        del state, vis, m
    launches = dict(onehot.LAUNCHES)
    assert not any(launches.values()), f"the chunk plane launched kernels: {launches}"
    return launches


def mixed_run(onehot, gossip, phase: int = 11) -> dict:
    """``mixed_storm()`` at the reference's size (1,000 nodes, 64 writers,
    16 streams of 2,048 seqs, 512 cells, 200 rounds), 25 rounds a call,
    each resuming the last and a chunk of the flight recorder: converged
    on both planes, every node's cells equal to the serial-merge ground
    truth of the final heads, the fast path's four kernels launched.
    Returns the launch counts of the run."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.ops import gossip as gossip_ops
    from corrosion_tpu_torch.sim import mixed_engine

    cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    tele = flight_telemetry("mixed_storm", "mixed")
    state, parts, elapsed = None, [], 0.0
    for r0 in range(0, sched.rounds, 25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, curves = mixed_engine.simulate_mixed(
            cfg, ccfg, topo, sched.slice(r0, min(r0 + 25, sched.rounds)), spec, seed=0,
            state=state, telemetry=tele, device="cuda",
        )
        b.record()
        b.synchronize()
        elapsed += a.elapsed_time(b)
        parts.append(curves)
    launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    peak = torch.cuda.max_memory_allocated()
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    rounds, n, s = sched.rounds, cfg.n_nodes, len(spec.writer)
    d = state.data
    heads = d.head.cpu().numpy()
    assert all(heads[w] >= v for w, v in zip(spec.writer, spec.version)), "a big version lost"
    assert bool((d.contig == d.head[None, :]).all()), "contig != head"
    assert int(gossip_ops.total_need(d)) == 0, "total_need != 0"
    assert bool(state.applied_before.all()), "a stream not reassembled"
    assert int(curves["streams_applied"][-1]) == n * s and float(curves["need"][-1]) == 0.0
    assert int((state.vis_round < 0).sum()) == 0, "a sample unseen"
    assert curves["chunks_sent"].sum() > 0 and curves["seqs_granted"].sum() > 0
    t0 = time.perf_counter()
    truth = gossip_ops.serial_merge_reference(d.head, cfg.gossip)
    truth_s = time.perf_counter() - t0
    cells = gossip_ops.node_cells(d, cfg.gossip)
    for f, want in zip(cells, truth):
        assert bool((f == want[None, :]).all()), "cells differ from the serial merge"
    assert int((truth.cl > 0).sum()) > 0, "the serial merge wrote no cell"
    missing = [k for k in PATH_KERNELS["mixed_storm"] if launches[k] == 0]
    assert not missing, f"mixed_storm: kernels never launched on its path: {missing}"
    lagging = np.nonzero(curves["need"] != 0)[0]
    done = int(lagging[-1]) + 1 if len(lagging) else 0
    log(f"phase {phase}: mixed_storm N={n} W={cfg.gossip.n_writers} S={s} last_seq="
        f"{int(spec.last_seq[0])} K={cfg.gossip.n_cells} {rounds} rounds: {elapsed / rounds:.1f} "
        f"ms/round (CUDA events), peak memory {peak / 2**30:.2f} GiB; converged (need 0 from "
        f"round {done}, contig == head, every pair reassembled, every sample seen, every node's "
        f"cells equal to the serial merge of {int(d.head.sum())} versions, built in "
        f"{truth_s:.2f} s); chunks sent {int(curves['chunks_sent'].astype(np.int64).sum())}, seqs "
        f"granted {int(curves['seqs_granted'].astype(np.int64).sum())}, msgs "
        f"{int(curves['msgs'].astype(np.int64).sum())}, cell merges "
        f"{int(curves['cell_merges'].astype(np.int64).sum())}")
    check_flight(tele, curves, phase, "mixed_storm", elapsed / rounds)
    log(f"phase {phase}: launches {json.dumps(launches)} "
        f"({json.dumps({k: round(v / rounds, 2) for k, v in launches.items() if v})} a round); "
        f"host syncs {json.dumps(syncs)} ({sum(syncs.values()) / rounds:.2f} a round)")
    return launches


def _unequal(a: dict, b: dict) -> dict:
    """The top-level fields of two reports that are not exactly equal:
    (baseline, card) for a number, "differs" for a list or a dict."""
    return {
        k: "differs" if isinstance(a.get(k), (dict, list)) else [a.get(k), b.get(k)]
        for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)
    }


def consumers(onehot, phase: int = 12) -> dict:
    """The curve consumers on the card: the three committed demo flights
    held to their baselines at the reference CI's tolerance, the invariant
    suite on ``kitchen-sink`` on all four engines (card == CPU), and a
    checkpoint round trip. The launch counts are reset before the phase
    and read after it. Returns them."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.obs import epidemic
    from corrosion_tpu_torch.sim import checkpoint, engine, faults, health, invariants, telemetry

    FLIGHTS.mkdir(parents=True, exist_ok=True)
    onehot.reset_launches()
    t_phase = time.perf_counter()
    for geo, adaptive in ((False, False), (True, False), (True, True)):
        label = "adaptive" if adaptive else "geo" if geo else "flat"
        path = str(FLIGHTS / f"demo_{label}.jsonl")
        t0 = time.perf_counter()
        facts = health.record_demo_flight(path, nodes=96, rounds=48, churn=True, seed=0,
                                          geo=geo, adaptive=adaptive, device="cuda")
        wall = time.perf_counter() - t0
        _, chunks = telemetry.replay_flight(path)
        step_ms = sum(c["wall_s"] for c in chunks) / facts["rounds"] * 1000
        if not geo:
            rep = health.report_from_flight(path, kill_rounds=facts["kill_rounds"])
            base = health.load_report(str(REPO / "CONVERGENCE_BASELINE.json"))
            diff = health.diff_reports(base, rep, tolerance=0.35)
            unequal = _unequal(base.to_dict(), rep.to_dict())
            assert rep.converged, "the demo flight did not converge"
        else:
            rep = epidemic.report_from_flight(path, fanout=facts["fanout"], nodes=facts["nodes"],
                                              geo_regions=facts["regions"])
            name = "EPIDEMIC_BASELINE_ADAPTIVE.json" if adaptive else "EPIDEMIC_BASELINE.json"
            base = epidemic.load_report(str(REPO / name))
            diff = epidemic.diff_reports(base, rep, tolerance=0.35)
            unequal = _unequal(base, rep)
            assert rep["checks_ok"], rep["check_problems"]
            assert rep["fit"]["fitted"], f"{label}: the SI fit abstained"
        assert not diff["regressions"], f"{label} demo flight: {diff['regressions']}"
        log(f"phase {phase}: demo flight {label} (96 nodes, 48 rounds, churn, seed 0): {wall:.1f} "
            f"s, {step_ms:.1f} ms/round (device_step_ms); converged round "
            f"{facts['converged_round']}; diff against the baseline at 0.35 clean; fields not "
            f"exactly equal: {json.dumps(unequal, default=str)}")
    plan = faults.named_scenarios(48, invariants.STD_REGIONS, invariants.STD_NODES,
                                  protect=invariants.PROTECTED)["kitchen-sink"]
    reports, walls = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        reports[dev] = invariants.run_suite(plan, seed=0, device=dev)
        walls[dev] = time.perf_counter() - t0
    for card, cpu in zip(reports["cuda"], reports["cpu"]):
        assert card.ok, f"{card.engine}: {card.violations}"
        for k in ("facts", "violations", "recovery"):
            assert getattr(card, k) == getattr(cpu, k), f"{card.engine}: card {k} != CPU {k}"
    log(f"phase {phase}: invariant suite on kitchen-sink ({plan.describe()}): all four engines "
        f"ok, card == CPU in facts, violations and recovery (card {walls['cuda']:.1f} s, CPU "
        f"{walls['cpu']:.1f} s); recovery rounds "
        + ", ".join(f"{r.engine} {r.recovery['recovery_rounds']}" for r in reports["cuda"]))
    cfg, topo, sched = baselines.churn_32(device="cuda")
    final, _ = engine.simulate(cfg, topo, sched, seed=0, max_chunk=100, device="cuda")
    path = str(FLIGHTS / "churn_32.npz")
    checkpoint.save_state(path, final, fingerprint="churn_32")
    loaded = checkpoint.load_state(path, cfg, len(sched.sample_writer),
                                   expect_fingerprint="churn_32", device="cuda")
    flat_a, flat_b = checkpoint._flatten(final), checkpoint._flatten(loaded)
    assert [p for p, _, _ in flat_a] == [p for p, _, _ in flat_b]
    assert all(torch.equal(x, y) for (_, x, _), (_, y, _) in zip(flat_a, flat_b)), "leaves differ"
    launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["consumers"] if launches[k] == 0]
    assert not missing, f"consumers: kernels never launched: {missing}"
    log(f"phase {phase}: save_state -> load_state of churn_32 on the card: {len(flat_a)} leaves "
        f"equal under the same paths; phase {time.perf_counter() - t_phase:.1f} s; launches "
        f"{json.dumps(launches)}")
    return launches


# ---- phase 13: the shard driver and the elastic plane ------------------------


def _same_on_card(a, b) -> list:
    """Paths of the leaves where two state trees (placed or whole) differ,
    compared on the card."""
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim.checkpoint import _flatten

    fa, fb = _flatten(mesh_mod.assemble(a)), _flatten(mesh_mod.assemble(b))
    assert [p for p, _, _ in fa] == [p for p, _, _ in fb], "state trees differ in structure"
    return [p for (p, x, _), (_, y, _) in zip(fa, fb) if not torch.equal(x, y.to(x.device))]


def _curve_diff(a: dict, b: dict, skip=()) -> list:
    return [k for k in a if k not in skip and not np.array_equal(a[k], b[k])]


def _timed(fn):
    """``fn()`` between two CUDA events: (its result, ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def sharded_runs(onehot, gossip, kept: dict, phase: int = 13) -> dict:
    """The shard driver and the elastic plane on the card, each path's
    launch counts reset just before it and read just after:

    (a) full-width ``wan_100k()`` on a (2, 2) mesh of card positions,
        ``SHARDED_ROUNDS`` rounds in calls of 12: curves equal phase 5's
        first rounds (but the xshard keys), the final state equals phase
        5's at that round, the exchange bytes equal ``traffic_model``,
        each position holds the predicted bytes;
    (b) ``anywrite_sparse`` at phase 4's n=2000 on 4 positions == the
        unsharded card run;
    (c) the merge_10k burst at n=2560 (legacy delivery) on 2 positions ==
        the unsharded card run;
    (d) the elastic drills on the card (``ELASTIC_DRILLS``): each equal to
        its uninterrupted run, the preemption's recovery machinery fired,
        the budget gate's survival fields ok, each report equal to the
        CPU's.

    Returns the launch counts by path."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.elastic import report, scenarios
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.obs import epidemic
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import engine, sparse_engine
    from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

    t_phase = time.perf_counter()
    by_path = {}

    # (a) wan_100k at full width on a (2, 2) mesh.
    cfg, topo, sched = build_path("wan_100k")
    mesh = parallel.make_wan_mesh(2, 2)
    log(f"phase {phase}: {mesh!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    state, parts, elapsed = None, [], 0.0
    for r0 in range(0, SHARDED_ROUNDS, 12):
        (state, curves), ms = _timed(lambda: parallel.simulate_sharded(
            cfg, topo, sched.slice(r0, r0 + 12), mesh, seed=0, state=state
        ))
        elapsed += ms
        parts.append(curves)
    by_path["wan_100k_sharded"] = launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    peak = torch.cuda.max_memory_allocated()
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    missing = [k for k in PATH_KERNELS["wan_100k_sharded"] if launches[k] == 0]
    assert not missing, f"wan_100k sharded: kernels never launched: {missing}"
    bad = _curve_diff(kept["curves"], curves, XSHARD_CURVE_KEYS)
    assert not bad, f"wan_100k sharded: curves differ from phase 5's in {bad}"
    bad = _same_on_card(state, kept["state"])
    assert not bad, f"wan_100k sharded: final state differs from phase 5's in {bad}"
    ok, problems = epidemic.xshard_model_check(curves, cfg.gossip, mesh)
    assert ok, problems
    tm = parallel.traffic_model(cfg.gossip, mesh)
    per = parallel.per_device_state_bytes(state)
    predicted = mesh_mod.predicted_per_device_bytes(
        state, mesh_mod.cluster_state_specs(state, mesh), mesh
    )
    assert sorted(per) == list(range(mesh.size)) and set(per.values()) == {predicted}, per
    whole = sum(x.numel() * x.element_size() for x in mesh_mod.tree_leaves(mesh_mod.assemble(state)))
    log(f"phase {phase}: wan_100k N={cfg.n_nodes} on {mesh.size} positions, {SHARDED_ROUNDS} "
        f"rounds: {elapsed / SHARDED_ROUNDS:.1f} ms/round sharded against "
        f"{kept['ms'] / SHARDED_ROUNDS:.1f} unsharded (phase 5, CUDA events; all positions share "
        f"one card, so no speed claim), peak memory {peak / 2**30:.2f} GiB; curves equal phase "
        f"5's first {SHARDED_ROUNDS} rounds, final state equal leaf for leaf; exchange bytes a "
        f"round ici {curves['xshard_bytes_ici'][0]:.0f}, dcn {curves['xshard_bytes_dcn'][0]:.0f} "
        f"== traffic_model ({tm['xshard_bytes_ici']:.0f}, {tm['xshard_bytes_dcn']:.0f}); state "
        f"bytes a position {predicted} == predicted ({predicted / whole:.4f} of the whole "
        f"{whole}); launches {json.dumps(launches)}; host syncs {json.dumps(syncs)}")
    del state, parts, kept["state"]

    # (b) anywrite_sparse at n=2000 on 4 positions.
    cfg, topo, sched = baselines.anywrite_sparse(device="cuda", **SPARSE_SMALL)
    onehot.reset_launches()
    got, ms = _timed(lambda: parallel.simulate_sparse_sharded(cfg, topo, sched, mesh, seed=0))
    by_path["anywrite_sparse_sharded"] = launches = dict(onehot.LAUNCHES)
    want, ms_whole = _timed(lambda: sparse_engine.simulate_sparse(cfg, topo, sched, seed=0,
                                                                  device="cuda"))
    missing = [k for k in PATH_KERNELS["anywrite_sparse_sharded"] if launches[k] == 0]
    assert not missing, f"anywrite_sparse sharded: kernels never launched: {missing}"
    bad = _same_on_card(tuple(got[:3]), tuple(want[:3]))
    bad += _curve_diff(want[3], got[3], XSHARD_CURVE_KEYS)
    assert not bad, f"anywrite_sparse sharded differs from the unsharded card run in {bad}"
    assert {k: v for k, v in got[4].items() if k != "resume"} == \
           {k: v for k, v in want[4].items() if k != "resume"}
    ok, problems = epidemic.xshard_model_check(got[3], cfg.gossip, mesh)
    assert ok, problems
    rounds = len(got[3]["need"])
    log(f"phase {phase}: anywrite_sparse n={cfg.n_nodes} on {mesh.size} positions, {rounds} "
        f"rounds == the unsharded card run ({ms / rounds:.1f} against {ms_whole / rounds:.1f} "
        f"ms/round); exchange bytes a round ici {got[3]['xshard_bytes_ici'][0]:.0f}, dcn "
        f"{got[3]['xshard_bytes_dcn'][0]:.0f} == traffic_model; launches {json.dumps(launches)}")
    del got, want

    # (c) the merge_10k burst at n=2560 (legacy delivery) on 2 positions.
    cfg, topo, sched = baselines.merge_10k(device="cuda", n=2560, rounds=48)
    sched = _burst(sched, engine.Schedule)
    mesh2 = parallel.make_mesh(2)
    onehot.reset_launches()
    (final, curves), ms = _timed(lambda: parallel.simulate_sharded(
        cfg, topo, sched, mesh2, seed=0, max_chunk=24
    ))
    by_path["merge_10k_sharded"] = launches = dict(onehot.LAUNCHES)
    (whole, want), ms_whole = _timed(lambda: engine.simulate(
        cfg, topo, sched, seed=0, max_chunk=24, device="cuda"
    ))
    missing = [k for k in PATH_KERNELS["merge_10k_sharded"] if launches[k] == 0]
    assert not missing, f"merge_10k sharded: kernels never launched: {missing}"
    bad = _same_on_card(final, whole) + _curve_diff(want, curves, XSHARD_CURVE_KEYS)
    assert not bad, f"merge_10k sharded differs from the unsharded card run in {bad}"
    ok, problems = epidemic.xshard_model_check(curves, cfg.gossip, mesh2)
    assert ok, problems
    log(f"phase {phase}: merge_10k burst n={cfg.n_nodes} (legacy delivery) on {mesh2.size} "
        f"positions, {sched.rounds} rounds == the unsharded card run ({ms / sched.rounds:.1f} "
        f"against {ms_whole / sched.rounds:.1f} ms/round); exchange bytes a round ici "
        f"{curves['xshard_bytes_ici'][0]:.0f}; launches {json.dumps(launches)}")
    del final, whole

    # (d) the elastic drills, on the card and then on the CPU.
    ckpt = REPO / "build" / "elastic"
    onehot.reset_launches()
    t0 = time.perf_counter()
    card = {n: scenarios.run_scenario(n, checkpoint_dir=str(ckpt / "cuda" / n), device="cuda")
            for n in ELASTIC_DRILLS}
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    by_path["elastic"] = launches = dict(onehot.LAUNCHES)
    t0 = time.perf_counter()
    cpu = {n: scenarios.run_scenario(n, checkpoint_dir=str(ckpt / "cpu" / n), device="cpu")
           for n in ELASTIC_DRILLS}
    cpu_s = time.perf_counter() - t0
    missing = [k for k in PATH_KERNELS["elastic"] if launches[k] == 0]
    assert not missing, f"elastic drills: kernels never launched: {missing}"
    for n in ELASTIC_DRILLS:
        rep = card[n]
        assert rep["ok"] and rep["bit_identical"] and rep["reconcile"]["ok"], (n, rep["mismatches"])
        walls = rep.pop("wall_s"), cpu[n].pop("wall_s")
        assert rep == cpu[n], f"{n}: the card's report differs from the CPU's"
        rep["wall_s"] = walls[0]
    mach = card["preempt_dense_churn"]["machinery"]
    assert mach["fired"] and mach["poison_changed"] and mach["replay_identical"], mach
    budget = json.loads((REPO / "bench_budget.json").read_text())["elastic"]
    # The survival fields only: the budget's wall ceilings are the CPU lane's.
    gate = report.check_elastic_budget(
        {"scenarios": list(card.values())},
        dict(budget, scenarios={n: {} for n in ELASTIC_DRILLS}),
    )
    assert gate["ok"], gate["breaches"]
    log(f"phase {phase}: elastic drills {', '.join(ELASTIC_DRILLS)} on the card: each equal "
        f"to its uninterrupted run and its report equal to the CPU's; preempt machinery "
        f"{json.dumps(mach)}; budget gate ok on the survival fields; card {card_s:.1f} s, CPU "
        f"{cpu_s:.1f} s; walls on the card "
        f"{json.dumps({n: round(report.wall_total(card[n]), 2) for n in ELASTIC_DRILLS})}; "
        f"launches {json.dumps(launches)}")
    log(f"phase {phase}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


# ---- phase 14: the bench harness and the device-cost plane -----------------


def bench_harness(onehot, led, first_run_s: float, compile_ms: float, cpu_costs: dict,
                  phase: int = 14) -> dict:
    """The bench harness on the card, each path's launch counts reset just
    before it and read just after (the 120-round run apart from the
    attribution and roofline steps after it, the lane's sharded runs apart
    from its attribution):

    (a) merge_10k in full (the bench's flagship: 10,000 nodes, 120 rounds,
        256 samples), seed 1, in calls of 24 rounds, with the ledger
        ``led`` armed and ``KernelTelemetry(ledger=, watermarks=)``; then
        ``plane_composite`` on its final state, ``attribute_planes``
        (``iters`` 10) and ``roofline_stage_costs``; the report put
        together as the bench puts it (``bench_context``,
        ``rounded_step_report``, ``roofline_report``,
        ``compile_split_report`` of ``first_run_s`` and ``compile_ms``),
        passing ``check_bench_invariants`` with ``steady_compiles`` 0;
    (b) ``measure_multichip`` on card positions, D in {1, 2, 4, 8}: curves
        and final states equal across D, exchange bytes equal to
        ``traffic_model`` (the lane raises otherwise);
    (c) the cost model of the four engines at their tiny configs on the
        card, its flops and bytes equal to the CPU's (``cpu_costs``, built
        by phase 4's worker);
    (d) ``capacity_model`` against the card's memory: the 512-node point
        exact, the 100,352-node point a placement measured here.

    Returns the launch counts by path."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.obs import costs
    from corrosion_tpu_torch.ops import gossip as gossip_ops
    from corrosion_tpu_torch.sim import benchlib, engine, health, telemetry

    t_phase = time.perf_counter()
    by_path = {}

    # (a) merge_10k, armed.
    cfg, topo, sched = build_path("merge_10k")
    n, rounds, chunk = cfg.n_nodes, sched.rounds, 24
    wm = costs.MemoryWatermarks()
    tele = telemetry.KernelTelemetry(engine="dense", ledger=led, watermarks=wm)
    torch.cuda.synchronize()
    onehot.reset_launches()
    led.arm("phase 14 timed merge_10k run (warmed by phases 2 and 6 at the same shapes)")
    t0 = time.perf_counter()
    final, curves = engine.simulate(cfg, topo, sched, seed=1, max_chunk=chunk, telemetry=tele,
                                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["bench_merge_10k"] = launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["bench_merge_10k"] if launches[k] == 0]
    assert not missing, f"merge_10k bench: kernels never launched: {missing}"
    step_ms = wall / rounds * 1000.0
    onehot.reset_launches()
    composite, stages, carry0 = benchlib.plane_composite(cfg, topo, sched, final)
    attr = telemetry.attribute_planes(composite, stages, carry0, iters=10)
    plane, residual_ms = attr.scale(step_ms)
    t_costs = time.perf_counter()
    stage_costs = costs.roofline_stage_costs(composite, stages, carry0)
    stage_s = time.perf_counter() - t_costs
    torch.cuda.synchronize()
    led.disarm()
    by_path["bench_attribution"] = attr_launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["bench_attribution"] if attr_launches[k] == 0]
    assert not missing, f"merge_10k attribution: kernels never launched: {missing}"
    mem = costs.reconcile_memory(parallel.shard_cluster_state(final, parallel.make_mesh(1)),
                                 watermarks=wm)
    lat = engine.visibility_latencies(final, sched, cfg)
    rep = health.report_from_curves(curves, engine="dense", round_ms=cfg.round_ms)
    d = final.data
    converged = bool((d.contig == d.head[None, :]).all())
    applied = float(curves["applied_broadcast"].astype(np.float64).sum()
                    + curves["applied_sync"].astype(np.float64).sum())
    step_rep = benchlib.rounded_step_report(step_ms, plane)
    p99 = lat["p99_s"]
    report = telemetry.check_bench_invariants({
        **benchlib.bench_context(cfg, n, rounds, chunk, device="cuda"),
        "nodes": n,
        "rounds": rounds,
        "kernels": "cuda",
        "metric": "p99_change_visibility_10k",
        "value": round(p99, 2),
        "unit": "s",
        "vs_baseline": round(10.0 / p99, 2) if p99 > 0 else None,
        "converged": converged,
        "cells_converged": bool(gossip_ops.cells_agree(d, cfg.gossip)),
        "unseen_pairs": lat["unseen"],
        "p50_s": round(lat["p50_s"], 2),
        "throughput_changes_per_s": round(applied / wall, 1),
        **step_rep,
        "step_inner_ms": round(tele.device_step_ms, 1),
        **benchlib.compile_split_report(first_run_s, compile_ms),
        "steady_compiles": led.armed_compiles,
        "roofline": benchlib.roofline_report(stage_costs, step_rep["plane_ms"]),
        "peak_live_bytes_per_device": max(wm.peak.values(), default=0),
        "allocator_peak_bytes_per_device": max(wm.allocator_peak.values(), default=0),
        "state_bytes_per_device": mem["state_bytes_per_position_max"],
        "converged_round": rep.converged_round,
        "staleness_p99": round(rep.staleness_p99, 1),
        "queue_backlog_peak": rep.queue_backlog_peak,
    })
    assert report["steady_compiles"] == 0 and wm.samples == rounds // chunk, (
        report["steady_compiles"], wm.samples)
    log(f"phase {phase}: merge_10k bench N={n} {rounds} rounds (seed 1, ledger armed, "
        f"{wm.samples} watermark samples): {step_ms:.1f} ms/round wall, step_inner_ms "
        f"{report['step_inner_ms']}; composite {attr.full_ms:.1f} ms, overhead "
        f"{attr.overhead_ms:.2f} ms, residual {residual_ms:.1f} ms; roofline stage costs "
        f"counted in {stage_s:.1f} s; memory reconciled at rest ({json.dumps(mem['watermarks'])}); "
        f"launches of the {rounds}-round run {json.dumps(launches)}, of the attribution and "
        f"roofline steps {json.dumps(attr_launches)}")
    log(f"phase {phase}: bench report {json.dumps(report)}")
    del final, carry0, composite, d

    # (b) the multi-device lane on card positions. Its progress notes
    # split the counts: the sharded runs (a warm and a timed run of each
    # plane at each D) end where the plane attribution at max(D) begins.
    class Marks:
        def __init__(self):
            self.at = {}

        def write(self, msg):
            self.at[msg.strip()] = dict(onehot.LAUNCHES)

        def flush(self):
            pass

    marks = Marks()
    onehot.reset_launches()
    t0 = time.perf_counter()
    lane = telemetry.check_bench_invariants(benchlib.measure_multichip(device="cuda",
                                                                       progress=marks))
    torch.cuda.synchronize()
    total = dict(onehot.LAUNCHES)
    runs = marks.at[f"[multichip] D={max(benchlib.MULTICHIP_DEVICE_COUNTS)}: plane attribution"]
    by_path["bench_multichip"] = runs
    by_path["bench_multichip_attribution"] = lane_attr = {k: total[k] - runs[k] for k in total}
    for path, launches in (("bench_multichip", runs), ("bench_multichip_attribution", lane_attr)):
        missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
        assert not missing, f"{path}: kernels never launched: {missing}"
    assert lane["bit_identical_across_device_counts"], lane
    log(f"phase {phase}: multichip lane D {lane['device_counts']} on card positions "
        f"({time.perf_counter() - t0:.1f} s): curves and final states equal across D; exchange "
        f"bytes a round ici {lane['xshard_bytes_per_round_ici']:.0f}, dcn "
        f"{lane['xshard_bytes_per_round_dcn']:.0f} == traffic_model; launches of the sharded "
        f"runs {json.dumps(runs)}, of the attribution and roofline steps {json.dumps(lane_attr)}")
    log(f"phase {phase}: multichip report {json.dumps(lane)}")

    # (c) the cost model on the card against the CPU's.
    onehot.reset_launches()
    t0 = time.perf_counter()
    card = costs.build_cost_model(device_counts=costs.DEVICE_COUNTS, device="cuda")
    card_s = time.perf_counter() - t0
    by_path["bench_costs"] = launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["bench_costs"] if launches[k] == 0]
    assert not missing, f"cost model: kernels never launched: {missing}"
    assert sorted(card["entries"]) == sorted(cpu_costs["entries"])
    unequal = {}
    for key, e in card["entries"].items():
        c = cpu_costs["entries"][key]
        if any(e[m] != c[m] for m in ("flops", "bytes_accessed", "kernel_calls",
                                      "config_fingerprint")):
            unequal[key] = {op: [e["by_op"].get(op), c["by_op"].get(op)]
                            for op in sorted(set(e["by_op"]) | set(c["by_op"]))
                            if e["by_op"].get(op) != c["by_op"].get(op)}
    assert not unequal, f"cost model card != CPU (ops [card, CPU]): {json.dumps(unequal)}"
    same_mem = {k: all(e[m] == cpu_costs["entries"][k][m] for m in ("peak_bytes", "temp_bytes"))
                for k, e in card["entries"].items()}
    log(f"phase {phase}: cost model of {len(card['entries'])} entries on the card ({card_s:.1f} s) "
        f"== the CPU's in flops, bytes, kernel calls and fingerprints; peak and temp bytes "
        f"equal too: {json.dumps(same_mem)}")
    log(f"phase {phase}: cost model " + json.dumps({
        k: {m: e.get(m) for m in ("flops", "bytes_accessed", "ops", "peak_bytes", "temp_bytes",
                                  "allocator_peak_bytes")}
        for k, e in card["entries"].items()
    }))

    # (d) the capacity curve against the card's memory.
    mesh8 = parallel.multichip_mesh(8)
    cfg100k, _, sched100k = costs.flagship_cfg(100_352, device="cuda")
    placed = costs.measure_placement(cfg100k, len(sched100k.sample_writer), mesh8)
    cap = costs.capacity_model(device="cuda", measured_100k={
        "nodes": 100_352, "device_count": 8, **placed,
        "source": "chip_smoke.py phase 14: flagship_cfg(100_352) placed on 8 card positions",
    })
    assert cap["validation"]["lane_512"]["exact"], cap["validation"]
    log(f"phase {phase}: capacity model against {cap['memory_bytes']} B of card memory: "
        f"{json.dumps(cap)}")
    log(f"phase {phase}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def kernel_rows(measured: list, by_path: dict) -> list:
    """The ``kernels`` line: one entry per kernel from phase 3's
    measurements and the main paths' launch counts."""
    rows = []
    for name, (src, replaces) in KERNELS.items():
        mine = [m for m in measured if m["name"] == name]
        first = mine[0]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            "max_abs_err": max(m["err"] for m in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
            "library_ms": first["library_ms"],
            # Every path's launches, and every shape measured on it (the
            # top-level times are the first shape's).
            "by_path": {
                path: {"launches": counts[name], "shapes": [
                    {
                        "shape": m["shape"], "max_abs_err": m["err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                        "bound_by": m["bound"][1], "library_ms": m["library_ms"],
                        "host_ms": m["host_ms"], "library_host_ms": m.get("library_host_ms"),
                        "device_events": m["device_events"],
                        **{k: v for k, v in m.items() if k.endswith("_ms") and k not in
                           ("ms", "plain_ms", "library_ms", "host_ms", "library_host_ms")},
                    }
                    for m in mine if m["path"] == path
                ]}
                for path, counts in by_path.items()
            },
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.obs import ledger
    from corrosion_tpu_torch.ops import gossip, onehot

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {smi} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"chip_smoke: {what} took {now - laps[-1]:.1f} s ({now - t_start:.1f} s in all)")
        laps.append(now)

    # The ledger records the library's build and load from here on.
    led = ledger.CompileLedger().watch_engines().install()
    with led.window("phase 2: build and load") as built:
        build_s = cuda_build.build(verbose=True)
        t_load = time.perf_counter()
        lib = cuda_build.load()
    log(f"phase 2: built the kernel library of {len(KERNELS)} kernels from "
        f"{len(cuda_build.SOURCES)} sources ({', '.join(cuda_build.SOURCES)}) in {build_s:.1f} s, "
        f"loaded in {time.perf_counter() - t_load:.2f} s: {lib.name}; ledger window "
        f"{json.dumps(built.to_record())}")
    lap("phase 2")
    measured = check_kernels(onehot, "cuda")
    lap("phase 3")
    check_tie_rules()
    cpu_costs = check_small_runs(onehot, gossip)
    lap("phase 4")
    by_path, kept, walls = {}, {}, {}
    for phase, path in (
        (5, "wan_100k"), (6, "merge_10k"), (7, "anywrite_sparse"), (8, "wan_100k_adaptive"),
    ):
        by_path[path] = full_run(onehot, gossip, phase, path,
                                 keep=kept if path == "wan_100k" else None, walls=walls)
        lap(f"phase {phase}")
    by_path["geo_10k"] = geo_run(onehot, gossip)
    lap("phase 9")
    by_path["anti_entropy_chunks"] = chunk_runs(onehot, gossip)
    lap("phase 10")
    by_path["mixed_storm"] = mixed_run(onehot, gossip)
    lap("phase 11")
    by_path["consumers"] = consumers(onehot)
    lap("phase 12")
    by_path.update(sharded_runs(onehot, gossip, kept))
    lap("phase 13")
    # The first run of merge_10k in this process: phase 2's build and load,
    # then phase 6's run.
    by_path.update(bench_harness(onehot, led, built.wall_ms / 1e3 + walls["merge_10k"],
                                 built.compile_ms, cpu_costs))
    lap("phase 14")
    rows = kernel_rows(measured, by_path)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build to the end")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-small-runs"]:
        sys.exit(cpu_small_runs(sys.argv[2]))
    sys.exit(main())

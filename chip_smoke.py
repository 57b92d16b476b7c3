#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each raises on failure; the exit code is nonzero on any fault):

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the four CUDA kernels from ``corrosion_tpu_torch/csrc`` (sm_90a);
3. each kernel against its plain PyTorch version on the same CUDA inputs,
   at the wan_100k shapes and on edge cases — exact equality required —
   timed with CUDA events (median of 25) beside the plain version, one
   PyTorch library call where one computes the same function, and the
   byte/operation bound;
4. ``wan_100k(n=2000, n_regions=4, n_writers=64, rounds=72)`` on the card
   (kernels) and on the CPU (plain versions): identical curves and final
   state;
5. full-size ``wan_100k()`` (100,000 nodes, 20 regions, 512 writers), all
   240 rounds in chunks of 12, with every kernel's launch counter > 0 and
   the watermark invariants.

The last lines are a ``kernels`` JSON line, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# INT32 outside the tensor cores: half the data sheet's 67 TFLOP/s float32,
# since a Hopper SM issues 64 INT32 lanes a clock against 128 FP32 lanes.
H100_INT_OPS_PER_S = 33.5e12

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
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event windows."""
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


def check_kernels(onehot, device) -> dict:
    """Exact equality kernel vs plain on edge cases and at wan_100k
    shapes; returns the per-kernel measurements at the main shapes."""
    g = torch.Generator().manual_seed(0)
    # Edge cases: 0-width axes, odd small shapes, both window widths.
    for r, m, w in ((0, 5, 7), (5, 0, 7), (5, 7, 0), (3, 1, 1), (37, 19, 41), (64, 300, 2049)):
        idx, val, mask = _inputs(g, r, m, w, device)
        for msk in (mask, None):
            got, want = onehot.rowmax(idx, val, msk, w), onehot.rowmax_plain(idx, val, msk, w)
            assert equal(got, want), f"rowmax differs at {(r, m, w)}"
        table = torch.randint(0, 1 << 32, (r, w), generator=g).to(device)
        assert equal(onehot.rowgather(table, idx), onehot.rowgather_plain(table, idx)), \
            f"rowgather differs at {(r, m, w)}"
        if r:
            cols = torch.randint(-1, w + 2, (m,), generator=g).to(device)[None, :].expand(r, m)
            assert equal(onehot.rowgather(table, cols), onehot.rowgather_plain(table, cols)), \
                f"rowgather (broadcast idx) differs at {(r, m, w)}"
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
    log("phase 3: edge cases equal (0-width axes, out-of-range, bit 31, wk 32/64)")

    # Main shapes (wan_100k): N=100,000 rows, kk=144 messages, W=512
    # writers, K=256 cells.
    n, kk, w, k = 100_000, 144, 512, 256
    out = {}
    idx, val, mask = _inputs(g, n, kk, k, device)
    idx = idx.clamp(0, k - 1)  # merge keys are always in range
    val = val & ((1 << 26) - 1)  # packed (cl << 24 | col_version) words
    safe = torch.where(mask, idx, k)
    zeros = torch.zeros((n, k + 1), dtype=torch.int64, device=device)
    got, want = onehot.rowmax(idx, val, mask, k), onehot.rowmax_plain(idx, val, mask, k)
    err = max_abs_err(got, want)
    assert err == 0, "rowmax differs at the merge shape"
    out["rowmax"] = dict(
        err=err,
        shape=f"[{n},{kk}]->[{n},{k}]",
        ms=cuda_ms(lambda: onehot.rowmax(idx, val, mask, k)),
        plain_ms=cuda_ms(lambda: onehot.rowmax_plain(idx, val, mask, k)),
        # amax is idempotent, so repeating it in place times the call alone.
        library_ms=cuda_ms(lambda: zeros.scatter_reduce_(1, safe, val, "amax")),
        bound=bound(nbytes(idx, val, mask, got), 2 * idx.numel()),
    )

    table = torch.randint(0, 1 << 24, (n, w), generator=g).to(device)
    gidx = torch.randint(0, w, (n, kk), generator=g).to(device)
    got, want = onehot.rowgather(table, gidx), onehot.rowgather_plain(table, gidx)
    err = max_abs_err(got, want)
    assert err == 0, "rowgather differs at the delivery shape"
    touched = torch.zeros((n, w), dtype=torch.bool, device=device)
    touched.scatter_(1, gidx, True)
    out["rowgather"] = dict(
        err=err,
        shape=f"[{n},{w}]<-[{n},{kk}]",
        ms=cuda_ms(lambda: onehot.rowgather(table, gidx)),
        plain_ms=cuda_ms(lambda: onehot.rowgather_plain(table, gidx)),
        library_ms=cuda_ms(lambda: torch.gather(table, 1, gidx)),
        # The gather needs only the table words it addresses.
        bound=bound(nbytes(gidx, got) + 8 * int(touched.sum()), gidx.numel()),
    )

    widx = torch.randint(0, w, (n, kk), generator=g).to(device)
    d = torch.randint(0, 40, (n, kk), generator=g).to(device)
    v = torch.randint(0, 1 << 20, (n, kk), generator=g).to(device)
    valid = torch.rand((n, kk), generator=g).to(device) < 0.8
    applied = valid & (d < 4)
    seen = torch.randint(0, 1 << 20, (n, w), generator=g).to(device)
    got = onehot.delivery_reduce(widx, d, v, applied, valid, seen, w)
    want = onehot.delivery_reduce_plain(widx, d, v, applied, valid, seen, w)
    err = max_abs_err(got, want)
    assert err == 0, "delivery_reduce differs"
    out["delivery_reduce"] = dict(
        err=err,
        shape=f"[{n},{kk}]x5,[{n},{w}]->2x[{n},{w}]",
        ms=cuda_ms(lambda: onehot.delivery_reduce(widx, d, v, applied, valid, seen, w)),
        plain_ms=cuda_ms(lambda: onehot.delivery_reduce_plain(widx, d, v, applied, valid, seen, w)),
        library_ms=None,
        bound=bound(nbytes(widx, d, v, applied, valid, seen, *got), 4 * widx.numel()),
    )

    oo = torch.randint(0, 1 << 32, (1, n, w), generator=g).to(device)
    adv_m = torch.randint(0, 8, (n, kk), generator=g).to(device)
    got = onehot.window_delivery(oo, widx, d, adv_m, valid, 32, w)
    want = onehot.window_delivery_plain(oo, widx, d, adv_m, valid, 32, w)
    err = max_abs_err(got, want)
    assert err == 0, "window_delivery differs"
    wtouched = torch.zeros((n, w), dtype=torch.bool, device=device)
    wtouched.scatter_(1, widx, valid)
    out["window_delivery"] = dict(
        err=err,
        shape=f"[1,{n},{w}],[{n},{kk}]x4->[{n},{kk}],[1,{n},{w}]",
        ms=cuda_ms(lambda: onehot.window_delivery(oo, widx, d, adv_m, valid, 32, w)),
        plain_ms=cuda_ms(lambda: onehot.window_delivery_plain(oo, widx, d, adv_m, valid, 32, w)),
        library_ms=None,
        bound=bound(
            nbytes(widx, d, adv_m, valid, *got) + 8 * int(wtouched.sum()),
            8 * widx.numel(),
        ),
    )
    for name, row in out.items():
        log(f"phase 3: {name} {row['shape']} equal; kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
            f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]})")
    return out


# ---- phase 4/5: the engine --------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def check_small_run():
    """wan_100k at n=2000 on the card (kernels) equals the CPU run (plain)."""
    from corrosion_tpu_torch import interop
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import engine

    kw = dict(n=2000, n_regions=4, n_writers=64, rounds=72)
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg, topo, sched = baselines.wan_100k(device=dev, **kw)
        t0 = time.perf_counter()
        final, curves = engine.simulate(cfg, topo, sched, seed=0, max_chunk=24, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (_flat(interop.to_numpy(final)), curves, time.perf_counter() - t0)
        log(f"phase 4: n=2000 x 72 rounds on {dev}: {runs[dev][2]:.1f} s")
    (fa, ca, _), (fb, cb, _) = runs["cuda"], runs["cpu"]
    bad = [k for k in ca if not np.array_equal(ca[k], cb[k])]
    bad += [k for k in fa if not np.array_equal(fa[k], fb[k])]
    assert not bad, f"card run differs from the CPU run in {bad}"
    assert ca["vis_count"].sum() > 0 and ca["msgs"].sum() > 0
    log(f"phase 4: card run == CPU run ({len(ca)} curves, {len(fa)} state "
        f"leaves); need[-1]={int(ca['need'][-1])}")


def full_run(onehot, gossip, chunk: int = 12):
    """Full-size wan_100k, every round of its schedule, ``chunk`` rounds
    per ``simulate`` call."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import engine

    cfg, topo, sched = baselines.wan_100k(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    state, parts, done = None, [], 0
    elapsed = 0.0
    t_wall = time.perf_counter()
    while done < sched.rounds:
        stop = min(done + chunk, sched.rounds)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, curves = engine.simulate(cfg, topo, sched.slice(done, stop), seed=0,
                                        state=state, device="cuda")
        b.record()
        b.synchronize()
        elapsed += a.elapsed_time(b)
        parts.append(curves)
        log(f"phase 5: rounds {done}-{stop - 1}: {a.elapsed_time(b) / (stop - done):.1f} ms/round")
        done = stop
    wall = time.perf_counter() - t_wall
    launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    d = state.data
    assert bool((d.contig <= d.head[None, :]).all()), "contig > head"
    assert bool((d.seen >= d.contig).all()), "seen < contig"
    for k in ("need", "staleness_sum", "msgs"):
        assert np.isfinite(curves[k].astype(np.float64)).all()
    assert curves["msgs"].sum() > 0 and curves["vis_count"].sum() > 0
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 5: wan_100k N={cfg.n_nodes} W={cfg.gossip.n_writers} "
        f"{done} rounds: {elapsed / done:.1f} ms/round (CUDA events), "
        f"wall {wall:.1f} s, peak memory {peak / 2**30:.2f} GiB")
    log(f"phase 5: launches {json.dumps(launches)}; host syncs {json.dumps(syncs)}")
    log(f"phase 5: need[-1]={int(curves['need'][-1])} "
        f"vis_count={int(curves['vis_count'].sum())} msgs={int(curves['msgs'].sum())}")
    return launches, done, elapsed / done, peak


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.ops import gossip, onehot

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {smi} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.cuda.set_device(0)
    log(f"phase 2: built {len(cuda_build.SOURCES)} kernels in "
        f"{cuda_build.build(verbose=True):.1f} s")
    measured = check_kernels(onehot, "cuda")
    check_small_run()
    launches, _, _, _ = full_run(onehot, gossip)
    rows = []
    for name, (src, replaces) in KERNELS.items():
        m = measured[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": m["err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
            "library_ms": m["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

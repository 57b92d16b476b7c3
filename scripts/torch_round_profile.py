#!/usr/bin/env python3
"""Where a full-size round of the PyTorch/CUDA port spends its time on
the card.

    python3 scripts/torch_round_profile.py
        [--config wan_100k|wan_100k_adaptive|merge_10k|anywrite_sparse|
                  mixed_storm|anti_entropy_chunks|anti_entropy_chunks_100k]
        [--warm 12] [--rounds 6] [--out build/torch_round_profile.json]

Runs the ``--config`` builder (``wan_100k()`` by default;
``wan_100k_adaptive`` is ``wan_100k()`` with the adaptive-dissemination
tuning ``ADAPTIVE_GOSSIP`` and 8-bucket sync sketches) at full size for
``--warm`` rounds, then profiles ``--rounds`` more with ``torch.profiler``
(CPU + CUDA activities). ``anywrite_sparse()`` runs whole epochs of 16
rounds (each with its rotation), so there both counts must be multiples
of 16: ``--warm 128 --rounds 16`` profiles write epoch 8.
``mixed_storm`` runs ``simulate_mixed`` (its chunk plane under
``corro_chunks``), ``anti_entropy_chunks`` runs ``simulate_chunks`` at
1,000 nodes and ``anti_entropy_chunks_100k`` at 100,000. It prints, from
the exported trace:

- ms/round over the profiled window (CUDA events) and the device's busy
  and idle share (union of kernel/memcpy/memset intervals over the
  window);
- device time per plane: kernels whose launch falls inside each
  ``corro_*`` profiler range of ``cluster_round``, plus ``other`` (keys,
  curve stacking, chunk set-up, and any event whose launch record the
  trace lost: ``no_launch_record_ms_per_round`` says how much);
- the top kernels by device time and the ported kernels' share;
- host syncs per round (``gossip.HOST_SYNCS``) and kernel launches per
  round.

Needs one CUDA device. Writes the summary as JSON to ``--out``, with the
card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import subprocess
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from corrosion_tpu_torch.profiling import device_events_by_range, launch_times, trace_events

PLANES = ("corro_chunks", "corro_broadcast", "corro_swim", "corro_sync", "corro_track",
          "corro_health")
CONFIGS = ("wan_100k", "wan_100k_adaptive", "merge_10k", "anywrite_sparse", "mixed_storm",
           "anti_entropy_chunks", "anti_entropy_chunks_100k")
# kernel: the substring of its device-side name in the trace (the row
# gathers' template is rowgather_kernel<kClip, kForm>: both forms count;
# table_gather_kernel<kIdxVec> counts both index loads)
PORTED = {
    "rowmax": "rowmax_kernel", "rowgather": "rowgather_kernel<false",
    "delivery_reduce": "delivery_reduce_kernel",
    "window_delivery": "window_delivery_kernel",
    "rowgather_wide": "rowgather_kernel<true", "rowsum": "rowsum_kernel",
    "table_gather": "table_gather_kernel",
}


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def analyse(events: list, window_ms: float, rounds: int) -> dict:
    # No placement by an event's own start: the host runs ahead of the
    # card, so a kernel launched in one plane often runs in the next.
    dev = device_events_by_range(events, PLANES)
    launched = launch_times(events)
    lost_ms = sum(
        e["dur"] for _, e in dev if e.get("args", {}).get("correlation") not in launched
    ) / 1e3
    per_plane = defaultdict(float)
    per_kernel = defaultdict(float)
    count = defaultdict(int)
    for plane, e in dev:
        per_plane[plane or "other"] += e["dur"] / 1e3
        per_kernel[e["name"]] += e["dur"] / 1e3
        count[e["name"]] += 1
    busy_ms = _union((e["ts"], e["ts"] + e["dur"]) for _, e in dev) / 1e3
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    ported = {
        k: round(sum(v for n, v in per_kernel.items() if sub in n) / rounds, 4)
        for k, sub in PORTED.items()
    }
    return {
        "ms_per_round": window_ms / rounds,
        "device_busy_share": busy_ms / window_ms,
        "device_idle_share": 1 - busy_ms / window_ms,
        "device_ms_per_round": device_ms / rounds,
        "plane_device_ms_per_round": {
            k: round(v / rounds, 3) for k, v in sorted(per_plane.items())
        },
        "no_launch_record_ms_per_round": lost_ms / rounds,
        "device_ops_per_round": sum(count.values()) / rounds,
        "top_kernels_ms_per_round": [
            {"name": n[:120], "ms": round(v / rounds, 4), "calls": count[n] / rounds}
            for n, v in top
        ],
        "ported_kernels_ms_per_round": ported,
        "ported_share_of_device_time": sum(ported.values()) * rounds / max(device_ms, 1e-9),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIGS, default="wan_100k")
    ap.add_argument("--warm", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default="build/torch_round_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_round_profile: CUDA is not available", file=_sys.stderr)
        return 2
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.ops import gossip, onehot
    from corrosion_tpu_torch.sim import chunk_engine, engine, health, mixed_engine, sparse_engine

    if args.config.startswith("anti_entropy_chunks"):
        ccfg, origin, last, _ = baselines.anti_entropy_chunks(
            n=100_000 if args.config.endswith("100k") else 1000, device="cuda"
        )
        nodes, writers = ccfg.n_nodes, ccfg.n_streams

        def run(state, r0, rounds):
            st, vis = state or (None, None)
            st, m = chunk_engine.simulate_chunks(
                ccfg, origin, last, rounds, seed=0, state=st, vis=vis, start_round=r0,
                device="cuda",
            )
            return st, m["vis"]
    elif args.config == "mixed_storm":
        cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device="cuda")
        nodes, writers = cfg.n_nodes, cfg.gossip.n_writers

        def run(state, r0, rounds):
            return mixed_engine.simulate_mixed(
                cfg, ccfg, topo, sched.slice(r0, r0 + rounds), spec, seed=0, state=state,
                device="cuda",
            )[0]
    else:
        run = None
    if run is not None:
        state = run(None, 0, args.warm) if args.warm else None
        torch.cuda.synchronize()
        gossip.reset_host_syncs()
        onehot.reset_launches()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            a.record()
            run(state, args.warm, args.rounds)
            b.record()
            b.synchronize()
        return report(args, prof, a.elapsed_time(b), nodes, writers, gossip, onehot)

    adaptive = args.config == "wan_100k_adaptive"
    cfg, topo, sched = getattr(baselines, "wan_100k" if adaptive else args.config)(device="cuda")
    if adaptive:
        cfg = health.with_adaptive(cfg, sync_sketch_buckets=8)
    sparse = args.config == "anywrite_sparse"
    if sparse:
        e_len = cfg.sparse.epoch_rounds
        if args.warm % e_len or args.rounds % e_len or not args.rounds:
            ap.error(f"anywrite_sparse runs whole epochs: --warm and --rounds must be "
                     f"multiples of {e_len} (--rounds at least one epoch)")

        def run(resume, rounds_end):
            return sparse_engine.simulate_sparse(
                cfg, topo, sched, seed=0, resume=resume,
                stop_after_epoch=rounds_end // e_len - 1, device="cuda",
            )[4]["resume"]

        state = run(None, args.warm) if args.warm else None
    else:
        state, _ = engine.simulate(cfg, topo, sched.slice(0, args.warm), seed=0, device="cuda")
    torch.cuda.synchronize()
    gossip.reset_host_syncs()
    onehot.reset_launches()
    window = sched.slice(args.warm, args.warm + args.rounds)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        if sparse:
            run(state, args.warm + args.rounds)
        else:
            engine.simulate(cfg, topo, window, seed=0, state=state, device="cuda")
        b.record()
        b.synchronize()
    return report(args, prof, a.elapsed_time(b), cfg.n_nodes, cfg.gossip.n_writers, gossip,
                  onehot)


def report(args, prof, window_ms, nodes, writers, gossip, onehot) -> int:
    """Analyse the window, add the card and the run's counts, write and
    print the summary."""
    out = analyse(trace_events(prof), window_ms, args.rounds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    out.update(
        config=args.config, card=smi, nodes=nodes,
        writers=writers, warm=args.warm, rounds=args.rounds,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        device=torch.cuda.get_device_name(0),
        host_syncs_per_round={k: v / args.rounds for k, v in gossip.HOST_SYNCS.items()},
        kernel_launches_per_round={k: v / args.rounds for k, v in onehot.LAUNCHES.items()},
    )
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    _sys.exit(main())

"""Time the unsharded round of two checkouts of the port on one card, in
alternating pairs (A, B, B, A, A, B, ...), each side a process of its own.

    python3 scripts/torch_ab_unsharded.py [--engine sparse|chunk|mixed] [--pairs N] PARENT_CHECKOUT [CHANGE_CHECKOUT]

Each side builds its kernel library, runs a warm-up, then times the first
rounds of a full-size run between CUDA events and prints one JSON line:
ms/round, peak device memory after ``reset_peak_memory_stats`` and the
last round's ``need``. The dense engine (the default) runs ``wan_100k``'s
first ``ROUNDS`` rounds in calls of 12 after a 2-round warm-up; ``--engine
sparse`` runs ``anywrite_sparse``'s first ``SPARSE_EPOCHS`` epochs in one
``simulate_sparse`` call after a one-epoch warm-up; ``--engine chunk`` the
100,000-node ``anti_entropy_chunks``'s first ``CHUNK_ROUNDS`` rounds in one
call, and ``--engine mixed`` ``mixed_storm``'s first ``MIXED_ROUNDS``
rounds in calls of 25, each after a 2-round warm-up. The card's name and
power limit come first. ``--pairs N`` (default 2) runs N pairs, the
parent first in odd pairs and the change first in even ones; the last
line is a JSON summary: each side's median ms/round and largest peak,
and the change's median over the parent's. CHANGE_CHECKOUT defaults to
the checkout holding this script. Needs CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROUNDS = 24
SPARSE_EPOCHS = 3  # 48 rounds: through the first epoch boundary that retires slots
CHUNK_ROUNDS = 24  # the 100,000-node chunk plane's first call in chip_smoke.py's phase 10
MIXED_ROUNDS = 75  # mixed_storm's first three calls of 25 in phase 11


def side(root: str, engine_name: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import chunk_engine, engine, mixed_engine, sparse_engine

    if not engine.__file__.startswith(root):
        raise RuntimeError(f"imported {engine.__file__}, not the checkout at {root}")
    cuda_build.build(verbose=False)
    cuda_build.load()
    if engine_name == "sparse":
        cfg, topo, sched = baselines.anywrite_sparse(device="cuda")
        rounds = SPARSE_EPOCHS * cfg.sparse.epoch_rounds
        sparse_engine.simulate_sparse(cfg, topo, sched, seed=0, stop_after_epoch=0,
                                      device="cuda")

        def run():
            return sparse_engine.simulate_sparse(cfg, topo, sched, seed=0,
                                                 stop_after_epoch=SPARSE_EPOCHS - 1,
                                                 device="cuda")[3]
    elif engine_name == "chunk":
        cfg, origin, last, _ = baselines.anti_entropy_chunks(n=100_000, device="cuda")
        rounds = CHUNK_ROUNDS
        chunk_engine.simulate_chunks(cfg, origin, last, 2, seed=0, device="cuda")

        def run():
            return chunk_engine.simulate_chunks(cfg, origin, last, CHUNK_ROUNDS, seed=0,
                                                device="cuda")[1]["curves"]
    elif engine_name == "mixed":
        cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device="cuda")
        rounds = MIXED_ROUNDS
        mixed_engine.simulate_mixed(cfg, ccfg, topo, sched.slice(0, 2), spec, seed=0,
                                    device="cuda")

        def run():
            state, parts = None, []
            for r0 in range(0, MIXED_ROUNDS, 25):
                state, curves = mixed_engine.simulate_mixed(
                    cfg, ccfg, topo, sched.slice(r0, r0 + 25), spec, seed=0, state=state,
                    device="cuda")
                parts.append(curves)
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    else:
        cfg, topo, sched = baselines.wan_100k(device="cuda")
        rounds = ROUNDS
        engine.simulate(cfg, topo, sched.slice(0, 2), seed=0, device="cuda")

        def run():
            return engine.simulate(cfg, topo, sched.slice(0, ROUNDS), seed=0, max_chunk=12,
                                   device="cuda")[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    curves = run()
    b.record()
    b.synchronize()
    return {"root": root, "engine": engine_name, "rounds": len(curves["need"]),
            "ms_per_round": a.elapsed_time(b) / rounds,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "need_last": float(curves["need"][-1])}


def main(argv: list) -> int:
    engine_name, pairs = "dense", 2
    if argv[:1] == ["--engine"]:
        engine_name, argv = argv[1], argv[2:]
    if argv[:1] == ["--pairs"]:
        pairs, argv = int(argv[1]), argv[2:]
    if argv[:1] == ["--side"]:
        print(json.dumps(side(os.path.abspath(argv[1]), engine_name)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(argv[0])
    change = os.path.abspath(argv[1] if len(argv) > 1 else
                             os.path.join(os.path.dirname(__file__), os.pardir))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    ok = True
    runs: dict = {parent: [], change: []}
    for i in range(1, pairs + 1):
        for root in ((parent, change) if i % 2 else (change, parent)):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--engine",
                                engine_name, "--side", root], capture_output=True, text=True)
            ok = ok and r.returncode == 0
            if r.returncode == 0:
                runs[root].append(json.loads(r.stdout.strip().splitlines()[-1]))
                print(r.stdout.strip(), flush=True)
            else:
                print(r.stderr[-3000:], flush=True)
    if not ok:
        return 1
    med = {root: statistics.median(x["ms_per_round"] for x in xs) for root, xs in runs.items()}
    print(json.dumps({
        "engine": engine_name, "pairs": pairs,
        "parent_median_ms": med[parent], "change_median_ms": med[change],
        "change_over_parent": med[change] / med[parent] - 1.0,
        "parent_peak_gib": max(x["peak_gib"] for x in runs[parent]),
        "change_peak_gib": max(x["peak_gib"] for x in runs[change]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

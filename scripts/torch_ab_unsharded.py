"""Time the unsharded round of two checkouts of the port on one card, in
turns (A, B, B, A), each side a process of its own.

    python3 scripts/torch_ab_unsharded.py [--engine sparse] PARENT_CHECKOUT [CHANGE_CHECKOUT]

Each side builds its kernel library, runs a warm-up, then times the first
rounds of a full-size run between CUDA events and prints one JSON line:
ms/round, peak device memory after ``reset_peak_memory_stats`` and the
last round's ``need``. The dense engine (the default) runs ``wan_100k``'s
first ``ROUNDS`` rounds in calls of 12 after a 2-round warm-up; ``--engine
sparse`` runs ``anywrite_sparse``'s first ``SPARSE_EPOCHS`` epochs in one
``simulate_sparse`` call after a one-epoch warm-up. The card's name and
power limit come first. CHANGE_CHECKOUT defaults to the checkout holding
this script. Needs CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROUNDS = 24
SPARSE_EPOCHS = 3  # 48 rounds: through the first epoch boundary that retires slots


def side(root: str, engine_name: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import engine, sparse_engine

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
            "need_last": int(curves["need"][-1])}


def main(argv: list) -> int:
    engine_name = "dense"
    if argv[:1] == ["--engine"]:
        engine_name, argv = argv[1], argv[2:]
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
    for root in (parent, change, change, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--engine", engine_name,
                            "--side", root], capture_output=True, text=True)
        ok = ok and r.returncode == 0
        print(r.stdout.strip() if r.returncode == 0 else r.stderr[-3000:], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

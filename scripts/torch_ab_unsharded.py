"""Time the unsharded wan_100k round of two checkouts of the port on one
card, in turns (A, B, B, A), each side a process of its own.

    python3 scripts/torch_ab_unsharded.py PARENT_CHECKOUT [CHANGE_CHECKOUT]

Each side builds its kernel library, runs a 2-round warm-up, then times
the first ``ROUNDS`` rounds of full-size ``wan_100k`` in calls of 12
between CUDA events, and prints one JSON line: ms/round, peak device
memory after ``reset_peak_memory_stats`` and the last round's ``need``.
The card's name and power limit come first. CHANGE_CHECKOUT defaults to
the checkout holding this script. Needs CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROUNDS = 24


def side(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import engine

    if not engine.__file__.startswith(root):
        raise RuntimeError(f"imported {engine.__file__}, not the checkout at {root}")
    cuda_build.build(verbose=False)
    cuda_build.load()
    cfg, topo, sched = baselines.wan_100k(device="cuda")
    engine.simulate(cfg, topo, sched.slice(0, 2), seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    _, curves = engine.simulate(cfg, topo, sched.slice(0, ROUNDS), seed=0, max_chunk=12,
                                device="cuda")
    b.record()
    b.synchronize()
    return {"root": root, "ms_per_round": a.elapsed_time(b) / ROUNDS,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "need_last": int(curves["need"][-1])}


def main(argv: list) -> int:
    if argv[:1] == ["--side"]:
        print(json.dumps(side(os.path.abspath(argv[1]))), flush=True)
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
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", root],
                           capture_output=True, text=True)
        ok = ok and r.returncode == 0
        print(r.stdout.strip() if r.returncode == 0 else r.stderr[-3000:], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of their
source, so an edited kernel never loads a stale build. ``build()`` starts
one ``nvcc`` per missing source, all at once; ``library(name)`` builds on
first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# rowgather.cu holds both gathers (rowgather and rowgather_wide).
SOURCES = (
    "rowmax", "rowgather", "delivery_reduce", "window_delivery", "rowsum",
    "table_gather",
)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES, verbose: bool = False) -> float:
    """Compile every missing library in ``names`` in parallel; returns the
    wall seconds spent. Raises with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(tmp), str(CSRC / f"{name}.cu"),
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib

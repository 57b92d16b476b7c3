"""Build and load the library of hand-written CUDA kernels in ``csrc/``.

One shared library holds every kernel and the PyTorch operators over them
(``torch.ops.corro.*``, registered by ``csrc/ops.cpp``). ``build()`` runs,
all at once, one ``nvcc`` per ``csrc/*.cu`` (an object for ``sm_90a``)
and one host-compiler run of ``ops.cpp`` against torch's headers, then
links the objects against torch's libraries with ``nvcc`` (the CUDA
runtime linked statically). No ninja. The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of every
source, the build flags and torch's version, so an edited kernel or flag
never loads a stale build. ``load()`` builds on first use and loads the
library with ``torch.ops.load_library``. Nothing here runs at import time.
Each build that compiles and each load calls the registered listeners
with its kind (``"build"``, ``"load"``) and wall seconds (``obs.ledger``
keeps its ledger with them).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# The kernels' sources (rowgather.cu holds both row gathers), then the
# operators over them.
KERNEL_SOURCES = (
    "rowmax.cu", "rowgather.cu", "delivery_reduce.cu", "window_delivery.cu", "rowsum.cu",
    "table_gather.cu",
)
SOURCES = KERNEL_SOURCES + ("ops.cpp",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC")
LINK_LIBS = ("-lc10", "-ltorch_cpu")

_loaded: Path | None = None
# Callables (kind, seconds) told of every build that compiles and every load.
LISTENERS: list = []


def _notify(kind: str, seconds: float) -> None:
    for fn in list(LISTENERS):
        fn(kind, seconds)


def _cxx_flags() -> tuple:
    return CXX_FLAGS + (f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",)


def lib_path(csrc: Path | None = None) -> Path:
    """Where the library built from ``csrc`` (None: ``CSRC``, the directory
    ``build()`` compiles) with today's flags lives."""
    csrc = csrc or CSRC
    h = hashlib.sha1()
    for f in sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cpp", ".h")):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    for part in (*NVCC_FLAGS, *_cxx_flags(), *LINK_LIBS, torch.__version__):
        h.update(part.encode() + b"\0")
    return BUILD_DIR / f"libcorro_kernels-{h.hexdigest()[:12]}.so"


def _tool(name: str, *candidates) -> str:
    for cand in (*candidates, shutil.which(name)):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built")


def cxx_command(src: Path, *args: str) -> list:
    """The host compiler's command for ``src`` against torch's headers,
    with the build's flags, then ``args``."""
    from torch.utils import cpp_extension

    return [_tool("g++"), *_cxx_flags(), *(f"-I{p}" for p in cpp_extension.include_paths()),
            *args, str(src)]


def _run(jobs: dict, verbose: bool) -> None:
    """Run every command of ``jobs`` (label -> argv) at once; raises with
    the output of each that failed."""
    procs = {
        label: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, cmd in jobs.items()
    }
    failed = []
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{label} ({' '.join(jobs[label])}):\n{log}")
        elif verbose and log:
            print(f"[{label}]\n{log}", flush=True)
    if failed:
        raise RuntimeError("kernel library build failed: " + "\n".join(failed))


def build(verbose: bool = False) -> float:
    """Compile and link the library unless it exists; returns the wall
    seconds spent. Raises with the compilers' output if a step fails."""
    out = lib_path()
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _tool("nvcc", "/usr/local/cuda/bin/nvcc")
    from torch.utils import cpp_extension

    work = Path(tempfile.mkdtemp(prefix=out.stem + ".", dir=BUILD_DIR))
    try:
        objs = [work / (Path(src).stem + ".o") for src in SOURCES]
        jobs = {
            src: [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                  "-c", str(CSRC / src), "-o", str(obj)]
            for src, obj in zip(KERNEL_SOURCES, objs)
        }
        jobs["ops.cpp"] = cxx_command(CSRC / "ops.cpp", "-c", "-o", str(objs[-1]))
        _run(jobs, verbose)
        lib_dirs = cpp_extension.library_paths()
        tmp = work / out.name
        _run({"link": [
            nvcc, "-shared", "-o", str(tmp), *map(str, objs),
            *(f"-L{d}" for d in lib_dirs),
            *(arg for d in lib_dirs for arg in ("-Xlinker", f"-rpath,{d}")),
            *LINK_LIBS,
        ]}, verbose)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    _notify("build", secs)
    return secs


def load() -> Path:
    """Build the library if needed and load it once into this process,
    registering ``torch.ops.corro.*``; returns its path."""
    global _loaded
    if _loaded is None:
        build()
        path = lib_path()
        t0 = time.perf_counter()
        torch.ops.load_library(str(path))
        _loaded = path
        _notify("load", time.perf_counter() - t0)
    return _loaded

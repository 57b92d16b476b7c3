"""The kernel library's build and load (``corrosion_tpu_torch.cuda_build``)
and the CPU route of the primitives, on the CPU: what can be held without
``nvcc`` or a card.

- the library's name follows every source and every build flag, so an
  edited kernel never loads a stale build;
- ``build()`` runs one ``nvcc`` per ``.cu`` and one host compile of
  ``ops.cpp`` at once, then one link, and raises with the compiler's output
  when a step fails (fake compilers stand in for the real ones);
- importing the port builds and loads nothing;
- CPU tensors take the plain versions without touching ``torch.ops.corro``.

The card-side half (the operators' checks, a broken build on the card)
is in ``tests/test_torch_cuda.py``.
"""

import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import cpp_extension

from corrosion_tpu_torch import cuda_build
from corrosion_tpu_torch.ops import onehot

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(p.name for p in cuda_build.CSRC.iterdir() if p.suffix in (".cu", ".cpp", ".h"))


@pytest.fixture
def csrc(tmp_path):
    """A copy of ``csrc/`` to edit."""
    return Path(shutil.copytree(cuda_build.CSRC, tmp_path / "csrc"))


def test_sources_are_the_kernels_and_the_operators():
    assert set(cuda_build.SOURCES) | {"kernels.h"} == set(FILES)
    assert cuda_build.SOURCES[-1] == "ops.cpp"
    assert all(s.endswith(".cu") for s in cuda_build.KERNEL_SOURCES)


@pytest.mark.parametrize("name", FILES)
def test_library_name_changes_when_any_source_changes(csrc, name):
    before = cuda_build.lib_path(csrc)
    assert before == cuda_build.lib_path()  # same sources, same name
    assert before.parent == cuda_build.BUILD_DIR and before.suffix == ".so"
    with open(csrc / name, "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.lib_path(csrc) != before


@pytest.mark.parametrize(
    "attr,extra", [("NVCC_FLAGS", "-lineinfo"), ("CXX_FLAGS", "-g"), ("LINK_LIBS", "-lm")]
)
def test_library_name_changes_when_a_flag_changes(monkeypatch, attr, extra):
    before = cuda_build.lib_path()
    monkeypatch.setattr(cuda_build, attr, getattr(cuda_build, attr) + (extra,))
    assert cuda_build.lib_path() != before


def test_library_name_hashes_the_directory_build_compiles(monkeypatch, csrc):
    with open(csrc / "ops.cpp", "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    assert cuda_build.lib_path() == cuda_build.lib_path(csrc)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs a host C++ compiler")
def test_the_operators_compile_against_torch_headers():
    # ops.cpp includes no CUDA header, so the host compiler checks it
    # without the card, with the build's own flags and torch's headers.
    cmd = cuda_build.cxx_command(cuda_build.CSRC / "ops.cpp", "-fsyntax-only")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_library_name_follows_torch_version(monkeypatch):
    before = cuda_build.lib_path()
    monkeypatch.setattr(torch, "__version__", torch.__version__ + ".other")
    assert cuda_build.lib_path() != before


def _fake_tools(tmp_path, fail=None):
    """Stand-in ``nvcc`` and ``g++``: each logs its arguments and writes
    its ``-o`` file; the one named ``fail`` prints an error and exits 1."""
    log = tmp_path / "calls.log"
    tools = {}
    for tool in ("nvcc", "g++"):
        script = tmp_path / f"fake-{tool}"
        body = (
            f'echo "{tool} $*" >> {log}\n'
            + (f'echo "{tool}: error: broken source" ; exit 1\n' if tool == fail else "")
            + 'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then touch "$2"; fi; shift; done\n'
        )
        script.write_text("#!/bin/sh\n" + body)
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        tools[tool] = str(script)
    return tools, log


def _patch_tools(monkeypatch, tmp_path, tools):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_tool", lambda name, *c: tools[name])


def test_build_compiles_every_source_at_once_then_links_once(monkeypatch, tmp_path):
    tools, log = _fake_tools(tmp_path)
    _patch_tools(monkeypatch, tmp_path, tools)
    assert cuda_build.build() > 0
    calls = log.read_text().splitlines()
    compiles, link = calls[:-1], calls[-1]
    nvcc = [c for c in compiles if c.startswith("nvcc")]
    assert len(nvcc) == len(cuda_build.KERNEL_SOURCES)
    assert all("arch=compute_90a,code=sm_90a" in c and " -c " in c for c in nvcc)
    (cxx,) = [c for c in compiles if c.startswith("g++")]
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cxx and "ops.cpp" in cxx
    assert f"-I{cpp_extension.include_paths()[0]}" in cxx
    assert link.startswith("nvcc -shared") and "-lc10" in link and "-rpath," in link
    assert sum(a.endswith(".o") for a in link.split()) == len(cuda_build.SOURCES)
    # The library is in place, the objects are gone, and a second build
    # finds it.
    assert [p.name for p in (tmp_path / "build").iterdir()] == [cuda_build.lib_path().name]
    assert cuda_build.build() == 0.0
    assert len(log.read_text().splitlines()) == len(calls)


@pytest.mark.parametrize("fail", ["nvcc", "g++"])
def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path, fail):
    tools, _ = _fake_tools(tmp_path, fail=fail)
    _patch_tools(monkeypatch, tmp_path, tools)
    with pytest.raises(RuntimeError, match="broken source"):
        cuda_build.build()
    assert not list((tmp_path / "build").iterdir())  # no library, no leftovers


def test_an_operator_whose_library_fails_to_build_raises_every_time(monkeypatch):
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("kernel library build failed: nvcc: error")

    monkeypatch.setattr(cuda_build, "load", broken)
    monkeypatch.setattr(onehot, "_OPS", {})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="build failed"):
            onehot._ops()
    assert len(calls) == 2 and onehot._OPS == {}


def test_importing_the_port_builds_and_loads_nothing():
    code = (
        "import importlib, pkgutil, subprocess, torch\n"
        "def refuse(*a, **k):\n"
        "    raise SystemExit('subprocess or library load at import')\n"
        "subprocess.Popen = refuse\n"
        "torch.ops.load_library = refuse\n"
        "import corrosion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from corrosion_tpu_torch import cuda_build\n"
        "from corrosion_tpu_torch.ops import onehot\n"
        "assert cuda_build._loaded is None and onehot._OPS == {}\n"
        "assert not hasattr(torch.ops.corro, 'table_gather')\n"
        "print('nothing built')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO)),
    )
    assert res.returncode == 0 and res.stdout.strip() == "nothing built", res.stderr


def _cases():
    g = np.random.default_rng(5)
    r, m, w = 6, 7, 9
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64))  # noqa: E731
    idx = t(g.integers(-2, w + 2, (r, m)))
    val = t(g.integers(0, 1 << 32, (r, m), dtype=np.uint64).astype(np.int64))
    mask = torch.as_tensor(g.random((r, m)) < 0.7)
    table = t(g.integers(0, 1 << 32, (r, w), dtype=np.uint64).astype(np.int64))
    seen = t(g.integers(0, 1 << 20, (r, w)))
    d = t(g.integers(0, 40, (r, m)))
    oo = t(g.integers(0, 1 << 32, (1, r, w), dtype=np.uint64).astype(np.int64))
    adv = t(g.integers(0, 8, (r, m)))
    return {
        "rowmax": ((idx, val, mask, w), onehot.rowmax_plain),
        "rowsum": ((idx, val, mask, w), onehot.rowsum_plain),
        "rowgather": ((table, idx), onehot.rowgather_plain),
        "rowgather_wide": ((table, idx), onehot.rowgather_wide_plain),
        "table_gather": ((table[0], idx), onehot.table_gather_plain),
        "delivery_reduce": ((idx, d, val, mask & (d < 20), mask, seen, w),
                            onehot.delivery_reduce_plain),
        "window_delivery": ((oo, idx, d, adv, mask, 32, w), onehot.window_delivery_plain),
    }


@pytest.mark.parametrize("prim", sorted(onehot.LAUNCHES))
def test_cpu_tensors_take_the_plain_version_without_the_operators(monkeypatch, prim):
    def refuse(*_):
        raise AssertionError("the CPU route reached the kernel library")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(onehot, "_ops", refuse)
    args, plain = _cases()[prim]
    onehot.reset_launches()
    got, want = getattr(onehot, prim)(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(v == 0 for v in onehot.LAUNCHES.values())

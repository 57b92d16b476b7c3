"""Loader and builder of the native runtime components, built from the C
sources in ``native/`` at the repo root (counterpart of
corrosion_tpu/native.py).

Two artifacts, both optional at run time (pure-Python fallbacks exist
everywhere they are used):

- ``_corro_native``: CPython extension with the packed-PK codec, exact
  SQLite value ordering and the compact binary wire codec.
- ``crdt_ext.so``: SQLite run-time loadable extension with the CRDT SQL
  helpers (``crdt_value_cmp`` et al.).

``build()`` compiles both into ``build/native/`` with the host's C
compiler, using ``native/Makefile``'s flags, one artifact at a time: the
codec needs only Python's headers, the SQLite extension also needs
``sqlite3ext.h`` (``sqlite_header_dir``), and a missing header leaves
``crdt_ext_available()`` False without stopping the codec. Nothing is
built when the module is imported.

The codec is loaded by its path, under a dotted module name of this
package, and never as the top-level ``_corro_native``: that name may
already be bound in ``sys.modules`` to another build of the same
sources.
"""

from __future__ import annotations

import glob
import importlib.util
import os
import shutil
import sqlite3
import subprocess
import sys
import sysconfig
from types import ModuleType

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CODEC_PATH = os.path.join(BUILD_DIR, "_corro_native.so")
CRDT_EXT_PATH = os.path.join(BUILD_DIR, "crdt_ext")
# The module's name: its last part picks PyInit__corro_native.
MODULE_NAME = __name__.rsplit(".", 1)[0] + "._native._corro_native"
CFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-shared")  # native/Makefile's

# artifact: (C source, its other inputs)
_SOURCES = {
    CODEC_PATH: ("corro_native.c", ("corro_core.h",)),
    CRDT_EXT_PATH + ".so": ("crdt_ext.c", ("corro_core.h",)),
}


def _import_native() -> ModuleType | None:
    if not os.path.exists(CODEC_PATH):
        return None
    spec = importlib.util.spec_from_file_location(MODULE_NAME, CODEC_PATH)
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except ImportError:
        return None
    return mod


native = _import_native()


def available() -> bool:
    """True when the CPython codec module is loaded."""
    return native is not None


def crdt_ext_available() -> bool:
    return os.path.exists(CRDT_EXT_PATH + ".so")


def load_crdt_extension(conn: sqlite3.Connection) -> bool:
    """Load the CRDT SQL helpers into a connection; False if unavailable."""
    if not crdt_ext_available():
        return False
    try:
        conn.enable_load_extension(True)
        try:
            conn.load_extension(CRDT_EXT_PATH)
        finally:
            conn.enable_load_extension(False)
        return True
    except sqlite3.OperationalError:
        return False


def sqlite_header_dir() -> str | None:
    """Where ``sqlite3ext.h`` is, in native/Makefile's order (the include
    tree of an installed tensorflow wheel, then ``/usr/include``); None
    when neither holds it."""
    purelib = sysconfig.get_paths()["purelib"]
    candidates = glob.glob(
        os.path.join(purelib, "tensorflow", "include", "external", "org_sqlite")
    ) + ["/usr/include"]
    for d in candidates:
        if os.path.exists(os.path.join(d, "sqlite3ext.h")):
            return d
    return None


def _stale(out: str) -> bool:
    src, deps = _SOURCES[out]
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(
        os.path.getmtime(os.path.join(NATIVE_SRC, f)) > built for f in (src, *deps)
    )


def _compile(out: str, include: str, quiet: bool) -> bool:
    """One artifact, written under a private name then moved into place,
    so a concurrent reader never loads a half-written file."""
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return False
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cc, *CFLAGS, f"-I{include}", "-o", tmp, os.path.join(NATIVE_SRC, _SOURCES[out][0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        if not quiet:
            sys.stderr.write(proc.stdout + proc.stderr)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out)
    return True


def build_status() -> dict:
    """Which artifacts exist, and where the SQLite header was found."""
    return {
        "codec": os.path.exists(CODEC_PATH),
        "codec_loaded": native is not None,
        "crdt_ext": crdt_ext_available(),
        "sqlite_header": sqlite_header_dir(),
        "build_dir": BUILD_DIR,
    }


def build(quiet: bool = True) -> bool:
    """Compile the artifacts that are missing or older than their sources
    into ``BUILD_DIR``; True when every artifact whose headers were found
    is built. Safe to call repeatedly; never raises on a missing
    toolchain."""
    global native
    if not os.path.isdir(NATIVE_SRC):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    ok = True
    if _stale(CODEC_PATH):
        ok = _compile(CODEC_PATH, sysconfig.get_paths()["include"], quiet)
    header = sqlite_header_dir()
    if header is not None and _stale(CRDT_EXT_PATH + ".so"):
        ok = _compile(CRDT_EXT_PATH + ".so", header, quiet) and ok
    if native is None:
        native = _import_native()
    return ok and native is not None

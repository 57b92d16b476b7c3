"""Runtime ledger of the kernel library's build and load (counterpart of
corrosion_tpu/obs/ledger.py, the compile ledger).

The reference records every XLA compilation. The port compiles nothing at
run time but its kernel library: ``cuda_build.build`` runs nvcc and the
host compiler when no library of the sources' hash exists, and
``cuda_build.load`` loads it into the process. ``cuda_build`` tells its
listeners of each (``cuda_build.LISTENERS``), and this module turns them
into recorded, attributable, gateable events:

- **A ledger of events.** :class:`CompileLedger` registers one listener
  and fills per-window records (:meth:`CompileLedger.window`): how many
  builds and loads fired, their summed wall-ms, and which operators
  became available. The records flow into the flight recorder (``kind:
  "compile"``) and a metrics registry (``corro_kernel_compiles_total`` /
  ``corro_kernel_compile_ms``).
- **A tripwire.** :meth:`CompileLedger.arm` declares "everything is
  built and loaded now": a further build or load raises
  :class:`RetraceError` naming the window.

The port has no jitted functions and so no compile caches.
:func:`jitted_functions` reports what stands in their place, the
operators of the kernel library (``torch.ops.corro.<name>``, which every
engine module reaches through ``ops.onehot``), and :func:`cache_sizes`
says of each whether the loaded library holds it (1) or not (0): there is
no cache of several entries behind an operator. Their ``module``
argument, and so the engine of the watch set
(:meth:`CompileLedger.watch`, :meth:`CompileLedger.watch_engines`,
``ENGINE_MODULES``), filters nothing: every engine gives the same
operators. Nothing should build on it as if it did.

The library is built and loaded at most once a process (``cuda_build.load``
returns at once after the first load), so once it is loaded an armed
ledger cannot fire within that process: a zero count of armed compiles
there holds by construction, not by measurement. The tripwire catches a
first load (or a build) that happens after ``arm``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import torch

from corrosion_tpu_torch import cuda_build

#: Engine name -> module path: the four engine drivers.
ENGINE_MODULES = {
    "dense": "corrosion_tpu_torch.sim.engine",
    "sparse": "corrosion_tpu_torch.sim.sparse_engine",
    "chunk": "corrosion_tpu_torch.sim.chunk_engine",
    "mixed": "corrosion_tpu_torch.sim.mixed_engine",
}


class RetraceError(RuntimeError):
    """A kernel-library build or load fired while the ledger was armed."""


def jitted_functions(module) -> dict[str, str]:
    """The compiled entry points ``module`` reaches, by name: the kernel
    library's operators (operator name -> ``corro::<name>``). Every engine
    module reaches all of them through ``ops.onehot``, so the set is the
    same for each."""
    from corrosion_tpu_torch.ops import onehot

    del module
    return {name: f"corro::{name}" for name in onehot.OPERATORS}


def cache_sizes(fns: dict[str, str]) -> dict[str, int]:
    """1 for each operator of ``fns`` the loaded library registers, else
    0."""
    return {name: int(hasattr(torch.ops.corro, name)) for name in fns}


# One process-wide listener fanning out to the active ledgers.

_LISTENER_LOCK = threading.Lock()
_ACTIVE: list["CompileLedger"] = []


def _listener(kind: str, secs: float) -> None:
    for led in list(_ACTIVE):
        led._on_compile(kind, secs)


def _ensure_listener() -> None:
    with _LISTENER_LOCK:
        if _listener not in cuda_build.LISTENERS:
            cuda_build.LISTENERS.append(_listener)


@dataclass
class CompileWindow:
    """One observed scope: how many builds and loads fired (``compiles``,
    by kind in ``kinds``), their summed wall, and which operators became
    available (``fns``). A ``nested`` window is an inert placeholder (its
    events went to the enclosing window); ``published`` marks a window
    already folded into a registry."""

    label: str
    compiles: int = 0
    compile_ms: float = 0.0
    kinds: dict = field(default_factory=dict)  # "build"/"load" -> count
    fns: dict = field(default_factory=dict)  # operator name -> 1 when it appeared
    wall_ms: float = 0.0
    nested: bool = False
    published: bool = False

    def to_record(self) -> dict:
        """Flight-recorder line (``kind: "compile"``)."""
        return {
            "kind": "compile",
            "label": self.label,
            "compiles": self.compiles,
            "compile_ms": round(self.compile_ms, 3),
            "kinds": dict(self.kinds),
            "fns": dict(self.fns),
        }


class CompileLedger:
    """Records every kernel-library build and load, and arms the tripwire.

    Usage (the engines take it as ``telemetry.KernelTelemetry(ledger=...)``,
    which opens a window a chunk)::

        led = CompileLedger().watch_engines(("dense",))
        with led:
            with led.window("first_run") as w:
                run_once()          # builds and loads the library here
            compile_ms = w.compile_ms
            led.arm("timed run")
            run_again()             # RetraceError on any build or load
            led.disarm()
    """

    def __init__(self):
        self.watched: dict[str, str] = {}
        self.windows: list[CompileWindow] = []
        self.total_compiles = 0
        self.total_compile_ms = 0.0
        self.armed_compiles = 0
        self._armed: str | None = None
        self._current: CompileWindow | None = None
        self._active = False

    # -- watch set ---------------------------------------------------------

    def watch(self, module) -> "CompileLedger":
        """Merge the operators ``module`` reaches into the watch set."""
        self.watched.update(jitted_functions(module))
        return self

    def watch_engines(self, engines=tuple(ENGINE_MODULES)) -> "CompileLedger":
        import importlib

        for name in engines:
            self.watch(importlib.import_module(ENGINE_MODULES[name]))
        return self

    # -- activation --------------------------------------------------------

    def install(self) -> "CompileLedger":
        _ensure_listener()
        with _LISTENER_LOCK:
            if self not in _ACTIVE:
                _ACTIVE.append(self)
        self._active = True
        return self

    def uninstall(self) -> None:
        with _LISTENER_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        self._active = False

    def __enter__(self) -> "CompileLedger":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- the tap -----------------------------------------------------------

    def _on_compile(self, kind: str, secs: float) -> None:
        ms = secs * 1000.0
        self.total_compiles += 1
        self.total_compile_ms += ms
        win = self._current
        if win is not None:
            win.compiles += 1
            win.compile_ms += ms
            win.kinds[kind] = win.kinds.get(kind, 0) + 1
        if self._armed is not None:
            self.armed_compiles += 1
            where = f" in window {win.label!r}" if win is not None else ""
            raise RetraceError(
                f"steady-state kernel-library {kind} ({ms:.1f} ms){where}: the ledger "
                f"was armed ({self._armed}); the warm-up did not build and load it"
            )

    # -- windows -----------------------------------------------------------

    @contextlib.contextmanager
    def window(self, label: str):
        """Scope one dispatch; yields the :class:`CompileWindow` being
        filled (read it after the ``with`` exits). A window opened inside
        another attributes its events to the OUTER window and yields an
        inert ``nested`` placeholder."""
        if self._current is not None:
            yield CompileWindow(label=label, nested=True)
            return
        before = cache_sizes(self.watched)
        win = CompileWindow(label=label)
        self._current = win
        t0 = time.perf_counter()
        try:
            yield win
        finally:
            win.wall_ms = (time.perf_counter() - t0) * 1000.0
            self._current = None
            after = cache_sizes(self.watched)
            win.fns = {
                name: after[name] - before.get(name, 0)
                for name in after if after[name] > before.get(name, 0)
            }
            self.windows.append(win)
        # Operators that appeared without a load the tap saw (a library
        # loaded behind cuda_build's back) are a violation under arms too.
        if self._armed is not None and win.fns and not win.compiles:
            self.armed_compiles += 1
            raise RetraceError(
                f"steady-state library load in window {win.label!r}: operators "
                f"{win.fns} appeared while the ledger was armed ({self._armed})"
            )

    # -- tripwire ----------------------------------------------------------

    def arm(self, reason: str = "steady state") -> None:
        """Declare the warm-up over: any further build or load raises
        :class:`RetraceError`."""
        if not self._active:
            self.install()
        self._armed = reason

    def disarm(self) -> None:
        self._armed = None

    @property
    def armed(self) -> bool:
        return self._armed is not None

    # -- outputs -----------------------------------------------------------

    def publish_window(self, registry, win: CompileWindow, engine: str = "dense") -> None:
        """Fold ONE window into a metrics registry and mark it published:
        ``corro_kernel_compiles_total{engine,fn}`` (an ``fn="(unwatched)"``
        bucket carries events no new operator accounts for) and
        ``corro_kernel_compile_ms{engine}``."""
        if win.nested or win.published:
            return
        win.published = True
        per_fn = dict(win.fns)
        accounted = sum(per_fn.values())
        if win.compiles > accounted:
            per_fn["(unwatched)"] = win.compiles - accounted
        if per_fn:
            c = registry.counter(
                "corro_kernel_compiles_total",
                "kernel plane: kernel-library builds and loads (ledger)",
            )
            for name, cnt in per_fn.items():
                c.inc(float(cnt), engine=engine, fn=name)
        if win.compile_ms:
            registry.counter(
                "corro_kernel_compile_ms",
                "kernel plane: summed kernel-library build and load wall (ms)",
            ).inc(win.compile_ms, engine=engine)

    def publish(self, registry, engine: str = "dense") -> None:
        """Fold every not-yet-published window into the registry."""
        for w in self.windows:
            self.publish_window(registry, w, engine=engine)

    def compile_counts(self) -> dict[str, int]:
        """Cumulative count per watched operator of the windows in which
        it appeared."""
        out: dict[str, int] = {}
        for w in self.windows:
            for name, cnt in w.fns.items():
                out[name] = out.get(name, 0) + cnt
        return out

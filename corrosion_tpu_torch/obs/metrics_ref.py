"""Metrics-name drift check: the documented series set vs reality
(counterpart of corrosion_tpu/obs/metrics_ref.py; the port's
``_PKG_ROOT`` and publishers).

docs/OBSERVABILITY.md carries a reference table of every ``corro_*``
metric/gauge/histogram name this codebase can register (between the
``metrics-ref-begin``/``-end`` markers). This module computes the
ground-truth set two ways and unions them:

- **Static**: an AST walk over the package finds every
  ``registry.counter/gauge/histogram("literal", ...)`` call — the agent
  / transport / pool / loadgen planes register by literal name.
- **Runtime**: the kernel-side publishers build names with f-strings
  (``telemetry.publish_curves`` via ``series_name``,
  ``health.publish_report``, ``epidemic.publish_epidemic``), so those
  paths are exercised against a throwaway registry and the resulting
  names collected.

``tests/test_observability.py`` asserts documented == registered, so a
new metric cannot land undocumented, and a doc row cannot outlive its
series. The port registers exactly the reference's names.
"""

from __future__ import annotations

import ast
import os
import re

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOC_BEGIN = "<!-- metrics-ref-begin -->"
DOC_END = "<!-- metrics-ref-end -->"

_REG_METHODS = {"counter", "gauge", "histogram"}


def static_metric_names(root: str = _PKG_ROOT) -> set[str]:
    """Every literal first argument of a ``.counter()`` / ``.gauge()`` /
    ``.histogram()`` call in the package source that names a ``corro_*``
    series."""
    names: set[str] = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError:
                    continue
            for node in ast.walk(tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REG_METHODS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    continue
                name = node.args[0].value
                if name.startswith("corro_"):
                    names.add(name)
    return names


def kernel_metric_names() -> set[str]:
    """Names the kernel-side publishers register dynamically: exercise
    ``publish_curves`` (full canonical key set), ``publish_report``,
    ``publish_epidemic``, and the process self-observability gauges
    against a fresh registry and collect what landed."""
    import numpy as np

    from corrosion_tpu_torch.obs import epidemic
    from corrosion_tpu_torch.sim import health
    from corrosion_tpu_torch.sim import telemetry as T
    from corrosion_tpu_torch.utils.metrics import (
        MetricsRegistry,
        register_process_gauges,
    )

    reg = MetricsRegistry()
    curves = {k: np.ones(2) for k in T.ROUND_CURVE_KEYS}
    T.publish_curves(reg, curves)
    health.publish_report(reg, health.ConvergenceReport())
    epidemic.publish_epidemic(reg, epidemic.build_report(curves))
    register_process_gauges(reg)
    return set(reg._metrics)


def registered_metric_names() -> set[str]:
    """The complete registrable series set (static literals + the
    dynamically-built kernel names)."""
    return static_metric_names() | kernel_metric_names()


def documented_metric_names(docs_path: str) -> set[str]:
    """Every ``corro_*`` token between the metrics-ref markers of
    docs/OBSERVABILITY.md. Raises when the markers are missing — a
    deleted table must fail the drift test loudly, not vacuously."""
    with open(docs_path, encoding="utf-8") as f:
        text = f.read()
    try:
        block = text.split(DOC_BEGIN, 1)[1].split(DOC_END, 1)[0]
    except IndexError:
        raise ValueError(
            f"{docs_path}: metrics reference markers "
            f"{DOC_BEGIN!r}/{DOC_END!r} not found"
        ) from None
    return set(re.findall(r"corro_[a-z0-9_]+", block))


def render_reference(names: set[str]) -> str:
    """The marker block body for docs/OBSERVABILITY.md — one backticked
    name per line, sorted (regenerate the docs table from this when a
    metric is added)."""
    return "\n".join(f"`{n}`" for n in sorted(names))

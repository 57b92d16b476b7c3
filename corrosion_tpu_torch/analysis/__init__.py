"""Static-analysis plane: kernel-purity, schema-parity, and concurrency
lints (`corrosion lint`), plus the runtime promotion/NaN/rebuild
sanitizer (counterpart of corrosion_tpu/analysis).

The telemetry plane (sim/telemetry.py) and the convergence-health plane
(sim/health.py) observe what the kernels *do*; this package guards the
code that produces those numbers. Six pillars, each a module:

- ``purity``: AST lints over the kernel modules (``ops/`` and the
  ``sim/*engine*.py`` round bodies) for host-trip, implicit-sync and
  dtype hazards — ``.cpu()``/``.numpy()``/``.tolist()``, ``int()``/
  ``.item()`` on a tensor, ``if t.any():``, a dtype-less
  ``torch.zeros`` — the bug classes that silently serialize the card
  every round (and keep the round out of a CUDA graph).
- ``schema``: statically extracts the telemetry keys each engine's round
  body emits and diffs them against the canonical ``ROUND_CURVE_KEYS``.
- ``concurrency``: blocking calls under held locks and lock-acquisition-
  order cycles in the host agent plane.
- ``asynclint``: asyncio race & lifecycle lints over the agent plane
  (CT040-CT043).
- ``clonemap``: the engine-clone drift gate (CT050-CT052) over the
  port's own ``SEAM_MAP.json``.
- ``determinism``: determinism-taint lints (CT060-CT062), with torch's
  unseeded sources (``torch.rand``/``randint``/``randn``/``randperm``
  without ``generator=``).

``runner.lint_paths`` orchestrates all of them over a file tree;
``sanitize.sanitize_engines`` is the runtime companion (a dispatch mode
that raises at the first mixed-dtype operation or NaN, and a rebuild
tripwire over the kernel library). Rule ids, rationale, and the
``# corro-lint: disable=CT0xx reason=...`` suppression syntax are
documented in docs/ANALYSIS.md.

Everything except ``sanitize`` is pure stdlib (ast/tokenize) — linting
never imports torch, so `corrosion lint` stays fast and runs anywhere.
"""

from corrosion_tpu_torch.analysis.findings import RULES, Finding  # noqa: F401
from corrosion_tpu_torch.analysis.runner import LintResult, lint_paths  # noqa: F401

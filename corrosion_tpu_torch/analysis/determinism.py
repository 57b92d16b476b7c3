"""Determinism taint lints (CT060-CT062) (counterpart of
corrosion_tpu/analysis/determinism.py).

Three replay contracts currently hold by convention only: traced kernel
code must not bake per-process values into the graph, the netem/fault
schedule planes promise *pure-hash* impairment (docs/CHAOS.md — exact
replay from seed+coordinates), and every committed ``corro-*/N``
artifact feeds a baseline diff gate that is meaningless unless the
bytes are deterministic. These rules make the conventions mechanical:

* CT060 — nondeterministic source (wall clock, ``random``, ``uuid``,
  ``os.urandom``, ``secrets``, builtin ``hash``, unseeded
  ``np.random.default_rng()``, and torch's global generator:
  ``torch.rand``/``randint``/``randn``/``randperm`` and kin without
  ``generator=``) or set-order iteration inside a kernel function. The
  value differs per process/run, so replays silently disagree; the port
  draws through ``rng`` (threefry from an explicit key) and explicit
  generators.
* CT061 — the same sources anywhere in a declared deterministic-schedule
  module: ``agent/netem.py`` and ``sim/faults.py`` by path, or any
  fixture carrying ``# corro-lint: deterministic-module``. Injected
  generators are fine (a parameter named ``rng`` is the caller's
  problem); *creating* entropy locally is not.
* CT062 — the same sources inside a function that also contains a
  ``corro-<name>/<N>`` format-tag literal, i.e. an artifact emit site.

Set-order iteration means a ``for`` loop directly over a set literal,
set/frozenset() call, or set comprehension — string hashes vary with
PYTHONHASHSEED, so iteration order varies per process. Wrapping in
``sorted()`` is the fix and passes.
"""

from __future__ import annotations

import ast
import re

from corrosion_tpu_torch.analysis.concurrency import _walk_no_defs
from corrosion_tpu_torch.analysis.findings import Finding
from corrosion_tpu_torch.analysis.source import SourceModule, dotted_name

DETERMINISTIC_MARKER = re.compile(
    r"(?m)^\s*#\s*corro-lint:\s*deterministic-module\s*$"
)
# Modules whose outputs are contractually pure functions of
# seed+coordinates (docs/CHAOS.md "Determinism contracts").
_SCHEDULE_FILES = (("agent", "netem.py"), ("sim", "faults.py"))

ARTIFACT_RE = re.compile(r"^corro-[a-z0-9-]+/\d+$")

# dotted name (exact or dotted-prefix "x.") -> why it is nondeterministic
_NONDET = {
    "time.time": "wall clock",
    "time.time_ns": "wall clock",
    "datetime.now": "wall clock",
    "datetime.utcnow": "wall clock",
    "datetime.datetime.now": "wall clock",
    "datetime.datetime.utcnow": "wall clock",
    "random.": "process-seeded global RNG",
    "np.random.": "process-seeded global RNG",
    "numpy.random.": "process-seeded global RNG",
    "os.urandom": "kernel entropy",
    "secrets.": "kernel entropy",
    "uuid.uuid1": "host+clock-derived id",
    "uuid.uuid4": "kernel entropy",
    "hash": "PYTHONHASHSEED-dependent for str/bytes",
}
# Exceptions: explicitly seeded constructions are deterministic.
_SEEDED_OK = ("default_rng", "Generator", "RandomState", "seed", "PRNGKey")
# torch draws from its process-global generator unless given
# ``generator=`` (the *_like forms take none).
_TORCH_GLOBAL_RNG = {
    "torch.rand", "torch.randint", "torch.randn", "torch.randperm",
    "torch.rand_like", "torch.randint_like", "torch.randn_like",
    "torch.bernoulli", "torch.multinomial", "torch.normal", "torch.poisson",
}


def is_schedule_module(mod: SourceModule) -> bool:
    parts = mod.path.replace("\\", "/").split("/")
    for pkg, name in _SCHEDULE_FILES:
        if parts[-1] == name and pkg in parts[:-1]:
            return True
    return bool(DETERMINISTIC_MARKER.search(mod.text))


def _nondet_reason(call: ast.Call) -> str | None:
    fname = dotted_name(call.func)
    if not fname:
        return None
    if fname in _TORCH_GLOBAL_RNG:
        if any(kw.arg == "generator" for kw in call.keywords):
            return None
        return "process-seeded global RNG (torch, no generator=)"
    last = fname.split(".")[-1]
    if last in _SEEDED_OK and (call.args or call.keywords):
        return None  # seeded/keyed: deterministic by construction
    for prefix, why in _NONDET.items():
        if fname == prefix or (prefix.endswith(".") and
                               fname.startswith(prefix)):
            if last in _SEEDED_OK and not (call.args or call.keywords):
                return f"{why} (unseeded `{fname}()`)"
            return why
    return None


def _set_iteration(node: ast.For | ast.AsyncFor) -> bool:
    it = node.iter
    if isinstance(it, (ast.Set, ast.SetComp)):
        return True
    if isinstance(it, ast.Call):
        return dotted_name(it.func) in ("set", "frozenset")
    return False


def _scan_scope(fn: ast.AST) -> list[tuple[int, int, str]]:
    """(line, col, why) nondeterminism events lexically in ``fn``,
    not descending into nested defs (they are scanned as their own
    scopes)."""
    events: list[tuple[int, int, str]] = []
    for node in _walk_no_defs(fn):
        if isinstance(node, ast.Call):
            why = _nondet_reason(node)
            if why:
                events.append((
                    node.lineno, node.col_offset,
                    f"`{dotted_name(node.func)}`: {why}",
                ))
        elif isinstance(node, (ast.For, ast.AsyncFor)) and \
                _set_iteration(node):
            events.append((
                node.lineno, node.col_offset,
                "iteration over a set: order varies with PYTHONHASHSEED "
                "(wrap in sorted())",
            ))
    return events


def _artifact_tags(fn: ast.AST) -> list[str]:
    tags = []
    for node in _walk_no_defs(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ARTIFACT_RE.match(node.value):
            tags.append(node.value)
    return tags


def check_determinism(mod: SourceModule) -> list[Finding]:
    findings: list[Finding] = []
    schedule = is_schedule_module(mod)

    for info in mod.functions:
        events = None
        if info.traced and mod.is_kernel:
            events = events if events is not None else _scan_scope(info.node)
            for line, col, what in events:
                findings.append(Finding(
                    rule="CT060", path=mod.path, line=line, col=col,
                    message=f"{what} in traced `{info.qualname}` — baked "
                    "at trace time, differs per process/run",
                ))
        if schedule:
            events = events if events is not None else _scan_scope(info.node)
            for line, col, what in events:
                findings.append(Finding(
                    rule="CT061", path=mod.path, line=line, col=col,
                    message=f"{what} in deterministic-schedule module — "
                    "schedules must be pure functions of "
                    "seed+coordinates (docs/CHAOS.md)",
                ))
        tags = _artifact_tags(info.node)
        if tags:
            events = events if events is not None else _scan_scope(info.node)
            for line, col, what in events:
                findings.append(Finding(
                    rule="CT062", path=mod.path, line=line, col=col,
                    message=f"{what} in `{info.qualname}`, which emits "
                    f"`{tags[0]}` — committed artifacts must be "
                    "byte-deterministic for their diff gates to hold",
                ))

    # Module-level statements of a schedule module are part of the
    # contract too (import-time entropy is still entropy).
    if schedule:
        mod_level = ast.Module(body=[
            n for n in mod.tree.body
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
        ], type_ignores=[])
        for line, col, what in _scan_scope(mod_level):
            findings.append(Finding(
                rule="CT061", path=mod.path, line=line, col=col,
                message=f"{what} at module scope of a "
                "deterministic-schedule module",
            ))
    return findings

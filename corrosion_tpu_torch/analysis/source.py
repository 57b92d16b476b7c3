"""Shared source model for the lint rules (counterpart of
corrosion_tpu/analysis/source.py).

``SourceModule`` parses one file and answers the questions every rule
needs: which functions are *traced* — kernel code, where a host trip or
a Python branch on a tensor value is a real hazard: jit-decorated
functions and scan/cond/while bodies (the reference's forms, which the
lint fixtures still use), the round bodies of the ``sim/*engine*.py``
drivers (a function that builds the round's stats through
``round_curves(...)``), and anything nested in one — which parameters are
static (jit's ``static_argnames``, and parameters annotated ``int``,
``float``, ``bool`` or ``str``: host scalars), which traced functions are
*host-only* code, and which findings are suppressed by
``# corro-lint: disable=CT0xx reason=...`` comments.

Kernel-module classification is path-based (``ops/`` and the
``sim/*engine*.py`` drivers) with a marker-comment escape hatch
(``# corro-lint: kernel-module`` / ``# corro-lint: engine-module``) so
test fixtures outside the package opt in explicitly. In ``ops/``
modules every function is PRESUMED traced: the package is the kernel
namespace, and host-side helpers (topology builders, ground-truth
references) must carry a reasoned suppression — that asymmetry is the
point, host code in the kernel namespace should be loud. The port's
reading adds one exemption: a presumed function whose own body never
names ``torch`` nor calls ``.cpu()``/``.cuda()``/``.numpy()``/``.item()``
is host-only code (numpy in, numpy out, no tensor), such as a
topology builder, and the host-trip rules skip it
(:attr:`FunctionInfo.host_only`).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field

SUPPRESS_RE = re.compile(
    r"#\s*corro-lint:\s*disable=([A-Z0-9,\s]+?)\s*(?:reason=(.+))?$"
)
# Marker comments must stand alone on a line: matching the bare substring
# would self-trigger on any file that mentions the marker (this one).
KERNEL_MARKER = re.compile(r"(?m)^\s*#\s*corro-lint:\s*kernel-module\s*$")
ENGINE_MARKER = re.compile(r"(?m)^\s*#\s*corro-lint:\s*engine-module\s*$")

# sim drivers whose scan bodies emit the canonical RoundCurves schema.
ENGINE_FILES = ("engine.py", "sparse_engine.py", "chunk_engine.py",
                "mixed_engine.py")

# jax control-flow primitives whose function arguments run inside the
# trace: any locally-defined function passed to one is a traced body.
_TRACING_CALLS = ("scan", "cond", "while_loop", "fori_loop", "map",
                  "switch", "associative_scan")

# Parameter annotations that make a parameter a host scalar.
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str"}
# Method calls that only a tensor answers: a function making one is not
# host-only code.
_TENSOR_METHODS = {"cpu", "cuda", "numpy", "item"}


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('jax.lax.scan',
    'self._read_lock', ...); '' when it isn't a plain name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclass
class Suppression:
    line: int
    rules: set[str]
    reason: str


@dataclass
class FunctionInfo:
    node: ast.AST
    qualname: str
    parent: "FunctionInfo | None"
    traced: bool = False
    # 'jit' | 'scan-body' | 'nested' | 'presumed' | 'round-body'
    traced_why: str = ""
    static_params: set[str] = field(default_factory=set)
    host_only: bool = False

    @property
    def explicit_traced(self) -> bool:
        """Traced by construction (jit/scan-body/nested), not by the
        ops-namespace presumption or the round-body reading — the set
        whose traced *parameters* CT005 branches on."""
        return self.traced and self.traced_why in ("jit", "scan-body", "nested")


def _static_argnames(call: ast.Call) -> set[str]:
    for kw in call.keywords:
        if kw.arg in ("static_argnames", "static_argnums") and isinstance(
            kw.value, (ast.Tuple, ast.List)
        ):
            return {
                e.value for e in kw.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
    return set()


def _jit_decoration(dec: ast.AST) -> tuple[bool, set[str]]:
    """(is_jit, static_argnames) for one decorator expression. Handles
    ``@jax.jit``, ``@jit``, ``@partial(jax.jit, static_argnames=...)``
    and ``@jax.jit(...)`` forms."""
    name = dotted_name(dec)
    if name in ("jit", "jax.jit"):
        return True, set()
    if isinstance(dec, ast.Call):
        fname = dotted_name(dec.func)
        if fname in ("jit", "jax.jit"):
            return True, _static_argnames(dec)
        if fname in ("partial", "functools.partial") and dec.args:
            inner = dotted_name(dec.args[0])
            if inner in ("jit", "jax.jit"):
                return True, _static_argnames(dec)
    return False, set()


def _scalar_params(fn: ast.AST) -> set[str]:
    """Parameters annotated as host scalars (``n: int``)."""
    a = fn.args
    return {
        p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
        if isinstance(p.annotation, ast.Name)
        and p.annotation.id in _SCALAR_ANNOTATIONS
    }


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn``'s own body, not of its nested defs (they are
    judged as their own scopes)."""
    from corrosion_tpu_torch.analysis.concurrency import _walk_no_defs

    return _walk_no_defs(fn)


def _calls_round_curves(fn: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call)
        and dotted_name(n.func).split(".")[-1] == "round_curves"
        for n in _own_nodes(fn)
    )


def _host_only(fn: ast.AST) -> bool:
    """Numpy in, numpy out: the body never names ``torch`` and calls no
    tensor-only method."""
    for n in _own_nodes(fn):
        if isinstance(n, ast.Name) and n.id == "torch":
            return False
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in _TENSOR_METHODS):
            return False
    return True


class SourceModule:
    def __init__(self, path: str, text: str | None = None):
        self.path = path
        if text is None:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.is_kernel = self._classify_kernel()
        self.is_engine = self._classify_engine()
        self.suppressions: list[Suppression] = []
        self.bad_suppressions: list[tuple[int, str]] = []
        self._parse_suppressions()
        self.functions: list[FunctionInfo] = []
        self._func_of: dict[ast.AST, FunctionInfo] = {}
        self._classify_functions()

    # -- module classification ------------------------------------------

    def _classify_kernel(self) -> bool:
        parts = self.path.replace("\\", "/").split("/")
        if KERNEL_MARKER.search(self.text) or ENGINE_MARKER.search(self.text):
            return True
        if "ops" in parts[:-1]:
            return True
        return parts[-1] in ENGINE_FILES and "sim" in parts[:-1]

    def _classify_engine(self) -> bool:
        parts = self.path.replace("\\", "/").split("/")
        if ENGINE_MARKER.search(self.text):
            return True
        return parts[-1] in ENGINE_FILES and "sim" in parts[:-1]

    @property
    def presume_traced(self) -> bool:
        """ops/ modules (and kernel-marked fixtures): every function is
        kernel code unless a suppression says otherwise."""
        return self.is_kernel and not self.is_engine

    # -- suppressions ---------------------------------------------------

    def _parse_suppressions(self) -> None:
        from corrosion_tpu_torch.analysis.findings import RULES

        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            comments = [
                (t.start[0], t.string) for t in tokens
                if t.type == tokenize.COMMENT
            ]
        except tokenize.TokenError:
            comments = []
        for line, comment in comments:
            m = SUPPRESS_RE.search(comment)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            unknown = sorted(r for r in rules if r not in RULES)
            if unknown:
                self.bad_suppressions.append(
                    (line, f"unknown rule id(s) {unknown} in suppression")
                )
                continue
            if not reason:
                self.bad_suppressions.append(
                    (line, "suppression without a reason= string "
                     "(reasons are mandatory; the suppression is ignored)")
                )
                continue
            self.suppressions.append(Suppression(line, rules, reason))

    def suppression_for(self, rule: str, line: int) -> Suppression | None:
        """Line-level suppression at ``line``, or a scope-level one from
        the header zone (decorators/def line, or the line just above) of
        any enclosing function/class."""
        for s in self.suppressions:
            if rule in s.rules and s.line == line:
                return s
        for node in ast.walk(self.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            end = getattr(node, "end_lineno", node.lineno)
            if not (node.lineno <= line <= end):
                continue
            first = min(
                [node.lineno] + [d.lineno for d in node.decorator_list]
            )
            header = range(first - 1, node.body[0].lineno)
            for s in self.suppressions:
                if rule in s.rules and s.line in header:
                    return s
        return None

    # -- traced-function classification ---------------------------------

    def _classify_functions(self) -> None:
        # Pass 1: collect functions with parent links; jit decorations.
        def visit(node: ast.AST, parent: FunctionInfo | None, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    info = FunctionInfo(child, qual, parent)
                    info.static_params |= _scalar_params(child)
                    for dec in child.decorator_list:
                        is_jit, statics = _jit_decoration(dec)
                        if is_jit:
                            info.traced = True
                            info.traced_why = "jit"
                            info.static_params |= statics
                    self.functions.append(info)
                    self._func_of[child] = info
                    visit(child, info, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, parent, f"{prefix}{child.name}.")
                else:
                    visit(child, parent, prefix)

        visit(self.tree, None, "")

        # Pass 2: functions handed to jax control-flow primitives are
        # traced bodies. Resolve Name arguments to local defs by scope.
        by_name: dict[str, list[FunctionInfo]] = {}
        for info in self.functions:
            by_name.setdefault(info.node.name, []).append(info)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            if fname.split(".")[-1] not in _TRACING_CALLS or (
                "." in fname and "lax" not in fname and "jax" not in fname
            ):
                continue
            if fname == "map":
                continue  # builtin map(), not lax.map (dotted)
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in by_name:
                    for cand in by_name[arg.id]:
                        if not cand.traced:
                            cand.traced = True
                            cand.traced_why = "scan-body"

        # Pass 3: propagate — nested inside traced => traced; ops/
        # presumption marks everything else.
        changed = True
        while changed:
            changed = False
            for info in self.functions:
                if not info.traced and info.parent and info.parent.traced:
                    info.traced = True
                    info.traced_why = "nested"
                    changed = True
        # Round bodies of the engine drivers (and what they nest): the
        # port runs them eagerly, so no decorator marks them.
        if self.is_engine:
            for info in self.functions:
                if not info.traced and _calls_round_curves(info.node):
                    info.traced = True
                    info.traced_why = "round-body"
            changed = True
            while changed:
                changed = False
                for info in self.functions:
                    if (not info.traced and info.parent
                            and info.parent.traced_why == "round-body"):
                        info.traced = True
                        info.traced_why = "round-body"
                        changed = True
        if self.presume_traced:
            for info in self.functions:
                if not info.traced:
                    info.traced = True
                    info.traced_why = "presumed"
        for info in self.functions:
            info.host_only = info.traced_why == "presumed" and _host_only(info.node)

    def enclosing_function(self, node: ast.AST) -> FunctionInfo | None:
        """FunctionInfo whose body lexically contains ``node`` (innermost)."""
        best: FunctionInfo | None = None
        line = getattr(node, "lineno", None)
        if line is None:
            return None
        for info in self.functions:
            f = info.node
            end = getattr(f, "end_lineno", f.lineno)
            if f.lineno <= line <= end:
                if best is None or f.lineno >= best.node.lineno:
                    best = info
        return best

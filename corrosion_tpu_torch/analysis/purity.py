"""Kernel-purity lints (CT001-CT005) over kernel modules (counterpart of
corrosion_tpu/analysis/purity.py, retargeted at torch).

The port runs each round eagerly on the card, so its hazards are the
ones that serialize the device against the host every round (and keep
the round out of a CUDA graph): host round-trips, implicit syncs, and
dtype drift from torch's float32 default. Each rule keeps the
reference's id and scope and adds torch's form of the hazard:

- CT001 (host trip): ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``nonzero`` (its output size is read on the host), or ``np.*`` inside a
  kernel function;
- CT002 (local numpy import): as in the reference;
- CT003 (dtype-less constructor): ``torch.tensor``/``zeros``/``ones``/
  ``full``/``empty`` without ``dtype=`` (the port's planes are int64;
  torch's default is float32), module-wide in kernel modules, and the
  reference's ``jnp`` forms;
- CT004 (coercion): ``int()``/``float()``/``bool()`` of a non-static
  value or ``.item()`` inside a kernel function;
- CT005 (branch on a tensor value): an ``if``/``while`` whose test calls
  a tensor reduction or comparison (``if t.any():``, ``while
  (x > 0).sum():``, ``if torch.equal(a, b):``) inside a kernel function
  — an implicit sync; and, as in the reference, a branch on a traced
  parameter of an explicitly traced (jit or scan-body) function.

Kernel functions are every function of an ``ops/`` module (presumed),
the round bodies of the ``sim/*engine*.py`` drivers, and jit-decorated
or scan-body functions (the reference's forms); see ``source``. A
presumed function that is host-only code (numpy in, numpy out: it never
names ``torch`` nor calls a tensor-only method) is exempt
from CT001, CT004 and CT005's tensor form — a topology builder is not a
host trip. The port's deliberate syncs (``gossip._branch`` and the
drop-scatter helper, which ``HOST_SYNCS`` counts) carry scope
suppressions with a reason. Annotated host-scalar parameters (``slot:
int``) are static, like jit's ``static_argnames``; shape/dtype attribute
tests and ``is None`` checks are static too.
"""

from __future__ import annotations

import ast

from corrosion_tpu_torch.analysis.findings import Finding
from corrosion_tpu_torch.analysis.source import FunctionInfo, SourceModule, dotted_name

# Constructors that take an optional dtype and default to promotion-prone
# widths. *_like/asarray/as_tensor/arange are excluded: _like preserves
# dtype, asarray/as_tensor convert an existing array, and arange's int
# default is stable (documented in docs/ANALYSIS.md).
_DTYPE_CTORS = {"array", "zeros", "ones", "full", "empty"}
_TORCH_DTYPE_CTORS = {"tensor", "zeros", "ones", "full", "empty"}
# positional index where dtype may appear per jnp ctor (torch's dtype is
# keyword-only).
_DTYPE_POS = {"array": 1, "zeros": 1, "ones": 1, "empty": 1, "full": 2}

_COERCIONS = {"float", "int", "bool"}
_COERCION_METHODS = {"item"}
# ``nonzero``'s output size is read on the host.
_HOST_TRIP_METHODS = {"cpu", "numpy", "tolist", "nonzero"}
# Calls in a branch test that read a tensor's value: reductions and
# whole-tensor comparisons.
_VALUE_METHODS = {"any", "all", "sum", "max", "min", "amax", "amin",
                  "prod", "count_nonzero", "equal", "allclose", "item"}
# torch functions whose result is static (no device read).
_STATIC_TORCH = {"torch.is_tensor", "torch.is_floating_point",
                 "torch.is_complex", "torch.device", "torch.dtype",
                 "torch.Size", "torch.iinfo", "torch.finfo"}
_HOST_ROOTS = {"np", "numpy", "math", "builtins"}

# attribute reads that are static at trace time even on traced values.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "sharding", "device"}


def _has_dtype(call: ast.Call, ctor: str) -> bool:
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    return len(call.args) > _DTYPE_POS[ctor]


def _is_constant_expr(node: ast.AST) -> bool:
    return all(
        isinstance(
            n,
            (ast.Constant, ast.Tuple, ast.List, ast.UnaryOp, ast.BinOp,
             ast.USub, ast.UAdd, ast.operator, ast.unaryop, ast.Load),
        )
        for n in ast.walk(node)
    )


def _static_only_test(test: ast.AST, fn: FunctionInfo) -> bool:
    """True when a branch test cannot involve a traced value: `is None`
    comparisons, isinstance/len on anything, shape/dtype attribute
    chains, and names in jit static_argnames."""
    static_names: set[str] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return True
        if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "isinstance", "len", "hasattr", "getattr"
        ):
            return True
        # `x is None` / `x is not None` tests identity of the pytree
        # structure, which is static at trace time — names under such a
        # Compare never witness a traced *value*.
        if isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            static_names |= {
                n.id for n in ast.walk(node) if isinstance(n, ast.Name)
            }
    names = {
        n.id for n in ast.walk(test) if isinstance(n, ast.Name)
    }
    params = _param_names(fn)
    hits = (names - static_names) & params
    return not hits or hits <= fn.static_params


def _reads_tensor_value(test: ast.AST) -> str | None:
    """The call whose tensor value a branch test's truth comes from
    (``t.any()``, ``torch.equal(a, b)``), or None. The walk does not enter
    the arguments of any other call: there a function decides the truth
    (``_branch(t.any())``, the port's counted sync; ``len(...)``)."""
    stack = [test]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            root = name.split(".")[0] if name else ""
            if name.startswith("torch.") and name not in _STATIC_TORCH \
                    and not name.startswith("torch.cuda."):
                return name
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _VALUE_METHODS
                    and root not in _HOST_ROOTS):
                return f".{node.func.attr}()"
            if isinstance(node.func, ast.Attribute):
                stack.append(node.func.value)
            continue
        stack.extend(ast.iter_child_nodes(node))
    return None


def _param_names(fn: FunctionInfo) -> set[str]:
    a = fn.node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def check_purity(mod: SourceModule) -> list[Finding]:
    if not mod.is_kernel:
        return []
    out: list[Finding] = []
    # value-position Attribute nodes: `np.random.default_rng` should fire
    # once (outermost), not once per link of the chain.
    inner_attrs = {
        id(n.value) for n in ast.walk(mod.tree)
        if isinstance(n, ast.Attribute)
    }

    def add(rule: str, node: ast.AST, msg: str) -> None:
        out.append(
            Finding(rule=rule, path=mod.path, line=node.lineno,
                    col=node.col_offset, message=msg)
        )

    for node in ast.walk(mod.tree):
        # CT002: function-local numpy import anywhere in a kernel module.
        if isinstance(node, ast.Import):
            fn = mod.enclosing_function(node)
            if fn is not None:
                for alias in node.names:
                    if alias.name == "numpy" or alias.name.startswith(
                        "numpy."
                    ):
                        add(
                            "CT002", node,
                            f"function-local `import {alias.name}` in "
                            f"kernel function {fn.qualname}; hoist to "
                            "module scope or suppress with a reason",
                        )

        # CT003: dtype-less literal constructors, module-wide.
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            parts = fname.split(".")
            jnp_ctor = (
                len(parts) == 2
                and parts[0] in ("jnp", "jax_numpy")
                and parts[1] in _DTYPE_CTORS
                and not _has_dtype(node, parts[1])
            )
            torch_ctor = (
                len(parts) == 2
                and parts[0] == "torch"
                and parts[1] in _TORCH_DTYPE_CTORS
                and not any(kw.arg == "dtype" for kw in node.keywords)
            )
            if jnp_ctor or torch_ctor:
                add(
                    "CT003", node,
                    f"`{fname}(...)` without an explicit dtype; default "
                    "promotion drifts downstream widths — state it",
                )

        fn = mod.enclosing_function(node)
        traced = fn is not None and fn.traced
        if not traced or fn.host_only:
            continue

        # CT001: numpy usage, or a tensor's trip to the host.
        if isinstance(node, ast.Attribute) and id(node) not in inner_attrs:
            root = node
            while isinstance(root.value, ast.Attribute):
                root = root.value
            if isinstance(root.value, ast.Name) and root.value.id in (
                "np", "numpy"
            ):
                add(
                    "CT001", node,
                    f"numpy reference `{dotted_name(node)}` inside traced "
                    f"function {fn.qualname} — host-trip hazard",
                )
        if isinstance(node, ast.Call) and (
            dotted_name(node.func) == "torch.nonzero"
            or (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_TRIP_METHODS
                and not node.args)
        ):
            what = dotted_name(node.func) if dotted_name(node.func) == \
                "torch.nonzero" else f".{node.func.attr}()"
            add(
                "CT001", node,
                f"`{what}` inside kernel function "
                f"{fn.qualname} — a host round-trip (device sync) per call",
            )

        # CT004: host coercions of (potentially) traced values.
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname in _COERCIONS and node.args:
                arg = node.args[0]
                arg_names = {
                    n.id for n in ast.walk(arg) if isinstance(n, ast.Name)
                }
                static_ok = (
                    _is_constant_expr(arg)
                    or arg_names <= fn.static_params
                    or any(
                        isinstance(a, ast.Attribute)
                        and a.attr in _STATIC_ATTRS
                        for a in ast.walk(arg)
                    )
                )
                if not static_ok:
                    add(
                        "CT004", node,
                        f"`{fname}(...)` coercion inside traced function "
                        f"{fn.qualname} — forces a device sync (or "
                        "TracerConversion error) per call",
                    )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _COERCION_METHODS
            ):
                add(
                    "CT004", node,
                    f"`.{node.func.attr}()` inside traced function "
                    f"{fn.qualname} — forces a device sync per call",
                )

        # CT005: Python branch on a tensor value (torch's implicit sync),
        # or on a traced parameter of an explicitly traced function (the
        # presumption would false-positive on host-config branches).
        if isinstance(node, (ast.If, ast.While)):
            kind = "if" if isinstance(node, ast.If) else "while"
            read = _reads_tensor_value(node.test)
            if read is not None:
                add(
                    "CT005", node,
                    f"Python `{kind}` on a tensor value (`{read}`) in "
                    f"{fn.qualname} ({fn.traced_why}) — an implicit device "
                    "sync per branch; keep it on the device (torch.where) "
                    "or count it as a deliberate sync",
                )
            elif fn.explicit_traced and not _static_only_test(node.test, fn):
                add(
                    "CT005", node,
                    f"Python `{kind}` on traced value(s) in "
                    f"{fn.qualname} ({fn.traced_why}); use lax.cond/"
                    "lax.select or mark the argument static",
                )
    return out

"""Schema-parity lint (CT010): engines' emitted telemetry keys vs the
canonical ``ROUND_CURVE_KEYS`` — statically.

All four engines' scan bodies must emit exactly the canonical RoundCurves
key set (sim/telemetry.py zero-fills the rest, so the *final* dict is
always canonical — what can drift is an engine passing an unknown key,
which today raises only at trace time, i.e. after a run was launched,
possibly hours into a queue slot). This module turns that runtime
ValueError into a lint: it extracts the canonical tuples from
telemetry.py without importing it (no torch), finds every
``round_curves(...)`` call site, resolves its keywords — including
``**delivery_latency_hist(...)`` / ``**prop_curves(...)`` /
``**link_curves(...)`` expansions through one local-assignment hop —
and diffs.

The restricted evaluator executes only top-level ``NAME = <expr>``
assignments from telemetry.py against a tuple/range/len-only builtin
namespace; anything it can't evaluate is skipped, and a telemetry.py
refactor that breaks extraction fails loudly (CT010 on the runner).
"""

from __future__ import annotations

import ast

from corrosion_tpu_torch.analysis.findings import Finding
from corrosion_tpu_torch.analysis.source import SourceModule, dotted_name

_EVAL_BUILTINS = {"tuple": tuple, "range": range, "len": len,
                  "sorted": sorted, "set": set, "frozenset": frozenset}


def extract_canonical(telemetry_path: str) -> dict[str, tuple]:
    """Evaluate telemetry.py's top-level key tuples without importing it.

    Returns the module-level constants that evaluated cleanly (expected:
    VIS_LAT_EDGES, VIS_LAT_KEYS, HEALTH_CURVE_KEYS, ROUND_CURVE_KEYS,
    LEVEL_CURVE_KEYS, plus the propagation plane's LINK_CURVE_KEYS /
    RUMOR_AGE_KEYS / PROP_CURVE_KEYS). tests/test_analysis.py pins this
    against the imported module so the evaluator can never silently
    drift.
    """
    with open(telemetry_path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=telemetry_path)
    env: dict[str, object] = {}
    for node in tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            continue
        name = node.targets[0].id
        try:
            code = compile(ast.Expression(node.value), telemetry_path, "eval")
            env[name] = eval(  # noqa: S307 - restricted namespace
                code, {"__builtins__": _EVAL_BUILTINS, **env}
            )
        except Exception:
            continue
    return {
        k: v for k, v in env.items()
        if isinstance(v, tuple) and all(isinstance(e, (str, int)) for e in v)
    }


def _resolve_star(mod: SourceModule, call: ast.Call, star: ast.AST,
                  canonical: dict[str, tuple]) -> tuple | None:
    """Keys contributed by a ``**expr`` in a round_curves call: a direct
    call to one of the telemetry key-set helpers
    (``delivery_latency_hist`` → VIS_LAT_KEYS, ``prop_curves`` →
    PROP_CURVE_KEYS, ``link_curves`` → LINK_CURVE_KEYS) or one hop
    through a local ``name = <helper>(...)`` assignment in the
    enclosing function. None = statically unresolvable."""
    helpers = {
        "delivery_latency_hist": tuple(canonical.get("VIS_LAT_KEYS", ())),
        "prop_curves": tuple(canonical.get("PROP_CURVE_KEYS", ())),
        "link_curves": tuple(canonical.get("LINK_CURVE_KEYS", ())),
    }

    def helper_keys(expr: ast.AST) -> tuple | None:
        if not isinstance(expr, ast.Call):
            return None
        return helpers.get(dotted_name(expr.func).split(".")[-1])

    got = helper_keys(star)
    if got is not None:
        return got
    if isinstance(star, ast.Name):
        fn = mod.enclosing_function(call)
        scope = fn.node if fn is not None else mod.tree
        for node in ast.walk(scope):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == star.id
            ):
                got = helper_keys(node.value)
                if got is not None:
                    return got
    return None


def emitted_keys(
    mod: SourceModule, canonical: dict[str, tuple]
) -> tuple[list[str], list[Finding]]:
    """(sorted emitted key set, findings) for one module's
    ``round_curves(...)`` call sites."""
    keys: set[str] = set()
    findings: list[Finding] = []
    canon = set(canonical.get("ROUND_CURVE_KEYS", ()))
    calls = [
        node for node in ast.walk(mod.tree)
        if isinstance(node, ast.Call)
        and dotted_name(node.func).split(".")[-1] == "round_curves"
    ]
    for call in calls:
        for kw in call.keywords:
            if kw.arg is None:
                got = _resolve_star(mod, call, kw.value, canonical)
                if got is None:
                    findings.append(Finding(
                        rule="CT010", path=mod.path, line=kw.value.lineno,
                        col=kw.value.col_offset,
                        message="`**` expansion in round_curves(...) is "
                        "not statically resolvable; emit "
                        "delivery_latency_hist directly (or via one "
                        "local assignment) so parity stays checkable",
                    ))
                else:
                    keys.update(got)
                continue
            keys.add(kw.arg)
            if canon and kw.arg not in canon:
                findings.append(Finding(
                    rule="CT010", path=mod.path, line=call.lineno,
                    col=call.col_offset,
                    message=f"round_curves key '{kw.arg}' is not in the "
                    "canonical ROUND_CURVE_KEYS set (runtime would "
                    "ValueError at trace time)",
                ))
    if mod.is_engine and not calls:
        findings.append(Finding(
            rule="CT010", path=mod.path, line=1, col=0,
            message="engine module never builds its per-round stats "
            "through telemetry.round_curves(...) — the schema parity "
            "contract is unenforceable here",
        ))
    return sorted(keys), findings

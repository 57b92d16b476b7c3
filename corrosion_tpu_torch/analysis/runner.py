"""Lint orchestration: discover files, run every rule, apply
suppressions, aggregate a LintResult.

Pure stdlib — importable and runnable without torch. The canonical
telemetry keys come from a static extraction of sim/telemetry.py
(schema.extract_canonical); pass ``telemetry_path`` to lint fixture
trees against a different schema source (the tests do). The engine
clone gate (CT05x) resolves ``analysis/SEAM_MAP.json`` against the
package tree by default; fixture trees pass ``seam_map_path`` +
``seam_root``. ``only`` restricts the run to a changed-file subset
(the ``lint --changed`` mode), and suppressions that match no finding
surface as non-gating CT009 stale warnings so the inventory can't rot.
"""

from __future__ import annotations

import os
import subprocess

from corrosion_tpu_torch.analysis import (
    asynclint,
    clonemap,
    concurrency,
    determinism,
    purity,
    schema,
)
from corrosion_tpu_torch.analysis.findings import Finding, LintResult
from corrosion_tpu_torch.analysis.source import SourceModule

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

# Rules the static runner never produces (runtime sanitizer family):
# their suppressions are consumed by `lint --sanitize`, so a static run
# must not call them stale.
_RUNTIME_RULES_PREFIX = "CT03"


def default_telemetry_path() -> str:
    import corrosion_tpu_torch

    return os.path.join(
        os.path.dirname(corrosion_tpu_torch.__file__), "sim", "telemetry.py"
    )


def default_seam_root() -> str:
    import corrosion_tpu_torch

    return os.path.dirname(os.path.abspath(corrosion_tpu_torch.__file__))


def discover(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            files.extend(
                os.path.join(root, n) for n in sorted(names)
                if n.endswith(".py")
            )
    return files


def changed_files(ref: str, cwd: str | None = None) -> set[str]:
    """Absolute real paths of files changed vs ``ref`` (committed diff
    plus untracked), for ``lint --changed``. Raises RuntimeError when
    git can't answer (not a repo, unknown ref)."""
    top = subprocess.run(
        ["git", "rev-parse", "--show-toplevel"],
        cwd=cwd, capture_output=True, text=True,
    )
    if top.returncode != 0:
        raise RuntimeError(f"not a git repository: {top.stderr.strip()}")
    root = top.stdout.strip()
    out: set[str] = set()
    diff = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=root, capture_output=True, text=True,
    )
    if diff.returncode != 0:
        raise RuntimeError(
            f"git diff vs {ref!r} failed: {diff.stderr.strip()}"
        )
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=root, capture_output=True, text=True,
    )
    for blob in (diff.stdout, untracked.stdout if
                 untracked.returncode == 0 else ""):
        for name in blob.splitlines():
            if name.strip():
                out.add(os.path.realpath(os.path.join(root, name.strip())))
    return out


def lint_paths(
    paths: list[str],
    rules: set[str] | None = None,
    telemetry_path: str | None = None,
    seam_map_path: str | None = None,
    seam_root: str | None = None,
    only: set[str] | None = None,
) -> LintResult:
    """Run every static rule over ``paths`` (files or trees).

    ``rules`` filters to a subset of CT0xx ids; suppressed findings are
    reported separately (they never gate) and CT000 fires on malformed
    suppressions — a suppression without a reason is ignored, loudly.
    ``only`` (absolute real paths) restricts to a changed-file subset.
    """
    result = LintResult()
    tpath = telemetry_path or default_telemetry_path()
    try:
        canonical = schema.extract_canonical(tpath)
    except OSError:
        canonical = {}
    if "ROUND_CURVE_KEYS" not in canonical:
        result.findings.append(Finding(
            rule="CT010", path=tpath, line=1,
            message="static extraction of ROUND_CURVE_KEYS failed — the "
            "schema-parity lint is blind; keep the canonical tuples "
            "statically evaluable",
        ))
    result.canonical_keys = tuple(canonical.get("ROUND_CURVE_KEYS", ()))

    engine_paths: list[str] = []
    for path in discover(paths):
        if only is not None and os.path.realpath(path) not in only:
            continue
        try:
            mod = SourceModule(path)
        except (SyntaxError, UnicodeDecodeError) as e:
            result.findings.append(Finding(
                rule="CT000", path=path,
                line=getattr(e, "lineno", 1) or 1,
                message=f"unparsable source: {e}",
            ))
            result.files += 1
            continue
        result.files += 1
        found: list[Finding] = []
        found.extend(purity.check_purity(mod))
        keys, schema_findings = schema.emitted_keys(mod, canonical)
        found.extend(schema_findings)
        if mod.is_engine:
            name = os.path.splitext(os.path.basename(path))[0]
            result.engines[name] = keys
            engine_paths.append(path)
        found.extend(concurrency.check_concurrency(mod))
        found.extend(asynclint.check_async(mod))
        found.extend(determinism.check_determinism(mod))
        for line, msg in mod.bad_suppressions:
            found.append(Finding(rule="CT000", path=path, line=line,
                                 message=msg))
        matched: set[tuple[int, str]] = set()
        for f in found:
            if rules is not None and f.rule not in rules:
                continue
            sup = mod.suppression_for(f.rule, f.line)
            if sup is not None:
                matched.add((id(sup), f.rule))
                f.suppressed = True
                f.suppress_reason = sup.reason
                result.suppressed.append(f)
            else:
                result.findings.append(f)
        if rules is None or "CT009" in rules:
            for s in mod.suppressions:
                for r in sorted(s.rules):
                    if r.startswith(_RUNTIME_RULES_PREFIX):
                        continue  # consumed by the runtime sanitizer
                    if rules is not None and r not in rules:
                        continue  # rule not active: staleness unknown
                    if (id(s), r) not in matched:
                        result.stale.append(Finding(
                            rule="CT009", path=path, line=s.line,
                            message=f"suppression for {r} no longer "
                            "matches any finding — delete it (reason "
                            f"was: {s.reason!r})",
                        ))

    # Cross-module engine-clone gate: runs when the linted set reaches
    # engine files (so fixture-tree lints stay self-contained unless
    # they pass their own map).
    explicit_map = seam_map_path is not None
    smap_path = seam_map_path or clonemap.default_seam_map_path()
    root = seam_root or default_seam_root()
    in_root = any(
        os.path.realpath(p).startswith(os.path.realpath(root) + os.sep)
        for p in engine_paths
    )
    if engine_paths and (explicit_map or in_root):
        clone_found: list[Finding] = []
        try:
            smap = clonemap.load_seam_map(smap_path)
        except OSError as e:
            clone_found.append(Finding(
                rule="CT051", path=smap_path, line=1,
                message=f"seam map unreadable: {e} — the engine-clone "
                "gate is blind",
            ))
            smap = None
        except ValueError as e:
            clone_found.append(Finding(
                rule="CT051", path=smap_path, line=1, message=str(e),
            ))
            smap = None
        if smap is not None:
            clone_found.extend(clonemap.check_clones(smap, root))
            clone_found.extend(clonemap.check_partial_keys(
                smap, result.engines, result.canonical_keys, smap_path,
            ))
        for f in clone_found:
            if rules is None or f.rule in rules:
                result.findings.append(f)

    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    result.suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    result.stale.sort(key=lambda f: (f.path, f.line, f.rule))
    return result

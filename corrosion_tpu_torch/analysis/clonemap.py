"""Engine-clone drift gate (CT050-CT052) over the four sim engines.

The 4× engine tax: every per-round plane is
threaded by hand through ``sim/{engine,sparse_engine,chunk_engine,
mixed_engine}.py``, and the copies drift — CT010 only checks telemetry
keys and the parity tests catch drift at runtime, after the fact. This
module makes the clone relationship *declared state*:

``analysis/SEAM_MAP.json`` (format ``corro-seam-map/1``) lists

* ``clones`` — function pairs that are intentional copies, with a
  per-pair ``renames`` table (b-side identifier -> a-side identifier)
  and a ``seams`` list: the hunks where the copies *legitimately*
  differ, stored as normalized source fragments with a name and a why.
* ``partial_keys`` — waivers for canonical round-curve keys that are
  deliberately emitted by fewer than all four engines, with the exact
  engine set and a why.

The analyzer parses each mapped function, strips docstrings, applies
the declared renames, unparses to canonical lines, and diffs the pair.
Every non-equal hunk must exactly match a declared seam, else **CT050**
fires with the stray fragment. A mapped function or file that no longer
exists fires **CT051** (an engine collapse deletes map entries as proof
of progress — deliberately). A canonical key emitted by some but not
all engines without a matching waiver (or with a stale waiver naming
the wrong engine set) fires **CT052**: a new per-round plane landed in
fewer than four copies.

``refresh_seams`` regenerates the seam lists from the live diff while
preserving the name/why of seams that still match — the committed-map
update flow (``lint --update-seams``), same idiom as the
``COST_BASELINE`` ``--update`` flow.
"""

from __future__ import annotations

import ast
import difflib
import json
import os

from corrosion_tpu_torch.analysis.findings import Finding

SEAM_MAP_FORMAT = "corro-seam-map/1"


def default_seam_map_path() -> str:
    return os.path.join(os.path.dirname(__file__), "SEAM_MAP.json")


def load_seam_map(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("format") != SEAM_MAP_FORMAT:
        raise ValueError(
            f"seam map {path}: format {data.get('format')!r}, "
            f"expected {SEAM_MAP_FORMAT!r}"
        )
    return data


# -- normalization -------------------------------------------------------

class _Renamer(ast.NodeTransformer):
    def __init__(self, renames: dict[str, str]):
        self.renames = renames

    def _r(self, name: str) -> str:
        return self.renames.get(name, name)

    def visit_Name(self, node: ast.Name):
        node.id = self._r(node.id)
        return self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        node.attr = self._r(node.attr)
        return self.generic_visit(node)

    def visit_arg(self, node: ast.arg):
        node.arg = self._r(node.arg)
        return self.generic_visit(node)

    def visit_keyword(self, node: ast.keyword):
        if node.arg is not None:
            node.arg = self._r(node.arg)
        return self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        node.name = self._r(node.name)
        return self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        node.name = self._r(node.name)
        return self.generic_visit(node)


def _strip_docstrings(node: ast.AST) -> None:
    for n in ast.walk(node):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Module)):
            body = getattr(n, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                n.body = body[1:] or [ast.Pass()]


def resolve_function(tree: ast.Module, qualname: str):
    """Find a (possibly nested) function by dotted qualname, e.g.
    ``_scan_impl.body``. Returns the node or None."""
    scope: ast.AST = tree
    node = None
    for part in qualname.split("."):
        node = None
        for child in ast.walk(scope):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) and child.name == part:
                node = child
                break
        if node is None:
            return None
        scope = node
    return node


def normalize(fn: ast.AST, renames: dict[str, str] | None = None
              ) -> list[str]:
    """Canonical source lines for one clone body: docstrings stripped,
    declared renames applied, comments/formatting gone via unparse.
    The ``def`` header is kept (renames cover the name delta) so
    signature drift is visible too."""
    import copy

    fn = copy.deepcopy(fn)
    _strip_docstrings(fn)
    if renames:
        fn = _Renamer(dict(renames)).visit(fn)
    ast.fix_missing_locations(fn)
    return ast.unparse(fn).splitlines()


def diff_hunks(a_lines: list[str], b_lines: list[str]
               ) -> list[tuple[list[str], list[str]]]:
    sm = difflib.SequenceMatcher(None, a_lines, b_lines, autojunk=False)
    hunks = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag != "equal":
            hunks.append((a_lines[i1:i2], b_lines[j1:j2]))
    return hunks


# -- the checks ----------------------------------------------------------

def _side(root: str, spec: dict):
    """(path, tree|None, fn|None) for one side of a clone pair."""
    path = os.path.join(root, spec["file"].replace("/", os.sep))
    if not os.path.isfile(path):
        return path, None, None
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    return path, tree, resolve_function(tree, spec["func"])


def check_clones(seam_map: dict, root: str) -> list[Finding]:
    """CT050/CT051 over every declared clone pair. ``root`` is the
    directory the map's relative file paths resolve against (the
    ``corrosion_tpu_torch`` package directory in production)."""
    findings: list[Finding] = []
    for pair in seam_map.get("clones", []):
        name = pair.get("name", "?")
        sides = {}
        missing = False
        for key in ("a", "b"):
            path, tree, fn = _side(root, pair[key])
            sides[key] = (path, fn)
            if fn is None:
                findings.append(Finding(
                    rule="CT051", path=path, line=1,
                    message=(
                        f"clone pair `{name}`: "
                        + (f"function `{pair[key]['func']}` not found"
                           if tree is not None else "file missing")
                        + " — collapse complete? delete the map entry "
                        "deliberately (the engine-collapse workflow in "
                        "docs/ANALYSIS.md)"
                    ),
                ))
                missing = True
        if missing:
            continue
        a_path, a_fn = sides["a"]
        b_path, b_fn = sides["b"]
        a_lines = normalize(a_fn)
        b_lines = normalize(b_fn, pair.get("renames", {}))
        declared = [
            (s.get("a", []), s.get("b", []))
            for s in pair.get("seams", [])
        ]
        for hunk_a, hunk_b in diff_hunks(a_lines, b_lines):
            if (hunk_a, hunk_b) in ((list(da), list(db))
                                    for da, db in declared):
                continue
            frag = (hunk_b or hunk_a)[0].strip()
            findings.append(Finding(
                rule="CT050", path=b_path, line=b_fn.lineno,
                message=f"clone pair `{name}` "
                f"({pair['a']['file']}:{pair['a']['func']} vs "
                f"{pair['b']['file']}:{pair['b']['func']}) diverges "
                f"outside declared seams near `{frag}` "
                f"({len(hunk_a)}a/{len(hunk_b)}b lines) — re-sync the "
                "copies or declare the seam (lint --update-seams, then "
                "fill in the why)",
            ))
    return findings


def check_partial_keys(seam_map: dict, engines: dict[str, list[str]],
                       canonical: tuple[str, ...],
                       map_path: str) -> list[Finding]:
    """CT052: canonical keys emitted by a strict subset of the engines
    must carry a waiver naming that exact subset."""
    findings: list[Finding] = []
    if len(engines) < 4:
        return findings  # partial lint scope: subset judgement unsound
    waivers = seam_map.get("partial_keys", {})
    all_names = sorted(engines)
    for key in canonical:
        emitting = sorted(n for n, keys in engines.items() if key in keys)
        if not emitting or emitting == all_names:
            continue
        waiver = waivers.get(key)
        if waiver is None:
            findings.append(Finding(
                rule="CT052", path=map_path, line=1,
                message=f"round-curve key `{key}` emitted by "
                f"{emitting} but not {sorted(set(all_names) - set(emitting))} "
                "and carries no partial_keys waiver — thread the plane "
                "through all four engines or declare the waiver with a "
                "why",
            ))
        elif sorted(waiver.get("engines", [])) != emitting:
            findings.append(Finding(
                rule="CT052", path=map_path, line=1,
                message=f"stale waiver for `{key}`: declared engines "
                f"{sorted(waiver.get('engines', []))} but measured "
                f"{emitting} — update the waiver",
            ))
    return findings


# -- map maintenance -----------------------------------------------------

def refresh_seams(seam_map: dict, root: str) -> tuple[dict, int]:
    """Regenerate every pair's ``seams`` from the live diff, keeping
    name/why for hunks that still match a declared seam. Returns the
    new map and the count of fresh (TODO-why) seams introduced."""
    out = json.loads(json.dumps(seam_map))  # deep copy
    fresh = 0
    for pair in out.get("clones", []):
        _, _, a_fn = _side(root, pair["a"])
        _, _, b_fn = _side(root, pair["b"])
        if a_fn is None or b_fn is None:
            continue  # CT051 territory; refresh can't help
        a_lines = normalize(a_fn)
        b_lines = normalize(b_fn, pair.get("renames", {}))
        old = {
            (tuple(s.get("a", [])), tuple(s.get("b", []))): s
            for s in pair.get("seams", [])
        }
        seams = []
        for i, (ha, hb) in enumerate(diff_hunks(a_lines, b_lines)):
            prev = old.get((tuple(ha), tuple(hb)))
            if prev is not None:
                seams.append(prev)
            else:
                fresh += 1
                seams.append({
                    "name": f"{pair.get('name', 'pair')}-seam-{i}",
                    "why": "TODO: describe why the copies differ here",
                    "a": ha,
                    "b": hb,
                })
        pair["seams"] = seams
    return out, fresh


def save_seam_map(seam_map: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(seam_map, f, indent=2, sort_keys=False)
        f.write("\n")

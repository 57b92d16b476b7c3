"""Concurrency lints for the host agent plane (CT020/CT021).

CT020 flags blocking calls (sleep, subprocess, socket dial/resolve,
file open) lexically inside ``with <lock>:`` blocks: the agent serves
its HTTP API, gossip transport, and admin RPC from one process, and a
lock held across a blocking call stalls every waiter for the call's
wall time (the reference wraps each lock in a registry precisely to
diagnose this class in production — utils/locks.py).

CT021 builds a lock-acquisition-order graph — an edge A->B when code
holding A acquires B, both lexically and through one same-class /
same-module call hop — and fails on cycles (the classic two-lock
deadlock shape). Lock identity is the dotted expression scoped by class
(``SplitPool._read_lock``), so two methods of one class share nodes but
distinct classes never alias.

Heuristics are name-based: a with-context expression counts as a lock
acquisition when its last name segment looks lock-ish (lock/mutex/
guard/sem/semaphore, e.g. ``self._read_lock``) or when it is a call to
an acquire-style method (``self._wlock(...)``, ``registry.acquire(...)``).
"""

from __future__ import annotations

import ast
import re

from corrosion_tpu_torch.analysis.findings import Finding
from corrosion_tpu_torch.analysis.source import SourceModule, dotted_name

_LOCKISH = re.compile(r"(?:^|_)(?:r|w)?(?:lock|mutex|guard|sem|semaphore)s?$",
                      re.IGNORECASE)
_ACQUIRISH = re.compile(r"(?:^|_)(?:acquire|wlock|rlock)$", re.IGNORECASE)

# dotted-prefix -> why it blocks. Matching is by module root + attr.
_BLOCKING = {
    "time.sleep": "sleeps while holding the lock",
    "subprocess.": "spawns and waits on a child process",
    "os.system": "spawns a shell and waits",
    "os.popen": "spawns a shell",
    "socket.create_connection": "dials a TCP connection",
    "socket.getaddrinfo": "resolves DNS",
    "socket.gethostbyname": "resolves DNS",
    "requests.": "performs a blocking HTTP request",
    "urllib.request.": "performs a blocking HTTP request",
    "open": "opens a file (disk I/O)",
}


def _lock_identity(item: ast.withitem, class_name: str | None) -> str | None:
    """Dotted lock identity for one with-item, or None if not a lock."""
    expr = item.context_expr
    name = dotted_name(expr)
    if isinstance(expr, ast.Call):
        fname = dotted_name(expr.func)
        last = fname.split(".")[-1] if fname else ""
        if _ACQUIRISH.search(last):
            name = fname
        elif last == "acquire" and len(fname.split(".")) > 1:
            # registry.acquire(lock, label): identity = the lock argument
            # when nameable, else the registry expression.
            name = (
                dotted_name(expr.args[0]) if expr.args else ""
            ) or fname
        else:
            return None
    if not name:
        return None
    last = name.split(".")[-1]
    if not (_LOCKISH.search(last) or _ACQUIRISH.search(last)):
        return None
    if name.startswith("self.") and class_name:
        return f"{class_name}.{name[5:]}"
    return name


def _blocking_reason(call: ast.Call) -> str | None:
    fname = dotted_name(call.func)
    if not fname:
        return None
    for prefix, why in _BLOCKING.items():
        if fname == prefix or (prefix.endswith(".") and
                               fname.startswith(prefix)):
            return why
    return None


def _walk_no_defs(node: ast.AST):
    """Walk a body without descending into nested function/class defs
    (their bodies execute later, outside the held lock)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue
        yield child
        yield from _walk_no_defs(child)


def check_concurrency(mod: SourceModule) -> list[Finding]:
    findings: list[Finding] = []
    edges: dict[tuple[str, str], int] = {}  # (a, b) -> first line

    # class context per function: qualname prefix ending in ClassName.
    class_of: dict[ast.AST, str | None] = {}

    def assign_classes(node: ast.AST, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                assign_classes(child, child.name)
            else:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_of[child] = cls
                assign_classes(child, cls)

    assign_classes(mod.tree, None)

    # locks each function/method acquires anywhere in its body (for the
    # one-hop call propagation), keyed by (class, name) and (None, name).
    acquired_by: dict[tuple[str | None, str], set[str]] = {}
    funcs: list[tuple[ast.AST, str | None]] = [
        (f, class_of.get(f)) for f in ast.walk(mod.tree)
        if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for f, cls in funcs:
        acq: set[str] = set()
        for node in _walk_no_defs(f):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _lock_identity(item, cls)
                    if lock:
                        acq.add(lock)
        acquired_by[(cls, f.name)] = acq
        acquired_by.setdefault((None, f.name), set()).update(acq)

    def scan_with(node: ast.AST, held: list[str], cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            now_held = held
            if isinstance(child, (ast.With, ast.AsyncWith)):
                locks = [
                    lk for item in child.items
                    if (lk := _lock_identity(item, cls))
                ]
                for lk in locks:
                    for h in held:
                        if h != lk:
                            edges.setdefault((h, lk), child.lineno)
                now_held = held + locks
            if held and isinstance(child, ast.Call):
                why = _blocking_reason(child)
                if why:
                    findings.append(Finding(
                        rule="CT020", path=mod.path, line=child.lineno,
                        col=child.col_offset,
                        message=f"`{dotted_name(child.func)}` under held "
                        f"lock {held[-1]}: {why}; move it outside the "
                        "critical section",
                    ))
                # one-hop: calling a method/function that itself
                # acquires locks while we hold one.
                fname = dotted_name(child.func)
                callee: set[str] = set()
                if fname.startswith("self."):
                    callee = acquired_by.get(
                        (cls, fname.split(".")[-1]), set()
                    )
                elif fname and "." not in fname:
                    callee = acquired_by.get((None, fname), set())
                for lk in callee:
                    for h in held:
                        if h != lk:
                            edges.setdefault((h, lk), child.lineno)
            scan_with(child, now_held, cls)

    for f, cls in funcs:
        scan_with(f, [], cls)

    # Cycle detection over the acquisition-order graph.
    graph: dict[str, set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    state: dict[str, int] = {}  # 0 visiting, 1 done
    reported: set[frozenset] = set()

    def dfs(node: str, stack: list[str]):
        state[node] = 0
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt) == 0:
                cycle = stack[stack.index(nxt):] + [nxt] if nxt in stack \
                    else [node, nxt]
                key = frozenset(cycle)
                if key not in reported:
                    reported.add(key)
                    line = min(
                        ln for (a, b), ln in edges.items()
                        if a in key and b in key
                    )
                    findings.append(Finding(
                        rule="CT021", path=mod.path, line=line, col=0,
                        message="lock-acquisition-order cycle: "
                        + " -> ".join(cycle)
                        + " (latent deadlock; fix the ordering)",
                    ))
            elif nxt not in state:
                dfs(nxt, stack + [nxt])
        state[node] = 1

    for n in sorted(graph):
        if n not in state:
            dfs(n, [n])
    return findings

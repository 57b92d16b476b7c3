"""Asyncio race & lifecycle lints for the agent plane (CT040-CT043).

The agent serves gossip, sync, the HTTP API, and admin RPC from one
event loop; its state-lifecycle bugs look nothing like the lock bugs
CT020/CT021 catch. Two real host bugs (accepted sockets surviving
death, the partition-heal membership wedge) and the listener-queue drop
were of this family:

* CT040 — an async method reads ``self.X``, suspends at an ``await``,
  then writes ``self.X`` back without holding a guarding lock. A second
  task interleaves at the await and one update is lost (check-then-act
  across a suspension point). Lock resolution reuses CT020's name
  heuristics; reads/writes under a lock-ish ``with``/``async with`` are
  exempt, as are lock-ish attributes themselves.
* CT041 — fire-and-forget ``create_task``/``ensure_future``: the
  returned task is neither stored, awaited, nor given
  ``add_done_callback``. Its exception vanishes and CPython may GC the
  task mid-run. TaskGroup-style receivers (``tg.create_task``) hold the
  task themselves and are exempt.
* CT042 — blocking call lexically inside ``async def``: the hard set
  (``time.sleep``, subprocess, socket dial/resolve, blocking HTTP,
  ``sqlite3.connect``) fires everywhere; ``open()`` and sync sqlite
  ``execute*`` on conn/cursor-named receivers fire only in agent-plane
  modules (``corrosion_tpu_torch/agent/`` or ``# corro-lint: agent-module``
  fixtures) — one-shot CLI helpers may block, the serving loop may not.
* CT043 — an ``except`` handler in an ``async def`` that catches
  ``asyncio.CancelledError`` (directly, bare, or via ``BaseException``)
  without a ``raise`` in the handler. Exemption: the cancel-and-await
  teardown idiom (a ``.cancel()`` call lexically before the ``try`` in
  the same function) is how you *intentionally* absorb the
  CancelledError you caused.

Findings attribute to the innermost enclosing function so nested async
defs (connection handlers inside ``start``) report once.
"""

from __future__ import annotations

import ast
import re

from corrosion_tpu_torch.analysis.concurrency import _lock_identity, _walk_no_defs
from corrosion_tpu_torch.analysis.findings import Finding
from corrosion_tpu_torch.analysis.source import SourceModule, dotted_name

AGENT_MARKER = re.compile(r"(?m)^\s*#\s*corro-lint:\s*agent-module\s*$")

# Lock-ish attribute names never count as racy state (they ARE the
# guard); mirrors concurrency._LOCKISH.
_LOCKISH_ATTR = re.compile(
    r"(?:^|_)(?:r|w)?(?:lock|mutex|guard|sem|semaphore)s?$", re.IGNORECASE
)

# Hard-blocking dotted prefixes: fire in any async def, any module.
_BLOCKING_ASYNC = {
    "time.sleep": "sleeps the whole event loop (use asyncio.sleep)",
    "subprocess.": "spawns and waits on a child process",
    "os.system": "spawns a shell and waits",
    "os.popen": "spawns a shell",
    "socket.create_connection": "dials TCP synchronously",
    "socket.getaddrinfo": "resolves DNS synchronously",
    "socket.gethostbyname": "resolves DNS synchronously",
    "requests.": "performs a blocking HTTP request",
    "urllib.request.": "performs a blocking HTTP request",
    "sqlite3.connect": "opens a database file synchronously",
}

# Receiver name (last dotted segment) that marks a sync sqlite handle.
_DBISH = re.compile(r"(?:^|_)(?:conn|connection|db|cur|cursor)$",
                    re.IGNORECASE)
_EXEC_METHODS = ("execute", "executemany", "executescript")

_TASK_SPAWNERS = ("create_task", "ensure_future")


def is_agent_module(mod: SourceModule) -> bool:
    parts = mod.path.replace("\\", "/").split("/")
    return "agent" in parts[:-1] or bool(AGENT_MARKER.search(mod.text))


def _self_attr(node: ast.AST) -> str | None:
    """Attribute name when ``node`` is ``self.X`` (one level), else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _async_functions(mod: SourceModule):
    for info in mod.functions:
        if isinstance(info.node, ast.AsyncFunctionDef):
            yield info


# -- CT040 ---------------------------------------------------------------

def _ct040(mod: SourceModule) -> list[Finding]:
    findings: list[Finding] = []
    for info in _async_functions(mod):
        # Ordered event stream: (line, kind, attr) with kind in
        # {read, write, await}; lock-guarded regions contribute no
        # read/write events (the lock serializes them).
        events: list[tuple[int, str, str]] = []

        def scan(node: ast.AST, guarded: bool):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                    continue
                now_guarded = guarded
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    if any(_lock_identity(item, None) or
                           _lock_identity(item, "C")
                           for item in child.items):
                        now_guarded = True
                if isinstance(child, (ast.Await, ast.AsyncFor)):
                    events.append((child.lineno, "await", ""))
                attr = _self_attr(child)
                if attr is not None and not _LOCKISH_ATTR.search(attr):
                    if not guarded:
                        kind = ("write" if isinstance(child.ctx,
                                                      (ast.Store, ast.Del))
                                else "read")
                        events.append((child.lineno, kind, attr))
                # self._x[k] = v / del self._x[k]: a write to _x.
                if isinstance(child, ast.Subscript) and isinstance(
                        child.ctx, (ast.Store, ast.Del)):
                    sattr = _self_attr(child.value)
                    if sattr is not None and not guarded \
                            and not _LOCKISH_ATTR.search(sattr):
                        events.append((child.lineno, "write", sattr))
                scan(child, now_guarded)

        scan(info.node, False)
        events.sort(key=lambda e: e[0])
        # For each attr: unguarded touch, then an await, then an
        # unguarded write -> the write clobbers concurrent updates.
        seen_before: dict[str, int] = {}
        awaited_after: dict[str, int] = {}
        reported: set[str] = set()
        for line, kind, attr in events:
            if kind == "await":
                for a in seen_before:
                    awaited_after.setdefault(a, line)
                continue
            if kind == "write" and attr in awaited_after \
                    and attr not in reported:
                reported.add(attr)
                findings.append(Finding(
                    rule="CT040", path=mod.path, line=line,
                    message=f"`self.{attr}` written after the await at "
                    f"line {awaited_after[attr]} that follows its read at "
                    f"line {seen_before[attr]} in `{info.qualname}` — a "
                    "concurrent task can interleave at the await; guard "
                    "the read+write with one lock or capture-and-swap "
                    "before awaiting",
                ))
            seen_before.setdefault(attr, line)
    return findings


# -- CT041 ---------------------------------------------------------------

def _ct041(mod: SourceModule) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(mod.tree):
        call: ast.Call | None = None
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            # `_ = create_task(...)` is still fire-and-forget.
            if all(isinstance(t, ast.Name) and t.id == "_"
                   for t in node.targets):
                call = node.value
        if call is None:
            continue
        fname = dotted_name(call.func)
        if fname.split(".")[-1] not in _TASK_SPAWNERS:
            continue
        receiver = fname.rsplit(".", 1)[0] if "." in fname else ""
        if "group" in receiver.lower() or receiver.split(".")[-1] == "tg":
            continue  # TaskGroup holds its children
        findings.append(Finding(
            rule="CT041", path=mod.path, line=node.lineno,
            message=f"`{fname}` result dropped — store the task (and "
            "await or add_done_callback it) so its exception cannot "
            "vanish and the task cannot be garbage-collected mid-run",
        ))
    return findings


# -- CT042 ---------------------------------------------------------------

def _conn_locals(fn: ast.AST) -> set[str]:
    """Local names bound to a sqlite conn/cursor-ish expression inside
    ``fn`` (``c = self.store.conn.cursor()``, ``conn = ...``)."""
    names: set[str] = set()
    for node in _walk_no_defs(fn):
        if not isinstance(node, ast.Assign):
            continue
        src = node.value
        dname = dotted_name(src.func) if isinstance(src, ast.Call) else \
            dotted_name(src)
        last = dname.split(".")[-1] if dname else ""
        if _DBISH.search(last) or last == "connect":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _ct042(mod: SourceModule) -> list[Finding]:
    findings: list[Finding] = []
    agent = is_agent_module(mod)
    for info in _async_functions(mod):
        conn_locals = _conn_locals(info.node) if agent else set()
        for node in _walk_no_defs(info.node):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            why = None
            for prefix, reason in _BLOCKING_ASYNC.items():
                if fname == prefix or (prefix.endswith(".") and
                                       fname.startswith(prefix)):
                    why = reason
                    break
            if why is None and agent:
                last = fname.split(".")[-1] if fname else ""
                if fname == "open":
                    why = "opens a file synchronously (disk I/O on the " \
                          "serving loop)"
                elif last in _EXEC_METHODS and "." in fname:
                    recv = fname.rsplit(".", 1)[0].split(".")[-1]
                    if _DBISH.search(recv) or \
                            fname.split(".")[0] in conn_locals:
                        why = "sync sqlite on the event loop (route " \
                              "through the writer pool / an executor)"
            if why is not None:
                findings.append(Finding(
                    rule="CT042", path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=f"`{fname}` inside `async def "
                    f"{info.qualname}`: {why}",
                ))
    return findings


# -- CT043 ---------------------------------------------------------------

def _catches_cancelled(handler: ast.ExceptHandler) -> str | None:
    """How this handler captures CancelledError, or None."""
    t = handler.type
    if t is None:
        return "bare `except:`"
    exprs = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in exprs:
        name = dotted_name(e)
        last = name.split(".")[-1]
        if last == "CancelledError":
            return f"`except {name}`"
        if last == "BaseException":
            return f"`except {name}` (CancelledError derives from it)"
    return None


def _ct043(mod: SourceModule) -> list[Finding]:
    findings: list[Finding] = []
    for info in _async_functions(mod):
        cancel_lines = [
            n.lineno for n in _walk_no_defs(info.node)
            if isinstance(n, ast.Call)
            and dotted_name(n.func).split(".")[-1] == "cancel"
        ]
        for node in _walk_no_defs(info.node):
            if not isinstance(node, ast.Try):
                continue
            # Cancel-and-await teardown: we cancelled the task ourselves
            # just above; absorbing the resulting CancelledError is the
            # documented idiom, not a swallow.
            if any(ln < node.lineno for ln in cancel_lines):
                continue
            for handler in node.handlers:
                how = _catches_cancelled(handler)
                if how is None:
                    continue
                reraises = any(
                    isinstance(n, ast.Raise)
                    for n in _walk_no_defs(handler)
                )
                if not reraises:
                    findings.append(Finding(
                        rule="CT043", path=mod.path, line=handler.lineno,
                        message=f"{how} in `async def {info.qualname}` "
                        "without re-raise — cancellation is absorbed and "
                        "shutdown/timeouts wedge; split the handler and "
                        "`raise`",
                    ))
    return findings


def check_async(mod: SourceModule) -> list[Finding]:
    return _ct040(mod) + _ct041(mod) + _ct042(mod) + _ct043(mod)

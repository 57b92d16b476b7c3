"""Template engine — the corro-tpl analogue.

The reference renders Rhai-scripted file templates with `sql("...")` →
typed rows, `.to_json()` / `.to_csv()`, `hostname()`, atomic tmp+rename
writes, and re-renders whenever a subscription to the template's queries
changes (corro-tpl/src/lib.rs:41-613; watcher corrosion/src/command/tpl.rs).

Here templates are Python-scripted (the idiomatic stand-in for Rhai):
``<% statements %>`` blocks run, ``<%= expression %>`` interpolates, and the
script namespace exposes ``sql``, ``hostname``, ``to_json``, ``to_csv``.
Example:

    # peers.conf.tpl
    <% for row in sql("SELECT id, text FROM tests") { emitted per row } %>
    <%= sql("SELECT count(*) FROM tests").rows[0][0] %> entries

Watch mode subscribes to every query the render used and re-renders on any
change event, writing atomically.

Counterpart of corrosion_tpu/tpl.py.
"""

from __future__ import annotations

import asyncio
import csv
import io
import json
import logging
import os
import re
import socket

from corrosion_tpu_torch.agent.config import Config, parse_addr
from corrosion_tpu_torch.client import CorrosionApiClient

_TAG = re.compile(r"<%(=?)(.*?)%>", re.S)


class QueryResponse:
    """Rows of one sql() call (QueryResponse, corro-tpl/src/lib.rs:41-248)."""

    def __init__(self, columns: list[str], rows: list[list]):
        self.columns = columns
        self.rows = rows

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def to_json(self, pretty: bool = False) -> str:
        objs = [dict(zip(self.columns, r)) for r in self.rows]
        return json.dumps(objs, indent=2 if pretty else None)

    def to_csv(self, header: bool = True) -> str:
        out = io.StringIO()
        w = csv.writer(out)
        if header:
            w.writerow(self.columns)
        w.writerows(self.rows)
        return out.getvalue()


def compile_template(text: str):
    """Compile template text into a python function body. Text segments
    emit verbatim; <% %> runs; <%= %> emits the expression."""
    src = ["def __render__(emit, sql, hostname, env):"]
    indent = 1

    def add(line: str):
        src.append("    " * indent + line)

    pos = 0
    for m in _TAG.finditer(text):
        if m.start() > pos:
            add(f"emit({text[pos:m.start()]!r})")
        is_expr, body = m.group(1) == "=", m.group(2).strip()
        if is_expr:
            add(f"emit(str({body}))")
        else:
            for line in body.splitlines():
                stripped = line.strip()
                if not stripped:
                    continue
                if stripped == "end":
                    indent = max(1, indent - 1)
                    continue
                add(stripped)
                if stripped.endswith(":"):
                    indent += 1
        pos = m.end()
    if pos < len(text):
        add(f"emit({text[pos:]!r})")
    ns: dict = {}
    exec("\n".join(src), ns)  # noqa: S102 — templates are operator-authored
    return ns["__render__"]


class TemplateState:
    """One template file: render + the queries it used (TemplateState,
    corro-tpl lib.rs:361)."""

    def __init__(self, template_path: str, out_path: str, client: CorrosionApiClient):
        self.template_path = template_path
        self.out_path = out_path
        self.client = client
        self.queries: list[str] = []
        self._watch_pumps: dict | None = None  # set by watch mode

    async def render_once(self) -> str:
        """Single-pass direct execution, like Rhai's inline sql()
        (corro-tpl/src/lib.rs:447-613): the template body runs ONCE on a
        worker thread, and every sql() call bridges synchronously back to
        the event loop for a live fetch — so a data-dependent nested query
        (sql() inside a loop over another query's rows) sees real rows.
        The queries actually used this render are recorded for watch mode,
        including ones discovered mid-render."""
        with open(self.template_path) as f:
            text = f.read()
        fn = compile_template(text)
        chunks: list[str] = []
        used: list[str] = []
        loop = asyncio.get_running_loop()

        async def fetch(q: str) -> QueryResponse:
            cols, rows = await self.client.query(q)
            return QueryResponse(cols, rows)

        def sql_sync(q: str) -> QueryResponse:
            used.append(q)
            return asyncio.run_coroutine_threadsafe(fetch(q), loop).result(
                timeout=60.0
            )

        await asyncio.to_thread(
            fn, chunks.append, sql_sync, socket.gethostname, {}
        )
        self.queries = list(dict.fromkeys(used))
        return "".join(chunks)

    async def write(self) -> None:
        out = await self.render_once()
        tmp = self.out_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(out)
        os.replace(tmp, self.out_path)  # atomic swap (corro-tpl writes)


async def run_templates(specs: list[str], cfg: Config, watch: bool = False) -> None:
    host, port = parse_addr(cfg.api.addr)
    client = CorrosionApiClient(host, port)
    states = []
    for spec in specs:
        tpl, _, out = spec.partition(":")
        states.append(TemplateState(tpl, out or tpl.removesuffix(".tpl"), client))
    for st in states:
        await st.write()
    if not watch:
        return
    # Re-render on subscription changes to any used query
    # (corrosion/src/command/tpl.rs:29+). Data-dependent templates can
    # discover NEW queries on a re-render (a row appearing makes the loop
    # body fetch for it) — after every render the subscription set is
    # reconciled so late-discovered queries get watched too.
    async def watch_one(st: TemplateState):
        pumps: dict[str, asyncio.Task] = {}
        st._watch_pumps = pumps  # observable for tests/diagnostics
        log = logging.getLogger(__name__)

        async def watch_query(q: str):
            # Subscribe INSIDE the task: reconcile assigns pumps[q]
            # synchronously before any await, so two concurrent renders
            # can never double-subscribe one query.
            sub = await client.subscribe(q, skip_rows=True)
            async for ev in sub:
                if "change" in ev:
                    await st.write()
                    reconcile()

        def reconcile() -> None:
            """Match the pump set to the queries the LAST render used:
            late-discovered queries get watched, queries that dropped out
            (a deleted row's per-row fetch) get cancelled — the set tracks
            the template, it never just grows."""
            want = set(st.queries)
            for q in list(pumps):
                if q not in want:
                    pumps.pop(q).cancel()
            for q in want:
                if q not in pumps:
                    pumps[q] = asyncio.create_task(watch_query(q))

        reconcile()
        while pumps:
            done, _ = await asyncio.wait(
                set(pumps.values()), return_when=asyncio.FIRST_COMPLETED
            )
            for q, t in list(pumps.items()):
                if t in done:
                    del pumps[q]
                    # A dead watch means that query's changes no longer
                    # re-render — surface it (exception retrieval also
                    # silences asyncio's destroyed-task warning).
                    if not t.cancelled():
                        log.warning(
                            "template watch for %r ended; resubscribing",
                            q, exc_info=t.exception(),
                        )
            # Still-wanted queries whose watch died get resubscribed after
            # a re-render (which also catches anything missed while the
            # watch was down) — one transient stream failure must not end
            # watch mode.
            if set(st.queries) - set(pumps):
                await asyncio.sleep(2.0)
                try:
                    await st.write()
                except Exception:
                    log.debug(
                        "template re-render failed; retrying",
                        exc_info=True,
                    )
                reconcile()

    await asyncio.gather(*(watch_one(st) for st in states))

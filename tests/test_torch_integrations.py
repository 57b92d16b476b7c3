"""The port's Consul bridge (``integrations/consul.py``) and template
engine (``tpl.py``) against the reference's, on the CPU. Their reference
cases (``test_ops_surface``'s consul and template cases) run against the
port in ``test_torch_agent_runtime.py``; here:

- ``hash_service``, ``hash_check`` and ``diff_statements`` give equal
  digests, statements and hash tables on seeded services and checks
  across a sequence of Consul states;
- the bridge's raw HTTP/1.1 client reads the same services through a
  chunked and a plain response;
- one template set rendered by each package against its own agent (fixed
  site ids and one fixed HLC clock) gives byte-equal files, and the same
  queries recorded for watch mode.
"""

import asyncio
import json
import random

import pytest

from corrosion_tpu import tpl as jtpl
from corrosion_tpu.client import CorrosionApiClient as JClient
from corrosion_tpu.integrations import consul as jconsul
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch import tpl as ttpl
from corrosion_tpu_torch.client import CorrosionApiClient as TClient
from corrosion_tpu_torch.integrations import consul as tconsul
from test_torch_agent_interop import fixed_clock, launch  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


def _services(rng: random.Random) -> tuple[dict, dict]:
    services, checks = {}, {}
    for i in rng.sample(range(12), rng.randrange(0, 9)):
        sid = f"svc-{i}"
        services[sid] = {
            "ID": sid, "Service": rng.choice(("web", "db", "cache", "")),
            "Tags": rng.sample(["a", "b", "c", "é"], rng.randrange(0, 4)) or None,
            "Meta": {k: rng.choice(("1", "2")) for k in rng.sample("xyz", rng.randrange(0, 3))},
            "Port": rng.choice((0, 80, 443, 8080)), "Address": rng.choice(("", "10.0.0.1")),
        }
        for j in range(rng.randrange(0, 3)):
            checks[f"{sid}-chk{j}"] = {
                "CheckID": f"{sid}-chk{j}", "ServiceID": sid, "ServiceName": services[sid]["Service"],
                "Name": rng.choice(("http", "tcp")), "Status": rng.choice(("passing", "critical")),
                "Output": rng.choice(("ok", "", "timeout")),
            }
    return services, checks


@pytest.mark.parametrize("seed", range(4))
def test_consul_diffs_and_hashes_equal_the_reference(seed):
    rng = random.Random(seed)
    known = {"ref": ({}, {}), "port": ({}, {})}
    for _ in range(12):
        services, checks = _services(rng)
        out = {}
        for side, mod in (("ref", jconsul), ("port", tconsul)):
            ks, kc = known[side]
            stmts, svc_h, chk_h = mod.diff_statements("node-1", services, checks, ks, kc)
            persist = (mod._hash_persist_statements("node-1", ks, svc_h, "__corro_consul_services")
                       + mod._hash_persist_statements("node-1", kc, chk_h, "__corro_consul_checks"))
            out[side] = (stmts, svc_h, chk_h, persist,
                         [mod.hash_service(s) for s in services.values()],
                         [mod.hash_check(c) for c in checks.values()])
            known[side] = (svc_h, chk_h)
        assert out["port"] == out["ref"]
    assert tconsul.SETUP_SQL == jconsul.SETUP_SQL


def test_consul_http_reads_chunked_and_plain_bodies():
    services = {"web-1": {"ID": "web-1", "Service": "web", "Port": 80}}
    body = json.dumps(services).encode()
    chunked = b"".join(b"%x\r\n%s\r\n" % (len(body[i:i + 7]), body[i:i + 7])
                       for i in range(0, len(body), 7)) + b"0\r\n\r\n"
    replies = iter([
        b"HTTP/1.1 200 OK\r\ntransfer-encoding: chunked\r\n\r\n" + chunked,
        b"HTTP/1.1 200 OK\r\ncontent-length: %d\r\n\r\n%s" % (len(body), body),
    ] * 2)

    async def main():
        async def on_conn(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            writer.write(next(replies))
            await writer.drain()
            writer.close()

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        addr = "127.0.0.1:%d" % server.sockets[0].getsockname()[1]
        try:
            return [await mod.ConsulHttp(addr).agent_services()
                    for mod in (jconsul, jconsul, tconsul, tconsul)]
        finally:
            server.close()
            await server.wait_closed()

    got = asyncio.run(main())
    assert got == [services] * 4
    assert tconsul._dechunk(chunked) == jconsul._dechunk(chunked) == body


TEMPLATES = {
    "hosts.conf.tpl": (
        "# generated\n"
        "<% for row in sql(\"SELECT id, text FROM tests ORDER BY id\"): %>"
        "server <%= row[0] %> <%= row[1] %>\n"
        "<% end %>"
        "count=<%= len(sql(\"SELECT id, text FROM tests ORDER BY id\")) %>\n"
    ),
    "rows.json.tpl": "<%= sql(\"SELECT id, text FROM tests ORDER BY id\").to_json(pretty=True) %>\n",
    "rows.csv.tpl": (
        "<%= sql(\"SELECT id, text FROM tests WHERE id > 1 ORDER BY id\").to_csv() %>"
        "<%= sql(\"SELECT id, text FROM tests WHERE id > 99\").to_csv(header=True) %>"
    ),
    "nested.tpl": (
        "<% for row in sql(\"SELECT id FROM tests ORDER BY id\"): %>"
        "<%= sql(\"SELECT text FROM tests WHERE id = \" + str(row[0])).rows[0][0] %>\n"
        "<% end %>"
    ),
}


async def _render(side: str, root) -> tuple[dict, dict]:
    mod, client_cls = {"ref": (jtpl, JClient), "port": (ttpl, TClient)}[side]
    ta = await launch(side, root / side)
    files, queries = {}, {}
    try:
        await ta.client.execute([["INSERT INTO tests (id, text) VALUES (?, ?)", [i, t]]
                                 for i, t in ((1, "svc-a"), (2, "svc, \"b\""), (3, "ünï"))])
        host, port = ta.agent.api_addr
        client = client_cls(host, port)
        for name, text in TEMPLATES.items():
            src = root / side / name
            src.write_text(text)
            st = mod.TemplateState(str(src), str(src).removesuffix(".tpl"), client)
            await st.write()
            files[name] = (root / side / name.removesuffix(".tpl")).read_bytes()
            queries[name] = st.queries
    finally:
        await ta.stop()
    return files, queries


def test_templates_render_byte_equal_to_the_reference(tmp_path, fixed_clock):
    ref_files, ref_queries = asyncio.run(_render("ref", tmp_path))
    port_files, port_queries = asyncio.run(_render("port", tmp_path))
    assert port_files == ref_files
    assert port_queries == ref_queries
    assert ref_files["nested.tpl"].decode().splitlines() == ["svc-a", "svc, \"b\"", "ünï"]
    assert len(ref_queries["nested.tpl"]) == 4
    for text in TEMPLATES.values():
        src_ref = jtpl.compile_template(text).__code__.co_code
        assert ttpl.compile_template(text).__code__.co_code == src_ref

"""The port's gossip-plane TLS (``agent/tls.py``) against the reference's,
on the CPU:

- the four cases of ``tests/test_tls.py``, run against the port's
  modules (``test_torch_core.run_against``) with a PKI the port's ``tls``
  generated;
- a mixed mTLS cluster, one reference agent and one port agent, whose CA
  one package made and whose certificates the other package made, in
  both orders: a write on each side reaches the other.

Like the reference's cases, these need the ``cryptography`` package.
"""

import asyncio

import pytest

pytest.importorskip("cryptography", reason="agent TLS plane needs the cryptography package")

import test_tls as ref_tls  # noqa: E402
from corrosion_tpu.agent import agent as jagent  # noqa: E402
from corrosion_tpu.agent import testing as jtesting  # noqa: E402
from corrosion_tpu.agent import tls as jtls  # noqa: E402
from corrosion_tpu_torch import native as tnative  # noqa: E402
from corrosion_tpu_torch.agent import agent as tagent  # noqa: E402
from corrosion_tpu_torch.agent import testing as ttesting  # noqa: E402
from corrosion_tpu_torch.agent import tls as ttls  # noqa: E402
from corrosion_tpu_torch.agent.transport import Transport  # noqa: E402
from corrosion_tpu_torch.core.values import Statement  # noqa: E402
from test_torch_agent_runtime import RUNTIME_SWAPS  # noqa: E402
from test_torch_core import reference_cases, run_against  # noqa: E402

TLS_SWAPS = dict(RUNTIME_SWAPS, **{"corrosion_tpu.agent.tls": ttls})
PACKAGES = {"ref": (jtls, jagent, jtesting), "port": (ttls, tagent, ttesting)}


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


def _pki(tls_mod, ca_mod, root) -> dict:
    """The reference fixture's PKI: a CA made by ``ca_mod``, a server
    certificate for 127.0.0.1 and a client certificate made by
    ``tls_mod``."""
    ca_dir = str(root / "ca")
    ca_mod.generate_ca(ca_dir)
    return {
        "ca": str(root / "ca" / ca_mod.CA_CERT),
        "ca_dir": ca_dir,
        "server": tls_mod.generate_server_cert(str(root / "server"), ca_dir, "127.0.0.1"),
        "client": tls_mod.generate_client_cert(str(root / "client"), ca_dir),
    }


@pytest.mark.parametrize("case", reference_cases(ref_tls))
def test_reference_tls_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    pki = _pki(ttls, ttls, tmp_path / "pki")
    run_against(ref_tls, case, TLS_SWAPS, monkeypatch, pki=pki, tmp_path=tmp_path)


def test_every_tls_case_is_run():
    assert len(reference_cases(ref_tls)) == 4


def _agent_tls(agent_mod, pki):
    return agent_mod.AgentTls(
        cert=pki["server"].cert, key=pki["server"].key, ca=pki["ca"],
        client_cert=pki["client"].cert, client_key=pki["client"].key, mtls=True,
    )


@pytest.mark.parametrize("ca_side,cert_side", [("ref", "port"), ("port", "ref")])
def test_mixed_mtls_cluster_converges(tmp_path, ca_side, cert_side):
    """A reference agent and a port agent gossip over mutual TLS with one
    package's CA and the other's certificates; each side's write reaches
    the other, and a peer holding a certificate of another CA is refused."""
    pki = _pki(PACKAGES[cert_side][0], PACKAGES[ca_side][0], tmp_path / "pki")

    async def main():
        cluster = []
        try:
            for side in ("ref", "port"):
                _, agent_mod, testing = PACKAGES[side]
                boot = [cluster[-1].gossip_addr] if cluster else None
                cluster.append(await testing.launch_test_agent(
                    str(tmp_path / side), bootstrap=boot, tls=_agent_tls(agent_mod, pki)))
            for i, ta in enumerate(cluster):
                await ta.client.execute(
                    [["INSERT INTO tests (id, text) VALUES (?, ?)", [i, f"tls-{i}"]]])

            async def converged():
                return all(ta.agent.store.query(Statement("SELECT id, text FROM tests ORDER BY id"))[1]
                           == [(0, "tls-0"), (1, "tls-1")] for ta in cluster)

            await jtesting.poll_until(converged, timeout=20)
            # A client holding another CA's certificate: no session.
            rogue = _pki(ttls, jtls, tmp_path / "rogue")
            client = Transport(ssl_client=ttls.client_ssl_context(
                rogue["ca"], rogue["client"].cert, rogue["client"].key))
            try:
                session = await client.open_session(cluster[1].gossip_addr, {"n": 1}, timeout=5)
                assert session is None or await session.recv(timeout=5) is None
            finally:
                client.close()
        finally:
            for ta in cluster:
                await ta.stop()

    asyncio.run(main())

"""The port's ``hostchaos/`` against the reference's, on the CPU:

- every case of ``tests/test_hostchaos.py`` run against the port's
  modules (``test_torch_core.run_against``): the netem plan and shim, the
  defence primitives, the machinery counters and the budget gate in tier
  1; the live scenarios keep the reference's ``slow`` mark;
- the port's test harness serves an agent again on a fresh gossip port
  when the datagram bind of the port its listener took fails;
- ``sim/host_oracles.py``'s host-chaos checks (``chip_smoke.py`` phase
  15), slow-marked like the reference's live scenarios.

Equality with the live reference (schedule fingerprints, the budget
gates) is ``test_torch_chaos_fidelity_interop.py``.
"""

import asyncio

import pytest

import test_hostchaos as ref_hostchaos
import corrosion_tpu_torch.hostchaos as thostchaos
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.agent import testing as ttesting
from corrosion_tpu_torch.agent import transport as ttransport
from corrosion_tpu_torch.hostchaos import harness as tharness
from corrosion_tpu_torch.hostchaos import report as treport
from corrosion_tpu_torch.hostchaos import scenarios as tscenarios
from corrosion_tpu_torch.sim import host_oracles as H
from test_torch_agent_runtime import RUNTIME_SWAPS
from test_torch_core import reference_cases, run_against

# The package first: ``run_against`` sets each module's attribute on the
# package object that ``sys.modules`` holds by then.
HOSTCHAOS_SWAPS = {
    "corrosion_tpu.hostchaos": thostchaos,
    "corrosion_tpu.hostchaos.harness": tharness,
    "corrosion_tpu.hostchaos.report": treport,
    "corrosion_tpu.hostchaos.scenarios": tscenarios,
    **RUNTIME_SWAPS,
}
SLOW = tuple(c for c in reference_cases(ref_hostchaos)
             if "slow" in [m.name for m in getattr(getattr(ref_hostchaos, c), "pytestmark", [])])
CASES = [pytest.param(c, marks=pytest.mark.slow) if c in SLOW else c
         for c in reference_cases(ref_hostchaos)]


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


@pytest.mark.parametrize("case", CASES)
def test_reference_hostchaos_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    run_against(ref_hostchaos, case, HOSTCHAOS_SWAPS, monkeypatch, tmp_path=tmp_path)


def test_every_case_is_run_and_the_slow_ones_keep_their_mark():
    assert len(reference_cases(ref_hostchaos)) == 27
    assert len(SLOW) == 7
    assert set(SLOW) == {
        "test_hard_kill_rehydrates_and_reconnect_replays_gap", "test_scenario_wan_steady",
        "test_scenario_kill_restart", "test_scenario_link_flap",
        "test_scenario_partition_heal", "test_wan_full_acceptance", "test_scenario_flap_soak",
    }


def test_the_swap_reaches_the_port(monkeypatch):
    run_against(ref_hostchaos, "test_counter_total_sums_labeled_series", HOSTCHAOS_SWAPS,
                monkeypatch)
    import sys

    assert sys.modules["corrosion_tpu.hostchaos.harness"] is tharness
    assert ref_hostchaos.NetemShim is RUNTIME_SWAPS["corrosion_tpu.agent.netem"].NetemShim


def test_hostchaos_context_resolves_its_device():
    """No device and no CUDA raises; ``device="cpu"`` describes the CPU."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            treport.hostchaos_context(3, "wan_steady", 0)
    ctx = treport.hostchaos_context(3, "wan_steady", 0, device="cpu")
    assert ctx["platform"] == "cpu" and ctx["scenario"] == "host_chaos_smoke"
    assert ctx["nodes"] == 3 and ctx["device_count"] == 1
    treport.emit_hostchaos_report(ctx)


def test_the_scenarios_are_the_references():
    """The seven scenarios with the shared agent knobs unchanged."""
    from corrosion_tpu.hostchaos import scenarios as jscenarios

    assert tscenarios._BASE_CFG == jscenarios._BASE_CFG
    assert tscenarios._SYNC_DEFENSE_CFG == jscenarios._SYNC_DEFENSE_CFG
    assert sorted(tscenarios.SCENARIOS) == sorted(jscenarios.SCENARIOS)
    for name in tscenarios.SCENARIOS:
        got, want = tscenarios.get_scenario(name), jscenarios.get_scenario(name)
        assert got.summary() == want.summary(), name
        assert got.plan.to_json() == want.plan.to_json(), name
    with pytest.raises(ValueError, match="unknown host-chaos scenario"):
        tscenarios.get_scenario("gremlins")


# -- the harness's gossip port -------------------------------------------------


def test_a_gossip_port_that_lost_its_datagram_bind_is_served_again(tmp_path, monkeypatch):
    """The listener takes a port free for TCP only; where another socket
    holds its UDP number the datagram bind fails. The harness serves the
    agent again on a fresh port, so every agent of a cluster has its
    datagram plane and the cluster converges over it."""
    real = ttransport.Transport.serve
    served = []

    async def refuse(*a, **k):
        raise OSError(98, "Address already in use")

    async def serve(self, host, port, handler):
        loop = asyncio.get_running_loop()
        first = not served  # the first datagram bind of the first agent fails
        if first:
            loop.create_datagram_endpoint = refuse
        try:
            addr = await real(self, host, port, handler)
        finally:
            if first:
                del loop.create_datagram_endpoint  # the loop's own method again
        served.append((addr, self._udp is not None))
        return addr

    monkeypatch.setattr(ttransport.Transport, "serve", serve)

    async def main():
        agents = await ttesting.launch_test_cluster(str(tmp_path), 3)
        try:
            assert all(ta.agent.transport._udp is not None for ta in agents)
            await agents[0].client.execute(
                [["INSERT INTO tests (id, text) VALUES (?, ?)", [1, "udp"]]])

            async def seen():
                return all(H.agent_digest(ta) == "1=udp" for ta in agents)

            await ttesting.poll_until(seen, timeout=20)
        finally:
            await ttesting.stop_cluster(agents)

    asyncio.run(main())
    assert [ok for _, ok in served] == [False, True, True, True], served
    assert served[0][0] != served[1][0]


def test_a_fixed_gossip_port_is_not_moved(tmp_path):
    """A relaunch on its old port keeps it, datagram plane or not: only
    an ephemeral port is chosen again."""

    async def main():
        a = await ttesting.launch_test_agent(str(tmp_path / "a"))
        port = a.gossip_addr[1]
        await ttesting.hard_kill(a)
        b = await ttesting.relaunch_test_agent(a)
        try:
            assert b.gossip_addr[1] == port
        finally:
            await b.stop()

    asyncio.run(main())


# -- the host oracles of chip_smoke.py phase 15 (live: slow) ------------------------


@pytest.mark.slow
def test_hostchaos_pair_oracle(tmp_path):
    out = H.hostchaos_pair("cpu", root=tmp_path)
    assert out["kill_restart"]["machinery"]["breaker_trips"] >= 1
    assert out["budget_breaches"] == []
    for name in H.HOSTCHAOS_PAIR:
        assert out[name]["violations"] == 0 and out[name]["rows"] == out[name]["commits"]


@pytest.mark.slow
def test_hostchaos_soak_oracle(tmp_path):
    out = H.hostchaos_soak(root=tmp_path)
    assert sorted(out["agents"]) == ["n0", "n1", "n2"]
    assert {r["kinds"][0] for r in out["agents"]["n0"]["resets"].values()} == {"restart"}

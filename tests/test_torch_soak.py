"""The port's ``soak_preempt`` drill against the reference's
``run_soak_preempt_scenario`` on the CPU: the same report in every field
but the wall and the byte prediction, which the port makes at its own
itemsizes (checked at the reference's as ``test_torch_elastic`` does),
and the same series file byte for byte. Both drills run once for the
module, the port's in a thread beside the reference's: the reference's
alone takes most of the file's time.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import pytest

from corrosion_tpu.elastic import scenarios as jscenarios
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.elastic import reshard as treshard
from corrosion_tpu_torch.elastic import scenarios as tscenarios
from corrosion_tpu_torch.obs import series as tseries
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.sim import engine as tengine


@pytest.fixture(scope="module")
def soak_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("soak")
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(tscenarios.run_scenario, "soak_preempt",
                           series_path=str(d / "port.jsonl"), device="cpu")
        jrep = jscenarios.run_soak_preempt_scenario(str(d / "ref.jsonl"))
        trep = port.result(timeout=600)
    return jrep, trep, d


def _port_bytes_at_reference_itemsizes() -> int:
    from corrosion_tpu_torch.sim import invariants as tinv

    cfg, _, sched = tinv._dense_scenario(tscenarios._preempt_plan(), 0, "cpu")
    state = tengine.init_cluster(cfg, len(sched.sample_writer), "cpu")
    mesh = treshard.virtual_mesh(8, "cpu")
    return tmesh.predicted_per_device_bytes(
        interop.to_numpy(state), tmesh.cluster_state_specs(state, mesh), mesh
    )


def test_soak_preempt_report_equals_the_reference(soak_pair):
    jrep, trep, _ = soak_pair
    assert trep["ok"] and trep["scenario"] == "soak_preempt" and not trep["violations"]
    jrep, trep = copy.deepcopy(jrep), copy.deepcopy(trep)
    jrep.pop("wall_s"), trep.pop("wall_s")
    assert jrep["reconcile"].pop("predicted_per_device_bytes") == _port_bytes_at_reference_itemsizes()
    trep["reconcile"].pop("predicted_per_device_bytes")
    assert trep == jrep


def test_soak_preempt_series_and_resets(soak_pair):
    _, trep, d = soak_pair
    assert (d / "port.jsonl").read_bytes() == (d / "ref.jsonl").read_bytes()
    data = tseries.replay_series(str(d / "port.jsonl"))
    assert len(data["headers"]) == 1
    assert len(data["samples"]) == tscenarios.PREEMPT_ROUNDS == trep["endurance"]["samples"]
    events = len(tscenarios.PREEMPT_EVENTS)
    for stem in ("corro_changes_committed", "corro_changes_applied"):
        assert trep["endurance"]["resets"][stem]["kinds"] == ["restart"]
        assert trep["endurance"]["resets"][stem]["events"] == events
    assert trep["endurance"]["ok"] and trep["endurance"]["detectors_armed"]["wedge"]
    assert not tseries.MetricSeriesRecorder._live.get(str(d / "port.jsonl"))

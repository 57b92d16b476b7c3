"""The port's device-cost plane (``corrosion_tpu_torch/obs/costs.py``) on
the CPU, against the live JAX reference where the two compute the same
thing:

- a counted cost entry is deterministic (two runs of each engine give the
  same counts), counts each kernel-bearing function as one op at
  the byte formula ``chip_smoke.py``'s kernel bounds share
  (``kernel_cost``, also at the u32 width), and counts views as nothing;
- the roofline stage costs of the composite are positive increments for
  every plane (the reference's ``test_roofline_stage_costs_are_positive_
  increments``);
- ``diff_cost_models`` gates regressions as the reference's does, on the
  reference's own cases (``tests/test_cost_plane.py``);
- memory watermarks are sampled at every chunk boundary and reconcile
  against the placement at rest; an unsampled watermark or a doctored
  prediction raises;
- ``predicted_state_bytes`` at the reference's itemsizes equals the
  reference's on the 8-position mesh, and at the port's equals a live
  placement to the byte; the capacity model validates its 512-node point
  exactly and refuses a contradicted measured point.

Tolerance: exact everywhere.
"""

import json

import numpy as np
import pytest
import torch

from corrosion_tpu.obs import costs as jcosts
from corrosion_tpu.sim import benchlib as jbench
from corrosion_tpu_torch import interop, parallel
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import costs
from corrosion_tpu_torch.ops import onehot
from corrosion_tpu_torch.parallel import mesh as tmesh
from corrosion_tpu_torch.sim import benchlib, telemetry
from corrosion_tpu_torch.sim import engine as tengine

torch.set_num_threads(1)

COUNTED = ("flops", "bytes_accessed", "ops", "kernel_calls", "argument_bytes", "output_bytes",
           "temp_bytes", "peak_bytes", "config_fingerprint", "rounds", "entry")


@pytest.mark.parametrize("engine,d", [("dense", 1), ("sparse", 1), ("chunk", 1), ("mixed", 1),
                                      ("dense", 8)])
def test_cost_entry_is_deterministic(engine, d):
    a = costs.cost_entry(engine, device_count=d, device="cpu")
    b = costs.cost_entry(engine, device_count=d, device="cpu")
    assert {k: a[k] for k in COUNTED} == {k: b[k] for k in COUNTED}
    assert a["flops"] > 0 and a["bytes_accessed"] > 0 and a["peak_bytes"] >= a["temp_bytes"] > 0
    assert a["engine"] == engine and a["variant"] == "plain" and a["device_count"] == d
    if engine != "chunk":  # the chunk plane launches no kernel
        assert a["kernel_calls"]
    assert "allocator_peak_bytes" not in a  # the card's only


def test_cost_model_keys_and_provenance():
    model = costs.build_cost_model(engines=("chunk",), device_counts=(1, 8), device="cpu")
    assert model["schema"] == costs.COST_SCHEMA
    assert (model["platform"], model["backend"]) == ("cpu", "plain")
    assert sorted(model["entries"]) == ["chunk/plain/d1", "chunk/plain/d8"]
    with pytest.raises(ValueError, match="variant"):
        costs.cost_entry("dense", "donated", device="cpu")


def test_save_and_load_model(tmp_path):
    model = {"schema": costs.COST_SCHEMA, "entries": {"x": {"flops": 1.0}}}
    costs.save_model(model, str(tmp_path / "m.json"))
    assert costs.load_model(str(tmp_path / "m.json")) == model
    (tmp_path / "bad.json").write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="schema"):
        costs.load_model(str(tmp_path / "bad.json"))


def test_a_kernel_bearing_function_is_one_op_at_the_bound_formula():
    g = torch.Generator().manual_seed(0)
    table = torch.randint(0, 1 << 24, (6, 40), generator=g)
    idx = torch.randint(-2, 43, (6, 9), generator=g)
    out, c = costs.count(lambda: onehot.rowgather(table, idx))
    ok = (idx >= 0) & (idx < 40)
    words = len({(r, int(x)) for r in range(6) for x, k in zip(idx[r], ok[r]) if k})
    assert (c.ops, dict(c.kernel_calls)) == (1, {"rowgather": 1})
    assert c.bytes == idx.numel() * 8 + out.numel() * 8 + words * 8
    assert c.flops == idx.numel()
    # A broadcast index is read once.
    cols = torch.tensor([3, 1, 39])
    _, c = costs.count(lambda: onehot.rowgather(table, cols[None, :].expand(6, 3)))
    assert c.bytes == 3 * 8 + 18 * 8 + len({(r, x) for r in range(6) for x in (1, 3, 39)}) * 8
    # rowmax: its three inputs and its output, 2 operations an entry.
    val = torch.randint(0, 1 << 20, (6, 9), generator=g)
    mask = torch.rand((6, 9), generator=g) < 0.5
    out, c = costs.count(lambda: onehot.rowmax(idx, val, mask, 40))
    assert c.bytes == 6 * 9 * (8 + 8 + 1) + out.numel() * 8 and c.flops == 2 * 54



def test_kernel_cost_at_the_u32_width_and_duplicate_window_words():
    """``kernel_cost`` is also ``chip_smoke.py``'s kernel bound: at
    ``int64_as=4`` an int64 element counts 4 bytes (the u32 bound), other
    dtypes their own; the window reads each (row, column) a valid message
    addresses once, however many copies address it, valid or not."""
    idx = torch.tensor([[0, 0, 2], [1, 1, 1]])
    d = torch.zeros((2, 3), dtype=torch.int64)
    adv_m = torch.ones((2, 3), dtype=torch.int64)
    valid = torch.tensor([[True, False, True], [False, False, True]])
    oo = torch.zeros((1, 2, 4), dtype=torch.int64)
    out = onehot.window_delivery(oo, idx, d, adv_m, valid, 32, 4)
    args = (oo, idx, d, adv_m, valid, 32, 4)
    # Three words: (0, 0), (0, 2), (1, 1).
    assert [t.dtype for t in out] == [torch.bool, torch.int64]
    assert costs.kernel_cost("window_delivery", args, out) == (
        6 * (8 + 8 + 8 + 1) + 6 + 8 * 8 + 3 * 8, 48)
    assert costs.kernel_cost("window_delivery", args, out, int64_as=4) == (
        6 * (4 + 4 + 4 + 1) + 6 + 8 * 4 + 3 * 4, 48)
    table = torch.arange(8).view(2, 4)
    cols = torch.tensor([3, 1])
    got = onehot.rowgather(table, cols.expand(2, 2))
    assert costs.kernel_cost("rowgather", (table, cols.expand(2, 2)), got, int64_as=4) == (
        2 * 4 + 4 * 4 + 4 * 4, 4)

def test_views_are_free_and_reductions_count_their_input():
    x = torch.arange(24)
    _, c = costs.count(lambda: x.view(4, 6)[1:, ::2].t())
    assert (c.ops, c.bytes, c.flops) == (0, 0, 0)
    _, c = costs.count(lambda: x.sum())
    assert (c.ops, c.bytes, c.flops) == (1, 24 * 8 + 8, 24)
    _, c = costs.count(lambda: x + 1)
    assert (c.ops, c.bytes, c.flops) == (1, 24 * 8 + 24 * 8, 24)  # the scalar is no tensor


def test_roofline_stage_costs_are_positive_increments():
    cfg, topo, sched = tb.merge_10k(n=32, rounds=9, samples=8, device="cpu")
    final, _ = tengine.simulate(cfg, topo, sched, seed=0, max_chunk=3, device="cpu")
    composite, stages, carry0 = benchlib.plane_composite(cfg, topo, sched, final)
    sc = costs.roofline_stage_costs(composite, stages, carry0)
    assert set(sc) == set(benchlib.PLANE_STAGES)
    for name, s in sc.items():
        assert s["flops"] > 0 and s["bytes"] > 0, name
    assert sc == costs.roofline_stage_costs(composite, stages, carry0)


def _diff_cases():
    base = {
        "schema": costs.COST_SCHEMA, "platform": "cpu", "backend": "native", "jax_version": "x",
        "torch_version": "x", "tolerance": 0.25,
        "entries": {
            "dense/plain/d1": {"config_fingerprint": "aa", "flops": 1000.0,
                               "bytes_accessed": 2000.0, "peak_bytes": 300, "temp_bytes": 100},
            "sparse/plain/d1": {"config_fingerprint": "bb", "flops": 10.0,
                                "bytes_accessed": 10.0, "peak_bytes": 10, "temp_bytes": 1},
        },
    }

    def edit(fn):
        c = json.loads(json.dumps(base))
        fn(c)
        return c

    def worse(c):
        c["entries"]["dense/plain/d1"]["flops"] = 1500.0
        c["entries"]["sparse/plain/d1"]["flops"] = 5.0

    def drift(c):
        del c["entries"]["sparse/plain/d1"]
        c["entries"]["dense/plain/d1"]["config_fingerprint"] = "zz"

    def new_entry(c):
        c["entries"]["mixed/plain/d8"] = {"config_fingerprint": "cc", "flops": 1.0}

    def memory(c):
        c["entries"]["sparse/plain/d1"]["peak_bytes"] = 13
        c["entries"]["sparse/plain/d1"]["temp_bytes"] = 1.2

    return {
        "same": (base, edit(lambda c: None), None),
        "worse": (base, edit(worse), None),
        "drift": (base, edit(drift), None),
        "platform": (base, edit(lambda c: c.update(platform="tpu")), None),
        "backend": (base, edit(lambda c: c.update(backend="pallas")), None),
        "new entry": (base, edit(new_entry), None),
        "memory": (base, edit(memory), None),
        "memory at 0.5": (base, edit(memory), 0.5),
        "worse at 0.6": (base, edit(worse), 0.6),
    }


@pytest.mark.parametrize("case", sorted(_diff_cases()))
def test_diff_cost_models_gates_as_the_reference(case):
    base, cand, tol = _diff_cases()[case]
    ok, breaches, notes = costs.diff_cost_models(base, cand, tol)
    jok, jbreaches, jnotes = jcosts.diff_cost_models(base, cand, tol)
    assert ok == jok
    assert [b.split(":")[0] for b in breaches] == [b.split(":")[0] for b in jbreaches]
    entry_notes = [n.split(":")[0] for n in notes if "/" in n.split(":")[0]]
    assert entry_notes == [n.split(":")[0] for n in jnotes if "/" in n.split(":")[0]]
    assert costs.GATED_METRICS == jcosts.GATED_METRICS
    assert costs.DEFAULT_COST_TOLERANCE == jcosts.DEFAULT_COST_TOLERANCE == 0.25


def _placed_run(chunk):
    cfg, topo, sched = tb.wan_100k(n=64, n_regions=4, n_writers=16, rounds=24, samples=16,
                                   partition=False, device="cpu")
    wm = costs.MemoryWatermarks()
    tele = telemetry.KernelTelemetry(engine="dense", watermarks=wm)
    mesh = tmesh.multichip_mesh(8, device="cpu")
    final, _ = parallel.simulate_sharded(cfg, topo, sched, mesh, seed=0, max_chunk=chunk,
                                         telemetry=tele)
    return cfg, sched, mesh, final, wm


def test_watermarks_sampled_at_chunk_boundaries_reconcile():
    cfg, sched, mesh, final, wm = _placed_run(8)
    assert wm.samples == 3 and set(wm.peak) == {"cpu"} and wm.allocator_peak == {}
    predicted = costs.predicted_state_bytes(cfg, len(sched.sample_writer), mesh)
    rep = costs.reconcile_memory(final, watermarks=wm, predicted_per_device=predicted)
    assert rep["at"] == "rest" and rep["positions"] == 8
    assert rep["state_bytes_per_position_max"] == predicted
    # The whole placement lives on the CPU once, under the watermark.
    assert 0 < rep["held_bytes_by_device"]["cpu"] <= wm.peak["cpu"]
    with pytest.raises(ValueError, match="never sampled"):
        costs.reconcile_memory(final, watermarks=costs.MemoryWatermarks())
    with pytest.raises(ValueError, match="predicted"):
        costs.reconcile_memory(final, predicted_per_device=predicted // 2)
    low = costs.MemoryWatermarks()
    low.samples, low.peak = 1, {"cpu": 1}
    with pytest.raises(ValueError, match="sampler missed"):
        costs.reconcile_memory(final, watermarks=low)
    with pytest.raises(ValueError, match="output_bytes"):
        costs.reconcile_memory(final, cost={"output_bytes": 10})
    with pytest.raises(ValueError, match="placed"):
        costs.reconcile_memory(tmesh.assemble(final))


class _Shape:
    """A leaf's shape at a numpy dtype."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)


def _reference_widths(tree, name=""):
    """A state's leaves at the reference's itemsizes (u32, i32, bool), named
    as ``interop.to_numpy`` names them."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_reference_widths(getattr(tree, f), f) for f in tree._fields))
    if tree.dtype == torch.bool:
        return _Shape(tree.shape, np.bool_)
    return _Shape(tree.shape, np.uint32 if name in interop.U32_FIELDS else np.int32)


def test_predicted_state_bytes_equal_the_reference_at_its_itemsizes():
    """The prediction's spec arithmetic over the ``meta`` shapes, at the
    reference's itemsizes, gives the reference's figure on the 8-position
    mesh; at the port's it is ``predicted_state_bytes``."""
    jmesh = jbench.multichip_mesh(8)
    tm = tmesh.multichip_mesh(8, device="cpu")
    for n in (512, 100_352, 1_003_520):
        cfg, _, sched = costs.flagship_cfg(n)
        jcfg, _, jsched = jcosts.flagship_cfg(n)
        shapes = tengine.init_cluster(cfg, len(sched.sample_writer), device="meta")
        specs = tmesh.cluster_state_specs(shapes, tm)
        want = jcosts.predicted_state_bytes(jcfg, len(jsched.sample_writer), jmesh)
        assert tmesh.predicted_per_device_bytes(_reference_widths(shapes), specs, tm) == want, n
        assert costs.predicted_state_bytes(cfg, len(sched.sample_writer), tm) == \
            tmesh.predicted_per_device_bytes(shapes, specs, tm)


def test_prediction_equals_a_live_placement():
    tm = tmesh.multichip_mesh(8, device="cpu")
    cfg, _, sched = costs.flagship_cfg(4096)
    placed = costs.measure_placement(cfg, len(sched.sample_writer), tm)
    assert placed == {"per_device_bytes": costs.predicted_state_bytes(
        cfg, len(sched.sample_writer), tm)}


def test_capacity_model_validates_and_refuses():
    with pytest.raises(ValueError, match="memory_bytes"):
        costs.capacity_model(node_counts=(4096,), device="cpu")
    with pytest.raises(ValueError, match="device_count"):
        costs.capacity_model(node_counts=(4096,), device_count=1, memory_bytes=1 << 30,
                             device="cpu")
    tm = tmesh.multichip_mesh(8, device="cpu")
    cfg, _, sched = costs.flagship_cfg(8192)
    point = {"nodes": 8192, "device_count": 8, "source": "a live placement in this test",
             **costs.measure_placement(cfg, len(sched.sample_writer), tm)}
    model = costs.capacity_model(node_counts=(4096, 8192, 16_384), memory_bytes=64 * 2**20,
                                 measured_100k=point, device="cpu")
    assert model["schema"] == costs.CAPACITY_SCHEMA and model["mesh"] == {"dcn": 2, "ici": 4}
    assert model["validation"]["lane_512"]["exact"]
    assert model["validation"]["large_100k"]["relative_error"] == 0.0
    assert [c["nodes"] for c in model["curve"]] == [4096, 8192, 16_384]
    assert all(c["verdict"] in ("fits", "tight", "exceeds") for c in model["curve"])
    assert model["state_bytes_per_node"] == pytest.approx(costs.bytes_per_node(model), abs=0.05)
    assert np.isclose(model["state_bytes_per_node"],
                      (model["curve"][-1]["per_device_bytes"] - model["curve"][0]["per_device_bytes"])
                      / (16_384 - 4096) * 8, atol=0.05)
    doctored = dict(point, per_device_bytes=point["per_device_bytes"] * 2)
    with pytest.raises(ValueError, match="capacity validation failed"):
        costs.capacity_model(node_counts=(4096,), memory_bytes=1 << 30,
                             measured_100k=doctored, device="cpu")

"""The bench half of the port's telemetry (``time_scan_step``,
``PlaneAttribution``, ``attribute_planes``, ``check_bench_invariants``)
against the live JAX reference on the CPU:

- ``PlaneAttribution`` telescopes, checks and scales exactly as the
  reference's on the same cumulative timings (the same Python float
  arithmetic, so equal to the bit);
- ``check_bench_invariants`` accepts and rejects exactly the reports the
  reference does, on the reference's own cases
  (``tests/test_perf_plane.py``, ``tests/test_kernel_telemetry.py``);
- ``attribute_planes`` on a toy composite telescopes and scales onto a
  run wall, and ``time_scan_step`` runs one warm-up step and then
  ``iters`` steps from the carry it was given.

Tolerance: exact everywhere.
"""

import math

import pytest
import torch

from corrosion_tpu.sim import benchlib as jbench
from corrosion_tpu.sim import telemetry as jtele
from corrosion_tpu_torch.sim import benchlib as tbench
from corrosion_tpu_torch.sim import telemetry as ttele

CUM = [
    (("broadcast", "swim", "sync", "track"), (1.0, 51.3, 71.9, 102.25, 110.0)),
    (("a", "b"), (0.5, 0.4, 2.0)),  # a negative increment, clamped at 0 by scale
    (("a",), (0.0, 0.0)),  # full_ms 0: the whole step is residual
    (("a", "b", "c"), (3.3, 7.1, 7.1, 12.9)),
]


@pytest.mark.parametrize("stages,cum", CUM)
@pytest.mark.parametrize("step_ms", [100.0, 1189.1, 0.0, 33.333])
def test_attribution_telescopes_and_scales_as_the_reference(stages, cum, step_ms):
    t = ttele.PlaneAttribution(stages=stages, cum_ms=cum)
    j = jtele.PlaneAttribution(stages=stages, cum_ms=cum)
    assert (t.full_ms, t.overhead_ms, t.increments) == (j.full_ms, j.overhead_ms, j.increments)
    t.check()
    assert t.scale(step_ms) == j.scale(step_ms)
    plane, residual = t.scale(step_ms)
    assert sum(plane.values()) + residual == pytest.approx(step_ms, abs=1e-9)


def test_broken_telescoping_is_refused_by_both():
    class Bent(ttele.PlaneAttribution):
        @property
        def increments(self):
            return {s: 1.0 for s in self.stages}

    with pytest.raises(AssertionError, match="telescoping"):
        Bent(stages=("a",), cum_ms=(0.0, 5.0)).check()


_PROVENANCE = {
    "platform": "cpu",
    "nodes": 128,
    "device_count": 1,
    "config_fingerprint": "deadbeefcafe0123",
}


def _reports(bench):
    """The reference's cases (tests/test_perf_plane.py), built with each
    package's own benchlib."""
    plane = {"swim": 10.0, "broadcast": 50.0, "sync": 30.0}
    stage_costs = {k: {"flops": 1e6 * (i + 1), "bytes": 2e6 * (i + 1)} for i, k in enumerate(plane)}
    one = {"broadcast": 50.0}
    bad = bench.roofline_report({"broadcast": {"flops": 1e6, "bytes": 1e6}}, one)
    bad["broadcast"]["flops_per_s"] = 123.0
    bad_b = bench.roofline_report({"broadcast": {"flops": 1e6, "bytes": 1e6}}, one)
    bad_b["broadcast"]["bytes_per_s"] = 5.0
    split = bench.compile_split_report(74.82, 61234.5)
    cases = {
        "consistent": {
            **_PROVENANCE, "step_ms": 100.0, "step_inner_ms": 90.0, "plane_ms": plane,
            "residual_ms": 10.0, "roofline": bench.roofline_report(stage_costs, plane),
            "step_ms_100k": 50.0, "step_inner_ms_100k": 49.0,
        },
        "planes without roofline": {**_PROVENANCE, "step_ms": 60.0, "plane_ms": one,
                                    "residual_ms": 10.0},
        "doctored flops_per_s": {**_PROVENANCE, "step_ms": 60.0, "plane_ms": one,
                                 "residual_ms": 10.0, "roofline": bad},
        "doctored bytes_per_s": {**_PROVENANCE, "step_ms": 60.0, "plane_ms": one,
                                 "residual_ms": 10.0, "roofline": bad_b},
        "roofline missing a plane": {
            **_PROVENANCE, "step_ms": 60.0, "plane_ms": {"broadcast": 40.0, "sync": 10.0},
            "residual_ms": 10.0, "roofline": bench.roofline_report({}, {"broadcast": 40.0}),
        },
        "roofline entry missing a field": {
            **_PROVENANCE, "step_ms": 60.0, "plane_ms": one, "residual_ms": 10.0,
            "roofline": {"broadcast": {"flops": 1.0, "bytes": 1.0}},
        },
        "compile split ok": {**_PROVENANCE, "step_ms": 10.0, **split, "steady_compiles": 0},
        "compile_ms alone": {**_PROVENANCE, "step_ms": 10.0, "compile_ms": 5.0},
        "negative split": {**_PROVENANCE, "step_ms": 10.0, "compile_ms": -1.0,
                           "first_step_ms": 2.0},
        "split not reconstructing": {**_PROVENANCE, "step_ms": 10.0,
                                     "first_run_incl_compile_s": 10.0, "compile_ms": 5.0,
                                     "first_step_ms": 5.0},
        "steady compiles": {**_PROVENANCE, "step_ms": 10.0, "steady_compiles": 2},
        "inner above step (r05)": {**_PROVENANCE, "step_ms": 1189.1, "step_inner_ms": 1545.2},
        "planes not partitioning (r05)": {
            **_PROVENANCE, "step_ms": 1189.1, "plane_ms": {"swim": 53.8, "broadcast": 807.6},
            "residual_ms": 0.2,
        },
        "suffixed planes not partitioning": {
            **_PROVENANCE, "step_ms": 10.0, "step_ms_100k": 50.0,
            "plane_ms_100k": {"a": 10.0}, "residual_ms_100k": 1.0,
        },
        "suffixed inner above step": {**_PROVENANCE, "step_ms": 10.0, "step_ms_100k": 50.0,
                                      "step_inner_ms_100k": 51.0},
        "scenario extra missing": {**_PROVENANCE, "step_ms": 10.0},
    }
    for missing in _PROVENANCE:
        cases[f"without {missing}"] = {
            **{k: v for k, v in _PROVENANCE.items() if k != missing}, "step_ms": 10.0,
        }
    cases["empty platform"] = {**_PROVENANCE, "platform": "", "step_ms": 10.0}
    return cases


def _verdict(check, report, extra=()):
    try:
        out = check(report, extra_provenance=extra)
    except ValueError as e:
        return "rejects", str(e).split(":")[0].split(" ")[0]
    assert out is report
    return "accepts", None


@pytest.mark.parametrize("case", sorted(_reports(tbench)))
@pytest.mark.parametrize("extra", [(), ("scenario",)])
def test_check_bench_invariants_decides_as_the_reference(case, extra):
    got = _verdict(ttele.check_bench_invariants, _reports(tbench)[case], extra)
    want = _verdict(jtele.check_bench_invariants, _reports(jbench)[case], extra)
    assert got[0] == want[0], (case, got, want)


@pytest.mark.parametrize("field,case", [
    ("roofline", "planes without roofline"),
    ("flops_per_s", "doctored flops_per_s"),
    ("first_step_ms", "compile_ms alone"),
    ("reconstruct", "split not reconstructing"),
    ("steady_compiles", "steady compiles"),
    ("step_inner_ms", "inner above step (r05)"),
    ("partition", "planes not partitioning (r05)"),
    ("platform", "without platform"),
    ("config_fingerprint", "without config_fingerprint"),
])
def test_rejections_name_the_reference_s_field(field, case):
    with pytest.raises(ValueError, match=field):
        ttele.check_bench_invariants(_reports(tbench)[case])


def _toy(enabled):
    def step(carry, i):
        x = carry
        if "a" in enabled:
            x = x + 1.0
        if "b" in enabled:
            x = x * 1.0001
        return x

    return step


def test_attribute_planes_on_a_toy_composite():
    attr = ttele.attribute_planes(_toy, ("a", "b"), torch.zeros(64), iters=3)
    attr.check()
    assert attr.full_ms > 0 and len(attr.cum_ms) == 3
    plane, residual = attr.scale(100.0)
    assert set(plane) == {"a", "b"} and all(v >= 0 for v in plane.values())
    assert math.isclose(sum(plane.values()) + residual, 100.0, abs_tol=1e-9)


def test_time_scan_step_runs_warm_up_then_iters_from_the_carry():
    seen = []

    def step(carry, i):
        seen.append((int(carry), i))
        return carry + 1

    ms = ttele.time_scan_step(step, torch.tensor(0), iters=4)
    assert ms >= 0.0
    # One untimed warm-up step from the carry, then four chained steps.
    assert seen == [(0, 0), (0, 0), (1, 1), (2, 2), (3, 3)]

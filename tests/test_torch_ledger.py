"""The port's ledger of the kernel library's build and load
(``corrosion_tpu_torch/obs/ledger.py``), on the CPU, driven through
``cuda_build``'s listener hook (``cuda_build._notify``, which ``build``
and ``load`` call): windows and their records, nesting, publish-once, the
armed tripwire, and the ledger window a ``KernelTelemetry`` chunk opens
on the engines. A real build and load is the positive control, on the
card only (``tests/test_torch_cuda.py``).
"""

import importlib
import json
from collections import defaultdict

import pytest
import torch

from corrosion_tpu_torch import cuda_build
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.obs import ledger
from corrosion_tpu_torch.ops import onehot
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import telemetry

torch.set_num_threads(1)


class Registry:
    """The duck-typed registry surface the ledger and the telemetry
    publish to; counters kept, gauges and histograms taken and dropped."""

    def __init__(self):
        self.values = defaultdict(float)

    def counter(self, name, help_=""):
        reg = self

        class C:
            def inc(self, v, **labels):
                reg.values[(name, tuple(sorted(labels.items())))] += v

        return C()

    def gauge(self, name, help_=""):
        class G:
            def set(self, v, **labels):
                pass

        return G()

    def histogram(self, name, help_=""):
        class H:
            def observe(self, v, **labels):
                pass

        return H()


@pytest.fixture
def led():
    with ledger.CompileLedger().watch_engines() as led:
        yield led


def test_engine_modules_and_watch_set():
    assert set(ledger.ENGINE_MODULES) == {"dense", "sparse", "chunk", "mixed"}
    for path in ledger.ENGINE_MODULES.values():
        assert path.startswith("corrosion_tpu_torch.sim.")
        importlib.import_module(path)
    fns = ledger.jitted_functions(tengine)
    assert set(fns) == set(onehot.OPERATORS)
    # Nothing is loaded on the CPU: no operator is registered.
    assert ledger.cache_sizes(fns) == dict.fromkeys(onehot.OPERATORS, 0)


def test_window_records_events_through_the_hook(led):
    with led.window("first_run") as w:
        cuda_build._notify("build", 1.5)
        cuda_build._notify("load", 0.25)
    assert (w.compiles, w.kinds, w.fns) == (2, {"build": 1, "load": 1}, {})
    assert w.compile_ms == pytest.approx(1750.0)
    assert w.wall_ms >= 0.0
    assert w.to_record() == {"kind": "compile", "label": "first_run", "compiles": 2,
                             "compile_ms": 1750.0, "kinds": {"build": 1, "load": 1}, "fns": {}}
    # Outside a window an event still counts in the totals.
    cuda_build._notify("load", 0.1)
    assert led.total_compiles == 3 and led.total_compile_ms == pytest.approx(1850.0)
    assert led.windows == [w]


def test_nested_window_is_an_inert_placeholder(led):
    with led.window("outer") as outer:
        with led.window("inner") as inner:
            cuda_build._notify("load", 0.5)
    assert inner.nested and inner.compiles == 0
    assert outer.compiles == 1 and led.windows == [outer]


def test_publish_once(led):
    reg = Registry()
    with led.window("a") as a:
        cuda_build._notify("build", 2.0)
    with led.window("b"):
        pass
    led.publish_window(reg, a, engine="dense")
    led.publish(reg, engine="dense")  # a is already published, b has nothing
    led.publish(reg, engine="dense")
    assert dict(reg.values) == {
        ("corro_kernel_compiles_total", (("engine", "dense"), ("fn", "(unwatched)"))): 1.0,
        ("corro_kernel_compile_ms", (("engine", "dense"),)): 2000.0,
    }
    assert a.published and led.compile_counts() == {}


def test_armed_ledger_raises_on_a_build_or_load(led):
    led.arm("timed run")
    assert led.armed
    with led.window("steady"), pytest.raises(ledger.RetraceError, match="steady"):
        cuda_build._notify("load", 0.01)
    with pytest.raises(ledger.RetraceError, match="build"):
        cuda_build._notify("build", 1.0)
    assert led.armed_compiles == 2
    led.disarm()
    cuda_build._notify("load", 0.01)
    assert led.armed_compiles == 2


def test_uninstalled_ledger_hears_nothing():
    led = ledger.CompileLedger()
    led.install()
    led.uninstall()
    cuda_build._notify("build", 1.0)
    assert led.total_compiles == 0
    # One listener for every ledger, registered once.
    assert cuda_build.LISTENERS.count(ledger._listener) == 1


def _loading_rowgather(monkeypatch, times=1):
    """The engine's first ``times`` row gathers announce a library load,
    as a first launch on the card does."""
    left = [times]
    real = onehot.rowgather

    def rowgather(table, idx):
        if left[0]:
            left[0] -= 1
            cuda_build._notify("load", 0.02)
        return real(table, idx)

    monkeypatch.setattr(onehot, "rowgather", rowgather)


def test_telemetry_chunk_window_goes_into_the_flight(led, monkeypatch, tmp_path):
    _loading_rowgather(monkeypatch)
    cfg, topo, sched = tb.churn_32(rounds=24, device="cpu")
    path = str(tmp_path / "f.jsonl")
    rec = telemetry.FlightRecorder(path, engine="dense", mode="w")
    reg = Registry()
    tele = telemetry.KernelTelemetry(engine="dense", recorder=rec, registry=reg, ledger=led)
    tengine.simulate(cfg, topo, sched, seed=0, max_chunk=8, telemetry=tele, device="cpu")
    rec.close()
    assert [w.label for w in led.windows] == ["dense@r0", "dense@r8", "dense@r16"]
    assert [w.compiles for w in led.windows] == [1, 0, 0]
    events = [json.loads(line) for line in open(path) if '"compile"' in line]
    assert [(e["label"], e["compiles"], e["kinds"]) for e in events] == \
        [("dense@r0", 1, {"load": 1})]
    assert reg.values[("corro_kernel_compiles_total",
                       (("engine", "dense"), ("fn", "(unwatched)")))] == 1.0


def test_armed_telemetry_run_fails_loudly(led, monkeypatch):
    _loading_rowgather(monkeypatch)
    cfg, topo, sched = tb.churn_32(rounds=8, device="cpu")
    led.arm("steady state")
    tele = telemetry.KernelTelemetry(engine="dense", ledger=led)
    with pytest.raises(ledger.RetraceError, match="dense@r0"):
        tengine.simulate(cfg, topo, sched, seed=0, telemetry=tele, device="cpu")

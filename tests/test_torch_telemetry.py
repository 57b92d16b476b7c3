"""The telemetry plane (``sim/telemetry.py``) and ``telemetry=`` on the four
engines, against the live JAX reference on the CPU: each engine's flight
record equals the reference's line for line (only the ``t_unix`` stamps
and the chunk ``wall_s`` differ), and a run with telemetry equals the
same run without it in curves, state and ``vis``. Also the recorder's
rotation and crash-resume, replay over garbage, the progress lines, the
metrics bridge into the reference's own ``MetricsRegistry``, and the
zero-round chunk run.
"""

import io
import json
import re

import numpy as np
import pytest
import torch

from corrosion_tpu.models import baselines as jb
from corrosion_tpu.sim import chunk_engine as jc
from corrosion_tpu.sim import engine as je
from corrosion_tpu.sim import health as jh
from corrosion_tpu.sim import mixed_engine as jm
from corrosion_tpu.sim import sparse_engine as js
from corrosion_tpu.sim import telemetry as jt
from corrosion_tpu.utils.metrics import MetricsRegistry
from corrosion_tpu_torch import interop
from corrosion_tpu_torch.models import baselines as tb
from corrosion_tpu_torch.sim import chunk_engine as tc
from corrosion_tpu_torch.sim import engine as te
from corrosion_tpu_torch.sim import health as th
from corrosion_tpu_torch.sim import mixed_engine as tm
from corrosion_tpu_torch.sim import sparse_engine as ts
from corrosion_tpu_torch.sim import telemetry as tt

torch.set_num_threads(1)

DEMO = dict(nodes=32, rounds=24, samples=16, churn=True)
SPARSE = dict(n=48, w_hot=16, rounds=24, n_regions=4, epoch_rounds=8, cohort=5,
              burst_writes=1, samples=8, seed=0, k_dev=16)
CHUNKS = dict(n=16, streams=2, last_seq=511, rounds=20)
MIXED = dict(n=64, streams=2, last_seq=255, rounds=12, samples=8)


def _lines(path):
    """Every record of a flight file (rotated segments first), without the
    wall-clock fields."""
    out = []
    for seg in tt.flight_segments(str(path)):
        with open(seg) as f:
            for line in f:
                rec = json.loads(line)
                rec.pop("t_unix", None)
                rec.pop("wall_s", None)
                out.append(rec)
    return out


def _flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _same_tree(a, b):
    if isinstance(a, tuple) and not hasattr(a, "_fields"):
        for x, y in zip(a, b, strict=True):
            _same_tree(x, y)
        return
    if torch.is_tensor(a):
        assert torch.equal(a, b)
        return
    fa, fb = _flat(interop.to_numpy(a)), _flat(interop.to_numpy(b))
    assert fa.keys() == fb.keys()
    bad = [k for k in fa if not np.array_equal(fa[k], fb[k])]
    assert not bad, bad


def _same_curves(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, bad


def _tele(path, engine, **kw):
    return tt.KernelTelemetry(engine=engine, recorder=tt.FlightRecorder(str(path), engine=engine,
                                                                        mode="w"), **kw)


def _jtele(path, engine, **kw):
    return jt.KernelTelemetry(engine=engine, recorder=jt.FlightRecorder(str(path), engine=engine,
                                                                        mode="w"), **kw)


def _close(*teles):
    for t in teles:
        t.recorder.close()


@pytest.mark.parametrize("max_chunk", [8, None], ids=["chunked", "unchunked"])
def test_dense_flight_equals_the_reference(tmp_path, max_chunk):
    jcfg, jtopo, jsched, _ = jh.churned_demo_cluster(**DEMO)
    cfg, topo, sched, _ = th.churned_demo_cluster(**DEMO, device="cpu")
    jtel, ttel = _jtele(tmp_path / "j.jsonl", "dense"), _tele(tmp_path / "t.jsonl", "dense")
    _, cj = je.simulate(jcfg, jtopo, jsched, seed=0, max_chunk=max_chunk, telemetry=jtel)
    final, ct = te.simulate(cfg, topo, sched, seed=0, max_chunk=max_chunk, telemetry=ttel,
                            device="cpu")
    _close(jtel, ttel)
    assert _lines(tmp_path / "t.jsonl") == _lines(tmp_path / "j.jsonl")
    assert len(ttel.chunk_walls) == (3 if max_chunk else 1)
    assert ttel.device_step_ms > 0
    _same_curves(ct, {k: np.asarray(v) for k, v in cj.items()})
    plain, cp = te.simulate(cfg, topo, sched, seed=0, max_chunk=max_chunk, device="cpu")
    _same_curves(ct, cp)
    _same_tree(final, plain)
    replayed, chunks = tt.replay_flight(str(tmp_path / "t.jsonl"))
    assert [c["start"] for c in chunks] == ([0, 8, 16] if max_chunk else [0])
    for k in tt.ROUND_CURVE_KEYS:
        assert np.array_equal(replayed[k], ct[k]), k


def test_sparse_flight_per_epoch_and_resume_equal_the_reference(tmp_path):
    jargs, targs = jb.anywrite_sparse(**SPARSE), tb.anywrite_sparse(**SPARSE, device="cpu")
    jtel, ttel = _jtele(tmp_path / "j.jsonl", "sparse"), _tele(tmp_path / "t.jsonl", "sparse")
    js.simulate_sparse(*jargs, seed=0, telemetry=jtel)
    sst, sw, vis, ct, _ = ts.simulate_sparse(*targs, seed=0, telemetry=ttel, device="cpu")
    _close(jtel, ttel)
    lines = _lines(tmp_path / "t.jsonl")
    assert lines == _lines(tmp_path / "j.jsonl")
    assert [r["start"] for r in lines if r["kind"] == "chunk"] == [0, 8, 16]
    # The same run split at epoch 0 and resumed, appending to one record.
    first = _tele(tmp_path / "r.jsonl", "sparse")
    *_, info = ts.simulate_sparse(*targs, seed=0, stop_after_epoch=0, telemetry=first,
                                  device="cpu")
    first.recorder.close()
    rest = tt.KernelTelemetry(engine="sparse", recorder=tt.FlightRecorder(
        str(tmp_path / "r.jsonl"), engine="sparse", mode="a"))
    sst2, sw2, vis2, ct2, _ = ts.simulate_sparse(*targs, seed=0, resume=info["resume"],
                                                 telemetry=rest, device="cpu")
    rest.recorder.close()
    rounds = [r for r in _lines(tmp_path / "r.jsonl") if r["kind"] == "round"]
    assert rounds == [r for r in lines if r["kind"] == "round"]
    _same_curves({k: v[8:] for k, v in ct.items()}, ct2)
    _same_tree((sst, sw, vis), (sst2, sw2, vis2))
    *_, cp, _ = ts.simulate_sparse(*targs, seed=0, device="cpu")
    _same_curves(ct, cp)


def test_chunk_engine_flight_equals_the_reference(tmp_path):
    ccfg, origin, last, rounds = jb.anti_entropy_chunks(**CHUNKS)
    tcfg, torigin, tlast, _ = tb.anti_entropy_chunks(**CHUNKS, device="cpu")
    jtel, ttel = _jtele(tmp_path / "j.jsonl", "chunk"), _tele(tmp_path / "t.jsonl", "chunk")
    jc.simulate_chunks(ccfg, origin, last, rounds, seed=0, max_chunk=7, telemetry=jtel)
    st, m = tc.simulate_chunks(tcfg, torigin, tlast, rounds, seed=0, max_chunk=7,
                               telemetry=ttel, device="cpu")
    _close(jtel, ttel)
    assert _lines(tmp_path / "t.jsonl") == _lines(tmp_path / "j.jsonl")
    st2, m2 = tc.simulate_chunks(tcfg, torigin, tlast, rounds, seed=0, device="cpu")
    _same_curves(m["curves"], m2["curves"])
    _same_tree(st, st2)
    assert torch.equal(m["vis"], m2["vis"])


def test_mixed_flight_and_resume_equal_the_reference(tmp_path):
    jargs, targs = jb.mixed_storm(**MIXED), tb.mixed_storm(**MIXED, device="cpu")
    jtel, ttel = _jtele(tmp_path / "j.jsonl", "mixed"), _tele(tmp_path / "t.jsonl", "mixed")
    jm.simulate_mixed(*jargs, seed=0, max_chunk=5, telemetry=jtel)
    final, ct = tm.simulate_mixed(*targs, seed=0, max_chunk=5, telemetry=ttel, device="cpu")
    _close(jtel, ttel)
    lines = _lines(tmp_path / "t.jsonl")
    assert lines == _lines(tmp_path / "j.jsonl")
    assert [r["start"] for r in lines if r["kind"] == "chunk"] == [0, 5, 10]
    cfg, ccfg, topo, sched, spec = targs
    part = tt.KernelTelemetry(engine="mixed")
    mid, _ = tm.simulate_mixed(cfg, ccfg, topo, sched.slice(0, 6), spec, seed=0,
                               telemetry=part, device="cpu")
    end, ct2 = tm.simulate_mixed(cfg, ccfg, topo, sched.slice(6, 12), spec, seed=0,
                                 state=mid, telemetry=part, device="cpu")
    assert [n for n, _ in part.chunk_walls] == [6, 6]
    _same_tree(final, end)
    _same_curves({k: v[6:] for k, v in ct.items()}, ct2)
    _, cp = tm.simulate_mixed(*targs, seed=0, max_chunk=5, device="cpu")
    _same_curves(ct, cp)


def _fake_chunks():
    g = np.random.default_rng(3)
    curves = {k: g.integers(0, 1000, 6).astype(tt.CURVE_DTYPES[k]) for k in tt.ROUND_CURVE_KEYS}
    curves["need"] = (g.random(6) * 100).astype(np.float32)
    return [(6 * i, curves) for i in range(5)]


def test_rotation_and_crash_resume_equal_the_reference(tmp_path):
    for mod, name in ((jt, "j"), (tt, "t")):
        path = str(tmp_path / f"{name}.jsonl")
        rec = mod.FlightRecorder(path, engine="dense", mode="w", max_bytes=4000)
        for start, curves in _fake_chunks()[:3]:
            rec.record_chunk(start, curves, wall_s=0.5)
        rec.close()
        with open(path, "a") as f:
            f.write('{"kind": "round", "round": 99, "ne')  # a crash mid-line
        rec = mod.FlightRecorder(path, engine="dense", mode="a", max_bytes=4000)
        for start, curves in _fake_chunks()[3:]:
            rec.record_chunk(start, curves, wall_s=0.5)
        rec.close()
    segs_t = tt.flight_segments(str(tmp_path / "t.jsonl"))
    segs_j = jt.flight_segments(str(tmp_path / "j.jsonl"))
    assert [s[-8:].replace("t.", "") for s in segs_t] == [s[-8:].replace("j.", "") for s in segs_j]
    assert len(segs_t) == 6, segs_t
    def parsed(path):
        out = []
        for line in open(path):
            try:
                out.append(json.loads(line))
            except ValueError:  # the torn line, with the header appended to it
                out.append("torn")
        return [{k: v for k, v in r.items() if k != "t_unix"} if r != "torn" else r for r in out]

    for a, b in zip(segs_t, segs_j):
        assert parsed(a) == parsed(b)
    headers = [[r["segment"] for r in parsed(s) if r != "torn" and r["kind"] == "flight"]
               for s in segs_t]
    assert headers == [[0], [1], [2], [3], [4], [5]], headers
    ct, chunks_t = tt.replay_flight(str(tmp_path / "t.jsonl"))
    cj, chunks_j = jt.replay_flight(str(tmp_path / "j.jsonl"))
    assert chunks_t == chunks_j and len(chunks_t) == 5
    _same_curves(ct, cj)
    assert list(ct["round"]) == list(range(30))
    # A fresh mode="w" recorder drops the old segments.
    tt.FlightRecorder(str(tmp_path / "t.jsonl"), mode="w").close()
    assert tt.flight_segments(str(tmp_path / "t.jsonl")) == [str(tmp_path / "t.jsonl")]


def test_replay_skips_garbage_and_record_event_refuses_reserved_kinds(tmp_path):
    path = str(tmp_path / "f.jsonl")
    rec = tt.FlightRecorder(path, mode="w")
    start, curves = _fake_chunks()[0]
    rec.record_chunk(start, curves)
    rec.record_event({"kind": "note", "text": "between chunks"})
    for kind in ("round", "chunk", "flight"):
        with pytest.raises(ValueError, match="reserved kind"):
            rec.record_event({"kind": kind})
    rec.close()
    with pytest.raises(ValueError, match="closed"):
        rec.record_chunk(0, curves)
    text = open(path).read()
    with open(path, "w") as f:
        f.write("not json\n\n" + text + "[1, 2\n" + '{"kind": "round", "round": 3, "msgs"')
    for mod in (tt, jt):
        got, chunks = mod.replay_flight(path)
        assert list(got["round"]) == list(range(6)) and len(chunks) == 1
        assert np.array_equal(got["need"], curves["need"].astype(np.float64))


def test_progress_lines_equal_the_reference(tmp_path):
    out = {}
    for mod, name in ((jt, "j"), (tt, "t")):
        buf = io.StringIO()
        tel = mod.KernelTelemetry(engine="mixed", progress=buf)
        for start, curves in _fake_chunks():
            tel.on_chunk(start, curves, wall_s=1.25)
        tel.on_chunk(30, {}, wall_s=0.0)
        out[name] = buf.getvalue()
        assert tel.device_step_ms == pytest.approx(5 * 1.25 / 30 * 1000)
    assert out["t"] == out["j"]
    assert re.match(r"\[flight:mixed\] rounds 0\.\.5 wall=1\.25s msgs=\d+ \{\"need\": \d+", out["t"])


class _Span:
    def __init__(self, log, name, attrs):
        self.log, self.attrs = log, dict(attrs, name=name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.log.append(self.attrs)
        return False

    def set_attr(self, k, v):
        self.attrs[k] = v


class _Tracer:
    def __init__(self):
        self.spans = []

    def span(self, name, **attrs):
        return _Span(self.spans, name, attrs)


class _Series:
    def __init__(self):
        self.samples = []

    def sample(self, registry, t, exclude=()):
        self.samples.append((t, registry.snapshot() if hasattr(registry, "snapshot") else None))


def _rendered(reg):
    return sorted(line for line in reg.render().splitlines() if "chunk_seconds" not in line)


def test_publish_curves_and_sinks_equal_the_reference():
    jcfg, jtopo, jsched, _ = jh.churned_demo_cluster(**DEMO, geo=True)
    cfg, topo, sched, _ = th.churned_demo_cluster(**DEMO, geo=True, device="cpu")
    regs, tracers, series = {}, {}, {}
    for mod, name, run in (
        (jt, "j", lambda tel: je.simulate(jcfg, jtopo, jsched, seed=0, max_chunk=10, telemetry=tel)),
        (tt, "t", lambda tel: te.simulate(cfg, topo, sched, seed=0, max_chunk=10, telemetry=tel,
                                          device="cpu")),
    ):
        regs[name], tracers[name], series[name] = MetricsRegistry(), _Tracer(), _Series()
        run(mod.KernelTelemetry(engine="dense", registry=regs[name], tracer=tracers[name],
                                series=series[name]))
    assert _rendered(regs["t"]) == _rendered(regs["j"])
    assert "corro_kernel_prop_link_cross_region_total" in regs["t"].render()
    strip = [{k: v for k, v in s.items() if k != "wall_s"} for s in tracers["t"].spans]
    assert strip == [{k: v for k, v in s.items() if k != "wall_s"} for s in tracers["j"].spans]
    assert [s["start_round"] for s in strip] == [0, 10, 20]
    assert [t for t, _ in series["t"].samples] == [t for t, _ in series["j"].samples] == [10, 20, 24]
    # Registries fed the same curves directly agree too (the level gauges).
    g = np.random.default_rng(0)
    curves = {k: g.integers(0, 50, 9).astype(tt.CURVE_DTYPES[k]) for k in tt.ROUND_CURVE_KEYS}
    a, b = MetricsRegistry(), MetricsRegistry()
    tt.publish_curves(a, curves, engine="sparse")
    jt.publish_curves(b, curves, engine="sparse")
    assert a.render() == b.render()


def test_zero_round_chunk_run_publishes_empty_curves(tmp_path):
    tcfg, torigin, tlast, _ = tb.anti_entropy_chunks(**CHUNKS, device="cpu")
    ccfg, origin, last, _ = jb.anti_entropy_chunks(**CHUNKS)
    regs = {"t": MetricsRegistry(), "j": MetricsRegistry()}
    ttel = tt.KernelTelemetry(engine="chunk", registry=regs["t"],
                              recorder=tt.FlightRecorder(str(tmp_path / "t.jsonl"), mode="w"))
    jtel = jt.KernelTelemetry(engine="chunk", registry=regs["j"],
                              recorder=jt.FlightRecorder(str(tmp_path / "j.jsonl"), mode="w"))
    st, m = tc.simulate_chunks(tcfg, torigin, tlast, 0, seed=0, telemetry=ttel, device="cpu")
    jc.simulate_chunks(ccfg, origin, last, 0, seed=0, telemetry=jtel)
    _close(ttel, jtel)
    assert all(len(v) == 0 for v in m["curves"].values())
    assert ttel.chunk_walls == [] and np.isnan(ttel.device_step_ms)
    assert _rendered(regs["t"]) == _rendered(regs["j"])
    assert "corro_kernel_rounds_total{engine=\"chunk\"} 0" in regs["t"].render()
    assert _lines(tmp_path / "t.jsonl") == _lines(tmp_path / "j.jsonl")
    curves, chunks = tt.replay_flight(str(tmp_path / "t.jsonl"))
    assert chunks == [] and list(curves) == ["round"]


def test_flight_path_from_argv():
    for mod in (tt, jt):
        assert mod.flight_path_from_argv(["48", "--flight"]) == "flight.jsonl"
        assert mod.flight_path_from_argv(["--flight=x.jsonl", "48"]) == "x.jsonl"
        assert mod.flight_path_from_argv(["--flight="], default="d") == "d"
        assert mod.flight_path_from_argv(["--flightx", "48"]) is None
    assert tt.series_name("need") == "corro_kernel_need"
    assert tt.series_name("staleness_max") == "corro_kernel_health_staleness_max"
    assert tt.LEVEL_CURVE_KEYS == jt.LEVEL_CURVE_KEYS
    assert np.array_equal(tt.curve_array({"msgs": [1, 2]}, "need"), np.zeros(2))


@pytest.mark.parametrize("with_telemetry", [False, True], ids=["plain", "telemetry"])
def test_engines_free_each_round_s_input(monkeypatch, with_telemetry):
    """A chunk's start state is freed once the next rounds are made, with
    telemetry or without: a full-size run holds one state, not two."""
    import gc
    import weakref

    seen = []

    def spy(module, name, first_round, state_of):
        orig = getattr(module, name)
        refs = {}

        def wrapped(*a, **kw):
            r = first_round(*a)
            if r % 8 == 0:
                refs["start"] = weakref.ref(state_of(*a))
            elif r % 8 == 3:
                gc.collect()
                seen.append((name, refs["start"]() is None))
            return orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)

    spy(ts, "_sparse_round", lambda *a: a[8], lambda *a: a[0].data.contig)
    spy(te, "cluster_round", lambda *a: int(a[0].round), lambda *a: a[0].data.contig)
    spy(tm, "_mixed_round", lambda *a: int(a[0].round), lambda *a: a[0].data.contig)
    spy(tc, "_round", lambda *a: a[4], lambda *a: a[0].have.starts)

    def tel():
        return tt.KernelTelemetry() if with_telemetry else None

    ts.simulate_sparse(*tb.anywrite_sparse(**SPARSE, device="cpu"), seed=0, telemetry=tel(),
                       device="cpu")
    cfg, topo, sched, _ = th.churned_demo_cluster(**DEMO, device="cpu")
    te.simulate(cfg, topo, sched, seed=0, max_chunk=8, telemetry=tel(), device="cpu")
    tm.simulate_mixed(*tb.mixed_storm(**MIXED, device="cpu"), seed=0, max_chunk=8,
                      telemetry=tel(), device="cpu")
    tcfg, torigin, tlast, rounds = tb.anti_entropy_chunks(**CHUNKS, device="cpu")
    tc.simulate_chunks(tcfg, torigin, tlast, rounds, seed=0, max_chunk=8, telemetry=tel(),
                       device="cpu")
    assert {name for name, _ in seen} == {"_sparse_round", "cluster_round", "_mixed_round",
                                          "_round"}
    assert all(freed for _, freed in seen), seen

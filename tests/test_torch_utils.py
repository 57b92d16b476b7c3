"""The port's ``utils/`` against the reference's, on the same calls:

- ``MetricsRegistry``: ``render()``, ``snapshot()`` and
  ``series_snapshot()`` equal on seeded random call sequences (labels,
  the label-set cap's overflow fold, histograms and their quantiles), the
  process gauges, ``StepTimer`` under one clock, and ``serve_prometheus``
  answering a local scrape with the registry's render;
- ``Tracer``: the JSONL export, ``recent()``, ``spans_to_otlp``,
  ``trace_sampled`` and ``parse_traceparent`` equal under a fixed clock
  and fixed ids; the OTLP worker is only started and closed (nothing is
  posted: no span reaches it);
- ``Backoff`` sequences under one seed, ``TaskRegistry``, ``Tripwire``
  (its signal handlers restored), ``LockRegistry`` and the log formats.

Every asyncio test runs under its own time limit.
"""

import asyncio
import json
import logging
import random
import signal
import sys
import threading
import types

import pytest

from corrosion_tpu.utils import backoff as jbackoff
from corrosion_tpu.utils import locks as jlocks
from corrosion_tpu.utils import logfmt as jlogfmt
from corrosion_tpu.utils import metrics as jmetrics
from corrosion_tpu.utils import spawn as jspawn
from corrosion_tpu.utils import tracing as jtracing
from corrosion_tpu.utils import tripwire as jtripwire
from corrosion_tpu_torch import utils as tutils
from corrosion_tpu_torch.utils import backoff as tbackoff
from corrosion_tpu_torch.utils import locks as tlocks
from corrosion_tpu_torch.utils import logfmt as tlogfmt
from corrosion_tpu_torch.utils import metrics as tmetrics
from corrosion_tpu_torch.utils import spawn as tspawn
from corrosion_tpu_torch.utils import tracing as ttracing
from corrosion_tpu_torch.utils import tripwire as ttripwire

TIME_LIMIT_S = 20.0


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIME_LIMIT_S))


def _drive_registry(mod, seed: int, max_labelsets):
    """A seeded random sequence of registry calls on ``mod``'s registry."""
    rng = random.Random(seed)
    reg = mod.MetricsRegistry(max_labelsets=max_labelsets)
    for _ in range(400):
        name = f"corro_{rng.choice(['a', 'b', 'c'])}"
        labels = {"peer": str(rng.randrange(12))} if rng.randrange(2) else {}
        op = rng.randrange(5)
        if op == 0:
            reg.counter(name + "_total", "help of a counter").inc(rng.choice([1.0, 2.5, 0.0]), **labels)
        elif op == 1:
            reg.gauge(name + "_level", "a gauge").set(rng.uniform(-5, 5), **labels)
        elif op == 2:
            reg.gauge(name + "_level", "a gauge").add(rng.randrange(4), **labels)
        elif op == 3:
            reg.histogram(name + "_seconds", "a histogram").observe(rng.expovariate(20.0), **labels)
        else:
            reg.histogram(name + "_bytes", "sized", buckets=(1, 10, 100, 1000)).observe(
                rng.randrange(2000), **labels)
    return reg


@pytest.mark.parametrize("seed,cap", [(0, None), (1, 64), (2, 4), (3, 1)])
def test_registry_render_and_snapshots_equal_the_reference(seed, cap):
    j, t = _drive_registry(jmetrics, seed, cap), _drive_registry(tmetrics, seed, cap)
    assert t.render() == j.render()
    assert t.snapshot() == j.snapshot()
    assert t.series_snapshot() == j.series_snapshot()
    for name in ("corro_a_seconds", "corro_b_seconds", "corro_c_bytes"):
        for q in (0.5, 0.9, 0.99):
            jh, th = j.histogram(name), t.histogram(name)
            assert th.quantile(q) == jh.quantile(q)
            assert th.count() == jh.count()


def test_process_gauges_and_step_timer(monkeypatch):
    regs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        gauges = mod.register_process_gauges(reg)
        assert mod.register_process_gauges(reg) == gauges  # idempotent
        ticks = iter([10.0, 10.25, 20.0, 20.5])
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))
        h = reg.histogram("corro_step_seconds")
        for _ in range(2):
            with mod.StepTimer(h, plane="broadcast"):
                pass
        regs.append(reg)
    assert regs[1].render() == regs[0].render()
    assert set(tmetrics.process_stats()) == set(jmetrics.process_stats()) == {"rss_bytes", "open_fds"}
    assert tmetrics.process_rss_bytes() > 0 and tmetrics.process_open_fds() > 0


async def _scrape(mod, reg, path: bytes) -> bytes:
    server, (host, port) = await mod.serve_prometheus(reg, "127.0.0.1", 0)
    try:
        reader, writer = await asyncio.open_connection(host, port)
        writer.write(b"GET " + path + b" HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        data = await reader.read()
        writer.close()
        return data
    finally:
        server.close()
        await server.wait_closed()


def test_serve_prometheus_answers_as_the_reference():
    j, t = _drive_registry(jmetrics, 5, None), _drive_registry(tmetrics, 5, None)
    for path in (b"/metrics", b"/metrics?x=1", b"/nope"):
        got, want = _run(_scrape(tmetrics, t, path)), _run(_scrape(jmetrics, j, path))
        assert got == want
    assert _run(_scrape(tmetrics, t, b"/metrics")).endswith(t.render().encode())


class _FixedIds:
    """Deterministic ``os.urandom`` and a clock that steps 1.5 us a read."""

    def __init__(self):
        self.n, self.ns = 0, 1_700_000_000_000_000_000

    def urandom(self, k: int) -> bytes:
        self.n += 1
        return (self.n.to_bytes(4, "big") * 8)[:k]

    def time_ns(self) -> int:
        self.ns += 1500
        return self.ns


def _trace(mod, path: str, monkeypatch) -> list:
    fixed = _FixedIds()
    monkeypatch.setattr(mod, "os", types.SimpleNamespace(urandom=fixed.urandom))
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time_ns=fixed.time_ns))
    tr = mod.Tracer(service="svc", capacity=4, export_path=path, sample=0.5)
    with tr.span("root", k=1) as root:
        with tr.span("child", n=2) as child:
            child.set_attr("rounds", 12)
            assert tr.current_traceparent() == child.traceparent
        s = tr.maybe_span("sampled")
        if s is not None:
            with s:
                pass
    with tr.span("remote", traceparent=root.traceparent):
        pass
    with tr.span("bad-parent", traceparent="00-zz-11-01"):
        pass
    try:
        with tr.span("fails"):
            raise KeyError("x")
    except KeyError:
        pass
    for i in range(3):
        tr.span(f"batched{i}").start().finish()
    recent = tr.recent(limit=10), tr.recent(name="child")
    tr.close()
    return recent


def test_tracer_jsonl_equal_under_a_fixed_clock(tmp_path, monkeypatch):
    got = _trace(ttracing, str(tmp_path / "port.jsonl"), monkeypatch)
    want = _trace(jtracing, str(tmp_path / "ref.jsonl"), monkeypatch)
    assert got == want
    port_lines = (tmp_path / "port.jsonl").read_text()
    assert port_lines == (tmp_path / "ref.jsonl").read_text()
    assert len(port_lines.splitlines()) == 9
    spans = [json.loads(x) for x in port_lines.splitlines()]
    assert ttracing.spans_to_otlp("svc", spans) == jtracing.spans_to_otlp("svc", spans)


def test_trace_ids_sampling_and_traceparent_parsing():
    rng = random.Random(1)
    for _ in range(500):
        tid = "%032x" % rng.getrandbits(128)
        rate = rng.choice([0.0, 0.1, 0.5, 0.99, 1.0])
        assert ttracing.trace_sampled(tid, rate) == jtracing.trace_sampled(tid, rate)
    for value in ("00-" + "a" * 32 + "-" + "b" * 16 + "-01", "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
                  "00-xyz-11-01", "garbage", "00-" + "g" * 32 + "-" + "b" * 16 + "-01"):
        assert ttracing.parse_traceparent(value) == jtracing.parse_traceparent(value)


def test_otlp_worker_starts_and_closes_without_posting():
    """The endpoint is never contacted: no span is recorded before close."""
    tr = ttracing.Tracer(otlp_endpoint="http://127.0.0.1:9")
    thread = tr._otlp_thread
    assert thread is not None and thread.is_alive()
    tr.close()
    thread.join(timeout=TIME_LIMIT_S)
    assert not thread.is_alive() and tr.otlp_export_errors == 0


def test_backoff_sequences_equal_under_one_seed():
    for kw in (dict(jitter=False, max_retries=8, min_wait=1, max_wait=8),
               dict(jitter=True, max_retries=50, seed=7, min_wait=0.5, max_wait=30, factor=1.7)):
        j, t = jbackoff.Backoff(**kw), tbackoff.Backoff(**kw)
        assert list(t) == list(j)
        j.reset(), t.reset()
        assert [next(t) for _ in range(3)] == [next(j) for _ in range(3)]
    assert tutils.Backoff is tbackoff.Backoff and tutils.__all__ == ["Backoff", "TaskRegistry", "Tripwire"]


async def _tasks(mod) -> list:
    reg = mod.TaskRegistry()
    gate = asyncio.Event()

    async def wait():
        await gate.wait()

    async def fail():
        raise RuntimeError("boom")

    seen = []
    for i in range(3):
        reg.spawn(wait(), name=f"w{i}")
    reg.spawn(fail(), name="f")
    await asyncio.sleep(0)
    seen.append(reg.pending)
    gate.set()
    seen.append(await reg.wait_for_all_pending_handles(cap=5.0))
    seen.append(reg.pending)
    reg.spawn(asyncio.sleep(30), name="long")
    await reg.cancel_all()
    seen.append(reg.pending)
    return seen


def test_task_registry_follows_the_reference(caplog):
    with caplog.at_level(logging.ERROR):
        assert _run(_tasks(tspawn)) == _run(_tasks(jspawn)) == [4, True, 0, 0]
    assert sum("task f failed" in r.getMessage() for r in caplog.records) == 2


async def _tripwire(mod) -> list:
    tw = mod.Tripwire.new_signals()
    installed = [signal.getsignal(s) not in (signal.SIG_DFL, signal.default_int_handler)
                 for s in (signal.SIGINT, signal.SIGTERM)]
    before = tw.tripped
    waiter = asyncio.ensure_future(tw.wait()) if hasattr(tw, "wait") else None
    tw.trip()
    if waiter is not None:
        await waiter
    return [installed, before, tw.tripped]


def test_tripwire_follows_the_reference_and_restores_handlers():
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        assert _run(_tripwire(ttripwire)) == _run(_tripwire(jtripwire))
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert {s: signal.getsignal(s) for s in saved} == saved


def test_lock_registry_follows_the_reference():
    out = []
    for mod in (jlocks, tlocks):
        reg = mod.LockRegistry()
        lock = threading.Lock()
        with reg.acquire(lock, "bookie", kind="read"):
            snap = reg.snapshot()
        out.append(([{k: v for k, v in s.items() if k != "age_ms"} for s in snap], reg.snapshot()))
    assert out[0] == out[1] and out[0][0][0]["state"] == tlocks.LOCKED


def test_log_formats_equal_the_reference():
    rec = logging.LogRecord("corro.agent", logging.WARNING, __file__, 1, "hello %s", ("x",), None)
    rec.created, rec.msecs = 1_700_000_000.25, 250.0
    assert tlogfmt.JsonFormatter().format(rec) == jlogfmt.JsonFormatter().format(rec)
    for colors in (False, True):
        assert tlogfmt.PlainFormatter(colors).format(rec) == jlogfmt.PlainFormatter(colors).format(rec)
    try:
        raise ValueError("v")
    except ValueError:
        rec.exc_info = sys.exc_info()
    assert tlogfmt.JsonFormatter().format(rec) == jlogfmt.JsonFormatter().format(rec)

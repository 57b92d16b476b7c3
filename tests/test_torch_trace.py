"""Trace replay (``sim/trace.py``) against the live JAX reference on the
CPU: ``schedule_from_trace`` buckets the same events into the same
schedule (writes and samples), its degenerate inputs behave the same,
the recorder hooks chain and unwind as the reference's do, and
``replay`` runs a recorded workload on the port's engine to the
reference's curves and latencies.
"""

import numpy as np
import pytest
import torch

from corrosion_tpu.core import hlc
from corrosion_tpu.sim import trace as jt
from corrosion_tpu_torch.sim import trace as tt

torch.set_num_threads(1)


def _both(events, **kw):
    out = []
    for mod in (jt, tt):
        actors, sched = mod.schedule_from_trace(mod.Trace(events=list(events)), **kw)
        out.append((actors, sched))
    (ja, js), (ta, ts) = out
    assert ta == ja
    for f in ("writes", "sample_writer", "sample_ver", "sample_round"):
        a, b = getattr(js, f), getattr(ts, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return ta, ts


def _random_events(seed, actors=5, writes=120, span_ms=20_000):
    g = np.random.default_rng(seed)
    names = [f"{g.integers(0, 2**32):08x}" for _ in range(actors)]
    base = {a: int(g.integers(1, 40)) for a in names}
    events = []
    for a in names:
        ts = np.sort(g.integers(0, span_ms, writes // actors))
        events += [(int(t), a, base[a] + i) for i, t in enumerate(ts)]
    return events


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("round_ms,drain,samples", [(500.0, 40, 256), (137.5, 3, 16), (0.9, 0, 8)])
def test_schedule_from_trace_equals_the_reference(seed, round_ms, drain, samples):
    actors, sched = _both(_random_events(seed), round_ms=round_ms, drain_rounds=drain,
                          samples=samples)
    assert sched.writes.sum() == 120 and len(actors) == 5


def test_degenerate_traces_equal_the_reference():
    _, sched = _both([(5000, "aa", 1), (5000, "bb", 1), (5001, "aa", 2)], drain_rounds=3)
    assert sched.writes.shape == (4, 2)
    _both([(0, "aa", 1), (1, "aa", 2), (999, "aa", 3)], round_ms=0.333, drain_rounds=2)
    _both([(0, "aa", 13), (10, "aa", 14), (700, "aa", 15)], round_ms=500, drain_rounds=1)
    for events, kw, match in (
        ([], {}, "empty trace"),
        ([(0, "aa", 1)], {"round_ms": 0.0}, "round_ms must be positive"),
        ([(0, "aa", 1)], {"round_ms": float("nan")}, "round_ms must be positive"),
        ([(0, "aa", 1)], {"drain_rounds": -1}, "drain_rounds must be >= 0"),
        ([(0, "aa", 1), (10, "aa", 3)], {}, "trace gap"),
    ):
        msgs = []
        for mod in (jt, tt):
            with pytest.raises(ValueError, match=match) as e:
                mod.schedule_from_trace(mod.Trace(events=list(events)), **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class _Agent:
    on_local_write = None


def test_recorders_chain_and_save_like_the_reference(tmp_path):
    assert tt.LOGICAL_BITS == hlc.LOGICAL_BITS
    for ms, lg in ((0, 0), (1_700_000_000_123, 5), (2**40, 2**20 - 1)):
        assert tt.ts_physical_ms(hlc.make_ts(ms, lg)) == ms
    agent = _Agent()
    t1, t2 = tt.Trace(), tt.Trace()
    t1.record(agent)
    t2.record(agent)
    agent.on_local_write("aa", 1, hlc.make_ts(1000, 3))
    agent.on_local_write("bb", 1, hlc.make_ts(1200, 0))
    assert t1.events == t2.events == [(1000, "aa", 1), (1200, "bb", 1)]
    assert not t1.unrecord(agent)  # t2 sits on top
    assert t2.unrecord(agent) and t1.unrecord(agent) and agent.on_local_write is None
    merged = t1.merge(tt.Trace(events=[(900, "cc", 1)]))
    assert merged.actors == ["aa", "bb", "cc"] and merged.events[0] == (900, "cc", 1)
    merged.save(str(tmp_path / "t.jsonl"))
    assert tt.Trace.load(str(tmp_path / "t.jsonl")).events == \
           jt.Trace.load(str(tmp_path / "t.jsonl")).events == merged.events


def test_replay_equals_the_reference():
    events = _random_events(7, actors=3, writes=30, span_ms=4000)
    ja, jfinal, jcurves, jlat = jt.replay(jt.Trace(events=events), observers=5, drain_rounds=12)
    ta, tfinal, tcurves, tlat = tt.replay(tt.Trace(events=events), observers=5, drain_rounds=12,
                                          device="cpu")
    assert ta == ja and tlat == jlat
    for k in jcurves:
        assert np.array_equal(np.asarray(jcurves[k]), tcurves[k]), k
    assert np.array_equal(np.asarray(jfinal.data.contig), tfinal.data.contig.numpy())

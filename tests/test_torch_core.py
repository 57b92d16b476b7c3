"""The port's ``core/`` (``values``, ``ids``, ``hlc``, ``intervals``,
``bookkeeping``, ``changes``) against the reference's:

- the reference's own cases (``tests/test_core_basics.py``,
  ``tests/test_bookkeeping.py``) run against the port's modules, once with
  the native codec and once with the Python one: ``run_against`` swaps
  the reference modules for the port's in the test module's globals and
  in ``sys.modules`` (for imports inside a test) while it runs;
- the copy against the live reference on seeded random operation
  sequences: equal states after every operation, equal bytes from the
  codec on both paths, equal HLC timestamps under one injected clock.
"""

import inspect
import random
import sys
import types

import numpy as np
import pytest

import test_bookkeeping as ref_bookkeeping_tests
import test_core_basics as ref_core_tests
from corrosion_tpu.core import bookkeeping as jbook
from corrosion_tpu.core import changes as jchanges
from corrosion_tpu.core import hlc as jhlc
from corrosion_tpu.core import ids as jids
from corrosion_tpu.core import intervals as jiv
from corrosion_tpu.core import values as jvalues
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.core import bookkeeping as tbook
from corrosion_tpu_torch.core import changes as tchanges
from corrosion_tpu_torch.core import hlc as thlc
from corrosion_tpu_torch.core import ids as tids
from corrosion_tpu_torch.core import intervals as tiv
from corrosion_tpu_torch.core import values as tvalues
from corrosion_tpu_torch.utils import backoff as tbackoff

CORE_SWAPS = {
    "corrosion_tpu.core.bookkeeping": tbook,
    "corrosion_tpu.core.changes": tchanges,
    "corrosion_tpu.core.hlc": thlc,
    "corrosion_tpu.core.ids": tids,
    "corrosion_tpu.core.intervals": tiv,
    "corrosion_tpu.core.values": tvalues,
    "corrosion_tpu.utils.backoff": tbackoff,
}


def reference_cases(module) -> list:
    """``(module, name)`` of every test function and test method of a
    reference test module, as ``Class.method`` for methods."""
    out = []
    for name, obj in vars(module).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            out.append(name)
        elif name.startswith("Test") and inspect.isclass(obj):
            out += [f"{name}.{m}" for m in vars(obj) if m.startswith("test_")]
    return out


def _port_value(obj, name: str, swaps: dict):
    if isinstance(obj, types.ModuleType):
        return swaps.get(obj.__name__)
    origin = getattr(obj, "__module__", None)
    if origin in swaps and hasattr(swaps[origin], name):
        return getattr(swaps[origin], name)
    return None


def run_against(module, case: str, swaps: dict, monkeypatch, **fixtures) -> None:
    """Run one reference test against the port: every global of ``module``
    that comes from a swapped reference module is replaced by the port's
    object of the same name, and ``sys.modules`` maps the reference module
    names to the port's for imports inside the test. The parent package's
    attribute is swapped too: ``from package import module`` reads it
    before ``sys.modules``."""
    for name, obj in list(vars(module).items()):
        port = _port_value(obj, name, swaps)
        if port is not None:
            monkeypatch.setattr(module, name, port)
    for ref_name, port_mod in swaps.items():
        monkeypatch.setitem(sys.modules, ref_name, port_mod)
        parent, _, leaf = ref_name.rpartition(".")
        if parent in sys.modules:
            monkeypatch.setattr(sys.modules[parent], leaf, port_mod, raising=False)
    cls_name, _, meth = case.rpartition(".")
    fn = getattr(getattr(module, cls_name)(), meth) if cls_name else getattr(module, case)
    params = inspect.signature(fn).parameters
    fixtures = dict(fixtures, monkeypatch=monkeypatch)
    fn(**{k: fixtures[k] for k in params})


@pytest.fixture(scope="module")
def codec_built():
    assert tnative.build(), tnative.build_status()
    return tnative.native


@pytest.fixture(params=["native", "python"])
def codec(request, codec_built, monkeypatch):
    """The port's values module on the native codec or the Python one."""
    if request.param == "python":
        monkeypatch.setattr(tnative, "native", None)
    return request.param


@pytest.mark.parametrize("case", reference_cases(ref_core_tests))
def test_reference_core_cases_hold_on_the_port(case, codec, monkeypatch):
    run_against(ref_core_tests, case, CORE_SWAPS, monkeypatch)


@pytest.mark.parametrize("case", reference_cases(ref_bookkeeping_tests))
def test_reference_bookkeeping_cases_hold_on_the_port(case, monkeypatch):
    run_against(ref_bookkeeping_tests, case, CORE_SWAPS, monkeypatch)


def test_the_swap_reaches_the_port():
    """The runner's globals point at the port's objects while it runs, and
    the reference's come back afterwards."""
    mp = pytest.MonkeyPatch()
    try:
        run_against(ref_core_tests, "TestRangeSet.test_total", CORE_SWAPS, mp)
        assert ref_core_tests.RangeSet is tiv.RangeSet
        assert sys.modules["corrosion_tpu.core.values"] is tvalues
        import corrosion_tpu.core as jcore

        assert jcore.values is tvalues  # `from corrosion_tpu.core import values`
    finally:
        mp.undo()
    assert ref_core_tests.RangeSet is jiv.RangeSet
    assert sys.modules["corrosion_tpu.core.values"] is jvalues
    assert jcore.values is jvalues


# -- the copy against the live reference on seeded operation sequences -------


def _rand_range(rng: random.Random, hi: int = 200):
    a = rng.randrange(hi)
    return a, a + rng.randrange(12)


@pytest.mark.parametrize("seed", range(4))
def test_rangeset_and_rangemap_follow_the_reference(seed):
    rng = random.Random(seed)
    js, ts = jiv.RangeSet(), tiv.RangeSet()
    jm, tm = jiv.RangeMap(), tiv.RangeMap()
    for _ in range(400):
        op = rng.randrange(4)
        s, e = _rand_range(rng)
        if op == 0:
            js.insert(s, e), ts.insert(s, e)
        elif op == 1:
            js.remove(s, e), ts.remove(s, e)
        elif op == 2:
            v = rng.choice("abc")
            jm.insert(s, e, v), tm.insert(s, e, v)
        else:
            jm.remove(s, e), tm.remove(s, e)
        assert list(js) == list(ts) and list(jm) == list(tm)
        x = rng.randrange(220)
        assert js.contains(x) == ts.contains(x)
        assert js.contains_range(s, e) == ts.contains_range(s, e)
        assert list(js.gaps(s, e + 30)) == list(ts.gaps(s, e + 30))
        assert (js.total(), js.max_end()) == (ts.total(), ts.max_end())
        assert jm.get(x) == tm.get(x) and jm.get_range(x) == tm.get_range(x)
        assert list(jm.overlapping(s, e)) == list(tm.overlapping(s, e))


def _known(book, iv, rng: random.Random, version: int):
    """A random known-version entry of ``book``'s types."""
    kind = rng.randrange(3)
    if kind == 0:
        return book.Current(db_version=version, last_seq=rng.randrange(5), ts=0)
    if kind == 1:
        last = rng.randrange(10, 40)
        return book.Partial(seqs=iv.RangeSet([_rand_range(rng, last)]), last_seq=last, ts=0)
    return book.CLEARED


def _book_state(bv) -> tuple:
    return (
        {v: repr(c) for v, c in bv.current.items()},
        {v: (list(p.seqs), p.last_seq) for v, p in bv.partials.items()},
        list(bv.cleared), bv.last(), list(bv.sync_need()),
    )


@pytest.mark.parametrize("seed", range(4))
def test_booked_versions_and_sync_follow_the_reference(seed):
    """Random inserts of every known kind into bookies of both packages,
    then ``generate_sync`` and ``compute_available_needs`` between peers."""
    rng = random.Random(seed)
    jbookie, tbookie = jbook.Bookie(), tbook.Bookie()
    for _ in range(300):
        actor = rng.choice(["a", "b", "c"])
        s = 1 + rng.randrange(60)
        e = s + rng.randrange(4)
        r = rng.getstate()
        kj = _known(jbook, jiv, rng, s)
        rng.setstate(r)
        kt = _known(tbook, tiv, rng, s)
        if isinstance(kj, jbook.Current) or rng.randrange(2):
            jbookie.for_actor(actor).insert(s, kj), tbookie.for_actor(actor).insert(s, kt)
        else:
            jbookie.for_actor(actor).insert_many(s, e, kj)
            tbookie.for_actor(actor).insert_many(s, e, kt)
        jb, tb = jbookie.get(actor), tbookie.get(actor)
        assert _book_state(jb) == _book_state(tb)
        v = rng.randrange(70)
        assert jb.contains_version(v) == tb.contains_version(v)
        assert jb.contains(v, (0, 5)) == tb.contains(v, (0, 5))
        assert jb.current_versions() == tb.current_versions()
    js, ts = jbook.generate_sync(jbookie, "me"), tbook.generate_sync(tbookie, "me")
    assert (js.heads, js.need, js.partial_need) == (ts.heads, ts.need, ts.partial_need)
    assert js.need_len() == ts.need_len()
    peer_j, peer_t = jbook.SyncState(actor_id="peer"), tbook.SyncState(actor_id="peer")
    peer_j.heads["a"] = peer_t.heads["a"] = 80
    peer_j.need["b"] = peer_t.need["b"] = [(3, 9)]
    for ours_j, ours_t, theirs_j, theirs_t in ((js, ts, peer_j, peer_t), (peer_j, peer_t, js, ts)):
        want = ours_j.compute_available_needs(theirs_j)
        got = ours_t.compute_available_needs(theirs_t)
        assert {a: [repr(n) for n in ns] for a, ns in want.items()} == \
            {a: [repr(n) for n in ns] for a, ns in got.items()}


def _rand_value(rng: np.random.Generator):
    kind = int(rng.integers(5))
    if kind == 0:
        return None
    if kind == 1:
        return int(rng.integers(-(2**63), 2**63 - 1, dtype=np.int64))
    if kind == 2:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 300)))
    if kind == 3:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FFF, int(rng.integers(0, 9))))
    return bytes(rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8))


def test_values_codec_bytes_equal_on_both_paths(codec_built):
    """Seeded random rows: the port's Python codec, the port's native codec
    and the reference's codec give the same bytes and the same rows back,
    and the LWW order agrees."""
    rng = np.random.default_rng(5)
    for _ in range(500):
        vals = tuple(_rand_value(rng) for _ in range(int(rng.integers(0, 6))))
        blob = jvalues.pack_columns(vals)
        assert tvalues._py_pack_columns(vals) == blob == tnative.native.pack_columns(list(vals))
        assert tvalues.pack_columns(vals) == blob
        assert tvalues.unpack_columns(blob) == tvalues._py_unpack_columns(blob) == \
            jvalues.unpack_columns(blob)
        a, b = _rand_value(rng), _rand_value(rng)
        assert tvalues.value_cmp_key(a) == jvalues.value_cmp_key(a)
        assert tvalues.value_le(a, b) == jvalues.value_le(a, b)
        assert (tvalues.value_cmp_key(a) <= tvalues.value_cmp_key(b)) == jvalues.value_le(a, b)


def test_value_types_equal_the_reference():
    ch = dict(table="t", pk=b"\x01", cid="c", val="v" * 7, col_version=3, db_version=4,
              seq=2, site_id=b"\x00" * 16, cl=1)
    assert tvalues.Change(**ch).estimated_byte_size() == jvalues.Change(**ch).estimated_byte_size()
    for raw in ("SELECT 1", ["INSERT INTO t VALUES (?)", [1]], ["x", {"a": 2}]):
        j, t = jvalues.Statement.parse(raw), tvalues.Statement.parse(raw)
        assert (j.sql, j.params, j.named_params) == (t.sql, t.params, t.named_params)


def test_chunker_follows_the_reference():
    rng = random.Random(9)
    for _ in range(20):
        last = rng.randrange(1, 120)
        seqs = sorted(rng.sample(range(last + 1), rng.randrange(0, min(last, 30))))

        def rows(mod):
            return [mod.Change(table="t", pk=bytes([s % 256]), cid="c", val="x" * rng2.randrange(300),
                               col_version=1, db_version=1, seq=s, site_id=b"\x00" * 16, cl=1)
                    for s in seqs]

        rng2 = random.Random(last)
        jrows = rows(jvalues)
        rng2 = random.Random(last)
        trows = rows(tvalues)
        mb = rng.choice([200, 500, 8000])
        want = [([c.seq for c in cs], r) for cs, r in jchanges.chunk_changes(jrows, last, max_bytes=mb)]
        got = [([c.seq for c in cs], r) for cs, r in tchanges.chunk_changes(trows, last, max_bytes=mb)]
        assert want == got
        assert jchanges.max_seq(jrows) == tchanges.max_seq(trows)
    ja, ta = jchanges.AdaptiveChunker(), tchanges.AdaptiveChunker()
    for s in [0.01, 2.0, 0.5, 9.0, 0.001] * 4:
        assert ja.record(s) == ta.record(s)
        assert vars(ja) == vars(ta)


def test_hlc_follows_the_reference_under_one_clock():
    """Both clocks read one injected wall clock that stalls, jumps and runs
    backwards: equal timestamps, equal drift refusals."""
    rng = random.Random(3)
    now = [1_700_000_000_000]
    jc, tc = jhlc.HLC(max_delta_ms=300), thlc.HLC(max_delta_ms=300)
    jc._now_ms = tc._now_ms = lambda: now[0]
    for _ in range(500):
        now[0] += rng.choice([0, 0, 1, 5, -3, 250])
        if rng.randrange(3):
            assert jc.new_timestamp() == tc.new_timestamp()
        else:
            remote = jhlc.make_ts(now[0] + rng.randrange(-50, 400), rng.randrange(8))
            outcomes = []
            for c, err in ((jc, jhlc.ClockDriftError), (tc, thlc.ClockDriftError)):
                try:
                    c.update_with_timestamp(remote)
                    outcomes.append("ok")
                except err as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]
        assert jc.last == tc.last
    ts = jc.last
    assert thlc.ts_to_string(ts) == jhlc.ts_to_string(ts)
    assert thlc.ts_from_string(jhlc.ts_to_string(ts)) == ts


def test_ids_follow_the_reference():
    for seed in range(20):
        raw = random.Random(seed).randbytes(16)
        j, t = jids.ActorId(raw), tids.ActorId(raw)
        assert (j.hex, str(j), j.to_node_index(97)) == (t.hex, str(t), t.to_node_index(97))
        assert tids.ActorId.from_hex(j.hex) == t
        ja = jids.Actor(j, ("127.0.0.1", 1000 + seed), ts=seed)
        ta = tids.Actor(t, ("127.0.0.1", 1000 + seed), ts=seed)
        assert ta.renew(seed + 1).wins_over(ta) == ja.renew(seed + 1).wins_over(ja)

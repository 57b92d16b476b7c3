"""The port's native build (``corrosion_tpu_torch/native.py``) against the
reference's:

- it builds into ``build/native/`` and leaves the reference's
  ``corrosion_tpu/_native/`` untouched, and its codec is its own module,
  loaded from that directory, never the top-level ``_corro_native`` that
  the reference binds;
- its codec gives the bytes of the reference's Python and native codecs
  on ``tests/test_native.py``'s samples, refuses the same malformed blobs
  and out-of-range integers, orders values as they do, and round-trips
  the same wire frames;
- its SQLite extension answers the CRDT SQL functions as the reference's.
"""

import os
import sqlite3
import sys
from pathlib import Path

import pytest

from corrosion_tpu import native as jnative
from corrosion_tpu.core import values as jvalues
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.core import values as tvalues
from test_native import CMP_VALUES, SAMPLES

REPO = Path(__file__).resolve().parent.parent


def _mtimes(d: Path) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in d.iterdir()} if d.is_dir() else {}


@pytest.fixture(scope="module")
def port():
    assert tnative.build(quiet=False), tnative.build_status()
    return tnative.native


def test_build_goes_to_build_native_and_leaves_the_reference_alone(port):
    ref_dir = REPO / "corrosion_tpu" / "_native"
    before = _mtimes(ref_dir)
    # Age the port's artifacts so the next build compiles both again.
    for p in (tnative.CODEC_PATH, tnative.CRDT_EXT_PATH + ".so"):
        if os.path.exists(p):
            os.utime(p, (0, 0))
    assert tnative.build(quiet=False)
    assert _mtimes(ref_dir) == before
    built = Path(tnative.BUILD_DIR)
    assert built == REPO / "build" / "native"
    assert os.path.getmtime(tnative.CODEC_PATH) > 0
    status = tnative.build_status()
    assert status["codec"] and status["codec_loaded"]
    assert status["crdt_ext"] == (status["sqlite_header"] is not None)


def test_the_codec_is_the_ports_own_module(port):
    assert Path(port.__file__).resolve().parent == (REPO / "build" / "native").resolve()
    assert port.__name__ == "corrosion_tpu_torch._native._corro_native"
    assert sys.modules.get(port.__name__) in (None, port)
    ref = sys.modules.get("_corro_native")
    if ref is not None:
        assert ref is not port and ref is jnative.native
        assert Path(ref.__file__).resolve().parent == (REPO / "corrosion_tpu" / "_native").resolve()
    assert tvalues._native_mod is tnative


@pytest.mark.parametrize("vals", SAMPLES)
def test_pack_bytes_equal_the_reference(port, vals):
    want = jvalues._py_pack_columns(vals)
    assert port.pack_columns(list(vals)) == want == tvalues._py_pack_columns(vals)
    if jnative.available():
        assert jnative.native.pack_columns(list(vals)) == want
    expect = tuple(int(v) if isinstance(v, bool) else v for v in vals)
    assert port.unpack_columns(want) == tvalues._py_unpack_columns(want) == expect
    assert tvalues.unpack_columns(want) == jvalues.unpack_columns(want) == expect


MALFORMED = (
    jvalues.pack_columns([1, "hi", b"xy"])[:-1],  # truncated payload
    b"\x01",  # truncated varint
    b"\x05",  # unknown tag
    b"\x03\x05ab",  # declared length overruns
    b"\x02\x00\x00",  # truncated real
    b"\x01" + b"\x80" * 10,  # varint overflow
)


@pytest.mark.parametrize("path", ["native", "python"])
def test_malformed_blobs_raise_the_ports_error(port, path, monkeypatch):
    if path == "python":
        monkeypatch.setattr(tnative, "native", None)
    for bad in MALFORMED:
        with pytest.raises(tvalues.MalformedBlobError):
            tvalues.unpack_columns(bad)
        with pytest.raises(jvalues.MalformedBlobError):
            jvalues.unpack_columns(bad)
    assert tvalues.MalformedBlobError is not jvalues.MalformedBlobError


@pytest.mark.parametrize("path", ["native", "python"])
def test_the_i64_range(port, path, monkeypatch):
    if path == "python":
        monkeypatch.setattr(tnative, "native", None)
    for bad in (2**63, -(2**63) - 1, 2**100):
        with pytest.raises(ValueError):
            tvalues.pack_columns([bad])
    edge = (2**63 - 1, -(2**63))
    assert tvalues.pack_columns(edge) == jvalues.pack_columns(edge)
    assert tvalues.unpack_columns(tvalues.pack_columns(edge)) == edge


def test_value_order_equals_the_reference(port):
    for a in CMP_VALUES:
        for b in CMP_VALUES:
            got = port.value_cmp(a, b)
            if jnative.available():
                assert got == jnative.native.value_cmp(a, b), (a, b)
            ka, kb = jvalues.value_cmp_key(a), jvalues.value_cmp_key(b)
            assert got == (-1 if ka < kb else (1 if ka > kb else 0)), (a, b)
            assert tvalues.value_le(a, b) == jvalues.value_le(a, b)


def test_wire_codec_equals_the_reference(port):
    frames = [
        {"t": "bcast", "actor": b"\x01" * 16, "version": 7, "seqs": [0, 41], "last_seq": 41,
         "ts": 123456789, "changes": [["tbl", b"pk\x00", "col", None, 1, 2, 3, b"s" * 16, 1],
                                      ["tbl", b"pk\x01", "col", 2.5, 1, 2, 4, b"s" * 16, 1]]},
        {"t": "sync_state", "state": {"heads": {"00ff": 3}, "need": {}, "partial": []}},
        {"empty": {}, "list": [], "nested": [[[1], [True, False, None]]], "big": -(2**62)},
    ]
    for f in frames:
        blob = port.encode(f)
        if jnative.available():
            assert blob == jnative.native.encode(f)
        assert port.decode(blob) == f
    for bad in (b"\xffgarbage", port.encode({"a": 1}) + b"tail", b"\x07\xff\xff\xff\xff\x7f"):
        with pytest.raises(ValueError):
            port.decode(bad)


@pytest.fixture
def ext_conns(port):
    if not (tnative.crdt_ext_available() and jnative.crdt_ext_available()):
        pytest.skip("crdt_ext.so not built by both packages (no sqlite3ext.h)")
    t, j = sqlite3.connect(":memory:"), sqlite3.connect(":memory:")
    assert tnative.load_crdt_extension(t) and jnative.load_crdt_extension(j)
    yield t, j
    t.close()
    j.close()


def test_crdt_ext_answers_as_the_reference(ext_conns):
    t, j = ext_conns
    finite = [v for v in CMP_VALUES if not (isinstance(v, float) and abs(v) == float("inf"))]
    queries = [("SELECT crdt_value_cmp(?, ?)", (a, b)) for a in finite for b in finite]
    blob = jvalues.pack_columns([1, "hi", None, b"\x00"])
    queries += [
        ("SELECT crdt_pack_columns(?, ?, ?, ?)", (1, "hi", None, b"\x00")),
        ("SELECT crdt_col_count(?)", (blob,)),
        ("SELECT crdt_unpack_col(?, 0), crdt_unpack_col(?, 1), crdt_unpack_col(?, 2), "
         "crdt_unpack_col(?, 3), crdt_unpack_col(?, 4)", (blob,) * 5),
        ("SELECT crdt_site_hex(?)", (b"\x00\xab\xff",)),
    ]
    for sql, args in queries:
        assert t.execute(sql, args).fetchall() == j.execute(sql, args).fetchall(), (sql, args)
    (packed,) = t.execute("SELECT crdt_pack_columns(?, ?, ?, ?)", (1, "hi", None, b"\x00")).fetchone()
    assert packed == tvalues.pack_columns([1, "hi", None, b"\x00"])


# -- the transport's and the store's native cases ----------------------------

# tests/test_native.py's cases that need the agent's transport and store,
# run against the port's (the codec, the values module, the transport and
# the store all swapped for the port's while a case runs).
NATIVE_AGENT_CASES = (
    "test_python_binary_decoder_parity",
    "test_transport_frames_binary_and_json",
    "test_store_uses_native_merge",
)


@pytest.mark.parametrize("case", NATIVE_AGENT_CASES)
def test_reference_transport_and_store_cases_hold_on_the_port(case, port, tmp_path,
                                                              monkeypatch):
    import test_native as ref_native_tests
    from corrosion_tpu_torch.agent import store as tstore
    from corrosion_tpu_torch.agent import transport as ttransport
    from test_torch_core import run_against

    swaps = {
        "corrosion_tpu.native": tnative,
        "corrosion_tpu.core.values": tvalues,
        "corrosion_tpu.agent.transport": ttransport,
        "corrosion_tpu.agent.store": tstore,
    }
    run_against(ref_native_tests, case, swaps, monkeypatch, tmp_path=tmp_path)
    assert ref_native_tests.native is tnative

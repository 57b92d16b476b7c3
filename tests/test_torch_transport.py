"""The port's gossip transport (``corrosion_tpu_torch/agent/transport.py``)
against the reference's:

- frames byte-equal to the reference's on both paths (kind 1 from the
  native encoder, kind 0 JSON where no codec is loaded), each decoded by
  the other package, and by the pure-Python binary decoder;
- the transport follows the port's own ``native`` module only;
- ``Breaker`` under one injected clock, step for step equal;
- one loopback exchange on 127.0.0.1 (a stream frame, a UDP datagram, a
  sync session's request and reply) port to port, and port to reference
  both ways.

Every exchange runs under its own time limit, so nothing waits under
xdist.
"""

import types

import pytest

from corrosion_tpu import native as jnative
from corrosion_tpu.agent import transport as jtransport
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.agent import transport as ttransport
from corrosion_tpu_torch.sim import host_oracles as H

MESSAGES = (
    {"t": "bcast", "actor": b"\x01" * 16, "version": -3,
     "changes": [["t", b"\x00", "c", 1.5, 1, 2, 3, b"s" * 16, 1]],
     "flags": [True, False, None], "nested": {"a": {"b": [2**62]}}},
    {},
    {"x": []},
    {"t": "sync", "need": [[0, 5], [9, 12]], "txt": "héllo ☃", "neg": -(2**63)},
    {"t": "swim", "from": ["127.0.0.1", 8787], "inc": 7, "f": -0.0},
)


@pytest.fixture(scope="module")
def codecs():
    assert tnative.build(), tnative.build_status()
    if not jnative.available():
        pytest.skip("the reference's native codec is not built here")


@pytest.mark.parametrize("msg", MESSAGES)
def test_binary_frames_equal_and_cross_decode(codecs, msg):
    a, b = ttransport.encode_frame(msg), jtransport.encode_frame(msg)
    assert a == b and a[4] == ttransport.FRAME_BIN
    assert ttransport.decode_frame_body(b[4:]) == msg == jtransport.decode_frame_body(a[4:])
    obj, end = ttransport._py_wire_decode(a[5:])
    assert end == len(a) - 5 and obj == msg


@pytest.mark.parametrize("msg", MESSAGES)
def test_json_frames_equal_and_cross_decode(codecs, msg, monkeypatch):
    monkeypatch.setattr(tnative, "native", None)
    monkeypatch.setattr(jnative, "native", None)
    a, b = ttransport.encode_frame(msg), jtransport.encode_frame(msg)
    assert a == b and a[4] == ttransport.FRAME_JSON
    assert ttransport.decode_frame_body(b[4:]) == msg == jtransport.decode_frame_body(a[4:])
    monkeypatch.undo()
    # A native peer decodes a JSON frame, and a codec-less one a binary
    # frame through the pure-Python decoder.
    assert ttransport.decode_frame_body(a[4:]) == msg
    binary = jtransport.encode_frame(msg)
    monkeypatch.setattr(tnative, "native", None)
    assert ttransport.decode_frame_body(binary[4:]) == msg


def test_the_transport_follows_only_the_ports_native(codecs, monkeypatch):
    assert ttransport._native is tnative
    msg = MESSAGES[0]
    monkeypatch.setattr(tnative, "native", None)
    assert jnative.native is not None
    assert ttransport.encode_frame(msg)[4] == ttransport.FRAME_JSON
    monkeypatch.undo()
    monkeypatch.setattr(jnative, "native", None)
    assert ttransport.encode_frame(msg)[4] == ttransport.FRAME_BIN


def test_malformed_frames_refused_alike(codecs):
    for body in (b"", b"\x07", b"\x01\xff", b"\x00{", b"\x01" + b"\x07\xff\xff\xff\xff\x7f"):
        errs = []
        for mod in (ttransport, jtransport):
            try:
                mod.decode_frame_body(body)
            except (ValueError, UnicodeDecodeError) as e:
                errs.append(type(e).__name__)
        assert len(errs) == 2 and errs[0] == errs[1], body
    for bad in (b"\xff", jtransport.encode_frame({"a": 1})[5:-1]):
        with pytest.raises(ValueError):
            ttransport._py_wire_decode(bad)


def test_transport_frames_oracle(codecs):
    out = H.transport_frames()
    assert out["binary_bytes"] < out["json_bytes"]


# -- the circuit breaker under an injected clock -----------------------------


def _clock(monkeypatch, mod, now: list):
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: now[0]))


def test_breaker_steps_equal_the_reference(monkeypatch):
    now = [100.0]
    _clock(monkeypatch, ttransport, now)
    _clock(monkeypatch, jtransport, now)
    kw = dict(threshold=3, base_s=0.5, max_s=4.0)
    bt, bj = ttransport.Breaker(**kw), jtransport.Breaker(**kw)
    # fail x5 (trip at the third), wait out cooldowns, re-trip, recover.
    script = ["fail"] * 5 + ["avail", ("tick", 3.0), "avail", "fail", ("tick", 10.0),
                             "avail", "fail", "ok", "avail", "ok", "fail", "fail", "fail"]
    trace = []
    for step in script:
        if isinstance(step, tuple):
            now[0] += step[1]
            continue
        got = [getattr(b, "available" if step == "avail" else step)() for b in (bt, bj)]
        assert got[0] == got[1], (step, got)
        assert (bt.fails, bt.open_until) == (bj.fails, bj.open_until), step
        trace.append(got[0])
    assert trace[:5] == [False, False, True, False, False]  # the trip edge
    assert bt.open_until == now[0] + 0.5


def test_breaker_defaults_equal_the_reference():
    assert (ttransport.BREAKER_THRESHOLD, ttransport.BREAKER_BASE_S, ttransport.BREAKER_MAX_S) \
        == (jtransport.BREAKER_THRESHOLD, jtransport.BREAKER_BASE_S, jtransport.BREAKER_MAX_S)
    assert (ttransport.MAX_FRAME, ttransport.MAX_DATAGRAM, ttransport.TRACE_KEY) \
        == (jtransport.MAX_FRAME, jtransport.MAX_DATAGRAM, jtransport.TRACE_KEY)


def test_trace_header_helpers_equal_the_reference():
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for mod in (ttransport, jtransport):
        f = mod.attach_trace({"t": "bcast"}, tp)
        assert mod.extract_trace(f) == tp
        assert mod.extract_trace({"trace": "garbage"}) is None
        assert mod.attach_trace({"t": "x"}, None) == {"t": "x"}


# -- loopback exchanges ---------------------------------------------------------

PAIRS = {
    "port-port": (ttransport, ttransport),
    "port-serves-reference": (ttransport, jtransport),
    "reference-serves-port": (jtransport, ttransport),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_loopback_exchange(pair, codecs):
    server, client = PAIRS[pair]
    out = H.transport_loopback(server, client)
    assert out == {"frame": True, "datagram": True, "session": True}


def test_loopback_exchange_without_a_codec(codecs, monkeypatch):
    """Both ends on JSON frames (no codec loaded): the same exchange."""
    monkeypatch.setattr(tnative, "native", None)
    out = H.transport_loopback()
    assert out == {"frame": True, "datagram": True, "session": True}

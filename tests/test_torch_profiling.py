"""Device time by profiler range (``corrosion_tpu_torch.profiling``), on a
hand-written chrome trace: the attribution that
``scripts/torch_round_profile.py`` reads device time through."""

from corrosion_tpu_torch.profiling import device_events_by_range, launch_times


def _range(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _device(name, ts, corr=None, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": 3,
            "args": {} if corr is None else {"correlation": corr}}


def _events():
    return [
        _range("a", 0, 10), _range("b", 20, 10), _range("other", 40, 10),
        _launch(7, 2), _launch(8, 21),
        # Launched in a, run while b's range is open: a's.
        _device("k1", 25, corr=7),
        _device("copy", 26, corr=8, cat="gpu_memcpy"),
        # No launch record in the trace, starting inside b.
        _device("k2", 22, corr=9),
        # A range not asked for, and no range at all.
        _device("k3", 42), _device("k4", 60),
        # Host-side events are not device time.
        {"cat": "cpu_op", "name": "aten::gather", "ts": 3, "dur": 1, "args": {}},
    ]


def test_device_events_follow_their_launch_then_their_own_start():
    got = [(name, e["name"]) for name, e in
           device_events_by_range(_events(), ("a", "b"), by_own_start=True)]
    assert got == [("a", "k1"), ("b", "copy"), ("b", "k2"), (None, "k3"), (None, "k4")]


def test_device_events_without_a_launch_record_have_no_range_by_default():
    got = [(name, e["name"]) for name, e in device_events_by_range(_events(), ("a", "b"))]
    assert got == [("a", "k1"), ("b", "copy"), (None, "k2"), (None, "k3"), (None, "k4")]
    assert sorted(launch_times(_events())) == [7, 8]

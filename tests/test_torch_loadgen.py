"""The port's ``loadgen/`` against the reference's, on the CPU:

- every case of ``tests/test_loadgen.py`` that is not marked slow, run
  against the port's modules (``test_torch_core.run_against``): the
  schedule, the fan-out oracle, the emit path and the budget gate, and
  the reduced fan-out storm and saturation sweep on the port's live
  agents; ``serving_context`` is bound to ``device="cpu"``;
- ``schedule`` and ``oracle`` against the live reference on seeded
  arrivals and seeded delivery streams: equal arrival lists, equal
  verdicts and equal delivery records;
- ``sim/host_oracles.py``'s serving-plane checks (``chip_smoke.py`` phase
  15) on the CPU: the 2,000-subscription storm with its table merged and
  read through the PG wire, the sweep at its defaults, gossip over mutual
  TLS.

The slow cases (the 2,000-subscription storm, the collapse rule) run on
the card in ``chip_smoke.py``; ``intake_policy`` at small size against the
reference is ``test_torch_loadgen_soak.py``.
"""

import functools
import random
import types

import pytest

import test_loadgen as ref_loadgen
from corrosion_tpu.loadgen import oracle as joracle
from corrosion_tpu.loadgen import schedule as jschedule
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch.loadgen import oracle as toracle
from corrosion_tpu_torch.loadgen import report as treport
from corrosion_tpu_torch.loadgen import schedule as tschedule
from corrosion_tpu_torch.sim import host_oracles as H
from test_torch_agent_runtime import RUNTIME_SWAPS
from test_torch_core import reference_cases, run_against

SLOW = ("test_fanout_storm_2k_subscriptions", "test_intake_policy_collapse_rule")
CASES = [c for c in reference_cases(ref_loadgen) if c not in SLOW]


def _report_on_cpu():
    """The port's ``loadgen.report`` with ``serving_context`` on the CPU."""
    mod = types.ModuleType("corrosion_tpu_torch.loadgen.report")
    mod.__dict__.update(vars(treport))
    mod.serving_context = functools.partial(treport.serving_context, device="cpu")
    return mod


@pytest.fixture(scope="module", autouse=True)
def built():
    tnative.build()


@pytest.mark.parametrize("case", CASES)
def test_reference_loadgen_cases_hold_on_the_port(case, tmp_path, monkeypatch):
    swaps = dict(RUNTIME_SWAPS, **{"corrosion_tpu.loadgen.report": _report_on_cpu()})
    run_against(ref_loadgen, case, swaps, monkeypatch, tmp_path=tmp_path)


def test_the_non_slow_cases_are_all_run():
    assert len(CASES) == 21
    assert set(CASES) | set(SLOW) == set(reference_cases(ref_loadgen))
    for name in SLOW:
        marks = [m.name for m in getattr(ref_loadgen, name).pytestmark]
        assert "slow" in marks, name


def test_serving_context_resolves_its_device():
    """No device and no CUDA raises; ``device="cpu"`` describes the CPU."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            treport.serving_context("fanout_storm", 1, 32)
    ctx = treport.serving_context("fanout_storm", 1, 32, device="cpu")
    assert ctx["platform"] == "cpu" and ctx["scenario"] == "fanout_storm"
    assert ctx["nodes"] == 1 and ctx["device_count"] == 1
    treport.emit_serving_report(ctx)


# -- the copy against the live reference -----------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_schedules_equal_the_reference(seed):
    rng = random.Random(seed)
    for _ in range(40):
        rate = rng.uniform(0.5, 500.0)
        count = rng.randrange(0, 200)
        burst = rng.randrange(1, 20)
        start = rng.uniform(0.0, 5.0)
        got = tschedule.open_loop(rate, count, burst=burst, start=start, stage=seed)
        want = jschedule.open_loop(rate, count, burst=burst, start=start, stage=seed)
        assert [(a.t, a.stage) for a in got] == [(a.t, a.stage) for a in want]
        stages = [(rng.uniform(1.0, 300.0), rng.uniform(0.1, 2.0))
                  for _ in range(rng.randrange(1, 5))]
        got = tschedule.ramp(stages, burst=burst)
        want = jschedule.ramp(stages, burst=burst)
        assert [(a.t, a.stage) for a in got] == [(a.t, a.stage) for a in want]


def _drive_oracle(mod, seed: int) -> tuple:
    """A seeded stream of attaches, commits, snapshots and deliveries,
    with duplicates, reordered change ids, early deliveries and missed
    commits among them."""
    rng = random.Random(seed)
    o = mod.FanoutOracle(keep_deliveries=True)
    sids = [o.attach_stream(group=rng.choice((None, 0, 1, 2)), label=f"s{i}")
            for i in range(12)]
    t, cid = 0.0, {s: 0 for s in sids}
    keys = []
    pend = []
    for step in range(600):
        t += rng.uniform(0.0, 0.02)
        op = rng.random()
        if op < 0.1:
            o.snapshot_done(rng.choice(sids), t)
        elif op < 0.35:
            k = len(keys)
            keys.append((k, (f"w{k}",), rng.choice((None, 0, 1, 2))))
            o.commit(k, (f"w{k}",), t_ack=t, group=keys[-1][2], t_send_mono=t - 0.01)
        elif op < 0.85 and keys:
            s = rng.choice(sids)
            k, payload, _ = rng.choice(keys) if rng.random() < 0.9 else (
                len(keys) + 1, ("early",), None)
            cid[s] += rng.choice((1, 1, 1, 2, -1))
            o.change(s, "insert", k, payload, change_id=cid[s], t=t + rng.uniform(0, 0.3),
                     t_wall=1e9 + t)
        elif op < 0.95 and keys:
            k, payload, _ = rng.choice(keys)
            o.snapshot_row(rng.choice(sids), k, payload, t_wall=1e9 + t)
        else:
            o.reconnected(rng.choice(sids))
        if step % 50 == 0:
            pend.append((o.pending(), o.pending(limit=3)))
    return o.finish(), o.delivery_records(), o.committed(), pend, list(o.violations)


@pytest.mark.parametrize("seed", range(6))
def test_oracle_verdicts_equal_the_reference(seed):
    got = _drive_oracle(toracle, seed)
    want = _drive_oracle(joracle, seed)
    assert got == want
    assert want[0]["violations"] > 0 and want[0]["fanout_lag_ms"]["count"] > 0


def test_serving_plane_oracles(tmp_path):
    """The card's checks of the storm (the reference's 2,000-subscription
    acceptance bar), the sweep and gossip TLS, run here on the CPU."""
    storm = H.loadgen_storm("cpu", root=tmp_path)
    assert (storm["streams"], storm["commits"], storm["violations"]) == (2000, 60, 0)
    assert storm["rows"] == storm["pg_rows"] == 60 and storm["routes"]["pg"]["ok"] > 0
    assert storm["nofile"]["soft"] == storm["nofile"]["hard"]
    sweep = H.loadgen_sweep(root=tmp_path)
    assert [s["rate_hz"] for s in sweep["stages"]] == [50.0, 200.0, 400.0]
    assert sweep["shed_total"] == sweep["server_shed_total"] > 0
    tls = H.agent_tls(root=tmp_path)
    if tls["tls"] != "cryptography absent":
        assert tls == {"tls": "ran", "agents": 3, "converge_s": tls["converge_s"],
                       "untrusted_refused": True}


def test_storm_table_is_held_to_the_merge(tmp_path):
    """A change log whose merge disagrees with the table (one logged
    col_version raised) is refused."""
    import asyncio
    import sqlite3

    from corrosion_tpu_torch.loadgen import scenarios

    asyncio.run(scenarios.fanout_storm(str(tmp_path), subs=8, writes=6, write_rate=30.0,
                                       read_rate=5.0, pg_rate=5.0, drain_timeout_s=15.0))
    db = tmp_path / "agent0" / "state.db"
    assert sorted(H.storm_cells(db, "cpu")) == list(range(6))
    conn = sqlite3.connect(str(db))
    conn.execute("UPDATE __crdt_changes SET col_version = col_version + 5 WHERE rowid ="
                 " (SELECT min(rowid) FROM __crdt_changes WHERE tbl = 'tests')")
    conn.commit()
    conn.close()
    with pytest.raises(AssertionError, match="change log"):
        H.storm_cells(db, "cpu")

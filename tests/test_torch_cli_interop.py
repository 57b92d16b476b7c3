"""The port's command line and lint plane against the live JAX reference,
on the CPU (each case runs the reference's side once):

- lint findings of the host-only rules (CT002, CT020-CT021, CT040-CT043,
  CT060-CT062) on one fixture tree that fires each: equal rule, file,
  line and message; and each package's lint of its own copy of the host
  planes (agent, loadgen, hostchaos, fidelity, ...): the same findings and
  suppressions;
- ``obs record --nodes 32 --rounds 16 --churn``: the flight's round
  records byte-equal, and the facts equal;
- ``chaos run kitchen-sink --engines dense --rounds 24 --json``: equal
  reports (facts, violations, recovery);
- ``obs cost show --engines dense --devices 1 --variants plain``: equal
  artifact headers (but the count of devices present) and entries on the
  keys whose meaning the two models
  share (engine, variant, device count, config fingerprint, rounds). The
  cost metrics (``flops``, ``bytes_accessed``, ...) share names only: the
  reference's come from XLA's analysis of a compiled graph, the port's
  from a count of its eager operations, so they are held positive, not
  equal;
- ``--help`` of every command and subcommand: the same text, apart from
  ``--device``, the package's name, and the cost plane's phrases in
  ``PORT_HELP`` (the reference's XLA and v5e facts, which are not the
  port's).
"""

import argparse
import contextlib
import io
import json
import re
import textwrap

import pytest
import torch

from corrosion_tpu import cli as jcli
from corrosion_tpu.analysis import lint_paths as jlint
from corrosion_tpu_torch import cli as tcli
from corrosion_tpu_torch.analysis import lint_paths as tlint
from test_torch_agent_runtime import CPU_CLI

torch.set_num_threads(2)

HOST_RULES = {"CT002", "CT020", "CT021", "CT040", "CT041", "CT042", "CT043", "CT060",
              "CT061", "CT062"}

FIXTURES = {
    "kernel.py": """\
        # corro-lint: kernel-module
        import time

        def helper(x):
            import numpy as np
            return x

        def step(x):
            return x + time.time()
        """,
    "locks.py": """\
        import threading
        import time

        class Pair:
            def ab(self):
                with self._a_lock:
                    with self._b_lock:
                        time.sleep(0.1)

            def ba(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
        """,
    "agent/loop.py": """\
        import asyncio
        import time

        class Cache:
            async def refill(self, k):
                if k not in self._entries:
                    v = await self._fetch(k)
                    self._entries[k] = v
                return self._entries[k]

            async def tick(self):
                time.sleep(1.0)
                asyncio.create_task(self.refill(1))
                with open("x") as f:
                    f.read()
                try:
                    await self.refill(2)
                except asyncio.CancelledError:
                    pass
        """,
    "sim/faults.py": """\
        import random
        import numpy as np

        SEED = random.random()

        def plan(regions):
            rng = np.random.default_rng()
            for r in set(regions):
                yield r, rng.random()
        """,
    "emit.py": """\
        import os

        def emit(path):
            return {"format": "corro-test-blob/1", "nonce": os.urandom(8).hex()}
        """,
}


def test_host_only_rule_findings_equal_the_reference(tmp_path):
    for name, src in FIXTURES.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))

    def seen(res):
        return sorted((f.rule, str(f.path)[len(str(tmp_path)):], f.line, f.message)
                      for f in res.findings if f.rule in HOST_RULES)

    ref = seen(jlint([str(tmp_path)]))
    assert seen(tlint([str(tmp_path)])) == ref
    assert {r for r, *_ in ref} == HOST_RULES


# The host planes the port copied: the concurrency, asyncio and
# determinism lints read them as they read the reference's.
HOST_TREES = ("agent", "loadgen", "hostchaos", "fidelity", "integrations", "core", "utils",
              "client.py", "tpl.py")


@pytest.mark.parametrize("tree", HOST_TREES)
def test_host_plane_lints_equal_the_reference_on_its_own_modules(tree):
    """Each package's lint on its own copy of a host plane: the same
    findings and suppressions (rule, file, message, reason), but for the
    line numbers a message quotes (the copies' imports shift them)."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def seen(pkg, lint):
        root = os.path.join(repo, pkg)
        res = lint([os.path.join(root, tree)])
        return sorted((f.rule, os.path.relpath(f.path, root),
                       re.sub(r"line \d+", "line N", f.message), f.suppress_reason)
                      for f in res.findings + res.suppressed + res.stale)

    assert seen("corrosion_tpu_torch", tlint) == seen("corrosion_tpu", jlint)


def _run(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_obs_record_flight_equals_the_reference(tmp_path):
    argv = ["obs", "record", "--nodes", "32", "--rounds", "16", "--churn", "--out"]
    jrc, jout = _run(jcli, argv + [str(tmp_path / "j.jsonl")])
    trc, tout = _run(CPU_CLI, argv + [str(tmp_path / "t.jsonl")])
    assert jrc == trc == 0

    def rounds(path):
        return [line for line in open(path) if json.loads(line).get("kind") == "round"]

    jr, tr = rounds(tmp_path / "j.jsonl"), rounds(tmp_path / "t.jsonl")
    assert len(jr) == 16 and tr == jr
    jf, tf = json.loads(jout), json.loads(tout)
    assert {k: v for k, v in tf.items() if k != "flight"} == \
           {k: v for k, v in jf.items() if k != "flight"}


def test_chaos_run_facts_equal_the_reference():
    argv = ["chaos", "run", "kitchen-sink", "--engines", "dense", "--rounds", "24", "--json"]
    jrc, jout = _run(jcli, argv)
    trc, tout = _run(CPU_CLI, argv)
    assert jrc == trc
    jrep, trep = json.loads(jout), json.loads(tout)
    assert [r["facts"] for r in trep] == [r["facts"] for r in jrep]
    assert trep == jrep


def test_obs_cost_show_shared_entries_equal_the_reference():
    argv = ["obs", "cost", "show", "--engines", "dense", "--devices", "1", "--variants",
            "plain", "--json"]
    jrc, jout = _run(jcli, argv)
    trc, tout = _run(CPU_CLI, argv)
    assert jrc == trc == 0
    jm, tm = json.loads(jout), json.loads(tout)
    # (``device_count``, the devices present, is the conftest's 8 virtual
    # ones on the reference's side.)
    for k in ("schema", "platform", "tolerance", "engines", "variants", "device_counts"):
        assert tm[k] == jm[k], k
    assert list(tm["entries"]) == list(jm["entries"]) == ["dense/plain/d1"]
    je, te = jm["entries"]["dense/plain/d1"], tm["entries"]["dense/plain/d1"]
    for k in ("engine", "variant", "device_count", "config_fingerprint", "rounds"):
        assert te[k] == je[k], k
    for k in ("flops", "bytes_accessed", "peak_bytes"):
        assert te[k] > 0 and je[k] > 0, k


# The port's own words in the cost plane's help, where the reference's
# name XLA, AOT lowering, virtual CPU devices or the v5e's HBM.
PORT_HELP = {
    "XLA cost model: show/diff the corro-cost-model/1 artifact, derive the "
    "corro-capacity/1 HBM curve":
        "device cost model: show/diff the corro-cost-model/1 artifact, derive the "
        "corro-capacity/1 memory curve",
    "AOT-lower every engine plane entry and emit the corro-cost-model/1 artifact":
        "count every engine plane entry's operations and emit the corro-cost-model/1 "
        "artifact",
    "comma-separated device counts (sets the virtual CPU mesh flag itself when jax is "
    "not yet initialized)":
        "comma-separated device counts (positions of a mesh on the --device card)",
    "predicted per-device HBM curve (corro-capacity/1), validated against the measured "
    "512-node and 100k points":
        "predicted per-device memory curve (corro-capacity/1), validated against the "
        "measured 512-node point",
    "per-device HBM budget (default: v5e 16 GiB)":
        "per-device memory budget (default: the card's memory)",
}
DEVICE = (r"\[--device DEVICE\] ?|--device DEVICE torch device the engine-running commands "
          r"use \(default: cuda; host-only commands ignore it\) ?")


def _helps(parser, path=()):
    yield path, parser.format_help()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                yield from _helps(sub, path + (name,))


def _flat(text):
    return " ".join(text.split()).replace("- ", "-")


def test_help_texts_equal_the_reference(monkeypatch):
    monkeypatch.setenv("COLUMNS", "100")
    ref = dict(_helps(jcli._build_parser()))
    port = dict(_helps(tcli._build_parser()))
    assert set(port) == set(ref) and len(ref) > 50
    for path, text in ref.items():
        want = _flat(text)
        if not path:  # the description is each module's docstring
            want = want.split(" options: ")[1]
        for ref_words, port_words in PORT_HELP.items():
            want = want.replace(ref_words, port_words)
        got = re.sub(DEVICE, "", _flat(port[path]).replace("corrosion_tpu_torch",
                                                          "corrosion_tpu"))
        if not path:
            got = got.split(" options: ")[1]
        # Without whitespace: argparse wraps at hyphens too, by line width.
        assert "".join(got.split()) == "".join(want.split()), path


@pytest.mark.parametrize("argv", [
    ["obs", "record"], ["obs", "cost", "show"], ["obs", "cost", "capacity"],
    ["chaos", "run", "x"], ["elastic", "run", "x"], ["loadgen", "soak"],
    ["fidelity", "replay", "t"], ["lint", "--sanitize"],
])
def test_engine_commands_parse_device_and_their_reference_arguments(argv):
    """Every engine-running command parses ``--device`` and, apart from
    it, the same arguments as the reference."""
    a = vars(jcli._build_parser().parse_args(argv))
    b = vars(tcli._build_parser().parse_args(["--device", "cpu", *argv]))
    assert b.pop("device") == "cpu"
    changed = {k for k in a if a[k] != b[k]}
    assert set(b) == set(a) and changed <= {"variants", "hbm_gib"}

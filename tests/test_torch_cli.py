"""The port's command line (``cli.py``, ``__main__.py``, ``obs/commands.py``)
on the CPU:

- the reference's CLI cases of ``tests/test_chaos.py`` (``chaos list/run/
  fuzz/replay`` and their usage errors) and ``tests/test_convergence_health.py``
  (``obs report/tail/diff`` on a flight the port's engine recorded) run
  against the port (``test_torch_core.run_against``), with ``--device cpu``
  bound in front of every argv (``CPU_CLI``);
- ``python -m corrosion_tpu_torch`` is the CLI: a subprocess lints the
  port clean and lists the rules without importing torch, and an
  engine-running command there without ``--device`` and without CUDA
  raises;
- the ``--device`` option: accepted before or after the subcommand,
  ignored by host-only commands, and ``obs cost show``'s default variant
  is the port's.

The reference's other CLI cases run in ``test_torch_analysis.py`` (lint),
``test_torch_agent_runtime.py`` (query/exec, ``obs timeline``),
``test_torch_series_endurance.py`` (``obs soak``) and
``test_torch_fidelity.py`` (``fidelity calibrate/replay``, slow).
Equality with the live reference is ``test_torch_cli_interop.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import test_chaos as ref_chaos
import test_convergence_health as ref_health
from corrosion_tpu_torch import cli as tcli
from corrosion_tpu_torch.sim import engine as tengine
from corrosion_tpu_torch.sim import faults as tfaults
from corrosion_tpu_torch.sim import health as thealth
from corrosion_tpu_torch.sim import invariants as tinvariants
from corrosion_tpu_torch.sim import telemetry as ttelemetry
from test_torch_agent_runtime import CPU_CLI
from test_torch_core import run_against

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CLI_SWAPS = {
    "corrosion_tpu.cli": CPU_CLI,
    "corrosion_tpu.sim.faults": tfaults,
    "corrosion_tpu.sim.health": thealth,
    "corrosion_tpu.sim.invariants": tinvariants,
    "corrosion_tpu.sim.telemetry": ttelemetry,
}


@pytest.mark.parametrize("case", ["test_chaos_cli_run_and_fuzz",
                                  "test_chaos_cli_usage_errors_exit_2"])
def test_reference_chaos_cli_cases_hold_on_the_port(case, tmp_path, capsys, monkeypatch):
    run_against(ref_chaos, case, CLI_SWAPS, monkeypatch, tmp_path=tmp_path, capsys=capsys)


@pytest.fixture(scope="module")
def churn_run(tmp_path_factory):
    """The reference module's fixture, run by the port's engine: one
    512-node churned run, flight-recorded."""
    cfg, topo, sched, kill_rounds = thealth.churned_demo_cluster(
        nodes=512, rounds=96, samples=64, seed=9, device="cpu")
    path = str(tmp_path_factory.mktemp("flight") / "churn512.jsonl")
    tele = ttelemetry.KernelTelemetry(
        engine="dense", recorder=ttelemetry.FlightRecorder(path, engine="dense"))
    final, curves = tengine.simulate(cfg, topo, sched, seed=2, max_chunk=24, telemetry=tele,
                                     device="cpu")
    tele.recorder.close()
    return cfg, topo, sched, kill_rounds, path, final, curves


def test_reference_obs_cli_case_holds_on_the_port(churn_run, tmp_path, capsys, monkeypatch):
    run_against(ref_health, "test_obs_cli_report_tail_diff", CLI_SWAPS, monkeypatch,
                churn_run=churn_run, tmp_path=tmp_path, capsys=capsys)


def _module_run(*argv, timeout=120):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "corrosion_tpu_torch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_python_dash_m_lints_the_port_clean_without_torch():
    res = _module_run("--device", "cpu", "lint", "corrosion_tpu_torch", "--show-suppressed")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("0 finding(s),") and "0 stale suppression(s)" in last
    assert "(suppressed: the round's counted sync" in res.stdout
    res = _module_run("lint", "--list-rules")
    assert res.returncode == 0 and "CT031" in res.stdout
    code = ("import sys, io, contextlib\n"
            "from corrosion_tpu_torch import cli\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    assert cli.main(['lint', '--list-rules']) == 0\n"
            "    assert cli.main(['lint', 'corrosion_tpu_torch/ops']) == 0\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_python_dash_m_engine_command_raises_without_cuda(tmp_path):
    res = _module_run("obs", "record", "--out", str(tmp_path / "f.jsonl"), "--nodes", "32",
                      "--rounds", "16")
    assert res.returncode == 1
    assert "RuntimeError: CUDA is not available" in res.stderr
    assert not (tmp_path / "f.jsonl").exists()


def test_device_option_is_global_and_host_commands_ignore_it(tmp_path, capsys):
    p = tcli._build_parser()
    assert p.parse_args(["--device", "cpu", "lint"]).device == "cpu"
    assert p.parse_args(["lint", "--device", "cpu"]).device == "cpu"
    assert p.parse_args(["obs", "record", "--device", "cpu"]).device == "cpu"
    assert not hasattr(p.parse_args(["lint"]), "device")
    assert p.parse_args(["obs", "cost", "show"]).variants == "plain"
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    # Host-only: no device resolved, so no CUDA needed.
    assert tcli.main(["lint", str(clean)]) == 0
    assert tcli.main(["--device", "cuda:7", "lint", str(clean)]) == 0
    capsys.readouterr()


def test_obs_record_writes_the_port_flight_on_the_named_device(tmp_path, capsys):
    out = tmp_path / "f.jsonl"
    assert CPU_CLI.main(["obs", "record", "--out", str(out), "--nodes", "32", "--rounds", "16",
                         "--churn"]) == 0
    facts = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"nodes": 32' in facts and '"kill_rounds": [4]' in facts
    assert thealth.report_from_flight(str(out)).rounds == 16

"""The port's ``analysis/`` (the lint plane) against the reference's, on
the CPU:

- every case of ``tests/test_analysis.py`` and ``tests/test_analysis_v2.py``
  run against the port's modules (``test_torch_core.run_against``), on the
  port's own tree: the module constant ``PKG`` and the ``repo_lint``
  fixture point at ``corrosion_tpu_torch/``, so the repo-wide cases read
  the port's engines, its ``SEAM_MAP.json`` and its suppressions; the
  sanitizer's cases run against a copy of the port's ``sanitize`` bound to
  the CPU, and the CLI's against the port's ``cli`` with ``--device cpu``;
- the torch forms of the purity rules (CT001/CT003/CT004/CT005), the
  host-only reading, the round-body scope, and torch's unseeded sources
  (CT060/CT061), each with a fixture that fires and one that does not;
- the sanitizer on the port's four engines at their tiny shapes on the
  CPU: no promotion, no NaN, no failure, and a tripwire that says it is
  blind where no kernel library is loaded; its dispatch mode's positive
  controls; the ledger's reading of an entry's own compile count.

Equality with the live reference (findings, flights, facts, cost entries,
help texts) is ``test_torch_cli_interop.py``.
"""

import os
import textwrap
import types

import pytest

import test_analysis as ref_analysis
import test_analysis_v2 as ref_analysis_v2
import corrosion_tpu_torch.analysis as tanalysis
from corrosion_tpu_torch.analysis import asynclint as tasynclint
from corrosion_tpu_torch.analysis import clonemap as tclonemap
from corrosion_tpu_torch.analysis import concurrency as tconcurrency
from corrosion_tpu_torch.analysis import determinism as tdeterminism
from corrosion_tpu_torch.analysis import findings as tfindings
from corrosion_tpu_torch.analysis import purity as tpurity
from corrosion_tpu_torch.analysis import runner as trunner
from corrosion_tpu_torch.analysis import sanitize as tsanitize
from corrosion_tpu_torch.analysis import schema as tschema
from corrosion_tpu_torch.analysis import source as tsource
from corrosion_tpu_torch.obs import ledger as tledger
from corrosion_tpu_torch.sim import telemetry as ttelemetry
from test_torch_agent_runtime import CPU_CLI
from test_torch_core import reference_cases, run_against
from test_torch_fidelity import on_cpu

PORT_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "corrosion_tpu_torch")

# The package first: ``run_against`` sets each module's attribute on the
# package object that ``sys.modules`` holds by then.
ANALYSIS_SWAPS = {
    "corrosion_tpu.analysis": tanalysis,
    "corrosion_tpu.analysis.asynclint": tasynclint,
    "corrosion_tpu.analysis.clonemap": tclonemap,
    "corrosion_tpu.analysis.concurrency": tconcurrency,
    "corrosion_tpu.analysis.determinism": tdeterminism,
    "corrosion_tpu.analysis.findings": tfindings,
    "corrosion_tpu.analysis.purity": tpurity,
    "corrosion_tpu.analysis.runner": trunner,
    "corrosion_tpu.analysis.sanitize": on_cpu(tsanitize, "sanitize_engines"),
    "corrosion_tpu.analysis.schema": tschema,
    "corrosion_tpu.analysis.source": tsource,
    "corrosion_tpu.cli": CPU_CLI,
    "corrosion_tpu.sim.telemetry": ttelemetry,
}
CASES = ([(ref_analysis, c) for c in reference_cases(ref_analysis)]
         + [(ref_analysis_v2, c) for c in reference_cases(ref_analysis_v2)])


@pytest.fixture(scope="module")
def repo_lint():
    """The reference module's fixture, on the port's tree."""
    return tanalysis.lint_paths([PORT_PKG])


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_analysis_cases_hold_on_the_port(module, case, repo_lint, tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setattr(module, "PKG", PORT_PKG)
    if hasattr(module, "RULES"):
        monkeypatch.setattr(module, "RULES", tfindings.RULES)
    run_against(module, case, ANALYSIS_SWAPS, monkeypatch, tmp_path=tmp_path, capsys=capsys,
                repo_lint=repo_lint)


def test_every_case_is_run():
    assert len(CASES) == 54


def test_the_swap_reaches_the_port(monkeypatch):
    import sys

    run_against(ref_analysis, "test_rule_registry_is_documented", ANALYSIS_SWAPS, monkeypatch)
    assert ref_analysis.lint_paths is trunner.lint_paths
    assert ref_analysis.extract_canonical is tschema.extract_canonical
    assert sys.modules["corrosion_tpu.analysis"].clonemap is tclonemap


def test_repo_lint_reads_the_ports_tree(repo_lint):
    """The port's lint of its own tree: clean, four engines, every
    suppression with its reason, the deliberate syncs among them."""
    assert repo_lint.ok and repo_lint.stale == []
    assert sorted(repo_lint.engines) == ["chunk_engine", "engine", "mixed_engine", "sparse_engine"]
    assert repo_lint.files >= 110
    where = {(os.path.relpath(f.path, PORT_PKG), f.rule) for f in repo_lint.suppressed}
    assert ("ops/gossip.py", "CT004") in where  # _branch
    assert ("ops/gossip.py", "CT001") in where  # _ok_rows, serial_merge_reference
    assert all(f.suppress_reason for f in repo_lint.suppressed)


def test_static_engine_key_sets_equal_the_runtime_round_curve_keys(repo_lint):
    assert set(repo_lint.canonical_keys) == set(ttelemetry.ROUND_CURVE_KEYS)
    union = set().union(*map(set, repo_lint.engines.values()))
    assert union == set(ttelemetry.ROUND_CURVE_KEYS)


def test_seam_map_is_the_ports_own_and_has_no_todo():
    path = tclonemap.default_seam_map_path()
    assert os.path.dirname(path) == os.path.join(PORT_PKG, "analysis")
    assert trunner.default_seam_root() == PORT_PKG
    smap = tclonemap.load_seam_map(path)
    assert "TODO" not in open(path).read()
    assert {p["name"] for p in smap["clones"]} == {
        "round-core-dense-sparse", "round-core-dense-mixed", "sim-driver-chunk-mixed"}
    refreshed, fresh = tclonemap.refresh_seams(smap, PORT_PKG)
    assert fresh == 0 and refreshed == smap


# -- the torch forms ---------------------------------------------------------


def _lint(tmp_path, source, name="snippet.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return tanalysis.lint_paths([str(p)])


def _rules(res):
    return sorted(f.rule for f in res.findings)


def test_torch_host_trips_coercions_and_branches_fire(tmp_path):
    res = _lint(tmp_path, """\
        # corro-lint: kernel-module
        import torch

        def step(x, n: int):
            a = x.cpu()
            b = x.numpy()
            c = x.tolist()
            d = torch.nonzero(x)
            e = int(x.sum())
            f = x.max().item()
            g = int(n)
            if x.any():
                x = x + 1
            while (x > 0).sum():
                x = x - 1
            if torch.equal(x, x):
                pass
            return torch.zeros((4,)), torch.tensor(1), torch.full((2,), 3, dtype=torch.int64)
    """)
    assert _rules(res) == ["CT001"] * 4 + ["CT003"] * 2 + ["CT004"] * 2 + ["CT005"] * 3


def test_torch_forms_stay_quiet_where_they_should(tmp_path):
    res = _lint(tmp_path, """\
        # corro-lint: kernel-module
        import numpy as np
        import torch

        def builder(sizes, seed):
            # host-only: numpy in, numpy out
            n = int(sum(sizes))
            rng = np.random.default_rng(seed)
            if rng.integers(0, 2, n).any():
                n += 1
            return np.arange(n).tolist()

        def counted(pred):
            return _branch(pred.any())

        def step(x, cfg):
            if _branch(x.any()) and cfg.flag:
                x = torch.where(x > 0, x, 0)
            if x.shape[0] == 0 or x.dtype == torch.bool or torch.is_tensor(cfg):
                pass
            return torch.zeros((4,), dtype=torch.int64)
    """)
    assert res.findings == []


def test_round_bodies_of_engine_modules_are_kernel_code(tmp_path):
    src = """\
        import torch
        from corrosion_tpu_torch.sim import telemetry as T

        def round_body(x):
            if x.any():
                x = x + 1
            return T.round_curves(msgs=x.sum())

        def driver(x):
            host = x.cpu().numpy()
            return host
    """
    res = _lint(tmp_path, src, name="sim/engine.py")
    assert [(f.rule, f.message.split(" in ")[1].split(" ")[0]) for f in res.findings] == [
        ("CT005", "round_body")]


def test_torch_global_rng_is_nondeterministic(tmp_path):
    res = _lint(tmp_path, """\
        # corro-lint: deterministic-module
        import torch

        def plan(n, gen):
            a = torch.rand(n)
            b = torch.randint(0, 4, (n,))
            c = torch.randperm(n, generator=gen)
            d = torch.randn(n, generator=gen)
            return a, b, c, d
    """)
    assert _rules(res) == ["CT061", "CT061"]
    assert all("torch, no generator=" in f.message for f in res.findings)
    res = _lint(tmp_path, """\
        # corro-lint: kernel-module
        import torch

        def step(x):
            return x + torch.randn(x.shape, dtype=torch.float32)
    """)
    assert _rules(res) == ["CT060"]


# -- the sanitizer -----------------------------------------------------------


def test_sanitizer_runs_the_four_engines_on_the_cpu():
    """Each engine twice, same shape, under the dispatch mode: no
    promotion, no NaN, no failure; no kernel library on the CPU, so the
    tripwire reports itself blind (CT030) rather than clean."""
    import torch

    torch.set_num_threads(2)
    findings = tsanitize.sanitize_engines(device="cpu")
    assert [(f.rule, f.path) for f in findings] == [
        ("CT030", f"<engine:{e}>") for e in tsanitize.ENGINES]
    assert all("watching nothing" in f.message for f in findings)
    assert set(tsanitize.LAST_RUN) == set(tsanitize.ENGINES)
    for rec in tsanitize.LAST_RUN.values():
        assert len(rec["seconds"]) == 2 and rec["builds"] == rec["loads"] == [0, 0]


def test_sanitizer_mode_raises_on_promotion_and_nan():
    import torch

    with tsanitize._sanitize_mode(True, True):
        a = torch.ones(3, dtype=torch.int64)
        with pytest.raises(tsanitize.TypePromotionError, match="aten.add"):
            a + torch.ones(3, dtype=torch.float32)
        with pytest.raises(FloatingPointError, match="aten.div"):
            torch.zeros(2) / torch.zeros(2)
        # Exempt: a bool condition, an int64 index, a 0-d scalar, a cast.
        assert torch.where(a > 0, a, a + 1).dtype == torch.int64
        assert torch.gather(a[None], 1, torch.tensor([[0]])).tolist() == [[1]]
        assert (a + torch.tensor(1.5)).dtype == torch.float32
        assert a.to(torch.float32).dtype == torch.float32


def test_sanitizer_classifies_a_promotion_as_ct031(monkeypatch):
    import torch

    def promoting():
        torch.ones(3, dtype=torch.int64) * torch.ones(3, dtype=torch.float32)

    monkeypatch.setitem(tsanitize._RUNNERS, "dense", promoting)
    findings = tsanitize.sanitize_engines(("dense",), device="cpu")
    assert [f.rule for f in findings] == ["CT031"]
    assert "aten.mul" in findings[0].message


def test_sanitizer_runners_take_no_argument_and_see_the_bound_device(monkeypatch):
    import torch

    seen = []

    class Fake:
        __name__ = "fake_engine"

        class scan:
            @staticmethod
            def _cache_size():
                return 1

    monkeypatch.setitem(tsanitize._RUNNERS, "chunk",
                        lambda: seen.append(tsanitize._DEVICE) or Fake)
    assert tsanitize.sanitize_engines(("chunk",), device="cpu") == []
    assert seen == [torch.device("cpu")] * 2 and tsanitize._DEVICE is None


def test_ledger_reads_an_entrys_own_compile_count():
    class Jitted:
        def __call__(self):
            pass

        def _cache_size(self):
            return 3

    mod = types.SimpleNamespace(scan=Jitted(), plain=lambda: None)
    fns = tledger.jitted_functions(mod)
    assert list(fns) == ["scan"]
    assert tledger.cache_sizes(fns) == {"scan": 3}
    led = tledger.CompileLedger()
    with led:
        with led.window("first"):
            pass
        with led.window("second"):
            import corrosion_tpu_torch.cuda_build as cb

            cb._notify("load", 0.01)
    ops = tledger.jitted_functions(types.ModuleType("engine"))
    sizes = tledger.cache_sizes(ops, led)
    assert set(sizes) == set(ops) and set(sizes.values()) == {1}  # not loaded + 1 reload

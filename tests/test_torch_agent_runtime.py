"""The reference's own tests of the agent runtime, run against the port.

``client``, ``agent/{pool,subs,backup,netem,agent,api,admin,testing}``
and the modules they import are swapped in for the reference's while
each case runs (``test_torch_core.run_against``): the cases launch the
port's agents on 127.0.0.1 and drive them through the port's client.

Covered: every case of ``test_agent_cluster``, ``test_agent_hardening``,
``test_sub_costs`` (its eight pure-dict cases run in
``test_torch_obs_rest.py``), ``test_pool_restore``, ``test_sync_serve``,
``test_sync_parallel``, ``test_transport_resilience`` and
``test_compaction``; ``test_trace_replay``'s end-to-end case with the
replay on the CPU; ``test_obs_timeline``'s two live-agent cases (the
second drives ``loadgen``'s fan-out storm); and the cases of
``test_ops_surface`` and ``test_observability`` that need no unported
module (``tpl`` and ``integrations.consul`` are ported). The cases that
do are named in ``WAITING``, with the module each waits for; they are
not collected.
``test_pgsql_lexer::test_normalize_sql_idempotent`` runs against the
port's ``subs`` in ``test_torch_pgsql.py``.
"""

import contextlib
import functools
import types

import pytest

import test_agent_cluster as ref_cluster
import test_agent_hardening as ref_hardening
import test_compaction as ref_compaction
import test_obs_timeline as ref_timeline
import test_observability as ref_observability
import test_ops_surface as ref_ops
import test_pool_restore as ref_pool
import test_sub_costs as ref_sub_costs
import test_sync_parallel as ref_sync_parallel
import test_sync_serve as ref_sync_serve
import test_trace_replay as ref_trace_replay
import test_transport_resilience as ref_transport
from corrosion_tpu_torch import client as tclient
from corrosion_tpu_torch import native as tnative
from corrosion_tpu_torch import tpl as ttpl
from corrosion_tpu_torch.agent import admin as tadmin
from corrosion_tpu_torch.agent import agent as tagent
from corrosion_tpu_torch.agent import api as tapi
from corrosion_tpu_torch.agent import backup as tbackup
from corrosion_tpu_torch.agent import config as tconfig
from corrosion_tpu_torch.agent import membership as tmembership
from corrosion_tpu_torch.agent import netem as tnetem
from corrosion_tpu_torch.agent import pg as tpg
from corrosion_tpu_torch.agent import pgsql as tpgsql
from corrosion_tpu_torch.agent import pool as tpool
from corrosion_tpu_torch.agent import store as tstore
from corrosion_tpu_torch.agent import subs as tsubs
from corrosion_tpu_torch.agent import testing as ttesting
from corrosion_tpu_torch.agent import transport as ttransport
from corrosion_tpu_torch.core import bookkeeping as tbook
from corrosion_tpu_torch.core import changes as tchanges
from corrosion_tpu_torch.core import hlc as thlc
from corrosion_tpu_torch.core import intervals as tiv
from corrosion_tpu_torch.core import values as tvalues
from corrosion_tpu_torch.integrations import consul as tconsul
from corrosion_tpu_torch.loadgen import harness as tharness
from corrosion_tpu_torch.loadgen import oracle as toracle
from corrosion_tpu_torch.loadgen import pgread as tpgread
from corrosion_tpu_torch.loadgen import report as treport
from corrosion_tpu_torch.loadgen import scenarios as tscenarios
from corrosion_tpu_torch.loadgen import schedule as tschedule
from corrosion_tpu_torch.obs import serving as tserving
from corrosion_tpu_torch.obs import timeline as ttimeline
from corrosion_tpu_torch.sim import health as thealth
from corrosion_tpu_torch.sim import telemetry as ttelemetry
from corrosion_tpu_torch.sim import trace as ttrace
from corrosion_tpu_torch.utils import backoff as tbackoff
from corrosion_tpu_torch.utils import locks as tlocks
from corrosion_tpu_torch.utils import logfmt as tlogfmt
from corrosion_tpu_torch.utils import metrics as tmetrics
from corrosion_tpu_torch.utils import spawn as tspawn
from corrosion_tpu_torch.utils import tracing as ttracing
from corrosion_tpu_torch.utils import tripwire as ttripwire
from test_torch_core import reference_cases, run_against

RUNTIME_SWAPS = {
    "corrosion_tpu.client": tclient,
    "corrosion_tpu.native": tnative,
    "corrosion_tpu.tpl": ttpl,
    "corrosion_tpu.agent.admin": tadmin,
    "corrosion_tpu.agent.agent": tagent,
    "corrosion_tpu.agent.api": tapi,
    "corrosion_tpu.agent.backup": tbackup,
    "corrosion_tpu.agent.config": tconfig,
    "corrosion_tpu.agent.membership": tmembership,
    "corrosion_tpu.agent.netem": tnetem,
    "corrosion_tpu.agent.pg": tpg,
    "corrosion_tpu.agent.pgsql": tpgsql,
    "corrosion_tpu.agent.pool": tpool,
    "corrosion_tpu.agent.store": tstore,
    "corrosion_tpu.agent.subs": tsubs,
    "corrosion_tpu.agent.testing": ttesting,
    "corrosion_tpu.agent.transport": ttransport,
    "corrosion_tpu.core.bookkeeping": tbook,
    "corrosion_tpu.core.changes": tchanges,
    "corrosion_tpu.core.hlc": thlc,
    "corrosion_tpu.core.intervals": tiv,
    "corrosion_tpu.core.values": tvalues,
    "corrosion_tpu.integrations.consul": tconsul,
    "corrosion_tpu.loadgen.harness": tharness,
    "corrosion_tpu.loadgen.oracle": toracle,
    "corrosion_tpu.loadgen.pgread": tpgread,
    "corrosion_tpu.loadgen.report": treport,
    "corrosion_tpu.loadgen.scenarios": tscenarios,
    "corrosion_tpu.loadgen.schedule": tschedule,
    "corrosion_tpu.obs.serving": tserving,
    "corrosion_tpu.obs.timeline": ttimeline,
    "corrosion_tpu.sim.health": thealth,
    "corrosion_tpu.sim.telemetry": ttelemetry,
    "corrosion_tpu.sim.trace": ttrace,
    "corrosion_tpu.utils.backoff": tbackoff,
    "corrosion_tpu.utils.locks": tlocks,
    "corrosion_tpu.utils.logfmt": tlogfmt,
    "corrosion_tpu.utils.metrics": tmetrics,
    "corrosion_tpu.utils.spawn": tspawn,
    "corrosion_tpu.utils.tracing": ttracing,
    "corrosion_tpu.utils.tripwire": ttripwire,
}

# Reference cases that need a module the port does not have yet, by the
# module each waits for. They are left out of the parametrisation.
WAITING = {
    ref_ops: {"test_cli_help_and_query_exec": "cli"},
    ref_observability: {"test_metric_names_match_docs": "obs.metrics_ref"},
    ref_timeline: {"test_obs_timeline_cli_from_run": "cli"},
}
# test_sub_costs' pure-dict cases, run against the port in
# test_torch_obs_rest.py.
SERVING_ELSEWHERE = (
    "test_heatmap_join_attribution_and_reconciliation",
    "test_heatmap_join_flags_mass_mismatch",
    "test_heatmap_refuses_run_without_ledger",
    "test_ledger_jsonl_roundtrip",
    "test_budget_gate_green_on_clean_measurement",
    "test_budget_gate_machinery_fired_rule",
    "test_budget_gate_absolute_rules",
    "test_baseline_diff_regression",
)
# The live-agent cases of test_obs_timeline; its synthetic cases run in
# test_torch_obs_rest.py.
TIMELINE_LIVE = ("test_default_agent_write_path_allocates_no_spans",
                 "test_traced_cluster_end_to_end_timeline")


def _cases(module, skip=()) -> list:
    waiting = WAITING.get(module, {})
    return [(module, c) for c in reference_cases(module)
            if c not in waiting and c not in skip]


WHOLE_FILES = (ref_cluster, ref_hardening, ref_pool, ref_sync_serve, ref_sync_parallel,
               ref_transport, ref_compaction, ref_ops, ref_observability)
CASES = (
    [mc for m in WHOLE_FILES for mc in _cases(m)]
    + _cases(ref_sub_costs, skip=SERVING_ELSEWHERE)
    + [(ref_timeline, c) for c in TIMELINE_LIVE]
)


class _PortCaplog:
    """``caplog`` whose ``at_level`` on a reference logger also sets the
    port's logger of the same module path (``corrosion_tpu_torch...``)."""

    def __init__(self, caplog):
        self._caplog = caplog

    def __getattr__(self, name):
        return getattr(self._caplog, name)

    @contextlib.contextmanager
    def at_level(self, level, logger=None):
        with contextlib.ExitStack() as stack:
            stack.enter_context(self._caplog.at_level(level, logger=logger))
            if logger and logger.startswith("corrosion_tpu."):
                port = "corrosion_tpu_torch." + logger.split(".", 1)[1]
                stack.enter_context(self._caplog.at_level(level, logger=port))
            yield


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's native codec and CRDT extension, as the reference's
    conftest builds the reference's."""
    tnative.build()


@pytest.mark.parametrize(
    "module,case", CASES, ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_runtime_cases_hold_on_the_port(module, case, tmp_path, caplog, capsys,
                                                  monkeypatch):
    run_against(module, case, RUNTIME_SWAPS, monkeypatch, tmp_path=tmp_path,
                caplog=_PortCaplog(caplog), capsys=capsys)


def test_trace_record_replay_end_to_end_on_the_port(tmp_path, monkeypatch):
    """test_trace_replay's end-to-end case: the port's agents recorded,
    the port's ``replay`` on the CPU."""
    trace_cpu = types.ModuleType("corrosion_tpu_torch.sim.trace")
    trace_cpu.__dict__.update(vars(ttrace))
    trace_cpu.replay = functools.partial(ttrace.replay, device="cpu")
    swaps = dict(RUNTIME_SWAPS, **{"corrosion_tpu.sim.trace": trace_cpu})
    run_against(ref_trace_replay, "test_trace_record_replay_end_to_end", swaps,
                monkeypatch, tmp_path=tmp_path)


def test_every_reference_case_is_run_or_waits():
    """Each whole file's cases are all parametrised here or named in
    ``WAITING``; test_sub_costs' rest runs in test_torch_obs_rest.py."""
    for m in WHOLE_FILES + (ref_sub_costs,):
        ran = {c for mm, c in CASES if mm is m}
        rest = set(SERVING_ELSEWHERE) if m is ref_sub_costs else set()
        assert ran | set(WAITING.get(m, {})) | rest == set(reference_cases(m)), m.__name__
    assert len([c for m, c in CASES if m is ref_cluster]) == 18
    assert set(ref_timeline.__dict__) >= set(TIMELINE_LIVE) | set(WAITING[ref_timeline])


def test_the_cases_launch_the_port(tmp_path, monkeypatch):
    """A swapped case starts the port's agents and none of the
    reference's."""
    from corrosion_tpu.agent import agent as jagent

    started = []
    port_start = tagent.Agent.start

    async def start(self):
        started.append(type(self))
        await port_start(self)

    async def refuse(self):
        raise AssertionError("the reference's agent was started")

    monkeypatch.setattr(tagent.Agent, "start", start)
    monkeypatch.setattr(jagent.Agent, "start", refuse)
    run_against(ref_cluster, "test_insert_rows_and_gossip", RUNTIME_SWAPS, monkeypatch,
                tmp_path=tmp_path)
    assert started == [tagent.Agent, tagent.Agent]

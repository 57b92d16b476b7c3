"""The port's PostgreSQL-to-SQLite lexer and translation
(``corrosion_tpu_torch/agent/pgsql.py``) against the reference's:

- the cases of ``tests/test_pgsql_lexer.py`` run against the port;
- every call those cases make (``translate``, ``split_statements``,
  ``tokenize``/``render``, the placeholder and catalog passes), recorded
  while they run on the reference, answered equally by the port.

``test_normalize_sql_idempotent`` calls ``agent/subs.normalize_sql``: it
runs with the port's ``subs`` swapped in as well, and the recorder does
not see its calls (``subs`` imports ``pgsql`` itself).
"""

import types

import pytest

import test_pgsql_lexer as ref_pgsql_tests
from corrosion_tpu.agent import pgsql as jpgsql
from corrosion_tpu_torch.agent import pgsql as tpgsql
from corrosion_tpu_torch.agent import subs as tsubs
from test_torch_core import reference_cases, run_against

SUBS_CASE = "test_normalize_sql_idempotent"
CASES = reference_cases(ref_pgsql_tests)
SWAPS = {"corrosion_tpu.agent.pgsql": tpgsql, "corrosion_tpu.agent.subs": tsubs}
FUNCTIONS = ("translate", "split_statements", "tokenize", "render",
             "translate_placeholders", "strip_catalog_prefix", "mentions_catalog")


@pytest.mark.parametrize("case", CASES)
def test_reference_lexer_cases_hold_on_the_port(case, monkeypatch):
    run_against(ref_pgsql_tests, case, SWAPS, monkeypatch)


def _recording(calls: list):
    """A stand-in for the reference module that records each call of
    ``FUNCTIONS`` with its arguments and the reference's answer."""
    spy = types.SimpleNamespace(**vars(jpgsql))
    for name in FUNCTIONS:
        def wrap(*args, _name=name):
            out = getattr(jpgsql, _name)(*args)
            calls.append((_name, args, out))
            return out
        setattr(spy, name, wrap)
    return spy


@pytest.mark.parametrize("case", [c for c in CASES if c != SUBS_CASE])
def test_every_call_of_the_case_answers_as_the_reference(case, monkeypatch):
    calls = []
    monkeypatch.setattr(ref_pgsql_tests, "pgsql", _recording(calls))
    getattr(ref_pgsql_tests, case)()
    assert calls, case
    for name, args, want in calls:
        if name == "render":
            args = (tpgsql.tokenize(jpgsql.render(*args)),)
        got = getattr(tpgsql, name)(*args)
        if name == "tokenize":
            got, want = ([(t.kind, t.text) for t in toks] for toks in (got, want))
        assert got == want, (name, args)


def test_the_lexer_cases_are_all_here():
    assert len(CASES) == 14 and SUBS_CASE in CASES

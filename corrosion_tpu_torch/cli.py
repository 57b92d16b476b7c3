"""corrosion CLI — the crates/corrosion binary's command surface.

Subcommands mirror corrosion/src/main.rs (Cli :447-513, Command :515-641):
agent, query, exec, backup, restore, sync generate, locks, cluster members,
reload, template. Run as `python -m corrosion_tpu_torch ...`. Commands
that run an engine take `--device` (default: CUDA, or an error when CUDA
is absent — never a silent CPU run); the host-only ones ignore it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys

from corrosion_tpu_torch.agent.config import Config, parse_addr, resolve_bootstrap


def _build_parser() -> argparse.ArgumentParser:
    # Global flags accepted before OR after the subcommand (the reference's
    # clap marks them global). SUPPRESS defaults keep a subparser's parse
    # from overwriting a value given before the subcommand.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--config", "-c", default=argparse.SUPPRESS, help="TOML config path"
    )
    common.add_argument(
        "--api-addr", default=argparse.SUPPRESS,
        help="host:port of the HTTP API",
    )
    common.add_argument(
        "--admin-path", default=argparse.SUPPRESS,
        help="admin unix socket path",
    )
    common.add_argument(
        "--device", default=argparse.SUPPRESS,
        help="torch device the engine-running commands use (default: "
        "cuda; host-only commands ignore it)",
    )
    p = argparse.ArgumentParser(
        prog="corrosion", description=__doc__, parents=[common]
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    add("agent", help="run the agent until interrupted")

    q = add("query", help="run a read-only SQL statement")
    q.add_argument("sql")
    q.add_argument("--columns", action="store_true")
    q.add_argument("--timer", action="store_true")

    e = add("exec", help="run write statements in a transaction")
    e.add_argument("sql", nargs="+")
    e.add_argument("--timer", action="store_true")

    b = add("backup", help="snapshot the db (VACUUM INTO + strip)")
    b.add_argument("out")
    b.add_argument("--db", required=True)

    r = add("restore", help="swap a backup into place")
    r.add_argument("backup")
    r.add_argument("--db", required=True)
    r.add_argument(
        "--self-actor-id", action="store_true",
        help="keep the backup's actor identity instead of assigning fresh",
    )
    r.add_argument(
        "--online", action="store_true",
        help="restore into a RUNNING agent via the admin socket (SQLite "
        "file locks held during the swap)",
    )

    s = add("sync", help="sync protocol utilities")
    s.add_argument("sync_cmd", choices=["generate"])

    lk = add("locks", help="show longest-held lock acquisitions")
    lk.add_argument("--top", type=int, default=10)

    cl = add("cluster", help="cluster introspection")
    cl.add_argument("cluster_cmd", choices=["members"])

    add("reload", help="re-apply schema paths from config")

    t = add("template", help="render templates (--watch to follow)")
    t.add_argument("files", nargs="+", help="TEMPLATE[:OUTPUT] specs")
    t.add_argument("--watch", action="store_true")

    cs = add("consul", help="consul bridge")
    cs.add_argument("consul_cmd", choices=["sync"])

    # Kernel convergence observability (sim/health.py): turn a flight
    # recording into a protocol-health verdict, follow one live, diff
    # two runs for regressions, or record a small demo flight.
    ob = add("obs", help="kernel convergence observability")
    ob_sub = ob.add_subparsers(dest="obs_cmd", required=True)

    orp = ob_sub.add_parser(
        "report", parents=[common],
        help="derive a convergence report from a flight JSONL",
    )
    orp.add_argument("flight", help="flight-recorder JSONL path")
    orp.add_argument("--round-ms", type=float, default=500.0)
    orp.add_argument("--kill-round", type=int, action="append",
                     default=None, help="ground-truth churn kill round "
                     "(repeatable; refines detection latency)")
    orp.add_argument("--json", action="store_true")

    otl = ob_sub.add_parser(
        "tail", parents=[common],
        help="stream a flight record's progress (live with --follow)",
    )
    otl.add_argument("flight")
    otl.add_argument("--follow", "-f", action="store_true",
                     help="keep polling for new records (tail -f)")
    otl.add_argument("--rounds", action="store_true",
                     help="print every round record, not chunk summaries")
    otl.add_argument("--poll", type=float, default=0.25)
    otl.add_argument("--idle-timeout", type=float, default=None,
                     help="stop following after this many idle seconds")

    odf = ob_sub.add_parser(
        "diff", parents=[common],
        help="flag convergence regressions between two runs",
    )
    odf.add_argument("baseline", help="flight JSONL or report JSON")
    odf.add_argument("candidate", help="flight JSONL or report JSON")
    odf.add_argument("--tolerance", type=float, default=0.2,
                     help="relative regression tolerance (default 0.2)")
    odf.add_argument("--round-ms", type=float, default=500.0)
    odf.add_argument("--json", action="store_true")

    orc = ob_sub.add_parser(
        "record", parents=[common],
        help="record a small-cluster demo flight (CI artifact source)",
    )
    orc.add_argument("--out", default="flight.jsonl")
    orc.add_argument("--nodes", type=int, default=128)
    orc.add_argument("--rounds", type=int, default=64)
    orc.add_argument("--churn", action="store_true")
    orc.add_argument("--seed", type=int, default=0)
    orc.add_argument("--geo", action="store_true",
                     help="WAN variant: 4 regions on the synthetic "
                     "circle geography with the propagation-topology "
                     "plane enabled (the `obs epidemic` source)")
    orc.add_argument("--adaptive", action="store_true",
                     help="enable the adaptive-dissemination plane at "
                     "the committed health.ADAPTIVE_GOSSIP tuning "
                     "(geo only; the EPIDEMIC_BASELINE_ADAPTIVE.json "
                     "source — docs/PERFORMANCE.md)")

    # Propagation-topology plane (corrosion_tpu_torch/obs/epidemic.py,
    # docs/OBSERVABILITY.md "Propagation plane"): SI-model fit over the
    # rumor-age coverage curve, traffic-matrix shares, redundancy, and
    # the EPIDEMIC_BASELINE diff gate.
    oep = ob_sub.add_parser(
        "epidemic", parents=[common],
        help="epidemic-model analyzer: fit/report/diff the "
        "corro-epidemic/1 propagation verdicts from a flight JSONL",
    )
    oep_sub = oep.add_subparsers(dest="epidemic_cmd", required=True)

    def _epi_common(p):
        p.add_argument("--fanout", type=int, default=4,
                       help="config fanout_near+fanout_far for the "
                       "push-gossip theory comparison (default 4)")
        p.add_argument("--nodes", type=int, default=None,
                       help="cluster size for the theoretical "
                       "half-coverage prediction")
        p.add_argument("--round-ms", type=float, default=500.0)
        p.add_argument("--geo-regions", type=int, default=None,
                       help="region count of the synthetic geo "
                       "geography (adds ring-resolved traffic shares)")

    oer = oep_sub.add_parser(
        "report", parents=[common],
        help="derive the corro-epidemic/1 report from a flight JSONL "
        "(exit 1 when the on-device accounting fails to reconcile)",
    )
    oer.add_argument("flight", help="flight-recorder JSONL path")
    _epi_common(oer)
    oer.add_argument("--oracle-records", default=None,
                     help="loadgen oracle delivery-records JSON: adds "
                     "the host-plane spread fit as a cross-validation "
                     "block (docs/FIDELITY.md)")
    oer.add_argument("--json", action="store_true")
    oer.add_argument("--out", default=None, help="report JSON path")

    oef = oep_sub.add_parser(
        "fit", parents=[common],
        help="print the SI/logit fit detail (per-bucket coverage "
        "points) for a flight JSONL",
    )
    oef.add_argument("flight")
    _epi_common(oef)
    oef.add_argument("--json", action="store_true")

    oed = oep_sub.add_parser(
        "diff", parents=[common],
        help="flag propagation regressions between two reports (or "
        "flights) — the EPIDEMIC_BASELINE CI gate",
    )
    oed.add_argument("baseline", help="flight JSONL or epidemic report")
    oed.add_argument("candidate", help="flight JSONL or epidemic report")
    oed.add_argument("--tolerance", type=float, default=0.25,
                     help="relative regression tolerance (default 0.25)")
    _epi_common(oed)
    oed.add_argument("--json", action="store_true")

    # Endurance plane (corrosion_tpu_torch/obs/series.py + obs/endurance.py,
    # docs/OBSERVABILITY.md "Endurance plane"): leak/wedge/stall/SLO
    # detectors over a recorded corro-metric-series/1 JSONL, and the
    # SOAK_BASELINE diff gate.
    osk = ob_sub.add_parser(
        "soak", parents=[common],
        help="endurance analyzer: leak/wedge/stall/SLO verdicts from a "
        "corro-metric-series/1 record, and the SOAK_BASELINE diff gate",
    )
    osk_sub = osk.add_subparsers(dest="soak_cmd", required=True)

    osr = osk_sub.add_parser(
        "report", parents=[common],
        help="derive the corro-endurance/1 verdict from a metric-series "
        "JSONL (exit 1 on any leak/wedge/stall/SLO breach)",
    )
    osr.add_argument("series", help="corro-metric-series/1 JSONL path")
    osr.add_argument("--t-scale-s", type=float, default=1.0,
                     help="seconds per sample-t unit (1.0 for wall-clock "
                     "series; kernel series record t in rounds)")
    osr.add_argument("--label", default="",
                     help="label stamped into the report")
    osr.add_argument("--wedge-min-span-s", type=float, default=5.0,
                     help="min flat-while-offered span to call a wedge")
    osr.add_argument("--leak-ceiling", action="append", default=None,
                     metavar="NAME=PER_HOUR",
                     help="override a leak-slope ceiling (repeatable)")
    osr.add_argument("--json", action="store_true")
    osr.add_argument("--out", default=None, help="report JSON path")

    osd = osk_sub.add_parser(
        "diff", parents=[common],
        help="flag endurance regressions between two soak reports — "
        "the SOAK_BASELINE.json CI gate",
    )
    osd.add_argument("baseline", help="soak/endurance report JSON")
    osd.add_argument("candidate", help="soak/endurance report JSON")
    osd.add_argument("--tolerance", type=float, default=0.5,
                     help="relative leak-slope tolerance (default 0.5); "
                     "new breaches are never tolerated")
    osd.add_argument("--json", action="store_true")

    # Serving query-cost plane (corrosion_tpu_torch/obs/serving.py,
    # docs/SERVING.md "Query-cost plane"): join a cost-armed storm's
    # per-subscription ledger with the fan-out oracle's delivery records
    # into the lag-vs-cost heatmap, and the SERVING_COST_BASELINE gate.
    osv = ob_sub.add_parser(
        "serving", parents=[common],
        help="serving query-cost analyzer: per-subscription lag-vs-cost "
        "attribution from a cost-armed loadgen run, and the "
        "SERVING_COST_BASELINE diff gate",
    )
    osv_sub = osv.add_subparsers(dest="serving_cmd", required=True)

    osvr = osv_sub.add_parser(
        "report", parents=[common],
        help="build the corro-serving-cost/1 heatmap report from a "
        "loadgen run emitted with --sub-costs (exit 1 when the ledger "
        "fails to reconcile against the oracle)",
    )
    osvr.add_argument("--from-run", required=True,
                      help="loadgen run report JSON produced with "
                      "sub_costs armed (reads run.sub_costs)")
    osvr.add_argument("--top", type=int, default=10,
                      help="top-K slow subscriptions to list")
    osvr.add_argument("--json", action="store_true")
    osvr.add_argument("--out", default=None, help="report JSON path")

    osvd = osv_sub.add_parser(
        "diff", parents=[common],
        help="flag serving-cost regressions between two "
        "corro-serving-cost/1 reports — the SERVING_COST_BASELINE.json "
        "CI gate",
    )
    osvd.add_argument("baseline", help="serving-cost report JSON")
    osvd.add_argument("candidate", help="serving-cost report JSON")
    osvd.add_argument("--tolerance", type=float, default=1.5,
                      help="multiplier on baseline eval/lag figures "
                      "(default 1.5)")
    osvd.add_argument("--floor-ms", type=float, default=5.0,
                      help="absolute floor under which deltas never "
                      "regress (loopback noise guard)")
    osvd.add_argument("--json", action="store_true")

    otm = ob_sub.add_parser(
        "timeline", parents=[common],
        help="correlate a traced loadgen run's spans + oracle delivery "
        "records (and optionally a kernel flight + write trace) into a "
        "corro-timeline/1 latency-budget artifact",
    )
    otm.add_argument("--from-run", default=None,
                     help="loadgen run report JSON produced with "
                     "--trace-dir (reads run.trace)")
    otm.add_argument("--spans", nargs="*", default=None,
                     help="span-export JSONL file(s) (with --records)")
    otm.add_argument("--records", default=None,
                     help="oracle delivery-records JSON (with --spans)")
    otm.add_argument("--sample", type=float, default=1.0,
                     help="trace sampling rate the run used (--spans "
                     "mode; --from-run reads it from the report)")
    otm.add_argument("--flight", default=None,
                     help="kernel flight JSONL for the write-journey "
                     "block (requires --trace)")
    otm.add_argument("--trace", default=None,
                     help="recorded write trace JSONL "
                     "(sim.trace.Trace.save; requires --flight)")
    otm.add_argument("--round-ms", type=float, default=500.0)
    otm.add_argument("--tolerance-ms", type=float, default=100.0,
                     help="stage-sum vs wall reconciliation tolerance")
    otm.add_argument("--min-coverage", type=float, default=0.99,
                     help="reconstructed/expected writes floor for "
                     "exit 0")
    otm.add_argument("--out", default=None)
    otm.add_argument("--json", action="store_true")

    # Device-cost observability plane (corrosion_tpu_torch/obs/costs.py,
    # docs/PERFORMANCE.md "Cost model & roofline"): the counted cost
    # model over every engine entry, the baseline diff gate, and the
    # memory capacity curve.
    oct_ = ob_sub.add_parser(
        "cost", parents=[common],
        help="device cost model: show/diff the corro-cost-model/1 "
        "artifact, derive the corro-capacity/1 memory curve",
    )
    oct_sub = oct_.add_subparsers(dest="cost_cmd", required=True)

    ocs = oct_sub.add_parser(
        "show", parents=[common],
        help="count every engine plane entry's operations and emit the "
        "corro-cost-model/1 artifact",
    )
    ocs.add_argument("--engines", default="dense,sparse,chunk,mixed")
    ocs.add_argument("--variants", default="plain")
    ocs.add_argument("--devices", default="1,8",
                     help="comma-separated device counts (positions of "
                     "a mesh on the --device card)")
    ocs.add_argument("--out", default=None,
                     help="artifact path (e.g. COST_BASELINE.json)")
    ocs.add_argument("--json", action="store_true")

    ocd = oct_sub.add_parser(
        "diff", parents=[common],
        help="rebuild the cost model at the baseline's dims and diff "
        "at tolerance — exit 1 on cost regressions",
    )
    ocd.add_argument("baseline", help="committed corro-cost-model/1 "
                     "JSON (COST_BASELINE.json)")
    ocd.add_argument("--tolerance", type=float, default=None,
                     help="relative-increase tolerance (default: the "
                     "baseline's, else 0.25)")
    ocd.add_argument("--out", default=None, help="diff report path")
    ocd.add_argument("--json", action="store_true")

    occ = oct_sub.add_parser(
        "capacity", parents=[common],
        help="predicted per-device memory curve (corro-capacity/1), "
        "validated against the measured 512-node point",
    )
    occ.add_argument("--nodes", default=None,
                     help="comma-separated node counts (default: the "
                     "100k..1M flagship grid)")
    occ.add_argument("--devices", type=int, default=8)
    occ.add_argument("--hbm-gib", type=float, default=None,
                     help="per-device memory budget (default: the card's "
                     "memory)")
    occ.add_argument("--no-validate", action="store_true",
                     help="skip the live 512-node validation point")
    occ.add_argument("--out", default=None)
    occ.add_argument("--json", action="store_true")

    # Bench trajectory (corrosion_tpu_torch/obs/trajectory.py): the committed
    # BENCH_r*/MULTICHIP_r* artifacts as one provenance-checked series.
    otj = ob_sub.add_parser(
        "trajectory", parents=[common],
        help="aggregate committed BENCH_r*/MULTICHIP_r* artifacts into "
        "a provenance-checked trajectory (refuses cross-platform/"
        "kernel deltas)",
    )
    otj.add_argument("--root", default=".",
                     help="directory holding the artifacts")
    otj.add_argument("--out", default=None)
    otj.add_argument("--json", action="store_true")

    # Chaos plane (sim/faults.py + sim/invariants.py, docs/CHAOS.md):
    # declarative fault injection, post-heal invariant checking, and a
    # seeded fuzzer that shrinks failing plans to minimal JSON repros.
    ch = add("chaos", help="fault injection + post-heal invariant suite")
    ch_sub = ch.add_subparsers(dest="chaos_cmd", required=True)

    cls_ = ch_sub.add_parser(
        "list", parents=[common], help="list the named fault scenarios"
    )
    cls_.add_argument("--rounds", type=int, default=64)

    crn = ch_sub.add_parser(
        "run", parents=[common],
        help="run a named scenario (or a fault-plan JSON) through the "
        "invariant suite",
    )
    crn.add_argument("scenario",
                     help="scenario name (chaos list) or plan JSON path")
    crn.add_argument("--engines", default="dense,sparse,chunk,mixed")
    crn.add_argument("--rounds", type=int, default=64,
                     help="run length for named scenarios")
    crn.add_argument("--seed", type=int, default=0)
    crn.add_argument("--json", action="store_true")

    cfz = ch_sub.add_parser(
        "fuzz", parents=[common],
        help="seeded random fault plans through the invariant suite, "
        "shrinking failures to minimal repros",
    )
    cfz.add_argument("--seed", type=int, default=0)
    cfz.add_argument("--plans", type=int, default=4)
    cfz.add_argument("--engines", default="dense,sparse,chunk,mixed")
    cfz.add_argument("--rounds", type=int, default=64)
    cfz.add_argument("--out", default=None,
                     help="directory for minimal-repro JSON artifacts")
    cfz.add_argument("--broken", action="store_true",
                     help="generate deliberately NON-healing plans (the "
                     "suite must fail and shrink them — chaos self-test)")
    cfz.add_argument("--no-wipe", action="store_true",
                     help="churn components use pause-resume only")
    cfz.add_argument("--shrink-evals", type=int, default=24)
    cfz.add_argument("--json", action="store_true")

    crp = ch_sub.add_parser(
        "replay", parents=[common],
        help="re-run a shrunk repro artifact's plan on its engine",
    )
    crp.add_argument("repro", help="chaos repro JSON path")

    # Host chaos plane (corrosion_tpu_torch/hostchaos + agent/netem.py,
    # docs/CHAOS.md "Host plane"): deterministic WAN impairment against
    # real agents, crash/restart scenarios, post-heal invariants, and
    # mechanical machinery-fired assertions.
    hc = add("hostchaos", help="host-plane chaos: WAN fault injection, "
             "crash/restart, machinery-fired proof")
    hc_sub = hc.add_subparsers(dest="hostchaos_cmd", required=True)

    hcl = hc_sub.add_parser(
        "list", parents=[common], help="list the standing host scenarios"
    )
    hcl.add_argument("--json", action="store_true")

    hcr = hc_sub.add_parser(
        "run", parents=[common],
        help="run a standing scenario (real loopback agents + netem + "
        "oracle + post-heal invariants); exit 1 on any failure",
    )
    hcr.add_argument("scenario", help="scenario name (hostchaos list)")
    hcr.add_argument("--seed", type=int, default=0)
    hcr.add_argument("--dir", default=None,
                     help="data dir (default: a fresh tempdir)")
    hcr.add_argument("--out", default=None, help="report JSON path")
    hcr.add_argument("--json", action="store_true")

    hcp = hc_sub.add_parser(
        "replay", parents=[common],
        help="verify a report's impairment schedule replays identically "
        "from its (plan, seed) — the determinism contract",
    )
    hcp.add_argument("report", help="hostchaos run report JSON path")

    # Elastic survival plane (corrosion_tpu_torch/elastic, docs/SCALING.md
    # "Elastic ops"): live mesh resharding + device-shard preemption,
    # convergence pinned bit-identical.
    el = add("elastic", help="elastic survival plane: live mesh reshard "
             "+ device-shard preemption, pinned bit-identical")
    el_sub = el.add_subparsers(dest="elastic_cmd", required=True)

    ell = el_sub.add_parser(
        "list", parents=[common], help="list the standing elastic drills"
    )
    ell.add_argument("--json", action="store_true")

    elr = el_sub.add_parser(
        "run", parents=[common],
        help="run one elastic drill (elastic list); exit 1 on any "
        "divergence, oracle violation, or idle recovery machinery",
    )
    elr.add_argument("scenario", help="drill name (elastic list)")
    elr.add_argument("--seed", type=int, default=0)
    elr.add_argument("--checkpoint-dir", default=None,
                     help="round-trip checkpoints through disk here "
                     "(default: in-memory only)")
    elr.add_argument("--out", default=None, help="report JSON path")
    elr.add_argument("--json", action="store_true")

    elm = el_sub.add_parser(
        "matrix", parents=[common],
        help="run the full dense reshard matrix "
        "(4→8, 8→4, 8→2, 1→8) plus one drill per "
        "other engine",
    )
    elm.add_argument("--seed", type=int, default=0)
    elm.add_argument("--out", default=None, help="report JSON path")
    elm.add_argument("--json", action="store_true")

    # Static-analysis plane (corrosion_tpu_torch/analysis, docs/ANALYSIS.md):
    # kernel-purity + schema-parity + concurrency lints, and the
    # strict-dtype/debug-nans/retrace sanitizer.
    ln = add("lint", help="static analysis: kernel purity, telemetry "
             "schema parity, lock discipline")
    ln.add_argument("paths", nargs="*", default=None,
                    help="files or trees to lint (default: the "
                    "corrosion_tpu_torch package)")
    ln.add_argument("--format", choices=["text", "json"], default="text")
    ln.add_argument("--rules", default=None,
                    help="comma-separated CT0xx ids to run (default all)")
    ln.add_argument("--sanitize", action="store_true",
                    help="also run tiny engine instances under strict "
                    "dtype promotion + debug_nans + retrace tripwire")
    ln.add_argument("--engines", default="dense,sparse,chunk,mixed",
                    help="engines for --sanitize")
    ln.add_argument("--no-static", action="store_true",
                    help="skip the static rules (with --sanitize: "
                    "sanitizer only)")
    ln.add_argument("--show-suppressed", action="store_true",
                    help="list reason-suppressed findings and stale "
                    "(CT009) suppressions in text output (JSON always "
                    "carries them)")
    ln.add_argument("--changed", nargs="?", const="HEAD~1", default=None,
                    metavar="REF",
                    help="lint only files changed vs a git ref "
                    "(default HEAD~1) — fast local/pre-push runs; exit "
                    "codes unchanged")
    ln.add_argument("--update-seams", action="store_true",
                    help="regenerate analysis/SEAM_MAP.json seam "
                    "fragments from the live engine diff (keeps whys of "
                    "seams that still match; fill in the TODO whys "
                    "before committing)")
    ln.add_argument("--list-rules", action="store_true")

    # Serving-plane load subsystem (corrosion_tpu_torch/loadgen, docs/SERVING.md):
    # open-loop load generation against a self-launched in-process agent
    # cluster, with the fan-out correctness oracle.
    lg = add("loadgen", help="serving-plane load generator + fan-out oracle")
    lg_sub = lg.add_subparsers(dest="loadgen_cmd", required=True)

    lgr = lg_sub.add_parser(
        "run", parents=[common],
        help="subscription fan-out storm + sustained write storm "
        "(oracle-checked)",
    )
    lgr.add_argument("--subs", type=int, default=2000)
    lgr.add_argument("--sub-groups", type=int, default=4)
    lgr.add_argument("--writes", type=int, default=80)
    lgr.add_argument("--write-rate", type=float, default=10.0,
                     help="open-loop write arrivals/s (each commit fans "
                     "out to subs/groups streams — size rate x subs to "
                     "the harness host)")
    lgr.add_argument("--read-rate", type=float, default=20.0)
    lgr.add_argument("--pg-rate", type=float, default=10.0)
    lgr.add_argument("--agents", type=int, default=1)
    lgr.add_argument("--drain-timeout", type=float, default=30.0)
    lgr.add_argument("--dir", default=None,
                     help="data dir (default: a fresh tempdir)")
    lgr.add_argument("--out", default=None, help="report JSON path")
    lgr.add_argument("--trace-dir", default=None,
                     help="enable causal write tracing; span exports + "
                     "oracle delivery records land here and the report "
                     "gains the run.trace block `obs timeline` consumes")
    lgr.add_argument("--trace-sample", type=float, default=1.0,
                     help="trace-id-keyed sampling rate for traced runs")

    lgs = lg_sub.add_parser(
        "sweep", parents=[common],
        help="saturation sweep: ramp arrivals past api_concurrency, "
        "verify 503 shed + bounded admitted p99",
    )
    lgs.add_argument("--rates", default="50,200,400",
                     help="comma-separated stage arrival rates (Hz)")
    lgs.add_argument("--stage-duration", type=float, default=2.0)
    lgs.add_argument("--api-concurrency", type=int, default=4)
    lgs.add_argument("--burst", type=int, default=16,
                     help="top-stage arrivals packed per instant "
                     "(> api_concurrency forces shed engagement)")
    lgs.add_argument("--bounded-p99-ms", type=float, default=5000.0)
    lgs.add_argument("--dir", default=None)
    lgs.add_argument("--out", default=None)

    lgk = lg_sub.add_parser(
        "soak", parents=[common],
        help="intake-policy soak: measure the docs/SCALING.md "
        "rebroadcast_intake collapse rule on the kernel plane",
    )
    lgk.add_argument("--nodes", type=int, default=96)
    lgk.add_argument("--rounds", type=int, default=72)
    lgk.add_argument("--write-prob", type=float, default=0.08)
    lgk.add_argument("--intake-margin", type=int, default=8)
    lgk.add_argument("--starved-intake", type=int, default=1)
    lgk.add_argument("--seed", type=int, default=0)
    lgk.add_argument("--out", default=None)
    lgk.add_argument(
        "--series-out", default=None,
        help="keep the corro-metric-series/1 process record at this "
        "path (feedable to `obs soak report`)",
    )

    # Fidelity plane (corrosion_tpu_torch/fidelity, docs/FIDELITY.md): the
    # calibrated round-length model and the mixed-mode live-vs-kernel
    # divergence measurement.
    fd = add("fidelity", help="calibrated round model + live-vs-kernel "
             "divergence measurement")
    fd_sub = fd.add_subparsers(dest="fidelity_cmd", required=True)

    fdc = fd_sub.add_parser(
        "calibrate", parents=[common],
        help="derive a corro-round-model/1 JSON from a live loopback "
        "cluster (or a transport-characterization artifact)",
    )
    fdc.add_argument("--out", default="round_model.json")
    fdc.add_argument("--agents", type=int, default=3)
    fdc.add_argument("--probes", type=int, default=40,
                     help="SWIM probe samples per directed agent pair")
    fdc.add_argument("--dir", default=None,
                     help="data dir (default: a fresh tempdir)")
    fdc.add_argument("--from-characterization", default=None,
                     help="derive from a transport_characterization JSON "
                     "artifact instead of launching agents")
    fdc.add_argument("--flush-ms", type=float, default=None,
                     help="broadcast flush tick for "
                     "--from-characterization (default: the reference's "
                     "500 ms)")

    fdm = fd_sub.add_parser(
        "compare", parents=[common],
        help="run the standing scenarios live AND as kernel replays; "
        "report calibrated-vs-uncalibrated divergence",
    )
    fdm.add_argument("--scenario", default="all",
                     choices=["steady", "burst", "dcn", "all"])
    fdm.add_argument("--agents", type=int, default=3)
    fdm.add_argument("--writes", type=int, default=24)
    fdm.add_argument("--dcn-rounds", type=int, default=64)
    fdm.add_argument("--model", default=None,
                     help="pre-built round-model JSON for the MIXED-MODE "
                     "scenarios (steady/burst; default: calibrate inline "
                     "on the launched cluster). The dcn scenario always "
                     "uses the synthetic WAN ring model — loopback "
                     "calibrations have no WAN geography to offer it")
    fdm.add_argument("--seed", type=int, default=0)
    fdm.add_argument("--dir", default=None)
    fdm.add_argument("--out", default=None, help="report JSON path")

    fdr = fd_sub.add_parser(
        "replay", parents=[common],
        help="replay a saved trace JSONL through the kernel under a "
        "round model",
    )
    fdr.add_argument("trace", help="trace JSONL (sim.trace.Trace.save)")
    fdr.add_argument("--model", default=None,
                     help="round-model JSON (default: the uncalibrated "
                     "500 ms identity)")
    fdr.add_argument("--observers", type=int, default=0)
    fdr.add_argument("--seed", type=int, default=0)
    fdr.add_argument("--json", action="store_true")

    # command/tls.rs:1-94: `corrosion tls {ca,server,client} generate`
    tl = add("tls", help="certificate generation")
    tl.add_argument("tls_kind", choices=["ca", "server", "client"])
    tl.add_argument("tls_cmd", choices=["generate"])
    tl.add_argument("host", nargs="?", default=None,
                    help="server SAN host (server generate)")
    tl.add_argument("--dir", default=".", help="output directory")
    tl.add_argument("--ca-dir", default=".",
                    help="directory holding ca_cert.pem/ca_key.pem")
    return p


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    config_path = getattr(args, "config", None)
    cfg = Config.load(config_path) if config_path else Config.load()
    if getattr(args, "api_addr", None):
        cfg.api.addr = args.api_addr
    if getattr(args, "admin_path", None):
        cfg.admin.uds_path = args.admin_path
    try:
        return asyncio.run(_dispatch(args, cfg)) or 0
    except BrokenPipeError:
        return 0  # stdout closed early (e.g. piped into head)


def _device(args):
    """The device of an engine-running command: ``--device``, else CUDA;
    raises when CUDA is absent and no device was given."""
    from corrosion_tpu_torch import resolve_device

    return resolve_device(getattr(args, "device", None))


async def _dispatch(args, cfg: Config) -> int:
    if args.command == "lint":
        return _lint(args)
    if args.command == "obs":
        return _obs(args)
    if args.command == "chaos":
        return _chaos(args)
    if args.command == "hostchaos":
        return await _hostchaos(args)
    if args.command == "elastic":
        return _elastic(args)
    if args.command == "loadgen":
        return await _loadgen(args)
    if args.command == "fidelity":
        return await _fidelity(args)
    if args.command == "agent":
        return await _run_agent(cfg)
    if args.command == "query":
        return await _query(args, cfg)
    if args.command == "exec":
        return await _exec(args, cfg)
    if args.command == "backup":
        from corrosion_tpu_torch.agent.backup import backup

        backup(args.db, args.out)
        print(f"backed up {args.db} -> {args.out}")
        return 0
    if args.command == "restore":
        if args.online:
            frames = await _admin(
                cfg,
                {"c": "restore", "path": os.path.abspath(args.backup),
                 "self_actor_id": args.self_actor_id},
            )
            print(f"restored online (actor {frames[0]['actor_id']})")
            return 0
        from corrosion_tpu_torch.agent.backup import restore

        site = restore(args.backup, args.db, self_actor_id=args.self_actor_id)
        print(f"restored {args.db} (actor {site.hex()})")
        return 0
    if args.command == "tls":
        from corrosion_tpu_torch.agent import tls as tls_mod

        if args.tls_kind == "ca":
            paths = tls_mod.generate_ca(args.dir)
        elif args.tls_kind == "server":
            if not args.host:
                print("tls server generate requires a host", file=sys.stderr)
                return 2
            paths = tls_mod.generate_server_cert(
                args.dir, args.ca_dir, args.host
            )
        else:
            paths = tls_mod.generate_client_cert(args.dir, args.ca_dir)
        print(f"wrote {paths.cert} and {paths.key}")
        return 0
    if args.command == "sync":
        frames = await _admin(cfg, {"c": "sync"})
        print(json.dumps(frames[0], indent=2))
        return 0
    if args.command == "locks":
        frames = await _admin(cfg, {"c": "locks", "top": args.top})
        print(json.dumps(frames[0]["locks"], indent=2))
        return 0
    if args.command == "cluster":
        frames = await _admin(cfg, {"c": "cluster"})
        print(json.dumps(frames[0]["members"], indent=2))
        return 0
    if args.command == "reload":
        frames = await _admin(
            cfg, {"c": "reload", "schema_sql": cfg.schema_sql()}
        )
        print(json.dumps(frames[0], indent=2))
        return 0
    if args.command == "template":
        from corrosion_tpu_torch.tpl import run_templates

        await run_templates(args.files, cfg, watch=args.watch)
        return 0
    if args.command == "consul":
        from corrosion_tpu_torch.integrations.consul import run_consul_sync

        await run_consul_sync(cfg)
        return 0
    return 2


async def _hostchaos(args) -> int:
    """`corrosion hostchaos {list,run,replay}` — the host chaos plane
    (docs/CHAOS.md "Host plane"). Exit 0 = green, 1 = a failed
    invariant / idle machinery / schedule mismatch."""
    import tempfile

    from corrosion_tpu_torch.hostchaos import SCENARIOS, get_scenario, run_scenario
    from corrosion_tpu_torch.hostchaos.harness import verify_schedule_determinism

    if args.hostchaos_cmd == "list":
        if args.json:
            print(json.dumps({
                name: {
                    "summary": SCENARIOS[name]().summary(),
                    "notes": SCENARIOS[name]().notes,
                }
                for name in sorted(SCENARIOS)
            }, indent=2))
            return 0
        for name in sorted(SCENARIOS):
            spec = SCENARIOS[name]()
            print(f"{name:16s} {spec.summary()}")
            print(f"{'':16s}   {spec.notes}")
        return 0

    if args.hostchaos_cmd == "run":
        try:
            spec = get_scenario(args.scenario)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        if args.dir:
            report = await run_scenario(
                spec, args.dir, seed=args.seed, progress=sys.stderr
            )
        else:
            with tempfile.TemporaryDirectory() as tmp:
                report = await run_scenario(
                    spec, tmp, seed=args.seed, progress=sys.stderr
                )
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
            print(f"wrote {args.out}", file=sys.stderr)
        if args.json:
            slim = dict(report)
            if slim.get("netem"):
                slim["netem"] = {
                    "seed": slim["netem"]["seed"],
                    "agents": {
                        k: {kk: vv for kk, vv in v.items() if kk != "trace"}
                        for k, v in slim["netem"]["agents"].items()
                    },
                }
            print(json.dumps(slim, indent=1))
        else:
            print(
                f"{report['scenario']}: "
                f"{'OK' if report['ok'] else 'FAILED'} — "
                f"oracle violations={report['oracle']['violations']}, "
                f"converged={report['converged']}, "
                f"machinery={report['machinery']}"
            )
            for f_ in report["failures"]:
                print(f"  FAIL: {f_}")
        return 0 if report["ok"] else 1

    if args.hostchaos_cmd == "replay":
        with open(args.report) as f:
            report = json.load(f)
        ok, problems = verify_schedule_determinism(report)
        if ok:
            agents = sorted((report.get("netem") or {})
                            .get("agents", {}))
            print(
                f"schedule replay OK: seed {report.get('seed')} "
                f"reproduces every recorded decision on {agents}"
            )
            return 0
        print("schedule replay MISMATCH:", file=sys.stderr)
        for p in problems:
            print(f"  {p}", file=sys.stderr)
        return 1
    return 2


def _elastic(args) -> int:
    """`corrosion elastic {list,run,matrix}` — the elastic survival
    plane (docs/SCALING.md "Elastic ops"). Exit 0 = every drill pinned
    bit-identical with its oracles green, 1 = divergence / oracle
    violation / idle recovery machinery, 2 = usage."""
    from corrosion_tpu_torch.elastic import scenarios as el_scenarios

    def _summary(rep: dict) -> str:
        extra = ""
        if rep.get("machinery") is not None:
            m = rep["machinery"]
            extra = (
                f", machinery fired={m['fired']} "
                f"(replayed {m['gap_rounds_replayed']} rounds)"
            )
        return (
            f"{rep['scenario']}: {'OK' if rep['ok'] else 'FAILED'} — "
            f"bit_identical={rep['bit_identical']}, "
            f"reconcile={'ok' if (rep.get('reconcile') or {}).get('ok') else 'FAILED'}, "
            f"violations={len(rep.get('violations') or [])}{extra}"
        )

    if args.elastic_cmd == "list":
        names = el_scenarios.scenario_names()
        if args.json:
            print(json.dumps(names, indent=1))
        else:
            for n in names:
                print(n)
        return 0

    if args.elastic_cmd == "run":
        try:
            rep = el_scenarios.run_scenario(
                args.scenario, seed=args.seed,
                checkpoint_dir=args.checkpoint_dir, device=_device(args),
            )
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=1, default=str)
            print(f"wrote {args.out}", file=sys.stderr)
        if args.json:
            print(json.dumps(rep, indent=1, default=str))
        else:
            print(_summary(rep))
            for m in rep.get("mismatches") or []:
                print(f"  DIVERGED: {m}")
            for v in rep.get("violations") or []:
                print(f"  FAIL: {v}")
        return 0 if rep["ok"] else 1

    if args.elastic_cmd == "matrix":
        dev = _device(args)
        reps = []
        for a, b in el_scenarios.RESHARD_MATRIX:
            reps.append(el_scenarios.run_reshard_scenario(
                "dense", a, b, seed=args.seed, device=dev
            ))
        for eng in el_scenarios.RESHARD_ENGINES:
            if eng != "dense":
                reps.append(el_scenarios.run_reshard_scenario(
                    eng, 4, 8, seed=args.seed, device=dev
                ))
        out = {
            "schema": el_scenarios.ELASTIC_SCHEMA,
            "kind": "matrix",
            "scenarios": reps,
            "ok": all(r["ok"] for r in reps),
        }
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1, default=str)
            print(f"wrote {args.out}", file=sys.stderr)
        if args.json:
            print(json.dumps(out, indent=1, default=str))
        else:
            for r in reps:
                print(_summary(r))
        return 0 if out["ok"] else 1
    return 2


def _lint(args) -> int:
    """`corrosion lint [paths] [--sanitize]` — the static-analysis plane
    (corrosion_tpu_torch/analysis, rules in docs/ANALYSIS.md). Pure lint never
    imports torch; --sanitize pulls in the engines lazily. Exit 0 = clean,
    1 = findings, 2 = usage."""
    from corrosion_tpu_torch.analysis import RULES, lint_paths
    from corrosion_tpu_torch.analysis.findings import LintResult

    if args.list_rules:
        for rid, (title, why) in sorted(RULES.items()):
            print(f"{rid}  {title}: {why}")
        return 0
    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(RULES)
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2
    if args.update_seams:
        from corrosion_tpu_torch.analysis import clonemap
        from corrosion_tpu_torch.analysis.runner import default_seam_root

        map_path = clonemap.default_seam_map_path()
        try:
            smap = clonemap.load_seam_map(map_path)
        except (OSError, ValueError) as e:
            print(f"seam map: {e}", file=sys.stderr)
            return 2
        refreshed, fresh = clonemap.refresh_seams(smap, default_seam_root())
        clonemap.save_seam_map(refreshed, map_path)
        print(f"{map_path}: seams regenerated, {fresh} new seam(s) need "
              "a why filled in" if fresh else
              f"{map_path}: seams regenerated, all declared whys kept")
        return 0
    paths = args.paths or [os.path.dirname(os.path.abspath(__file__))]
    only = None
    if args.changed is not None:
        from corrosion_tpu_torch.analysis.runner import changed_files

        try:
            only = changed_files(args.changed, cwd=paths[0]
                                 if os.path.isdir(paths[0]) else None)
        except RuntimeError as e:
            print(f"--changed: {e}", file=sys.stderr)
            return 2
    if args.no_static:
        result = LintResult()
    else:
        result = lint_paths(paths, rules=rules, only=only)
    if args.sanitize:
        from corrosion_tpu_torch.analysis.sanitize import ENGINES, sanitize_engines

        engines = tuple(
            e.strip() for e in args.engines.split(",") if e.strip()
        )
        unknown = set(engines) - set(ENGINES)
        if unknown:
            print(f"unknown engine(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        result.findings.extend(sanitize_engines(engines, device=_device(args)))
    if args.format == "json":
        print(result.to_json())
    else:
        print(result.render_text(show_suppressed=args.show_suppressed))
    return 0 if result.ok else 1


def _chaos(args) -> int:
    """`corrosion chaos {list,run,fuzz,replay}` — the chaos plane's CLI
    (docs/CHAOS.md). Exit 0 = every invariant held, 1 = violations (a
    shrunk repro is written/printed), 2 = usage."""
    from corrosion_tpu_torch.sim import faults as faults_mod
    from corrosion_tpu_torch.sim import invariants as inv

    if args.chaos_cmd == "list":
        try:
            plans = faults_mod.named_scenarios(
                args.rounds, inv.STD_REGIONS, inv.STD_NODES,
                protect=inv.PROTECTED,
            )
        except ValueError as e:
            print(f"chaos list: {e}", file=sys.stderr)
            return 2
        for name in sorted(plans):
            print(f"{name:18} {plans[name].describe()}")
        return 0

    if args.chaos_cmd in ("run", "fuzz"):
        engines = tuple(
            e.strip() for e in args.engines.split(",") if e.strip()
        )
        unknown = set(engines) - set(inv.ENGINES)
        if unknown:
            print(f"unknown engine(s): {sorted(unknown)}", file=sys.stderr)
            return 2

    if args.chaos_cmd == "run":
        # Bad inputs are usage errors (exit 2), not tracebacks: a
        # malformed plan file, a plan exceeding the standard scenario's
        # shape, or rounds the scenario catalog rejects.
        try:
            if os.path.exists(args.scenario):
                with open(args.scenario) as f:
                    d = json.load(f)
                # A repro artifact carries its plan; a plan file IS one.
                plan = faults_mod.FaultPlan.from_dict(d.get("plan", d))
            else:
                plans = faults_mod.named_scenarios(
                    args.rounds, inv.STD_REGIONS, inv.STD_NODES,
                    protect=inv.PROTECTED,
                )
                if args.scenario not in plans:
                    print(
                        f"unknown scenario {args.scenario!r}; `chaos list` "
                        f"names them", file=sys.stderr,
                    )
                    return 2
                plan = plans[args.scenario]
            if plan.max_region() >= inv.STD_REGIONS:
                raise ValueError(
                    f"plan references region {plan.max_region()} but the "
                    f"standard scenario has {inv.STD_REGIONS} regions"
                )
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            print(f"chaos run: invalid plan/scenario: {e!r}", file=sys.stderr)
            return 2
        reports = inv.run_suite(
            plan, engines, seed=args.seed, progress=sys.stderr,
            device=_device(args),
        )
        if args.json:
            print(json.dumps([r.to_dict() for r in reports]))
        else:
            for r in reports:
                print(r.render())
        return 0 if all(r.ok for r in reports) else 1

    if args.chaos_cmd == "fuzz":
        out = inv.fuzz(
            seed=args.seed, plans=args.plans, engines=engines,
            rounds=args.rounds, out_dir=args.out,
            break_heal=args.broken, allow_wipe=not args.no_wipe,
            shrink_evals=args.shrink_evals, progress=sys.stderr,
            device=_device(args),
        )
        if args.json:
            print(json.dumps(out))
        else:
            for i, entry in enumerate(out["plans"]):
                mark = "ok" if entry["ok"] else "FAIL"
                print(f"plan {i}: [{mark}] {entry['describe']}")
                if not entry["ok"]:
                    repro = entry.get("repro", {})
                    mini = faults_mod.FaultPlan.from_dict(
                        repro.get("plan", entry["plan"])
                    )
                    print(f"  shrunk repro: {mini.describe()}")
                    for v in repro.get("violations", []):
                        print(f"  violation: {v}")
                    if "repro_path" in entry:
                        print(f"  artifact: {entry['repro_path']}")
            print(
                f"{args.plans - out['failures']}/{args.plans} plans passed "
                f"on engines {','.join(engines)}"
            )
        return 1 if out["failures"] else 0

    if args.chaos_cmd == "replay":
        try:
            rep = inv.replay_repro(
                args.repro, progress=sys.stderr, device=_device(args)
            )
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            print(f"chaos replay: {e!r}", file=sys.stderr)
            return 2
        print(rep.render())
        return 0 if rep.ok else 1
    return 2


async def _loadgen(args) -> int:
    """`corrosion loadgen {run,sweep,soak}` — the serving-plane load
    subsystem (docs/SERVING.md). Every report funnels through the
    self-describing emit path; exit 0 = the scenario's promise held
    (zero oracle violations / shed engaged + p99 bounded / collapse
    rule demonstrated), 1 = it did not."""
    import tempfile

    from corrosion_tpu_torch.loadgen import scenarios
    from corrosion_tpu_torch.loadgen.report import (
        emit_serving_report, serving_context,
    )

    def emit(report: dict, ok: bool) -> int:
        emit_serving_report(report)
        out = json.dumps(report, indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        print(out)
        return 0 if ok else 1

    dev = _device(args)
    if args.loadgen_cmd == "run":
        with tempfile.TemporaryDirectory() as tmp:
            run = await scenarios.fanout_storm(
                args.dir or tmp,
                subs=args.subs, sub_groups=args.sub_groups,
                writes=args.writes, write_rate=args.write_rate,
                read_rate=args.read_rate, pg_rate=args.pg_rate,
                n_agents=args.agents, drain_timeout_s=args.drain_timeout,
                trace_dir=args.trace_dir,
                trace_sample=args.trace_sample,
                progress=sys.stderr,
            )
        report = {
            **serving_context(
                "fanout_storm", args.agents, args.subs, args.writes,
                args.write_rate, device=dev,
            ),
            "subs": args.subs,
            "run": run,
        }
        # Zero violations is vacuous if nothing committed or delivered:
        # a fully broken write path must not exit 0.
        ok = (
            run["oracle"]["violations"] == 0
            and run["oracle"]["commits"] > 0
            and run["oracle"]["delivered_changes"]
            + run["oracle"]["delivered_snapshot"] > 0
        )
        return emit(report, ok)

    if args.loadgen_cmd == "sweep":
        rates = tuple(
            float(r) for r in args.rates.split(",") if r.strip()
        )
        with tempfile.TemporaryDirectory() as tmp:
            sweep = await scenarios.saturation_sweep(
                args.dir or tmp,
                api_concurrency=args.api_concurrency, rates=rates,
                stage_duration_s=args.stage_duration, burst=args.burst,
                bounded_p99_ms=args.bounded_p99_ms, progress=sys.stderr,
            )
        report = {
            **serving_context(
                "saturation_sweep", 1, args.api_concurrency, rates,
                args.burst, device=dev,
            ),
            "sweep": sweep,
        }
        ok = (
            sweep["shed_engaged"]
            and sweep["admitted_p99_bounded"]
            and sweep["shed_accounting_consistent"]
        )
        return emit(report, ok)

    if args.loadgen_cmd == "soak":
        soak = scenarios.intake_policy(
            nodes=args.nodes, rounds=args.rounds,
            write_prob=args.write_prob,
            intake_margin=args.intake_margin,
            starved_intake=args.starved_intake, seed=args.seed,
            progress=sys.stderr, series_path=args.series_out, device=dev,
        )
        report = {
            **serving_context(
                "intake_policy", args.nodes, args.rounds,
                args.write_prob, args.seed, device=dev,
            ),
            "soak": soak,
        }
        return emit(report, soak["collapse_rule_holds"])
    return 2


async def _fidelity(args) -> int:
    """`corrosion fidelity {calibrate,compare,replay}` — the fidelity
    plane's CLI (docs/FIDELITY.md). `compare` exits 0 iff every
    mixed-mode scenario's calibrated replay lands strictly closer to the
    live CDF than the uncalibrated one AND the DCN invariant cross-check
    holds; 1 otherwise; 2 = usage."""
    import tempfile

    from corrosion_tpu_torch.fidelity.calibrate import (
        REFERENCE_ROUND_MS, RoundModel, calibrate_live,
        from_characterization,
    )

    if args.fidelity_cmd == "calibrate":
        if args.from_characterization:
            try:
                with open(args.from_characterization) as f:
                    char = json.load(f)
                model = from_characterization(
                    char,
                    # `is None`, not `or`: an explicit --flush-ms 0 must
                    # reach derive_model's loud positivity check, never
                    # silently become the 500 ms default.
                    flush_ms=(
                        args.flush_ms if args.flush_ms is not None
                        else REFERENCE_ROUND_MS
                    ),
                )
            except (OSError, ValueError, json.JSONDecodeError) as e:
                print(f"fidelity calibrate: {e!r}", file=sys.stderr)
                return 2
        else:
            if args.flush_ms is not None:
                print(
                    "fidelity calibrate: --flush-ms only applies with "
                    "--from-characterization (live calibration reads the "
                    "launched agents' configured tick)", file=sys.stderr,
                )
                return 2
            from corrosion_tpu_torch.agent.testing import (
                launch_test_cluster, stop_cluster,
            )

            with tempfile.TemporaryDirectory() as tmp:
                agents = await launch_test_cluster(
                    args.dir or tmp, args.agents
                )
                try:
                    model = await calibrate_live(agents, probes=args.probes)
                finally:
                    await stop_cluster(agents)
        model.save(args.out)
        print(f"wrote {args.out}: {model.describe()}")
        return 0

    if args.fidelity_cmd == "compare":
        from corrosion_tpu_torch.fidelity import scenarios as fid_scenarios
        from corrosion_tpu_torch.fidelity.report import emit_fidelity_report

        try:
            model = RoundModel.load(args.model) if args.model else None
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"fidelity compare: bad --model: {e!r}", file=sys.stderr)
            return 2
        dev = _device(args)
        out: dict = {"scenarios": {}}
        with tempfile.TemporaryDirectory() as tmp:
            base = args.dir or tmp
            if args.scenario in ("steady", "all"):
                out["scenarios"]["steady"] = await fid_scenarios.steady_load(
                    base, writes=args.writes, n_agents=args.agents,
                    model=model, seed=args.seed, progress=sys.stderr,
                    device=dev,
                )
            if args.scenario in ("burst", "all"):
                out["scenarios"]["burst"] = await fid_scenarios.burst_drain(
                    base, writes=args.writes, n_agents=args.agents,
                    model=model, seed=args.seed, progress=sys.stderr,
                    device=dev,
                )
            if args.scenario in ("dcn", "all"):
                out["scenarios"]["dcn"] = fid_scenarios.dcn_partition(
                    rounds=args.dcn_rounds, seed=args.seed,
                    progress=sys.stderr, device=dev,
                )
        from corrosion_tpu_torch.fidelity.calibrate import trace_fingerprint
        from corrosion_tpu_torch.fidelity.report import fidelity_context

        fp = trace_fingerprint([
            (i, blk.get("trace_fingerprint", name), i)
            for i, (name, blk) in enumerate(sorted(out["scenarios"].items()))
        ])
        report = {
            **fidelity_context(
                f"cli_{args.scenario}", args.agents, fp,
                args.writes, args.dcn_rounds, args.seed, device=dev,
            ),
            **out,
        }
        emit_fidelity_report(report)
        text = json.dumps(report, indent=2)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
        print(text)
        ok = all(
            blk.get("calibrated_closer", True)
            and blk.get("invariants_ok", True)
            for blk in report["scenarios"].values()
        )
        return 0 if ok else 1

    if args.fidelity_cmd == "replay":
        from corrosion_tpu_torch.fidelity.calibrate import identity_model
        from corrosion_tpu_torch.fidelity.compare import (
            bucket_hist, hist_cdf, kernel_replay,
        )
        from corrosion_tpu_torch.sim.trace import Trace

        try:
            trace = Trace.load(args.trace)
            model = (
                RoundModel.load(args.model) if args.model
                else identity_model()
            )
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"fidelity replay: {e!r}", file=sys.stderr)
            return 2
        rep = kernel_replay(
            trace, model.round_ms,
            n_nodes=len(trace.actors) + args.observers,
            model=model, seed=args.seed,
            vis_offset_rounds=model.vis_offset_rounds, device=_device(args),
        )
        lat = rep.pop("lat_rounds")
        rep["hist"] = bucket_hist(lat + model.vis_offset_rounds)
        rep["cdf"] = [round(c, 6) for c in hist_cdf(rep["hist"])]
        rep["model"] = model.describe()
        if args.json:
            print(json.dumps(rep))
        else:
            for k, v in rep.items():
                print(f"{k}: {v}")
        return 0 if rep["unseen"] == 0 else 1
    return 2


def _obs(args) -> int:
    """`corrosion obs {report,tail,diff,record,epidemic,soak,serving,
    timeline,cost,trajectory}` — delegates to the obs package
    (corrosion_tpu_torch/obs/commands.py), which owns the convergence-plane
    verdicts, the propagation/epidemic analyzer, the endurance and
    serving query-cost analyzers, and the causal-tracing correlator."""
    from corrosion_tpu_torch.obs import commands as obs_commands

    return obs_commands.run(args)


async def _run_agent(cfg: Config) -> int:
    import os

    from corrosion_tpu_torch.agent.agent import Agent, AgentConfig
    from corrosion_tpu_torch.agent.subs import SubsManager
    from corrosion_tpu_torch.utils.logfmt import setup_logging

    # Log format from config (LogFormat, config.rs:318-326).
    setup_logging(fmt=cfg.log.format, colors=cfg.log.colors)

    gossip_host, gossip_port = parse_addr(cfg.gossip.addr)
    api_host, api_port = parse_addr(cfg.api.addr)
    tls_cfg = None
    if not cfg.gossip.plaintext:
        # Fail closed: demanding TLS without cert material is a config
        # error, not a silent plaintext fallback.
        if not (cfg.gossip.tls_cert_file and cfg.gossip.tls_key_file):
            raise SystemExit(
                "gossip.plaintext = false requires tls_cert_file and "
                "tls_key_file ([gossip.tls] cert_file/key_file)"
            )
        from corrosion_tpu_torch.agent.agent import AgentTls

        tls_cfg = AgentTls(
            cert=cfg.gossip.tls_cert_file,
            key=cfg.gossip.tls_key_file,
            ca=cfg.gossip.tls_ca_file,
            client_cert=cfg.gossip.tls_client_cert_file,
            client_key=cfg.gossip.tls_client_key_file,
            mtls=cfg.gossip.tls_mtls,
            insecure=cfg.gossip.tls_insecure,
        )
    elif cfg.gossip.tls_cert_file:
        raise SystemExit(
            "gossip TLS material configured but plaintext = true — set "
            "gossip.plaintext = false to enable TLS"
        )
    acfg = AgentConfig(
        data_dir=os.path.dirname(cfg.db.path) or ".",
        gossip_host=gossip_host,
        gossip_port=gossip_port,
        api_host=api_host,
        api_port=api_port,
        bootstrap=resolve_bootstrap(cfg.gossip.bootstrap),
        bootstrap_raw=list(cfg.gossip.bootstrap),
        schema_sql=cfg.schema_sql(),
        probe_interval=cfg.gossip.probe_interval_ms / 1000.0,
        sync_interval=cfg.gossip.sync_interval_ms / 1000.0,
        max_transmissions=cfg.gossip.max_transmissions,
        admin_uds=cfg.admin.uds_path,
        tls=tls_cfg,
        prometheus_addr=cfg.telemetry.prometheus_addr or "",
        otlp_endpoint=cfg.telemetry.otlp_endpoint or "",
    )
    agent = Agent(acfg)
    agent.subs = SubsManager(agent.store)
    await agent.start()
    from corrosion_tpu_torch.utils.tripwire import Tripwire

    agent.tripwire = Tripwire.new_signals()
    # Through the logging stack, not print: the startup banner must honor
    # the configured log format (a JSON shipper chokes on bare text).
    logging.getLogger("corrosion_tpu_torch.cli").info(
        "agent %s api=%s gossip=%s",
        agent.actor_id, agent.api_addr, agent.gossip_addr,
    )
    await agent.tripwire.wait()
    await agent.stop()
    return 0


async def _query(args, cfg: Config) -> int:
    from corrosion_tpu_torch.client import CorrosionApiClient

    host, port = parse_addr(cfg.api.addr)
    client = CorrosionApiClient(host, port)
    import time

    t0 = time.monotonic()
    cols, rows = await client.query(args.sql)
    if args.columns:
        print("|".join(cols))
    for row in rows:
        print("|".join("" if v is None else str(v) for v in row))
    if args.timer:
        print(f"time: {time.monotonic() - t0:.6f}s", file=sys.stderr)
    return 0


async def _exec(args, cfg: Config) -> int:
    from corrosion_tpu_torch.client import CorrosionApiClient

    host, port = parse_addr(cfg.api.addr)
    client = CorrosionApiClient(host, port)
    resp = await client.execute(list(args.sql))
    print(json.dumps(resp))
    return 0


async def _admin(cfg: Config, command: dict) -> list[dict]:
    from corrosion_tpu_torch.agent.admin import AdminClient

    frames = await AdminClient(cfg.admin.uds_path).call(command)
    if not frames:
        raise SystemExit("admin: connection closed without a response")
    if "error" in frames[0]:
        raise SystemExit(f"admin: {frames[0]['error']}")
    return frames


if __name__ == "__main__":
    raise SystemExit(main())

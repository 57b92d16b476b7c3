"""`corrosion obs ...` command implementations (counterpart of
corrosion_tpu/obs/commands.py).

Promoted out of ``cli.py`` so the observability logic lives with the
plane it operates on: ``report``/``tail``/``diff``/``record`` drive the
kernel convergence plane (``sim/health.py``), ``epidemic`` drives the
propagation-topology analyzer (:mod:`corrosion_tpu_torch.obs.epidemic`), and
``timeline`` drives the causal-tracing correlator
(:mod:`corrosion_tpu_torch.obs.timeline` + :mod:`corrosion_tpu_torch.obs.journey`).
``cli.py`` keeps the argparse surface and delegates here.

Exit codes: 0 = verdict ok, 1 = regression / failed invariant, 2 =
usage. ``sim.health`` imports torch, so report/tail/diff/record pay the
torch import (about a second) though report/tail/diff read JSONL only;
``soak``, ``serving``, ``trajectory`` and ``timeline`` without
``--flight`` avoid it. The engine-running commands (``record``, ``cost
show|diff|capacity``) run on ``--device``: CUDA unless given, and an
error when CUDA is absent.
"""

from __future__ import annotations

import json
import sys


def run(args) -> int:
    if args.obs_cmd == "timeline":
        return _timeline(args)
    if args.obs_cmd == "cost":
        return _cost(args)
    if args.obs_cmd == "trajectory":
        return _trajectory(args)
    if args.obs_cmd == "epidemic":
        return _epidemic(args)
    if args.obs_cmd == "soak":
        return _soak(args)
    if args.obs_cmd == "serving":
        return _serving(args)

    from corrosion_tpu_torch.sim import health

    if args.obs_cmd == "report":
        rep = health.report_from_flight(
            args.flight, round_ms=args.round_ms,
            kill_rounds=args.kill_round,
        )
        if args.json:
            print(json.dumps(rep.to_dict()))
        else:
            print(rep.render())
        return 0

    if args.obs_cmd == "tail":
        last_round: dict = {}
        n_rounds = 0
        for rec in health.iter_flight(
            args.flight, follow=args.follow, poll_s=args.poll,
            idle_timeout_s=args.idle_timeout,
        ):
            kind = rec.get("kind")
            if kind == "flight":
                print(
                    f"[flight] engine={rec.get('engine', '?')} "
                    f"version={rec.get('version', '?')}"
                )
            elif kind == "round":
                last_round = rec
                n_rounds += 1
                if args.rounds:
                    print(json.dumps(rec))
            elif kind == "chunk" and not args.rounds:
                wall = rec.get("wall_s")
                tail = {
                    k: last_round.get(k)
                    for k in (
                        "need", "mismatches", "staleness_sum",
                        "queue_backlog", "swim_undetected_deaths",
                    )
                    if k in last_round
                }
                print(
                    f"[chunk] rounds {rec.get('start')}.."
                    f"{rec.get('start', 0) + rec.get('rounds', 0) - 1}"
                    + (f" wall={wall}s" if wall is not None else "")
                    + f" {json.dumps(tail)}"
                )
        print(f"[tail] {n_rounds} round records")
        return 0

    if args.obs_cmd == "diff":
        base = health.load_report(args.baseline, round_ms=args.round_ms)
        cand = health.load_report(args.candidate, round_ms=args.round_ms)
        diff = health.diff_reports(base, cand, tolerance=args.tolerance)
        if args.json:
            print(json.dumps(diff))
        else:
            for row in diff["rows"]:
                mark = "ok" if row["ok"] else "REGRESSION"
                print(
                    f"{row['metric']}: {row['baseline']} -> "
                    f"{row['candidate']} [{mark}]"
                )
            for r in diff["regressions"]:
                print(f"REGRESSION: {r}", file=sys.stderr)
        return 1 if diff["regressions"] else 0

    if args.obs_cmd == "record":
        facts = health.record_demo_flight(
            args.out, nodes=args.nodes, rounds=args.rounds,
            churn=args.churn, seed=args.seed, progress=sys.stderr,
            geo=args.geo, adaptive=getattr(args, "adaptive", False),
            device=_device(args),
        )
        print(json.dumps(facts))
        return 0
    return 2


def _epidemic(args) -> int:
    """`obs epidemic {report,fit,diff}` — the propagation-topology
    plane's analyzer (obs/epidemic.py, docs/OBSERVABILITY.md
    "Propagation plane"). Exit 0 = verdict ok, 1 = regression or an
    accounting identity failed to reconcile, 2 = usage."""
    from corrosion_tpu_torch.obs import epidemic

    kw = dict(
        fanout=args.fanout, nodes=args.nodes, round_ms=args.round_ms,
        geo_regions=args.geo_regions,
    )

    if args.epidemic_cmd == "report":
        try:
            rep = epidemic.report_from_flight(args.flight, **kw)
        except (OSError, ValueError) as e:
            print(f"obs epidemic report: {e}", file=sys.stderr)
            return 2
        if args.oracle_records:
            try:
                with open(args.oracle_records) as f:
                    rep["oracle"] = epidemic.oracle_coverage(
                        json.load(f), round_ms=args.round_ms
                    )
            except (OSError, ValueError) as e:
                print(
                    f"obs epidemic report: bad --oracle-records: {e!r}",
                    file=sys.stderr,
                )
                return 2
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(rep, indent=2) + "\n")
        print(json.dumps(rep) if args.json else epidemic.render_report(rep))
        if not rep["checks_ok"]:
            for p in rep["check_problems"]:
                print(f"obs epidemic report: ACCOUNTING: {p}",
                      file=sys.stderr)
            return 1
        return 0

    if args.epidemic_cmd == "fit":
        try:
            rep = epidemic.report_from_flight(args.flight, **kw)
        except (OSError, ValueError) as e:
            print(f"obs epidemic fit: {e}", file=sys.stderr)
            return 2
        fit = rep["fit"]
        if args.json:
            print(json.dumps(fit))
        else:
            for p in fit["points"]:
                logit = p.get("logit")
                print(
                    f"age<={p['age']:g}r coverage={p['coverage']:.4f}"
                    + (f" logit={logit:+.3f}" if logit is not None else "")
                )
            if fit["fitted"]:
                print(
                    f"beta={fit['spread_exponent']:.4f}/round "
                    f"half={fit['half_coverage_round']:.1f}r "
                    f"r2={fit['r2']:.3f}"
                )
            else:
                print("fit abstained (fewer than 2 interior points)")
        return 0 if fit["fitted"] else 1

    if args.epidemic_cmd == "diff":
        try:
            base = epidemic.load_report(args.baseline, **kw)
            cand = epidemic.load_report(args.candidate, **kw)
        except (OSError, ValueError) as e:
            print(f"obs epidemic diff: {e}", file=sys.stderr)
            return 2
        diff = epidemic.diff_reports(base, cand, tolerance=args.tolerance)
        if args.json:
            print(json.dumps(diff))
        else:
            for row in diff["rows"]:
                mark = "ok" if row["ok"] else "REGRESSION"
                print(
                    f"{row['metric']}: {row['baseline']} -> "
                    f"{row['candidate']} [{mark}]"
                )
            for r in diff["regressions"]:
                print(f"REGRESSION: {r}", file=sys.stderr)
        return 1 if diff["regressions"] else 0
    return 2


def _soak(args) -> int:
    """`obs soak {report,diff}` — the endurance plane's analyzer
    (obs/series.py + obs/endurance.py, docs/OBSERVABILITY.md "Endurance
    plane"). torch-free: judging a recorded series must not pay the
    kernel import. Exit 0 = verdict ok, 1 = breach/regression, 2 =
    usage."""
    from corrosion_tpu_torch.obs import endurance
    from corrosion_tpu_torch.obs.series import replay_series

    if args.soak_cmd == "report":
        try:
            samples = replay_series(args.series)["samples"]
        except (OSError, ValueError) as e:
            print(f"obs soak report: {e}", file=sys.stderr)
            return 2
        ceilings: dict = {}
        for spec in args.leak_ceiling or ():
            name, _, val = spec.partition("=")
            try:
                ceilings[name] = float(val)
            except ValueError:
                print(
                    f"obs soak report: bad --leak-ceiling {spec!r} "
                    f"(want NAME=UNITS_PER_HOUR)", file=sys.stderr,
                )
                return 2
        rep = endurance.build_report(
            samples, t_scale_s=args.t_scale_s, label=args.label,
            leak_ceilings=ceilings or None,
            wedge_min_span_s=args.wedge_min_span_s,
        )
        _emit(
            rep, args,
            text=None if args.json else endurance.render_report(rep),
        )
        for b in rep["breaches"]:
            print(f"obs soak report: BREACH: {b}", file=sys.stderr)
        return 0 if rep["ok"] else 1

    if args.soak_cmd == "diff":
        try:
            with open(args.baseline) as f:
                base = json.load(f)
            with open(args.candidate) as f:
                cand = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs soak diff: {e}", file=sys.stderr)
            return 2
        diff = endurance.diff_soak(base, cand, tolerance=args.tolerance)
        if args.json:
            print(json.dumps(diff))
        else:
            for row in diff["rows"]:
                mark = "ok" if row["ok"] else "REGRESSION"
                print(
                    f"{row['metric']}: {row['baseline']} -> "
                    f"{row['candidate']} [{mark}]"
                )
            for r in diff["regressions"]:
                print(f"REGRESSION: {r}", file=sys.stderr)
        return 1 if diff["regressions"] else 0
    return 2


def _serving(args) -> int:
    """`obs serving {report,diff}` — the serving query-cost plane's
    analyzer (obs/serving.py, docs/SERVING.md "Query-cost plane").
    torch-free: joining a recorded ledger with oracle delivery records
    must not pay the kernel import. Exit 0 = verdict ok, 1 =
    reconciliation/regression failure, 2 = usage."""
    from corrosion_tpu_torch.obs import serving

    if args.serving_cmd == "report":
        try:
            with open(args.from_run) as f:
                report = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs serving report: {e!r}", file=sys.stderr)
            return 2
        run = report.get("run", report)
        try:
            rep = serving.build_serving_report(run, top_k=args.top)
        except ValueError as e:
            print(f"obs serving report: {e}", file=sys.stderr)
            return 2
        _emit(
            rep, args,
            text=None if args.json else serving.render_serving_report(rep),
        )
        ok = rep["reconciliation"]["ok"] and rep["fallback"]["observed"]
        if not rep["fallback"]["observed"]:
            print(
                "obs serving report: no fallback-bound subscription was "
                "ever observed evaluating (machinery-fired rule)",
                file=sys.stderr,
            )
        for m in rep["reconciliation"]["mismatches"]:
            print(f"obs serving report: MISMATCH: {m}", file=sys.stderr)
        return 0 if ok else 1

    if args.serving_cmd == "diff":
        try:
            with open(args.baseline) as f:
                base = json.load(f)
            with open(args.candidate) as f:
                cand = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs serving diff: {e!r}", file=sys.stderr)
            return 2
        # Accept either a bare corro-serving-cost/1 report or a smoke
        # gate report that nests one under "serving".
        base = base.get("serving", base)
        cand = cand.get("serving", cand)
        ok, rows = serving.diff_serving_reports(
            base, cand, tolerance=args.tolerance, floor_ms=args.floor_ms,
        )
        if args.json:
            print(json.dumps({"ok": ok, "rows": rows}))
        else:
            for row in rows:
                mark = "ok" if row["ok"] else "REGRESSION"
                print(
                    f"{row['path']}: {row['base']} -> {row['cand']} "
                    f"(limit {row['limit']}) [{mark}]"
                )
        for row in rows:
            if not row["ok"]:
                print(
                    f"obs serving diff: REGRESSION: {row['path']} "
                    f"{row['base']} -> {row['cand']}", file=sys.stderr,
                )
        return 0 if ok else 1
    return 2


def _device(args):
    """``--device``, else CUDA; raises when CUDA is absent."""
    from corrosion_tpu_torch import resolve_device

    return resolve_device(getattr(args, "device", None))


def _ensure_devices(n: int, device) -> bool:
    """Positions for an ``n``-position mesh on ``device``, placed as
    ``obs/costs._mesh_for`` places them (``parallel.mesh``: positions are
    filled from the visible cards in turn, so any count is available on
    one card). Always True; the reference's False (a jax backend already
    up with fewer virtual devices) has no counterpart."""
    from corrosion_tpu_torch.parallel.mesh import multichip_mesh

    if n > 1:
        multichip_mesh(n, device=device)
    return True


def _emit(payload: dict, args, text: str | None = None) -> None:
    """Shared artifact output: pretty/compact JSON to stdout (or the
    rendered text form), plus --out."""
    body = json.dumps(payload, indent=None if args.json else 2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(payload, indent=2) + "\n")
    print(body if text is None else text)


def _cost(args) -> int:
    """`obs cost {show,diff,capacity}` — the device-cost plane
    (obs/costs.py, docs/PERFORMANCE.md "Cost model & roofline"), on
    ``--device``."""
    from corrosion_tpu_torch.obs import costs

    dev = _device(args)
    if args.cost_cmd == "show":
        devices = [int(d) for d in args.devices.split(",") if d.strip()]
        _ensure_devices(max(devices), dev)
        model = costs.build_cost_model(
            engines=tuple(
                e.strip() for e in args.engines.split(",") if e.strip()
            ),
            variants=tuple(
                v.strip() for v in args.variants.split(",") if v.strip()
            ),
            device_counts=tuple(devices),
            progress=sys.stderr, device=dev,
        )
        _emit(model, args)
        return 0

    if args.cost_cmd == "diff":
        try:
            base = costs.load_model(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"obs cost diff: {e!r}", file=sys.stderr)
            return 2
        dmax = max(base.get("device_counts", [1]))
        _ensure_devices(dmax, dev)
        cand = costs.build_cost_model(
            engines=tuple(base.get("engines", costs.ENGINES)),
            # The port has only its own variants; the baseline's others
            # show as missing entries (breaches), not as a crash.
            variants=tuple(v for v in base.get("variants", costs.VARIANTS)
                           if v in costs.VARIANTS),
            device_counts=tuple(base.get("device_counts", (1,))),
            progress=sys.stderr, device=dev,
        )
        ok, breaches, notes = costs.diff_cost_models(
            base, cand, tolerance=args.tolerance
        )
        report = {
            "ok": ok, "breaches": breaches, "notes": notes,
            "baseline": args.baseline, "measured": cand,
        }
        _emit(report, args)
        for b in breaches:
            print(f"obs cost diff: BREACH {b}", file=sys.stderr)
        for n in notes:
            print(f"obs cost diff: note: {n}", file=sys.stderr)
        return 0 if ok else 1

    if args.cost_cmd == "capacity":
        _ensure_devices(args.devices, dev)
        nodes = (
            costs.CAPACITY_NODE_GRID if args.nodes is None
            else tuple(
                int(x) for x in args.nodes.split(",") if x.strip()
            )
        )
        try:
            model = costs.capacity_model(
                node_counts=nodes,
                device_count=args.devices,
                validate_live=not args.no_validate,
                memory_bytes=(
                    None if args.hbm_gib is None else int(args.hbm_gib * 2**30)
                ),
                device=dev,
            )
        except ValueError as e:
            print(f"obs cost capacity: RECONCILE FAILED: {e}",
                  file=sys.stderr)
            return 1
        _emit(model, args)
        return 0
    return 2


def _trajectory(args) -> int:
    """`obs trajectory` — the committed bench artifacts as one
    provenance-checked series (obs/trajectory.py)."""
    from corrosion_tpu_torch.obs import trajectory as traj_mod

    traj = traj_mod.build_trajectory(args.root)
    if not traj["bench"] and not traj["multichip"]:
        print(
            f"obs trajectory: no BENCH_r*/MULTICHIP_r* artifacts under "
            f"{args.root}", file=sys.stderr,
        )
        return 2
    _emit(
        traj, args,
        text=None if args.json else traj_mod.render_trajectory(traj),
    )
    return 0


def _timeline(args) -> int:
    """`obs timeline`: correlate a traced loadgen run's span exports +
    oracle delivery records (and optionally a kernel flight + write
    trace) into one corro-timeline/1 artifact."""
    from corrosion_tpu_torch.obs.timeline import (
        build_timeline,
        load_spans,
        timeline_ok,
    )

    if args.from_run:
        try:
            with open(args.from_run) as f:
                report = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs timeline: {e!r}", file=sys.stderr)
            return 2
        run = report.get("run", report)
        trace_blk = run.get("trace")
        if not trace_blk:
            print(
                "obs timeline: report has no run.trace block — rerun "
                "`loadgen run --trace-dir DIR`", file=sys.stderr,
            )
            return 2
        spans = load_spans(trace_blk["span_files"])
        records = trace_blk["oracle_records"]
        sample = float(trace_blk.get("sample", 1.0))
    elif args.spans and args.records:
        spans = load_spans(args.spans)
        try:
            with open(args.records) as f:
                records = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs timeline: bad --records: {e!r}", file=sys.stderr)
            return 2
        sample = args.sample
    else:
        print(
            "obs timeline: need --from-run REPORT or --spans FILE... "
            "--records FILE", file=sys.stderr,
        )
        return 2

    timeline = build_timeline(
        spans, records, sample=sample, tolerance_ms=args.tolerance_ms,
    )

    if args.flight and args.trace:
        from corrosion_tpu_torch.obs.journey import reconstruct_write_journeys
        from corrosion_tpu_torch.sim.trace import Trace

        try:
            timeline["kernel"] = reconstruct_write_journeys(
                args.flight, Trace.load(args.trace),
                round_ms=args.round_ms,
            )
        except (OSError, ValueError) as e:
            print(f"obs timeline: kernel join failed: {e!r}",
                  file=sys.stderr)
            return 2
    elif args.flight or args.trace:
        print(
            "obs timeline: --flight and --trace go together (the "
            "journey reconstructor needs both)", file=sys.stderr,
        )
        return 2

    text = json.dumps(timeline, indent=None if args.json else 2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    ok, problems = timeline_ok(timeline, min_coverage=args.min_coverage)
    for p in problems:
        print(f"obs timeline: {p}", file=sys.stderr)
    return 0 if ok else 1

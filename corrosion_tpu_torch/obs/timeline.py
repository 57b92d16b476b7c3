"""End-to-end causal write timelines — the cross-plane correlator.

For one acked write, where did the latency go? The three evidence
sources each see a part of the journey:

- the **load generator** (client side) knows when each write was sent,
  when its HTTP ack returned, and when every subscription stream
  delivered it (``loadgen/oracle.py`` delivery records, wall-clock
  stamped);
- the **agents** (server side) export causal spans — ``api_write`` at
  ingest (continuing the client's W3C traceparent), ``commit`` around
  the store transaction, ``ingest_apply`` per gossip hop on every relay,
  ``sub_fanout`` inside the matcher (``utils/tracing.py`` JSONL export);
- the **kernel plane** optionally contributes a replayed view of the
  same workload (:mod:`corrosion_tpu_torch.obs.journey`).

``build_timeline`` joins them on the client-minted trace id (spans) and
write key (deliveries) into one ``corro-timeline/1`` artifact:

- per-write **stage decomposition**: ``send_wait`` (client send → server
  ingest), ``ingest`` (ingest → store transaction start, the
  admission/pool queue wait), ``commit`` (store transaction through
  bookkeeping), ``gossip`` (commit → last relevant remote hop's apply),
  ``fanout`` (→ last delivery or ack, whichever is later);
- a **latency budget**: p50/p99/mean/max per stage across all
  reconstructed writes, so a tail regression names the stage that moved;
- the **reconciliation invariant**: per write, the epoch-clock-derived
  stage sum must equal the wall latency measured on the MONOTONIC clock
  (oracle ``t_send_mono`` → last delivery/ack ``t_mono`` — a clock no
  span touches) within ``tolerance_ms``, and the span-derived cut
  points must be causally ordered against the oracle's timestamps
  (send ≤ api ≤ commit-start ≤ commit-end ≤ ack; no delivery before
  commit start). A broken join, a missing span, an epoch-clock step
  mid-run, or span-vs-oracle skew fails the reconcile — the
  provenance-chain property every headline number must have.

Clock domains: span times are ``time.time_ns()`` and client stamps
``time.time()`` (one epoch clock in-process — the stage CUTS live
there), while the reconciliation wall rides ``loop.time()``
(monotonic). The stage sum telescopes to the epoch window by
construction, so only the cross-domain comparison gives the sum check
teeth; records without monotonic stamps fall back to the epoch wall
and are counted out of ``reconcile.independent_walls`` (the ordering
check still applies to them).

Host code only. Counterpart of corrosion_tpu/obs/timeline.py.
"""

from __future__ import annotations

import json

from corrosion_tpu_torch.utils.tracing import trace_sampled

TIMELINE_SCHEMA = "corro-timeline/1"

STAGES = ("send_wait", "ingest", "commit", "gossip", "fanout")

# Span names the host plane emits per traced write (agent/api.py,
# agent/agent.py, agent/subs.py).
SPAN_API = "api_write"
SPAN_COMMIT = "commit"
SPAN_HOP = "ingest_apply"
SPAN_FANOUT = "sub_fanout"


def load_spans(paths) -> list[dict]:
    """Read span-export JSONL files (unparsable lines skipped — a
    crashed agent's torn tail write must not sink the whole timeline).
    An UNOPENABLE file is a different failure class: it is warned about
    on stderr by name, because silently skipping it surfaces later only
    as a cryptic coverage shortfall (e.g. relative span paths resolved
    from the wrong cwd)."""
    import sys

    spans: list[dict] = []
    for path in paths:
        try:
            f = open(path)
        except OSError as e:
            print(
                f"obs timeline: cannot read span file {path!r}: {e} "
                f"(coverage will be judged without it)",
                file=sys.stderr,
            )
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    spans.append(json.loads(line))
                except ValueError:
                    continue
    return spans


def _pct(sorted_vals: list[float], q: float) -> float:
    """Exact nearest-rank percentile over a sorted sample."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(i)]


def _stage_stats(values: list[float]) -> dict:
    vals = sorted(values)
    if not vals:
        return {"count": 0}
    return {
        "count": len(vals),
        "p50": round(_pct(vals, 0.50), 3),
        "p99": round(_pct(vals, 0.99), 3),
        "mean": round(sum(vals) / len(vals), 3),
        "max": round(vals[-1], 3),
    }


def _span_times(span: dict) -> tuple[float, float]:
    """(start_s, end_s) of an exported span in epoch seconds."""
    start = span["start_ns"] / 1e9
    return start, start + span["duration_us"] / 1e6


def _hop_chain_depth(hops: list[dict]) -> int:
    """Longest parent-chain of ingest_apply spans (1 = single hop) —
    how deep the rebroadcast re-stamping carried the trace."""
    by_id = {h["span_id"]: h for h in hops}
    best = 0
    for h in hops:
        depth, cur, seen = 1, h, {h["span_id"]}
        while True:
            parent = by_id.get(cur.get("parent_id"))
            if parent is None or parent["span_id"] in seen:
                break
            seen.add(parent["span_id"])
            depth += 1
            cur = parent
        best = max(best, depth)
    return best


def build_timeline(
    spans: list[dict],
    oracle_records: dict,
    *,
    sample: float = 1.0,
    tolerance_ms: float = 100.0,
    max_writes_detail: int = 64,
) -> dict:
    """Join spans + oracle records into the ``corro-timeline/1`` dict.

    ``oracle_records`` is :meth:`FanoutOracle.delivery_records` output;
    ``sample`` is the trace-sampling rate the run used (reconstruction
    coverage is judged over the writes the sampler KEPT — an unsampled
    write has no spans by design, not by failure).
    """
    by_trace: dict[str, dict[str, list[dict]]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], {}).setdefault(
            s["name"], []
        ).append(s)

    deliveries_by_key: dict[object, list[dict]] = {}
    n_changes = n_snapshot = 0
    for d in oracle_records.get("deliveries", ()):
        deliveries_by_key.setdefault(d["key"], []).append(d)
        if d.get("kind") == "change":
            n_changes += 1
        else:
            n_snapshot += 1

    writes = oracle_records.get("writes", ())
    traced = [w for w in writes if w.get("trace_id")]
    expected = [
        w for w in traced if trace_sampled(w["trace_id"], sample)
    ]

    stage_vals: dict[str, list[float]] = {s: [] for s in STAGES}
    wall_vals: list[float] = []
    detail: list[dict] = []
    reconstructed = 0
    remote_hop_writes = 0
    max_depth = 0
    rec_checked = rec_ok = rec_independent = ordering_violations = 0
    max_abs_err_ms = 0.0

    for w in expected:
        tid = w["trace_id"]
        tspans = by_trace.get(tid, {})
        api = tspans.get(SPAN_API, [None])[0]
        commit = tspans.get(SPAN_COMMIT, [None])[0]
        hops = tspans.get(SPAN_HOP, [])
        dels = [
            d for d in deliveries_by_key.get(w["key"], ())
            if d.get("kind") == "change"
        ]
        t_send = w.get("t_send_wall")
        t_ack = w.get("t_ack_wall")
        if api is None or commit is None or t_send is None:
            continue  # not reconstructable end-to-end
        if not dels and not deliveries_by_key.get(w["key"]):
            # No delivery evidence at all (e.g. no matching stream):
            # the journey cannot be called end-to-end.
            continue
        api_start, _api_end = _span_times(api)
        commit_start, commit_end = _span_times(commit)
        t_delivery_last = max((d["t_wall"] for d in dels), default=None)
        ends = [v for v in (t_delivery_last, t_ack) if v is not None]
        if not ends:
            continue  # snapshot-only delivery with no ack stamp
        t_end = max(ends)
        reconstructed += 1
        if hops:
            max_depth = max(max_depth, _hop_chain_depth(hops))
        # The gossip stage counts only the hop that SERVED the
        # deliveries — the ingest_apply span containing the first
        # delivery (fan-out happens inside the serving agent's apply
        # flush). Other hops of the same trace (relays that hold no
        # matching stream) are real dissemination but not on this
        # write's delivery path: counting them would charge a
        # local-fan-out write for an unrelated relay that finished later.
        serving_hop = None
        if hops and dels:
            t_first = min(d["t_wall"] for d in dels)
            slack = tolerance_ms / 1e3
            cands = [
                h for h in hops
                if _span_times(h)[0] <= t_first
                <= _span_times(h)[1] + slack
            ]
            if cands:
                # Deepest qualifying hop = the serving agent's own apply.
                serving_hop = max(cands, key=lambda h: h["start_ns"])
        if serving_hop is not None:
            remote_hop_writes += 1
            c4 = max(commit_end, _span_times(serving_hop)[0])
        else:
            c4 = commit_end
        stages_ms = {
            "send_wait": (api_start - t_send) * 1e3,
            "ingest": (commit_start - api_start) * 1e3,
            "commit": (commit_end - commit_start) * 1e3,
            "gossip": (c4 - commit_end) * 1e3,
            "fanout": (t_end - c4) * 1e3,
        }
        # The wall the stage sum answers to. The stages telescope to
        # the EPOCH-clock window (t_end - t_send) by construction, so
        # comparing against that would be a tautology: whenever the
        # run recorded monotonic-clock endpoints too (oracle commit
        # t_send_mono/t_ack_mono + per-delivery t_mono — loop.time(),
        # a clock no span touches), the wall is measured THERE. An
        # epoch-clock step (NTP slew mid-run) or any mixed-clock
        # inconsistency then shows up as stage-sum error; span-vs-
        # oracle offset skew is caught by the ordering check below.
        t_send_m = w.get("t_send_mono")
        ends_mono = [
            d["t_mono"] for d in dels if d.get("t_mono") is not None
        ]
        if w.get("t_ack_mono") is not None:
            ends_mono.append(w["t_ack_mono"])
        independent = t_send_m is not None and bool(ends_mono)
        wall_ms = (
            (max(ends_mono) - t_send_m) * 1e3 if independent
            else (t_end - t_send) * 1e3
        )
        for k, v in stages_ms.items():
            stage_vals[k].append(v)
        wall_vals.append(wall_ms)

        # Reconciliation: the stage sum against the loadgen-measured
        # wall, plus the causal ordering of span cuts vs oracle stamps.
        rec_checked += 1
        if independent:
            rec_independent += 1
        err = abs(sum(stages_ms.values()) - wall_ms)
        max_abs_err_ms = max(max_abs_err_ms, err)
        tol_s = tolerance_ms / 1e3
        ordered = (
            t_send - tol_s <= api_start
            and api_start <= commit_start + tol_s
            and commit_start <= commit_end
            and (t_ack is None or commit_end <= t_ack + tol_s)
            and all(
                d["t_wall"] >= commit_start - tol_s for d in dels
            )
        )
        if not ordered:
            ordering_violations += 1
        if err <= tolerance_ms and ordered:
            rec_ok += 1
        if len(detail) < max_writes_detail:
            detail.append({
                "key": w["key"],
                "trace_id": tid,
                "wall_ms": round(wall_ms, 3),
                "stages_ms": {
                    k: round(v, 3) for k, v in stages_ms.items()
                },
                "deliveries": len(dels),
                "hops": len(hops),
                "reconciled": err <= tolerance_ms and ordered,
            })

    coverage = reconstructed / len(expected) if expected else 0.0
    return {
        "schema": TIMELINE_SCHEMA,
        "writes_acked": len(writes),
        "writes_traced": len(traced),
        "writes_expected": len(expected),
        "writes_reconstructed": reconstructed,
        "coverage": round(coverage, 5),
        "sample": sample,
        "spans_seen": len(spans),
        "deliveries": {"changes": n_changes, "snapshot": n_snapshot},
        "hops": {
            "writes_with_remote_hop": remote_hop_writes,
            "max_chain_depth": max_depth,
        },
        "stages_ms": {k: _stage_stats(v) for k, v in stage_vals.items()},
        "wall_ms": _stage_stats(wall_vals),
        "reconcile": {
            "tolerance_ms": tolerance_ms,
            "checked": rec_checked,
            "ok": rec_ok,
            # Writes whose wall came from the monotonic clock (a domain
            # no span touches) — only those stage-sum checks are
            # non-tautological; 0 here means the records carried no
            # monotonic stamps and only the ordering check had teeth.
            "independent_walls": rec_independent,
            "ordering_violations": ordering_violations,
            "max_abs_err_ms": round(max_abs_err_ms, 3),
        },
        "writes_detail": detail,
    }


def timeline_from_run(
    run: dict, *, tolerance_ms: float = 100.0,
    max_writes_detail: int = 64,
) -> dict:
    """Build the timeline from a traced ``loadgen run`` report block —
    the ``run`` dict returned by ``scenarios.fanout_storm(trace_dir=...)``
    (its ``trace`` sub-block carries span file paths + oracle records)."""
    trace = run.get("trace")
    if not trace:
        raise ValueError(
            "run has no trace block — rerun loadgen with tracing "
            "enabled (fanout_storm(trace_dir=...) / --trace-dir)"
        )
    return build_timeline(
        load_spans(trace["span_files"]),
        trace["oracle_records"],
        sample=float(trace.get("sample", 1.0)),
        tolerance_ms=tolerance_ms,
        max_writes_detail=max_writes_detail,
    )


def timeline_ok(
    timeline: dict, min_coverage: float = 0.99
) -> tuple[bool, list[str]]:
    """The timeline acceptance verdict: coverage over sampled acked
    writes, every reconciliation check green. Returns (ok, problems)."""
    problems: list[str] = []
    if timeline["writes_expected"] == 0:
        problems.append("no traced writes to reconstruct")
    if timeline["coverage"] < min_coverage:
        problems.append(
            f"coverage {timeline['coverage']:.4f} < {min_coverage} "
            f"({timeline['writes_reconstructed']}/"
            f"{timeline['writes_expected']} writes reconstructed)"
        )
    rec = timeline["reconcile"]
    if rec["ok"] < rec["checked"]:
        problems.append(
            f"reconciliation failed for {rec['checked'] - rec['ok']}/"
            f"{rec['checked']} writes (max err "
            f"{rec['max_abs_err_ms']} ms, "
            f"{rec['ordering_violations']} ordering violations)"
        )
    return not problems, problems

"""Kernel telemetry plane shared by the simulation engines (counterpart
of corrosion_tpu/sim/telemetry.py).

- **RoundCurves schema**: every engine emits exactly ``ROUND_CURVE_KEYS``;
  ``round_curves`` zero-fills what an engine does not measure, and
  ``CURVE_DTYPES`` gives each key the numpy dtype the reference's curves
  carry, so finished curves compare with the reference's array for array.
- **FlightRecorder**: streams per-round curves to a ``corro-flight/1``
  JSONL at every chunk boundary, so a long run reports progress and a
  crashed run leaves a replayable record (``replay_flight``).
- **Metrics bridge**: ``publish_curves`` folds finished curves into a
  registry (duck-typed: ``counter``/``gauge``/``histogram``) as
  ``corro_kernel_*`` series.
- **KernelTelemetry**: the bundle of sinks the four engines' run functions take as
  ``telemetry=``; it times each chunk, spans it, and flushes it.

The compile ledger and memory watermarks of the reference's
``KernelTelemetry`` and its plane attribution belong to the bench
harness and are not part of this module.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import IO, Callable

import numpy as np
import torch

VIS_LAT_EDGES = (1, 2, 4, 8, 16, 32, 64)
VIS_LAT_KEYS = tuple(f"vis_lat_b{i}" for i in range(len(VIS_LAT_EDGES) + 1))
CHAOS_CURVE_KEYS = ("chaos_lost_msgs", "chaos_wiped")
HEALTH_CURVE_KEYS = (
    "staleness_sum",
    "staleness_max",
    "swim_false_alarms",
    "swim_undetected_deaths",
    "swim_flaps",
    "queue_backlog",
    "streams_applied",
    "chunks_sent",
    "seqs_granted",
) + CHAOS_CURVE_KEYS + VIS_LAT_KEYS
XSHARD_CURVE_KEYS = ("xshard_bytes_ici", "xshard_bytes_dcn")
PROP_REGIONS = 4
LINK_CURVE_KEYS = tuple(
    f"link_{i}{j}" for i in range(PROP_REGIONS) for j in range(PROP_REGIONS)
)
RUMOR_AGE_EDGES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 48, 64)
RUMOR_AGE_KEYS = tuple(f"rumor_age_b{i}" for i in range(len(RUMOR_AGE_EDGES) + 1))
PROP_CURVE_KEYS = (
    ("prop_useful_msgs", "prop_dup_msgs")
    + LINK_CURVE_KEYS
    + RUMOR_AGE_KEYS
    + ("prop_rumor_kills", "prop_pull_rounds")
)
ROUND_CURVE_KEYS = (
    "msgs",
    "applied_broadcast",
    "applied_sync",
    "cell_merges",
    "need",
    "mismatches",
    "sessions",
    "window_degraded",
    "sync_regrant",
    "cold_healed",
    "vis_count",
) + HEALTH_CURVE_KEYS + XSHARD_CURVE_KEYS + PROP_CURVE_KEYS

# Level-style curves whose end-of-run value is a convergence verdict on
# its own: published additionally as ``<series>_last`` gauges.
LEVEL_CURVE_KEYS = (
    "need",
    "mismatches",
    "staleness_sum",
    "staleness_max",
    "swim_false_alarms",
    "swim_undetected_deaths",
    "queue_backlog",
    "streams_applied",
)

# The reference's per-key dtypes: counts summed without a dtype are
# int32, the float observables float32, everything else uint32.
CURVE_DTYPES = {k: np.uint32 for k in ROUND_CURVE_KEYS}
CURVE_DTYPES.update(
    msgs=np.int32, mismatches=np.int32, sessions=np.int32,
    staleness_sum=np.float32, xshard_bytes_ici=np.float32,
    xshard_bytes_dcn=np.float32,
)


def series_name(key: str) -> str:
    """Prometheus series stem of a curve key: ``corro_kernel_health_<key>``
    for the health plane, ``corro_kernel_<key>`` for the rest."""
    prefix = "corro_kernel_health_" if key in HEALTH_CURVE_KEYS else "corro_kernel_"
    return prefix + key


def delivery_latency_hist(lat_rounds, newly, edges=None, keys=None) -> dict:
    """Fixed-bucket histogram of the pairs newly visible this round:
    bucket b counts ``edges[b-1] < lat <= edges[b]`` (last = overflow)."""
    edges = VIS_LAT_EDGES if edges is None else edges
    keys = VIS_LAT_KEYS if keys is None else keys
    idx = torch.zeros(lat_rounds.shape, dtype=torch.int64, device=lat_rounds.device)
    for e in edges:
        idx = idx + (lat_rounds > e).to(torch.int64)
    return {k: (newly & (idx == b)).sum() for b, k in enumerate(keys)}


def link_curves(link) -> dict:
    """A [R, R] region-pair traffic matrix (R <= ``PROP_REGIONS``) as the
    fixed ``LINK_CURVE_KEYS`` scalars; entries past R zero-fill."""
    r = link.shape[0]
    if r > PROP_REGIONS:
        raise ValueError(
            f"propagation plane supports at most {PROP_REGIONS} regions, "
            f"got {r}; disable prop_observe or shrink the region axis"
        )
    return {
        f"link_{i}{j}": link[i, j] if i < r and j < r else 0
        for i in range(PROP_REGIONS)
        for j in range(PROP_REGIONS)
    }


def prop_curves(
    enabled: bool, link=None, useful=None, dup=None, lat_rounds=None, newly=None,
    kills=None, pulls=None,
) -> dict:
    """Per-round propagation-plane stats, or {} when the plane is off (the
    reference's static skip): the link matrix, the useful/duplicate split
    of delivered copies, the rumor-age histogram of the pairs first
    delivered this round (``RUMOR_AGE_EDGES``), and the kill and pull
    counters (zero when None)."""
    if not enabled:
        return {}
    out = {
        "prop_useful_msgs": useful,
        "prop_dup_msgs": dup,
        "prop_rumor_kills": 0 if kills is None else kills,
        "prop_pull_rounds": 0 if pulls is None else pulls,
    }
    out.update(link_curves(link))
    out.update(delivery_latency_hist(lat_rounds, newly, RUMOR_AGE_EDGES, RUMOR_AGE_KEYS))
    return out


def round_curves(**stats) -> dict:
    """Canonical per-round stats dict: unknown keys raise, missing keys
    zero-fill."""
    unknown = set(stats) - set(ROUND_CURVE_KEYS)
    if unknown:
        raise ValueError(f"unknown round-curve keys {sorted(unknown)}")
    return {k: stats.get(k, 0) for k in ROUND_CURVE_KEYS}


def stack_curves(rows: list, dtypes: dict | None = None) -> dict:
    """Per-round stats dicts -> {key: numpy array} in the reference's
    dtypes (``CURVE_DTYPES``, or an engine's own ``dtypes``), with one
    device-to-host copy for the whole run. Keys a row holds as tensors
    must be tensors in every row; the rest are the zero fill."""
    dtypes = CURVE_DTYPES if dtypes is None else dtypes
    live = [k for k in ROUND_CURVE_KEYS if rows and torch.is_tensor(rows[0][k])]
    table = np.zeros((len(rows), len(ROUND_CURVE_KEYS)), np.float64)
    if live:
        vals = torch.stack([
            torch.stack([r[k].to(torch.float64) for k in live]) for r in rows
        ]).cpu().numpy()
        for j, k in enumerate(live):
            table[:, ROUND_CURVE_KEYS.index(k)] = vals[:, j]
    out = {}
    for i, k in enumerate(ROUND_CURVE_KEYS):
        dt = np.dtype(dtypes[k])
        col = table[:, i]
        out[k] = col.astype(dt) if dt.kind == "f" else col.astype(np.int64).astype(dt)
    return out


def curve_array(curves: dict, key: str) -> np.ndarray:
    """Curve as float64, zero-filled to the record's round count when the
    key is absent (a flight recorded before a plane existed replays as
    zeros for it): the fallback every host-side analyzer shares."""
    if key in curves:
        return np.asarray(curves[key], dtype=np.float64)
    n = len(np.asarray(curves.get("round", curves.get("msgs", []))))
    return np.zeros(n, dtype=np.float64)


FLIGHT_SCHEMA = "corro-flight/1"


def flight_segments(path: str) -> list[str]:
    """Every file of a (possibly rotated) flight record, oldest first:
    ``path.1``, ``path.2``, ..., then the live ``path``. Non-numeric
    suffixes are not segments."""
    segs = []
    for p in glob.glob(glob.escape(path) + ".*"):
        sfx = p[len(path) + 1:]
        if sfx.isdigit():
            segs.append((int(sfx), p))
    out = [p for _n, p in sorted(segs)]
    if os.path.exists(path):
        out.append(path)
    return out


class FlightRecorder:
    """Streams per-round kernel curves to JSONL at chunk boundaries.

    One ``{"kind": "round", "round": r, <curve values>}`` line per round,
    a ``{"kind": "chunk", ...}`` marker per flushed chunk (with its wall
    time) and a self-describing ``{"kind": "flight", "schema":
    "corro-flight/1", "segment": ...}`` header per open. Every line is
    flushed as written, so a crash loses at most the chunk in flight and
    a torn last line, which ``replay_flight`` skips.

    ``mode="a"`` (default) lets a resumed run append to the same record;
    ``mode="w"`` starts afresh and removes stale rotated segments.
    ``max_bytes`` rotates at chunk boundaries only: the live file moves to
    ``path.N`` (oldest ``.1``) and a fresh ``path`` opens with the next
    segment's header; an appending recorder numbers past the segments
    already there.
    """

    def __init__(
        self, path: str, engine: str = "dense", mode: str = "a",
        max_bytes: int | None = None,
    ):
        self.path = path
        self.engine = engine
        self.max_bytes = max_bytes
        existing = flight_segments(path)
        if mode == "w":
            for p in existing:
                if p != path:
                    os.remove(p)
            self._segment = 0
        else:
            self._segment = max(
                (int(p[len(path) + 1:]) for p in existing if p != path), default=0
            )
        self._f: IO[str] | None = open(path, mode)
        self._write_header()

    def _write_header(self) -> None:
        self._write({
            "kind": "flight", "schema": FLIGHT_SCHEMA, "version": 1,
            "engine": self.engine, "segment": self._segment, "t_unix": time.time(),
        })

    def _write(self, obj: dict) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def record_event(self, obj: dict) -> None:
        """Append one out-of-band event line. The kinds ``round``,
        ``chunk`` and ``flight`` belong to the recorder and are refused."""
        if self._f is None:
            raise ValueError("FlightRecorder is closed")
        if obj.get("kind") in ("round", "chunk", "flight"):
            raise ValueError(f"record_event cannot write reserved kind {obj.get('kind')!r}")
        self._write(obj)

    def record_chunk(self, start_round: int, curves: dict, wall_s: float | None = None) -> None:
        """Flush one chunk's per-round curves (rounds are absolute):
        floating columns as floats, the rest as ints."""
        if self._f is None:
            raise ValueError("FlightRecorder is closed")
        keys = [k for k in ROUND_CURVE_KEYS if k in curves]
        n = len(np.asarray(curves[keys[0]])) if keys else 0
        cols = {k: np.asarray(curves[k]) for k in keys}
        for i in range(n):
            obj = {"kind": "round", "round": int(start_round) + i}
            for k in keys:
                v = cols[k][i]
                obj[k] = float(v) if np.issubdtype(cols[k].dtype, np.floating) else int(v)
            self._write(obj)
        marker = {"kind": "chunk", "start": int(start_round), "rounds": n}
        if wall_s is not None:
            marker["wall_s"] = round(float(wall_s), 6)
        self._write(marker)
        if self.max_bytes is not None and self._f.tell() >= self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Roll the live file to ``path.N`` and open a fresh segment."""
        self._f.close()
        self._segment += 1
        os.replace(self.path, f"{self.path}.{self._segment}")
        self._f = open(self.path, "w")
        self._write_header()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def replay_flight(path: str) -> tuple[dict, list[dict]]:
    """Rebuild (curves, chunk markers) from a flight JSONL and its rotated
    segments, oldest first. Unparsable lines (a torn write) are skipped;
    rounds are sorted, a repeated round keeps its last record, and the
    curves hold only the keys the file recorded, plus ``round``."""
    rows: dict[int, dict] = {}
    chunks: list[dict] = []
    for seg in flight_segments(path) or [path]:
        with open(seg) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                kind = obj.get("kind")
                if kind == "round" and "round" in obj:
                    rows[int(obj["round"])] = obj
                elif kind == "chunk":
                    chunks.append(obj)
    order = sorted(rows)
    keys = [k for k in ROUND_CURVE_KEYS if any(k in rows[r] for r in order)]
    curves = {k: np.asarray([rows[r].get(k, 0) for r in order]) for k in keys}
    curves["round"] = np.asarray(order, np.int64)
    return curves, chunks


def publish_curves(registry, curves: dict, engine: str = "dense") -> None:
    """Fold finished-run curves into a metrics registry: per key a
    ``<series>_total{engine}`` counter of the summed curve, a
    ``<series>_last`` gauge for the level curves, the propagation plane's
    link and rumor-age curves as three aggregate counters, and
    ``corro_kernel_rounds_total``."""
    link_total = {"same": 0.0, "cross": 0.0}
    link_seen = rumor_seen = False
    rumor_total = 0.0
    n = 0
    for k in ROUND_CURVE_KEYS:
        if k not in curves:
            continue
        arr = np.asarray(curves[k], dtype=np.float64)
        if k in LINK_CURVE_KEYS:
            link_seen = True
            i, j = k[len("link_"):]
            link_total["same" if i == j else "cross"] += float(arr.sum())
            continue
        if k in RUMOR_AGE_KEYS:
            rumor_seen = True
            rumor_total += float(arr.sum())
            continue
        n = max(n, arr.size)
        registry.counter(
            f"{series_name(k)}_total", f"kernel plane: summed per-round {k}",
        ).inc(float(arr.sum()), engine=engine)
        if k in LEVEL_CURVE_KEYS and arr.size:
            registry.gauge(
                f"{series_name(k)}_last", f"kernel plane: end-of-run {k}",
            ).set(float(arr[-1]), engine=engine)
    if link_seen:
        for rel, help_ in (("same", "within one region"), ("cross", "between regions")):
            registry.counter(
                f"corro_kernel_prop_link_{rel}_region_total",
                f"propagation plane: delivered copies {help_}",
            ).inc(link_total[rel], engine=engine)
    if rumor_seen:
        registry.counter(
            "corro_kernel_prop_rumor_events_total",
            "propagation plane: first deliveries bucketed by rumor age",
        ).inc(rumor_total, engine=engine)
    registry.counter(
        "corro_kernel_rounds_total", "kernel plane: simulated rounds"
    ).inc(float(n), engine=engine)


def _synchronize(tree) -> None:
    """Wait for the card to finish the work behind ``tree``'s tensors
    (nothing to wait for on the CPU)."""
    stack = [tree]
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


@dataclass
class KernelTelemetry:
    """Per-run telemetry sinks threaded through an engine's run as ``telemetry=``.

    Any subset may be set: ``recorder`` streams JSONL per chunk,
    ``registry`` receives the ``corro_kernel_*`` series at run end and a
    ``corro_kernel_chunk_seconds`` histogram per chunk, ``tracer`` opens a
    ``kernel_chunk`` span around each chunk, ``progress`` gets one status
    line per chunk, and ``series`` (duck-typed ``sample(registry, t,
    exclude)``) takes one registry snapshot per chunk boundary at the
    absolute round reached, with the level gauges refreshed first.
    ``chunk_walls`` collects (rounds, wall seconds) per chunk.
    """

    engine: str = "dense"
    recorder: FlightRecorder | None = None
    registry: object | None = None
    tracer: object | None = None
    progress: IO[str] | None = None
    chunk_walls: list = field(default_factory=list)
    series: object | None = None
    series_exclude: tuple = ("corro_kernel_chunk_seconds",)

    def run_chunk(self, start_round: int, fn: Callable):
        """Run one chunk ``fn() -> (state, curves)`` under a span, time it
        until the card has finished it, then flush it to every sink.

        The port's round is eager, so the wall holds the host's enqueue of
        the chunk's launches as well as the device's work. No curve value
        is read inside the timed window."""
        span_cm = (
            self.tracer.span("kernel_chunk", engine=self.engine, start_round=int(start_round))
            if self.tracer is not None else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with span_cm as span:
            state, curves = fn()
            _synchronize(state)
            wall = time.perf_counter() - t0
            n = len(np.asarray(next(iter(curves.values())))) if curves else 0
            if span is not None:
                span.set_attr("rounds", n)
                span.set_attr("wall_s", round(wall, 6))
        self.on_chunk(start_round, curves, wall, n_rounds=n)
        return state, curves

    def on_chunk(
        self, start_round: int, curves: dict, wall_s: float, n_rounds: int | None = None,
    ) -> None:
        if n_rounds is not None:
            n = n_rounds
        else:
            n = len(np.asarray(next(iter(curves.values())))) if curves else 0
        self.chunk_walls.append((n, wall_s))
        if self.registry is not None:
            self.registry.histogram(
                "corro_kernel_chunk_seconds", "kernel plane: wall seconds per chunk execution",
            ).observe(wall_s, engine=self.engine)
        if self.recorder is not None:
            self.recorder.record_chunk(start_round, curves, wall_s)
        if self.series is not None and self.registry is not None:
            for k in LEVEL_CURVE_KEYS:
                if k in curves and n:
                    self.registry.gauge(
                        f"{series_name(k)}_last", f"kernel plane: end-of-run {k}",
                    ).set(float(np.asarray(curves[k])[-1]), engine=self.engine)
            self.series.sample(
                self.registry, t=float(int(start_round) + n), exclude=self.series_exclude,
            )
        if self.progress is not None:
            tail = {
                k: int(np.asarray(curves[k])[-1])
                for k in ("need", "mismatches") if k in curves and n
            }
            msgs = int(np.asarray(curves["msgs"]).sum()) if "msgs" in curves else 0
            self.progress.write(
                f"[flight:{self.engine}] rounds "
                f"{int(start_round)}..{int(start_round) + n - 1} "
                f"wall={wall_s:.2f}s msgs={msgs} {json.dumps(tail)}\n"
            )
            self.progress.flush()

    def on_run_end(self, curves: dict) -> None:
        if self.registry is not None:
            publish_curves(self.registry, curves, engine=self.engine)

    @property
    def device_step_ms(self) -> float:
        """Per-round wall over the timed chunks only (host work between
        chunks excluded; the host's enqueue inside them included)."""
        rounds = sum(n for n, _ in self.chunk_walls)
        if rounds == 0:
            return float("nan")
        return sum(w for _, w in self.chunk_walls) / rounds * 1000.0


def flight_path_from_argv(argv, default: str = "flight.jsonl") -> str | None:
    """``--flight`` (a recorder at ``default``) or ``--flight=PATH`` from a
    script's arguments; None when absent. A following token is never
    taken as the path."""
    for a in argv:
        if a == "--flight":
            return default
        if a.startswith("--flight="):
            return a.split("=", 1)[1] or default
    return None

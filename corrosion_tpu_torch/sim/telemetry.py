"""Per-round curve schema of the simulation engines (the parts of
corrosion_tpu/sim/telemetry.py the engines need, the propagation plane's
``prop_curves`` among them).

Every engine emits exactly ``ROUND_CURVE_KEYS``; ``round_curves`` zero-
fills what an engine does not measure. ``CURVE_DTYPES`` gives each key
the numpy dtype the reference's curves carry, so finished curves compare
with the reference's array for array. The flight recorder, the metrics
bridge and plane attribution come with later slices.
"""

from __future__ import annotations

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

# The reference's per-key dtypes: counts summed without a dtype are
# int32, the float observables float32, everything else uint32.
CURVE_DTYPES = {k: np.uint32 for k in ROUND_CURVE_KEYS}
CURVE_DTYPES.update(
    msgs=np.int32, mismatches=np.int32, sessions=np.int32,
    staleness_sum=np.float32, xshard_bytes_ici=np.float32,
    xshard_bytes_dcn=np.float32,
)


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

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each raises on failure; the exit code is nonzero on any fault):

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the one kernel library from the sources in
   ``corrosion_tpu_torch/csrc``: one nvcc per ``.cu`` (sm_90a) and one
   host-compiler run of ``ops.cpp`` (the ``torch.ops.corro`` operators
   every kernel launches through), all at once, then one link; load it.
   The kernel-library ledger (``obs.ledger``) is installed first, so the
   build and the load land in its window;
3. each kernel against its plain PyTorch version on the same CUDA inputs,
   on edge cases (0-width axes, out-of-range indices, bit 31, and widths
   10,000 and 16,384, which take every row kernel's shared-memory opt-in;
   the row gathers in each form and both semantics, with a broadcast
   index, odd M and W, an index at an odd storage offset and M either side
   of the form rule; ``table_gather`` at W = 1, 2,048 and 100,000, the
   latter served from L2, with n from 0 to 3, one block of 1,024 outputs
   either side and several blocks and one, and an index at an odd storage
   offset) and at every shape each main path gives it
   (wan_100k and anywrite_sparse: the fast path's kernels with every
   ``rowgather`` site — base gather, CRDT winner check, sync grants,
   ``visibility``, and anywrite's ``cold_sync`` grants, also at the
   partitioned round's per-position shapes; merge_10k:
   ``rowmax`` and ``rowgather`` in the CRDT merge, ``rowgather`` in the
   sync grants and ``visibility``, ``delivery_reduce`` at W = 10,000,
   ``rowgather_wide`` and ``rowsum``; anywrite_sparse also ``table_gather``
   in the sync grants and in ``rotate``) — exact equality required. Each is
   timed beside its plain version, one PyTorch library call where one
   computes the same function, and the byte/operation bound: CUDA events
   around runs of back-to-back calls (at least 50 and 20 ms) rotating over
   input copies that together exceed the 50 MB L2 (``ms``, median of three
   such runs taken in turns with the other functions timed at that shape),
   the host's enqueue time a call
   (``host_ms``, beside the library call's ``library_host_ms``),
   the kernel's device time a call from torch.profiler with the CUDA
   activity alone (``device_ms``, the kernel only) and
   the old single-call window (``single_ms``); a log line gives the
   phase's seconds by part (``Split``). The row gathers are also
   timed in each form (``scalar_ms``, ``pairs_ms``), ``table_gather``
   beside a copy of its index (``clone_ms``: its bytes, no gather),
   ``delivery_reduce``
   at merge_10k against two ``rowmax`` and a max pass, and ``rowsum``
   against ``torch.zeros`` + ``scatter_add_`` (no single call makes its
   fresh plane). The adaptive-dissemination paths add ``table_gather`` at
   the intake priority ([512] <- [100000, 144]) and the saturation test
   ([512] <- [100000, 48]), with a 2-D index at an odd storage offset and a
   non-contiguous one (refused), and ``rowgather`` at the rumor kill's
   watermark lookup; the geo scenario's shapes (10,000 rows, 16 writers)
   for every kernel it launches; ``mixed_storm``'s (1,000 rows, 64
   writers, 512 cells) for the fast path's kernels, the sync sessions'
   CRDT merge ([125, 512]) and the big versions' admission merge, one
   column a stream ([1000, 1] -> [1000, 512]), and the adaptive mixed
   run's ``table_gather`` at n = 64; phase 15's ``loadgen soak`` at 96
   nodes (the fast path's gathers, reductions and window) and at 10,000
   (the legacy gather, ``rowsum``, the reductions and ``visibility``), and
   its fidelity replay at 10,000 nodes and 3 writers (the fast path's
   gathers, reductions and window). The inputs are made on the card from
   one seeded generator, and every object alive when the phase starts is
   frozen out of the collector's walks (``gc.freeze``);
4. small runs on the card (kernels) and on the CPU (plain versions), with
   identical curves and final state: ``wan_100k(n=2000, ...)``,
   ``three_node(n_inserts=504)``, ``churn_32(rounds=128)`` and its wipe
   variant,
   ``anti_entropy_1k()``, a merge_10k burst variant at n=2560 (wider than
   2048 writers, so it takes the legacy delivery and launches
   ``rowgather_wide`` and ``rowsum``), and ``anywrite_sparse(n=2000,
   rounds=32, ...)`` with fewer hot slots than active writers under a
   partition (forced
   demotions, cold healing, ``table_gather``); then the adaptive plane
   (``health.ADAPTIVE_GOSSIP``): ``wan_100k(n=2000, rounds=48)`` with
   8-bucket sketches (sketch scoring forced), the merge_10k burst at
   n=2560 over 24 rounds (the legacy delivery; its CPU side is the slow
   one), ``churned_demo_cluster(96, 48, geo=True,
   adaptive=True)`` and the anywrite run with ``prop_observe``; then the
   chunk plane's tie-sensitive picks at 1.6 M rows, ``anti_entropy_chunks(
   n=48, streams=4, rounds=48)`` plain and under a fault plan (loss,
   churn, a wipe that spares the origins), and ``mixed_storm(n=64, streams=2, rounds=24)``
   without cells, with cells, under kill/revive/wipe and adaptive with
   ``prop_observe`` (conservation). The CPU side of every small run (and
   of phase 12's invariant suite, phase 15's ``loadgen soak`` and its
   fidelity plane's ``dcn_partition``) goes in
   one worker process, started with the card's side and checked after
   phase 11: it runs at the lowest priority with a core left to this
   process, beside phases 4-11;
5. full-size ``wan_100k()`` (100,000 nodes, 20 regions, 512 writers), all
   240 rounds in chunks of 12: its four kernels launched, the watermark
   invariants; its telemetry also carries the port's metrics bridge (a
   ``MetricsRegistry``, a ``Tracer`` exporting to ``build/flights`` and a
   ``MetricSeriesRecorder`` with ``clock=None``): one series header and 20
   samples at rounds 12, 24, ..., 240, ``corro_kernel_rounds_total`` 240
   and every ``corro_kernel_*_total`` counter its curve's float64 sum, 20
   ``kernel_chunk`` spans, and the endurance report over the series ok
   (the soak lane's kernel detectors at 100,000 nodes); the final cell
   planes, watermarks, window words and alive mask are held on the host
   for phase 15, which moves them back to the card and frees them;
6. full-size ``merge_10k()`` (10,000 nodes, 10,000 writers), all 120
   rounds in chunks of 12: ``rowgather_wide``, ``rowmax``, ``rowgather``
   and ``delivery_reduce`` launched, the watermark invariants;
7. full-size ``anywrite_sparse()`` (100,000 nodes, any of them a writer,
   2,048 hot slots), all 320 rounds, epoch by epoch: converged, no
   deviation entry dropped, ``table_gather``, ``rowmax``, ``rowgather``
   and ``delivery_reduce`` launched, the watermark invariants; its state
   after 48 rounds is held on the host for phase 13;
8. ``wan_100k_adaptive``: full-size ``wan_100k()`` with
   ``ADAPTIVE_GOSSIP`` and 8-bucket sync sketches, its first
   ``ADAPTIVE_ROUNDS`` (120) rounds in chunks of 12: its five kernels
   launched (``table_gather`` among them), the watermark invariants;
9. ``geo_10k``: ``churned_demo_cluster(nodes=10_000, rounds=64, geo=True)``
   (4 regions, 16 writers, a kill/revive wave of 625 nodes, dense SWIM,
   ``prop_observe``), push-only and adaptive: the propagation plane's
   conservation identities on the card's curves, rumor kills in the
   adaptive run, and each run's delivered copies, peak backlog and
   convergence round;
10. the chunk plane: ``anti_entropy_chunks()`` (1,000 nodes, 16 streams
   of 8,192 seqs, 240 rounds: converged), then at 100,000 nodes (1.6 M
   (node, stream) rows, the first 48 rounds: the interval invariants,
   reassembly that never falls), 24 rounds a call; no kernel launched;
   the 100,000-node run's state after its first call is held on the host
   for phase 13;
11. ``mixed_storm()`` (1,000 nodes, 64 writers, 16 big transactions of
   2,048 seqs, 512 cells, 200 rounds), 25 rounds a call: converged on both
   planes with every node's cells equal to the serial-merge ground truth
   of the final heads, ``rowmax``, ``rowgather``, ``delivery_reduce`` and
   ``window_delivery`` launched; its state after round 75 is held on the
   host for phase 13;
12. the curve consumers, through the command line (``cli.main`` in this
   process, no ``--device``: the CLI resolves CUDA): the reference CI's
   flight commands, ``obs record`` of the committed demo flights (96
   nodes, 48 rounds, churn, seed 0; flat, geo, geo adaptive), ``obs
   report --json`` and ``obs epidemic report``, then ``obs diff
   CONVERGENCE_BASELINE.json`` and ``obs epidemic diff
   EPIDEMIC_BASELINE.json`` (``EPIDEMIC_BASELINE_ADAPTIVE.json``) at the
   CI's tolerance 0.35, each exiting 0 (``cli_obs_demo``); ``chaos run
   kitchen-sink --engines dense,sparse,chunk,mixed --json``, every report
   ok and the card's facts, violations and recovery equal to the CPU's
   (run in phase 4's worker; ``cli_chaos``); and a ``save_state``/
   ``load_state`` round trip of a 50-round churn_32 run on the card;
13. the shard driver and the elastic plane: full-width ``wan_100k()`` on
   a (2, 2) mesh of card positions (all on one card when there is one),
   24 rounds in calls of 12: curves equal to phase 5's first 24 rounds but
   the exchange's byte keys, the final state equal to phase 5's at round
   24, the exchange bytes equal to ``traffic_model`` and each position's
   state bytes equal to the prediction; full-width ``anywrite_sparse()``
   partitioned on the same mesh, one round under the structural check and
   then its first 48 rounds (through the first epoch boundary that retires
   slots): curves, state and info equal to phase 7's at that round, every
   position's state bytes equal to the prediction after every round, its
   ms/round, peak memory (at or below phase 7's over the same rounds) and
   exchange bytes by tag printed; the 100,000-node chunk plane (400,000
   (node, stream) rows a position) and full-size ``mixed_storm()``
   partitioned on the same mesh, each after one round under the structural
   check: 24 rounds equal to phase 10's first call (curves, coverage, vis)
   and 75 rounds in calls of 25 equal to phase 11's at round 75 (curves
   but the exchange's byte keys, held to ``traffic_model``, and every
   state leaf), each position's state bytes equal to the prediction after
   every round, each peak at or below the unsharded run's over the same
   rounds, ms/round and exchange bytes by tag printed; phase 4's
   ``anywrite_sparse(n=2000,
   rounds=32, ...)`` on 4 positions (forced demotions: the partitioned
   cold plane) and the merge_10k burst at n=2560 (the legacy delivery, 24
   rounds) on 2, each equal to its unsharded card run;
   the elastic drills
   (``reshard_{dense,sparse,chunk,mixed}_4to8``, ``preempt_dense_churn``,
   ``soak_preempt``) on the card, each equal to its uninterrupted run, the
   preemption's recovery machinery fired, the soak drill's counter resets
   classified as restarts in a series of one header, the budget gate ok on
   its survival fields, each report equal to the CPU's; the drills' card
   side (``python3 chip_smoke.py --card-elastic-drills OUT``) and CPU side
   (``--cpu-elastic-drills OUT``) run in processes of their own, started
   with phase 12 and joined here (they are host-paced and claim no time).
   Phase 3 times the kernels at the shard bodies' row blocks;
14. the bench harness and the device-cost plane: merge_10k in full (seed
   1) with the ledger armed and ``KernelTelemetry(ledger=, watermarks=)``,
   its plane attribution and roofline stage costs, the bench report put
   together as the reference bench does and passed through
   ``check_bench_invariants`` (``steady_compiles`` 0); the multi-device lane
   (``measure_multichip``) at D = 1, 2, 4, 8 on card positions, 24 rounds
   (``LANE_ROUNDS``; the reference's 32), equal across D with exchange
   bytes equal to ``traffic_model``; ``obs cost show`` (the cost model
   of the four engines at their tiny configs, D = 1 and 4) on the card,
   equal in flops, bytes and kernel calls to the CPU's (built by phase 4's
   worker), and ``obs cost diff`` of its file against itself exiting 0;
   and the capacity curve against
   the card's memory, its 512-node point exact and its 100,352-node point
   a placement measured here;
15. the host oracles against the card's planes (``sim/host_oracles.py``):
   the reference's two possession-window traces through
   ``gossip.broadcast_round`` on the card, fast delivery
   (``delivery_reduce``, ``window_delivery``) and legacy (``rowgather_wide``,
   ``rowsum``), possession and need sets equal to ``BookedVersions`` after
   every delivered round; the writer rotation trace (``table_gather``),
   claims equal to the bookies'; the interval sets against
   ``Partial``/``RangeSet`` in eight small trials and at 1.6 M rows (32
   batched chunk arrivals, 2,000 rows replayed on the host); the native
   codec built on the card's host (``build/native``), equal to the Python
   codec, with the transport's frames (kind 1 and kind 0, decoded by the
   pure-Python decoder) and one loopback exchange of two ``Transport``s
   on 127.0.0.1 (a frame, a datagram, a sync session); then the agent's
   host oracles: the SQLite CRDT ``Store`` against the reference's six
   random-stream trials (``crdt.apply_changes`` on the card), against the
   engines' cell merge on 16 nodes x 256 cells (``rowmax``,
   ``rowgather``) and against phase 5's final wan_100k cells (every
   committed version in two orders == ``serial_merge_reference``; every
   converged alive row equal to the store in one broadcast compare; at
   round 24, kept by phase 13 on the host, 16 rows that fall short of
   ``head`` each equal to a store of exactly the versions they hold); the
   kernels' down-member GC beside the host ``Swim``'s GC and
   adaptive transmissions; 40 seeds of sync's ring preference (the grants
   merged into cells: ``rowmax``, ``rowgather``; node 0's row equal to a
   store) and ``rtt_ring``'s edges; and ``obs.journey`` over
   phase 5's flight with the schedule's write trace. Then the agent
   runtime: 16 of the port's agents live on 127.0.0.1
   (``agent.testing.launch_test_agent``, bootstrapped at random), each
   recorded by ``sim.trace.Trace``, take 48 conflicting upserts over HTTP
   through ``CorrosionApiClient``; once their digests agree, a
   subscription on agent 0 equals the table, every agent's change log
   merged on the card in one shuffled batch (``crdt.apply_changes``)
   equals every agent's rows, and agent 0's online backup restored into a
   fresh agent through ``AdminClient`` has its digest; and the recorded
   traffic replayed (``sim.trace.replay``) in a 10,000-node cluster on the
   card (``rowmax``, ``rowgather``, ``delivery_reduce``,
   ``window_delivery``): each writer's head equal to its agent's committed
   versions and every alive node converged. Then the serving plane:
   ``loadgen soak`` (``loadgen.scenarios.intake_policy``) at its defaults
   (96 nodes, the fast delivery path) equal to phase 4's CPU run with its
   collapse rule holding, and at 10,000 nodes, every node a writer (the
   legacy delivery: W = 10,000), each run held to the watermark
   invariants, its seconds, the peak memory and the backlog's slopes
   logged; the 2,000-subscription fan-out storm (``loadgen run``, 60
   writes at 10/s, reads over HTTP and the PG wire) with no oracle
   violation, its table equal to the card's merge of its change log and
   to a read through a fresh ``agent.pg.serve_pg``; the saturation sweep
   (``loadgen sweep``) with its three flags true; and three agents
   gossiping over mutual TLS with certificates from ``agent.tls``, or a
   ``{"tls": "cryptography absent"}`` line where that package is missing.
   Then the chaos and fidelity planes: ``fidelity steady`` and ``burst``
   (``fidelity.scenarios.steady_load``, ``burst_drain``) at their defaults,
   three port agents on 127.0.0.1 calibrating their own round model, both
   replays of each trace on the card (``rowgather``, ``delivery_reduce``)
   with the calibrated one strictly closer to the live CDF, nothing
   unseen, each replay equal to the CPU's on the same trace; the steady
   trace replayed at 10,000 nodes (``fidelity.compare.kernel_replay``)
   calibrated with ``ROUND_MODEL_WAN.json`` and at 500 ms, nothing unseen
   (``rowgather``, ``delivery_reduce``, ``window_delivery``);
   ``dcn_partition`` at its shape (all four fast-path kernels), its
   invariant cross-check ok, both runs recovered, equal to phase 4's CPU
   run; ``hostchaos`` ``wan_steady`` and ``kill_restart`` with no oracle
   violation, converged, their required machinery fired and every agent's
   table equal to the card's merge of their change logs; and the
   endurance soak's host lane (``soak_churn`` with the series recorder),
   no wedge, stall or SLO breach, the killed agent's resets classified
   restart. The stores' files and the agents' data directories go under
   ``build/host_oracles``;
16. the command line (``python -m corrosion_tpu_torch``; phases 12 and 14
   take its other paths): ``obs record --nodes 10000 --rounds 64 --churn
   --geo --seed 0`` (phase 9's push-only geo_10k, in chunks of 16), its
   flight's per-round curves equal to phase 9's push run's and its
   convergence rounds equal to phase 9's, ``obs report --json`` and ``obs
   epidemic report --nodes 10000 --geo-regions 4`` on it, its ms a round,
   peak memory and the membership's mismatched beliefs logged
   (``cli_geo_10k``); ``lint corrosion_tpu_torch --show-suppressed`` exit 0
   with each suppression's reason, and ``lint --sanitize --no-static
   --device cuda`` exit 0 on the four engines, each run twice, the second
   with 0 builds and 0 loads of the kernel library (``cli_lint``); and
   ``python -m corrosion_tpu_torch`` as processes of their own: ``lint
   --list-rules``, and, beside the other two paths, ``obs cost diff
   COST_BASELINE.json`` (the reference's JAX model) without ``--device``,
   its model measured on the card and its breaches logged, not gated
   (``cli_module``).

Phases 5 (wan_100k), 10 (anti_entropy_chunks at 1,000 nodes) and 11 pass
``telemetry=KernelTelemetry(recorder=FlightRecorder(...), progress=
sys.stderr)`` to every call: each flight record (under ``build/flights``)
must replay to the run's curves, key for key and round for round, and the
recorder's ``device_step_ms`` is logged beside the CUDA-event ms/round.

The launch counts are reset just before each main-path run (phases 5-8
and 11, the pairs of runs of phases 9 and 10, each of phase 12's three
paths, each of phase 13's seven paths, each of phase 14's paths: the
merge_10k run, its plane attribution, the multi-device lane's sharded
runs, read at the lane's note that its attribution begins, that
attribution, and ``obs cost show`` with its self-diff, each of phase
15's twenty-four paths and each of phase 16's three) and read just after
it. Each phase logs its wall time. The last lines are a ``kernels`` JSON line,
the nvidia-smi line, and the result line ``{"ok": true, "device": {...}}``.
Each kernel's entry carries its launches summed over the paths and,
under ``by_path``, each path's launches and the times and bound of every
shape measured on it; its top-level times are those of its first shape.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# INT32 outside the tensor cores: half the data sheet's 67 TFLOP/s float32,
# since a Hopper SM issues 64 INT32 lanes a clock against 128 FP32 lanes.
H100_INT_OPS_PER_S = 33.5e12
L2_BYTES = 50 * 2**20  # H100 L2 cache
RUN_CALLS = 50  # back-to-back calls a timed run at least (in whole cycles of copies)
MIN_RUN_MS = 20.0  # and at least this long
RUNS = 3  # timed runs a function, in turns with the others; the median counts

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "rowmax": ("corrosion_tpu_torch/csrc/rowmax.cu",
               "corrosion_tpu/ops/onehot.py:177"),
    "rowgather": ("corrosion_tpu_torch/csrc/rowgather.cu",
                  "corrosion_tpu/ops/onehot.py:561"),
    "delivery_reduce": ("corrosion_tpu_torch/csrc/delivery_reduce.cu",
                        "corrosion_tpu/ops/onehot.py:637"),
    "window_delivery": ("corrosion_tpu_torch/csrc/window_delivery.cu",
                        "corrosion_tpu/ops/onehot.py:729"),
    "rowgather_wide": ("corrosion_tpu_torch/csrc/rowgather.cu",
                       "corrosion_tpu/ops/onehot.py:261"),
    "rowsum": ("corrosion_tpu_torch/csrc/rowsum.cu",
               "corrosion_tpu/ops/onehot.py:487"),
    "table_gather": ("corrosion_tpu_torch/csrc/table_gather.cu",
                     "corrosion_tpu/ops/onehot.py:383"),
}
# Kernels each main path must launch.
PATH_KERNELS = {
    "wan_100k": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "merge_10k": ("rowgather_wide", "rowmax", "rowgather", "delivery_reduce"),
    "anywrite_sparse": ("table_gather", "rowmax", "rowgather", "delivery_reduce"),
    "wan_100k_adaptive": ("rowmax", "rowgather", "delivery_reduce", "window_delivery",
                          "table_gather"),
    "geo_10k": ("rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    "anti_entropy_chunks": (),
    "mixed_storm": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    # Phase 12, through the command line: the three demo flights (the
    # adaptive one launches table_gather), the invariant suite on four
    # engines, and the checkpointed churn_32 run.
    "cli_obs_demo": ("rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    "cli_chaos": ("rowmax", "rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    "checkpoint": ("rowmax", "rowgather", "delivery_reduce"),
    # Phase 13: the shard driver's bodies and the elastic drills.
    "wan_100k_sharded": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "anywrite_sparse_sharded": ("table_gather", "rowmax", "rowgather", "delivery_reduce",
                                "window_delivery"),
    "anywrite_sparse_small_sharded": ("table_gather", "rowmax", "rowgather", "delivery_reduce"),
    "merge_10k_sharded": ("rowgather_wide", "rowsum", "rowmax", "rowgather", "delivery_reduce"),
    # The partitioned chunk plane launches no kernel; the partitioned mixed
    # round launches the fast path's four inside its position bodies.
    "anti_entropy_chunks_sharded": (),
    "mixed_storm_sharded": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "elastic": ("rowmax", "rowgather", "delivery_reduce", "window_delivery", "table_gather"),
    # Phase 14: the bench harness (merge_10k's legacy delivery, the
    # multi-device lane's 512-node fast path and its sparse plane, the
    # cost model's tiny configs), and the plane attribution after each of
    # the two runs (the composite steps over the final state).
    "bench_merge_10k": ("rowgather_wide", "rowsum", "rowmax", "rowgather", "delivery_reduce"),
    "bench_attribution": ("rowgather_wide", "rowmax", "rowgather", "delivery_reduce"),
    "bench_multichip": ("rowmax", "rowgather", "delivery_reduce", "window_delivery",
                        "table_gather"),
    "bench_multichip_attribution": ("rowmax", "rowgather", "delivery_reduce"),
    # ``obs cost show`` and its self-diff (D = 1 and 4).
    "cli_cost": ("rowmax", "rowgather", "delivery_reduce", "table_gather"),
    # Phase 15: the host oracles against the card's planes (the possession
    # window on each delivery path, the writer rotation, the chunk
    # plane's interval sets, which have no kernel, and the native codec).
    "window_bookie_fast": ("delivery_reduce", "window_delivery"),
    "window_bookie_legacy": ("rowgather_wide", "rowsum", "delivery_reduce"),
    "rotation_bookie": ("table_gather",),
    "coverage_rangeset": (),
    "native_codec": (),
    # The agent's host oracles: the CRDT store against the cell merges
    # (the trials' scatter merge and phase 5's final state launch nothing
    # themselves), the host SWIM beside the kernels' GC, sync's ring
    # preference, and write journeys over phase 5's flight.
    "store_crdt_trials": (),
    "store_crdt_plane": ("rowmax", "rowgather"),
    "store_crdt_full": (),
    "membership_gc": (),
    "membership_rings": ("rowmax", "rowgather"),
    "journey_wan_100k": (),
    # The agent runtime: the live cluster's change logs merged on the card
    # (``apply_changes`` launches nothing), and its recorded traffic
    # replayed at 10,000 nodes on the fast delivery path (W = 16).
    "agent_cluster_live": (),
    "agent_trace_replay": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    # The serving plane: loadgen soak on the fast delivery path (96
    # nodes, no cells: no rowmax) and on the legacy one (10,000 writers,
    # no window_delivery; visibility's rowgather); the storm, the sweep
    # and gossip TLS are host code (the storm's merge launches nothing).
    "loadgen_soak": ("rowgather", "delivery_reduce", "window_delivery"),
    "loadgen_soak_10k": ("rowgather_wide", "rowsum", "rowgather", "delivery_reduce"),
    "loadgen_storm": (),
    "loadgen_sweep": (),
    "agent_tls": (),
    # The chaos and fidelity planes: the live runs' replays at 3 nodes (no
    # cells: no rowmax; no window either) and the steady trace's at 10,000
    # (the fast delivery path), the DCN scenario at 48 nodes (its
    # invariant cross-check carries cells); host chaos is host code (its
    # merge launches nothing).
    "fidelity_steady": ("rowgather", "delivery_reduce"),
    "fidelity_burst": ("rowgather", "delivery_reduce"),
    "fidelity_replay_10k": ("rowgather", "delivery_reduce", "window_delivery"),
    "fidelity_dcn": ("rowmax", "rowgather", "delivery_reduce", "window_delivery"),
    "hostchaos_smoke": (),
    "hostchaos_soak": (),
    # Phase 16: the command line. Phase 9's push-only geo_10k through
    # ``obs record``; the sanitizer's tiny engines (the cost model's
    # configs); ``python -m`` in its own process (its launches are that
    # process's).
    "cli_geo_10k": ("rowgather", "delivery_reduce", "window_delivery"),
    "cli_lint": ("rowmax", "rowgather", "delivery_reduce", "table_gather"),
    "cli_module": (),
}
# Phase 13 runs wan_100k's first rounds sharded; phase 5 keeps its state
# and curves there to hold them to.
SHARDED_ROUNDS = 24
ELASTIC_DRILLS = ("reshard_dense_4to8", "reshard_sparse_4to8", "reshard_chunk_4to8",
                  "reshard_mixed_4to8", "preempt_dense_churn", "soak_preempt")
# Phase 13 runs anywrite_sparse's first epochs partitioned, through the
# first boundary that retires slots (epoch 2, round 32); phase 7 keeps its
# state and curves there to hold them to.
SPARSE_SHARDED_ROUNDS = 48
# Phase 13's merge_10k burst at n=2560 on 2 positions (48 in phase 4).
MERGE_SHARDED_ROUNDS = 24
# Phase 8's wan_100k_adaptive: the first half of the 240-round schedule,
# cut to make room for the partitioned round's host time in phases 13-14
# (its kernels all launch in the first rounds; nothing of it is kept).
ADAPTIVE_ROUNDS = 120
CHUNK_100K_ROUNDS = 48  # phase 10's 100,000-node run (the 1,000-node run takes all 240)
# Phase 13 runs the 100,000-node chunk plane's first call (24 rounds) and
# mixed_storm's first three calls of 25 (through round 75: 12 of its 16
# big versions commit before then) partitioned; phases 10 and 11 keep their
# states and curves there to hold them to.
CHUNK_SHARDED_ROUNDS = 24
MIXED_SHARDED_ROUNDS = 75
CHECKPOINT_ROUNDS = 50  # phase 12's churn_32 run for the checkpoint round trip
COST_DEVICES = (1, 4)  # phase 14's ``obs cost show --devices`` (and its CPU twin's)
# The multi-device lane's rounds in phase 14 (``benchlib.MULTICHIP_ROUNDS``,
# 32, cut to make room for phase 15's chaos and fidelity planes): its
# sharded runs first launch ``window_delivery`` after round 16.
LANE_ROUNDS = 24
REPO = Path(__file__).resolve().parent
FLIGHTS = REPO / "build" / "flights"  # flight records of the telemetry-carrying phases


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event windows of
    one call each: what the host does before the launch falls inside."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _prefix(key: str) -> str:
    return key[: -len("ms")]  # "ms" -> "", "plain_ms" -> "plain_"


class Split:
    """Seconds of phase 3 by part, summed over its sites (``PARTS``);
    ``other`` is what the parts leave of the phase's wall: making the
    inputs, the bounds' touched-word counts, logging."""

    PARTS = ("equality checks", "input copies", "timed event runs", "collector", "single_ms",
             "device_ms")

    def __init__(self):
        self.s = dict.fromkeys(self.PARTS, 0.0)
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] += time.perf_counter() - t0

    def line(self) -> str:
        total = time.perf_counter() - self.t0
        parts = dict(self.s, other=total - sum(self.s.values()))
        return f"{total:.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())


def kernel_device_ms(fn, run, calls: int) -> tuple[float, int]:
    """Device ms a call of ``fn`` from torch.profiler with the CUDA
    activity alone, read from the profiler's own event list: one run of
    ``calls`` calls while tracing starts (the schedule's warm-up step,
    discarded), then one recorded run; every device event (kernel, copy,
    set) of the recorded step counts. Returns (ms, device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            run(fn, calls)
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls, len(events)


def run_ms(fns: dict, inputs: tuple, bytes_per_call: int, split: Split) -> dict:
    """Milliseconds a call of each ``fns[key](*inputs)`` (``fns["ms"]`` the
    kernel), three ways, and the kernel's device time:

    - ``key``: CUDA events around a run of back-to-back calls (at least
      ``RUN_CALLS`` and ``MIN_RUN_MS``), divided by the count; the median
      of ``RUNS`` such runs, taken in turns over the functions. The calls
      rotate over enough copies of ``inputs`` that one cycle moves more
      than the L2 holds, so each finds its data cold;
    - ``<prefix>host_ms``: host time a call to enqueue those runs (median;
      a function of one launch never waits on the card here, one of many
      may once the launch queue fills);
    - ``<prefix>single_ms``: the median single-call window (``cuda_ms``);
    - ``device_ms``: the kernel's device time a call (every kernel, copy
      and set it launches) from torch.profiler over one more run
      (``kernel_device_ms``), and ``device_events``, the device events
      that run recorded.

    Where ``ms`` exceeds ``device_ms`` and meets ``host_ms``, the host
    sets the pace."""
    with split.part("input copies"):
        copies = [inputs] + [
            tuple(t.clone() for t in inputs) for _ in range(L2_BYTES // max(bytes_per_call, 1))
        ]

    def run(fn, calls):
        for i in range(calls):
            fn(*copies[i % len(copies)])

    # The warm-up run (allocator, clocks, caches) also sizes each function's
    # timed runs: at least RUN_CALLS calls and MIN_RUN_MS of events, in whole
    # cycles of the copies, so one host hiccup moves a run little.
    calls = {}
    runs = {key: [] for key in fns}
    with split.part("timed event runs"):
        for key, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(fn, RUN_CALLS)
            b.record()
            b.synchronize()
            want = max(RUN_CALLS, math.ceil(MIN_RUN_MS * RUN_CALLS / max(a.elapsed_time(b), 1e-3)))
            calls[key] = len(copies) * -(-want // len(copies))
    # No collector pause inside a timed run (as timeit): one collection
    # first, the collector off through the site's runs.
    with split.part("collector"):
        gc.collect()
    gc.disable()
    try:
        with split.part("timed event runs"):
            for _ in range(RUNS):
                for key, fn in fns.items():
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    t0 = time.perf_counter()
                    run(fn, calls[key])
                    host = time.perf_counter() - t0
                    b.record()
                    b.synchronize()
                    runs[key].append((a.elapsed_time(b) / calls[key], host * 1e3 / calls[key]))
    finally:
        gc.enable()
    out = {}
    for key, fn in fns.items():
        out[key] = statistics.median(t for t, _ in runs[key])
        out[_prefix(key) + "host_ms"] = statistics.median(h for _, h in runs[key])
        with split.part("single_ms"):
            out[_prefix(key) + "single_ms"] = cuda_ms(lambda: fn(*inputs))
    with split.part("device_ms"):
        out["device_ms"], out["device_events"] = kernel_device_ms(fns["ms"], run, calls["ms"])
    return out


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    tb = bytes_moved / H100_BYTES_PER_S * 1e3
    to = ops / H100_INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs (exactness requires 0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        for g, w in zip(got, want)
    )


# ---- phase 3: kernels against their plain versions -------------------------


def _inputs(g, r, m, w, device):
    """Random kernel inputs: indices with negatives and out-of-range
    columns, u32 values with bit 31 set, random masks."""
    idx = torch.randint(-2, w + 3, (r, m), generator=g, device=device)
    val = torch.randint(0, 1 << 32, (r, m), generator=g, device=device)
    mask = torch.rand((r, m), generator=g, device=device) < 0.7
    return idx, val, mask


GATHER_EDGES = (
    (1, 1, 1), (37, 19, 41), (33, 17, 130), (1001, 144, 512), (2001, 36, 256),
    (40, 128, 511), (40, 127, 512), (40, 255, 512), (40, 256, 512), (40, 257, 512),
    (9, 144, 10_000), (3, 50, 16_384),
)


def check_gathers(onehot, table, idx, where: str) -> None:
    """``rowgather`` and ``rowgather_wide`` equal their plain versions
    through the public wrappers (the rule's form) and in each form forced
    (``onehot._gather``, on non-empty inputs), with ``idx`` and with its
    first row broadcast (row stride 0) as ``[1, M]`` and as an expanded
    view."""
    r, w = table.shape
    forms = onehot.GATHER_FORMS if idx.numel() and w else ()
    bcast = idx[:1]
    for ix in (idx, bcast, bcast.expand(r, -1)) if r else (idx,):
        want = onehot.rowgather_plain(table, ix)
        assert equal(onehot.rowgather(table, ix), want), \
            f"rowgather differs at {where}, idx strides {ix.stride()}"
        for f in forms:
            assert equal(onehot._gather("rowgather", table, ix, False, f), want), \
                f"rowgather ({f}) differs at {where}, idx strides {ix.stride()}"
        if ix is idx:  # rowgather_wide takes a contiguous [R, M] index only
            want = onehot.rowgather_wide_plain(table, ix)
            assert equal(onehot.rowgather_wide(table, ix), want), f"rowgather_wide differs at {where}"
            for f in forms:
                assert equal(onehot._gather("rowgather_wide", table, ix, True, f), want), \
                    f"rowgather_wide ({f}) differs at {where}"


def check_kernels(onehot, device) -> list:
    """Exact equality kernel vs plain on edge cases and at the shapes each
    main path gives each kernel; returns one measurement per kernel and
    shape, in path order."""
    from corrosion_tpu_torch.obs import costs

    g = torch.Generator(device=device).manual_seed(0)
    split = Split()
    t_edges = time.perf_counter()
    # Edge cases: 0-width axes, odd small shapes, both window widths, and
    # widths past every row kernel's 48 KB shared-memory default (16,384
    # columns: 64 KB for rowmax/rowsum and window_delivery at wk=32, 128 KB
    # for delivery_reduce and window_delivery at wk=64), one of them not a
    # multiple of 128.
    for r, m, w in (
        (0, 5, 7), (5, 0, 7), (5, 7, 0), (3, 1, 1), (37, 19, 41), (64, 300, 2049),
        (48, 144, 10_000), (24, 144, 16_384),
    ):
        idx, val, mask = _inputs(g, r, m, w, device)
        for msk in (mask, None):
            got, want = onehot.rowmax(idx, val, msk, w), onehot.rowmax_plain(idx, val, msk, w)
            assert equal(got, want), f"rowmax differs at {(r, m, w)}"
            got, want = onehot.rowsum(idx, val, msk, w), onehot.rowsum_plain(idx, val, msk, w)
            assert equal(got, want), f"rowsum differs at {(r, m, w)}"
        table = torch.randint(0, 1 << 32, (r, w), generator=g, device=device)
        check_gathers(onehot, table, idx, f"{(r, m, w)}")
        seen = torch.randint(0, 1 << 32, (r, w), generator=g, device=device)
        d = torch.randint(0, 200, (r, m), generator=g, device=device)
        applied = mask & (d < 150)
        got = onehot.delivery_reduce(idx, d, val, applied, mask, seen, w)
        want = onehot.delivery_reduce_plain(idx, d, val, applied, mask, seen, w)
        assert all(equal(x, y) for x, y in zip(got, want)), f"delivery_reduce differs at {(r, m, w)}"
        for wk in (32, 64):
            oo = torch.randint(0, 1 << 32, (wk // 32, r, w), generator=g, device=device)
            adv_m = torch.randint(0, 70, (r, m), generator=g, device=device)
            dd = torch.randint(0, 140, (r, m), generator=g, device=device)
            got = onehot.window_delivery(oo, idx, dd, adv_m, mask, wk, w)
            want = onehot.window_delivery_plain(oo, idx, dd, adv_m, mask, wk, w)
            assert all(equal(x, y) for x, y in zip(got, want)), f"window_delivery differs at {(r, m, w, wk)}"
    # The row gathers' forms: odd m (scalar pair tails), odd W, row counts
    # off the tiles, m at the form rule's threshold (W/2) and one either
    # side, W = 10,000 and 16,384.
    for r, m, w in GATHER_EDGES:
        table = torch.randint(0, 1 << 32, (r, w), generator=g, device=device)
        flat = torch.randint(-3, w + 3, (r * m + 1,), generator=g, device=device)
        check_gathers(onehot, table, flat[:-1].view(r, m), f"{(r, m, w)}")
        # A view at an odd storage offset: idx not 16-byte aligned.
        check_gathers(onehot, table, flat[1:].view(r, m), f"{(r, m, w)} offset idx")
    # table_gather: an empty table or index, widths off multiples of 128,
    # 1-D to 3-D indices past both ends; then, at W = 1, 2,048 and 100,000
    # (a table served from L2), n from 0 to 3, one block of 1,024 outputs
    # either side and several blocks and one (the pairs' scalar tail), each
    # index also at an odd storage offset (scalar index loads).
    for w, shape in (
        (0, (4, 5)), (9, (0,)), (9, (3, 0)), (1, (7,)), (37, (19, 41)),
        (2049, (64, 300)), (16_384, (24, 144)), (100_000, (3, 50, 200)),
    ):
        table = torch.randint(0, 1 << 32, (w,), generator=g, device=device)
        idx = torch.randint(-w - 3, 2 * w + 3, shape, generator=g, device=device)
        assert equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx)), \
            f"table_gather differs at W={w}, idx {shape}"
    for w in (1, 2048, 100_000):
        table = torch.randint(0, 1 << 32, (w,), generator=g, device=device)
        for n in (0, 1, 2, 3, 1023, 1024, 1025, 5 * 1024 + 1):
            base = torch.randint(-w - 3, 2 * w + 3, (n + 1,), generator=g, device=device)
            for at, idx in (("aligned", base[:n]), ("odd offset", base[1:])):
                assert equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx)), \
                    f"table_gather differs at W={w}, n={n}, {at} idx"
    # 2-D indices at the adaptive plane's widths: at an odd storage offset
    # (scalar index loads), and a non-contiguous view, which the operator
    # refuses (its contiguous copy gathers).
    for w, r, m in ((512, 1001, 144), (512, 999, 48), (16, 301, 64), (16, 3, 16)):
        table = torch.randint(0, 1 << 32, (w,), generator=g, device=device)
        flat = torch.randint(-w - 3, 2 * w + 3, (r * m + 1,), generator=g, device=device)
        for at, idx in (("aligned", flat[:-1].view(r, m)), ("odd offset", flat[1:].view(r, m))):
            assert equal(onehot.table_gather(table, idx), onehot.table_gather_plain(table, idx)), \
                f"table_gather differs at W={w}, idx [{r},{m}] {at}"
        strided = flat[: r * (m // 2) * 2].view(r, -1)[:, ::2]
        try:
            onehot.table_gather(table, strided)
        except ValueError:
            pass
        else:
            raise AssertionError("table_gather took a non-contiguous index")
        assert equal(onehot.table_gather(table, strided.contiguous()),
                     onehot.table_gather_plain(table, strided)), f"table_gather differs at W={w}, strided"
    torch.cuda.synchronize()
    split.s["equality checks"] += time.perf_counter() - t_edges
    log("phase 3: edge cases equal (0-width axes, out-of-range, bit 31, wk 32/64, "
        "W 10,000 and 16,384; every gather form and semantics, row stride 0 and M, "
        "odd m and W, offset idx; table_gather W 0 to 100,000, n 0-3, one block +-1, "
        "several blocks + 1, odd-offset idx, 2-D odd-offset idx, non-contiguous idx refused)")

    out = []

    def measure(name, path, shape, inputs, kernel, plain, library, args, **extra):
        """Exact equality of ``kernel(*inputs)`` and ``plain(*inputs)``, then
        the times of both, of ``library`` and of each ``extra`` function
        (``run_ms``); the bound is the cost model's formula
        (``costs.kernel_cost``) for the kernel-bearing function ``name``
        called on ``args``: each input read once, the table words a gather
        addresses, the outputs written once, at int64 (``bound``) and at
        the reference's u32 (``bound_u32``, informational)."""
        with split.part("equality checks"):
            got, want = kernel(*inputs), plain(*inputs)
            err = max_abs_err(got, want)
        assert err == 0, f"{name} differs from its plain version at {path} {shape}"
        outs = got if isinstance(got, tuple) else (got,)
        del got, want
        moved, ops = costs.kernel_cost(name, args, outs)
        moved_u32 = costs.kernel_cost(name, args, outs, int64_as=4)[0]
        fns = {"ms": kernel, "plain_ms": plain, **extra}
        if library is not None:
            fns["library_ms"] = library
        times = run_ms(fns, inputs, moved, split)
        times.setdefault("library_ms", None)
        out.append(dict(name=name, path=path, shape=shape, err=err,
                        bound=bound(moved, ops), bound_u32=bound(moved_u32, ops), **times))

    def rowmax_case(path, n, kk, k):
        idx, val, mask = _inputs(g, n, kk, k, device)
        idx = idx.clamp(0, k - 1)  # merge keys are always in range
        val = val & ((1 << 26) - 1)  # packed (cl << 24 | col_version) words
        safe = torch.where(mask, idx, k)
        zeros = torch.zeros((n, k + 1), dtype=torch.int64, device=device)
        measure(
            "rowmax", path, f"[{n},{kk}]->[{n},{k}]", (idx, val, mask, safe, zeros),
            lambda idx, val, mask, safe, zeros: onehot.rowmax(idx, val, mask, k),
            lambda idx, val, mask, safe, zeros: onehot.rowmax_plain(idx, val, mask, k),
            # amax is idempotent, so repeating it in place times the call alone.
            lambda idx, val, mask, safe, zeros: zeros.scatter_reduce_(1, safe, val, "amax"),
            (idx, val, mask, k),
        )
        return idx

    def gather_case(path, site, table, gidx, wide=False):
        """One row gather at ``site``; ``gidx`` 1-D is one column list
        broadcast over every row (row stride 0, as ``visibility`` passes
        it). The bound reads only the table words the gather addresses."""
        r, w = table.shape
        m = gidx.shape[-1]
        full = gidx.expand(r, m)
        name = "rowgather_wide" if wide else "rowgather"
        kern = onehot.rowgather_wide if wide else onehot.rowgather
        plain = onehot.rowgather_wide_plain if wide else onehot.rowgather_plain
        # Each form forced through the operator (``onehot._gather``), each
        # exact as well; the kernel's own entry is the public wrapper, in the
        # form the rule picks.
        forms = {}
        with split.part("equality checks"):
            want = plain(table, full)
            for f in onehot.GATHER_FORMS:
                got = onehot._gather(name, table, full, wide, f)
                assert equal(got, want), f"{name} {f} differs at {site}"
                forms[f"{f}_ms"] = lambda t, i, f=f: onehot._gather(name, t, i.expand(r, m), wide, f)
            del want, got
        measure(
            name, path, f"{site} [{r},{w}]<-"
            + (f"[{m}] broadcast" if gidx.dim() == 1 else f"[{r},{m}]")
            + f" ({onehot.gather_form(w, m, gidx.dim() == 1)})",
            (table, gidx),
            lambda t, i: kern(t, i.expand(r, m)),
            lambda t, i: plain(t, i.expand(r, m)),
            # Every index is in range, so gather on it needs no mask or clip.
            lambda t, i: torch.gather(t, 1, i.expand(r, m)),
            (table, full),
            **forms,
        )

    def u24(*shape):
        return torch.randint(0, 1 << 24, shape, generator=g, device=device)

    def sorted_idx(r, budget, w):
        # A grant enumeration's columns: ascending along each row.
        return torch.sort(torch.randint(0, w, (r, budget), generator=g, device=device), dim=1).values

    def reduce_case(path, n, kk, w, d_hi, v_hi, **extra_fns):
        widx = torch.randint(0, w, (n, kk), generator=g, device=device)
        d = torch.randint(0, d_hi, (n, kk), generator=g, device=device)
        v = torch.randint(0, v_hi, (n, kk), generator=g, device=device)
        valid = torch.rand((n, kk), generator=g, device=device) < 0.8
        applied = valid & (d < d_hi // 10)
        seen = torch.randint(0, v_hi, (n, w), generator=g, device=device)
        measure(
            "delivery_reduce", path, f"[{n},{kk}]x5,[{n},{w}]->2x[{n},{w}]",
            (widx, d, v, applied, valid, seen),
            lambda *a: onehot.delivery_reduce(*a, w),
            lambda *a: onehot.delivery_reduce_plain(*a, w),
            None,
            (widx, d, v, applied, valid, seen, w),
            **extra_fns,
        )
        return widx, d, valid

    def fast_path(path, n, kk, w, k, samples, r_sync, budget):
        """The fast delivery path's kernels at one path's shapes: the CRDT
        merge's rowmax, every rowgather site, the delivery reductions and
        the window."""
        idx = rowmax_case(path, n, kk, k)
        gather_case(path, "base gather", u24(n, w), torch.randint(0, w, (n, kk), generator=g, device=device))
        gather_case(path, "CRDT winner check", u24(n, k), idx)
        gather_case(path, "sync grants", u24(r_sync, w), sorted_idx(r_sync, budget, w))
        gather_case(path, "visibility", u24(n, w), torch.randint(0, w, (samples,), generator=g, device=device))
        window_case(path, n, kk, w)

    def window_case(path, n, kk, w):
        """The delivery reductions and the window at one path's shapes."""
        widx, d, valid = reduce_case(path, n, kk, w, 40, 1 << 20)
        oo = torch.randint(0, 1 << 32, (1, n, w), generator=g, device=device)
        adv_m = torch.randint(0, 8, (n, kk), generator=g, device=device)
        measure(
            "window_delivery", path, f"[1,{n},{w}],[{n},{kk}]x4->[{n},{kk}],[1,{n},{w}]",
            (oo, widx, d, adv_m, valid),
            lambda *a: onehot.window_delivery(*a, 32, w),
            lambda *a: onehot.window_delivery_plain(*a, 32, w),
            None,
            (oo, widx, d, adv_m, valid, 32, w),
        )

    def table_case(path, site, table, tidx):
        measure(
            "table_gather", path, f"{site} [{table.shape[0]}]<-{list(tidx.shape)}", (table, tidx),
            onehot.table_gather, onehot.table_gather_plain,
            # The index is already in range, so take on it needs no clip.
            torch.take,
            (table, tidx),
            # A copy of the index: the same bytes read and written, no gather.
            clone_ms=lambda table, tidx: tidx.clone(),
        )

    # wan_100k: N=100,000 rows, kk=144 messages, W=512 writers, K=256 cells,
    # S=128 samples, sync cohort 16,667 rows (interval 6) with budget 512.
    fast_path("wan_100k", 100_000, 144, 512, 256, 128, 16_667, 512)

    # merge_10k: N = W = 10,000 rows and writers, kk = 144 messages,
    # K = 1,024 cells, S = 256 samples, sync cohort R = 2,000 rows with
    # budget 512.
    n, kk, w, k, r_sync, budget = 10_000, 144, 10_000, 1024, 2_000, 512
    idx = rowmax_case("merge_10k", n, kk, k)
    gather_case("merge_10k", "CRDT winner check", torch.randint(0, 1 << 26, (n, k), generator=g, device=device), idx)
    gather_case("merge_10k", "sync grants", u24(r_sync, w), sorted_idx(r_sync, budget, w))
    gather_case("merge_10k", "visibility", u24(n, w), torch.randint(0, w, (256,), generator=g, device=device))

    # The legacy contig_run/seen reductions, and the two-rowmax form of the
    # same function (two launches and a max pass) timed beside them.
    def two_rowmax(widx, d, v, applied, valid, seen):
        return (onehot.rowmax(widx, d, applied, w),
                torch.maximum(seen, onehot.rowmax(widx, v, valid, w)))

    reduce_case("merge_10k", n, kk, w, 1 << 20, 1 << 20, two_rowmax_ms=two_rowmax)

    # The legacy base gather (and the window's word reads, same shape).
    widx = torch.randint(0, w, (n, kk), generator=g, device=device)
    gather_case("merge_10k", "legacy base gather", u24(n, w), widx, wide=True)

    # The legacy window assembly: one power of two per admitted message.
    def rowsum_case(path, widx, w):
        n, kk = widx.shape
        bits = torch.where(
            torch.rand((n, kk), generator=g, device=device) < 0.5,
            1 << torch.randint(0, 32, (n, kk), generator=g, device=device), 0,
        )
        measure(
            "rowsum", path, f"[{n},{kk}]->[{n},{w}]", (widx, bits),
            lambda widx, bits: onehot.rowsum(widx, bits, None, w),
            lambda widx, bits: onehot.rowsum_plain(widx, bits, None, w),
            # No one PyTorch call makes a fresh zero-filled plane holding the
            # sums: the two-call composition is timed beside it.
            None,
            (widx, bits, None, w),
            zeros_scatter_add_ms=lambda widx, bits: torch.zeros(
                (n, w), dtype=torch.int64, device=device).scatter_add_(1, widx, bits),
        )

    rowsum_case("merge_10k", widx, w)
    del widx, idx

    # anywrite_sparse: N = 100,000 rows, kk = 320 messages (fanout 5 x queue
    # 64), W = 2,048 hot slots, K = 256 cells, S = 256 samples, sync cohort
    # 16,667 rows with budget 512. The fast path's kernels, cold_sync's
    # grant gathers ([N, k_dev = 256] deviation tables, 64 units a node),
    # then table_gather: the grant enumeration maps each granted unit's slot
    # to its global writer, rotate maps every queue entry's slot through the
    # reset-slot mask.
    w_hot, r_sync, n, q = 2048, 16_667, 100_000, 64
    fast_path("anywrite_sparse", n, 5 * q, w_hot, 256, 256, r_sync, budget)
    gather_case("anywrite_sparse", "cold_sync grants", u24(n, 256), sorted_idx(n, 64, 256))
    table_case("anywrite_sparse", "sync grants", torch.randint(0, n, (w_hot,), generator=g, device=device),
               sorted_idx(r_sync, budget, w_hot))
    table_case("anywrite_sparse", "rotate",
               (torch.rand((w_hot,), generator=g, device=device) < 0.4).to(torch.int64),
               torch.randint(0, w_hot, (n, q), generator=g, device=device))

    # wan_100k_adaptive (its other sites are wan_100k's): the intake
    # priority reads the head of each delivered copy's writer (the sorted
    # writer column, [N, kk = 144]), the saturation test each queue
    # entry's ([N, Q = 48], twice a round), the rumor kill each copy's
    # receiver watermark.
    n, w, kk, q = 100_000, 512, 144, 48
    heads = torch.randint(0, 1 << 20, (w,), generator=g, device=device)
    table_case("wan_100k_adaptive", "intake priority", heads, sorted_idx(n, kk, w))
    table_case("wan_100k_adaptive", "queue saturation", heads,
               torch.randint(0, w, (n, q), generator=g, device=device))
    gather_case("wan_100k_adaptive", "rumor-kill watermarks", u24(n, w),
                torch.randint(0, w, (n, kk), generator=g, device=device))

    # geo_10k: N = 10,000 rows, W = 16 writers, kk = 64 messages (fanout
    # 2+2 x queue 16), S = 64 samples, no cells (no rowmax, no grant
    # gathers); the base gather and the kill's watermark lookup share a
    # shape.
    n, w, kk, q = 10_000, 16, 64, 16
    gather_case("geo_10k", "base gather, rumor-kill watermarks", u24(n, w),
                torch.randint(0, w, (n, kk), generator=g, device=device))
    gather_case("geo_10k", "visibility", u24(n, w), torch.randint(0, w, (64,), generator=g, device=device))
    window_case("geo_10k", n, kk, w)
    heads = torch.randint(0, 1 << 10, (w,), generator=g, device=device)
    table_case("geo_10k", "intake priority", heads, sorted_idx(n, kk, w))
    table_case("geo_10k", "queue saturation", heads, torch.randint(0, w, (n, q), generator=g, device=device))
    # mixed_storm: N = 1,000 rows, W = 64 writers, kk = 64 messages (fanout
    # 2+2 x queue 16), K = 512 cells, S = 256 samples, sync cohort 125 rows
    # (interval 8) with budget 512: the fast path's kernels; then the CRDT
    # merge of the sync sessions ([125, 512] grants) and the admission of
    # each reassembled big version, one column a stream ([1000, 1], 16
    # times a round); then the adaptive mixed run's table_gather sites at
    # its n = 64 (phase 4).
    n, kk, w, k = 1000, 64, 64, 512
    fast_path("mixed_storm", n, kk, w, k, 256, 125, 512)
    idx = rowmax_case("mixed_storm", 125, 512, k)
    gather_case("mixed_storm", "sync CRDT winner check", u24(125, k), idx)
    idx = rowmax_case("mixed_storm", n, 1, k)
    gather_case("mixed_storm", "admission CRDT winner check", u24(n, k), idx)
    heads = torch.randint(0, 1 << 10, (w,), generator=g, device=device)
    table_case("mixed_storm", "adaptive n=64 intake priority", heads, sorted_idx(64, kk, w))
    table_case("mixed_storm", "adaptive n=64 queue saturation", heads,
               torch.randint(0, w, (64, 16), generator=g, device=device))
    del idx, heads

    # The shard bodies of phase 13, one row block a position. The
    # partitioned dense round (wan_100k on 4 positions, the merge_10k
    # burst on 2) runs every kernel site per position: [25,000, 144] a
    # body over 512 writers and 256 cells, its sync grants over a quarter
    # of the 16,667-row cohort and its visibility over its 25,000 rows;
    # the merge burst n=2560, [1280, 144] over 2,560 writers and 1,024
    # cells (the legacy delivery), grants over 256 of a 512-row cohort.
    # The partitioned anywrite_sparse at full width on 4 positions runs the
    # same sites per position: [25,000, 320] a body over 2,048 hot slots
    # and 256 cells, its sync grants over a quarter of the 16,667-row
    # cohort, its visibility over its 25,000 rows, cold_sync's grant
    # gathers on its [25,000, 256] deviation tables, and table_gather in
    # the sync grants and in rotate over its [25,000, 64] queue; the same
    # at phase 4's n=2000 on 4 ([500, 320] over 56 hot slots and 256
    # cells); the elastic drills' dense wan workload n=64 on 8, [8, 144]
    # over 16 writers and 256 cells.
    fast_path("wan_100k_sharded", 25_000, 144, 512, 256, 128, 4_167, 512)
    n, q = 25_000, 64
    fast_path("anywrite_sparse_sharded", n, 5 * q, w_hot, 256, 256, 4_167, budget)
    gather_case("anywrite_sparse_sharded", "cold_sync grants", u24(n, 256), sorted_idx(n, 64, 256))
    table_case("anywrite_sparse_sharded", "sync grants",
               torch.randint(0, 100_000, (w_hot,), generator=g, device=device),
               sorted_idx(4_167, budget, w_hot))
    table_case("anywrite_sparse_sharded", "rotate",
               (torch.rand((w_hot,), generator=g, device=device) < 0.4).to(torch.int64),
               torch.randint(0, w_hot, (n, q), generator=g, device=device))
    for path, n, kk, w, k in (("anywrite_sparse_small_sharded", 500, 320, 56, 256),
                              ("elastic", 8, 144, 16, 256)):
        idx = rowmax_case(path, n, kk, k)
        gather_case(path, "base gather", u24(n, w), torch.randint(0, w, (n, kk), generator=g, device=device))
        gather_case(path, "CRDT winner check", u24(n, k), idx)
        window_case(path, n, kk, w)
    table_case("anywrite_sparse_small_sharded", "rotate",
               (torch.rand((56,), generator=g, device=device) < 0.4).to(torch.int64),
               torch.randint(0, 56, (500, 64), generator=g, device=device))
    # The sparse drill's rotate: 8 hot slots, n=64, queue 64.
    table_case("elastic", "rotate", (torch.rand((8,), generator=g, device=device) < 0.4).to(torch.int64),
               torch.randint(0, 8, (64, 64), generator=g, device=device))
    # The partitioned mixed_storm on 4 positions: [250, 64] a body over 64
    # writers and 512 cells, its sync grants over a quarter of the 125-row
    # cohort, its visibility over its 250 rows, and the CRDT merges of the
    # sync sessions ([32, 512] grants) and of each admitted big version
    # ([250, 1], one column a stream).
    n, kk, w, k = 250, 64, 64, 512
    fast_path("mixed_storm_sharded", n, kk, w, k, 256, 32, 512)
    idx = rowmax_case("mixed_storm_sharded", 32, 512, k)
    gather_case("mixed_storm_sharded", "sync CRDT winner check", u24(32, k), idx)
    idx = rowmax_case("mixed_storm_sharded", n, 1, k)
    gather_case("mixed_storm_sharded", "admission CRDT winner check", u24(n, k), idx)
    n, kk, w, k = 1280, 144, 2560, 1024
    idx = rowmax_case("merge_10k_sharded", n, kk, k)
    gather_case("merge_10k_sharded", "CRDT winner check", u24(n, k), idx)
    gather_case("merge_10k_sharded", "sync grants", u24(256, w), sorted_idx(256, 512, w))
    gather_case("merge_10k_sharded", "visibility", u24(n, w),
                torch.randint(0, w, (256,), generator=g, device=device))
    reduce_case("merge_10k_sharded", n, kk, w, 1 << 20, 1 << 20)
    widx = torch.randint(0, w, (n, kk), generator=g, device=device)
    gather_case("merge_10k_sharded", "legacy base gather", u24(n, w), widx, wide=True)
    rowsum_case("merge_10k_sharded", widx, w)
    del idx, widx

    # Phase 15's loadgen soak: every node a writer, kk = 144 messages
    # (fanouts 3 + 3 x queue 24), S = 32 samples, no cells and no sync (no
    # rowmax, no grant gathers). 96 nodes take the fast path; 10,000 the
    # legacy one, whose window words are read at the base gather's shape.
    n, kk, w = 96, 144, 96
    gather_case("loadgen_soak", "base gather", u24(n, w),
                torch.randint(0, w, (n, kk), generator=g, device=device))
    gather_case("loadgen_soak", "visibility", u24(n, w),
                torch.randint(0, w, (32,), generator=g, device=device))
    window_case("loadgen_soak", n, kk, w)
    n, kk, w = 10_000, 144, 10_000
    reduce_case("loadgen_soak_10k", n, kk, w, 1 << 20, 1 << 20)
    widx = torch.randint(0, w, (n, kk), generator=g, device=device)
    gather_case("loadgen_soak_10k", "legacy base gather, window words", u24(n, w), widx, wide=True)
    rowsum_case("loadgen_soak_10k", widx, w)
    gather_case("loadgen_soak_10k", "visibility", u24(n, w),
                torch.randint(0, w, (32,), generator=g, device=device))
    del widx

    # Phase 15's fidelity replay at 10,000 nodes: the steady run's 3
    # recorded writers and silent observers, kk = 64 messages (fanouts 2 +
    # 2 x queue 16), S = 24 samples (one a write), no cells (no rowmax, no
    # grant gathers): the fast path's gathers, reductions and window.
    n, kk, w = 10_000, 64, 3
    gather_case("fidelity_replay_10k", "base gather", u24(n, w),
                torch.randint(0, w, (n, kk), generator=g, device=device))
    gather_case("fidelity_replay_10k", "visibility", u24(n, w),
                torch.randint(0, w, (24,), generator=g, device=device))
    window_case("fidelity_replay_10k", n, kk, w)
    for row in out:
        times = ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("ms") and v is not None
        )
        lib_host = row.get("library_host_ms")
        log(f"phase 3: {row['name']} {row['path']} {row['shape']} equal; host ms a call "
            f"{row['host_ms']:.4f} (library {'—' if lib_host is None else f'{lib_host:.4f}'}); "
            f"{times}; device events {row['device_events']}; bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}), at u32 {row['bound_u32'][0]:.4f}")
    log(f"phase 3: split {split.line()}")
    return out


# ---- phase 4/5: the engine --------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _burst(sched, schedule_cls):
    """Two versions per writer per round for rounds 0-11: enough out-of-
    order arrivals to open the legacy window (merge_10k's 1% rate alone
    leaves it shut at small sizes)."""
    writes = sched.writes.copy()
    writes[:12, :] = 2
    return schedule_cls(writes=writes).make_samples(256)


def _wiped(sched, schedule_cls):
    """The same churn schedule with every kill a crash-with-state-wipe."""
    return schedule_cls(
        writes=sched.writes, kill=sched.kill, revive=sched.revive,
        wipe=sched.kill.copy(), sample_writer=sched.sample_writer,
        sample_ver=sched.sample_ver, sample_round=sched.sample_round,
    )


def _chunk_faults(rounds, origin):
    """Loss, a node that stays down, and a wipe that spares the origins."""
    from corrosion_tpu_torch.sim import faults

    spared = set(origin.tolist())
    victims = tuple(x for x in range(5, 40) if x not in spared)[:6]
    return faults.FaultPlan(rounds, (
        faults.Fault("loss", 10, 40, prob=0.4),
        faults.Fault("churn", 12, 13, nodes=victims, revive_at=30, wipe=True),
        faults.Fault("churn", 15, 16, nodes=(victims[-1] + 1,)),
    ))


def _mixed_churn(sched, n_nodes):
    """A kill/revive/wipe schedule that spares the streams' origin nodes
    (0 and 1), with receiver loss on region 0."""
    from corrosion_tpu_torch.sim import faults

    plan = faults.FaultPlan(sched.rounds, (
        faults.Fault("churn", 6, 7, nodes=(5, 6, 20), revive_at=14, wipe=True),
        faults.Fault("churn", 4, 5, nodes=(40,)),
        faults.Fault("loss", 3, 11, prob=0.5, regions=(0,)),
    ))
    return faults.apply_plan(sched, plan, n_nodes, 4)


# Fewer hot slots (56) than an epoch's writers need under a partition:
# forced demotions, deviation entries and cold healing, all within four
# epochs (64 rounds cut to 32 to make room for phase 15's chaos and
# fidelity planes).
SPARSE_SMALL = dict(n=2000, w_hot=56, rounds=32, n_regions=4, epoch_rounds=8,
                    cohort=32, k_dev=96, partition=True, samples=64)
# 48 rounds (120 before phase 15's chaos and fidelity planes, 72 before
# phase 16's command line): the fault plan's loss, churn and wipe all fall
# in its first 40.
CHUNK_SMALL = dict(n=48, streams=4, last_seq=2047, rounds=48)
MIXED_SMALL = dict(n=64, streams=2, last_seq=255, rounds=24, samples=16)
# churn_32's depth in phase 4 (the builder's 400 cut to make room for phase
# 15's serving plane, then its chaos and fidelity planes): four of the ten
# flappers go down and two come back up; the last 32 rounds drain.
CHURN_SMALL_ROUNDS = 128
# three_node's inserts in phase 4 (the builder's 1,000, cut likewise): 42
# rounds of writes, then its 30-round drain.
THREE_NODE_INSERTS = 504
SMALL_RUNS = (
    # (label, builder, builder kwargs, schedule transform, chunk, gossip
    # fields set with health.with_adaptive (None: the builder's config),
    # ops.gossip module settings for the run)
    ("wan_100k n=2000", "wan_100k", dict(n=2000, n_regions=4, n_writers=64, rounds=72), None, 24,
     None, {}),
    ("three_node", "three_node", dict(n_inserts=THREE_NODE_INSERTS), None, None, None, {}),
    ("churn_32", "churn_32", dict(rounds=CHURN_SMALL_ROUNDS), None, 100, None, {}),
    ("churn_32 wipe", "churn_32", dict(rounds=CHURN_SMALL_ROUNDS), _wiped, 100, None, {}),
    ("anti_entropy_1k", "anti_entropy_1k", {}, None, 50, None, {}),
    ("merge_10k burst n=2560", "merge_10k", dict(n=2560, rounds=48), _burst, 24, None, {}),
    ("anywrite_sparse n=2000", "anywrite_sparse", SPARSE_SMALL, None, None, None, {}),
    # The adaptive plane: sketch scoring forced (the escalated pull scores
    # exactly below _EXACT_SCORE_MAX at this size), the legacy delivery, the
    # geo scenario with its propagation curves, and the sparse engine.
    ("wan_100k adaptive sketch n=2000", "wan_100k", dict(n=2000, rounds=48), None, 24,
     dict(sync_sketch_buckets=8), {"_EXACT_SCORE_MAX": 0}),
    ("merge_10k burst adaptive n=2560", "merge_10k", dict(n=2560, rounds=24), _burst, 12, {}, {}),
    ("geo churned_demo_cluster adaptive n=96", "churned_demo_cluster",
     dict(nodes=96, rounds=48, geo=True, adaptive=True), None, None, None, {}),
    ("anywrite_sparse adaptive prop n=2000", "anywrite_sparse", SPARSE_SMALL, None, None,
     dict(prop_observe=True), {}),
    # The chunk plane and the mixed engine: plain and under faults, the
    # mixed storm without and with cells, and its adaptive twin (the
    # reference's test_mixed_engine_adaptive_counters_and_conservation).
    ("anti_entropy_chunks n=48", "anti_entropy_chunks", CHUNK_SMALL, None, 40, None, {}),
    ("anti_entropy_chunks n=48 faults", "anti_entropy_chunks", CHUNK_SMALL, _chunk_faults, None,
     None, {}),
    ("mixed_storm n=64 no cells", "mixed_storm", dict(MIXED_SMALL, n_cells=0), None, None, None,
     {}),
    ("mixed_storm n=64", "mixed_storm", MIXED_SMALL, None, 10, None, {}),
    ("mixed_storm n=64 churn", "mixed_storm", MIXED_SMALL, _mixed_churn, None, None, {}),
    ("mixed_storm n=64 adaptive prop", "mixed_storm", dict(MIXED_SMALL, n_cells=0), None, None,
     dict(prop_observe=True), {}),
)


def _small_run(builder, kw, transform, chunk, adapt, dev):
    """One small run on ``dev``: its flattened final state, curves and
    info (the sparse engine's, without the resume point; the chunk
    engine's metrics; {} otherwise)."""
    from corrosion_tpu_torch import interop
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import chunk_engine, engine, health, mixed_engine, sparse_engine

    if builder == "anti_entropy_chunks":
        ccfg, origin, last, rounds = baselines.anti_entropy_chunks(device=dev, **kw)
        plan = None if transform is None else transform(rounds, origin.cpu())
        state, m = chunk_engine.simulate_chunks(
            ccfg, origin, last, rounds, seed=0, max_chunk=chunk, faults=plan, device=dev
        )
        flat = _flat(interop.to_numpy(state))
        flat["vis"] = m.pop("vis").cpu().numpy()
        curves = m.pop("curves")
        return flat, curves, m, rounds
    if builder == "mixed_storm":
        cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device=dev, **kw)
        if adapt is not None:
            cfg = health.with_adaptive(cfg, **adapt)
        if transform is not None:
            sched = transform(sched, cfg.n_nodes)
        final, curves = mixed_engine.simulate_mixed(
            cfg, ccfg, topo, sched, spec, seed=0, max_chunk=chunk, device=dev
        )
        return _flat(interop.to_numpy(final)), curves, {}, sched.rounds
    if builder == "churned_demo_cluster":
        cfg, topo, sched, _ = health.churned_demo_cluster(device=dev, **kw)
    else:
        cfg, topo, sched = getattr(baselines, builder)(device=dev, **kw)
    if adapt is not None:
        cfg = health.with_adaptive(cfg, **adapt)
    if transform is not None:
        sched = transform(sched, engine.Schedule)
    if builder != "anywrite_sparse":
        final, curves = engine.simulate(cfg, topo, sched, seed=0, max_chunk=chunk, device=dev)
        return _flat(interop.to_numpy(final)), curves, {}, sched.rounds
    sstate, swim, vis, curves, info = sparse_engine.simulate_sparse(
        cfg, topo, sched, seed=0, device=dev
    )
    assert sparse_engine.converged_sparse(sstate)
    flat = _flat(interop.to_numpy(sstate))
    flat.update(_flat(interop.to_numpy(swim), "swim."))
    flat["vis_round"] = vis.cpu().numpy()
    info.pop("resume")
    return flat, curves, info, sched.rounds


def _with_knobs(module, knobs: dict, fn):
    """``fn()`` with the module settings ``knobs`` (``ops.gossip``'s, or
    ``sim.benchlib``'s) in force."""
    saved = {k: getattr(module, k) for k in knobs}
    try:
        for k, v in knobs.items():
            setattr(module, k, v)
        return fn()
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def cpu_small_runs(out: str) -> int:
    """``python3 chip_smoke.py --cpu-small-runs OUT``: every run of
    ``SMALL_RUNS`` on the CPU (the plain versions), in order, each one's
    ``_small_run`` result and its seconds, then the cost model of the four
    engines on the CPU (phase 14 holds the card's to it), the invariant
    suite on ``kitchen-sink`` (phase 12), ``loadgen soak`` and the fidelity
    plane's ``dcn_partition`` at their defaults (phase 15) on the CPU, with
    their seconds, pickled into ``OUT``. Phase 4 starts it as a worker
    process."""
    from corrosion_tpu_torch.fidelity import scenarios as fidelity
    from corrosion_tpu_torch.loadgen import scenarios
    from corrosion_tpu_torch.obs import costs
    from corrosion_tpu_torch.ops import gossip
    from corrosion_tpu_torch.sim import invariants

    t_all = time.perf_counter()
    runs = []
    for _, builder, kw, transform, chunk, adapt, knobs in SMALL_RUNS:
        t0 = time.perf_counter()
        run = _with_knobs(gossip, knobs,
                          lambda: _small_run(builder, kw, transform, chunk, adapt, "cpu"))
        runs.append((*run, time.perf_counter() - t0))
    t0 = time.perf_counter()
    model = costs.build_cost_model(device_counts=COST_DEVICES, device="cpu")
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    suite = invariants.run_suite(kitchen_sink(), seed=0, device="cpu")
    t_suite = time.perf_counter() - t0
    t0 = time.perf_counter()
    soak = scenarios.intake_policy(device="cpu")
    t_soak = time.perf_counter() - t0
    t0 = time.perf_counter()
    dcn = fidelity.dcn_partition(device="cpu")
    Path(out).write_bytes(pickle.dumps(
        {"runs": runs, "cost_model": model, "cost_model_s": t_model, "suite": suite,
         "suite_s": t_suite, "soak": soak, "soak_s": t_soak, "dcn": dcn,
         "dcn_s": time.perf_counter() - t0, "s": time.perf_counter() - t_all}
    ))
    return 0


def run_drills(device: str) -> dict:
    """Every drill of ``ELASTIC_DRILLS`` on ``device``, its checkpoints
    and the soak drill's series under ``build/elastic/<device>``."""
    from corrosion_tpu_torch.elastic import scenarios

    base = REPO / "build" / "elastic" / device
    base.mkdir(parents=True, exist_ok=True)
    return {
        n: scenarios.run_scenario(
            n, checkpoint_dir=str(base / n), device=device,
            series_path=str(base / f"{n}.series.jsonl") if n == "soak_preempt" else None,
        )
        for n in ELASTIC_DRILLS
    }


def cpu_elastic_drills(out: str) -> int:
    """``python3 chip_smoke.py --cpu-elastic-drills OUT``: the elastic
    drills on the CPU and their seconds, pickled into ``OUT``. Phase 12
    starts it as a worker process beside the card's side."""
    t0 = time.perf_counter()
    reports = run_drills("cpu")
    Path(out).write_bytes(pickle.dumps({"reports": reports, "s": time.perf_counter() - t0}))
    return 0


def card_elastic_drills(out: str) -> int:
    """``python3 chip_smoke.py --card-elastic-drills OUT``: the elastic
    drills on the card, in a process of its own (the drills are
    host-paced), its launch counts reset just before them and read just
    after, pickled into ``OUT`` with the reports and their seconds. Phase
    12 starts it beside phases 12 and 13 (the library is built by then)."""
    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.ops import onehot

    cuda_build.load()
    onehot.reset_launches()
    t0 = time.perf_counter()
    reports = run_drills("cuda")
    torch.cuda.synchronize()
    Path(out).write_bytes(pickle.dumps({"reports": reports, "launches": dict(onehot.LAUNCHES),
                                        "s": time.perf_counter() - t0}))
    return 0


def start_drills() -> tuple:
    """Phase 13's elastic drills, started when phase 12 starts: the card's
    side (``card_elastic_drills``) and the CPU's (``cpu_elastic_drills``),
    each in a process of its own beside phases 12 and 13."""
    card_out = REPO / "build" / "elastic_card.pkl"
    cpu_out = REPO / "build" / "elastic_cpu.pkl"
    return (start_worker("--card-elastic-drills", card_out, card=True), card_out,
            start_worker("--cpu-elastic-drills", cpu_out), cpu_out, time.perf_counter())


def start_worker(flag: str, out_path: Path, card: bool = False) -> subprocess.Popen:
    """This script with ``flag OUT`` in a process of its own. A CPU worker
    sees no card and runs at the lowest priority with one thread fewer
    than the host's cores, so this process's host thread always finds a
    core; a ``card`` worker sees the card (and the kernel library this
    process built)."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.unlink(missing_ok=True)
    argv = [sys.executable, str(Path(__file__).resolve()), flag, str(out_path)]
    if card:
        return subprocess.Popen(argv)
    threads = str(max(1, len(os.sched_getaffinity(0)) - 1))
    return subprocess.Popen(
        argv, env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=threads),
        preexec_fn=lambda: os.nice(19),
    )


def join_worker(worker: subprocess.Popen, out_path: Path, what: str):
    """Wait for a worker and return what it pickled."""
    rc = worker.wait()
    assert rc == 0, f"{what} failed (exit code {rc})"
    return pickle.loads(out_path.read_bytes())


def stop_worker(worker: subprocess.Popen) -> None:
    """Kill a worker still running (its caller failed first)."""
    if worker.poll() is None:
        worker.kill()
        worker.wait()


def start_small_runs(onehot, gossip) -> tuple:
    """Phase 4's card side: each small run on the card, its launch counts
    read just after it, while a worker process (``cpu_small_runs``, no card
    visible to it) runs the CPU side. The worker goes on beside the next
    phases; ``check_small_runs`` joins it. Returns what that takes."""
    out_path = REPO / "build" / "small_runs_cpu.pkl"
    worker = start_worker("--cpu-small-runs", out_path)
    card = []
    try:
        for _, builder, kw, transform, chunk, adapt, knobs in SMALL_RUNS:
            onehot.reset_launches()
            t0 = time.perf_counter()
            out = _with_knobs(gossip, knobs,
                              lambda: _small_run(builder, kw, transform, chunk, adapt, "cuda"))
            torch.cuda.synchronize()
            card.append((*out, time.perf_counter() - t0, dict(onehot.LAUNCHES)))
    except BaseException:
        stop_worker(worker)
        raise
    return worker, out_path, card


def check_small_runs(worker, out_path: Path, card: list) -> dict:
    """Each small run on the card (kernels) equals the CPU run (plain
    versions); the merge_10k runs launch the two wide-path kernels, the
    anywrite runs demote, heal and launch ``table_gather``, the adaptive
    runs launch ``table_gather`` and kill rumors. Joins phase 4's worker
    first. Returns what the worker pickled: its CPU cost model (phase 14),
    invariant suite (phase 12), ``loadgen soak`` and ``dcn_partition``
    reports (phase 15)."""
    t0 = time.perf_counter()
    try:
        worker_out = join_worker(worker, out_path, "phase 4: the CPU side of the small runs")
    finally:
        stop_worker(worker)
    log(f"phase 4: the CPU side took {worker_out['s']:.1f} s in the worker, the card side "
        f"{sum(r[4] for r in card):.1f} s; waited for the worker {time.perf_counter() - t0:.1f} s")
    cpu = worker_out["runs"]
    for (label, builder, kw, transform, chunk, adapt, knobs), ra, rb in zip(SMALL_RUNS, card, cpu):
        (fa, ca, ia, rounds, ta, launches), (fb, cb, ib, _, tb) = ra, rb
        bad = [k for k in ca if not np.array_equal(ca[k], cb[k])]
        bad += [k for k in fa if not np.array_equal(fa[k], fb[k])]
        assert not bad and json.dumps(ia) == json.dumps(ib), \
            f"{label}: card run differs from the CPU run in {bad}"
        assert ca["vis_count"].sum() > 0 and ca["msgs"].sum() > 0, label
        if builder == "anti_entropy_chunks":
            # The chunk plane is plain PyTorch: no kernel of its own.
            assert not any(launches.values()), launches
            assert ca["applied_sync"].sum() > 0, label
            if transform is not None:
                assert ca["chaos_wiped"].sum() > 0 and ca["chaos_lost_msgs"].sum() > 0, label
        if builder == "mixed_storm":
            need = ("rowgather", "delivery_reduce") + (("rowmax",) if kw.get("n_cells", 1) else ())
            assert all(launches[k] > 0 for k in need), launches
            assert ca["chunks_sent"].sum() > 0 and ca["seqs_granted"].sum() > 0, label
            if transform is not None:
                assert ca["chaos_wiped"].sum() > 0, label
        if builder == "merge_10k":
            for k in ("rowgather_wide", "rowsum"):
                assert launches[k] > 0, f"{label}: {k} never launched"
        if builder == "anywrite_sparse":
            assert ia["max_dev_entries"] > 0 and ca["cold_healed"].sum() > 0, ia
            assert launches["table_gather"] > 0, launches
        if adapt is not None or kw.get("adaptive"):
            assert launches["table_gather"] > 0, launches
            assert fa["data.q_dup"].shape[1] > 0 and fa["data.q_dup"].any(), label
            if builder == "churned_demo_cluster" or adapt.get("prop_observe"):
                check_conservation(label, ca)
                assert ca["prop_rumor_kills"].sum() > 0, label
        extra = f"; info {json.dumps(ia)}; cold_healed={int(ca['cold_healed'].sum())}" if ia else ""
        log(f"phase 4: {label} ({rounds} rounds): card {ta:.1f} s == CPU (worker) "
            f"{tb:.1f} s ({len(ca)} curves, {len(fa)} state leaves); "
            f"need[-1]={int(ca['need'][-1])}{extra}; launches {json.dumps(launches)}")
    log(f"phase 4: the worker built the CPU cost model in {worker_out['cost_model_s']:.1f} s, "
        f"ran the invariant suite in {worker_out['suite_s']:.1f} s, loadgen soak in "
        f"{worker_out['soak_s']:.1f} s and dcn_partition in {worker_out['dcn_s']:.1f} s")
    return worker_out


def check_tie_rules() -> None:
    """The chunk plane's tie-sensitive picks on the card equal the CPU's on
    tie-heavy inputs at the 100,000-node run's 1.6 M rows: the slot pick
    (argmax over scores on four levels), the first overlapping peer slot
    (argmax over bool) and the interval overflow (argmin over tied lengths,
    through ``insert`` into full sets)."""
    from corrosion_tpu_torch.ops import chunks, intervals

    g = torch.Generator().manual_seed(5)
    rows, cap = 1_600_000, 16
    live = torch.rand((rows, cap), generator=g) < 0.6
    u = torch.randint(0, 4, (rows, 3, cap), generator=g).to(torch.float32) / 4
    cpu = chunks._pick_slot(live, u)
    assert torch.equal(chunks._pick_slot(live.cuda(), u.cuda()).cpu(), cpu), "slot pick"
    overlap = torch.rand((rows, cap), generator=g) < 0.3
    assert torch.equal(chunks._first_overlap(overlap.cuda()).cpu(), chunks._first_overlap(overlap))
    # Full sets of 16 length-3 intervals, then an insert of another length-3
    # one: every candidate ties on length.
    starts = (torch.arange(cap) * 10)[None, :].expand(rows, cap) + torch.randint(0, 3, (rows, 1), generator=g)
    iv = intervals.IntervalSet(starts.contiguous(), (starts + 2).contiguous())
    s = torch.randint(0, 200, (rows,), generator=g)
    want = intervals.insert(iv, s, s + 2)
    got = intervals.insert(intervals.IntervalSet(iv.starts.cuda(), iv.ends.cuda()), s.cuda(), s.cuda() + 2)
    assert torch.equal(got.starts.cpu(), want.starts) and torch.equal(got.ends.cpu(), want.ends), \
        "interval overflow"
    log(f"phase 4: chunk-plane tie rules card == CPU at {rows:,} rows (slot pick, first "
        f"overlap, overflow of tied lengths)")


def check_conservation(label: str, curves: dict) -> None:
    """The propagation plane's identities, round by round: the link
    matrix's mass and useful + duplicate copies are ``msgs``, the rumor-age
    histogram's mass is ``vis_count``."""
    from corrosion_tpu_torch.sim import telemetry

    def mass(keys):
        return sum(curves[k].astype(np.int64) for k in keys)

    msgs = curves["msgs"].astype(np.int64)
    assert np.array_equal(mass(telemetry.LINK_CURVE_KEYS), msgs), f"{label}: link mass != msgs"
    assert np.array_equal(mass(("prop_useful_msgs", "prop_dup_msgs")), msgs), \
        f"{label}: useful + dup != msgs"
    assert np.array_equal(mass(telemetry.RUMOR_AGE_KEYS), curves["vis_count"].astype(np.int64)), \
        f"{label}: rumor-age mass != vis_count"


def flight_telemetry(name: str, engine: str, **bridge):
    """A ``KernelTelemetry`` recording a fresh flight at ``FLIGHTS/name``
    and writing one progress line a chunk to stderr; ``bridge`` passes a
    ``registry``, ``tracer`` and ``series`` on to it."""
    from corrosion_tpu_torch.sim import telemetry

    FLIGHTS.mkdir(parents=True, exist_ok=True)
    rec = telemetry.FlightRecorder(str(FLIGHTS / f"{name}.jsonl"), engine=engine, mode="w")
    return telemetry.KernelTelemetry(engine=engine, recorder=rec, progress=sys.stderr, **bridge)


def bridge_telemetry(name: str, engine: str):
    """``flight_telemetry`` carrying the port's metrics bridge as well: a
    ``MetricsRegistry``, a ``Tracer`` exporting its spans to
    ``FLIGHTS/name.spans.jsonl`` and a ``MetricSeriesRecorder`` at
    ``FLIGHTS/name.series.jsonl`` with ``clock=None``, one sample a chunk."""
    from corrosion_tpu_torch.obs.series import MetricSeriesRecorder
    from corrosion_tpu_torch.utils.metrics import MetricsRegistry
    from corrosion_tpu_torch.utils.tracing import Tracer

    FLIGHTS.mkdir(parents=True, exist_ok=True)
    spans = FLIGHTS / f"{name}.spans.jsonl"
    spans.unlink(missing_ok=True)  # the tracer appends
    return flight_telemetry(
        name, engine, registry=MetricsRegistry(),
        tracer=Tracer(service="chip_smoke", export_path=str(spans)),
        series=MetricSeriesRecorder(str(FLIGHTS / f"{name}.series.jsonl"), source="kernel",
                                    mode="w", clock=None),
    )


# The kernel lane's endurance detectors (the reference's
# scripts/soak_smoke.py: t in rounds taken as seconds, no wedge pair, the
# staleness ceiling and the false-alarm budget proportional to the
# cluster's nodes, there 16) at N nodes; the leak ceilings of the two
# kernel watermark gauges scale with N the same way from their defaults.
SOAK_LANE_NODES = 16


def kernel_endurance_kw(n_nodes: int) -> dict:
    from corrosion_tpu_torch.obs import endurance

    scale = n_nodes / SOAK_LANE_NODES
    return dict(
        t_scale_s=1.0, wedge_pairs=(),
        leak_ceilings={
            k: v * scale for k, v in endurance.DEFAULT_LEAK_CEILINGS.items()
            if k.startswith("corro_kernel_")
        },
        slos=(
            {"name": "convergence_staleness", "kind": "gauge",
             "series": "corro_kernel_health_staleness_sum_last", "ceiling": 40.0 * n_nodes,
             "objective": 0.80},
            {"name": "probe_false_alarm_budget", "kind": "counter_budget",
             "series": "corro_kernel_health_swim_false_alarms_last",
             "allowed_per_hour": 3600.0 * n_nodes},
        ),
    )


def check_bridge(tele, parts: list, n_nodes: int, phase: int, label: str) -> dict:
    """Close the bridge's tracer and recorder and hold them to the run:
    one series header and one sample a chunk at the absolute round
    reached, ``corro_kernel_rounds_total`` the rounds run, every
    ``corro_kernel_*_total`` counter its curve's float64 sum (chunk by
    chunk, as the registry adds; and the whole curve's, for curves of
    integers), one ``kernel_chunk`` span a chunk, and the endurance report
    over the series ok. Returns the report."""
    from corrosion_tpu_torch.obs import endurance, series
    from corrosion_tpu_torch.sim import telemetry

    tele.tracer.close()
    tele.series.close()
    ends = list(np.cumsum([len(p["need"]) for p in parts]))
    data = series.replay_series(tele.series.path)
    assert len(data["headers"]) == 1, f"{label}: {len(data['headers'])} series headers"
    assert [s["t"] for s in data["samples"]] == [float(e) for e in ends], f"{label}: sample rounds"
    reg = tele.registry
    eng = tele.engine
    assert reg.counter("corro_kernel_rounds_total").get(engine=eng) == float(ends[-1])
    checked = 0
    for k in parts[0]:
        if k in telemetry.LINK_CURVE_KEYS or k in telemetry.RUMOR_AGE_KEYS:
            continue
        got = reg.counter(f"{telemetry.series_name(k)}_total").get(engine=eng)
        chunked = 0.0
        for p in parts:
            chunked += float(np.asarray(p[k], np.float64).sum())
        assert got == chunked, f"{label}: {k} counter {got} != {chunked}"
        whole = np.concatenate([np.asarray(p[k], np.float64) for p in parts])
        if np.array_equal(whole, np.round(whole)) and abs(whole).sum() < 2.0**53:
            assert got == float(whole.sum()), f"{label}: {k} counter {got} != {whole.sum()}"
        checked += 1
    spans = [json.loads(x) for x in (FLIGHTS / f"{label}.spans.jsonl").read_text().splitlines()]
    assert [s["name"] for s in spans] == ["kernel_chunk"] * len(parts), f"{label}: spans"
    assert [s["attrs"]["start_round"] for s in spans] == [0, *ends[:-1]]
    rep = endurance.build_report(data["samples"], label=label, **kernel_endurance_kw(n_nodes))
    assert rep["ok"], f"{label}: endurance breaches {rep['breaches']}"
    log(f"phase {phase}: {label} metrics bridge: {len(data['samples'])} series samples at "
        f"t={ends[0]}..{ends[-1]}, {checked} corro_kernel_*_total counters equal to their "
        f"curves' float64 sums, {len(spans)} kernel_chunk spans; endurance ok, armed "
        f"{json.dumps(rep['detectors_armed'])}, leaks "
        f"{json.dumps({k: v.get('slope_per_hour') for k, v in rep['leaks'].items()})}")
    return rep


def check_flight(tele, curves: dict, phase: int, label: str, ms_per_round: float) -> None:
    """Close ``tele``'s recorder and hold its flight record to the run's
    curves, key for key and round for round; log ``device_step_ms`` beside
    the CUDA-event ms/round and the record's size."""
    from corrosion_tpu_torch.sim import telemetry

    tele.recorder.close()
    path = tele.recorder.path
    replayed, chunks = telemetry.replay_flight(path)
    rounds = len(curves["need"])
    assert set(replayed) == set(curves) | {"round"}, f"{label}: flight keys differ"
    assert list(replayed["round"]) == list(range(rounds)), f"{label}: flight rounds differ"
    bad = [k for k in curves if not np.array_equal(replayed[k], curves[k])]
    assert not bad, f"{label}: the flight record differs from the curves in {bad}"
    assert sum(c["rounds"] for c in chunks) == rounds == sum(n for n, _ in tele.chunk_walls)
    size = sum(os.path.getsize(p) for p in telemetry.flight_segments(path))
    log(f"phase {phase}: {label} flight record ({len(chunks)} chunks, {size / 2**20:.2f} MiB) "
        f"replays equal to the curves; device_step_ms {tele.device_step_ms:.1f} against "
        f"{ms_per_round:.1f} ms/round (CUDA events)")


def dense_chunks(cfg, topo, sched, chunk: int = 12, telemetry=None):
    """``engine.simulate`` over ``chunk`` rounds at a time, each call
    resuming the last (and a chunk of ``telemetry``); yields (state,
    curves, info) per call."""
    from corrosion_tpu_torch.sim import engine

    state, done = None, 0
    while done < sched.rounds:
        stop = min(done + chunk, sched.rounds)
        state, curves = engine.simulate(cfg, topo, sched.slice(done, stop), seed=0,
                                        state=state, telemetry=telemetry, device="cuda")
        done = stop
        yield state, curves, {}


def sparse_epochs(cfg, topo, sched, last: dict | None = None):
    """``simulate_sparse`` one epoch at a time, each call resuming the last;
    yields (SparseState, curves, info) per epoch, and puts the epoch's
    resume point (swim state and vis_round with it) under ``last["resume"]``
    when ``last`` is given."""
    from corrosion_tpu_torch.sim import sparse_engine

    resume = None
    for epoch in range(-(-sched.rounds // cfg.sparse.epoch_rounds)):
        sstate, _, vis, curves, info = sparse_engine.simulate_sparse(
            cfg, topo, sched, seed=0, resume=resume, stop_after_epoch=epoch, device="cuda"
        )
        resume = info.pop("resume")  # only the latest state stays alive
        if last is not None:
            last["resume"] = resume
        yield sstate, curves, dict(info, unseen=int((vis < 0).sum()))


def build_path(path: str):
    """(config, topology, schedule) of a full-size main path on the card."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import health

    if path == "wan_100k_adaptive":
        # The reference tests' composed_sketch tuning; prop_observe stays
        # off (20 regions exceed the plane's PROP_REGIONS = 4).
        cfg, topo, sched = baselines.wan_100k(device="cuda")
        return (health.with_adaptive(cfg, sync_sketch_buckets=8), topo,
                sched.slice(0, ADAPTIVE_ROUNDS))
    return getattr(baselines, path)(device="cuda")


def full_run(onehot, gossip, phase: int, builder: str, keep: dict | None = None,
             walls: dict | None = None):
    """A main path at full size, every round of its schedule, one call per
    chunk (dense engine) or epoch (sparse engine), with the launch counts
    reset just before and read just after. ``keep`` takes the state, the
    curves and the CUDA-event ms after ``SHARDED_ROUNDS`` rounds (the
    sparse engine: the (sparse state, swim state, vis_round), the curves,
    the ms, the peak memory so far and the epochs' info after
    ``SPARSE_SHARDED_ROUNDS``), and under ``final`` the last round's cell
    planes, ``head``, ``contig``, window words and alive mask (on the
    host), the gossip config and the schedule's writes (dense only);
    ``walls`` the run's wall seconds under its name."""
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import sparse_engine

    cfg, topo, sched = build_path(builder)
    sparse = builder == "anywrite_sparse"
    # wan_100k carries the flight recorder and the metrics bridge: one
    # chunk a 12-round call.
    tele = bridge_telemetry(builder, "dense") if builder == "wan_100k" else None
    last = {}
    if sparse:
        chunks = sparse_epochs(cfg, topo, sched, last)
    else:
        chunks = dense_chunks(cfg, topo, sched, telemetry=tele)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    parts, infos, done, elapsed = [], [], 0, 0.0
    t_wall = time.perf_counter()
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step = next(chunks, None)
        if step is None:
            break
        b.record()
        b.synchronize()
        state, curves, info = step
        ms, rounds = a.elapsed_time(b), len(curves["need"])
        elapsed += ms
        parts.append(curves)
        infos.append(info)
        log(f"phase {phase}: rounds {done}-{done + rounds - 1}: {ms / rounds:.1f} ms/round"
            + "".join(f", {k} {v}" for k, v in info.items()))
        done += rounds
        if keep is not None and done == (SPARSE_SHARDED_ROUNDS if sparse else SHARDED_ROUNDS):
            # Held on the host, so the later phases' peaks stay their own.
            held = state
            if sparse:
                held = (state, last["resume"]["swim"], last["resume"]["vis_round"])
                keep.update(peak=torch.cuda.max_memory_allocated(), infos=list(infos))
            keep.update(state=mesh_mod.to_host(held), ms=elapsed,
                        curves={k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
            del held
    wall = time.perf_counter() - t_wall
    if walls is not None:
        walls[builder] = wall
    if keep is not None and not sparse:
        keep["peak"] = torch.cuda.max_memory_allocated()
        # Phase 15 holds the final cells to the SQLite store and reads the
        # flight's write journeys. The cell planes, the watermarks and the
        # window words are held on the host, as phase 13's round's are.
        d = state.data
        keep["final"] = dict(mesh_mod.to_host(dict(
            cells=d.cells, head=d.head, contig=d.contig, oo=d.oo, alive=state.swim.alive)),
            cfg=cfg.gossip, writes=sched.writes)
    launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    assert done == sched.rounds
    d = state.data
    assert bool((d.contig <= d.head[None, :]).all()), "contig > head"
    assert bool((d.seen >= d.contig).all()), "seen < contig"
    for k in ("need", "staleness_sum", "msgs"):
        assert np.isfinite(curves[k].astype(np.float64)).all()
    assert curves["msgs"].sum() > 0 and curves["vis_count"].sum() > 0
    missing = [k for k in PATH_KERNELS[builder] if launches[k] == 0]
    assert not missing, f"{builder}: kernels never launched on its path: {missing}"
    peak = torch.cuda.max_memory_allocated()
    log(f"phase {phase}: {builder} N={cfg.n_nodes} W={cfg.gossip.n_writers} "
        f"{done} rounds: {elapsed / done:.1f} ms/round (CUDA events), "
        f"wall {wall:.1f} s, peak memory {peak / 2**30:.2f} GiB")
    if tele is not None:
        check_flight(tele, curves, phase, builder, elapsed / done)
        check_bridge(tele, parts, cfg.n_nodes, phase, builder)
    if sparse:
        assert sum(i["dev_dropped"] for i in infos) == 0, "deviation entries dropped"
        assert sparse_engine.converged_sparse(state), "anywrite_sparse did not converge"
        conv = np.nonzero(curves["need"] != 0)[0]
        log(f"phase {phase}: converged (need 0 from round "
            f"{int(conv[-1]) + 1 if len(conv) else 0}), unseen sample pairs "
            f"{infos[-1]['unseen']}, retired {sum(i['retired'] for i in infos)}, promoted "
            f"{sum(i['promoted'] for i in infos)}, max dev entries "
            f"{max(i['max_dev_entries'] for i in infos)}, cold_healed "
            f"{int(curves['cold_healed'].sum())}")
    log(f"phase {phase}: launches {json.dumps(launches)}; host syncs {json.dumps(syncs)}")
    log(f"phase {phase}: need[-1]={int(curves['need'][-1])} "
        f"vis_count={int(curves['vis_count'].sum())} msgs={int(curves['msgs'].sum())}")
    return launches


def geo_run(onehot, gossip, phase: int = 9, keep: dict | None = None) -> dict:
    """The geo epidemic scenario at 10,000 nodes, push-only then adaptive,
    each in one call: every round completes, the watermark invariants and
    the propagation identities hold on the card's curves, the adaptive
    run kills rumors. The launch counts are reset before the pair and read
    after it. Returns them; the push run's curves (on the host) and
    convergence round go into ``keep["geo_push"]`` for phase 16."""
    from corrosion_tpu_torch.sim import engine, health

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    copies = {}
    for adaptive in (False, True):
        label = "adaptive" if adaptive else "push"
        cfg, topo, sched, kill_rounds = health.churned_demo_cluster(
            nodes=10_000, rounds=64, samples=64, geo=True, adaptive=adaptive, device="cuda"
        )
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        final, curves = engine.simulate(cfg, topo, sched, seed=0, device="cuda")
        b.record()
        b.synchronize()
        d = final.data
        assert len(curves["msgs"]) == sched.rounds
        assert bool((d.contig <= d.head[None, :]).all()), f"{label}: contig > head"
        assert bool((d.seen >= d.contig).all()), f"{label}: seen < contig"
        assert curves["msgs"].sum() > 0 and curves["vis_count"].sum() > 0, label
        check_conservation(f"geo_10k {label}", curves)
        kills = int(curves["prop_rumor_kills"].sum())
        pulls = int(curves["prop_pull_rounds"].sum())
        assert kills > 0 if adaptive else kills == pulls == 0, (label, kills, pulls)
        # The data plane's convergence: need stays 0 from this round on.
        lagging = np.nonzero(curves["need"] != 0)[0]
        converged = int(lagging[-1]) + 1 if len(lagging) else 0
        msgs = int(curves["msgs"].astype(np.int64).sum())
        copies[label] = msgs
        if keep is not None and not adaptive:
            keep["geo_push"] = {"curves": curves, "converged": converged}
        log(f"phase {phase}: geo_10k {label} N={cfg.n_nodes} W={cfg.gossip.n_writers} "
            f"{sched.rounds} rounds (kill/revive of {int(sched.kill.sum())} nodes at round "
            f"{kill_rounds[0]}): {a.elapsed_time(b) / sched.rounds:.1f} ms/round (CUDA events); "
            f"delivered copies {msgs}, useful {int(curves['prop_useful_msgs'].sum())}, "
            f"duplicate {int(curves['prop_dup_msgs'].sum())}; peak queue_backlog "
            f"{int(curves['queue_backlog'].max())} ({curves['queue_backlog'].max() / cfg.n_nodes:.2f} "
            f"a node); rumor kills {kills}, pull rounds {pulls}; "
            + (f"need 0 from round {converged}" if converged < sched.rounds
               else "need not 0 by the last round")
            + f"; SWIM mismatches in the last round {int(curves['mismatches'][-1])}")
    launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["geo_10k"] if launches[k] == 0]
    assert not missing, f"geo_10k: kernels never launched on its path: {missing}"
    log(f"phase {phase}: geo_10k delivered copies push {copies['push']} -> adaptive "
        f"{copies['adaptive']} ({copies['adaptive'] / copies['push']:.3f}x); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase {phase}: launches {json.dumps(launches)}; host syncs {json.dumps(dict(gossip.HOST_SYNCS))}")
    return launches


def check_intervals(have, last_seq, n_streams: int) -> None:
    """The interval invariants of a final chunk state, every row: live slots
    first, sorted, disjoint and non-adjacent, inside [0, last_seq]; empty
    slots hold (EMPTY, EMPTY - 1)."""
    from corrosion_tpu_torch.ops import intervals

    s, e = have.starts, have.ends
    live = s <= e
    assert bool((live[:, :-1] | ~live[:, 1:]).all()), "an empty slot before a live one"
    assert bool(((s[:, 1:] > e[:, :-1] + 1) | ~live[:, 1:]).all()), "slots overlap, touch or unsorted"
    row_last = last_seq[torch.arange(s.shape[0], device=s.device) % n_streams][:, None]
    assert bool(((s >= 0) & (e <= row_last) | ~live).all()), "a slot outside [0, last_seq]"
    assert bool(((s == intervals.EMPTY) & (e == intervals.EMPTY - 1) | live).all()), "a bad empty slot"


def chunk_runs(onehot, gossip, phase: int = 10, keep: dict | None = None) -> dict:
    """``anti_entropy_chunks()`` at the reference's size (1,000 nodes, 16
    streams of 8,192 seqs, 240 rounds: converged) and at 100,000 nodes
    (1.6 M (node, stream) rows, ``CHUNK_100K_ROUNDS`` rounds: the interval
    invariants, reassembly that never falls), 24 rounds a call, each call
    resuming the last. The 100,000-node run's state, vis and curves after
    its first call (``CHUNK_SHARDED_ROUNDS``), its ms and its peak memory
    over those rounds go into ``keep`` on the host for phase 13. The
    launch counts are reset before the pair and read after it (the plane
    launches no kernel). Returns them."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import chunk_engine

    onehot.reset_launches()
    for n in (1000, 100_000):
        cfg, origin, last, rounds = baselines.anti_entropy_chunks(n=n, device="cuda")
        if n == 100_000:
            rounds = CHUNK_100K_ROUNDS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gossip.reset_host_syncs()
        state = vis = None
        parts, elapsed = [], 0.0
        tele = flight_telemetry("anti_entropy_chunks", "chunk") if n == 1000 else None
        for r0 in range(0, rounds, 24):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = chunk_engine.simulate_chunks(
                cfg, origin, last, min(24, rounds - r0), seed=0, state=state, vis=vis,
                start_round=r0, telemetry=tele, device="cuda",
            )
            b.record()
            b.synchronize()
            vis = m["vis"]
            parts.append(m["curves"])
            elapsed += a.elapsed_time(b)
            if n == 100_000 and r0 + 24 == CHUNK_SHARDED_ROUNDS and keep is not None:
                keep.update(state=(state.have.starts.cpu(), state.have.ends.cpu()),
                            vis=vis.cpu(), curves=dict(m["curves"]), ms=elapsed,
                            peak=torch.cuda.max_memory_allocated())
        curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        peak = torch.cuda.max_memory_allocated()
        applied = curves["streams_applied"].astype(np.int64)
        assert len(applied) == rounds and np.isfinite(curves["need"]).all()
        assert (np.diff(applied) >= 0).all(), "streams_applied fell without a wipe"
        check_intervals(state.have, last, cfg.n_streams)
        if n == 1000:
            assert m["unapplied"] == 0, f"anti_entropy_chunks did not converge: {m['unapplied']}"
        lagging = np.nonzero(curves["need"] != 0)[0]
        done = int(lagging[-1]) + 1 if len(lagging) else 0
        log(f"phase {phase}: anti_entropy_chunks N={n} S={cfg.n_streams} last_seq="
            f"{int(last[0])} ({cfg.rows:,} rows) {rounds} rounds: {elapsed / rounds:.1f} ms/round "
            f"(CUDA events), peak memory {peak / 2**30:.2f} GiB, host syncs a round "
            f"{sum(gossip.HOST_SYNCS.values()) / rounds:.2f} (branches; plus one curve copy a "
            f"24-round call); applied_frac {m['applied_frac']:.6f}, unapplied {m['unapplied']}, "
            f"p50 {m['p50_s']:.1f} s, p99 {m['p99_s']:.1f} s, "
            + (f"need 0 from round {done}" if done < rounds else f"need[-1] {curves['need'][-1]:.0f}")
            + f"; chunks sent {int(curves['msgs'].astype(np.int64).sum())}, seqs granted "
            f"{int(curves['applied_sync'].astype(np.int64).sum())}; intervals sorted, disjoint, "
            f"non-adjacent, inside [0, last_seq]")
        if tele is not None:
            check_flight(tele, curves, phase, f"anti_entropy_chunks N={n}", elapsed / rounds)
        del state, vis, m
    launches = dict(onehot.LAUNCHES)
    assert not any(launches.values()), f"the chunk plane launched kernels: {launches}"
    return launches


def mixed_run(onehot, gossip, phase: int = 11, keep: dict | None = None) -> dict:
    """``mixed_storm()`` at the reference's size (1,000 nodes, 64 writers,
    16 streams of 2,048 seqs, 512 cells, 200 rounds), 25 rounds a call,
    each resuming the last and a chunk of the flight recorder: converged
    on both planes, every node's cells equal to the serial-merge ground
    truth of the final heads, the fast path's four kernels launched. Its
    state and curves after ``MIXED_SHARDED_ROUNDS``, its ms and its peak
    memory over those rounds go into ``keep`` on the host for phase 13.
    Returns the launch counts of the run."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.ops import gossip as gossip_ops
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import mixed_engine

    cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    tele = flight_telemetry("mixed_storm", "mixed")
    state, parts, elapsed = None, [], 0.0
    for r0 in range(0, sched.rounds, 25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, curves = mixed_engine.simulate_mixed(
            cfg, ccfg, topo, sched.slice(r0, min(r0 + 25, sched.rounds)), spec, seed=0,
            state=state, telemetry=tele, device="cuda",
        )
        b.record()
        b.synchronize()
        elapsed += a.elapsed_time(b)
        parts.append(curves)
        if r0 + 25 == MIXED_SHARDED_ROUNDS and keep is not None:
            keep.update(state=mesh_mod.to_host(state), ms=elapsed,
                        curves={k: np.concatenate([p[k] for p in parts]) for k in parts[0]},
                        peak=torch.cuda.max_memory_allocated())
    launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    peak = torch.cuda.max_memory_allocated()
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    rounds, n, s = sched.rounds, cfg.n_nodes, len(spec.writer)
    d = state.data
    heads = d.head.cpu().numpy()
    assert all(heads[w] >= v for w, v in zip(spec.writer, spec.version)), "a big version lost"
    assert bool((d.contig == d.head[None, :]).all()), "contig != head"
    assert int(gossip_ops.total_need(d)) == 0, "total_need != 0"
    assert bool(state.applied_before.all()), "a stream not reassembled"
    assert int(curves["streams_applied"][-1]) == n * s and float(curves["need"][-1]) == 0.0
    assert int((state.vis_round < 0).sum()) == 0, "a sample unseen"
    assert curves["chunks_sent"].sum() > 0 and curves["seqs_granted"].sum() > 0
    t0 = time.perf_counter()
    truth = gossip_ops.serial_merge_reference(d.head, cfg.gossip)
    truth_s = time.perf_counter() - t0
    cells = gossip_ops.node_cells(d, cfg.gossip)
    for f, want in zip(cells, truth):
        assert bool((f == want[None, :]).all()), "cells differ from the serial merge"
    assert int((truth.cl > 0).sum()) > 0, "the serial merge wrote no cell"
    missing = [k for k in PATH_KERNELS["mixed_storm"] if launches[k] == 0]
    assert not missing, f"mixed_storm: kernels never launched on its path: {missing}"
    lagging = np.nonzero(curves["need"] != 0)[0]
    done = int(lagging[-1]) + 1 if len(lagging) else 0
    log(f"phase {phase}: mixed_storm N={n} W={cfg.gossip.n_writers} S={s} last_seq="
        f"{int(spec.last_seq[0])} K={cfg.gossip.n_cells} {rounds} rounds: {elapsed / rounds:.1f} "
        f"ms/round (CUDA events), peak memory {peak / 2**30:.2f} GiB; converged (need 0 from "
        f"round {done}, contig == head, every pair reassembled, every sample seen, every node's "
        f"cells equal to the serial merge of {int(d.head.sum())} versions, built in "
        f"{truth_s:.2f} s); chunks sent {int(curves['chunks_sent'].astype(np.int64).sum())}, seqs "
        f"granted {int(curves['seqs_granted'].astype(np.int64).sum())}, msgs "
        f"{int(curves['msgs'].astype(np.int64).sum())}, cell merges "
        f"{int(curves['cell_merges'].astype(np.int64).sum())}")
    check_flight(tele, curves, phase, "mixed_storm", elapsed / rounds)
    log(f"phase {phase}: launches {json.dumps(launches)} "
        f"({json.dumps({k: round(v / rounds, 2) for k, v in launches.items() if v})} a round); "
        f"host syncs {json.dumps(syncs)} ({sum(syncs.values()) / rounds:.2f} a round)")
    return launches


def _unequal(a: dict, b: dict) -> dict:
    """The top-level fields of two reports that are not exactly equal:
    (baseline, card) for a number, "differs" for a list or a dict."""
    return {
        k: "differs" if isinstance(a.get(k), (dict, list)) else [a.get(k), b.get(k)]
        for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)
    }


def kitchen_sink():
    """The invariant suite's ``kitchen-sink`` fault plan at its standard
    size (48 rounds)."""
    from corrosion_tpu_torch.sim import faults, invariants

    return faults.named_scenarios(48, invariants.STD_REGIONS, invariants.STD_NODES,
                                  protect=invariants.PROTECTED)["kitchen-sink"]


def cli_main(argv: list) -> tuple[int, str]:
    """``python -m corrosion_tpu_torch <argv>`` in this process (the kernel
    library stays loaded): its exit code and standard output. No
    ``--device`` unless ``argv`` names one: the CLI resolves CUDA itself."""
    import io

    from corrosion_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue()


def demo_flights(phase: int) -> dict:
    """The reference CI's flight commands on the card: the three committed
    demo flights (96 nodes, 48 rounds, churn, seed 0; flat, geo, geo
    adaptive) recorded through ``obs record``; the flat one's ``obs report
    --json`` (with the facts' kill rounds) diffed against
    ``CONVERGENCE_BASELINE.json``, each geo one's ``obs epidemic report``
    against ``EPIDEMIC_BASELINE.json`` or ``EPIDEMIC_BASELINE_ADAPTIVE.json``
    by ``obs diff`` and ``obs epidemic diff`` at tolerance 0.35, each
    exiting 0; the report converged, the epidemic accounting reconciled
    and its SI fit made."""
    from corrosion_tpu_torch.sim import health, telemetry

    FLIGHTS.mkdir(parents=True, exist_ok=True)
    out = {}
    for geo, adaptive in ((False, False), (True, False), (True, True)):
        label = "adaptive" if adaptive else "geo" if geo else "flat"
        path = FLIGHTS / f"demo_{label}.jsonl"
        report_path = FLIGHTS / f"demo_{label}_report.json"
        t0 = time.perf_counter()
        rc, text = cli_main(["obs", "record", "--out", path, "--nodes", 96, "--rounds", 48,
                             "--churn", "--seed", 0] + ["--geo"] * geo + ["--adaptive"] * adaptive)
        assert rc == 0, f"obs record {label}: exit {rc}"
        facts = json.loads(text.strip().splitlines()[-1])
        wall = time.perf_counter() - t0
        _, chunks = telemetry.replay_flight(str(path))
        step_ms = sum(c["wall_s"] for c in chunks) / facts["rounds"] * 1000
        if not geo:
            kills = [a for k in facts["kill_rounds"] for a in ("--kill-round", k)]
            rc, text = cli_main(["obs", "report", path, "--json", *kills])
            assert rc == 0, f"obs report {label}: exit {rc}"
            report_path.write_text(text)
            baseline = REPO / "CONVERGENCE_BASELINE.json"
            rc, _ = cli_main(["obs", "diff", baseline, report_path, "--tolerance", 0.35])
            rep = health.load_report(str(report_path))
            assert rep.converged, "the demo flight did not converge"
            unequal = _unequal(health.load_report(str(baseline)).to_dict(), rep.to_dict())
            diff_cmd = "obs diff"
        else:
            rc, _ = cli_main(["obs", "epidemic", "report", path, "--fanout", facts["fanout"],
                              "--nodes", facts["nodes"], "--geo-regions", facts["regions"],
                              "--out", report_path])
            rep = json.loads(report_path.read_text())
            assert rc == 0 and rep["checks_ok"], (label, rc, rep["check_problems"])
            assert rep["fit"]["fitted"], f"{label}: the SI fit abstained"
            baseline = REPO / ("EPIDEMIC_BASELINE_ADAPTIVE.json" if adaptive
                               else "EPIDEMIC_BASELINE.json")
            rc, _ = cli_main(["obs", "epidemic", "diff", baseline, report_path,
                              "--tolerance", 0.35])
            unequal = _unequal(json.loads(baseline.read_text()), rep)
            diff_cmd = "obs epidemic diff"
        assert rc == 0, f"{label} demo flight: {diff_cmd} against {baseline.name} exit {rc}"
        out[label] = {"s": round(wall, 2), "converged_round": facts["converged_round"]}
        log(f"phase {phase}: demo flight {label} through the CLI (96 nodes, 48 rounds, churn, "
            f"seed 0): {wall:.1f} s, {step_ms:.1f} ms/round (device_step_ms); converged round "
            f"{facts['converged_round']}; {diff_cmd} against {baseline.name} at 0.35 exit 0; "
            f"fields not exactly equal: {json.dumps(unequal, default=str)}")
    return out


def chaos_suite(cpu: dict, phase: int) -> dict:
    """``chaos run kitchen-sink --engines dense,sparse,chunk,mixed --rounds
    48 --json`` on the card: every report ok, its facts, violations and
    recovery equal to the CPU's (``cpu``, phase 4's worker)."""
    rc, text = cli_main(["chaos", "run", "kitchen-sink", "--engines", "dense,sparse,chunk,mixed",
                         "--rounds", 48, "--json"])
    card = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and all(r["ok"] for r in card), [r["violations"] for r in card]
    cpu_reports = json.loads(json.dumps([r.to_dict() for r in cpu["suite"]]))
    assert [r["engine"] for r in card] == [r["engine"] for r in cpu_reports]
    for c, p in zip(card, cpu_reports):
        for k in ("facts", "violations", "recovery"):
            assert c[k] == p[k], f"{c['engine']}: card {k} != CPU {k}"
    log(f"phase {phase}: chaos run kitchen-sink ({kitchen_sink().describe()}): all four engines "
        f"ok, card == CPU in facts, violations and recovery (CPU {cpu['suite_s']:.1f} s in "
        f"phase 4's worker); recovery rounds "
        + ", ".join(f"{r['engine']} {r['recovery']['recovery_rounds']}" for r in card))
    return {r["engine"]: r["recovery"]["recovery_rounds"] for r in card}


def consumers(onehot, cpu: dict, phase: int = 12) -> dict:
    """The curve consumers on the card, through the command line: the
    reference CI's flight commands (``cli_obs_demo``), the invariant suite
    on ``kitchen-sink`` on all four engines (``cli_chaos``, card == CPU,
    the CPU's from phase 4's worker, ``cpu``), and a checkpoint round trip
    (``checkpoint``), each path's launch counts reset just before it and
    read just after. Returns them by path."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.sim import checkpoint, engine

    t_phase = time.perf_counter()
    by_path, secs = {}, {}
    run = path_runner(onehot, phase, by_path, secs)
    run("cli_obs_demo", lambda: demo_flights(phase))
    run("cli_chaos", lambda: chaos_suite(cpu, phase))

    def round_trip():
        cfg, topo, sched = baselines.churn_32(rounds=CHECKPOINT_ROUNDS, device="cuda")
        final, _ = engine.simulate(cfg, topo, sched, seed=0, max_chunk=100, device="cuda")
        path = str(FLIGHTS / "churn_32.npz")
        checkpoint.save_state(path, final, fingerprint="churn_32")
        loaded = checkpoint.load_state(path, cfg, len(sched.sample_writer),
                                       expect_fingerprint="churn_32", device="cuda")
        flat_a, flat_b = checkpoint._flatten(final), checkpoint._flatten(loaded)
        assert [p for p, _, _ in flat_a] == [p for p, _, _ in flat_b]
        assert all(torch.equal(x, y) for (_, x, _), (_, y, _) in zip(flat_a, flat_b)), \
            "leaves differ"
        return {"leaves": len(flat_a), "equal": True}

    run("checkpoint", round_trip)
    log(f"phase {phase}: seconds by path {json.dumps(secs)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return by_path


# ---- phase 13: the shard driver and the elastic plane ------------------------


def _same_on_card(a, b) -> list:
    """Paths of the leaves where two state trees (placed or whole) differ,
    compared on the card."""
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim.checkpoint import _flatten

    fa, fb = _flatten(mesh_mod.assemble(a)), _flatten(mesh_mod.assemble(b))
    assert [p for p, _, _ in fa] == [p for p, _, _ in fb], "state trees differ in structure"
    return [p for (p, x, _), (_, y, _) in zip(fa, fb) if not torch.equal(x, y.to(x.device))]


def _curve_diff(a: dict, b: dict, skip=()) -> list:
    return [k for k in a if k not in skip and not np.array_equal(a[k], b[k])]


def _timed(fn):
    """``fn()`` between two CUDA events: (its result, ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _tally_calls(info: dict, call: dict) -> None:
    """Add one call's ``info`` (exchange bytes by kind and tag, state bytes
    a round) to a run's."""
    for key in ("exchange_bytes", "exchange_bytes_by_tag"):
        for k, v in call[key].items():
            info.setdefault(key, {})[k] = info.get(key, {}).get(k, 0.0) + v
    info.setdefault("state_bytes", []).extend(call["state_bytes"])


def sharded_runs(onehot, gossip, kept: dict, drills: tuple, phase: int = 13) -> dict:
    """The shard driver and the elastic plane on the card, each path's
    launch counts reset just before it and read just after:

    (a) full-width ``wan_100k()`` on a (2, 2) mesh of card positions,
        partitioned (every plane per position, the state resident in the
        positions' blocks), ``SHARDED_ROUNDS`` rounds in calls of 12:
        curves equal phase 5's first rounds (but the xshard keys), the
        final state equals phase 5's at that round, the queue wire's bytes
        equal ``traffic_model``, each position holds the predicted bytes
        after every round; first, one round from a fresh state under the
        structural check (no whole node plane inside a position body).
        Printed beside phase 5's: ms/round and peak memory; beside
        ``traffic_model``'s detail: the bytes of each exchange kind;
    (b) full-width ``anywrite_sparse()`` on the same mesh, partitioned
        (every plane of the round and the epoch boundary per position, the
        state resident in the positions' blocks): one round from a fresh
        state under the structural check, then ``SPARSE_SHARDED_ROUNDS``
        rounds whose curves, state and info equal phase 7's at that round,
        each position holding the predicted bytes after every round, its
        peak at or below phase 7's over the same rounds; printed beside
        phase 7's: ms/round and peak; the exchange bytes by kind and tag;
        then phase 4's n=2000 on 4 positions (forced demotions, the cold
        plane) == the unsharded card run;
    (c), (d) the 100,000-node chunk plane and full-size ``mixed_storm()``
        on the same mesh, partitioned (``chunk_mixed_sharded_runs``);
    (e) the merge_10k burst at n=2560 (legacy delivery) on 2 positions,
        partitioned, == the unsharded card run;
    (f) the elastic drills on the card (``ELASTIC_DRILLS``, ``drills``:
        the processes ``start_drills`` started with phase 12): each equal
        to its uninterrupted run, the preemption's recovery machinery
        fired, the budget gate's survival fields ok, each report equal to
        the CPU's.

    Returns the launch counts by path."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.obs import epidemic
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.parallel import shard_driver
    from corrosion_tpu_torch.sim import engine
    from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

    t_phase = time.perf_counter()
    by_path = {}

    # (a) wan_100k at full width on a (2, 2) mesh, partitioned.
    cfg, topo, sched = build_path("wan_100k")
    mesh = parallel.make_wan_mesh(2, 2)
    log(f"phase {phase}: {mesh!r}")
    n, nl = cfg.n_nodes, cfg.n_nodes // mesh.size
    # The structural check: one full-width round from a fresh state, every
    # operation of every position body watched (its launches not counted).
    check = shard_driver.WholePlaneCheck(n, nl, n_cells=cfg.gossip.n_cells)
    out, check_ms = _timed(lambda: parallel.simulate_sharded(
        cfg, topo, sched.slice(0, 1), mesh, seed=0, watch=check
    ))
    watched = out[1]
    del out  # the watched round's state, so the timed run's peak is its own
    assert not _curve_diff({k: v[:1] for k, v in kept["curves"].items()}, watched,
                           XSHARD_CURVE_KEYS), "wan_100k watched round differs from phase 5's"
    assert check.ops > 1000 and check.found == [], \
        f"wan_100k: whole node planes inside the position bodies: {check.found[:8]}"
    log(f"phase {phase}: structural check over one full-width round: {check.ops} operations "
        f"in the position bodies, none outputs a whole node plane ({check_ms:.0f} ms watched)")
    del watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    state, parts, elapsed, info = None, [], 0.0, {}
    for r0 in range(0, SHARDED_ROUNDS, 12):
        call = {}
        (state, curves), ms = _timed(lambda: parallel.simulate_sharded(
            cfg, topo, sched.slice(r0, r0 + 12), mesh, seed=0, state=state, info=call
        ))
        elapsed += ms
        parts.append(curves)
        _tally_calls(info, call)
    by_path["wan_100k_sharded"] = launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    peak = torch.cuda.max_memory_allocated()
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    missing = [k for k in PATH_KERNELS["wan_100k_sharded"] if launches[k] == 0]
    assert not missing, f"wan_100k sharded: kernels never launched: {missing}"
    bad = _curve_diff(kept["curves"], curves, XSHARD_CURVE_KEYS)
    assert not bad, f"wan_100k sharded: curves differ from phase 5's in {bad}"
    bad = _same_on_card(state, kept["state"])
    assert not bad, f"wan_100k sharded: final state differs from phase 5's in {bad}"
    ok, problems = epidemic.xshard_model_check(curves, cfg.gossip, mesh)
    assert ok, problems
    tm = parallel.traffic_model(cfg.gossip, mesh)
    per = parallel.per_device_state_bytes(state)
    predicted = mesh_mod.predicted_per_device_bytes(
        state, mesh_mod.cluster_state_specs(state, mesh), mesh
    )
    assert sorted(per) == list(range(mesh.size)) and set(per.values()) == {predicted}, per
    during = {b for row in info["state_bytes"] for b in row}
    assert len(info["state_bytes"]) == SHARDED_ROUNDS and during == {predicted}, during
    whole = sum(math.prod(x.shape) * x.dtype.itemsize for x in mesh_mod.tree_leaves(state))
    rounds = SHARDED_ROUNDS
    exch = {k: v / rounds for k, v in sorted(info["exchange_bytes"].items())}
    by_tag = {k: v / rounds for k, v in sorted(info["exchange_bytes_by_tag"].items())}
    detail = {k: tm["detail"][k] for k in
              ("alive_gather_bytes", "pulled_reduce_bytes", "sync_gather_bytes_est")}
    assert by_tag["gather:alive"] == detail["alive_gather_bytes"], (by_tag, detail)
    log(f"phase {phase}: wan_100k N={n} partitioned on {mesh.size} positions, {rounds} "
        f"rounds: {elapsed / rounds:.1f} ms/round against {kept['ms'] / rounds:.1f} unsharded "
        f"(phase 5, CUDA events; all positions share one card, so no speed claim), peak memory "
        f"{peak / 2**30:.2f} GiB against phase 5's {kept['peak'] / 2**30:.2f} GiB (its whole "
        f"240-round run); curves equal phase 5's first {rounds} rounds, final state equal leaf "
        f"for leaf; queue wire a round ici {curves['xshard_bytes_ici'][0]:.0f}, dcn "
        f"{curves['xshard_bytes_dcn'][0]:.0f} == traffic_model ({tm['xshard_bytes_ici']:.0f}, "
        f"{tm['xshard_bytes_dcn']:.0f}); state bytes a position after every round {predicted} "
        f"== predicted ({predicted / whole:.4f} of the whole {whole}); launches "
        f"{json.dumps(launches)}; host syncs {json.dumps(syncs)}")
    log(f"phase {phase}: exchange bytes a round between positions, by kind "
        f"{json.dumps(exch)}; by tag {json.dumps(by_tag)}; traffic_model's estimates "
        f"{json.dumps(detail)}")
    kept["sharded"] = dict(ms_per_round=elapsed / rounds, peak=peak, state_bytes=predicted,
                           exchange=exch, by_tag=by_tag, detail=detail)
    mid = kept.pop("state")
    # Phase 15 holds this round's rows that fall short of head to the
    # SQLite store: the cells, watermarks and window words stay on the host.
    kept["mid"] = dict(cells=mid.data.cells, head=mid.data.head, contig=mid.data.contig,
                       oo=mid.data.oo, alive=mid.swim.alive)
    del state, parts, mid

    by_path.update(sparse_sharded_runs(onehot, gossip, kept, mesh, phase))
    by_path.update(chunk_mixed_sharded_runs(onehot, gossip, kept, mesh, phase))

    # (e) the merge_10k burst at n=2560 (legacy delivery) on 2 positions.
    cfg, topo, sched = baselines.merge_10k(device="cuda", n=2560, rounds=MERGE_SHARDED_ROUNDS)
    sched = _burst(sched, engine.Schedule)
    mesh2 = parallel.make_mesh(2)
    onehot.reset_launches()
    (final, curves), ms = _timed(lambda: parallel.simulate_sharded(
        cfg, topo, sched, mesh2, seed=0, max_chunk=24
    ))
    by_path["merge_10k_sharded"] = launches = dict(onehot.LAUNCHES)
    (whole, want), ms_whole = _timed(lambda: engine.simulate(
        cfg, topo, sched, seed=0, max_chunk=24, device="cuda"
    ))
    missing = [k for k in PATH_KERNELS["merge_10k_sharded"] if launches[k] == 0]
    assert not missing, f"merge_10k sharded: kernels never launched: {missing}"
    bad = _same_on_card(final, whole) + _curve_diff(want, curves, XSHARD_CURVE_KEYS)
    assert not bad, f"merge_10k sharded differs from the unsharded card run in {bad}"
    ok, problems = epidemic.xshard_model_check(curves, cfg.gossip, mesh2)
    assert ok, problems
    log(f"phase {phase}: merge_10k burst n={cfg.n_nodes} (legacy delivery) on {mesh2.size} "
        f"positions, {sched.rounds} rounds == the unsharded card run ({ms / sched.rounds:.1f} "
        f"against {ms_whole / sched.rounds:.1f} ms/round); exchange bytes a round ici "
        f"{curves['xshard_bytes_ici'][0]:.0f}; launches {json.dumps(launches)}")
    del final, whole

    # (f) the elastic drills.
    by_path["elastic"] = elastic_drills(drills, phase)
    log(f"phase {phase}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def sparse_sharded_runs(onehot, gossip, kept: dict, mesh, phase: int = 13) -> dict:
    """Phase 13 (b): full-width ``anywrite_sparse()`` partitioned on
    ``mesh``, held to phase 7's first ``SPARSE_SHARDED_ROUNDS`` rounds
    (``kept["sparse"]``, popped), then phase 4's n=2000 on the same mesh
    against its unsharded card run. Returns the launch counts by path."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.obs import epidemic
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.parallel import shard_driver
    from corrosion_tpu_torch.sim import sparse_engine
    from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

    by_path = {}
    # (b) anywrite_sparse at full width on the (2, 2) mesh, partitioned:
    # one round from a fresh state under the structural check, then its
    # first SPARSE_SHARDED_ROUNDS rounds, held to phase 7's.
    sk = kept.pop("sparse")
    cfg, topo, sched = build_path("anywrite_sparse")
    n, nl = cfg.n_nodes, cfg.n_nodes // mesh.size
    epochs = SPARSE_SHARDED_ROUNDS // cfg.sparse.epoch_rounds
    check = shard_driver.WholePlaneCheck(n, nl, n_cells=cfg.gossip.n_cells)
    out, check_ms = _timed(lambda: parallel.simulate_sparse_sharded(
        cfg, topo, sched.slice(0, 1), mesh, seed=0, watch=check
    ))
    watched = out[3]
    del out  # the watched round's state, so the timed run's peak is its own
    assert all(np.isfinite(v.astype(np.float64)).all() for v in watched.values())
    assert check.ops > 1000 and check.found == [], \
        f"anywrite_sparse: whole node planes inside the position bodies: {check.found[:8]}"
    log(f"phase {phase}: structural check over one full-width anywrite_sparse round (its "
        f"epoch boundary and round): {check.ops} operations in the position bodies, none "
        f"outputs a whole node plane ({check_ms:.0f} ms watched)")
    del watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    info = {}
    got, ms = _timed(lambda: parallel.simulate_sparse_sharded(
        cfg, topo, sched, mesh, seed=0, stop_after_epoch=epochs - 1, info=info
    ))
    by_path["anywrite_sparse_sharded"] = launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    peak = torch.cuda.max_memory_allocated()
    rounds = len(got[3]["need"])
    assert rounds == SPARSE_SHARDED_ROUNDS, rounds
    missing = [k for k in PATH_KERNELS["anywrite_sparse_sharded"] if launches[k] == 0]
    assert not missing, f"anywrite_sparse sharded: kernels never launched: {missing}"
    bad = _curve_diff(sk["curves"], got[3], XSHARD_CURVE_KEYS)
    assert not bad, f"anywrite_sparse sharded: curves differ from phase 7's in {bad}"
    bad = _same_on_card(tuple(got[:3]), sk["state"])
    assert not bad, f"anywrite_sparse sharded: state differs from phase 7's in {bad}"
    want = {"epochs": len(sk["infos"]), "retired": sum(i["retired"] for i in sk["infos"]),
            "promoted": sum(i["promoted"] for i in sk["infos"]),
            "dev_dropped": sum(i["dev_dropped"] for i in sk["infos"]),
            "max_dev_entries": max(i["max_dev_entries"] for i in sk["infos"])}
    assert {k: got[4][k] for k in want} == want, (got[4], want)
    assert want["retired"] > 0, "anywrite_sparse sharded: no slot retired in the run"
    ok, problems = epidemic.xshard_model_check(got[3], cfg.gossip, mesh)
    assert ok, problems
    tree = tuple(got[:3])
    per = parallel.per_device_state_bytes(tree)
    predicted = mesh_mod.predicted_per_device_bytes(tree, shard_driver.sparse_specs(tree, mesh),
                                                    mesh)
    assert sorted(per) == list(range(mesh.size)) and set(per.values()) == {predicted}, per
    during = {b for row in info["state_bytes"] for b in row}
    assert len(info["state_bytes"]) == rounds and during == {predicted}, during
    whole = sum(math.prod(x.shape) * x.dtype.itemsize for x in mesh_mod.tree_leaves(tree))
    exch = {k: v / rounds for k, v in sorted(info["exchange_bytes"].items())}
    by_tag = {k: v / rounds for k, v in sorted(info["exchange_bytes_by_tag"].items())}
    log(f"phase {phase}: anywrite_sparse N={n} W={cfg.gossip.n_writers} partitioned on "
        f"{mesh.size} positions, {rounds} rounds ({epochs} epochs): {ms / rounds:.1f} ms/round "
        f"against {sk['ms'] / rounds:.1f} unsharded (phase 7, CUDA events; all positions share "
        f"one card, so no speed claim), peak memory {peak / 2**30:.2f} GiB against phase 7's "
        f"{sk['peak'] / 2**30:.2f} GiB over the same rounds; curves equal phase 7's first "
        f"{rounds} rounds, state equal leaf for leaf, info {json.dumps(want)}; cold_healed "
        f"{int(got[3]['cold_healed'].sum())}; queue wire a round ici "
        f"{got[3]['xshard_bytes_ici'][0]:.0f}, dcn {got[3]['xshard_bytes_dcn'][0]:.0f} == "
        f"traffic_model; state bytes a position after every round {predicted} == predicted "
        f"({predicted / whole:.4f} of the whole {whole}); launches {json.dumps(launches)}; host "
        f"syncs {json.dumps(syncs)}")
    log(f"phase {phase}: anywrite_sparse exchange bytes a round between positions, by kind "
        f"{json.dumps(exch)}; by tag {json.dumps(by_tag)}")
    assert peak <= sk["peak"], (f"anywrite_sparse sharded: peak {peak} above the unsharded "
                                f"run's {sk['peak']} over the same rounds")
    kept["sparse_sharded"] = dict(ms_per_round=ms / rounds, ms_unsharded=sk["ms"] / rounds,
                                  peak=peak, peak_unsharded=sk["peak"], state_bytes=predicted,
                                  exchange=exch, by_tag=by_tag)
    del got, tree, sk

    # (b') anywrite_sparse at phase 4's n=2000 on 4 positions: forced
    # demotions under a region cut, so the partitioned cold plane runs.
    cfg, topo, sched = baselines.anywrite_sparse(device="cuda", **SPARSE_SMALL)
    onehot.reset_launches()
    got, ms = _timed(lambda: parallel.simulate_sparse_sharded(cfg, topo, sched, mesh, seed=0))
    by_path["anywrite_sparse_small_sharded"] = launches = dict(onehot.LAUNCHES)
    want, ms_whole = _timed(lambda: sparse_engine.simulate_sparse(cfg, topo, sched, seed=0,
                                                                  device="cuda"))
    missing = [k for k in PATH_KERNELS["anywrite_sparse_small_sharded"] if launches[k] == 0]
    assert not missing, f"anywrite_sparse n=2000 sharded: kernels never launched: {missing}"
    bad = _same_on_card(tuple(got[:3]), tuple(want[:3]))
    bad += _curve_diff(want[3], got[3], XSHARD_CURVE_KEYS)
    assert not bad, f"anywrite_sparse n=2000 sharded differs from the unsharded card run in {bad}"
    assert {k: v for k, v in got[4].items() if k != "resume"} == \
           {k: v for k, v in want[4].items() if k != "resume"}
    assert got[4]["max_dev_entries"] > 0 and got[3]["cold_healed"].sum() > 0
    ok, problems = epidemic.xshard_model_check(got[3], cfg.gossip, mesh)
    assert ok, problems
    rounds = len(got[3]["need"])
    log(f"phase {phase}: anywrite_sparse n={cfg.n_nodes} on {mesh.size} positions, {rounds} "
        f"rounds == the unsharded card run ({ms / rounds:.1f} against {ms_whole / rounds:.1f} "
        f"ms/round); max dev entries {got[4]['max_dev_entries']}, cold_healed "
        f"{int(got[3]['cold_healed'].sum())}; exchange bytes a round ici "
        f"{got[3]['xshard_bytes_ici'][0]:.0f}, dcn {got[3]['xshard_bytes_dcn'][0]:.0f} == "
        f"traffic_model; launches {json.dumps(launches)}")
    del got, want

    return by_path


def chunk_mixed_sharded_runs(onehot, gossip, kept: dict, mesh, phase: int = 13) -> dict:
    """Phase 13 (c) and (d) on ``mesh``, each path's launch counts reset
    just before its timed run and read just after:

    (c) the 100,000-node ``anti_entropy_chunks`` partitioned (400,000
        (node, stream) rows a position): one round from a fresh state under
        the structural check, then ``CHUNK_SHARDED_ROUNDS`` rounds whose
        curves, coverage and vis equal phase 10's after its first call
        (``kept["chunks"]``, popped);
    (d) full-size ``mixed_storm()`` partitioned: one round under the check,
        then ``MIXED_SHARDED_ROUNDS`` rounds in calls of 25 whose curves
        (but the xshard keys, held to ``traffic_model``) and state equal
        phase 11's at that round (``kept["mixed"]``, popped).

    Each prints its ms/round beside the unsharded run's, its peak memory
    (asserted at or below the unsharded run's over the same rounds), each
    position's state bytes after every round (asserted equal to the
    prediction) and the exchange bytes by tag. Returns the launch counts by
    path."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.obs import epidemic
    from corrosion_tpu_torch.ops.chunks import ChunkState
    from corrosion_tpu_torch.ops.intervals import IntervalSet
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.parallel import shard_driver
    from corrosion_tpu_torch.sim.telemetry import XSHARD_CURVE_KEYS

    by_path = {}

    def report(label, rounds, ms, unsharded, peak, info, tree, specs, extra=""):
        per = parallel.per_device_state_bytes(tree)
        predicted = mesh_mod.predicted_per_device_bytes(tree, specs, mesh)
        assert sorted(per) == list(range(mesh.size)) and set(per.values()) == {predicted}, per
        during = {b for row in info["state_bytes"] for b in row}
        assert len(info["state_bytes"]) == rounds and during == {predicted}, during
        whole = sum(math.prod(x.shape) * x.dtype.itemsize for x in mesh_mod.tree_leaves(tree))
        by_tag = {k: v / rounds for k, v in sorted(info["exchange_bytes_by_tag"].items())}
        log(f"phase {phase}: {label} partitioned on {mesh.size} positions, {rounds} rounds: "
            f"{ms / rounds:.1f} ms/round against {unsharded['ms'] / rounds:.1f} unsharded (CUDA "
            f"events; all positions share one card, so no speed claim), peak memory "
            f"{peak / 2**30:.2f} GiB against {unsharded['peak'] / 2**30:.2f} GiB over the same "
            f"rounds; equal to the unsharded card run{extra}; state bytes a position after "
            f"every round {predicted} == predicted ({predicted / whole:.4f} of the whole "
            f"{whole}); exchange bytes a round between positions by tag {json.dumps(by_tag)}")
        assert peak <= unsharded["peak"], (f"{label}: peak {peak} above the unsharded run's "
                                           f"{unsharded['peak']} over the same rounds")
        return dict(ms_per_round=ms / rounds, ms_unsharded=unsharded["ms"] / rounds, peak=peak,
                    peak_unsharded=unsharded["peak"], state_bytes=predicted, by_tag=by_tag)

    # (c) the chunk plane at 100,000 nodes.
    ck = kept.pop("chunks")
    cfg, origin, last, _ = baselines.anti_entropy_chunks(n=100_000, device="cuda")
    n, nl = cfg.n_nodes, cfg.n_nodes // mesh.size
    check = shard_driver.WholePlaneCheck(n, nl, n_streams=cfg.n_streams)
    out, check_ms = _timed(lambda: parallel.simulate_chunks_sharded(
        cfg, origin, last, 1, mesh, seed=0, watch=check))
    bad = _curve_diff({k: v[:1] for k, v in ck["curves"].items()}, out[1]["curves"])
    assert not bad, f"anti_entropy_chunks watched round differs from phase 10's in {bad}"
    del out  # the watched round's state, so the timed run's peak is its own
    assert check.ops > 1000 and check.found == [], \
        f"anti_entropy_chunks: whole planes inside the position bodies: {check.found[:8]}"
    log(f"phase {phase}: structural check over one 100,000-node chunk round: {check.ops} "
        f"operations in the position bodies, none outputs a whole node or (node, stream) "
        f"plane ({check_ms:.0f} ms watched)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    info = {}
    (state, m), ms = _timed(lambda: parallel.simulate_chunks_sharded(
        cfg, origin, last, CHUNK_SHARDED_ROUNDS, mesh, seed=0, info=info))
    by_path["anti_entropy_chunks_sharded"] = launches = dict(onehot.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    assert not any(launches.values()), f"the partitioned chunk plane launched kernels: {launches}"
    bad = _curve_diff(ck["curves"], m["curves"])
    assert not bad, f"anti_entropy_chunks partitioned: curves differ from phase 10's in {bad}"
    want = ChunkState(have=IntervalSet(*ck["state"]))
    bad = _same_on_card((state, m["vis"]), (want, ck["vis"]))
    assert not bad, f"anti_entropy_chunks partitioned: state differs from phase 10's in {bad}"
    tree = (state, m["vis"])
    kept["chunks_sharded"] = report(
        f"anti_entropy_chunks N={n} S={cfg.n_streams} ({cfg.rows:,} rows, "
        f"{cfg.rows // mesh.size:,} a position)", CHUNK_SHARDED_ROUNDS, ms, ck, peak, info, tree,
        shard_driver.chunk_specs(tree, mesh),
        f" (curves, coverage and vis equal phase 10's at round {CHUNK_SHARDED_ROUNDS}; "
        f"applied_frac {m['applied_frac']:.6f}, p50 {m['p50_s']:.1f} s; host syncs "
        f"{json.dumps(dict(gossip.HOST_SYNCS))})")
    del state, m, tree, want, ck

    # (d) mixed_storm at full size.
    mk = kept.pop("mixed")
    cfg, ccfg, topo, sched, spec = baselines.mixed_storm(device="cuda")
    n, nl = cfg.n_nodes, cfg.n_nodes // mesh.size
    check = shard_driver.WholePlaneCheck(n, nl, n_cells=cfg.gossip.n_cells,
                                         n_streams=ccfg.n_streams)
    out, check_ms = _timed(lambda: parallel.simulate_mixed_sharded(
        cfg, ccfg, topo, sched.slice(0, 1), spec, mesh, seed=0, watch=check))
    bad = _curve_diff({k: v[:1] for k, v in mk["curves"].items()}, out[1], XSHARD_CURVE_KEYS)
    assert not bad, f"mixed_storm watched round differs from phase 11's in {bad}"
    del out
    assert check.ops > 1000 and check.found == [], \
        f"mixed_storm: whole planes inside the position bodies: {check.found[:8]}"
    log(f"phase {phase}: structural check over one full-size mixed_storm round: {check.ops} "
        f"operations in the position bodies, none outputs a whole node or (node, stream) "
        f"plane ({check_ms:.0f} ms watched)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    onehot.reset_launches()
    gossip.reset_host_syncs()
    state, parts, elapsed, info = None, [], 0.0, {}
    for r0 in range(0, MIXED_SHARDED_ROUNDS, 25):
        call = {}
        (state, curves), ms = _timed(lambda: parallel.simulate_mixed_sharded(
            cfg, ccfg, topo, sched.slice(r0, r0 + 25), spec, mesh, seed=0, state=state, info=call))
        elapsed += ms
        parts.append(curves)
        _tally_calls(info, call)
    by_path["mixed_storm_sharded"] = launches = dict(onehot.LAUNCHES)
    syncs = dict(gossip.HOST_SYNCS)
    peak = torch.cuda.max_memory_allocated()
    curves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    missing = [k for k in PATH_KERNELS["mixed_storm_sharded"] if launches[k] == 0]
    assert not missing, f"mixed_storm sharded: kernels never launched: {missing}"
    bad = _curve_diff(mk["curves"], curves, XSHARD_CURVE_KEYS)
    assert not bad, f"mixed_storm partitioned: curves differ from phase 11's in {bad}"
    bad = _same_on_card(state, mk["state"])
    assert not bad, f"mixed_storm partitioned: state differs from phase 11's in {bad}"
    ok, problems = epidemic.xshard_model_check(curves, cfg.gossip, mesh)
    assert ok, problems
    applied = int(curves["streams_applied"][-1])
    assert applied > 0, "mixed_storm partitioned: no stream reassembled by the cut"
    kept["mixed_sharded"] = report(
        f"mixed_storm N={n} W={cfg.gossip.n_writers} S={ccfg.n_streams}", MIXED_SHARDED_ROUNDS,
        elapsed, mk, peak, info, state, mesh_mod.mixed_state_specs(state, mesh),
        f" (curves and state equal phase 11's at round {MIXED_SHARDED_ROUNDS}; streams_applied "
        f"{applied} of {n * ccfg.n_streams}; queue wire a round ici "
        f"{curves['xshard_bytes_ici'][0]:.0f}, dcn {curves['xshard_bytes_dcn'][0]:.0f} == "
        f"traffic_model; launches {json.dumps(launches)}; host syncs {json.dumps(syncs)})")
    del state, parts, mk
    return by_path


def elastic_drills(drills: tuple, phase: int = 13) -> dict:
    """Phase 13 (f): the elastic drills (``ELASTIC_DRILLS``) on the card
    and on the CPU, each side in a process of its own started with phase
    12 (``drills``, from ``start_drills``): each equal to its uninterrupted
    run, the preemption's recovery machinery fired, the soak drill's
    resets classified as restarts in a series of one header, the budget
    gate's survival fields ok, each report equal to the CPU's. Returns the
    card side's launch counts."""
    from corrosion_tpu_torch.elastic import report, scenarios
    from corrosion_tpu_torch.obs import series

    card_proc, card_out, cpu_proc, cpu_out, t_start = drills
    t0 = time.perf_counter()
    try:
        card_run = join_worker(card_proc, card_out, "phase 13: the card side of the elastic drills")
        worker_out = join_worker(cpu_proc, cpu_out, "phase 13: the CPU side of the elastic drills")
    finally:
        stop_worker(card_proc)
        stop_worker(cpu_proc)
    wait_s = time.perf_counter() - t0
    card, card_s, launches = card_run["reports"], card_run["s"], card_run["launches"]
    cpu, cpu_s = worker_out["reports"], worker_out["s"]
    missing = [k for k in PATH_KERNELS["elastic"] if launches[k] == 0]
    assert not missing, f"elastic drills: kernels never launched: {missing}"
    for n in ELASTIC_DRILLS:
        rep = card[n]
        assert rep["ok"] and rep["bit_identical"] and rep["reconcile"]["ok"], (n, rep["mismatches"])
        walls = rep.pop("wall_s"), cpu[n].pop("wall_s")
        assert rep == cpu[n], f"{n}: the card's report differs from the CPU's"
        rep["wall_s"] = walls[0]
    mach = card["preempt_dense_churn"]["machinery"]
    assert mach["fired"] and mach["poison_changed"] and mach["replay_identical"], mach
    soak = card["soak_preempt"]
    events = len(scenarios.PREEMPT_EVENTS)
    for stem in ("corro_changes_committed", "corro_changes_applied"):
        r = soak["endurance"]["resets"][stem]
        assert r["kinds"] == ["restart"] and r["events"] == events, (stem, r)
    for dev in ("cuda", "cpu"):
        data = series.replay_series(str(REPO / "build" / "elastic" / dev / "soak_preempt.series.jsonl"))
        assert len(data["headers"]) == 1 and len(data["samples"]) == scenarios.PREEMPT_ROUNDS, dev
    budget = json.loads((REPO / "bench_budget.json").read_text())["elastic"]
    # The survival fields only: the budget's wall ceilings are the CPU lane's.
    gate = report.check_elastic_budget(
        {"scenarios": list(card.values())},
        dict(budget, scenarios={n: {} for n in ELASTIC_DRILLS}),
    )
    assert gate["ok"], gate["breaches"]
    log(f"phase {phase}: elastic drills {', '.join(ELASTIC_DRILLS)} on the card: each equal "
        f"to its uninterrupted run and its report equal to the CPU's; preempt machinery "
        f"{json.dumps(mach)}; soak_preempt: one series header, {scenarios.PREEMPT_ROUNDS} "
        f"samples, each counter's {events} resets classified restart, endurance armed "
        f"{json.dumps(soak['endurance']['detectors_armed'])}; budget gate ok on the survival "
        f"fields; card {card_s:.1f} s and CPU {cpu_s:.1f} s, each in a process of its own "
        f"started {t0 - t_start:.1f} s before phase 13 reached them (beside phases 12 and 13), "
        f"waited for them {wait_s:.1f} s; walls on the card "
        f"{json.dumps({n: round(report.wall_total(card[n]), 2) for n in ELASTIC_DRILLS})}; "
        f"launches {json.dumps(launches)}")
    return launches


# ---- phase 14: the bench harness and the device-cost plane -----------------


def bench_harness(onehot, led, first_run_s: float, compile_ms: float, cpu_costs: dict,
                  phase: int = 14) -> dict:
    """The bench harness on the card, each path's launch counts reset just
    before it and read just after (the 120-round run apart from the
    attribution and roofline steps after it, the lane's sharded runs apart
    from its attribution):

    (a) merge_10k in full (the bench's flagship: 10,000 nodes, 120 rounds,
        256 samples), seed 1, in calls of 24 rounds, with the ledger
        ``led`` armed and ``KernelTelemetry(ledger=, watermarks=)``; then
        ``plane_composite`` on its final state, ``attribute_planes``
        (``iters`` 10) and ``roofline_stage_costs``; the report put
        together as the bench puts it (``bench_context``,
        ``rounded_step_report``, ``roofline_report``,
        ``compile_split_report`` of ``first_run_s`` and ``compile_ms``),
        passing ``check_bench_invariants`` with ``steady_compiles`` 0;
    (b) ``measure_multichip`` on card positions, D in {1, 2, 4, 8}: curves
        and final states equal across D, exchange bytes equal to
        ``traffic_model`` (the lane raises otherwise);
    (c) ``obs cost show`` (the cost model of the four engines at their
        tiny configs, D in ``COST_DEVICES``) on the card, its flops and
        bytes equal to the CPU's (``cpu_costs``, built by phase 4's
        worker), and ``obs cost diff`` of the file against itself exit 0
        (``cli_cost``);
    (d) ``capacity_model`` against the card's memory: the 512-node point
        exact, the 100,352-node point a placement measured here.

    Returns the launch counts by path."""
    from corrosion_tpu_torch import parallel
    from corrosion_tpu_torch.obs import costs
    from corrosion_tpu_torch.ops import gossip as gossip_ops
    from corrosion_tpu_torch.sim import benchlib, engine, health, telemetry

    t_phase = time.perf_counter()
    by_path = {}

    # (a) merge_10k, armed.
    cfg, topo, sched = build_path("merge_10k")
    n, rounds, chunk = cfg.n_nodes, sched.rounds, 24
    wm = costs.MemoryWatermarks()
    tele = telemetry.KernelTelemetry(engine="dense", ledger=led, watermarks=wm)
    torch.cuda.synchronize()
    onehot.reset_launches()
    led.arm("phase 14 timed merge_10k run (warmed by phases 2 and 6 at the same shapes)")
    t0 = time.perf_counter()
    final, curves = engine.simulate(cfg, topo, sched, seed=1, max_chunk=chunk, telemetry=tele,
                                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_path["bench_merge_10k"] = launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["bench_merge_10k"] if launches[k] == 0]
    assert not missing, f"merge_10k bench: kernels never launched: {missing}"
    step_ms = wall / rounds * 1000.0
    onehot.reset_launches()
    composite, stages, carry0 = benchlib.plane_composite(cfg, topo, sched, final)
    attr = telemetry.attribute_planes(composite, stages, carry0, iters=10)
    plane, residual_ms = attr.scale(step_ms)
    t_costs = time.perf_counter()
    stage_costs = costs.roofline_stage_costs(composite, stages, carry0)
    stage_s = time.perf_counter() - t_costs
    torch.cuda.synchronize()
    led.disarm()
    by_path["bench_attribution"] = attr_launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["bench_attribution"] if attr_launches[k] == 0]
    assert not missing, f"merge_10k attribution: kernels never launched: {missing}"
    mem = costs.reconcile_memory(parallel.shard_cluster_state(final, parallel.make_mesh(1)),
                                 watermarks=wm)
    lat = engine.visibility_latencies(final, sched, cfg)
    rep = health.report_from_curves(curves, engine="dense", round_ms=cfg.round_ms)
    d = final.data
    converged = bool((d.contig == d.head[None, :]).all())
    applied = float(curves["applied_broadcast"].astype(np.float64).sum()
                    + curves["applied_sync"].astype(np.float64).sum())
    step_rep = benchlib.rounded_step_report(step_ms, plane)
    p99 = lat["p99_s"]
    report = telemetry.check_bench_invariants({
        **benchlib.bench_context(cfg, n, rounds, chunk, device="cuda"),
        "nodes": n,
        "rounds": rounds,
        "kernels": "cuda",
        "metric": "p99_change_visibility_10k",
        "value": round(p99, 2),
        "unit": "s",
        "vs_baseline": round(10.0 / p99, 2) if p99 > 0 else None,
        "converged": converged,
        "cells_converged": bool(gossip_ops.cells_agree(d, cfg.gossip)),
        "unseen_pairs": lat["unseen"],
        "p50_s": round(lat["p50_s"], 2),
        "throughput_changes_per_s": round(applied / wall, 1),
        **step_rep,
        "step_inner_ms": round(tele.device_step_ms, 1),
        **benchlib.compile_split_report(first_run_s, compile_ms),
        "steady_compiles": led.armed_compiles,
        "roofline": benchlib.roofline_report(stage_costs, step_rep["plane_ms"]),
        "peak_live_bytes_per_device": max(wm.peak.values(), default=0),
        "allocator_peak_bytes_per_device": max(wm.allocator_peak.values(), default=0),
        "state_bytes_per_device": mem["state_bytes_per_position_max"],
        "converged_round": rep.converged_round,
        "staleness_p99": round(rep.staleness_p99, 1),
        "queue_backlog_peak": rep.queue_backlog_peak,
    })
    assert report["steady_compiles"] == 0 and wm.samples == rounds // chunk, (
        report["steady_compiles"], wm.samples)
    log(f"phase {phase}: merge_10k bench N={n} {rounds} rounds (seed 1, ledger armed, "
        f"{wm.samples} watermark samples): {step_ms:.1f} ms/round wall, step_inner_ms "
        f"{report['step_inner_ms']}; composite {attr.full_ms:.1f} ms, overhead "
        f"{attr.overhead_ms:.2f} ms, residual {residual_ms:.1f} ms; roofline stage costs "
        f"counted in {stage_s:.1f} s; memory reconciled at rest ({json.dumps(mem['watermarks'])}); "
        f"launches of the {rounds}-round run {json.dumps(launches)}, of the attribution and "
        f"roofline steps {json.dumps(attr_launches)}")
    log(f"phase {phase}: bench report {json.dumps(report)}")
    del final, carry0, composite, d

    # (b) the multi-device lane on card positions. Its progress notes
    # split the counts: the sharded runs (a warm and a timed run of each
    # plane at each D) end where the plane attribution at max(D) begins.
    class Marks:
        def __init__(self):
            self.at = {}

        def write(self, msg):
            self.at[msg.strip()] = dict(onehot.LAUNCHES)

        def flush(self):
            pass

    marks = Marks()
    onehot.reset_launches()
    t0 = time.perf_counter()
    lane = telemetry.check_bench_invariants(_with_knobs(
        benchlib, {"MULTICHIP_ROUNDS": LANE_ROUNDS},
        lambda: benchlib.measure_multichip(device="cuda", progress=marks)))
    assert lane["rounds"] == LANE_ROUNDS, lane["rounds"]
    torch.cuda.synchronize()
    total = dict(onehot.LAUNCHES)
    runs = marks.at[f"[multichip] D={max(benchlib.MULTICHIP_DEVICE_COUNTS)}: plane attribution"]
    by_path["bench_multichip"] = runs
    by_path["bench_multichip_attribution"] = lane_attr = {k: total[k] - runs[k] for k in total}
    for path, launches in (("bench_multichip", runs), ("bench_multichip_attribution", lane_attr)):
        missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
        assert not missing, f"{path}: kernels never launched: {missing}"
    assert lane["bit_identical_across_device_counts"], lane
    log(f"phase {phase}: multichip lane D {lane['device_counts']} on card positions "
        f"({time.perf_counter() - t0:.1f} s): curves and final states equal across D; exchange "
        f"bytes a round ici {lane['xshard_bytes_per_round_ici']:.0f}, dcn "
        f"{lane['xshard_bytes_per_round_dcn']:.0f} == traffic_model; launches of the sharded "
        f"runs {json.dumps(runs)}, of the attribution and roofline steps {json.dumps(lane_attr)}")
    log(f"phase {phase}: multichip report {json.dumps(lane)}")

    # (c) the cost model on the card through the command line, against
    # the CPU's, and its self-diff.
    path = REPO / "build" / "cost_model.json"
    onehot.reset_launches()
    t0 = time.perf_counter()
    rc, _ = cli_main(["obs", "cost", "show", "--engines", ",".join(costs.ENGINES), "--devices",
                      ",".join(map(str, COST_DEVICES)), "--out", path])
    assert rc == 0, f"obs cost show: exit {rc}"
    card = costs.load_model(str(path))
    card_s = time.perf_counter() - t0
    rc, text = cli_main(["obs", "cost", "diff", path, "--json"])
    self_diff = json.loads(text)
    assert rc == 0 and self_diff["ok"] and not self_diff["notes"], (rc, self_diff["breaches"],
                                                                    self_diff["notes"])
    torch.cuda.synchronize()
    by_path["cli_cost"] = launches = dict(onehot.LAUNCHES)
    missing = [k for k in PATH_KERNELS["cli_cost"] if launches[k] == 0]
    assert not missing, f"cost model: kernels never launched: {missing}"
    assert sorted(card["entries"]) == sorted(cpu_costs["entries"])
    unequal = {}
    for key, e in card["entries"].items():
        c = cpu_costs["entries"][key]
        if any(e[m] != c[m] for m in ("flops", "bytes_accessed", "kernel_calls",
                                      "config_fingerprint")):
            unequal[key] = {op: [e["by_op"].get(op), c["by_op"].get(op)]
                            for op in sorted(set(e["by_op"]) | set(c["by_op"]))
                            if e["by_op"].get(op) != c["by_op"].get(op)}
    assert not unequal, f"cost model card != CPU (ops [card, CPU]): {json.dumps(unequal)}"
    same_mem = {k: all(e[m] == cpu_costs["entries"][k][m] for m in ("peak_bytes", "temp_bytes"))
                for k, e in card["entries"].items()}
    log(f"phase {phase}: obs cost show: {len(card['entries'])} entries on the card "
        f"({card_s:.1f} s) == the CPU's in flops, bytes, kernel calls and fingerprints; peak "
        f"and temp bytes equal too: {json.dumps(same_mem)}; obs cost diff of the file against "
        f"itself exit 0, 0 breaches, 0 notes ({time.perf_counter() - t0 - card_s:.1f} s)")
    log(f"phase {phase}: cost model " + json.dumps({
        k: {m: e.get(m) for m in ("flops", "bytes_accessed", "ops", "peak_bytes", "temp_bytes",
                                  "allocator_peak_bytes")}
        for k, e in card["entries"].items()
    }))

    # (d) the capacity curve against the card's memory.
    mesh8 = parallel.multichip_mesh(8)
    cfg100k, _, sched100k = costs.flagship_cfg(100_352, device="cuda")
    placed = costs.measure_placement(cfg100k, len(sched100k.sample_writer), mesh8)
    cap = costs.capacity_model(device="cuda", measured_100k={
        "nodes": 100_352, "device_count": 8, **placed,
        "source": "chip_smoke.py phase 14: flagship_cfg(100_352) placed on 8 card positions",
    })
    assert cap["validation"]["lane_512"]["exact"], cap["validation"]
    log(f"phase {phase}: capacity model against {cap['memory_bytes']} B of card memory: "
        f"{json.dumps(cap)}")
    log(f"phase {phase}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


# ---- phase 15: the host oracles against the card's planes -------------------


def host_oracles(onehot, kept: dict, phase: int = 15) -> dict:
    """The host oracles (``core/``'s bookkeeping, the agent's store, SWIM
    and transport, ``obs.journey``) against the planes they stand for, on
    the card, each path's launch counts reset just before it and read just
    after (``sim/host_oracles.py``):

    - ``window_bookie_fast`` and ``window_bookie_legacy``: the reference's
      two possession-window traces through ``gossip.broadcast_round`` on a
      3-node harness (``window_k`` 32), on the fast delivery and on the
      legacy one, possession and need sets equal to ``BookedVersions``
      after every delivered round;
    - ``rotation_bookie``: promotion, forced demotion, ``cold_sync`` and
      hot-slot delivery on 4 nodes, claims equal to the bookies';
    - ``coverage_rangeset``: the reference's eight trials of the interval
      sets against ``Partial``/``RangeSet``, then 32 batched chunk arrivals
      into ``anti_entropy_chunks(n=100_000)``'s 1.6 M rows, 2,000 of them
      replayed through ``RangeSet``;
    - ``native_codec``: the native codec built on this host, against the
      Python codec; the transport's frames of kind 1 (native) and kind 0
      (JSON) through the pure-Python decoder, one loopback exchange of two
      ``Transport``s on 127.0.0.1 (a frame, a datagram, a sync session)
      under 10 s, and which merge the store runs (the CRDT extension, or
      Python where ``sqlite3ext.h`` is missing);
    - ``store_crdt_trials``: the reference's six random-stream trials
      through two ``Store``s in two orders and ``crdt.apply_changes`` on
      the card;
    - ``store_crdt_plane``: four seeded delivery batches through the
      engines' cell merge (``rowmax``, ``rowgather``) on 16 nodes x 256
      cells, each row equal to a ``Store`` of its changes;
    - ``store_crdt_full``: phase 5's final wan_100k state (``kept["final"]``,
      the host copy moved to the card and freed here): the store of every committed version in two orders ==
      ``serial_merge_reference``, every converged alive row equal to it in
      one broadcast compare (at least one); then the same at round 24
      (``kept["mid"]``, phase 13's host copy, moved to the card), where 16
      rows that fall short of ``head`` are each held to a store of exactly
      the versions they hold (at least one);
    - ``membership_gc``: the kernels' down-member GC (dense and sparse)
      beside the host ``Swim``'s GC and adaptive transmissions, each under
      10 s;
    - ``membership_rings``: 40 seeds of ``gossip.sync_round``'s ring
      preference, the grants merged into 64 cells (``rowmax``,
      ``rowgather``), node 0's row equal to a store of what it holds, and
      ``rtt_ring``'s exact edges;
    - ``journey_wan_100k``: ``obs.journey`` over phase 5's flight with the
      schedule's write trace, its totals reconciled with the flight;
    - ``agent_cluster_live``: 16 of the port's agents on 127.0.0.1, each
      recorded by a ``Trace``, 48 conflicting upserts over HTTP; converged
      digests, the subscription's view equal to the table, every change
      log merged on the card equal to every agent's rows, the restored
      online backup's digest equal;
    - ``agent_trace_replay``: that trace replayed at 10,000 nodes, heads
      equal to the agents' committed versions, every alive node
      converged; the visibility percentiles logged beside the live
      cluster's seconds to convergence;
    - the serving plane's five paths (``serving_plane``);
    - the chaos and fidelity planes' six paths (``chaos_fidelity``).

    Returns the launch counts by path."""
    from corrosion_tpu_torch.models import baselines
    from corrosion_tpu_torch.parallel import mesh as mesh_mod
    from corrosion_tpu_torch.sim import host_oracles as H

    t_phase = time.perf_counter()
    by_path, secs = {}, {}
    run = path_runner(onehot, phase, by_path, secs)
    run("window_bookie_fast", lambda: H.window_bookie("cuda"))
    run("window_bookie_legacy", lambda: H.window_bookie("cuda", legacy=True))
    run("rotation_bookie", lambda: H.rotation_trace("cuda"))
    ccfg, _, last_seq, _ = baselines.anti_entropy_chunks(n=100_000, device="cuda")
    rows = ccfg.n_nodes * ccfg.n_streams

    def coverage():
        trials = H.coverage_trials("cuda")
        t0 = time.perf_counter()
        full = H.coverage_full_width(
            "cuda", rows=rows, cap=ccfg.cap, last_seq=int(last_seq[0]), chunk_len=ccfg.chunk_len,
        )
        return {"trials": trials, "full_width": full, "full_width_s": round(time.perf_counter() - t0, 2)}

    run("coverage_rangeset", coverage)

    def codec():
        out = H.native_codec()
        out["frames"] = H.transport_frames()
        out["loopback"] = H.transport_loopback()
        out["store_merge"] = "native" if H.store_merge() else "python"
        return out

    run("native_codec", codec)
    run("store_crdt_trials", lambda: H.store_crdt_trials("cuda"))
    run("store_crdt_plane", lambda: H.store_crdt_plane("cuda"))
    final, mid = kept.pop("final"), kept.pop("mid")

    def full():
        # Both host copies (phase 5's last round, phase 13's last) go back
        # to the card one at a time.
        keys = ("cells", "head", "contig", "oo", "alive")
        last = mesh_mod.assemble({k: final[k] for k in keys}, "cuda")
        out = H.store_crdt_full(*(last[k] for k in keys), final["cfg"])
        assert out["converged_rows"] >= 1, "wan_100k: no converged row to hold to the store"
        del last
        # Phase 13's round, where rows fall short of head.
        at_mid = mesh_mod.assemble(mid, "cuda")
        key = f"round_{SHARDED_ROUNDS}"
        out[key] = H.store_crdt_full(*(at_mid[k] for k in keys), final["cfg"])
        assert out[key]["short_rows_checked"] >= 1, f"wan_100k: no short row at {key}"
        return out

    run("store_crdt_full", full)
    run("membership_gc", lambda: H.membership_gc("cuda"))
    run("membership_rings", lambda: H.membership_rings("cuda"))
    run("journey_wan_100k",
        lambda: H.journey_check(str(FLIGHTS / "wan_100k.jsonl"), final["writes"]))
    live = {}

    def cluster():
        out, live["trace"], live["versions"] = H.agent_cluster_live("cuda")
        live["converge_s"] = out["converge_s"]
        return out

    run("agent_cluster_live", cluster)

    def replay():
        out = H.agent_trace_replay(live["trace"], live["versions"], H.REPLAY_NODES, "cuda")
        live.update(out)
        return out

    run("agent_trace_replay", replay)
    log(f"phase {phase}: the live cluster converged in {live['converge_s']} s of wall; "
        f"its traffic at {live['nodes']} nodes: visibility p50 {live['vis_p50_rounds']} "
        f"and p99 {live['vis_p99_rounds']} rounds")
    serving_plane(run, kept.pop("soak_cpu"), phase)
    chaos_fidelity(run, kept.pop("dcn_cpu"), phase)
    log(f"phase {phase}: seconds by path {json.dumps(secs)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return by_path


def path_runner(onehot, phase: int, by_path: dict, secs: dict):
    """``run(path, fn)``: ``fn()`` with the launch counts reset just before
    it and read just after into ``by_path[path]``, its seconds into
    ``secs[path]``; every kernel ``PATH_KERNELS[path]`` names must have
    launched."""

    def run(path: str, fn):
        onehot.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[path] = round(time.perf_counter() - t0, 2)
        by_path[path] = launches = dict(onehot.LAUNCHES)
        missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
        assert not missing, f"{path}: kernels never launched on its path: {missing}"
        log(f"phase {phase}: {path} equal to its host oracle in {secs[path]:.2f} s: "
            f"{json.dumps(out)}; launches {json.dumps(launches)}")
        return out

    return run


def serving_plane(run, soak_cpu: dict, phase: int = 15) -> None:
    """Phase 15's serving plane (``sim/host_oracles.py``), each through
    ``run`` (``path_runner``):

    - ``loadgen_soak``: ``loadgen soak`` at its defaults (96 nodes, 96
      rounds, the fast delivery path) on the card, equal key for key to
      phase 4's CPU run but ``process``, its collapse rule holding;
    - ``loadgen_soak_10k``: the same at 10,000 nodes, every node a writer,
      so W = 10,000 takes the legacy delivery; each run's watermark
      invariants, its seconds and the phase's peak memory; the backlog's
      slopes, peaks and the collapse rule logged (a finding, not a gate);
    - ``loadgen_storm``: the 2,000-subscription fan-out storm, reads over
      HTTP and the PG wire: no oracle violation, nothing missing; its table
      equal to the card's merge of its change log and to a read through a
      fresh ``serve_pg``; the host's ``RLIMIT_NOFILE`` logged;
    - ``loadgen_sweep``: the saturation sweep at its defaults: shed
      engaged, client and server shed counts equal, admitted p99 bounded;
    - ``agent_tls``: three agents gossiping over mutual TLS, or a line
      saying ``cryptography`` is absent from this host."""
    from corrosion_tpu_torch.sim import host_oracles as H

    def soak():
        rep, runs = H.loadgen_soak("cuda", cpu_report=soak_cpu)
        assert rep["collapse_rule_holds"], rep
        return {**{k: rep[k] for k in ("kernel_nodes", "rounds", "write_rate_per_round",
                                       "divergence_ratio", "collapse_rule_holds")},
                "runs": runs}

    run("loadgen_soak", soak)

    def soak_10k():
        torch.cuda.reset_peak_memory_stats()
        rep, runs = H.loadgen_soak("cuda", nodes=H.SOAK_10K_NODES)
        assert rep["kernel_nodes"] == H.SOAK_10K_NODES and len(runs) == 2, runs
        ms = [round(1000 * r["s"] / r["rounds"], 1) for r in runs]
        return {
            **{k: rep[k] for k in ("kernel_nodes", "rounds", "write_rate_per_round",
                                   "bounded_ceiling", "divergence_ratio",
                                   "collapse_rule_holds")},
            **{side: {k: rep[side][k] for k in ("intake", "staleness_last", "staleness_peak",
                                                "tail_slope_per_round")}
               for side in ("sized", "starved")},
            "runs": runs, "ms_per_round": ms,
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        }

    run("loadgen_soak_10k", soak_10k)
    run("loadgen_storm", lambda: H.loadgen_storm("cuda"))
    run("loadgen_sweep", H.loadgen_sweep)
    tls = run("agent_tls", H.agent_tls)
    log(json.dumps({"tls": tls["tls"]}))


def chaos_fidelity(run, dcn_cpu: dict, phase: int = 15) -> None:
    """Phase 15's chaos and fidelity planes (``sim/host_oracles.py``), each
    through ``run`` (``path_runner``):

    - ``fidelity_steady`` and ``fidelity_burst``: ``steady_load`` and
      ``burst_drain`` at their defaults (three of the port's agents on
      127.0.0.1, 24 writes; 12 Hz round-robin, and all at once on one
      writer): the live cluster calibrates its own round model and both
      replays of its trace run on the card; the calibrated one strictly
      closer to the live CDF, nothing unseen on either side, each replay
      equal to the port's plain path on the CPU on the same trace;
    - ``fidelity_replay_10k``: the steady run's trace at 10,000 nodes (its
      3 writers and silent observers), calibrated with
      ``ROUND_MODEL_WAN.json`` and uncalibrated at 500 ms: nothing unseen,
      the loss and probe-loss axes present in the first and absent in the
      second, the watermark invariants; latencies, time to convergence, ms
      a round and the peak memory logged;
    - ``fidelity_dcn``: ``dcn_partition`` at its shape (48 nodes, 4 geo
      regions, 64 rounds): the chaos invariant cross-check ok, both runs
      recovered, the recovery delta within bench_budget.json's
      ``fidelity`` ceiling, the dict equal to phase 4's CPU run;
    - ``hostchaos_smoke``: ``wan_steady`` and ``kill_restart``: no oracle
      violation, converged, bookkeeping contiguous, the required machinery
      fired (a breaker trip), every agent's table equal to the card's merge
      of their change logs; bench_budget.json's ``hostchaos`` breaches
      logged, not gated (its entry was recorded on the CPU);
    - ``hostchaos_soak``: ``soak_churn`` with the metric-series recorder:
      an endurance block per agent with no wedge, stall or SLO breach, the
      killed agent's counter drops classified restart; the leak slopes
      logged beside bench_budget.json's ``soak`` ceilings.

    The agents' directories go under ``build/host_oracles``."""
    from corrosion_tpu_torch.sim import host_oracles as H

    traces = {}

    def fidelity(kind):
        out, traces[kind] = H.fidelity_live(kind, "cuda")
        return out

    run("fidelity_steady", lambda: fidelity("steady"))
    run("fidelity_burst", lambda: fidelity("burst"))

    def replay_10k():
        torch.cuda.reset_peak_memory_stats()
        out = H.fidelity_replay_10k(traces["steady"], "cuda")
        out["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
        return out

    run("fidelity_replay_10k", replay_10k)
    run("fidelity_dcn", lambda: H.fidelity_dcn("cuda", cpu_report=dcn_cpu)[0])
    pair = run("hostchaos_smoke", lambda: H.hostchaos_pair("cuda"))
    soak = run("hostchaos_soak", H.hostchaos_soak)
    log(json.dumps({"hostchaos_budget_breaches": pair["budget_breaches"],
                    "soak_over_budget": {k: v["over_budget"] for k, v in soak["agents"].items()}}))


# ---- phase 16: the command line -----------------------------------------------


def cli_geo_10k(geo_push: dict, phase: int) -> dict:
    """``obs record --nodes 10000 --rounds 64 --churn --geo --seed 0``: phase
    9's push-only geo_10k through the CLI, recorded in chunks of 16; its
    flight's per-round curves equal to phase 9's push run's (``geo_push``,
    on the host), key for key; the facts' convergence round (need 0 from
    then on) equal to phase 9's, and ``obs report --json``'s equal to the
    report of phase 9's curves; ``obs epidemic report`` reconciled."""
    from corrosion_tpu_torch.sim import health, telemetry

    path = FLIGHTS / "cli_geo_10k.jsonl"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, text = cli_main(["obs", "record", "--out", path, "--nodes", 10_000, "--rounds", 64,
                         "--churn", "--geo", "--seed", 0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert rc == 0, f"obs record: exit {rc}"
    facts = json.loads(text.strip().splitlines()[-1])
    curves, chunks = telemetry.replay_flight(str(path))
    want = geo_push["curves"]
    assert set(want) <= set(curves), sorted(set(want) - set(curves))
    bad = [k for k in want if not np.array_equal(np.asarray(curves[k]), np.asarray(want[k]))]
    assert not bad, f"cli_geo_10k: the flight's curves differ from phase 9's push run in {bad}"
    assert [c["rounds"] for c in chunks] == [16] * 4, [c["rounds"] for c in chunks]
    assert facts["converged_round"] == geo_push["converged"], (facts["converged_round"],
                                                               geo_push["converged"])
    rc, text = cli_main(["obs", "report", path, "--json"])
    rep = json.loads(text)
    assert rc == 0 and rep["converged_round"] == health.report_from_curves(
        want, engine="dense").converged_round, rep["converged_round"]
    rc, text = cli_main(["obs", "epidemic", "report", path, "--nodes", 10_000,
                         "--geo-regions", 4, "--json"])
    epi = json.loads(text)
    assert rc == 0 and epi["checks_ok"], epi["check_problems"]
    return {
        "s": round(wall, 2), "ms_per_round": round(wall / 64 * 1000, 1),
        "device_step_ms": round(sum(c["wall_s"] for c in chunks) / 64 * 1000, 1),
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
        "need_zero_from": facts["converged_round"],
        "report_converged_round": rep["converged_round"],
        "mismatched_beliefs_last": facts["mismatches_last"],
        "spread_exponent": epi["fit"].get("spread_exponent"),
    }


def cli_lint(phase: int) -> dict:
    """``lint corrosion_tpu_torch --show-suppressed`` exit 0, each
    suppression listed with its reason; ``lint --sanitize --no-static
    --device cuda`` exit 0 on the four engines (each run twice: the second
    with 0 builds and 0 loads of the kernel library)."""
    from corrosion_tpu_torch.analysis import sanitize

    t0 = time.perf_counter()
    rc, text = cli_main(["lint", REPO / "corrosion_tpu_torch", "--show-suppressed"])
    static_s = time.perf_counter() - t0
    lines = text.strip().splitlines()
    assert rc == 0 and lines[-1].startswith("0 finding(s),"), lines[-3:]
    suppressed = [ln for ln in lines[:-1] if "(suppressed: " in ln]
    assert suppressed and all(ln.split("(suppressed: ", 1)[1].strip(") ") for ln in suppressed)
    t0 = time.perf_counter()
    rc, text = cli_main(["lint", "--sanitize", "--no-static", "--device", "cuda"])
    assert rc == 0, text[-2000:]
    runs = dict(sanitize.LAST_RUN)
    assert sorted(runs) == sorted(sanitize.ENGINES)
    for name, rec in runs.items():
        assert rec["builds"][1] == rec["loads"][1] == 0, (name, rec)
    return {"static_s": round(static_s, 2), "summary": lines[-1],
            "suppressions": len(suppressed), "sanitize_s": round(time.perf_counter() - t0, 2),
            "engines": {n: {"seconds": [round(x, 2) for x in r["seconds"]],
                            "second_run_builds": r["builds"][1],
                            "second_run_loads": r["loads"][1]} for n, r in runs.items()}}


def start_module() -> tuple:
    """``python -m corrosion_tpu_torch obs cost diff COST_BASELINE.json
    --json`` as a process of its own, no ``--device``: the entry point
    resolves CUDA and rebuilds the cost model at the baseline's dims (the
    reference's JAX model: variants plain and donated, D = 1 and 8) on the
    card. Started with phase 12, it runs beside phases 12 and 13; phase
    16 joins it. Returns the process and its start."""
    return subprocess.Popen(
        [sys.executable, "-m", "corrosion_tpu_torch", "obs", "cost", "diff",
         str(REPO / "COST_BASELINE.json"), "--json"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def cli_module(proc: subprocess.Popen, t_start: float, phase: int) -> dict:
    """``python -m corrosion_tpu_torch lint --list-rules`` exit 0; then the
    process ``start_module`` started: its model measured on the card
    (platform ``gpu``, backend ``cuda``, every entry's kernels launched),
    its breaches against the reference's baseline logged, not gated."""
    res = subprocess.run([sys.executable, "-m", "corrosion_tpu_torch", "lint", "--list-rules"],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().splitlines()[-1].startswith("CT062"), \
        res.stderr[-2000:]
    t0 = time.perf_counter()
    out, err = proc.communicate(timeout=900)
    wall, waited = time.perf_counter() - t_start, time.perf_counter() - t0
    assert proc.returncode in (0, 1), (proc.returncode, err[-3000:])
    diff = json.loads(out.strip().splitlines()[-1])
    measured = diff["measured"]
    assert measured["platform"] == "gpu" and measured["backend"] == "cuda", measured["platform"]
    calls = {k: sum(e["kernel_calls"].values()) for k, e in measured["entries"].items()}
    assert all(n > 0 for k, n in calls.items() if not k.startswith("chunk/")), calls
    log(f"phase {phase}: python -m corrosion_tpu_torch obs cost diff COST_BASELINE.json (the "
        f"reference's JAX model; logged, not gated): exit {proc.returncode}, ended within "
        f"{wall:.1f} s of its start (waited for it {waited:.1f} s), measured on the card (platform gpu, backend cuda, kernel calls an "
        f"entry {json.dumps(calls)}); {len(diff['breaches'])} breaches, {len(diff['notes'])} "
        f"notes: {json.dumps({'breaches': diff['breaches'], 'notes': diff['notes']})}")
    return {"list_rules": "exit 0", "cost_diff_exit": proc.returncode, "cost_diff_s": round(wall, 1),
            "breaches": len(diff["breaches"]), "notes": len(diff["notes"])}


def command_line(onehot, kept: dict, module: tuple, phase: int = 16) -> dict:
    """Phase 16: the command line on the card, each path through
    ``path_runner`` (launch counts reset just before it and read just
    after): ``cli_geo_10k`` (``cli_geo_10k``), ``cli_lint`` (``cli_lint``)
    and ``cli_module`` (``cli_module``: ``module``, the ``python -m
    corrosion_tpu_torch`` process ``start_module`` started with phase 12,
    joined here; its launches are its own). Phases 12 and 14 take the CLI's other paths (``cli_obs_demo``,
    ``cli_chaos``, ``cli_cost``)."""
    t_phase = time.perf_counter()
    by_path, secs = {}, {}
    run = path_runner(onehot, phase, by_path, secs)
    run("cli_geo_10k", lambda: cli_geo_10k(kept.pop("geo_push"), phase))
    run("cli_lint", lambda: cli_lint(phase))
    run("cli_module", lambda: cli_module(*module, phase))
    log(f"phase {phase}: seconds by path {json.dumps(secs)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return by_path


def kernel_rows(measured: list, by_path: dict) -> list:
    """The ``kernels`` line: one entry per kernel from phase 3's
    measurements and the main paths' launch counts."""
    rows = []
    for name, (src, replaces) in KERNELS.items():
        mine = [m for m in measured if m["name"] == name]
        first = mine[0]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            "max_abs_err": max(m["err"] for m in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
            "library_ms": first["library_ms"],
            # Every path's launches, and every shape measured on it (the
            # top-level times are the first shape's).
            "by_path": {
                path: {"launches": counts[name], "shapes": [
                    {
                        "shape": m["shape"], "max_abs_err": m["err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0],
                        "bound_by": m["bound"][1], "library_ms": m["library_ms"],
                        "host_ms": m["host_ms"], "library_host_ms": m.get("library_host_ms"),
                        "device_events": m["device_events"],
                        **{k: v for k, v in m.items() if k.endswith("_ms") and k not in
                           ("ms", "plain_ms", "library_ms", "host_ms", "library_host_ms")},
                    }
                    for m in mine if m["path"] == path
                ]}
                for path, counts in by_path.items()
            },
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from corrosion_tpu_torch import cuda_build
    from corrosion_tpu_torch.obs import ledger
    from corrosion_tpu_torch.ops import gossip, onehot

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {smi} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"chip_smoke: {what} took {now - laps[-1]:.1f} s ({now - t_start:.1f} s in all)")
        laps.append(now)

    # The ledger records the library's build and load from here on.
    led = ledger.CompileLedger().watch_engines().install()
    with led.window("phase 2: build and load") as built:
        build_s = cuda_build.build(verbose=True)
        t_load = time.perf_counter()
        lib = cuda_build.load()
    log(f"phase 2: built the kernel library of {len(KERNELS)} kernels from "
        f"{len(cuda_build.SOURCES)} sources ({', '.join(cuda_build.SOURCES)}) in {build_s:.1f} s, "
        f"loaded in {time.perf_counter() - t_load:.2f} s: {lib.name}; ledger window "
        f"{json.dumps(built.to_record())}")
    lap("phase 2")
    # One collection, then every object alive now frozen out of the
    # collector's walks: each site's collection before its timed runs
    # (``run_ms``) then scans only what phase 3 made since.
    gc.collect()
    gc.freeze()
    try:
        measured = check_kernels(onehot, "cuda")
    finally:
        gc.unfreeze()
    lap("phase 3")
    check_tie_rules()
    small = start_small_runs(onehot, gossip)
    lap("phase 4 on the card")
    by_path, kept, walls = {}, {}, {}
    try:
        for phase, path in (
            (5, "wan_100k"), (6, "merge_10k"), (7, "anywrite_sparse"), (8, "wan_100k_adaptive"),
        ):
            keep = {"wan_100k": kept, "anywrite_sparse": kept.setdefault("sparse", {})}
            by_path[path] = full_run(onehot, gossip, phase, path, keep=keep.get(path),
                                     walls=walls)
            lap(f"phase {phase}")
        by_path["geo_10k"] = geo_run(onehot, gossip, keep=kept)
        lap("phase 9")
        by_path["anti_entropy_chunks"] = chunk_runs(onehot, gossip,
                                                    keep=kept.setdefault("chunks", {}))
        lap("phase 10")
        by_path["mixed_storm"] = mixed_run(onehot, gossip, keep=kept.setdefault("mixed", {}))
        lap("phase 11")
    except BaseException:
        stop_worker(small[0])
        raise
    cpu = check_small_runs(*small)
    kept["soak_cpu"], kept["dcn_cpu"] = cpu["soak"], cpu["dcn"]
    lap("phase 4's checks")
    # Processes of their own, beside the phases that claim no time: the
    # elastic drills (phase 13) and phase 16's `python -m` process.
    drills, module = start_drills(), start_module()
    try:
        by_path.update(consumers(onehot, cpu))
        lap("phase 12")
        by_path.update(sharded_runs(onehot, gossip, kept, drills))
        lap("phase 13")
        # The first run of merge_10k in this process: phase 2's build and
        # load, then phase 6's run.
        by_path.update(bench_harness(onehot, led, built.wall_ms / 1e3 + walls["merge_10k"],
                                     built.compile_ms, cpu["cost_model"]))
        lap("phase 14")
        by_path.update(host_oracles(onehot, kept))
        lap("phase 15")
        by_path.update(command_line(onehot, kept, module))
        lap("phase 16")
    finally:
        for proc in (drills[0], drills[2], module[0]):
            stop_worker(proc)
    rows = kernel_rows(measured, by_path)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build to the end")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-small-runs"]:
        sys.exit(cpu_small_runs(sys.argv[2]))
    if sys.argv[1:2] == ["--cpu-elastic-drills"]:
        sys.exit(cpu_elastic_drills(sys.argv[2]))
    if sys.argv[1:2] == ["--card-elastic-drills"]:
        sys.exit(card_elastic_drills(sys.argv[2]))
    sys.exit(main())

"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of bqueryd_tpu_torch from the sources in this
   checkout (and the native codec library, in parallel);
3. writes the BASELINE dataset with the port's ctable: bench.py's taxi
   schema and generator (seed 42), 10,000,000 rows in 10 shards of 1M,
   with pickup_ts sorted within each shard so that its zone maps prune;
4. drives every config through ``LocalRPC.groupby`` on cuda, the
   in-process reference: the five BASELINE configs (single, sharded,
   multikey, filtered, highcard) and the rest of the groupby verb
   (distinct: count_distinct value sets unioned across 10 shards;
   distinct_sole: one shard's count_distinct on the device sort; runs:
   sorted_count_distinct; basket: basket expansion; pruned: a time filter
   that chunk pruning serves from 10 of 40 chunks, then pruned_off, the
   same query with ``BQUERYD_TPU_CHUNK_PRUNE=0``; zones: 265 pickup
   locations, the base kernel's "table" branch).  Mergeable configs go
   to ``MeshQueryExecutor`` (one key alignment, one kernel call over every
   shard's rows, the merge on the device), the distinct ones per shard to
   the engine.  Per config: one cold query after the executor's and
   engine's caches are cleared (printing what stays warm: the on-disk
   sidecars and the decoded-column cache), then 3 warm queries.  Each
   query is checked against a NumPy reference of the generated arrays
   (int sums, counts, distinct counts and run counts bit-exact, the float
   mean within rtol=2e-5), must launch its config's kernel branch the
   expected times at the expected shape (R, G, n), merge as expected and
   report the expected chunk counts, and the executor configs' warm
   queries must hit every working-set segment; then the multi-device leg
   (``run_multidevice_path``): the executor's three entry points on the
   card once, on the card repeated 2 and 4 times (logical devices) and,
   on a box of several, on every card, in device mode and under
   ``BQUERYD_TPU_DEVICE_MERGE=0``: sharded, multikey, filtered, zones and
   highcard through ``LocalRPC``, a bundle of 4 filtered queries
   (``execute_bundle``) and dag_topk, dag_quantile, dag_join and
   dag_window (``execute_dag``; refused under the kill switch), 1 + 2
   queries each, every answer equal to NumPy's and to one device's, one
   contraction per device at the per-device shape, the bytes fetched one
   table in device mode and k tables in host mode (``MergeStats``); then
   the psum mode (``run_psum_path``): two ranks of this script (``--psum-
   rank``) joined by ``BQUERYD_TPU_DIST_*`` (NCCL on a card each, gloo on
   one card), 2 logical devices each, every answer exact in both ranks;
   it prints the ``multidevice`` line (walls, bytes, the backend);
5. drives the main path, the system's own entry points: a controller and a
   worker on cuda as threads of this process, talking TCP ZMQ through a
   file:// store beside the shards, and every config through
   ``RPC.groupby`` (controller fan-out: one CalcMessage per shard group,
   one per shard for the distinct ops; the worker's executor or engine;
   the client's merge): per config one cold query after the worker's
   caches are cleared and 3 warm ones, each checked the same way and
   reporting the route ``LocalRPC`` took; walls split into the worker's
   phases (prune included), the client's merge and the rest, beside
   ``LocalRPC``'s; the worker's result cache is off, so that every warm
   query runs its kernels, and its delta cache on (its bookkeeping is the
   ``delta`` phase); under the heuristic strategy hints alone
   (``BQUERYD_TPU_CALIB=0``): each query's hints must be
   ``plan.strategy.select_for_group``'s and its routes and launches the
   ones they imply (highcard's binding "scatter" launches no contraction
   here, every other config its kernel);
6. drives the operator-DAG verb on a cluster of its own over the same
   shards: five configs through ``RPC.query`` (dag_join: a 265-row zone
   table joined on PULocationID; dag_topk: fare's top 5 and trip_distance's
   3 smallest; dag_quantile: trip_distance p50 and p99 sketches; dag_window:
   fare per hour of pickup; dag_plain: multikey's shape, which must equal
   ``RPC.groupby``'s bytes), the four extended ones on two legs: the fast
   path (one message, one contraction over all 10M rows, merged on the
   device) and, under ``BQUERYD_TPU_DAG_BATCH=0``, one message per shard
   (a contraction per shard, merged at the client); per leg 1 cold + 3
   warm with the result cache off, each checked against NumPy (ints
   bit-exact, top-k lists equal to a NumPy sort, quantiles within alpha),
   launching its contractions as expected, the two legs equal, then one
   query served from the result cache ("cached", no launch); the fast
   path's quantile grids, flattened, equal the host formula's sketches
   merged over the shards, and the card's sketch keys of every
   trip_distance value equal the host formula's;
7. drives the append verb on bench.py's ingest deployment (2,000,000 rows
   in 4 shards of its own, its own cluster): the query ``[g]: v sum, f
   mean, v min``, two cycles of ``RPC.append`` (a 24th of a shard each)
   followed by the query, which must be a delta refresh of the appended
   chunks alone, with ``rollup`` messages per shard to the worker (a
   build, a refresh before the append answered "fresh", one after it
   answered "delta", each checked against NumPy), a cold recompute equal
   to it, a ``seq`` filter that chunk
   pruning serves and one ``RPC.query`` over the grown shards, all checked
   against NumPy of the concatenated frames;
8. drives admission, plan-time pruning and shared-scan bundles on the
   groupby cluster (``run_concurrency_path``, its own controller and worker,
   the result cache off): bench.py's swarm of 8 clients (each its own RPC
   and client_id) x 4 rounds of ``passenger_count`` -> fare sum, each
   query with its own ``trip_distance`` threshold, first at window 0 (one
   dispatch per query), then at a 40 ms window (one bundle per round), with
   QPS, median and p90 walls and the worker's phases of each bundle; one
   window of 4 ``zones`` and one of 4 ``highcard`` queries (the "table"
   and hicard "cluster" branches under a bundle); bench.py's
   identical-query probe (two identical queries, one CalcMessage); a query
   the advertised shard stats exclude on every shard (no dispatch).  Every
   answer equals NumPy's, ints bit for bit; each bundle member launches
   one contraction and the fused windows form bundles; under the
   heuristic hints alone every solo query and member runs the
   contraction; the per-query routing work this slice added (the worker's
   gate and the controller's hint) is timed outside the loop;
9. drives latency-aware host routing and the device-health latch on a
   cluster of its own (``run_routing_path``): the dispatch floor the
   worker measured after its warmup and the host-routing threshold at 8
   and 32 ns a row (below the append leg's 20,833-row tail views); a shard
   group of half the threshold through the cluster at the default (route
   "host", no launch) and under ``BQUERYD_TPU_HOST_KERNEL_ROWS=0`` (on the
   card, one launch), 5 + 5 walls; then ``devicehealth.force_state(True)``:
   the five BASELINE configs, dag_join and a 40 ms window of 4 zones
   queries, exact, every route "host", no launch and no CUDA allocation,
   the worker map showing ``backend_wedged``; then ``force_state(False)``
   and the BASELINE configs take their heuristic routes and launch their
   kernels again;
10. drives measured-cost calibration on a cluster of its own
   (``run_calibration_path``): the worker's store emptied, 1 cold + 20
   warm rounds of single, zones and highcard at the default settings,
   each exact and its launches held to the route its reply names, every
   change of route logged; each round's hint and route, the walls per
   route, the controller's ``get_info()["calibration"]`` (cells tagged
   "cuda") and the four hint counters; one round under
   ``BQUERYD_TPU_CALIB=0`` must carry the heuristic hints alone and take
   their routes (single and zones launch their kernels);
11. drives the serving layer on a cluster of its own over the taxi
   shards (``run_serving_path``, ``BQUERYD_TPU_SERVE=1``, a view
   materialized at its first query, the heuristic hints alone, the result
   cache off): per config of sharded, multikey, zones and highcard the
   first query dispatched ("recompute") and the rollup it builds (one
   ``rollup`` message per shard, one contraction each on the engine over
   the shard's 1M rows), then 3 queries served from it ("rollup", the
   entry's key, no dispatched shard, no launch) and 3 dispatched under
   ``BQUERYD_TPU_SERVE=0`` (launching as their route implies), with walls,
   reply bytes and client merges; a VendorID groupby folded from
   multikey's rollup ("subsume"), multikey under ``payment_type >= 1``
   served by the zone proof and under ``payment_type > 2`` recomputed (a
   ``filter-partial`` rejection recorded); the kill switch and back; the
   debug bundle (schema /4, the serving section, the flight events, the
   worker's device health) and ``rpc.metrics()``; then, on bench.py's
   ingest deployment, an append under a rollup: the repeat query exact,
   the heartbeat's delta refresh (4 ``rollup`` refreshes, one launch over
   each shard's appended rows) and the query served again, exact.  Every
   answer is checked against NumPy; a logged serving error, a failed fold
   or build or a ``render-error`` decision fails it.  It prints the
   ``serving`` line; every other leg runs with serving off;
12. drives the resilience layer on a cluster of its own
   (``run_resilience_path``): a controller with short timeouts and two
   workers on cuda over the same shards, sharded and zones through eight
   fault scenarios (clean, a transient device fault, a hedge, a dropped
   reply, a bundle's failover, exhaustion, a worker dying after its ack
   and a third joining, a wedge), each under a fault plan, exact, with
   the launches each scenario implies per worker; one ``resilience`` line
   per scenario;
13. drives dataset distribution on a cluster of its own
   (``run_distribution_path``): the reference's per-box layout (a
   controller, a calc worker on cuda on an empty serving dir, a
   downloader with three threads and a mover) and a LocalFS blob store
   under ``build/``; the ten shards zipped and put, one ``download(
   wait=True)`` ticket activating all ten (walls, bytes, ``downloads()``
   seen, each shard's ``bqueryd.metadata``), sharded and zones over them
   (1 cold + 3 warm, exact, one launch each, inputs captured for the
   kernel rows), taxi_0 distributed again with data of another seed and
   answered fresh, a missing blob's ticket raised with nothing activated,
   taxi_0 written as a bcolz v1 ctable and imported by ``python -m
   bqueryd_tpu_torch.node import`` (the native Blosc decoder, which the
   library must carry) and single's query over it exact, then ``sleep``,
   ``readfile``, ``info`` and ``killall``, every loop ending within 5 s;
   one ``distribution`` line before the ``kernels`` line;
14. drives the observability stack on a cluster of its own
   (``run_observability_path``, started as ``--metrics_port 0`` and
   ``--log_json`` start a node, every query a slow one, the result cache
   off, the heuristic hints, the SLO class ``interactive`` declared) through
   an ``RPC(slo_class="interactive")``: sharded, multikey, zones and
   highcard, 1 cold + 5 warm each, each query followed by the same one
   under ``BQUERYD_TPU_METRICS=0``, both exact and launching the same
   kernels as their routes imply; every warm query's autopsy is its own,
   ok, its segments summing to its wall within 1 ms (sharded's coverage
   at least 0.95), its trace holds the required spans with the groupby
   span the one orphan and a kernel span with ``device_s`` > 0; then the
   slow-query ring (one entry per query, class ``interactive``), the
   timeline, the debug bundle (its nine observability sections, the SLO
   class, the worker's calls per kernel wrapper and shape equal to the
   launch counters, the library's load, the runtime, the build directory,
   the device memory from ``torch.cuda.memory_stats`` at or above the
   working set's bytes), both nodes' ``/metrics`` scraped over HTTP, a
   burst of 32 sharded queries from 8 clients with ``rpc.capacity()``
   (coverage 1.0, the worker's μ > 0), and one warm sharded query under
   ``BQUERYD_TPU_PROFILE=1`` whose Chrome trace holds the ``mma``
   kernel's launch inside its ``aggregate`` range; it prints the
   ``observability`` line (walls on and off, their ratio, each config's
   segments and ``kernel`` host seconds against ``device_s``);
15. runs the CLI: ``python -m bqueryd_tpu_torch.node controller``,
   ``... worker --device=cuda``, ``... downloader`` and ``... movebcolz``
   as processes, one checked query per config (but the unpruned leg,
   whose environment the worker process does not have), dag_join through
   ``RPC.query``, an append to a small shard of its own (the repeat query
   a delta refresh) and the download of a zipped shard from a
   ``BQUERYD_TPU_BLOB_DIR`` store, which the worker then answers; all
   four stopped by SIGTERM and exiting 0;
16. drives the per-shard engine path (``QueryEngine.execute_local`` per
   shard + ``hostmerge``) for the five BASELINE configs, 1 warm-up + 1
   timed query, checked the same way, each query launching its branch once
   per shard; the launch counters are set to 0 just before each path
   (executor, cluster, DAG, append, concurrency, routing, calibration,
   serving, resilience, distribution, observability, engine) and read
   just after (the multi-device leg too), and every
   kernel of each path must have launched there;
17. breaks queries down into host phases and pipeline stage busy time
   (cProfile of a query run with the pipeline serialized), and device busy
   time and idle share (torch.profiler, at the pipeline's own width): the
   BASELINE configs on the executor path cold and warm and on the engine
   path warm, the other configs through ``LocalRPC`` (cold and warm on the
   executor, warm per shard);
18. holds every branch of each kernel against its plain PyTorch version at
   every recorded shape: each config's own inputs (captured from a warm
   ``LocalRPC`` query: the executor's one call, or a per-shard config's
   first shard; highcard's also forced onto the hicard "global" branch),
   the engine path's per-shard shapes, the DAG configs' per-shard shapes
   and the append leg's (the executor's and a delta refresh's tail view)
   and the first member of a swarm, zones and highcard bundle (its mask
   folded into its codes), the multi-device leg's first device at k = 4
   (and k = 2 for sharded and highcard), the distribution leg's sharded
   and zones over
   the downloaded shards and single over the imported one, captured from
   their own runs, plus one shape
   per other branch (base "table" at G = 8192, hicard "global" past the
   cluster table),
   with ints bit-exact, float rows within rtol=2e-5, atol=1e-6*max, and
   the base kernel's output bit-identical across two launches; times each
   kernel warm and with L2 flushed (device time per launch, from
   torch.profiler), beside its plain version, one library call
   (``index_add_``, used nowhere in the port) and a plain streaming read
   of the same bytes;
19. sweeps the base kernel's two branches over G (the crossover behind
    ``onehot.MMA_GROUPS_LIMIT``), beside ``index_add_``, at n = 1M and at
    the executor's n = 10,223,616, and the hicard cluster count C;
20. times the fast path's torch bodies at the shapes its programs ran
    (each top-k emission, checked against the sort route, each sketch
    grid, the whole program with its fetch);
21. prints the sweeps, the fast path's program times, the device-health
    snapshot (the latch must have flipped only where the wedge leg forced
    it, no probe written off), the ``kernels`` JSON line, then the device
    JSON line last.

Every leg that runs a controller, but the calibration leg and the
routing leg's host-routed queries, runs under the heuristic strategy
hints alone (``BQUERYD_TPU_CALIB=0``), so that no route depends on walls
an earlier leg recorded; calibration's route changes are the calibration
leg's.  Exits non-zero, printing no result, without a CUDA card or
outside a checkout of the repository.  Any failed phase fails the run.
"""

import collections
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROWS = 10_000_000
SHARDS = 10
SEED = 42
#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12
#: H100 SXM dense bf16 tensor-core rate, FLOP/s
BF16_TC_FLOPS = 989e12
#: bytes written between launches to push the inputs out of the 50 MB L2
FLUSH_BYTES = 128 << 20

#: start of bench.py's synthetic day of pickups, ns since the epoch, and
#: the pruned configs' bound: the day's last 3 hours
DAY_START_NS = 1_700_000_000_000_000_000
PRUNE_FROM = np.datetime64(DAY_START_NS + 21 * 3600 * 10**9, "ns")

CONFIGS = {
    # name: (shard slice, groupby cols, agg list, where terms)
    "single": (slice(0, 1), ["passenger_count"],
               [["fare_amount", "sum", "fare_amount"]], []),
    "sharded": (slice(None), ["passenger_count"],
                [["fare_amount", "sum", "fare_amount"]], []),
    "multikey": (slice(None), ["VendorID", "payment_type"],
                 [["fare_amount", "sum", "fare_sum"],
                  ["fare_amount", "count", "n"],
                  ["trip_distance", "mean", "dist_mean"]], []),
    "filtered": (slice(None), ["passenger_count"],
                 [["fare_amount", "sum", "fare_amount"]],
                 [["trip_distance", ">", 5.0]]),
    "highcard": (slice(None), ["PULocationID", "DOLocationID"],
                 [["fare_amount", "sum", "fare_amount"]], []),
    # the rest of the groupby verb: distinct value sets unioned at the
    # client, a sole payload's device sort, run counts, basket expansion
    # and chunk-zone-map pruning (then the same query unpruned)
    "distinct": (slice(None), ["passenger_count"],
                 [["fare_amount", "sum", "fare_amount"],
                  ["PULocationID", "count_distinct", "pu_distinct"]], []),
    "distinct_sole": (slice(0, 1), ["payment_type"],
                      [["DOLocationID", "count_distinct", "do_distinct"]],
                      []),
    "runs": (slice(None), ["VendorID"],
             [["fare_amount", "sum", "fare_amount"],
              ["payment_type", "sorted_count_distinct", "pay_runs"]], []),
    "basket": (slice(None), ["passenger_count"],
               [["fare_amount", "sum", "fare_amount"]],
               [["fare_amount", "==", 19999], ["trip_distance", ">", 25.0]]),
    "pruned": (slice(None), ["passenger_count"],
               [["fare_amount", "sum", "fare_amount"]],
               [["pickup_ts", ">=", PRUNE_FROM]]),
    "pruned_off": (slice(None), ["passenger_count"],
                   [["fare_amount", "sum", "fare_amount"]],
                   [["pickup_ts", ">=", PRUNE_FROM]]),
    # 265 pickup zones: the base kernel's "table" branch (33 to 8,192
    # groups) on the executor's contraction
    "zones": (slice(None), ["PULocationID"],
              [["fare_amount", "sum", "fare_sum"],
               ["fare_amount", "count", "n"]], []),
}

#: the serving leg's queries beyond CONFIGS: multikey's shape folded to
#: VendorID alone (its rollup answers by a key fold), and multikey under a
#: filter every chunk's zone map proves whole (payment_type is 1..5) and
#: under one that cuts chunks (recomputed)
SERVE_QUERIES = {
    "serve_vendor": (slice(None), ["VendorID"],
                     CONFIGS["multikey"][2], []),
    "serve_zone_proof": (slice(None), ["VendorID", "payment_type"],
                         CONFIGS["multikey"][2], [["payment_type", ">=", 1]]),
    "serve_partial": (slice(None), ["VendorID", "payment_type"],
                      CONFIGS["multikey"][2], [["payment_type", ">", 2]]),
}


def _spec(config):
    """``(shard slice, groupby cols, agg list, where terms)`` of a config
    or a serving query."""
    return SERVE_QUERIES.get(config) or CONFIGS[config]


#: the five BASELINE configs, which the per-shard engine path and the
#: breakdown also run
BASE_CONFIGS = ("single", "sharded", "multikey", "filtered", "highcard")

#: groupby keyword arguments beyond the four positional ones
OPTIONS = {"basket": {"expand_filter_column": "PULocationID"}}

#: environment a config runs under: the comparison leg of "pruned"
ENV = {"pruned_off": {"BQUERYD_TPU_CHUNK_PRUNE": "0"}}

#: configs the worker serves per shard on the engine (their distinct ops
#: are not mergeable): {config: (R, G) of each shard's contraction}, one
#: launch per shard per query; a sole payload's count_distinct adds a
#: device sort, a distinct-only query stacks the count row alone
PER_SHARD_SHAPE = {
    "distinct": (9, 9),
    "distinct_sole": (1, 5),
    "runs": (9, 2),
}

#: (decoded, skipped) chunks of the pruned config over all shards: each
#: 1M-row shard is written in 4 chunks of ctable's default length, and
#: only its last chunk holds pickups from 21 h on
PRUNED_CHUNKS = (10, 30)

#: the (kernel, branch) each config's contraction must launch
CONFIG_KERNEL = {
    "single": ("onehot_rows_dot", "mma"),
    "sharded": ("onehot_rows_dot", "mma"),
    "multikey": ("onehot_rows_dot", "mma"),
    "filtered": ("onehot_rows_dot", "mma"),
    "highcard": ("onehot_rows_dot_hicard", "cluster"),
    "distinct": ("onehot_rows_dot", "mma"),
    "distinct_sole": ("onehot_rows_dot", "mma"),
    "runs": ("onehot_rows_dot", "mma"),
    "basket": ("onehot_rows_dot", "mma"),
    "pruned": ("onehot_rows_dot", "mma"),
    "pruned_off": ("onehot_rows_dot", "mma"),
    "zones": ("onehot_rows_dot", "table"),
}

#: the CUDA kernel (csrc/onehot_groupby.cu) behind each (wrapper, branch)
BRANCH_KERNEL = {
    ("onehot_rows_dot", "mma"): "onehot_mma_kernel",
    ("onehot_rows_dot", "table"): "onehot_table_kernel",
    ("onehot_rows_dot_hicard", "cluster"): "hicard_cluster_kernel",
    ("onehot_rows_dot_hicard", "global"): "hicard_global_kernel",
}

#: the TPU kernel each wrapper replaces
REPLACES = {
    "onehot_rows_dot": "bqueryd_tpu/ops/pallas_groupby.py:341",
    "onehot_rows_dot_hicard": "bqueryd_tpu/ops/pallas_groupby.py:255",
}


#: (R, G) of each config's ONE contraction on the executor path:
#: fare_amount (250..19,999) rides as int16, so its sum stacks a count
#: row and 2 limbs; multikey adds trip_distance's present row and its 3
#: Dekker rows (the last 3 rows are float rows)
EXEC_SHAPE = {
    "single": (3, 9),
    "sharded": (3, 9),
    "multikey": (7, 10),
    "filtered": (3, 9),
    "highcard": (3, 73_728),
    "basket": (3, 9),
    "pruned": (3, 9),
    "pruned_off": (3, 9),
    "zones": (3, 288),
}

#: how each config's payloads merge: "device" on the executor, "host"
#: for LocalRPC's per-shard union, "none" for one payload; through the
#: cluster every per-shard message is one payload
MERGE_MODE = {c: "device" for c in EXEC_SHAPE}
MERGE_MODE.update({"distinct": "host", "runs": "host",
                   "distinct_sole": "none"})

#: (R, G) of each shard's contraction on the per-shard engine path:
#: int64 fare_amount stacks 8 limbs
ENGINE_SHAPE = {
    "single": (9, 9),
    "sharded": (9, 9),
    "multikey": (13, 10),
    "filtered": (9, 9),
    "highcard": (9, 73_728),
}

#: float (Dekker) rows at the end of each config's stacked rows
FLOAT_ROWS = {"multikey": 3}


def _zone_table():
    """dag_join's dimension table: each of the 265 pickup locations to one
    of five zones ``z{id % 5}``."""
    ids = np.arange(1, 266, dtype=np.int64)
    return {"PULocationID": ids,
            "zone": np.array([f"z{i % 5}" for i in ids], dtype=object)}


#: the relational operators through ``RPC.query`` on the same 10 shards,
#: the shapes of bench.py's operators section: a broadcast join, per-group
#: top-k (fare's top 5 are all ties at 19,999, so trip_distance's 3
#: smallest add a float measure and the ascending side), quantile
#: sketches, a time-window rollup, and a plain groupby shape
DAG_SPECS = {
    "dag_join": {"groupby": ["zone"],
                 "aggs": [["fare_amount", "sum", "fare_sum"],
                          ["fare_amount", "count", "n"]],
                 "join": {"table": _zone_table(), "on": "PULocationID",
                          "select": ["zone"]}},
    "dag_topk": {"groupby": ["passenger_count"],
                 "aggs": [["fare_amount", "topk", "fare_top5", {"k": 5}],
                          ["trip_distance", "topk", "dist_low3",
                           {"k": 3, "largest": False}]]},
    "dag_quantile": {"groupby": ["passenger_count"],
                     "aggs": [["trip_distance", "quantile", "p50",
                               {"q": 0.5, "alpha": 0.01}],
                              ["trip_distance", "quantile", "p99",
                               {"q": 0.99, "alpha": 0.01}]]},
    "dag_window": {"groupby": [{"window": {"on": "pickup_ts", "every": "1h",
                                           "alias": "hour"}}],
                   "aggs": [["fare_amount", "sum", "fare_sum"]]},
    "dag_plain": {"groupby": ["VendorID", "payment_type"],
                  "aggs": CONFIGS["multikey"][2]},
}

#: the sketches' relative accuracy in DAG_SPECS
SKETCH_ALPHA = 0.01

#: (R, G) of each shard's contraction of a DAG config: the per-shard
#: ``DagExecutor`` stacks int64 fare's count row and 8 limbs; top-k and
#: quantile DAGs count rows alone (R = 1); the day of pickups starts at
#: 22:13:20 UTC, so it spans 25 one-hour windows (bucketed to 26 groups);
#: dag_plain is multikey on the executor
DAG_SHAPE = {
    "dag_join": (9, 5),
    "dag_topk": (1, 9),
    "dag_quantile": (1, 9),
    "dag_window": (9, 26),
}

#: (R, G) of each extended DAG config's ONE contraction on the fast path
#: (``MeshQueryExecutor.execute_dag``) over every shard's rows: fare rides
#: as int16 there (a count row and 2 limbs), as on the executor path
DAG_FAST_SHAPE = {
    "dag_join": (3, 5),
    "dag_topk": (1, 9),
    "dag_quantile": (1, 9),
    "dag_window": (3, 26),
}

#: the DAG leg's two routes of an extended config: the fast path (one
#: message for the shard group, merged on the device) and, under the kill
#: switch, one message per shard, each one payload, merged at the client
DAG_LEGS = {"fast": {}, "per-shard": {"BQUERYD_TPU_DAG_BATCH": "0"}}

#: the append leg: bench.py's ingest deployment, 2,000,000 rows in 4
#: shards of its own, chunks of a 24th of a shard, two appends of about
#: 4% per shard
INGEST_ROWS = 2_000_000
INGEST_SHARDS = 4
INGEST_SEED = 23
INGEST_AGGS = [["v", "sum", "vs"], ["f", "mean", "fm"], ["v", "min", "vmin"]]
#: float (Dekker) rows of the ingest query's contractions: f's mean
INGEST_FLOAT_ROWS = 3


def shape_key(name, branch, n_rows, n_groups, n):
    return f"{name}/{branch}/R={n_rows}/G={n_groups}/n={n}"


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def make_dataset(data_dir, rows=ROWS, shards=SHARDS, seed=SEED):
    """bench.py's generator (same RandomState stream, column order and
    ranges) written with the port's ctable from plain arrays.  pickup_ts
    comes from the same draws, sorted within each shard, so that its
    per-chunk zone maps let a time filter prune chunks.  Returns (shard
    names, per-shard {column: array})."""
    from bqueryd_tpu_torch.storage.ctable import ctable

    rng = np.random.RandomState(seed)
    per = rows // shards
    names, parts = [], []
    for i in range(shards):
        n = per + (rows % shards if i == shards - 1 else 0)
        cols = {
            "passenger_count": rng.randint(1, 10, n).astype(np.int64),
            "fare_amount": rng.randint(250, 20000, n).astype(np.int64),
            "VendorID": rng.randint(1, 3, n).astype(np.int64),
            "payment_type": rng.randint(1, 6, n).astype(np.int64),
            "PULocationID": rng.randint(1, 266, n).astype(np.int64),
            "DOLocationID": rng.randint(1, 266, n).astype(np.int64),
            "trip_distance": (rng.random(n) * 30).astype(np.float32),
        }
        cols["pickup_ts"] = (
            np.int64(DAY_START_NS)
            + np.sort(rng.randint(0, 86_400, n)).astype(np.int64)
            * np.int64(1_000_000_000)
        ).view("datetime64[ns]")
        name = f"taxi_{i}.bcolzs"
        t = ctable(os.path.join(data_dir, name), mode="w")
        t.append(cols)
        t.flush()
        names.append(name)
        parts.append(cols)
    return names, parts


def _kept(config, part):
    """The rows of one shard that ``config`` aggregates: its filter, then
    basket expansion within the shard."""
    _sl, _gcols, _aggs, where = _spec(config)
    keep = np.ones(len(part["fare_amount"]), dtype=bool)
    for col, op, value in where:
        # a float32 column against a Python float compares in float32
        keep &= {">": np.greater, ">=": np.greater_equal,
                 "==": np.equal}[op](part[col], value)
    basket = OPTIONS.get(config, {}).get("expand_filter_column")
    if basket is not None:
        keep = np.isin(part[basket], np.unique(part[basket][keep]))
    return keep


def reference(config, parts):
    """NumPy reference of one config: {key tuple: {out col: value}}."""
    sl, gcols, aggs, _where = _spec(config)
    shards = parts[sl]
    kept = [_kept(config, p) for p in shards]
    cols = {c: np.concatenate([p[c][k] for p, k in zip(shards, kept)])
            for c in shards[0]}
    keys = [cols[c] for c in gcols]
    cards = [int(max(p[c].max() for p in shards)) + 1 for c in gcols]
    packed = keys[0].copy()
    for k, card in zip(keys[1:], cards[1:]):
        packed = packed * card + k
    size = int(np.prod(cards))
    count = np.bincount(packed, minlength=size)
    out = {}
    for in_col, op, out_col in aggs:
        v = cols[in_col]
        if op == "sum":
            s = np.zeros(size, dtype=np.int64)
            np.add.at(s, packed, v)
            out[out_col] = s
        elif op == "count":
            out[out_col] = count
        elif op == "mean":
            out[out_col] = np.bincount(
                packed, weights=v.astype(np.float64), minlength=size
            ) / np.maximum(count, 1)
        elif op == "count_distinct":
            # distinct (group, value) pairs over every shard's rows
            pairs = np.unique(packed * (int(v.max()) + 1) + v)
            out[out_col] = np.bincount(pairs // (int(v.max()) + 1),
                                       minlength=size)
        elif op == "sorted_count_distinct":
            # runs of equal (group, value) in each shard's row order,
            # summed over the shards
            runs = np.zeros(size, dtype=np.int64)
            for p, k in zip(shards, kept):
                g, w = p[gcols[0]][k], p[in_col][k]
                new = np.ones(len(g), dtype=bool)
                new[1:] = (g[1:] != g[:-1]) | (w[1:] != w[:-1])
                runs += np.bincount(g[new], minlength=size)
            out[out_col] = runs
    present = np.flatnonzero(count)
    result = {}
    for slot in present:
        key, rest = [], int(slot)
        for card in reversed(cards[1:]):
            key.append(rest % card)
            rest //= card
        key.append(rest)
        result[tuple(reversed(key))] = {c: out[c][slot] for c in out}
    return result


def check_result(config, order, columns, want):
    _sl, gcols, aggs, _where = _spec(config)
    assert order == gcols + [a[2] for a in aggs], order
    n = len(columns[gcols[0]])
    assert n == len(want), f"{config}: {n} groups, reference {len(want)}"
    for i in range(n):
        key = tuple(int(columns[c][i]) for c in gcols)
        ref = want[key]
        for in_col, op, out_col in aggs:
            got = columns[out_col][i]
            if op == "mean":
                assert np.isfinite(got), (config, key, out_col)
                assert abs(got - ref[out_col]) <= 2e-5 * abs(ref[out_col]), (
                    config, key, out_col, got, ref[out_col])
            else:
                assert columns[out_col].dtype == np.int64
                assert int(got) == int(ref[out_col]), (
                    config, key, out_col, int(got), int(ref[out_col]))


def selected_share(config, parts):
    """The share of the config's shards' rows its filter (and basket
    expansion) selects."""
    sl = CONFIGS[config][0]
    kept = sum(int(_kept(config, p).sum()) for p in parts[sl])
    return kept / _rows_of(parts, sl)


def _exec_rows(config, parts):
    """Rows of the executor's one contraction, before the row grid: the
    pruned config's views hold only the chunks with pickups from 21 h on."""
    from bqueryd_tpu_torch.storage.ctable import DEFAULT_CHUNKLEN

    sl = CONFIGS[config][0]
    if config != "pruned":
        return _rows_of(parts, sl)
    rows = 0
    for p in parts[sl]:
        ts = p["pickup_ts"]
        for start in range(0, len(ts), DEFAULT_CHUNKLEN):
            chunk = ts[start:start + DEFAULT_CHUNKLEN]
            if chunk.max() >= PRUNE_FROM:
                rows += len(chunk)
    return rows


def expected_launches(config, parts):
    """{shape key: launches} of one query of ``config``: one contraction
    at the executor's shape, or one per shard at the shard's shape."""
    from bqueryd_tpu_torch import ops

    kernel, branch = CONFIG_KERNEL[config]
    sl = CONFIGS[config][0]
    if config in PER_SHARD_SHAPE:
        out = {}
        for p in parts[sl]:
            key = shape_key(kernel, branch, *PER_SHARD_SHAPE[config],
                            len(p["fare_amount"]))
            out[key] = out.get(key, 0) + 1
        return out
    n = ops.program_bucket(_exec_rows(config, parts), fine=True)
    return {shape_key(kernel, branch, *EXEC_SHAPE[config], n): 1}


#: the route a config's cluster queries take under the heuristic hints
#: alone (``BQUERYD_TPU_CALIB=0``): highcard's estimate, 265 x 265 = 70,225
#: groups above the 8,192-group contraction limit, draws a binding
#: "scatter"; every other config stays on the contraction
HEURISTIC_ROUTE = {"highcard": "scatter"}


def heuristic_route(config):
    return HEURISTIC_ROUTE.get(config, "matmul")


def heuristic_hints(controller, config, names):
    """{hint: shards} the controller stamps on one query of ``config``
    under the heuristic hints: ``plan.strategy.select_for_group`` per
    dispatch group (each shard alone for the per-shard configs) over the
    shards its advertised stats do not prune."""
    from bqueryd_tpu_torch import plan as planmod
    from bqueryd_tpu_torch.plan import strategy as strategymod

    sl, gcols, _aggs, where = CONFIGS[config]
    shards = [n for n in names[sl] if not where
              or planmod.stats_can_match(controller.shard_stats[n], where)]
    groups = ([[n] for n in shards] if config in PER_SHARD_SHAPE
              else [shards])
    hints = {}
    for group in groups:
        hint = strategymod.select_for_group(controller.shard_stats, group,
                                            gcols)[0]
        hints[hint] = hints.get(hint, 0) + len(group)
    return hints


def route_launches(config, parts, routes):
    """{shape key: launches} of one cluster query of ``config`` whose
    replies name ``routes`` (``effective_strategy`` per shard group): the
    calibrated hints (an exploration, a measured override or the analytic
    prior) may take the query off the contraction, so only the "matmul"
    route launches."""
    return expected_launches(config, parts) if routes == ["matmul"] else {}


def _env(config):
    """The environment ``config`` runs under (``ENV``), restored after."""
    return _env_set(ENV.get(config, {}))


def _query(rpc, names, config):
    """One groupby of ``config`` through ``rpc`` (LocalRPC or RPC)."""
    sl, gcols, aggs, where = _spec(config)
    with _env(config):
        return rpc.groupby(names[sl], gcols, aggs, where,
                           **OPTIONS.get(config, {}))


def _launch_delta(before):
    """Launches per shape key since the ``before`` snapshot."""
    from bqueryd_tpu_torch.ops import onehot

    return {
        shape_key(*k): v - before.get(k, 0)
        for k, v in onehot.LAUNCHES.items() if v - before.get(k, 0)
    }


def _rows_of(parts, sl):
    return sum(len(p["fare_amount"]) for p in parts[sl])


def _warm_state(data_dir):
    """What a cold query still finds warm: the sidecars on disk beside the
    shards and the process's decoded-column cache."""
    from bqueryd_tpu_torch.storage.ctable import column_cache_stats

    sidecars = {"factor": 0, "composite": 0}
    for _root, _dirs, files in os.walk(data_dir):
        for f in files:
            if f == "factor.npz":
                sidecars["factor"] += 1
            elif f.startswith("composite_") and f.endswith(".npz"):
                sidecars["composite"] += 1
    return {"sidecars": sidecars, "column_cache": column_cache_stats()}


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check_prune(config, label, counts):
    """The pruned config decodes :data:`PRUNED_CHUNKS`; with pruning off,
    nothing is pruned."""
    want = PRUNED_CHUNKS if config == "pruned" else None
    if config in ("pruned", "pruned_off") and counts != want:
        raise AssertionError(f"{label}: chunk counts {counts}, expected "
                             f"{want}")


def run_executor_path(rpc, names, parts, data_dir, warm=3):
    """The in-process reference path: per config one cold query (executor
    and engine caches cleared) and ``warm`` warm queries through
    ``LocalRPC.groupby``; every query checked, launching its branch the
    expected times at the expected shape and merging as expected."""
    from bqueryd_tpu_torch.ops import onehot

    report = {}
    for config in CONFIGS:
        want = reference(config, parts)
        expect = expected_launches(config, parts)
        rpc.executor.clear_caches()
        rpc.engine.clear_caches()
        stays_warm = _warm_state(data_dir)
        walls, launches = [], 0
        for rep in range(warm + 1):
            before = dict(onehot.LAUNCHES)
            (order, columns), wall = _timed(
                lambda: _query(rpc, names, config))
            check_result(config, order, columns, want)
            launched = _launch_delta(before)
            launches += sum(launched.values())
            if launched != expect or rpc.last_merge_mode != MERGE_MODE[config]:
                raise AssertionError(
                    f"{config} query {rep}: expected {expect} and merge "
                    f"mode {MERGE_MODE[config]}, launched {launched} "
                    f"({rpc.last_merge_mode})")
            _check_prune(config, f"{config} query {rep}", rpc.last_chunk_prune)
            if rep == 0:
                cold_stats = rpc.executor.workingset.stats()
            walls.append(wall)
        stats = rpc.executor.workingset.stats()
        if config in EXEC_SHAPE:
            for seg in ("align", "codes", "blocks"):
                if (stats[seg]["misses"] != cold_stats[seg]["misses"]
                        or stats[seg]["hits"] - cold_stats[seg]["hits"]
                        < warm):
                    raise AssertionError(
                        f"{config}: warm queries missed the {seg} segment: "
                        f"{cold_stats[seg]} -> {stats[seg]}")
        report[config] = {
            "cold_wall_s": walls[0],
            "warm_walls_s": walls[1:],
            "warm_wall_s_median": float(np.median(walls[1:])),
            "groups": len(want),
            "route": rpc.last_effective_strategy,
            "merge_mode": rpc.last_merge_mode,
            "launch_shapes": expect,
            "launches": launches,
            "chunk_prune": rpc.last_chunk_prune,
            "selected_share": selected_share(config, parts),
            "stays_warm_at_cold": stays_warm,
            "workingset": stats,
        }
        log(f"executor {config}: {json.dumps(report[config])}")
    return report


def _wait(predicate, timeout, what, interval=0.1, state=None):
    """Poll ``predicate`` until it holds; past ``timeout`` raise, with
    ``state()`` in the message when given."""
    deadline = time.time() + timeout
    while not predicate():
        if time.time() > deadline:
            detail = f": {state()}" if state is not None else ""
            raise AssertionError(
                f"timed out after {timeout}s: {what}{detail}")
        time.sleep(interval)


def _served(rpc, names):
    """True once the calc workers behind ``rpc`` advertise every shard."""
    workers = rpc.info()["workers"].values()
    return set(names) <= {f for w in workers if w.get("workertype") == "calc"
                          for f in w.get("data_files") or []}


def run_cluster_path(names, parts, data_dir, store_dir, local, warm=3):
    """The system's own entry points: a port controller and a port worker
    on cuda, as threads of this process, talking TCP ZMQ through a file://
    store; every config through ``RPC.groupby``, per config one cold query
    after the worker's caches are cleared and ``warm`` warm ones.  Each
    query is checked, must launch its branch the expected times at the
    expected shape, merge as expected (one device merge for a shard group
    on the executor, one payload per shard message otherwise) and report
    the route that ``LocalRPC`` (``local``, the executor path's report)
    took.  The walls are split into the worker's phases (summed over a
    query's shard messages, which the worker serves one after another),
    the client's merge and the rest (controller, ZMQ hops, pickling),
    beside the median of 20 pings (client to controller and back) and the
    worker's table opens timed outside its loop.

    The controller stamps each dispatch with a strategy hint; the leg runs
    under the heuristic hints alone (``BQUERYD_TPU_CALIB=0``, set by the
    caller), so that no route depends on walls an earlier leg recorded:
    each query's hints must be ``plan.strategy.select_for_group``'s, its
    routes :data:`HEURISTIC_ROUTE`'s (highcard's binding "scatter", no
    launch) and its launches the expected ones.  Calibration's route
    changes are the calibration leg's (:func:`run_calibration_path`)."""
    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.ops import onehot

    rpc, controller, worker, threads = _start_cluster(data_dir, store_dir)
    report = {}
    try:
        # one client <-> controller round trip with no worker behind it
        pings = []
        for _ in range(20):
            t0 = time.perf_counter()
            if rpc.ping() != "pong":
                raise AssertionError("the controller did not answer a ping")
            pings.append(time.perf_counter() - t0)
        report["ping_s_median"] = float(np.median(pings))
        _wait(lambda: all(n in controller.shard_stats for n in names),
              60, "every shard's advertised stats")
        for config in CONFIGS:
            sl = CONFIGS[config][0]
            want = reference(config, parts)
            # one message per shard group: the executor configs' shards
            # are one group, the per-shard configs' go one by one
            groups = (len(names[sl]) if config in PER_SHARD_SHAPE else 1)
            modes_want = [
                "device" if MERGE_MODE[config] == "device" else "none"
            ] * groups
            # a per-shard config with no mergeable agg names no route
            route = heuristic_route(config)
            routes_want = ([route] * groups
                           if config != "distinct_sole" else [])
            expect = (expected_launches(config, parts)
                      if route == "matmul" else {})
            hints_want = heuristic_hints(controller, config, names)
            # the worker's loop thread idles between queries
            worker.clear_caches()
            queries, launches = [], 0
            for rep in range(warm + 1):
                before = dict(onehot.LAUNCHES)
                (order, columns), wall = _timed(
                    lambda: _query(rpc, names, config))
                check_result(config, order, columns, want)
                launched = _launch_delta(before)
                modes = list(rpc.last_call_merge_modes.values())
                routes = list(rpc.last_call_strategies["effective"].values())
                hints = rpc.last_call_strategies["hints"]
                if (launched != expect or modes != modes_want
                        or routes != routes_want or hints != hints_want):
                    raise AssertionError(
                        f"cluster {config} query {rep}: expected {expect}, "
                        f"merge modes {modes_want}, routes {routes_want} and "
                        f"hints {hints_want}; launched {launched}, merge "
                        f"modes {modes}, routes {routes}, hints {hints}")
                launches += sum(launched.values())
                queries.append(_reply_split(rpc, wall))
                _check_prune(config, f"cluster {config} query {rep}",
                             queries[-1]["chunk_prune"])
            # the worker's table opens for these shards, called from this
            # thread while the nodes idle: the open phase without the loop
            paths = [os.path.join(data_dir, f) for f in names[sl]]
            opens = []
            for _ in range(5):
                t0 = time.perf_counter()
                for path in paths:
                    worker._open_table(path)
                opens.append(time.perf_counter() - t0)
            # and the prune seam over them, split into the zone-map test
            # and the views' creation
            where = CONFIGS[config][3]
            prune_direct = None
            if where and config not in OPTIONS:
                tables = [worker._open_table(path) for path in paths]
                select, views = [], []
                for _ in range(5):
                    t0 = time.perf_counter()
                    keeps = [ops.chunk_selection(t, where) for t in tables]
                    t1 = time.perf_counter()
                    for t, keep in zip(tables, keeps):
                        if keep is not None:
                            t.chunk_view(np.flatnonzero(keep))
                    views.append(time.perf_counter() - t1)
                    select.append(t1 - t0)
                prune_direct = {"selection_s_median": float(np.median(select)),
                                "views_s_median": float(np.median(views))}
            report[config] = dict(
                _warm_summary(queries),
                messages=groups,
                reply_bytes=queries[-1]["reply_bytes"],
                open_direct_s_median=float(np.median(opens)),
                prune_direct=prune_direct,
                routes=routes,
                hints=hints,
                merge_modes=modes,
                launch_shapes=expected_launches(config, parts),
                launches=launches,
                chunk_prune=queries[-1]["chunk_prune"],
                local_rpc_cold_wall_s=local[config]["cold_wall_s"],
                local_rpc_warm_wall_s_median=local[config][
                    "warm_wall_s_median"],
            )
            log(f"cluster {config}: {json.dumps(report[config])}")
    finally:
        _stop_cluster(rpc, controller, worker, threads)
    return report


@contextlib.contextmanager
def _env_set(values):
    """``os.environ`` updated with ``values`` inside the block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _set_result_cache(worker, nbytes):
    """Turn an idle in-process worker's result cache off (0) or on: the
    worker reads ``BQUERYD_TPU_RESULT_CACHE_BYTES`` at its next query."""
    os.environ["BQUERYD_TPU_RESULT_CACHE_BYTES"] = str(int(nbytes))
    worker._result_cache = None


@contextlib.contextmanager
def capturing(store, label, n_float=0, only=None):
    """Record under ``label`` the inputs of the first launch of each
    kernel shape not yet in ``store`` (label -> (kernel, branch, codes,
    rows, R, G, int rows)), for the kernel rows; nothing more is launched.
    A second new shape in one block gets the label with its shape.
    ``only(shape key)``, when given, keeps the shapes it accepts."""
    from bqueryd_tpu_torch.ops import onehot

    known = {shape_key(e[0], e[1], e[4], e[5], e[2].shape[0])
             for e in store.values()}
    launchers = {"onehot_rows_dot": onehot._launch_base,
                 "onehot_rows_dot_hicard": onehot._launch_hicard}

    def wrap(name, launch):
        def run(codes, rows, n_rows, n_groups, plan):
            key = shape_key(name, plan.branch, n_rows, n_groups,
                            codes.shape[0])
            if key not in known and (only is None or only(key)):
                known.add(key)
                at = label if label not in store else f"{label} {key}"
                store[at] = (name, plan.branch, codes, rows, n_rows,
                             n_groups, n_rows - n_float)
            return launch(codes, rows, n_rows, n_groups, plan)
        return run

    onehot._launch_base = wrap("onehot_rows_dot",
                               launchers["onehot_rows_dot"])
    onehot._launch_hicard = wrap("onehot_rows_dot_hicard",
                                 launchers["onehot_rows_dot_hicard"])
    try:
        yield
    finally:
        onehot._launch_base = launchers["onehot_rows_dot"]
        onehot._launch_hicard = launchers["onehot_rows_dot_hicard"]


def _start_cluster(data_dir, store_dir):
    """A port controller and a port calc worker on cuda as threads of this
    process, found through a file:// store; returns (rpc, controller,
    worker, threads) once the worker serves every shard of ``data_dir``."""
    import logging

    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    url = f"file://{store_dir}"
    quiet = logging.WARNING
    controller = ControllerNode(coordination_url=url, loglevel=quiet,
                                runfile_dir=store_dir, heartbeat_interval=0.5)
    worker = WorkerNode(coordination_url=url, data_dir=data_dir,
                        loglevel=quiet, heartbeat_interval=1.0,
                        poll_timeout=0.1, n_devices=1)  # one card
    threads = [threading.Thread(target=n.go, daemon=True)
               for n in (controller, worker)]
    for t in threads:
        t.start()
    shards = [f for f in os.listdir(data_dir) if f.endswith(".bcolzs")]
    _wait(lambda: all(n in controller.files_map for n in shards), 60,
          "the worker's registration")
    rpc = RPC(coordination_url=url, timeout=300, retries=1, loglevel=quiet)
    return rpc, controller, worker, threads


def _stop_cluster(rpc, controller, worker, threads):
    rpc._close_socket()
    for n in (controller, worker):
        n.running = False
    for t in threads:
        t.join(timeout=20)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a cluster node did not stop")


def _reply_split(rpc, wall):
    """A cluster query's wall split into the worker's phases (summed over
    its messages), the client's merge and the rest."""
    phases = {}
    for t in rpc.last_call_timings.values():
        for k, v in t.items():
            phases[k] = phases.get(k, 0) + v
    prune = None
    if "_chunks_decoded" in phases:
        prune = (phases["_chunks_decoded"], phases["_chunks_skipped"])
    return {
        "wall_s": wall,
        "worker_s": phases["_total"],
        "worker_phases_s": {k: v for k, v in phases.items()
                            if not k.startswith("_")},
        "client_merge_s": rpc.last_call_client_merge_s,
        "rest_s": wall - phases["_total"] - rpc.last_call_client_merge_s,
        "reply_bytes": rpc.last_call_reply_bytes,
        "chunk_prune": prune,
    }


def _warm_summary(queries):
    warm = queries[1:]
    return {
        "cold": queries[0],
        "warm": warm,
        "warm_wall_s_median": float(np.median([q["wall_s"] for q in warm])),
        "warm_median_s": {
            k: float(np.median([q[k] for q in warm]))
            for k in ("worker_s", "client_merge_s", "rest_s")
        },
        "warm_worker_phases_median_s": {
            k: float(np.median([q["worker_phases_s"].get(k, 0.0)
                                for q in warm]))
            for k in warm[-1]["worker_phases_s"]
        },
    }


def dag_reference(config, parts):
    """NumPy reference of one DAG config over every shard's rows:
    {key: {out col: value}}."""
    cols = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
    pc, fare = cols["passenger_count"], cols["fare_amount"]
    out = {}
    if config == "dag_join":
        zone = cols["PULocationID"] % 5
        for z in np.unique(zone):
            sel = zone == z
            out[f"z{z}"] = {"fare_sum": int(fare[sel].sum()),
                            "n": int(sel.sum())}
    elif config == "dag_topk":
        dist = cols["trip_distance"]
        for g in np.unique(pc):
            sel = pc == g
            out[int(g)] = {"fare_top5": np.sort(fare[sel])[::-1][:5],
                           "dist_low3": np.sort(dist[sel])[:3]}
    elif config == "dag_quantile":
        dist = cols["trip_distance"].astype(np.float64)
        for g in np.unique(pc):
            sel = dist[pc == g]
            out[int(g)] = {q: float(np.quantile(sel, float(q[1:]) / 100,
                                                method="lower"))
                           for q in ("p50", "p99")}
    elif config == "dag_window":
        hour_ns = np.int64(3600 * 10**9)
        ts = cols["pickup_ts"].view(np.int64)
        hours, inv = np.unique(ts // hour_ns * hour_ns, return_inverse=True)
        sums = np.zeros(len(hours), dtype=np.int64)
        np.add.at(sums, inv, fare)
        for h, s in zip(hours, sums):
            out[np.datetime64(int(h), "ns")] = {"fare_sum": int(s)}
    else:
        raise ValueError(config)
    return out


def check_dag(config, order, columns, want):
    """One DAG config's result against :func:`dag_reference`: ints bit for
    bit, top-k lists equal to a NumPy sort, quantiles within alpha of the
    lower order statistic."""
    spec = DAG_SPECS[config]
    key = order[0]
    assert order == [key] + [a[2] for a in spec["aggs"]], order
    got_keys = [k.item() if isinstance(k, np.generic) else k
                for k in columns[key]]
    if config == "dag_window":
        got_keys = list(columns[key])
    assert len(got_keys) == len(want), (config, len(got_keys), len(want))
    for i, k in enumerate(got_keys):
        ref = want[k]
        for out_col, value in ref.items():
            got = columns[out_col][i]
            if config == "dag_topk":
                assert got.dtype == value.dtype and np.array_equal(
                    got, value), (config, k, out_col, got, value)
            elif config == "dag_quantile":
                assert abs(got - value) <= SKETCH_ALPHA * abs(value) + 1e-12, (
                    config, k, out_col, got, value)
            else:
                assert columns[out_col].dtype == np.int64
                assert int(got) == value, (config, k, out_col, got, value)


def dag_expected_launches(config, parts, leg="fast"):
    """{shape key: launches} of one query of a DAG config: the fast path's
    one contraction over every shard's rows, one per shard on the
    per-shard leg, or the executor's one for dag_plain."""
    from bqueryd_tpu_torch import ops

    if config == "dag_plain":
        return expected_launches("multikey", parts)
    if leg == "fast":
        n = ops.program_bucket(_rows_of(parts, slice(None)), fine=True)
        return {shape_key("onehot_rows_dot", "mma", *DAG_FAST_SHAPE[config],
                          n): 1}
    out = {}
    for p in parts:
        key = shape_key("onehot_rows_dot", "mma", *DAG_SHAPE[config],
                        len(p["fare_amount"]))
        out[key] = out.get(key, 0) + 1
    return out


@contextlib.contextmanager
def capturing_dag_program(store, label):
    """Record under ``label`` the arguments of the fast path's first device
    program (``executor._dag_partials``) in the block."""
    from bqueryd_tpu_torch.parallel import executor

    program = executor._dag_partials

    def run(*args):
        store.setdefault(label, args)
        return program(*args)

    executor._dag_partials = run
    try:
        yield
    finally:
        executor._dag_partials = program


def _dag_rows(config, order, columns):
    """{key: tuple of the row's aggregate values} of a DAG result, for the
    comparison of its two legs (the legs order groups differently)."""
    key = order[0]
    out = {}
    for i, k in enumerate(columns[key]):
        k = k.item() if isinstance(k, np.generic) else k
        out[k] = tuple(
            tuple(np.asarray(columns[c][i]).tolist()) if config == "dag_topk"
            else columns[c][i].item() for c in order[1:])
    return out


def check_sketch_grid(worker, names, parts, data_dir):
    """The fast path's dag_quantile grids, flattened, against the host
    formula's flat sketches of every shard merged by bucket addition:
    keys, counts and offsets equal."""
    from bqueryd_tpu_torch.parallel import opexec
    from bqueryd_tpu_torch.plan import dag as dagmod

    dag = dagmod.compile_query(dict(DAG_SPECS["dag_quantile"],
                                    table=list(names)))
    tables = [worker._open_table(os.path.join(data_dir, n)) for n in names]
    payload = worker.executor.execute_dag(tables, dag)
    if worker.executor.last_merge_mode != "device":
        raise AssertionError("the sketch check did not take the fast path")
    # passenger_count 1..9 is group 0..8 on every shard
    host = opexec.merge_sketch_parts(
        [(np.arange(9), *opexec.sketch_flat(
            p["passenger_count"] - 1, p["trip_distance"], 9,
            alpha=SKETCH_ALPHA)) for p in parts], 9)
    for i, agg in enumerate(payload["aggs"]):
        got = (agg["sketch_keys"], agg["sketch_counts"],
               agg["sketch_offsets"])
        for name, a, b in zip(("keys", "counts", "offsets"), got, host):
            if not np.array_equal(a, b):
                raise AssertionError(f"dag_quantile agg {i}: sketch {name} "
                                     "differ from the host's")
    return int(host[1].sum())


def run_dag_path(names, parts, data_dir, store_dir, captured, programs,
                 warm=3):
    """The operator-DAG verb on the 10 taxi shards: its own controller and
    worker on cuda (threads, file:// store), each DAG config through
    ``RPC.query``.  Each extended config runs on both legs (``DAG_LEGS``):
    the fast path (one message, one contraction over every shard's rows,
    merged on the device) and, under ``BQUERYD_TPU_DAG_BATCH=0``, one
    message per shard (a contraction per shard, merged at the client); per
    leg one cold query after the worker's caches are cleared and ``warm``
    warm ones with the result cache off, each checked against NumPy,
    launching its contractions the expected times at the expected shapes
    and merging as expected, and the two legs' results equal.  Then, with
    the result cache on, one query to fill it and one that must be served
    from it ("cached", no launch).  dag_plain's result must be the very
    bytes of ``RPC.groupby`` of the same shape, on the same route.  Records
    each leg's kernel inputs (its cold query's first launch) into
    ``captured`` and the fast path's device programs into ``programs``;
    holds the fast path's quantile grids against the host's flat sketches
    merged over the shards, and the card's sketch keys of every
    trip_distance value against the host formula's."""
    from bqueryd_tpu_torch.ops import onehot, relops
    from bqueryd_tpu_torch.parallel import opexec

    report = {}
    with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0"}):
        rpc, controller, worker, threads = _start_cluster(data_dir,
                                                          store_dir)
        try:
            for config, spec in DAG_SPECS.items():
                query = dict(spec, table=list(names))
                plain = config == "dag_plain"
                want = (reference("multikey", parts) if plain
                        else dag_reference(config, parts))
                report[config] = {}
                results = {}
                for leg, env in (DAG_LEGS.items() if not plain
                                 else [("fast", {})]):
                    expect = dag_expected_launches(config, parts, leg)
                    if plain or leg == "fast":
                        modes_want = ["device"]
                    else:
                        modes_want = ["none"] * len(names)
                    _set_result_cache(worker, 0)
                    worker.clear_caches()
                    queries, routes = [], None
                    at_start = dict(onehot.LAUNCHES)
                    with _env_set(env):
                        for rep in range(warm + 1):
                            before = dict(onehot.LAUNCHES)
                            blocks = contextlib.ExitStack()
                            if rep == 0 and not plain:
                                blocks.enter_context(capturing(
                                    captured, f"dag {leg} {config}"))
                            if rep == 0 and leg == "fast" and not plain:
                                blocks.enter_context(capturing_dag_program(
                                    programs, config))
                            with blocks:
                                (order, columns), wall = _timed(
                                    lambda: rpc.query(query))
                            if plain:
                                check_result("multikey", order, columns,
                                             want)
                            else:
                                check_dag(config, order, columns, want)
                            launched = _launch_delta(before)
                            modes = list(rpc.last_call_merge_modes.values())
                            routes = list(rpc.last_call_strategies[
                                "effective"].values())
                            if launched != expect or modes != modes_want:
                                raise AssertionError(
                                    f"{config} {leg} query {rep}: expected "
                                    f"{expect} and merge modes {modes_want}; "
                                    f"launched {launched}, merge modes "
                                    f"{modes}")
                            queries.append(_reply_split(rpc, wall))
                        results[leg] = _dag_rows(config, order, columns)
                    report[config][leg] = dict(
                        _warm_summary(queries),
                        routes=routes,
                        merge_modes=modes,
                        messages=len(modes),
                        launch_shapes=expect,
                        launches=_launch_delta(at_start),
                    )
                if len(results) == 2 and results["fast"] != results[
                        "per-shard"]:
                    raise AssertionError(
                        f"{config}: the fast path and the per-shard leg "
                        "differ")
                if plain:
                    # RPC.groupby of the same shape: the same bytes, the
                    # same route
                    g_order, g_columns = _query(rpc, names, "multikey")
                    if (g_order != order or routes != list(
                            rpc.last_call_strategies["effective"].values())
                            or any(g_columns[c].tobytes()
                                   != columns[c].tobytes() for c in order)):
                        raise AssertionError(
                            "dag_plain differs from RPC.groupby of its shape")
                    report[config]["fast"]["launches"] = _launch_delta(
                        at_start)
                _set_result_cache(worker, 256 * 1024**2)
                rpc.query(query)  # fills the result cache
                before = dict(onehot.LAUNCHES)
                order, columns = rpc.query(query)
                cached_routes = list(
                    rpc.last_call_strategies["effective"].values())
                if _launch_delta(before) or cached_routes != ["cached"]:
                    raise AssertionError(
                        f"{config} with the result cache on: routes "
                        f"{cached_routes}, launched {_launch_delta(before)}")
                if plain:
                    check_result("multikey", order, columns, want)
                else:
                    check_dag(config, order, columns, want)
                report[config]["cached_routes"] = cached_routes
                report[config]["groups"] = len(want)
                log(f"dag {config}: {json.dumps(report[config])}")
        finally:
            _stop_cluster(rpc, controller, worker, threads)
    report["sketch_grid_rows_checked"] = check_sketch_grid(
        worker, names, parts, data_dir)
    # the card's sketch keys of every trip_distance value, against the host
    # formula that defines the bucket layout
    dist = np.concatenate([p["trip_distance"] for p in parts])
    device = worker.device
    card = relops.sketch_bin(dist, SKETCH_ALPHA, device)
    host = opexec.sketch_keys_host(dist, SKETCH_ALPHA)
    if not np.array_equal(card, host):
        raise AssertionError(
            f"sketch keys differ on {int((card != host).sum())} values")
    report["sketch_keys_checked"] = int(len(dist))
    return report


def time_dag_programs(programs, iters=10):
    """Device time of the fast path's torch bodies at the shapes its
    programs ran (``programs``: config -> ``_dag_partials`` arguments):
    each top-k emission (its route, checked against the sort route) and
    each sketch grid, then the whole program with its fetch."""
    import torch

    from bqueryd_tpu_torch.ops import relops
    from bqueryd_tpu_torch.parallel import executor, opexec

    out = {}
    for config, args in programs.items():
        n_groups, codes_d, measures_d, _classic, topk, sketch = args[:6]
        codes = codes_d[0].to(torch.int64)
        per_slot = [m[0] for m in measures_d]
        rows = {}
        for slot, k, largest, drop_nan, sentinel, float_neg in topk:
            def emit():
                return relops.topk_dense_emit(
                    codes, per_slot[slot], None, k, largest, n_groups,
                    drop_nan, sentinel, float_neg)

            dense, cnt = emit()
            sd, sc = relops.topk_dense_block(
                codes, per_slot[slot], None, k, largest, n_groups, drop_nan,
                sentinel, float_neg)
            for a, b in zip(
                    opexec.dense_topk_to_flat(dense.cpu().numpy(),
                                              cnt.cpu().numpy()),
                    opexec.dense_topk_to_flat(sd.cpu().numpy(),
                                              sc.cpu().numpy())):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{config} top-k slot {slot}: the "
                                         "routes differ")
            rows[f"topk slot {slot} k={k} largest={largest}"] = {
                "dtype": str(per_slot[slot].dtype),
                "device_ms": _device_ms(emit, "", iters),
                "event_ms": _time_ms(emit, iters),
                "sort_route_event_ms": _time_ms(
                    lambda: relops.topk_dense_block(
                        codes, per_slot[slot], None, k, largest, n_groups,
                        drop_nan, sentinel, float_neg), iters),
            }
        for slot, lg, imin, imax, kmin, width in sketch:
            def grid():
                return relops.sketch_grid_block(
                    codes, per_slot[slot], n_groups, lg, imin, imax, kmin,
                    width)

            rows[f"sketch slot {slot} width={width}"] = {
                "dtype": str(per_slot[slot].dtype),
                "device_ms": _device_ms(grid, "", iters),
                "event_ms": _time_ms(grid, iters),
            }
        rows["program with fetch"] = {
            "event_ms": _time_ms(lambda: executor._dag_partials(*args),
                                 iters)}
        out[config] = {"n": int(codes.shape[0]), "G": int(n_groups),
                       "ops": rows}
        log(f"dag program {config}: {json.dumps(out[config])}")
    return out


def _ingest_frame(rng, rows, seq_offset):
    """bench.py's ingest rows (``_ingest_frame``) as plain arrays."""
    return {
        "g": rng.randint(0, 7, rows).astype(np.int64),
        "v": rng.randint(-10000, 10000, rows).astype(np.int64),
        "f": rng.random(rows).astype(np.float32),
        "seq": np.arange(seq_offset, seq_offset + rows, dtype=np.int64),
    }


def write_ingest(base_dir, rows, shards, seed=INGEST_SEED):
    """bench.py's ingest dataset with the port's ctable: ``shards`` shards,
    chunks of a 24th of a shard.  Returns ({name: {column: array}},
    chunklen)."""
    from bqueryd_tpu_torch.storage.ctable import ctable

    rng = np.random.RandomState(seed)
    per = rows // shards
    chunklen = max(4096, per // 24)
    frames = {}
    for i in range(shards):
        name = f"ing_{i}.bcolzs"
        frames[name] = _ingest_frame(rng, per, 0)
        t = ctable(os.path.join(base_dir, name), mode="w", chunklen=chunklen)
        t.append(frames[name])
        t.flush()
    return frames, chunklen, rng


def ingest_reference(frames, where=None):
    """{g: {vs, fm, vmin}} of the ingest query over ``frames``."""
    cols = {c: np.concatenate([f[c] for f in frames.values()])
            for c in ("g", "v", "f", "seq")}
    keep = np.ones(len(cols["g"]), dtype=bool)
    if where is not None:
        keep = cols["seq"] > where
    g, v, f = cols["g"][keep], cols["v"][keep], cols["f"][keep]
    out = {}
    for k in np.unique(g):
        sel = g == k
        out[int(k)] = {"vs": int(v[sel].sum()),
                       "fm": float(f[sel].astype(np.float64).mean()),
                       "vmin": int(v[sel].min()),
                       "v_top3": np.sort(v[sel])[::-1][:3],
                       "f_p90": float(np.quantile(f[sel].astype(np.float64),
                                                  0.9, method="lower"))}
    return out


def check_ingest(order, columns, want, outs=("vs", "fm", "vmin")):
    assert order == ["g"] + list(outs), order
    assert len(columns["g"]) == len(want), (len(columns["g"]), len(want))
    for i, k in enumerate(columns["g"]):
        ref = want[int(k)]
        for out in outs:
            got = columns[out][i]
            if out == "fm":
                assert abs(got - ref[out]) <= 2e-5 * abs(ref[out]), (k, got)
            elif out == "f_p90":
                assert abs(got - ref[out]) <= SKETCH_ALPHA * abs(ref[out]), (
                    k, got, ref[out])
            elif out == "v_top3":
                assert np.array_equal(got, ref[out]), (k, got, ref[out])
            else:
                assert int(got) == ref[out], (k, out, got, ref[out])


def _rollup_msg(name, prior=None, base=None):
    """A ``rollup`` CalcMessage of the ingest query over one shard, with
    the prior partials and growth base of a refresh."""
    from bqueryd_tpu_torch.messages import CalcMessage

    msg = CalcMessage({"payload": "rollup", "token": os.urandom(8).hex()})
    msg.set_args_kwargs([name, ["g"], INGEST_AGGS, []], {"aggregate": True})
    if prior is not None:
        msg.add_as_binary("rollup_prior", prior)
        msg.add_as_binary("rollup_base", base)
    return msg


def run_rollups(worker, frames, names, mode, priors=None):
    """One ``rollup`` message per ingest shard to the (idle) worker's
    ``handle_work``, each reply in ``mode`` and its finalized partials
    checked against NumPy of that shard's rows.  Returns ({name: (data,
    base)}, report)."""
    from bqueryd_tpu_torch.models.query import ResultPayload
    from bqueryd_tpu_torch.parallel import hostmerge

    out, walls, phases = {}, [], {}
    for name in names:
        prior, base = (priors or {}).get(name, (None, None))
        reply, wall = _timed(lambda: worker.handle_work(
            _rollup_msg(name, prior, base)))
        if reply.get("rollup_mode") != mode:
            raise AssertionError(f"rollup {name}: mode "
                                 f"{reply.get('rollup_mode')}, expected {mode}")
        order, columns = hostmerge.finalize_table(hostmerge.merge_payloads(
            [ResultPayload.from_bytes(reply["data"])]))
        check_ingest(order, columns, ingest_reference({name: frames[name]}))
        zones = reply.get_from_binary("rollup_zones")
        base = reply.get_from_binary("rollup_base")
        if zones["g"]["kind"] != "int" or base["rows"] != len(
                frames[name]["g"]):
            raise AssertionError(f"rollup {name}: census {zones['g']}, "
                                 f"base rows {base['rows']}")
        out[name] = (reply["data"], base)
        walls.append(wall)
        for k, v in reply["phase_timings"].items():
            phases[k] = phases.get(k, 0.0) + v
    return out, {"mode": mode, "walls_s": walls, "phases_s": phases}


def run_append_path(scratch, captured):
    """The append verb on bench.py's ingest deployment: its own dataset
    (2,000,000 rows in 4 shards) and its own controller and worker on cuda,
    so the taxi shards are never mutated.  The query ``[g]: v sum, f mean,
    v min`` once (the delta base); ``rollup`` messages of the same query
    to the worker, one per shard: a build ("rebuild"), then a refresh with
    no growth ("fresh"); then two cycles of ``RPC.append`` of a 24th of a
    shard to each shard, each followed by the query, which must be a delta
    refresh (route "delta", one launch per grown shard at the appended
    rows), the first also by a rollup refresh per shard ("delta"); a cold recompute after the worker's caches are
    cleared, equal to the refreshed result; a ``seq`` filter that chunk
    pruning serves; one ``RPC.query`` over the grown shards.  Every result
    is checked against NumPy of the concatenated frames (ints bit for bit,
    the mean within rtol 2e-5, the quantile within alpha)."""
    from bqueryd_tpu_torch.ops import onehot

    base_dir = tempfile.mkdtemp(prefix="ingest_", dir=scratch)
    store = tempfile.mkdtemp(prefix="store_", dir=base_dir)
    t0 = time.perf_counter()
    frames, chunklen, rng = write_ingest(base_dir, INGEST_ROWS, INGEST_SHARDS)
    names = sorted(frames)
    per = INGEST_ROWS // INGEST_SHARDS
    report = {"rows": INGEST_ROWS, "shards": INGEST_SHARDS,
              "chunklen": chunklen,
              "write_s": time.perf_counter() - t0}
    rpc, controller, worker, threads = _start_cluster(base_dir, store)
    try:
        def query(where=None, label=None, n_float=INGEST_FLOAT_ROWS):
            terms = [] if where is None else [["seq", ">", where]]
            block = (capturing(captured, label, n_float) if label
                     else contextlib.nullcontext())
            before = dict(onehot.LAUNCHES)
            with block:
                (order, columns), wall = _timed(lambda: rpc.groupby(
                    names, ["g"], INGEST_AGGS, terms))
            check_ingest(order, columns, ingest_reference(frames, where))
            routes = list(rpc.last_call_strategies["effective"].values())
            return (columns, dict(_reply_split(rpc, wall), routes=routes,
                                  launched=_launch_delta(before)))

        _, report["base"] = query(label="append executor")
        # the rollup verb on the idle worker: a build per shard, then a
        # refresh before any append ("fresh")
        built, report["rollup_rebuild"] = run_rollups(worker, frames, names,
                                                      "rebuild")
        _, report["rollup_fresh"] = run_rollups(worker, frames, names,
                                                "fresh", built)
        append_rows = per // 24
        seq_base = per
        report["append_walls_s"], report["delta"] = [], []
        for cycle in range(2):
            t0 = time.perf_counter()
            for name in names:
                extra = _ingest_frame(rng, append_rows, seq_base)
                frames[name] = {c: np.concatenate([frames[name][c], extra[c]])
                                for c in extra}
                res = rpc.append(name, extra)
                if res["appended"] != append_rows or len(res["holders"]) != 1:
                    raise AssertionError(f"append {name}: {res}")
            report["append_walls_s"].append(time.perf_counter() - t0)
            seq_base += append_rows
            delta_cols, q = query(label="append tail" if cycle == 0
                                  else None)
            if (q["routes"] != ["delta"]
                    or sum(q["launched"].values()) != INGEST_SHARDS
                    or any(not k.endswith(f"/n={append_rows}")
                           for k in q["launched"])):
                raise AssertionError(
                    f"delta cycle {cycle}: routes {q['routes']}, launched "
                    f"{q['launched']}")
            report["delta"].append(q)
            if cycle == 0:
                # the grown shards' rollups refresh from the appended
                # chunks alone
                _, report["rollup_delta"] = run_rollups(
                    worker, frames, names, "delta", built)
        worker.clear_caches()
        cold_cols, report["cold"] = query()
        if report["cold"]["routes"] in (["delta"], ["cached"]):
            raise AssertionError(f"cold recompute: {report['cold']}")
        for out in ("vs", "vmin"):
            if not np.array_equal(cold_cols[out], delta_cols[out]):
                raise AssertionError(f"delta vs cold {out} differ")
        report["delta_vs_cold_fm_max_rel"] = float(np.max(
            np.abs(cold_cols["fm"] - delta_cols["fm"])
            / np.abs(cold_cols["fm"])))
        threshold = int((per + 2 * append_rows) * 0.92)
        _, report["pruned"] = query(where=threshold)
        decoded, skipped = report["pruned"]["chunk_prune"] or (0, 0)
        if not skipped:
            raise AssertionError(f"the seq filter pruned nothing: "
                                 f"{report['pruned']}")
        spec = {"table": names, "groupby": ["g"],
                "aggs": [["v", "topk", "v_top3", {"k": 3}],
                         ["f", "quantile", "f_p90",
                          {"q": 0.9, "alpha": SKETCH_ALPHA}],
                         ["v", "sum", "vs"]]}
        before = dict(onehot.LAUNCHES)
        (order, columns), wall = _timed(lambda: rpc.query(spec))
        check_ingest(order, columns, ingest_reference(frames),
                     outs=("v_top3", "f_p90", "vs"))
        report["query"] = dict(_reply_split(rpc, wall),
                               launched=_launch_delta(before),
                               merge_modes=list(
                                   rpc.last_call_merge_modes.values()))
        report["delta_refreshes"] = worker.delta_refreshes
        report["append_rows_per_shard"] = 2 * append_rows
        report["delta_wall_s"] = report["delta"][-1]["wall_s"]
        report["cold_wall_s"] = report["cold"]["wall_s"]
        report["cold_over_delta"] = (report["cold_wall_s"]
                                     / report["delta_wall_s"])
    finally:
        _stop_cluster(rpc, controller, worker, threads)
        shutil.rmtree(base_dir, ignore_errors=True)
    log(f"append: {json.dumps(report)}")
    return report


#: the concurrency leg: bench.py's swarm (8 clients, each with its own
#: RPC and client_id, 4 rounds behind a barrier), every query
#: ``passenger_count`` -> fare sum with its own ``trip_distance``
#: threshold, run at window 0 and at bench.py's 40 ms window
CONC_CLIENTS = 8
CONC_ROUNDS = 4
CONC_WINDOW_MS = 40
CONC_BASE, CONC_STEP = 0.5, 0.013
#: the other windows of the leg: 4 compatible queries each, on the base
#: kernel's "table" branch (zones) and the hicard "cluster" branch
CONC_WINDOWS = {
    "zones": (["PULocationID"], [["fare_amount", "sum", "fare_sum"],
                                 ["fare_amount", "count", "n"]],
              (2.0, 7.5, 15.0, 22.5)),
    "highcard": (["PULocationID", "DOLocationID"],
                 [["fare_amount", "sum", "fare_amount"]],
                 (1.0, 5.0, 10.0, 20.0)),
}
#: the (kernel, branch) each window's members launch, one per member
CONC_KERNEL = {"swarm": ("onehot_rows_dot", "mma"),
               "zones": ("onehot_rows_dot", "table"),
               "highcard": ("onehot_rows_dot_hicard", "cluster")}


def conc_reference(cols, gcols, aggs, threshold):
    """NumPy of one filtered query over the concatenated shards:
    {key tuple: {out col: value}}, sums exact in int64."""
    keep = cols["trip_distance"] > np.float32(threshold)
    keys = [cols[c][keep] for c in gcols]
    packed = keys[0] if len(keys) == 1 else keys[0] * 266 + keys[1]
    fare = cols["fare_amount"][keep]
    count = np.bincount(packed)
    sums = np.bincount(packed, weights=fare).astype(np.int64)
    out = {}
    for slot in np.flatnonzero(count):
        key = ((int(slot),) if len(keys) == 1
               else (int(slot) // 266, int(slot) % 266))
        out[key] = {a[2]: int(sums[slot] if a[1] == "sum" else count[slot])
                    for a in aggs}
    return out


def check_conc(label, gcols, aggs, order, columns, want):
    """Every group and value equal to NumPy's, ints bit for bit.  A query
    whose every shard was pruned at plan time answers with no columns at
    all, the reference's empty answer."""
    if not want and order == [] and columns == {}:
        return
    if order != gcols + [a[2] for a in aggs]:
        raise AssertionError(f"{label}: columns {order}")
    n = len(columns[gcols[0]])
    if n != len(want):
        raise AssertionError(f"{label}: {n} groups, NumPy {len(want)}")
    for i in range(n):
        key = tuple(int(columns[c][i]) for c in gcols)
        for a in aggs:
            if (columns[a[2]].dtype != np.int64
                    or int(columns[a[2]][i]) != want[key][a[2]]):
                raise AssertionError(f"{label} {key} {a[2]}: "
                                     f"{columns[a[2]][i]} != "
                                     f"{want[key][a[2]]}")


def _swarm(url, queries_by_client, window_ms):
    """bench.py's closed-loop swarm against a live controller: one thread
    and one RPC (with its own client_id) per client, a barrier per round so
    that each round's queries land together, ``window_ms`` set for the leg.
    Returns ``(results[(client, round)], walls, elapsed_s, timings)``:
    ``timings[(client, round)]`` is the reply's phase timings of its one
    shard group (a bundle member's scaled by its share), with the route
    its reply named under ``"_route"``."""
    import logging

    from bqueryd_tpu_torch.rpc import RPC

    n_clients = len(queries_by_client)
    barrier = threading.Barrier(n_clients)
    results, walls, errors, timings = {}, [], [], {}
    lock = threading.Lock()

    def client(ci):
        rpc = None
        try:
            rpc = RPC(coordination_url=url, timeout=300, retries=1,
                      loglevel=logging.WARNING, client_id=f"client-{ci}")
            for k, query in enumerate(queries_by_client[ci]):
                barrier.wait(timeout=300)
                t0 = time.perf_counter()
                out = rpc.groupby(*query)
                wall = time.perf_counter() - t0
                with lock:
                    walls.append(wall)
                    results[(ci, k)] = out
                    (timings[(ci, k)],) = rpc.last_call_timings.values()
                    (timings[(ci, k)]["_route"],) = (
                        rpc.last_call_strategies["effective"].values())
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)
            barrier.abort()
        finally:
            if rpc is not None:
                rpc._close_socket()

    with _env_set({"BQUERYD_TPU_BATCH_WINDOW_MS": str(window_ms)}):
        threads = [threading.Thread(target=client, args=(ci,), daemon=True)
                   for ci in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        elapsed = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"swarm failed: {errors!r}")
    return results, walls, elapsed, timings


def _counter_delta(controller, before):
    return {k: controller.counters[k] - before[k]
            for k in ("plan_bundles", "plan_bundled_queries",
                      "plan_shared_dispatches", "dispatched_shards",
                      "plan_pruned_shards")}


def run_concurrency_path(names, parts, data_dir, store_dir, captured):
    """Admission, plan-time pruning, shared dispatch and the micro-batch
    window on the groupby cluster (its own controller and worker on cuda,
    the 10 taxi shards, the result cache off).

    1. bench.py's swarm (``CONC_CLIENTS`` clients x ``CONC_ROUNDS`` rounds
       of distinct-but-compatible queries), first at window 0 (unfused:
       every query its own dispatch and fold), then at ``CONC_WINDOW_MS``
       (fused): QPS, median and p90 walls, the controller's bundle counters
       and the worker's phases of one bundle reply.  Every answer equals
       NumPy's; the fused leg must form bundles (bundled queries > bundles
       > 0) and launch one contraction per executed member.
    2. One window of 4 compatible ``zones`` queries (the base kernel's
       "table" branch) and one of 4 ``highcard`` ones (hicard "cluster"):
       one bundle each, one launch per member.  The first bundle of each
       kind records its kernel inputs into ``captured``.
    3. bench.py's identical-query probe: two concurrent identical queries
       at window 0 share one CalcMessage.
    4. A query whose filter the advertised shard stats exclude on every
       shard: answered with no dispatch and no launch, NumPy's empty
       answer."""
    from bqueryd_tpu_torch.ops import onehot

    cols = {c: np.concatenate([p[c] for p in parts])
            for c in ("passenger_count", "fare_amount", "PULocationID",
                      "DOLocationID", "trip_distance")}
    report = {"clients": CONC_CLIENTS, "rounds": CONC_ROUNDS,
              "window_ms": CONC_WINDOW_MS}
    n_queries = CONC_CLIENTS * CONC_ROUNDS
    gcols, aggs = ["passenger_count"], [["fare_amount", "sum", "fare_sum"]]

    def swarm_queries(base):
        return [[(names, gcols, aggs,
                  [["trip_distance", ">",
                    round(base + CONC_STEP * (ci * CONC_ROUNDS + k), 4)]])
                 for k in range(CONC_ROUNDS)]
                for ci in range(CONC_CLIENTS)]

    queries = swarm_queries(CONC_BASE)
    want = {q[3][0][2]: conc_reference(cols, gcols, aggs, q[3][0][2])
            for qs in queries for q in qs}
    bundle_phases = []
    bundle_launches = {}

    with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0"}):
        rpc, controller, worker, threads = _start_cluster(data_dir,
                                                          store_dir)
        real_bundle = worker._handle_bundle

        def spied_bundle(msg):
            # the unscaled phases of each bundle reply the worker sends,
            # and its launches: one contraction per executed member
            before = dict(onehot.LAUNCHES)
            reply = real_bundle(msg)
            launched = _launch_delta(before)
            executed = sum(1 for v in reply["member_shares"].values() if v)
            if sum(launched.values()) != executed:
                raise AssertionError(f"a bundle of {executed} executed "
                                     f"members launched {launched}")
            for key, n in launched.items():
                bundle_launches[key] = bundle_launches.get(key, 0) + n
            bundle_phases.append({
                "members": len(reply["bundle_members"]),
                "phases_s": dict(reply["phase_timings"]),
                "launched": launched,
            })
            return reply

        worker._handle_bundle = spied_bundle
        try:
            _wait(lambda: all(n in controller.shard_stats for n in names),
                  60, "every shard's advertised stats")
            # warm-up: each shape's alignment, measure blocks and unmasked
            # codes, and one fused round at disjoint thresholds
            for gc, ag in [(gcols, aggs)] + [w[:2] for w in
                                              CONC_WINDOWS.values()]:
                rpc.groupby(names, gc, ag, [])
            _swarm(controller_url(store_dir),
                   [[q[0]] for q in swarm_queries(20.0)], CONC_WINDOW_MS)

            for leg, window in (("unfused", 0), ("fused", CONC_WINDOW_MS)):
                before = dict(controller.counters)
                launches_before = dict(onehot.LAUNCHES)
                n_phases = len(bundle_phases)
                # the fused leg's first launch is its first bundle's first
                # member: its inputs go to the kernel rows
                with (capturing(captured, "bundle swarm") if window
                      else contextlib.nullcontext()):
                    results, walls, elapsed, timings = _swarm(
                        controller_url(store_dir), queries, window)
                for (ci, k), (order, columns) in results.items():
                    q = queries[ci][k]
                    check_conc(f"{leg} {ci}/{k}", gcols, aggs, order,
                               columns, want[q[3][0][2]])
                counters = _counter_delta(controller, before)
                launched = _launch_delta(launches_before)
                kernel, branch = CONC_KERNEL["swarm"]
                # a solo query carries the heuristic's advisory "matmul"
                # hint: every query and member on the contraction
                routes = [t["_route"] for t in timings.values()]
                if (sum(launched.values()) != n_queries
                        or set(routes) != {"matmul"}
                        or any(not k.startswith(f"{kernel}/{branch}/")
                               for k in launched)):
                    raise AssertionError(
                        f"{leg}: launched {launched} for {n_queries} "
                        f"queries with routes {routes} (one contraction per "
                        "query or member)")
                if leg == "fused" and not (
                        counters["plan_bundled_queries"]
                        > counters["plan_bundles"] > 0):
                    raise AssertionError(f"fused leg formed no bundles: "
                                         f"{counters}")
                if leg == "unfused" and (counters["plan_bundles"]
                                         or len(bundle_phases) != n_phases):
                    raise AssertionError(f"window 0 bundled: {counters}")
                report[leg] = {
                    "routes": {r: routes.count(r) for r in set(routes)},
                    "qps": n_queries / elapsed,
                    "elapsed_s": elapsed,
                    "wall_s_median": float(np.median(walls)),
                    "wall_s_p90": float(np.percentile(walls, 90)),
                    "walls_s": sorted(walls),
                    "counters": counters,
                    "launched": launched,
                    "bundles": bundle_phases[n_phases:],
                }
                if leg == "unfused":
                    # the worker's phases of a solo reply, median per phase
                    report[leg]["reply_phases_s_median"] = {
                        k: float(np.median([t.get(k, 0.0)
                                            for t in timings.values()]))
                        for k in next(iter(timings.values()))
                        if k != "_route"}
                log(f"concurrency {leg}: qps {report[leg]['qps']:.1f}, "
                    f"median {report[leg]['wall_s_median'] * 1e3:.2f} ms, "
                    f"counters {counters}")
            report["fused_over_unfused_qps"] = (report["fused"]["qps"]
                                                / report["unfused"]["qps"])
            report["routing_work_us"] = _routing_work(
                controller, worker, data_dir, names, gcols, aggs)
            log(f"concurrency routing work per query (us): "
                f"{json.dumps(report['routing_work_us'])}")

            # two windows of 4 compatible queries per other contraction
            # (the second at thresholds shifted by 0.5)
            for name, (gc, ag, base_thresholds) in CONC_WINDOWS.items():
                report[name] = []
                for shift in (0.0, 0.5):
                    thresholds = [t + shift for t in base_thresholds]
                    wants = [conc_reference(cols, gc, ag, t)
                             for t in thresholds]
                    before = dict(controller.counters)
                    launches_before = dict(onehot.LAUNCHES)
                    with (capturing(captured, f"bundle {name}") if not shift
                          else contextlib.nullcontext()):
                        results, walls, _elapsed, _t = _swarm(
                            controller_url(store_dir),
                            [[(names, gc, ag, [["trip_distance", ">", t]])]
                             for t in thresholds], CONC_WINDOW_MS)
                    for ci, t in enumerate(thresholds):
                        check_conc(f"{name} > {t}", gc, ag,
                                   *results[(ci, 0)], wants[ci])
                    counters = _counter_delta(controller, before)
                    launched = _launch_delta(launches_before)
                    kernel, branch = CONC_KERNEL[name]
                    if (counters["plan_bundles"] != 1
                            or counters["plan_bundled_queries"] != 4
                            or sum(launched.values()) != 4
                            or any(not k.startswith(f"{kernel}/{branch}/")
                                   for k in launched)):
                        raise AssertionError(
                            f"{name} window: counters {counters}, "
                            f"launched {launched}")
                    report[name].append({
                        "counters": counters, "launched": launched,
                        "wall_s_median": float(np.median(walls)),
                        "bundle": bundle_phases[-1]})
                    log(f"concurrency {name}: {json.dumps(report[name][-1])}")
            # bench.py's identical-query probe at window 0: a fresh filter,
            # so the shared unit is still running when the second arrives
            before = dict(controller.counters)
            probe = (names, gcols, aggs, [["trip_distance", ">", 9.37]])
            results, _walls, _elapsed, _t = _swarm(controller_url(store_dir),
                                               [[probe], [probe]], 0)
            probe_want = conc_reference(cols, gcols, aggs, 9.37)
            for (ci, _k), out in results.items():
                check_conc(f"probe {ci}", gcols, aggs, *out, probe_want)
            report["identical_probe"] = _counter_delta(controller, before)
            if (report["identical_probe"]["plan_shared_dispatches"] < 1
                    or report["identical_probe"]["dispatched_shards"] != 1):
                raise AssertionError(f"identical probe: "
                                     f"{report['identical_probe']}")

            # a filter the advertised stats exclude on every shard
            before = dict(controller.counters)
            launches_before = dict(onehot.LAUNCHES)
            (order, columns), wall = _timed(lambda: rpc.groupby(
                names, gcols, aggs, [["trip_distance", ">", 31.0]]))
            check_conc("stats-pruned", gcols, aggs, order, columns,
                       conc_reference(cols, gcols, aggs, 31.0))
            pruned = _counter_delta(controller, before)
            if (pruned["plan_pruned_shards"] != len(names)
                    or pruned["dispatched_shards"]
                    or _launch_delta(launches_before)):
                raise AssertionError(f"stats-pruned query: {pruned}")
            report["stats_pruned"] = dict(pruned, wall_s=wall,
                                          groups=len(columns.get(gcols[0], ())))
            report["counters"] = dict(controller.counters)
            report["bundle_launches"] = bundle_launches
            report["admission"] = controller.admission.stats()
            if report["admission"]["active"]:
                raise AssertionError(f"tickets left: {report['admission']}")
        finally:
            worker._handle_bundle = real_bundle
            _stop_cluster(rpc, controller, worker, threads)
    log(f"concurrency: fused/unfused QPS "
        f"{report['fused_over_unfused_qps']:.3f}")
    return report


def _routing_work(controller, worker, data_dir, names, gcols, aggs,
                  reps=200):
    """Median µs of the routing work one swarm query pays, timed on this
    thread while the nodes idle: the worker's gate in ``worker.execute``
    (the wedge latch, the host-cost estimate over the group's shards, the
    threshold) and the controller's hint (``plan.select_calibrated`` over
    the advertised stats and its model), with calibration off and on."""
    from bqueryd_tpu_torch.models.query import (
        _host_ns_estimate,
        host_kernel_rows,
    )
    from bqueryd_tpu_torch.plan import strategy as strategymod
    from bqueryd_tpu_torch.utils import devicehealth

    tables = [worker._open_table(os.path.join(data_dir, n)) for n in names]

    def gate():
        total = sum(int(t.nrows) for t in tables)
        return (not devicehealth.backend_wedged()
                and total > host_kernel_rows(max(
                    _host_ns_estimate(t, aggs, total) for t in tables)))

    def hint():
        return strategymod.select_calibrated(
            controller.shard_stats, names, gcols, controller.calibration)

    out = {}
    for label, fn, env in (("gate", gate, {}),
                           ("hint_calib_off", hint,
                            {"BQUERYD_TPU_CALIB": "0"}),
                           ("hint_calib_on", hint,
                            {"BQUERYD_TPU_CALIB": "1"})):
        walls = []
        with _env_set(env):
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                walls.append(time.perf_counter() - t0)
        out[label] = float(np.median(walls)) * 1e6
    return out


#: not-wedged -> wedged flips the run forces (the wedge leg's one)
FORCED_FLIPS = 1
#: the wedge leg's window of compatible zones queries (their filters)
WEDGE_ZONES = (2.0, 7.5, 15.0, 22.5)
#: walls per route of the host-route leg (alternating host and device)
ROUTE_REPS = 5


def _route_dataset(data_dir, rows):
    """A shard group of ``rows`` taxi rows in 2 shards, written with
    :func:`make_dataset` beside the taxi shards as ``route_{i}.bcolzs``."""
    tmp = tempfile.mkdtemp(prefix="route_", dir=data_dir)
    names, parts = make_dataset(tmp, rows=rows, shards=2)
    moved = []
    for i, name in enumerate(names):
        moved.append(f"route_{i}.bcolzs")
        os.rename(os.path.join(tmp, name), os.path.join(data_dir, moved[-1]))
    shutil.rmtree(tmp, ignore_errors=True)
    return moved, parts


def _cluster_query(rpc, config, names, parts, want, label, expect_route):
    """One checked ``RPC.groupby`` of ``config`` over ``names``: the
    answer equal to NumPy's, every reply's route ``expect_route`` and the
    launches it implies (none off the contraction); with ``expect_route``
    None (calibrated hints), the launches of the route the reply names.
    Returns the query's record."""
    from bqueryd_tpu_torch.ops import onehot

    sl, gcols, aggs, where = CONFIGS[config]
    before = dict(onehot.LAUNCHES)
    (order, columns), wall = _timed(lambda: rpc.groupby(
        names, gcols, aggs, where, **OPTIONS.get(config, {})))
    check_result(config, order, columns, want)
    launched = _launch_delta(before)
    routes = list(rpc.last_call_strategies["effective"].values())
    if expect_route is None:
        expect = route_launches(config, parts, routes)
    elif not routes or any(r != expect_route for r in routes):
        raise AssertionError(f"{label}: routes {routes}, expected "
                             f"{expect_route}")
    else:
        expect = (expected_launches(config, parts)
                  if expect_route == "matmul" else {})
    if launched != expect:
        raise AssertionError(f"{label}: routes {routes}, expected launches "
                             f"{expect}, launched {launched}")
    return {"wall_s": wall, "routes": routes, "launched": launched,
            "hints": rpc.last_call_strategies["hints"],
            "merge_modes": list(rpc.last_call_merge_modes.values())}


def run_routing_path(names, parts, data_dir, store_dir):
    """Latency-aware host routing and the device-health latch on a cluster
    of their own over the taxi shards (result cache off):

    1. the dispatch floor the worker measured after its warmup, and the
       host-routing threshold at 8 and 32 ns a row, which must lie below
       the smallest shape a leg runs on the card (the append leg's
       20,833-row tail views);
    2. a shard group of half that threshold (2 shards) through the
       cluster, alternately at the default (route "host", no launch) and
       under ``BQUERYD_TPU_HOST_KERNEL_ROWS=0`` and the heuristic hints
       (route "matmul", one launch), both exact: the two walls are the
       card's crossover;
    3. the wedge: ``devicehealth.force_state(True)`` in this process, then
       the five BASELINE configs, dag_join and a 40 ms window of 4
       ``zones`` queries, every answer exact, every route "host", no
       launch and no CUDA allocation, the worker map showing
       ``backend_wedged``; then ``force_state(False)`` and the BASELINE
       configs, under the heuristic hints (``BQUERYD_TPU_CALIB=0``), take
       their :data:`HEURISTIC_ROUTE` again and launch its kernels."""
    import torch

    from bqueryd_tpu_torch.models import query as q
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.utils import devicehealth

    report = {}
    rpc, controller, worker, threads = _start_cluster(data_dir, store_dir)
    route_names = []
    try:
        # 1. the floor: WorkerNode.go remeasured it once the kernels were
        # loaded and the CUDA context made
        floor = q.device_dispatch_floor()
        rows8 = q.host_kernel_rows()
        rows32 = q.host_kernel_rows(q._HOST_NS_PER_ROW_SLOW)
        smallest = INGEST_ROWS // INGEST_SHARDS // 24
        report["floor"] = {"floor_us": floor * 1e6, "host_rows_8ns": rows8,
                           "host_rows_32ns": rows32,
                           "smallest_device_shape_rows": smallest}
        log(f"dispatch floor {floor * 1e6:.3f} us: host-routing threshold "
            f"{rows8} rows at 8 ns/row, {rows32} at 32 ns/row")
        if not 0 < rows32 <= rows8 < smallest:
            raise AssertionError(f"threshold {report['floor']} not below "
                                 f"the {smallest}-row tail views")

        # 2. a shard group of half the threshold, host and card in turn
        route_names, route_parts = _route_dataset(data_dir, max(rows8 // 2,
                                                                 4))
        _wait(lambda: all(n in controller.files_map for n in route_names),
              30, "the worker advertising the host-route shards")
        want = reference("sharded", route_parts)
        walls = {"host": [], "device": []}
        for rep in range(ROUTE_REPS + 1):
            for leg, env, route in (
                    ("host", {}, "host"),
                    ("device", {"BQUERYD_TPU_HOST_KERNEL_ROWS": "0",
                                "BQUERYD_TPU_CALIB": "0"}, "matmul")):
                with _env_set(env):
                    rec = _cluster_query(
                        rpc, "sharded", route_names, route_parts, want,
                        f"host-route leg {leg} {rep}", route)
                if rep:
                    walls[leg].append(rec["wall_s"])
        report["host_route"] = {
            "rows": sum(len(p["fare_amount"]) for p in route_parts),
            "host_wall_s_median": float(np.median(walls["host"])),
            "device_wall_s_median": float(np.median(walls["device"])),
            "walls_s": walls,
        }
        log(f"host route: {json.dumps(report['host_route'])}")

        # 3. the wedge: no probe may run (and unlatch) inside the leg
        stats_before = torch.cuda.memory_stats()["allocation.all.allocated"]
        before = dict(onehot.LAUNCHES)
        wedged = {}
        with _env_set({"BQUERYD_TPU_DEVICE_PROBE_INTERVAL_S": "3600"}):
            devicehealth.force_state(True)
            try:
                _wait(lambda: controller.worker_map.get(
                    worker.worker_id, {}).get("backend_wedged"), 30,
                    "backend_wedged in the controller's worker map")
                for config in BASE_CONFIGS:
                    wedged[config] = _cluster_query(
                        rpc, config, names[CONFIGS[config][0]], parts,
                        reference(config, parts), f"wedged {config}", "host")
                (order, columns), wall = _timed(lambda: rpc.query(
                    dict(DAG_SPECS["dag_join"], table=list(names))))
                check_dag("dag_join", order, columns,
                          dag_reference("dag_join", parts))
                routes = list(rpc.last_call_strategies["effective"].values())
                if routes != ["host"]:
                    raise AssertionError(f"wedged dag_join: routes {routes}")
                wedged["dag_join"] = {"wall_s": wall, "routes": routes}
                counters = dict(controller.counters)
                gc, ag, _t = CONC_WINDOWS["zones"]
                cols = {c: np.concatenate([p[c] for p in parts])
                        for c in ("PULocationID", "fare_amount",
                                  "trip_distance")}
                results, zwalls, _elapsed, timings = _swarm(
                    controller_url(store_dir),
                    [[(names, gc, ag, [["trip_distance", ">", t]])]
                     for t in WEDGE_ZONES], CONC_WINDOW_MS)
                for ci, t in enumerate(WEDGE_ZONES):
                    check_conc(f"wedged zones > {t}", gc, ag,
                               *results[(ci, 0)],
                               conc_reference(cols, gc, ag, t))
                zroutes = [t["_route"] for t in timings.values()]
                zcount = _counter_delta(controller, counters)
                if set(zroutes) != {"host"} or zcount["plan_bundles"] != 1:
                    raise AssertionError(f"wedged zones window: routes "
                                         f"{zroutes}, counters {zcount}")
                wedged["zones_window"] = {
                    "wall_s_median": float(np.median(zwalls)),
                    "routes": zroutes, "counters": zcount}
                launched = _launch_delta(before)
                allocs = (torch.cuda.memory_stats()["allocation.all.allocated"]
                          - stats_before)
                if launched or allocs:
                    raise AssertionError(f"wedged leg launched {launched}, "
                                         f"{allocs} CUDA allocations")
                wedged["worker_map_backend_wedged"] = bool(
                    controller.worker_map[worker.worker_id]["backend_wedged"])
            finally:
                devicehealth.force_state(False)
        report["wedged"] = wedged
        log(f"wedged: {json.dumps(wedged)}")
        _wait(lambda: not controller.worker_map.get(
            worker.worker_id, {}).get("backend_wedged"), 30,
            "the recovered worker's WRM")
        # the heuristic hints alone (calibration off), so that each config
        # takes the route its shape gives it: the four base-kernel configs
        # launch their contraction again, highcard runs its binding
        # "scatter"
        recovered = {}
        with _env_set({"BQUERYD_TPU_CALIB": "0"}):
            for config in BASE_CONFIGS:
                recovered[config] = _cluster_query(
                    rpc, config, names[CONFIGS[config][0]], parts,
                    reference(config, parts), f"recovered {config}",
                    heuristic_route(config))
        report["recovered"] = recovered
        log(f"recovered: {json.dumps(recovered)}")
    finally:
        _stop_cluster(rpc, controller, worker, threads)
        for name in route_names:
            shutil.rmtree(os.path.join(data_dir, name), ignore_errors=True)
    return report


#: the calibration leg: warm rounds of these configs on a cluster of its
#: own, default settings
CALIB_CONFIGS = ("single", "zones", "highcard")
CALIB_ROUNDS = 20
HINT_COUNTERS = ("plan_strategy_hints", "plan_calibrated_overrides",
                 "plan_explore_hints", "plan_matmul_promotions")


def run_calibration_path(names, parts, data_dir, store_dir):
    """Measured-cost calibration on a cluster of its own (result cache
    off, calibration at its defaults, the worker's store emptied first so
    that no earlier leg's walls steer it): one cold and
    :data:`CALIB_ROUNDS` warm rounds of :data:`CALIB_CONFIGS`, each answer
    exact and its launches held to the route its reply names, every
    change of route logged; each round's hint and route, the walls per
    route, the controller's model (``get_info()["calibration"]``, cells
    tagged "cuda") and the four hint counters; then one round under
    ``BQUERYD_TPU_CALIB=0``, whose hints must be the heuristic's
    (``plan.strategy.select_for_group``) and whose routes and launches
    :data:`HEURISTIC_ROUTE`'s."""
    from bqueryd_tpu_torch.plan import calibrate

    # the worker-side store is process-global: every earlier leg's
    # executor and engine recorded into it
    calibrate._reset_for_tests()
    rpc, controller, worker, threads = _start_cluster(data_dir, store_dir)
    report = {"rounds": [], "walls_by_route": {}, "flips": [],
              "launches": dict.fromkeys(CALIB_CONFIGS, 0)}
    try:
        wants = {c: reference(c, parts) for c in CALIB_CONFIGS}
        for rnd in range(CALIB_ROUNDS + 1):
            row = {}
            for config in CALIB_CONFIGS:
                rec = _cluster_query(rpc, config, names[CONFIGS[config][0]],
                                     parts, wants[config],
                                     f"calibration {config} round {rnd}",
                                     None)
                (route,) = rec["routes"]
                report["launches"][config] += sum(rec["launched"].values())
                row[config] = {"hints": rec["hints"], "route": route,
                               "wall_s": rec["wall_s"]}
                if rnd and report["rounds"][-1][config]["route"] != route:
                    report["flips"].append({
                        "round": rnd, "config": config, "hints": rec["hints"],
                        "from": report["rounds"][-1][config]["route"],
                        "to": route})
                    log(f"calibration {config} round {rnd}: route "
                        f"{report['flips'][-1]['from']} -> {route} (hints "
                        f"{rec['hints']})")
                if rnd:
                    report["walls_by_route"].setdefault(
                        f"{config} {route}", []).append(rec["wall_s"])
            report["rounds"].append(row)
        info = rpc.info()["calibration"]
        # the worker's device type tags its cells: "cuda" on the card
        tag = f"|{worker.device.type}|"
        cuda_cells = sorted({k for cells in info["source_cells"].values()
                             for k in cells if tag in k})
        if not cuda_cells:
            raise AssertionError(f"no {tag}-tagged cell: {info}")
        report["calibration"] = info
        report["counters"] = {k: controller.counters[k]
                              for k in HINT_COUNTERS}
        report["walls_by_route_median_s"] = {
            k: float(np.median(v)) for k, v in
            report["walls_by_route"].items()}
        # the kill switch: heuristic hints, routes and launches only
        killed = {}
        with _env_set({"BQUERYD_TPU_CALIB": "0"}):
            for config in CALIB_CONFIGS:
                rec = _cluster_query(rpc, config, names[CONFIGS[config][0]],
                                     parts, wants[config],
                                     f"calibration off {config}",
                                     heuristic_route(config))
                heuristic = heuristic_hints(controller, config, names)
                if rec["hints"] != heuristic:
                    raise AssertionError(f"BQUERYD_TPU_CALIB=0 {config}: "
                                         f"hints {rec['hints']}, heuristic "
                                         f"{heuristic}")
                killed[config] = rec
        report["calib_off"] = killed
    finally:
        _stop_cluster(rpc, controller, worker, threads)
    log(f"calibration: counters {report['counters']}, cuda cells "
        f"{cuda_cells}")
    for rnd, row in enumerate(report["rounds"]):
        log(f"calibration round {rnd}: " + ", ".join(
            f"{c} {v['hints']} -> {v['route']} {v['wall_s'] * 1e3:.3f} ms"
            for c, v in row.items()))
    log(f"calibration walls by route (median s): "
        f"{json.dumps(report['walls_by_route_median_s'])}")
    return report


#: the serving leg (run_serving_path): the configs whose rollups it builds
#: on the taxi shards and then serves, each against its dispatched warm
#: queries; its environment: serving on, a view materialized at its first
#: query, the heuristic hints alone, the worker's result cache off (so that
#: a dispatched warm query runs its kernels)
SERVE_CONFIGS = ("sharded", "multikey", "zones", "highcard")
SERVE_WARM = 3
SERVE_ENV = {"BQUERYD_TPU_SERVE": "1", "BQUERYD_TPU_ROLLUP_HEAT_MIN": "1",
             "BQUERYD_TPU_CALIB": "0", "BQUERYD_TPU_RESULT_CACHE_BYTES": "0"}
#: the serving layer's internal errors: it logs them and recomputes, so the
#: leg fails on any of them instead of passing by recomputing
SERVE_FAILURE_LOGS = ("serving layer error", "rollup fold failed")
#: the kernel branches the serving leg launches: the builds on the engine
#: (mma for sharded and multikey, table for zones, hicard cluster for
#: highcard, mma on the ingest shards and their tails) and the dispatched
#: queries
SERVE_KERNELS = (("onehot_rows_dot", "mma"), ("onehot_rows_dot", "table"),
                 ("onehot_rows_dot_hicard", "cluster"))


def _serve_failures():
    """A log handler collecting the serving layer's internal errors."""
    import logging

    class Failures(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.ERROR)
            self.records = []

        def emit(self, record):
            text = record.getMessage()
            if any(t in text for t in SERVE_FAILURE_LOGS):
                self.records.append(text)

    return Failures()


def _settled(controller):
    """No rollup build in flight, and every entry ready."""
    entries = list(controller.serving.manager.entries.values())
    return not controller._rollup_waiters and all(
        e.state == "ready" for e in entries)


def _ready_entry(controller, known):
    """The one ready entry not in ``known``, or None."""
    fresh = [e for e in list(controller.serving.manager.entries.values())
             if e.key not in known and e.state == "ready"]
    return fresh[0] if len(fresh) == 1 else None


def _flight_since(node, seq, kind, **match):
    """``node``'s flight events of ``kind`` after ``seq`` whose fields
    equal ``match``."""
    return [e for e in node.flight.events()
            if e["seq"] > seq and e["kind"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def _build_seconds(controller, seq, key):
    """Seconds from the controller's last ``rollup_dispatch`` of ``key``
    after ``seq`` to its ``rollup_materialized`` (flight-ring clocks)."""
    sent = _flight_since(controller, seq, "rollup_dispatch", entry=key)
    done = _flight_since(controller, seq, "rollup_materialized", entry=key)
    return done[-1]["ts"] - sent[-1]["ts"]


def _serve_query(rpc, names, config):
    """One groupby of ``config`` through the cluster: (order, columns, the
    reply's provenance, wall, bytes and client merge)."""
    (order, columns), wall = _timed(lambda: _query(rpc, names, config))
    merge = rpc.last_call_client_merge_s
    return order, columns, {
        "answer_source": rpc.last_call_answer_source,
        "subsumed_from": rpc.last_call_subsumed_from,
        "wall_s": wall,
        "reply_bytes": rpc.last_call_reply_bytes,
        "client_merge_s": merge,
        "rest_s": wall - merge,
    }


def _walls(queries):
    return {k: float(np.median([q[k] for q in queries]))
            for k in ("wall_s", "reply_bytes", "client_merge_s", "rest_s")}


def _serve_config(rpc, controller, worker, names, parts, config, captured):
    """One config's rollup: the first query dispatched ("recompute") and
    the build it triggers (one ``rollup`` message per shard, each one
    contraction on the engine over its 1M rows), then ``SERVE_WARM``
    served queries ("rollup" from the new entry, no dispatch, no launch)
    and ``SERVE_WARM`` dispatched ones under ``BQUERYD_TPU_SERVE=0``
    (launching as the heuristic route implies).  Every answer checked
    against NumPy."""
    from bqueryd_tpu_torch.ops import onehot

    want = reference(config, parts)
    shard_rows = len(parts[0]["fare_amount"])
    known = set(controller.serving.manager.entries)
    seq, wseq = controller.flight.seq, worker.flight.seq
    before = dict(onehot.LAUNCHES)
    # a kernel row for a build shape no other leg records (zones' table
    # branch at one shard's rows)
    block = (capturing(captured, f"serving {config} build",
                       only=lambda key: key.endswith(f"/n={shard_rows}"))
             if config == "zones" else contextlib.nullcontext())
    t0 = time.perf_counter()
    with block:
        order, columns, first = _serve_query(rpc, names, config)
        check_result(config, order, columns, want)
        routes = list(rpc.last_call_strategies["effective"].values())
        _wait(lambda: _settled(controller)
              and _ready_entry(controller, known) is not None, 300,
              f"the {config} rollup")
    build_wall = time.perf_counter() - t0
    if first["answer_source"] != "recompute" or routes != [
            heuristic_route(config)]:
        raise AssertionError(f"serving {config}: first query {first}, "
                             f"routes {routes}")
    entry = _ready_entry(controller, known)
    build_s = _build_seconds(controller, seq, entry.key)
    launched = _launch_delta(before)
    query_launches = route_launches(config, parts, routes)
    builds = {k: v - query_launches.get(k, 0) for k, v in launched.items()
              if v - query_launches.get(k, 0)}
    kernel, branch = CONFIG_KERNEL[config]
    messages = _flight_since(controller, seq, "dispatch", verb="rollup")
    built = _flight_since(worker, wseq, "rollup_build", mode="rebuild")
    if (len(messages) != SHARDS or len(built) != SHARDS or sorted(m["filename"] for m in messages)
            != sorted(names)
            or any(launched.get(k, 0) < v for k, v in query_launches.items())
            or sum(builds.values()) != SHARDS
            or any(not k.startswith(f"{kernel}/{branch}/")
                   or not k.endswith(f"/n={shard_rows}") for k in builds)):
        raise AssertionError(
            f"serving {config}: {len(messages)} rollup messages, launched "
            f"{launched}, the query's {query_launches}")
    if set(entry.view["filenames"]) != set(names) or any(
            i["mode"] != "rebuild" for i in entry.per_file.values()):
        raise AssertionError(f"serving {config}: entry {entry.snapshot()}")
    served = []
    dispatched_shards = controller.counters["dispatched_shards"]
    for rep in range(SERVE_WARM):
        before = dict(onehot.LAUNCHES)
        order, columns, q = _serve_query(rpc, names, config)
        check_result(config, order, columns, want)
        if (q["answer_source"] != "rollup" or q["subsumed_from"] != entry.key
                or _launch_delta(before)
                or controller.counters["dispatched_shards"]
                != dispatched_shards):
            raise AssertionError(
                f"served {config} query {rep}: {q}, launched "
                f"{_launch_delta(before)}")
        served.append(q)
    dispatched = []
    with _env_set({"BQUERYD_TPU_SERVE": "0"}):
        for rep in range(SERVE_WARM):
            before = dict(onehot.LAUNCHES)
            order, columns, q = _serve_query(rpc, names, config)
            check_result(config, order, columns, want)
            routes = list(rpc.last_call_strategies["effective"].values())
            launched = _launch_delta(before)
            if (q["answer_source"] != "recompute"
                    or routes != [heuristic_route(config)]
                    or launched != route_launches(config, parts, routes)):
                raise AssertionError(
                    f"dispatched {config} query {rep}: {q}, routes "
                    f"{routes}, launched {launched}")
            q.update(_reply_split(rpc, q["wall_s"]), routes=routes,
                     launched=launched)
            dispatched.append(q)
    out = {
        "entry": entry.key,
        "groups": len(want),
        "first": first,
        "build": {"messages": len(messages),
                  "worker_builds": len(built),
                  "launches": builds,
                  "wall_s": build_wall,
                  "dispatch_to_ready_s": build_s,
                  # the worker's wall of each rollup message (its flight
                  # ring's work_done events)
                  "worker_walls_s": [e["wall_s"] for e in _flight_since(
                      worker, wseq, "work_done", verb="rollup")],
                  "group_rows": entry.group_rows(),
                  "bytes": entry.nbytes},
        "served": served,
        "dispatched": dispatched,
        "served_median": _walls(served),
        "dispatched_median": _walls(dispatched),
    }
    out["served_over_dispatched_wall"] = (
        out["served_median"]["wall_s"] / out["dispatched_median"]["wall_s"])
    return out


def _serve_folds(rpc, controller, names, parts, multikey_key, captured):
    """The multikey rollup's proofs: a VendorID groupby answered by a key
    fold ("subsume"), the multikey query under ``payment_type >= 1``
    answered by the zone proof ("rollup"), and under ``payment_type > 2``
    recomputed, with a ``filter-partial`` rejection recorded."""
    from bqueryd_tpu_torch.ops import onehot

    out = {}
    shard_rows = len(parts[0]["fare_amount"])
    for config, source in (("serve_vendor", "subsume"),
                           ("serve_zone_proof", "rollup"),
                           ("serve_partial", "recompute")):
        _wait(lambda: _settled(controller), 300, "settled rollups")
        want = reference(config, parts)
        before = dict(onehot.LAUNCHES)
        # the key fold's own view (VendorID alone: 2 groups) is built next
        # on the engine, a shape no other leg records
        block = (capturing(captured, "serving vendor build",
                           FLOAT_ROWS["multikey"],
                           only=lambda key: key.endswith(f"/n={shard_rows}"))
                 if config == "serve_vendor" else contextlib.nullcontext())
        with block:
            order, columns, q = _serve_query(rpc, names, config)
            if config == "serve_vendor":
                _wait(lambda: _settled(controller), 300, "the fold's view")
        check_result(config, order, columns, want)
        # each query's own view is built too (heat 1): those rollup launches
        # may fall inside the wall, so only the dispatch's is held
        launched = _launch_delta(before)
        dispatch = (expected_launches("multikey", parts)
                    if source == "recompute" else {})
        if (q["answer_source"] != source
                or (source != "recompute"
                    and q["subsumed_from"] != multikey_key)
                or any(launched.get(k, 0) < v for k, v in dispatch.items())):
            raise AssertionError(f"serving {config}: {q}, launched "
                                 f"{launched}, expected {source} from "
                                 f"{multikey_key}")
        q.update(groups=len(want), launched=launched)
        out[config] = q
    rejected = [r for d in list(controller.serving.decisions)
                for r in d["rejected"]]
    if ["filter-partial:payment_type"] != sorted(
            {r[1] for r in rejected if r[1].startswith("filter-partial")}):
        raise AssertionError(f"no filter-partial rejection: {rejected}")
    _wait(lambda: _settled(controller), 300, "settled rollups")
    return out


def _serve_kill_switch(rpc, controller, names, parts):
    """``sharded`` under ``BQUERYD_TPU_SERVE=0`` recomputes on the card
    (its dispatch launch), and is served again at 1 (no launch)."""
    from bqueryd_tpu_torch.ops import onehot

    want = reference("sharded", parts)
    out = {}
    for value, source in (("0", "recompute"), ("1", "rollup")):
        with _env_set({"BQUERYD_TPU_SERVE": value}):
            before = dict(onehot.LAUNCHES)
            order, columns, q = _serve_query(rpc, names, "sharded")
            check_result("sharded", order, columns, want)
            launched = _launch_delta(before)
            expect = (expected_launches("sharded", parts) if value == "0"
                      else {})
            if q["answer_source"] != source or launched != expect:
                raise AssertionError(f"kill switch {value}: {q}, launched "
                                     f"{launched}")
            out[f"serve={value}"] = dict(q, launched=launched)
    if controller.serving.snapshot()["enabled"] is not True:
        raise AssertionError("serving stayed off")
    return out


def _serve_bundle(rpc, controller, worker):
    """``rpc.debug_bundle()`` and ``rpc.metrics()`` after the leg."""
    bundle = rpc.debug_bundle()
    section = bundle["controller"]
    serving = section["serving"]
    kinds = {e["kind"] for e in controller.flight.events()}
    text = rpc.metrics()
    worker_slice = bundle["workers"][worker.worker_id]["snapshot"]
    checks = {
        "schema": bundle["schema"] == "bqueryd_tpu.debug_bundle/4",
        "served": serving["served"] >= 1,
        "ready": any(e["state"] == "ready"
                     for e in serving["rollups"]["entries"]),
        "flight": {"rollup_dispatch", "rollup_materialized",
                   "serve_decision"} <= kinds,
        "metrics": 'bqueryd_tpu_serve_answers_total{source="rollup"}' in text,
        "device_health": worker_slice.get("device_health", {}).get(
            "wedged") == 0,
        "lint": controller.metrics.lint() == [] and worker.metrics.lint()
        == [],
    }
    if not all(checks.values()):
        raise AssertionError(f"debug bundle: {checks}")
    answers = {line.split()[0]: float(line.split()[1])
               for line in text.splitlines()
               if line.startswith("bqueryd_tpu_serve_answers_total")}
    return {"checks": checks, "bytes": len(json.dumps(bundle)),
            "flight_events": len(section["flight"]),
            "flight_evictions": section["flight_evictions"],
            "entries": [{k: e[k] for k in ("key", "state", "keys", "hits",
                                             "bytes", "group_rows")}
                        for e in serving["rollups"]["entries"]],
            "answers": answers}


def _serve_append(scratch, captured):
    """An append under a rollup, on bench.py's ingest deployment (2M rows
    in 4 shards of its own, its own cluster): the ingest query
    materialized (4 builds) and served; one append of a 24th of a shard to
    each shard, with the controller's heartbeat held so that every shard
    has grown before the entry refreshes; the repeat query ("recompute",
    "cached" or "delta") exact against the concatenated frames; the
    heartbeat's refresh of the stale entry (one ``rollup`` refresh per
    shard, mode "delta", one launch over each shard's appended rows);
    once the grown stats are advertised, the query served again, exact."""
    from bqueryd_tpu_torch.ops import onehot

    base_dir = tempfile.mkdtemp(prefix="serve_ingest_", dir=scratch)
    store = tempfile.mkdtemp(prefix="store_", dir=base_dir)
    frames, _chunklen, rng = write_ingest(base_dir, INGEST_ROWS,
                                          INGEST_SHARDS)
    names = sorted(frames)
    per = INGEST_ROWS // INGEST_SHARDS
    append_rows = per // 24
    report = {}
    rpc, controller, worker, threads = _start_cluster(base_dir, store)
    try:
        def stats_rows(rows):
            return all((controller.shard_stats.get(n) or {}).get("rows")
                       == rows for n in names)

        def query():
            before = dict(onehot.LAUNCHES)
            (order, columns), wall = _timed(lambda: rpc.groupby(
                names, ["g"], INGEST_AGGS, []))
            check_ingest(order, columns, ingest_reference(frames))
            return {"answer_source": rpc.last_call_answer_source,
                    "subsumed_from": rpc.last_call_subsumed_from,
                    "wall_s": wall, "reply_bytes": rpc.last_call_reply_bytes,
                    "launched": _launch_delta(before)}

        _wait(lambda: stats_rows(per), 60, "the ingest shards' stats")
        before = dict(onehot.LAUNCHES)
        with capturing(captured, "serving ingest build", INGEST_FLOAT_ROWS,
                       only=lambda key: key.endswith(f"/n={per}")):
            report["first"] = query()
            _wait(lambda: _settled(controller)
                  and _ready_entry(controller, set()) is not None, 120,
                  "the ingest rollup")
        builds = {k: v for k, v in _launch_delta(before).items()
                  if k.endswith(f"/n={per}")}
        report["build_launches"] = builds
        if sum(builds.values()) != INGEST_SHARDS:
            raise AssertionError(f"ingest rollup builds launched {builds}")
        entry = _ready_entry(controller, set())
        report["served"] = query()
        if (report["first"]["answer_source"] != "recompute"
                or report["served"]["answer_source"] != "rollup"
                or report["served"]["launched"]):
            raise AssertionError(f"ingest rollup: {report}")
        refreshes = controller.counters["rollup_refreshes"]
        seq = worker.flight.seq
        # hold the heartbeat (and with it the refresh) until every shard
        # has grown
        controller.heartbeat_interval = 3600.0
        for name in names:
            extra = _ingest_frame(rng, append_rows, per)
            frames[name] = {c: np.concatenate([frames[name][c], extra[c]])
                            for c in extra}
            res = rpc.append(name, extra)
            if res["appended"] != append_rows:
                raise AssertionError(f"append {name}: {res}")
        if entry.state != "stale":
            raise AssertionError(f"the appended rollup is {entry.state}")
        report["repeat"] = query()
        if report["repeat"]["answer_source"] not in ("recompute", "cached",
                                                     "delta"):
            raise AssertionError(f"after the append: {report['repeat']}")
        before = dict(onehot.LAUNCHES)
        cseq = controller.flight.seq
        controller.heartbeat_interval = 0.5
        controller.last_heartbeat = 0.0
        _wait(lambda: _settled(controller) and controller.counters[
            "rollup_refreshes"] - refreshes >= INGEST_SHARDS, 120,
            "the delta refresh")
        report["refresh_s"] = _build_seconds(controller, cseq, entry.key)
        report["refresh_worker_walls_s"] = [
            e["wall_s"] for e in _flight_since(worker, seq, "work_done",
                                               verb="rollup")]
        tail = _launch_delta(before)
        modes = {f: i["mode"] for f, i in entry.per_file.items()}
        deltas = _flight_since(worker, seq, "rollup_build", mode="delta")
        if (set(modes.values()) != {"delta"}
                or sorted(e["filename"] for e in deltas) != names
                or sum(tail.values()) != INGEST_SHARDS
                or any(not k.endswith(f"/n={append_rows}") for k in tail)):
            raise AssertionError(f"refresh: modes {modes}, launched {tail}, "
                                 f"{len(deltas)} delta builds")
        report["refresh"] = {"modes": modes, "launched": tail,
                             "refreshes": controller.counters[
                                 "rollup_refreshes"] - refreshes}
        _wait(lambda: stats_rows(per + append_rows), 60,
              "the grown shards' stats")
        report["after"] = query()
        if (report["after"]["answer_source"] != "rollup"
                or report["after"]["subsumed_from"] != entry.key
                or report["after"]["launched"]):
            raise AssertionError(f"after the refresh: {report['after']}")
        report["counters"] = {k: controller.counters[k] for k in (
            "rollup_builds", "rollup_refreshes", "rollup_evictions")}
    finally:
        _stop_cluster(rpc, controller, worker, threads)
        shutil.rmtree(base_dir, ignore_errors=True)
    return report


def serving_summary(report):
    """The serving line: per config the served and dispatched medians
    (wall, reply bytes, client merge), the build's messages and launches;
    the folds' sources and walls, the kill switch, the append under a
    rollup, the counters and the bundle's checks."""
    configs = {}
    for config, r in report["configs"].items():
        configs[config] = {
            "groups": r["groups"],
            "served": r["served_median"],
            "dispatched": r["dispatched_median"],
            "served_over_dispatched_wall": r["served_over_dispatched_wall"],
            "build_messages": r["build"]["messages"],
            "build_launches": r["build"]["launches"],
            "build_wall_s": r["build"]["wall_s"],
            "build_dispatch_to_ready_s": r["build"]["dispatch_to_ready_s"],
            "build_worker_walls_s": r["build"]["worker_walls_s"],
            "entry_bytes": r["build"]["bytes"],
        }
    append = report["append"]
    return {
        "configs": configs,
        "folds": {k: {f: v[f] for f in ("answer_source", "wall_s",
                                        "reply_bytes", "client_merge_s")}
                  for k, v in report["folds"].items()},
        "kill_switch": {k: v["answer_source"]
                        for k, v in report["kill_switch"].items()},
        "append": {"build_launches": append["build_launches"],
                   "repeat": append["repeat"]["answer_source"],
                   "refresh": append["refresh"],
                   "refresh_s": append["refresh_s"],
                   "refresh_worker_walls_s": append["refresh_worker_walls_s"],
                   "after": append["after"]["answer_source"]},
        "counters": {k: report["counters"][k] for k in (
            "rollup_builds", "rollup_refreshes", "rollup_evictions",
            "dispatched_shards")},
        "answers": report["bundle"]["answers"],
        "bundle": report["bundle"]["checks"],
    }


def run_serving_path(names, parts, data_dir, store_dir, scratch, captured):
    """The serving layer on a cluster of its own over the taxi shards
    (``SERVE_ENV``): per config of ``SERVE_CONFIGS`` the rollup built from
    the first query and served against dispatched warm queries
    (:func:`_serve_config`); multikey's key fold, zone proof and partial
    filter (:func:`_serve_folds`); the kill switch; the debug bundle and
    the metrics; then an append under a rollup on the ingest deployment
    (:func:`_serve_append`).  Any logged serving error, fold failure,
    ``render-error`` decision or failed build fails the leg."""
    import bqueryd_tpu_torch

    failures = _serve_failures()
    bqueryd_tpu_torch.logger.addHandler(failures)
    report = {"configs": {}}
    try:
        with _env_set(SERVE_ENV):
            rpc, controller, worker, threads = _start_cluster(data_dir,
                                                              store_dir)
            try:
                _wait(lambda: all((controller.shard_stats.get(n) or {}).get(
                    "rows") for n in names), 60, "the shards' stats")
                for config in SERVE_CONFIGS:
                    report["configs"][config] = _serve_config(
                        rpc, controller, worker, names, parts, config,
                        captured)
                    log(f"serving {config}: "
                        f"{json.dumps(report['configs'][config])}")
                report["folds"] = _serve_folds(
                    rpc, controller, names, parts,
                    report["configs"]["multikey"]["entry"], captured)
                report["kill_switch"] = _serve_kill_switch(
                    rpc, controller, names, parts)
                report["bundle"] = _serve_bundle(rpc, controller, worker)
                report["counters"] = dict(controller.counters)
                failed = [e for e in controller.flight.events()
                          if e["kind"] == "rollup_build_failed"]
                render_errors = [d for d in list(controller.serving.decisions)
                                 if any(r[1] == "render-error"
                                        for r in d["rejected"])]
                if failed or render_errors:
                    raise AssertionError(f"failed builds {failed}, render "
                                         f"errors {render_errors}")
            finally:
                _stop_cluster(rpc, controller, worker, threads)
            report["append"] = _serve_append(scratch, captured)
        if failures.records:
            raise AssertionError(f"serving errors: {failures.records}")
    finally:
        bqueryd_tpu_torch.logger.removeHandler(failures)
    return report


# -- the resilience leg -------------------------------------------------------

#: the resilience leg's controller timeouts (seconds): short, so that each
#: failover completes within a few seconds
RES_TIMEOUTS = {"dispatch_timeout": 2.0, "dispatch_hard_timeout": 3.0,
                "dead_worker_timeout": 3.0}
RES_CONFIGS = ("sharded", "zones")
RES_KERNELS = (("onehot_rows_dot", "mma"), ("onehot_rows_dot", "table"))
RES_COUNTERS = ("dispatched_shards", "failover_dispatches",
                "transient_faults", "hedged_dispatches", "hedge_wins",
                "duplicate_replies", "health_avoided_dispatches",
                "plan_bundles", "plan_bundled_queries")
#: the controller's flight events that make up a scenario's attempt
#: history
RES_EVENTS = ("dispatch", "transient_fault", "dispatch_timeout",
              "hedged_dispatch", "hedge_win", "hedge_loss",
              "stale_reply_dropped", "worker_removed", "worker_wedged")
RES_HEDGE_MS = 200.0
RES_DELAY_S = 1.5
RES_BATCH_WINDOW_MS = "400"


class _ThreadLaunches(collections.Counter):
    """``onehot.LAUNCHES`` with a per-thread tally beside it, so that the
    launches of several in-process workers are told apart: each wrapper
    still adds one per launch, and the tally records which node's loop
    thread made it."""

    def __init__(self):
        self.by_thread = collections.Counter()
        super().__init__()

    def __setitem__(self, key, value):
        added = value - self.get(key, 0)
        super().__setitem__(key, value)
        if added > 0:
            self.by_thread[(threading.current_thread().name, key)] += added

    def clear(self):
        super().clear()
        self.by_thread.clear()


class _Resilience:
    """The resilience leg's cluster: one controller and calc workers on
    cuda over ONE data_dir (every shard has every worker as a holder), as
    named threads of this process, with per-worker launch tallies."""

    def __init__(self, names, data_dir, store_dir, tally):
        import logging

        from bqueryd_tpu_torch.controller import ControllerNode
        from bqueryd_tpu_torch.rpc import RPC

        self.names = names
        self.data_dir = data_dir
        self.url = f"file://{store_dir}"
        self.tally = tally
        self.quiet = logging.WARNING
        self.controller = ControllerNode(
            coordination_url=self.url, loglevel=self.quiet,
            runfile_dir=store_dir, heartbeat_interval=0.5, **RES_TIMEOUTS)
        self.threads = [threading.Thread(target=self.controller.go,
                                         name="controller", daemon=True)]
        self.threads[0].start()
        self.workers = {}  # label -> WorkerNode
        for label in ("w1", "w2"):
            self.add_worker(label)
        self.rpc = RPC(coordination_url=self.url, timeout=120, retries=1,
                       loglevel=self.quiet)

    def add_worker(self, label):
        from bqueryd_tpu_torch.worker import WorkerNode

        worker = WorkerNode(coordination_url=self.url,
                            data_dir=self.data_dir, loglevel=self.quiet,
                            heartbeat_interval=0.5, poll_timeout=0.05,
                            n_devices=1)
        thread = threading.Thread(target=worker.go, name=label, daemon=True)
        self.workers[label] = worker
        self.threads.append(thread)
        thread.start()
        _wait(lambda: all(worker.worker_id in self.controller.files_map.get(
            n, ()) for n in self.names), 120, f"{label}'s registration")
        return worker

    def label_of(self, worker_id):
        return next((label for label, w in self.workers.items()
                     if w.worker_id == worker_id), worker_id)

    def stop(self):
        self.rpc._close_socket()
        for node in [self.controller] + list(self.workers.values()):
            node.running = False
        for t in self.threads:
            t.join(timeout=20)
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("a resilience node did not stop")

    # -- measurement ---------------------------------------------------------
    def snapshot(self):
        return {"counters": {k: self.controller.counters[k]
                             for k in RES_COUNTERS},
                "seq": self.controller.flight.seq,
                "tally": dict(self.tally.by_thread)}

    def since(self, snap):
        """Counter deltas, the attempt history (the controller's flight
        events, workers by label) and the launches per worker and shape
        since ``snap``."""
        counters = {k: self.controller.counters[k] - snap["counters"][k]
                    for k in RES_COUNTERS}
        attempts = []
        for e in self.controller.flight.events():
            if e["seq"] <= snap["seq"] or e["kind"] not in RES_EVENTS:
                continue
            entry = {"kind": e["kind"]}
            for k in ("worker", "token", "winner", "loser", "original",
                      "error", "age_s", "hard"):
                if e.get(k) is not None:
                    entry[k] = (self.label_of(e[k])
                                if k in ("worker", "winner", "loser",
                                         "original") else e[k])
            attempts.append(entry)
        launches = {}
        for (thread, key), n in self.tally.by_thread.items():
            added = n - snap["tally"].get((thread, key), 0)
            if added:
                per = launches.setdefault(thread, {})
                per[shape_key(*key)] = added
        return counters, attempts, launches

    def query(self, config, rpc=None, where=None):
        """One checked query of ``config`` (``where`` replaces its
        filter); its wall."""
        sl, gcols, aggs, own_where = CONFIGS[config]
        t0 = time.perf_counter()
        order, columns = (rpc or self.rpc).groupby(
            self.names[sl], gcols, aggs,
            own_where if where is None else where)
        wall = time.perf_counter() - t0
        check_result(config, order, columns, self.want[config])
        return wall

    def _dispatch_state(self, box):
        """What a pinned query's missing dispatch waits on: the queues,
        the workers' busy flags and health, the work in flight."""
        ctl = self.controller
        return {
            "box": {k: repr(v)[:300] for k, v in box.items()},
            "queued": {str(k): len(v)
                       for k, v in ctl.worker_out_messages.items()},
            "workers": {self.label_of(w): {"busy": i.get("busy"),
                                           "hb_only": i.get("hb_only")}
                        for w, i in ctl.worker_map.items()},
            "inflight": len(ctl.inflight),
            "health": {self.label_of(w): s.get("status")
                       for w, s in ctl.health.statuses().items()},
            "admission": ctl.admission.stats(),
        }

    def pinned(self, label, config):
        """Start ``config``'s query with every other live holder marked
        busy, so that its first dispatch goes to worker ``label``; release
        the others once that dispatch is in flight.  Returns the query's
        thread and its result box."""
        target = self.workers[label].worker_id
        others = [w.worker_id for w in self.workers.values()
                  if w.worker_id != target
                  and w.worker_id in self.controller.worker_map]
        def hold_others():
            # a registration replaces a worker's entry from the loop
            # thread, so the mark is set again on every poll
            for wid in others:
                info = self.controller.worker_map.get(wid)
                if info is not None:
                    info["busy"] = True

        hold_others()
        seq = self.controller.flight.seq
        box = {}

        def run():
            try:
                box["wall"] = self.query(config)
            except Exception as exc:  # surfaced by the caller
                box["error"] = exc

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        try:
            # polled every millisecond: a fault that fails at once is
            # retried after a backoff of 50 ms or more, which must find
            # the other holders free again, or it lands on ``label`` anew
            _wait(lambda: hold_others() or "error" in box or _flight_since(
                self.controller, seq, "dispatch", worker=target), 60,
                f"the dispatch to {label}", interval=0.001,
                state=lambda: self._dispatch_state(box))
            if "error" in box:
                raise AssertionError(
                    f"the query pinned to {label} failed before its "
                    f"dispatch: {box['error']!r}") from box["error"]
        finally:
            for wid in others:
                info = self.controller.worker_map.get(wid)
                if info is not None:
                    info["busy"] = False
        return thread, box


def _joined(thread, box, what, timeout=120):
    thread.join(timeout)
    if thread.is_alive():
        raise AssertionError(f"{what}: the query did not finish")
    if "error" in box:
        raise AssertionError(f"{what}: {box['error']!r}") from box["error"]
    return box["wall"]


def _per_worker_total(launches):
    return {w: sum(v.values()) for w, v in launches.items()}


def _by_shape(launches):
    """Launches per shape key over every worker."""
    out = collections.Counter()
    for per in launches.values():
        out.update(per)
    return dict(out)


def _times(shapes, k):
    """``k`` queries' launches of each {shape: launches} in ``shapes``."""
    out = collections.Counter()
    for per in shapes:
        out.update({key: n * k for key, n in per.items()})
    return dict(out)


def _expect(cond, what, detail):
    if not cond:
        raise AssertionError(f"resilience {what}: {json.dumps(detail)}")


def run_resilience_path(names, parts, data_dir, store_dir):
    """The resilience layer on a cluster of its own: one port controller
    with short timeouts (``RES_TIMEOUTS``) and two calc workers on cuda
    over the SAME data_dir, so that every shard has two holders; sharded
    (``mma``) and zones (``table``), each answer checked against NumPy.
    Each scenario arms one fault plan, matched by worker where its site
    knows the worker, and disarms in a ``finally``:

    1. clean: each holder warmed, then 3 queries per config (the walls and
       launches the others are held to);
    2. transient: ``worker.device`` raises ``DeviceBusyError`` on each
       query's first attempt: one failover per query to the other holder,
       launches as clean's (the failed attempt launched nothing);
    3. hedge: ``hedge_ms`` 200 and a 1.5 s ``worker.execute`` delay on the
       first holder: a hedge win per query, the slow reply deduplicated,
       launches twice clean's;
    4. dropped reply: ``worker.reply`` drops the first holder's reply
       once: recovered after the hard timeout (the worker is alive and
       removed), launches twice clean's;
    5. bundle: a 400 ms window, two compatible queries and a transient
       fault on the first holder: the bundle fails over whole, under one
       token, both members exact;
    6. exhaustion: ``worker.device`` raises on every attempt: the client
       gets ``DispatchExhausted`` with attempts naming both workers, and
       nothing launches;
    7. die after ack: the first holder dies after its Busy: recovered by
       the dead-worker cull and the dispatch timeout (``worker_removed``
       in the flight ring); a third worker then joins;
    8. wedge: a ``wedge`` on one live worker: its WRM advertises
       ``backend_wedged``, ``rpc.health()`` lists it as wedged, queries
       go to the other holder (``health_avoided_dispatches``) and it
       launches nothing after the latch; the process-global device latch
       stays clear.

    Every scenario prints one ``resilience`` line (walls, counter deltas,
    attempt history, launches per worker and shape)."""
    from bqueryd_tpu_torch import chaos
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.rpc import RPC, RPCError
    from bqueryd_tpu_torch.utils import devicehealth

    tally = _ThreadLaunches()
    saved = onehot.LAUNCHES
    onehot.LAUNCHES = tally
    report = {}
    cluster = None
    try:
        cluster = _Resilience(names, data_dir, store_dir, tally)
        cluster.want = {c: reference(c, parts) for c in RES_CONFIGS}
        ctl = cluster.controller
        one = {c: expected_launches(c, parts) for c in RES_CONFIGS}

        def record(name, walls, snap, **extra):
            counters, attempts, launches = cluster.since(snap)
            report[name] = dict(walls=walls, counters=counters,
                                attempts=attempts, launches=launches,
                                **extra)
            print(json.dumps({"resilience": name, **report[name]}),
                  flush=True)
            return counters, attempts, launches

        def arm(spec):
            chaos.arm(dict(spec, seed=11))

        # 1. clean: each holder warmed (cold walls), then free placement
        snap = cluster.snapshot()
        cold = {}
        for label in ("w1", "w2"):
            for config in RES_CONFIGS:
                thread, box = cluster.pinned(label, config)
                cold[f"{label} {config}"] = _joined(thread, box,
                                                    f"cold {config}")
        warm_snap = cluster.snapshot()
        walls = {c: [cluster.query(c) for _ in range(3)]
                 for c in RES_CONFIGS}
        _c, _a, warm_launches = cluster.since(warm_snap)
        record("clean", walls, snap, cold_walls=cold,
               warm_launches=warm_launches)
        _expect(_by_shape(warm_launches) == _times(one.values(), 3),
                "clean launches", warm_launches)

        # 2. transient: every query's first attempt raises on the device
        snap = cluster.snapshot()
        try:
            arm({"faults": [{"site": "worker.device", "action": "raise",
                             "args": {"error": "DeviceBusyError"},
                             "every": 2, "times": len(RES_CONFIGS)}]})
            walls = {c: cluster.query(c) for c in RES_CONFIGS}
        finally:
            chaos.disarm()
        counters, attempts, launches = record("transient", walls, snap)
        _expect(counters["transient_faults"] == len(RES_CONFIGS)
                and counters["failover_dispatches"] == len(RES_CONFIGS),
                "transient counters", counters)
        for fault in (a for a in attempts if a["kind"] == "transient_fault"):
            sent = [a["worker"] for a in attempts
                    if a["kind"] == "dispatch"
                    and a.get("token") == fault["token"]]
            _expect(len(sent) == 2 and sent[0] == fault["worker"]
                    and sent[1] != sent[0], "transient retry", attempts)
        _expect(_by_shape(launches) == _times(one.values(), 1),
                "transient launches", launches)

        # 3. hedge: the first holder answers late, the hedge wins
        snap = cluster.snapshot()
        slow = cluster.workers["w1"].worker_id
        walls = {}
        try:
            ctl.hedge_ms = RES_HEDGE_MS
            arm({"faults": [{"site": "worker.execute", "action": "delay",
                             "args": {"seconds": RES_DELAY_S},
                             "match": {"worker": slow, "verb": "groupby"}}]})
            for config in RES_CONFIGS:
                dups = ctl.counters["duplicate_replies"]
                thread, box = cluster.pinned("w1", config)
                walls[config] = _joined(thread, box, f"hedge {config}")
                _wait(lambda: ctl.counters["duplicate_replies"] > dups, 30,
                      "the slow reply's dedup")
        finally:
            chaos.disarm()
            ctl.hedge_ms = 0.0
        counters, attempts, launches = record("hedge", walls, snap)
        n = len(RES_CONFIGS)
        _expect(counters["hedged_dispatches"] == n
                and counters["hedge_wins"] == n
                and counters["duplicate_replies"] == n, "hedge counters",
                counters)
        _expect(_per_worker_total(launches) == {"w1": n, "w2": n}
                and _by_shape(launches) == _times(one.values(), 2),
                "hedge launches", launches)

        # 4. a dropped reply, recovered after the hard timeout
        snap = cluster.snapshot()
        try:
            arm({"faults": [{"site": "worker.reply", "action": "drop",
                             "match": {"worker": slow, "verb": "groupby"},
                             "times": 1}]})
            thread, box = cluster.pinned("w1", "sharded")
            walls = {"sharded": _joined(thread, box, "dropped reply")}
        finally:
            chaos.disarm()
        counters, attempts, launches = record("dropped_reply", walls, snap)
        _expect(counters["failover_dispatches"] == 1
                and any(a["kind"] == "dispatch_timeout" and a.get("hard")
                        for a in attempts), "dropped-reply recovery",
                attempts)
        _expect(_per_worker_total(launches) == {"w1": 1, "w2": 1}
                and _by_shape(launches) == _times([one["sharded"]], 2),
                "dropped-reply launches", launches)
        # the removed (live) worker registers again
        _wait(lambda: all(slow in ctl.files_map.get(n, ()) for n in names)
              and not ctl.worker_map.get(slow, {}).get("hb_only"), 60,
              "the removed worker's return")

        # 5. a bundle fails over whole on a transient fault
        snap = cluster.snapshot()
        try:
            with _env_set({"BQUERYD_TPU_BATCH_WINDOW_MS":
                           RES_BATCH_WINDOW_MS}):
                arm({"faults": [{"site": "worker.execute", "action": "raise",
                                 "args": {"error": "DeviceBusyError"},
                                 "match": {"worker": slow,
                                           "verb": "groupby"},
                                 "times": 1}]})
                other = cluster.workers["w2"].worker_id
                ctl.worker_map[other]["busy"] = True
                boxes = [{}, {}]
                clients = []
                for box, op in zip(boxes, (">", ">=")):
                    client = RPC(coordination_url=cluster.url, timeout=120,
                                 retries=1, loglevel=cluster.quiet)
                    clients.append(client)

                    def run(box=box, op=op, client=client):
                        try:
                            box["wall"] = cluster.query(
                                "sharded", rpc=client,
                                where=[["fare_amount", op, 0]])
                        except Exception as exc:
                            box["error"] = exc

                    box["thread"] = threading.Thread(target=run, daemon=True)
                    box["thread"].start()
                try:
                    _wait(lambda: _flight_since(ctl, snap["seq"], "dispatch",
                                                worker=slow), 60,
                          "the bundle's dispatch to w1")
                finally:
                    ctl.worker_map[other]["busy"] = False
                walls = {f"member {i}": _joined(b["thread"], b,
                                                f"bundle member {i}")
                         for i, b in enumerate(boxes)}
                for client in clients:
                    client._close_socket()
        finally:
            chaos.disarm()
        counters, attempts, launches = record("bundle", walls, snap)
        sent = [a for a in attempts if a["kind"] == "dispatch"]
        _expect(counters["plan_bundles"] == 1
                and counters["plan_bundled_queries"] == 2
                and counters["transient_faults"] == 1
                and counters["failover_dispatches"] == 1
                and len(sent) == 2 and sent[0]["token"] == sent[1]["token"]
                and [a["worker"] for a in sent] == ["w1", "w2"],
                "bundle failover", {"counters": counters,
                                    "attempts": attempts})
        _expect(_per_worker_total(launches) == {"w2": 2}
                and _by_shape(launches) == _times([one["sharded"]], 2),
                "bundle launches", launches)

        # 6. exhaustion: every attempt faults
        snap = cluster.snapshot()
        t0 = time.perf_counter()
        try:
            arm({"faults": [{"site": "worker.device", "action": "raise",
                             "args": {"error": "DeviceBusyError"}}]})
            try:
                cluster.query("sharded")
            except RPCError as exc:
                error = exc
            else:
                raise AssertionError("exhaustion: the query answered")
        finally:
            chaos.disarm()
        walls = {"sharded": time.perf_counter() - t0}
        counters, attempts, launches = record(
            "exhaustion", walls, snap, error_class=error.error_class,
            client_attempts=[dict(a, worker=cluster.label_of(a["worker"]))
                             for a in error.attempts])
        _expect(error.error_class == "DispatchExhausted"
                and len(error.attempts) == ctl.max_dispatch_retries + 1
                and {a["worker"] for a in error.attempts}
                == {w.worker_id for w in cluster.workers.values()}
                and not launches, "exhaustion",
                {"error": str(error), "launches": launches})

        # 7. die after ack, then a third worker joins
        snap = cluster.snapshot()
        dead = cluster.workers["w1"]
        try:
            arm({"faults": [{"site": "worker.execute",
                             "action": "die_after_ack",
                             "match": {"worker": dead.worker_id,
                                       "verb": "groupby"},
                             "times": 1}]})
            thread, box = cluster.pinned("w1", "sharded")
            walls = {"sharded": _joined(thread, box, "die after ack")}
        finally:
            chaos.disarm()
        _wait(lambda: _flight_since(ctl, snap["seq"], "worker_removed",
                                    worker=dead.worker_id), 30,
              "the dead worker's cull")
        t0 = time.perf_counter()
        cluster.add_worker("w3")
        walls["w3_join"] = time.perf_counter() - t0
        counters, attempts, launches = record("die_after_ack", walls, snap)
        _expect(counters["failover_dispatches"] == 1
                and dead.worker_id not in ctl.worker_map
                and not dead.running, "die-after-ack recovery", attempts)
        _expect(_by_shape(launches) == _times([one["sharded"]], 1)
                and list(launches) == ["w2"], "die-after-ack launches",
                launches)

        # 8. a wedge on one live worker
        snap = cluster.snapshot()
        wedged = cluster.workers["w2"]
        try:
            arm({"faults": [{"site": "worker.execute", "action": "wedge",
                             "match": {"worker": wedged.worker_id,
                                       "verb": "groupby"},
                             "times": 1}]})
            thread, box = cluster.pinned("w2", "sharded")
            walls = {"failover": _joined(thread, box, "wedge failover")}
        finally:
            chaos.disarm()
        _wait(lambda: cluster.rpc.health()["workers"].get(
            wedged.worker_id, {}).get("status") == "wedged", 30,
            "rpc.health() listing the wedged worker")
        for config in RES_CONFIGS:
            walls[config] = [cluster.query(config) for _ in range(2)]
        health = cluster.rpc.health()
        counters, attempts, launches = record(
            "wedge", walls, snap,
            health={cluster.label_of(w): s["status"]
                    for w, s in health["workers"].items()},
            device_latch=devicehealth.health_snapshot())
        _expect(counters["transient_faults"] == 1
                and counters["failover_dispatches"] == 1
                and counters["health_avoided_dispatches"] >= 1
                and wedged._chaos_wedged
                and list(launches) == ["w3"]
                and _by_shape(launches) == _times(
                    [one["sharded"], one["sharded"], one["sharded"],
                     one["zones"], one["zones"]], 1)
                and devicehealth.health_snapshot()["wedged"] == 0
                and any(a["kind"] == "worker_wedged" for a in attempts),
                "wedge", {"counters": counters, "launches": launches})
    finally:
        chaos.disarm()
        onehot.LAUNCHES = saved
        saved.update(tally)
        if cluster is not None:
            cluster.stop()
    return report


#: the distribution leg: three download threads as the reference's
#: supervisor layout runs three downloaders a box, a ticket poll of 0.5 s
#: (the default is 5 s) so that the walls measure the pipeline, and the
#: seed of taxi_0's replacement data
DIST_THREADS = 3
DIST_POLL_S = 0.5
DIST_CONFIGS = ("sharded", "zones")
DIST_KERNELS = (("onehot_rows_dot", "mma"), ("onehot_rows_dot", "table"))
DIST_RESEED = 4242
DIST_BUCKET = "bcolz"
#: rows per block of the bcolz v1 writer's Blosc chunks
V1_BLOCK = 1 << 16
V1_CHUNKLEN = 1 << 16


def _v1_blosclz(plane):
    """A blosclz stream of one split stream (uint8 array) built with
    numpy: a constant plane as one literal byte and one distance-1 match
    (the format's run-length form), any other as literal runs of at most
    32 bytes."""
    n = len(plane)
    if n >= 10 and (plane == plane[0]).all():
        rest = n - 10  # the match copies n - 1 bytes: 3 + 6 + rest
        return bytes([0, int(plane[0]), 7 << 5]) + b"\xff" * (rest // 255) \
            + bytes([rest % 255, 0])
    full = n // 32 * 32
    runs = np.concatenate([np.full((full // 32, 1), 31, np.uint8),
                           plane[:full].reshape(-1, 32)], axis=1).reshape(-1)
    if n > full:
        runs = np.concatenate([runs, [n - full - 1], plane[full:]])
    return runs.astype(np.uint8).tobytes()


def _v1_chunk(data, typesize, memcpy=False):
    """One Blosc v1 chunk of ``data`` (bytes): memcpyed, or byte-shuffled
    per block with each full block's ``typesize`` split streams (one for
    the leftover block) blosclz-coded, each framed by its int32 size."""
    import struct

    nbytes = len(data)
    if memcpy:
        return struct.pack("<BBBBiii", 2, 1, 0x2, typesize, nbytes, nbytes,
                           16 + nbytes) + data
    raw = np.frombuffer(data, np.uint8)
    blocksize = min(V1_BLOCK, nbytes)
    nblocks = -(-nbytes // blocksize)
    streams = []
    for b in range(nblocks):
        block = raw[b * blocksize:(b + 1) * blocksize]
        full = len(block) == blocksize
        nsplits = typesize if (full and 1 < typesize <= 16
                               and len(block) // typesize >= 128) else 1
        if typesize > 1:
            nel = len(block) // typesize
            block = np.concatenate([
                block[:nel * typesize].reshape(nel, typesize).T.reshape(-1),
                block[nel * typesize:]])
        neblock = len(block) // nsplits
        parts = []
        for s in range(nsplits):
            piece = block[s * neblock:(s + 1) * neblock]
            comp = _v1_blosclz(piece)
            parts.append(struct.pack("<i", len(comp)) + comp)
        streams.append(b"".join(parts))
    starts, pos = [], 16 + 4 * nblocks
    for s in streams:
        starts.append(pos)
        pos += len(s)
    flags = 0x1 if typesize > 1 else 0
    header = struct.pack("<BBBBiii", 2, 1, flags, typesize, nbytes,
                         blocksize, pos)
    return (header + b"".join(struct.pack("<i", p) for p in starts)
            + b"".join(streams))


def write_v1_ctable(rootdir, cols, memcpy_col):
    """``cols`` as a bcolz v1 ctable rootdir (``__attrs__``, ``__cols__``,
    one carray per column with ``meta/sizes``, ``meta/storage`` and one
    Blosc chunk per ``V1_CHUNKLEN`` rows, the last one a leftover);
    ``memcpy_col`` is written memcpyed.  Returns the bytes written."""
    os.makedirs(rootdir)
    with open(os.path.join(rootdir, "__attrs__"), "w") as f:
        json.dump({"origin": "chip_smoke"}, f)
    with open(os.path.join(rootdir, "__cols__"), "w") as f:
        json.dump({"names": list(cols)}, f)
    written = 0
    for name, values in cols.items():
        values = np.ascontiguousarray(values)
        root = os.path.join(rootdir, name)
        os.makedirs(os.path.join(root, "meta"))
        os.makedirs(os.path.join(root, "data"))
        with open(os.path.join(root, "meta", "sizes"), "w") as f:
            json.dump({"shape": [len(values)], "nbytes": values.nbytes,
                       "cbytes": -1}, f)
        with open(os.path.join(root, "meta", "storage"), "w") as f:
            json.dump({"dtype": values.dtype.str, "chunklen": V1_CHUNKLEN,
                       "cparams": {"clevel": 5, "shuffle": 1,
                                   "cname": "blosclz"},
                       "dflt": 0, "expectedlen": len(values)}, f)
        nfull = len(values) // V1_CHUNKLEN
        for i in range(nfull + 1):
            piece = values[i * V1_CHUNKLEN:(i + 1) * V1_CHUNKLEN]
            if not len(piece):
                break
            fname = f"__{i}.blp" if i < nfull else "__leftover.blp"
            chunk = _v1_chunk(piece.tobytes(), values.dtype.itemsize,
                              memcpy=name == memcpy_col)
            with open(os.path.join(root, "data", fname), "wb") as f:
                f.write(chunk)
            written += len(chunk)
    return written


class _Distribution:
    """The distribution leg's nodes: one controller, one calc worker on
    cuda on an empty serving dir, one downloader (``DIST_THREADS``) and
    one mover on that dir, as threads of this process."""

    def __init__(self, store_dir, serving):
        import logging

        from bqueryd_tpu_torch.controller import ControllerNode
        from bqueryd_tpu_torch.rpc import RPC
        from bqueryd_tpu_torch.worker import (
            DownloaderNode,
            MoveBcolzNode,
            WorkerNode,
        )

        quiet = logging.WARNING
        self.url = f"file://{store_dir}"
        common = dict(coordination_url=self.url, data_dir=serving,
                      loglevel=quiet, heartbeat_interval=0.5,
                      poll_timeout=0.1)
        self.controller = ControllerNode(
            coordination_url=self.url, loglevel=quiet, runfile_dir=store_dir,
            heartbeat_interval=0.5)
        self.calc = WorkerNode(n_devices=1, **common)  # one card
        self.downloader = DownloaderNode(download_threads=DIST_THREADS,
                                         **common)
        self.mover = MoveBcolzNode(**common)
        for node in (self.downloader, self.mover):
            node.download_interval = DIST_POLL_S
        self.nodes = (self.controller, self.calc, self.downloader,
                      self.mover)
        self.threads = [threading.Thread(target=n.go, name=n.__class__
                                         .__name__, daemon=True)
                        for n in self.nodes]
        for t in self.threads:
            t.start()
        _wait(lambda: len(self.controller.worker_map) == 3, 120,
              "the distribution nodes' registration")
        self.rpc = RPC(coordination_url=self.url, timeout=600, retries=1,
                       loglevel=quiet)

    def stop(self):
        self.rpc._close_socket()
        for node in self.nodes:
            node.running = False
        for t in self.threads:
            t.join(timeout=20)
        if any(t.is_alive() for t in self.threads):
            raise AssertionError("a distribution node did not stop")


def _dist_download(cluster, blobs):
    """``rpc.download(wait=True)`` of ``blobs`` while another client polls
    ``rpc.downloads()``; returns (reply, wall, the distinct snapshots)."""
    import logging

    from bqueryd_tpu_torch.rpc import RPC

    watcher = RPC(coordination_url=cluster.url, timeout=60, retries=1,
                  loglevel=logging.WARNING)
    seen, done = [], threading.Event()

    def watch():
        while not done.is_set():
            snap = sorted(watcher.downloads())
            if snap and (not seen or seen[-1] != snap):
                seen.append(snap)
            done.wait(0.05)

    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        reply = cluster.rpc.download(filenames=blobs, bucket=DIST_BUCKET,
                                     scheme="localfs", wait=True)
    finally:
        wall = time.perf_counter() - t0
        done.set()
        thread.join(timeout=10)
        watcher._close_socket()
    return reply, wall, seen


def run_distribution_path(names, parts, data_dir, scratch, captured):
    """Dataset distribution and the bcolz v1 import on a cluster of its
    own, the reference's per-box layout (controller, calc worker on cuda,
    downloader with three threads, mover) over an empty serving dir, the
    object store a ``LocalFSBackend`` under ``build/``
    (``BQUERYD_TPU_BLOB_DIR``), the result cache off and the heuristic
    hints alone:

    1. each of the ten taxi shards zipped with ``zip_to_file`` and put
       into the blob store (zip time and bytes, outside the walls);
    2. one ``download(wait=True)`` ticket of the ten: "DONE", its wall,
       the wall until all ten are advertised, the bytes fetched,
       ``downloads()`` seen meanwhile, each shard's ``bqueryd.metadata``;
    3. sharded and zones, 1 cold + 3 warm each, exact, one ``mma`` or
       ``table`` launch each at the executor's shape; the first warm
       query's inputs captured for the kernel rows;
    4. taxi_0 distributed again under its name with data of another seed:
       sharded's next answer is the new data's, with one launch;
    5. a download of a blob the store lacks: the RPC raises the ticket's
       error and nothing is activated;
    6. taxi_0 written as a bcolz v1 ctable (shuffled blosclz streams,
       trip_distance memcpyed), imported into the serving dir by
       ``python -m bqueryd_tpu_torch.node import`` as a process (the
       native Blosc decoder, which the library must carry); single's
       query over it exact, one ``mma`` launch at one shard's shape;
    7. ``sleep``, ``readfile`` of a shard's meta.json, ``info`` with its
       ``replication`` and ``others``, then ``killall``: every node's loop
       ends within 5 s.

    Returns the ``distribution`` report."""
    from bqueryd_tpu_torch import download as dl
    from bqueryd_tpu_torch.blob import LocalFSBackend
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.rpc import RPCError
    from bqueryd_tpu_torch.storage import native
    from bqueryd_tpu_torch.utils.net import zip_to_file

    if not native.blosc_available():
        raise AssertionError("the native library lacks the Blosc decoder")
    root = tempfile.mkdtemp(prefix="dist_", dir=scratch)
    blob_root = os.path.join(root, "blobs")
    serving = os.path.join(root, "serving")
    store_dir = os.path.join(root, "store")
    zips = os.path.join(root, "zips")
    for d in (serving, store_dir, zips):
        os.makedirs(d)
    backend = LocalFSBackend(root=blob_root)
    report = {}
    captured_here = {}

    def put(shard_dir, name):
        path, _crc = zip_to_file(shard_dir, zips)
        size = os.path.getsize(path)
        backend.put(DIST_BUCKET, f"{name}.zip", path)
        os.remove(path)
        return size

    t0 = time.perf_counter()
    zip_bytes = {n: put(os.path.join(data_dir, n), n) for n in names}
    report["zip"] = {"s": time.perf_counter() - t0,
                     "bytes": sum(zip_bytes.values()),
                     "shards": len(zip_bytes)}
    cluster = None
    try:
        with _env_set({"BQUERYD_TPU_BLOB_DIR": blob_root}):
            cluster = _Distribution(store_dir, serving)
            ctl, rpc = cluster.controller, cluster.rpc
            reply, wall, seen = _dist_download(
                cluster, [f"{n}.zip" for n in names])
            t_reply = time.perf_counter()
            if reply != "DONE":
                raise AssertionError(f"download replied {reply!r}")
            _wait(lambda: all(n in ctl.files_map for n in names), 120,
                  "the ten activated shards advertised")
            activated = time.perf_counter() - t_reply
            metas = [json.load(open(os.path.join(serving, n,
                                                 dl.METADATA_FILENAME)))
                     for n in names]
            if len({m["ticket"] for m in metas}) != 1:
                raise AssertionError(f"activation metadata {metas}")
            report["download"] = {
                "reply": reply, "wall_s": wall,
                "reply_to_advertised_s": activated,
                "bytes_fetched": sum(zip_bytes.values()),
                "downloads_seen": seen,
                "activations": cluster.mover.downloads_done.value,
                "ticket": metas[0]["ticket"],
            }
            log(f"distribution download: {json.dumps(report['download'])}")

            # 3. the configs over the downloaded shards
            queries = {}
            for config in DIST_CONFIGS:
                want = reference(config, parts)
                one = expected_launches(config, parts)
                walls = []
                for i in range(4):
                    before = dict(onehot.LAUNCHES)
                    # the first warm query's inputs: a row of their own,
                    # though an earlier leg ran the same shape
                    with (capturing(captured_here,
                                    f"distribution {config}") if i == 1
                          else contextlib.nullcontext()):
                        (order, columns), w = _timed(
                            lambda: _query(rpc, names, config))
                    check_result(config, order, columns, want)
                    got = _launch_delta(before)
                    if got != one:
                        raise AssertionError(
                            f"distribution {config}: launches {got}, "
                            f"want {one}")
                    walls.append(w)
                queries[config] = {"cold_s": walls[0], "warm_s": walls[1:],
                                   "launches": one}
            report["queries"] = queries

            # 4. taxi_0 distributed again, other data under its name
            build = os.path.join(root, "reseeded")
            os.makedirs(build)
            _names, (fresh,) = make_dataset(
                build, len(parts[0]["fare_amount"]), 1, seed=DIST_RESEED)
            new_parts = [fresh] + list(parts[1:])
            put(os.path.join(build, names[0]), names[0])
            shutil.rmtree(build)
            reply, wall, _seen = _dist_download(cluster,
                                                [f"{names[0]}.zip"])
            # two of the worker's rescans, so that a scan that fell in the
            # swap (the old dir removed, the new not yet moved in) is
            # superseded before the query
            time.sleep(1.2)
            _wait(lambda: all(n in ctl.files_map for n in names), 60,
                  "the re-activated shard")
            before = dict(onehot.LAUNCHES)
            (order, columns), w = _timed(
                lambda: _query(rpc, names, "sharded"))
            check_result("sharded", order, columns,
                         reference("sharded", new_parts))
            got = _launch_delta(before)
            if got != expected_launches("sharded", new_parts):
                raise AssertionError(f"re-distribution launches {got}")
            report["redistribute"] = {"reply": reply, "wall_s": wall,
                                      "query_s": w, "launches": got}

            # 5. a blob the store does not hold
            shards_before = sorted(os.listdir(serving))
            failed_before = cluster.downloader.downloads_failed.value
            t0 = time.perf_counter()
            try:
                rpc.download(filenames=["absent.bcolzs.zip"],
                             bucket=DIST_BUCKET, scheme="localfs", wait=True)
            except RPCError as exc:
                error = str(exc)
            else:
                raise AssertionError("a missing blob's download succeeded")
            if ("failed" not in error
                    or sorted(os.listdir(serving)) != shards_before
                    or cluster.downloader.downloads_failed.value
                    != failed_before + 1):
                raise AssertionError(f"the failed ticket: {error}")
            report["missing_blob"] = {"error": error[:200],
                                      "wall_s": time.perf_counter() - t0}

            # 6. the bcolz v1 import, as a process
            legacy = os.path.join(root, "legacy_0.bcolz")
            t0 = time.perf_counter()
            v1_bytes = write_v1_ctable(legacy, parts[0], "trip_distance")
            write_s = time.perf_counter() - t0
            imported = "imported_0.bcolzs"
            env = dict(os.environ,
                       PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "bqueryd_tpu_torch.node", "import",
                 legacy, os.path.join(serving, imported)],
                env=env, capture_output=True, text=True, timeout=600)
            import_s = time.perf_counter() - t0
            if out.returncode:
                raise AssertionError(f"import exited {out.returncode}: "
                                     f"{out.stderr[-2000:]}")
            _wait(lambda: imported in ctl.files_map, 60,
                  "the imported shard advertised")
            before = dict(onehot.LAUNCHES)
            with capturing(captured_here, "distribution import"):
                (order, columns), w = _timed(
                    lambda: _query(rpc, [imported], "single"))
            check_result("single", order, columns,
                         reference("single", parts))
            got = _launch_delta(before)
            if got != expected_launches("single", parts):
                raise AssertionError(f"import query launches {got}")
            report["import"] = {
                "v1_write_s": write_s, "v1_bytes": v1_bytes,
                "import_s": import_s, "decoder": "native",
                "stdout": out.stdout.strip()[-200:], "query_s": w,
                "launches": got,
            }
            log(f"distribution import: {json.dumps(report['import'])}")

            # 7. the admin verbs, then killall
            slept = rpc.sleep(0.1)
            meta = rpc.readfile(f"{names[1]}/meta.json")
            with open(os.path.join(serving, names[1], "meta.json"),
                      "rb") as f:
                if meta != f.read() or "slept 0.1" not in slept:
                    raise AssertionError("sleep or readfile answered wrong")
            info = rpc.info()
            if (info["others"] != {}
                    or info["replication"]["shards_by_holders"]["1"]
                    != len(names) + 1):
                raise AssertionError(f"info: {info['replication']}")
            t0 = time.perf_counter()
            if rpc.killall() != "OK":
                raise AssertionError("killall")
            for t in cluster.threads:
                t.join(timeout=5)
            alive = [t.name for t in cluster.threads if t.is_alive()]
            if alive:
                raise AssertionError(f"killall left {alive} running")
            report["admin"] = {"sleep": slept, "readfile_bytes": len(meta),
                               "replication": info["replication"],
                               "others": info["others"],
                               "killall_s": time.perf_counter() - t0}
    finally:
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(root, ignore_errors=True)
    captured.update(captured_here)
    return report


def controller_url(store_dir):
    """The coordination URL of a cluster started on ``store_dir``."""
    return f"file://{store_dir}"


# -- observability: traces, autopsies, SLO classes, slow queries, the
# profile, /metrics, the capacity model and the device trace --------------

OBS_CONFIGS = ("sharded", "multikey", "zones", "highcard")
OBS_WARM = 5
#: the spans a warm query's timeline holds (tests/test_obs.py's waterfall)
OBS_SPANS = ("admission", "plan", "dispatch", "kernel", "merge", "calc",
             "storage_decode", "h2d_transfer", "groupby")
#: warm autopsy coverage each config is held to (the reference's contract
#: on its real-wall config); the others' is printed
OBS_COVERAGE = {"sharded": 0.95}
#: the debug bundle's sections of this slice's subsystems
OBS_SECTIONS = ("trace", "autopsy", "slow_queries", "worker_histograms",
                "runtime", "compile_cache", "slo", "timeline_ring",
                "capacity")
OBS_KERNELS = ("onehot_rows_dot", "onehot_rows_dot_hicard")
OBS_ENV = {
    # what the CLI's --metrics_port 0 and --log_json set for a node
    "BQUERYD_TPU_METRICS_PORT": "0",
    "BQUERYD_TPU_LOG_JSON": "1",
    # every query lands in the slow-query ring
    "BQUERYD_TPU_SLOW_QUERY_MS": "0",
    "BQUERYD_TPU_SLO_CLASSES": "interactive:2.0:0.99",
    "BQUERYD_TPU_RESULT_CACHE_BYTES": "0",
    "BQUERYD_TPU_CALIB": "0",
}
OBS_SWARM_CLIENTS = 8
OBS_SWARM_ROUNDS = 4


def _program_calls():
    """{(name, signature): calls} of the process's call registry."""
    from bqueryd_tpu_torch.obs import profile

    prof = profile.profiler()
    with prof._lock:
        return {(e["name"], sig): e["calls"]
                for sig, e in prof.programs.items()}


def _kernel_calls_since(before):
    """Calls of the two instrumented kernel wrappers since ``before``."""
    out = dict.fromkeys(OBS_KERNELS, 0)
    for (name, sig), calls in _program_calls().items():
        short = name.rsplit(".", 1)[-1]
        if short in out:
            out[short] += calls - before.get((name, sig), 0)
    return out


def _kernel_launches(launched):
    """Launches per wrapper of a ``_launch_delta``."""
    out = dict.fromkeys(OBS_KERNELS, 0)
    for key, n in launched.items():
        out[key.split("/", 1)[0]] += n
    return out


def _check_waterfall(label, timeline):
    """The required spans, the groupby span the one orphan (its parent is
    the client's root span), and a kernel span with its device time."""
    spans = timeline["spans"]
    names = {s["name"] for s in spans}
    missing = set(OBS_SPANS) - names
    ids = {s["span_id"] for s in spans}
    orphans = [s["name"] for s in spans if s.get("parent_span_id") not in ids]
    kernels = [s for s in spans if s["name"] == "kernel"]
    device = [(s.get("tags") or {}).get("device_s") for s in kernels]
    if missing or orphans != ["groupby"] or not all(
            d is not None and d > 0 for d in device):
        raise AssertionError(
            f"{label}: spans missing {sorted(missing)}, orphans {orphans}, "
            f"kernel device_s {device}")
    return (sum(s["duration_s"] for s in kernels), sum(device))


def _check_autopsy(label, record, trace_id):
    """The query's own record, ok, its segments summing to its wall."""
    total = sum(record["segments"].values()) + record["unattributed_s"]
    if (record.get("trace_id") != trace_id or record.get("ok") is not True
            or abs(total - record["wall_s"]) > 1e-3):
        raise AssertionError(
            f"{label}: autopsy {record.get('trace_id')} (want {trace_id}), "
            f"ok {record.get('ok')}, segments {total} against wall "
            f"{record['wall_s']}")


def _scrape(port, families):
    """GET /metrics of a node; every sample line parses, and each family
    has samples.  Returns the sample count."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        text = resp.read().decode()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as resp:
        if resp.read().strip() != b"ok":
            raise AssertionError(f"/healthz of port {port}")
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        float(value)
        family = name.split("{", 1)[0]
        samples[family] = samples.get(family, 0) + 1
    absent = [f for f in families if not samples.get(f)]
    if absent:
        raise AssertionError(f"/metrics of port {port} lacks {absent}")
    return sum(samples.values())


def _trace_launch_in_range(trace_dir, kernel, range_name):
    """Whether the Chrome trace in ``trace_dir`` holds a launch of
    ``kernel`` inside a ``range_name`` range: the launch (the runtime call
    of the kernel's correlation id) within the range, or, where the trace
    keeps no runtime record of it, the kernel's external id that of the
    range."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"{len(files)} traces in {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and str(e.get("name", "")).startswith(range_name)
              and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel in str(e.get("name", ""))]
    by_corr = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr:
            by_corr[corr] = e
    found = None
    for k in kernels:
        args = k.get("args") or {}
        launch = by_corr.get(args.get("correlation"))
        if launch is not None:
            if any(r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]
                   for r in ranges):
                found = "runtime launch inside the range"
                break
        elif any((r.get("args") or {}).get("External id")
                 == args.get("External id") for r in ranges):
            found = "kernel's external id is the range's"
            break
    return {"ranges": len(ranges), "kernels": len(kernels),
            "runtime_records": len(by_corr), "found": found,
            "file": files[0]}


def run_observability_path(names, parts, data_dir, store_dir, scratch):
    """The observability stack on a cluster of its own (the controller and
    a worker on cuda, ``--metrics_port 0`` and ``--log_json``, every query
    a slow one, the result cache off, the heuristic hints alone) through
    an ``RPC(slo_class="interactive")``: sharded, multikey, zones and
    highcard, 1 cold + 5 warm each, every query followed by the same one
    under ``BQUERYD_TPU_METRICS=0``, each exact, launching as its route
    implies, on and off alike.  Every warm query's autopsy is its own,
    ok, with segments summing to its wall (sharded's warm coverage at
    least 0.95), and its trace holds the required spans, the groupby span
    the one orphan and a kernel span with ``device_s``.  Then the slow
    queries (one per query, class "interactive"), the timeline, the debug
    bundle (the nine sections, the worker's calls per instrumented name
    and shape against the launch counters, the library's load, runtime,
    build directory, device memory against the working set), both nodes'
    ``/metrics`` over HTTP, a burst of 32 sharded queries from 8 clients
    and ``rpc.capacity()`` (coverage 1.0, the worker's μ > 0), and one
    warm sharded query under ``BQUERYD_TPU_PROFILE=1`` whose Chrome trace
    must hold the ``mma`` kernel's launch inside its ``aggregate`` range.
    Returns the ``observability`` report."""
    import logging

    from bqueryd_tpu_torch.obs import profile
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.rpc import RPC

    report = {"configs": {}}
    with _env_set(OBS_ENV):
        rpc0, controller, worker, threads = _start_cluster(data_dir,
                                                           store_dir)
        rpc0._close_socket()
        url = f"file://{store_dir}"
        rpc = RPC(coordination_url=url, timeout=300, retries=1,
                  loglevel=logging.WARNING, slo_class="interactive")
        try:
            _wait(lambda: all(n in controller.shard_stats for n in names),
                  60, "every shard's advertised stats")
            on_traces = []
            calls = dict.fromkeys(OBS_KERNELS, 0)
            launches = dict.fromkeys(OBS_KERNELS, 0)
            for config in OBS_CONFIGS:
                want = reference(config, parts)
                worker.clear_caches()
                walls = {"on": [], "off": []}
                coverage, segments, kernel_s = [], [], []
                unattributed = []
                for rep in range(OBS_WARM + 1):
                    answers = {}
                    for mode in ("on", "off"):
                        env = ({} if mode == "on"
                               else {"BQUERYD_TPU_METRICS": "0"})
                        with _env_set(env):
                            before = dict(onehot.LAUNCHES)
                            prog = _program_calls()
                            answer, wall = _timed(
                                lambda: _query(rpc, names, config))
                            trace_id = rpc.last_trace_id
                            # the controller replies, then accounts: a
                            # verb served after the query is served after
                            # its accounting, under this environment
                            rpc.ping()
                            launched = _launch_delta(before)
                            called = _kernel_calls_since(prog)
                            routes = list(rpc.last_call_strategies[
                                "effective"].values())
                        label = f"observability {config} {mode} {rep}"
                        check_result(config, *answer, want)
                        # the route the reply names implies the launches
                        expect = route_launches(config, parts, routes)
                        if launched != expect:
                            raise AssertionError(
                                f"{label}: launched {launched}, expected "
                                f"{expect}")
                        answers[mode] = (answer, launched)
                        if rep:
                            walls[mode].append(wall)
                        if mode == "off":
                            continue
                        for name in OBS_KERNELS:
                            calls[name] += called[name]
                            launches[name] += _kernel_launches(
                                launched)[name]
                        on_traces.append(trace_id)
                        if not rep:
                            continue
                        record = rpc.autopsy(trace_id)
                        _check_autopsy(label, record, trace_id)
                        coverage.append(record["coverage"])
                        segments.append(record["segments"])
                        unattributed.append(record["unattributed_s"])
                        kernel_s.append(_check_waterfall(
                            label, rpc.trace(trace_id)))
                    (order_on, cols_on), launched_on = answers["on"]
                    (order_off, cols_off), launched_off = answers["off"]
                    if launched_on != launched_off or order_on != order_off \
                            or any(not np.array_equal(cols_on[c], cols_off[c])
                                   for c in order_on):
                        raise AssertionError(
                            f"observability {config} {rep}: the answers or "
                            f"launches with observability on and off "
                            f"differ ({launched_on}, {launched_off})")
                floor = OBS_COVERAGE.get(config)
                if floor is not None and min(coverage) < floor:
                    raise AssertionError(
                        f"observability {config}: warm coverage "
                        f"{coverage} below {floor}")
                on_med = float(np.median(walls["on"]))
                off_med = float(np.median(walls["off"]))
                report["configs"][config] = {
                    "coverage": coverage,
                    "coverage_min": min(coverage),
                    "segments_median_s": {
                        k: float(np.median([s.get(k, 0.0)
                                            for s in segments]))
                        for k in sorted({k for s in segments for k in s})},
                    "unattributed_s_median": float(np.median(unattributed)),
                    "kernel_host_s_median": float(np.median(
                        [k[0] for k in kernel_s])),
                    "kernel_device_s_median": float(np.median(
                        [k[1] for k in kernel_s])),
                    "warm_wall_on_s_median": on_med,
                    "warm_wall_off_s_median": off_med,
                    "on_off_ratio": on_med / off_med,
                    "routes": routes,
                    "launches_per_query": sum(expect.values()),
                }
                log(f"observability {config}: "
                    f"{json.dumps(report['configs'][config])}")
            if calls != launches:
                raise AssertionError(
                    f"observability: instrumented kernel calls {calls}, "
                    f"launches {launches}")
            report["kernel_calls"] = calls
            # the slow-query ring: one entry per query with observability
            # on (the off ones are not accounted), in the client's class
            slow = rpc.slow_queries()
            slow_ids = [e["trace_id"] for e in slow]
            if (sorted(slow_ids) != sorted(on_traces)
                    or {e["slo_class"] for e in slow} != {"interactive"}):
                raise AssertionError(
                    f"observability: {len(slow)} slow-query entries of "
                    f"classes {sorted({e['slo_class'] for e in slow})} for "
                    f"{len(on_traces)} queries")
            timeline = rpc.timeline()
            if not timeline:
                raise AssertionError("observability: an empty timeline")
            report["slow_queries"] = len(slow)
            report["timeline_entries"] = len(timeline)
            report["bundle"] = _check_obs_bundle(rpc, controller, worker,
                                                 len(on_traces))
            report["metrics_samples"] = {
                "worker": _scrape(worker._metrics_server.port, (
                    "bqueryd_tpu_worker_groupby_seconds_bucket",
                    "bqueryd_tpu_query_phase_seconds_bucket",
                    "bqueryd_tpu_reply_bytes_bucket",
                    "bqueryd_tpu_device_peak_bytes_in_use")),
                "controller": _scrape(controller._metrics_server.port, (
                    "bqueryd_tpu_groupby_seconds_bucket",
                    "bqueryd_tpu_capacity_fleet_utilization",
                    "bqueryd_tpu_capacity_headroom_qps",
                    "bqueryd_tpu_slo_queries_total")),
            }
            report["capacity"] = _obs_capacity(rpc, url, names, parts,
                                               worker)
            report["device_trace"] = _obs_device_trace(rpc, names, parts,
                                                       scratch)
        finally:
            rpc._close_socket()
            _stop_cluster(rpc0, controller, worker, threads)
    return report


def _check_obs_bundle(rpc, controller, worker, n_queries):
    """The debug bundle: the nine sections, the SLO class's queries, and
    the worker's slice (polled until its heartbeat carried the newest
    calls) with the calls per instrumented name and shape equal to the
    process's registry, the library's load, the runtime, the build
    directory and the device memory from ``torch.cuda.memory_stats``, its
    peak at least the working set's device bytes."""
    from bqueryd_tpu_torch.obs import profile

    def slice_now():
        bundle = rpc.debug_bundle()
        snap = (bundle["workers"].get(worker.worker_id) or {}).get(
            "snapshot") or {}
        want = {p["signature"]: p["calls"]
                for p in profile.profiler().snapshot()["programs"]}
        got = {p["signature"]: p["calls"]
               for p in (snap.get("compile") or {}).get("programs", ())}
        return bundle, snap, got == want and bool(want)

    deadline = time.time() + 30
    bundle, snap, fresh = slice_now()
    while not fresh and time.time() < deadline:
        time.sleep(0.5)
        bundle, snap, fresh = slice_now()
    section = bundle["controller"]
    missing = [s for s in OBS_SECTIONS if s not in section]
    compile_ = snap.get("compile") or {}
    kernel_entries = [p for p in compile_.get("programs", ())
                      if p["name"].rsplit(".", 1)[-1] in OBS_KERNELS]
    runtime = snap.get("runtime") or {}
    cache = snap.get("compile_cache") or {}
    memory = (snap.get("device_memory") or [{}])[0]
    ws = worker.executor.workingset.stats()
    ws_bytes = ws["codes"]["bytes"] + ws["blocks"]["bytes"]
    interactive = section.get("slo", {}).get("interactive", {})
    problems = []
    if missing:
        problems.append(f"sections missing {missing}")
    if not fresh:
        problems.append("the worker slice never carried the newest calls")
    if interactive.get("queries", 0) < n_queries:
        problems.append(f"slo section {interactive}")
    if compile_.get("library_loads", 0) < 1 or not kernel_entries:
        problems.append(f"compile section {compile_.get('library_loads')} "
                        f"loads, {len(kernel_entries)} kernel entries")
    if not {"torch", "torch_cuda", "device"} <= set(runtime):
        problems.append(f"runtime {runtime}")
    if not str(cache.get("path", "")).endswith(os.path.join("build",
                                                             "kernels")):
        problems.append(f"compile_cache {cache}")
    if not memory.get("peak_bytes_in_use", 0) >= ws_bytes > 0:
        problems.append(f"device memory {memory} against the working "
                        f"set's {ws_bytes} bytes")
    if problems:
        raise AssertionError(f"observability bundle: {problems}")
    return {
        "sections": sorted(section),
        "slo_interactive": interactive,
        "library_loads": compile_["library_loads"],
        "persistent_cache": [compile_["persistent_cache_hits"],
                             compile_["persistent_cache_misses"]],
        "kernel_entries": [{k: p[k] for k in ("signature", "calls",
                                              "flops", "bytes_accessed")}
                           for p in kernel_entries],
        "runtime": runtime,
        "compile_cache": cache,
        "device_memory": memory,
        "workingset_device_bytes": ws_bytes,
    }


def _obs_capacity(rpc, url, names, parts, worker):
    """A burst of sharded queries from 8 clients, each answer exact, then
    ``rpc.capacity()`` until the fleet's coverage is 1.0 and the worker's
    μ > 0 (its WRM histograms carry the burst)."""
    sl, gcols, aggs, where = CONFIGS["sharded"]
    want = reference("sharded", parts)
    query = (names[sl], gcols, aggs, where)
    results, walls, elapsed, _timings = _swarm(
        url, [[query] * OBS_SWARM_ROUNDS] * OBS_SWARM_CLIENTS, 0)
    for order, columns in results.values():
        check_result("sharded", order, columns, want)
    deadline = time.time() + 30
    while True:
        snap = rpc.capacity()
        fleet = snap.get("fleet") or {}
        mu = ((snap.get("workers") or {}).get(worker.worker_id)
              or {}).get("mu")
        if fleet.get("coverage") == 1.0 and mu:
            break
        if time.time() > deadline:
            raise AssertionError(f"observability capacity: {snap}")
        time.sleep(0.5)
    return {"queries": len(results), "elapsed_s": elapsed,
            "wall_s_median": float(np.median(walls)),
            "fleet": fleet, "worker": snap["workers"][worker.worker_id]}


def _obs_device_trace(rpc, names, parts, scratch):
    """One warm sharded query under ``BQUERYD_TPU_PROFILE=1`` and
    ``BQUERYD_TPU_PROFILE_DIR``: its Chrome trace holds the mma kernel's
    launch inside the ``aggregate`` range."""
    trace_dir = tempfile.mkdtemp(prefix="obs_trace_", dir=scratch)
    try:
        with _env_set({"BQUERYD_TPU_PROFILE": "1",
                       "BQUERYD_TPU_PROFILE_DIR": trace_dir}):
            order, columns = _query(rpc, names, "sharded")
        check_result("sharded", order, columns, reference("sharded", parts))
        found = _trace_launch_in_range(
            trace_dir, BRANCH_KERNEL[("onehot_rows_dot", "mma")],
            "aggregate")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    if not found["found"]:
        raise AssertionError(f"observability device trace: {found}")
    return found


# -- the multi-device merge ----------------------------------------------------

#: the multi-device leg's groupby configs, bundle and DAGs; its device
#: layouts are one card repeated k times (logical devices, as the JAX
#: package's tests repeat the CPU) and, on a box of several, every card
MD_CONFIGS = ("sharded", "multikey", "filtered", "zones", "highcard")
MD_DAGS = ("dag_topk", "dag_quantile", "dag_join", "dag_window")
MD_BUNDLE = 4
MD_K = (2, 4)
MD_WARM = 2
#: logical devices of each rank of the psum leg, and its configs
MD_PSUM_K = 2
MD_PSUM_CONFIGS = ("sharded", "multikey", "zones", "highcard")
#: the layouts whose first device's kernel inputs the kernel rows hold
MD_KERNEL_ROWS = {"k=4": MD_CONFIGS + ("dag_join", "dag_topk",
                                       "dag_window"),
                  "k=2": ("sharded", "highcard")}


def _md_layouts():
    """``[(label, devices)]``: one card once (the reference point), one
    card repeated ``k`` times for each of :data:`MD_K`, and every card
    when torch sees more than one."""
    import torch

    card = torch.device("cuda", 0)
    out = [("k=1", [card])] + [(f"k={k}", [card] * k) for k in MD_K]
    n = torch.cuda.device_count()
    if n > 1:
        out.append((f"cards={n}", [torch.device("cuda", i)
                                   for i in range(n)]))
    return out


def _md_launches(kind, shape, n_rows, k):
    """{shape key: launches} of one query on ``k`` devices: one
    contraction per device over its row of the pack."""
    from bqueryd_tpu_torch import ops

    kernel, branch = kind
    n = ops.program_bucket(-(-n_rows // k), fine=True)
    return {shape_key(kernel, branch, *shape, n): k}


def _md_same(label, got, want, n_keys=1):
    """Two finalized answers, ``(order, columns)`` (or lists of them, a
    bundle's), equal group for group (the host merge orders groups its own
    way): the first ``n_keys`` columns are the keys; ints and keys bit for
    bit, floats within rtol 2e-5, top-k lists equal."""
    if isinstance(got, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _md_same(f"{label} member {i}", g, w, n_keys)
        return
    (o1, c1), (o2, c2) = got, want
    if o1 != o2:
        raise AssertionError(f"{label}: columns {o1} against {o2}")
    if len(c1[o1[0]]) != len(c2[o2[0]]):
        raise AssertionError(f"{label}: {len(c1[o1[0]])} groups against "
                             f"{len(c2[o2[0]])}")
    p1, p2 = (np.lexsort([np.asarray(c[k]) for k in reversed(o1[:n_keys])])
              for c in (c1, c2))
    for col in o1:
        a, b = np.asarray(c1[col])[p1], np.asarray(c2[col])[p2]
        if a.dtype == object or b.dtype == object:
            same = len(a) == len(b) and all(
                np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(a, b))
        elif a.dtype.kind == "f":
            same = a.shape == b.shape and np.allclose(a, b, rtol=2e-5,
                                                      atol=0)
        else:
            same = a.dtype == b.dtype and np.array_equal(a, b)
        if not same:
            raise AssertionError(f"{label}: column {col} differs from k=1")


def _md_capture(store, label, config):
    """Record under ``label`` the first launch's inputs in the block (the
    first device's, its kernel call at the per-device shape)."""
    from bqueryd_tpu_torch.ops import onehot

    saved = {"onehot_rows_dot": onehot._launch_base,
             "onehot_rows_dot_hicard": onehot._launch_hicard}

    def wrap(name):
        def run(codes, rows, n_rows, n_groups, plan):
            store.setdefault(label, (name, plan.branch, codes, rows, n_rows,
                                     n_groups,
                                     n_rows - FLOAT_ROWS.get(config, 0)))
            return saved[name](codes, rows, n_rows, n_groups, plan)
        return run

    onehot._launch_base = wrap("onehot_rows_dot")
    onehot._launch_hicard = wrap("onehot_rows_dot_hicard")
    return saved


def _md_restore(saved):
    from bqueryd_tpu_torch.ops import onehot

    onehot._launch_base = saved["onehot_rows_dot"]
    onehot._launch_hicard = saved["onehot_rows_dot_hicard"]


#: the bundle's members: the swarm's query, passenger_count -> fare sum,
#: each under its own trip_distance threshold
MD_BUNDLE_AGGS = [["fare_amount", "sum", "fare_amount"]]
MD_BUNDLE_THRESHOLDS = tuple(CONC_BASE + CONC_STEP * i
                             for i in range(MD_BUNDLE))


def _md_bundle_queries():
    from bqueryd_tpu_torch.models.query import GroupByQuery

    return [GroupByQuery(["passenger_count"], MD_BUNDLE_AGGS,
                         [["trip_distance", ">", t]])
            for t in MD_BUNDLE_THRESHOLDS]


def run_multidevice_path(names, parts, data_dir, captured):
    """The executor's three entry points over several devices: per layout
    of :func:`_md_layouts` a ``LocalRPC`` whose executor runs on those
    devices, in device mode and (but at k=1) under
    ``BQUERYD_TPU_DEVICE_MERGE=0``: the groupby configs of
    :data:`MD_CONFIGS` (1 cold query, then ``MD_WARM`` warm), a bundle of
    ``MD_BUNDLE`` filtered queries (``execute_bundle``) and the extended
    DAGs on the fast path (``execute_dag``; under the kill switch it must
    refuse).  Every answer equals NumPy's and k=1's; each query launches
    one contraction per device at the per-device shape; the bytes fetched
    are one table in device mode (k=1's) and k tables in host mode; the
    first device's kernel inputs of :data:`MD_KERNEL_ROWS` go to
    ``captured``."""
    import torch

    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.parallel import devicemerge, hostmerge
    from bqueryd_tpu_torch.parallel.executor import DagFastPathUnsupported
    from bqueryd_tpu_torch.plan import dag as dagmod
    from bqueryd_tpu_torch.rpc import LocalRPC

    rows = _rows_of(parts, slice(None))
    cols = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
    want = {c: reference(c, parts) for c in MD_CONFIGS}
    want.update({c: dag_reference(c, parts) for c in MD_DAGS})
    bundle_want = [conc_reference(cols, ["passenger_count"],
                                  MD_BUNDLE_AGGS, t)
                   for t in MD_BUNDLE_THRESHOLDS]
    stats = devicemerge.stats()
    base, base_bytes = {}, {}
    report = {}
    for label, devices in _md_layouts():
        k = len(devices)
        rpc = LocalRPC(data_dir, devices=devices)
        tables = [rpc._table(n) for n in names]
        modes = ("device",) if k == 1 else ("device", "host")
        for mode in modes:
            rec = report.setdefault(label, {})[mode] = {}
            env = {"BQUERYD_TPU_DEVICE_MERGE":
                   "1" if mode == "device" else "0"}

            def hold(what, run, expect, check, capture=None):
                walls, answer, fetched = [], None, []
                for rep in range(MD_WARM + 1):
                    before = dict(onehot.LAUNCHES)
                    snap = stats.snapshot()
                    saved = (_md_capture(captured, capture[0], capture[1])
                             if capture and rep == 1 else None)
                    try:
                        out, wall = _timed(run)
                    finally:
                        if saved:
                            _md_restore(saved)
                    check(out)
                    launched = _launch_delta(before)
                    if launched != expect:
                        raise AssertionError(
                            f"multidevice {label} {mode} {what} query "
                            f"{rep}: launched {launched}, expected {expect}")
                    after = stats.snapshot()
                    fetched.append(after["bytes_fetched"][mode]
                                   - snap["bytes_fetched"][mode])
                    walls.append(wall)
                    answer = out
                if len(set(fetched)) != 1:
                    raise AssertionError(f"multidevice {label} {mode} "
                                         f"{what}: fetched {fetched}")
                if k == 1:
                    base[what], base_bytes[what] = answer, fetched[0]
                else:
                    _md_same(f"multidevice {label} {mode} {what}",
                             answer, base[what],
                             len(CONFIGS[what][1]) if what in CONFIGS
                             else 1)
                    bound = base_bytes[what] * (k if mode == "host" else 1)
                    if fetched[0] != bound:
                        raise AssertionError(
                            f"multidevice {label} {mode} {what}: fetched "
                            f"{fetched[0]} bytes, expected {bound}")
                rec[what] = {"first_wall_s": walls[0],
                             "warm_walls_s": walls[1:],
                             "warm_wall_s_median":
                                 float(np.median(walls[1:])),
                             "fetched_bytes": fetched[0],
                             "launches": sum(expect.values())}

            with _env_set(env):
                for config in MD_CONFIGS:
                    def run_query(config=config):
                        return _query(rpc, names, config)

                    def check(out, config=config):
                        check_result(config, *out, want[config])
                        if rpc.last_merge_mode != mode:
                            raise AssertionError(
                                f"multidevice {config}: merge mode "
                                f"{rpc.last_merge_mode}, expected {mode}")

                    capture = None
                    if mode == "device" and config in MD_KERNEL_ROWS.get(
                            label, ()):
                        capture = (f"multidevice {label} {config}", config)
                    hold(config, run_query,
                         _md_launches(CONFIG_KERNEL[config],
                                      EXEC_SHAPE[config], rows, k),
                         check, capture)

                def run_bundle():
                    payloads = rpc.executor.execute_bundle(
                        tables, _md_bundle_queries())
                    return [hostmerge.finalize_table(
                        hostmerge.merge_payloads([p])) for p in payloads]

                def check_bundle(outs):
                    for i, (out, w) in enumerate(zip(outs, bundle_want)):
                        check_conc(f"multidevice bundle member {i}",
                                   ["passenger_count"], MD_BUNDLE_AGGS,
                                   *out, w)
                    if rpc.executor.last_merge_mode != mode:
                        raise AssertionError("multidevice bundle: merge "
                                             "mode "
                                             f"{rpc.executor.last_merge_mode}")

                expect = _md_launches(CONFIG_KERNEL["sharded"],
                                      EXEC_SHAPE["sharded"], rows, k)
                hold("bundle", run_bundle,
                     {key: n * MD_BUNDLE for key, n in expect.items()},
                     check_bundle)
                for config in MD_DAGS:
                    dag = dagmod.compile_query(dict(DAG_SPECS[config],
                                                    table=list(names)))
                    if mode == "host":
                        try:
                            rpc.executor.execute_dag(tables, dag)
                        except DagFastPathUnsupported:
                            continue
                        raise AssertionError(
                            f"multidevice {config}: the fast path ran "
                            "under BQUERYD_TPU_DEVICE_MERGE=0")

                    def run_dag(dag=dag):
                        return hostmerge.finalize_table(
                            hostmerge.merge_payloads(
                                [rpc.executor.execute_dag(tables, dag)]))

                    def check_d(out, config=config):
                        check_dag(config, *out, want[config])

                    capture = None
                    if config in MD_KERNEL_ROWS.get(label, ()):
                        capture = (f"multidevice {label} {config}", config)
                    hold(config, run_dag,
                         _md_launches(("onehot_rows_dot", "mma"),
                                      DAG_FAST_SHAPE[config], rows, k),
                         check_d, capture)
        rpc.executor.clear_caches()
        rpc.engine.clear_caches()
        del rpc, tables
        # release the layout's host and device buffers now, not in a later
        # leg's query (a cycle's arrays are freed at the next collection)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"multidevice {label}: {json.dumps(report[label])}")
    return report


def psum_rank(rank, data_dir, out_path):
    """One rank of the psum leg (``chip_smoke.py --psum-rank R DATA OUT``,
    started by :func:`run_psum_path` with the ``BQUERYD_TPU_DIST_*``
    variables): joins the job, runs :data:`MD_PSUM_CONFIGS` and dag_topk
    through a ``LocalRPC`` on ``MD_PSUM_K`` logical devices of its card
    (1 cold + 1 warm each) and pickles the answers, walls, merge modes,
    launches and backend to ``out_path``."""
    import pickle

    import torch

    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.parallel import devicemerge, hostmerge
    from bqueryd_tpu_torch.plan import dag as dagmod
    from bqueryd_tpu_torch.rpc import LocalRPC

    if not ops.maybe_init_distributed():
        raise AssertionError("the psum rank joined no job")
    info = ops.distributed_info()
    if devicemerge.resolve_mode() != devicemerge.MODE_PSUM:
        raise AssertionError("a joined rank must take the psum mode")
    card = torch.device("cuda", torch.cuda.current_device())
    rpc = LocalRPC(data_dir, devices=[card] * MD_PSUM_K)
    names = [f"taxi_{i}.bcolzs" for i in range(SHARDS)]
    onehot._library()
    out = {"info": info, "devices": [str(d) for d in rpc.executor.devices],
           "answers": {}, "walls": {}, "modes": {}}
    onehot.reset_launch_counts()
    for config in MD_PSUM_CONFIGS:
        walls = []
        for _rep in range(2):
            answer, wall = _timed(lambda: _query(rpc, names, config))
            walls.append(wall)
        out["answers"][config], out["walls"][config] = answer, walls
        out["modes"][config] = rpc.last_merge_mode
    tables = [rpc._table(n) for n in names]
    dag = dagmod.compile_query(dict(DAG_SPECS["dag_topk"],
                                    table=list(names)))
    walls = []
    for _rep in range(2):
        answer, wall = _timed(lambda: hostmerge.finalize_table(
            hostmerge.merge_payloads([rpc.executor.execute_dag(tables,
                                                               dag)])))
        walls.append(wall)
    out["answers"]["dag_topk"], out["walls"]["dag_topk"] = answer, walls
    out["launches"] = {shape_key(*key): v
                       for key, v in onehot.LAUNCHES.items()}
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def run_psum_path(names, parts, data_dir, scratch):
    """The psum mode with two ranks, each a process of this script
    (:func:`psum_rank`) on ``MD_PSUM_K`` logical devices: NCCL where each
    rank has a card of its own, gloo on one card.  Both ranks' answers must
    equal NumPy's and each other's, with the launches the 4-row pack
    implies (each rank runs its 2 rows); returns the backend, the walls
    and the launches."""
    import pickle
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, BQUERYD_TPU_DIST_COORDINATOR=f"127.0.0.1:{port}",
               BQUERYD_TPU_DIST_NPROCS="2")
    outs = [os.path.join(scratch, f"psum_rank{r}.pkl") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--psum-rank", str(r),
         data_dir, outs[r]],
        env=dict(env, BQUERYD_TPU_DIST_PROC_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"psum rank {r} failed:\n{text[-4000:]}")
    ranks = []
    for path in outs:
        with open(path, "rb") as fh:
            ranks.append(pickle.load(fh))
    from bqueryd_tpu_torch import ops

    # each rank runs its MD_PSUM_K rows of the 2 * MD_PSUM_K-row pack: one
    # launch per device and query, two queries per config
    n = ops.program_bucket(-(-_rows_of(parts, slice(None))
                             // (2 * MD_PSUM_K)), fine=True)
    want_launches = {}
    shapes = [CONFIG_KERNEL[c] + EXEC_SHAPE[c] for c in MD_PSUM_CONFIGS]
    shapes.append(("onehot_rows_dot", "mma") + DAG_FAST_SHAPE["dag_topk"])
    for shape in shapes:
        key = shape_key(*shape, n)
        want_launches[key] = want_launches.get(key, 0) + 2 * MD_PSUM_K
    for r, rank in enumerate(ranks):
        for config in MD_PSUM_CONFIGS:
            check_result(config, *rank["answers"][config],
                         reference(config, parts))
            if rank["modes"][config] != "device":
                raise AssertionError(f"psum rank {r} {config}: merge mode "
                                     f"{rank['modes'][config]}")
        check_dag("dag_topk", *rank["answers"]["dag_topk"],
                  dag_reference("dag_topk", parts))
        if rank["launches"] != want_launches:
            raise AssertionError(f"psum rank {r}: launched "
                                 f"{rank['launches']}, expected "
                                 f"{want_launches}")
    for config in ranks[0]["answers"]:
        _md_same(f"psum {config}", ranks[0]["answers"][config],
                 ranks[1]["answers"][config])
    report = {"backend": ranks[0]["info"]["backend"],
              "world_size": ranks[0]["info"]["world_size"],
              "devices_per_rank": [r["devices"] for r in ranks],
              "walls_s": [r["walls"] for r in ranks],
              "launches_per_rank": ranks[0]["launches"]}
    log(f"psum: {json.dumps(report)}")
    return report


def run_cli_check(names, parts, data_dir, store_dir):
    """The CLI on the card: ``python -m bqueryd_tpu_torch.node controller``,
    ``... worker --device=cuda``, ``... downloader`` and ``... movebcolz``
    as processes of their own, found through a file:// store, one checked
    query per config from the port client, then dag_join through
    ``RPC.query``, an ``RPC.append`` to a small ingest shard written beside
    the taxi shards for the check (the repeat query after it a delta
    refresh), and the download of a zipped copy of taxi_1 from a
    ``BQUERYD_TPU_BLOB_DIR`` blob store, which the downloader fetches, the
    mover activates and the worker answers (single's query); SIGTERM stops
    all four, which must exit 0.  The worker process runs with its result
    cache off and loads the kernel library this process built."""
    import logging

    from bqueryd_tpu_torch.blob import LocalFSBackend
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.utils.net import zip_to_file

    root = os.path.dirname(os.path.abspath(__file__))
    url = f"file://{store_dir}"
    # the object store of the download: a zipped copy of taxi_1
    blob_dir = tempfile.mkdtemp(prefix="cli_blobs_", dir=store_dir)
    dl_shard = "cli_dl.bcolzs"
    zipped, _crc = zip_to_file(os.path.join(data_dir, names[1]), store_dir)
    LocalFSBackend(root=blob_dir).put(DIST_BUCKET, f"{dl_shard}.zip", zipped)
    os.remove(zipped)
    env = dict(os.environ, BQUERYD_TPU_RUNFILE_DIR=store_dir,
               PYTHONPATH=root, BQUERYD_TPU_RESULT_CACHE_BYTES="0",
               BQUERYD_TPU_BLOB_DIR=blob_dir)
    # a shard of its own for the append: the taxi shards stay as written
    ingest_dir = tempfile.mkdtemp(prefix="cli_ingest_", dir=store_dir)
    frames, _chunklen, rng = write_ingest(ingest_dir, 96_000, 1)
    cli_shard = "cli_ingest.bcolzs"
    os.rename(os.path.join(ingest_dir, "ing_0.bcolzs"),
              os.path.join(data_dir, cli_shard))
    frames = {cli_shard: frames["ing_0.bcolzs"]}
    node = [sys.executable, "-m", "bqueryd_tpu_torch.node"]
    roles = {
        "controller": node + ["controller", f"--coordination={url}"],
        "worker": node + ["worker", f"--coordination={url}",
                          f"--data_dir={data_dir}", "--device=cuda"],
        "downloader": node + ["downloader", f"--coordination={url}",
                              f"--data_dir={data_dir}"],
        "movebcolz": node + ["movebcolz", f"--coordination={url}",
                             f"--data_dir={data_dir}"],
    }
    logs = {role: open(os.path.join(store_dir, f"{role}.log"), "w+")
            for role in roles}
    procs = {role: subprocess.Popen(cmd, cwd=root, env=env,
                                    stdout=logs[role],
                                    stderr=subprocess.STDOUT)
             for role, cmd in roles.items()}
    report = {}
    t0 = time.perf_counter()
    try:
        def up():
            dead = [r for r, p in procs.items() if p.poll() is not None]
            if dead:
                raise AssertionError(f"CLI {dead} exited early")
            return _registered(url)

        _wait(up, 120, "the CLI controller's registration")
        rpc = RPC(coordination_url=url, timeout=300, retries=1,
                  loglevel=logging.WARNING)
        _wait(lambda: _served(rpc, names), 120,
              "the CLI worker serving every shard")
        report["start_s"] = time.perf_counter() - t0
        # one query per config; the worker process keeps the environment
        # it started with, so the unpruned leg has no run here
        for config in (c for c in CONFIGS if c not in ENV):
            (order, columns), wall = _timed(
                lambda: _query(rpc, names, config))
            check_result(config, order, columns, reference(config, parts))
            modes = set(rpc.last_call_merge_modes.values())
            if modes != {"none" if config in PER_SHARD_SHAPE else "device"}:
                raise AssertionError(f"CLI {config}: merge modes {modes}")
            report[config] = {"first_query_wall_s": wall}
        (order, columns), wall = _timed(lambda: rpc.query(
            dict(DAG_SPECS["dag_join"], table=list(names))))
        check_dag("dag_join", order, columns,
                  dag_reference("dag_join", parts))
        report["dag_join"] = {"first_query_wall_s": wall}
        _wait(lambda: _served(rpc, [cli_shard]), 60,
              "the CLI worker serving the ingest shard")

        def ingest_query():
            order, columns = rpc.groupby([cli_shard], ["g"], INGEST_AGGS, [])
            check_ingest(order, columns, ingest_reference(frames))
            return list(rpc.last_call_strategies["effective"].values())

        ingest_query()  # the delta base
        extra = _ingest_frame(rng, 4_000, 96_000)
        res, wall = _timed(lambda: rpc.append(cli_shard, extra))
        frames[cli_shard] = {c: np.concatenate([frames[cli_shard][c],
                                                extra[c]]) for c in extra}
        routes = ingest_query()
        if res["appended"] != 4_000 or routes != ["delta"]:
            raise AssertionError(f"CLI append: {res}, then routes {routes}")
        report["append"] = {"append_wall_s": wall, "routes": routes}
        # the download roles: one zipped shard fetched and activated
        reply, wall = _timed(lambda: rpc.download(
            filenames=[f"{dl_shard}.zip"], bucket=DIST_BUCKET,
            scheme="localfs", wait=True))
        if reply != "DONE":
            raise AssertionError(f"CLI download replied {reply!r}")
        _wait(lambda: _served(rpc, [dl_shard]), 60,
              "the CLI worker serving the downloaded shard")
        (order, columns), qwall = _timed(
            lambda: _query(rpc, [dl_shard], "single"))
        check_result("single", order, columns,
                     reference("single", [parts[1]]))
        report["download"] = {"download_wall_s": wall,
                              "first_query_wall_s": qwall}
        rpc._close_socket()
    except BaseException:
        for role, f in logs.items():
            f.seek(0)
            log(f"CLI {role} log:\n{f.read()[-4000:]}")
        raise
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for f in logs.values():
            f.close()
        for leftover in (cli_shard, dl_shard, "incoming"):
            shutil.rmtree(os.path.join(data_dir, leftover),
                          ignore_errors=True)
    codes = {role: p.returncode for role, p in procs.items()}
    if any(codes.values()):
        raise AssertionError(f"CLI nodes exited with {codes}")
    log(f"CLI check: {json.dumps(report)}")
    return report


def _registered(url):
    import bqueryd_tpu_torch
    from bqueryd_tpu_torch.coordination import coordination_store

    return bool(coordination_store(url).smembers(
        bqueryd_tpu_torch.REDIS_SET_KEY))


def _engine_query(rpc, names, config):
    """One query of ``config`` through the per-shard engine path."""
    from bqueryd_tpu_torch import worker
    from bqueryd_tpu_torch.models.query import GroupByQuery
    from bqueryd_tpu_torch.parallel import hostmerge

    sl, gcols, aggs, where = CONFIGS[config]
    tables = [rpc._table(n) for n in names[sl]]
    payload = worker.execute(tables, GroupByQuery(gcols, aggs, where),
                             rpc.engine)
    return hostmerge.finalize_table(hostmerge.merge_payloads([payload]))


def run_engine_path(rpc, names, parts, repeats=1):
    """The per-shard engine path at reduced depth: 1 warm-up + ``repeats``
    timed queries per config, checked, each launching its branch once per
    shard at the shard's shape."""
    from bqueryd_tpu_torch.ops import onehot

    report = {}
    for config in BASE_CONFIGS:
        sl = CONFIGS[config][0]
        want = reference(config, parts)
        kernel, branch = CONFIG_KERNEL[config]
        shard_rows = {len(p["fare_amount"]) for p in parts[sl]}
        expect = {
            shape_key(kernel, branch, *ENGINE_SHAPE[config], rows):
            sum(len(p["fare_amount"]) == rows for p in parts[sl])
            for rows in shard_rows
        }
        walls = []
        for rep in range(repeats + 1):
            before = dict(onehot.LAUNCHES)
            (order, columns), wall = _timed(
                lambda: _engine_query(rpc, names, config))
            check_result(config, order, columns, want)
            launched = _launch_delta(before)
            if launched != expect:
                raise AssertionError(
                    f"engine {config} query {rep}: expected {expect}, "
                    f"launched {launched}")
            if rep:
                walls.append(wall)
        report[config] = {
            "wall_s_median": float(np.median(walls)),
            "walls_s": walls,
            "warmup_included": False,
            "route": rpc.engine.last_effective_strategy,
            "launch_shapes": expect,
        }
        log(f"engine {config}: {json.dumps(report[config])}")
    return report


#: host functions whose cumulative time (cProfile of a query run with the
#: pipeline serialized) the executor path's breakdown reports, in path
#: order
EXEC_PHASES = (
    ("align", "_global_key_space"),
    ("mask", "build_mask"),
    ("pack", "_pack"),
    ("h2d", "_upload"),
    ("partial_tables", "partial_tables"),
    ("fetch", "_fetch"),
    ("collect", "_collect_payload"),
    ("finalize", "finalize_table"),
    ("prune", "chunk_pruned_table"),
    ("views", "chunk_view"),
    ("basket", "expand_mask_by_group"),
    ("stat", "<built-in method posix.stat>"),
    ("realpath", "realpath"),
)

#: the same for the per-shard configs of the rest of the groupby verb
SLICE_PHASES = (
    ("decode", "column_raw"),
    ("factorize", "_key_codes"),
    ("h2d", "as_tensor"),
    ("partial_tables", "partial_tables"),
    ("value_sets", "_group_distinct_flat"),
    ("device_sort", "groupby_count_distinct"),
    ("runs", "groupby_sorted_count_distinct"),
    ("hostmerge", "merge_payloads"),
    ("finalize", "finalize_table"),
)

#: the same for the per-shard engine path
ENGINE_PHASES = (
    ("decode", "column_raw"),
    ("factorize", "_group_codes"),
    ("mask", "build_mask"),
    ("h2d", "as_tensor"),  # every upload; overlaps mask and partial_tables
    ("partial_tables", "partial_tables"),
    ("d2h", "tree_to_numpy"),
    ("hostmerge", "merge_payloads"),
    ("finalize", "finalize_table"),
)


def _profile_query(run, phases, reset=None):
    """Where one query spends its time: cumulative host time per phase
    (cProfile) and the pipeline's stage busy time of a query run with the
    pipeline serialized, then the device's busy time and idle share
    (torch.profiler) of another query at the pipeline's own width.
    ``reset`` runs before each of the two queries (a cold query clears
    the caches there).  Serialized, every phase runs on the calling
    thread: Python 3.12's cProfile also records the pool threads' calls
    (through sys.monitoring), with times that do not add up."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bqueryd_tpu_torch.parallel import pipeline

    if reset is not None:
        reset()
    prof = cProfile.Profile()
    pipeline.clock().reset()
    width = os.environ.get("BQUERYD_TPU_PIPELINE_THREADS")
    os.environ["BQUERYD_TPU_PIPELINE_THREADS"] = "1"
    try:
        _, cprofile_wall = _timed(lambda: prof.runcall(run))
    finally:
        if width is None:
            del os.environ["BQUERYD_TPU_PIPELINE_THREADS"]
        else:
            os.environ["BQUERYD_TPU_PIPELINE_THREADS"] = width
    stages = pipeline.clock().snapshot()["busy_seconds"]
    stats = pstats.Stats(prof).stats
    host = {
        label: sum(v[3] for k, v in stats.items() if k[2] == func)
        for label, func in phases
    }
    if reset is not None:
        reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        _, wall = _timed(run)
    device_us, kernel_us = 0.0, 0.0
    for evt in trace.key_averages():
        self_dev = _evt_device_us(evt)
        device_us += self_dev
        if any(k in evt.key for k in BRANCH_KERNEL.values()):
            kernel_us += self_dev
    torch.cuda.synchronize()
    return {
        "host_phases_s": host,
        "stage_busy_s": stages,
        "cprofile_wall_s": cprofile_wall,
        "profiled_wall_s": wall,
        "device_busy_s": device_us / 1e6 if device_us else None,
        "onehot_kernel_s": kernel_us / 1e6 if device_us else None,
        "device_idle_share": (1 - device_us / 1e6 / wall)
        if device_us else None,
    }


def breakdown(rpc, names):
    """The executor path cold (caches cleared) and warm, and the engine
    path warm, per BASELINE config; then the other configs through
    ``LocalRPC``."""
    def clear():
        rpc.executor.clear_caches()
        rpc.engine.clear_caches()

    out = {"executor": {}, "engine": {}}
    for config in BASE_CONFIGS:
        def run():
            return _query(rpc, names, config)

        cold = _profile_query(run, EXEC_PHASES, reset=clear)
        warm = _profile_query(run, EXEC_PHASES)
        out["executor"][config] = {"cold": cold, "warm": warm}
        log(f"breakdown executor {config}: "
            f"{json.dumps(out['executor'][config])}")
        out["engine"][config] = _profile_query(
            lambda: _engine_query(rpc, names, config), ENGINE_PHASES)
        log(f"breakdown engine {config}: "
            f"{json.dumps(out['engine'][config])}")
    # the rest of the verb through LocalRPC: the per-shard configs warm,
    # the executor ones cold and warm
    out["slice"] = {}
    for config in CONFIGS:
        if config in BASE_CONFIGS:
            continue

        def run():
            return _query(rpc, names, config)

        if config in PER_SHARD_SHAPE:
            run()  # warm the engine's caches first
            out["slice"][config] = {"warm": _profile_query(run,
                                                           SLICE_PHASES)}
        else:
            out["slice"][config] = {
                "cold": _profile_query(run, EXEC_PHASES, reset=clear),
                "warm": _profile_query(run, EXEC_PHASES),
            }
        log(f"breakdown slice {config}: {json.dumps(out['slice'][config])}")
    return out


def capture_executor_inputs(rpc, names, parts):
    """The (codes, rows) each config's kernel call receives through
    ``LocalRPC``, captured from one warm query per config: ``{config:
    (kernel, branch, codes, rows, R, G, int rows)}``; a per-shard config's
    first shard stands for its shards.  Configs with the same shape keep
    their own inputs (filtered's codes carry its folded filter).  The
    launches of these queries are outside the counted runs."""
    from bqueryd_tpu_torch.ops import onehot

    captured = {}
    calls = []
    current = []
    launchers = {"onehot_rows_dot": onehot._launch_base,
                 "onehot_rows_dot_hicard": onehot._launch_hicard}

    def capturing(name, launch):
        def run(codes, rows, n_rows, n_groups, plan):
            config = current[0]
            calls.append(config)
            if config not in captured:
                captured[config] = (name, plan.branch, codes, rows, n_rows,
                                    n_groups,
                                    n_rows - FLOAT_ROWS.get(config, 0))
            return launch(codes, rows, n_rows, n_groups, plan)
        return run

    onehot._launch_base = capturing("onehot_rows_dot",
                                    launchers["onehot_rows_dot"])
    onehot._launch_hicard = capturing("onehot_rows_dot_hicard",
                                      launchers["onehot_rows_dot_hicard"])
    try:
        for config in CONFIGS:
            current[:] = [config]
            calls.clear()
            _query(rpc, names, config)
            want = sum(expected_launches(config, parts).values())
            if len(calls) != want:
                raise AssertionError(f"{config}: {len(calls)} kernel calls, "
                                     f"expected {want}")
    finally:
        onehot._launch_base = launchers["onehot_rows_dot"]
        onehot._launch_hicard = launchers["onehot_rows_dot_hicard"]
    return captured


def _time_ms(fn, iters):
    """Mean ms per call of ``fn`` between two CUDA events around ``iters``
    back-to-back calls (host overhead included where it dominates)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _evt_device_us(evt):
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = getattr(evt, "self_cuda_time_total", 0.0)
    return us


#: timings that fell back to CUDA events: (kernel, flushed) of each
PROFILER_FALLBACKS = []


def _event_ms(fn, iters, flush):
    """Mean ms per call between CUDA events recorded around each call,
    after its flush: the fallback of :func:`_device_ms`."""
    import torch

    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _device_ms(fn, kernel, iters, flush=None, windows=6):
    """Mean device time per call, in ms, of the CUDA kernels whose name
    holds ``kernel`` ("" for every kernel ``fn`` runs), from torch.profiler
    (CUPTI) over ``iters`` calls after a warm-up.  With ``flush``, that
    buffer is overwritten before each call, so the inputs come from device
    memory and not from L2; the flush itself is not counted.  Where the
    profiler holds too few records after ``windows`` windows, the time
    comes from CUDA events around the calls (host launch cost included)
    and :data:`PROFILER_FALLBACKS` says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if flush is not None and not kernel:
        raise ValueError("a flushed timing names its kernel")
    fn()
    torch.cuda.synchronize()
    # CUPTI drops some records of a window (1 and 11 of 50 launches of one
    # 10M-row kernel, 8 of 10 flushed launches of another, once all 30 of
    # three flushed windows), so each kernel's time per call is the mean
    # over the records held, times its launches per call; a window holding
    # fewer than half its calls' records is pooled with the next, up to
    # ``windows`` windows
    totals = {}  # kernel name -> [device us, records]
    for window in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        for evt in trace.key_averages():
            if kernel and kernel not in evt.key or not evt.count:
                continue
            total = totals.setdefault(evt.key, [0.0, 0])
            total[0] += _evt_device_us(evt)
            total[1] += evt.count
        count = sum(n for _, n in totals.values())
        if count >= iters // 2:
            break
    calls = iters * window
    per_call = sum(us / n * max(1, round(n / calls))
                   for us, n in totals.values())
    if count < iters // 2 and kernel:
        PROFILER_FALLBACKS.append((kernel, flush is not None))
        log(f"profiler saw {count} launches of {kernel} over {calls} calls: "
            "timed with CUDA events")
        if flush is None:
            return _time_ms(fn, iters)
        return _event_ms(fn, iters, flush)
    if count < iters // 2 or (kernel and count > calls) or per_call <= 0:
        raise AssertionError(
            f"profiler saw {count} launches of {kernel or 'any kernel'} "
            f"({per_call} us per call) over {calls} calls"
        )
    return per_call / 1e3


def _stack(rows, device):
    """Rows stacked as the port stacks them: into [R, padded_width(n)]."""
    import torch

    from bqueryd_tpu_torch.ops import onehot

    n = rows[0].shape[0]
    out = torch.empty(len(rows), onehot.padded_width(n),
                      dtype=torch.bfloat16, device=device)[:, :n]
    torch.stack(rows, 0, out=out)
    return out


def _shard_inputs(parts, device):
    """The (kernel, branch, codes, rows, R, G, int rows) each kernel branch
    receives on the per-shard engine path, built with the port's own row
    plans from shard 0 (1M rows), plus one synthetic shape per branch no
    path takes (n = 1,000,003: ragged, so ld > n)."""
    import torch

    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.ops import groupby as tg

    shard = parts[0]

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    fare = to_dev(shard["fare_amount"])
    limbs, _bias = tg._limb_rows(fare, 64, True)
    count = torch.ones(len(shard["fare_amount"]), dtype=torch.bfloat16,
                       device=device)

    def codes_of(cols):
        codes = [ops.factorize(shard[c])[0] for c in cols]
        cards = [int(c.max()) + 1 for c in codes]
        dense = ops.pack_codes(codes, cards)
        if ops.total_cardinality(cards) > 1 << 16:
            dense, combos = ops.factorize(dense)
            return dense, ops.program_bucket(len(combos))
        return dense, ops.total_cardinality(cards)

    out = {}
    codes, g = codes_of(["passenger_count"])
    out["shard R=9"] = ("onehot_rows_dot", "mma", to_dev(codes.astype(np.int32)),
                       _stack([count] + limbs, device), 9, g, 9)
    codes, g = codes_of(["VendorID", "payment_type"])
    dist = to_dev(shard["trip_distance"])
    hi, mid, lo = tg._dekker_rows(dist)
    out["shard R=13"] = ("onehot_rows_dot", "mma",
                        to_dev(codes.astype(np.int32)),
                        _stack([count] + limbs + [count, hi, mid, lo],
                               device), 13, g, 10)
    codes, g = codes_of(["PULocationID", "DOLocationID"])
    out["shard hicard"] = ("onehot_rows_dot_hicard", "cluster",
                          to_dev(codes.astype(np.int32)),
                          _stack([count] + limbs, device), 9, g, 9)

    rng = np.random.RandomState(SEED)
    n = 1_000_003

    def synthetic(n_rows, n_groups):
        codes = rng.randint(-1, n_groups, n).astype(np.int32)
        rows = rng.randint(0, 256, (n_rows, n)).astype(np.float32)
        rows[0] = codes >= 0
        return to_dev(codes), _stack(
            list(to_dev(rows).to(torch.bfloat16)), device)

    codes, rows = synthetic(9, 8192)
    out["table G=8192"] = ("onehot_rows_dot", "table", codes, rows, 9,
                           8192, 9)
    codes, rows = synthetic(27, 1 << 18)
    out["global R=27"] = ("onehot_rows_dot_hicard", "global", codes, rows,
                          27, 1 << 18, 27)
    return out


def _compare(label, got, want, n_rows, n_int):
    """Int rows bit-exact; float rows within rtol=2e-5, atol=1e-6*max.
    Returns the largest absolute difference."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if got.dtype == torch.uint32:
        got_f = got.view(torch.int32).to(torch.float64)
        want_f = want.view(torch.int32).to(torch.float64)
    else:
        got_f, want_f = got.to(torch.float64), want.to(torch.float64)
    ints = (slice(None), slice(0, n_int)) if got.dim() == 3 else (
        slice(0, n_int),)
    if not torch.equal(got_f[ints], want_f[ints]):
        raise AssertionError(f"{label}: int rows differ from the plain "
                             "version")
    if n_int < n_rows:
        # Dekker rows: the tensor cores and the warps' fold sum in another
        # order than the plain version's index_add_
        f = (slice(None), slice(n_int, n_rows))
        scale = float(want_f[f].abs().max())
        tol = 2e-5 * want_f[f].abs() + 1e-6 * scale
        if not bool(((got_f[f] - want_f[f]).abs() <= tol).all()):
            raise AssertionError(f"{label}: float rows out of tolerance")
    if not bool(torch.isfinite(got_f).all()):
        raise AssertionError(f"{label}: non-finite output")
    return float((got_f - want_f).abs().max())


def _launch(name, expect, codes, rows, n_rows, n_groups, **forced):
    """A call that launches ``name``'s kernel branch ``expect``, asserting
    that the shape routes there (or that a sweep's ``forced`` plan
    arguments send it there)."""
    from bqueryd_tpu_torch.ops import onehot

    n = codes.shape[0]
    if name == "onehot_rows_dot":
        plan = onehot._base_plan(n_rows, n_groups, n, **forced)
        run = onehot._launch_base
    else:
        plan = onehot._hicard_plan(n_rows, n_groups, n, **forced)
        run = onehot._launch_hicard
    if plan.branch != expect:
        raise AssertionError(f"{name} R={n_rows} G={n_groups}: plan takes "
                             f"{plan.branch}, expected {expect}")
    return lambda: run(codes, rows, n_rows, n_groups, plan)


def _library_call(name, codes, rows, n_rows, n_groups, device):
    """The library yardstick of a kernel call: one ``index_add_`` over
    pre-arranged inputs (slot indices and ``[n, R]`` values) that computes
    the same tables (per block of ``BLOCK_K`` rows for the base kernel);
    timed only, used nowhere in the port.  Returns ``(call, kept row
    indices)``."""
    import torch

    from bqueryd_tpu_torch.ops import onehot

    c = codes.to(torch.int64)
    keep = torch.nonzero(c >= 0).squeeze(1)
    vals = rows[:, keep].t().to(torch.float32).contiguous()
    if name == "onehot_rows_dot":
        slot = (keep // onehot.BLOCK_K) * n_groups + c[keep]
        nb = -(-codes.shape[0] // onehot.BLOCK_K)
        acc = torch.zeros(nb * n_groups, n_rows, device=device)
    else:
        slot = c[keep]
        vals = vals.to(torch.int64)
        acc = torch.zeros(n_groups, n_rows, dtype=vals.dtype, device=device)
    return (lambda: acc.index_add_(0, slot, vals)), keep


#: kernel rows whose branch is forced: the executor's highcard inputs on
#: the hicard "global" branch, which that shape does not route to
FORCED = ("executor highcard global",)


def check_kernels(inputs, device, launches, iters=50):
    """Every branch of each kernel at every recorded shape (``inputs``:
    label -> (kernel, branch, codes, rows, R, G, int rows)) against its
    plain version, timed.  ``launches``: label -> {path: launches of
    that row's branch and shape on the path}."""
    import torch

    from bqueryd_tpu_torch.ops import onehot

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = []
    for label, (name, branch, codes, rows, n_rows, n_groups, n_int) in (
        inputs.items()
    ):
        wrapper = getattr(onehot, name)
        plain = getattr(onehot, f"{name}_plain")
        kernel = BRANCH_KERNEL[(name, branch)]
        if label in FORCED:
            # a branch the shape does not route to, forced through its plan
            run = _launch(name, branch, codes, rows, n_rows, n_groups,
                          branch=branch)
        else:
            _launch(name, branch, codes, rows, n_rows, n_groups)  # routes
            run = lambda: wrapper(codes, rows, n_rows, n_groups)  # noqa: E731
        got = run()
        want = plain(codes, rows, n_rows, n_groups)
        torch.cuda.synchronize()
        err = _compare(label, got, want, n_rows, n_int)
        if branch == "mma":
            again = run()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"{label}: two launches differ")

        library, keep = _library_call(name, codes, rows, n_rows, n_groups,
                                      device)
        n = codes.shape[0]
        in_bytes = rows.numel() * 2 + n * 4
        bytes_moved = in_bytes + got.numel() * 4
        if branch == "mma":
            # the tensor-core products: one m16n8k16 MMA per 16 rows, per
            # 8-group n-tile, per 16-row tile of stacked rows
            plan = onehot._base_plan(n_rows, n_groups, n)
            ops = (2 * 16 * 8 * 16 * -(-n // 16) * plan.ntiles
                   * plan.grid[1])
            peak = BF16_TC_FLOPS
        else:
            # one add per (row, stacked row) that has a group
            ops, peak = int(keep.numel()) * n_rows, FP32_FLOPS
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / peak) * 1e3
        ms = _device_ms(run, kernel, iters)
        ms_cold = _device_ms(run, kernel, max(iters // 5, 5), flush=flush)
        ms_events = _time_ms(run, iters)
        plain_ms = _time_ms(
            lambda: plain(codes, rows, n_rows, n_groups), max(iters // 5, 3))
        library_ms = _time_ms(library, iters)
        stream_ms = _device_ms(
            lambda: (rows.view(torch.int16).sum(), codes.sum()), "", iters)
        results.append({
            "name": name,
            "branch": branch,
            "shape": label,
            "route": "cuda",
            "source": "bqueryd_tpu_torch/csrc/onehot_groupby.cu",
            "kernel": kernel,
            "replaces": REPLACES[name],
            "launches": sum(launches[label].values()),
            "launches_by_path": launches[label],
            "max_abs_err": err,
            "ms": ms,
            "ms_cold": ms_cold,
            "ms_events": ms_events,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                         >= ops / peak else "operations"),
            "bytes": bytes_moved,
            "library_ms": library_ms,
            "stream_read_ms": stream_ms,
            "n": n, "R": n_rows, "G": n_groups,
        })
        log(f"kernel {label}: {json.dumps(results[-1])}")
    return results


#: group counts of the base kernel's branch sweep
G_SWEEP = (9, 16, 32, 64, 256, 1024, 8192)
#: row counts of the G sweep: one shard, and the executor's contraction
#: over the 10 shards (``ops.program_bucket(10M, fine=True)``)
G_SWEEP_N = (1_000_000, 10_223_616)


def sweeps(parts, device, iters=30):
    """The base kernel's two branches over G at R = 9 on shard 0's rows
    (n = 1M, and tiled to the executor's n = 10,223,616), each beside the
    library call (``index_add_``, device time); and the hicard cluster
    count C on the engine path's highcard inputs (one shard)."""
    import torch

    from bqueryd_tpu_torch.ops import onehot

    inputs = _shard_inputs(parts, device)
    _, _, _, shard_rows, n_rows, _, _ = inputs["shard R=9"]
    rng = np.random.RandomState(SEED)
    g_sweep = []
    for n in G_SWEEP_N:
        reps = -(-n // shard_rows.shape[1])
        rows = (shard_rows if n == shard_rows.shape[1] else _stack(
            [r.repeat(reps)[:n] for r in shard_rows], device))
        for g in G_SWEEP:
            codes = torch.from_numpy(
                rng.randint(0, g, n).astype(np.int32)).to(device)
            want = onehot.onehot_rows_dot_plain(codes, rows, n_rows, g)
            row = {"G": g, "R": n_rows, "n": n,
                   "chosen": onehot._base_plan(n_rows, g, n).branch}
            for branch in ("mma", "table"):
                try:
                    run = _launch("onehot_rows_dot", branch, codes, rows,
                                  n_rows, g, branch=branch)
                except ValueError:
                    row[f"{branch}_ms"] = None  # the branch cannot take G
                    continue
                _compare(f"G sweep {branch} G={g} n={n}", run(), want,
                         n_rows, n_rows)
                row[f"{branch}_ms"] = _device_ms(
                    run, BRANCH_KERNEL[("onehot_rows_dot", branch)], iters)
            library, _keep = _library_call("onehot_rows_dot", codes, rows,
                                           n_rows, g, device)
            row["library_ms"] = _device_ms(library, "", iters)
            g_sweep.append(row)
            log(f"G sweep: {json.dumps(row)}")
            del want, library

    name, _, codes, rows, n_rows, n_groups, _ = inputs["shard hicard"]
    want = onehot.onehot_rows_dot_hicard_plain(codes, rows, n_rows, n_groups)
    c_sweep = []
    for clusters in (2, 4, 8):
        run = _launch(name, "cluster", codes, rows, n_rows, n_groups,
                      clusters=clusters)
        _compare(f"C sweep C={clusters}", run(), want, n_rows, n_rows)
        smem = onehot._hicard_plan(n_rows, n_groups, codes.shape[0],
                                   clusters=clusters).smem
        c_sweep.append({
            "C": clusters, "ms": _device_ms(run, "hicard_cluster_kernel",
                                            iters),
            "smem_per_cta": smem,
            "max_active_clusters": onehot.hicard_max_active_clusters(smem),
        })
        log(f"C sweep: {json.dumps(c_sweep[-1])}")
    run = _launch(name, "global", codes, rows, n_rows, n_groups,
                  branch="global")
    _compare("C sweep global", run(), want, n_rows, n_rows)
    c_sweep.append({"C": None, "branch": "global",
                    "ms": _device_ms(run, "hicard_global_kernel", iters)})
    return {"g_sweep": g_sweep, "c_sweep": c_sweep,
            "hicard_shape": {"R": n_rows, "G": n_groups,
                             "n": codes.shape[0]}}


def _input_label(config):
    """The kernel row of a config's own captured inputs: the executor's
    one contraction, or a per-shard config's first shard."""
    return (f"per-shard {config}" if config in PER_SHARD_SHAPE
            else f"executor {config}")


def counted_launches(path, configs=CONFIGS):
    """The launch counts of the run just driven, per shape key; raises if
    a kernel branch of the ``configs`` it drove never launched in it."""
    from bqueryd_tpu_torch.ops import onehot

    launches = {shape_key(*k): v for k, v in onehot.LAUNCHES.items()}
    for kernel, branch in {CONFIG_KERNEL[c] for c in configs}:
        if not any(k.startswith(f"{kernel}/{branch}/") and v
                   for k, v in launches.items()):
            raise AssertionError(
                f"{kernel} ({branch}) never launched on the {path} path")
    return launches


def path_launches(path, kernels=(("onehot_rows_dot", "mma"),)):
    """The launch counts of a DAG or append run just driven, per shape
    key; raises if a kernel branch of the path never launched in it."""
    from bqueryd_tpu_torch.ops import onehot

    launches = {shape_key(*k): v for k, v in onehot.LAUNCHES.items()}
    for kernel, branch in kernels:
        if not any(k.startswith(f"{kernel}/{branch}/") and v
                   for k, v in launches.items()):
            raise AssertionError(
                f"{kernel} ({branch}) never launched on the {path} path")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        log("torch sees no CUDA device: nothing to run")
        return 2
    if sys.argv[1:2] == ["--psum-rank"]:
        return psum_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.rpc import LocalRPC
    from bqueryd_tpu_torch.storage import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    native_thread = threading.Thread(target=native.get_lib)
    native_thread.start()
    lib_path = onehot.build()
    native_thread.join()
    log(f"built {lib_path} and native codec "
        f"({'loaded' if native.available() else 'absent'}) in "
        f"{time.perf_counter() - t0:.1f}s")
    log(onehot.build.ptxas_report.strip())

    device = torch.device("cuda", 0)
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    data_dir = tempfile.mkdtemp(prefix="smoke_data_", dir=scratch)
    try:
        t0 = time.perf_counter()
        names, parts = make_dataset(data_dir)
        log(f"dataset: {ROWS} rows in {SHARDS} shards, "
            f"{time.perf_counter() - t0:.1f}s")
        print(json.dumps({"reduced": [
            "pickup_ts sorted within each shard (bench.py writes the same "
            "draws unsorted), so that its zone maps prune chunks",
        ]}), flush=True)
        # one card: run_multidevice_path drives the device lists
        rpc = LocalRPC(data_dir, devices=[device])
        # set-up outside every timed query: the CUDA context and the
        # kernels' library
        torch.zeros(1, device=device)
        onehot._library()
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        configs = run_executor_path(rpc, names, parts, data_dir)
        exec_launches = counted_launches("executor")
        log(f"executor path: {time.perf_counter() - t0:.1f}s")
        # the executor's three entry points over several devices, in
        # device and host mode, then the psum mode in two ranks
        md_captured = {}
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        multidevice = run_multidevice_path(names, parts, data_dir,
                                           md_captured)
        md_launches = path_launches(
            "multidevice", tuple({CONFIG_KERNEL[c] for c in MD_CONFIGS}))
        md_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        psum = run_psum_path(names, parts, data_dir, scratch)
        log(f"multidevice path: {md_wall:.1f}s, psum ranks: "
            f"{time.perf_counter() - t0:.1f}s")
        print(json.dumps({"multidevice": {
            "layouts": multidevice, "psum": psum,
            "leg_s": md_wall, "psum_s": time.perf_counter() - t0}}),
            flush=True)
        # the cluster's nodes bind and advertise the loopback address
        os.environ["BQUERYD_TPU_IP"] = "127.0.0.1"
        # the serving layer stays off on every leg but its own, so that a
        # repeated query of another leg is dispatched as it always was
        os.environ["BQUERYD_TPU_SERVE"] = "0"
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        # the result cache off, so that every warm query runs its kernels
        # (the delta cache stays on: its bookkeeping is in the walls); the
        # heuristic hints alone, so that the routes do not depend on walls
        # earlier legs recorded
        with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0",
                       "BQUERYD_TPU_CALIB": "0"}):
            cluster = run_cluster_path(
                names, parts, data_dir,
                tempfile.mkdtemp(prefix="store_", dir=data_dir), configs)
        # every config's kernel launched, but highcard's: its binding
        # "scatter" hint takes it off the contraction here
        cluster_launches = counted_launches(
            "cluster", [c for c in CONFIGS if heuristic_route(c) == "matmul"])
        log(f"cluster path: {time.perf_counter() - t0:.1f}s")
        # the operator DAGs and the append verb, each a path of its own
        captured, programs = {}, {}
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        # the heuristic hints alone here too: dag_plain's bytes must equal
        # those of RPC.groupby, whose hint calibration could route
        # elsewhere than the DAG's route
        with _env_set({"BQUERYD_TPU_CALIB": "0"}):
            dag = run_dag_path(names, parts, data_dir,
                               tempfile.mkdtemp(prefix="dag_store_",
                                                dir=data_dir),
                               captured, programs)
        dag_launches = path_launches("dag")
        log(f"DAG path: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        with _env_set({"BQUERYD_TPU_CALIB": "0"}):
            append = run_append_path(data_dir, captured)
        append_launches = path_launches("append")
        log(f"append path: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        with _env_set({"BQUERYD_TPU_CALIB": "0"}):
            concurrency = run_concurrency_path(
                names, parts, data_dir,
                tempfile.mkdtemp(prefix="conc_store_", dir=data_dir),
                captured)
        conc_launches = path_launches("concurrency",
                                      tuple(CONC_KERNEL.values()))
        log(f"concurrency path: {time.perf_counter() - t0:.1f}s")
        # host routing and the wedge latch, then calibration: each on a
        # cluster of its own, the result cache off
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0"}):
            routing = run_routing_path(
                names, parts, data_dir,
                tempfile.mkdtemp(prefix="route_store_", dir=data_dir))
        routing_launches = path_launches("routing")
        log(f"routing path: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0"}):
            calibration = run_calibration_path(
                names, parts, data_dir,
                tempfile.mkdtemp(prefix="calib_store_", dir=data_dir))
        # the kill-switch round puts single and zones on the contraction
        calib_launches = path_launches(
            "calibration", tuple({CONFIG_KERNEL[c] for c in CALIB_CONFIGS
                                  if heuristic_route(c) == "matmul"}))
        log(f"calibration path: {time.perf_counter() - t0:.1f}s")
        # the serving layer: rollups built on the card, answers served
        # with no dispatch and no launch, on a cluster of its own
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        serving = run_serving_path(
            names, parts, data_dir,
            tempfile.mkdtemp(prefix="serve_store_", dir=data_dir), data_dir,
            captured)
        serving_launches = path_launches("serving", SERVE_KERNELS)
        log(f"serving path: {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"serving": serving_summary(serving)}), flush=True)
        # resilience: failover, hedging, dedup, exhaustion, a lost and a
        # wedged worker, on a cluster of two (then three) holders
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0",
                       "BQUERYD_TPU_CALIB": "0"}):
            resilience = run_resilience_path(
                names, parts, data_dir,
                tempfile.mkdtemp(prefix="res_store_", dir=data_dir))
        resilience_launches = path_launches("resilience", RES_KERNELS)
        log(f"resilience path: {time.perf_counter() - t0:.1f}s")
        # distribution: the ten shards downloaded by one ticket, served,
        # one re-distributed, a failed ticket, a bcolz v1 import, killall
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        with _env_set({"BQUERYD_TPU_RESULT_CACHE_BYTES": "0",
                       "BQUERYD_TPU_CALIB": "0"}):
            distribution = run_distribution_path(names, parts, data_dir,
                                                 scratch, captured)
        distribution_launches = path_launches("distribution", DIST_KERNELS)
        log(f"distribution path: {time.perf_counter() - t0:.1f}s")
        # observability: traces, autopsies, the SLO classes, slow queries,
        # the profile, /metrics and the capacity model, on its own cluster
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        observability = run_observability_path(
            names, parts, data_dir,
            tempfile.mkdtemp(prefix="obs_store_", dir=data_dir), scratch)
        observability_launches = path_launches("observability", DIST_KERNELS)
        log(f"observability path: {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"observability": observability}), flush=True)
        t0 = time.perf_counter()
        cli = run_cli_check(
            names, parts, data_dir,
            tempfile.mkdtemp(prefix="cli_store_", dir=data_dir))
        log(f"CLI check: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        engine_configs = run_engine_path(rpc, names, parts)
        engine_launches = counted_launches("per-shard engine", BASE_CONFIGS)
        log(f"engine path: {time.perf_counter() - t0:.1f}s")
        print(json.dumps({"configs": configs,
                          "cluster_configs": cluster,
                          "dag_configs": dag,
                          "append": append,
                          "concurrency": concurrency,
                          "routing": routing,
                          "calibration": calibration,
                          "serving": serving,
                          "resilience": resilience,
                          "distribution": distribution,
                          "observability": observability,
                          "cli": cli,
                          "engine_configs": engine_configs,
                          "multidevice": multidevice,
                          "psum": psum,
                          "launches": {"executor": exec_launches,
                                       "multidevice": md_launches,
                                       "cluster": cluster_launches,
                                       "dag": dag_launches,
                                       "append": append_launches,
                                       "concurrency": conc_launches,
                                       "routing": routing_launches,
                                       "calibration": calib_launches,
                                       "serving": serving_launches,
                                       "resilience": resilience_launches,
                                       "distribution": distribution_launches,
                                       "observability":
                                           observability_launches,
                                       "engine": engine_launches},
                          "card": smi}), flush=True)
        print(json.dumps({"breakdown": breakdown(rpc, names)}), flush=True)
        inputs = {_input_label(config): entry for config, entry in
                  capture_executor_inputs(rpc, names, parts).items()}
        name, _branch, *rest = inputs["executor highcard"]
        inputs["executor highcard global"] = (name, "global", *rest)
        inputs.update(_shard_inputs(parts, device))
        inputs.update(captured)
        inputs.update(md_captured)
        # launches per path: the executor rows count each config's own
        # queries on the cluster and executor paths, the other rows the
        # launches at their shape
        launches = {label: {} for label in inputs}
        for path, counted in (("executor", exec_launches),
                              ("multidevice", md_launches),
                              ("cluster", cluster_launches),
                              ("dag", dag_launches),
                              ("append", append_launches),
                              ("concurrency", conc_launches),
                              ("engine", engine_launches)):
            for label, e in inputs.items():
                key = shape_key(e[0], e[1], e[4], e[5], e[2].shape[0])
                if counted.get(key):
                    launches[label][path] = counted[key]
        for config in configs:
            label = _input_label(config)
            launches[label] = dict(
                {"executor": configs[config]["launches"],
                 "cluster": cluster[config]["launches"]},
                **{p: n for p, n in launches[label].items()
                   if p == "multidevice"})
        # the routing, calibration, serving and resilience legs' launches
        # at each row's shape
        for path, counted in (("routing", routing_launches),
                              ("calibration", calib_launches),
                              ("serving", serving_launches),
                              ("resilience", resilience_launches),
                              ("distribution", distribution_launches),
                              ("observability", observability_launches)):
            for label, e in inputs.items():
                key = shape_key(e[0], e[1], e[4], e[5], e[2].shape[0])
                if counted.get(key) and not label.startswith("bundle "):
                    launches[label][path] = counted[key]
        # a bundle row counts the launches made inside the worker's
        # bundles at its shape (solo queries of that shape ran too)
        for label, e in inputs.items():
            if label.startswith("bundle "):
                key = shape_key(e[0], e[1], e[4], e[5], e[2].shape[0])
                launches[label] = {
                    "concurrency bundles":
                        concurrency["bundle_launches"].get(key, 0)}
        # dag_plain runs multikey's shape on the executor
        launches[_input_label("multikey")]["dag"] = sum(
            dag["dag_plain"]["fast"]["launches"].values())
        kernels = check_kernels(inputs, device, launches)
        print(json.dumps({"dag_programs": time_dag_programs(programs)}),
              flush=True)
        print(json.dumps(sweeps(parts, device)), flush=True)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    # the end of the run: the latch flipped only where the wedge leg
    # forced it, and no probe was ever written off as hung
    from bqueryd_tpu_torch.utils import devicehealth

    health = devicehealth.health_snapshot()
    print(json.dumps({"device_health": health,
                      "forced_flips": FORCED_FLIPS}), flush=True)
    if health != {"wedged": 0, "abandoned_probes": 0,
                  "wedge_generation": FORCED_FLIPS}:
        raise AssertionError(f"the device latched outside the forced "
                             f"flips: {health}")
    print(json.dumps({"profiler_fallbacks": PROFILER_FALLBACKS}), flush=True)
    print(json.dumps({"distribution": distribution}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

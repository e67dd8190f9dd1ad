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
   queries must hit every working-set segment;
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
11. runs the CLI: ``python -m bqueryd_tpu_torch.node controller`` and
   ``... worker --device=cuda`` as processes, one checked query per config
   (but the unpruned leg, whose environment the worker process does not
   have), dag_join through ``RPC.query`` and an append to a small shard
   of its own (the repeat query a delta refresh), both stopped by SIGTERM
   and exiting 0;
12. drives the per-shard engine path (``QueryEngine.execute_local`` per
   shard + ``hostmerge``) for the five BASELINE configs, 1 warm-up + 1
   timed query, checked the same way, each query launching its branch once
   per shard; the launch counters are set to 0 just before each path
   (executor, cluster, DAG, append, concurrency, engine) and read just
   after, and every
   kernel of each path must have launched there;
13. breaks queries down into host phases and pipeline stage busy time
   (cProfile of a query run with the pipeline serialized), and device busy
   time and idle share (torch.profiler, at the pipeline's own width): the
   BASELINE configs on the executor path cold and warm and on the engine
   path warm, the other configs through ``LocalRPC`` (cold and warm on the
   executor, warm per shard);
14. holds every branch of each kernel against its plain PyTorch version at
   every recorded shape: each config's own inputs (captured from a warm
   ``LocalRPC`` query: the executor's one call, or a per-shard config's
   first shard; highcard's also forced onto the hicard "global" branch),
   the engine path's per-shard shapes, the DAG configs' per-shard shapes
   and the append leg's (the executor's and a delta refresh's tail view)
   and the first member of a swarm, zones and highcard bundle (its mask
   folded into its codes), captured from their own runs, plus one shape
   per other branch (base "table" at G = 8192, hicard "global" past the
   cluster table),
   with ints bit-exact, float rows within rtol=2e-5, atol=1e-6*max, and
   the base kernel's output bit-identical across two launches; times each
   kernel warm and with L2 flushed (device time per launch, from
   torch.profiler), beside its plain version, one library call
   (``index_add_``, used nowhere in the port) and a plain streaming read
   of the same bytes;
15. sweeps the base kernel's two branches over G (the crossover behind
    ``onehot.MMA_GROUPS_LIMIT``) and the hicard cluster count C;
16. times the fast path's torch bodies at the shapes its programs ran
    (each top-k emission, checked against the sort route, each sketch
    grid, the whole program with its fetch);
17. prints the sweeps, the fast path's program times, the device-health
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

import contextlib
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


def make_dataset(data_dir, rows=ROWS, shards=SHARDS):
    """bench.py's generator (same RandomState stream, column order and
    ranges) written with the port's ctable from plain arrays.  pickup_ts
    comes from the same draws, sorted within each shard, so that its
    per-chunk zone maps let a time filter prune chunks.  Returns (shard
    names, per-shard {column: array})."""
    from bqueryd_tpu_torch.storage.ctable import ctable

    rng = np.random.RandomState(SEED)
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
    _sl, _gcols, _aggs, where = CONFIGS[config]
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
    sl, gcols, aggs, _where = CONFIGS[config]
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
    _sl, gcols, aggs, _where = CONFIGS[config]
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
    sl, gcols, aggs, where = CONFIGS[config]
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


def _wait(predicate, timeout, what):
    deadline = time.time() + timeout
    while not predicate():
        if time.time() > deadline:
            raise AssertionError(f"timed out after {timeout}s: {what}")
        time.sleep(0.1)


def _served(rpc, names):
    """True once the cluster behind ``rpc`` advertises every shard."""
    workers = rpc.info()["workers"].values()
    return set(names) <= {f for w in workers
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
def capturing(store, label, n_float=0):
    """Record under ``label`` the inputs of the first launch of each
    kernel shape not yet in ``store`` (label -> (kernel, branch, codes,
    rows, R, G, int rows)), for the kernel rows; nothing more is launched.
    A second new shape in one block gets the label with its shape."""
    from bqueryd_tpu_torch.ops import onehot

    known = {shape_key(e[0], e[1], e[4], e[5], e[2].shape[0])
             for e in store.values()}
    launchers = {"onehot_rows_dot": onehot._launch_base,
                 "onehot_rows_dot_hicard": onehot._launch_hicard}

    def wrap(name, launch):
        def run(codes, rows, n_rows, n_groups, plan):
            key = shape_key(name, plan.branch, n_rows, n_groups,
                            codes.shape[0])
            if key not in known:
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
                        poll_timeout=0.1)  # cuda
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
        n_groups, codes_d, measures_d, _classic, topk, sketch = args
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


def controller_url(store_dir):
    """The coordination URL of a cluster started on ``store_dir``."""
    return f"file://{store_dir}"


def run_cli_check(names, parts, data_dir, store_dir):
    """The CLI on the card: ``python -m bqueryd_tpu_torch.node controller``
    and ``... worker --device=cuda`` as processes of their own, found
    through a file:// store, one checked query per config from the port
    client, then dag_join through ``RPC.query`` and an ``RPC.append`` to a
    small ingest shard written beside the taxi shards for the check (the
    repeat query after it a delta refresh); SIGTERM stops both, which must
    exit 0.  The worker process runs with its result cache off and loads
    the kernel library this process built."""
    import logging

    from bqueryd_tpu_torch.rpc import RPC

    root = os.path.dirname(os.path.abspath(__file__))
    url = f"file://{store_dir}"
    env = dict(os.environ, BQUERYD_TPU_RUNFILE_DIR=store_dir,
               PYTHONPATH=root, BQUERYD_TPU_RESULT_CACHE_BYTES="0")
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
        shutil.rmtree(os.path.join(data_dir, cli_shard), ignore_errors=True)
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

        # the library yardstick: one index_add_ over pre-arranged inputs
        # (slot indices and [n, R] values), timed here only
        c = codes.to(torch.int64)
        keep = torch.nonzero(c >= 0).squeeze(1)
        vals = rows[:, keep].t().to(torch.float32).contiguous()
        n = codes.shape[0]
        if name == "onehot_rows_dot":
            slot = (keep // onehot.BLOCK_K) * n_groups + c[keep]
            nb = -(-n // onehot.BLOCK_K)
            acc = torch.zeros(nb * n_groups, n_rows, device=device)
        else:
            slot = c[keep]
            vals = vals.to(torch.int64)
            acc = torch.zeros(n_groups, n_rows, dtype=vals.dtype,
                              device=device)
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
        library_ms = _time_ms(lambda: acc.index_add_(0, slot, vals), iters)
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


def sweeps(parts, device, iters=30):
    """The base kernel's two branches over G at R = 9 on shard 0's rows,
    and the hicard cluster count C on the engine path's highcard inputs
    (one shard)."""
    import torch

    from bqueryd_tpu_torch.ops import onehot

    inputs = _shard_inputs(parts, device)
    _, _, _, rows, n_rows, _, _ = inputs["shard R=9"]
    n = rows.shape[1]
    rng = np.random.RandomState(SEED)
    g_sweep = []
    for g in G_SWEEP:
        codes = torch.from_numpy(rng.randint(0, g, n).astype(np.int32)).to(
            device)
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
            _compare(f"G sweep {branch} G={g}", run(), want, n_rows, n_rows)
            row[f"{branch}_ms"] = _device_ms(
                run, BRANCH_KERNEL[("onehot_rows_dot", branch)], iters)
        g_sweep.append(row)
        log(f"G sweep: {json.dumps(row)}")

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
        rpc = LocalRPC(data_dir)  # cuda
        # set-up outside every timed query: the CUDA context and the
        # kernels' library
        torch.zeros(1, device=device)
        onehot._library()
        t0 = time.perf_counter()
        onehot.reset_launch_counts()
        configs = run_executor_path(rpc, names, parts, data_dir)
        exec_launches = counted_launches("executor")
        log(f"executor path: {time.perf_counter() - t0:.1f}s")
        # the cluster's nodes bind and advertise the loopback address
        os.environ["BQUERYD_TPU_IP"] = "127.0.0.1"
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
                          "cli": cli,
                          "engine_configs": engine_configs,
                          "launches": {"executor": exec_launches,
                                       "cluster": cluster_launches,
                                       "dag": dag_launches,
                                       "append": append_launches,
                                       "concurrency": conc_launches,
                                       "routing": routing_launches,
                                       "calibration": calib_launches,
                                       "engine": engine_launches},
                          "card": smi}), flush=True)
        print(json.dumps({"breakdown": breakdown(rpc, names)}), flush=True)
        inputs = {_input_label(config): entry for config, entry in
                  capture_executor_inputs(rpc, names, parts).items()}
        name, _branch, *rest = inputs["executor highcard"]
        inputs["executor highcard global"] = (name, "global", *rest)
        inputs.update(_shard_inputs(parts, device))
        inputs.update(captured)
        # launches per path: the executor rows count each config's own
        # queries on the cluster and executor paths, the other rows the
        # launches at their shape
        launches = {label: {} for label in inputs}
        for path, counted in (("executor", exec_launches),
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
            launches[_input_label(config)] = {
                "executor": configs[config]["launches"],
                "cluster": cluster[config]["launches"],
            }
        # the routing and calibration legs' launches at each row's shape
        for path, counted in (("routing", routing_launches),
                              ("calibration", calib_launches)):
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

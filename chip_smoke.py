"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of bqueryd_tpu_torch from the sources in this
   checkout (and the native codec library, in parallel);
3. writes the BASELINE dataset with the port's ctable: bench.py's taxi
   schema and generator (seed 42), 10,000,000 rows in 10 shards of 1M;
4. drives the main path: the five BASELINE configs (single, sharded,
   multikey, filtered, highcard) through ``LocalRPC.groupby`` on cuda,
   each checked against a NumPy reference of the generated arrays (int
   sums and counts bit-exact, the float mean within rtol=2e-5) and timed
   (median of 3 after one warm-up); every kernel of the path must have
   launched there (launch counters set to 0 just before, read just after);
5. breaks one warm query of each config down into host phases (cProfile)
   and device busy time (torch.profiler);
6. holds each kernel against its plain PyTorch version at the main path's
   shapes and times kernel, plain version and one library call
   (``index_add_``, used nowhere in the port) with CUDA events;
7. prints the ``kernels`` JSON line, then the device JSON line last.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.  Any failed phase fails the run.
"""

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
}

#: which kernel each config's contraction must launch
CONFIG_KERNEL = {
    "single": "onehot_rows_dot",
    "sharded": "onehot_rows_dot",
    "multikey": "onehot_rows_dot",
    "filtered": "onehot_rows_dot",
    "highcard": "onehot_rows_dot_hicard",
}


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def make_dataset(data_dir, rows=ROWS, shards=SHARDS):
    """bench.py's generator (same RandomState stream, column order and
    ranges) written with the port's ctable from plain arrays.  pickup_ts is
    drawn to keep the stream identical but not written: no config reads
    it.  Returns (shard names, per-shard {column: array})."""
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
        rng.randint(0, 86_400, n)  # pickup_ts, not written
        name = f"taxi_{i}.bcolzs"
        t = ctable(os.path.join(data_dir, name), mode="w")
        t.append(cols)
        t.flush()
        names.append(name)
        parts.append(cols)
    return names, parts


def reference(config, parts):
    """NumPy reference of one config: {key tuple: {out col: value}}."""
    sl, gcols, aggs, where = CONFIGS[config]
    cols = {c: np.concatenate([p[c] for p in parts[sl]]) for c in parts[0]}
    keep = np.ones(len(cols["fare_amount"]), dtype=bool)
    for col, op, value in where:
        assert op == ">"
        keep &= cols[col] > value  # float32 against a Python float: float32
    keys = [cols[c][keep] for c in gcols]
    cards = [int(k.max()) + 1 for k in keys]
    packed = keys[0].copy()
    for k, card in zip(keys[1:], cards[1:]):
        packed = packed * card + k
    size = int(np.prod(cards))
    count = np.bincount(packed, minlength=size)
    out = {}
    for in_col, op, out_col in aggs:
        v = cols[in_col][keep]
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


def run_main_path(rpc, names, parts, repeats=3):
    """Drive the five configs; returns per-config walls and launches."""
    from bqueryd_tpu_torch.ops import onehot

    import torch

    report = {}
    for config, (sl, gcols, aggs, where) in CONFIGS.items():
        want = reference(config, parts)
        before = {
            "onehot_rows_dot": onehot.onehot_rows_dot.launches,
            "onehot_rows_dot_hicard": onehot.onehot_rows_dot_hicard.launches,
        }
        walls = []
        for rep in range(repeats + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            order, columns = rpc.groupby(names[sl], gcols, aggs, where)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_result(config, order, columns, want)
            if rep:
                walls.append(wall)
        launches = {
            k: getattr(onehot, k).launches - v for k, v in before.items()
        }
        kernel = CONFIG_KERNEL[config]
        if launches[kernel] < repeats + 1:
            raise AssertionError(
                f"{config}: {kernel} launched {launches[kernel]} times"
            )
        report[config] = {
            "wall_s_median": float(np.median(walls)),
            "walls_s": walls,
            "warmup_included": False,
            "groups": len(want),
            "route": rpc.engine.last_effective_strategy,
            "launches": launches,
            "queries": repeats + 1,
        }
        log(f"{config}: {json.dumps(report[config])}")
    return report


#: host functions of the query path whose cumulative time the breakdown
#: reports (cProfile), in path order
PHASES = (
    ("decode", "column_raw"),
    ("factorize", "_group_codes"),
    ("mask", "build_mask"),
    ("h2d", "as_tensor"),  # every upload; overlaps mask and partial_tables
    ("partial_tables", "partial_tables"),
    ("d2h", "tree_to_numpy"),
    ("hostmerge", "merge_payloads"),
    ("finalize", "finalize_table"),
)


def breakdown(rpc, names):
    """Where one warm query of each config spends its time: cumulative
    host time per phase (cProfile, one query) and the device's busy time
    and idle share (torch.profiler, another query)."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for config, (sl, gcols, aggs, where) in CONFIGS.items():
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(rpc.groupby, names[sl], gcols, aggs, where)
        torch.cuda.synchronize()
        cprofile_wall = time.perf_counter() - t0
        stats = pstats.Stats(prof).stats
        phases = {}
        for label, func in PHASES:
            phases[label] = sum(
                v[3] for k, v in stats.items() if k[2] == func
            )
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            rpc.groupby(names[sl], gcols, aggs, where)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device_us, kernel_us = 0.0, 0.0
        for evt in trace.key_averages():
            self_dev = getattr(evt, "self_device_time_total", None)
            if self_dev is None:
                self_dev = getattr(evt, "self_cuda_time_total", 0.0)
            device_us += self_dev
            if "onehot" in evt.key:
                kernel_us += self_dev
        out[config] = {
            "host_phases_s": phases,
            "cprofile_wall_s": cprofile_wall,
            "profiled_wall_s": wall,
            "device_busy_s": device_us / 1e6 if device_us else None,
            "onehot_kernel_s": kernel_us / 1e6 if device_us else None,
            "device_idle_share": (1 - device_us / 1e6 / wall)
            if device_us else None,
        }
        log(f"breakdown {config}: {json.dumps(out[config])}")
    return out


def _time_ms(fn, iters):
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


def _main_path_inputs(parts, device):
    """The (codes, rows, R, G) each kernel receives on the main path, built
    with the port's own row plans from shard 0 (1M rows)."""
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
    out["onehot_rows_dot R=9"] = (
        "onehot_rows_dot", to_dev(codes.astype(np.int32)),
        torch.stack([count] + limbs).contiguous(), 9, g, 9)
    codes, g = codes_of(["VendorID", "payment_type"])
    dist = to_dev(shard["trip_distance"])
    hi, mid, lo = tg._dekker_rows(dist)
    out["onehot_rows_dot R=13"] = (
        "onehot_rows_dot", to_dev(codes.astype(np.int32)),
        torch.stack([count] + limbs + [count, hi, mid, lo]).contiguous(),
        13, g, 10)
    codes, g = codes_of(["PULocationID", "DOLocationID"])
    out["onehot_rows_dot_hicard R=9"] = (
        "onehot_rows_dot_hicard", to_dev(codes.astype(np.int32)),
        torch.stack([count] + limbs).contiguous(), 9, g, 9)
    return out


def check_kernels(parts, device, launches, iters=50):
    """Each kernel against its plain version at main-path shapes, timed."""
    import torch

    from bqueryd_tpu_torch.ops import onehot

    results = []
    for label, (name, codes, rows, n_rows, n_groups, n_int) in (
        _main_path_inputs(parts, device).items()
    ):
        wrapper = getattr(onehot, name)
        plain = getattr(onehot, f"{name}_plain")
        counted = wrapper.launches
        got = wrapper(codes, rows, n_rows, n_groups)
        want = plain(codes, rows, n_rows, n_groups)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
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
        err = float((got_f - want_f).abs().max())
        if n_int < n_rows:
            # Dekker rows: float32 atomics sum in another order than the
            # plain version's index_add_
            f = (slice(None), slice(n_int, n_rows))
            scale = float(want_f[f].abs().max())
            tol = 2e-5 * want_f[f].abs() + 1e-6 * scale
            if not bool(((got_f[f] - want_f[f]).abs() <= tol).all()):
                raise AssertionError(f"{label}: float rows out of tolerance")

        # the library yardstick: one index_add_ over pre-arranged inputs
        # (slot indices and [n, R] float32 values), timed here only
        c = codes.to(torch.int64)
        keep = torch.nonzero(c >= 0).squeeze(1)
        vals = rows[:, keep].t().to(torch.float32).contiguous()
        if name == "onehot_rows_dot":
            slot = (keep // onehot.BLOCK_K) * n_groups + c[keep]
            nb = -(-codes.shape[0] // onehot.BLOCK_K)
            acc = torch.zeros(nb * n_groups, n_rows, device=device)
            out_bytes = nb * (-(-n_rows // 16) * 16) * (
                -(-n_groups // 128) * 128) * 4
        else:
            slot = c[keep]
            vals = vals.to(torch.int64)
            acc = torch.zeros(n_groups, n_rows, dtype=vals.dtype,
                              device=device)
            out_bytes = (-(-n_rows // 16) * 16) * (
                -(-n_groups // onehot.HICARD_GROUP_PAD)
                * onehot.HICARD_GROUP_PAD) * 4
        n = codes.shape[0]
        in_bytes = rows.numel() * 2 + n * 4
        bytes_moved = in_bytes + out_bytes
        # one add per (row, stacked row) that has a group
        flops = int(keep.numel()) * n_rows
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                       flops / FP32_FLOPS) * 1e3
        kernel_ms = _time_ms(
            lambda: wrapper(codes, rows, n_rows, n_groups), iters)
        plain_ms = _time_ms(
            lambda: plain(codes, rows, n_rows, n_groups), max(iters // 5, 3))
        library_ms = _time_ms(
            lambda: acc.index_add_(0, slot, vals), iters)
        wrapper.launches = counted  # comparison launches do not count
        results.append({
            "name": name,
            "shape": label,
            "route": "cuda",
            "source": "bqueryd_tpu_torch/csrc/onehot_groupby.cu",
            "replaces": (
                "bqueryd_tpu/ops/pallas_groupby.py:341"
                if name == "onehot_rows_dot"
                else "bqueryd_tpu/ops/pallas_groupby.py:255"
            ),
            "launches": launches[name],
            "max_abs_err": err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                         >= flops / FP32_FLOPS else "operations"),
            "bytes": bytes_moved,
            "library_ms": library_ms,
            "n": n, "R": n_rows, "G": n_groups,
        })
        log(f"kernel {label}: {json.dumps(results[-1])}")
    return results


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
            "pickup_ts column not written (no BASELINE config reads it)",
        ]}), flush=True)
        rpc = LocalRPC(data_dir)  # cuda
        onehot.reset_launch_counts()
        configs = run_main_path(rpc, names, parts)
        launches = {
            "onehot_rows_dot": onehot.onehot_rows_dot.launches,
            "onehot_rows_dot_hicard": onehot.onehot_rows_dot_hicard.launches,
        }
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"{name} never launched on the main path")
        print(json.dumps({"configs": configs, "card": smi}), flush=True)
        print(json.dumps({"breakdown": breakdown(rpc, names)}), flush=True)
        kernels = check_kernels(parts, device, launches)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's psum mode, in two OS processes on the CPU.

The counterpart of ``tests/test_multihost.py``: two processes join one
``torch.distributed`` group through the reference's
``BQUERYD_TPU_DIST_COORDINATOR`` / ``_NPROCS`` / ``_PROC_ID`` variables
(``ops.maybe_init_distributed``, gloo on the CPU), each with 4 logical CPU
devices, so the global pack has 8 rows and each process runs its own 4.
The same groupby, a bundle and a DAG with top-k and quantile sketches run
through ``MeshQueryExecutor`` in both processes; each must give the
replicated psum answer, bit-exact against pandas (top-k lists against a
NumPy sort, sketches equal in both processes).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

_WORKER_SCRIPT = r"""
import json, os, sys
proc_id, data_dir, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]

from bqueryd_tpu_torch import ops
assert ops.maybe_init_distributed() is True, "distributed init did not run"
info = ops.distributed_info()
assert info == {"backend": "gloo", "rank": proc_id, "world_size": 2}, info

import numpy as np
from bqueryd_tpu_torch.models.query import GroupByQuery
from bqueryd_tpu_torch.parallel import devicemerge, hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.plan import dag as dagmod
from bqueryd_tpu_torch.storage.ctable import ctable

assert devicemerge.resolve_mode() == devicemerge.MODE_PSUM
names = sorted(n for n in os.listdir(data_dir) if n.endswith(".bcolzs"))
tables = [ctable(os.path.join(data_dir, n), mode="r") for n in names]
executor = MeshQueryExecutor(device="cpu", n_devices=4)


def frame(payload, key):
    df = hostmerge.payload_to_dataframe(hostmerge.merge_payloads([payload]))
    df = df.sort_values(key).reset_index(drop=True)
    return {c: [v.tolist() if hasattr(v, "tolist") else v for v in df[c]]
            for c in df.columns}


out = {}
query = GroupByQuery(["g"], [["v", "sum", "s"], ["v", "min", "lo"],
                             ["w", "max", "hi"], ["v", "count", "n"]])
out["groupby"] = frame(executor.execute(tables, query), "g")
assert executor.last_merge_mode == "device"
members = [GroupByQuery(["g"], [["w", "sum", "ws"]], [["w", ">", 0]]),
           GroupByQuery(["g"], [["v", "max", "vmax"]])]
out["bundle"] = [frame(p, "g")
                 for p in executor.execute_bundle(tables, members)]
spec = {"table": ["x"], "groupby": ["g"],
        "aggs": [["w", "topk", "t3", {"k": 3}],
                 ["v", "sum", "s"],
                 ["f", "quantile", "p50", {"q": 0.5, "alpha": 0.01}]]}
out["dag"] = frame(executor.execute_dag(tables, dagmod.compile_query(spec)),
                   "g")
with open(f"{out_path}.{proc_id}", "w") as fh:
    json.dump(out, fh)
"""


_UNEQUAL_SCRIPT = r"""
import os, sys
proc_id, data_dir = int(sys.argv[1]), sys.argv[2]

from bqueryd_tpu_torch import ops
assert ops.maybe_init_distributed() is True, "distributed init did not run"

from bqueryd_tpu_torch.models.query import GroupByQuery
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.storage.ctable import ctable

names = sorted(n for n in os.listdir(data_dir) if n.endswith(".bcolzs"))
tables = [ctable(os.path.join(data_dir, n), mode="r") for n in names]
executor = MeshQueryExecutor(device="cpu", n_devices=4 if proc_id == 0 else 2)
try:
    executor.execute(tables, GroupByQuery(["g"], [["v", "sum", "s"]]))
except ValueError as exc:
    assert "[4, 2]" in str(exc), exc
    print("refused:", exc)
else:
    raise AssertionError("unequal device counts were merged")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script, args):
    """Run ``script`` in two processes joined through the
    ``BQUERYD_TPU_DIST_*`` variables (rank as its first argument, then
    ``args``); each bounded by a 240 s timeout, both killed if one hangs.
    Returns their outputs; fails on a non-zero exit."""
    import bqueryd_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(bqueryd_tpu_torch.__file__))
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p),
        "BQUERYD_TPU_DIST_COORDINATOR": f"127.0.0.1:{_free_port()}",
        "BQUERYD_TPU_DIST_NPROCS": "2",
        "CUDA_VISIBLE_DEVICES": "",
    })
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(proc_id), *args],
            env=dict(env, BQUERYD_TPU_DIST_PROC_ID=str(proc_id)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for proc_id in (0, 1)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outputs.append(out.decode(errors="replace"))
    finally:
        for p in procs:  # a hung collective must not outlive the test
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker process failed:\n{out}"
    return outputs


def _write_shards(tmp_path, rows):
    from bqueryd_tpu_torch.storage.ctable import ctable

    rng = np.random.default_rng(9)
    frames = []
    for i in range(4):
        df = pd.DataFrame({
            "g": rng.integers(0, 11, rows).astype(np.int64),
            "v": rng.integers(-(2**50), 2**50, rows).astype(np.int64),
            "w": rng.integers(-100, 100, rows).astype(np.int64),
            "f": rng.random(rows),
        })
        frames.append(df)
        ctable.fromdataframe(df, str(tmp_path / f"shard_{i}.bcolzs"))
    return pd.concat(frames, ignore_index=True)


def test_two_process_psum_merge(tmp_path):
    full = _write_shards(tmp_path, 5_000)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER_SCRIPT)
    out_path = str(tmp_path / "result.json")
    _run_ranks(script, [str(tmp_path), out_path])

    results = []
    for proc_id in (0, 1):
        with open(f"{out_path}.{proc_id}") as fh:
            results.append(json.load(fh))
    assert results[0] == results[1]
    got = results[0]

    by_g = full.groupby("g")
    assert got["groupby"]["g"] == sorted(full["g"].unique().tolist())
    assert got["groupby"]["s"] == by_g["v"].sum().tolist()
    assert got["groupby"]["lo"] == by_g["v"].min().tolist()
    assert got["groupby"]["hi"] == by_g["w"].max().tolist()
    assert got["groupby"]["n"] == by_g["v"].count().tolist()
    pos = full[full["w"] > 0].groupby("g")["w"].sum()
    assert got["bundle"][0]["g"] == pos.index.tolist()
    assert got["bundle"][0]["ws"] == pos.tolist()
    assert got["bundle"][1]["vmax"] == by_g["v"].max().tolist()
    assert got["dag"]["s"] == by_g["v"].sum().tolist()
    for g, top in zip(got["dag"]["g"], got["dag"]["t3"]):
        want = np.sort(full.loc[full["g"] == g, "w"].to_numpy())[::-1][:3]
        assert top == want.tolist()
    for g, p50 in zip(got["dag"]["g"], got["dag"]["p50"]):
        vals = np.sort(full.loc[full["g"] == g, "f"].to_numpy())
        exact = vals[int(np.floor(0.5 * (len(vals) - 1)))]
        assert abs(p50 - exact) <= 0.01 * abs(exact) + 1e-9


def test_psum_ranks_with_unequal_devices_refuse(tmp_path):
    """The psum layout gives rank ``r`` the pack's rows ``[r * n_dev, (r +
    1) * n_dev)``; ranks running 4 and 2 devices would count rows twice or
    drop them, so the first psum query raises in both ranks."""
    _write_shards(tmp_path, 500)
    script = tmp_path / "unequal.py"
    script.write_text(_UNEQUAL_SCRIPT)
    for out in _run_ranks(script, [str(tmp_path)]):
        assert "refused:" in out, out


@pytest.mark.parametrize("count,world,want", [
    (1, 2, [(0,), (0,)]),
    (2, 2, [(0,), (1,)]),
    (4, 2, [(0, 1), (2, 3)]),
    (5, 2, [(0, 1), (2, 3)]),
    (3, 4, [(0,), (1,), (2,), (0,)]),
])
def test_rank_cards_are_disjoint(count, world, want):
    from bqueryd_tpu_torch import ops

    assert [ops.rank_cards(count, r, world) for r in range(world)] == want


def test_joined_rank_executor_runs_its_own_cards(monkeypatch):
    """In a joined job an executor left to every visible card takes its
    rank's block (``ops.rank_cards``), never a card of another rank; an
    explicit count or list is taken as given."""
    import torch

    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.parallel.executor import resolve_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = {}
    for rank in (0, 1):
        monkeypatch.setattr(ops, "_distributed",
                            {"backend": "nccl", "rank": rank,
                             "world_size": 2})
        cards[rank] = resolve_devices("cuda", None)
    assert cards == {0: (torch.device("cuda", 0), torch.device("cuda", 1)),
                     1: (torch.device("cuda", 2), torch.device("cuda", 3))}
    assert resolve_devices("cuda:2", 1) == (torch.device("cuda", 2),)
    monkeypatch.setattr(ops, "_distributed", None)
    assert len(resolve_devices("cuda", None)) == 4

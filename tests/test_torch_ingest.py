"""The port's append verb, its worker caches and its table identity.

``tests/test_ingest.py``'s cases through the port, on the CPU
(``device="cpu"``), beside the JAX package where the two compare:

* storage: one identity per table instance, pinned at the worker's open
  (one ``stat``, a ``realpath`` memoized per rootdir), naming the snapshot
  the instance reads; an append's rename gives the next open a new one;
  an all-null dict column is written and appended and the JAX reader reads
  it;
* the worker (``WorkerNode.handle_work``): the delta cache refreshes a
  grown shard group from its appended chunks alone, equal to a cold
  recompute; after an append no repeat query returns the pre-append result
  from the result cache, the delta cache, the executor's working set or
  the engine's factorize cache;
* a port cluster (threads over TCP ZMQ on 127.0.0.1): ``RPC.append`` to
  every holder, once per shared data_dir, its errors, the delta route
  reported to the client, and ``RPC.query`` chunk-prune parity;
* two faults of the JAX engine that the port answers right, held against
  pandas: zero-row shards and uint64 filter values past 2^63.
"""

import importlib
import logging
import os
import threading
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.ops import workingset as jax_workingset
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch.messages import CalcMessage
from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.ops.workingset import (
    DeltaAggCache,
    growth_since,
    table_growth_base,
)
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.rpc import LocalRPC
from bqueryd_tpu_torch.storage.ctable import ctable, table_cache_key
from tests.conftest import wait_until
from test_ingest import _frame
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

QUIET = logging.WARNING
RPC_TIMEOUT = 30
CPU = "cpu"
#: the module (the storage package exports its class under the same name)
ctable_mod = importlib.import_module("bqueryd_tpu_torch.storage.ctable")
AGGS = [["v", "sum", "vs"], ["f", "mean", "fm"], ["v", "min", "vmin"]]


@pytest.fixture
def mem_store_url():
    """A fresh mem:// store of the port's coordination module."""
    return f"mem://torch-ingest-{os.urandom(4).hex()}"


def _worker(data_dir, url):
    from bqueryd_tpu_torch.worker import WorkerNode

    return WorkerNode(coordination_url=url, data_dir=str(data_dir),
                      loglevel=QUIET, device=CPU)


def _msg(filenames, aggs=None, where=None):
    msg = CalcMessage({"payload": "groupby", "token": "00"})
    msg.set_args_kwargs([filenames, ["g"], aggs or AGGS, where or []], {})
    return msg


def _append_msg(filename, frame):
    msg = CalcMessage({"payload": "append", "token": "append_00"})
    msg.set_args_kwargs([filename, frame], {})
    return msg


def _result(reply):
    order, columns = hostmerge.finalize_table(hostmerge.merge_payloads(
        [ResultPayload.from_bytes(reply["data"])]))
    return pd.DataFrame({c: columns[c] for c in order}, columns=order)


def _expected(df, aggs=None, where=()):
    for col, op, value in where:
        df = df[{">": df[col] > value, "<": df[col] < value}[op]]
    spec = {out: (col, "mean" if op == "mean" else op)
            for col, op, out in (aggs or AGGS)}
    return df.groupby("g", as_index=False).agg(**spec)


def _check(got, want, aggs=None):
    got = got.sort_values("g").reset_index(drop=True)
    want = want.sort_values("g").reset_index(drop=True)
    np.testing.assert_array_equal(got["g"].to_numpy(), want["g"].to_numpy())
    for _col, op, out in aggs or AGGS:
        if op == "mean":
            np.testing.assert_allclose(got[out].to_numpy(),
                                       want[out].to_numpy(), rtol=2e-5)
        else:
            np.testing.assert_array_equal(got[out].to_numpy(),
                                          want[out].to_numpy())


# -- storage -------------------------------------------------------------------

def test_open_pins_one_identity_per_snapshot(tmp_path, mem_store_url,
                                             monkeypatch):
    root = str(tmp_path / "t.bcolzs")
    ctable.fromdataframe(_frame(300), root, chunklen=100)
    worker = _worker(tmp_path, mem_store_url)
    try:
        first = worker._open_table(root)
        assert first.identity == ctable_mod.rootdir_cache_key(root)
        calls = []
        real = os.path.realpath
        monkeypatch.setattr(os.path, "realpath",
                            lambda p: calls.append(p) or real(p))

        def no_stat_identity(rootdir):
            if rootdir is not None:  # a view has no rootdir of its own
                raise AssertionError("a pinned table took a stat identity")

        monkeypatch.setattr(ctable_mod, "rootdir_cache_key", no_stat_identity)
        # a warm open: the cached instance, no realpath; its cache key and
        # its views read the pinned identity
        assert worker._open_table(root) is first
        key = table_cache_key(first)
        view_key = table_cache_key(first.chunk_view([1, 2]))
        assert calls == []
        assert key == first.identity + (300,)
        # an append renames a new meta.json: the next open is a new
        # instance of the grown snapshot, and the old one keeps its rows
        ctable(root, mode="a").append(
            {c: v.to_numpy() for c, v in _frame(50, seed=1, offset=300)
             .items()})
        grown = worker._open_table(root)
        assert grown is not first and calls == []
        assert grown.nrows == 350 and first.nrows == 300
        assert len(first.column_raw("v")) == 300
        assert table_cache_key(grown) != key
        assert table_cache_key(grown.chunk_view([1, 2])) != view_key
        assert grown.identity[0] == first.identity[0]
    finally:
        worker.socket.close()


def test_mid_append_reader_keeps_its_snapshot(tmp_path, mem_store_url):
    """A reader opened mid-append (column index grown, meta.json not yet
    renamed) reads its committed snapshot, and its pinned identity is that
    snapshot's."""
    root = str(tmp_path / "t.bcolzs")
    ctable.fromdataframe(_frame(300), root, chunklen=100)
    torn = ctable(root, mode="a")
    torn._append_physical("v", np.arange(50, dtype=np.int64))
    worker = _worker(tmp_path, mem_store_url)
    try:
        reader = worker._open_table(root)
        assert reader.nrows == 300
        assert len(reader.column_raw("v")) == 300
        assert len(reader.committed_chunks("v")) == 3
        assert reader.identity == ctable_mod.rootdir_cache_key(root)
    finally:
        worker.socket.close()


def test_zone_maps_match_reference(tmp_path):
    """The port's writer stores the per-chunk zone maps the JAX reader
    reads (NaN and NaT skipped, an all-NaT chunk without one)."""
    root = str(tmp_path / "t.bcolzs")
    df = _frame(1000)
    ctable.fromdataframe(df, root, chunklen=100)
    nulls = pd.DataFrame({c: df[c].iloc[:2] for c in df.columns})
    nulls["f"] = np.float32(np.nan)
    nulls["ts"] = pd.NaT
    ctable(root, mode="a").append_dataframe(nulls)
    port, ref = ctable(root), jax_ctable(root)
    for col in ("seq", "ts", "f", "v", "s"):
        assert port.chunk_zone_maps(col) == ref.chunk_zone_maps(col), col
    assert port.chunk_zone_maps("ts")[-1] is None
    assert port.chunk_zone_maps("seq")[0] == (0, 99)
    assert port.col_stats("seq") == ref.col_stats("seq") == (0, 999)


def test_torn_append_repaired_and_snapshots_cached_apart(tmp_path):
    """A crash between the column data and the meta.json commit leaves
    uncommitted chunks that the next append drops; a reader opened before
    an append keeps decoding its snapshot from the column cache."""
    root = str(tmp_path / "t.bcolzs")
    ctable.fromdataframe(_frame(300), root, chunklen=100)
    old_reader = ctable(root)
    assert len(old_reader.column_raw("v")) == 300
    ctable(root, mode="a")._append_physical("v", np.arange(50,
                                                            dtype=np.int64))
    extra = _frame(40, seed=1, offset=300)
    ctable(root, mode="a").append_dataframe(extra)
    t = ctable(root)
    assert t.nrows == 340 and len({len(t.committed_chunks(c))
                                   for c in t.names}) == 1
    np.testing.assert_array_equal(t.column_raw("v")[-40:],
                                  extra["v"].to_numpy())
    np.testing.assert_array_equal(t.column_raw("v"),
                                  jax_ctable(root).column_raw("v"))
    assert len(old_reader.column_raw("v")) == 300


def test_growth_since_matches_reference(tmp_path):
    root = str(tmp_path / "t.bcolzs")
    ctable.fromdataframe(_frame(300), root, chunklen=100)
    base = table_growth_base(ctable(root))
    assert base == jax_workingset.table_growth_base(jax_ctable(root))
    assert growth_since(base, ctable(root)) == []
    ctable(root, mode="a").append_dataframe(_frame(150, seed=9, offset=300))
    assert growth_since(base, ctable(root)) == [3, 4] == (
        jax_workingset.growth_since(base, jax_ctable(root)))
    ctable.fromdataframe(
        pd.concat([_frame(300, seed=31), _frame(150, seed=32, offset=300)],
                  ignore_index=True),
        root, chunklen=100,
    )
    assert growth_since(base, ctable(root)) is None
    cache = DeltaAggCache()
    assert cache.store(("k",), [ctable(root)], b"x")
    assert cache.refresh_ids(cache.get(("k",)), [ctable(root)]) == [[]]
    cache.discard(("k",))
    assert cache.get(("k",)) is None


@pytest.mark.parametrize("via", ["dataframe", "mapping"])
def test_all_null_dict_column_is_written_and_appended(tmp_path, via):
    """A string column with no value at all: the port writes the shard,
    appends all-null and mixed batches to it, and the JAX reader reads
    it."""
    root = str(tmp_path / "n.bcolzs")
    first = {"g": np.array([0, 1, 0], dtype=np.int64),
             "s": np.array([None, None, None], dtype=object)}
    nulls = {"g": np.array([1, 1], dtype=np.int64),
             "s": np.array([None, np.nan], dtype=object)}
    mixed = {"g": np.array([0, 1], dtype=np.int64),
             "s": np.array(["a", None], dtype=object)}
    if via == "dataframe":
        ctable.fromdataframe(pd.DataFrame(first), root, chunklen=2)
        for batch in (nulls, mixed):
            ctable(root, mode="a").append_dataframe(pd.DataFrame(batch))
    else:
        t = ctable(root, mode="w", chunklen=2)
        t.append(first)
        for batch in (nulls, mixed):
            ctable(root, mode="a").append(batch)
    port, ref = ctable(root), jax_ctable(root)
    assert port.kind("s") == ref.kind("s") == "dict"
    want = [None] * 5 + ["a", None]
    assert list(port.column("s")) == want
    assert list(ref.column("s")) == want
    np.testing.assert_array_equal(ref.column_raw("s"),
                                  [-1, -1, -1, -1, -1, 0, -1])
    order, cols = LocalRPC(str(tmp_path), device=CPU).groupby(
        ["n.bcolzs"], ["s"], [["g", "sum", "gs"]], [])
    assert list(cols["s"]) == ["a"] and list(cols["gs"]) == [0]


# -- the worker ----------------------------------------------------------------

def test_worker_delta_serves_after_append(tmp_path, mem_store_url,
                                          monkeypatch):
    """Fresh compute records the delta base; an append makes the repeat a
    delta refresh over the appended rows alone, equal to a cold recompute
    and to pandas; a second append refreshes again."""
    root = str(tmp_path / "t.bcolzs")
    df = _frame(1500, seed=13)
    ctable.fromdataframe(df, root, chunklen=256)
    worker = _worker(tmp_path, mem_store_url)
    try:
        first = worker.handle_work(_msg(["t.bcolzs"]))
        assert first["effective_strategy"] != "delta"
        assert "delta" in first["phase_timings"]
        frames = [df]
        for cycle in range(2):
            extra = _frame(120, seed=14 + cycle,
                           offset=1500 + 120 * cycle)
            worker.handle_work(_append_msg("t.bcolzs", extra))
            frames.append(extra)
            second = worker.handle_work(_msg(["t.bcolzs"]))
            assert second["effective_strategy"] == "delta"
            assert second["merge_mode"] == "host"
            assert worker.delta_refreshes == cycle + 1
            assert worker.delta_cache().delta_rows == 120 * (cycle + 1)
            _check(_result(second),
                   _expected(pd.concat(frames, ignore_index=True)))
        # a cold recompute with the delta cache off gives the same answer
        monkeypatch.setenv("BQUERYD_TPU_DELTA_SERVE", "0")
        monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
        worker._result_cache = None
        worker.clear_caches()
        third = worker.handle_work(_msg(["t.bcolzs"]))
        assert third.get("effective_strategy") not in ("delta", "cached")
        got, want = _result(second), _result(third)
        _check(got, want)
    finally:
        worker.socket.close()


def test_worker_delta_filtered_group_of_shards(tmp_path, mem_store_url,
                                               monkeypatch):
    """A filtered query over two shards, one of which grows: the refresh
    aggregates the grown shard's tail alone (filter applied), and equals
    pandas over both shards."""
    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
    frames = {}
    for i in range(2):
        frames[i] = _frame(900, seed=40 + i, offset=900 * i)
        ctable.fromdataframe(frames[i], str(tmp_path / f"s{i}.bcolzs"),
                             chunklen=200)
    names = ["s0.bcolzs", "s1.bcolzs"]
    where = [["seq", ">", 500]]
    worker = _worker(tmp_path, mem_store_url)
    try:
        worker.handle_work(_msg(names, where=where))
        # an unchanged repeat with the result cache off recomputes
        again = worker.handle_work(_msg(names, where=where))
        assert again.get("effective_strategy") not in ("delta", "cached")
        extra = _frame(333, seed=42, offset=1800)
        worker.handle_work(_append_msg("s1.bcolzs", extra))
        reply = worker.handle_work(_msg(names, where=where))
        assert reply["effective_strategy"] == "delta"
        full = pd.concat([frames[0], frames[1], extra], ignore_index=True)
        _check(_result(reply), _expected(full, where=[("seq", ">", 500)]))
    finally:
        worker.socket.close()


def test_worker_delta_ineligible_shapes_recompute(tmp_path, mem_store_url):
    root = str(tmp_path / "t.bcolzs")
    df = _frame(800, seed=15)
    ctable.fromdataframe(df, root, chunklen=128)
    worker = _worker(tmp_path, mem_store_url)
    aggs = [["v", "count_distinct", "vd"]]
    try:
        worker.handle_work(_msg(["t.bcolzs"], aggs=aggs))
        extra = _frame(50, seed=16, offset=800)
        worker.handle_work(_append_msg("t.bcolzs", extra))
        reply = worker.handle_work(_msg(["t.bcolzs"], aggs=aggs))
        assert reply.get("effective_strategy") not in ("delta", "cached")
        assert worker.delta_refreshes == 0
        want = pd.concat([df, extra]).groupby("g", as_index=False).agg(
            vd=("v", "nunique"))
        _check(_result(reply), want, aggs=[["v", "count", "vd"]])
    finally:
        worker.socket.close()


@pytest.mark.parametrize("cache", ["result", "delta", "workingset",
                                   "factorize"])
def test_no_pre_append_result_after_an_append(tmp_path, mem_store_url,
                                              monkeypatch, cache):
    """After an append through the worker, a repeated query never returns
    the pre-append result: not from the result cache (on, delta off), the
    delta cache (on, result cache off), the executor's working set (both
    off) or the engine's factorize cache (the per-shard engine path of a
    count_distinct query)."""
    on = {"result": ("256000000", "0"), "delta": ("0", "1"),
          "workingset": ("0", "0"), "factorize": ("0", "0")}[cache]
    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", on[0])
    monkeypatch.setenv("BQUERYD_TPU_DELTA_SERVE", on[1])
    aggs = ([["v", "count_distinct", "vd"], ["v", "sum", "vs"]]
            if cache == "factorize" else AGGS)
    check_aggs = ([["v", "count", "vd"], ["v", "sum", "vs"]]
                  if cache == "factorize" else AGGS)
    root = str(tmp_path / "t.bcolzs")
    df = _frame(1000, seed=50)
    ctable.fromdataframe(df, root, chunklen=128)
    worker = _worker(tmp_path, mem_store_url)

    def expected(frame):
        if cache != "factorize":
            return _expected(frame)
        return frame.groupby("g", as_index=False).agg(
            vd=("v", "nunique"), vs=("v", "sum"))

    try:
        for _ in range(2):
            reply = worker.handle_work(_msg(["t.bcolzs"], aggs=aggs))
        if cache == "result":
            assert reply["effective_strategy"] == "cached"
        ws = worker.executor.workingset.stats()
        factorized = len(worker.engine._factorize_cache)
        # an append that changes every group's answer
        extra = _frame(300, seed=51, offset=1000)
        extra["v"] = extra["v"] + 1000
        worker.handle_work(_append_msg("t.bcolzs", extra))
        reply = worker.handle_work(_msg(["t.bcolzs"], aggs=aggs))
        _check(_result(reply),
               expected(pd.concat([df, extra], ignore_index=True)),
               aggs=check_aggs)
        route = reply.get("effective_strategy")
        assert route != "cached"
        assert (route == "delta") == (cache == "delta")
        if cache == "workingset":
            after = worker.executor.workingset.stats()
            for seg in ("align", "codes", "blocks"):
                assert after[seg]["misses"] > ws[seg]["misses"], seg
        if cache == "factorize":
            assert len(worker.engine._factorize_cache) > factorized
    finally:
        worker.socket.close()


def test_worker_errors(tmp_path, mem_store_url, monkeypatch):
    ctable.fromdataframe(_frame(100), str(tmp_path / "t.bcolzs"))
    worker = _worker(tmp_path, mem_store_url)
    try:
        with pytest.raises(ValueError, match="does not exist"):
            worker.handle_work(_msg(["nope.bcolzs"]))
        with pytest.raises(ValueError, match="does not exist"):
            worker.handle_work(_append_msg("nope.bcolzs", _frame(5)))
        with pytest.raises(ValueError, match="escapes data_dir"):
            worker.handle_work(_append_msg("../t.bcolzs", _frame(5)))
        monkeypatch.setenv("BQUERYD_TPU_APPEND", "0")
        with pytest.raises(ValueError, match="streaming append disabled"):
            worker.handle_work(_append_msg("t.bcolzs", _frame(5)))
    finally:
        worker.socket.close()


# -- the port cluster ------------------------------------------------------------

def _start(nodes):
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    return threads


@contextmanager
def _running(nodes):
    threads = _start(nodes)
    try:
        yield
    finally:
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads), "a node did not stop"


def _controller(url, run_dir):
    from bqueryd_tpu_torch.controller import ControllerNode

    return ControllerNode(coordination_url=url, loglevel=QUIET,
                          runfile_dir=str(run_dir), heartbeat_interval=0.1)


def _rpc(url):
    from bqueryd_tpu_torch.rpc import RPC

    return RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
               loglevel=QUIET)


@pytest.fixture
def ingest_cluster(tmp_path, mem_store_url, monkeypatch):
    """A port controller and one calc worker serving one chunked shard."""
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    df = _frame(3000, seed=18)
    ctable.fromdataframe(df, str(tmp_path / "t.bcolzs"), chunklen=256)
    controller = _controller(mem_store_url, tmp_path)
    worker = _worker(tmp_path, mem_store_url)
    worker.heartbeat_interval = 0.1
    worker.poll_timeout = 0.05
    with _running([controller, worker]):
        wait_until(lambda: "t.bcolzs" in controller.files_map,
                   desc="shard registration")
        rpc = _rpc(mem_store_url)
        try:
            yield {"rpc": rpc, "controller": controller, "worker": worker,
                   "df": df}
        finally:
            rpc._close_socket()


def _frame_of(result):
    order, columns = result
    return pd.DataFrame({c: columns[c] for c in order}, columns=order)


@pytest.mark.parametrize("via", ["dataframe", "mapping"])
def test_rpc_append_end_to_end(ingest_cluster, via):
    rpc = ingest_cluster["rpc"]
    worker = ingest_cluster["worker"]
    q = (["t.bcolzs"], ["g"], AGGS, [])
    first = _frame_of(rpc.groupby(*q))
    extra = _frame(240, seed=19, offset=3000)
    batch = extra if via == "dataframe" else {
        c: extra[c].to_numpy() for c in extra.columns}
    res = rpc.append("t.bcolzs", batch)
    assert res["appended"] == 240 and res["filename"] == "t.bcolzs"
    assert list(res["holders"]) == [worker.worker_id]
    assert res["holders"][worker.worker_id]["rows"] == 3240
    got = _frame_of(rpc.groupby(*q))
    assert rpc.last_call_strategies["effective"] == {"t.bcolzs": "delta"}
    assert rpc.last_call_merge_modes == {"t.bcolzs": "host"}
    assert worker.delta_refreshes == 1
    assert worker.append_rows == 240
    full = pd.concat([ingest_cluster["df"], extra], ignore_index=True)
    _check(got, _expected(full))
    assert len(first) == len(got)
    # the refreshed result went to the result cache: the next repeat hits
    _check(_frame_of(rpc.groupby(*q)), _expected(full))
    assert rpc.last_call_strategies["effective"] == {"t.bcolzs": "cached"}


def test_rpc_append_unknown_file(ingest_cluster):
    from bqueryd_tpu_torch.rpc import RPCError

    with pytest.raises(RPCError, match="not served by any worker"):
        ingest_cluster["rpc"].append("nope.bcolzs", _frame(5))


def test_rpc_append_disabled_worker(ingest_cluster, monkeypatch):
    from bqueryd_tpu_torch.rpc import RPCError

    monkeypatch.setenv("BQUERYD_TPU_APPEND", "0")
    with pytest.raises(RPCError, match="streaming append disabled") as err:
        ingest_cluster["rpc"].append("t.bcolzs", _frame(5))
    assert ingest_cluster["worker"].worker_id in str(err.value)


def test_rpc_append_mismatched_columns_names_the_holder(ingest_cluster):
    from bqueryd_tpu_torch.rpc import RPCError

    with pytest.raises(RPCError, match="different columns") as err:
        ingest_cluster["rpc"].append(
            "t.bcolzs", pd.DataFrame({"g": np.zeros(3, dtype=np.int64)}))
    assert ingest_cluster["worker"].worker_id in str(err.value)
    # the cluster still answers
    assert ingest_cluster["rpc"].ping() == "pong"


def test_rpc_append_dedupes_shared_datadir(tmp_path, mem_store_url,
                                           monkeypatch):
    """Two workers serving the SAME (node, data_dir) are one physical
    replica: the append applies once."""
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    root = str(tmp_path / "t.bcolzs")
    ctable.fromdataframe(_frame(500, seed=21), root, chunklen=100)
    controller = _controller(mem_store_url, tmp_path)
    workers = [_worker(tmp_path, mem_store_url) for _ in range(2)]
    for w in workers:
        w.heartbeat_interval = 0.1
        w.poll_timeout = 0.05
    with _running([controller] + workers):
        wait_until(lambda: len(controller.files_map.get("t.bcolzs") or ())
                   == 2, desc="both workers advertising")
        rpc = _rpc(mem_store_url)
        try:
            res = rpc.append("t.bcolzs", _frame(50, seed=22, offset=500))
        finally:
            rpc._close_socket()
    assert len(res["holders"]) == 1, "shared data_dir = one append"
    assert ctable(root).nrows == 550
    assert sum(w.appends for w in workers) == 1


def test_rpc_query_chunk_prune_parity(ingest_cluster, monkeypatch):
    """``RPC.query`` pushdown predicates prune chunks by their zone maps;
    the result equals the unpruned path's exactly."""
    rpc = ingest_cluster["rpc"]
    spec = {"table": ["t.bcolzs"], "groupby": ["g"],
            "aggs": [["v", "sum", "vs"], ["v", "topk", "top2", {"k": 2}]],
            "where": [["seq", ">", 2700]]}
    pruned = _frame_of(rpc.query(spec))
    timings = rpc.last_call_timings["t.bcolzs"]
    assert timings["_chunks_skipped"] >= 10 and timings["_chunks_decoded"] >= 1
    monkeypatch.setenv("BQUERYD_TPU_CHUNK_PRUNE", "0")
    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
    ingest_cluster["worker"]._result_cache = None
    full = _frame_of(rpc.query(spec))
    assert "_chunks_skipped" not in rpc.last_call_timings["t.bcolzs"]
    ingest_cluster["worker"]._result_cache = None
    a = pruned.sort_values("g").reset_index(drop=True)
    b = full.sort_values("g").reset_index(drop=True)
    np.testing.assert_array_equal(a["vs"], b["vs"])
    for x, y in zip(a["top2"], b["top2"]):
        np.testing.assert_array_equal(x, y)
    df = ingest_cluster["df"]
    want = df[df["seq"] > 2700].groupby("g")["v"].sum()
    np.testing.assert_array_equal(a["vs"], want.to_numpy())


# -- faults of the JAX engine that the port answers right ---------------------

def _write(frame, path):
    t = ctable(path, mode="w")
    t.append(frame)
    return path


@pytest.mark.parametrize("aggs", [
    [["v", "sum", "vs"], ["v", "count", "n"]],
    [["v", "count_distinct", "vd"]],
])
def test_zero_row_shards_answer_like_pandas(tmp_path, aggs):
    """A zero-row shard alone answers with no groups; beside a non-empty
    shard, with that shard's groups (executor and per-shard engine)."""
    empty = {"g": np.zeros(0, dtype=np.int64),
             "v": np.zeros(0, dtype=np.int64)}
    full = {"g": np.array([2, 1, 2, 2], dtype=np.int64),
            "v": np.array([5, 7, 9, 9], dtype=np.int64)}
    _write(empty, str(tmp_path / "e.bcolzs"))
    _write(full, str(tmp_path / "f.bcolzs"))
    rpc = LocalRPC(str(tmp_path), device=CPU)
    order, cols = rpc.groupby(["e.bcolzs"], ["g"], aggs, [])
    assert all(len(cols.get(c, [])) == 0 for c in order)
    df = pd.DataFrame(full)
    named = {out: ("v", "nunique" if op == "count_distinct" else op)
             for _c, op, out in aggs}
    want = df.groupby("g", as_index=False).agg(**named)
    for files in (["e.bcolzs", "f.bcolzs"], ["f.bcolzs", "e.bcolzs"]):
        order, cols = rpc.groupby(files, ["g"], aggs, [])
        got = pd.DataFrame({c: cols[c] for c in order}).sort_values("g")
        for c in want.columns:
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          want[c].to_numpy())


@pytest.mark.parametrize("op", [">", ">=", "==", "<=", "!="])
@pytest.mark.parametrize("aggs", [
    [["w", "sum", "ws"]],
    [["w", "count_distinct", "wd"]],
])
def test_uint64_filter_past_int64_like_pandas(tmp_path, op, aggs):
    """A filter value at or past 2^63 on a uint64 column selects the rows
    pandas selects, on the executor and on the per-shard engine."""
    big = np.uint64(2**63)
    u = np.array([1, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 1, 2**63 + 5],
                 dtype=np.uint64)
    frame = {"g": np.array([0, 1, 0, 1, 0, 2], dtype=np.int64), "u": u,
             "w": np.arange(6, dtype=np.int64)}
    _write(frame, str(tmp_path / "u.bcolzs"))
    rpc = LocalRPC(str(tmp_path), device=CPU)
    for value in (int(big), int(big) + 5, 2**64 - 1):
        order, cols = rpc.groupby(["u.bcolzs"], ["g"], aggs,
                                  [["u", op, value]])
        df = pd.DataFrame(frame)
        keep = {">": df["u"] > value, ">=": df["u"] >= value,
                "==": df["u"] == value, "<=": df["u"] <= value,
                "!=": df["u"] != value}[op]
        named = {out: ("w", "nunique" if o == "count_distinct" else o)
                 for _c, o, out in aggs}
        want = df[keep].groupby("g", as_index=False).agg(**named)
        if want.empty:
            assert order == [] and cols == {}
            continue
        got = pd.DataFrame({c: cols[c] for c in order}).sort_values("g")
        for c in want.columns:
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          want[c].to_numpy())

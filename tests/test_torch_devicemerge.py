"""The port's device merge against the JAX package's.

``bqueryd_tpu_torch.parallel.devicemerge`` merges the executor's
per-device partial tables over a list of torch devices; here eight logical
CPU devices (``MeshQueryExecutor(device="cpu", n_devices=8)``) stand
beside the JAX executor on the 8 virtual CPU devices of
``tests/conftest.py``.  ``tests/test_devicemerge.py``'s ``MERGE_CASES`` and
fixture data run through both packages in device mode and under the
``BQUERYD_TPU_DEVICE_MERGE=0`` kill switch (host mode); then the span
partitioner, the bucketized emission, the merges themselves, the mode
contract, ``MergeStats``, the kill switch's ``hostmerge`` route and byte
accounting, bundles and the DAG fast path at 8 devices, the working set,
health probe and memory profile over several devices, and ``merge_mode``
on the wire through a port cluster whose worker runs 4 devices.

Tolerances: keys, row counts and ints bit for bit; floats within
``tests/test_differential_fuzz.py:_compare`` (rtol 2e-5, atol 1e-6).
"""

import logging
import os
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
from bqueryd_tpu.parallel import devicemerge as jax_devicemerge
from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
from bqueryd_tpu.parallel.executor import MeshQueryExecutor as JaxExecutor
from bqueryd_tpu.parallel.executor import make_mesh
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import ops
from bqueryd_tpu_torch.models.query import GroupByQuery
from bqueryd_tpu_torch.ops import groupby as tg
from bqueryd_tpu_torch.ops.workingset import WorkingSet
from bqueryd_tpu_torch.parallel import devicemerge, hostmerge, opexec
from bqueryd_tpu_torch.parallel import executor as executor_mod
from bqueryd_tpu_torch.parallel.executor import (
    DagFastPathUnsupported,
    MeshQueryExecutor,
)
from bqueryd_tpu_torch.storage.ctable import ctable
from test_dag_fastpath import ALPHA, _dim
from test_dag_fastpath import _dataset as _dag_dataset
from test_devicemerge import MERGE_CASES, merge_shards  # noqa: F401
from test_differential_fuzz import _compare
from tests.conftest import wait_until
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

CPU = "cpu"
N_DEV = 8
QUIET = logging.WARNING
RTOL, ATOL = 2e-5, 1e-6


def _frame(payload, gcols):
    df = jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads([dict(payload)]))
    return df.sort_values(gcols).reset_index(drop=True)


def _port_tables(tables):
    return [ctable(t.rootdir, mode="r") for t in tables]


def _aggs_of(case):
    return [list(a) for a in MERGE_CASES[case][1]]


@pytest.fixture(scope="module")
def port_executors():
    """One 8-device and one 1-device port executor, kept across cases."""
    return (MeshQueryExecutor(device=CPU, n_devices=N_DEV),
            MeshQueryExecutor(device=CPU))


# -- execute() against the JAX executor, both modes ----------------------------

@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("case", range(len(MERGE_CASES)))
def test_execute_matches_jax_at_8_devices(merge_shards, port_executors,
                                          monkeypatch, case, mode):
    """The port's 8-device executor answers every merge case as the JAX
    executor on its 8 devices does, in device mode and under the kill
    switch, and as the port's own single device does."""
    _df, tables = merge_shards
    gcols, aggs, where = MERGE_CASES[case]
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE",
                       "1" if mode == "device" else "0")
    eight, one = port_executors
    query = GroupByQuery(gcols, _aggs_of(case), where)
    got = _frame(eight.execute(_port_tables(tables), query), gcols)
    assert eight.last_merge_mode == mode
    jax_ex = JaxExecutor(mesh=make_mesh())
    want = _frame(jax_ex.execute(
        tables, JaxQuery(gcols, aggs, where, aggregate=True)), gcols)
    assert jax_ex.last_merge_mode == mode
    _compare(got, want, gcols, aggs)
    solo = _frame(one.execute(_port_tables(tables), query), gcols)
    _compare(got, solo, gcols, aggs)


def test_kill_switch_routes_through_hostmerge(merge_shards, monkeypatch):
    """Under ``=0`` the executor merges one payload per device through
    ``hostmerge.merge_payloads``; in device mode it never calls it."""
    _df, tables = merge_shards
    query = GroupByQuery(["g"], [["big", "sum", "s"]])
    calls = []
    real = hostmerge.merge_payloads

    def spy(payloads):
        calls.append(len(payloads))
        return real(payloads)

    monkeypatch.setattr(hostmerge, "merge_payloads", spy)
    ex = MeshQueryExecutor(device=CPU, n_devices=N_DEV)
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "1")
    ex.execute(_port_tables(tables), query)
    assert calls == []
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "0")
    ex.execute(_port_tables(tables), query)
    assert calls == [N_DEV]


def test_byte_accounting_matches_one_table(merge_shards, monkeypatch):
    """Device mode fetches the final table (the bytes one device fetches)
    and saves the other devices' tables; host mode fetches every device's
    table and saves nothing."""
    _df, tables = merge_shards
    query = GroupByQuery(["g"], [["big", "sum", "s"],
                                 ["small", "min", "lo"]])
    stats = devicemerge.stats()

    def run(ex, mode):
        monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE",
                           "1" if mode == "device" else "0")
        before = stats.snapshot()
        ex.execute(_port_tables(tables), query)
        after = stats.snapshot()
        key = mode
        assert after["queries"][key] == before["queries"][key] + 1
        return (after["bytes_fetched"][key] - before["bytes_fetched"][key],
                after["d2h_bytes_saved"] - before["d2h_bytes_saved"])

    one_fetched, one_saved = run(MeshQueryExecutor(device=CPU), "device")
    assert one_fetched > 0 and one_saved == 0
    dev_fetched, dev_saved = run(
        MeshQueryExecutor(device=CPU, n_devices=N_DEV), "device")
    assert dev_fetched == one_fetched
    assert dev_saved == (N_DEV - 1) * one_fetched
    host_fetched, host_saved = run(
        MeshQueryExecutor(device=CPU, n_devices=N_DEV), "host")
    assert host_fetched == N_DEV * one_fetched and host_saved == 0


@pytest.mark.parametrize("n_devices", [1, 2, 3, 5, 8])
def test_any_device_count_matches_one(merge_shards, n_devices):
    """Spans that do not divide the group count (23 groups, bucketed) and
    owners whose span is all pad agree with one device, bit for bit on
    ints."""
    _df, tables = merge_shards
    gcols = ["g"]
    aggs = [["big", "sum", "s"], ["small", "max", "hi"],
            ["f64", "sum", "fs"], ["small", "count", "n"]]
    query = GroupByQuery(gcols, aggs)
    want = _frame(MeshQueryExecutor(device=CPU).execute(
        _port_tables(tables), query), gcols)
    ex = MeshQueryExecutor(device=CPU, n_devices=n_devices)
    got = _frame(ex.execute(_port_tables(tables), query), gcols)
    _compare(got, want, gcols, aggs)
    assert ex.workingset.stats()["codes"]["bytes"] > 0


# -- the span partitioner and the bucketized emission ---------------------------

@pytest.mark.parametrize("n_groups,n_dev", [
    (24, 8), (9, 8), (1, 8), (0, 8), (7, 1), (70_225, 8), (5, 3),
    (73_728, 4), (288, 2)])
def test_bucket_span_matches_reference(n_groups, n_dev):
    got = devicemerge.bucket_span(n_groups, n_dev)
    assert got == jax_devicemerge.bucket_span(n_groups, n_dev)
    span, padded = got
    assert padded >= n_groups and span * n_dev == padded
    assert max(g // span for g in range(min(n_groups, 1000))) < n_dev \
        if n_groups else True


def test_bucketize_partials_matches_reference():
    from bqueryd_tpu import ops as jax_ops

    rng = np.random.default_rng(5)
    codes = rng.integers(-1, 11, 4_000).astype(np.int32)
    vals = rng.integers(-(2**60), 2**60, 4_000).astype(np.int64)
    small = rng.integers(-100, 100, 4_000).astype(np.int8)
    measures, agg_ops = (vals, small, small), ("sum", "min", "max")
    want, want_span = jax_ops.partial_tables_bucketized(
        codes, measures, agg_ops, 11, 8)
    got, span = ops.partial_tables_bucketized(
        codes, measures, agg_ops, 11, 8, device=CPU)
    assert span == want_span == 2
    np.testing.assert_array_equal(got["rows"].numpy(),
                                  np.asarray(want["rows"]))
    for g, w in zip(got["aggs"], want["aggs"]):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy()[:11],
                                          np.asarray(w[k])[:11])
            assert g[k].shape[0] == 16
    # the pad tail: no rows, zero sums
    np.testing.assert_array_equal(got["rows"].numpy()[11:], 0)
    same, span = ops.bucketize_partials(got, 16, 8)
    assert same is got and span == 2


def _random_tree(rng, n, dtypes):
    rows = torch.from_numpy(rng.integers(0, 5, n).astype(np.int64))
    aggs = []
    for dt in dtypes:
        info = np.iinfo(dt) if np.dtype(dt).kind in "iu" else None
        if info is not None:
            lo, hi = max(info.min, -(2**62)), min(info.max, 2**62)
            v = rng.integers(lo, hi, n, dtype=np.int64 if lo < 0
                             else np.uint64).astype(dt)
        else:
            v = rng.standard_normal(n).astype(dt)
        aggs.append({"sum" if np.dtype(dt).kind != "u" else "max":
                     torch.from_numpy(v),
                     "min": torch.from_numpy(v[::-1].copy()),
                     "count": rows.clone()})
    return {"rows": rows, "aggs": tuple(aggs)}


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_scatter_merge_equals_an_elementwise_fold(n_dev):
    """Each owner's span of the merge is the elementwise fold of every
    device's tables over that span: sums add (mod 2^64), extrema of
    signed, unsigned 64-bit and float leaves take the extremum."""
    rng = np.random.default_rng(n_dev)
    n = 13
    dtypes = (np.int64, np.uint64, np.int16, np.float32)
    trees = [_random_tree(rng, n, dtypes) for _ in range(n_dev)]
    span, padded = devicemerge.bucket_span(n, n_dev)
    bucketized = [ops.bucketize_partials(t, n, n_dev)[0] for t in trees]
    owned = devicemerge.scatter_merge_partials(
        bucketized, [torch.device(CPU)] * n_dev, span)
    merged = {k: np.concatenate([o[k].numpy() if k == "rows" else None
                                 for o in owned]) for k in ("rows",)}
    np.testing.assert_array_equal(
        merged["rows"][:n], np.sum([t["rows"].numpy() for t in trees], 0))
    for i, dt in enumerate(dtypes):
        for kind in trees[0]["aggs"][i]:
            got = np.concatenate([o["aggs"][i][kind].numpy()
                                  for o in owned])[:n]
            parts = np.stack([t["aggs"][i][kind].numpy() for t in trees])
            if kind == "min":
                want = parts.min(0)
            elif kind == "max":
                want = parts.max(0)
            else:
                want = parts.sum(0, dtype=parts.dtype)
            assert got.dtype == want.dtype
            if np.dtype(dt).kind == "f" and kind == "sum":
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)
    one = devicemerge.reduce_partials(trees, torch.device(CPU))
    np.testing.assert_array_equal(one["rows"].numpy(), merged["rows"][:n])


@pytest.mark.parametrize("dtype,largest", [
    (np.int64, True), (np.int64, False), (np.int16, True),
    (np.float64, False), (np.float32, True), (np.uint64, True)])
def test_topk_reselect_equals_the_host_merge(dtype, largest):
    """The re-select of several devices' dense top-k tables equals the
    host k-way merge of their flat parts (``opexec.merge_topk_parts``),
    value lists bit for bit, zero-padded slots never winning."""
    rng = np.random.default_rng(3)
    n_groups, k, n_dev = 6, 4, 5
    values, counts, parts = [], [], []
    for _ in range(n_dev):
        cnt = rng.integers(0, k + 1, n_groups)
        raw = rng.integers(-50, 50, (n_groups, k))
        if np.dtype(dtype).kind == "u":
            raw = rng.integers(2**63 - 20, 2**63 + 20, (n_groups, k),
                               dtype=np.uint64)
        dense = np.sort(raw.astype(dtype), axis=1)
        if largest:
            dense = dense[:, ::-1]
        dense = np.where(np.arange(k)[None, :] < cnt[:, None], dense, 0)
        dense = np.ascontiguousarray(dense.astype(dtype))
        values.append(torch.from_numpy(dense))
        counts.append(torch.from_numpy(cnt.astype(np.int64)))
        flat, offs = opexec.dense_topk_to_flat(dense, cnt)
        parts.append((np.arange(n_groups), flat, offs))
    float_neg = np.dtype(dtype).kind == "f"
    top, cnt = devicemerge.topk_reselect(values, counts, k, largest,
                                         float_neg)
    got_flat, got_offs = opexec.dense_topk_to_flat(top.numpy(), cnt.numpy())
    want_flat, want_offs = opexec.merge_topk_parts(parts, k, largest,
                                                   n_groups)
    np.testing.assert_array_equal(got_offs, want_offs)
    np.testing.assert_array_equal(got_flat, want_flat)
    assert got_flat.dtype == np.dtype(dtype)


def test_scatter_merge_grid_adds_bucket_counts():
    rng = np.random.default_rng(8)
    grids = [torch.from_numpy(rng.integers(0, 9, (10, 7))) for _ in range(4)]
    span, _ = devicemerge.bucket_span(10, 4)
    padded = [tg._pad_leaf(g, 12 - 10) for g in grids]
    owned = devicemerge.scatter_merge_grid(padded, [torch.device(CPU)] * 4,
                                           span)
    got = torch.cat(owned).numpy()[:10]
    np.testing.assert_array_equal(got, sum(g.numpy() for g in grids))
    whole, = devicemerge.scatter_merge_grid(grids, [torch.device(CPU)] * 4,
                                            None)
    np.testing.assert_array_equal(whole.numpy(), got)


# -- the mode contract and MergeStats ----------------------------------------------

def test_resolve_mode_contract(monkeypatch):
    monkeypatch.delenv("BQUERYD_TPU_DEVICE_MERGE", raising=False)
    assert devicemerge.resolve_mode() == devicemerge.MODE_DEVICE
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "0")
    assert devicemerge.resolve_mode() == devicemerge.MODE_HOST
    assert not devicemerge.device_merge_enabled()
    # a multi-process job pins the psum mode regardless
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "1")
    monkeypatch.setattr(devicemerge, "_distributed_world", lambda: 2)
    assert devicemerge.resolve_mode() == devicemerge.MODE_PSUM
    assert (devicemerge.MODE_DEVICE, devicemerge.MODE_HOST,
            devicemerge.MODE_PSUM) == (jax_devicemerge.MODE_DEVICE,
                                       jax_devicemerge.MODE_HOST,
                                       jax_devicemerge.MODE_PSUM)
    # no torch.distributed group in this process: one world
    monkeypatch.undo()
    assert devicemerge._distributed_world() == 1
    assert ops.distributed_info() is None
    assert ops.maybe_init_distributed() is False


@pytest.mark.parametrize("cls", [devicemerge.MergeStats,
                                 jax_devicemerge.MergeStats])
def test_merge_stats_thread_safety(cls):
    """The port's MergeStats counts as the reference's does under four
    threads (both run the same sequence)."""
    stats = cls()

    def pound():
        for _ in range(500):
            stats.record("device", 100, saved=700)
            stats.record("host", 800)
            stats.record("psum", 10, saved=-5)

    threads = [threading.Thread(target=pound) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = stats.snapshot()
    assert snap["bytes_fetched"] == {"device": 4 * 500 * 110,
                                     "host": 4 * 500 * 800}
    assert snap["d2h_bytes_saved"] == 4 * 500 * 700
    assert snap["queries"] == {"device": 4000, "host": 2000}
    assert stats.fetched("device") == 220_000 and stats.count("host") == 2000
    stats.reset()
    assert stats.snapshot()["queries"] == {"device": 0, "host": 0}
    assert devicemerge.stats() is devicemerge.stats()


# -- bundles and the DAG fast path at 8 devices ---------------------------------

BUNDLE = [
    (["g"], [["big", "sum", "s"], ["small", "min", "lo"]], []),
    (["g"], [["small", "max", "hi"], ["f32", "mean", "m"]],
     [["sel", ">", 0.5]]),
    (["g"], [["big", "count", "n"], ["f64", "sum", "fs"]],
     [["sel", "<=", 0.25]]),
]


@pytest.mark.parametrize("mode", ["device", "host"])
def test_execute_bundle_matches_jax_at_8_devices(merge_shards, monkeypatch,
                                                 mode):
    _df, tables = merge_shards
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE",
                       "1" if mode == "device" else "0")
    ex = MeshQueryExecutor(device=CPU, n_devices=N_DEV)
    got = ex.execute_bundle(_port_tables(tables),
                            [GroupByQuery(g, a, w) for g, a, w in BUNDLE])
    assert ex.last_merge_mode == mode
    jax_ex = JaxExecutor(mesh=make_mesh())
    want = jax_ex.execute_bundle(
        tables, [JaxQuery(g, a, w, aggregate=True) for g, a, w in BUNDLE])
    solo = MeshQueryExecutor(device=CPU).execute_bundle(
        _port_tables(tables), [GroupByQuery(g, a, w) for g, a, w in BUNDLE])
    for (gcols, aggs, _w), p, j, s in zip(BUNDLE, got, want, solo):
        _compare(_frame(p, gcols), _frame(j, gcols), gcols, aggs)
        _compare(_frame(p, gcols), _frame(s, gcols), gcols, aggs)


@pytest.fixture(scope="module")
def dag_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_devmerge_dag")
    paths = []
    for i, df in enumerate(_dag_dataset()):
        p = str(root / f"dm_dag_{i}.bcolzs")
        jax_ctable.fromdataframe(df, p)
        paths.append(p)
    return paths


DAG_CASES = {
    "topk": {"groupby": ["g"],
             "aggs": [["v_int", "topk", "t5", {"k": 5}],
                      ["v_float", "topk", "f3", {"k": 3, "largest": False}],
                      ["v_big", "sum", "s"]]},
    "quantile": {"groupby": ["g"],
                 "aggs": [["v_ext", "quantile", "q1",
                           {"q": 0.1, "alpha": 0.02}],
                          ["v_float", "quantile", "p50",
                           {"q": 0.5, "alpha": ALPHA}]]},
    "join": {"groupby": ["region"],
             "aggs": [["v_int", "sum", "s"], ["weight", "max", "wmax"],
                      ["v_float", "mean", "m"]],
             "join": {"table": _dim(), "on": "cust",
                      "select": ["region", "weight"]}},
    "window": {"groupby": ["g", {"window": {"on": "t", "every": "1h",
                                            "alias": "hr"}}],
               "aggs": [["v_int", "sum", "s"], ["v_int", "min", "mn"],
                        ["u64", "max", "umax"]],
               "where": [["v_int", ">", -7]]},
}


def _same_payload(got, want):
    """Keys, rows, ints, top-k lists and sketch parts bit-equal (dtypes
    too); float sums and means within rtol 2e-5, atol 1e-6."""
    assert got["kind"] == want["kind"]
    for col in want["keys"]:
        np.testing.assert_array_equal(np.asarray(got["keys"][col]),
                                      np.asarray(want["keys"][col]))
    np.testing.assert_array_equal(got["rows"], want["rows"])
    for g, w in zip(got["aggs"], want["aggs"]):
        assert set(g) == set(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if b.dtype.kind == "f" and name != "topk_values":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(DAG_CASES))
def test_execute_dag_matches_jax_at_8_devices(dag_shards, case):
    from bqueryd_tpu.plan import dag as jax_dag
    from bqueryd_tpu_torch.plan import dag as dagmod

    spec = dict(DAG_CASES[case], table=["x"])
    ex = MeshQueryExecutor(device=CPU, n_devices=N_DEV)
    got = dict(ex.execute_dag([ctable(p, mode="r") for p in dag_shards],
                              dagmod.compile_query(spec)))
    assert ex.last_merge_mode == "device"
    want = dict(JaxExecutor(mesh=make_mesh()).execute_dag(
        [jax_ctable(p, mode="r") for p in dag_shards],
        jax_dag.compile_query(spec)))
    _same_payload(got, want)
    solo = dict(MeshQueryExecutor(device=CPU).execute_dag(
        [ctable(p, mode="r") for p in dag_shards],
        dagmod.compile_query(spec)))
    _same_payload(got, solo)


def test_dag_kill_switch_and_grid_budget(dag_shards, monkeypatch):
    """``BQUERYD_TPU_DEVICE_MERGE=0`` sends every DAG per shard, as the
    reference's does; the sketch budget counts the padded groups."""
    from bqueryd_tpu_torch.plan import dag as dagmod

    spec = dict(DAG_CASES["quantile"], table=["x"])
    tables = [ctable(p, mode="r") for p in dag_shards]
    ex = MeshQueryExecutor(device=CPU, n_devices=N_DEV)
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "0")
    with pytest.raises(DagFastPathUnsupported, match="DEVICE_MERGE=0"):
        ex.execute_dag(tables, dagmod.compile_query(spec))
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "1")
    width, _kmin = opexec.sketch_grid_layout(0.02)
    # 6 groups pad to 8 over 8 devices: a budget of 7 rows refuses
    monkeypatch.setenv("BQUERYD_TPU_SKETCH_GRID_CELLS", str(7 * width))
    with pytest.raises(DagFastPathUnsupported, match="8x"):
        ex.execute_dag(tables, dagmod.compile_query(spec))


# -- the executor's devices ----------------------------------------------------

def test_devices_resolve_and_key_the_working_set(merge_shards):
    _df, tables = merge_shards
    ex = MeshQueryExecutor(devices=[CPU, CPU, CPU])
    assert ex.n_devices == 3 and ex.device == torch.device(CPU)
    ex.execute(_port_tables(tables), GroupByQuery(["g"], [["big", "sum",
                                                           "s"]]))
    (codes,) = ex._codes_cache._data.values()
    assert isinstance(codes, executor_mod._Rows) and codes.shape[0] == 3
    assert all(r.device == torch.device(CPU) for r in codes)
    assert ex._codes_cache.stats()["bytes"] == codes.numel()
    for key in list(ex._codes_cache._data) + list(ex._hbm_cache._data):
        assert key[-2:] == (3, "cpu,cpu,cpu")
    assert executor_mod.resolve_devices(CPU, None) == (torch.device(CPU),)
    with pytest.raises(ValueError):
        MeshQueryExecutor(devices=[])


def test_pressure_reads_every_device(monkeypatch):
    """Eviction acts on the most pressed of the executor's cards."""
    from bqueryd_tpu_torch.ops import workingset as ws_mod

    samples = {"cuda:0": {"bytes_in_use": 10, "bytes_limit": 100},
               "cuda:1": {"bytes_in_use": 95, "bytes_limit": 100}}
    seen = []

    def fake(device):
        seen.append(str(device))
        return samples.get(str(device))

    monkeypatch.setattr(ws_mod, "memory_sample", fake)
    ws = WorkingSet(devices=["cuda:0", "cuda:1", "cuda:0"])
    ws.segment("blocks").put("a", np.zeros(64, np.uint8))
    assert ws_mod.pressure_sample(ws.devices) == samples["cuda:1"]
    assert ws.evict_under_pressure(watermark=0.9) == 64
    assert sorted(seen) == ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]
    assert ws_mod.pressure_sample([CPU]) is None


def test_health_probe_covers_each_device(monkeypatch, tmp_path):
    """The worker registers its executor's devices with the health probe
    (a repeated device once); an executor alone registers nothing; the
    default probe touches each watched device."""
    from bqueryd_tpu_torch.utils import devicehealth
    from bqueryd_tpu_torch.worker import WorkerNode

    monkeypatch.setattr(devicehealth, "_devices", ())
    monkeypatch.setattr(devicehealth, "_device", None)
    worker = WorkerNode(coordination_url=f"mem://probe-{os.urandom(4).hex()}",
                        data_dir=str(tmp_path), loglevel=QUIET, device=CPU,
                        n_devices=2)
    try:
        assert worker.executor.devices == (torch.device(CPU),) * 2
        assert devicehealth._devices == (torch.device(CPU),)
        assert devicehealth.watched_device() == torch.device(CPU)
        monkeypatch.setattr(devicehealth, "_devices", ("x",))
        MeshQueryExecutor(devices=[CPU, CPU])
        assert devicehealth._devices == ("x",)
    finally:
        worker.socket.close()
    probed = []
    monkeypatch.setattr(devicehealth, "_devices", ("a", "b"))
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, device=None: probed.append(device)
                        or np.zeros(()))
    devicehealth._default_probe()
    assert probed == ["a", "b"]


# -- merge_mode on the wire -------------------------------------------------------

@pytest.fixture(scope="module")
def merge_cluster(tmp_path_factory):
    """A port controller and a port worker with 4 logical CPU devices over
    TCP ZMQ on 127.0.0.1, four shards of ``tests/test_devicemerge.py``'s
    cluster data."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    rng = np.random.default_rng(23)
    n = 6_000
    df = pd.DataFrame({"g": rng.integers(0, 9, n).astype(np.int64),
                       "v": rng.integers(-(2**40), 2**40, n).astype(
                           np.int64)})
    root = tmp_path_factory.mktemp("torch_devmerge_cluster")
    names = []
    for i in range(4):
        name = f"dm-{i}.bcolzs"
        ctable.fromdataframe(df.iloc[i::4].reset_index(drop=True),
                             str(root / name))
        names.append(name)
    url = f"file://{root / 'store'}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        mp.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
        controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                    runfile_dir=str(root),
                                    heartbeat_interval=0.2)
        worker = WorkerNode(coordination_url=url, data_dir=str(root),
                            loglevel=QUIET, heartbeat_interval=0.2,
                            poll_timeout=0.05, device=CPU, n_devices=4)
        threads = [threading.Thread(target=node.go, daemon=True)
                   for node in (controller, worker)]
        for t in threads:
            t.start()
        try:
            wait_until(lambda: len(controller.files_map) >= len(names),
                       desc="worker shard registration")
            rpc = RPC(coordination_url=url, timeout=60, retries=1,
                      loglevel=QUIET)
            try:
                yield df, names, rpc, controller, worker
            finally:
                rpc._close_socket()
        finally:
            for node in (controller, worker):
                node.running = False
            for t in threads:
                t.join(timeout=10)


def test_merge_mode_rides_the_wire(merge_cluster, monkeypatch):
    """A shard group's reply says ``device`` (one message, 4 devices);
    the kill switch sends one message per shard, each merged on the host,
    with the same answer; the worker's merge gauges count both."""
    df, names, rpc, controller, worker = merge_cluster
    assert worker.executor.n_devices == 4
    monkeypatch.delenv("BQUERYD_TPU_DEVICE_MERGE", raising=False)
    expect = df.groupby("g")["v"].sum().sort_index()
    before = devicemerge.stats().snapshot()
    order, cols = rpc.groupby(names, ["g"], [["v", "sum", "s"]], [])
    modes = rpc.last_call_merge_modes
    assert modes and list(modes.values()) == ["device"], modes
    got = pd.Series(cols["s"], index=cols["g"]).sort_index()
    assert got.tolist() == expect.tolist()
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "0")
    order, cols = rpc.groupby(names, ["g"], [["v", "sum", "s"]], [])
    modes = rpc.last_call_merge_modes
    assert len(modes) == len(names), modes
    assert set(modes.values()) <= {"host", "none"}, modes
    got = pd.Series(cols["s"], index=cols["g"]).sort_index()
    assert got.tolist() == expect.tolist()
    after = devicemerge.stats().snapshot()
    assert after["queries"]["device"] > before["queries"]["device"]
    assert after["queries"]["host"] >= before["queries"]["host"] + len(names)
    text = worker.metrics.render()
    for family in ("bqueryd_tpu_merge_bytes_fetched",
                   "bqueryd_tpu_merge_queries",
                   "bqueryd_tpu_merge_d2h_bytes_saved"):
        assert family in text


def test_controller_shards_per_message_under_the_kill_switch(monkeypatch):
    from bqueryd_tpu_torch.controller import ControllerNode

    node = ControllerNode.__new__(ControllerNode)
    node.files_map = {"a": {"w1"}, "b": {"w1"}, "c": {"w2"}}
    groups = ControllerNode._shard_groups(
        node, ["a", "b", "c"], ["g"], [["v", "sum", "s"]], {})
    assert sorted(map(sorted, groups)) == [["a", "b"], ["c"]]
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_MERGE", "0")
    groups = ControllerNode._shard_groups(
        node, ["a", "b", "c"], ["g"], [["v", "sum", "s"]], {})
    assert groups == [["a"], ["b"], ["c"]]


def test_no_env_leaks():
    assert os.environ.get("BQUERYD_TPU_DEVICE_MERGE") in (None, "1")

"""Latency-aware host routing of the port against the JAX package's.

The same seeded NumPy inputs go through both packages: the host kernels
(``ops.host_partial_tables``: ints bit for bit, floats within rtol 2e-5 and
atol 1e-6), the routing threshold and its per-query cost estimate, and the
routing decisions of the engine, the worker's ``execute`` gate, its DAG
fast-path gate and its bundle gate on the same shards.  The per-shard DAG
executor's host twins equal its device route and the reference's twins.
Routing is not a fallback: a device error still fails the query.
"""

import os
import time

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.models import query as jax_q
from bqueryd_tpu.ops import groupby as jax_gb
from bqueryd_tpu.parallel import opexec as jax_opexec
from bqueryd_tpu.plan import dag as jax_dag
from bqueryd_tpu.storage import native as jax_native
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu.utils import devicehealth as jax_health
from bqueryd_tpu_torch.models import query as q
from bqueryd_tpu_torch.ops import groupby as gb
from bqueryd_tpu_torch.parallel import opexec
from bqueryd_tpu_torch.plan import dag as dagmod
from bqueryd_tpu_torch.storage import native
from bqueryd_tpu_torch.storage.ctable import ctable
from bqueryd_tpu_torch.utils import devicehealth
from test_torch_operators import _same_payload, _shape_specs
from test_torch_operators import shards as op_shards  # noqa: F401
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401
from tests.torch_fixtures import native_libs  # noqa: F401

#: both packages' host routes on the native kernels (a test turns them off)
pytestmark = pytest.mark.usefixtures("native_libs")

RTOL, ATOL = 2e-5, 1e-6
CPU = "cpu"
OPS = ("sum", "mean", "count", "count_na", "min", "max")


@pytest.fixture(autouse=True)
def _healthy():
    devicehealth.force_state(False)
    jax_health.force_state(False)
    yield
    devicehealth.force_state(False)
    jax_health.force_state(False)


def _equal_tables(got, want):
    np.testing.assert_array_equal(got["rows"], want["rows"])
    assert len(got["aggs"]) == len(want["aggs"])
    for g, w in zip(got["aggs"], want["aggs"]):
        assert set(g) == set(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b)


def _measure(kind, rng, n):
    if kind == "int":
        return rng.integers(-(2**60), 2**60, n).astype(np.int64)
    if kind == "small_int":
        return rng.integers(-20_000, 20_000, n).astype(np.int32)
    if kind == "uint64":
        return rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    if kind == "float":
        v = (rng.random(n) * 100 - 50).astype(np.float64)
        v[rng.random(n) < 0.04] = np.nan
        return v
    if kind == "float32":
        return (rng.random(n) * 100 - 50).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("n", [30_000, 250_000])
@pytest.mark.parametrize("kind",
                         ["int", "small_int", "uint64", "float", "float32"])
@pytest.mark.parametrize("op", OPS)
def test_host_partial_tables_match_reference(monkeypatch, op, kind, n,
                                             native_on):
    """Both packages' host kernels on identical inputs: null keys, a mask,
    the native striped kernels (at or past their row floor) on and off."""
    if not native_on:
        monkeypatch.setattr(native, "groupby_available", lambda: False)
        monkeypatch.setattr(jax_native, "groupby_available", lambda: False)
    rng = np.random.default_rng(41 + n)
    g = 19
    codes = rng.integers(-1, g, n).astype(np.int32)
    mask = rng.random(n) < 0.85
    vals = _measure(kind, rng, n)
    got = gb.host_partial_tables(codes, (vals,), (op,), g, mask=mask)
    want = jax_gb.host_partial_tables(codes, (vals,), (op,), g, mask=mask)
    _equal_tables(got, want)


@pytest.mark.parametrize("op", ["count", "count_na", "min", "max"])
def test_host_partial_tables_datetime_sentinel(op):
    """Datetime measures ride as int64 with NaT (int64 min) as their null
    sentinel; the rows-only call (no measures) too."""
    rng = np.random.default_rng(7)
    n, g = 40_000, 11
    codes = rng.integers(0, g, n).astype(np.int32)
    ts = rng.integers(0, 2**50, n).astype(np.int64)
    ts[rng.random(n) < 0.05] = np.iinfo(np.int64).min
    sentinel = (np.iinfo(np.int64).min,)
    got = gb.host_partial_tables(codes, (ts,), (op,), g,
                                 null_sentinels=sentinel)
    want = jax_gb.host_partial_tables(codes, (ts,), (op,), g,
                                      null_sentinels=sentinel)
    _equal_tables(got, want)
    _equal_tables(gb.host_partial_tables(codes, (), (), g),
                  jax_gb.host_partial_tables(codes, (), (), g))
    with pytest.raises(ValueError):
        gb.host_partial_tables(codes, (ts,), ("sum",), g,
                               null_sentinels=sentinel)


@pytest.mark.parametrize("kind", ["int", "small_int", "uint64", "float"])
def test_host_partial_tables_match_the_device_route(kind):
    """The host twin and ``partial_tables`` (its plain version on the CPU)
    give the same tables, every mergeable op at once."""
    rng = np.random.default_rng(43)
    n, g = 50_000, 23
    codes = rng.integers(-1, g, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    vals = _measure(kind, rng, n)
    host = gb.host_partial_tables(codes, (vals,) * len(OPS), OPS, g,
                                  mask=mask)
    dev = gb.tree_to_numpy(gb.partial_tables(
        codes, (vals,) * len(OPS), OPS, g, mask=mask, device=CPU))
    _equal_tables(host, dev)


def test_host_expand_mask_matches_device_twin():
    rng = np.random.default_rng(3)
    codes = rng.integers(-1, 300, 20_000)
    mask = rng.random(20_000) < 0.01
    host = gb.host_expand_mask_by_group(codes, mask, n_groups=300)
    dev = gb.expand_mask_by_group(codes, mask, n_groups=300, device=CPU)
    np.testing.assert_array_equal(host, dev.numpy())
    assert gb.host_expand_mask_by_group(codes, None) is None


def test_host_kernel_rows_env_cap_and_wedge(monkeypatch):
    for value in ("12345", "0", "garbage"):
        monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", value)
        assert q.host_kernel_rows() == jax_q.host_kernel_rows()
    monkeypatch.delenv("BQUERYD_TPU_HOST_KERNEL_ROWS")
    for floor in (10.0, 2e-5, 1e-7):  # a pathological link, a card, none
        monkeypatch.setattr(q, "_measured_floor", floor)
        monkeypatch.setattr(jax_q, "_measured_floor", floor)
        for ns in (None, q._HOST_NS_PER_ROW_SLOW):
            assert q.host_kernel_rows(ns) == jax_q.host_kernel_rows(ns)
    monkeypatch.setattr(q, "_measured_floor", 10.0)
    assert q.host_kernel_rows() == q._HOST_ROUTE_CAP
    devicehealth.force_state(True)
    assert q.host_kernel_rows() == 1 << 62
    for name in ("_HOST_NS_PER_ROW", "_HOST_NS_PER_ROW_SLOW",
                 "_HOST_ROUTE_CAP"):
        assert getattr(q, name) == getattr(jax_q, name)


def test_dispatch_floor_measures_and_caches(monkeypatch):
    monkeypatch.setattr(q, "_measured_floor", None)
    floor = q.device_dispatch_floor(device=CPU)
    assert 0 < floor < 1.0
    assert q.device_dispatch_floor() == floor  # cached
    assert q.device_dispatch_floor(remeasure=True, device=CPU) > 0


def test_min_wall_outlasts_a_burst_of_contention():
    """Calls inflated by 20 ms in a burst that covers the first three
    (as a worker's background floor can be, while its loop registers)
    leave the floor at an uncontended call's wall: the rounds spread the
    samples past the burst."""
    calls = []

    def call():
        calls.append(None)
        if len(calls) <= 3:
            time.sleep(0.02)

    wall = q._min_wall(call, rounds=4, gap_s=0.001)
    assert len(calls) == 12
    assert wall < 0.01


def test_dispatch_floor_spreads_its_samples(monkeypatch):
    """The floor is :func:`_min_wall` of the tiny fetch, over the default
    rounds: more than three samples, a gap apart."""
    seen = []
    real = q._min_wall

    def spy(call, rounds=None, gap_s=None):
        seen.append((rounds, gap_s))
        return real(call, rounds, gap_s)

    monkeypatch.setattr(q, "_min_wall", spy)
    monkeypatch.setattr(q, "_measured_floor", None)
    assert q.device_dispatch_floor(remeasure=True, device=CPU) > 0
    assert seen == [(None, None)]
    assert q._FLOOR_ROUNDS > 1 and q._FLOOR_ROUND_GAP_S > 0


# -- shards ------------------------------------------------------------------

def _frame(seed, n):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 9, n).astype(np.int64),
        "k2": rng.integers(0, 5, n).astype(np.int64),
        "small": rng.integers(-100, 100, n).astype(np.int64),
        "big": rng.integers(-(2**62), 2**62, n).astype(np.int64),
        "u": rng.integers(0, 2**40, n).astype(np.uint64),
        "f": rng.random(n) * 100,
        "basket": rng.integers(0, 50, n).astype(np.int64),
        "t": pd.to_datetime(rng.integers(0, 2**40, n)),
    })


@pytest.fixture(scope="module")
def shard_set(tmp_path_factory):
    """Three shards of 6,000 rows and one of 250,000 (past the native
    kernels' row floor), written by the JAX package's ctable."""
    root = tmp_path_factory.mktemp("torch_routing")
    frames, paths = [], []
    for i, n in enumerate((6_000, 6_000, 6_000, 250_000)):
        df = _frame(100 + i, n)
        p = str(root / f"r{i}.bcolzs")
        jax_ctable.fromdataframe(df, p)
        frames.append(df)
        paths.append(p)
    return frames, paths


AGG_LISTS = {
    "sum_small": [["small", "sum", "s"]],
    "sum_big": [["big", "sum", "s"]],
    "mean": [["small", "mean", "m"], ["f", "sum", "fs"]],
    "minmax": [["small", "min", "lo"], ["big", "max", "hi"]],
    "uint_max": [["u", "max", "ux"]],
    "datetime_max": [["t", "max", "tx"], ["t", "count", "n"]],
}


@pytest.mark.parametrize("name", sorted(AGG_LISTS))
def test_host_ns_estimate_matches_reference(shard_set, name):
    _frames, paths = shard_set
    aggs = AGG_LISTS[name]
    for p in paths:
        for n_rows in (6_000, 250_000, 10**9):
            assert q._host_ns_estimate(ctable(p, mode="r"), aggs, n_rows) == (
                jax_q._host_ns_estimate(jax_ctable(p, mode="r"), aggs, n_rows))


def _set_floor(monkeypatch, floor):
    monkeypatch.delenv("BQUERYD_TPU_HOST_KERNEL_ROWS", raising=False)
    monkeypatch.setattr(q, "_measured_floor", floor)
    monkeypatch.setattr(jax_q, "_measured_floor", floor)


#: (env threshold or None, floor) pairs: pinned under and over every
#: group; a floor whose thresholds (100,000 rows at the fast rate, 25,000
#: at the slow) cover the small shards but not the big one; and one
#: (25,000 fast, 6,250 slow) that host-routes the three small shards
#: together only at the fast rate
ROUTINGS = [("0", None), ("1000000", None), (None, 8e-4), (None, 2e-4)]


@pytest.mark.parametrize("routing", range(len(ROUTINGS)))
@pytest.mark.parametrize("name", sorted(AGG_LISTS))
@pytest.mark.parametrize("strategy", [None, "host"])
def test_engine_routes_like_the_reference(monkeypatch, shard_set, routing,
                                          name, strategy):
    from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
    from bqueryd_tpu.models.query import QueryEngine as JaxEngine
    from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.parallel import hostmerge

    env, floor = ROUTINGS[routing]
    if env is None:
        _set_floor(monkeypatch, floor)
    else:
        monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", env)
    _frames, paths = shard_set
    aggs = AGG_LISTS[name]
    where = [["small", ">", -50]]
    port, ref = QueryEngine(device=CPU), JaxEngine()
    for p in paths:
        got = port.execute_local(
            ctable(p, mode="r"), GroupByQuery(["k"], aggs, where),
            strategy=strategy)
        want = ref.execute_local(
            jax_ctable(p, mode="r"), JaxQuery(["k"], aggs, where),
            strategy=strategy)
        host = ref.last_effective_strategy == "host"
        assert (port.last_effective_strategy == "host") == host, p
        g = hostmerge.finalize_table(hostmerge.merge_payloads([got]))
        w = jax_hostmerge.payload_to_dataframe(
            jax_hostmerge.merge_payloads([want]))
        order, cols = g
        at = np.argsort(cols["k"])
        for c in order:
            a, b = cols[c][at], w.sort_values("k")[c].to_numpy()
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(a, b.astype(a.dtype))


def _jax_worker():
    import logging

    from bqueryd_tpu.worker import WorkerNode

    w = WorkerNode.__new__(WorkerNode)
    w._engine = w._mesh_executor = w._result_cache = None
    w.logger = logging.getLogger("test-routing")
    return w


@pytest.mark.parametrize("routing", range(len(ROUTINGS)))
@pytest.mark.parametrize("group", ["small3", "all4", "big1"])
@pytest.mark.parametrize("name", ["sum_small", "minmax", "datetime_max"])
def test_worker_gates_match_reference(monkeypatch, shard_set, routing, group,
                                      name):
    """``worker.execute``'s executor gate, ``_bundle_mesh_eligible`` and
    the DAG fast-path gate decide as the JAX worker's on the same shards."""
    from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
    from bqueryd_tpu.utils.tracing import PhaseTimer
    from bqueryd_tpu_torch import worker as port_worker
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor

    env, floor = ROUTINGS[routing]
    if env is None:
        _set_floor(monkeypatch, floor)
    else:
        monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", env)
    _frames, paths = shard_set
    sel = {"small3": paths[:3], "all4": paths, "big1": paths[3:]}[group]
    aggs = AGG_LISTS[name]
    ref = _jax_worker()
    ref_tables = [jax_ctable(p, mode="r") for p in sel]
    ref._execute(ref_tables, JaxQuery(["k"], aggs, []), PhaseTimer())
    tables = [ctable(p, mode="r") for p in sel]
    report = {}
    port_worker.execute(tables, GroupByQuery(["k"], aggs, []),
                        QueryEngine(device=CPU),
                        executor=MeshQueryExecutor(device=CPU),
                        report=report)
    assert report["merge_mode"] == ref._last_merge_mode
    assert (report["effective_strategy"] == "host") == (
        ref._last_effective_strategy == "host")

    node = port_worker.WorkerNode.__new__(port_worker.WorkerNode)
    node.executor = MeshQueryExecutor(device=CPU)
    queries = [GroupByQuery(["k"], aggs, []),
               GroupByQuery(["k"], [["small", "sum", "x"]], [["f", ">", 5]])]
    jax_queries = [JaxQuery(["k"], aggs, []),
                   JaxQuery(["k"], [["small", "sum", "x"]], [["f", ">", 5]])]
    assert node._bundle_mesh_eligible(tables, queries) == (
        ref._bundle_mesh_eligible(ref_tables, jax_queries))
    assert node._bundle_mesh_eligible(
        tables, queries + [GroupByQuery(["k"], [["nope", "sum", "x"]])]
    ) is False

    # the DAG fast-path gate: both packages' fast paths spied
    spec = {"table": ["x"], "groupby": ["k"],
            "aggs": [["small", "topk", "t", {"k": 2}], ["small", "sum", "s"]]}
    fast = {"port": 0, "ref": 0}

    class Unsupported(Exception):
        pass

    from bqueryd_tpu.parallel import executor as jax_executor_mod
    from bqueryd_tpu_torch.parallel import executor as executor_mod

    def spy(which, exc):
        def run(*_a, **_k):
            fast[which] += 1
            raise exc("spied")
        return run

    node.executor.execute_dag = spy("port",
                                    executor_mod.DagFastPathUnsupported)
    node.engine = QueryEngine(device=CPU)
    node.logger = ref.logger
    node._execute_dag(tables, dagmod.compile_query(spec), None, {})
    ref.mesh_executor.execute_dag = spy(
        "ref", jax_executor_mod.DagFastPathUnsupported)
    ref._execute_dag(ref_tables, jax_dag.compile_query(spec), PhaseTimer())
    assert fast["port"] == fast["ref"]


@pytest.mark.parametrize("shape", sorted(_shape_specs()))
def test_dag_host_twins_bit_identical(monkeypatch, op_shards,  # noqa: F811
                                      shape):
    """A per-shard DAG on the host route equals the reference's host route
    and the port's device route (the plain versions on the CPU)."""
    from bqueryd_tpu.models.query import QueryEngine as JaxEngine
    from bqueryd_tpu_torch.models.query import QueryEngine

    _frames, paths = op_shards
    spec = dict(_shape_specs()[shape], table=["x"])
    dag, ref = dagmod.compile_query(spec), jax_dag.compile_query(spec)
    port = opexec.DagExecutor(QueryEngine(device=CPU))
    jax = jax_opexec.DagExecutor(JaxEngine())
    for p in paths:
        monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "0")
        dev = port.execute_shard(ctable(p, mode="r"), dag)
        monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", str(10**9))
        host = port.execute_shard(ctable(p, mode="r"), dag)
        assert port.last_effective_strategy == "host"
        want = jax.execute_shard(jax_ctable(p, mode="r"), ref)
        assert jax.last_effective_strategy == "host"
        _same_payload(host, want)
        _same_payload(host, dev)


def test_dag_host_route_makes_no_device_call(monkeypatch,
                                            op_shards):  # noqa: F811
    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.models.query import QueryEngine
    from bqueryd_tpu_torch.ops import relops

    def no_device(*_a, **_k):
        raise AssertionError("a device op ran on the host route")

    for mod, names in ((ops, ("partial_tables",)),
                       (relops, ("topk_partials", "sketch_bin",
                                 "gather_positions"))):
        for name in names:
            monkeypatch.setattr(mod, name, no_device)
    monkeypatch.setattr(ops.predicates, "as_tensor", no_device)
    devicehealth.force_state(True)
    _frames, paths = op_shards
    spec = dict(_shape_specs()["combined"], table=["x"])
    executor = opexec.DagExecutor(QueryEngine(device=CPU))
    for p in paths:
        executor.execute_shard(ctable(p, mode="r"),
                               dagmod.compile_query(spec))
        assert executor.last_effective_strategy == "host"


def test_host_route_makes_no_device_call(monkeypatch, shard_set):
    """A host-routed engine query uploads nothing: no codes, no mask, no
    basket expansion, no partials on the device."""
    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine

    def no_device(*_a, **_k):
        raise AssertionError("a device op ran on the host route")

    for name in ("partial_tables", "expand_mask_by_group",
                 "groupby_count_distinct", "groupby_sorted_count_distinct"):
        monkeypatch.setattr(ops, name, no_device)
    monkeypatch.setattr(gb, "as_tensor", no_device)
    monkeypatch.setattr(ops.predicates, "as_tensor", no_device)
    monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "1000000")
    _frames, paths = shard_set
    engine = QueryEngine(device=CPU)
    table = ctable(paths[0], mode="r")
    for query in (
        GroupByQuery(["k"], [["small", "sum", "s"],
                             ["basket", "count_distinct", "d"],
                             ["k2", "sorted_count_distinct", "r"]],
                     [["f", ">", 20.0]], expand_filter_column="basket"),
        GroupByQuery(["k", "k2"], [["small", "min", "lo"]], [["u", ">", 5]],
                     sole_payload=True),
    ):
        engine.execute_local(table, query)
        assert engine.last_effective_strategy == "host"


def test_device_error_propagates_as_an_error_reply(monkeypatch, tmp_path):
    """A failing kernel wrapper fails the query with an ErrorMessage: the
    router does not retry it on the host."""
    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.messages import CalcMessage, ErrorMessage
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.worker import WorkerNode

    monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "0")
    df = _frame(5, 5_000)
    ctable.fromdataframe(df[["k", "small"]], str(tmp_path / "e.bcolzs"))

    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")

    def no_host(*_a, **_k):
        raise AssertionError("retried on the host")

    monkeypatch.setattr(onehot, "onehot_rows_dot", broken)
    monkeypatch.setattr(ops, "host_partial_tables", no_host)
    worker = WorkerNode(coordination_url=f"mem://err-{os.urandom(4).hex()}",
                        data_dir=str(tmp_path), device=CPU)
    sent = []
    worker.send = lambda addr, msg: sent.append(msg)
    worker.send_to_all = lambda msg: None
    try:
        msg = CalcMessage({"payload": "groupby", "token": "t"})
        msg.set_args_kwargs(["e.bcolzs", ["k"], [["small", "sum", "s"]], []],
                            {})
        worker.handle(msg, b"controller")
    finally:
        worker.socket.close()
    (reply,) = sent
    assert reply.isa(ErrorMessage)
    assert "CUDA error" in reply["payload"]

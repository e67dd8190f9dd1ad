"""The port's executor path on the CPU against the JAX package's
``MeshQueryExecutor`` on the 8 virtual CPU devices of ``conftest.py``.

The fuzz dataset is written once by the JAX package's ctable; every
mergeable fuzz case goes through the port's executor, through
``LocalRPC.groupby`` (which now routes to it) and through the JAX executor,
and each is held against the other and against pandas with ``_compare``
(ints exact, floats within rtol=2e-5).  Then the executor's own contracts:
the packed fetch, route hints, the wire dtypes against the JAX package's,
the working set's hits and invalidation, composite sidecars written by
either package, the ``CompositeOverflow`` fallback, the worker's routes
and threads, memory-pressure eviction and the pipeline pool.
"""

import threading
import time

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
from bqueryd_tpu.parallel import executor as jax_executor
from bqueryd_tpu.parallel.executor import MeshQueryExecutor as JaxExecutor
from bqueryd_tpu.parallel.executor import make_mesh
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import ops, worker
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.ops import groupby as tg
from bqueryd_tpu_torch.ops import onehot
from bqueryd_tpu_torch.ops.workingset import WorkingSet, memory_sample
from bqueryd_tpu_torch.parallel import executor as port_executor
from bqueryd_tpu_torch.parallel import pipeline
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.rpc import LocalRPC
from bqueryd_tpu_torch.storage.ctable import ChunkView, ctable
from bqueryd_tpu_torch.utils.tracing import PhaseTimer
from test_differential_fuzz import (
    CASES,
    _compare,
    _dataset,
    _expected,
    _filter_df,
)
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

MERGEABLE = ("sum", "mean", "count", "count_na", "min", "max")
PORT_CASES = [
    i for i, (_g, aggs, _w) in enumerate(CASES)
    if all(op in MERGEABLE for _i, op, _o in aggs)
]


def _write_shards(root, frames, **kwargs):
    names = []
    for i, df in enumerate(frames):
        name = f"shard_{i}.bcolzs"
        jax_ctable.fromdataframe(df, str(root / name), **kwargs)
        names.append(name)
    return names


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The fuzz dataset written by the JAX package's ctable."""
    root = tmp_path_factory.mktemp("torch_executor")
    frames = _dataset(20240601)
    return root, frames, _write_shards(root, frames)


@pytest.fixture(scope="module")
def jax_answers(shards):
    """The JAX executor's payload per fuzz case, computed once: one
    executor on the 8 virtual devices, so its programs stay cached."""
    root, _frames, names = shards
    executor = JaxExecutor(mesh=make_mesh())
    tables = [jax_ctable(str(root / n), mode="r") for n in names]
    cache = {}

    def answer(case_i):
        if case_i not in cache:
            gcols, aggs, where = CASES[case_i]
            cache[case_i] = executor.execute(
                tables, JaxQuery(gcols, aggs, where)
            )
        return cache[case_i]

    return answer


@pytest.fixture(scope="module")
def port(shards):
    """One port executor and the port's tables of the shared shards."""
    root, _frames, names = shards
    tables = [ctable(str(root / n), mode="r") for n in names]
    return MeshQueryExecutor(device="cpu"), tables


def _payload_frame(payload):
    return jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads([dict(payload)])
    )


@pytest.mark.parametrize("case_i", PORT_CASES)
def test_executor_matches_jax_executor(shards, jax_answers, port, case_i):
    _root, frames, _names = shards
    executor, tables = port
    gcols, aggs, where = CASES[case_i]
    payload = executor.execute(tables, GroupByQuery(gcols, aggs, where))
    assert executor.last_merge_mode == "device"
    got = _payload_frame(payload)
    _compare(got, _payload_frame(jax_answers(case_i)), gcols, aggs)
    _compare(got, _expected(frames, gcols, aggs, where), gcols, aggs)


@pytest.mark.parametrize("case_i", PORT_CASES)
def test_local_rpc_matches_jax_executor(shards, jax_answers, case_i):
    root, _frames, names = shards
    gcols, aggs, where = CASES[case_i]
    rpc = LocalRPC(str(root), device="cpu")
    order, columns = rpc.groupby(names, gcols, aggs, where)
    assert rpc.last_merge_mode == "device"
    assert rpc.last_effective_strategy in ("matmul", "scatter", "sort")
    got = pd.DataFrame({c: columns[c] for c in order}, columns=order)
    want_order, want = jax_hostmerge.finalize_table(
        jax_hostmerge.merge_payloads([dict(jax_answers(case_i))])
    )
    assert order == want_order
    want = pd.DataFrame({c: want[c] for c in want_order}, columns=want_order)
    _compare(got, want, gcols, aggs)


@pytest.mark.parametrize("dtype", [tg.torch.int8, tg.torch.int16,
                                   tg.torch.int32, tg.torch.int64,
                                   tg.torch.float32, tg.torch.float64,
                                   tg.torch.bool])
def test_packed_fetch_round_trips_every_leaf(dtype):
    """Leaves of any dtype after a 5-byte leaf (so none starts aligned)
    come back bit for bit from the one packed buffer."""
    gen = tg.torch.Generator().manual_seed(5)
    odd = tg.torch.randint(-100, 100, (5,), dtype=tg.torch.int8,
                           generator=gen)
    leaf = (tg.torch.randn(9, generator=gen, dtype=tg.torch.float64) * 1e6)
    leaf = leaf > 0 if dtype == tg.torch.bool else leaf.to(dtype)
    leaves = [odd, leaf, leaf.flip(0)]
    spec = [(tg.np_dtype(x.dtype), tuple(x.shape)) for x in leaves]
    flat = port_executor._fetch_many(
        [tg.torch.cat([port_executor._pack_leaf(x) for x in leaves])])[0]
    assert flat.dtype == np.uint8 and flat.nbytes == sum(
        x.numel() * x.element_size() for x in leaves)
    for got, want in zip(port_executor._unpack_host(flat, spec), leaves):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("hint,route", [(None, "matmul"), ("auto", "matmul"),
                                        ("scatter", "scatter"),
                                        ("sort", "sort"),
                                        ("matmul!", "matmul")])
def test_route_hint_reaches_partial_tables(shards, port, hint, route):
    """A route hint passes through the worker and the executor to
    ``partial_tables`` unchanged; every route gives the same answer."""
    _root, frames, _names = shards
    executor, tables = port
    gcols, aggs = ["k_int"], [["v_small", "sum", "s"],
                              ["v_float", "mean", "m"]]
    report = {}
    payload = worker.execute(tables, GroupByQuery(gcols, aggs),
                             QueryEngine(device="cpu"), executor=executor,
                             strategy=hint, report=report)
    assert report == {"effective_strategy": route, "merge_mode": "device"}
    _compare(_payload_frame(payload), _expected(frames, gcols, aggs, []),
             gcols, aggs)


@pytest.mark.parametrize("column", ["k_int", "k_str", "k_float", "t",
                                    "k_wide", "v_small", "v_big", "v_float",
                                    "v_bool", "v_u32", "v_u64", "basket",
                                    "sel"])
def test_wire_and_stored_dtypes_match_jax(shards, port, column):
    root, _frames, names = shards
    _executor, tables = port
    jax_tables = [jax_ctable(str(root / n), mode="r") for n in names]
    assert port_executor._wire_dtype(tables, column) == (
        jax_executor._wire_dtype(jax_tables, column))
    assert port_executor._stored_dtype(tables, column) == (
        jax_executor._stored_dtype(jax_tables, column))


@pytest.mark.parametrize("n_groups", [1, 126, 127, 128, 32_766, 32_767,
                                      32_768, 73_728])
def test_codes_dtype_matches_jax(n_groups):
    assert port_executor._codes_dtype(n_groups) == (
        jax_executor._codes_dtype(n_groups))


def test_warm_query_hits_the_working_set(shards, monkeypatch):
    root, frames, names = shards
    tables = [ctable(str(root / n), mode="r") for n in names]
    executor = MeshQueryExecutor(device="cpu")
    gcols = ["k_str", "k_int"]
    query = GroupByQuery(gcols, [["v_small", "sum", "s"]],
                         [["sel", ">", 0.5]])

    def n_where(q):
        # the shards whose filter column the query reads
        return sum(ops.shard_can_match(t, q.where_terms) for t in tables)

    cold = _payload_frame(executor.execute(tables, query))
    s0 = executor.workingset.stats()
    # blocks: the measure, and each shard's resident filter column
    assert [s0[k]["misses"] for k in ("align", "codes", "blocks")] == [
        1, 1, 1 + n_where(query)]

    def boom(*_a, **_k):
        raise AssertionError("factorize ran on a warm query")

    monkeypatch.setattr(ops, "factorize", boom)
    warm = _payload_frame(executor.execute(tables, query))
    s1 = executor.workingset.stats()
    for seg, hits in (("align", 1), ("codes", 1),
                      ("blocks", 1 + n_where(query))):
        assert s1[seg]["hits"] == s0[seg]["hits"] + hits, seg
        assert s1[seg]["misses"] == s0[seg]["misses"], seg
    _compare(warm, cold, gcols, query.agg_list)

    # another measure: align and codes hit, one new block
    other = GroupByQuery(gcols, [["v_big", "sum", "s"]], [["sel", ">", 0.5]])
    got = _payload_frame(executor.execute(tables, other))
    s2 = executor.workingset.stats()
    assert s2["align"]["hits"] == s1["align"]["hits"] + 1
    assert s2["codes"]["hits"] == s1["codes"]["hits"] + 1
    assert s2["blocks"]["misses"] == s1["blocks"]["misses"] + 1
    _compare(got, _expected(frames, gcols, other.agg_list, other.where_terms),
             gcols, other.agg_list)

    # another filter: align, codes (unmasked, the fold is per query) and
    # blocks (the measure and the filter columns) hit, and the answer is
    # the new filter's
    refiltered = GroupByQuery(gcols, [["v_small", "sum", "s"]],
                              [["sel", "<=", 0.25]])
    got = _payload_frame(executor.execute(tables, refiltered))
    s3 = executor.workingset.stats()
    assert s3["align"]["hits"] == s2["align"]["hits"] + 1
    assert s3["codes"]["hits"] == s2["codes"]["hits"] + 1
    assert s3["blocks"]["hits"] == s2["blocks"]["hits"] + 1 + n_where(
        refiltered)
    for seg in ("align", "codes", "blocks"):
        assert s3[seg]["misses"] == s2[seg]["misses"], seg
    _compare(got, _expected(frames, gcols, refiltered.agg_list,
                            refiltered.where_terms), gcols,
             refiltered.agg_list)


def test_segments_count_tensor_bytes_and_key_the_device(port):
    executor, tables = port
    executor.clear_caches()
    executor.execute(tables, GroupByQuery(["k_int"], [["v_small", "sum", "s"]]))
    (codes,) = executor._codes_cache._data.values()
    (block,) = executor._hbm_cache._data.values()
    assert executor._codes_cache.stats()["bytes"] == codes.numel()
    assert codes.dtype.itemsize == 1  # 7 groups ride as int8
    assert executor._hbm_cache.stats()["bytes"] == block.numel() * 2
    assert str(block.dtype) == "torch.int16"  # v_small in [-1000, 1000)
    width = ops.program_bucket(sum(len(t) for t in tables), fine=True)
    assert tuple(codes.shape) == tuple(block.shape) == (1, width)
    for key in list(executor._codes_cache._data) + list(
        executor._hbm_cache._data
    ):
        assert key[-2:] == (1, "cpu")


def test_one_contraction_call_over_all_shards(port, monkeypatch):
    """The narrow wire dtype reaches the kernel: an int16 sum stacks a
    count row and 2 limbs (R = 3) over every shard's rows in ONE call."""
    executor, tables = port
    calls = []
    plain = onehot.onehot_rows_dot

    def spy(codes, rows, n_rows, n_groups):
        calls.append((codes.dtype, codes.shape[0], n_rows, n_groups))
        return plain(codes, rows, n_rows, n_groups)

    monkeypatch.setattr(onehot, "onehot_rows_dot", spy)
    executor.execute(tables, GroupByQuery(["k_int"], [["v_small", "sum", "s"]]))
    width = ops.program_bucket(sum(len(t) for t in tables), fine=True)
    assert calls == [(tg.torch.int32, width, 3, 7)]


def test_rewritten_shard_misses_and_serves_new_rows(tmp_path):
    frames = _dataset(7)
    names = _write_shards(tmp_path, frames)
    executor = MeshQueryExecutor(device="cpu")
    query = GroupByQuery(["k_int"], [["v_small", "sum", "s"]])

    def run():
        tables = [ctable(str(tmp_path / n), mode="r") for n in names]
        return _payload_frame(executor.execute(tables, query))

    run()
    s0 = executor.workingset.stats()
    frames[1] = frames[1].assign(v_small=frames[1]["v_small"] * 3)
    ctable.fromdataframe(frames[1], str(tmp_path / names[1]))
    got = run()
    s1 = executor.workingset.stats()
    for seg in ("align", "codes", "blocks"):
        assert s1[seg]["misses"] == s0[seg]["misses"] + 1, seg
    _compare(got, _expected(frames, ["k_int"], query.agg_list, []),
             ["k_int"], query.agg_list)


def _spy_composite(monkeypatch, table_cls):
    seen = {"hits": 0, "stores": 0}
    load, store = table_cls.composite_cache_load, table_cls.composite_cache_store

    def spy_load(self, *a, **k):
        hit = load(self, *a, **k)
        seen["hits"] += hit is not None
        return hit

    def spy_store(self, *a, **k):
        seen["stores"] += 1
        return store(self, *a, **k)

    monkeypatch.setattr(table_cls, "composite_cache_load", spy_load)
    monkeypatch.setattr(table_cls, "composite_cache_store", spy_store)
    return seen


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_composite_sidecar_is_shared_between_packages(tmp_path, monkeypatch,
                                                      writer):
    frames = _dataset(11)
    names = _write_shards(tmp_path, frames)
    gcols = ["k_str", "k_int", "k_float"]
    aggs = [["v_small", "sum", "s"], ["v_float", "max", "hi"]]
    port_tables = [ctable(str(tmp_path / n), mode="r") for n in names]
    jax_tables = [jax_ctable(str(tmp_path / n), mode="r") for n in names]

    def run_port():
        return MeshQueryExecutor(device="cpu").execute(
            port_tables, GroupByQuery(gcols, aggs))

    def run_jax():
        return JaxExecutor(mesh=make_mesh()).execute(
            jax_tables, JaxQuery(gcols, aggs))

    first, second = (run_jax, run_port) if writer == "jax" else (
        run_port, run_jax)
    reader_cls = ctable if writer == "jax" else jax_ctable
    want = _payload_frame(first())
    seen = _spy_composite(monkeypatch, reader_cls)
    got = _payload_frame(second())
    assert seen == {"hits": len(names), "stores": 0}
    _compare(got, want, gcols, aggs)
    _compare(got, _expected(frames, gcols, aggs, []), gcols, aggs)


def test_composite_overflow_takes_the_per_shard_path(shards, monkeypatch):
    root, frames, names = shards
    gcols, aggs = ["k_str", "k_int"], [["v_small", "sum", "s"],
                                       ["v_float", "mean", "m"]]
    rpc = LocalRPC(str(root), device="cpu")
    monkeypatch.setattr(ops, "MAX_COMPOSITE", 8)  # 3 x 7 keys overflow it
    with pytest.raises(ops.CompositeOverflow):
        rpc.executor.execute([rpc._table(n) for n in names],
                             GroupByQuery(gcols, aggs))
    order, columns = rpc.groupby(names, gcols, aggs)
    assert rpc.last_merge_mode == "host"
    got = pd.DataFrame({c: columns[c] for c in order}, columns=order)
    _compare(got, _expected(frames, gcols, aggs, []), gcols, aggs)


def test_non_mergeable_ops_are_refused(shards):
    root, frames, names = shards
    executor = MeshQueryExecutor(device="cpu")
    query = GroupByQuery(["k_int"], [["v_float", "count_distinct", "nd"]])
    assert not executor.supports(query)
    assert not executor.supports(
        GroupByQuery(["k_int"], [["v_small", "sum", "s"]], aggregate=False))
    tables = [ctable(str(root / n), mode="r") for n in names]
    with pytest.raises(ValueError, match="mergeable"):
        executor.execute(tables, query)
    # LocalRPC serves them per shard and unions the value sets on the host
    rpc = LocalRPC(str(root), device="cpu")
    order, columns = rpc.groupby(names, ["k_int"], query.agg_list)
    assert rpc.last_merge_mode == "host"
    got = pd.DataFrame({c: columns[c] for c in order}, columns=order)
    _compare(got, _expected(frames, ["k_int"], query.agg_list, []),
             ["k_int"], query.agg_list)


@pytest.mark.parametrize(
    "where", [[["sel", ">", 0.97]], [["v_small", ">", 900]]])
def test_basket_expansion_matches_jax_executor(shards, port, where):
    """Each shard's mask widens to whole baskets on the device before the
    fold, which is per query: the same filter without the expansion reads
    the same unmasked codes entry and answers without it."""
    root, frames, names = shards
    executor, tables = port
    gcols = ["k_int"]
    aggs = [["v_small", "sum", "s"], ["v_float", "mean", "m"],
            ["v_big", "max", "hi"]]
    query = GroupByQuery(gcols, aggs, where, expand_filter_column="basket")
    got = _payload_frame(executor.execute(tables, query))
    want = _payload_frame(JaxExecutor(mesh=make_mesh()).execute(
        [jax_ctable(str(root / n), mode="r") for n in names],
        JaxQuery(gcols, aggs, where, expand_filter_column="basket")))
    _compare(got, want, gcols, aggs)
    expanded = []
    for df in frames:
        hit = _filter_df(df, where).index
        expanded.append(df[df["basket"].isin(df.loc[hit, "basket"].unique())])
    _compare(got, _expected(expanded, gcols, aggs, []), gcols, aggs)
    before = executor.workingset.stats()["codes"]
    plain = _payload_frame(executor.execute(
        tables, GroupByQuery(gcols, aggs, where)))
    after = executor.workingset.stats()["codes"]
    assert after["misses"] == before["misses"]
    assert after["hits"] == before["hits"] + 1
    _compare(plain, _expected(frames, gcols, aggs, where), gcols, aggs)


#: case -> (the filter that warms the executor, a filter new to it,
#: expand_filter_column), each filter on the column the case names
RESIDENT_FILTERS = {
    "float32": ([["v_float", ">", 12.5]], [["v_float", ">", -3.25]], None),
    # v_small rides as int16 in its measure block; 40,000 lies past it
    "narrowed_int": ([["v_small", ">", 0]],
                     [["v_small", "<=", 40_000], ["v_small", ">", 250]],
                     None),
    "datetime": ([["t", ">", pd.Timestamp("2014-06-01")]],
                 [["t", ">", pd.Timestamp("2015-01-01")]], None),
    "dict_eq": ([["k_str", "in", ["a"]]], [["k_str", "==", "b"]], None),
    "dict_in": ([["k_str", "==", "a"]], [["k_str", "in", ["a", "c"]]],
                None),
    "uint32": ([["v_u32", ">", 2**31]], [["v_u32", "<=", 2**30]], None),
    "basket": ([["sel", ">", 0.97]], [["sel", ">", 0.9]], "basket"),
    "chunk_view": ([["basket", ">", 350]], [["basket", ">", 420]], None),
    "two_devices": ([["v_float", ">", 12.5]], [["v_float", "<=", 0.0]],
                    None),
    "append": ([["v_float", ">", 12.5]], [["v_float", "<=", 0.0]], None),
}


@pytest.fixture(scope="module")
def jax_mesh_executor():
    return JaxExecutor(mesh=make_mesh())


@pytest.mark.parametrize("case", sorted(RESIDENT_FILTERS))
def test_new_filter_reads_resident_inputs_only(shards, jax_mesh_executor,
                                               tmp_path, case):
    """A warm executor answers a filter new to it from the working set
    alone: the unmasked codes, the measure blocks and each shard's filter
    column (or basket codes) hit, nothing misses and nothing is uploaded,
    and the answer is the JAX executor's and pandas'.  An unfiltered query
    then gives the unfiltered answer (the fold left the cached codes
    unmasked); after an append the grown shard's filter column is read
    afresh."""
    root, frames, names = shards
    first, second, expand = RESIDENT_FILTERS[case]
    gcols = ["k_str", "k_int"]
    aggs = [["v_small", "sum", "s"], ["v_float", "mean", "m"],
            ["v_big", "max", "hi"]]
    if case in ("chunk_view", "append"):
        # chunks of 500 rows, 8 a shard, over the sorted basket column
        root, frames = tmp_path, list(frames)
        names = _write_shards(root, frames, chunklen=500)

    def open_tables():
        tables = [ctable(str(root / n), mode="r") for n in names]
        if case == "chunk_view":
            tables = [ops.chunk_pruned_table(t, first)[0] for t in tables]
            assert all(isinstance(t, ChunkView) for t in tables)
        return tables

    def in_view(frames):
        # each shard's rows that its view selects
        if case != "chunk_view":
            return frames
        return [df.iloc[np.concatenate([
            np.arange(c * 500, min((c + 1) * 500, len(df)))
            for c in t.chunk_ids])] for df, t in zip(frames, tables)]

    def expected(frames, where):
        if expand is not None:
            frames = [df[df[expand].isin(
                _filter_df(df, where)[expand].unique())] for df in frames]
            where = []
        return _expected(in_view(frames), gcols, aggs, where)

    tables = open_tables()
    executor = MeshQueryExecutor(
        devices=["cpu"] * (2 if case == "two_devices" else 1))
    executor.timer = PhaseTimer()

    def run(where, expand=expand):
        return _payload_frame(executor.execute(tables, GroupByQuery(
            gcols, aggs, where, expand_filter_column=expand)))

    _compare(run(first), expected(frames, first), gcols, aggs)
    assert executor.h2d_bytes > 0
    before, uploaded = executor.workingset.stats(), executor.h2d_bytes
    got = run(second)
    after = executor.workingset.stats()
    for seg in ("align", "codes", "blocks"):
        assert after[seg]["misses"] == before[seg]["misses"], seg
        assert after[seg]["hits"] > before[seg]["hits"], seg
    assert executor.h2d_bytes == uploaded
    want = jax_mesh_executor.execute(
        [jax_ctable(str(root / n), mode="r") for n in names],
        JaxQuery(gcols, aggs, second, expand_filter_column=expand))
    _compare(got, _payload_frame(want), gcols, aggs)
    _compare(got, expected(frames, second), gcols, aggs)

    # the same unmasked codes entry answers unfiltered
    _compare(run([], None), _expected(in_view(frames), gcols, aggs, []),
             gcols, aggs)
    assert executor.workingset.stats()["codes"]["misses"] == (
        after["codes"]["misses"])

    if case == "append":
        grown = frames[1].iloc[:300].assign(
            v_float=np.full(300, -1.0, dtype=np.float32))
        ctable(str(root / names[1]), mode="a").append(grown)
        frames[1] = pd.concat([frames[1], grown], ignore_index=True)
        tables = open_tables()
        misses = executor.workingset.stats()["blocks"]["misses"]
        got = run(second)
        # the measures of the new shard group and the grown shard's
        # filter column; the other shards' filter columns hit
        assert executor.workingset.stats()["blocks"]["misses"] == (
            misses + len(aggs) + 1)
        _compare(got, expected(frames, second), gcols, aggs)


def test_entry_points_share_the_scan_preamble(shards, jax_mesh_executor):
    """One shard group as a solo query, a 2-member bundle and a DAG over
    the same keys: the solo query adds one ``align`` and one ``codes``
    entry, the bundle finds both and adds none, and the DAG keeps its own
    keys (its derivations, its alignment and its codes).  Each answer is
    the JAX package's."""
    from bqueryd_tpu.plan import dag as jax_dag
    from bqueryd_tpu_torch.plan import dag as dagmod

    root, _frames, names = shards
    tables = [ctable(str(root / n), mode="r") for n in names]
    jax_tables = [jax_ctable(str(root / n), mode="r") for n in names]
    executor = MeshQueryExecutor(device="cpu")
    gcols = ["k_str", "k_int"]
    members = [(gcols, [["v_small", "sum", "s"]], []),
               (gcols, [["v_big", "max", "hi"], ["v_float", "mean", "m"]],
                [["sel", ">", 0.5]])]

    def entries():
        stats = executor.workingset.stats()
        return stats["align"]["entries"], stats["codes"]["entries"]

    def same(got, want, aggs):
        _compare(_payload_frame(got), _payload_frame(want), gcols, aggs)

    assert entries() == (0, 0)
    solo = executor.execute(tables, GroupByQuery(*members[0]))
    assert entries() == (1, 1)
    same(solo, jax_mesh_executor.execute(jax_tables, JaxQuery(*members[0])),
         members[0][1])

    bundle = executor.execute_bundle(
        tables, [GroupByQuery(*m) for m in members])
    assert entries() == (1, 1)
    want = jax_mesh_executor.execute_bundle(
        jax_tables, [JaxQuery(*m) for m in members])
    for got, w, (_g, aggs, _w) in zip(bundle, want, members):
        same(got, w, aggs)

    spec = {"table": ["x"], "groupby": gcols,
            "aggs": [["v_small", "sum", "s"]]}
    dag = executor.execute_dag(tables, dagmod.compile_query(spec))
    # one derivation per shard and one alignment; one codes entry
    assert entries() == (1 + len(tables) + 1, 2)
    same(dag, jax_mesh_executor.execute_dag(
        jax_tables, jax_dag.compile_query(spec)), spec["aggs"])


def test_worker_routes_by_query_shape(port):
    executor, tables = port
    engine = QueryEngine(device="cpu")
    agg = GroupByQuery(["k_int"], [["v_small", "sum", "s"]])
    raw = GroupByQuery(["k_int"], [["v_small", "sum", "s"]],
                       [["sel", ">", 0.9]], aggregate=False)
    routes = []
    for tabs, query, ex in [(tables, agg, executor), (tables[:1], raw, executor),
                            (tables, raw, executor), (tables, agg, None)]:
        report = {}
        payload = worker.execute(tabs, query, engine, executor=ex,
                                 report=report)
        routes.append(report["merge_mode"])
        assert payload["kind"] == ("partials" if query.aggregate else "rows")
    assert routes == ["device", "none", "host", "host"]


@pytest.mark.parametrize("threads", ["1", "4"])
def test_per_shard_path_launches_on_the_calling_thread(shards, port,
                                                       monkeypatch, threads):
    """The per-shard path runs each shard's host work on the pipeline pool
    and every ``partial_tables`` call on the caller's thread."""
    _root, frames, _names = shards
    _executor, tables = port
    monkeypatch.setenv("BQUERYD_TPU_PIPELINE_THREADS", threads)
    gcols, aggs = ["k_str", "k_int"], [["v_small", "sum", "s"],
                                       ["v_float", "max", "hi"]]
    where = [["sel", ">", 0.5]]
    callers, factorizers = [], set()
    partial_tables, key_codes = ops.partial_tables, QueryEngine._key_codes

    def spy_partial_tables(*a, **k):
        callers.append(threading.get_ident())
        return partial_tables(*a, **k)

    def spy_key_codes(self, *a, **k):
        factorizers.add(threading.get_ident())
        return key_codes(self, *a, **k)

    monkeypatch.setattr(ops, "partial_tables", spy_partial_tables)
    monkeypatch.setattr(QueryEngine, "_key_codes", spy_key_codes)
    report = {}
    payload = worker.execute(tables, GroupByQuery(gcols, aggs, where),
                             QueryEngine(device="cpu"), report=report)
    assert report["merge_mode"] == "host"
    assert callers == [threading.get_ident()] * len(tables)
    if threads == "4":
        assert factorizers - {threading.get_ident()}
    _compare(_payload_frame(payload), _expected(frames, gcols, aggs, where),
             gcols, aggs)


def test_datetime_sum_and_more_devices_are_refused(port):
    """A datetime mean is refused on any number of devices; two devices
    (once refused, before the device merge) answer what one does: ints
    bit for bit, floats within ``_compare``."""
    executor, tables = port
    two = MeshQueryExecutor(device="cpu", n_devices=2)
    assert two.devices == (tg.torch.device("cpu"),) * 2
    for ex in (executor, two):
        with pytest.raises(ValueError, match="not defined for datetime"):
            ex.execute(tables, GroupByQuery(["k_int"], [["t", "mean", "x"]]))
    gcols = ["k_int"]
    aggs = [["v_big", "sum", "s"], ["v_small", "min", "lo"],
            ["v_float", "mean", "m"], ["v_small", "count", "n"]]
    query = GroupByQuery(gcols, aggs)
    one = _payload_frame(executor.execute(tables, query))
    got = _payload_frame(two.execute(tables, query))
    assert two.last_merge_mode == "device"
    _compare(got, one, gcols, aggs)


def test_pressure_eviction_sheds_blocks_before_codes(port):
    executor, tables = port
    executor.clear_caches()
    executor.execute(tables, GroupByQuery(["k_int"], [["v_small", "sum", "s"]]))
    executor.execute(tables, GroupByQuery(["k_int"], [["v_big", "sum", "s"]]))
    ws = executor.workingset
    blocks = ws.segment("blocks").stats()["bytes"]
    assert len(ws.segment("blocks")) == 2 and len(ws.segment("codes")) == 1
    # target: one byte above the watermark -> the LRU block only
    freed = ws.evict_under_pressure(
        sample={"bytes_in_use": 501, "bytes_limit": 1000}, watermark=0.5)
    assert 0 < freed < blocks
    assert len(ws.segment("blocks")) == 1 and len(ws.segment("codes")) == 1
    # a target past every block: the codes go too, the alignment stays
    freed = ws.evict_under_pressure(
        sample={"bytes_in_use": 10**12, "bytes_limit": 10**12}, watermark=0.5)
    assert len(ws.segment("blocks")) == 0 and len(ws.segment("codes")) == 0
    assert len(ws.segment("align")) == 1
    assert ws.stats()["pressure_evictions"] == 3
    assert ws.evict_under_pressure() == 0  # the CPU gives no sample
    assert memory_sample(executor.device) is None
    assert WorkingSet().evict_under_pressure(
        sample={"bytes_in_use": 99, "bytes_limit": 100}, watermark=0) == 0


def test_hicard_route_stops_at_its_row_limit():
    limit = onehot.HICARD_MAX_ROWS
    dtypes = [np.dtype(np.int16)]
    assert tg.kernel_route(None, [np.zeros(0, np.int16)], ("sum",), limit,
                           73_728) == "matmul"
    assert tg._hicard_matmul_profitable(dtypes, ("sum",), limit, 73_728)
    assert not tg._hicard_matmul_profitable(dtypes, ("sum",), limit + 1,
                                            73_728)
    assert tg.kernel_route(None, [np.zeros(0, np.int16)], ("sum",),
                           limit + 1, 73_728) in ("scatter", "sort")
    codes = tg.torch.zeros(limit + 1, dtype=tg.torch.int32)
    rows = tg.torch.zeros(1, limit + 1, dtype=tg.torch.bfloat16)
    with pytest.raises(ValueError, match="HICARD_MAX_ROWS"):
        onehot.onehot_rows_dot_hicard(codes, rows, 1, 73_728)


def test_map_ordered_keeps_input_order(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_PIPELINE_THREADS", "4")
    rng = np.random.default_rng(3)
    delays = rng.random(24) * 0.005
    seen = set()

    def work(i):
        time.sleep(delays[i])
        seen.add(threading.get_ident())
        return i * i

    assert pipeline.map_ordered(work, range(24)) == [i * i for i in range(24)]
    assert len(seen) > 1
    with pytest.raises(ZeroDivisionError):
        pipeline.map_ordered(lambda i: 1 // (i - 2), range(8))
    monkeypatch.setenv("BQUERYD_TPU_PIPELINE_THREADS", "1")
    seen.clear()
    assert pipeline.map_ordered(work, range(5)) == [0, 1, 4, 9, 16]
    assert seen == {threading.get_ident()}
    assert pipeline.submit(work, 3).result() == 9
    with pytest.raises(ZeroDivisionError):
        pipeline.submit(lambda: 1 // 0).result()

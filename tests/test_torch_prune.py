"""Chunk-zone-map pruning of the port on the CPU, against the JAX package:
tables written with ``chunklen=4096`` and a monotonic column, the keep
masks and counts of ``chunk_selection``/``chunk_pruned_table``, the
``ChunkView`` reads, and pruned ``worker.execute`` results equal to the
unpruned ones on every route (ints bit for bit, floats within
``_compare``), with no sidecar written or read for a view."""

import os

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.ops import predicates as jax_predicates
from bqueryd_tpu.plan import stats as jax_stats
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import ops, worker
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.ops import predicates
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.plan import stats
from bqueryd_tpu_torch.rpc import LocalRPC
from bqueryd_tpu_torch.storage.ctable import ChunkView, ctable, table_cache_key
from test_differential_fuzz import _compare, _filter_df
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

CHUNKLEN = 4096
ROWS = 20_000  # 5 chunks per shard, the last one short
T0 = pd.Timestamp("2016-01-01")


def _frames(seed=3, shards=2):
    rng = np.random.default_rng(seed)
    frames = []
    for s in range(shards):
        base = s * 2 * ROWS
        frames.append(pd.DataFrame({
            # strictly increasing, step 2: chunk i holds [lo_i, lo_i + 8190]
            "mono": base + 2 * np.arange(ROWS, dtype=np.int64),
            "t": T0 + pd.to_timedelta(
                s * ROWS + np.arange(ROWS), unit="s"),
            "k_int": rng.integers(0, 7, ROWS).astype(np.int64),
            "k_str": rng.choice(["a", "b", None], ROWS),
            "v_small": rng.integers(-1000, 1000, ROWS).astype(np.int64),
            "v_float": np.where(rng.random(ROWS) < 0.05, np.nan,
                                rng.random(ROWS) * 100 - 50
                                ).astype(np.float32),
            "basket": np.sort(rng.integers(0, ROWS // 8, ROWS)),
        }))
    return frames


def _write(root, frames):
    names = []
    for i, df in enumerate(frames):
        name = f"p_{i}.bcolzs"
        jax_ctable.fromdataframe(df, str(root / name), chunklen=CHUNKLEN)
        names.append(name)
    return names


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_prune")
    frames = _frames()
    return root, frames, _write(root, frames)


#: where-term lists: prunable ranges, equality and membership (incl. a
#: value inside the shard's range but in no chunk's), datetimes, ops that
#: never prune, and terms on columns without zone maps
WHERES = {
    "ge_tail": [["mono", ">=", 2 * ROWS + 2 * 4 * CHUNKLEN]],
    "le_head": [["mono", "<=", 2 * CHUNKLEN - 10]],
    "eq": [["mono", "==", 2 * 3 * CHUNKLEN + 40]],
    "eq_gap": [["mono", "==", 2 * CHUNKLEN - 1]],
    "in": [["mono", "in", [10, 2 * ROWS + 2 * 2 * CHUNKLEN + 2]]],
    "datetime": [["t", ">", T0 + pd.Timedelta(seconds=ROWS + 3 * CHUNKLEN)]],
    "and": [["mono", ">", 2 * CHUNKLEN], ["mono", "<=", 2 * 2 * CHUNKLEN],
            ["v_small", ">", 0]],
    "ne": [["mono", "!=", 8]],
    "not_in": [["mono", "not in", [8, 10]]],
    "dict": [["k_str", "==", "a"]],
    "wide": [["mono", ">", 100]],
    "float": [["v_float", ">", 49.0]],
}


@pytest.mark.parametrize("where", sorted(WHERES))
def test_chunk_selection_matches_jax(shards, where):
    root, _frames_, names = shards
    terms = WHERES[where]
    for name in names:
        port = ctable(str(root / name), mode="r")
        ref = jax_ctable(str(root / name), mode="r")
        assert port.chunk_rows() == ref.chunk_rows()
        for col in ("mono", "t", "v_float", "k_str"):
            assert port.chunk_zone_maps(col) == ref.chunk_zone_maps(col)
        keep = predicates.chunk_selection(port, terms)
        want = jax_predicates.chunk_selection(ref, terms)
        if want is None:
            assert keep is None
        else:
            np.testing.assert_array_equal(keep, want)
        view, decoded, skipped = predicates.chunk_pruned_table(port, terms)
        ref_view, ref_decoded, ref_skipped = (
            jax_predicates.chunk_pruned_table(ref, terms))
        assert (decoded, skipped) == (ref_decoded, ref_skipped)
        assert (view is port) == (ref_view is ref)
        if view is not port:
            assert isinstance(view, ChunkView)
            assert view.chunk_ids == ref_view.chunk_ids
            assert view.nrows == ref_view.nrows == len(view)
            assert view.chunk_rows() == ref_view.chunk_rows()
            for col in ("mono", "t", "k_int", "k_str", "v_float"):
                np.testing.assert_array_equal(view.column_raw(col),
                                              ref_view.column_raw(col))
                np.testing.assert_array_equal(view.column(col),
                                              ref_view.column(col))
                assert view.col_stats(col) == ref_view.col_stats(col)
            assert view.dictionary("k_str") == ref_view.dictionary("k_str")


def test_zone_can_match_matches_jax():
    values = [5, 5.5, -1, 100, [1, 50], [], (9, 200), "x", None]
    for op in ("==", "!=", "<", "<=", ">", ">=", "in", "not in"):
        for value in values:
            for lo, hi in ((0, 10), (5, 5), (-3.5, 2.0)):
                assert stats.zone_can_match(lo, hi, op, value) == (
                    jax_stats.zone_can_match(lo, hi, op, value)), (op, value)


def test_prune_switches(shards, monkeypatch):
    root, _frames_, names = shards
    table = ctable(str(root / names[0]), mode="r")
    terms = WHERES["le_head"]
    view, decoded, skipped = predicates.chunk_pruned_table(table, terms)
    assert (decoded, skipped) == (1, 4) and view is not table
    monkeypatch.setenv("BQUERYD_TPU_CHUNK_PRUNE", "0")
    assert predicates.chunk_pruned_table(table, terms) == (table, 0, 0)
    monkeypatch.setenv("BQUERYD_TPU_CHUNK_PRUNE", "1")
    # a floor below the surviving share (1 of 5) keeps the whole table
    monkeypatch.setenv("BQUERYD_TPU_CHUNK_PRUNE_SELECTIVITY", "0.1")
    assert predicates.chunk_pruned_table(table, terms) == (table, 5, 0)
    monkeypatch.setenv("BQUERYD_TPU_CHUNK_PRUNE_SELECTIVITY", "junk")
    assert predicates.chunk_prune_selectivity() == 0.9


def test_chunk_view_bounds_and_identity(shards):
    root, _frames_, names = shards
    table = ctable(str(root / names[0]), mode="r")
    with pytest.raises(IndexError):
        table.chunk_view([5])
    view = table.chunk_view([3, 1])
    assert view.chunk_ids == [1, 3]
    assert view.rootdir is None and view.mode == "r"
    # deterministic per (parent, selection), never the parent's identity
    assert table_cache_key(view) == table_cache_key(table.chunk_view([1, 3]))
    assert table_cache_key(view) != table_cache_key(table.chunk_view([1]))
    assert table_cache_key(view) != table_cache_key(table)
    for name in ("factor_stamp", "factor_cache_load", "factor_cache_store",
                 "composite_stamp", "composite_cache_load",
                 "composite_cache_store"):
        assert not hasattr(view, name)
    # prefetch decodes the selection into the decoded-column cache
    for fut in view.prefetch(["mono", "missing"]):
        fut.result()
    np.testing.assert_array_equal(
        view.column_raw("mono"),
        np.concatenate([table.column_raw("mono")[CHUNKLEN:2 * CHUNKLEN],
                        table.column_raw("mono")[3 * CHUNKLEN:4 * CHUNKLEN]]))


QUERIES = {
    "sum_mean": (["k_int"], [["v_small", "sum", "s"],
                             ["v_float", "mean", "m"],
                             ["v_small", "count", "n"]], {}),
    "multikey": (["k_int", "k_str"], [["v_small", "sum", "s"],
                                      ["v_float", "max", "hi"]], {}),
    "distinct": (["k_int"], [["v_small", "count_distinct", "nd"],
                             ["v_small", "sum", "s"]], {}),
    "runs": (["k_str"], [["v_small", "sorted_count_distinct", "r"]], {}),
    "raw": (["k_int"], [["v_small", "sum", "v_small"]],
            {"aggregate": False}),
}


def _run(tables, query, engine, executor):
    report = {}
    payload = worker.execute(tables, query, engine, executor=executor,
                             report=report)
    return hostmerge.finalize_table(hostmerge.merge_payloads([payload])), \
        report


def _frame(order, columns):
    return pd.DataFrame({c: columns[c] for c in order}, columns=order)


@pytest.mark.parametrize("where", ["ge_tail", "and", "eq_gap", "datetime",
                                   "ne"])
@pytest.mark.parametrize("query_name", sorted(QUERIES))
@pytest.mark.parametrize("n_shards", [1, 2])
def test_pruned_execute_equals_unpruned(shards, monkeypatch, where,
                                        query_name, n_shards):
    root, frames, names = shards
    gcols, aggs, kw = QUERIES[query_name]
    query = GroupByQuery(gcols, aggs, WHERES[where], **kw)
    tables = [ctable(str(root / n), mode="r") for n in names[:n_shards]]
    engine = QueryEngine(device="cpu")
    executor = MeshQueryExecutor(device="cpu")
    (order, got), report = _run(tables, query, engine, executor)
    # the reference's own seam, summed over the shards as its worker does
    counts = [
        jax_predicates.chunk_pruned_table(
            jax_ctable(str(root / n), mode="r"), WHERES[where])[1:]
        for n in names[:n_shards]
    ]
    monkeypatch.setenv("BQUERYD_TPU_CHUNK_PRUNE", "0")
    (want_order, want), off = _run(tables, query, QueryEngine(device="cpu"),
                                   MeshQueryExecutor(device="cpu"))
    assert "chunk_prune" not in off
    assert order == want_order
    decoded, skipped = (sum(c[0] for c in counts), sum(c[1] for c in counts))
    assert report.get("chunk_prune") == (
        (decoded, skipped) if decoded or skipped else None)
    if not kw.get("aggregate", True):
        # raw rows keep the table's row order through a view
        for col in order:
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)
        return
    if not order:
        assert not want_order
        return
    g, w = _frame(order, got), _frame(want_order, want)
    _compare(g, w, gcols, aggs)
    for _in, op, out in aggs:
        if op != "mean":
            np.testing.assert_array_equal(
                g.sort_values(gcols)[out].to_numpy(),
                w.sort_values(gcols)[out].to_numpy(), err_msg=out)


def test_views_key_the_working_set_and_write_no_sidecars(tmp_path,
                                                         monkeypatch):
    """The executor over pruned views keys align, codes and blocks by each
    view's own identity; a view writes no factor or composite sidecar and
    reads none of its parent's."""
    frames = _frames(seed=8)
    names = _write(tmp_path, frames)
    reads = []
    for name in ("factor_cache_load", "composite_cache_load"):
        real = getattr(ctable, name)

        def spy(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(ctable, name, spy)
    rpc = LocalRPC(str(tmp_path), device="cpu")
    gcols, aggs = ["k_int", "k_str"], [["v_small", "sum", "s"]]
    where = WHERES["and"]
    order, columns = rpc.groupby(names, gcols, aggs, where)
    assert rpc.last_chunk_prune == (2, 8)
    assert rpc.last_merge_mode == "device"
    assert reads == []
    sidecars = [f for _r, _d, files in os.walk(tmp_path) for f in files
                if f.endswith(".npz")]
    assert sidecars == []
    # shard 1's view holds no chunk and its stats rule it out: the
    # executor aligns shard 0's view alone
    views = [ops.chunk_pruned_table(rpc._table(n), where)[0] for n in names]
    assert views[1].nrows == 0
    tables_key = (table_cache_key(views[0]),)
    parents_key = (table_cache_key(rpc._table(names[0])),)
    assert (tables_key, tuple(gcols)) in rpc.executor._align_cache
    assert (parents_key, tuple(gcols)) not in rpc.executor._align_cache
    stats_before = rpc.executor.workingset.stats()
    again = rpc.groupby(names, gcols, aggs, where)
    stats_after = rpc.executor.workingset.stats()
    for seg in ("align", "codes", "blocks"):
        assert stats_after[seg]["misses"] == stats_before[seg]["misses"], seg
        assert stats_after[seg]["hits"] > stats_before[seg]["hits"], seg
    for col in order:
        np.testing.assert_array_equal(again[1][col], columns[col])
    want = _filter_df(pd.concat(frames, ignore_index=True), where)
    want = want.groupby(gcols, dropna=True)["v_small"].sum().reset_index()
    got = _frame(order, columns)
    _compare(got, want.rename(columns={"v_small": "s"}), gcols, aggs)
    # the full table still writes its own sidecars afterwards
    rpc.groupby(names, gcols, aggs)
    assert any(f.endswith(".npz") for _r, _d, files in os.walk(tmp_path)
               for f in files)


def test_basket_expansion_skips_pruning(shards):
    root, frames, names = shards
    rpc = LocalRPC(str(root), device="cpu")
    where = WHERES["le_head"]
    gcols, aggs = ["k_int"], [["v_small", "sum", "s"]]
    rpc.groupby(names, gcols, aggs, where)
    assert rpc.last_chunk_prune == (1, 9)
    order, columns = rpc.groupby(names, gcols, aggs, where,
                                 expand_filter_column="basket")
    assert rpc.last_chunk_prune is None
    expanded = []
    for df in frames:
        hit = _filter_df(df, where).index
        expanded.append(df[df["basket"].isin(df.loc[hit, "basket"].unique())])
    want = pd.concat(expanded, ignore_index=True).groupby(gcols)[
        "v_small"].sum().reset_index().rename(columns={"v_small": "s"})
    _compare(_frame(order, columns), want, gcols, aggs)


@pytest.mark.parametrize("gcols", [["k_int"], ["k_int", "k_str"]])
def test_view_of_no_chunks_answers_no_groups(shards, gcols):
    """A filter value inside a shard's range but in no chunk's prunes every
    chunk.  The reference engine then indexes its empty group table with a
    one-group row count and raises IndexError; the port's engine and
    executor answer with no groups, as the unpruned query does."""
    from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
    from bqueryd_tpu.models.query import QueryEngine as JaxEngine

    root, _frames_, names = shards
    where = WHERES["eq_gap"]
    aggs = [["v_small", "sum", "s"]]
    ref_view, decoded, skipped = jax_predicates.chunk_pruned_table(
        jax_ctable(str(root / names[0]), mode="r"), where)
    assert (decoded, skipped) == (0, 5)
    with pytest.raises(IndexError):
        JaxEngine().execute_local(ref_view, JaxQuery(gcols, aggs, where))
    view = ops.chunk_pruned_table(ctable(str(root / names[0]), mode="r"),
                                  where)[0]
    query = GroupByQuery(gcols, aggs, where)
    for payload in (
        QueryEngine(device="cpu").execute_local(view, query),
        MeshQueryExecutor(device="cpu").execute([view], query),
    ):
        assert payload["kind"] == "partials"
        assert len(payload["rows"]) == 0
        assert all(len(v) == 0 for v in payload["keys"].values())

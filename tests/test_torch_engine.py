"""The port's slice as a whole, on the CPU, against the JAX package:
shared on-disk shards, every differential-fuzz query through
``LocalRPC.groupby`` and through the JAX ``QueryEngine`` + ``hostmerge``
path, payload interchange between the two host merges, raw rows, the
distinct ops, basket expansion and run counts on basket-sorted data."""

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
from bqueryd_tpu.models.query import QueryEngine as JaxEngine
from bqueryd_tpu.models.query import ResultPayload as JaxPayload
from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.rpc import LocalRPC
from bqueryd_tpu_torch.storage.ctable import ctable
from test_differential_fuzz import (
    CASES,
    _compare,
    _dataset,
    _expected,
    _filter_df,
)
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

PORT_CASES = list(range(len(CASES)))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The fuzz dataset written by the JAX package's ctable."""
    root = tmp_path_factory.mktemp("torch_engine")
    frames = _dataset(20240601)
    names = []
    for i, df in enumerate(frames):
        name = f"shard_{i}.bcolzs"
        jax_ctable.fromdataframe(df, str(root / name))
        names.append(name)
    return root, frames, names


def _frame(order, columns):
    return pd.DataFrame({c: columns[c] for c in order}, columns=order)


def _jax_result(root, names, gcols, aggs, where, aggregate=True,
                expand_filter_column=None):
    query = JaxQuery(gcols, aggs, where, aggregate=aggregate,
                     expand_filter_column=expand_filter_column)
    engine = JaxEngine()
    payloads = [
        engine.execute_local(jax_ctable(str(root / n), mode="r"), query)
        for n in names
    ]
    return jax_hostmerge.merge_payloads(payloads)


def test_port_reads_jax_shards(shards):
    root, frames, names = shards
    for name, df in zip(names, frames):
        t = ctable(str(root / name), mode="r")
        ref = jax_ctable(str(root / name), mode="r")
        assert t.names == ref.names == list(df.columns)
        for col in df.columns:
            assert t.kind(col) == ref.kind(col)
            np.testing.assert_array_equal(t.column_raw(col),
                                          ref.column_raw(col), err_msg=col)
            np.testing.assert_array_equal(t.column(col), ref.column(col),
                                          err_msg=col)


def test_jax_reads_port_shards(shards, tmp_path):
    root, frames, names = shards
    df = frames[0]
    ctable.fromdataframe(df, str(tmp_path / "p.bcolzs"))
    back = jax_ctable(str(tmp_path / "p.bcolzs"), mode="r")
    ref = jax_ctable(str(root / names[0]), mode="r")
    for col in df.columns:
        np.testing.assert_array_equal(back.column(col), ref.column(col),
                                      err_msg=col)
    # numeric columns from plain arrays, without pandas
    arrays = {c: df[c].to_numpy() for c in ("k_int", "v_big", "v_float")}
    t = ctable(str(tmp_path / "a.bcolzs"), mode="w")
    t.append(arrays)
    t.flush()
    back = jax_ctable(str(tmp_path / "a.bcolzs"), mode="r")
    for col, values in arrays.items():
        assert back.kind(col) == "numeric"
        np.testing.assert_array_equal(back.column(col), values, err_msg=col)


@pytest.mark.parametrize("case_i", PORT_CASES)
def test_local_rpc_matches_jax_engine(shards, case_i):
    root, frames, names = shards
    gcols, aggs, where = CASES[case_i]
    order, columns = LocalRPC(str(root), device="cpu").groupby(
        names, gcols, aggs, where
    )
    got = _frame(order, columns)
    want = jax_hostmerge.payload_to_dataframe(
        _jax_result(root, names, gcols, aggs, where)
    )
    _compare(got, want, gcols, aggs)
    _compare(got, _expected(frames, gcols, aggs, where), gcols, aggs)


def test_payloads_merge_across_packages(shards):
    root, _frames, names = shards
    gcols = ["k_str", "k_int"]
    aggs = [["v_big", "sum", "s"], ["v_float", "mean", "m"],
            ["v_small", "min", "lo"], ["v_float", "count", "n"]]
    where = [["sel", ">", 0.2]]
    port_q = GroupByQuery(gcols, aggs, where)
    jax_q = JaxQuery(gcols, aggs, where)
    port_engine, jax_engine = QueryEngine(device="cpu"), JaxEngine()
    port_payloads = [
        port_engine.execute_local(ctable(str(root / n), mode="r"), port_q)
        for n in names
    ]
    jax_payloads = [
        jax_engine.execute_local(jax_ctable(str(root / n), mode="r"), jax_q)
        for n in names
    ]
    want = jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads(jax_payloads)
    )
    # port payloads through the wire into the JAX merge, mixed with its own
    mixed = [JaxPayload.from_bytes(port_payloads[0].to_bytes())] + [
        JaxPayload.from_bytes(p.to_bytes()) for p in jax_payloads[1:]
    ]
    got = jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads(mixed)
    )
    _compare(got, want, gcols, aggs)
    # and the reverse: JAX payloads into the port's merge
    mixed = [ResultPayload.from_bytes(p.to_bytes()) for p in jax_payloads]
    mixed[1] = port_payloads[1]
    got = hostmerge.payload_to_dataframe(hostmerge.merge_payloads(mixed))
    _compare(got, want, gcols, aggs)


def test_raw_rows_match_jax(shards):
    root, _frames, names = shards
    gcols, aggs = ["k_int", "k_str"], [["v_small", "sum", "v_small"]]
    where = [["sel", "<=", 0.3], ["k_int", "in", [1, 2, 5]]]
    order, columns = LocalRPC(str(root), device="cpu").groupby(
        names, gcols, aggs, where, aggregate=False
    )
    want_order, want = jax_hostmerge.finalize_table(
        _jax_result(root, names, gcols, aggs, where, aggregate=False)
    )
    assert order == want_order
    for col in order:
        np.testing.assert_array_equal(columns[col], want[col], err_msg=col)


def test_pruned_shard_returns_empty(shards):
    root, _frames, names = shards
    order, columns = LocalRPC(str(root), device="cpu").groupby(
        names, ["k_int"], [["v_small", "sum", "s"]], [["sel", ">", 2.0]]
    )
    assert order == [] and columns == {}


@pytest.mark.parametrize(
    "aggs",
    [
        [["v_float", "count_distinct", "nd"]],
        [["v_small", "sum", "s"], ["v_small", "sorted_count_distinct", "r"]],
    ],
)
@pytest.mark.parametrize("n_files", [1, 3])
def test_distinct_ops_match_jax_engine(shards, aggs, n_files):
    """One file's count_distinct is the device sort's final counts, several
    files' are value sets unioned on the host; sorted_count_distinct's run
    counts add across shards.  Both agree with the JAX engine bit for bit."""
    root, frames, names = shards
    rpc = LocalRPC(str(root), device="cpu")
    order, columns = rpc.groupby(names[:n_files], ["k_int"], aggs)
    assert rpc.last_merge_mode == ("none" if n_files == 1 else "host")
    got = _frame(order, columns)
    jax_query = JaxQuery(["k_int"], aggs, sole_payload=n_files == 1)
    engine = JaxEngine()
    want = jax_hostmerge.payload_to_dataframe(jax_hostmerge.merge_payloads([
        engine.execute_local(jax_ctable(str(root / n), mode="r"), jax_query)
        for n in names[:n_files]
    ]))
    _compare(got, want, ["k_int"], aggs)
    got = got.sort_values("k_int").reset_index(drop=True)
    want = want.sort_values("k_int").reset_index(drop=True)
    for _in, _op, out in aggs:
        assert got[out].dtype == np.int64
        np.testing.assert_array_equal(got[out].to_numpy(),
                                      want[out].to_numpy())


@pytest.mark.parametrize(
    "where",
    [
        [["sel", ">", 0.97]],
        [["v_small", ">", 900]],
    ],
)
def test_basket_expansion_matches_jax_engine(shards, where):
    """expand_filter_column widens a filter to whole baskets per shard: any
    matching row selects its entire basket (the reference fuzz's
    ``test_basket_expansion_matches_pandas``), through ``LocalRPC`` (the
    executor) and the engine, against the JAX engine and pandas."""
    root, frames, names = shards
    gcols, aggs = ["k_int"], [["v_small", "sum", "s"],
                              ["v_float", "count", "n"]]
    rpc = LocalRPC(str(root), device="cpu")
    order, columns = rpc.groupby(names, gcols, aggs, where,
                                 expand_filter_column="basket")
    assert rpc.last_merge_mode == "device"
    got = _frame(order, columns)
    want = jax_hostmerge.payload_to_dataframe(_jax_result(
        root, names, gcols, aggs, where, expand_filter_column="basket"))
    expanded = []
    for df in frames:
        hit = _filter_df(df, where).index
        keep = df["basket"].isin(df.loc[hit, "basket"].unique())
        expanded.append(df[keep])
    _compare(got, want, gcols, aggs)
    _compare(got, _expected(expanded, gcols, aggs, []), gcols, aggs)
    engine = QueryEngine(device="cpu")
    query = GroupByQuery(gcols, aggs, where, expand_filter_column="basket")
    merged = hostmerge.merge_payloads([
        engine.execute_local(ctable(str(root / n), mode="r"), query)
        for n in names
    ])
    _compare(hostmerge.payload_to_dataframe(merged), want, gcols, aggs)


def test_basket_expansion_of_raw_rows_matches_jax(shards):
    root, _frames, names = shards
    gcols, aggs = ["k_str"], [["v_small", "sum", "v_small"]]
    where = [["sel", ">", 0.95]]
    order, columns = LocalRPC(str(root), device="cpu").groupby(
        names, gcols, aggs, where, aggregate=False,
        expand_filter_column="k_str")
    want_order, want = jax_hostmerge.finalize_table(_jax_result(
        root, names, gcols, aggs, where, aggregate=False,
        expand_filter_column="k_str"))
    assert order == want_order
    for col in order:
        np.testing.assert_array_equal(columns[col], want[col], err_msg=col)


def test_sorted_count_distinct_on_basket_sorted_data(tmp_path):
    """On data sorted by (group, value) per shard, the basket layout the op
    exists for, the summed run counts equal pandas nunique per shard (the
    reference fuzz's test of the same name), through ``LocalRPC`` and the
    JAX engine alike."""
    rng = np.random.default_rng(77)
    frames, names = [], []
    for i in range(2):
        n = 3_000
        df = pd.DataFrame(
            {
                "g": np.sort(rng.integers(0, 5, n)).astype(np.int64),
                "v": rng.integers(0, 40, n).astype(np.int64),
            }
        ).sort_values(["g", "v"], kind="stable").reset_index(drop=True)
        jax_ctable.fromdataframe(df, str(tmp_path / f"s{i}.bcolzs"))
        frames.append(df)
        names.append(f"s{i}.bcolzs")
    aggs = [["v", "sorted_count_distinct", "nd"]]
    order, columns = LocalRPC(str(tmp_path), device="cpu").groupby(
        names, ["g"], aggs)
    got = _frame(order, columns).sort_values("g").reset_index(drop=True)
    expected = sum(
        df.groupby("g")["v"].nunique() for df in frames
    ).sort_index()
    assert got["g"].tolist() == expected.index.tolist()
    assert got["nd"].tolist() == expected.tolist()
    want = jax_hostmerge.payload_to_dataframe(
        _jax_result(tmp_path, names, ["g"], aggs, []))
    assert want.sort_values("g")["nd"].tolist() == expected.tolist()

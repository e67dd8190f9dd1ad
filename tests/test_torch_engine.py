"""The port's slice as a whole, on the CPU, against the JAX package:
shared on-disk shards, the differential-fuzz queries through
``LocalRPC.groupby`` and through the JAX ``QueryEngine`` + ``hostmerge``
path, payload interchange between the two host merges, raw rows, and the
ops that wait for later slices."""

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
from test_differential_fuzz import CASES, _compare, _dataset, _expected

MERGEABLE = ("sum", "mean", "count", "count_na", "min", "max")
PORT_CASES = [
    i for i, (_g, aggs, _w) in enumerate(CASES)
    if all(op in MERGEABLE for _i, op, _o in aggs)
]


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


def _jax_result(root, names, gcols, aggs, where, aggregate=True):
    query = JaxQuery(gcols, aggs, where, aggregate=aggregate)
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
def test_distinct_ops_are_not_ported_yet(shards, aggs):
    root, _frames, names = shards
    rpc = LocalRPC(str(root), device="cpu")
    with pytest.raises(NotImplementedError, match="distinct"):
        rpc.groupby(names, ["k_int"], aggs)

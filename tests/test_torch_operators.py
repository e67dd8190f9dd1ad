"""The port's operator DAG (the ``query`` verb) against the JAX package's.

The same numpy inputs go through ``bqueryd_tpu`` (JAX on the CPU; its
relational operators are jnp, no Pallas) and ``bqueryd_tpu_torch`` (torch
on the CPU, ``device="cpu"``):

* ``plan.dag``: the plain round trip over the differential fuzz corpus
  field for field, equal signatures and wire forms for every spec shape,
  and the same validation errors (class and text);
* ``ops.relops``: top-k, sketch bucket keys and the join gather bit for
  bit against the JAX host twins (``parallel.opexec``) and device twins;
* ``parallel.opexec.DagExecutor``: per-shard payloads of every shape of
  ``tests/test_operators.py`` (joins, top-k, quantiles, windows, the
  combined shape) against the JAX ``DagExecutor``'s: keys, row counts,
  ints, top-k lists and sketches exact, floats within ``_compare``'s rtol
  2e-5 / atol 1e-6, merged results against pandas with quantiles within
  alpha;
* a port cluster (controller, calc worker on the CPU, ``RPC``, threads
  over TCP ZMQ on 127.0.0.1) answering ``RPC.query`` as
  ``tests/test_operators.py``'s cluster cases do, plus the result-cache
  hit, the plain DAG bit-identical to ``RPC.groupby``, and a JAX ``RPC``
  reading the port cluster's DAG replies.
"""

import logging
import pickle
import threading
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
from bqueryd_tpu.models.query import QueryEngine as JaxEngine
from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
from bqueryd_tpu.parallel import opexec as jax_opexec
from bqueryd_tpu.plan import dag as jax_dag
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.ops import relops
from bqueryd_tpu_torch.parallel import hostmerge, opexec
from bqueryd_tpu_torch.plan import dag as dagmod
from bqueryd_tpu_torch.storage.ctable import ctable
from tests.conftest import wait_until
from test_differential_fuzz import CASES
from test_operators import ALPHA, _dataset, _dim, _pandas_side
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6
RPC_TIMEOUT = 30
QUIET = logging.WARNING
CPU = "cpu"


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """``tests/test_operators.py``'s dataset, written by the JAX package's
    ctable: ``(frames, paths)``."""
    root = tmp_path_factory.mktemp("torch_operators")
    paths = []
    for i, df in enumerate(_dataset()):
        p = str(root / f"op_{i}.bcolzs")
        jax_ctable.fromdataframe(df, p)
        paths.append(p)
    return _dataset(), paths


# -- plan.dag ----------------------------------------------------------------

@pytest.mark.parametrize("case_i", range(len(CASES)))
def test_plain_round_trip_matches_reference(case_i):
    """Every fuzz case round-trips GroupByQuery -> DAG -> GroupByQuery field
    for field in the port, through the wire form too, with the JAX
    package's query and DAG signatures."""
    gcols, agg_list, where = CASES[case_i]
    q = GroupByQuery(gcols, agg_list, where)
    ref_q = JaxQuery(gcols, agg_list, where)
    dag = dagmod.dag_from_query(q, filenames=["x.bcolzs"])
    ref_dag = jax_dag.dag_from_query(ref_q, filenames=["x.bcolzs"])
    assert dag.is_plain()
    assert dag.plain_groupby_query().signature() == q.signature()
    assert q.signature() == ref_q.signature()
    assert dag.signature() == ref_dag.signature()
    wire = dag.to_wire()
    assert wire == ref_dag.to_wire()
    again = dagmod.OperatorDAG.from_wire(pickle.loads(pickle.dumps(wire)))
    assert again.plain_groupby_query().signature() == q.signature()


def _specs():
    dim = _dim()
    return {
        "plain": {"table": ["a", "b"], "groupby": ["g"],
                  "aggs": [["v_int", "sum", "s"], ["v_float", "mean", "m"]],
                  "where": [["sel", ">", 0.5]]},
        "join": {"table": ["x"], "groupby": ["region"],
                 "aggs": [["v_int", "sum", "s"], ["weight", "sum", "w"]],
                 "where": [["sel", ">", 0.5], ["region", "in", ["r0", "r2"]]],
                 "join": {"table": dim, "on": "cust",
                          "select": ["region", "weight"]}},
        "topk": {"table": ["x"], "groupby": ["g"],
                 "aggs": [["v_int", "topk", "t", {"k": 3}],
                          ["v_float", "topk", "b", {"k": 2,
                                                    "largest": False}]]},
        "quantile": {"table": ["x"], "groupby": ["g"],
                     "aggs": [["v_float", "quantile", "p50", {"q": 0.5}],
                              ["v_float", "quantile", "p99",
                               {"q": 0.99, "alpha": ALPHA}]]},
        "window": {"table": ["x"],
                   "groupby": ["g", {"window": {"on": "t", "every": "30m",
                                                "alias": "hw"}}],
                   "aggs": [["v_int", "count", "n"]]},
        "combined": {"table": ["x"],
                     "groupby": ["region", {"window": {"on": "t",
                                                       "every": "4h"}}],
                     "aggs": [["v_int", "sum", "s"],
                              ["v_int", "topk", "top2", {"k": 2}],
                              ["v_float", "quantile", "med", {"q": 0.5}]],
                     "where": [["sel", ">", 0.3]],
                     "join": {"table": dim, "on": "cust",
                              "select": ["region"]}},
    }


@pytest.mark.parametrize("shape", sorted(_specs()))
def test_spec_compiles_to_the_reference_dag(shape):
    """Equal DAG signatures, wire forms, batching and groupby-shaped plan
    signatures: a JAX client and a port controller see one query."""
    spec = _specs()[shape]
    dag, ref = dagmod.compile_query(spec), jax_dag.compile_query(spec)
    assert dag.signature() == ref.signature()
    assert dag.is_plain() == ref.is_plain() == (shape == "plain")
    assert dagmod.dag_batchable(dag) == jax_dag.dag_batchable(ref)
    assert pickle.dumps(dag.to_wire()) == pickle.dumps(ref.to_wire())
    plan, kwargs = dagmod.groupby_equivalent(dag)
    ref_plan, ref_kwargs = jax_dag.groupby_equivalent(ref)
    assert plan.signature() == ref_plan.signature()
    assert plan.physical_agg_list() == ref_plan.physical_agg_list()
    assert kwargs["batch"] == ref_kwargs["batch"]
    assert set(dag.nodes()) == set(ref.nodes())
    assert dag.edges() == ref.edges()


def _bad_specs():
    ok = {"table": ["x"], "groupby": ["g"], "aggs": [["v", "sum", "s"]]}
    return [
        {**ok, "aggs": [["v", "median", "m"]]},
        {**ok, "aggs": [["v", "quantile", "m", {"q": 1.5}]]},
        {**ok, "aggs": [["v", "quantile", "m", {"alpha": 0.1}]]},
        {**ok, "aggs": [["v", "topk", "m", {"k": 0}]]},
        {**ok, "aggs": [["v", "topk", "t", {"k": 10**9}]]},
        {**ok, "aggs": [["v", "sum", "m", {"k": 1}]]},
        {**ok, "aggs": []},
        {**ok, "groupby": []},
        {**ok, "aggs": [["v", "sum", "g"]]},
        {**ok, "bogus": 1},
        {**ok, "table": []},
        {**ok, "where": [["v", ">"]]},
        {**ok, "groupby": [{"window": {"on": "t", "every": "xyz"}}]},
        {**ok, "groupby": [{"window": {"on": "t", "every": "1h"}},
                           {"window": {"on": "t", "every": "2h"}}]},
        {**ok, "groupby": [{"window": {"on": "t", "every": "1h",
                                       "alias": "t"}}]},
        {**ok, "join": {"table": {"cust": np.array([1, 1, 2]),
                                  "x": np.array([1, 2, 3])},
                        "on": "cust", "select": ["x"]}},
        {**ok, "join": {"table": {"cust": np.array([1, 2]),
                                  "x": np.array([1, 2, 3])},
                        "on": "cust", "select": ["x"]}},
        {**ok, "join": {"table": {"cust": np.array([1, 2])}, "on": "cust",
                        "select": ["zz"]}},
        {**ok, "join": {"table": {"k": np.array([1])}, "on": "cust"}},
        "not a dict",
    ]


@pytest.mark.parametrize("case_i", range(len(_bad_specs())))
def test_validation_errors_match_reference(case_i):
    spec = _bad_specs()[case_i]
    with pytest.raises(jax_dag.DagValidationError) as want:
        jax_dag.compile_query(spec)
    with pytest.raises(dagmod.DagValidationError) as got:
        dagmod.compile_query(spec)
    assert got.value.error_class == want.value.error_class
    assert str(got.value) == str(want.value)


def test_broadcast_limit_and_settings_match_reference(monkeypatch):
    big = {"table": ["x"], "groupby": ["x"], "aggs": [["v", "sum", "s"]],
           "join": {"table": {"cust": np.arange(10), "x": np.arange(10)},
                    "on": "cust", "select": ["x"]}}
    monkeypatch.setenv("BQUERYD_TPU_JOIN_BROADCAST_LIMIT", "5")
    monkeypatch.setenv("BQUERYD_TPU_TOPK_LIMIT", "7")
    monkeypatch.setenv("BQUERYD_TPU_SKETCH_ALPHA", "0.02")
    with pytest.raises(dagmod.DagValidationError, match="broadcast limit"):
        dagmod.compile_query(big)
    assert dagmod.topk_limit() == jax_dag.topk_limit() == 7
    assert dagmod.sketch_alpha() == jax_dag.sketch_alpha() == 0.02
    assert dagmod.make_quantile_op(0.5) == jax_dag.make_quantile_op(0.5)
    monkeypatch.setenv("BQUERYD_TPU_DAG_BATCH", "0")
    topk = dagmod.compile_query(_specs()["topk"])
    assert not dagmod.dag_batchable(topk)
    assert not jax_dag.dag_batchable(jax_dag.compile_query(_specs()["topk"]))


# -- ops.relops ----------------------------------------------------------------

def _topk_values(rng, n):
    return {
        "int": rng.integers(-(2**60), 2**60, n),
        "float_nan": np.where(rng.random(n) < 0.1, np.nan,
                              rng.random(n) * 100 - 50),
        "ties": rng.integers(0, 4, n).astype(np.int64),
        "bool": rng.random(n) < 0.5,
        "float32": (rng.random(n) * 10).astype(np.float32),
        "uint64": rng.integers(0, 2**63, n).astype(np.uint64) * np.uint64(2),
    }


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("kind", ["int", "float_nan", "ties", "bool",
                                  "float32", "uint64"])
def test_topk_bit_identical_to_reference_twins(kind, largest):
    from bqueryd_tpu.ops import relops as jax_relops

    rng = np.random.default_rng(11)
    n = 4000
    codes = rng.integers(-1, 9, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    vals = _topk_values(rng, n)[kind]
    for k in (1, 4):
        got_v, got_o = relops.topk_partials(codes, vals, k, largest, 9,
                                            mask=mask, device=CPU)
        host_v, host_o = jax_opexec.topk_flat(codes, vals, k, largest, 9,
                                              mask=mask)
        np.testing.assert_array_equal(got_o, host_o)
        assert got_v.dtype == host_v.dtype
        assert got_v.tobytes() == host_v.tobytes()
        if kind != "uint64":  # jnp has no uint64 sort without x64 bits
            dev_v, dev_o = jax_relops.topk_partials(codes, vals, k, largest,
                                                    9, mask=mask)
            np.testing.assert_array_equal(got_o, dev_o)
            np.testing.assert_array_equal(got_v, dev_v)


def test_topk_datetime_sentinel_ties_and_empty_groups():
    nat = np.iinfo(np.int64).min
    codes = np.array([0, 0, 0, 0, 0, 0, 2, 2], dtype=np.int64)
    vals = np.array([5, 5, 5, 5, 1, nat, nat, 3], dtype=np.int64)
    for largest in (True, False):
        got = relops.topk_partials(codes, vals, 3, largest, 4,
                                   sentinel=nat, device=CPU)
        want = jax_opexec.topk_flat(codes, vals, 3, largest, 4,
                                    sentinel=nat)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got_v, got_o = relops.topk_partials(codes, vals, 3, True, 4,
                                        sentinel=nat, device=CPU)
    assert got_v.tolist() == [5, 5, 5, 3] and got_o.tolist() == [0, 3, 3, 4, 4]
    # zeros of both signs tie, as NumPy's sort holds them
    z = np.array([0.0, -0.0, 0.0, -0.0, 1.0])
    zc = np.zeros(5, dtype=np.int64)
    for largest in (True, False):
        got_v, _ = relops.topk_partials(zc, z, 3, largest, 1, device=CPU)
        want_v, _ = jax_opexec.topk_flat(zc, z, 3, largest, 1)
        assert got_v.tobytes() == want_v.tobytes()


def test_sketch_keys_bit_identical_to_reference_twins():
    from bqueryd_tpu.ops import relops as jax_relops

    rng = np.random.default_rng(5)
    drawn = np.concatenate([rng.random(20000) * 1e9 - 5e8,
                            rng.random(2000) * 30])
    for alpha in (ALPHA, 0.05):
        gamma = jax_opexec.sketch_layout(alpha)[0]
        edges = np.power(gamma, np.arange(-50, 50, dtype=np.float64))
        values = np.concatenate([
            drawn, edges, -edges, np.nextafter(edges, 0),
            np.nextafter(edges, np.inf),
            [0.0, -0.0, 1e-13, -1e-13, 1e-12, 1e15, 1e18, -1e18, 1.0, -1.0],
        ])
        got = relops.sketch_bin(values, alpha, CPU)
        np.testing.assert_array_equal(
            got, jax_opexec.sketch_keys_host(values, alpha))
        np.testing.assert_array_equal(
            got, opexec.sketch_keys_host(values, alpha))
        # the JAX device twin's log may sit an ulp off NumPy's at a bucket
        # edge: it is held on the drawn values, as its own test holds it
        np.testing.assert_array_equal(
            got[:len(drawn)], jax_relops.sketch_bin(drawn, alpha))


def test_gather_positions_exact():
    from bqueryd_tpu.ops import relops as jax_relops

    rng = np.random.default_rng(3)
    codes = rng.integers(-1, 64, 5000).astype(np.int64)
    pos = rng.integers(-1, 50, 64)
    got = relops.gather_positions(pos, codes, CPU)
    np.testing.assert_array_equal(
        got, np.where(codes >= 0, pos[np.maximum(codes, 0)], -1))
    np.testing.assert_array_equal(got, jax_relops.gather_positions(pos,
                                                                    codes))


@pytest.mark.parametrize("largest", [True, False])
def test_topk_merge_matches_reference(shards, largest):
    """Sharded top-k partials merged by k-way re-select equal the one-shot
    selection, in the port and in the JAX package."""
    frames, _paths = shards
    df = pd.concat(frames, ignore_index=True)
    single = opexec.topk_flat(df["g"].to_numpy(), df["v_int"].to_numpy(), 4,
                              largest, 6)
    parts = []
    for f in frames:
        v, o = relops.topk_partials(f["g"].to_numpy(), f["v_int"].to_numpy(),
                                    4, largest, 6, device=CPU)
        parts.append((np.arange(6), v, o))
    merged = opexec.merge_topk_parts(parts, 4, largest, 6)
    want = jax_opexec.merge_topk_parts(parts, 4, largest, 6)
    for a, b, c in zip(merged, want, single):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("values", [
    [1.0, np.nan, 3.0, np.nan, np.nan],
    [-100.0, -1.0, 0.0, 0.0, 1.0, 100.0, 1e18],
    [np.nan, np.nan, np.nan, np.nan, np.nan],
    [1e-300, -1e-300, 5e-13, 2e-12, 1e300],
])
def test_sketches_and_quantiles_match_reference(values):
    """NaN, all-NaN, negative, zero and extreme values: the port's device
    keys, flat sketches and estimates against the JAX package's."""
    vals = np.asarray(values, dtype=np.float64)
    codes = np.array([0, 0, 0, 1, 1, 1, 1][:len(vals)], dtype=np.int64)
    keys = relops.sketch_bin(vals, ALPHA, CPU)
    got = opexec.sketch_flat(codes, vals, 2, alpha=ALPHA, keys=keys)
    want = jax_opexec.sketch_flat(codes, vals, 2, alpha=ALPHA)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for q in (0.01, 0.5, 0.999):
        np.testing.assert_array_equal(
            opexec.sketch_quantiles(*got, q, ALPHA),
            jax_opexec.sketch_quantiles(*want, q, ALPHA))
    parts = [(np.arange(2), *got), (np.array([1, 0]), *got)]
    for g, w in zip(opexec.merge_sketch_parts(parts, 2),
                    jax_opexec.merge_sketch_parts(parts, 2)):
        np.testing.assert_array_equal(g, w)


# -- parallel.opexec.DagExecutor ----------------------------------------------

def _shape_specs():
    dim = _dim()
    join = {"table": dim, "on": "cust", "select": ["region", "weight"]}
    out = {
        "join": {"groupby": ["region"],
                 "aggs": [["v_int", "sum", "s"], ["v_float", "mean", "m"],
                          ["weight", "sum", "w"]], "join": join},
        "join_absent_keys": {"groupby": ["region"],
                             "aggs": [["v_int", "count", "n"]],
                             "join": {**join, "select": ["region"]}},
        "join_post_filter": {"groupby": ["g"], "aggs": [["v_int", "sum", "s"]],
                             "where": [["sel", ">", 0.5],
                                       ["region", "in", ["r0", "r2"]]],
                             "join": {**join, "select": ["region"]}},
        "topk_datetime": {"groupby": ["g"],
                          "aggs": [["t", "topk", "latest", {"k": 2}]]},
        "topk_string_key": {"groupby": ["k_str"],
                            "aggs": [["v_big", "topk", "t", {"k": 1}],
                                     ["v_int", "min", "lo"]]},
        "window_1h": {"groupby": [{"window": {"on": "t", "every": "1h",
                                             "alias": "hh"}}],
                      "aggs": [["v_int", "sum", "s"], ["v_int", "count", "n"]]},
        "window_key_30m": {"groupby": ["g", {"window": {"on": "t",
                                                       "every": "30m",
                                                       "alias": "hw"}}],
                           "aggs": [["v_int", "sum", "s"]]},
        "window_day_seconds": {"groupby": [{"window": {"on": "t",
                                                       "every": 86400}}],
                               "aggs": [["v_float", "max", "mx"]]},
        "combined": {"groupby": ["region", {"window": {"on": "t",
                                                       "every": "4h",
                                                       "alias": "w4"}}],
                     "aggs": [["v_int", "sum", "s"],
                              ["v_int", "topk", "top2", {"k": 2}],
                              ["v_float", "quantile", "med",
                               {"q": 0.5, "alpha": ALPHA}]],
                     "where": [["sel", ">", 0.3]],
                     "join": {"table": dim, "on": "cust",
                              "select": ["region"]}},
        "distinct": {"groupby": ["g"],
                     "aggs": [["cust", "count_distinct", "d"]]},
        # a composite key space past 2^16 groups: the tuples factorize
        "wide_keys": {"groupby": ["cust", "v_big"],
                      "aggs": [["v_float", "sum", "s"],
                               ["v_int", "topk", "t", {"k": 1}]]},
        "two_keys_packed": {"groupby": ["k_str", "g"],
                            "aggs": [["v_int", "max", "mx"]],
                            "where": [["v_float", ">", 0.0]]},
    }
    for col, k in (("v_int", 3), ("v_float", 5), ("v_big", 1)):
        for largest in (True, False):
            out[f"topk_{col}_{k}_{largest}"] = {
                "groupby": ["g"],
                "aggs": [[col, "topk", "tk", {"k": k, "largest": largest}]]}
    for q in (0.1, 0.5, 0.9, 0.99):
        out[f"quantile_{q}"] = {
            "groupby": ["g"],
            "aggs": [["v_float", "quantile", "qq", {"q": q, "alpha": ALPHA}]]}
    return out


def _same_payload(got, want):
    assert got["kind"] == want["kind"]
    if got["kind"] == "empty":
        return
    assert got["key_cols"] == want["key_cols"]
    assert got["ops"] == want["ops"] and got["out_cols"] == want["out_cols"]
    assert got["value_kinds"] == want["value_kinds"]
    for col in want["keys"]:
        np.testing.assert_array_equal(got["keys"][col], want["keys"][col])
    np.testing.assert_array_equal(got["rows"], want["rows"])
    for g, w in zip(got["aggs"], want["aggs"]):
        assert set(g) == set(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if b.dtype.kind == "f" and name not in ("topk_values",):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", sorted(_shape_specs()))
def test_dag_executor_payloads_match_reference(shards, shape):
    _frames, paths = shards
    spec = dict(_shape_specs()[shape], table=["x"])
    dag, ref = dagmod.compile_query(spec), jax_dag.compile_query(spec)
    port = opexec.DagExecutor(QueryEngine(device=CPU))
    jax = jax_opexec.DagExecutor(JaxEngine())
    got_all, want_all = [], []
    for p in paths:
        got = port.execute_shard(ctable(p, mode="r"), dag)
        want = jax.execute_shard(jax_ctable(p, mode="r"), ref)
        _same_payload(got, want)
        got_all.append(got)
        want_all.append(want)
    got_order, got_cols = hostmerge.finalize_table(
        hostmerge.merge_payloads(got_all))
    want_order, want_cols = jax_hostmerge.finalize_table(
        jax_hostmerge.merge_payloads(want_all))
    assert got_order == want_order
    for col in want_order:
        a, b = got_cols[col], want_cols[col]
        if b.dtype == object and len(b) and isinstance(b[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(a, b)


def _run(paths, spec):
    executor = opexec.DagExecutor(QueryEngine(device=CPU))
    dag = dagmod.compile_query(dict(spec, table=["x"]))
    payloads = [executor.execute_shard(ctable(p, mode="r"), dag)
                for p in paths]
    merged = hostmerge.merge_payloads(payloads)
    return hostmerge.payload_to_dataframe(merged)


def test_join_window_topk_quantile_against_pandas(shards):
    frames, paths = shards
    got = _run(paths, _shape_specs()["combined"])
    df = _pandas_side(frames, dim=_dim(), window=("t", "4h", "w4"),
                      where=[("sel", ">", 0.3)]).dropna(subset=["w4"])
    gb = df.groupby(["region", "w4"])
    exp_s = gb["v_int"].sum()
    exp_k = gb["v_int"].apply(lambda s: np.sort(s.to_numpy())[::-1][:2])
    exp_q = gb["v_float"].quantile(0.5, interpolation="lower")
    assert len(got) == len(exp_s)
    for i in range(len(got)):
        key = (got["region"][i], pd.Timestamp(got["w4"][i]))
        assert int(got["s"][i]) == int(exp_s.loc[key])
        np.testing.assert_array_equal(np.asarray(got["top2"][i]),
                                      exp_k.loc[key])
        e = float(exp_q.loc[key])
        assert abs(float(got["med"][i]) - e) <= abs(e) * ALPHA + 1e-9


def test_window_across_shard_edges(tmp_path):
    base = pd.Timestamp("2020-01-01 00:59:59")
    frames = [
        pd.DataFrame({"t": [base, base + pd.Timedelta(seconds=2)],
                      "v": np.array([10, 20], dtype=np.int64)}),
        pd.DataFrame({"t": [base + pd.Timedelta(seconds=1),
                            base + pd.Timedelta(hours=2)],
                      "v": np.array([100, 7], dtype=np.int64)}),
    ]
    paths = []
    for i, df in enumerate(frames):
        p = str(tmp_path / f"w{i}.bcolzs")
        ctable.fromdataframe(df, p)
        paths.append(p)
    got = _run(paths, {
        "groupby": [{"window": {"on": "t", "every": "1h", "alias": "hh"}}],
        "aggs": [["v", "sum", "s"]],
    }).sort_values("hh").reset_index(drop=True)
    assert got["s"].tolist() == [10, 120, 7]


def test_string_measures_are_rejected(shards):
    _frames, paths = shards
    for op, params in (("quantile", {"q": 0.5}), ("topk", {"k": 2})):
        with pytest.raises(dagmod.DagValidationError, match="numeric"):
            _run(paths[:1], {"groupby": ["g"],
                             "aggs": [["k_str", op, "x", params]]})


# -- the port cluster ---------------------------------------------------------

@contextmanager
def _cluster(url, data_dir):
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=data_dir, heartbeat_interval=0.2)
    worker = WorkerNode(coordination_url=url, data_dir=data_dir,
                        loglevel=QUIET, heartbeat_interval=0.2,
                        poll_timeout=0.05, device=CPU)
    nodes = [controller, worker]
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    try:
        wait_until(lambda: len(controller.files_map) >= 2,
                   desc="port worker registration")
        rpc = RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
                  loglevel=QUIET)
        try:
            yield {"rpc": rpc, "controller": controller, "worker": worker}
        finally:
            rpc._close_socket()
    finally:
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads), "a node did not stop"


@pytest.fixture(scope="module")
def op_cluster(tmp_path_factory):
    """A port cluster over two shards of ``tests/test_operators.py``'s
    second dataset; the nodes advertise 127.0.0.1."""
    root = tmp_path_factory.mktemp("torch_op_cluster")
    frames = _dataset(seed=99)[:2]
    for i, df in enumerate(frames):
        ctable.fromdataframe(df, str(root / f"e2e_{i}.bcolzs"))
    url = f"file://{root / 'store'}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        with _cluster(url, str(root)) as cluster:
            yield dict(cluster, frames=frames, url=url,
                       shards=[f"e2e_{i}.bcolzs" for i in range(2)])


def _frame(result):
    order, columns = result
    return pd.DataFrame({c: columns[c] for c in order}, columns=order)


def test_rpc_query_end_to_end(op_cluster):
    rpc = op_cluster["rpc"]
    dim = _dim()
    df = _frame(rpc.query({
        "table": op_cluster["shards"], "groupby": ["region"],
        "aggs": [["v_int", "sum", "s"], ["v_int", "topk", "t2", {"k": 2}],
                 ["v_float", "quantile", "p90", {"q": 0.9, "alpha": ALPHA}]],
        "join": {"table": dim, "on": "cust", "select": ["region"]},
    }))
    full = pd.concat(op_cluster["frames"]).merge(pd.DataFrame(dim), on="cust")
    gb = full.groupby("region")
    assert dict(zip(df["region"], df["s"])) == gb["v_int"].sum().to_dict()
    exp_k = gb["v_int"].apply(lambda s: sorted(s, reverse=True)[:2])
    exp_q = gb["v_float"].quantile(0.9, interpolation="lower")
    for i, r in enumerate(df["region"]):
        assert list(df["t2"][i]) == exp_k[r]
        e = float(exp_q[r])
        assert abs(float(df["p90"][i]) - e) <= abs(e) * ALPHA + 1e-9
    # top-k and sketch parts merge by part kind: one message for the shard
    # group, merged on the device by the fast path
    assert list(rpc.last_call_merge_modes.values()) == ["device"]


def test_rpc_query_window_end_to_end(op_cluster):
    rpc = op_cluster["rpc"]
    df = _frame(rpc.query({
        "table": op_cluster["shards"],
        "groupby": [{"window": {"on": "t", "every": "1d", "alias": "day"}}],
        "aggs": [["v_int", "sum", "s"]],
    }))
    full = pd.concat(op_cluster["frames"], ignore_index=True)
    full = full.dropna(subset=["t"])
    exp = full.groupby(full["t"].dt.floor("1D"))["v_int"].sum()
    assert dict(zip(pd.to_datetime(df["day"]), df["s"])) == exp.to_dict()


def test_rpc_query_count_distinct_goes_per_shard(op_cluster):
    rpc = op_cluster["rpc"]
    df = _frame(rpc.query({
        "table": op_cluster["shards"],
        "groupby": [{"window": {"on": "t", "every": "1d", "alias": "day"}}],
        "aggs": [["cust", "count_distinct", "d"]],
    }))
    full = pd.concat(op_cluster["frames"], ignore_index=True)
    full = full.dropna(subset=["t"])
    exp = full.groupby(full["t"].dt.floor("1D"))["cust"].nunique()
    assert dict(zip(pd.to_datetime(df["day"]), df["d"])) == exp.to_dict()
    assert list(rpc.last_call_merge_modes.values()) == ["none", "none"]


def test_rpc_query_spec_rejected_structured(op_cluster):
    from bqueryd_tpu_torch.rpc import RPCError

    rpc = op_cluster["rpc"]
    with pytest.raises(dagmod.DagValidationError):
        rpc.query({"table": op_cluster["shards"], "groupby": ["g"],
                   "aggs": [["v_int", "median", "m"]]})
    # the controller validates again: a spec sent past the client check
    with pytest.raises(RPCError) as err:
        rpc._rpc("query", ({"table": op_cluster["shards"], "groupby": ["g"],
                            "aggs": [["v_int", "topk", "t", {"k": 0}]]},),
                 {})
    assert err.value.error_class == "UnsupportedOp"
    with pytest.raises(RPCError) as err:
        rpc.groupby(op_cluster["shards"], ["g"], [["v_int", "median", "m"]],
                    [])
    assert err.value.error_class == "UnsupportedOp"
    assert "rpc.query" in str(err.value)
    with pytest.raises(RPCError, match="not found"):
        rpc.query({"table": ["nope.bcolzs"], "groupby": ["g"],
                   "aggs": [["v_int", "sum", "s"]]})


def test_rpc_query_result_cache_hit(op_cluster):
    """An identical repeated DAG query is served from the worker's result
    cache (keyed by the DAG signature): route "cached", no kernel."""
    from bqueryd_tpu_torch.ops import onehot

    rpc = op_cluster["rpc"]
    spec = {"table": op_cluster["shards"], "groupby": ["g"],
            "aggs": [["v_int", "topk", "t", {"k": 3}],
                     ["v_int", "max", "mx"]]}
    a = _frame(rpc.query(spec))
    assert set(rpc.last_call_strategies["effective"].values()) != {"cached"}
    hits = op_cluster["worker"].result_cache.hits
    before = sum(onehot.LAUNCHES.values())
    b = _frame(rpc.query(spec))
    assert sum(onehot.LAUNCHES.values()) == before
    assert op_cluster["worker"].result_cache.hits == hits + 1
    assert list(rpc.last_call_strategies["effective"].values()) == ["cached"]
    for x, y in zip(a["t"], b["t"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["mx"], b["mx"])


def test_plain_query_is_bit_identical_to_groupby(op_cluster, monkeypatch):
    """A plain spec through ``RPC.query`` takes the groupby path (the
    executor, one device merge) and gives the very result of
    ``RPC.groupby``."""
    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
    # the groupby carries the controller's hint and the DAG none: with
    # calibration off the hint is the heuristic's advisory "matmul", the
    # route the executor picks by itself, so both take one route
    monkeypatch.setenv("BQUERYD_TPU_CALIB", "0")
    op_cluster["worker"]._result_cache = None
    rpc = op_cluster["rpc"]
    aggs = [["v_int", "sum", "s"], ["v_float", "mean", "m"],
            ["v_big", "min", "lo"]]
    where = [["sel", ">", 0.25]]
    try:
        order, got = rpc.query({"table": op_cluster["shards"],
                                "groupby": ["k_str", "g"], "aggs": aggs,
                                "where": where})
        assert list(rpc.last_call_merge_modes.values()) == ["device"]
        route = rpc.last_call_strategies["effective"]
        want_order, want = rpc.groupby(op_cluster["shards"], ["k_str", "g"],
                                       aggs, where)
        assert rpc.last_call_strategies["effective"] == route
    finally:
        op_cluster["worker"]._result_cache = None
    assert order == want_order
    for col in order:
        assert got[col].dtype == want[col].dtype
        if got[col].dtype == object:
            assert list(got[col]) == list(want[col])
        else:
            assert got[col].tobytes() == want[col].tobytes()


def test_reference_client_reads_port_dag_replies(op_cluster):
    """The JAX package's ``RPC``, finding the port controller through the
    file:// store, merges the port worker's DAG payloads (top-k and sketch
    parts) into the answer the port client gives."""
    from bqueryd_tpu.rpc import RPC as RefRPC

    spec = {"table": op_cluster["shards"], "groupby": ["g"],
            "aggs": [["v_float", "topk", "t", {"k": 2, "largest": False}],
                     ["v_float", "quantile", "p50", {"q": 0.5}],
                     ["v_int", "sum", "s"]]}
    client = RefRPC(coordination_url=op_cluster["url"], timeout=RPC_TIMEOUT,
                    retries=1, loglevel=QUIET)
    try:
        got = client.query(spec).sort_values("g").reset_index(drop=True)
    finally:
        client._close_socket()
    want = _frame(op_cluster["rpc"].query(spec))
    want = want.sort_values("g").reset_index(drop=True)
    np.testing.assert_array_equal(got["s"], want["s"])
    np.testing.assert_array_equal(got["p50"], want["p50"])
    for x, y in zip(got["t"], want["t"]):
        np.testing.assert_array_equal(x, y)


def test_worker_device_error_propagates(op_cluster, monkeypatch):
    """A device failure inside the DAG pipeline (the fast path's dense
    top-k or the per-shard top-k) reaches the client as the worker's error;
    nothing reruns it elsewhere."""
    from bqueryd_tpu_torch.rpc import RPCError

    def failing(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(relops, "topk_partials", failing)
    monkeypatch.setattr(relops, "topk_dense_emit", failing)
    with pytest.raises(RPCError, match="illegal memory access"):
        op_cluster["rpc"].query({
            "table": op_cluster["shards"], "groupby": ["g"],
            "aggs": [["v_int", "topk", "t", {"k": 4}]]})


def test_sole_and_batched_dag_dispatch(op_cluster, monkeypatch):
    """Extended DAGs batch per shard group unless BQUERYD_TPU_DAG_BATCH=0,
    which sends one message per shard; both answer alike (group by group:
    the device merge orders groups by key, the client's merge by first
    appearance)."""
    spec = {"table": op_cluster["shards"], "groupby": ["g"],
            "aggs": [["v_int", "topk", "t", {"k": 5}]]}
    rpc = op_cluster["rpc"]
    a = _frame(rpc.query(spec)).sort_values("g").reset_index(drop=True)
    assert len(rpc.last_call_merge_modes) == 1
    monkeypatch.setenv("BQUERYD_TPU_DAG_BATCH", "0")
    b = _frame(rpc.query(spec)).sort_values("g").reset_index(drop=True)
    assert list(rpc.last_call_merge_modes.values()) == ["none", "none"]
    assert a["g"].tolist() == b["g"].tolist()
    for x, y in zip(a["t"], b["t"]):
        np.testing.assert_array_equal(x, y)

"""The port's DAG fast path against the JAX package's.

``MeshQueryExecutor.execute_dag`` runs an extended operator DAG (joins,
top-k, quantile sketches, windows) over a whole shard group: one decode,
alignment and upload pass and one device program.  Every case of
``tests/test_dag_fastpath.py`` is held here three ways, on the shards that
file's ``_dataset`` builds (written by the JAX package's ctable):

* against the JAX ``MeshQueryExecutor.execute_dag`` on the 8 virtual CPU
  devices of ``tests/conftest.py``, payload for payload;
* against the port's own per-shard route (``DagExecutor`` and the host
  merge, what ``BQUERYD_TPU_DAG_BATCH=0`` restores);
* against pandas.

Tolerances: keys, row counts, ints, top-k lists and sketch buckets (so the
quantile estimates) bit-equal; float sums and means within
``tests/test_differential_fuzz.py:_compare``'s rtol 2e-5, atol 1e-6.  The
port runs on the CPU (``device="cpu"``).
"""

import logging
import threading
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest
import torch

from bqueryd_tpu.parallel import opexec as jax_opexec
from bqueryd_tpu.parallel.executor import (
    DagFastPathUnsupported as JaxUnsupported,
)
from bqueryd_tpu.parallel.executor import MeshQueryExecutor as JaxExecutor
from bqueryd_tpu.plan import dag as jax_dag
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import messages
from bqueryd_tpu_torch.models.query import QueryEngine
from bqueryd_tpu_torch.ops import relops
from bqueryd_tpu_torch.parallel import executor as executor_mod
from bqueryd_tpu_torch.parallel import hostmerge, opexec
from bqueryd_tpu_torch.parallel.executor import (
    DagFastPathUnsupported,
    MeshQueryExecutor,
)
from bqueryd_tpu_torch.plan import dag as dagmod
from bqueryd_tpu_torch.storage.ctable import ctable
from tests.conftest import wait_until
from test_dag_fastpath import ALPHA, _dataset, _dim
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6
CPU = "cpu"
QUIET = logging.WARNING
RPC_TIMEOUT = 30


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """``tests/test_dag_fastpath.py``'s three shards: ``(frames, paths)``."""
    root = tmp_path_factory.mktemp("torch_dagfast")
    frames = _dataset()
    paths = []
    for i, df in enumerate(frames):
        p = str(root / f"fp_{i}.bcolzs")
        jax_ctable.fromdataframe(df, p)
        paths.append(p)
    return frames, paths


def _spec(**kw):
    return dict(kw, table=["x"])


def _port_fast(paths, spec, mex=None):
    mex = mex or MeshQueryExecutor(device=CPU)
    return dict(mex.execute_dag([ctable(p, mode="r") for p in paths],
                                dagmod.compile_query(spec)))


def _jax_fast(paths, spec):
    return dict(JaxExecutor().execute_dag(
        [jax_ctable(p, mode="r") for p in paths], jax_dag.compile_query(spec)
    ))


def _port_slow(paths, spec):
    """The per-shard route (what ``BQUERYD_TPU_DAG_BATCH=0`` restores)."""
    executor = opexec.DagExecutor(QueryEngine(device=CPU))
    dag = dagmod.compile_query(spec)
    return hostmerge.merge_payloads(
        [executor.execute_shard(ctable(p, mode="r"), dag) for p in paths])


def _same_payload(got, want):
    """Payload for payload: keys, rows, ints, top-k lists and sketch parts
    bit-equal (dtypes too), floats within rtol 2e-5, atol 1e-6."""
    assert got["kind"] == want["kind"]
    if got["kind"] == "empty":
        return
    assert list(got["key_cols"]) == list(want["key_cols"])
    assert list(got["ops"]) == list(want["ops"])
    assert list(got["out_cols"]) == list(want["out_cols"])
    assert list(got["value_kinds"]) == list(want["value_kinds"])
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


def _frames(payload_a, payload_b, sort_cols):
    a = hostmerge.payload_to_dataframe(payload_a)
    b = hostmerge.payload_to_dataframe(payload_b)
    return (a.sort_values(sort_cols).reset_index(drop=True),
            b.sort_values(sort_cols).reset_index(drop=True))


def _same_frame(a, b, ints=(), floats=(), lists=(), exact=()):
    assert len(a) == len(b) and len(a) > 0
    for col in ints:
        assert a[col].tolist() == b[col].tolist(), col
    for col in floats:
        np.testing.assert_allclose(a[col].to_numpy(), b[col].to_numpy(),
                                   rtol=RTOL, atol=ATOL)
    for col in lists:
        for x, y in zip(a[col], b[col]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, col
            np.testing.assert_array_equal(x, y)
    for col in exact:
        np.testing.assert_array_equal(a[col].to_numpy(), b[col].to_numpy())


def _hold(paths, spec, sort_cols, **frame_cols):
    """The port's fast path against the JAX fast path (payloads) and the
    port's per-shard route (finalized frames); returns the fast path's
    finalized frame."""
    mex = MeshQueryExecutor(device=CPU)
    fast = _port_fast(paths, spec, mex)
    assert mex.last_merge_mode == "device"
    _same_payload(fast, _jax_fast(paths, spec))
    a, b = _frames(fast, _port_slow(paths, spec), sort_cols)
    _same_frame(a, b, **frame_cols)
    return a


def _pandas(frames, dim=None, window=None, where=()):
    df = pd.concat(frames, ignore_index=True)
    if dim is not None:
        df = df.merge(pd.DataFrame(dim), on="cust", how="inner")
    if window is not None:
        col, every, alias = window
        df = df.copy()
        df[alias] = df[col].dt.floor(every)
    ops = {">": np.greater, "<=": np.less_equal, ">=": np.greater_equal}
    for col, op, val in where:
        df = df[ops[op](df[col], val)]
    return df


def _lower_q(s, q):
    return float(np.quantile(s.dropna().to_numpy(), q, method="lower"))


def _topk_of(s, k, largest):
    v = np.sort(s.dropna().to_numpy())
    return v[::-1][:k] if largest else v[:k]


# -- merge parity ------------------------------------------------------------

def test_mixed_classic_and_extended_with_join_and_window(shards):
    """Join + window + pushdown + post filter + classic + top-k + sketch in
    one query."""
    frames, paths = shards
    spec = _spec(
        groupby=["g", {"window": {"on": "t", "every": "1h", "alias": "hr"}}],
        aggs=[["v_int", "sum", "s"], ["v_int", "min", "mn"],
              ["v_float", "mean", "m"], ["weight", "max", "wmax"],
              ["v_int", "topk", "t3", {"k": 3}],
              ["v_float", "quantile", "p50", {"q": 0.5, "alpha": ALPHA}]],
        where=[["v_int", ">", -7], ["weight", "<=", 5]],
        join={"table": _dim(), "on": "cust", "select": ["region", "weight"]},
    )
    got = _hold(paths, spec, ["g", "hr"], ints=("g", "s", "mn", "wmax"),
                floats=("m",), lists=("t3",), exact=("hr", "p50"))
    df = _pandas(frames, dim=_dim(), window=("t", "1h", "hr"),
                 where=[("v_int", ">", -7), ("weight", "<=", 5)])
    gb = df.groupby(["g", "hr"])
    assert len(got) == gb.ngroups
    for i in range(len(got)):
        key = (got["g"][i], pd.Timestamp(got["hr"][i]))
        part = df[(df["g"] == key[0]) & (df["hr"] == key[1])]
        assert int(got["s"][i]) == int(part["v_int"].sum())
        assert int(got["mn"][i]) == int(part["v_int"].min())
        assert int(got["wmax"][i]) == int(part["weight"].max())
        np.testing.assert_allclose(got["m"][i], part["v_float"].mean(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(np.asarray(got["t3"][i]),
                                      _topk_of(part["v_int"], 3, True))
        if part["v_float"].notna().any():
            e = _lower_q(part["v_float"], 0.5)
            assert abs(float(got["p50"][i]) - e) <= abs(e) * ALPHA + 1e-9


@pytest.mark.parametrize("col,largest", [
    ("v_int", True),      # heavy ties: multiset semantics
    ("v_int", False),
    ("v_big", True),
    ("v_float", False),   # NaN skipping + the float key
    ("t", True),          # datetime: NaT sentinel on int64
])
def test_topk_parity_matrix(shards, col, largest):
    frames, paths = shards
    spec = _spec(groupby=["g"],
                 aggs=[[col, "topk", "tk", {"k": 5, "largest": largest}]])
    got = _hold(paths, spec, ["g"], ints=("g",), lists=("tk",))
    df = pd.concat(frames, ignore_index=True)
    for g, tk in zip(got["g"], got["tk"]):
        s = df.loc[df["g"] == g, col]
        want = _topk_of(s, 5, largest)
        if col == "t":
            want = want.astype("datetime64[ns]")
        np.testing.assert_array_equal(np.asarray(tk), want)


def test_sketch_buckets_bit_equal_including_clamps(shards):
    """The fetched grid converts to exactly the flat sketch part of the
    per-shard route and of the JAX fast path: the zero bucket, negative
    keys and both clamp edges included, so the estimates are bit-equal."""
    frames, paths = shards
    spec = _spec(groupby=["g"],
                 aggs=[["v_ext", "quantile", "q1", {"q": 0.1, "alpha": 0.02}],
                       ["v_ext", "quantile", "q9",
                        {"q": 0.9, "alpha": 0.02}]])
    fast, slow = _port_fast(paths, spec), _port_slow(paths, spec)
    _same_payload(fast, _jax_fast(paths, spec))
    fo, so = (np.argsort(np.asarray(p["keys"]["g"])) for p in (fast, slow))
    for ai in range(2):
        fa, sa = fast["aggs"][ai], slow["aggs"][ai]
        f_off, s_off = fa["sketch_offsets"], sa["sketch_offsets"]
        for gf, gs in zip(fo, so):
            for part in ("sketch_keys", "sketch_counts"):
                np.testing.assert_array_equal(
                    fa[part][f_off[gf]:f_off[gf + 1]],
                    sa[part][s_off[gs]:s_off[gs + 1]])
    a, b = _frames(fast, slow, ["g"])
    _same_frame(a, b, ints=("g",), exact=("q1", "q9"))
    df = pd.concat(frames, ignore_index=True)
    for g, q1, q9 in zip(a["g"], a["q1"], a["q9"]):
        s = df.loc[df["g"] == g, "v_ext"]
        for got, q in ((q1, 0.1), (q9, 0.9)):
            e = _lower_q(s, q)
            # inside the clamped magnitudes the estimate is within alpha
            if e == 0.0 or 1e-12 <= abs(e) <= 1e15:
                assert abs(got - e) <= abs(e) * 0.02 + 1e-12, (g, q, got, e)


def test_uint64_and_string_keys_parity(shards):
    frames, paths = shards
    spec = _spec(groupby=["k_str"],
                 aggs=[["u64", "sum", "us"], ["u64", "max", "umax"],
                       ["v_int", "topk", "tk", {"k": 2}]])
    got = _hold(paths, spec, ["k_str"], ints=("k_str", "us", "umax"),
                lists=("tk",))
    assert got["us"].dtype == np.uint64  # the mod-2^64 unsigned view
    df = pd.concat(frames, ignore_index=True)
    for i, key in enumerate(got["k_str"]):
        part = df[df["k_str"] == key]
        want_sum = np.add.reduce(part["u64"].to_numpy(), dtype=np.uint64)
        assert got["us"][i] == want_sum
        assert got["umax"][i] == part["u64"].max()
        np.testing.assert_array_equal(np.asarray(got["tk"][i]),
                                      _topk_of(part["v_int"], 2, True))


def test_topk_emission_routes_agree_directly():
    """The three dense emissions (matrix, k-pass, sort) give the flat
    partials of the NumPy host twin, of the JAX package's and of the JAX
    emissions on the same inputs, bit for bit."""
    import jax
    import jax.numpy as jnp

    from bqueryd_tpu.ops import relops as jax_relops

    rng = np.random.default_rng(9)
    n, groups, k = 3000, 7, 4
    codes = rng.integers(-1, groups, n)
    for vals, drop_nan, float_neg in (
        (rng.integers(-5, 5, n).astype(np.int64), False, False),
        (np.where(rng.random(n) < 0.1, np.nan, rng.random(n)), True, True),
    ):
        c, v = torch.from_numpy(codes), torch.from_numpy(vals)
        for largest in (True, False):
            expected = jax_opexec.topk_flat(codes, vals, k, largest, groups)
            np.testing.assert_array_equal(
                expected[0],
                opexec.topk_flat(codes, vals, k, largest, groups)[0])
            for emit, jax_emit in (
                (relops.topk_matrix_block, jax_relops.topk_matrix_block),
                (relops.topk_kpass_block, jax_relops.topk_kpass_block),
            ):
                dense, cnt = emit(c, v, None, k, largest, groups, drop_nan,
                                  None)
                got = opexec.dense_topk_to_flat(dense.numpy(), cnt.numpy())
                jd, jc = jax.device_get(jax_emit(
                    jnp.asarray(codes), jnp.asarray(vals), None, k, largest,
                    groups, drop_nan, None))
                ref = jax_opexec.dense_topk_to_flat(np.asarray(jd),
                                                    np.asarray(jc))
                for g_, e_, r_ in zip(got, expected, ref):
                    np.testing.assert_array_equal(g_, e_)
                    np.testing.assert_array_equal(g_, r_)
            dense, cnt = relops.topk_dense_block(
                c, v, None, k, largest, groups, drop_nan, None, float_neg)
            got = opexec.dense_topk_to_flat(dense.numpy(), cnt.numpy())
            for g_, e_ in zip(got, expected):
                np.testing.assert_array_equal(g_, e_)


@pytest.mark.parametrize("kind", ["int8", "uint16", "uint64", "float32",
                                  "bool", "extremes", "inf"])
def test_topk_emission_routes_agree_on_every_dtype(kind):
    """The three routes over the dtypes a measure block can hold: each
    value's bijective key (float widening and negation, int bitwise-not,
    uint64's sign-bit flip) inverts exactly, the int64 and float
    extremes that equal the masked fill included."""
    rng = np.random.default_rng(4)
    n, groups = 2000, 5
    i64 = np.iinfo(np.int64)
    vals = {
        "int8": rng.integers(-128, 127, n).astype(np.int8),
        "uint16": rng.integers(0, 60000, n).astype(np.uint16),
        "uint64": rng.integers(0, 2**63, n).astype(np.uint64)
        * np.uint64(2),
        "float32": (rng.random(n) * 10).astype(np.float32),
        "bool": rng.random(n) < 0.5,
        "extremes": np.tile(np.array([i64.min, i64.max, 0]), n)[:n],
        "inf": np.where(rng.random(n) < 0.3, -np.inf,
                        np.where(rng.random(n) < 0.3, np.inf,
                                 rng.random(n))),
    }[kind]
    codes = rng.integers(-1, groups, n)
    mask = rng.random(n) < 0.8
    is_float = vals.dtype.kind == "f"
    c, v, m = (torch.from_numpy(a) for a in (codes, vals, mask))
    for largest in (True, False):
        for k in (1, 3, 40):
            want = opexec.topk_flat(codes, vals, k, largest, groups,
                                    mask=mask)
            routes = [relops.topk_dense_block(c, v, m, k, largest, groups,
                                              is_float, None, is_float)]
            if kind != "bool":
                routes += [
                    emit(c, v, m, k, largest, groups, is_float, None)
                    for emit in (relops.topk_matrix_block,
                                 relops.topk_kpass_block)]
            for dense, cnt in routes:
                got = opexec.dense_topk_to_flat(dense.numpy(), cnt.numpy())
                assert got[0].dtype == want[0].dtype
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])


def test_topk_emit_takes_the_reference_route(monkeypatch):
    """``topk_dense_emit`` picks the reference's route from the shape
    alone: the matrix route while ``TOPK_MATRIX_CELLS // groups`` is at
    least 4,096 rows, the k-pass route for k <= ``TOPK_KPASS_MAX_K``, the
    sort route past that and for bool values."""
    from bqueryd_tpu.ops import relops as jax_relops

    assert relops.TOPK_MATRIX_CELLS == jax_relops.TOPK_MATRIX_CELLS
    assert relops.TOPK_KPASS_MAX_K == jax_relops.TOPK_KPASS_MAX_K
    taken = []
    for name in ("topk_matrix_block", "topk_kpass_block",
                 "topk_dense_block"):
        real = getattr(relops, name)

        def spy(*args, _real=real, _name=name):
            taken.append(_name)
            return _real(*args)

        monkeypatch.setattr(relops, name, spy)
    codes = torch.zeros(10, dtype=torch.int64)
    values = torch.arange(10, dtype=torch.int64)
    cells = relops.TOPK_MATRIX_CELLS
    for groups, k, vals, route in (
        (9, 5, values, "topk_matrix_block"),
        (cells // 4096, 5, values, "topk_matrix_block"),
        (cells // 4096 + 1, 5, values, "topk_kpass_block"),
        (cells // 4096 + 1, 32, values, "topk_kpass_block"),
        (cells // 4096 + 1, 33, values, "topk_dense_block"),
        (9, 5, values > 4, "topk_dense_block"),
    ):
        taken.clear()
        relops.topk_dense_emit(codes, vals, None, k, True, groups, False,
                               None, False)
        assert taken == [route], (groups, k)


def test_topk_kpass_and_sort_routes_agree():
    """The k-pass route (k <= TOPK_KPASS_MAX_K) and the sort route (past
    it) against the host twin and the JAX per-shard kernel, k straddling
    the crossover; the per-shard ``topk_partials`` too."""
    from bqueryd_tpu.ops import relops as jax_relops

    rng = np.random.default_rng(3)
    codes = rng.integers(-1, 5, 4000)
    c = torch.from_numpy(codes)
    for vals in (rng.integers(-6, 6, 4000).astype(np.int64),
                 np.where(rng.random(4000) < 0.1, np.nan, rng.random(4000))):
        is_float = vals.dtype.kind == "f"
        v = torch.from_numpy(vals)
        for largest in (True, False):
            for k in (3, relops.TOPK_KPASS_MAX_K + 8):
                host = jax_opexec.topk_flat(codes, vals, k, largest, 5)
                ref = jax_relops.topk_partials(codes, vals, k, largest, 5)
                if k <= relops.TOPK_KPASS_MAX_K:
                    dense, cnt = relops.topk_kpass_block(
                        c, v, None, k, largest, 5, is_float, None)
                else:
                    dense, cnt = relops.topk_dense_block(
                        c, v, None, k, largest, 5, is_float, None, is_float)
                dev = opexec.dense_topk_to_flat(dense.numpy(), cnt.numpy())
                shard = relops.topk_partials(codes, vals, k, largest, 5,
                                             device=CPU)
                for got in (dev, shard):
                    np.testing.assert_array_equal(host[1], got[1])
                    np.testing.assert_array_equal(host[0], got[0])
                    np.testing.assert_array_equal(ref[0], got[0])


def test_sketch_grid_matches_flat_sketches():
    """``sketch_grid_block`` flattened equals ``opexec.sketch_flat`` (the
    per-shard route) and the JAX grid, over values at bucket edges, both
    clamps, zeros of both signs and NaNs; the grid layout is the JAX
    package's."""
    import jax
    import jax.numpy as jnp

    from bqueryd_tpu.ops import relops as jax_relops

    rng = np.random.default_rng(21)
    for alpha in (ALPHA, 0.05):
        assert (opexec.sketch_grid_layout(alpha)
                == jax_opexec.sketch_grid_layout(alpha))
        gamma = opexec.sketch_layout(alpha)[0]
        edges = np.power(gamma, np.arange(-40, 40, dtype=np.float64))
        vals = np.concatenate([
            rng.random(6000) * 1e6 - 5e5, edges, -edges,
            np.nextafter(edges, 0), [0.0, -0.0, np.nan, 1e-14, -1e20, 1e20],
        ])
        codes = rng.integers(-1, 6, len(vals))
        width, kmin = opexec.sketch_grid_layout(alpha)
        _g, lg, imin, imax = opexec.sketch_layout(alpha)
        grid = relops.sketch_grid_block(
            torch.from_numpy(codes), torch.from_numpy(vals), 6, lg, imin,
            imax, kmin, width)
        assert grid.dtype == torch.int64 and grid.shape == (6, width)
        got = opexec.sketch_grid_to_flat(grid.numpy(), kmin)
        for a, b in zip(got, opexec.sketch_flat(codes, vals, 6, alpha=alpha)):
            np.testing.assert_array_equal(a, b)
        # the JAX grid on the values away from bucket edges, where its log
        # may sit an ulp off NumPy's
        drawn = slice(0, 6000)
        jgrid = jax.device_get(jax_relops.sketch_grid_block(
            jnp.asarray(codes[drawn]), jnp.asarray(vals[drawn]), 6, lg, imin,
            imax, kmin, width))
        pgrid = relops.sketch_grid_block(
            torch.from_numpy(codes[drawn]), torch.from_numpy(vals[drawn]), 6,
            lg, imin, imax, kmin, width)
        np.testing.assert_array_equal(pgrid.numpy(), np.asarray(jgrid))


def test_opexec_helpers_match_reference():
    rng = np.random.default_rng(2)
    dense = rng.integers(-9, 9, (6, 4))
    counts = np.array([0, 4, 2, 1, 3, 0])
    for a, b in zip(opexec.dense_topk_to_flat(dense, counts),
                    jax_opexec.dense_topk_to_flat(dense, counts)):
        np.testing.assert_array_equal(a, b)
    grid = rng.integers(0, 3, (5, 11)) * (rng.random((5, 11)) < 0.3)
    for a, b in zip(opexec.sketch_grid_to_flat(grid, -5),
                    jax_opexec.sketch_grid_to_flat(grid, -5)):
        np.testing.assert_array_equal(a, b)
    pos = rng.integers(-1, 4, 50)
    for dim in (np.arange(4) * 3,
                np.array(["2020-01-01", "NaT", "2021-05-05", "1999-12-31"],
                         dtype="datetime64[s]")):
        got = opexec.gathered_dim_values(dim, pos)
        want = jax_opexec.gathered_dim_values(dim, pos)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- the shared decode, alignment and upload pass ------------------------------

def test_different_measures_share_derivations(shards):
    """A second DAG with other aggs over the same derivations (join,
    window, filter, keys) hits the cached alignment and folded codes; one
    with another derivation (another filter) misses them.  A fact measure
    shares the groupby executor's block."""
    from bqueryd_tpu_torch.models.query import GroupByQuery

    _frames_src, paths = shards
    mex = MeshQueryExecutor(device=CPU)
    base = _spec(
        groupby=["g", {"window": {"on": "t", "every": "1h", "alias": "hr"}}],
        where=[["v_int", ">", -7]],
        join={"table": _dim(), "on": "cust", "select": ["region"]},
    )
    _port_fast(paths, {**base, "aggs": [["v_int", "sum", "s"]]}, mex)
    stats = mex.workingset.stats()
    hits = {seg: stats[seg]["hits"] for seg in ("align", "codes")}
    misses = {seg: stats[seg]["misses"] for seg in ("align", "codes")}
    second = {**base, "aggs": [["v_float", "mean", "m"],
                               ["v_float", "quantile", "p9", {"q": 0.9}]]}
    got = _port_fast(paths, second, mex)
    stats = mex.workingset.stats()
    assert stats["align"]["hits"] > hits["align"]
    assert stats["codes"]["hits"] > hits["codes"]
    assert stats["align"]["misses"] == misses["align"]
    assert stats["codes"]["misses"] == misses["codes"]
    _same_payload(got, _jax_fast(paths, second))
    # another pushdown filter: another derivation, no cached codes reused
    third = {**base, "where": [["v_int", ">", -3]],
             "aggs": [["v_int", "sum", "s"]]}
    got = _port_fast(paths, third, mex)
    stats2 = mex.workingset.stats()
    assert stats2["codes"]["misses"] == misses["codes"] + 1
    assert stats2["align"]["misses"] > misses["align"]
    _same_payload(got, _jax_fast(paths, third))
    # the groupby executor reuses the DAG's fact block of v_int
    tables = [ctable(p, mode="r") for p in paths]
    blocks = stats2["blocks"]["hits"]
    mex.execute(tables, GroupByQuery(["g"], [["v_int", "sum", "s"]], []))
    assert mex.workingset.stats()["blocks"]["hits"] == blocks + 1


def test_warm_repeat_reads_only_the_working_set(shards, monkeypatch):
    """A repeated fast-path query runs no derivation and no upload: the
    derivation, alignment, codes and blocks entries all hit."""
    _frames_src, paths = shards
    mex = MeshQueryExecutor(device=CPU)
    spec = _spec(groupby=["region"],
                 aggs=[["weight", "sum", "w"], ["v_int", "topk", "t", {"k": 2}]],
                 join={"table": _dim(), "on": "cust",
                       "select": ["region", "weight"]})
    first = _port_fast(paths, spec, mex)

    def no_derivation(*_a, **_k):
        raise AssertionError("a warm query derived again")

    monkeypatch.setattr(opexec.DagExecutor, "_probe_join", no_derivation)
    monkeypatch.setattr(executor_mod, "_upload", no_derivation)
    _same_payload(_port_fast(paths, spec, mex), first)


# -- fallback routing and the kill switch ------------------------------------

def test_count_distinct_and_raw_rows_not_batchable():
    cd = dagmod.compile_query(_spec(groupby=["g"],
                                    aggs=[["v", "count_distinct", "cd"]]))
    assert not dagmod.dag_batchable(cd)
    assert dagmod.groupby_equivalent(cd)[1]["batch"] is False
    ext = dagmod.compile_query(_spec(groupby=["g"],
                                     aggs=[["v", "topk", "t", {"k": 2}]]))
    assert dagmod.dag_batchable(ext)
    assert dagmod.groupby_equivalent(ext)[1]["batch"] is True


def test_derive_signature_matches_reference():
    for spec in (
        _spec(groupby=["g"], aggs=[["v_int", "sum", "s"]]),
        _spec(groupby=["g", {"window": {"on": "t", "every": "1h"}}],
              aggs=[["v_int", "topk", "t", {"k": 2}]],
              where=[["v_int", ">", 0], ["region", "==", "r1"]],
              join={"table": _dim(), "on": "cust", "select": ["region"]}),
    ):
        dag, ref = dagmod.compile_query(spec), jax_dag.compile_query(spec)
        assert dag.derive_signature() == ref.derive_signature()
        other = dagmod.compile_query(dict(spec, aggs=[["v_int", "max", "m"]]))
        assert other.derive_signature() == dag.derive_signature()
        assert other.signature() != dag.signature()


def test_dag_batch_env_kill_switch(monkeypatch):
    spec = _spec(groupby=["g"], aggs=[["v", "quantile", "q", {"q": 0.5}]])
    ext = dagmod.compile_query(spec)
    monkeypatch.setenv("BQUERYD_TPU_DAG_BATCH", "0")
    assert not dagmod.dag_batchable(ext)
    assert not jax_dag.dag_batchable(jax_dag.compile_query(spec))
    assert dagmod.groupby_equivalent(ext)[1]["batch"] is False


@pytest.mark.parametrize("case", ["count_distinct", "raw_rows",
                                  "object_join_measure", "sketch_budget"])
def test_unsupported_shapes_raise_on_both_packages(shards, monkeypatch, case):
    """The shapes the fast path leaves to the per-shard route raise
    ``DagFastPathUnsupported`` in the port where they raise it in the JAX
    package; the over-budget sketch grid before any upload."""
    _f, paths = shards
    spec = {
        "count_distinct": _spec(groupby=["g"], aggs=[
            ["v_int", "count_distinct", "cd"],
            ["v_int", "topk", "t", {"k": 2}]]),
        "raw_rows": _spec(groupby=["g"], aggs=[["v_int", "sum", "s"]]),
        "object_join_measure": _spec(
            groupby=["g"], aggs=[["region", "count", "n"]],
            join={"table": _dim(), "on": "cust", "select": ["region"]}),
        "sketch_budget": _spec(groupby=["g"], aggs=[
            ["v_float", "quantile", "p5", {"q": 0.5}]]),
    }[case]
    dag, ref = dagmod.compile_query(spec), jax_dag.compile_query(spec)
    if case == "raw_rows":
        dag.aggregate_rows = ref.aggregate_rows = False
    if case == "sketch_budget":
        monkeypatch.setenv("BQUERYD_TPU_SKETCH_GRID_CELLS", "16")

        def no_upload(*_a, **_k):
            raise AssertionError("uploaded before the budget check")

        monkeypatch.setattr(executor_mod, "_upload", no_upload)
    mex = MeshQueryExecutor(device=CPU)
    with pytest.raises(DagFastPathUnsupported):
        mex.execute_dag([ctable(p, mode="r") for p in paths], dag)
    with pytest.raises(JaxUnsupported):
        JaxExecutor().execute_dag([jax_ctable(p, mode="r") for p in paths],
                                  ref)


@pytest.mark.parametrize("case", ["string_topk", "string_quantile",
                                  "datetime_quantile", "datetime_sum",
                                  "unknown_column"])
def test_validation_errors_identical_on_both_routes(shards, case):
    """A query-shape error raises with the same class and text on the fast
    path, on the port's per-shard route and on the JAX fast path: the fast
    path never turns an error into a fallback."""
    _f, paths = shards
    agg = {
        "string_topk": ["k_str", "topk", "t", {"k": 2}],
        "string_quantile": ["k_str", "quantile", "q", {"q": 0.5}],
        "datetime_quantile": ["t", "quantile", "q", {"q": 0.5}],
        "datetime_sum": ["t", "sum", "s"],
        "unknown_column": ["nope", "topk", "t", {"k": 2}],
    }[case]
    spec = _spec(groupby=["g"], aggs=[agg])
    with pytest.raises(ValueError) as fast_err:
        _port_fast(paths, spec)
    with pytest.raises(ValueError) as slow_err:
        opexec.DagExecutor(QueryEngine(device=CPU)).execute_shard(
            ctable(paths[0], mode="r"), dagmod.compile_query(spec))
    with pytest.raises(ValueError) as jax_err:
        _jax_fast(paths, spec)
    assert type(fast_err.value) is type(slow_err.value)
    assert str(fast_err.value) == str(slow_err.value)
    assert str(fast_err.value) == str(jax_err.value)
    assert type(fast_err.value).__name__ == type(jax_err.value).__name__


def test_composite_overflow_raises_for_the_worker(tmp_path):
    """A key space past int64 raises ``ops.CompositeOverflow`` on the fast
    path, which the worker serves per shard."""
    from bqueryd_tpu_torch import ops

    rng = np.random.default_rng(0)
    cols = {f"k{i}": rng.integers(0, 3000, 4000).astype(np.int64)
            for i in range(6)}
    cols["v"] = rng.integers(0, 9, 4000).astype(np.int64)
    p = str(tmp_path / "wide.bcolzs")
    ctable.fromdataframe(pd.DataFrame(cols), p)
    spec = _spec(groupby=[f"k{i}" for i in range(6)],
                 aggs=[["v", "topk", "t", {"k": 1}]])
    with pytest.raises(ops.CompositeOverflow):
        _port_fast([p], spec)


def test_fast_path_prunes_chunks_like_the_reference(tmp_path):
    """The pushdown prunes shards by their stats and chunks by their zone
    maps first, with the JAX fast path's chunk counts, and the answer is
    the unpruned one (pandas)."""
    rng = np.random.default_rng(5)
    frames, paths = [], []
    for i in range(2):
        n = 4000
        df = pd.DataFrame({
            "g": rng.integers(0, 4, n).astype(np.int64),
            "seq": np.arange(i * n, (i + 1) * n, dtype=np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64),
        })
        p = str(tmp_path / f"pr_{i}.bcolzs")
        jax_ctable.fromdataframe(df, p, chunklen=500)
        frames.append(df)
        paths.append(p)
    spec = _spec(groupby=["g"],
                 aggs=[["v", "sum", "s"], ["v", "topk", "t", {"k": 3}]],
                 where=[["seq", ">=", 7000]])
    mex = MeshQueryExecutor(device=CPU)
    got = _port_fast(paths, spec, mex)
    ref = JaxExecutor()
    want = dict(ref.execute_dag([jax_ctable(p, mode="r") for p in paths],
                                jax_dag.compile_query(spec)))
    _same_payload(got, want)
    assert mex.last_prune_counts == list(ref.last_prune_counts)
    assert mex.last_prune_counts and mex.last_prune_counts[0][1] > 0
    full = pd.concat(frames, ignore_index=True)
    full = full[full["seq"] >= 7000]
    frame = hostmerge.payload_to_dataframe(got)
    for i, g in enumerate(frame["g"]):
        part = full[full["g"] == g]["v"]
        assert int(frame["s"][i]) == int(part.sum())
        np.testing.assert_array_equal(frame["t"][i], _topk_of(part, 3, True))


def test_empty_group_after_pruning(shards):
    """A pushdown no shard can match answers an empty payload, as the JAX
    fast path does."""
    _f, paths = shards
    spec = _spec(groupby=["g"], aggs=[["v_int", "topk", "t", {"k": 2}]],
                 where=[["v_int", ">", 1000]])
    got, want = _port_fast(paths, spec), _jax_fast(paths, spec)
    assert got["kind"] == want["kind"] == "empty"


# -- the worker's routing ------------------------------------------------------

def _worker(data_dir, tmp_path):
    from bqueryd_tpu_torch.worker import WorkerNode

    return WorkerNode(coordination_url=f"mem://dagfast-{tmp_path.name}",
                      data_dir=str(data_dir), loglevel=QUIET, device=CPU)


def _dag_msg(names, spec):
    msg = messages.CalcMessage({"payload": "groupby", "token": "t"})
    dag = dagmod.compile_query(dict(spec, table=list(names)))
    plan, kwargs = dagmod.groupby_equivalent(dag)
    msg.set_args_kwargs([list(names), list(plan.groupby.keys),
                         plan.physical_agg_list(), plan.where_terms], {})
    msg.add_as_binary("dag", dag.to_wire())
    return msg


def test_worker_routes_fast_path_and_catches_only_two_errors(
        shards, tmp_path, monkeypatch):
    """``_execute_dag`` serves a batchable DAG on the fast path (merge
    mode "device"), serves ``DagFastPathUnsupported`` and
    ``CompositeOverflow`` per shard ("host"), with equal answers, and lets
    any other error, a device error included, propagate."""
    import os

    from bqueryd_tpu_torch import ops

    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
    _f, paths = shards
    data_dir = os.path.dirname(paths[0])
    names = [os.path.basename(p) for p in paths]
    worker = _worker(data_dir, tmp_path)
    spec = {"groupby": ["g"],
            "aggs": [["v_int", "sum", "s"], ["v_int", "topk", "t", {"k": 3}],
                     ["v_float", "quantile", "q", {"q": 0.5}]]}
    try:
        fast = worker.handle_work(_dag_msg(names, spec))
        assert fast["merge_mode"] == "device"
        assert fast["effective_strategy"] == "matmul"
        for exc in (DagFastPathUnsupported("no"),
                    ops.CompositeOverflow("wide")):
            def unsupported(*_a, _exc=exc, **_k):
                raise _exc

            monkeypatch.setattr(worker.executor, "execute_dag", unsupported)
            slow = worker.handle_work(_dag_msg(names, spec))
            assert slow["merge_mode"] == "host"
            a, b = _frames(
                hostmerge.merge_payloads(
                    [_payload(fast["data"])]),
                hostmerge.merge_payloads(
                    [_payload(slow["data"])]), ["g"])
            _same_frame(a, b, ints=("g", "s"), lists=("t",), exact=("q",))

        def device_error(*_a, **_k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.undo()
        monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
        monkeypatch.setattr(relops, "topk_dense_emit", device_error)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            worker.handle_work(_dag_msg(names, spec))
    finally:
        worker.socket.close()


def _payload(data):
    from bqueryd_tpu_torch.models.query import ResultPayload

    return ResultPayload.from_bytes(data)


def test_worker_falls_back_when_unsupported(shards):
    """A DAG the fast path does not take (count_distinct) is served per
    shard, and equals pandas."""
    frames, paths = shards
    spec = _spec(groupby=["g"], aggs=[["v_int", "count_distinct", "cd"]])
    assert not dagmod.dag_batchable(dagmod.compile_query(spec))
    df = hostmerge.payload_to_dataframe(_port_slow(paths, spec))
    full = pd.concat(frames, ignore_index=True)
    exp = full.groupby("g")["v_int"].nunique().to_dict()
    assert dict(zip(df["g"], df["cd"])) == exp


# -- a port cluster ------------------------------------------------------------

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
def fp_cluster(tmp_path_factory):
    """A port cluster over two shards of the second dataset of
    ``tests/test_dag_fastpath.py``'s cluster case; 127.0.0.1."""
    root = tmp_path_factory.mktemp("torch_fp_cluster")
    frames = _dataset(seed=77)[:2]
    for i, df in enumerate(frames):
        ctable.fromdataframe(df, str(root / f"fpc_{i}.bcolzs"))
    url = f"file://{root / 'store'}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        mp.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
        with _cluster(url, str(root)) as cluster:
            yield dict(cluster, frames=frames, url=url,
                       shards=[f"fpc_{i}.bcolzs" for i in range(2)])


def _frame(result):
    order, columns = result
    return pd.DataFrame({c: columns[c] for c in order}, columns=order)


CLUSTER_SPEC = {
    "groupby": ["g"],
    "aggs": [["v_int", "sum", "s"], ["v_int", "topk", "t3", {"k": 3}],
             ["v_float", "quantile", "p50", {"q": 0.5, "alpha": ALPHA}]],
    "where": [["v_int", ">", -7]],
}


def test_cluster_batched_dag_dispatch_and_kill_switch(fp_cluster,
                                                      monkeypatch):
    """A batched DAG query is ONE CalcMessage for the co-located shards,
    merged on the device; under ``BQUERYD_TPU_DAG_BATCH=0`` it is one
    message per shard, merged on the host; ints, top-k lists and sketch
    quantiles bit-identical between the two, and equal to pandas."""
    rpc = fp_cluster["rpc"]
    spec = dict(CLUSTER_SPEC, table=fp_cluster["shards"])
    batched = _frame(rpc.query(spec))
    assert list(rpc.last_call_merge_modes.values()) == ["device"]
    monkeypatch.setenv("BQUERYD_TPU_DAG_BATCH", "0")
    per_shard = _frame(rpc.query(spec))
    modes = list(rpc.last_call_merge_modes.values())
    assert len(modes) == 2 and "device" not in modes
    a = batched.sort_values("g").reset_index(drop=True)
    b = per_shard.sort_values("g").reset_index(drop=True)
    _same_frame(a, b, ints=("g", "s"), lists=("t3",), exact=("p50",))
    full = pd.concat(fp_cluster["frames"], ignore_index=True)
    full = full[full["v_int"] > -7]
    for i, g in enumerate(a["g"]):
        part = full[full["g"] == g]
        assert int(a["s"][i]) == int(part["v_int"].sum())
        np.testing.assert_array_equal(a["t3"][i],
                                      _topk_of(part["v_int"], 3, True))
        e = _lower_q(part["v_float"], 0.5)
        assert abs(float(a["p50"][i]) - e) <= abs(e) * ALPHA + 1e-9


def test_reference_client_reads_fast_path_replies(fp_cluster):
    """The JAX package's ``RPC`` reads the port worker's fast-path reply
    (one device-merged payload with top-k and sketch parts) into the port
    client's answer."""
    from bqueryd_tpu.rpc import RPC as RefRPC

    spec = dict(CLUSTER_SPEC, table=fp_cluster["shards"])
    client = RefRPC(coordination_url=fp_cluster["url"], timeout=RPC_TIMEOUT,
                    retries=1, loglevel=QUIET)
    try:
        got = client.query(spec).sort_values("g").reset_index(drop=True)
        modes = list((client.last_call_merge_modes or {}).values())
    finally:
        client._close_socket()
    assert modes == ["device"]
    want = _frame(fp_cluster["rpc"].query(spec))
    want = want.sort_values("g").reset_index(drop=True)
    _same_frame(got, want, ints=("g", "s"), lists=("t3",), exact=("p50",))


def test_cluster_fast_path_device_error_reaches_the_client(fp_cluster,
                                                           monkeypatch):
    """A device error inside the fast path's program is the worker's
    error: nothing reruns the query per shard."""
    from bqueryd_tpu_torch.rpc import RPCError

    def failing(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(relops, "sketch_grid_block", failing)
    with pytest.raises(RPCError, match="illegal memory access"):
        fp_cluster["rpc"].query(dict(CLUSTER_SPEC,
                                     table=fp_cluster["shards"]))

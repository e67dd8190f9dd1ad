"""Port ``partial_tables`` (plain versions, on the CPU) against the JAX
package's ``partial_tables`` on the same NumPy inputs.

The JAX side runs with ``BQUERYD_TPU_PALLAS=1`` and
``BQUERYD_TPU_FORCE_MATMUL=1`` so it takes its Pallas contraction route
(interpret mode) on the CPU, the route the port takes everywhere.  Int
leaves are bit-exact; float leaves use rtol=2e-5, atol=1e-6 (the tolerance
tests/test_differential_fuzz.py allows).
"""

import jax
import numpy as np
import pytest
import torch

import bqueryd_tpu.ops as jops
from bqueryd_tpu_torch.ops import groupby as tg

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _jax_contraction_route(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_PALLAS", "1")
    monkeypatch.setenv("BQUERYD_TPU_FORCE_MATMUL", "1")


def _measure(rng, kind, n):
    if kind == "int64_small":
        return rng.integers(-1000, 1000, n).astype(np.int64)
    if kind == "int64_big":
        v = rng.integers(-(2**62), 2**62, n).astype(np.int64)
        v[:4] = [I64_MIN, I64_MAX, I64_MIN, I64_MAX]
        return v
    if kind == "int8":
        return rng.integers(-128, 128, n).astype(np.int8)
    if kind == "int32":
        return rng.integers(-(2**31), 2**31, n).astype(np.int32)
    if kind == "uint8":
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "uint32":
        return rng.integers(0, 2**32, n).astype(np.uint32)
    if kind == "uint64":
        return rng.integers(2**62, 2**64 - 1, n, dtype=np.uint64)
    if kind == "bool":
        return rng.random(n) < 0.3
    if kind == "float32":
        v = (rng.standard_normal(n) * 1000).astype(np.float32)
        v[rng.random(n) < 0.05] = np.nan
        return v
    if kind == "float64":
        v = rng.standard_normal(n) * 1e6
        v[rng.random(n) < 0.05] = np.nan
        return v
    if kind == "datetime":  # int64 ns with NaT (int64 min) as its sentinel
        v = rng.integers(0, 10**18, n).astype(np.int64)
        v[rng.random(n) < 0.1] = I64_MIN
        return v
    raise ValueError(kind)


def _inputs(seed, n, n_groups, kinds, with_mask):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, n_groups, n).astype(np.int64)
    measures = tuple(_measure(rng, k, n) for k in kinds)
    mask = (rng.random(n) < 0.7) if with_mask else None
    sentinels = tuple(I64_MIN if k == "datetime" else None for k in kinds)
    return codes, measures, mask, sentinels


def _port(codes, measures, ops, n_groups, mask, sentinels, strategy=None):
    return tg.tree_to_numpy(tg.partial_tables(
        codes, measures, ops, n_groups, mask, null_sentinels=sentinels,
        strategy=strategy, device="cpu",
    ))


def _jax(codes, measures, ops, n_groups, mask, sentinels, strategy=None):
    return jax.device_get(jops.partial_tables(
        codes, measures, ops, n_groups, mask, null_sentinels=sentinels,
        strategy=strategy,
    ))


def _assert_leaf(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_trees_match(got, want):
    _assert_leaf(got["rows"], want["rows"], "rows")
    assert len(got["aggs"]) == len(want["aggs"])
    for i, (g, w) in enumerate(zip(got["aggs"], want["aggs"])):
        assert sorted(g) == sorted(w), f"agg {i} parts"
        for key in w:
            _assert_leaf(g[key], w[key], f"agg {i} {key}")


# (measure kinds, ops, n_groups, mask) -> one route of partial_tables each
CASES = [
    (("int64_small",) * 3, ("sum", "mean", "count"), 10, True),
    (("int64_big",) * 3, ("sum", "min", "max"), 10, False),
    (("int8", "int32", "uint8", "bool"), ("sum",) * 4, 9, True),
    (("float32",) * 4, ("sum", "mean", "count", "count_na"), 12, True),
    (("float32",) * 2, ("min", "max"), 7, False),
    (("float64",) * 3, ("sum", "mean", "count"), 10, True),
    (("uint32", "uint64", "uint64", "uint64"),
     ("sum", "sum", "min", "max"), 10, False),
    (("uint64", "bool", "bool"), ("mean", "min", "max"), 10, True),
    (("datetime",) * 4, ("count", "count_na", "min", "max"), 10, True),
    (("int64_small", "float32"), ("sum", "min"), 300, True),
    ((), (), 10, True),
]


@pytest.mark.parametrize("case_i", range(len(CASES)))
def test_partial_tables_match_jax(case_i):
    kinds, ops, n_groups, with_mask = CASES[case_i]
    codes, measures, mask, sentinels = _inputs(
        case_i, 20_000, n_groups, kinds, with_mask
    )
    assert_trees_match(
        _port(codes, measures, ops, n_groups, mask, sentinels),
        _jax(codes, measures, ops, n_groups, mask, sentinels),
    )


@pytest.mark.parametrize("strategy", ["scatter", "sort", "matmul!"])
def test_strategy_hints_match_jax(strategy):
    kinds = ("int64_big", "float32", "int64_small", "float64")
    ops = ("sum", "mean", "max", "sum")
    codes, measures, mask, sentinels = _inputs(11, 20_000, 10, kinds, True)
    assert_trees_match(
        _port(codes, measures, ops, 10, mask, sentinels, strategy),
        _jax(codes, measures, ops, 10, mask, sentinels, strategy),
    )


def test_hicard_route_matches_jax():
    # past the base route's 8192 groups: the hicard contraction (int sums,
    # unsigned means, counts), ragged in rows and groups
    n, n_groups = 40_000, 9_000
    codes, measures, mask, _ = _inputs(
        1, n, n_groups, ("int64_small", "uint8", "int64_big"), True
    )
    ops = ("sum", "mean", "count")
    dtypes = [m.dtype for m in measures]
    assert tg._hicard_matmul_profitable(dtypes, ops, n, n_groups)
    assert_trees_match(
        _port(codes, measures, ops, n_groups, mask, (None,) * 3),
        _jax(codes, measures, ops, n_groups, mask, None),
    )


def test_high_cardinality_min_max_scatters_like_jax():
    codes, measures, mask, _ = _inputs(
        2, 20_000, 9_000, ("int64_small", "float32"), False
    )
    ops = ("min", "sum")
    assert tg.kernel_route(None, measures, ops, 20_000, 9_000) == "scatter"
    assert_trees_match(
        _port(codes, measures, ops, 9_000, mask, (None, None)),
        _jax(codes, measures, ops, 9_000, mask, None),
    )


@pytest.mark.parametrize(
    "kinds, ops, n_groups, strategy",
    [
        (("int64_small",), ("sum",), 10, None),
        (("float64",), ("sum",), 10, None),
        (("float64",), ("sum",), 10, "matmul!"),
        (("float32",), ("min",), 10, None),
        (("int64_small",), ("sum",), 9_000, None),
        (("int64_small", "float32"), ("sum", "count"), 9_000, None),
        (("float32",), ("sum",), 9_000, None),
        (("int64_small",), ("sum",), 300_000, None),
        (("int64_small",), ("sum",), 10, "sort"),
    ],
)
def test_kernel_route_matches_jax(kinds, ops, n_groups, strategy):
    codes, measures, _, _ = _inputs(3, 1_000, 10, kinds, False)
    assert tg.kernel_route(strategy, measures, ops, 1_000, n_groups) == (
        jops.kernel_route(strategy, measures, ops, 1_000, n_groups)
    )


def test_sentinel_sum_raises_like_jax():
    codes, measures, _, sentinels = _inputs(4, 100, 5, ("datetime",), False)
    with pytest.raises(ValueError, match="sentinel"):
        jops.partial_tables(codes, measures, ("sum",), 5,
                            null_sentinels=sentinels)
    with pytest.raises(ValueError, match="sentinel"):
        tg.partial_tables(codes, measures, ("sum",), 5,
                          null_sentinels=sentinels, device="cpu")


def test_combine_and_finalize_match_jax():
    kinds = ("int64_big", "float32", "float32", "uint64", "int8", "bool")
    ops = ("sum", "mean", "min", "max", "count", "max")
    half = 10_000
    codes, measures, mask, _ = _inputs(5, 2 * half, 12, kinds, True)
    sl = [slice(0, half), slice(half, None)]
    port = [
        tg.partial_tables(codes[s], tuple(m[s] for m in measures), ops, 12,
                          mask[s], device="cpu")
        for s in sl
    ]
    want_parts = [
        jops.partial_tables(codes[s], tuple(m[s] for m in measures), ops,
                            12, mask[s])
        for s in sl
    ]
    merged = tg.combine_partials(*port)
    want_merged = jops.combine_partials(*want_parts)
    assert_trees_match(tg.tree_to_numpy(merged), jax.device_get(want_merged))
    got = [t.numpy() for t in tg.finalize(merged, ops)]
    want = jax.device_get(jops.finalize(want_merged, ops))
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_leaf(g, w, f"finalize {ops[i]}")


def test_float32_filter_boundary_compares_in_float32():
    from bqueryd_tpu.ops import predicates as jpred

    from bqueryd_tpu_torch.ops import predicates as tpred

    v = np.array([0.1, 0.2, 5.0, np.nextafter(np.float32(5.0), 6)],
                 dtype=np.float32)
    for bound in (0.1, 5.0, 0.2):
        got = tpred.term_mask(torch.from_numpy(v), ">", bound).numpy()
        want = np.asarray(jpred.term_mask(v, ">", bound))
        np.testing.assert_array_equal(got, want)
    assert not tpred.term_mask(torch.from_numpy(v), ">", 0.1).numpy()[0]


def test_in_and_not_in_match_jax():
    from bqueryd_tpu.ops import predicates as jpred

    from bqueryd_tpu_torch.ops import predicates as tpred

    v = np.arange(-5, 20, dtype=np.int64)
    f = np.linspace(0, 3, 13).astype(np.float32)
    for values, members in ((v, [1, 3, 17]), (f, [0.25, 1.0, 2])):
        for op in ("in", "not in", "==", "!=", "<", "<=", ">=", ">"):
            arg = members if op in ("in", "not in") else members[1]
            got = tpred.term_mask(torch.from_numpy(values), op, arg).numpy()
            want = np.asarray(jpred.term_mask(values, op, arg))
            np.testing.assert_array_equal(got, want, err_msg=op)

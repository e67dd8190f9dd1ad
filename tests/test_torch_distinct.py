"""The distinct ops and basket expansion of the port on the CPU, bit for bit
against the JAX package: ``groupby_count_distinct``,
``groupby_sorted_count_distinct`` and ``expand_mask_by_group`` on seeded
NumPy inputs (masks, negative and out-of-range codes, NaN, uint64 and
datetime values, empty input), the engine's flat distinct sets and their
union, and distinct payloads merged across the two packages."""

import numpy as np
import pandas as pd
import pytest
import torch

from bqueryd_tpu import ops as jax_ops
from bqueryd_tpu.models import query as jax_query
from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
from bqueryd_tpu.models.query import QueryEngine as JaxEngine
from bqueryd_tpu.models.query import ResultPayload as JaxPayload
from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import ops
from bqueryd_tpu_torch.models import query as port_query
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.storage.ctable import ctable
from test_differential_fuzz import _compare, _dataset, _expected
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

N = 5_000


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _codes(rng, n, n_groups, null=0.1, over=0.0):
    """Group codes in [0, n_groups) with a share of nulls (-1) and of codes
    at or past n_groups."""
    codes = rng.integers(0, n_groups, n).astype(np.int32)
    codes[rng.random(n) < null] = -1
    codes[rng.random(n) < over] = n_groups + rng.integers(0, 40)
    return codes


# -- groupby_count_distinct ----------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("masked", [False, True])
def test_count_distinct_matches_jax(seed, masked):
    rng = np.random.default_rng(seed)
    n_groups = int(rng.integers(1, 300))
    n_values = int(rng.integers(1, 2_000))
    codes = _codes(rng, N, n_groups)
    vcodes = rng.integers(-1, n_values, N).astype(np.int64)
    mask = rng.random(N) < 0.6 if masked else None
    g, v = ops.program_bucket(n_groups), ops.program_bucket(n_values)
    want = jax_ops.groupby_count_distinct(codes, vcodes, g, v, mask)
    _same(ops.groupby_count_distinct(codes, vcodes, g, v, mask,
                                     device="cpu"), want)
    # tensors run where they lie
    got = ops.groupby_count_distinct(
        torch.from_numpy(codes), torch.from_numpy(vcodes), g, v,
        None if mask is None else torch.from_numpy(mask))
    _same(got, want)


def test_count_distinct_edges_match_jax():
    rng = np.random.default_rng(11)
    # codes past n_groups: their rows drop out of the segment sum
    codes = _codes(rng, N, 20, over=0.2)
    vcodes = rng.integers(0, 50, N).astype(np.int32)
    want = jax_ops.groupby_count_distinct(codes, vcodes, 20, 64)
    _same(ops.groupby_count_distinct(codes, vcodes, 20, 64, device="cpu"),
          want)
    # empty input
    empty = np.zeros(0, dtype=np.int32)
    _same(ops.groupby_count_distinct(empty, empty, 7, 3, device="cpu"),
          jax_ops.groupby_count_distinct(empty, empty, 7, 3))
    # every row invalid
    nulls = np.full(100, -1, dtype=np.int32)
    _same(ops.groupby_count_distinct(nulls, nulls, 4, 4, device="cpu"),
          jax_ops.groupby_count_distinct(nulls, nulls, 4, 4))


def test_count_distinct_overflow_raises_in_both():
    codes = np.zeros(4, dtype=np.int32)
    for fn, kw in ((jax_ops.groupby_count_distinct, {}),
                   (ops.groupby_count_distinct, {"device": "cpu"})):
        with pytest.raises(ValueError, match="exceeds int64"):
            fn(codes, codes, 1 << 32, 1 << 32, **kw)
    with pytest.raises(ops.CompositeOverflow):
        ops.groupby_count_distinct(codes, codes, 1 << 32, 1 << 32,
                                   device="cpu")


# -- groupby_sorted_count_distinct ---------------------------------------------

def _runs(rng, n, n_groups, kind):
    """Codes sorted by group, values in runs within each group."""
    codes = np.sort(rng.integers(0, n_groups, n)).astype(np.int32)
    raw = np.sort(rng.integers(0, 30, n))
    if kind == "int":
        values = raw.astype(np.int64)
    elif kind == "float_nan":
        values = raw.astype(np.float64) / 3
        values[rng.random(n) < 0.1] = np.nan
    elif kind == "uint64":
        values = (raw.astype(np.uint64) + np.uint64(2**63 + 5))
    elif kind == "datetime":
        values = (raw.astype(np.int64) * 10**9 + 1_400_000_000 * 10**9)
        values[rng.random(n) < 0.05] = np.iinfo(np.int64).min  # NaT
    elif kind == "bool":
        values = raw % 2 == 0
    else:  # dict codes with nulls
        values = raw.astype(np.int32) - 1
    return codes, values


@pytest.mark.parametrize(
    "kind", ["int", "float_nan", "uint64", "datetime", "bool", "dict"])
@pytest.mark.parametrize("masked", [False, True])
def test_sorted_count_distinct_matches_jax(kind, masked):
    rng = np.random.default_rng(len(kind) + masked)
    n_groups = 37
    codes, values = _runs(rng, N, n_groups, kind)
    codes[rng.random(N) < 0.05] = -1
    mask = rng.random(N) < 0.7 if masked else None
    g = ops.program_bucket(n_groups)
    want = jax_ops.groupby_sorted_count_distinct(codes, values, g, mask)
    _same(ops.groupby_sorted_count_distinct(codes, values, g, mask,
                                            device="cpu"), want)
    _same(ops.host_sorted_count_distinct(codes, values, g, mask), want)
    _same(jax_ops.host_sorted_count_distinct(codes, values, g, mask), want)
    if kind == "datetime":
        # datetime64 values compare as their nanoseconds
        _same(ops.groupby_sorted_count_distinct(
            codes, values.view("datetime64[ns]"), g, mask, device="cpu"),
            want)
    if kind == "uint64":
        # a uint64 tensor compares as its int64 bits
        _same(ops.groupby_sorted_count_distinct(
            torch.from_numpy(codes), torch.from_numpy(values), g,
            None if mask is None else torch.from_numpy(mask)), want)


def test_sorted_count_distinct_edges_match_jax():
    rng = np.random.default_rng(5)
    codes, values = _runs(rng, N, 10, "int")
    codes[rng.random(N) < 0.2] = 12  # past n_groups: dropped
    _same(ops.groupby_sorted_count_distinct(codes, values, 10, device="cpu"),
          jax_ops.groupby_sorted_count_distinct(codes, values, 10))
    # empty input: the JAX op cannot gather from zero rows, its NumPy twin
    # gives the zeros
    empty = np.zeros(0, dtype=np.int32)
    _same(ops.groupby_sorted_count_distinct(empty, empty.astype(np.int64), 5,
                                            device="cpu"),
          jax_ops.host_sorted_count_distinct(empty, empty.astype(np.int64),
                                             5))
    # a masked row inside a run neither splits nor hides it
    codes = np.zeros(6, dtype=np.int32)
    values = np.array([1, 1, 2, 1, 1, 3])
    mask = np.array([True, True, False, True, False, True])
    got = ops.groupby_sorted_count_distinct(codes, values, 1, mask,
                                            device="cpu")
    assert _np(got).tolist() == [2]
    _same(got, jax_ops.groupby_sorted_count_distinct(codes, values, 1, mask))


# -- expand_mask_by_group --------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_groups", [None, 1, 17, 600])
def test_expand_mask_matches_jax(seed, n_groups):
    rng = np.random.default_rng(100 + seed)
    card = n_groups or 800
    codes = _codes(rng, N, card, over=0.05)
    mask = rng.random(N) < 0.02
    want = jax_ops.expand_mask_by_group(codes, mask, n_groups=n_groups)
    got = ops.expand_mask_by_group(codes, mask, n_groups=n_groups,
                                   device="cpu")
    _same(got, want)
    # the mask's own device wins over the default
    got = ops.expand_mask_by_group(codes, torch.from_numpy(mask),
                                   n_groups=n_groups)
    _same(got, want)


def test_expand_mask_edges_match_jax():
    assert ops.expand_mask_by_group(np.zeros(3), None, device="cpu") is None
    assert jax_ops.expand_mask_by_group(np.zeros(3), None) is None
    empty = np.zeros(0, dtype=np.int64)
    _same(ops.expand_mask_by_group(empty, empty.astype(bool), device="cpu"),
          jax_ops.expand_mask_by_group(empty, empty.astype(bool)))
    # codes past the bucketed segment table: dropped, then clamped
    codes = np.array([0, 1, 2, 40, 41, -1, 16, 15], dtype=np.int64)
    mask = np.array([False, True, False, True, False, True, False, False])
    for n_groups in (3, 16, 17):
        _same(ops.expand_mask_by_group(codes, mask, n_groups, device="cpu"),
              jax_ops.expand_mask_by_group(codes, mask, n_groups))


# -- the engine's flat distinct sets -------------------------------------------

@pytest.mark.parametrize("values_kind", ["int", "float", "str", "datetime"])
def test_group_distinct_flat_matches_reference(values_kind):
    rng = np.random.default_rng(7)
    n_groups, n_values = 23, 61
    codes = _codes(rng, N, n_groups).astype(np.int64)
    vcodes = rng.integers(-1, n_values, N).astype(np.int64)
    mask = rng.random(N) < 0.5
    uniques = {
        "int": np.arange(n_values, dtype=np.int64) * 7 - 100,
        "float": np.linspace(-1, 1, n_values).astype(np.float32),
        "str": np.asarray([f"v{i}" for i in range(n_values)], dtype=object),
        "datetime": (np.arange(n_values) * 10**9).astype("datetime64[ns]"),
    }[values_kind]
    for m in (None, mask):
        got = port_query._group_distinct_flat(codes, vcodes, uniques,
                                              n_groups, m)
        want = jax_query._group_distinct_flat(codes, vcodes, uniques,
                                              n_groups, m)
        for g, w in zip(got, want):
            _same(g, w)
        present = np.diff(want[1]) % 3 != 0
        part = {"distinct_values": want[0], "distinct_offsets": want[1]}
        got_f = port_query.filter_distinct_part(part, present)
        want_f = jax_query.filter_distinct_part(part, present)
        assert got_f.keys() == want_f.keys()
        for k in want_f:
            _same(got_f[k], want_f[k])
    counts = np.array([3, 0, 2, 5])
    _same(port_query._segment_local_arange(counts),
          jax_query._segment_local_arange(counts))


@pytest.mark.parametrize("values_kind", ["int", "uint64_high", "float", "str"])
def test_union_distinct_flat_matches_reference(values_kind):
    rng = np.random.default_rng(9)
    n_global = 40
    parts = []
    for _ in range(4):
        n_local = int(rng.integers(1, n_global))
        local_map = rng.choice(n_global, n_local, replace=False)
        counts = rng.integers(0, 9, n_local)
        raw = rng.integers(0, 30, int(counts.sum()))
        values = {
            "int": raw.astype(np.int64) - 10,
            "uint64_high": raw.astype(np.uint64) + np.uint64(2**63),
            "float": raw.astype(np.float32) / 4,
            "str": np.asarray([f"s{v}" for v in raw], dtype=object),
        }[values_kind]
        offsets = np.zeros(n_local + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        parts.append((local_map, values, offsets))
    got = hostmerge._union_distinct_flat(parts, n_global)
    want = jax_hostmerge._union_distinct_flat(parts, n_global)
    for g, w in zip(got, want):
        _same(g, w)
    # nothing to union: empty values, zero offsets
    empty = [(np.arange(3), np.empty(0), np.zeros(4, dtype=np.int64))]
    for g, w in zip(hostmerge._union_distinct_flat(empty, 5),
                    jax_hostmerge._union_distinct_flat(empty, 5)):
        _same(g, w)


# -- distinct payloads across the two packages ---------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_distinct")
    frames = _dataset(20240917)
    names = []
    for i, df in enumerate(frames):
        name = f"shard_{i}.bcolzs"
        jax_ctable.fromdataframe(df, str(root / name))
        names.append(name)
    return root, frames, names


DISTINCT_AGGS = [
    ["v_float", "count_distinct", "nd"],
    ["t", "count_distinct", "nt"],
    ["k_str", "count_distinct", "ns"],
    ["v_u64", "count_distinct", "nu"],
    ["v_small", "sum", "s"],
]


@pytest.mark.parametrize("sole", [False, True])
def test_distinct_payloads_merge_across_packages(shards, sole):
    """Port payloads decode and union in the JAX host merge, JAX payloads
    in the port's, with the same part names and dtypes; a sole payload's
    device-sorted counts match the JAX engine's too."""
    root, frames, names = shards
    gcols, where = ["k_int"], [["sel", ">", 0.3]]
    use = names[:1] if sole else names
    port_q = GroupByQuery(gcols, DISTINCT_AGGS, where, sole_payload=sole)
    jax_q = JaxQuery(gcols, DISTINCT_AGGS, where, sole_payload=sole)
    port_engine, jax_engine = QueryEngine(device="cpu"), JaxEngine()
    port_payloads = [
        port_engine.execute_local(ctable(str(root / n), mode="r"), port_q)
        for n in use
    ]
    jax_payloads = [
        jax_engine.execute_local(jax_ctable(str(root / n), mode="r"), jax_q)
        for n in use
    ]
    for p, j in zip(port_payloads, jax_payloads):
        assert p["value_kinds"] == j["value_kinds"]
        for pa, ja in zip(p["aggs"], j["aggs"]):
            assert pa.keys() == ja.keys()
            for k in ja:
                assert np.asarray(pa[k]).dtype == np.asarray(ja[k]).dtype, k
                assert (np.asarray(pa[k]).astype(str).tolist()
                        == np.asarray(ja[k]).astype(str).tolist()), k
    want = jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads(jax_payloads))
    frames_used = frames[:1] if sole else frames
    _compare(want, _expected(frames_used, gcols, DISTINCT_AGGS, where),
             gcols, DISTINCT_AGGS)
    mixed = [JaxPayload.from_bytes(p.to_bytes()) for p in port_payloads]
    mixed[-1] = jax_payloads[-1]
    got = jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads(mixed))
    _compare(got, want, gcols, DISTINCT_AGGS)
    mixed = [ResultPayload.from_bytes(p.to_bytes()) for p in jax_payloads]
    mixed[0] = port_payloads[0]
    got = hostmerge.payload_to_dataframe(hostmerge.merge_payloads(mixed))
    _compare(got, want, gcols, DISTINCT_AGGS)


def test_distinct_values_cap(shards, monkeypatch):
    root, _frames, names = shards
    monkeypatch.setenv("BQUERYD_TPU_DISTINCT_VALUES_LIMIT", "10")
    query = GroupByQuery(["k_int"], [["v_small", "count_distinct", "n"]])
    with pytest.raises(ValueError, match="DISTINCT_VALUES_LIMIT"):
        QueryEngine(device="cpu").execute_local(
            ctable(str(root / names[0]), mode="r"), query)


def test_sole_count_distinct_overflow_ships_sets(shards, monkeypatch):
    """A (group, value) space past int64 takes the value sets, exactly."""
    root, frames, names = shards

    def overflow(*args, **kwargs):
        raise ops.CompositeOverflow("composite space exceeds int64")

    monkeypatch.setattr(ops, "groupby_count_distinct", overflow)
    gcols, aggs = ["k_int"], [["v_small", "count_distinct", "n"]]
    payload = QueryEngine(device="cpu").execute_local(
        ctable(str(root / names[0]), mode="r"),
        GroupByQuery(gcols, aggs, sole_payload=True))
    assert "distinct_values" in payload["aggs"][0]
    got = hostmerge.payload_to_dataframe(hostmerge.merge_payloads([payload]))
    _compare(got, _expected(frames[:1], gcols, aggs, []), gcols, aggs)


def test_distinct_only_query_counts_rows_through_partial_tables(
        shards, monkeypatch):
    """With no mergeable aggregation the rows that drop empty groups come
    from one rows-only partial_tables call."""
    root, frames, names = shards
    calls = []
    real = ops.partial_tables

    def counting(codes, measures, agg_ops, *args, **kwargs):
        calls.append(tuple(agg_ops))
        return real(codes, measures, agg_ops, *args, **kwargs)

    monkeypatch.setattr(ops, "partial_tables", counting)
    gcols = ["k_str"]
    aggs = [["v_small", "sorted_count_distinct", "r"],
            ["v_float", "count_distinct", "nd"]]
    payload = QueryEngine(device="cpu").execute_local(
        ctable(str(root / names[1]), mode="r"), GroupByQuery(gcols, aggs))
    assert calls == [()]
    want = JaxEngine().execute_local(
        jax_ctable(str(root / names[1]), mode="r"), JaxQuery(gcols, aggs))
    got = hostmerge.payload_to_dataframe(hostmerge.merge_payloads([payload]))
    want = jax_hostmerge.payload_to_dataframe(
        jax_hostmerge.merge_payloads([want]))
    got = got.sort_values(gcols).reset_index(drop=True)
    want = want.sort_values(gcols).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=True)

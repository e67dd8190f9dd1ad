"""The port's one-hot contraction (plain versions, on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the same inputs, and
the shape plans that choose each CUDA kernel's branch.

Int rows (count flags, 8-bit limbs) must be equal; bf16 Dekker limb rows
are compared with rtol=2e-5, atol=1e-6, since float32 summation order
differs between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bqueryd_tpu.ops as jops
from bqueryd_tpu.ops import pallas_groupby
from bqueryd_tpu_torch.ops import groupby as tg
from bqueryd_tpu_torch.ops import onehot


def _bf16_exact(values):
    """float32 values rounded to bf16, so both frameworks get the same rows."""
    return torch.from_numpy(values).to(torch.bfloat16).to(torch.float32).numpy()


def _inputs(seed, n, n_groups, n_int_rows, n_float_rows=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, n_groups, n).astype(np.int32)
    int_rows = rng.integers(0, 256, (n_int_rows, n)).astype(np.float32)
    int_rows[0] = (codes >= 0).astype(np.float32)  # a count row
    float_rows = _bf16_exact(
        (rng.standard_normal((n_float_rows, n)) * 100).astype(np.float32)
    )
    return codes, np.concatenate([int_rows, float_rows], axis=0)


def _port(fn, codes, rows, n_groups):
    return fn(
        torch.from_numpy(codes),
        torch.from_numpy(rows).to(torch.bfloat16),
        rows.shape[0],
        n_groups,
    )


def _jax(fn, codes, rows, n_groups):
    return np.asarray(jax.device_get(fn(
        jnp.asarray(codes),
        jnp.asarray(rows).astype(jnp.bfloat16),
        n_rows=rows.shape[0],
        n_groups=n_groups,
        interpret=True,
    )))


@pytest.mark.parametrize(
    "n, n_groups, n_int, n_float",
    [
        (40_000, 10, 9, 0),     # ragged second block, the main path's G
        (40_000, 10, 10, 3),    # count/limb rows + Dekker limbs (multikey)
        (5_000, 300, 5, 0),     # one partial block, several lane tiles
        (70_000, 1_000, 2, 3),  # three blocks
        (33_000, 64, 9, 0),     # past the mma branch's group limit
        (33_000, 1_024, 9, 0),
        (33_000, 8_192, 9, 0),  # the base route's group ceiling
    ],
)
def test_onehot_rows_dot_matches_pallas(n, n_groups, n_int, n_float):
    codes, rows = _inputs(n + n_groups, n, n_groups, n_int, n_float)
    got = _port(onehot.onehot_rows_dot, codes, rows, n_groups).numpy()
    want = _jax(pallas_groupby.onehot_rows_dot, codes, rows, n_groups)
    assert got.shape == want.shape
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got[:, :n_int], want[:, :n_int])
    np.testing.assert_allclose(
        got[:, n_int:], want[:, n_int:], rtol=2e-5, atol=1e-6
    )


def test_onehot_rows_dot_hicard_matches_pallas():
    # the shapes tests/test_ops.py runs: 40k rows -> 2 blocks, 9k groups ->
    # 5 group tiles, ragged in both
    n, n_groups = 40_000, 9_000
    codes, rows = _inputs(7, n, n_groups, 9)
    got = _port(onehot.onehot_rows_dot_hicard, codes, rows, n_groups)
    want = _jax(pallas_groupby.onehot_rows_dot_hicard, codes, rows, n_groups)
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_negative_and_out_of_range_codes_contribute_nowhere():
    n, n_groups = 1_000, 10
    codes = np.full(n, -1, dtype=np.int32)
    codes[::2] = 3
    codes[1::4] = 500  # beyond G128: outside every output column
    rows = np.ones((2, n), dtype=np.float32)
    got = _port(onehot.onehot_rows_dot, codes, rows, n_groups).numpy()
    want = _jax(pallas_groupby.onehot_rows_dot, codes, rows, n_groups)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 3] == 500 and got.sum() == 1_000


def test_hicard_row_bound(monkeypatch):
    assert onehot.HICARD_MAX_ROWS == pallas_groupby.HICARD_MAX_ROWS
    monkeypatch.setattr(onehot, "HICARD_MAX_ROWS", 1_000)
    codes = np.zeros(1_001, dtype=np.int32)
    rows = np.ones((1, 1_001), dtype=np.float32)
    with pytest.raises(ValueError, match="HICARD_MAX_ROWS"):
        _port(onehot.onehot_rows_dot_hicard, codes, rows, 9_000)


def test_wrappers_check_their_inputs():
    codes = torch.zeros(8, dtype=torch.int64)
    rows = torch.ones(1, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        onehot.onehot_rows_dot(codes, rows, 1, 4)
    with pytest.raises(TypeError, match="bf16"):
        onehot.onehot_rows_dot(
            codes.to(torch.int32), rows.to(torch.float32), 1, 4
        )


def test_plain_versions_do_not_count_launches():
    onehot.reset_launch_counts()
    codes, rows = _inputs(3, 100, 10, 2)
    _port(onehot.onehot_rows_dot, codes, rows, 10)
    _port(onehot.onehot_rows_dot_hicard, codes, rows, 9_000)
    assert onehot.onehot_rows_dot.launches == 0
    assert onehot.onehot_rows_dot_hicard.launches == 0
    assert not onehot.LAUNCHES


def test_base_tiling_fits_shared_memory():
    for n_rows, g_pad in [(9, 128), (13, 128), (9, 8192), (40, 8192), (1, 128)]:
        g_tile, copies = onehot._base_tiling(n_rows, g_pad)
        assert g_tile % 32 == 0 and 1 <= copies <= 8
        assert copies * n_rows * g_tile * 4 <= onehot._SMEM_BUDGET
        assert -(-g_pad // g_tile) * g_tile >= g_pad
    with pytest.raises(ValueError):
        onehot._base_tiling(5_000, 128)


def test_ragged_rows_stack_with_a_padded_stride(monkeypatch):
    """n % 8 != 0: _partial_tables_mm stacks into [R, padded_width(n)] and
    the result still matches the JAX package's partial_tables."""
    monkeypatch.setenv("BQUERYD_TPU_PALLAS", "1")
    monkeypatch.setenv("BQUERYD_TPU_FORCE_MATMUL", "1")
    n, n_groups = 40_003, 10
    rng = np.random.default_rng(11)
    codes = rng.integers(-1, n_groups, n).astype(np.int64)
    measures = (rng.integers(-1000, 1000, n).astype(np.int64),
                (rng.standard_normal(n) * 100).astype(np.float32))
    ops = ("sum", "mean")
    seen = []
    real = onehot.onehot_rows_dot

    def spy(codes_t, rows, n_rows, g):
        seen.append((rows.stride(), tuple(rows.shape)))
        return real(codes_t, rows, n_rows, g)

    monkeypatch.setattr(onehot, "onehot_rows_dot", spy)
    got = tg.tree_to_numpy(tg.partial_tables(codes, measures, ops, n_groups,
                                             device="cpu"))
    want = jax.device_get(jops.partial_tables(codes, measures, ops,
                                              n_groups))
    ld = onehot.padded_width(n)
    assert ld % 8 == 0 and ld > n
    assert seen == [((ld, 1), (13, n))]  # count, 8 limbs, present, 3 Dekker
    np.testing.assert_array_equal(got["rows"], np.asarray(want["rows"]))
    np.testing.assert_array_equal(got["aggs"][0]["sum"],
                                  np.asarray(want["aggs"][0]["sum"]))
    np.testing.assert_array_equal(got["aggs"][1]["count"],
                                  np.asarray(want["aggs"][1]["count"]))
    np.testing.assert_allclose(got["aggs"][1]["sum"],
                               np.asarray(want["aggs"][1]["sum"]),
                               rtol=2e-5, atol=1e-6)


def test_strided_rows_match_contiguous_rows():
    n, n_groups = 5_003, 12
    codes, rows = _inputs(5, n, n_groups, 6, 2)
    t = torch.from_numpy(rows).to(torch.bfloat16)
    padded = torch.zeros(8, onehot.padded_width(n), dtype=torch.bfloat16)
    padded[:, :n] = t
    view = padded[:, :n]
    c = torch.from_numpy(codes)
    for fn in (onehot.onehot_rows_dot, onehot.onehot_rows_dot_hicard):
        assert torch.equal(fn(c, view, 8, n_groups), fn(c, t, 8, n_groups))


#: every shape the base route admits, sampled: (rows, groups, n)
_BASE_SHAPES = [
    (r, g, n)
    for r in (1, 2, 9, 13, 16, 17, 40, 100, 1_600)
    for g in (1, 8, 9, 16, 31, 32, 33, 64, 128, 129, 256, 1_000, 8_192)
    for n in (1, 7, 32_768, 1_000_003)
]


@pytest.mark.parametrize("n_rows", sorted({s[0] for s in _BASE_SHAPES}))
def test_base_plan_fits_the_card(n_rows):
    for r, g, n in _BASE_SHAPES:
        if r != n_rows:
            continue
        plan = onehot._base_plan(r, g, n)
        nb = max(1, -(-n // onehot.BLOCK_K))
        assert plan.branch == ("mma" if g <= onehot.MMA_GROUPS_LIMIT
                               else "table")
        assert 0 < plan.smem <= onehot.SMEM_LIMIT
        assert plan.grid[0] % plan.cluster == 0
        assert plan.cluster <= 8 and onehot.BLOCK_K % plan.cluster == 0
        assert plan.ld % 8 == 0 and plan.ld >= n
        if plan.branch == "mma":
            assert plan.grid == (nb * plan.cluster, -(-r // 16))
            assert plan.ntiles in onehot._MMA_NTILES
            assert g <= plan.ntiles * 8 <= -(-g // 128) * 128
        else:
            assert plan.grid[0] == nb * 8
            assert plan.grid[1] * plan.g_tile >= -(-g // 128) * 128


@pytest.mark.parametrize("n_groups, branch", [
    (onehot.MMA_GROUPS_LIMIT, "mma"),
    (onehot.MMA_GROUPS_LIMIT + 1, "table"),
    (9, "mma"),
    (8_192, "table"),
])
def test_base_plan_branch_at_the_crossover(n_groups, branch):
    assert onehot._base_plan(9, n_groups, 1_000_000).branch == branch


def test_forced_branches_raise_where_they_cannot_run():
    with pytest.raises(ValueError):
        onehot._base_plan(9, 300, 1_000, branch="mma")  # no 38-tile build
    with pytest.raises(ValueError):
        onehot._base_plan(9, 9, 1_000, branch="wgmma")
    with pytest.raises(ValueError):
        onehot._hicard_plan(27, 1 << 18, 1_000, branch="cluster")
    with pytest.raises(ValueError):
        onehot._hicard_plan(9, 73_728, 1_000, clusters=3)
    assert onehot._base_plan(9, 256, 1_000, branch="mma").ntiles == 32
    assert onehot._base_plan(9, 9, 1_000, branch="table").branch == "table"


_HICARD_GROUPS = (8_193, 9_000, 70_225, 73_728, 100_000, 1 << 18)


@pytest.mark.parametrize("n_groups", _HICARD_GROUPS)
def test_hicard_plan_fits_the_card(n_groups):
    gpad = -(-n_groups // onehot.HICARD_GROUP_PAD) * onehot.HICARD_GROUP_PAD
    for r in (1, 2, 9, 13, 17, 25, 27, 40, 64):
        for n in (1, 1_000_003, onehot.HICARD_MAX_ROWS):
            plan = onehot._hicard_plan(r, n_groups, n)
            assert plan.ld % 8 == 0 and plan.ld >= n
            assert plan.smem <= onehot.SMEM_LIMIT
            assert plan.grid[0] % plan.cluster == 0
            if plan.branch == "cluster":
                assert plan.clusters >= onehot.HICARD_CLUSTERS
                assert plan.clusters * onehot.HICARD_CLUSTER <= onehot._SMS
                assert plan.grid == (plan.clusters * onehot.HICARD_CLUSTER,)
                assert gpad % (plan.clusters * onehot.HICARD_CLUSTER) == 0
                assert plan.smem == r * gpad // plan.grid[0] * 4
                assert plan.smem <= onehot._SMEM_BUDGET
            else:
                # global only where no cluster count holds the table
                assert r * gpad // (8 * onehot.HICARD_CLUSTER) * 4 > (
                    onehot._SMEM_BUDGET)
                assert 1 <= plan.grid[0] <= onehot._HICARD_MAX_BLOCKS


def test_hicard_main_path_shape_takes_the_cluster_table():
    plan = onehot._hicard_plan(9, 73_728, 1_000_000)
    assert plan.branch == "cluster"
    assert plan.clusters == onehot.HICARD_CLUSTERS
    assert onehot._hicard_plan(27, 1 << 18, 1_000_000).branch == "global"
    forced = onehot._hicard_plan(9, 73_728, 1_000_000, branch="global")
    assert forced.branch == "global" and forced.smem == 0
    for c in (2, 4, 8):
        assert onehot._hicard_plan(9, 73_728, 10, clusters=c).clusters == c


def test_padded_width():
    assert [onehot.padded_width(n) for n in (0, 1, 8, 9, 1_000_003)] == [
        8, 8, 8, 16, 1_000_008]

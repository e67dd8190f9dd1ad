"""The port's one-hot contraction (plain versions, on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the same inputs.

Int rows (count flags, 8-bit limbs) must be equal; bf16 Dekker limb rows
are compared with rtol=2e-5, atol=1e-6, since float32 summation order
differs between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bqueryd_tpu.ops import pallas_groupby
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


def test_base_tiling_fits_shared_memory():
    for n_rows, g_pad in [(9, 128), (13, 128), (9, 8192), (40, 8192), (1, 128)]:
        g_tile, copies = onehot._base_tiling(n_rows, g_pad)
        assert g_tile % 32 == 0 and 1 <= copies <= 8
        assert copies * n_rows * g_tile * 4 <= onehot._SMEM_BUDGET
        assert -(-g_pad // g_tile) * g_tile >= g_pad
    with pytest.raises(ValueError):
        onehot._base_tiling(5_000, 128)

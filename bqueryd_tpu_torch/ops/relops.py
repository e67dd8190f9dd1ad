"""Device twins of the relational operators' host kernels (plan.dag,
parallel.opexec), in torch.

The port of ``bqueryd_tpu/ops/relops.py``, whose entry points are jnp
programs (no Pallas kernel).  The per-shard entry points take NumPy
inputs, compute on ``device`` (``cuda`` unless the caller passes
``device="cpu"``) and return NumPy, bit-identical to their NumPy host
twins in :mod:`bqueryd_tpu_torch.parallel.opexec`:

* :func:`gather_positions` — the broadcast hash-join probe: one gather of
  per-distinct-key dimension positions onto rows;
* :func:`topk_partials` — per-group top-k: a lexicographic order by
  (group, value) from two stable sorts, then each group's first or last
  ``k`` rows of its segment, as ``opexec.topk_flat`` selects them;
* :func:`sketch_bin` — the quantile sketch's signed log-gamma bucket key
  per value, in float64.

The fast path (``parallel.executor.MeshQueryExecutor.execute_dag``) runs
the dense bodies on tensors already on the device, inside its one device
program:

* :func:`topk_dense_emit` — per-group top-k as a dense best-first
  ``[groups, k]`` table and per-group counts, by a static route over three
  bodies that emit the same value multisets: the masked-matrix route
  (:func:`topk_matrix_block`), the k-pass segment route
  (:func:`topk_kpass_block`) and the sort route
  (:func:`topk_dense_block`);
* :func:`sketch_grid_block` — the dense per-(group, bucket) count grid,
  binned by :func:`sketch_bin_block`, the body :func:`sketch_bin` runs too.
"""

import numpy as np
import torch

from bqueryd_tpu_torch import resolve_device
from bqueryd_tpu_torch.ops.groupby import _Measure, as_tensor
from bqueryd_tpu_torch.parallel.opexec import (
    SKETCH_MIN_MAGNITUDE,
    sketch_keys_layout,
    sketch_layout,
)

#: a sketch quotient ``log(v) / log(gamma)`` within this relative distance
#: of an integer is a bucket edge where a one-ulp difference between the
#: card's ``log`` and NumPy's could change the bucket: such values take
#: the host formula that defines the layout
_EDGE_RTOL = 1e-9


def gather_positions(pos_of_unique, codes, device=None):
    """Join probe: ``row_pos[i] = pos_of_unique[codes[i]]``, -1 (a miss)
    where ``codes[i]`` is null."""
    device = resolve_device(device)
    pos = as_tensor(np.asarray(pos_of_unique, dtype=np.int64), device)
    c = as_tensor(np.asarray(codes), device).to(torch.int64)
    out = torch.where(c >= 0, pos[c.clamp(min=0)], torch.full_like(c, -1))
    return out.cpu().numpy()


def _order_key(values, device):
    """An order-preserving tensor of ``values`` that torch sorts: bools
    as small ints, unsigned ints shifted into int64, floats as float64
    with -0.0 folded onto +0.0 (NumPy's sorts hold them equal, a radix sort
    of their bits would not)."""
    v = np.asarray(values)
    if v.dtype == np.bool_:
        return as_tensor(v.astype(np.int16), device)
    if v.dtype == np.uint64:
        return as_tensor(
            v.view(np.int64) ^ np.int64(np.iinfo(np.int64).min), device
        )
    if v.dtype.kind in "iu":
        return as_tensor(v.astype(np.int64), device)
    if v.dtype.kind == "f":
        return as_tensor(v.astype(np.float64), device) + 0.0
    raise TypeError(f"no order for top-k values of dtype {v.dtype}")


def topk_partials(codes, values, k, largest, n_groups, mask=None,
                  sentinel=None, device=None):
    """Per-shard top-k partial in the flat mergeable form ``(values,
    offsets)``, bit-identical to ``opexec.topk_flat``: null keys, masked
    rows, NaNs and the null ``sentinel`` (datetime NaT) drop; group ``g``'s
    values are best-first, ties kept (a value multiset, as ``nlargest``)."""
    values = np.asarray(values)
    c = as_tensor(np.asarray(codes), resolve_device(device)).to(torch.int64)
    key = _order_key(values, c.device)
    valid = c >= 0
    if mask is not None:
        valid &= as_tensor(np.asarray(mask, dtype=bool), c.device)
    if sentinel is not None:
        raw = as_tensor(values.astype(np.int64), c.device)
        valid &= raw != int(sentinel)
    if values.dtype.kind == "f":
        valid &= ~torch.isnan(key)
    rows = torch.nonzero(valid).squeeze(1)
    g = c[rows]
    by_value = torch.sort(key[rows], stable=True).indices
    perm = by_value[torch.sort(g[by_value], stable=True).indices]
    counts = torch.bincount(g, minlength=int(n_groups))
    take = counts.clamp(max=int(k))
    ends = torch.cumsum(counts, 0)
    group_of = torch.repeat_interleave(
        torch.arange(int(n_groups), device=c.device), take
    )
    loc = (torch.arange(group_of.numel(), device=c.device)
           - (torch.cumsum(take, 0) - take)[group_of])
    if largest:
        at = ends[group_of] - 1 - loc
    else:
        at = (ends - counts)[group_of] + loc
    picked = rows[perm[at]].cpu().numpy()
    offsets = np.zeros(int(n_groups) + 1, dtype=np.int64)
    np.cumsum(take.cpu().numpy(), out=offsets[1:])
    return values[picked], offsets


#: per-group k at or below which the dense top-k emission takes the k-pass
#: segment route when the matrix route does not apply; past it, the sort
#: route
TOPK_KPASS_MAX_K = 32

#: cell budget of the matrix route's masked ``[groups, chunk]`` matrix per
#: chunk (2^24 cells of 8 bytes: a 128 MiB transient)
TOPK_MATRIX_CELLS = 1 << 24

_INT64_MIN = -(1 << 63)


def _topk_measure(codes, values, mask, drop_nan, sentinel):
    """``(codes int64, measure, valid)`` of a dense top-k emission: null
    keys, masked rows, the null ``sentinel`` and (``drop_nan``) NaNs are
    not valid."""
    codes = codes.to(torch.int64)
    m = _Measure(values, codes.device)
    valid = codes >= 0
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    if sentinel is not None:
        valid = valid & (m.t != int(sentinel))
    if drop_nan:
        valid = valid & ~torch.isnan(m.t)
    return codes, m, valid


def _ranked(m, largest):
    """``(key, fill, restore)``: ``m``'s values as an int64 or float64
    tensor in which a larger key is a better value for the selection, the
    key below every value, and the inverse back to ``m``'s dtype.  The
    transforms are exact bijections (float widening and negation, integer
    bitwise-not, uint64's sign-bit flip), so a slot holding the fill of a
    group whose rows all equal it inverts to the right value."""
    t = m.t
    if m.is_float:
        key = t.to(torch.float64)
        if not largest:
            key = -key
        sign = 1.0 if largest else -1.0

        def restore(k):
            return m.restore((k * sign).to(t.dtype))

        return key, float("-inf"), restore
    key = t.to(torch.int64)
    flip = m.dtype == np.uint64
    if flip:
        key = key ^ _INT64_MIN
    if not largest:
        key = ~key

    def restore(k):
        if not largest:
            k = ~k
        if flip:
            k = k ^ _INT64_MIN
        return m.restore(k.to(t.dtype))

    return key, _INT64_MIN, restore


def topk_matrix_block(codes, values, mask, k, largest, n_groups, drop_nan,
                      sentinel):
    """Dense per-group top-k over a masked ``[groups, chunk]`` key matrix:
    ``torch.topk`` along each group's row of every chunk, then over the
    chunks' candidates.  Rows chunk so that the matrix never exceeds
    :data:`TOPK_MATRIX_CELLS` cells.  Returns ``(values[n_groups, k],
    counts[n_groups])`` with group ``g``'s best-first values in its first
    ``counts[g]`` slots; slots past the count are not read.  Top-k partials
    carry values only, so which of equal rows a slot takes is not
    observable."""
    codes, m, valid = _topk_measure(codes, values, mask, drop_nan, sentinel)
    key, fill, restore = _ranked(m, largest)
    k, n_groups, n = int(k), int(n_groups), int(key.shape[0])
    gids = torch.arange(n_groups, dtype=torch.int64, device=codes.device)
    chunk = max(min(max(TOPK_MATRIX_CELLS // max(n_groups, 1), k), n), 1)
    tops = []
    counts = torch.zeros(n_groups, dtype=torch.int64, device=codes.device)
    for start in range(0, n, chunk):
        c = codes[start:start + chunk]
        hit = valid[start:start + chunk][None, :] & (c[None, :]
                                                     == gids[:, None])
        mat = torch.where(hit, key[start:start + chunk][None, :], fill)
        top = torch.topk(mat, min(k, mat.shape[1]), dim=1).values
        if top.shape[1] < k:
            top = torch.cat([top, torch.full(
                (n_groups, k - top.shape[1]), fill, dtype=key.dtype,
                device=key.device)], dim=1)
        tops.append(top)
        counts += hit.sum(dim=1)
    if not tops:
        cand = torch.full((n_groups, k), fill, dtype=key.dtype,
                          device=key.device)
    elif len(tops) == 1:
        cand = tops[0]
    else:
        cand = torch.topk(torch.cat(tops, dim=1), k, dim=1).values
    return restore(cand), counts.clamp(max=k)


def topk_kpass_block(codes, values, mask, k, largest, n_groups, drop_nan,
                     sentinel):
    """Dense per-group top-k by ``k`` segment passes, O(k n) with no
    rows-scale sort: each pass takes the per-group maximum key of the rows
    still alive, then retires one row per group (the lowest row index among
    that group's best rows).  Same dense contract as
    :func:`topk_matrix_block`."""
    codes, m, valid = _topk_measure(codes, values, mask, drop_nan, sentinel)
    key, fill, restore = _ranked(m, largest)
    n_groups, n = int(n_groups), int(key.shape[0])
    dev = codes.device
    safe = torch.where(codes >= 0, codes, 0)
    row = torch.arange(n, dtype=torch.int64, device=dev)
    alive = valid
    slots = []
    for _ in range(int(k)):
        cur = torch.where(alive, key, fill)
        best = torch.full((n_groups,), fill, dtype=key.dtype,
                          device=dev).scatter_reduce(0, safe, cur, "amax")
        slots.append(best)
        is_best = alive & (key == best[safe])
        kill = torch.full((n_groups,), n, dtype=torch.int64,
                          device=dev).scatter_reduce(
            0, safe, torch.where(is_best, row, n), "amin")
        alive = alive & (row != kill[safe])
    counts = torch.zeros(n_groups, dtype=torch.int64, device=dev).scatter_add(
        0, safe, valid.to(torch.int64))
    return restore(torch.stack(slots, dim=1)), counts.clamp(max=int(k))


def topk_dense_block(codes, values, mask, k, largest, n_groups, drop_nan,
                     sentinel, float_neg):
    """Dense per-group top-k by sorting: rows ordered by (group, value
    best-first) from two stable sorts, each row's rank within its group,
    and the rows of rank < ``k`` scattered into the dense table.
    ``float_neg`` says that the values are floats (their descending key is
    a negation, with -0.0 folded onto +0.0 as NumPy's sort holds them
    equal), as the reference's static argument does.  Same dense contract
    as :func:`topk_matrix_block`."""
    codes, m, valid = _topk_measure(codes, values, mask, drop_nan, sentinel)
    key, _fill, _restore = _ranked(m, largest)
    if float_neg:
        key = key + 0.0
    k, n_groups = int(k), int(n_groups)
    dev = codes.device
    gkey = torch.where(valid, codes, n_groups)
    by_value = torch.sort(key, descending=True, stable=True).indices
    order = by_value[torch.sort(gkey[by_value], stable=True).indices]
    sk = gkey[order]
    rank = (torch.arange(sk.shape[0], dtype=torch.int64, device=dev)
            - torch.searchsorted(sk, sk))
    sel = (sk < n_groups) & (rank < k)
    gi, ri = sk[sel], rank[sel]
    out = torch.zeros((n_groups, k), dtype=m.t.dtype, device=dev)
    out[gi, ri] = m.t[order][sel]
    counts = torch.bincount(gi, minlength=n_groups)
    return m.restore(out), counts


def topk_dense_emit(codes, values, mask, k, largest, n_groups, drop_nan,
                    sentinel, float_neg):
    """Route the dense top-k emission by static shape, as the reference
    does: the matrix route when the ``[groups, chunk]`` matrix affords a
    chunk of at least 4,096 rows that holds ``k``, the k-pass route for
    ``k`` up to :data:`TOPK_KPASS_MAX_K`, the sort route past that or for
    bool values.  The three emit the same value multisets.  ``codes``,
    ``values`` and ``mask`` are tensors on one device."""
    if values.dtype != torch.bool:
        chunk = TOPK_MATRIX_CELLS // max(int(n_groups), 1)
        if chunk >= 4096 and int(k) <= chunk:
            return topk_matrix_block(codes, values, mask, k, largest,
                                     n_groups, drop_nan, sentinel)
        if int(k) <= TOPK_KPASS_MAX_K:
            return topk_kpass_block(codes, values, mask, k, largest,
                                    n_groups, drop_nan, sentinel)
    return topk_dense_block(codes, values, mask, k, largest, n_groups,
                            drop_nan, sentinel, float_neg)


def sketch_bin_block(values, log_gamma, imin, imax):
    """Signed bucket key per value of a float64 tensor (int64, on its
    device).  NaN rows produce garbage keys and must be excluded by the
    caller.  A value at a bucket edge (its quotient within
    :data:`_EDGE_RTOL` of an integer) is binned by the host formula, which
    defines the layout, so the keys equal ``opexec.sketch_keys_host``'s."""
    mag = values.abs()
    tiny = mag < SKETCH_MIN_MAGNITUDE
    q = torch.log(torch.where(tiny, torch.ones_like(mag), mag)) / log_gamma
    i = torch.ceil(q).clamp(imin, imax).to(torch.int64)
    unsigned = i - imin + 1
    keys = torch.where(
        tiny, torch.zeros_like(i),
        torch.where(values < 0, -unsigned, unsigned),
    )
    edge = (q - torch.round(q)).abs() <= _EDGE_RTOL * q.abs().clamp(min=1.0)
    at = torch.nonzero(edge & ~tiny).squeeze(1)
    if at.numel():
        host = values[at].cpu().numpy()
        keys[at] = as_tensor(
            sketch_keys_layout(host, log_gamma, imin, imax), keys.device
        )
    return keys


def sketch_grid_block(codes, values, n_groups, log_gamma, imin, imax, kmin,
                      width):
    """Dense per-(group, signed bucket) count grid: ``int64[n_groups,
    width]``, column ``j`` holding the count of bucket key ``kmin + j``.
    One scatter-add (``bincount``) over ``g * width + col``; NaN values and
    null or masked-out codes (< 0) drop, as in the host kernel.
    ``opexec.sketch_grid_to_flat`` turns the fetched grid into the flat
    part the host route builds."""
    codes = codes.to(torch.int64)
    v = _Measure(values, codes.device).as_float64()
    valid = (codes >= 0) & ~torch.isnan(v)
    keys = sketch_bin_block(v, log_gamma, imin, imax)
    cells = int(n_groups) * int(width)
    flat = torch.where(valid, codes * int(width) + (keys - int(kmin)), cells)
    return torch.bincount(flat, minlength=cells + 1)[:cells].view(
        int(n_groups), int(width))


def sketch_bin(values, alpha, device=None):
    """Signed bucket key per value (int64), equal to
    ``opexec.sketch_keys_host``'s (:func:`sketch_bin_block` on the
    device).  NaN rows produce garbage keys and must be excluded by the
    caller's validity mask, as for the host twin."""
    _gamma, lg, imin, imax = sketch_layout(alpha)
    v = as_tensor(np.asarray(values, dtype=np.float64),
                  resolve_device(device))
    return sketch_bin_block(v, lg, imin, imax).cpu().numpy()

"""Segment-reduction groupby on torch tensors: per-shard partial tables.

The port of ``bqueryd_tpu/ops/groupby.py``'s partial-table kernels:

* group keys arrive as dense int codes (:mod:`.factorize`); negative codes
  are null keys and drop their rows;
* sums and counts take the **one-hot contraction**: stacked bf16 rows (a
  count row, 8-bit limbs of biased ints, a 3-limb bf16 split of float32
  values) reduced against the one-hot of the codes by the hand-written
  CUDA kernels of :mod:`.onehot`.  Block partials of limbs stay below
  2^24, so the float32 accumulation is exact, and recombining the limbs in
  int64 (mod 2^64, two's complement) makes int sums bit-exact over the
  full int64 range;
* min/max, float64 measures and group counts past the contraction's
  limits take the scatter route (``index_add_`` / ``scatter_reduce_`` in
  native int64/float64) or the sort route (``torch.sort`` + ``cumsum`` +
  ``searchsorted``); both are bit-exact on ints;
* results are **partial tables** (``{"rows": int64[G], "aggs": (...)}``,
  mean = {sum, count}) closed under elementwise merge: only
  :func:`finalize` turns them into final values;
* the distinct counts (:func:`groupby_count_distinct`,
  :func:`groupby_sorted_count_distinct`) and basket expansion
  (:func:`expand_mask_by_group`) are plain torch sorts, running maxima and
  segment reductions, as the JAX package's are jnp ones.

Routing depends only on the ops, dtypes, row count and group count, never
on the device: a CUDA tensor goes through the kernels, a CPU tensor
through their plain versions, along the same route.
"""

import warnings

import numpy as np
import torch

from bqueryd_tpu_torch.models.query import (  # noqa: F401
    AGG_OPS,
    MERGEABLE_OPS,
    extremum_fill,
)
from bqueryd_tpu_torch.ops import onehot

#: kernel routes partial_tables accepts as a planner hint (None == "auto").
#: "matmul" is advisory; "scatter"/"sort" are binding; "matmul!" is binding
#: inside the group and cell guards of the base contraction
KERNEL_STRATEGIES = ("auto", "matmul", "scatter", "sort", "matmul!")

#: rows per contraction block (the base kernel's output block)
_MATMUL_BLOCK = onehot.BLOCK_K

#: group ceiling of the base contraction route
_MATMUL_GROUPS_LIMIT = 8192

#: cap on rows * groups for the base contraction route
_MATMUL_CELLS_LIMIT = 1 << 36

#: group ceiling of the hicard contraction route
HICARD_GROUPS_LIMIT = 1 << 18

#: native host-groupby routing: below the row floor thread spawn overhead
#: beats the striping win; above the group ceiling the per-thread [G]
#: accumulators stop being cache friendly
_NATIVE_GROUPBY_MIN_ROWS = 200_000
_NATIVE_GROUPBY_MAX_GROUPS = 1 << 18

#: float64 mantissa bound: a weighted bincount over int64 values is exact
#: iff every partial sum stays below it (|partial| <= n rows x max|v|).
#: Shared with the host-routing cost estimate (``models.query``)
HOST_EXACT_SUM_BOUND = 2**53

#: rows per block of the JAX package's blocked int scatter; with
#: _MAX_BLOCK_SEGMENTS it decides when an int sum takes the sort route
_SUM_BLOCK = 65536
_MAX_BLOCK_SEGMENTS = 1 << 25

_INT64_MIN = -(1 << 63)

_TORCH_TO_NUMPY = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.uint16: np.uint16,
    torch.uint32: np.uint32,
    torch.uint64: np.uint64,
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
}

#: unsigned types torch stores but cannot compute on
_BAREBONES = {
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
}


def np_dtype(dtype):
    """NumPy dtype of a torch or NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NUMPY[dtype])
    return np.dtype(dtype)


def as_tensor(arr, device):
    """A NumPy array or tensor as a tensor on ``device``, without copying a
    tensor already there.  Read-only arrays (decoded-column cache entries)
    are wrapped as they are: no kernel writes to its inputs."""
    if torch.is_tensor(arr):
        return arr.to(device)
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        # torch warns that it cannot protect read-only bytes; none of the
        # port's kernels writes to an input
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


def _placed(codes, device):
    """The device an op runs on: a tensor's own, else ``device``."""
    if torch.is_tensor(codes):
        return codes.device
    from bqueryd_tpu_torch import resolve_device

    return resolve_device(device)


class _Measure:
    """A measure tensor in a type torch computes on, with its storage dtype:
    uint16/uint32 widen to int64 values and uint64 keeps its bits as int64."""

    def __init__(self, values, device):
        self.dtype = np_dtype(values.dtype)
        if not torch.is_tensor(values):
            values = np.asarray(values)
            if self.dtype in _BAREBONES:
                values = (
                    values.view(np.int64) if self.dtype.itemsize == 8
                    else values.astype(np.int64)
                )
            self.t = as_tensor(values, device)
        else:
            t = values.to(device)
            if self.dtype in _BAREBONES:
                t = (t.view(torch.int64) if self.dtype.itemsize == 8
                     else t.to(torch.int64))
            self.t = t

    @property
    def is_float(self):
        return self.dtype.kind == "f"

    def as_int64(self):
        return self.t.to(torch.int64)

    def as_float64(self):
        f = self.t.to(torch.float64)
        if self.dtype == np.uint64:
            f = torch.where(self.t < 0, f + 2.0**64, f)
        return f

    def restore(self, t):
        """A result in the compute type back to the storage dtype."""
        if self.dtype == np.uint64:
            return t.view(torch.uint64)
        if self.dtype in _BAREBONES:
            return t.to(_BAREBONES[self.dtype])
        if self.dtype == np.bool_:
            return t.to(torch.bool)
        return t


def _measure_null(m, sentinel):
    """Per-measure null rows, or None when the measure cannot be null.
    ``sentinel`` marks the integer encoding of a missing value (datetime NaT
    is int64 min)."""
    if sentinel is not None:
        return m.t == sentinel
    if m.is_float:
        return torch.isnan(m.t)
    return None


def _normalize_sentinels(null_sentinels, n):
    if null_sentinels is None:
        return (None,) * n
    t = tuple(None if s is None else int(s) for s in null_sentinels)
    if len(t) != n:
        raise ValueError(
            f"null_sentinels has {len(t)} entries for {n} measures"
        )
    return t


def program_bucket(n, fine=False):
    """Round a dimension UP onto a coarse grid: pow2/64 steps for row
    counts (``fine=True``) and pow2/16 for group counts.  Padded groups get
    zero rows and are sliced off by callers."""
    n = int(n)
    if n <= 16:
        return max(n, 0)
    step = 1 << max((n - 1).bit_length() - (6 if fine else 4), 0)
    return -(-n // step) * step


def matmul_groups_limit():
    """Group ceiling of the base contraction route."""
    return _MATMUL_GROUPS_LIMIT


def matmul_route_allowed(n, n_groups):
    """The base contraction route's guards: group ceiling and the
    rows x groups cells budget."""
    return 0 < n_groups <= _MATMUL_GROUPS_LIMIT and (
        n * n_groups <= _MATMUL_CELLS_LIMIT
    )


def _matmul_profitable(dtypes, ops, n, n_groups):
    """Base contraction only when within its guards AND some sum/count
    rides it (min/max and float64 sums scatter regardless)."""
    if not matmul_route_allowed(n, n_groups):
        return False
    for dt, op in zip(dtypes, ops):
        if op in ("count", "count_na"):
            return True
        if op in ("sum", "mean") and dt != np.float64:
            return True
    return not dtypes  # rows-count-only query


def _hicard_matmul_profitable(dtypes, ops, n, n_groups):
    """Hicard contraction past the base route's group ceiling: INT sums
    and counts only (its mod-2^32 accumulation has no wrap-free encoding
    for float limbs), at most HICARD_GROUPS_LIMIT groups and
    HICARD_MAX_ROWS rows."""
    if not _MATMUL_GROUPS_LIMIT < n_groups <= HICARD_GROUPS_LIMIT:
        return False
    if n > onehot.HICARD_MAX_ROWS:
        return False
    for dt, op in zip(dtypes, ops):
        if op in ("count", "count_na"):
            continue
        if op not in ("sum", "mean") or dt.kind == "f":
            return False
    return True


def kernel_route(strategy, measures, ops, n, n_groups):
    """The route :func:`partial_tables` takes for this dispatch, without
    running it: "matmul" (either contraction kernel), "scatter" or "sort".
    ``measures`` only needs ``.dtype`` per entry."""
    n, n_groups = int(n), int(n_groups)
    dtypes = [np_dtype(m.dtype) for m in measures]
    ops = tuple(ops)
    if strategy in ("scatter", "sort"):
        return strategy
    if strategy == "matmul!" and matmul_route_allowed(n, n_groups):
        return "matmul"
    if _matmul_profitable(dtypes, ops, n, n_groups):
        return "matmul"
    if _hicard_matmul_profitable(dtypes, ops, n, n_groups):
        return "matmul"
    if -(-n // _SUM_BLOCK) * n_groups > _MAX_BLOCK_SEGMENTS:
        return "sort"
    return "scatter"


def partial_tables(codes, measures, ops, n_groups, mask=None,
                   null_sentinels=None, strategy=None, device=None):
    """Compute per-group partial tables for one shard.

    codes:    int[n] dense group codes in [0, n_groups); negative = null key
    measures: tuple of value arrays [n], one per aggregation
    ops:      tuple of op names aligned with measures (MERGEABLE_OPS)
    mask:     optional bool[n] row filter
    null_sentinels: optional tuple aligned with measures; an int entry marks
              that integer value as the measure's missing-data encoding
    strategy: route hint (:data:`KERNEL_STRATEGIES`)
    device:   where NumPy inputs run; tensors run where they lie

    Returns ``{"rows": int64[n_groups], "aggs": tuple of partial dicts}`` of
    tensors on the device."""
    ops = tuple(ops)
    measures = tuple(measures)
    n_groups = int(n_groups)
    null_sentinels = _normalize_sentinels(null_sentinels, len(measures))
    for sentinel, op in zip(null_sentinels, ops):
        if sentinel is not None and op in ("sum", "mean"):
            raise ValueError(
                f"op {op!r} cannot aggregate a sentinel-null measure"
            )
    for op in ops:
        if op not in MERGEABLE_OPS:
            raise ValueError(
                f"op {op!r} has no mergeable partial; use the dedicated kernel"
            )
    if strategy is not None and strategy not in KERNEL_STRATEGIES:
        raise ValueError(f"unknown kernel strategy {strategy!r}")
    dev = _placed(codes, device)
    codes = as_tensor(codes, dev).to(torch.int64)
    if mask is not None:
        mask = as_tensor(mask, dev).to(torch.bool)
    ms = tuple(_Measure(m, dev) for m in measures)
    n = codes.shape[0]
    dtypes = [m.dtype for m in ms]

    if strategy in ("scatter", "sort"):
        return _partial_tables_scatter(
            codes, ms, ops, n_groups, mask, null_sentinels,
            force_sort=strategy == "sort",
        )
    if (strategy == "matmul!" and matmul_route_allowed(n, n_groups)) or (
        _matmul_profitable(dtypes, ops, n, n_groups)
    ):
        return _partial_tables_mm(
            codes, ms, ops, n_groups, mask, null_sentinels, hicard=False
        )
    if _hicard_matmul_profitable(dtypes, ops, n, n_groups):
        return _partial_tables_mm(
            codes, ms, ops, n_groups, mask, null_sentinels, hicard=True
        )
    return _partial_tables_scatter(
        codes, ms, ops, n_groups, mask, null_sentinels
    )


def bundle_partial_tables(codes, masks, measures, member_specs, n_groups,
                          null_sentinels=None, strategy=None, device=None):
    """Per-member partial tables of a shared-scan bundle over ONE codes
    array and ONE set of de-duplicated measure columns.

    codes:        int[n] group codes shared by every member (uploaded once,
                  unmasked: each member's filter applies per member)
    masks:        bool[n_masks, n] stacked row filters, one row per member
                  that filters (a member without one indexes None)
    measures:     tuple of value arrays [n], one per DISTINCT measure
                  column of the whole bundle (the union upload)
    member_specs: one entry per member, ``(mask_idx_or_None, ((measure_slot,
                  op), ...))``: its stacked mask row and the (measure, op)
                  pairs it aggregates
    null_sentinels: optional tuple aligned with ``measures``, as
                  :func:`partial_tables` takes it per measure

    Returns a tuple with, per member, exactly what :func:`partial_tables`
    returns for that member alone: each member is one ``partial_tables``
    call with its mask on ``mask=`` (one one-hot launch per member on the
    card), which zeroes the contributions that folding the mask into the
    codes would drop, so that integer partials are bit-identical to the
    member's solo run over the same rows.  The reference's CPU backend
    batches the members into one segment sum instead; on the CPU the port
    runs the same member loop over the plain versions, with equal
    results."""
    measures = tuple(measures)
    sentinels = _normalize_sentinels(null_sentinels, len(measures))
    for _mask_idx, aggs in member_specs:
        for slot, op in aggs:
            if op not in MERGEABLE_OPS and op != "count_na":
                raise ValueError(
                    f"op {op!r} has no mergeable partial; bundles carry "
                    "mergeable aggregations only"
                )
            if sentinels[slot] is not None and op in ("sum", "mean"):
                raise ValueError(
                    f"op {op!r} cannot aggregate a sentinel-null measure"
                )
    return tuple(
        partial_tables(
            codes,
            tuple(measures[slot] for slot, _op in aggs),
            tuple(op for _slot, op in aggs),
            n_groups,
            mask=None if mask_idx is None else masks[mask_idx],
            null_sentinels=tuple(sentinels[slot] for slot, _op in aggs),
            strategy=strategy,
            device=device,
        )
        for mask_idx, aggs in member_specs
    )


def _segment_sum(values, safe, n_groups):
    out = torch.zeros(n_groups, dtype=values.dtype, device=values.device)
    return out.index_add_(0, safe, values)


def _sorted_segment_sum(values, safe, n_groups):
    """Per-group sums by sort + prefix-sum + difference at group
    boundaries.  int64 prefix sums wrap mod 2^64 and difference back
    exactly; float64 matches direct summation to ~1 ulp of the prefix."""
    codes_s, order = torch.sort(safe, stable=True)
    prefix = torch.cumsum(values[order], 0)
    ends = torch.searchsorted(
        codes_s,
        torch.arange(n_groups, dtype=codes_s.dtype, device=safe.device),
        right=True,
    )
    zero = torch.zeros(1, dtype=values.dtype, device=values.device)
    bounds = torch.cat([zero, prefix])[ends]
    return torch.diff(torch.cat([zero, bounds]))


def _int_sum(values, present, safe, n_groups, force_sort=False):
    """Exact int64 per-group sums (mod 2^64)."""
    v = torch.where(present, values, torch.zeros_like(values))
    if force_sort or -(-values.shape[0] // _SUM_BLOCK) * n_groups > (
        _MAX_BLOCK_SEGMENTS
    ):
        return _sorted_segment_sum(v, safe, n_groups)
    return _segment_sum(v, safe, n_groups)


def _segment_extremum(kind, m, present, safe, n_groups):
    """Per-group min/max by ``scatter_reduce_``; absent rows never win
    (empty groups are masked later by count == 0).  uint64 compares with
    its sign bit flipped, which orders its int64 bits as unsigned."""
    t = m.t
    if m.dtype == np.bool_:
        t = t.to(torch.uint8)
    flip = m.dtype == np.uint64
    if flip:
        t = t ^ _INT64_MIN
    if flip:
        fill = _INT64_MIN if kind == "max" else (1 << 63) - 1
    elif m.dtype == np.bool_:
        fill = 1 if kind == "min" else 0
    elif m.dtype in _BAREBONES:
        fill = int(extremum_fill(m.dtype, kind))
    else:
        fill = extremum_fill(m.dtype, kind)
    out = torch.full((n_groups,), fill, dtype=t.dtype, device=t.device)
    vals = torch.where(present, t, torch.full_like(t, fill))
    out.scatter_reduce_(0, safe, vals, "amin" if kind == "min" else "amax")
    if flip:
        out = out ^ _INT64_MIN
    return m.restore(out)


def _limb_rows(values, nbits, signed):
    """8-bit limbs of biased int64 ``values`` as exact bf16 rows.

    Signed inputs are biased by ``2^(nbits-1)`` into unsigned range (the
    int64 add wraps mod 2^64, and only the low ``nbits/8`` limbs are read);
    the bias is subtracted group-wise (``count * bias``) after the
    contraction.  An arithmetic shift followed by ``& 0xFF`` yields the
    same byte as a logical one."""
    u = values
    bias = 0
    if signed:
        bias = 1 << (nbits - 1)
        u = u + (_INT64_MIN if nbits == 64 else bias)
    rows = [((u >> (8 * i)) & 0xFF).to(torch.bfloat16)
            for i in range(nbits // 8)]
    return rows, bias


def _dekker_rows(v):
    """3-limb bf16 split of float32 ``v``: each limb captures >= 8 mantissa
    bits and each residual is exact in float32, so hi + mid + lo carries all
    24 bits.  bf16 conversion rounds to nearest-even."""
    hi_f = v.to(torch.bfloat16).to(torch.float32)
    r1 = v - hi_f
    mid_f = r1.to(torch.bfloat16).to(torch.float32)
    r2 = r1 - mid_f
    return hi_f.to(torch.bfloat16), mid_f.to(torch.bfloat16), r2.to(
        torch.bfloat16
    )


def _partial_tables_mm(codes, ms, ops, n_groups, mask, sentinels, hicard):
    """Contraction route: one kernel call over the stacked bf16 rows."""
    valid = codes >= 0
    if mask is not None:
        valid = valid & mask
    dev = codes.device
    folded = torch.where(valid, codes, -1).to(torch.int32)

    rows = []        # flat [n] bf16 rows
    int_rows = []    # indices reduced exactly in int64
    float_rows = []  # indices reduced in float64

    def add_int(row):
        rows.append(row)
        int_rows.append(len(rows) - 1)
        return len(rows) - 1

    def add_float(row):
        rows.append(row)
        float_rows.append(len(rows) - 1)
        return len(rows) - 1

    valid_count_row = add_int(valid.to(torch.bfloat16))

    plans = []
    for m, op, sentinel in zip(ms, ops, sentinels):
        null = _measure_null(m, sentinel)
        if null is None:
            present_row = valid_count_row
        elif op == "count_na":
            present_row = None  # consumes only the null row below
        else:
            present_row = add_int((valid & ~null).to(torch.bfloat16))
        if op in ("sum", "mean"):
            if not m.is_float and op == "mean":
                # pandas float-mean semantics: int means accumulate in f64
                plans.append(("f64_scatter", op, m.as_float64(), present_row))
            elif not m.is_float:
                nbits = 8 if m.dtype == np.bool_ else m.dtype.itemsize * 8
                limbs, bias = _limb_rows(
                    m.as_int64(), nbits, m.dtype.kind == "i"
                )
                idxs = [add_int(r) for r in limbs]
                plans.append(("int_sum", op, idxs, bias, present_row))
            elif m.dtype == np.float64:
                plans.append(("f64_scatter", op, m.t, present_row))
            else:
                v = m.t.to(torch.float32)
                v = torch.where(valid & ~torch.isnan(v), v,
                                torch.zeros_like(v))
                hi, mid, lo = _dekker_rows(v)
                plans.append(("float_sum", op, add_float(hi), add_float(mid),
                              add_float(lo), present_row))
        elif op == "count":
            plans.append(("count", op, present_row))
        elif op == "count_na":
            if null is not None:
                plans.append(
                    ("count", op, add_int((valid & null).to(torch.bfloat16)))
                )
            else:  # plain integers cannot be null
                plans.append(("zero_count", op))
        else:  # min / max
            plans.append((op, op, m, present_row, null))

    # one write of the rows into [R, padded_width(n)]: every row starts
    # 16-byte aligned, as the kernels' TMA and 16-byte loads need
    n_rows = len(rows)
    n = codes.shape[0]
    stacked = torch.empty(n_rows, onehot.padded_width(n),
                          dtype=torch.bfloat16, device=dev)[:, :n]
    torch.stack(rows, 0, out=stacked)
    if hicard:
        out = onehot.onehot_rows_dot_hicard(folded, stacked, n_rows, n_groups)
        # zero-extend the uint32 totals: one block of int64 sums
        tot = out.view(torch.int32)[:n_rows, :n_groups].to(torch.int64)
        tot_u = (tot & 0xFFFFFFFF)[int_rows]
    else:
        out = onehot.onehot_rows_dot(folded, stacked, n_rows, n_groups)
        out = out[:, :n_rows, :n_groups]
        tot_u = out[:, int_rows].to(torch.int64).sum(0)
        if float_rows:
            tot_f = out[:, float_rows].to(torch.float64).sum(0)
            f_pos = {ridx: i for i, ridx in enumerate(float_rows)}
    u_pos = {ridx: i for i, ridx in enumerate(int_rows)}

    def int_row(ridx):
        return tot_u[u_pos[ridx]]

    rows_count = int_row(valid_count_row)
    safe = torch.where(valid, codes, 0)

    aggs = []
    for plan in plans:
        kind, op = plan[0], plan[1]
        if kind == "int_sum":
            _, _, idxs, bias, present_row = plan
            s = torch.zeros(n_groups, dtype=torch.int64, device=dev)
            for j, ridx in enumerate(idxs):
                s = s + (int_row(ridx) << (8 * j))  # wraps mod 2^64
            count = int_row(present_row)
            if bias == 1 << 63:
                s = s - (count & 1) * _INT64_MIN  # count * 2^63 mod 2^64
            elif bias:
                s = s - count * bias
            partial = {"sum": s}
            if op == "mean":
                partial["count"] = count
            aggs.append(partial)
        elif kind == "float_sum":
            _, _, hi_idx, mid_idx, lo_idx, present_row = plan
            # smallest-magnitude limbs first
            partial = {
                "sum": (tot_f[f_pos[lo_idx]] + tot_f[f_pos[mid_idx]])
                + tot_f[f_pos[hi_idx]]
            }
            if op == "mean":
                partial["count"] = int_row(present_row)
            aggs.append(partial)
        elif kind == "f64_scatter":
            _, _, values, present_row = plan
            present = valid & ~torch.isnan(values)
            contrib = torch.where(present, values, torch.zeros_like(values))
            partial = {"sum": _segment_sum(
                contrib.to(torch.float64), safe, n_groups
            )}
            if op == "mean":
                partial["count"] = int_row(present_row)
            aggs.append(partial)
        elif kind == "count":
            aggs.append({"count": int_row(plan[2])})
        elif kind == "zero_count":
            aggs.append({"count": torch.zeros(n_groups, dtype=torch.int64,
                                              device=dev)})
        else:  # min / max
            _, _, m, present_row, null = plan
            present = valid if null is None else valid & ~null
            aggs.append({
                kind: _segment_extremum(kind, m, present, safe, n_groups),
                "count": int_row(present_row),
            })
    return {"rows": rows_count, "aggs": tuple(aggs)}


def _partial_tables_scatter(codes, ms, ops, n_groups, mask, sentinels,
                            force_sort=False):
    """Scatter route: native int64/float64 ``index_add_`` (or the sort
    route when ``force_sort`` or past the segment budget for int sums)."""
    valid = codes >= 0
    if mask is not None:
        valid = valid & mask
    safe = torch.where(valid, codes, 0)
    dev = codes.device

    def int_count(flags):
        return _int_sum(flags.to(torch.int64), flags, safe, n_groups,
                        force_sort=force_sort)

    rows = int_count(valid)
    aggs = []
    for m, op, sentinel in zip(ms, ops, sentinels):
        null = _measure_null(m, sentinel)
        present = valid if null is None else valid & ~null

        def present_count():
            return rows if null is None else int_count(present)

        if op in ("sum", "mean"):
            if m.is_float or op == "mean":
                # integer MEANS also accumulate in float64 like pandas
                f = m.as_float64()
                contrib = torch.where(present, f, torch.zeros_like(f))
                if force_sort:
                    s = _sorted_segment_sum(contrib, safe, n_groups)
                else:
                    s = _segment_sum(contrib, safe, n_groups)
                partial = {"sum": s}
            else:
                partial = {"sum": _int_sum(m.as_int64(), present, safe,
                                           n_groups, force_sort=force_sort)}
            if op == "mean":
                partial["count"] = present_count()
            aggs.append(partial)
        elif op == "count":
            aggs.append({"count": present_count()})
        elif op == "count_na":
            aggs.append({"count": (
                int_count(valid & null) if null is not None
                else torch.zeros(n_groups, dtype=torch.int64, device=dev)
            )})
        else:  # min / max
            aggs.append({
                op: _segment_extremum(op, m, present, safe, n_groups),
                "count": present_count(),
            })
    return {"rows": rows, "aggs": tuple(aggs)}


def _computable(t):
    """(int64 tensor, dtype) for unsigned types torch stores but cannot
    compute on; other tensors pass through with dtype None."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64), t.dtype
    if t.dtype in (torch.uint16, torch.uint32):
        return t.to(torch.int64), t.dtype
    return t, None


def _restored(t, dtype):
    if dtype is None:
        return t
    if dtype == torch.uint64:
        return t.view(torch.uint64)
    return t.to(dtype)


def _extremum(a, b, kind):
    """Elementwise min/max of two leaves, unsigned ones included."""
    (ca, dt), (cb, _) = _computable(a), _computable(b)
    if dt == torch.uint64:
        ca, cb = ca ^ _INT64_MIN, cb ^ _INT64_MIN
    out = torch.minimum(ca, cb) if kind == "min" else torch.maximum(ca, cb)
    if dt == torch.uint64:
        out = out ^ _INT64_MIN
    return _restored(out, dt)


def combine_partials(a, b):
    """Merge two partial-table trees of tensors."""
    aggs = []
    for pa, pb in zip(a["aggs"], b["aggs"]):
        merged = {}
        for key in pa:
            if key in ("min", "max"):
                merged[key] = _extremum(pa[key], pb[key], key)
            else:  # sum / count
                merged[key] = pa[key] + pb[key]
        aggs.append(merged)
    return {"rows": a["rows"] + b["rows"], "aggs": tuple(aggs)}


def finalize(partials, ops):
    """Turn merged partials into final per-group aggregate tensors.

    mean = sum / count; groups with no contributing rows yield NaN for
    mean/min/max of floats, 0 for int min/max and 0 for sum/count."""
    out = []
    for partial, op in zip(partials["aggs"], ops):
        if op == "mean":
            count = partial["count"]
            out.append(torch.where(
                count > 0,
                partial["sum"] / torch.clamp(count, min=1),
                torch.full_like(partial["sum"], float("nan"),
                                dtype=torch.float64),
            ))
        elif op == "sum":
            out.append(partial["sum"])
        elif op in ("count", "count_na"):
            out.append(partial["count"])
        elif op in ("min", "max"):
            value, dt = _computable(partial[op])
            if value.dtype == torch.bool:
                value = value.to(torch.int64)  # as JAX promotes bool and 0
            empty = partial["count"] == 0
            fill = float("nan") if value.is_floating_point() else 0
            out.append(_restored(
                torch.where(empty, torch.full_like(value, fill), value), dt
            ))
        else:
            raise ValueError(f"cannot finalize op {op!r}")
    return tuple(out)


def tree_to_numpy(tree):
    """A partial-table tree of tensors as NumPy arrays on the host."""
    return {
        "rows": tree["rows"].cpu().numpy(),
        "aggs": tuple(
            {k: v.cpu().numpy() for k, v in part.items()}
            for part in tree["aggs"]
        ),
    }


# -- distinct counts and basket expansion -------------------------------------
# Plain torch primitives (sort, cummax, bincount, scatter_reduce_), as the
# JAX package computes them with jnp sort, cummax and segment ops; no Pallas
# kernel stands behind them there.  Out-of-range segment ids are dropped as
# JAX's segment ops drop them (an out-of-range index traps on the card).


def _counts_into(flags, segment, n_groups):
    """int64 per-segment count of ``flags``; segments outside
    ``[0, n_groups)`` are dropped.  A histogram (``bincount``) rather than
    an ``index_add_``: with a few groups, a million adds onto the same few
    slots serialize on the card's atomics."""
    keep = flags & (segment >= 0) & (segment < n_groups)
    return torch.bincount(torch.where(keep, segment, n_groups),
                          minlength=n_groups + 1)[:n_groups]


def groupby_count_distinct(codes, value_codes, n_groups, n_values,
                           mask=None, device=None):
    """Distinct-value count per group by sort + boundary detection.

    ``value_codes`` are dense codes of the measure values (host-factorized).
    Each valid row becomes the int64 composite ``code * n_values +
    value_code`` (-1 for invalid rows), the composites are sorted, and each
    first occurrence of a composite counts one for its group.  Raises
    :class:`~bqueryd_tpu_torch.ops.factorize.CompositeOverflow` when the
    composite space does not fit int64.  Returns int64[n_groups]."""
    from bqueryd_tpu_torch.ops.factorize import (
        MAX_COMPOSITE,
        CompositeOverflow,
        total_cardinality,
    )

    n_groups, n_values = int(n_groups), int(n_values)
    if total_cardinality((n_groups, n_values)) >= MAX_COMPOSITE:
        # a wrapped composite would undercount silently; the engine ships
        # the distinct value sets instead
        raise CompositeOverflow(
            f"count_distinct composite space {n_groups}x{n_values} "
            "exceeds int64"
        )
    dev = _placed(codes, device)
    codes = as_tensor(codes, dev).to(torch.int64)
    value_codes = as_tensor(value_codes, dev).to(torch.int64)
    valid = (codes >= 0) & (value_codes >= 0)
    if mask is not None:
        valid = valid & as_tensor(mask, dev).to(torch.bool)
    composite = torch.where(valid, codes * n_values + value_codes, -1)
    ordered = torch.sort(composite).values
    first = torch.ones_like(ordered, dtype=torch.bool)
    first[1:] = ordered[1:] != ordered[:-1]
    is_new = first & (ordered >= 0)
    group_of = torch.where(is_new, torch.div(ordered, n_values,
                                             rounding_mode="floor"), 0)
    return _counts_into(is_new, group_of, n_groups)


def groupby_sorted_count_distinct(codes, values, n_groups, mask=None,
                                  device=None):
    """bquery's ``sorted_count_distinct``: value *runs* per group, for rows
    pre-sorted by value within each group.  A run boundary is measured
    against the previous *valid* row (an exclusive running max of valid
    row indices), so a masked-out row inside a run neither splits nor
    hides it; ``NaN != NaN`` starts a new run.  Returns int64[n_groups]."""
    n_groups = int(n_groups)
    dev = _placed(codes, device)
    codes = as_tensor(codes, dev).to(torch.int64)
    n = codes.shape[0]
    if n == 0:
        return torch.zeros(n_groups, dtype=torch.int64, device=dev)
    if not torch.is_tensor(values) and np.asarray(values).dtype.kind == "M":
        values = np.asarray(values).view(np.int64)  # compares as its ns
    # uint16/32/64 in a type torch compares on the card, equality intact
    values = _Measure(values, dev).t
    valid = codes >= 0
    if mask is not None:
        valid = valid & as_tensor(mask, dev).to(torch.bool)
    idx = torch.arange(n, device=dev)
    last_valid = torch.cummax(torch.where(valid, idx, -1), 0).values
    prev_idx = torch.cat([last_valid.new_full((1,), -1), last_valid[:-1]])
    gather = torch.clamp(prev_idx, min=0)
    same = (
        (prev_idx >= 0)
        & (codes[gather] == codes)
        & (values[gather] == values)
    )
    return _counts_into(valid & ~same, torch.where(valid, codes, 0), n_groups)


def host_sorted_count_distinct(codes, values, n_groups, mask=None):
    """NumPy version of :func:`groupby_sorted_count_distinct` with the same
    run-boundary semantics (masked-row bridging, ``NaN != NaN``): the op's
    host route (a host-routed or wedged query) and the tests' plain
    reference."""
    codes = np.asarray(codes)
    values = np.asarray(values)
    if codes.shape[0] == 0:
        return np.zeros(int(n_groups), dtype=np.int64)
    valid = codes >= 0
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=bool)
    idx = np.arange(codes.shape[0])
    marked = np.where(valid, idx, -1)
    last_valid = np.maximum.accumulate(marked)
    prev_idx = np.concatenate([[-1], last_valid[:-1]])
    has_prev = prev_idx >= 0
    gather = np.clip(prev_idx, 0, None)
    with np.errstate(invalid="ignore"):
        same = (
            has_prev
            & (codes[gather] == codes)
            & (values[gather] == values)
        )
    is_new_run = valid & ~same
    out = np.zeros(max(int(n_groups), 1), dtype=np.int64)
    np.add.at(out, codes[is_new_run].astype(np.int64), 1)
    return out[: int(n_groups)]


def host_partial_tables(codes, measures, ops, n_groups, mask=None,
                        null_sentinels=None):
    """NumPy :func:`partial_tables`: the same tables, on the host.

    The host route of latency-aware routing: below a row threshold
    (``models.query.host_kernel_rows``) a query's partials cost less on
    the host than the device's dispatch-and-fetch floor, and while the
    device is wedged every query the host can serve runs here.  No torch
    is involved.  Int sums are exact mod 2^64: one float64-weighted
    bincount while every partial stays below 2^53, else four 16-bit limbs,
    or the native striped kernels (``storage.native``), which sum in
    uint64.  Returns ``{"rows": int64[n_groups], "aggs": tuple of partial
    dicts}`` of NumPy arrays."""
    import numpy as np

    codes = np.asarray(codes)
    valid = codes >= 0
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=bool)
    # no null keys and no filter: every np.where masking pass is skipped
    # and the bincounts stay unweighted
    all_valid = bool(valid.all())
    safe = (
        codes.astype(np.int64)
        if all_valid
        else np.where(valid, codes, 0).astype(np.int64)
    )
    minlength = max(int(n_groups), 1)

    # the striped C++ kernels, bounded by a row floor (thread spawn
    # overhead) and a group ceiling (per-thread accumulator memory)
    native_mod = None
    if (
        len(codes) >= _NATIVE_GROUPBY_MIN_ROWS
        and minlength <= _NATIVE_GROUPBY_MAX_GROUPS
    ):
        from bqueryd_tpu_torch.storage import native as _native

        if _native.groupby_available():
            native_mod = _native
    codes32 = base_mask = None
    if native_mod is not None:
        codes32 = np.ascontiguousarray(codes, dtype=np.int32)
        if not all_valid:
            # a bool array's uint8 view keeps the native calls zero-copy
            base_mask = valid.view(np.uint8)

    def count_where(flags):
        if native_mod is not None:
            m = base_mask if flags is None else (
                flags.view(np.uint8) if flags.dtype == np.bool_ else flags
            )
            return native_mod.groupby_i64(codes32, None, m, minlength)[1]
        if flags is None:  # all rows count
            return np.bincount(safe, minlength=minlength).astype(np.int64)
        return np.bincount(
            safe, weights=flags.astype(np.float64), minlength=minlength
        ).astype(np.int64)

    def exact_int_sum(values, present):
        v = values.astype(np.int64, copy=False)
        if present is not None:
            v = np.where(present, v, 0)
        if len(v):
            bound = max(abs(int(v.min())), abs(int(v.max())))
            if bound * len(v) < HOST_EXACT_SUM_BOUND:
                return np.bincount(
                    safe, weights=v.astype(np.float64), minlength=minlength
                ).astype(np.int64)
        # full range: 16-bit limbs keep each weighted bincount exact
        # (< 2^16 x 2^37 rows < 2^53), recombined mod 2^64
        total = np.zeros(minlength, dtype=np.uint64)
        for i in range(4):
            if i < 3:  # unsigned 16-bit slices of the two's complement
                limb = (v >> np.int64(16 * i)) & np.int64(0xFFFF)
            else:      # the top limb keeps the sign (arithmetic shift)
                limb = v >> np.int64(48)
            limb_sum = np.bincount(
                safe, weights=limb.astype(np.float64), minlength=minlength
            )
            total = total + (
                limb_sum.astype(np.int64).astype(np.uint64)
                << np.uint64(16 * i)
            )
        return total.astype(np.int64)

    def null_mask(values, sentinel):
        if sentinel is not None:
            return values == np.asarray(sentinel, dtype=values.dtype)
        if np.issubdtype(values.dtype, np.floating):
            return np.isnan(values)
        return np.zeros(values.shape, dtype=bool)

    rows = count_where(None if all_valid else valid)
    sentinels = _normalize_sentinels(null_sentinels, len(measures))
    # (values id, dtype) -> (values, (mins, maxs, counts)): min and max of
    # one measure share one native pass; the array pins its id()
    minmax_cache = {}
    aggs = []
    for values, op, sentinel in zip(measures, ops, sentinels):
        if op not in MERGEABLE_OPS:
            raise ValueError(
                f"op {op!r} has no mergeable partial; use the dedicated kernel"
            )
        if sentinel is not None and op in ("sum", "mean"):
            raise ValueError(
                f"op {op!r} cannot aggregate a sentinel-null measure"
            )
        values = np.asarray(values)
        if (
            native_mod is not None
            and sentinel is None
            and op in ("min", "max")
            and native_mod.groupby_minmax_available()
            # uint values >= 2^63 would wrap in the signed i64 kernel
            and not np.issubdtype(values.dtype, np.unsignedinteger)
        ):
            cache_key = (id(values), values.dtype.str)
            entry = minmax_cache.get(cache_key)
            if entry is None:
                hit = native_mod.groupby_minmax(
                    codes32, values, base_mask, minlength
                )
                minmax_cache[cache_key] = entry = (values, hit)
            mns, mxs, cnts = entry[1]
            ext64 = mns if op == "min" else mxs
            target = values.dtype
            # empty groups re-filled with the measure dtype's identity
            ext = np.where(
                cnts == 0, extremum_fill(target, op), ext64
            ).astype(target)
            aggs.append({op: ext, "count": cnts})
            continue
        if native_mod is not None and op in ("sum", "mean"):
            # one striped call: the sum and the present count (the mean's
            # denominator); integer MEANS go through the f64 kernel
            if np.issubdtype(values.dtype, np.floating) or op == "mean":
                fsums, fcounts = native_mod.groupby_f64(
                    codes32, np.asarray(values, dtype=np.float64),
                    base_mask, minlength, want_counts=(op == "mean"),
                )
                partial = {"sum": fsums}
                if op == "mean":
                    partial["count"] = fcounts
            else:
                isums, _ = native_mod.groupby_i64(
                    codes32, values.astype(np.int64, copy=False),
                    base_mask, minlength,
                )
                partial = {"sum": isums}
            aggs.append(partial)
            continue
        null = null_mask(values, sentinel)
        has_null = null.any() if (
            sentinel is not None
            or np.issubdtype(values.dtype, np.floating)
        ) else False
        # present=None: every row contributes
        present = None if (all_valid and not has_null) else (valid & ~null)
        if op in ("sum", "mean"):
            if np.issubdtype(values.dtype, np.floating) or op == "mean":
                # integer means accumulate in f64, as pandas does
                contrib = (
                    values if present is None else np.where(present, values, 0)
                ).astype(np.float64)
                partial = {
                    "sum": np.bincount(
                        safe, weights=contrib, minlength=minlength
                    )
                }
            else:
                partial = {"sum": exact_int_sum(values, present)}
            if op == "mean":
                partial["count"] = count_where(present)
            aggs.append(partial)
        elif op == "count":
            aggs.append({"count": count_where(present)})
        elif op == "count_na":
            na = (
                np.zeros(minlength, dtype=np.int64)
                if not has_null
                else count_where(valid & null)
            )
            aggs.append({"count": na})
        elif op in ("min", "max"):
            sel = slice(None) if present is None else present
            ext = np.full(
                minlength, extremum_fill(values.dtype, op),
                dtype=values.dtype,
            )
            if op == "min":
                np.minimum.at(ext, safe[sel], values[sel])
            else:
                np.maximum.at(ext, safe[sel], values[sel])
            aggs.append({op: ext, "count": count_where(present)})
    return {"rows": rows, "aggs": tuple(aggs)}


def host_expand_mask_by_group(group_codes, mask, n_groups=None):
    """NumPy :func:`expand_mask_by_group` with the same edge semantics: a
    code past the segment table is dropped from the hit table and clamped
    in the gather.  Serves the host route and a wedged device."""
    if mask is None:
        return None
    codes = np.asarray(group_codes)
    mask = np.asarray(mask, dtype=bool)
    if n_groups is None:
        n_groups = codes.shape[0]
    n_seg = max(int(n_groups), 1)
    valid = codes >= 0
    hit = np.zeros(n_seg, dtype=bool)
    sel = valid & mask & (codes < n_seg)
    hit[codes[sel]] = True
    gather = np.minimum(np.where(valid, codes, 0), n_seg - 1)
    return valid & hit[gather]


def expand_mask_by_group(group_codes, mask, n_groups=None, device=None):
    """Expand a row mask to whole groups (basket expansion, the reference
    bqueryd's ``is_in_ordered_subgroups`` without requiring sorted input):
    every row whose group holds at least one selected row becomes selected.

    A segment max of ``mask & valid`` over ``program_bucket(n_groups)``
    segments, gathered back to the rows.  Negative codes (null baskets) are
    never selected; a code past the segment table is dropped from the
    scatter and clamped in the gather, as the JAX package's segment max
    and gather do.  ``n_groups`` defaults to the row count.  Returns a bool
    tensor, or None when ``mask`` is None (no filter to expand).  A NumPy
    mask while the device is wedged takes :func:`host_expand_mask_by_group`
    and returns a NumPy array."""
    if mask is None:
        return None
    if not torch.is_tensor(mask):
        from bqueryd_tpu_torch.utils import devicehealth

        if devicehealth.backend_wedged():
            return host_expand_mask_by_group(group_codes, mask, n_groups)
    dev = mask.device if torch.is_tensor(mask) else _placed(group_codes,
                                                            device)
    codes = as_tensor(group_codes, dev).to(torch.int64)
    mask = as_tensor(mask, dev).to(torch.bool)
    if n_groups is None:
        n_groups = codes.shape[0]
    n_seg = max(program_bucket(int(n_groups)), 1)
    valid = codes >= 0
    safe = torch.where(valid, codes, 0)
    inside = safe < n_seg
    hit = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    hit.scatter_reduce_(0, torch.where(inside, safe, 0),
                        (mask & valid & inside).to(torch.int32), "amax")
    return (hit[torch.clamp(safe, max=n_seg - 1)] > 0) & valid

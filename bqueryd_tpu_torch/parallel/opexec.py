"""Operator-DAG executor: per-shard scheduling of the relational operators.

The port of ``bqueryd_tpu/parallel/opexec.py``, the scheduler half of
:mod:`bqueryd_tpu_torch.plan.dag`: a worker hands each CalcMessage's
compiled :class:`~bqueryd_tpu_torch.plan.dag.OperatorDAG` to
:class:`DagExecutor`, which runs the operator pipeline shard by shard on
the engine's device and merges the per-shard partial states on the host,
by key value (:mod:`bqueryd_tpu_torch.parallel.hostmerge`).

Per-shard pipeline::

    chunk prune + mask(pushdown) -> join probe (gather after factorizing
      the join key) -> window rollup (datetime-bucket derived key)
      -> post-derivation filter -> composite key codes
      -> per-node partials: GroupAgg (ops.partial_tables: the one-hot
                                      contraction kernels)
                            TopK (two stable sorts, per-shard top-k)
                            QuantileSketch (DDSketch-style log buckets)
      -> ResultPayload (kind="partials", extended agg part kinds)

Extended partial part kinds (inside ``payload["aggs"][i]``, like the flat
``distinct_values``/``distinct_offsets`` sets):

* ``topk_values`` / ``topk_offsets`` — group ``g``'s best-first top-k
  values are ``topk_values[o[g]:o[g+1]]``; cross-payload merge is a k-way
  re-select over the concatenation (:func:`merge_topk_parts`).
* ``sketch_keys`` / ``sketch_counts`` / ``sketch_offsets`` — group ``g``'s
  occupied sketch buckets (ascending key order) and their counts; the
  cross-payload merge is bucket-count ADDITION (:func:`merge_sketch_parts`).

Sketch layout (DDSketch-style): ``gamma = (1+alpha)/(1-alpha)``; a
positive value ``v`` lands in bucket ``i = ceil(log(v)/log(gamma))``
(clamped to magnitudes in [SKETCH_MIN_MAGNITUDE, SKETCH_MAX_MAGNITUDE]),
carried as the signed key ``i - imin + 1`` (negated for negative values,
0 for zeros/tiny values); the bucket representative ``2*gamma^i/(gamma+1)``
is within relative error ``alpha`` of any value in the bucket.  The
quantile estimate returns the representative of the bucket holding the
LOWER order statistic at rank ``floor(q*(n-1))``, so its relative error vs
the exact ``quantile(..., interpolation='lower')`` is <= alpha inside the
clamped magnitude range.

The merge and finalize helpers are NumPy, and the module imports no torch
at module scope: the client merges with them.  The device twins live in
:mod:`bqueryd_tpu_torch.ops.relops`, imported by the executor.  Every
device call runs on the engine's device (``cuda`` unless the engine was
built with ``device="cpu"``).  A shard at or under
``models.query.host_kernel_rows()``, or any shard while the device is
wedged, runs on the host instead (:meth:`DagExecutor._device_eligible`):
its mask, join probe, partials, top-k and sketch keys are the NumPy twins,
bit-identical to the device route.
"""

import contextlib
import math

import numpy as np

from bqueryd_tpu_torch.models.query import (
    _DENSE_COMBO_CAP,
    MERGEABLE_OPS,
    ResultPayload,
    _group_distinct_flat,
    _segment_local_arange,
    _value_kind_for,
)
from bqueryd_tpu_torch.plan.dag import DagValidationError, parse_op

#: datetime null sentinel (NaT as int64)
NAT_SENTINEL = np.iinfo(np.int64).min

#: sketch magnitude clamp: values below the min collapse into the zero
#: bucket, values above the max into the edge bucket (error bound holds
#: only inside the range — documented in the README)
SKETCH_MIN_MAGNITUDE = 1e-12
SKETCH_MAX_MAGNITUDE = 1e15


# -- sketch math (shared by the host kernels, the device twins and the
# -- client-side merge/finalize) ---------------------------------------------

def sketch_layout(alpha):
    """``(gamma, log_gamma, imin, imax)`` of the fixed bucket layout for a
    given relative accuracy — a pure function of ``alpha``, so every shard
    and worker bins into the SAME buckets and the merge is key-aligned
    addition with no coordination."""
    alpha = float(alpha)
    gamma = (1.0 + alpha) / (1.0 - alpha)
    lg = math.log(gamma)
    imin = math.floor(math.log(SKETCH_MIN_MAGNITUDE) / lg)
    imax = math.ceil(math.log(SKETCH_MAX_MAGNITUDE) / lg)
    return gamma, lg, imin, imax


def sketch_keys_host(values, alpha):
    """Signed bucket key per value (int64; caller excludes NaN/null rows).
    Key 0 = zero/tiny bucket; +/-(i - imin + 1) for positive/negative
    magnitudes in bucket ``i``."""
    _gamma, lg, imin, imax = sketch_layout(alpha)
    return sketch_keys_layout(values, lg, imin, imax)


def sketch_keys_layout(values, log_gamma, imin, imax):
    """:func:`sketch_keys_host` for a layout given by its parameters: the
    host formula that defines the buckets, which the device binning falls
    back to at a bucket edge."""
    v = np.asarray(values, dtype=np.float64)
    mag = np.abs(v)
    tiny = mag < SKETCH_MIN_MAGNITUDE
    with np.errstate(divide="ignore", invalid="ignore"):
        i = np.ceil(np.log(np.where(tiny, 1.0, mag)) / log_gamma)
    i = np.clip(i, imin, imax).astype(np.int64)
    unsigned = i - np.int64(imin) + 1
    return np.where(
        tiny, np.int64(0), np.where(v < 0, -unsigned, unsigned)
    )


def sketch_key_values(keys, alpha):
    """Representative value per signed bucket key (float64)."""
    gamma, _lg, imin, _imax = sketch_layout(alpha)
    keys = np.asarray(keys, dtype=np.int64)
    i = np.abs(keys) - 1 + imin
    mag = 2.0 * np.power(float(gamma), i.astype(np.float64)) / (gamma + 1.0)
    return np.where(keys == 0, 0.0, np.where(keys < 0, -mag, mag))


def sketch_flat(codes, values, n_groups, mask=None, alpha=0.01,
                keys=None):
    """Per-(group, bucket) counts in flat form ``(keys, counts, offsets)``:
    group ``g`` occupies ``keys[o[g]:o[g+1]]`` (ascending) with counts
    aligned.  ``keys=`` lets the device route pass pre-binned keys (the
    jitted elementwise kernel); NaN values are dropped (pandas quantile
    skipna)."""
    codes = np.asarray(codes)
    v = np.asarray(values, dtype=np.float64)
    valid = codes >= 0
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=bool)
    valid = valid & ~np.isnan(v)
    g = codes[valid].astype(np.int64)
    k = (
        sketch_keys_host(v[valid], alpha)
        if keys is None
        else np.asarray(keys, dtype=np.int64)[valid]
    )
    _gamma, _lg, imin, imax = sketch_layout(alpha)
    span = np.int64(2 * (imax - imin + 1) + 1)
    kmin = np.int64(-(imax - imin + 1))
    pair = g * span + (k - kmin)
    uniq, counts = np.unique(pair, return_counts=True)
    g_of = uniq // span
    k_of = uniq % span + kmin
    offsets = np.searchsorted(g_of, np.arange(n_groups + 1)).astype(np.int64)
    return k_of.astype(np.int64), counts.astype(np.int64), offsets


def sketch_grid_layout(alpha):
    """``(width, kmin)`` of the dense signed-bucket grid for one alpha:
    column ``j`` of a ``[groups, width]`` grid holds bucket key
    ``kmin + j`` (negative magnitudes, the zero bucket, positive
    magnitudes).  A pure function of ``alpha``, so every shard group bins
    into the same grid."""
    _gamma, _lg, imin, imax = sketch_layout(alpha)
    half = imax - imin + 1
    return 2 * half + 1, -half


def sketch_grid_to_flat(grid, kmin):
    """Dense ``[groups, width]`` bucket-count grid -> the flat mergeable
    form ``(keys, counts, offsets)``.  Row-major ``nonzero`` yields each
    group's occupied buckets in ascending key order, the layout of
    :func:`sketch_flat` and :func:`merge_sketch_parts`, so a grid converts
    to the very flat part the host route builds (zero cells vanish)."""
    grid = np.asarray(grid)
    g, col = np.nonzero(grid)
    keys = col.astype(np.int64) + np.int64(kmin)
    counts = grid[g, col].astype(np.int64)
    offsets = np.searchsorted(
        g, np.arange(grid.shape[0] + 1)
    ).astype(np.int64)
    return keys, counts, offsets


def merge_sketch_parts(parts, n_global):
    """Bucket-count ADDITION across payloads.  ``parts`` is
    ``[(local_map, keys, counts, offsets), ...]``; returns the merged flat
    ``(keys, counts, offsets)`` over ``n_global`` aligned groups."""
    gid_chunks, key_chunks, cnt_chunks = [], [], []
    for local_map, keys, counts, offsets in parts:
        keys = np.asarray(keys, dtype=np.int64)
        if len(keys) == 0:
            continue
        per_group = np.diff(np.asarray(offsets))
        gid_chunks.append(
            np.repeat(np.asarray(local_map, dtype=np.int64), per_group)
        )
        key_chunks.append(keys)
        cnt_chunks.append(np.asarray(counts, dtype=np.int64))
    if not gid_chunks:
        return (
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.int64),
            np.zeros(n_global + 1, dtype=np.int64),
        )
    gids = np.concatenate(gid_chunks)
    keys = np.concatenate(key_chunks)
    counts = np.concatenate(cnt_chunks)
    kmin = np.int64(keys.min())
    span = np.int64(keys.max()) - kmin + 1
    pair = gids * span + (keys - kmin)
    uniq, inv = np.unique(pair, return_inverse=True)
    summed = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(summed, inv, counts)
    g_of = uniq // span
    k_of = uniq % span + kmin
    offsets = np.searchsorted(g_of, np.arange(n_global + 1)).astype(np.int64)
    return k_of.astype(np.int64), summed, offsets


def sketch_quantiles(keys, counts, offsets, q, alpha):
    """Per-group quantile estimates from a merged flat sketch (float64;
    NaN for empty groups).  Targets the LOWER order statistic at rank
    ``floor(q*(n-1))`` — the comparator the documented <= alpha relative
    error bound is stated against."""
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    n_groups = len(offsets) - 1
    out = np.full(n_groups, np.nan)
    if len(keys) == 0:
        return out
    cc = np.cumsum(counts)
    starts, ends = offsets[:-1], offsets[1:]
    nonempty = ends > starts
    base = np.where(starts > 0, cc[np.maximum(starts, 1) - 1], 0)
    tot = np.where(nonempty, cc[np.maximum(ends, 1) - 1] - base, 0)
    rank = np.floor(float(q) * np.maximum(tot - 1, 0)).astype(np.int64)
    target = base + rank + 1
    j = np.searchsorted(cc, target, side="left")
    j = np.minimum(j, len(keys) - 1)
    vals = sketch_key_values(keys, alpha)
    out[nonempty] = vals[j[nonempty]]
    return out


# -- top-k math ---------------------------------------------------------------

def topk_select(gids, values, k, largest, n_groups):
    """Per-group top-k of (group id, value) pairs, flat form: ``(values,
    offsets)`` with group ``g``'s values BEST-FIRST (descending for
    largest, ascending for smallest).  The same selection serves the
    per-shard partial and the cross-payload k-way re-select, so a merge of
    merges is associative by construction."""
    gids = np.asarray(gids, dtype=np.int64)
    values = np.asarray(values)
    order = np.lexsort((values, gids))
    g = gids[order]
    v = values[order]
    counts = np.bincount(g, minlength=n_groups)
    take = np.minimum(counts, int(k))
    ends = np.cumsum(counts)
    rep = np.repeat(np.arange(n_groups, dtype=np.int64), take)
    loc = _segment_local_arange(take)
    if largest:
        idx = ends[rep] - 1 - loc
    else:
        idx = (ends - counts)[rep] + loc
    offsets = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(take, out=offsets[1:])
    return v[idx], offsets


def topk_flat(codes, values, k, largest, n_groups, mask=None, sentinel=None):
    """Per-shard top-k partial over raw rows: drops null keys, masked
    rows, NaNs, and sentinel nulls (datetime NaT), then selects."""
    codes = np.asarray(codes)
    v = np.asarray(values)
    valid = codes >= 0
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=bool)
    if sentinel is not None:
        valid = valid & (v != np.asarray(sentinel, dtype=v.dtype))
    if np.issubdtype(v.dtype, np.floating):
        valid = valid & ~np.isnan(v)
    return topk_select(
        codes[valid].astype(np.int64), v[valid], k, largest, n_groups
    )


def dense_topk_to_flat(dense, counts):
    """Dense best-first ``[groups, k]`` + per-group counts -> the flat
    mergeable form ``(values, offsets)``: group ``g`` keeps its first
    ``counts[g]`` slots.  The fast path's collect uses it."""
    dense = np.asarray(dense)
    take = np.asarray(counts, dtype=np.int64)
    n = len(take)
    rep = np.repeat(np.arange(n, dtype=np.int64), take)
    loc = _segment_local_arange(take)
    flat = dense[rep, loc] if len(rep) else dense[:0, 0]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(take, out=offsets[1:])
    return flat, offsets


def merge_topk_parts(parts, k, largest, n_global):
    """K-way re-select across payloads: concatenate each group's flat
    top-k lists and re-select the global top-k."""
    gid_chunks, val_chunks = [], []
    for local_map, values, offsets in parts:
        values = np.asarray(values)
        if len(values) == 0:
            continue
        per_group = np.diff(np.asarray(offsets))
        gid_chunks.append(
            np.repeat(np.asarray(local_map, dtype=np.int64), per_group)
        )
        val_chunks.append(values)
    if not gid_chunks:
        return np.empty(0), np.zeros(n_global + 1, dtype=np.int64)
    return topk_select(
        np.concatenate(gid_chunks), np.concatenate(val_chunks),
        k, largest, n_global,
    )


def dim_measure_kind(dtype):
    """``(null_sentinel, value_kind)`` of a join-selected measure column by
    dtype: 'datetime' (NaT sentinel), 'uint64' or 'uint'."""
    dtype = np.dtype(dtype)
    if dtype.kind == "M":
        return NAT_SENTINEL, "datetime"
    if dtype == np.dtype(np.uint64):
        return None, "uint64"
    if dtype.kind == "u":
        return None, "uint"
    return None, None


def gathered_dim_values(dim_column, row_pos):
    """Dimension column broadcast onto fact rows via the probe gather
    (garbage where unmatched: those rows carry null codes and drop from
    every reduction); datetime rides as raw int64 with the NaT sentinel.
    Shared by both DAG routes, like :func:`dim_measure_kind`."""
    v = np.asarray(dim_column)[np.maximum(row_pos, 0)]
    if v.dtype.kind == "M":
        v = v.astype("datetime64[ns]").view(np.int64)
    return v


def filter_flat(values_by_key, offsets, present):
    """Row-filter flat per-group arrays to the ``present`` groups (the
    generic form of ``models.query.filter_distinct_part``, shared by every
    flat part kind)."""
    offsets = np.asarray(offsets)
    counts = np.diff(offsets)
    sel = counts[present]
    starts = offsets[:-1][present]
    idx = np.repeat(starts, sel) + _segment_local_arange(sel)
    new_offsets = np.zeros(len(sel) + 1, dtype=np.int64)
    np.cumsum(sel, out=new_offsets[1:])
    return (
        {key: np.asarray(v)[idx] for key, v in values_by_key.items()},
        new_offsets,
    )


# -- finalize (client-side, via hostmerge.finalize_table) --------------------

def finalize_topk(agg, vkind=None):
    """Flat top-k part -> object array of per-group best-first value
    arrays (datetime measures ride as int64 and re-view here)."""
    values = np.asarray(agg["topk_values"])
    offsets = np.asarray(agg["topk_offsets"])
    if vkind == "datetime":
        values = values.astype(np.int64).view("datetime64[ns]")
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = values[offsets[i]:offsets[i + 1]]
    return out


def finalize_quantile(agg, op):
    """Flat sketch part -> per-group quantile estimates for the op string
    ``quantile:<q>:<alpha>``."""
    parsed = parse_op(op)
    return sketch_quantiles(
        agg["sketch_keys"], agg["sketch_counts"], agg["sketch_offsets"],
        parsed[1], parsed[2],
    )


# -- per-shard execution ------------------------------------------------------

class _ShardState:
    """Resolved derivations of one shard: the join gather positions and
    the window bucket ints, plus memoized value/code views per column."""

    __slots__ = ("table", "dag", "device", "row_pos", "window_ints",
                 "_values", "_codes")

    def __init__(self, table, dag, device):
        self.table = table
        self.dag = dag
        self.device = device      # the engine's device, or None: the host
        self.row_pos = None       # int64[n] dim-row per fact row, -1 = miss
        self.window_ints = None   # int64[n] bucket ns, NAT_SENTINEL = null
        self._values = {}
        self._codes = {}


class DagExecutor:
    """Executes extended operator DAGs per shard and merges host-side.

    Plain DAGs never reach this class: the worker runs them through the
    groupby path (``OperatorDAG.plain_groupby_query``).  The executor
    shares the engine's factorize cache (join keys and fact group keys
    factorize once per shard per column, like any groupby) and its device.
    A device error propagates."""

    def __init__(self, engine):
        self.engine = engine
        self.timer = None
        #: kernel route of the classic GroupAgg partials (or of the rows
        #: count alone), surfaced as effective_strategy
        self.last_effective_strategy = None
        #: "none" (single payload) or "host" (value-keyed cross-shard merge)
        self.last_merge_mode = None
        #: per-shard (decoded, skipped) chunk-prune counts of the last
        #: execute(); the worker folds the totals into its reply
        self._prune_counts = []

    @property
    def device(self):
        return self.engine.device

    def _phase(self, name):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.phase(name)

    # -- public -------------------------------------------------------------
    def execute(self, tables, dag, timer=None):
        """One payload per CalcMessage: the per-shard operator pipelines,
        one after another on the calling thread, then the host value-keyed
        merge across shards."""
        from bqueryd_tpu_torch.parallel import hostmerge

        self.timer = timer
        self.last_effective_strategy = None
        self._prune_counts = []
        payloads = [self.execute_shard(t, dag) for t in tables]
        if len(payloads) == 1:
            self.last_merge_mode = "none"
            return payloads[0]
        self.last_merge_mode = "host"
        with self._phase("hostmerge"):
            merged = hostmerge.merge_payloads(payloads)
        return ResultPayload(merged)

    # -- derivations --------------------------------------------------------
    @staticmethod
    def _device_eligible(n_rows):
        """Whether a shard of ``n_rows`` runs on the device: the device is
        not wedged and the rows clear the host-routing threshold."""
        from bqueryd_tpu_torch.models.query import host_kernel_rows
        from bqueryd_tpu_torch.utils import devicehealth

        return (not devicehealth.backend_wedged()
                and n_rows > host_kernel_rows())

    def _probe_join(self, state, mask):
        """Factorize the fact join key, hash the (small) dimension key
        once, and probe per row as a gather, on the device behind the same
        routing as every kernel."""
        from bqueryd_tpu_torch.ops import relops

        join = state.dag.join
        table = state.table
        if join.on not in table:
            raise DagValidationError(
                f"join key {join.on!r} is not a column of the fact shard"
            )
        codes, uniques = self.engine._key_codes(table, join.on)
        codes = np.asarray(codes)
        uniques = np.asarray(uniques)
        dim_keys = np.asarray(join.table[join.right_on])
        if uniques.dtype == object or dim_keys.dtype == object:
            lookup = {v: i for i, v in enumerate(dim_keys.tolist())}
            pos_of_unique = np.fromiter(
                (lookup.get(v, -1) for v in uniques.tolist()),
                dtype=np.int64, count=len(uniques),
            )
        else:
            order = np.argsort(dim_keys, kind="stable")
            skeys = dim_keys[order]
            at = np.searchsorted(skeys, uniques)
            at = np.minimum(at, len(skeys) - 1)
            hit = skeys[at] == uniques
            pos_of_unique = np.where(hit, order[at], np.int64(-1))
        if len(pos_of_unique) == 0:
            pos_of_unique = np.zeros(1, dtype=np.int64) - 1
        if state.device is not None:
            state.row_pos = relops.gather_positions(
                pos_of_unique, codes, state.device
            )
        else:
            state.row_pos = np.where(
                codes >= 0, pos_of_unique[np.maximum(codes, 0)],
                np.int64(-1),
            )
        matched = state.row_pos >= 0
        return matched if mask is None else (mask & matched)

    def _derive_window(self, state):
        window = state.dag.window
        table = state.table
        if window.column not in table:
            raise DagValidationError(
                f"window column {window.column!r} is not a column of the "
                f"fact shard"
            )
        if table.kind(window.column) != "datetime":
            raise DagValidationError(
                f"window column {window.column!r} is not a datetime column"
            )
        ints = np.asarray(table.column_raw(window.column)).astype(np.int64)
        null = ints == NAT_SENTINEL
        every = np.int64(window.every_ns)
        origin = np.int64(window.origin_ns)
        bucket = (ints - origin) // every * every + origin
        state.window_ints = np.where(null, np.int64(NAT_SENTINEL), bucket)

    # -- column resolution ---------------------------------------------------
    def _is_join_col(self, state, col):
        return state.dag.join is not None and col in state.dag.join.select

    def _is_window_col(self, state, col):
        return state.dag.window is not None and col == state.dag.window.alias

    def _gathered(self, state, col):
        """Dimension column broadcast onto fact rows via the probe gather
        (garbage where unmatched — those rows are masked out)."""
        hit = state._values.get(("join", col))
        if hit is None:
            dim = np.asarray(state.dag.join.table[col])
            pos = np.maximum(state.row_pos, 0)
            hit = dim[pos]
            state._values[("join", col)] = hit
        return hit

    def _measure_values(self, state, col):
        """Raw per-row measure values + null sentinel (datetime NaT)."""
        if self._is_window_col(state, col):
            return state.window_ints, NAT_SENTINEL, "datetime"
        if self._is_join_col(state, col):
            dim = np.asarray(state.dag.join.table[col])
            sentinel, kind = dim_measure_kind(dim.dtype)
            hit = state._values.get(("measure", col))
            if hit is None:
                hit = gathered_dim_values(dim, state.row_pos)
                state._values[("measure", col)] = hit
            return hit, sentinel, kind
        table = state.table
        if col not in table:
            raise DagValidationError(
                f"column {col!r} is not a fact column, a join-selected "
                f"column, or the window alias"
            )
        sentinel = (
            NAT_SENTINEL if table.kind(col) == "datetime" else None
        )
        return (
            np.asarray(table.column_raw(col)),
            sentinel,
            _value_kind_for(table, col),
        )

    def _key_codes_for(self, state, col):
        """``(codes, key_values)`` for one group-key column, any source."""
        hit = state._codes.get(col)
        if hit is not None:
            return hit
        if self._is_window_col(state, col):
            codes, uniq = _factorize_values(
                state.window_ints, null_value=NAT_SENTINEL
            )
            result = (codes, uniq.astype(np.int64).view("datetime64[ns]"))
        elif self._is_join_col(state, col):
            dim = np.asarray(state.dag.join.table[col])
            dcodes, duniq = _factorize_values(dim)
            codes = np.where(
                state.row_pos >= 0,
                dcodes[np.maximum(state.row_pos, 0)],
                np.int64(-1),
            )
            result = (codes, duniq)
        else:
            if col not in state.table:
                raise DagValidationError(
                    f"group key {col!r} is not a fact column, a "
                    f"join-selected column, or the window alias"
                )
            codes, uniq = self.engine._key_codes(state.table, col)
            result = (np.asarray(codes), np.asarray(uniq))
        state._codes[col] = result
        return result

    def _post_filter_values(self, state, col):
        """Per-row values for a post-derivation filter term (actual
        values, not physical codes — derived columns have no table
        dictionary to translate against)."""
        if self._is_window_col(state, col):
            return state.window_ints.view("datetime64[ns]")
        if self._is_join_col(state, col):
            return self._gathered(state, col)
        raise DagValidationError(
            f"post-derivation filter column {col!r} is neither "
            f"join-selected nor the window alias"
        )

    # -- shard execution -----------------------------------------------------
    def execute_shard(self, table, dag):
        from bqueryd_tpu_torch import ops

        for in_col, op, _out in dag.aggs:
            kind = parse_op(op)[0]
            if kind in ("sum", "mean") and (
                in_col in table and table.kind(in_col) == "datetime"
            ):
                raise ValueError(
                    f"{kind!r} is not defined for datetime column {in_col!r}"
                )

        with self._phase("prune"):
            if dag.scan.pushdown:
                if not ops.shard_can_match(table, dag.scan.pushdown):
                    return ResultPayload.empty()
                # chunk-granular zone-map pruning on the PUSHDOWN terms
                # (pre-join fact predicates): joins/top-k/windows only
                # narrow rows further, so a chunk no pushdown row survives
                # contributes nothing to any downstream operator
                table, decoded, skipped = ops.chunk_pruned_table(
                    table, dag.scan.pushdown
                )
                if decoded or skipped:
                    self._prune_counts.append((decoded, skipped))
        # one route per shard, decided before any device call: the mask,
        # the join probe and the aggregate all take it
        state = _ShardState(
            table, dag,
            self.device if self._device_eligible(int(table.nrows)) else None)
        with self._phase("mask"):
            mask = ops.build_mask(table, dag.scan.pushdown, state.device)
            if mask is not None and state.device is not None:
                mask = mask.cpu().numpy()
        if dag.join is not None:
            with self._phase("join"):
                mask = self._probe_join(state, mask)
        if dag.window is not None:
            with self._phase("rollup"):
                self._derive_window(state)
        if dag.filter is not None and dag.filter.terms:
            with self._phase("mask"):
                for col, op, value in dag.filter.terms:
                    m = _eval_post_term(
                        self._post_filter_values(state, col), op, value
                    )
                    mask = m if mask is None else (mask & m)

        with self._phase("factorize"):
            per_key = [self._key_codes_for(state, c) for c in dag.group_keys]
            key_values = [v for _, v in per_key]
            dense, combo_cols, n_groups = _composite_codes(
                [np.asarray(c) for c, _ in per_key],
                [len(v) for v in key_values],
            )

        with self._phase("aggregate"):
            rows, agg_parts = self._aggregate(state, dense, n_groups, mask)

        with self._phase("collect"):
            present = rows > 0
            combos_present = np.flatnonzero(present)
            keys = {}
            for ci, (col, values) in enumerate(
                zip(dag.group_keys, key_values)
            ):
                idx = combo_cols[combos_present, ci]
                keys[col] = np.asarray(values)[idx]
            aggs = []
            for part in agg_parts:
                if "topk_offsets" in part:
                    vals, offs = filter_flat(
                        {"topk_values": part["topk_values"]},
                        part["topk_offsets"], present,
                    )
                    aggs.append({**vals, "topk_offsets": offs})
                elif "sketch_offsets" in part:
                    vals, offs = filter_flat(
                        {
                            "sketch_keys": part["sketch_keys"],
                            "sketch_counts": part["sketch_counts"],
                        },
                        part["sketch_offsets"], present,
                    )
                    aggs.append({**vals, "sketch_offsets": offs})
                elif "distinct_offsets" in part:
                    from bqueryd_tpu_torch.models.query import (
                        filter_distinct_part,
                    )

                    aggs.append(filter_distinct_part(part, present))
                else:
                    aggs.append({k: v[present] for k, v in part.items()})
            return ResultPayload.partials(
                key_cols=list(dag.group_keys),
                keys=keys,
                rows=np.asarray(rows)[present],
                aggs=aggs,
                ops=[a[1] for a in dag.aggs],
                out_cols=[a[2] for a in dag.aggs],
                value_kinds=self._value_kinds(state, dag),
            )

    def _value_kinds(self, state, dag):
        kinds = []
        for in_col, op, _out in dag.aggs:
            _v, _sentinel, kind = self._measure_values(state, in_col)
            parsed = parse_op(op)
            if parsed[0] == "quantile":
                kinds.append(None)  # sketches estimate in float64
            else:
                kinds.append(kind)
        return kinds

    def _aggregate(self, state, dense, n_groups, mask):
        """Per-node partial states: the classic GroupAgg through
        ``ops.partial_tables`` (the one-hot contraction kernels, routed as
        for a groupby); with no mergeable agg, the per-group row count
        alone through the same call; TopK and QuantileSketch through their
        twins in :mod:`bqueryd_tpu_torch.ops.relops`.  A shard that is not
        device-eligible takes the NumPy twins (``ops.host_partial_tables``,
        :func:`topk_flat`, the host sketch keys) and reports "host"."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.ops import relops
        from bqueryd_tpu_torch.ops.groupby import as_tensor

        dag = state.dag
        agg_parts = [None] * len(dag.aggs)
        device = state.device

        mergeable, resolved = [], {}
        for i, (in_col, op, _out) in enumerate(dag.aggs):
            parsed = parse_op(op)
            values, sentinel, _kind = self._measure_values(state, in_col)
            resolved[i] = (values, sentinel)
            if parsed[0] in MERGEABLE_OPS:
                mergeable.append((i, parsed[0]))

        measures = tuple(np.asarray(resolved[i][0]) for i, _ in mergeable)
        mops = tuple(op for _, op in mergeable)
        sentinels = tuple(resolved[i][1] for i, _ in mergeable)
        if device is None:
            self.last_effective_strategy = "host"
            partials = ops.host_partial_tables(
                dense.astype(np.int32), measures, mops, n_groups, mask,
                null_sentinels=sentinels,
            )
        else:
            # the bucketed group count keeps padded groups zero-row; they
            # are sliced off after the fetch
            n_prog = ops.program_bucket(n_groups)
            codes = as_tensor(dense.astype(np.int32), device)
            self.last_effective_strategy = ops.kernel_route(
                None, measures, mops, len(dense), n_prog
            )
            partials = ops.tree_to_numpy(ops.partial_tables(
                codes, measures, mops, n_prog, mask,
                null_sentinels=sentinels,
            ))
        rows = partials["rows"][:n_groups]
        for (i, _op), part in zip(mergeable, partials["aggs"]):
            agg_parts[i] = {k: v[:n_groups] for k, v in part.items()}

        for i, (in_col, op, _out) in enumerate(dag.aggs):
            parsed = parse_op(op)
            values, sentinel = resolved[i]
            if parsed[0] == "topk":
                _k, largest = parsed[1], parsed[2]
                v = np.asarray(values)
                if v.dtype == object or (
                    in_col in state.table
                    and state.table.kind(in_col) == "dict"
                ):
                    # dict columns surface as unordered dictionary CODES
                    # here — a top-k over them would rank ingestion order
                    raise DagValidationError(
                        f"topk measure {in_col!r} must be numeric or "
                        f"datetime, not strings"
                    )
                if device is None:
                    tvals, toffs = topk_flat(
                        dense, v, parsed[1], largest, n_groups,
                        mask=mask, sentinel=sentinel,
                    )
                else:
                    tvals, toffs = relops.topk_partials(
                        dense, v, parsed[1], largest, n_groups,
                        mask=mask, sentinel=sentinel, device=device,
                    )
                agg_parts[i] = {
                    "topk_values": tvals, "topk_offsets": toffs
                }
            elif parsed[0] == "quantile":
                _q, alpha = parsed[1], parsed[2]
                v = np.asarray(values)
                if (
                    v.dtype == object
                    or sentinel is not None
                    or (
                        in_col in state.table
                        and state.table.kind(in_col) == "dict"
                    )
                ):
                    raise DagValidationError(
                        f"quantile measure {in_col!r} must be numeric "
                        f"(strings/datetimes have no sketch ordering)"
                    )
                keys = (None if device is None
                        else relops.sketch_bin(v, alpha, device))
                skeys, scounts, soffs = sketch_flat(
                    dense, v, n_groups, mask=mask, alpha=alpha, keys=keys
                )
                agg_parts[i] = {
                    "sketch_keys": skeys,
                    "sketch_counts": scounts,
                    "sketch_offsets": soffs,
                }
            elif parsed[0] == "count_distinct":
                vcodes, vuniques = self._key_codes_for(state, in_col)
                dvalues, doffsets = _group_distinct_flat(
                    np.asarray(dense), np.asarray(vcodes),
                    np.asarray(vuniques), n_groups, mask,
                )
                agg_parts[i] = {
                    "distinct_values": dvalues,
                    "distinct_offsets": doffsets,
                }
            elif agg_parts[i] is None:
                raise DagValidationError(f"unsupported DAG op {op!r}")
        return rows, agg_parts


def _composite_codes(code_arrays, cards):
    """Dense group codes of the key tuple: ``(dense, combo_cols,
    n_groups)``, ``combo_cols[g]`` being group ``g``'s per-key codes and
    -1 a row with a null key.  Groups are in ascending lexicographic order
    of their key codes, so that after the collect drops the groups without
    rows, the payload is the one a ``np.unique`` over the key tuples
    gives: one key keeps its codes, a small composite space packs, a
    larger one factorizes the tuples."""
    from bqueryd_tpu_torch import ops

    if len(code_arrays) == 1:
        n_groups = max(cards[0], 1)
        combo_cols = np.arange(n_groups, dtype=np.int64)[:, None]
        return code_arrays[0].astype(np.int64), combo_cols, n_groups
    total = ops.total_cardinality(cards)
    if total == 0:  # a key without values: every row has a null key
        return (np.full(len(code_arrays[0]), np.int64(-1)),
                np.zeros((1, len(cards)), dtype=np.int64), 1)
    if total <= _DENSE_COMBO_CAP:
        dense = ops.pack_codes(code_arrays, cards)
        n_groups = max(total, 1)
        combo_cols = np.stack(
            ops.unpack_codes(np.arange(n_groups, dtype=np.int64), cards),
            axis=1,
        ).astype(np.int64)
        return np.asarray(dense, dtype=np.int64), combo_cols, n_groups
    stacked = np.stack([c.astype(np.int64) for c in code_arrays], axis=1)
    valid = (stacked >= 0).all(axis=1)
    view = np.ascontiguousarray(stacked[valid]).view(
        [("", np.int64)] * stacked.shape[1]
    ).ravel()
    uniq, inv = np.unique(view, return_inverse=True)
    dense = np.full(len(stacked), np.int64(-1))
    dense[valid] = inv
    combo_cols = uniq.view(np.int64).reshape(len(uniq), stacked.shape[1])
    return dense, combo_cols, max(len(uniq), 1)


# -- helpers ------------------------------------------------------------------

def _factorize_values(arr, null_value=None):
    """First-class-value factorize with pandas-style null poisoning:
    ``(codes[-1 for null], uniques)``.  Handles object arrays (None/NaN
    nulls), float NaN, datetime64 NaT, and an explicit int sentinel."""
    arr = np.asarray(arr)
    if arr.dtype == object:
        null = np.fromiter(
            (
                v is None or (isinstance(v, float) and math.isnan(v))
                for v in arr.tolist()
            ),
            dtype=bool, count=len(arr),
        )
    elif arr.dtype.kind == "f":
        null = np.isnan(arr)
    elif arr.dtype.kind == "M":
        null = np.isnat(arr)
    elif null_value is not None:
        null = arr == null_value
    else:
        null = None
    if null is not None and null.any():
        work = arr[~null]
        uniq, inv = np.unique(work, return_inverse=True)
        codes = np.full(len(arr), np.int64(-1))
        codes[~null] = inv.astype(np.int64)
        return codes, uniq
    uniq, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int64), uniq


def _eval_post_term(values, op, value):
    """NumPy twin of ops.predicates.term_mask for derived columns (actual
    values; datetime comparisons coerce via numpy)."""
    values = np.asarray(values)
    if values.dtype.kind == "M" and not isinstance(value, np.datetime64):
        if isinstance(value, (list, tuple, set, frozenset)):
            value = [np.datetime64(v, "ns") for v in value]
        else:
            value = np.datetime64(value, "ns")
    if op == "==":
        return values == value
    if op == "!=":
        return values != value
    if op == "<":
        return values < value
    if op == "<=":
        return values <= value
    if op == ">":
        return values > value
    if op == ">=":
        return values >= value
    if op in ("in", "not in"):
        if values.dtype == object:
            members = set(value)
            hit = np.fromiter(
                (v in members for v in values.tolist()),
                dtype=bool, count=len(values),
            )
        else:
            hit = np.isin(values, np.asarray(list(value)))
        return hit if op == "in" else ~hit
    raise DagValidationError(f"unsupported where op {op!r}")

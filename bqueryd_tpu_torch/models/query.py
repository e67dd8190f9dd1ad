"""Query model + local execution engine of the port.

A groupby query (``(filename, groupby_col_list, agg_list,
where_terms_list)`` with ``aggregate``) runs per shard as

    storage decode -> host factorize -> H2D -> where-mask -> partial
    tables (one-hot contraction kernels) -> D2H -> collect by key value

Results travel as :class:`ResultPayload`, the same pickled dict and
``PAYLOAD_FORMAT`` as ``bqueryd_tpu``, so payloads of either package merge
with the other's host merge:

* ``kind="partials"``: per-group partial tables keyed by actual key values;
  mean partials carry (sum, count); ``count_distinct`` partials carry each
  group's distinct value set (or, for a sole payload, final counts from the
  device sort); ``sorted_count_distinct`` carries run counts;
* ``kind="rows"``: the ``aggregate=False`` raw-rows path;
* ``kind="empty"``: shard pruned by ``shard_can_match``.

The engine serves every op of :data:`AGG_OPS` and basket expansion
(``expand_filter_column``).  Latency-aware routing decides per shard,
before any device call: a shard at or under :func:`host_kernel_rows` (the
row count whose host cost matches the device's measured
dispatch-and-fetch floor, :func:`device_dispatch_floor`), a ``"host"``
hint, or a wedged device (:mod:`bqueryd_tpu_torch.utils.devicehealth`)
runs the mergeable partials on the host (``ops.host_partial_tables``:
NumPy and the native striped kernels), with its mask, basket expansion
and distinct counts on the host too.  Routing is not a fallback: a query
that fails on the device fails, with no retry on the host.
"""

import os
import pickle
import time
from dataclasses import dataclass, field

import numpy as np

from bqueryd_tpu_torch.utils import devicehealth

PAYLOAD_FORMAT = "bqueryd-tpu-result-1"

#: the bquery aggregation surface plus min/max
AGG_OPS = (
    "sum",
    "mean",
    "count",
    "count_na",
    "count_distinct",
    "sorted_count_distinct",
    "min",
    "max",
)

#: ops whose partials merge with elementwise +/min/max
MERGEABLE_OPS = ("sum", "mean", "count", "count_na", "min", "max")

#: multi-key composite spaces at most this large aggregate directly over the
#: full (K1*...*Kn)-slot space instead of paying an O(n) compaction pass
_DENSE_COMBO_CAP = 1 << 16


def extremum_fill(dtype, kind):
    """Identity fill for per-group ``min``/``max`` partials of ``dtype``:
    'min' fills with the dtype's maximum so any real value wins (and vice
    versa); bool uses its and/or identities, floats +/-inf."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.inf if kind == "min" else -np.inf
    if dtype == np.bool_:
        return kind == "min"
    info = np.iinfo(dtype)
    return info.max if kind == "min" else info.min


def normalize_agg_list(agg_list):
    """Agg shorthand normalization: ``"col"`` -> ``[col, 'sum', col]``;
    2-item ``[in, op]`` -> ``[in, op, in]``."""
    normalized = []
    for agg in agg_list:
        if isinstance(agg, str):
            normalized.append([agg, "sum", agg])
        elif len(agg) == 2:
            agg = list(agg)
            normalized.append([agg[0], agg[1], agg[0]])
        else:
            normalized.append(list(agg))
    return normalized


def freeze_value(value):
    """Canonical, hashable, collision-free form of a query parameter
    (repr() is ambiguous for numpy arrays, which truncate their repr)."""
    import hashlib

    if isinstance(value, np.ndarray):
        if value.dtype == object:
            # tobytes() of an object array is its pointers: freeze the
            # contained values instead
            return ("ndarray-obj", value.shape,
                    tuple(freeze_value(v) for v in value.ravel().tolist()))
        return ("ndarray", value.dtype.str, value.shape,
                hashlib.sha1(value.tobytes()).hexdigest())
    if isinstance(value, (list, tuple)):
        return ("seq", tuple(freeze_value(v) for v in value))
    if isinstance(value, (set, frozenset)):
        return ("set", tuple(sorted((freeze_value(v) for v in value),
                                    key=repr)))
    if isinstance(value, np.generic):
        return value.item()
    return value


@dataclass
class GroupByQuery:
    groupby_cols: list
    agg_list: list          # [[in_col, op, out_col], ...]
    where_terms: list = field(default_factory=list)
    aggregate: bool = True
    expand_filter_column: str = None
    #: set by the controller when this payload is the whole query (a
    #: single-shard fan-out): count_distinct then ships final per-group
    #: counts from the device sort instead of the value sets a cross-shard
    #: union needs
    sole_payload: bool = False

    def signature(self):
        """Hashable identity of the query (cache key component)."""
        return (
            tuple(self.groupby_cols),
            freeze_value(self.agg_list),
            freeze_value(self.where_terms or []),
            bool(self.aggregate),
            self.expand_filter_column,
            bool(self.sole_payload),
        )

    def __post_init__(self):
        self.agg_list = normalize_agg_list(self.agg_list)

    @property
    def in_cols(self):
        return [a[0] for a in self.agg_list]

    @property
    def ops(self):
        return tuple(a[1] for a in self.agg_list)

    @property
    def out_cols(self):
        return [a[2] for a in self.agg_list]


def _group_distinct_flat(group_codes, value_codes, value_uniques, n_groups,
                         mask=None):
    """Per-group distinct values in flat form: ``(values, offsets)``, group
    ``g``'s values being ``values[offsets[g]:offsets[g+1]]``: one array and
    one int64 offsets array, cheap to pickle and unioned across payloads
    without per-group Python.  Null group keys, null values (code < 0, as
    pandas ``nunique`` skips NaN) and masked-out rows contribute nothing."""
    valid = (group_codes >= 0) & (value_codes >= 0)
    if mask is not None:
        valid &= mask
    nv = max(len(value_uniques), 1)
    pairs = np.unique(
        group_codes[valid].astype(np.int64) * nv + value_codes[valid]
    )
    g_of = pairs // nv
    v_of = pairs % nv
    offsets = np.searchsorted(g_of, np.arange(n_groups + 1)).astype(np.int64)
    return np.asarray(value_uniques)[v_of], offsets


def _segment_local_arange(counts):
    """[0..c0), [0..c1), ... concatenated: the index within each segment."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def filter_distinct_part(part, present):
    """A flat distinct part restricted to the ``present`` groups."""
    values = part["distinct_values"]
    offsets = part["distinct_offsets"]
    counts = np.diff(offsets)
    sel = counts[present]
    starts = offsets[:-1][present]
    idx = np.repeat(starts, sel) + _segment_local_arange(sel)
    new_offsets = np.zeros(len(sel) + 1, dtype=np.int64)
    np.cumsum(sel, out=new_offsets[1:])
    return {"distinct_values": values[idx], "distinct_offsets": new_offsets}


class ResultPayload(dict):
    """Wire form of a shard/worker result; a plain dict for pickling."""

    @classmethod
    def empty(cls):
        return cls(format=PAYLOAD_FORMAT, kind="empty")

    @classmethod
    def rows(cls, columns, order):
        return cls(format=PAYLOAD_FORMAT, kind="rows", columns=columns,
                   order=order)

    @classmethod
    def partials(cls, key_cols, keys, rows, aggs, ops, out_cols,
                 value_kinds=None):
        return cls(
            format=PAYLOAD_FORMAT,
            kind="partials",
            key_cols=list(key_cols),
            keys=keys,        # {col: np.ndarray[G] of key values}
            rows=rows,        # np.int64[G]
            aggs=aggs,        # list of {partname: np.ndarray[G]}
            ops=list(ops),
            out_cols=list(out_cols),
            # storage kind per agg (None | 'datetime' | 'uint64' | 'uint')
            value_kinds=(
                [None] * len(list(out_cols))
                if value_kinds is None
                else list(value_kinds)
            ),
        )

    def to_bytes(self):
        return pickle.dumps(dict(self), protocol=4)

    @classmethod
    def from_bytes(cls, buf):
        if not buf:
            return cls.empty()
        obj = pickle.loads(buf)
        if obj.get("format") != PAYLOAD_FORMAT:
            raise ValueError("unknown result payload format")
        return cls(obj)


_measured_floor = None


def device_dispatch_floor(remeasure=False, device=None):
    """Measured wall of one tiny op plus a synchronising fetch on
    ``device`` (default: the device :func:`devicehealth.watch` registered,
    else the CPU): the minimum of 3 after one warm call, cached per
    process.  The fetch is included because the device query path ends in
    one; this is the cost host routing competes against.

    A sample taken while another thread holds the device (a kernel build,
    the CUDA context's creation) is inflated: the worker calls
    ``remeasure=True`` once its kernels are loaded and its context made.
    The measurement runs under :func:`devicehealth.run_with_deadline`: a
    deadline miss latches the device as wedged instead of hanging the
    caller, and the garbage floor is not cached."""
    global _measured_floor
    if devicehealth.backend_wedged():
        # not cached: a recovered device must remeasure a real floor
        return devicehealth.probe_timeout_s()
    if _measured_floor is None or remeasure:
        dev = device if device is not None else devicehealth.watched_device()

        def _measure():
            import torch

            x = torch.zeros((), device=dev if dev is not None else "cpu")
            (x + 1).item()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                (x + 1).item()
                walls.append(time.perf_counter() - t0)
            return min(walls)

        timeout = devicehealth.probe_timeout_s()
        if timeout <= 0:  # detection disabled: measure directly
            _measured_floor = _measure()
            return _measured_floor
        done, floor = devicehealth.run_with_deadline(_measure, timeout)
        if not done or floor is None:
            devicehealth.latch_wedged()
            return devicehealth.probe_timeout_s()
        _measured_floor = floor
    return _measured_floor


#: assumed host aggregation cost per row on the fast paths (cached codes,
#: one bincount or one native pass), used only to turn the measured
#: dispatch floor into a row threshold
_HOST_NS_PER_ROW = 8e-9

#: the cost when a measure misses the fast paths: the 16-bit-limb exact int
#: sum (4 weighted bincounts) or np.minimum/maximum.at extrema run about 4x
#: the fast rate, so near-threshold queries are not host-routed on the
#: optimistic estimate
_HOST_NS_PER_ROW_SLOW = 32e-9


def _host_ns_estimate(table, agg_list, n_rows):
    """Per-row host cost of ``agg_list`` for routing, from column metadata
    only (physical dtype and min/max stats, no decode): integer sums whose
    ``n x max|value|`` bound stays under 2^53, or that the native kernels
    take, run at the fast rate; larger-magnitude (or stats-less) int sums
    and min/max outside the native kernels at the slow rate."""
    from bqueryd_tpu_torch.ops.groupby import (
        _NATIVE_GROUPBY_MIN_ROWS,
        HOST_EXACT_SUM_BOUND,
    )

    native_ok = None  # computed lazily: import + symbol probe

    def native_takes_it():
        # the C++ kernels sum in uint64 (exact at any magnitude) and do
        # min/max in one pass: a query they take has no slow fallback
        nonlocal native_ok
        if native_ok is None:
            from bqueryd_tpu_torch.storage import native

            native_ok = (
                n_rows >= _NATIVE_GROUPBY_MIN_ROWS
                and native.groupby_available()
            )
        return native_ok

    minmax_ok = None

    def native_minmax_ok():
        nonlocal minmax_ok
        if minmax_ok is None:
            from bqueryd_tpu_torch.storage import native

            minmax_ok = native.groupby_minmax_available()
        return minmax_ok

    for in_col, op, _out in agg_list:
        if op in ("min", "max"):
            # the min/max kernel declines unsigned dtypes (uint64 would
            # wrap its signed accumulator): those run ufunc.at
            if (
                table.kind(in_col) == "datetime"
                or not native_takes_it()
                or not native_minmax_ok()
                or np.issubdtype(
                    table.physical_dtype(in_col), np.unsignedinteger
                )
            ):
                return _HOST_NS_PER_ROW_SLOW
            continue
        if op in ("sum", "mean") and np.issubdtype(
            table.physical_dtype(in_col), np.integer
        ):
            if native_takes_it():
                continue
            stats = table.col_stats(in_col)
            if stats is None:
                return _HOST_NS_PER_ROW_SLOW
            bound = max(abs(int(stats[0])), abs(int(stats[1])))
            if bound * max(int(n_rows), 1) >= HOST_EXACT_SUM_BOUND:
                return _HOST_NS_PER_ROW_SLOW
    return _HOST_NS_PER_ROW


#: never host-route a query above this many rows, however slow the device
#: link: large queries belong on the device
_HOST_ROUTE_CAP = 4_000_000


def host_kernel_rows(ns_per_row=None):
    """Row threshold at or below which mergeable aggregations run on the
    host (:func:`ops.host_partial_tables`) instead of paying the device's
    dispatch-and-fetch floor: ``floor / ns_per_row``, capped at
    :data:`_HOST_ROUTE_CAP`.  ``ns_per_row`` is a per-query estimate
    (:func:`_host_ns_estimate`), the fast rate by default.
    ``BQUERYD_TPU_HOST_KERNEL_ROWS`` overrides it (0: never host-route).
    A wedged device returns 2^62 whatever the override: every query the
    host can serve goes there."""
    if devicehealth.backend_wedged(launch=False):
        return 1 << 62
    env = os.environ.get("BQUERYD_TPU_HOST_KERNEL_ROWS")
    if env is not None:
        try:
            return max(int(env), 0)
        except ValueError:
            import logging

            logging.getLogger("bqueryd_tpu_torch").warning(
                "unparseable BQUERYD_TPU_HOST_KERNEL_ROWS=%r, "
                "host routing disabled", env,
            )
            return 0
    ns = _HOST_NS_PER_ROW if ns_per_row is None else ns_per_row
    return min(int(device_dispatch_floor() / ns), _HOST_ROUTE_CAP)


def _value_kind_for(table, col):
    """Storage-kind tag carried per agg in the payload: 'datetime' restores
    datetime64 at finalize; 'uint64' re-views mod-2^64 sums as unsigned;
    'uint' marks narrower unsigned storage for the cross-shard merge."""
    if table.kind(col) == "datetime":
        return "datetime"
    dt = table.physical_dtype(col)
    if dt == np.dtype(np.uint64):
        return "uint64"
    if dt.kind == "u":
        return "uint"
    return None


class QueryEngine:
    """Executes queries against local ctable shards on one torch device
    (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, device=None):
        from bqueryd_tpu_torch import resolve_device
        from bqueryd_tpu_torch.utils.cache import BytesCappedCache

        self.device = resolve_device(device)
        # the device-health probes run on this engine's device
        devicehealth.watch(self.device)
        #: the kernel route of the last execute_local ("matmul", "scatter",
        #: "sort", or "host" for the host route)
        self.last_effective_strategy = None
        # per-(table, column) factorization cache, keyed on the shard's
        # meta identity so activation invalidates naturally
        self._factorize_cache = BytesCappedCache(
            int(
                os.environ.get(
                    "BQUERYD_TPU_FACTORIZE_CACHE_BYTES", 256 * 1024**2
                )
            )
        )

    def clear_caches(self):
        self._factorize_cache.clear()

    # -- key handling ------------------------------------------------------
    def _key_codes(self, table, col):
        """Physical dense codes + key-value array for one groupby column."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.storage.ctable import table_cache_key

        kind = table.kind(col)
        if kind == "dict":
            codes = table.column_raw(col)
            values = np.asarray(table.dictionary(col), dtype=object)
            return codes, values
        cache_key = (table_cache_key(table), col)
        hit = self._factorize_cache.get(cache_key)
        if hit is not None:
            return hit
        loader = getattr(table, "factor_cache_load", None)
        if loader is not None:
            disk = loader(col)
            if disk is not None:
                codes, uniques = disk
                if kind == "datetime" and uniques.dtype.kind != "M":
                    uniques = uniques.view("datetime64[ns]")
                self._factorize_cache.put(
                    cache_key, (codes, uniques),
                    nbytes=codes.nbytes + uniques.nbytes,
                )
                return codes, uniques
        # stamp BEFORE the read: a shard rewritten mid-factorize leaves a
        # stale sidecar (future miss), never a poisoned one
        stamper = getattr(table, "factor_stamp", None)
        stamp = stamper(col) if stamper is not None else None
        codes, uniques = ops.factorize(table.column_raw(col))
        if kind == "datetime":
            uniques = uniques.view("datetime64[ns]")
        # NaN/NaT uniques are nulls, not values: poison their codes to -1
        null_at = None
        if kind == "datetime":
            null_at = np.flatnonzero(np.isnat(uniques))
        elif np.issubdtype(np.asarray(uniques).dtype, np.floating):
            null_at = np.flatnonzero(np.isnan(uniques))
        if null_at is not None and len(null_at):
            codes = np.where(np.isin(codes, null_at), np.int64(-1), codes)
        storer = getattr(table, "factor_cache_store", None)
        if storer is not None and stamp is not None:
            storer(col, codes, uniques, stamp=stamp)
        self._factorize_cache.put(
            cache_key, (codes, uniques), nbytes=codes.nbytes + uniques.nbytes
        )
        return codes, uniques

    def _basket_codes(self, table, col):
        """Basket codes for ``expand_filter_column``, cached like
        :meth:`_key_codes` but factorized over the PHYSICAL column, so that
        dict-encoded nulls (code -1) form one ordinary, selectable basket:
        the basket key is a plain value column, as in the reference
        bqueryd's ``is_in_ordered_subgroups``, which knows no nulls."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.storage.ctable import table_cache_key

        cache_key = (table_cache_key(table), col, "basket")
        hit = self._factorize_cache.get(cache_key)
        if hit is not None:
            return hit
        codes, uniques = ops.factorize(np.asarray(table.column_raw(col)))
        self._factorize_cache.put(
            cache_key, (codes, uniques), nbytes=codes.nbytes + uniques.nbytes
        )
        return codes, uniques

    def _group_codes(self, table, groupby_cols):
        """Dense group codes of the key tuple, the per-group combos and how
        to decode them: ``(dense, combos, n_groups, cards, key_values,
        combo_cols)``."""
        from bqueryd_tpu_torch import ops

        per_key = [self._key_codes(table, c) for c in groupby_cols]
        code_arrays = [np.asarray(c) for c, _ in per_key]
        key_values = [v for _, v in per_key]
        cards = [len(v) for v in key_values]
        combo_cols = None  # set by the CompositeOverflow fallback only
        # null keys (code -1) stay -1: every kernel drops negative codes
        if len(code_arrays) == 1:
            dense = code_arrays[0]
            combos = np.arange(cards[0], dtype=np.int64)
            n_groups = max(cards[0], 1)
        elif ops.total_cardinality(cards) >= ops.MAX_COMPOSITE:
            # radix packing would wrap: factorize the key TUPLES instead
            stacked = np.stack(
                [np.asarray(c, dtype=np.int64) for c in code_arrays], axis=1
            )
            valid = (stacked >= 0).all(axis=1)
            view = np.ascontiguousarray(stacked[valid]).view(
                [("", np.int64)] * stacked.shape[1]
            ).ravel()
            uniq, inv = np.unique(view, return_inverse=True)
            dense = np.full(len(stacked), np.int64(-1))
            dense[valid] = inv
            combo_cols = uniq.view(np.int64).reshape(
                len(uniq), stacked.shape[1]
            )
            combos = np.arange(len(uniq), dtype=np.int64)
            n_groups = max(len(uniq), 1)
        else:
            packed = ops.pack_codes(code_arrays, cards)
            total_card = ops.total_cardinality(cards)
            if total_card <= _DENSE_COMBO_CAP:
                # small composite space: aggregate over it directly; empty
                # combos drop at collect via rows == 0
                dense = packed
                combos = np.arange(total_card, dtype=np.int64)
                n_groups = max(total_card, 1)
            else:
                # compact the sparse composite space, then evict the null
                # composite (-1) so it stays invalid downstream
                dense, combos = ops.factorize(packed)
                null_at = np.flatnonzero(combos == -1)
                if len(null_at):
                    j = int(null_at[0])
                    remap = np.empty(len(combos), dtype=np.int64)
                    remap[:j] = np.arange(j)
                    remap[j] = -1
                    remap[j + 1:] = np.arange(j, len(combos) - 1)
                    dense = remap[dense]
                    combos = np.delete(combos, j)
                n_groups = max(len(combos), 1)
        return dense, combos, n_groups, cards, key_values, combo_cols

    # -- execution ---------------------------------------------------------
    def _host_routed(self, table, query, strategy):
        """Whether this shard's mergeable partials run on the host: the
        ``"host"`` hint, or a row count at or under the threshold for the
        query's own host cost (a wedged device raises it to 2^62)."""
        if strategy == "host":
            return True
        mergeable = [a for a in query.agg_list if a[1] in MERGEABLE_OPS]
        if not query.aggregate or not mergeable:
            return False
        n = int(table.nrows)
        return n <= host_kernel_rows(_host_ns_estimate(table, mergeable, n))

    def execute_local(self, table, query: GroupByQuery,
                      strategy=None) -> ResultPayload:
        """Run one query on one shard.  ``strategy`` is the planner's
        kernel-route hint: ``"host"`` forces the host kernels, "matmul",
        "scatter", "sort" and "matmul!" flow into :func:`ops.partial_tables`
        (see ``ops.KERNEL_STRATEGIES``), None or "auto" keeps the adaptive
        default.  The route is decided before any device call: on the host
        route (the hint, a shard under :func:`host_kernel_rows`) or with the
        device wedged, the mask, basket expansion, partials and distinct
        counts all run in NumPy and nothing touches the device."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.ops.groupby import as_tensor

        self.last_effective_strategy = None
        if strategy not in (None, "auto", "host", "matmul", "scatter",
                            "sort", "matmul!"):
            raise ValueError(f"unknown kernel strategy {strategy!r}")
        if query.aggregate:
            for in_col, op in zip(query.in_cols, query.ops):
                if op in ("sum", "mean") and table.kind(in_col) == "datetime":
                    raise ValueError(
                        f"{op!r} is not defined for datetime "
                        f"column {in_col!r}"
                    )

        if query.where_terms and not ops.shard_can_match(
            table, query.where_terms
        ):
            return ResultPayload.empty()
        wedged = devicehealth.backend_wedged()
        host_route = self._host_routed(table, query, strategy)
        on_host = host_route or wedged
        device = None if on_host else self.device
        mask = ops.build_mask(table, query.where_terms, device)
        if query.expand_filter_column:
            basket_codes, basket_uniques = self._basket_codes(
                table, query.expand_filter_column
            )
            if on_host:
                mask = ops.host_expand_mask_by_group(
                    basket_codes, mask, n_groups=len(basket_uniques))
            else:
                mask = ops.expand_mask_by_group(
                    basket_codes, mask, n_groups=len(basket_uniques),
                    device=self.device,
                )
        if not query.aggregate:
            return self._raw_rows(table, query, mask)

        (dense, combos, n_groups, cards, key_values,
         combo_cols) = self._group_codes(table, query.groupby_cols)
        if len(combos) < n_groups:
            # a shard without rows (a view of no chunks): its one padded
            # group has no rows and drops at collect
            combos = np.zeros(n_groups, dtype=np.int64)

        # the bucketed group count keeps padded groups zero-row; they are
        # sliced off after the fetch
        n_prog = ops.program_bucket(n_groups)
        dense32 = dense.astype(np.int32)
        codes = None if on_host else as_tensor(dense32, self.device)
        mergeable = [
            (i, a) for i, a in enumerate(query.agg_list)
            if a[1] in ops.MERGEABLE_OPS
        ]
        agg_parts = [None] * len(query.agg_list)
        if mergeable:
            from bqueryd_tpu_torch.plan import calibrate

            measures = tuple(table.column_raw(a[0]) for _, a in mergeable)
            mops = tuple(a[1] for _, a in mergeable)
            sentinels = tuple(
                np.iinfo(np.int64).min
                if table.kind(a[0]) == "datetime" else None
                for _, a in mergeable
            )
            dtypes = [np.asarray(m).dtype for m in measures]
            if on_host:
                self.last_effective_strategy = "host"
                clock = time.perf_counter()
                partials = ops.host_partial_tables(
                    dense32, measures, mops, n_groups, mask,
                    null_sentinels=sentinels,
                )
                # host walls are calibration samples too (nothing to build)
                calibrate.record_sample(
                    rows=len(dense), groups=n_groups, dtypes=dtypes,
                    backend="host", strategy="host",
                    wall_s=time.perf_counter() - clock,
                )
                rows = partials["rows"]
                for (i, _a), part in zip(mergeable, partials["aggs"]):
                    agg_parts[i] = dict(part)
            else:
                from bqueryd_tpu_torch.ops import onehot

                kernel_strategy = None if strategy == "auto" else strategy
                route = ops.kernel_route(
                    kernel_strategy, measures, mops, len(dense), n_prog
                )
                self.last_effective_strategy = route
                marker = onehot.build_marker()
                clock = time.perf_counter()
                partials = ops.tree_to_numpy(ops.partial_tables(
                    codes, measures, mops, n_prog, mask,
                    null_sentinels=sentinels, strategy=kernel_strategy,
                ))
                wall = time.perf_counter() - clock
                # a wall that built the kernel library or launched a shape
                # for the first time is not a sample of the route
                if onehot.build_marker() == marker:
                    calibrate.record_sample(
                        rows=len(dense), groups=n_groups, dtypes=dtypes,
                        backend=self.device.type, strategy=route,
                        wall_s=wall,
                    )
                rows = partials["rows"][:n_groups]
                for (i, _a), part in zip(mergeable, partials["aggs"]):
                    agg_parts[i] = {k: v[:n_groups] for k, v in part.items()}
        elif on_host:
            # rows still needed to drop empty groups
            rows = ops.host_partial_tables(
                dense32, (), (), n_groups, mask)["rows"]
        else:
            rows = ops.partial_tables(
                codes, (), (), n_prog, mask
            )["rows"].cpu().numpy()[:n_groups]
        for i, (in_col, op, _out) in enumerate(query.agg_list):
            if op not in ops.MERGEABLE_OPS:
                agg_parts[i] = self._distinct_part(
                    table, query, in_col, op, codes, dense, n_groups, mask
                )

        present = rows > 0
        combos_present = combos[present]
        if len(query.groupby_cols) == 1:
            key_codes = [combos_present]
        elif combo_cols is not None:
            key_codes = [
                combo_cols[combos_present, ci]
                for ci in range(combo_cols.shape[1])
            ]
        else:
            key_codes = ops.unpack_codes(combos_present, cards)
        keys = {
            col: np.asarray(values)[np.asarray(codes_g, dtype=np.int64)]
            for col, codes_g, values in zip(
                query.groupby_cols, key_codes, key_values
            )
        }
        return ResultPayload.partials(
            key_cols=query.groupby_cols,
            keys=keys,
            rows=rows[present],
            aggs=[
                filter_distinct_part(part, present)
                if "distinct_offsets" in part
                else {k: v[present] for k, v in part.items()}
                for part in agg_parts
            ],
            ops=query.ops,
            out_cols=query.out_cols,
            value_kinds=[_value_kind_for(table, c) for c in query.in_cols],
        )

    def _distinct_part(self, table, query, in_col, op, codes, dense,
                       n_groups, mask):
        """One distinct op's partial over the shard's group codes
        (``codes`` on the device, or None on the host route; ``dense`` on
        the host; ``mask`` a tensor, a NumPy array or None):

        * ``count_distinct`` of a sole payload: final counts from the
          device sort (:func:`ops.groupby_count_distinct`), or the value
          sets when the (group, value) space overflows int64 or the query
          runs on the host;
        * ``count_distinct`` otherwise: the per-group distinct value sets,
          which union exactly across shards and workers, capped at
          ``BQUERYD_TPU_DISTINCT_VALUES_LIMIT`` (group, value) pairs;
        * ``sorted_count_distinct``: run counts (the device twin, or
          :func:`ops.host_sorted_count_distinct` on the host), additive
          across shards (a run is local to its shard's order)."""
        from bqueryd_tpu_torch import ops

        on_host = codes is None
        if op == "sorted_count_distinct":
            if on_host:
                counts = ops.host_sorted_count_distinct(
                    dense.astype(np.int32), table.column_raw(in_col),
                    n_groups, mask,
                )
                return {"distinct": counts[:n_groups]}
            counts = ops.groupby_sorted_count_distinct(
                codes, table.column_raw(in_col),
                ops.program_bucket(n_groups), mask,
            )
            return {"distinct": counts.cpu().numpy()[:n_groups]}
        if op != "count_distinct":
            raise ValueError(f"unknown aggregation op {op!r}")
        # dict and datetime values resolve to their actual values: shard
        # dictionary codes live in incompatible code spaces
        vcodes, vuniques = self._key_codes(table, in_col)
        if query.sole_payload and not on_host:
            try:
                counts = ops.groupby_count_distinct(
                    codes, vcodes, ops.program_bucket(n_groups),
                    # a bucketed n_values keeps the composite injective
                    # (codes < actual <= bucket): counts are unchanged
                    ops.program_bucket(max(len(vuniques), 1)), mask,
                )
            except ops.CompositeOverflow:
                pass  # the value sets below answer exactly without packing
            else:
                return {"distinct": counts.cpu().numpy()[:n_groups]}
        if mask is not None and not on_host:
            mask = mask.cpu().numpy()
        values, offsets = _group_distinct_flat(
            np.asarray(dense), np.asarray(vcodes), np.asarray(vuniques),
            n_groups, mask,
        )
        # the sets grow with the distinct values (up to the whole column):
        # a cap keeps one query from exhausting worker or client memory
        limit = int(os.environ.get(
            "BQUERYD_TPU_DISTINCT_VALUES_LIMIT", 5_000_000
        ))
        if limit and len(values) > limit:
            raise ValueError(
                f"count_distinct on {in_col!r}: {len(values)} (group, value) "
                f"pairs exceeds the payload cap {limit}; raise "
                f"BQUERYD_TPU_DISTINCT_VALUES_LIMIT to allow"
            )
        return {"distinct_values": values, "distinct_offsets": offsets}

    def _raw_rows(self, table, query, mask):
        column_list = list(query.groupby_cols) + list(query.in_cols)
        seen = set()
        column_list = [c for c in column_list
                       if not (c in seen or seen.add(c))]
        if mask is not None and not isinstance(mask, np.ndarray):
            mask = mask.cpu().numpy()
        idx = None if mask is None else np.flatnonzero(mask)
        columns = {}
        for col in column_list:
            values = table.column(col)
            columns[col] = values if idx is None else values[idx]
        return ResultPayload.rows(columns, column_list)

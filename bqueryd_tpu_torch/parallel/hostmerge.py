"""Host-side (NumPy-only) merge of value-keyed result payloads.

The port's copy of ``bqueryd_tpu/parallel/hostmerge.py`` for the groupby
ops: payloads carry actual key values, and this module aligns them across
shards and workers and combines them:

* ``mean`` merges as (sum, count) -> weighted mean, not sum-of-shard-means;
* ``min``/``max`` merge as min/max;
* ``sum``/``count`` add;
* ``count_distinct`` partials carry each group's distinct VALUE SET in flat
  form (``distinct_values``, ``distinct_offsets``) and merge by union, so a
  value seen on several shards counts once; a sole payload's final counts
  (``distinct``) and ``sorted_count_distinct``'s run counts add.

* the operator DAG's part kinds: per-group top-k lists (``topk_values``,
  ``topk_offsets``) merge by a k-way re-select, quantile sketches
  (``sketch_keys``, ``sketch_counts``, ``sketch_offsets``) by bucket-count
  addition (:mod:`bqueryd_tpu_torch.parallel.opexec`).

Payloads of ``bqueryd_tpu`` and of the port share one format, so either
package's merge takes the other's payloads.
"""

import numpy as np

from bqueryd_tpu_torch.models.query import extremum_fill

_MERGE_RULES = {
    "sum": np.add,
    "count": np.add,
    "distinct": np.add,
    "min": np.minimum,
    "max": np.maximum,
    # ("distinct_values", "distinct_offsets") pairs merge by set union in
    # _merge_aligned
}


def merge_payloads(payloads):
    """Merge a list of ResultPayload dicts into one.

    Mixed kinds: 'empty' payloads are dropped; remaining payloads must agree
    on kind.  Returns a single payload dict (kind 'empty' if all were).
    """
    from bqueryd_tpu_torch.utils.tracing import trace_span

    live = [p for p in payloads if p.get("kind") != "empty"]
    if not live:
        return {"format": "bqueryd-tpu-result-1", "kind": "empty"}
    kinds = {p["kind"] for p in live}
    # a profiler range under BQUERYD_TPU_PROFILE=1, on the timeline of the
    # device kernels it complements
    with trace_span("hostmerge"):
        if kinds == {"rows"}:
            return _merge_rows(live)
        if kinds == {"partials"}:
            return _merge_partials(live)
    raise ValueError(f"cannot merge mixed payload kinds: {sorted(kinds)}")


def _merge_rows(payloads):
    order = payloads[0]["order"]
    for p in payloads[1:]:
        if p["order"] != order:
            raise ValueError("row payloads have mismatched columns")
    columns = {
        col: np.concatenate([p["columns"][col] for p in payloads])
        for col in order
    }
    return {
        "format": payloads[0]["format"],
        "kind": "rows",
        "columns": columns,
        "order": order,
    }


def _align_groups(payloads, key_cols):
    """Vectorized global key alignment.

    Factorizes each key column over the concatenation of all payloads
    (``np.unique`` handles ints, floats, and string/object keys alike), folds
    the per-column codes into one composite code pairwise (re-factorizing
    after each fold keeps codes bounded by the row count, so the mixed-radix
    products cannot overflow int64), then renumbers the composite codes into
    first-seen order — the same global ordering the previous per-group
    Python-dict loop produced, at NumPy speed.

    Returns ``(group_of, n_global, global_keys)`` where ``group_of[i]`` maps
    payload *i*'s local groups to global group ids and ``global_keys`` are the
    per-column key values of each global group.
    """
    lengths = [len(p["rows"]) for p in payloads]
    offsets = np.cumsum([0] + lengths)
    total = offsets[-1]

    col_values = [   # concatenated raw key values per column
        np.concatenate([np.asarray(p["keys"][c]) for p in payloads])
        for c in key_cols
    ]
    combined = _pack_int_keys(col_values) if total else None
    if combined is not None:
        # all-integer keys with packable ranges: ONE unique over the packed
        # composite instead of a sort per column
        _uniq, combined = np.unique(combined, return_inverse=True)
        combined = combined.astype(np.int64, copy=False)
        n_comb = len(_uniq)
    else:
        for allv in col_values:
            uniq, inv = np.unique(allv, return_inverse=True)
            inv = inv.astype(np.int64, copy=False)
            if combined is None:
                combined, n_comb = inv, len(uniq)
            else:
                pair = combined * np.int64(len(uniq)) + inv
                uniq_pair, combined = np.unique(pair, return_inverse=True)
                combined = combined.astype(np.int64, copy=False)
                n_comb = len(uniq_pair)
        if combined is None:  # no key columns: everything is one group
            combined, n_comb = np.zeros(total, dtype=np.int64), min(1, total)

    # renumber into first-seen order (deterministic, matches dict semantics)
    first_pos = np.full(n_comb, total, dtype=np.int64)
    np.minimum.at(first_pos, combined, np.arange(total, dtype=np.int64))
    seen_order = np.argsort(first_pos, kind="stable")
    rank = np.empty(n_comb, dtype=np.int64)
    rank[seen_order] = np.arange(n_comb, dtype=np.int64)
    global_codes = rank[combined]

    rep_rows = first_pos[seen_order]  # one representative row per global group
    global_keys = {
        c: col_values[ci][rep_rows] for ci, c in enumerate(key_cols)
    }
    group_of = [
        global_codes[offsets[i]:offsets[i + 1]] for i in range(len(payloads))
    ]
    return group_of, n_comb, global_keys


def _pack_int_keys(col_values):
    """Mixed-radix-pack all-integer key columns into one int64 code array, or
    None when any column is non-integer or the range product could overflow."""
    if not col_values or not all(
        np.issubdtype(v.dtype, np.integer) for v in col_values
    ):
        return None
    mins = [int(v.min()) for v in col_values]
    maxs = [int(v.max()) for v in col_values]
    if any(m < -(1 << 63) or x >= (1 << 63) for m, x in zip(mins, maxs)):
        return None  # uint64 beyond int64 range: np.unique fallback handles it
    spans = [x - m + 1 for x, m in zip(maxs, mins)]
    capacity = 1
    for s in spans:
        capacity *= s
        if capacity >= (1 << 62):
            return None
    packed = np.zeros(len(col_values[0]), dtype=np.int64)
    for v, m, s in zip(col_values, mins, spans):
        packed *= np.int64(s)
        packed += v.astype(np.int64) - np.int64(m)
    return packed


def _merge_partials(payloads):
    first = payloads[0]
    key_cols = first["key_cols"]
    ops = first["ops"]
    out_cols = first["out_cols"]
    def _merge_kinds(a, b):
        # Shards may store the same column at different widths.  A uint64
        # shard merging with a NARROWER UNSIGNED sibling ('uint') keeps the
        # unsigned view — all sums are the same mod-2^64 bits.  A signed or
        # float sibling (None) makes the unsigned reinterpretation unsound
        # (pandas widens those mixes to float/int64), so that mix is
        # refused rather than silently corrupted.  'uint' next to a plain
        # numeric sibling needs no special finalize at all.  Datetime never
        # mixes with non-datetime (validated at execution).
        if a == b:
            return a
        pair = {a, b}
        if pair == {"uint64", "uint"}:
            return "uint64"
        if pair == {"uint", None}:
            return None
        raise ValueError("partial payloads disagree on query shape")

    value_kinds = first.get("value_kinds")
    for p in payloads[1:]:
        if (
            p["key_cols"] != key_cols
            or p["ops"] != ops
            or p["out_cols"] != out_cols
        ):
            raise ValueError("partial payloads disagree on query shape")
        theirs = p.get("value_kinds")
        if theirs != value_kinds:
            # a payload with no value_kinds at all (a worker running a
            # pre-kinds build during a rolling restart) means "no special
            # finalize anywhere" — merge as all-None and let _merge_kinds
            # decide per column, raising only on genuinely incompatible
            # kinds (uint64/datetime next to a plain numeric)
            if value_kinds is None:
                value_kinds = [None] * len(out_cols)
            if theirs is None:
                theirs = [None] * len(out_cols)
            value_kinds = [
                _merge_kinds(a, b) for a, b in zip(value_kinds, theirs)
            ]
    if len(payloads) == 1:
        return dict(first)

    return _merge_aligned(payloads, key_cols, ops, out_cols, value_kinds)


def collapse_partials(payload):
    """Collapse duplicate key tuples inside ONE partials payload.

    A freshly executed partial has unique keys, but a payload whose key
    columns were rewritten (a window re-floored onto a coarser grid, a
    group-key column dropped: the folds of :mod:`bqueryd_tpu_torch.serve.
    subsume`) maps several stored groups onto one key tuple.  Re-aggregating
    them is the cross-shard merge of one payload, so this goes through the
    same merge rules (extremum fills, distinct unions)."""
    if payload.get("kind") != "partials" or not len(payload.get("rows", ())):
        return payload
    return _merge_aligned(
        [payload],
        payload["key_cols"],
        payload["ops"],
        payload["out_cols"],
        payload.get("value_kinds"),
    )


def _merge_aligned(payloads, key_cols, ops, out_cols, value_kinds):
    """Shape-validated merge core: align key tuples globally and combine
    every aggregation part under its merge rule."""
    first = payloads[0]
    group_of, n_global, global_keys = _align_groups(payloads, key_cols)

    def scatter(rule, parts, dtype):
        if rule in (np.minimum, np.maximum):
            fill = extremum_fill(
                dtype, "min" if rule is np.minimum else "max"
            )
            out = np.full(n_global, fill, dtype=dtype)
        else:
            out = np.zeros(n_global, dtype=dtype)
        for local_map, arr in parts:
            rule.at(out, local_map, arr)
        return out

    rows = scatter(
        np.add, [(g, np.asarray(p["rows"])) for g, p in zip(group_of, payloads)],
        np.int64,
    )
    aggs = []
    for ai in range(len(ops)):
        part_names = first["aggs"][ai].keys()
        merged = {}
        if "topk_offsets" in part_names:
            from bqueryd_tpu_torch.parallel import opexec
            from bqueryd_tpu_torch.plan.dag import parse_op

            _kind, k, largest = parse_op(ops[ai])
            values, offsets = opexec.merge_topk_parts(
                [
                    (g, p["aggs"][ai]["topk_values"],
                     p["aggs"][ai]["topk_offsets"])
                    for g, p in zip(group_of, payloads)
                ],
                k, largest, n_global,
            )
            aggs.append({"topk_values": values, "topk_offsets": offsets})
            continue
        if "sketch_offsets" in part_names:
            from bqueryd_tpu_torch.parallel import opexec

            keys, counts, offsets = opexec.merge_sketch_parts(
                [
                    (g, p["aggs"][ai]["sketch_keys"],
                     p["aggs"][ai]["sketch_counts"],
                     p["aggs"][ai]["sketch_offsets"])
                    for g, p in zip(group_of, payloads)
                ],
                n_global,
            )
            aggs.append({"sketch_keys": keys, "sketch_counts": counts,
                         "sketch_offsets": offsets})
            continue
        if "distinct_offsets" in part_names:
            values, offsets = _union_distinct_flat(
                [
                    (g, p["aggs"][ai]["distinct_values"],
                     p["aggs"][ai]["distinct_offsets"])
                    for g, p in zip(group_of, payloads)
                ],
                n_global,
            )
            merged["distinct_values"] = values
            merged["distinct_offsets"] = offsets
        for pname in part_names:
            if pname in ("distinct_values", "distinct_offsets"):
                continue
            rule = _MERGE_RULES[pname]
            parts = [
                (g, np.asarray(p["aggs"][ai][pname]))
                for g, p in zip(group_of, payloads)
            ]
            # widen across payloads: shards may store the same column at
            # different widths, and adopting parts[0]'s dtype would
            # truncate a wider sibling's extrema into the fill range
            dtype = np.result_type(*[arr.dtype for _g, arr in parts])
            merged[pname] = scatter(rule, parts, dtype)
        aggs.append(merged)

    return {
        "format": first["format"],
        "kind": "partials",
        "key_cols": key_cols,
        "keys": global_keys,
        "rows": rows,
        "aggs": aggs,
        "ops": ops,
        "out_cols": out_cols,
        "value_kinds": value_kinds,
    }


def _union_distinct_flat(parts, n_global):
    """Union per-group distinct value sets across payloads, vectorized.

    ``parts`` is ``[(local_map, values, offsets), ...]`` in the flat
    per-group form.  Each payload's offsets expand into global group ids,
    (group, value) pairs dedupe through composite codes, and the result is
    one merged flat ``(values, offsets)``, with no per-group Python loop."""
    vals_chunks, gid_chunks = [], []
    for local_map, values, offsets in parts:
        values = np.asarray(values)
        if len(values) == 0:
            continue
        counts = np.diff(np.asarray(offsets))
        vals_chunks.append(values)
        gid_chunks.append(np.repeat(np.asarray(local_map), counts))
    if not vals_chunks:
        return np.empty(0), np.zeros(n_global + 1, dtype=np.int64)
    all_vals = np.concatenate(vals_chunks)
    all_gids = np.concatenate(gid_chunks)
    span = None
    if np.issubdtype(all_vals.dtype, np.integer):
        vmin = int(all_vals.min())
        vmax = int(all_vals.max())
        span = vmax - vmin + 1
        if n_global * span >= (1 << 62) or vmax >= (1 << 63):
            span = None  # overflow (uint64 past int64 too): unique path
    if span is not None:
        # integer values in a packable range: one unique over packed
        # (group, value) codes, no sort of the values themselves
        pair = all_gids.astype(np.int64) * np.int64(span) + (
            all_vals.astype(np.int64) - np.int64(vmin)
        )
        uniq_pairs = np.unique(pair)
        merged_vals = (uniq_pairs % span + vmin).astype(all_vals.dtype)
        counts = np.bincount(uniq_pairs // span, minlength=n_global)
    else:
        uniq_vals, vinv = np.unique(all_vals, return_inverse=True)
        pair = all_gids.astype(np.int64) * np.int64(len(uniq_vals)) + vinv
        uniq_pairs = np.unique(pair)
        merged_vals = uniq_vals[uniq_pairs % len(uniq_vals)]
        counts = np.bincount(uniq_pairs // len(uniq_vals), minlength=n_global)
    offsets = np.zeros(n_global + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return merged_vals, offsets


def finalize_table(merged):
    """Finalize a merged payload into plain arrays:
    ``(order, {col: np.ndarray})``.  NumPy mirror of ``ops.finalize``."""
    if merged["kind"] == "empty":
        return [], {}
    if merged["kind"] == "rows":
        return merged["order"], merged["columns"]

    out_cols = merged["out_cols"]
    order = list(merged["key_cols"]) + list(out_cols)
    columns = dict(merged["keys"])
    rows = merged["rows"]
    value_kinds = merged.get("value_kinds") or [None] * len(out_cols)
    for agg, op, out_col, vkind in zip(
        merged["aggs"], merged["ops"], out_cols, value_kinds
    ):
        if op == "mean":
            count = agg["count"]
            with np.errstate(invalid="ignore", divide="ignore"):
                values = np.where(
                    count > 0, agg["sum"] / np.maximum(count, 1), np.nan
                )
        elif op == "sum":
            values = agg["sum"]
            if vkind == "uint64":
                # every kernel accumulates mod 2^64; unsigned columns just
                # re-view the same bits (pandas keeps uint64 sums unsigned)
                values = np.asarray(values).astype(np.int64).view(np.uint64)
        elif op in ("count", "count_na"):
            values = agg["count"]
        elif op == "count_distinct":
            if "distinct" in agg:
                # a sole payload: final counts from the device sort
                values = np.asarray(agg["distinct"])
            else:
                values = np.diff(np.asarray(agg["distinct_offsets"]))
        elif op == "sorted_count_distinct":
            values = agg["distinct"]
        elif isinstance(op, str) and op.startswith("topk:"):
            # object array of per-group best-first value arrays
            from bqueryd_tpu_torch.parallel import opexec

            values = opexec.finalize_topk(agg, vkind=vkind)
        elif isinstance(op, str) and op.startswith("quantile:"):
            from bqueryd_tpu_torch.parallel import opexec

            values = opexec.finalize_quantile(agg, op)
        elif op in ("min", "max"):
            values = agg[op]
            empty = agg["count"] == 0
            if vkind == "datetime":
                # partials merged as raw int64; NaT (int64 min) for groups
                # whose values were all-NaT, then back to datetime64[ns]
                values = np.where(
                    empty, np.iinfo(np.int64).min, values.astype(np.int64)
                ).view("datetime64[ns]")
            elif np.issubdtype(values.dtype, np.floating):
                values = np.where(empty, np.nan, values)
            else:
                values = np.where(empty, 0, values)
        else:
            raise ValueError(f"cannot finalize op {op!r}")
        columns[out_col] = values

    present = rows > 0
    if not present.all():
        columns = {c: v[present] for c, v in columns.items()}
    return order, columns


def payload_to_dataframe(merged):
    """Final client-side conversion (pandas import isolated here).

    String data and the column index are built at OBJECT dtype explicitly:
    pandas 3 otherwise infers arrow-backed str arrays, whose construction
    (``ArrowStringArray._from_sequence``) null-derefs inside libarrow 25.0
    on some environments (observed: single-core hosts under this repo's
    benchmark) — and the reference returned object-dtype strings anyway."""
    import pandas as pd

    order, columns = finalize_table(merged)
    if not order:
        return pd.DataFrame()
    data = {}
    for c in order:
        v = columns[c]
        if getattr(v, "dtype", None) == object:
            data[c] = pd.Series(v, dtype=object)
        else:
            data[c] = v
    return pd.DataFrame(data, columns=pd.Index(order, dtype=object))

"""where_terms: filter terms -> boolean row masks on the device, with shard
pruning.

The port of ``bqueryd_tpu/ops/predicates.py``: a filter is a list of
``(column, op, value)`` terms AND-ed together.  Ops: ==, !=, <, <=, >, >=,
in, not in.  Masks are torch bool tensors on the engine's device and stay
there: the groupby kernels consume them without a host round-trip.  A
query the router sends to the host (a small shard, a wedged device) builds
its mask as a NumPy array instead (``build_mask(..., device=None)``), with
the same elementwise semantics and no device call.

Value translation happens on the host against the table's dictionaries:

* dict columns compare by code; a value absent from the dictionary maps to
  code -2, which yields all-false for ==/in and all-true for !=/not-in
  (codes are always >= -1);
* datetime columns compare as int64 nanoseconds.

A Python scalar compares in the column's own dtype (a float32 column
against ``5.0`` compares in float32), as in JAX and NumPy 2.

:func:`shard_can_match` is the host-side precheck: column min/max stats and
dictionary membership decide whether a shard can hold any matching row
before anything is decoded or uploaded.  :func:`chunk_pruned_table` goes one
level down: the per-chunk zone maps the writer stores prove chunks
unmatchable, and a query runs over a view of the surviving chunks.
"""

import os

import numpy as np
import torch

from bqueryd_tpu_torch.ops.groupby import as_tensor

WHERE_OPS = ("==", "!=", "<", "<=", ">", ">=", "in", "not in")

#: ops the per-chunk zone maps can prune on (``plan.stats.zone_can_match``);
#: ``!=``/``not in`` never prune: NaN rows satisfy them but are invisible
#: to the NaN-skipping zone maps
ZONE_PRUNABLE_OPS = ("==", "<", "<=", ">", ">=", "in")


def _to_ns(value):
    """Nanoseconds since the epoch of a datetime-like value (a
    ``pandas.Timestamp``, ``np.datetime64``, ``datetime`` or ISO string),
    without importing pandas."""
    ns = getattr(value, "value", None)  # pandas.Timestamp
    if isinstance(ns, (int, np.integer)) and not isinstance(value, np.generic):
        return int(ns)
    return int(np.datetime64(value, "ns").astype(np.int64))


def translate_value(table, column, value, op="=="):
    """Translate a user-facing term value into physical column space.

    Range ops on dict columns are rejected: dictionary codes are in
    first-seen order, so ``<``/``>`` over codes would compare ingestion
    order, not values."""
    if isinstance(value, (set, frozenset)):
        value = list(value)
    kind = table.kind(column)
    if kind == "dict":
        if op in ("<", "<=", ">", ">="):
            raise ValueError(
                f"range op {op!r} is not supported on dictionary-encoded "
                f"column {column!r} (codes are unordered)"
            )
        lookup = table.dict_lookup(column)
        if isinstance(value, (list, tuple)):
            return [lookup.get(str(v), -2) for v in value]
        return lookup.get(str(value), -2)
    if kind == "datetime":
        if isinstance(value, (list, tuple)):
            return [_to_ns(v) for v in value]
        return _to_ns(value)
    return value


def _member_tensor(values, value):
    """The ``in`` list as a tensor in the promoted dtype of both sides."""
    members = torch.as_tensor(np.asarray(value), device=values.device)
    common = torch.promote_types(values.dtype, members.dtype)
    return values.to(common), members.to(common)


def term_mask(values, op, value):
    """Boolean mask for one term over a physical value tensor (or a NumPy
    array, for the unsigned columns torch cannot compare)."""
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
        if isinstance(values, np.ndarray):
            hit = np.isin(values, np.asarray(value))
        else:
            hit = torch.isin(*_member_tensor(values, value))
        return hit if op == "in" else ~hit
    raise ValueError(f"unsupported where op {op!r}")


def build_mask(table, where_terms_list, device):
    """AND together all terms into one bool tensor on ``device``, or into
    one NumPy bool array when ``device`` is None (the host route); None for
    an empty term list (no filtering)."""
    if not where_terms_list:
        return None
    mask = None
    for column, op, value in where_terms_list:
        phys = translate_value(table, column, value, op)
        raw = np.ascontiguousarray(table.column_raw(column))
        if device is None:
            m = np.asarray(term_mask(raw, op, phys), dtype=bool)
        elif raw.dtype.kind == "u" and raw.dtype.itemsize > 1:
            # torch has no comparisons for uint16/32/64: compare on the host
            m = torch.from_numpy(term_mask(raw, op, phys)).to(device)
        else:
            m = term_mask(as_tensor(raw, device), op, phys)
        mask = m if mask is None else (mask & m)
    return mask


def chunk_prune_enabled():
    """Chunk-granular zone-map pruning switch (``BQUERYD_TPU_CHUNK_PRUNE``,
    default on)."""
    return os.environ.get("BQUERYD_TPU_CHUNK_PRUNE", "1") == "1"


def chunk_prune_selectivity():
    """Surviving-chunk fraction ABOVE which pruning is skipped
    (``BQUERYD_TPU_CHUNK_PRUNE_SELECTIVITY``, default 0.9): a filter that
    keeps nearly every chunk would fragment the content-keyed caches for
    little decode saved."""
    try:
        return float(
            os.environ.get("BQUERYD_TPU_CHUNK_PRUNE_SELECTIVITY", "0.9")
        )
    except ValueError:
        return 0.9


def chunk_selection(table, where_terms_list):
    """Boolean keep-mask over the table's committed chunk grid for an
    AND-ed term list, or None when nothing is prunable (no zone maps, no
    prunable ops, one chunk).  A False entry is proof, from the chunk's
    min/max, that no row of that chunk satisfies the conjunction."""
    from bqueryd_tpu_torch.plan.stats import zone_can_match

    counts = getattr(table, "chunk_rows", lambda: None)()
    if counts is None or len(counts) <= 1:
        return None
    keep = np.ones(len(counts), dtype=bool)
    prunable = False
    for term in where_terms_list or []:
        try:
            column, op, value = term
        except (TypeError, ValueError):
            continue
        if op not in ZONE_PRUNABLE_OPS or column not in table:
            continue
        maps = table.chunk_zone_maps(column)
        if maps is None or len(maps) != len(counts):
            continue
        phys = translate_value(table, column, value, op)
        for i, zone in enumerate(maps):
            if not keep[i] or zone is None:
                continue
            if not zone_can_match(zone[0], zone[1], op, phys):
                keep[i] = False
                prunable = True
    return keep if prunable else None


def chunk_pruned_table(table, where_terms_list):
    """``(table_or_view, chunks_decoded, chunks_skipped)``: the table
    itself unless pruning is on, at least one chunk is provably
    unmatchable and the surviving fraction is at or under
    :func:`chunk_prune_selectivity`; then a ``ChunkView`` of the surviving
    chunks.  Never for basket expansion (``expand_filter_column``), which
    re-selects rows of a basket that live in pruned chunks."""
    counts = getattr(table, "chunk_rows", lambda: None)()
    total = len(counts) if counts is not None else 0
    if not chunk_prune_enabled():
        return table, 0, 0
    keep = chunk_selection(table, where_terms_list)
    if keep is None:
        return table, total, 0
    selected = int(keep.sum())
    if selected == total or selected / total > chunk_prune_selectivity():
        return table, total, 0
    return table.chunk_view(np.flatnonzero(keep)), selected, total - selected


def shard_can_match(table, where_terms_list):
    """Host-side pruning: False only if NO row of this shard can satisfy the
    conjunction.  Uses column min/max stats (numeric/datetime) and
    dictionary membership (dict columns); unknown columns conservatively
    match."""
    for term in where_terms_list or []:
        column, op, value = term
        if column not in table:
            continue
        try:
            kind = table.kind(column)
            if kind == "dict":
                phys = translate_value(table, column, value, op)
                if op == "==" and phys == -2:
                    return False
                if op == "in" and isinstance(phys, list) and all(
                    p == -2 for p in phys
                ):
                    return False
                continue
            stats = table.col_stats(column)
            if stats is None:
                continue
            lo, hi = stats
            if kind == "datetime":
                value_phys = translate_value(table, column, value, op)
            else:
                value_phys = value
            if op == "==" and not (
                isinstance(value_phys, (list, tuple))
            ) and (value_phys < lo or value_phys > hi):
                return False
            if op == ">" and hi <= value_phys:
                return False
            if op == ">=" and hi < value_phys:
                return False
            if op == "<" and lo >= value_phys:
                return False
            if op == "<=" and lo > value_phys:
                return False
            if op == "in" and isinstance(value_phys, (list, tuple)) and all(
                v < lo or v > hi for v in value_phys
            ):
                return False
        except TypeError:
            # value not comparable with stats: pruning is best-effort
            continue
    return True

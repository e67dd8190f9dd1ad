"""Plan subsumption: which materialized answers prove a query's answer.

The port's copy of ``bqueryd_tpu/serve/subsume.py``.  Given the logical
plan of an admitted query and the controller's ready rollups
(:mod:`.rollup`), it finds the candidates whose partials provably contain
the query's answer and the transform that extracts it:

* **exact** — the same plan view: the stored partials serve verbatim;
* **window-fold** — a finer time-window rollup answers a coarser window
  when the coarse width is a multiple of the fine one and the origins
  agree modulo the fine width: every fine bucket lies wholly inside one
  coarse bucket, so re-flooring the bucket keys and merging is exact;
* **key-fold** — a rollup on more group keys answers a groupby on fewer
  by dropping key columns and merging; sound only when every dropped key
  column is a null-free integer column (the build's column census), since
  a null key drops its rows from the finer grouping;
* **zone-proof filter** — a rollup with a weaker filter (usually none)
  answers a filtered query when the per-chunk zone maps prove that each
  extra term selects EVERY chunk whole; integer columns only, as float and
  datetime zone maps skip NaN/NaT rows.

Anything else is refused with a reason (partial chunk overlap, window
misalignment, non-mergeable ops, joins) and recomputed: the dispatch path
is always right, serving is only an optimization.  The source is chosen
by :func:`bqueryd_tpu_torch.plan.calibrate.analytic_units`: folding a
G-group partial must cost less than scanning N rows.

NumPy only; every function is deterministic on its inputs.
"""

from bqueryd_tpu_torch.models.query import MERGEABLE_OPS

#: ops a rollup partial can be merged again under
SERVE_OPS = frozenset(MERGEABLE_OPS)

#: index of the window signature inside :meth:`plan.dag.OperatorDAG.signature`
_DAG_WINDOW_IDX = 7
#: index of the join signature (any join disqualifies)
_DAG_JOIN_IDX = 6

#: operators a zone map can prove full-chunk selection for
_FULL_SELECT_OPS = frozenset({"==", "!=", ">", ">=", "<", "<=", "in"})


def _freeze_term(term):
    col, op, value = term
    if isinstance(value, (list, tuple, set)):
        value = tuple(value)
    return (col, op, value)


def plan_view(plan):
    """The hashable view of a logical plan that subsumption reasons over,
    compared field by field."""
    return {
        "filenames": tuple(plan.filenames),
        "keys": tuple(plan.groupby.keys),
        "aggs": tuple(tuple(a) for a in plan.physical_agg_list()),
        "where": tuple(_freeze_term(t) for t in plan.where_terms),
        "aggregate_rows": bool(plan.aggregate_rows),
        "expand": plan.expand_filter_column,
        "dag_sig": getattr(plan, "dag_sig", None),
    }


def view_key(view):
    """Stable string identity of a view: the rollup store's key and the
    ``subsumed_from`` wire value."""
    import hashlib

    digest = hashlib.sha1(repr(sorted(view.items())).encode()).hexdigest()
    return f"rollup:{'+'.join(view['keys']) or 'all'}:{digest[:12]}"


def plan_eligible(view):
    """``(ok, reason)``: can this plan shape be served or rolled up at all?
    Anything outside the mergeable aggregations is refused with a reason
    (recorded in the flight ring)."""
    if not view["aggregate_rows"]:
        return False, "raw-rows"
    if view["expand"]:
        return False, "expand-filter"
    for _in_col, op, _out in view["aggs"]:
        if op not in SERVE_OPS:
            return False, f"op:{op}"
    dag_sig = view["dag_sig"]
    if dag_sig is not None and dag_sig[_DAG_JOIN_IDX] is not None:
        return False, "join"
    # a DAG without a window matches exactly only: no fold is defined
    return True, None


def zone_full_select(lo, hi, op, value):
    """Whether one chunk's ``(min, max)`` zone proves that ``op value``
    selects every row of it.  Unknown ops and incomparable values give
    False."""
    try:
        if op == "==":
            return lo == hi == value
        if op == "!=":
            return not isinstance(value, (list, tuple)) and (
                value < lo or value > hi
            )
        if op == ">":
            return lo > value
        if op == ">=":
            return lo >= value
        if op == "<":
            return hi < value
        if op == "<=":
            return hi <= value
        if op == "in":
            return lo == hi and lo in value
    except TypeError:
        return False
    return False


def term_full_selects(cols_meta, term):
    """True when ONE file's column census proves that ``term`` selects
    every chunk whole: an integer column with a zone map on every chunk."""
    col, op, value = term
    if op not in _FULL_SELECT_OPS:
        return False
    info = (cols_meta or {}).get(col)
    if not info or info.get("kind") != "int":
        return False
    zones = info.get("zones")
    if not zones:
        return False
    return all(
        z is not None and zone_full_select(z[0], z[1], op, value)
        for z in zones
    )


def _match_window(cand, query):
    """Window-fold match of two DAG views: ``(transform, reason)``."""
    c_sig, q_sig = cand["dag_sig"], query["dag_sig"]
    if len(c_sig) != len(q_sig):
        return None, "dag-version"
    for i in range(len(c_sig)):
        if i != _DAG_WINDOW_IDX and c_sig[i] != q_sig[i]:
            return None, "dag-shape"
    c_win, q_win = c_sig[_DAG_WINDOW_IDX], q_sig[_DAG_WINDOW_IDX]
    if c_win is None or q_win is None:
        return None, "window-missing"
    c_col, c_every, c_alias, c_origin = c_win
    q_col, q_every, q_alias, q_origin = q_win
    if c_col != q_col or c_alias != q_alias:
        return None, "window-column"
    if q_every % c_every != 0:
        return None, "window-misaligned"
    if (q_origin - c_origin) % c_every != 0:
        return None, "window-origin"
    return {
        "kind": "fold",
        "window": (q_alias, int(q_every), int(q_origin)),
    }, None


def _match_fold(cand, query, meta):
    """Key-fold, aggregate projection and zone-proof match of two plain
    views.  ``meta`` is ``{filename: {col: {"kind", "zones", "nulls"}}}``,
    the candidate's build census."""
    if not set(query["keys"]) <= set(cand["keys"]):
        return None, "keys"
    dropped = [k for k in cand["keys"] if k not in query["keys"]]
    for k in dropped:
        for fname in query["filenames"]:
            info = ((meta or {}).get(fname) or {}).get(k)
            if not info or info.get("kind") != "int" or info.get("nulls"):
                return None, f"key-nullable:{k}"
    cand_aggs = list(cand["aggs"])
    agg_idx = []
    for agg in query["aggs"]:
        if agg not in cand_aggs:
            return None, f"agg-missing:{agg[2]}"
        agg_idx.append(cand_aggs.index(agg))
    c_where, q_where = set(cand["where"]), set(query["where"])
    if not c_where <= q_where:
        return None, "filter-weaker"
    extra = [t for t in query["where"] if t not in c_where]
    for term in extra:
        for fname in query["filenames"]:
            if not term_full_selects((meta or {}).get(fname), term):
                return None, f"filter-partial:{term[0]}"
    transform = {"kind": "fold"}
    if tuple(query["keys"]) != tuple(cand["keys"]):
        transform["keys"] = tuple(query["keys"])
    if agg_idx != list(range(len(cand_aggs))):
        transform["aggs"] = tuple(agg_idx)
    if len(transform) == 1:
        # the same shape: verbatim, exact or justified by zone proofs
        transform = {"kind": "zone" if extra else "exact"}
    return transform, None


def match(cand, query, meta=None):
    """Match one candidate view against a query view: ``(transform,
    None)`` or ``(None, reason)``.  ``transform["kind"]`` is ``"exact"``
    (serve the stored bytes), ``"zone"`` (the same, by zone proofs) or
    ``"fold"`` (re-key and/or project, then collapse)."""
    if cand["filenames"] != query["filenames"]:
        return None, "filenames"
    if cand["aggregate_rows"] != query["aggregate_rows"] or (
        cand["expand"] != query["expand"]
    ):
        return None, "shape"
    if cand == query:
        return {"kind": "exact"}, None
    c_dag, q_dag = cand["dag_sig"], query["dag_sig"]
    if (c_dag is None) != (q_dag is None):
        return None, "shape"
    if c_dag is not None:
        return _match_window(cand, query)
    return _match_fold(cand, query, meta)


def apply_transform(payload, transform):
    """Apply a match transform to ONE partials payload dict.  ``exact``
    and ``zone`` pass it through; ``fold`` projects the aggregation slots,
    re-keys (window re-floor, key-column drop) and collapses duplicate key
    tuples through :func:`bqueryd_tpu_torch.parallel.hostmerge.
    collapse_partials`, the merge every cross-shard combine uses."""
    import numpy as np

    from bqueryd_tpu_torch.parallel import hostmerge

    if payload.get("kind") != "partials" or transform["kind"] != "fold":
        return payload
    p = dict(payload)
    sel = transform.get("aggs")
    if sel is not None:
        p["aggs"] = [payload["aggs"][i] for i in sel]
        p["ops"] = [payload["ops"][i] for i in sel]
        p["out_cols"] = [payload["out_cols"][i] for i in sel]
        kinds = payload.get("value_kinds")
        if kinds is not None:
            p["value_kinds"] = [kinds[i] for i in sel]
    window = transform.get("window")
    if window is not None:
        alias, every, origin = window
        arr = np.asarray(p["keys"][alias])
        ints = arr.astype(np.int64, copy=False)
        floored = origin + ((ints - origin) // every) * every
        # NaT bucket keys (int64 min) pass through: the window derivation
        # drops NaT rows, so none should be there
        nat = ints == np.iinfo(np.int64).min
        if nat.any():
            floored = np.where(nat, ints, floored)
        keys = dict(p["keys"])
        keys[alias] = (
            floored.view(arr.dtype) if arr.dtype.kind == "M"
            else floored.astype(arr.dtype)
        )
        p["keys"] = keys
    keep = transform.get("keys")
    if keep is not None:
        p["key_cols"] = list(keep)
        p["keys"] = {c: p["keys"][c] for c in keep}
    return hostmerge.collapse_partials(p)


def serving_cost(groups, out_groups):
    """Relative cost of answering from a G-group partial (a host fold)."""
    from bqueryd_tpu_torch.plan import calibrate

    return calibrate.analytic_units("scatter", groups, max(out_groups, 1))


def recompute_cost(total_rows, out_groups):
    """Relative cost of the dispatch path scanning ``total_rows`` again."""
    from bqueryd_tpu_torch.plan import calibrate

    return calibrate.analytic_units(
        "scatter", max(total_rows, 1), max(out_groups, 1)
    )


def choose_source(matches, total_rows):
    """The cheapest candidate: ``matches`` is a list of ``(entry_key,
    transform, candidate_group_rows)``; returns the winning tuple, or None
    when a recompute is estimated cheaper than every candidate (tiny
    tables)."""
    best = None
    floor = recompute_cost(total_rows, 1)
    for entry_key, transform, groups in matches:
        cost = serving_cost(groups, 1)
        if cost >= floor:
            continue
        if best is None or cost < best[3]:
            best = (entry_key, transform, groups, cost)
    if best is None:
        return None
    return best[:3]

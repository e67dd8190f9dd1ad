"""Typed operator DAG: the relational surface beyond filter->groupby->agg.

The port's copy of ``bqueryd_tpu/plan/dag.py`` (pure Python and NumPy), so
that a port controller validates a ``query`` spec as the reference
controller does, compiles it to the same DAG with the same signature, and
a port worker reads the wire DAG of either:

* **node types** — :class:`Scan` (fact shards + pushed-down predicates),
  :class:`Filter` (post-join/post-window terms on derived columns),
  :class:`HashJoinBroadcast` (a small dimension table shipped in the
  dispatch envelope; the probe is a gather after factorizing the join
  key), :class:`WindowRollup` (a datetime-bucket derived group key),
  :class:`GroupAgg` (the mergeable groupby kernels), :class:`TopK`
  (per-group top-k: partial = per-shard top-k, merge = k-way re-select)
  and :class:`QuantileSketch` (a fixed-bucket DDSketch-style mergeable
  histogram, merged by bucket-count addition);
* **compile** — :func:`compile_query` turns the ``rpc.query`` spec dict
  into a validated :class:`OperatorDAG`; :func:`dag_from_query` compiles a
  plain :class:`~bqueryd_tpu_torch.models.query.GroupByQuery` into the
  same form, and :meth:`OperatorDAG.plain_groupby_query` round-trips it
  back exactly, so plain groupbys compile through the DAG layer and run on
  the unchanged groupby path;
* **dispatch form** — :func:`groupby_equivalent` derives the
  groupby-shaped ``(plan, kwargs)`` the controller dispatches; the DAG
  itself rides each CalcMessage under the ``dag`` binary envelope key.

Every aggregation is carried in ONE ordered physical agg list
``[[in_col, op_string, out_col], ...]`` where extended ops encode their
parameters in the op string (``"topk:5:largest"``,
``"quantile:0.95:0.01"``): the merged payload is self-describing, so the
client-side merge (:mod:`bqueryd_tpu_torch.parallel.hostmerge`) needs no
side channel to finalize.

Control-plane module: no torch, no pandas.
"""

import os
from dataclasses import dataclass, field

import numpy as np

from bqueryd_tpu_torch.models.query import (
    AGG_OPS,
    MERGEABLE_OPS,
    freeze_value,
    normalize_agg_list,
)
from bqueryd_tpu_torch.utils.env import env_num

DAG_VERSION = 1

#: extended (non-classic) operator prefixes; parameters ride the op string
EXTENDED_OP_PREFIXES = ("topk", "quantile")

#: classic ops a DAG GroupAgg node may carry (``sorted_count_distinct`` is
#: excluded: its run-boundary semantics depend on the physical shard sort
#: order, which derived join/window columns do not preserve)
DAG_CLASSIC_OPS = tuple(op for op in AGG_OPS if op != "sorted_count_distinct")

#: recognized window units (value = nanoseconds)
_WINDOW_UNITS = {
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
    "d": 86400 * 1_000_000_000,
}


class DagValidationError(ValueError):
    """A query spec the DAG compiler refuses.  ``error_class`` is the
    structured class the controller replies (client-side it lands on
    ``RPCError.error_class``): ``"UnsupportedOp"`` for unknown/illegal
    operators, ``"InvalidPlan"`` for structural problems (bad join table,
    bad window spec, colliding output names)."""

    def __init__(self, message, error_class="InvalidPlan"):
        super().__init__(message)
        self.error_class = error_class


def dag_batch_enabled():
    """The ``BQUERYD_TPU_DAG_BATCH`` kill switch (default on): batched
    shard-group dispatch + device-resident merge for extended DAG queries.
    ``0`` keeps the per-shard dispatch + host value-keyed merge, the
    route count_distinct / dict-measure DAGs always take."""
    return os.environ.get("BQUERYD_TPU_DAG_BATCH", "1") != "0"


def dag_batchable(dag):
    """Whether this DAG's aggregations can ride ONE CalcMessage per shard
    group with the device-resident merge: classic mergeable ops plus the
    extended mergeable part kinds (top-k dense re-select, sketch
    bucket-count addition).  ``count_distinct`` (per-group value SETS —
    shipped, not reduce-scattered) and raw-rows keep the per-shard
    dispatch, exactly like they always have on the classic path."""
    if not dag_batch_enabled():
        return False
    if not dag.aggregate_rows:
        return False
    for _in_col, op, _out in dag.aggs:
        kind = parse_op(op)[0]
        if kind not in MERGEABLE_OPS and kind not in EXTENDED_OP_PREFIXES:
            return False
    return True


def topk_limit():
    """Per-group k ceiling (payload growth is k x groups x shards)."""
    return env_num("BQUERYD_TPU_TOPK_LIMIT", 1024, cast=int)


def join_broadcast_limit():
    """Max dimension-table rows shipped in a dispatch envelope.  The
    broadcast join serializes the whole dimension table into every
    CalcMessage; past ~1e5 rows it stops being "small" and belongs in a
    shard."""
    return env_num("BQUERYD_TPU_JOIN_BROADCAST_LIMIT", 100_000, cast=int)


def sketch_alpha():
    """Default relative accuracy of quantile sketches (DDSketch-style
    log-gamma buckets, gamma = (1+alpha)/(1-alpha)): the estimate's
    relative error vs the exact empirical quantile is <= alpha for values
    with magnitude in the sketch's bucketed range (see parallel.opexec).
    An out-of-range override degrades to the shipped default, matching the
    env contract everywhere else."""
    alpha = env_num("BQUERYD_TPU_SKETCH_ALPHA", 0.01, cast=float)
    return alpha if 0.0 < alpha < 0.5 else 0.01


# -- op strings ---------------------------------------------------------------

def make_topk_op(k, largest=True):
    return f"topk:{int(k)}:{'largest' if largest else 'smallest'}"


def make_quantile_op(q, alpha=None):
    alpha = sketch_alpha() if alpha is None else float(alpha)
    return f"quantile:{float(q)!r}:{alpha!r}"


def parse_op(op):
    """Decompose an op string: ``("sum",)`` / ``("topk", k, largest)`` /
    ``("quantile", q, alpha)``.  Raises :class:`DagValidationError` for
    malformed extended ops; classic strings pass through unparsed."""
    if not isinstance(op, str) or ":" not in op:
        return (op,)
    head, _, rest = op.partition(":")
    if head == "topk":
        parts = rest.split(":")
        try:
            k = int(parts[0])
            largest = {"largest": True, "smallest": False}[parts[1]]
        except (IndexError, KeyError, ValueError):
            raise DagValidationError(
                f"malformed topk op {op!r} (want 'topk:<k>:largest|smallest')",
                error_class="UnsupportedOp",
            ) from None
        return ("topk", k, largest)
    if head == "quantile":
        parts = rest.split(":")
        try:
            q = float(parts[0])
            alpha = float(parts[1]) if len(parts) > 1 else sketch_alpha()
        except (IndexError, ValueError):
            raise DagValidationError(
                f"malformed quantile op {op!r} (want 'quantile:<q>[:<alpha>]')",
                error_class="UnsupportedOp",
            ) from None
        return ("quantile", q, alpha)
    return (op,)


def is_extended_op(op):
    return isinstance(op, str) and op.partition(":")[0] in EXTENDED_OP_PREFIXES


# -- node types ---------------------------------------------------------------

@dataclass
class Scan:
    """Fact-table scan: the shard files plus the predicate conjunction that
    pushes down to them (plan-time shard pruning + in-scan masking)."""
    filenames: list
    pushdown: list = field(default_factory=list)


@dataclass
class HashJoinBroadcast:
    """Broadcast hash join of a small dimension table (inner).

    ``table`` is ``{col: np.ndarray}`` with unique values in ``right_on``;
    the fact side factorizes ``on`` and probes as a gather (one lookup per
    DISTINCT key, one gather per row).  Rows whose key is absent from the
    dimension table are dropped (inner-join semantics — document per the
    README's join size/shape limits)."""
    on: str
    right_on: str
    table: dict
    select: list = field(default_factory=list)

    def n_rows(self):
        return len(next(iter(self.table.values()))) if self.table else 0


@dataclass
class WindowRollup:
    """Datetime-bucket derived group key: ``alias`` = ``column`` floored to
    ``every_ns`` boundaries (epoch-anchored plus ``origin_ns``).  NaT rows
    carry a null key and drop from the rollup, like any null group key."""
    column: str
    every_ns: int
    alias: str
    origin_ns: int = 0


@dataclass
class Filter:
    """Post-derivation filter: terms that reference join-selected or
    window-derived columns, evaluated AFTER those nodes run.  Fact-column
    terms belong in the scan pushdown instead (prunable)."""
    terms: list = field(default_factory=list)


@dataclass
class GroupAgg:
    """The classic mergeable aggregation stage (existing kernels,
    unchanged): every ``[in, op, out]`` with a classic op."""
    keys: list
    aggs: list = field(default_factory=list)


@dataclass
class TopK:
    """Per-group top-k of one measure, via the sort route.  Partial =
    per-shard top-k (flat values/offsets), merge = k-way re-select —
    mergeable, bounded at k x groups values per payload."""
    in_col: str
    out_col: str
    k: int
    largest: bool = True


@dataclass
class QuantileSketch:
    """Mergeable per-group quantile sketch: DDSketch-style log-gamma
    buckets (gamma = (1+alpha)/(1-alpha)) whose cross-shard/worker merge
    is bucket-count addition; the estimate carries <= alpha relative error
    vs the exact empirical quantile (lower order statistic)."""
    in_col: str
    out_col: str
    q: float
    alpha: float


@dataclass
class OperatorDAG:
    """The compiled operator DAG of one query.

    Structurally the pipeline is ``scan -> [join] -> [window] -> [filter]
    -> group stage``, with the group stage fanning out to one
    :class:`GroupAgg` node (all classic ops) plus one :class:`TopK` /
    :class:`QuantileSketch` node per extended aggregation; ``nodes()`` /
    ``edges()`` materialize that graph.  The
    ordered ``aggs`` list (``[[in, op_string, out], ...]``) is the output
    contract: payload agg order, finalize order, and the wire op strings.
    """
    scan: Scan
    group_keys: list
    aggs: list                              # ordered [[in, op_string, out]]
    join: HashJoinBroadcast = None
    window: WindowRollup = None
    filter: Filter = None
    aggregate_rows: bool = True             # False = raw-rows (plain only)
    expand_filter_column: str = None        # plain-groupby passthrough
    sole_payload: bool = False              # plain-groupby passthrough

    # -- structure ----------------------------------------------------------
    def nodes(self):
        """``{node_id: node}`` in pipeline order; agg-stage nodes are
        ``group`` plus ``topk:<out>`` / ``quantile:<out>`` per extended
        aggregation."""
        out = {"scan": self.scan}
        if self.join is not None:
            out["join"] = self.join
        if self.window is not None:
            out["window"] = self.window
        if self.filter is not None and self.filter.terms:
            out["filter"] = self.filter
        classic = [a for a in self.aggs if not is_extended_op(a[1])]
        out["group"] = GroupAgg(keys=list(self.group_keys), aggs=classic)
        for in_col, op, out_col in self.aggs:
            parsed = parse_op(op)
            if parsed[0] == "topk":
                out[f"topk:{out_col}"] = TopK(
                    in_col, out_col, parsed[1], parsed[2]
                )
            elif parsed[0] == "quantile":
                out[f"quantile:{out_col}"] = QuantileSketch(
                    in_col, out_col, parsed[1], parsed[2]
                )
        return out

    def edges(self):
        """``[(src_id, dst_id), ...]``: the linear derivation spine plus the
        group stage's fan-out to each per-aggregation node."""
        nodes = self.nodes()
        spine = [
            nid for nid in ("scan", "join", "window", "filter")
            if nid in nodes
        ]
        edges = list(zip(spine, spine[1:]))
        last = spine[-1]
        for nid in nodes:
            if nid == "group" or nid.startswith(("topk:", "quantile:")):
                edges.append((last, nid))
        return edges

    def is_plain(self):
        """True when this DAG is exactly the historical groupby shape —
        no join, no window, no post-derivation filter, classic ops only."""
        return (
            self.join is None
            and self.window is None
            and (self.filter is None or not self.filter.terms)
            and not any(is_extended_op(a[1]) for a in self.aggs)
        )

    def plain_groupby_query(self):
        """The exact :class:`GroupByQuery` a plain DAG round-trips to (None
        for extended shapes).  The round trip is field-for-field — the
        worker executes plain DAGs through the UNCHANGED engine path, so
        plain groupbys stay bit-identical (and result-cache-compatible)
        with the pre-DAG sequence."""
        if not self.is_plain():
            return None
        from bqueryd_tpu_torch.models.query import GroupByQuery

        return GroupByQuery(
            list(self.group_keys),
            [list(a) for a in self.aggs],
            [tuple(t) for t in self.scan.pushdown],
            aggregate=self.aggregate_rows,
            expand_filter_column=self.expand_filter_column,
            sole_payload=self.sole_payload,
        )

    # -- identity -----------------------------------------------------------
    def derive_signature(self):
        """Hashable identity of the derivation pipeline alone: group keys,
        pushdown, join content, window geometry and post-derivation filter,
        but not the agg list.  The fast path's working-set entries (join
        probe, window buckets, folded codes) live under it, so two DAGs
        that differ only in their measures share one decode, alignment and
        upload."""
        full = self.signature()
        # ("dag", version, group_keys, aggs, pushdown, filter, join, window,
        #  aggregate_rows, expand, sole): drop the agg list (index 3)
        return full[:3] + full[4:]

    def signature(self):
        """Hashable identity (result-cache key component; folded into the
        logical plan's signature so DAG queries never dedup-fuse with a
        plain groupby over the same fact projection)."""
        join_sig = None
        if self.join is not None:
            join_sig = (
                self.join.on,
                self.join.right_on,
                tuple(sorted(
                    (c, freeze_value(np.asarray(v)))
                    for c, v in self.join.table.items()
                )),
                tuple(self.join.select),
            )
        window_sig = None
        if self.window is not None:
            window_sig = (
                self.window.column, int(self.window.every_ns),
                self.window.alias, int(self.window.origin_ns),
            )
        return (
            "dag", DAG_VERSION,
            tuple(self.group_keys),
            freeze_value(self.aggs),
            freeze_value([tuple(t) for t in self.scan.pushdown]),
            freeze_value(
                [tuple(t) for t in (self.filter.terms if self.filter else [])]
            ),
            join_sig,
            window_sig,
            bool(self.aggregate_rows),
            self.expand_filter_column,
            bool(self.sole_payload),
        )

    # -- wire form ----------------------------------------------------------
    def to_wire(self):
        wire = {
            "v": DAG_VERSION,
            "filenames": list(self.scan.filenames),
            "pushdown": [list(t) for t in self.scan.pushdown],
            "group_keys": list(self.group_keys),
            "aggs": [list(a) for a in self.aggs],
            "aggregate_rows": bool(self.aggregate_rows),
            "expand_filter_column": self.expand_filter_column,
            "sole": bool(self.sole_payload),
        }
        if self.filter is not None and self.filter.terms:
            wire["filter"] = [list(t) for t in self.filter.terms]
        if self.join is not None:
            wire["join"] = {
                "on": self.join.on,
                "right_on": self.join.right_on,
                "table": {
                    c: np.asarray(v) for c, v in self.join.table.items()
                },
                "select": list(self.join.select),
            }
        if self.window is not None:
            wire["window"] = {
                "column": self.window.column,
                "every_ns": int(self.window.every_ns),
                "alias": self.window.alias,
                "origin_ns": int(self.window.origin_ns),
            }
        return wire

    @classmethod
    def from_wire(cls, wire):
        if wire.get("v") != DAG_VERSION:
            raise DagValidationError(
                f"unknown DAG version {wire.get('v')!r} (this worker speaks "
                f"v{DAG_VERSION})"
            )
        join = None
        if wire.get("join"):
            j = wire["join"]
            join = HashJoinBroadcast(
                on=j["on"], right_on=j["right_on"],
                table={c: np.asarray(v) for c, v in j["table"].items()},
                select=list(j["select"]),
            )
        window = None
        if wire.get("window"):
            w = wire["window"]
            window = WindowRollup(
                column=w["column"], every_ns=int(w["every_ns"]),
                alias=w["alias"], origin_ns=int(w.get("origin_ns", 0)),
            )
        dag = cls(
            scan=Scan(
                filenames=list(wire["filenames"]),
                pushdown=[tuple(t) for t in wire.get("pushdown", [])],
            ),
            group_keys=list(wire["group_keys"]),
            aggs=[list(a) for a in wire["aggs"]],
            join=join,
            window=window,
            filter=Filter(
                terms=[tuple(t) for t in wire.get("filter", [])]
            ) if wire.get("filter") else None,
            aggregate_rows=bool(wire.get("aggregate_rows", True)),
            expand_filter_column=wire.get("expand_filter_column"),
            sole_payload=bool(wire.get("sole")),
        )
        validate_dag(dag)
        return dag


# -- validation ---------------------------------------------------------------

def parse_window_every(every):
    """``"1h"`` / ``"30m"`` / ``"90s"`` / ``"1d"`` (or a plain number of
    seconds) -> nanoseconds."""
    if isinstance(every, (int, float)) and not isinstance(every, bool):
        ns = int(float(every) * 1_000_000_000)
    elif isinstance(every, str) and every[-1:] in _WINDOW_UNITS:
        try:
            ns = int(float(every[:-1]) * _WINDOW_UNITS[every[-1]])
        except ValueError:
            raise DagValidationError(
                f"malformed window every {every!r}"
            ) from None
    else:
        raise DagValidationError(
            f"malformed window every {every!r} (want e.g. '1h', '30m', "
            f"'90s', '1d', or seconds)"
        )
    if ns <= 0:
        raise DagValidationError(f"window every must be positive, got {every!r}")
    return ns


def validate_dag(dag):
    """Typed validation of a compiled DAG; raises
    :class:`DagValidationError`.  Checks everything resolvable without the
    fact schema (fact-column existence is validated at shard-open time by
    the executor, which has the table)."""
    derived = set()
    if dag.join is not None:
        j = dag.join
        if not j.table or j.right_on not in j.table:
            raise DagValidationError(
                f"join table must contain the join key {j.right_on!r}"
            )
        lengths = {len(np.asarray(v)) for v in j.table.values()}
        if len(lengths) != 1:
            raise DagValidationError("join table columns have unequal lengths")
        n = j.n_rows()
        if n == 0:
            raise DagValidationError("join table is empty")
        limit = join_broadcast_limit()
        if n > limit:
            raise DagValidationError(
                f"join table has {n} rows, above the broadcast limit {limit} "
                f"(BQUERYD_TPU_JOIN_BROADCAST_LIMIT); store it as a shard "
                f"instead"
            )
        keys = np.asarray(j.table[j.right_on])
        if len(np.unique(keys)) != len(keys):
            raise DagValidationError(
                f"join key {j.right_on!r} has duplicate values: the "
                f"broadcast hash join requires a unique dimension key"
            )
        missing = [c for c in j.select if c not in j.table]
        if missing:
            raise DagValidationError(
                f"join select columns absent from the table: {missing}"
            )
        if j.on in j.select:
            raise DagValidationError(
                f"join select column {j.on!r} collides with the fact join key"
            )
        derived.update(j.select)
    if dag.window is not None:
        if dag.window.every_ns <= 0:
            raise DagValidationError("window every_ns must be positive")
        if dag.window.alias in derived:
            raise DagValidationError(
                f"window alias {dag.window.alias!r} collides with a "
                f"join-selected column"
            )
        if dag.window.alias == dag.window.column:
            raise DagValidationError(
                "window alias must differ from its source column"
            )
        derived.add(dag.window.alias)
    if not dag.aggregate_rows and not dag.is_plain():
        raise DagValidationError(
            "aggregate=False (raw rows) is only supported for plain "
            "filter->groupby shapes",
            error_class="UnsupportedOp",
        )
    out_names = list(dag.group_keys) + [a[2] for a in dag.aggs]
    if len(set(out_names)) != len(out_names):
        raise DagValidationError(
            f"output column names collide: {out_names}"
        )
    if dag.aggregate_rows and not dag.group_keys:
        raise DagValidationError("groupby keys must not be empty")
    for in_col, op, _out in dag.aggs:
        parsed = parse_op(op)
        kind = parsed[0]
        if kind == "topk":
            k = parsed[1]
            if not 1 <= k <= topk_limit():
                raise DagValidationError(
                    f"topk k={k} outside [1, {topk_limit()}] "
                    f"(BQUERYD_TPU_TOPK_LIMIT)",
                    error_class="UnsupportedOp",
                )
        elif kind == "quantile":
            q, alpha = parsed[1], parsed[2]
            if not 0.0 < q < 1.0:
                raise DagValidationError(
                    f"quantile q={q} outside (0, 1)",
                    error_class="UnsupportedOp",
                )
            if not 0.0 < alpha < 0.5:
                raise DagValidationError(
                    f"quantile alpha={alpha} outside (0, 0.5)",
                    error_class="UnsupportedOp",
                )
        elif kind not in DAG_CLASSIC_OPS:
            raise DagValidationError(
                f"unsupported aggregation op {op!r} on {in_col!r}; "
                f"supported: {DAG_CLASSIC_OPS + EXTENDED_OP_PREFIXES}",
                error_class="UnsupportedOp",
            )
    return dag


# -- compilation --------------------------------------------------------------

def dag_from_query(query, filenames=()):
    """Plain :class:`GroupByQuery` -> DAG.  The inverse of
    :meth:`OperatorDAG.plain_groupby_query`; the pair is an exact field
    round trip (asserted over the fuzz corpus), which is what lets the
    worker compile EVERY groupby through the DAG layer while plain shapes
    keep executing on the unchanged engine."""
    return OperatorDAG(
        scan=Scan(
            filenames=list(filenames),
            pushdown=[tuple(t) for t in (query.where_terms or [])],
        ),
        group_keys=list(query.groupby_cols),
        aggs=[list(a) for a in query.agg_list],
        aggregate_rows=bool(query.aggregate),
        expand_filter_column=query.expand_filter_column,
        sole_payload=bool(query.sole_payload),
    )


def compile_query(spec):
    """The ``rpc.query`` verb's compiler: spec dict -> validated DAG.

    Spec shape (see README "Relational operators")::

        {
          "table": "facts.bcolz" | ["s0.bcolz", ...],
          "groupby": ["region",
                      {"window": {"on": "ts", "every": "1h",
                                  "alias": "ts_hour"}}],
          "aggs": [["amount", "sum", "total"],
                   ["amount", "topk", "top3", {"k": 3, "largest": True}],
                   ["amount", "quantile", "p95", {"q": 0.95}]],
          "where": [["amount", ">", 0], ["region", "==", "emea"]],
          "join": {"table": {"cust": [...], "region": [...]},
                   "on": "cust", "select": ["region"]},
        }

    ``where`` terms are split automatically: terms on fact columns push
    down to the scan (prunable against advertised shard stats), terms on
    join-selected / window-derived columns become the post-derivation
    filter node.
    """
    if not isinstance(spec, dict):
        raise DagValidationError("query spec must be a dict")
    unknown = set(spec) - {"table", "groupby", "aggs", "where", "join"}
    if unknown:
        raise DagValidationError(f"unknown query spec keys: {sorted(unknown)}")
    filenames = spec.get("table")
    if isinstance(filenames, str):
        filenames = [filenames]
    if not filenames:
        raise DagValidationError("query spec needs a 'table'")
    filenames = list(dict.fromkeys(filenames))

    join = None
    if spec.get("join") is not None:
        j = spec["join"]
        if not isinstance(j, dict) or "table" not in j or "on" not in j:
            raise DagValidationError(
                "join spec needs {'table': {col: values}, 'on': fact_col}"
            )
        table = {c: np.asarray(v) for c, v in j["table"].items()}
        right_on = j.get("right_on", j["on"])
        select = list(j.get("select", [c for c in table if c != right_on]))
        join = HashJoinBroadcast(
            on=j["on"], right_on=right_on, table=table, select=select
        )

    window = None
    group_keys = []
    for entry in spec.get("groupby") or []:
        if isinstance(entry, str):
            group_keys.append(entry)
            continue
        if isinstance(entry, dict) and "window" in entry:
            if window is not None:
                raise DagValidationError(
                    "at most one window rollup per query"
                )
            w = entry["window"]
            if not isinstance(w, dict) or "on" not in w or "every" not in w:
                raise DagValidationError(
                    "window spec needs {'on': datetime_col, 'every': '1h'}"
                )
            every_ns = parse_window_every(w["every"])
            alias = w.get("alias") or f"{w['on']}_{w['every']}"
            origin_ns = int(w.get("origin_ns", 0))
            window = WindowRollup(
                column=w["on"], every_ns=every_ns, alias=alias,
                origin_ns=origin_ns,
            )
            group_keys.append(alias)
            continue
        raise DagValidationError(f"malformed groupby entry {entry!r}")

    aggs = []
    for agg in spec.get("aggs") or []:
        agg = list(agg)
        if len(agg) == 4 and isinstance(agg[3], dict):
            in_col, op, out_col, params = agg
            if op == "topk":
                op = make_topk_op(
                    params.get("k", 1), params.get("largest", True)
                )
            elif op == "quantile":
                if "q" not in params:
                    raise DagValidationError(
                        "quantile agg needs params {'q': <0..1>}",
                        error_class="UnsupportedOp",
                    )
                op = make_quantile_op(params["q"], params.get("alpha"))
            else:
                raise DagValidationError(
                    f"op {op!r} takes no params dict",
                    error_class="UnsupportedOp",
                )
            aggs.append([in_col, op, out_col])
        elif len(agg) == 3:
            aggs.append([agg[0], agg[1], agg[2]])
        else:
            raise DagValidationError(
                f"malformed agg {agg!r} (want [in, op, out] or "
                f"[in, op, out, params])"
            )
    if not aggs:
        raise DagValidationError("query spec needs at least one agg")
    # classic shorthand normalization on the classic subset only
    aggs = [
        a if is_extended_op(a[1]) else normalize_agg_list([a])[0]
        for a in aggs
    ]

    derived = set(join.select) if join is not None else set()
    if window is not None:
        derived.add(window.alias)
    pushdown, post = [], []
    for term in spec.get("where") or []:
        term = tuple(term)
        if len(term) != 3:
            raise DagValidationError(f"malformed where term {term!r}")
        (post if term[0] in derived else pushdown).append(term)

    dag = OperatorDAG(
        scan=Scan(filenames=filenames, pushdown=pushdown),
        group_keys=group_keys,
        aggs=aggs,
        join=join,
        window=window,
        filter=Filter(terms=post) if post else None,
    )
    validate_dag(dag)
    return dag


def groupby_equivalent(dag):
    """The groupby-shaped ``(LogicalPlan, kwargs)`` the controller's
    existing machinery dispatches: the plan carries the fact-side scan /
    pushdown (shard pruning works unchanged), the ordered physical agg
    list (extended op strings included), and the DAG signature folded into
    the plan signature (dedup/supersede can never confuse a DAG query with
    a plain groupby of the same projection).  ``kwargs`` carries the wire
    DAG under ``"dag"`` plus the batching eligibility: device-mergeable
    part kinds (classic + top-k + sketch) ship ONE CalcMessage per shard
    group — the same ``_shard_groups`` path, failover and hedging
    semantics as plain groupbys — while count_distinct / raw-rows shapes
    (and everything under ``BQUERYD_TPU_DAG_BATCH=0``) keep the
    per-shard dispatch with the host value-keyed merge."""
    from bqueryd_tpu_torch.plan.logical import plan_groupby

    plan = plan_groupby(
        list(dag.scan.filenames),
        list(dag.group_keys),
        [list(a) for a in dag.aggs],
        [list(t) for t in dag.scan.pushdown],
        aggregate=dag.aggregate_rows,
    )
    plan.dag_sig = dag.signature()
    return plan, {"batch": dag_batchable(dag), "dag": dag.to_wire()}

"""Logical query plans: the typed form of a ``groupby`` RPC.

The port's copy of the part of ``bqueryd_tpu/plan/logical.py`` that the
controller and the worker need, so that a port controller sends the same
rewritten plan fragment as the reference controller, and a port worker
reads the fragment of either:

* ``plan_groupby`` compiles the RPC arguments into a node pipeline
  ``Scan -> Filter -> GroupBy -> Aggregate -> Project`` and rewrites it:
  ``predicate_pushdown`` moves the filter terms into the scan, and
  ``mean_decomposition`` lowers ``mean`` into ``sum`` + ``count`` partials
  plus a divide in the project node, sharing duplicate primitives;
* ``fragment_for`` cuts the per-dispatch slice of a plan (one shard group,
  the sole-payload flag) into a small
  pickle-friendly dict that a ``CalcMessage`` carries under ``plan``;
  ``fragment_to_query`` rebuilds the worker's ``GroupByQuery`` from it.
"""

from dataclasses import dataclass, field

from bqueryd_tpu_torch.models.query import (
    GroupByQuery,
    freeze_value,
    normalize_agg_list,
)

PLAN_VERSION = 1


@dataclass
class ScanNode:
    filenames: list
    columns: list                       # every column the query touches
    pushdown: list = field(default_factory=list)  # where terms pushed down


@dataclass
class FilterNode:
    terms: list = field(default_factory=list)


@dataclass
class GroupByNode:
    keys: list = field(default_factory=list)


@dataclass
class AggregateNode:
    #: [[in_col, op, slot], ...] — primitive partials after rewriting
    aggs: list = field(default_factory=list)


@dataclass
class ProjectNode:
    #: ordered [(out_col, expr)]; expr is ("slot", name) or
    #: ("div", numerator_slot, denominator_slot)
    exprs: list = field(default_factory=list)


@dataclass
class LogicalPlan:
    scan: ScanNode
    filter: FilterNode
    groupby: GroupByNode
    aggregate: AggregateNode
    project: ProjectNode
    aggregate_rows: bool = True         # the RPC ``aggregate=`` kwarg
    expand_filter_column: str = None
    rewrites: list = field(default_factory=list)  # applied rule names
    dag_sig: tuple = None               # OperatorDAG.signature() of a query

    @property
    def filenames(self):
        return self.scan.filenames

    @property
    def where_terms(self):
        """The filter conjunction wherever its terms currently live."""
        return list(self.scan.pushdown) + list(self.filter.terms)

    def physical_agg_list(self):
        """The engine-facing agg list, rebuilt from the rewritten aggregate
        and project nodes in the original output order.  A decomposed mean
        comes back as ``[in, 'mean', out]``: the kernels' mean partial
        already carries (sum, count)."""
        by_slot = {slot: (in_col, op) for in_col, op, slot in self.aggregate.aggs}
        out = []
        for out_col, expr in self.project.exprs:
            if expr[0] == "slot":
                in_col, op = by_slot[expr[1]]
                out.append([in_col, op, out_col])
            elif expr[0] == "div":
                in_col, _op = by_slot[expr[1]]
                out.append([in_col, "mean", out_col])
            else:
                raise ValueError(f"unknown project expr {expr!r}")
        return out

    def signature(self):
        """Hashable identity of the plan minus the shard set: two queries
        with equal signatures over the same shard group compute identical
        payloads.  The last field is the operator DAG's signature
        (``dag_sig``, set by :func:`bqueryd_tpu_torch.plan.dag.
        groupby_equivalent`), None for a plain groupby: a DAG's join
        table, window and post-derivation filter are invisible to the
        groupby-shaped fields."""
        return (
            tuple(self.groupby.keys),
            freeze_value(self.physical_agg_list()),
            freeze_value(self.where_terms),
            bool(self.aggregate_rows),
            self.expand_filter_column,
            self.dag_sig,
        )


def compile_groupby(filenames, groupby_cols, agg_list, where_terms=None,
                    aggregate=True, expand_filter_column=None):
    """RPC arguments -> un-rewritten LogicalPlan.  Filenames are
    deduplicated, order-preserving: a duplicate would count twice on a
    batched dispatch."""
    if isinstance(filenames, str):
        filenames = [filenames]
    filenames = list(dict.fromkeys(filenames))
    aggs = normalize_agg_list(agg_list)
    where_terms = [tuple(t) for t in (where_terms or [])]
    columns = list(dict.fromkeys(
        list(groupby_cols)
        + [a[0] for a in aggs]
        + [t[0] for t in where_terms]
        + ([expand_filter_column] if expand_filter_column else [])
    ))
    return LogicalPlan(
        scan=ScanNode(filenames=filenames, columns=columns),
        filter=FilterNode(terms=where_terms),
        groupby=GroupByNode(keys=list(groupby_cols)),
        aggregate=AggregateNode(aggs=[list(a) for a in aggs]),
        project=ProjectNode(),
        aggregate_rows=aggregate,
        expand_filter_column=expand_filter_column,
    )


def _rule_predicate_pushdown(plan):
    """Filter terms -> scan pushdown: the conjunction is evaluated inside
    the scan."""
    if not plan.filter.terms:
        return False
    plan.scan.pushdown = list(plan.scan.pushdown) + list(plan.filter.terms)
    plan.filter.terms = []
    return True


def _rule_mean_decomposition(plan):
    """``mean`` -> primitive ``sum`` + ``count`` partials and a
    project-time divide; duplicate primitives over the same input column
    are shared."""
    slots = {}       # (in_col, op) -> slot name
    new_aggs = []
    exprs = []
    changed = False

    def slot_for(in_col, op):
        nonlocal changed
        key = (in_col, op)
        if key not in slots:
            slots[key] = f"__{in_col}__{op}"
            new_aggs.append([in_col, op, slots[key]])
        else:
            changed = True  # a primitive is shared between outputs
        return slots[key]

    for in_col, op, out_col in plan.aggregate.aggs:
        if op == "mean":
            changed = True
            s = slot_for(in_col, "sum")
            c = slot_for(in_col, "count")
            exprs.append((out_col, ("div", s, c)))
        else:
            exprs.append((out_col, ("slot", slot_for(in_col, op))))
    plan.aggregate.aggs = new_aggs
    plan.project.exprs = exprs
    return changed


#: rule pipeline, applied in order by rewrite_plan
REWRITE_RULES = (
    ("predicate_pushdown", _rule_predicate_pushdown),
    ("mean_decomposition", _rule_mean_decomposition),
)


def rewrite_plan(plan):
    """Apply every rewrite rule, recording the names of those that fired.
    The project node is always materialized (an identity projection when
    there is no aggregate), so ``physical_agg_list`` round-trips."""
    for name, rule in REWRITE_RULES:
        if rule(plan):
            plan.rewrites.append(name)
    if not plan.project.exprs:
        plan.project.exprs = [
            (out, ("slot", out)) for _in, _op, out in plan.aggregate.aggs
        ]
    return plan


def plan_groupby(filenames, groupby_cols, agg_list, where_terms=None,
                 aggregate=True, expand_filter_column=None):
    """Compile and rewrite in one call (the controller's entry point)."""
    return rewrite_plan(
        compile_groupby(
            filenames, groupby_cols, agg_list, where_terms,
            aggregate=aggregate, expand_filter_column=expand_filter_column,
        )
    )


def fragment_for(plan, filenames, strategy=None, sole=False):
    """The per-dispatch slice of a plan: what ONE CalcMessage executes.
    Its keys are the reference's, so either package's worker reads it.

    ``strategy`` is the controller's kernel-route hint (``plan.strategy``).
    The calibration-backed binding promotion ("matmul!") never rides the
    wire as a strategy value: it ships as the advisory "matmul" plus the
    ``strategy_binding`` flag, which a worker that does not know it
    ignores, degrading to the advisory hint."""
    binding = strategy == "matmul!"
    return {
        "v": PLAN_VERSION,
        "filenames": list(filenames),
        "groupby_cols": list(plan.groupby.keys),
        "agg_list": plan.physical_agg_list(),
        "where_terms": [list(t) for t in plan.where_terms],
        "aggregate": bool(plan.aggregate_rows),
        "expand_filter_column": plan.expand_filter_column,
        "sole": bool(sole),
        "strategy": "matmul" if binding else strategy,
        "strategy_binding": binding,
    }


def fragment_to_query(fragment):
    """Rebuild the worker-side GroupByQuery from a plan fragment."""
    return GroupByQuery(
        list(fragment["groupby_cols"]),
        [list(a) for a in fragment["agg_list"]],
        [tuple(t) for t in fragment["where_terms"]],
        aggregate=fragment.get("aggregate", True),
        expand_filter_column=fragment.get("expand_filter_column"),
        sole_payload=bool(fragment.get("sole")),
    )

"""Shared-scan multi-query fusion of the port: the admission micro-batch
window and its bundles.

The port's copy of ``bqueryd_tpu/plan/bundle.py``.  The identical-work
join of the controller fuses only bit-identical concurrent queries.  A
bundle fuses *compatible* ones: the same shard set after pruning and the
same group-key columns, while measures and filters differ.  A compatible
group dispatched together pays the per-scan work (decode, key alignment,
the codes upload, the measure uploads) once and runs one device program
over every member
(:meth:`bqueryd_tpu_torch.parallel.executor.MeshQueryExecutor.
execute_bundle`).

``BQUERYD_TPU_BATCH_WINDOW_MS`` (default 0 = off: every plan launches the
moment it is admitted, as before) holds admitted groupby plans for up to
that many milliseconds, so that concurrent queries land in one flush;
``BQUERYD_TPU_BATCH_MAX`` caps the members of a flush.  The flush groups
plans by :func:`compat_key`; a plan that cannot fuse launches alone.

Each member keeps its own identity end to end: its deadline, quota ticket
and result envelope.  The bundle fragment carries a record per member
(:func:`bundle_fragment`) that the worker's reply is demultiplexed by, and
a member past its deadline is dropped from the stack, never the bundle.

Control-plane module: stdlib and ``models.query`` only (no torch).
"""

from bqueryd_tpu_torch.models.query import MERGEABLE_OPS, GroupByQuery
from bqueryd_tpu_torch.utils.env import env_num

BUNDLE_VERSION = 1


def batch_window_ms():
    """The admission micro-batch window in milliseconds; 0 (the default)
    stages nothing.  Read per query, so that a live controller can be
    re-tuned."""
    return max(env_num("BQUERYD_TPU_BATCH_WINDOW_MS", 0.0), 0.0)


def batch_max():
    """Most member queries one flush may hold; a full window flushes early
    instead of stretching its first member's latency."""
    return max(env_num("BQUERYD_TPU_BATCH_MAX", 16, int), 2)


def compat_key(plan, keep, kwargs):
    """The plan-compatibility signature: queries with equal keys in one
    flush fuse into one bundle.  None for a query that cannot ride a
    bundle (it launches alone):

    * raw rows (``aggregate=False``) and basket expansion: their payloads
      are not per-group partial tables;
    * an op outside ``MERGEABLE_OPS`` (the distinct counts);
    * ``batch=False``: the caller asked for per-shard dispatch;
    * a fully pruned plan: nothing to scan.

    The key leaves out measures, filters and deadlines (fusing across them
    is the point: measures share one union upload, filters become the
    stacked mask axis, deadlines stay per member) and holds the POST-PRUNE
    shard set: queries that prune to different shards scan different
    data.  ``affinity`` stays in the key as in the reference, whose
    clients may pin a query to a worker."""
    if not keep:
        return None
    if not plan.aggregate_rows or plan.expand_filter_column:
        return None
    if not kwargs.get("batch", True):
        return None
    if any(a[1] not in MERGEABLE_OPS for a in plan.physical_agg_list()):
        return None
    return (
        tuple(keep),
        tuple(plan.groupby.keys),
        kwargs.get("affinity"),
    )


def bundle_fragment(plan, filenames, members, strategy=None, sole=False):
    """The per-dispatch slice of a bundle: what one CalcMessage executes
    for a compatible group.  Shared fields (shard group, group-key columns,
    strategy hint) ride once; each member record carries what differs: its
    aggs, its filter, its deadline and the ``member_id`` the reply is
    demultiplexed by.

    ``members`` is ``[(member_id, plan, deadline), ...]``.  A binding
    "matmul!" ships as an advisory "matmul" plus ``strategy_binding``, as
    the reference's plan fragment does."""
    binding = strategy == "matmul!"
    return {
        "v": BUNDLE_VERSION,
        "filenames": list(filenames),
        "groupby_cols": list(plan.groupby.keys),
        "sole": bool(sole),
        "strategy": "matmul" if binding else strategy,
        "strategy_binding": binding,
        "members": [
            {
                "member_id": member_id,
                "agg_list": member_plan.physical_agg_list(),
                "where_terms": [list(t) for t in member_plan.where_terms],
                "deadline": deadline,
            }
            for member_id, member_plan, deadline in members
        ],
    }


def bundle_to_queries(fragment):
    """The worker's member queries of a bundle fragment: ``[(member_id,
    deadline, GroupByQuery), ...]`` in fragment order."""
    if fragment.get("v") != BUNDLE_VERSION:
        raise ValueError(f"unknown bundle version {fragment.get('v')!r}")
    groupby_cols = list(fragment["groupby_cols"])
    sole = bool(fragment.get("sole"))
    return [
        (
            member["member_id"],
            member.get("deadline"),
            GroupByQuery(
                list(groupby_cols),
                [list(a) for a in member["agg_list"]],
                [tuple(t) for t in member["where_terms"]],
                aggregate=True,
                sole_payload=sole,
            ),
        )
        for member in fragment["members"]
    ]


def member_shares(executed_ids, walls=None):
    """Each executed member's share of a bundle's shared scan: ``{member_id:
    share}`` summing to 1.0.  Proportional to the members' own walls where
    the worker measured them (the per-member fallback), else equal (one
    program served everyone).  The controller scales the bundle reply's
    phase timings by it; a result-cache hit is not an executed member."""
    executed = list(executed_ids)
    if not executed:
        return {}
    if walls:
        total = sum(max(float(walls.get(m, 0.0)), 0.0) for m in executed)
        if total > 0.0 and all(
            float(walls.get(m, 0.0)) > 0.0 for m in executed
        ):
            return {m: round(float(walls[m]) / total, 6) for m in executed}
    share = round(1.0 / len(executed), 6)
    return {m: share for m in executed}


def fragment_strategy(fragment):
    """The kernel-strategy hint a bundle fragment carries, or None, with
    the binding promotion ("matmul" plus ``strategy_binding``) rebuilt as
    "matmul!" unless ``BQUERYD_TPU_CALIB=0``, as for a single query's plan
    fragment."""
    strategy = fragment.get("strategy")
    if strategy in (None, "auto"):
        return None
    if strategy == "matmul" and fragment.get("strategy_binding"):
        from bqueryd_tpu_torch.plan import calibrate

        if calibrate.enabled():
            return "matmul!"
    return strategy

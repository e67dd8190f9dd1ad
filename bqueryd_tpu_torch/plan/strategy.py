"""Cost-based kernel-strategy selection from per-shard statistics.

The port's copy of ``bqueryd_tpu/plan/strategy.py``, decision for
decision.  ``ops.partial_tables`` has three device routes for the
mergeable aggregations:

* ``matmul``  -- the one-hot contraction on the CUDA kernels of
  ``ops.onehot`` (up to ``BQUERYD_TPU_MATMUL_GROUPS`` groups on the base
  kernel, int sums past it on the hicard kernel);
* ``scatter`` -- ``index_add_`` / ``scatter_reduce_`` segment reductions;
* ``sort``    -- sort + prefix-diff reduction, whose cost is independent of
  the group count.

The controller chooses per dispatch from the stats workers advertise, and
the hint travels in the plan fragment.  A ``matmul`` hint is advisory;
``scatter`` and ``sort`` are binding (``ops.kernel_route``).  With no
stats the selector returns ``auto``.

Group-cardinality estimation: per key column, shards whose [min, max]
ranges overlap are assumed to share a key domain (their global cardinality
is the max per-shard cardinality); pairwise-disjoint ranges sum
(range-partitioned data).  Multi-key spaces multiply per-column estimates,
capped by the row count.

Control-plane module: stdlib only, so the controller imports it.  The two
environment knobs it reads are the reference's
(``BQUERYD_TPU_MATMUL_GROUPS``, ``BQUERYD_TPU_MATMUL_CELLS``).
"""

import os

STRATEGY_AUTO = "auto"
STRATEGY_HOST = "host"
STRATEGY_MATMUL = "matmul"
STRATEGY_SCATTER = "scatter"
STRATEGY_SORT = "sort"
#: calibration-backed matmul: binding INSIDE the kernel guards: the worker
#: skips only the op/dtype profitability heuristic, while the group and
#: cells guards of the contraction route stand.  Only emitted by
#: :func:`select_calibrated` when measurement backs the matmul route.
STRATEGY_MATMUL_BINDING = "matmul!"

STRATEGIES = (
    STRATEGY_AUTO, STRATEGY_HOST, STRATEGY_MATMUL, STRATEGY_SCATTER,
    STRATEGY_SORT, STRATEGY_MATMUL_BINDING,
)

#: mirrors ops.groupby._SUM_BLOCK / _MAX_BLOCK_SEGMENTS: past 2^25
#: ceil(rows / 65536) x groups blocks the sort route takes over
_SUM_BLOCK = 65536
_MAX_BLOCK_SEGMENTS = 1 << 25


def matmul_groups_limit():
    """The contraction route's group ceiling as the planner sees it."""
    return int(os.environ.get("BQUERYD_TPU_MATMUL_GROUPS", 8192))


def matmul_cells_limit():
    """The contraction route's rows x groups budget as the planner sees
    it."""
    return int(os.environ.get("BQUERYD_TPU_MATMUL_CELLS", 1 << 36))


def _column_card_estimate(stats_list, column):
    """Estimated global distinct count of ``column`` across a shard group,
    or None when any shard lacks the cardinality.  Overlapping value ranges
    -> shared domain (max); disjoint ranges -> partitioned domain (sum)."""
    cards, ranges = [], []
    for stats in stats_list:
        entry = ((stats or {}).get("cols") or {}).get(column)
        if not entry or "card" not in entry:
            return None
        cards.append(int(entry["card"]))
        if entry.get("min") is not None and entry.get("max") is not None:
            ranges.append((entry["min"], entry["max"]))
    if not cards:
        return None
    if len(ranges) == len(cards) and len(ranges) > 1:
        ordered = sorted(ranges)
        disjoint = all(
            ordered[i][1] < ordered[i + 1][0] for i in range(len(ordered) - 1)
        )
        if disjoint:
            return sum(cards)
    return max(cards)


def estimate_groups(stats_list, groupby_cols):
    """Estimated group count of a query over a shard group, or None when the
    stats cannot support an estimate (some shard or key column unknown)."""
    if not stats_list or any(s is None for s in stats_list):
        return None
    total_rows = sum(int(s.get("rows", 0)) for s in stats_list)
    est = 1
    for col in groupby_cols:
        card = _column_card_estimate(stats_list, col)
        if card is None:
            return None
        est *= max(card, 1)
        if est >= total_rows:
            return max(total_rows, 1)  # cannot exceed the row count
    return max(est, 1)


def choose_strategy(total_rows, est_groups):
    """Pick a kernel route from (rows, estimated groups); ``auto`` when the
    estimate is missing or the economics are ambiguous."""
    if est_groups is None or total_rows is None or total_rows <= 0:
        return STRATEGY_AUTO
    limit = matmul_groups_limit()
    if (0 < est_groups <= limit
            and total_rows * est_groups <= matmul_cells_limit()):
        # low cardinality: the one-hot contraction wins; the hint stays
        # advisory (partial_tables applies its own profitability test)
        return STRATEGY_MATMUL
    if est_groups > limit:
        blocks = -(-total_rows // _SUM_BLOCK)
        if blocks * est_groups > _MAX_BLOCK_SEGMENTS:
            # the blocked scatter table would outgrow its HBM budget: the
            # sort + prefix-diff reduction is group-count-independent
            return STRATEGY_SORT
        return STRATEGY_SCATTER
    return STRATEGY_AUTO


def select_for_group(stats_by_file, filenames, groupby_cols):
    """Controller entry point: HEURISTIC strategy hint for one dispatch
    group.  Returns ``(strategy, est_groups, total_rows)``.  Malformed
    advertised stats (a version-skewed worker) degrade to ``auto``, never
    raise: a stats problem must not fail the query it was meant to speed
    up.  The calibrated layer (:func:`select_calibrated`) wraps it and
    falls back here whenever calibration is disabled or cold."""
    stats_list = [
        (stats_by_file or {}).get(f) for f in filenames
    ]
    if any(not isinstance(s, dict) for s in stats_list):
        return STRATEGY_AUTO, None, None
    try:
        total_rows = sum(int(s.get("rows", 0)) for s in stats_list)
        est = estimate_groups(stats_list, groupby_cols)
        return choose_strategy(total_rows, est), est, total_rows
    except (TypeError, ValueError):
        return STRATEGY_AUTO, None, None


def candidate_strategies(total_rows, est_groups):
    """The kernel routes LEGAL at (rows, est groups): scatter and sort are
    always-correct fallbacks; matmul is a candidate only inside the same
    value guards ``ops.partial_tables`` enforces (group ceiling, cells
    budget): calibration may only rank routes the guards would accept."""
    candidates = [STRATEGY_SCATTER, STRATEGY_SORT]
    if (
        est_groups is not None
        and total_rows is not None
        and 0 < est_groups <= matmul_groups_limit()
        and total_rows * est_groups <= matmul_cells_limit()
    ):
        candidates.insert(0, STRATEGY_MATMUL)
    return tuple(candidates)


def select_calibrated(stats_by_file, filenames, groupby_cols,
                      calibration=None):
    """Measured-cost strategy selection: the heuristic choice refined by a
    :class:`~bqueryd_tpu_torch.plan.calibrate.CalibrationStore` when one is
    given
and warm.  Returns ``(strategy, est_groups, total_rows, reason)`` with
    ``reason`` from ``CalibrationStore.choose`` (``cold`` also covers every
    disabled/degraded path).  Decision ladder:

    * no stats / calibration off / cold bucket -> the heuristic, unchanged
      (cold start is bit-identical to :func:`select_for_group`);
    * measurement ranks a route best among the LEGAL candidates -> that
      route; a measured-or-agreeing ``matmul`` is promoted to
      :data:`STRATEGY_MATMUL_BINDING` (binding inside the kernel guards);
    * the deterministic epsilon slot explores an unmeasured legal candidate
      as an ADVISORY hint — exploration never emits the binding form.
    """
    from bqueryd_tpu_torch.plan import calibrate

    strategy, est, total_rows = select_for_group(
        stats_by_file, filenames, groupby_cols
    )
    if (
        calibration is None
        or not calibrate.enabled()
        or est is None
        or total_rows is None
        or strategy not in (STRATEGY_MATMUL, STRATEGY_SCATTER, STRATEGY_SORT)
    ):
        return strategy, est, total_rows, "cold"
    choice, reason = calibration.choose(
        total_rows, est, None, candidate_strategies(total_rows, est),
        strategy,
    )
    if choice == STRATEGY_MATMUL and reason in ("measured", "agree"):
        # measurement backs the contraction route (reason "prior", an
        # analytic extrapolation with no matmul walls, stays advisory):
        # binding inside the group and cells guards
        choice = STRATEGY_MATMUL_BINDING
    return choice, est, total_rows, reason

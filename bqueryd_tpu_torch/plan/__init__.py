"""Query planning of the port: the logical plan the controller compiles
from a ``groupby`` RPC and the per-dispatch fragments it sends workers
(:mod:`bqueryd_tpu_torch.plan.logical`), the operator DAG of the ``query``
verb (:mod:`bqueryd_tpu_torch.plan.dag`), the per-shard statistics workers
advertise and the plan-time and per-chunk pruning tests over them
(:mod:`bqueryd_tpu_torch.plan.stats`), admission control
(:mod:`bqueryd_tpu_torch.plan.admission`), the shared-scan bundles of
the admission micro-batch window (:mod:`bqueryd_tpu_torch.plan.bundle`),
the kernel-strategy hint chosen from those stats
(:mod:`bqueryd_tpu_torch.plan.strategy`) and its measured-cost
calibration from the kernel walls workers gossip
(:mod:`bqueryd_tpu_torch.plan.calibrate`, ``BQUERYD_TPU_CALIB=0``
restores the heuristic).

``BQUERYD_TPU_PLANNER=0`` turns plan-time shard pruning and strategy
hints off."""

import os

from bqueryd_tpu_torch.plan.admission import (  # noqa: F401
    ADMIT,
    BUSY,
    DUPLICATE,
    QUEUED,
    AdmissionController,
)
from bqueryd_tpu_torch.plan.logical import (  # noqa: F401
    LogicalPlan,
    compile_groupby,
    fragment_for,
    fragment_to_query,
    plan_groupby,
    rewrite_plan,
)
from bqueryd_tpu_torch.plan.stats import (  # noqa: F401
    StatsCollector,
    gather_table_stats,
    stats_can_match,
)
from bqueryd_tpu_torch.plan.strategy import (  # noqa: F401
    STRATEGIES,
    STRATEGY_AUTO,
    STRATEGY_MATMUL_BINDING,
    candidate_strategies,
    choose_strategy,
    estimate_groups,
    select_calibrated,
    select_for_group,
)
from bqueryd_tpu_torch.plan import calibrate  # noqa: F401


def planner_enabled():
    """Plan-time shard pruning and strategy hints; on unless
    ``BQUERYD_TPU_PLANNER=0``.  Read per query, so that a live controller
    can be re-tuned."""
    return os.environ.get("BQUERYD_TPU_PLANNER", "1") != "0"

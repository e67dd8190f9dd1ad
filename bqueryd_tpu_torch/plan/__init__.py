"""Query planning of the port: the logical plan the controller compiles
from a ``groupby`` RPC and the per-dispatch fragments it sends workers
(:mod:`bqueryd_tpu_torch.plan.logical`), the operator DAG of the ``query``
verb (:mod:`bqueryd_tpu_torch.plan.dag`), the per-shard statistics workers
advertise and the plan-time and per-chunk pruning tests over them
(:mod:`bqueryd_tpu_torch.plan.stats`), admission control
(:mod:`bqueryd_tpu_torch.plan.admission`) and the shared-scan bundles of
the admission micro-batch window (:mod:`bqueryd_tpu_torch.plan.bundle`).
Strategy selection and its calibration are not ported yet.

``BQUERYD_TPU_PLANNER=0`` turns plan-time shard pruning off."""

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


def planner_enabled():
    """Plan-time shard pruning; on unless ``BQUERYD_TPU_PLANNER=0``.  Read
    per query, so that a live controller can be re-tuned."""
    return os.environ.get("BQUERYD_TPU_PLANNER", "1") != "0"

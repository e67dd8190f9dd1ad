"""Query planning of the port: the logical plan the controller compiles
from a ``groupby`` RPC and the per-dispatch fragments it sends workers
(:mod:`bqueryd_tpu_torch.plan.logical`), the operator DAG of the ``query``
verb (:mod:`bqueryd_tpu_torch.plan.dag`), and the per-chunk zone-map test
of chunk pruning (:mod:`bqueryd_tpu_torch.plan.stats`).  Admission,
advertised shard statistics, strategy calibration and shared-scan bundles
are not ported yet."""

from bqueryd_tpu_torch.plan.logical import (  # noqa: F401
    LogicalPlan,
    compile_groupby,
    fragment_for,
    fragment_to_query,
    plan_groupby,
    rewrite_plan,
)

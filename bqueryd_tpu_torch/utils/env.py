"""Environment overrides for the ``BQUERYD_TPU_*`` timing knobs.

An unset, empty or unparseable override falls back to the caller's
default: a mistyped value degrades to the shipped constant and never takes
a node down at construction time.  The names are the reference package's,
so one deployment configures both packages alike.
"""

import os


def env_num(name, default, cast=float):
    """The override ``name`` when set and parseable, ``default``
    otherwise."""
    # bqtpu: allow[config-dynamic-env-key] callers pass literal registered names: the controller timing knobs (DEAD_WORKER/DISPATCH/DISPATCH_HARD TIMEOUTs, MAX_DISPATCH_RETRIES, HEDGE_MS, REPLICA_FACTOR), plan.admission's ADMIT_* trio, plan.bundle's BATCH_WINDOW_MS/BATCH_MAX, plan.dag's TOPK_LIMIT/JOIN_BROADCAST_LIMIT/SKETCH_ALPHA, obs.capacity's CAPACITY_* and obs.slo's TIMELINE_* knobs; all in ENV_REGISTRY
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return cast(raw)
    except (ValueError, TypeError):
        return default

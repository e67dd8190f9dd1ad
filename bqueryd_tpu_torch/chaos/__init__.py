"""Deterministic fault injection: the seams that make failure testable.

The port's copy of ``bqueryd_tpu/chaos``.  Injection hooks sit in the real
failure seams (the controller's dispatch and reply handling, the worker's
execution and reply, the executor's device entry points, the RPC client's
socket layer, the coordination store) and fire faults from a declarative,
seedable :class:`~bqueryd_tpu_torch.chaos.plan.FaultPlan`.

Arming
------
Only through ``BQUERYD_TPU_FAULT_PLAN`` (a JSON file path or inline JSON,
see ``plan.load_plan``), read when a node is built (every node calls
:func:`maybe_arm_from_env`), or through :func:`arm` for in-process
clusters.  Unarmed costs nothing: every hook goes through :func:`fire`,
whose disarmed path is one module-global ``None`` check.

Determinism
-----------
Rules trigger off counters and a per-rule RNG seeded from the plan's
``seed``: the same plan over the same sequence of calls injects the same
faults.

Error taxonomy
--------------
:class:`TransientError` subclasses (``DeviceBusyError``) are the retryable
class: a worker that catches one replies an ErrorMessage flagged
``transient=True``, and the controller fails the shard over to another
holder instead of aborting the query.  :class:`FaultInjected` (not
transient) exercises the abort path.  Only an injected fault raises
``DeviceBusyError``: no code relabels a real CUDA error as transient.

Standard library only.
"""

import os
import threading

from bqueryd_tpu_torch.chaos.plan import (  # noqa: F401  (public surface)
    SITES,
    Fault,
    FaultPlan,
    FaultPlanError,
    load_plan,
)

__all__ = [
    "SITES", "Fault", "FaultPlan", "FaultPlanError", "load_plan",
    "TransientError", "DeviceBusyError", "FaultInjected",
    "arm", "disarm", "maybe_arm_from_env", "enabled", "fire",
    "injected_total", "site_stats", "plan_stats",
]


class TransientError(RuntimeError):
    """Retryable worker-side failure: the controller re-queues the shard
    onto a different holder (replica failover) instead of aborting the
    parent query."""


class DeviceBusyError(TransientError):
    """The device refused or was busy: the transient fault class that chaos
    injects at worker.execute and worker.device."""


class FaultInjected(RuntimeError):
    """A deliberately injected NON-transient fault (exercises the abort /
    structured-error path end to end)."""


_ERROR_CLASSES = {
    "DeviceBusyError": DeviceBusyError,
    "TransientError": TransientError,
    "FaultInjected": FaultInjected,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
}

#: the active plan; None = disarmed (the ONE attribute the hot path checks)
_plan = None

_stats_lock = threading.Lock()
_injected = {}       # site -> fired count (includes inline delay/raise)
_injected_total = 0


def enabled():
    """True while a fault plan is armed."""
    return _plan is not None


def arm(spec):
    """Compile and arm ``spec`` (dict / inline JSON / path); returns the
    :class:`FaultPlan`.  Replaces any previously armed plan."""
    global _plan
    plan = load_plan(spec)
    _plan = plan
    return plan


def disarm():
    """Disarm fault injection (hooks return to the no-op path)."""
    global _plan
    _plan = None


def maybe_arm_from_env():
    """Arm from ``BQUERYD_TPU_FAULT_PLAN`` when set; called by every node
    constructor.  Unset leaves the current state alone (a plan armed
    programmatically by a test or a smoke run survives node construction).
    A malformed env plan raises — silently injecting nothing would defeat
    the entire harness."""
    spec = os.environ.get("BQUERYD_TPU_FAULT_PLAN")
    if spec:
        arm(spec)
    return _plan


def _count(site):
    global _injected_total
    with _stats_lock:
        _injected[site] = _injected.get(site, 0) + 1
        _injected_total += 1


def fire(site, **ctx):
    """The injection hook: returns a :class:`Fault` for the call site to
    interpret, or None (no fault / disarmed).

    Generic actions are applied here so call sites stay one-liners:
    ``delay`` sleeps ``args.seconds`` and returns None (transparent);
    ``raise`` raises ``args.error`` (a name from the error taxonomy,
    default :class:`FaultInjected`) with ``args.message``.
    """
    plan = _plan
    if plan is None:
        return None
    fault = plan.consider(site, ctx)
    if fault is None:
        return None
    _count(site)
    if fault.action == "delay":
        import time

        time.sleep(float(fault.args.get("seconds", 0.05)))
        return None
    if fault.action == "raise":
        error_cls = _ERROR_CLASSES.get(
            fault.args.get("error", "FaultInjected"), FaultInjected
        )
        raise error_cls(
            fault.args.get(
                "message",
                f"chaos: injected {error_cls.__name__} at {site}",
            )
        )
    return fault


def injected_total():
    """Process-lifetime count of injected faults (all sites) — exported as
    the ``bqueryd_tpu_fault_injected_total`` gauge on every node."""
    with _stats_lock:
        return _injected_total


def site_stats():
    """Per-site injected counts (process lifetime, survives disarm)."""
    with _stats_lock:
        return dict(_injected)


def plan_stats():
    """Per-rule matched/fired counts of the armed plan ([] when disarmed)."""
    plan = _plan
    return plan.stats() if plan is not None else []


def _reset_for_tests():
    """Disarm and zero the stats (test isolation)."""
    global _plan, _injected, _injected_total
    _plan = None
    with _stats_lock:
        _injected = {}
        _injected_total = 0

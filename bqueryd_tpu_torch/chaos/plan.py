"""Fault-plan model: named sites x trigger predicates x actions.

A :class:`FaultPlan` is compiled from a JSON-safe dict (inline JSON string,
file path, or dict — see :func:`load_plan`) and is **deterministic**: given
the same plan (including its ``seed``) and the same sequence of
``fire(site, **ctx)`` calls, the same faults fire in the same order, so a
scenario that failed can be re-run bit for bit.  The port's copy of
``bqueryd_tpu/chaos/plan.py``.

Plan schema (all rule fields optional except ``site`` and ``action``)::

    {
      "seed": 42,                      # plan-wide determinism seed
      "faults": [
        {
          "site":   "worker.execute",  # injection site (fnmatch pattern)
          "action": "raise",           # one of SITES[site]
          "match":  {"verb": "groupby", "worker": "ab12*"},
                                       # ctx predicates: fnmatch for strings,
                                       # equality otherwise; missing ctx key
                                       # means no match
          "args":   {"error": "DeviceBusyError", "seconds": 0.5},
          "times":  1,                 # fire at most N times (0 = unlimited)
          "after":  0,                 # skip the first N matching triggers
          "every":  1,                 # then fire every Nth match
          "probability": 1.0,          # seeded per-rule RNG (deterministic)
          "window_s": 0                # first qualifying match opens the
                                       # window; stays active this many
                                       # seconds, then exhausts for good
                                       # (0 = off).  times/every/probability
                                       # still gate matches INSIDE the window

        }
      ]
    }

Sites and their legal actions are declared in :data:`SITES`; an unknown
site/action fails loudly at **arm** time, never silently at inject time.

Rule state (hit counters, window clocks) is lock-guarded: sites fire from
the controller loop, worker loops, heartbeat threads, and client threads
concurrently.  Standard library only.
"""

import fnmatch
import json
import os
import random
import threading
import time

#: every injection site threaded through the stack, with the actions its
#: call sites understand.  ``delay`` and ``raise`` are interpreted inside
#: ``FaultPlan.fire`` itself but are legal ONLY where a site's tuple lists
#: them — a ``raise`` at a seam that doesn't catch it (e.g. the controller
#: dispatch loop) would lose the message instead of injecting a fault; the
#: rest are returned to the hook for site-specific interpretation.
SITES = {
    # controller -> worker work envelopes (ControllerNode._send_to_worker)
    "controller.dispatch": ("drop", "delay", "duplicate"),
    # worker -> controller result envelopes (ControllerNode.handle_worker)
    "controller.reply": ("drop", "delay", "duplicate"),
    # worker work execution (WorkerBase.handle, before handle_work)
    "worker.execute": ("raise", "delay", "wedge", "die_after_ack"),
    # worker result send (WorkerBase.handle, after handle_work)
    "worker.reply": ("drop", "delay"),
    # mesh-executor device dispatch (MeshQueryExecutor.execute)
    "worker.device": ("raise", "delay"),
    # RPC client socket layer (RPC._rpc)
    "rpc.call": ("timeout", "disconnect", "delay"),
    # coordination-store operations (coordination.ChaosStore)
    "coordination.store": ("partition", "delay"),
}

#: actions interpreted by fire() itself (not returned to the hook); legal
#: only at sites whose SITES tuple lists them
GENERIC_ACTIONS = ("delay", "raise")


class FaultPlanError(ValueError):
    """Malformed fault plan (unknown site/action, bad types) — raised at
    arm time so a typo'd plan can never silently inject nothing."""


class Fault:
    """One fired fault, returned to (or raised at) the injection site."""

    __slots__ = ("site", "action", "args", "rule_index")

    def __init__(self, site, action, args, rule_index):
        self.site = site
        self.action = action
        self.args = args
        self.rule_index = rule_index

    def __repr__(self):
        return (
            f"Fault(site={self.site!r}, action={self.action!r}, "
            f"args={self.args!r}, rule={self.rule_index})"
        )


class FaultRule:
    """One compiled rule; trigger bookkeeping is lock-guarded."""

    def __init__(self, spec, index, seed):
        if not isinstance(spec, dict):
            raise FaultPlanError(f"fault rule {index} is not a dict: {spec!r}")
        unknown = set(spec) - {
            "site", "action", "match", "args", "times", "after", "every",
            "probability", "window_s",
        }
        if unknown:
            raise FaultPlanError(
                f"fault rule {index} has unknown fields {sorted(unknown)}"
            )
        self.site = spec.get("site")
        self.action = spec.get("action")
        if not isinstance(self.site, str) or not self.site:
            raise FaultPlanError(f"fault rule {index} needs a 'site'")
        # the site may be an fnmatch pattern; it must still cover at least
        # one declared site, and the action must be legal at every site the
        # pattern covers
        covered = [s for s in SITES if fnmatch.fnmatchcase(s, self.site)]
        if not covered:
            raise FaultPlanError(
                f"fault rule {index}: site {self.site!r} matches no known "
                f"site (known: {sorted(SITES)})"
            )
        if not isinstance(self.action, str) or not self.action:
            raise FaultPlanError(f"fault rule {index} needs an 'action'")
        for s in covered:
            if self.action not in SITES[s]:
                raise FaultPlanError(
                    f"fault rule {index}: action {self.action!r} is not "
                    f"legal at site {s!r} (legal: {sorted(SITES[s])})"
                )
        self.match = dict(spec.get("match") or {})
        self.args = dict(spec.get("args") or {})
        self.times = int(spec.get("times", 0))
        self.after = int(spec.get("after", 0))
        self.every = max(int(spec.get("every", 1)), 1)
        self.probability = float(spec.get("probability", 1.0))
        self.window_s = float(spec.get("window_s", 0.0))
        self.index = index
        # deterministic per-rule stream: same (seed, index) -> same decisions
        self._rng = random.Random(
            f"{seed}:{index}:{self.site}:{self.action}"
        )
        self._lock = threading.Lock()
        self._matched = 0        # triggers that passed the match predicates
        self._fired = 0          # faults actually injected
        self._window_started = None

    def _ctx_matches(self, ctx):
        for key, pattern in self.match.items():
            value = ctx.get(key)
            if value is None:
                return False
            if isinstance(pattern, str):
                if not fnmatch.fnmatchcase(str(value), pattern):
                    return False
            elif value != pattern:
                return False
        return True

    def consider(self, site, ctx, now=None):
        """Trigger evaluation: returns a :class:`Fault` to inject or None.
        Deterministic given the call sequence (counters + seeded RNG)."""
        if not fnmatch.fnmatchcase(site, self.site):
            return None
        if not self._ctx_matches(ctx):
            return None
        now = time.time() if now is None else now
        with self._lock:
            self._matched += 1
            if self.window_s > 0.0:
                # window semantics: the first qualifying trigger (past
                # ``after``) opens the window; once it closes the rule is
                # exhausted for good.  Matches inside the window still pass
                # through times/every/probability below — a 10%-probability
                # windowed rule injects at 10%, not 100%
                if self._window_started is None:
                    if self._matched <= self.after:
                        return None
                    self._window_started = now
                elif now - self._window_started > self.window_s:
                    return None
            elif self._matched <= self.after:
                return None
            if self.times and self._fired >= self.times:
                return None
            if (self._matched - self.after - 1) % self.every != 0:
                return None
            if self.probability < 1.0 and (
                self._rng.random() >= self.probability
            ):
                return None
            self._fired += 1
        return Fault(site, self.action, self.args, self.index)

    def stats(self):
        with self._lock:
            return {
                "site": self.site,
                "action": self.action,
                "matched": self._matched,
                "fired": self._fired,
            }


class FaultPlan:
    """A compiled plan: ordered rules, first match wins per fire()."""

    def __init__(self, spec):
        if not isinstance(spec, dict):
            raise FaultPlanError(f"fault plan is not a dict: {type(spec)}")
        unknown = set(spec) - {"seed", "faults"}
        if unknown:
            raise FaultPlanError(
                f"fault plan has unknown top-level fields {sorted(unknown)}"
            )
        self.seed = int(spec.get("seed", 0))
        faults = spec.get("faults")
        if not isinstance(faults, list) or not faults:
            raise FaultPlanError("fault plan needs a non-empty 'faults' list")
        self.rules = [
            FaultRule(rule_spec, i, self.seed)
            for i, rule_spec in enumerate(faults)
        ]

    def consider(self, site, ctx):
        """First matching rule's fault, or None."""
        for rule in self.rules:
            fault = rule.consider(site, ctx)
            if fault is not None:
                return fault
        return None

    def stats(self):
        return [rule.stats() for rule in self.rules]


def load_plan(spec):
    """Compile ``spec`` into a :class:`FaultPlan`.

    ``spec`` may be a dict, an inline JSON string (starts with ``{``), or a
    path to a JSON file — the three forms ``BQUERYD_TPU_FAULT_PLAN``
    accepts.  Raises :class:`FaultPlanError` on anything malformed."""
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, str):
        text = spec.strip()
        if not text.startswith("{"):
            try:
                with open(os.path.expanduser(text)) as f:
                    text = f.read()
            except OSError as exc:
                raise FaultPlanError(
                    f"fault plan file unreadable: {exc}"
                ) from exc
        try:
            spec = json.loads(text)
        except ValueError as exc:
            raise FaultPlanError(f"fault plan is not valid JSON: {exc}") from exc
    return FaultPlan(spec)

"""The serving layer: answer admitted queries from proofs, not scans.

The port's copy of ``bqueryd_tpu/serve/__init__.py``.  ``ServingLayer`` is
the controller's one entry point into serving, over two halves:

* :mod:`.subsume` — plan subsumption (exact, window-fold, key-fold and
  zone-proof matches) and the cost-based choice of source;
* :mod:`.rollup` — heat and the materialized rollups' lifecycle (build,
  delta refresh, eviction, staleness on append).

The layer sits at the top of ``ControllerNode._admit_plan``: a hit
replies to the client at once, with no admission slot, no dispatch and no
scan; a miss falls through to the dispatch path unchanged.
``BQUERYD_TPU_SERVE=0`` (read on every call, so it can be flipped on a
live process) turns off serving and the rollup bookkeeping.

Message construction stays in the controller (``_dispatch_rollup_build``,
``_absorb_rollup_reply``, ``_reply_served``); this package never touches
a socket.
"""

import os
import pickle
import time
from collections import deque

from bqueryd_tpu_torch.serve import rollup, subsume


def serve_enabled():
    """The kill switch ``BQUERYD_TPU_SERVE`` (default on), read on every
    call."""
    return os.environ.get("BQUERYD_TPU_SERVE", "1") == "1"


class ServingLayer:
    """The controller's side of subsumption and rollups."""

    def __init__(self, controller):
        self.controller = controller
        self.manager = rollup.RollupManager()
        self.decisions = deque(maxlen=32)
        self.served = 0

    # -- the admission hook ---------------------------------------------------
    def try_serve(self, msg, plan, kwargs):
        """Called by ``_admit_plan`` after the shard check, before any
        admission accounting.  True when this answered the query (the reply
        is sent); False on any miss or refusal, and the caller dispatches
        as before."""
        if not serve_enabled():
            return False
        try:
            return self._try_serve(msg, plan, kwargs)
        except Exception:
            # an optimization: an internal error falls back to the dispatch
            # path, which is always right, and never fails the query
            self.controller.logger.exception("serving layer error (miss)")
            return False

    def _try_serve(self, msg, plan, kwargs):
        now = time.monotonic()
        view = subsume.plan_view(plan)
        ok, reason = subsume.plan_eligible(view)
        if not ok:
            self._record_decision(None, "recompute", [("plan", reason)])
            return False
        key = subsume.view_key(view)
        spec = {
            "args": [
                list(view["keys"]),
                [list(a) for a in plan.physical_agg_list()],
                [list(t) for t in plan.where_terms],
            ],
            "dag_wire": kwargs.get("dag"),
        }
        if self.manager.note_query(key, view, spec, now):
            entry = self.manager.start_build(key, now)
            if entry is not None:
                self.controller._dispatch_rollup_build(entry)
        matches, rejected = [], []
        for entry in self.manager.candidates(view["filenames"]):
            transform, why = subsume.match(entry.view, view, entry.meta())
            if transform is None:
                rejected.append((entry.key, why))
            else:
                matches.append((entry.key, transform, entry.group_rows()))
        total_rows = 0
        for fname in view["filenames"]:
            stats = self.controller.shard_stats.get(fname) or {}
            total_rows += int(stats.get("rows", 0) or 0)
        choice = subsume.choose_source(matches, total_rows)
        if choice is None:
            if matches:
                rejected.extend((m[0], "cost") for m in matches)
            self._record_decision(key, "recompute", rejected)
            return False
        entry_key, transform, _groups = choice
        entry = self.manager.entries[entry_key]
        payloads = self._render(entry, transform)
        if payloads is None:
            self.manager.fail(entry_key, "render")
            self._record_decision(key, "recompute", rejected + [
                (entry_key, "render-error")
            ])
            return False
        source = "rollup" if transform["kind"] in ("exact", "zone") else "subsume"
        self.manager.note_hit(entry_key, now)
        self.served += 1
        self._record_decision(key, source, rejected, chosen=entry_key)
        self.controller._reply_served(msg, payloads, source, entry_key)
        return True

    def _render(self, entry, transform):
        """The per-file payload bytes of the reply envelope; None when a
        transform fails (the query is then recomputed)."""
        out = []
        try:
            for fname in entry.filenames:
                info = entry.per_file[fname]
                if transform["kind"] in ("exact", "zone"):
                    out.append(info["data"])
                else:
                    folded = subsume.apply_transform(
                        info["payload"], transform
                    )
                    out.append(pickle.dumps(dict(folded), protocol=4))
        except Exception:
            self.controller.logger.exception("rollup fold failed")
            return None
        return out

    def _record_decision(self, key, source, rejected, chosen=None):
        self.decisions.append({
            "view": key,
            "source": source,
            "chosen": chosen,
            "rejected": [list(r) for r in rejected],
        })
        if rejected or source != "recompute":
            self.controller.flight.record(
                "serve_decision",
                view=key,
                source=source,
                chosen=chosen,
                rejected=[list(r) for r in rejected],
            )

    # -- lifecycle hooks ------------------------------------------------------
    def note_append(self, filename):
        """An append for ``filename`` is about to be dispatched: mark
        covering rollups stale before any worker changes its shard."""
        if not serve_enabled():
            return
        flipped = self.manager.note_append(filename, time.monotonic())
        if flipped:
            self.controller.flight.record(
                "rollup_stale", filename=filename, entries=flipped
            )

    def absorb_build(self, key, fname, info):
        """One worker's build or refresh reply, decoded by the
        controller."""
        return self.manager.absorb(key, fname, info, time.monotonic())

    def tick(self):
        """Housekeeping on the heartbeat: abandon wedged builds, hold the
        retention caps and dispatch delta refreshes of stale entries."""
        if not serve_enabled():
            return
        now = time.monotonic()
        dropped = self.manager.sweep(now)
        if dropped:
            for key, why in dropped:
                self.controller.flight.record(
                    "rollup_evict", entry=key, reason=why
                )
            self.controller.counters["rollup_evictions"] += len(dropped)
        for key in self.manager.stale_keys():
            res = self.manager.begin_refresh(key, now)
            if res is None:
                continue
            entry, prior = res
            self.controller._dispatch_rollup_build(entry, prior=prior)

    def snapshot(self):
        """The ``serving`` section of the debug bundle."""
        return {
            "enabled": serve_enabled(),
            "served": self.served,
            "rollups": self.manager.snapshot(),
            "recent_decisions": list(self.decisions),
        }

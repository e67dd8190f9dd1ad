"""Worker health scoring: observability folded back into placement.

The port's copy of ``bqueryd_tpu/obs/health.py``.  The controller folds the
groupby latency histogram snapshot, the error counter and the
device-health latch that ride each worker's WRM into rolling per-worker
baselines, and the dispatch path acts on them.

Per worker, per heartbeat, the :class:`HealthScorer` records (groupby
count, latency sum, error-counter value, backend_wedged) samples and keeps
a time window of them.  Classification, strictest first:

* ``wedged``   — the worker's own device-health latch (or its chaos wedge)
  says its device is hung; it is not removed, only last in line;
* ``degraded`` — its windowed error rate crossed ``error_rate_threshold``
  (with a minimum error count, so one blip never flags), or its windowed
  mean query latency is ``latency_factor`` times the fleet median (over
  workers with enough samples: a lone worker is never an outlier of one);
* ``ok``       — everything else, including workers too young to judge.

``ControllerNode.find_free_worker`` prefers ``ok`` candidates and falls back
to degraded or wedged ones only when no healthy holder of the shard is
free: deprioritized, never excluded, so a sole holder still serves.
``BQUERYD_TPU_HEALTH_ROUTING=0`` turns the preference off (scoring and
``rpc.health()`` stay live).

Standard library only.
"""

import collections
import os
import statistics
import threading
import time

STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_WEDGED = "wedged"

#: the worker-side histogram family the latency baseline is derived from
LATENCY_FAMILY = "bqueryd_tpu_worker_groupby_seconds"


def routing_enabled():
    """Whether dispatch deprioritizes non-ok workers (read per call)."""
    return os.environ.get("BQUERYD_TPU_HEALTH_ROUTING", "1") != "0"


def _latency_totals(snapshot):
    """(count, sum_seconds) of the worker groupby histogram in a WRM
    histogram snapshot; (0, 0.0) when absent/malformed."""
    try:
        series = snapshot.get(LATENCY_FAMILY) or []
        count = 0
        total = 0.0
        for entry in series:
            count += sum(int(c) for c in entry.get("counts", ()))
            total += float(entry.get("sum", 0.0))
        return count, total
    except Exception:
        return 0, 0.0


class HealthScorer:
    """Rolling per-worker latency/error baselines + outlier classification."""

    def __init__(self, window_s=300.0, min_samples=5, latency_factor=3.0,
                 error_rate_threshold=0.25, min_errors=3,
                 latency_floor_s=0.001):
        self.window_s = window_s
        #: min completed queries in the window before a worker can be a
        #: latency outlier (or anchor the fleet median)
        self.min_samples = min_samples
        self.latency_factor = latency_factor
        self.error_rate_threshold = error_rate_threshold
        self.min_errors = min_errors
        #: fleet medians under this are noise, not a baseline to be 3x of
        self.latency_floor_s = latency_floor_s
        self._lock = threading.Lock()
        self._samples = {}   # worker_id -> deque[(ts, count, sum, errors)]
        self._wedged = {}    # worker_id -> bool (latest advertised latch)
        self._pids = {}      # worker_id -> advertised pid (exact restarts)
        # statuses() is on the dispatch hot path (one call per placed
        # shard) but its inputs change only on observe/remove (heartbeat
        # cadence): memoize on a revision counter
        self._rev = 0
        self._statuses_cache = (-1, None)

    def observe(self, worker_id, snapshot=None, wedged=False, errors=None,
                pid=None, now=None):
        """Fold one WRM's worth of signals in (idempotent per heartbeat:
        identical cumulative totals just extend the window)."""
        now = time.time() if now is None else now
        count, total = _latency_totals(snapshot or {})
        try:
            errors = int(errors or 0)
        except (TypeError, ValueError):
            errors = 0
        with self._lock:
            window = self._samples.setdefault(
                worker_id, collections.deque()
            )
            last_pid = self._pids.get(worker_id)
            if pid is not None:
                self._pids[worker_id] = pid
            if window and pid is not None and last_pid is not None \
                    and pid != last_pid:
                # exact restart signal (the WRM advertises the pid):
                # rebase even when the totals alone wouldn't prove it
                window.clear()
            if window:
                _ts, lcount, ltotal, lerr = window[-1]
                if count < lcount and count <= lcount // 2:
                    # the worker process restarted under the same node id:
                    # its cumulative histogram/counter totals reset to
                    # zero.  The window deltas assume monotonicity — left
                    # alone, max(last-first, 0) would clamp this worker's
                    # windowed throughput/error rate to 0 until the
                    # pre-restart samples age out, hiding a genuinely slow
                    # or erroring restarted worker.  Rebase: drop the
                    # pre-restart samples and let the fresh process build
                    # its own baseline (innocent until measured, same as a
                    # brand-new worker).  The halving test keeps slightly
                    # out-of-order snapshots from the worker's two WRM
                    # streams (main loop + liveness thread) from reading
                    # as restarts — those deltas already clamp at 0.
                    window.clear()
            window.append((now, count, total, errors))
            cutoff = now - self.window_s
            while len(window) > 1 and window[0][0] < cutoff:
                window.popleft()
            self._wedged[worker_id] = bool(wedged)
            self._rev += 1

    def remove(self, worker_id):
        with self._lock:
            self._samples.pop(worker_id, None)
            self._wedged.pop(worker_id, None)
            self._pids.pop(worker_id, None)
            self._rev += 1

    def _window_stats(self, window):
        """Deltas across the window: completed queries, mean latency,
        errors, error rate."""
        first, last = window[0], window[-1]
        dcount = max(last[1] - first[1], 0)
        dsum = max(last[2] - first[2], 0.0)
        derr = max(last[3] - first[3], 0)
        mean = (dsum / dcount) if dcount else None
        attempts = dcount + derr
        error_rate = (derr / attempts) if attempts else 0.0
        return {
            "queries": dcount,
            "mean_latency_s": None if mean is None else round(mean, 6),
            "errors": derr,
            "error_rate": round(error_rate, 4),
        }

    def statuses(self, now=None):
        """``{worker_id: {"status", "reason", ...window stats...}}``."""
        with self._lock:
            rev = self._rev
            cached_rev, cached = self._statuses_cache
            if cached_rev == rev and cached is not None:
                return cached
            windows = {
                wid: self._window_stats(window)
                for wid, window in self._samples.items()
                if window
            }
            wedged = dict(self._wedged)
        means = [
            s["mean_latency_s"]
            for s in windows.values()
            if s["mean_latency_s"] is not None
            and s["queries"] >= self.min_samples
        ]
        fleet_median = statistics.median(means) if means else None
        out = {}
        for wid, stats in windows.items():
            status, reason = STATUS_OK, None
            if wedged.get(wid):
                status = STATUS_WEDGED
                reason = "backend_wedged latch advertised in WRM"
            elif (
                stats["errors"] >= self.min_errors
                and stats["error_rate"] > self.error_rate_threshold
            ):
                status = STATUS_DEGRADED
                reason = (
                    f"error rate {stats['error_rate']:.0%} over "
                    f"{stats['errors']} errors in window"
                )
            elif (
                fleet_median is not None
                and fleet_median > self.latency_floor_s
                and stats["queries"] >= self.min_samples
                and stats["mean_latency_s"] is not None
                and stats["mean_latency_s"]
                > self.latency_factor * fleet_median
            ):
                status = STATUS_DEGRADED
                reason = (
                    f"mean latency {stats['mean_latency_s']:.3f}s > "
                    f"{self.latency_factor:.1f}x fleet median "
                    f"{fleet_median:.3f}s"
                )
            entry = dict(stats)
            entry["status"] = status
            entry["wedged"] = bool(wedged.get(wid))
            if reason:
                entry["reason"] = reason
            if fleet_median is not None:
                entry["fleet_median_latency_s"] = round(fleet_median, 6)
            out[wid] = entry
        self._statuses_cache = (rev, out)
        return out

    def status(self, worker_id):
        """One worker's status string (``ok`` when unknown)."""
        return self.statuses().get(worker_id, {}).get("status", STATUS_OK)

    def healthy_subset(self, worker_ids):
        """The ``ok`` members of ``worker_ids`` (cheap single scoring pass);
        used by dispatch to prefer healthy holders of a shard."""
        statuses = self.statuses()
        return [
            wid for wid in worker_ids
            if statuses.get(wid, {}).get("status", STATUS_OK) == STATUS_OK
        ]

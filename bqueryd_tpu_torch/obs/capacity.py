"""Fleet capacity telemetry: queueing-model saturation accounting.

The port's copy of ``bqueryd_tpu/obs/capacity.py``: the controller's
capacity model behind ``rpc.capacity()``, fed by signals that already
flow, so that it costs no wire traffic of its own; for the same sequence
of observations its ``snapshot()`` equals the reference's.

* **service rate μ** per worker — EWMA of completions over service time,
  from the deltas of the ``bqueryd_tpu_worker_groupby_seconds`` histogram
  snapshot that rides every WRM.  Deltas are reset-guarded: a worker
  restarting under the same node id resets its counters, and a negative
  delta rebases the baseline (counted in ``resets``);
* **arrival rate λ** per SLO class — tapped at admission
  (``AdmissionController.arrival_observer``) over a rolling window;
* **utilization ρ = λ/μ** per worker and for the fleet, with an M/G/1
  (Pollaczek–Khinchine) predicted queue delay
  ``Wq = ρ/(1-ρ) · E[S] · (1+cv²)/2`` whose second moment comes from the
  same histogram's buckets, cross-checked against the *measured* wait (the
  admission wait hook and the ``admission_wait``/``dispatch`` segments of
  finished queries' autopsies): their drift is a gauge;
* **saturation states** ``ok < warm < saturated < overloaded`` per worker
  and fleet, with hysteresis (``BQUERYD_TPU_CAPACITY_HYSTERESIS_S``);
* a **shard heat map** from per-shard dispatch counts;
* **headroom QPS** and the predicted **saturation knee**
  (``knee_qps = Σμ / shards-per-query``);
* a **shadow advisor**: ``scale_up n`` / ``scale_down n`` /
  ``rebalance shard→worker`` recommendations with their evidence, shown by
  ``rpc.capacity()``, logged to the flight ring and counted, and never
  acted on.

The worker's ``pipeline_busy`` WRM key (the stage clocks of
:mod:`bqueryd_tpu_torch.parallel.pipeline`) names each worker's
bottleneck stage beside its ρ.  The stage clocks are process-global:
workers that share one process share one clock, so stage shares are
advisory there; μ always comes from the per-node histograms.

``BQUERYD_TPU_CAPACITY=0`` turns the model off.  Standard library only.
"""

import math
import os
import threading
import time

from bqueryd_tpu_torch.utils.env import env_num

#: the WRM histogram family μ is derived from (same family the health
#: scorer windows): count = completed CalcMessages, sum = service seconds
SERVICE_FAMILY = "bqueryd_tpu_worker_groupby_seconds"

STATE_OK = "ok"
STATE_WARM = "warm"
STATE_SATURATED = "saturated"
STATE_OVERLOADED = "overloaded"

#: severity order; the numeric codes back the fleet-state gauge
STATE_CODES = {
    STATE_OK: 0, STATE_WARM: 1, STATE_SATURATED: 2, STATE_OVERLOADED: 3,
}

#: ρ at which λ has outrun μ by definition (not an env knob: >= 1 means the
#: queue grows without bound while the window's rates hold)
RHO_OVERLOADED = 1.0

#: EWMA smoothing for service-time moments and measured waits
EWMA_ALPHA = 0.3

#: a hot shard is one whose dispatch share exceeds this multiple of the
#: uniform share (skew detection for the rebalance advice)
SHARD_SKEW_FACTOR = 3.0

DEFAULT_WINDOW_S = 60.0
DEFAULT_RHO_WARM = 0.5
DEFAULT_RHO_SATURATED = 0.8
DEFAULT_HYSTERESIS_S = 10.0
DEFAULT_TARGET_RHO = 0.7


def capacity_enabled():
    """Whether the capacity model ingests/evaluates (read per call:
    live-tunable).  The taps are dict bumps under one lock — the 2%
    observability overhead budget covers them — but a kill switch is the
    house rule for every accounting layer."""
    return os.environ.get("BQUERYD_TPU_CAPACITY", "1") != "0"


def window_s():
    """Rolling window the arrival/dispatch rates are measured over."""
    return max(env_num("BQUERYD_TPU_CAPACITY_WINDOW_S", DEFAULT_WINDOW_S),
               1.0)


def rho_warm():
    return env_num("BQUERYD_TPU_CAPACITY_RHO_WARM", DEFAULT_RHO_WARM)


def rho_saturated():
    return env_num(
        "BQUERYD_TPU_CAPACITY_RHO_SATURATED", DEFAULT_RHO_SATURATED
    )


def hysteresis_s():
    return max(
        env_num("BQUERYD_TPU_CAPACITY_HYSTERESIS_S", DEFAULT_HYSTERESIS_S),
        0.0,
    )


def target_rho():
    """The utilization the advisor sizes the fleet for: scale_up asks for
    enough workers to bring ρ back to this, scale_down only sheds workers
    the target still leaves headroom for."""
    rho = env_num("BQUERYD_TPU_CAPACITY_TARGET_RHO", DEFAULT_TARGET_RHO)
    return min(max(rho, 0.05), 0.95)


def classify(rho):
    """Raw (pre-hysteresis) state for a utilization estimate."""
    if rho is None:
        return STATE_OK
    if rho >= RHO_OVERLOADED:
        return STATE_OVERLOADED
    if rho >= rho_saturated():
        return STATE_SATURATED
    if rho >= rho_warm():
        return STATE_WARM
    return STATE_OK


def _bucket_midpoints(bounds):
    """Geometric midpoints of a log-scale bucket vector, plus the +Inf
    overflow slot (approximated one log-step past the last bound) — good
    enough for the E[S²] the P-K formula needs."""
    mids = []
    for i, hi in enumerate(bounds):
        lo = bounds[i - 1] if i else hi / 2.5
        mids.append(math.sqrt(max(lo, 1e-12) * max(hi, 1e-12)))
    mids.append(bounds[-1] * 2.5 if bounds else 1.0)
    return mids


def service_totals(snapshot):
    """(count, sum_seconds, bucket_bounds, bucket_counts) of the worker
    groupby service histogram in a WRM snapshot; zeros when absent or
    malformed (a skewed peer contributes nothing, never poison)."""
    try:
        series = snapshot.get(SERVICE_FAMILY) or []
        count, total = 0, 0.0
        bounds, counts = [], []
        for entry in series:
            ecounts = [int(c) for c in entry.get("counts", ())]
            count += sum(ecounts)
            total += float(entry.get("sum", 0.0))
            ebounds = [float(b) for b in entry.get("buckets", ())]
            if ebounds and not bounds:
                bounds, counts = ebounds, ecounts
            elif ebounds == bounds and len(ecounts) == len(counts):
                counts = [a + b for a, b in zip(counts, ecounts)]
        return count, total, bounds, counts
    except Exception:
        return 0, 0.0, [], []


class _RateWindow:
    """Bucketed event counts over a rolling window (the burn-rate pattern:
    volume-independent memory — at most window/bucket + 1 buckets survive
    trimming).  NOT thread-safe on its own; the model's lock guards it."""

    def __init__(self, bucket_s=5.0):
        self.bucket_s = bucket_s
        self.buckets = {}   # bucket index -> count
        self.first_ts = None

    def add(self, now, n=1):
        idx = int(now // self.bucket_s)
        self.buckets[idx] = self.buckets.get(idx, 0) + n
        if self.first_ts is None:
            self.first_ts = now

    def rate(self, now, horizon_s):
        """Events/second over the trailing horizon; trims expired buckets.
        A window younger than the horizon measures over its own age (cold
        start must not read as a fraction of the eventual rate)."""
        cutoff = int((now - horizon_s) // self.bucket_s)
        for idx in [i for i in self.buckets if i < cutoff]:
            del self.buckets[idx]
        total = sum(
            c for i, c in self.buckets.items() if i >= cutoff
        )
        span = horizon_s
        if self.first_ts is not None:
            span = min(
                horizon_s, max(now - self.first_ts, self.bucket_s)
            )
        return total / span if span > 0 else 0.0

    def total(self, now, horizon_s):
        cutoff = int((now - horizon_s) // self.bucket_s)
        return sum(c for i, c in self.buckets.items() if i >= cutoff)


class _Hysteresis:
    """A state change must persist ``hold_s`` before it takes; flapping
    inputs keep the last stable state."""

    def __init__(self, state=STATE_OK):
        self.state = state
        self.pending = None      # (raw_state, since_ts)

    def update(self, raw, now, hold_s):
        if raw == self.state:
            self.pending = None
            return self.state
        if self.pending is None or self.pending[0] != raw:
            self.pending = (raw, now)
        if now - self.pending[1] >= hold_s:
            self.state = raw
            self.pending = None
        return self.state


class _WorkerModel:
    """Per-worker cumulative baselines + EWMA service moments.  Mutated
    only under the owning CapacityModel's lock."""

    def __init__(self):
        self.last_count = None   # cumulative completions (None = no baseline)
        self.last_sum = 0.0      # cumulative service seconds
        self.last_counts = []    # cumulative bucket vector
        self.last_ts = None
        self.mean_s = None       # EWMA mean service seconds
        self.m2_s = None         # EWMA second moment of service seconds
        self.busy_ewma = None    # EWMA serving fraction of wall
        self.samples = 0         # completions folded into the EWMAs
        self.resets = 0          # counter restarts detected (rebased)
        self.stage_busy = {}     # stage -> cumulative busy baseline
        self.stage_window = {}   # stage -> busy seconds delta (last beat)
        self.wedged = False      # latest advertised device-health latch
        self.pid = None          # advertised worker pid (exact restarts)
        self.hysteresis = _Hysteresis()

    def mu(self):
        """Service rate: CalcMessages per second of service time."""
        if not self.mean_s or self.mean_s <= 0:
            return None
        return 1.0 / self.mean_s

    def cv2(self):
        """Squared coefficient of variation of service time (0 when the
        moments are too cold to say)."""
        if not self.mean_s or self.m2_s is None:
            return 0.0
        return max(self.m2_s / (self.mean_s * self.mean_s) - 1.0, 0.0)


class CapacityModel:
    """The controller's fleet capacity model (see module docstring).

    Ingestion (``absorb_worker`` / ``observe_*``) and evaluation
    (``evaluate``) all run on the controller event loop plus the metrics
    scrape thread, so every mutable structure sits behind one lock; the
    ``on_advice`` callback fires OUTSIDE the lock (it records flight
    events, which take their own lock)."""


    #: lock discipline, statically checked by bqueryd_tpu_torch.analysis
    _bqtpu_guarded_ = {
        "_lock": (
            "_workers", "_arrivals", "_launched",
            "_arrivals_by_class", "_dispatches",
            "_shard_rates", "_shard_workers", "_measured_wait",
            "_measured_wait_n", "_spq_ewma", "_fleet_state", "_last_eval",
            "_last_advice", "_advice_counts",
        ),
    }

    def __init__(self, on_advice=None):
        self._lock = threading.Lock()
        self._workers = {}            # worker_id -> _WorkerModel
        self._arrivals = _RateWindow()          # offered, all classes
        self._launched = _RateWindow()          # queries that opened a run
        self._arrivals_by_class = {}  # slo class -> _RateWindow
        self._dispatches = {}         # worker_id -> _RateWindow
        self._shard_rates = {}        # shard -> _RateWindow
        self._shard_workers = {}      # shard -> {worker_id: last_ts}
        self._measured_wait = None    # EWMA measured queue delay (s)
        self._measured_wait_n = 0
        self._spq_ewma = None         # shards (CalcMessages) per query
        self._fleet_state = _Hysteresis()
        self._last_eval = {}          # cached evaluation (gauges read it)
        self._last_advice = None      # signatures of standing advice
        self._advice_counts = {       # lifetime advice volume by action
            "scale_up": 0, "scale_down": 0, "rebalance": 0,
        }
        #: advice sink: called with each NEW recommendation dict when the
        #: advised action set changes (the controller wires the flight
        #: recorder + counters here); shadow mode — nobody acts on it
        self.on_advice = on_advice

    # -- ingestion ----------------------------------------------------------
    def absorb_worker(self, worker_id, snapshot, pipeline_busy=None,
                      wedged=False, pid=None, now=None):
        """Fold one WRM heartbeat's cumulative totals in.  A worker
        process restarting under the same node id restarts its cumulative
        counters from zero: detected EXACTLY via the advertised ``pid``
        when it changes, and heuristically (totals halving) for peers that
        ship no pid — either way the baseline is rebased, never a
        poisoned negative rate, and the EWMAs survive the restart
        untouched.  ``wedged`` is the advertised device-health latch: a
        wedged worker's μ is excluded from fleet capacity (a hung
        accelerator is not capacity, whatever it measured before it
        latched)."""
        if not capacity_enabled():
            return
        now = time.time() if now is None else now
        count, total, bounds, counts = service_totals(snapshot or {})
        with self._lock:
            model = self._workers.setdefault(worker_id, _WorkerModel())
            if (
                pid is not None and model.pid is not None
                and pid != model.pid
            ):
                # exact restart signal: rebase before the delta math so
                # even a restart the halving heuristic would miss (old
                # count still small) never folds a cross-restart delta
                # into the moments
                model.resets += 1
                model.last_count, model.last_sum = count, total
                model.last_counts = counts
                model.stage_busy = {}
                model.stage_window = {}
            if pid is not None:
                model.pid = pid
            self._absorb_service_locked(
                model, count, total, bounds, counts, now
            )
            self._absorb_stages_locked(model, pipeline_busy)
            model.wedged = bool(wedged)
            model.last_ts = now

    def _absorb_service_locked(self, model, count, total, bounds, counts,
                               now):
        if model.last_count is None:
            model.last_count, model.last_sum = count, total
            model.last_counts = counts
            return
        dcount = count - model.last_count
        dsum = total - model.last_sum
        if dcount < 0 or dsum < -1e-9:
            # cumulative totals went backwards.  Two distinct causes: the
            # worker process RESTARTED under the same node id (totals
            # restart near zero — rebase the baseline, never a negative
            # rate), or the worker's two WRM streams (main loop + liveness
            # thread) delivered snapshots slightly out of order (totals
            # barely below the baseline — drop the stale sample, keep the
            # baseline).  The halving test separates them.
            if count <= model.last_count // 2:
                model.resets += 1
                model.last_count, model.last_sum = count, total
                model.last_counts = counts
            return
        elapsed = (
            now - model.last_ts if model.last_ts is not None else None
        )
        if dcount > 0:
            mean = dsum / dcount
            model.mean_s = (
                mean if model.mean_s is None
                else (1 - EWMA_ALPHA) * model.mean_s + EWMA_ALPHA * mean
            )
            m2 = self._second_moment(
                bounds, counts, model.last_counts, mean
            )
            model.m2_s = (
                m2 if model.m2_s is None
                else (1 - EWMA_ALPHA) * model.m2_s + EWMA_ALPHA * m2
            )
            model.samples += dcount
        if elapsed is not None and elapsed > 0:
            busy = min(max(dsum, 0.0) / elapsed, 1.0)
            model.busy_ewma = (
                busy if model.busy_ewma is None
                else (1 - EWMA_ALPHA) * model.busy_ewma + EWMA_ALPHA * busy
            )
        model.last_count, model.last_sum = count, total
        model.last_counts = counts

    @staticmethod
    def _second_moment(bounds, counts, last_counts, fallback_mean):
        """E[S²] of the heartbeat's completions from the bucket-vector
        delta (geometric midpoints); falls back to the deterministic
        mean² when the vectors don't line up (version skew)."""
        if (
            not bounds
            or len(counts) != len(bounds) + 1
            or len(last_counts) != len(counts)
        ):
            return fallback_mean * fallback_mean
        deltas = [max(a - b, 0) for a, b in zip(counts, last_counts)]
        n = sum(deltas)
        if n <= 0:
            return fallback_mean * fallback_mean
        mids = _bucket_midpoints(bounds)
        return sum(d * m * m for d, m in zip(deltas, mids)) / n

    def _absorb_stages_locked(self, model, pipeline_busy):
        busy = (pipeline_busy or {}).get("busy_seconds")
        if not isinstance(busy, dict):
            return
        for stage, seconds in busy.items():
            try:
                seconds = float(seconds)
            except (TypeError, ValueError):
                continue
            base = model.stage_busy.get(stage)
            if base is not None and seconds >= base:
                # EWMA of per-beat busy deltas: idle beats decay every
                # stage equally (relative ordering — the bottleneck label
                # — survives a quiet spell)
                delta = seconds - base
                prev = model.stage_window.get(stage)
                model.stage_window[stage] = (
                    delta if prev is None
                    else (1 - EWMA_ALPHA) * prev + EWMA_ALPHA * delta
                )
            elif base is not None and seconds > base / 2.0:
                # slightly-backwards cumulative busy: a stale snapshot
                # from the worker's other WRM stream — drop the sample,
                # keep the baseline AND the EWMA (same halving contract as
                # the service-totals path)
                continue
            else:
                # first sight or a reset (restart): drop the stale EWMA,
                # the fresh process rebuilds its own
                model.stage_window.pop(stage, None)
            model.stage_busy[stage] = seconds

    def remove_worker(self, worker_id):
        with self._lock:
            self._workers.pop(worker_id, None)
            self._dispatches.pop(worker_id, None)
            # heat-map hygiene: rebalance evidence must not cite a culled
            # worker as a live holder
            for holders in self._shard_workers.values():
                holders.pop(worker_id, None)

    def observe_arrival(self, slo_class="default", now=None):
        """One offered query at admission (ADMIT/QUEUED and BUSY all count
        toward λ: it is *offered* load, and shed load is exactly what
        saturation looks like; DUPLICATE resubmissions never reach this
        hook)."""
        if not capacity_enabled():
            return
        now = time.time() if now is None else now
        with self._lock:
            self._arrivals.add(now)
            self._arrivals_by_class.setdefault(
                str(slo_class or "default"), _RateWindow()
            ).add(now)

    def observe_launch(self, now=None):
        """One query actually opening a run (solo launch or bundle
        member).  This — not offered arrivals — is the shards-per-query
        denominator: BUSY-shed, queued-then-expired, and superseded
        offers dispatch no shards, and counting them would overestimate
        the knee precisely while the cluster sheds load."""
        if not capacity_enabled():
            return
        now = time.time() if now is None else now
        with self._lock:
            self._launched.add(now)

    def observe_dispatch(self, worker_id, filenames, now=None):
        """One CalcMessage handed to a worker; ``filenames`` is the shard
        group it covers (the heat map counts each member shard)."""
        if not capacity_enabled():
            return
        now = time.time() if now is None else now
        if isinstance(filenames, str):
            filenames = [filenames]
        with self._lock:
            self._dispatches.setdefault(worker_id, _RateWindow()).add(now)
            for shard in filenames or ():
                self._shard_rates.setdefault(shard, _RateWindow()).add(now)
                holders = self._shard_workers.setdefault(shard, {})
                holders[worker_id] = now
                if len(holders) > 16:
                    oldest = min(holders, key=holders.get)
                    holders.pop(oldest, None)

    def observe_queue_wait(self, seconds, source="admission"):
        """A measured queue-delay sample: the admission wait-observer hook
        (queued → launch) or a finished query's autopsy
        ``admission_wait + dispatch`` segments (submit → worker send, the
        wait the M/G/1 prediction models).  EWMA'd; the drift gauge is
        predicted vs this."""
        del source
        if not capacity_enabled():
            return
        try:
            seconds = max(float(seconds), 0.0)
        except (TypeError, ValueError):
            return
        with self._lock:
            self._measured_wait = (
                seconds if self._measured_wait is None
                else (1 - EWMA_ALPHA) * self._measured_wait
                + EWMA_ALPHA * seconds
            )
            self._measured_wait_n += 1

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, now=None):
        """Recompute per-worker/fleet utilization, states (hysteresis
        applied), the shard heat map, and the shadow advice; caches the
        result for the gauges and returns it.  Emits ``on_advice`` for each
        recommendation when the advised action set changes."""
        if not capacity_enabled():
            with self._lock:
                # the kill switch must produce the documented stub, not a
                # frozen pre-disable verdict: stale saturation gauges on a
                # dead model would keep alerts firing forever
                self._last_eval = {}
            return {}
        now = time.time() if now is None else now
        with self._lock:
            result = self._evaluate_locked(now)
            # signatures deliberately EXCLUDE the sizing `n`: near a
            # capacity boundary ceil() quantization flips n every beat,
            # and re-emitting a standing scale_up per flip would flood the
            # flight ring and inflate the advised counters
            signatures = {
                (a["action"], a.get("shard")): a
                for a in result["recommendations"]
            }
            # emit/count only recommendations NOT already standing: a
            # rebalance rec flapping in and out must not re-count the
            # unchanged scale_up rec beside it
            previous = self._last_advice or frozenset()
            fresh = [
                rec for sig, rec in signatures.items()
                if sig not in previous
            ]
            self._last_advice = frozenset(signatures)
            for rec in fresh:
                self._advice_counts[rec["action"]] = (
                    self._advice_counts.get(rec["action"], 0) + 1
                )
            self._last_eval = result
        if fresh and self.on_advice is not None:
            for rec in fresh:
                try:
                    self.on_advice(rec)
                except Exception:
                    pass  # shadow advice must never break the event loop
        return result

    def _evaluate_locked(self, now):
        horizon = window_s()
        hold = hysteresis_s()
        arrival_qps = self._arrivals.rate(now, horizon)
        by_class = {
            cls: round(w.rate(now, horizon), 4)
            for cls, w in self._arrivals_by_class.items()
            if w.total(now, horizon) > 0
        }
        launched_qps = self._launched.rate(now, horizon)
        shard_rate = sum(
            w.rate(now, horizon) for w in self._dispatches.values()
        )
        # shards per SERVED query: the launched rate is the denominator —
        # shed/expired/superseded offers dispatch nothing and must not
        # deflate spq (and thereby inflate the knee) exactly when the
        # cluster sheds load
        if launched_qps > 0 and shard_rate > 0:
            spq = max(shard_rate / launched_qps, 1e-6)
            self._spq_ewma = (
                spq if self._spq_ewma is None
                else (1 - EWMA_ALPHA) * self._spq_ewma + EWMA_ALPHA * spq
            )
        spq = self._spq_ewma or 1.0

        workers = {}
        mu_fleet = 0.0
        measured_workers = 0
        wq_num = wq_den = 0.0
        for worker_id, model in self._workers.items():
            lam = (
                self._dispatches[worker_id].rate(now, horizon)
                if worker_id in self._dispatches else 0.0
            )
            mu = model.mu()
            rate_rho = (lam / mu) if mu else None
            busy = model.busy_ewma
            # utilization: the rate ratio when measurable, tempered by the
            # directly measured serving fraction (max of both — a worker
            # 95% busy is saturated no matter how noisy the λ window is)
            rho = rate_rho
            if busy is not None:
                rho = busy if rho is None else max(rho, busy)
            state = model.hysteresis.update(classify(rho), now, hold)
            wq = None
            if mu and rate_rho is not None:
                if rate_rho < 1.0:
                    wq = (
                        rate_rho / (1.0 - rate_rho)
                        * model.mean_s * (1.0 + model.cv2()) / 2.0
                    )
                    wq = min(wq, horizon)
                else:
                    wq = horizon  # unbounded in-model: cap at the window
                wq_num += lam * wq
                wq_den += lam
            if mu and not model.wedged:
                # a wedged accelerator is not capacity: its (pre-latch) μ
                # must not inflate the knee, so losing a device to a wedge
                # shrinks fleet μ exactly like losing the worker
                mu_fleet += mu
                measured_workers += 1
            bottleneck = None
            if model.stage_window:
                bottleneck = max(
                    model.stage_window, key=model.stage_window.get
                )
            workers[worker_id] = {
                "mu": round(mu, 4) if mu else None,
                "lambda": round(lam, 4),
                "rho": round(rho, 4) if rho is not None else None,
                "state": state,
                "mean_service_s": (
                    round(model.mean_s, 6) if model.mean_s else None
                ),
                "cv2": round(model.cv2(), 4),
                "busy_fraction": (
                    round(busy, 4) if busy is not None else None
                ),
                "samples": model.samples,
                "resets": model.resets,
                "predicted_wait_s": (
                    round(wq, 6) if wq is not None else None
                ),
                "bottleneck_stage": bottleneck,
                "wedged": model.wedged,
            }

        n_workers = len(self._workers)
        knee_qps = (mu_fleet / spq) if mu_fleet > 0 else None
        fleet_rho = (shard_rate / mu_fleet) if mu_fleet > 0 else None
        busys = [
            m.busy_ewma for m in self._workers.values()
            if m.busy_ewma is not None
        ]
        if busys:
            mean_busy = sum(busys) / len(busys)
            fleet_rho = (
                mean_busy if fleet_rho is None
                else max(fleet_rho, mean_busy)
            )
        fleet_state = self._fleet_state.update(
            classify(fleet_rho), now, hold
        )
        predicted_wait = (wq_num / wq_den) if wq_den > 0 else None
        measured_wait = self._measured_wait
        drift = None
        if predicted_wait is not None and measured_wait is not None:
            scale = max(predicted_wait, measured_wait, 0.005)
            drift = (predicted_wait - measured_wait) / scale
        headroom_qps = None
        if knee_qps is not None:
            headroom_qps = max(knee_qps * target_rho() - arrival_qps, 0.0)

        heat = self._shard_heat_locked(now, horizon)
        recommendations = self._advise_locked(
            now=now,
            arrival_qps=arrival_qps,
            shard_rate=shard_rate,
            mu_fleet=mu_fleet,
            measured_workers=measured_workers,
            n_workers=n_workers,
            fleet_state=fleet_state,
            fleet_rho=fleet_rho,
            workers=workers,
            heat=heat,
        )
        return {
            "ts": round(now, 3),
            "window_s": horizon,
            "fleet": {
                "workers": n_workers,
                "measured_workers": measured_workers,
                "coverage": (
                    round(measured_workers / n_workers, 4)
                    if n_workers else 0.0
                ),
                "arrival_qps": round(arrival_qps, 4),
                "launched_qps": round(launched_qps, 4),
                "arrival_qps_by_class": by_class,
                "dispatch_rate": round(shard_rate, 4),
                "shards_per_query": round(spq, 4),
                "mu_dispatches_per_s": round(mu_fleet, 4),
                "knee_qps": (
                    round(knee_qps, 4) if knee_qps is not None else None
                ),
                "utilization": (
                    round(fleet_rho, 4) if fleet_rho is not None else None
                ),
                "state": fleet_state,
                "headroom_qps": (
                    round(headroom_qps, 4)
                    if headroom_qps is not None else None
                ),
                "predicted_queue_delay_s": (
                    round(predicted_wait, 6)
                    if predicted_wait is not None else None
                ),
                "measured_queue_delay_s": (
                    round(measured_wait, 6)
                    if measured_wait is not None else None
                ),
                "measured_wait_samples": self._measured_wait_n,
                "model_drift": (
                    round(drift, 4) if drift is not None else None
                ),
            },
            "workers": workers,
            "shard_heat": heat,
            "recommendations": recommendations,
            "advice_counts": dict(self._advice_counts),
        }

    def _shard_heat_locked(self, now, horizon, top=16):
        entries = []
        for shard, w in list(self._shard_rates.items()):
            rate = w.rate(now, horizon)   # trims expired buckets
            if w.total(now, horizon) <= 0:
                if not w.buckets:
                    # no traffic left anywhere in the window: drop the
                    # shard's bookkeeping so a long-lived controller's
                    # heat map stays bounded by ACTIVE shards
                    del self._shard_rates[shard]
                    self._shard_workers.pop(shard, None)
                continue
            entries.append((rate, shard))
        entries.sort(reverse=True)
        # share/skew denominate over the SUMMED per-shard rate, not the
        # envelope dispatch rate: a batched shard group bumps every member
        # shard per envelope, and the envelope denominator would read a
        # perfectly uniform k-shard group as skew k (spurious rebalance
        # advice at k >= SHARD_SKEW_FACTOR)
        n_shards = len(entries)
        total_rate = sum(rate for rate, _shard in entries)
        uniform = (total_rate / n_shards) if n_shards else 0.0
        heat = []
        for rate, shard in entries[:top]:
            share = (rate / total_rate) if total_rate > 0 else 0.0
            heat.append({
                "shard": shard,
                "rate": round(rate, 4),
                "share": round(share, 4),
                "skew": (
                    round(rate / uniform, 2) if uniform > 0 else None
                ),
                "workers": sorted(self._shard_workers.get(shard, ())),
            })
        return heat

    def _advise_locked(self, now, arrival_qps, shard_rate, mu_fleet,
                       measured_workers, n_workers, fleet_state, fleet_rho,
                       workers, heat):
        """Shadow recommendations with evidence.  No traffic in the window
        means no evidence — an idle cluster gets no advice (especially not
        a scale_down loop)."""
        del now
        recs = []
        if arrival_qps <= 0 or not n_workers or not measured_workers:
            return recs
        # sizing is in USABLE workers (measured, non-wedged — the same
        # population μ_fleet sums over): a fleet of 4 with 2 wedged has 2
        # usable workers, and scale_up must size the gap from THAT, or
        # wedged capacity that isn't capacity double-counts
        usable = measured_workers
        mu_avg = mu_fleet / usable if usable else None
        workers_needed = None
        if mu_avg:
            workers_needed = max(
                math.ceil(shard_rate / (target_rho() * mu_avg)), 1
            )
        if fleet_state in (STATE_SATURATED, STATE_OVERLOADED):
            n = 1
            if workers_needed is not None:
                n = max(workers_needed - usable, 1)
            recs.append({
                "action": "scale_up",
                "n": n,
                "reason": (
                    f"fleet {fleet_state}: utilization "
                    f"{fleet_rho if fleet_rho is not None else 'n/a'} vs "
                    f"target {target_rho()}"
                ),
                "evidence": {
                    "fleet_rho": fleet_rho,
                    "arrival_qps": round(arrival_qps, 4),
                    "dispatch_rate": round(shard_rate, 4),
                    "mu_fleet": round(mu_fleet, 4),
                    "workers": n_workers,
                    "usable_workers": usable,
                    "workers_needed": workers_needed,
                },
            })
        elif (
            fleet_state == STATE_OK
            and usable > 1
            and workers_needed is not None
            and workers_needed < usable
            and fleet_rho is not None
            and fleet_rho < 0.5 * rho_warm()
        ):
            recs.append({
                "action": "scale_down",
                "n": usable - workers_needed,
                "reason": (
                    f"fleet idle: utilization {fleet_rho} — "
                    f"{workers_needed} worker(s) would hold ρ at "
                    f"{target_rho()}"
                ),
                "evidence": {
                    "fleet_rho": fleet_rho,
                    "arrival_qps": round(arrival_qps, 4),
                    "workers": n_workers,
                    "usable_workers": usable,
                    "workers_needed": workers_needed,
                },
            })
        # rebalance: a skewed-hot shard while some worker sits cool
        if heat and len(self._shard_rates) >= 4:
            hottest = heat[0]
            cool = [
                wid for wid, w in workers.items()
                if w["state"] == STATE_OK
                and wid not in hottest["workers"]
            ]
            hot_worker_states = [
                workers[wid]["state"] for wid in hottest["workers"]
                if wid in workers
            ]
            if (
                hottest.get("skew") is not None
                and hottest["skew"] >= SHARD_SKEW_FACTOR
                and cool
                and any(s != STATE_OK for s in hot_worker_states)
            ):
                recs.append({
                    "action": "rebalance",
                    "shard": hottest["shard"],
                    "to_worker": min(
                        cool,
                        key=lambda wid: workers[wid]["rho"] or 0.0,
                    ),
                    "reason": (
                        f"shard {hottest['shard']} takes "
                        f"{hottest['skew']}x the uniform dispatch share "
                        "while a holder is hot and another worker is ok"
                    ),
                    "evidence": {
                        "share": hottest["share"],
                        "skew": hottest["skew"],
                        "holders": hottest["workers"],
                    },
                })
        return recs

    # -- read surface -------------------------------------------------------
    def snapshot(self):
        """The cached last evaluation (JSON-safe) — ``rpc.capacity()`` and
        the debug bundle call :meth:`evaluate` first for freshness; the
        gauges read this without recomputing."""
        with self._lock:
            out = dict(self._last_eval)
        out["enabled"] = capacity_enabled()
        return out

    def fleet_gauge(self, field, default=0.0):
        """One fleet-level number for a callback gauge (NaN-free)."""
        with self._lock:
            fleet = self._last_eval.get("fleet") or {}
        value = fleet.get(field)
        if field == "state":
            return STATE_CODES.get(value, 0)
        return default if value is None else value

    def advice_count(self, action):
        with self._lock:
            return self._advice_counts.get(action, 0)

    def worker_resets(self):
        """Total WRM counter restarts detected (the satellite's guard made
        visible: a restarting fleet shows up here, not as poisoned μ)."""
        with self._lock:
            return sum(m.resets for m in self._workers.values())

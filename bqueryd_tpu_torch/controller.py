"""ControllerNode: discovery, dispatch and the sink of queries and appends.

The port's copy of the part of ``bqueryd_tpu/controller.py`` that answers
every verb of ``CONTROLLER_VERBS``, with the reference's wire behaviour:

* one ROUTER socket bound to a random port in 14300-14399, its identity
  ``tcp://ip:port`` registered in the coordination store;
* workers register and re-register with WorkerRegisterMessages (WRMs);
  silent ones are culled;
* messages wait in affinity queues (``worker_out_messages``: ``None`` for
  unpinned work, a worker id for an append or a rollup build pinned to
  that worker with ``worker_id``), drained round-robin, every placeable
  message per tick;
* a ``groupby`` compiles to a logical plan (``plan.logical``), and its
  shards are batched into one ``CalcMessage`` per group of shards that the
  same workers hold (mergeable aggregations; raw rows and the distinct ops
  go one shard per message), so a worker runs one executor call over all
  of them;
* each group's reply payload is kept in memory until every requested
  shard is covered, then the client gets one pickled envelope of
  per-group payloads, which it merges by key value;
* a ``query`` spec compiles to an operator DAG (``plan.dag``) and its
  groupby-shaped plan, and is dispatched like a groupby with the wire DAG
  on every ``CalcMessage`` (one message per shard group when its
  aggregations merge by part kind, else one per shard);
* an ``append`` goes to every holder of the shard, once per distinct
  (node, data_dir), and is answered when all holders confirmed, or with
  an error naming the failed ones.

* resilience: a unit whose worker was lost, whose dispatch went stale
  (``dispatch_timeout`` on a silent worker, ``dispatch_hard_timeout`` on a
  live one) or that failed with a ``transient`` error is re-queued onto a
  different holder after a backoff (:meth:`_requeue`:
  ``_excluded_workers``, ``_not_before``, ``_attempt_history``); past
  ``max_dispatch_retries`` its queries fail with ``error_class``
  "DispatchExhausted" and the attempts.  With ``BQUERYD_TPU_HEDGE_MS`` > 0
  a unit in flight that long also goes to a second holder, and the first
  reply wins.  Replies are deduplicated by token (``duplicate_replies``).
  ``find_free_worker`` prefers the holders the health scorer
  (:mod:`obs.health`, fed by the WRMs) rates ok; ``rpc.health()`` shows
  the statuses.  The fault sites of :mod:`chaos` (``controller.dispatch``,
  ``controller.reply``) make each path testable.

* before any dispatch, a ``groupby`` or ``query`` passes admission
  (:mod:`plan.admission`: at most ``BQUERYD_TPU_ADMIT_MAX_ACTIVE`` plans
  run, ``BQUERYD_TPU_ADMIT_QUEUE_DEPTH`` more wait, each client at most
  ``BQUERYD_TPU_ADMIT_CLIENT_QUOTA``; beyond that the client gets BUSY at
  once); a REQ identity holds one ticket, a resend of the same query joins
  its run and a different query retires the abandoned one;
* shards whose advertised stats (the workers' WRMs, :mod:`plan.stats`)
  exclude the filter are pruned at plan time: never dispatched, their
  payload slots pre-filled empty;
* two concurrent plans that need the identical computation over one shard
  group share ONE CalcMessage, whose reply goes to every subscriber;
* with ``BQUERYD_TPU_BATCH_WINDOW_MS`` > 0, admitted plans are staged for
  that long and compatible ones (same post-prune shards and group keys,
  any measures and filters) go out as one shared-scan bundle per shard
  group (:mod:`plan.bundle`), whose reply is demultiplexed per member; at
  the default 0 nothing is staged.

* each plain groupby dispatch carries a kernel-strategy hint
  (``plan.strategy.select_calibrated``): the heuristic from the advertised
  stats, refined by the kernel walls workers gossip in their WRMs
  (``self.calibration``, :mod:`plan.calibrate`); bundles and DAG
  dispatches carry none.  Each worker's device-health latch
  (``backend_wedged``) is kept in its ``worker_map`` entry and scored.

* the serving layer (:mod:`serve`) answers a query before admission when
  a materialized rollup proves its answer (``answer_source`` "rollup" or
  "subsume", with ``subsumed_from`` naming the rollup); it builds and
  delta-refreshes rollups of hot plans with ``rollup`` messages to the
  workers.  A dispatched answer says "cached" when every shard group came
  from a worker's result cache, "delta" when any was delta-refreshed, else
  "recompute".  ``BQUERYD_TPU_SERVE=0`` turns it off.
* every counter is also a Prometheus counter of ``self.metrics``
  (``rpc.metrics()``); the flight ring (``self.flight``) records dispatches,
  worker removals and the serving layer's decisions and rollup lifecycle;
  ``rpc.debug_bundle()`` assembles it with each worker's heartbeat slice.

* distribution: ``download`` registers a ticket in the store, one slot
  per (placement node, file) (:mod:`download`, ``replica_factor`` holders
  per file, every node at 0); a downloader's ``TicketDoneMessage``
  answers the client waiting on it, with the ticket's error when one
  failed.  ``get_info()["replication"]`` and the
  ``bqueryd_tpu_replica_holders`` gauges count shards by live holders;
* peers: every heartbeat the controller connects to the other
  controllers in the store and sends each its info (``peer_info``, kept
  in ``others``); an unreachable peer is removed from the store;
* the admin verbs: ``sleep``, ``readfile`` and ``execute_code`` go to
  one free calc worker and its reply is relayed as it comes; ``kill``
  stops this controller, ``killworkers`` every worker, ``killall`` both,
  relayed once to every peer.

* tracing and accounting (:mod:`obs`): a query adopts the client's trace
  context (``trace``) and its spans (``groupby``, ``admission``,
  ``plan``, ``dispatch``, ``demux`` here; ``calc`` and its phases from the
  workers' replies) are assembled when it finishes into a timeline in
  ``trace_store`` (``rpc.trace``) with its critical-path attribution
  (``rpc.autopsy``); the query lands in its SLO class (``slo``), in the
  ``query_seconds`` histogram and, past ``BQUERYD_TPU_SLOW_QUERY_MS``, in
  ``slow_queries`` (``rpc.slow_queries``); every heartbeat evaluates the
  capacity model (``capacity``, ``rpc.capacity``) and snapshots the
  controller into ``timeline_ring`` (``rpc.timeline``).  An answer served
  by the serving layer is accounted as a dispatched one is.
  ``BQUERYD_TPU_METRICS_PORT`` serves ``/metrics``.

The controller imports neither torch nor pandas.

Framing on the ROUTER socket:

* 3 frames with an empty middle = an RPC request from a REQ client;
* 3 frames, non-empty middle   = a worker reply with a binary result frame;
* 2 frames                     = a worker control message.
"""

import base64
import binascii
import logging
import os
import pickle
import random
import signal
import socket
import threading
import time

import zmq

import bqueryd_tpu_torch
from bqueryd_tpu_torch import backoff, chaos, messages
from bqueryd_tpu_torch.coordination import coordination_store
from bqueryd_tpu_torch.messages import (
    BusyMessage,
    CalcMessage,
    DoneMessage,
    ErrorMessage,
    Message,
    RPCMessage,
    StopMessage,
    TicketDoneMessage,
    WorkerRegisterMessage,
    msg_factory,
)
from bqueryd_tpu_torch.utils.env import env_num
from bqueryd_tpu_torch.utils.net import bind_to_random_port, get_my_ip

POLLING_TIMEOUT = 0.5        # seconds
DEAD_WORKER_TIMEOUT = 60.0   # cull workers silent longer than this
HEARTBEAT_INTERVAL = 2.0     # store re-registration period
DISPATCH_TIMEOUT = 120.0     # re-queue in-flight work of a dead worker
DISPATCH_HARD_TIMEOUT = 1800.0  # ...and of a live one after this
MAX_DISPATCH_RETRIES = 2
#: failover pacing between dispatch attempts of one unit: base * 2^retries,
#: capped, plus a per-token jitter (:mod:`bqueryd_tpu_torch.backoff`, the
#: formula the RPC client's retries use too)
RETRY_BACKOFF_BASE_S = backoff.BACKOFF_BASE_S
RETRY_BACKOFF_CAP_S = backoff.BACKOFF_CAP_S
#: how long an append fan-out waits for every holder's reply
APPEND_TIMEOUT = 120.0
RUNFILE_DIR = os.environ.get("BQUERYD_TPU_RUNFILE_DIR", "/srv")

#: the reference's verbs, in its order
CONTROLLER_VERBS = (
    "ping", "loglevel", "info", "kill", "killworkers", "killall",
    "download", "readfile", "execute_code", "sleep", "groupby", "query",
    "trace", "metrics", "slow_queries", "health", "debug_bundle",
    "autopsy", "timeline", "capacity", "append",
)

#: verbs a worker answers for one client directly: no query segment, the
#: reply relayed as it comes
DIRECT_VERBS = ("sleep", "readfile", "execute_code")

#: the controller's counters with their help texts (the reference's names
#: and meanings): ``self.counters`` is a dict built from them
#: (:class:`obs.RegistryCounters`), in ``get_info()["counters"]``, and each
#: key is also the Prometheus counter ``bqueryd_tpu_<key>_total``
COUNTER_SPECS = {
    "plan_pruned_shards": "shards excluded at plan time by advertised stats",
    "plan_shared_dispatches":
        "concurrent queries that joined an existing dispatch instead of "
        "paying their own (identical-work dedup + shared-scan bundle "
        "members beyond the first)",
    "plan_bundles":
        "shared-scan bundle dispatches: one decode/align/upload pass and "
        "one mesh program serving a whole compatible micro-batch",
    "plan_bundled_queries":
        "member queries that rode a shared-scan bundle dispatch",
    "plan_strategy_hints": "non-auto kernel-strategy hints issued",
    "plan_calibrated_overrides":
        "dispatches where measured walls overrode the heuristic route",
    "plan_explore_hints":
        "bounded-exploration dispatches sampling an unmeasured route",
    "plan_matmul_promotions":
        "calibration-backed matmul hints made binding inside the guards",
    "admission_busy": "BUSY backpressure replies sent to clients",
    "admission_queued": "plans held in the admission wait queue",
    "admission_superseded": "abandoned queries retired early on resend",
    "deadline_expired": "work expired by its deadline before running",
    "dispatched_shards": "groupby CalcMessages sent to workers",
    "queries_completed": "groupby parents finished (reply sent or aborted)",
    "slow_queries": "finished queries past BQUERYD_TPU_SLOW_QUERY_MS",
    "health_avoided_dispatches":
        "dispatch decisions that routed around a degraded/wedged worker",
    "reply_payload_bytes":
        "cumulative result-payload bytes received in worker calc replies "
        "(the controller-side twin of the worker's reply_bytes histogram)",
    "failover_dispatches":
        "shards re-queued after a worker loss, timeout, or transient fault "
        "(the retry excludes the failed holder)",
    "transient_faults":
        "transient (retryable) worker error replies that triggered a "
        "shard failover instead of a query abort",
    "hedged_dispatches":
        "duplicate tail-shard dispatches issued past BQUERYD_TPU_HEDGE_MS",
    "hedge_wins":
        "hedged dispatches whose duplicate replied before the original",
    "duplicate_replies":
        "worker replies deduplicated by query token (hedge losers, "
        "late retries, chaos-duplicated envelopes) — counted, never "
        "double-merged",
    "capacity_scale_up_advised":
        "shadow-advisor scale_up recommendations emitted (advisory only — "
        "logged to the flight ring, never acted on)",
    "capacity_scale_down_advised":
        "shadow-advisor scale_down recommendations emitted (advisory only)",
    "capacity_rebalance_advised":
        "shadow-advisor shard-rebalance recommendations emitted (advisory "
        "only)",
    "rollup_builds":
        "materialized-rollup shard builds completed (serve.rollup full "
        "rebuilds; delta refreshes count separately)",
    "rollup_refreshes":
        "rollup shard refreshes served by aggregating only appended tail "
        "chunks (growth_since exact-prefix validation)",
    "rollup_evictions":
        "rollup entries dropped by the retention sweep (count/byte caps, "
        "wedged-build timeout)",
}


#: the parts of the controller loop's wall
#: (``bqueryd_tpu_controller_loop_seconds_total{part}``): the poll; every
#: frame's handling, client answers included; the finished queries'
#: accounting (:meth:`ControllerNode._finalize_query_obs`), wherever the
#: loop runs it; ``dispatch_pending``; the rest (heartbeat, the dead-worker
#: sweep, stale retries, hedging, admission, the window flush, the append
#: sweep)
LOOP_PARTS = ("wait", "receive", "finalize", "dispatch", "other")

#: worker roles that share a serving dir but serve none of its shards
NON_SERVING_ROLES = ("download", "movebcolz")


def _served_files(info):
    """The shards a WRM makes its worker a holder of.  A downloader and a
    mover list the data dir they stage into, but hold no shard: a rollup
    build or an append pinned to one of them would fail, and the replica
    counts would count them."""
    if info.get("workertype") in NON_SERVING_ROLES:
        return []
    return info.get("data_files") or []


class ControllerNode:
    def __init__(
        self,
        coordination_url=None,
        loglevel=None,
        runfile_dir=RUNFILE_DIR,
        heartbeat_interval=HEARTBEAT_INTERVAL,
        dead_worker_timeout=None,
        dispatch_timeout=None,
        dispatch_hard_timeout=None,
        port_range=(14300, 14400),
        admit_max_active=None,
        admit_queue_depth=None,
        admit_client_quota=None,
        max_dispatch_retries=None,
        hedge_ms=None,
    ):
        from bqueryd_tpu_torch import obs
        from bqueryd_tpu_torch.plan import AdmissionController, calibrate
        from bqueryd_tpu_torch.serve import ServingLayer

        bqueryd_tpu_torch.configure_logging(loglevel or logging.INFO)
        # fault injection: armed only when BQUERYD_TPU_FAULT_PLAN is set;
        # every fault site is one None check otherwise
        chaos.maybe_arm_from_env()
        self.store = coordination_store(
            coordination_url or bqueryd_tpu_torch.DEFAULT_COORDINATION_URL
        )
        self.heartbeat_interval = heartbeat_interval
        # the timing knobs: the constructor argument, else the env var,
        # else the module constant
        if dead_worker_timeout is None:
            dead_worker_timeout = env_num("BQUERYD_TPU_DEAD_WORKER_TIMEOUT",
                                          DEAD_WORKER_TIMEOUT)
        if dispatch_timeout is None:
            dispatch_timeout = env_num("BQUERYD_TPU_DISPATCH_TIMEOUT",
                                       DISPATCH_TIMEOUT)
        if dispatch_hard_timeout is None:
            dispatch_hard_timeout = env_num(
                "BQUERYD_TPU_DISPATCH_HARD_TIMEOUT", DISPATCH_HARD_TIMEOUT)
        self.dead_worker_timeout = dead_worker_timeout
        self.dispatch_timeout = dispatch_timeout
        self.dispatch_hard_timeout = max(dispatch_hard_timeout,
                                         dispatch_timeout)
        self.max_dispatch_retries = (
            max_dispatch_retries if max_dispatch_retries is not None
            else env_num("BQUERYD_TPU_MAX_DISPATCH_RETRIES",
                         MAX_DISPATCH_RETRIES, int)
        )
        # hedged dispatch of tail work: 0 (the default) is off; past this
        # many milliseconds in flight a unit goes to a second holder too
        self.hedge_ms = (hedge_ms if hedge_ms is not None
                         else env_num("BQUERYD_TPU_HEDGE_MS", 0.0))
        # replica placement of downloads: this many holders per shard (0,
        # the default, is every node; download.setup_download), visible in
        # get_info and the replica_holders gauges
        self.replica_factor = max(
            env_num("BQUERYD_TPU_REPLICA_FACTOR", 0, int), 0)

        self.context = zmq.Context.instance()
        self.socket = self.context.socket(zmq.ROUTER)
        self.socket.setsockopt(zmq.ROUTER_MANDATORY, 1)
        self.socket.setsockopt(zmq.SNDTIMEO, 1000)
        self.socket.setsockopt(zmq.LINGER, 500)
        self.address = bind_to_random_port(
            self.socket, f"tcp://{get_my_ip()}", port_range[0], port_range[1]
        )
        self.logger = bqueryd_tpu_torch.logger.getChild(
            f"controller.{self.address}"
        )
        self.node_name = socket.gethostname()
        self.poller = zmq.Poller()
        self.poller.register(self.socket, zmq.POLLIN)

        self.worker_map = {}          # worker_id -> WRM info (+ last_seen/busy)
        self._adoption_blocked = {}   # worker_id -> until-ts (hb-only cull)
        self.files_map = {}           # filename -> set(worker_id)
        self._holder_counts_memo = None
        self.others = {}              # peer controller address -> its info
        self._ticket_files = {}       # download ticket -> its shard names
        # messages waiting for a worker, one queue per affinity: None for
        # unpinned work, a worker id for the messages pinned to it
        self.worker_out_messages = {None: []}
        self._affinity_rr = 0
        self.inflight = {}            # work token -> {worker, sent_at, msg,
        #                               parent, retries[, hedged, hedged_at]}
        self._hedged_tokens = {}      # answered token -> ts (dedup ring)
        self._hedge_losers = {}       # token -> {workers, since}: reclaim
        #                               handles on the side that lost
        self._requeued_tokens = set()  # retries waiting in a queue: a late
        #                                reply of the failed attempt must
        #                                neither abort nor run again
        self.rpc_segments = {}        # parent token -> fan-out bookkeeping
        # admission: the REQ identity is the ticket
        self.admission = AdmissionController(
            max_active=admit_max_active,
            queue_depth=admit_queue_depth,
            client_quota=admit_client_quota,
        )
        self._admitting = False
        self._ticket_sigs = {}        # live ticket -> (filenames, plan sig)
        self.shard_stats = {}         # filename -> advertised stats
        # measured-cost calibration: the workers' WRM summaries, one
        # source per worker, consulted by select_calibrated at dispatch;
        # in memory only (the workers own persistence)
        self.calibration = calibrate.CalibrationStore()
        self._worker_wedged = {}      # worker_id -> last advertised latch
        self._worker_metrics = {}     # worker_id -> last histogram snapshot
        self._worker_metrics_rev = 0  # bumped on absorb/remove (memo key)
        self._worker_hist_cache = (-1, None)  # (rev, merged aggregate)
        # rolling latency and error baselines from the WRMs, which
        # find_free_worker's candidate order acts on
        self.health = obs.HealthScorer()
        # the serving layer: subsumption and materialized rollups; a hit
        # replies before admission, BQUERYD_TPU_SERVE=0 makes every entry
        # point a no-op
        self.serving = ServingLayer(self)
        self._rollup_waiters = {}     # rollup dispatch token -> (key, file)
        # shared dispatch: every groupby work unit has a subscriber list,
        # the parents waiting for its payload
        self._work_subscribers = {}   # work token -> [parent token, ...]
        self._work_keys = {}          # work token -> shared-dispatch key
        self._work_index = {}         # shared-dispatch key -> work token
        # the micro-batch window: admitted plans staged until it closes,
        # then flushed grouped by compatibility key; empty at window 0
        self._pending_window = []     # [(msg, plan, kwargs), ...]
        self._window_opened = 0.0
        # observability: the counters dict mirrors every write into a
        # typed registry counter; liveness gauges are read at render time
        self.metrics = obs.MetricsRegistry()
        self.counters = obs.RegistryCounters(self.metrics, COUNTER_SPECS)
        self.loop_clock = obs.LoopClock(
            self.metrics, "bqueryd_tpu_controller_loop_seconds_total",
            "seconds of the controller loop's wall per part (wait, "
            "receive, finalize, dispatch, other); they sum to the loop's "
            "wall", LOOP_PARTS)
        self.metrics.gauge(
            "bqueryd_tpu_admission_active",
            "plans currently executing", fn=lambda: len(self.admission._active),
        )
        self.metrics.gauge(
            "bqueryd_tpu_admission_queue_depth",
            "plans waiting in the admission queue",
            fn=lambda: len(self.admission._queued),
        )
        self.metrics.gauge(
            "bqueryd_tpu_inflight_shards",
            "shard dispatches awaiting a worker reply",
            fn=lambda: len(self.inflight),
        )
        self.metrics.gauge(
            "bqueryd_tpu_workers_known",
            "workers currently registered", fn=lambda: len(self.worker_map),
        )
        self.metrics.gauge(
            "bqueryd_tpu_fault_injected_total",
            "faults injected by the armed chaos plan, process-lifetime "
            "(0 while BQUERYD_TPU_FAULT_PLAN is unarmed)",
            fn=chaos.injected_total,
        )
        # replica visibility: shards by live holder count; a failover
        # needs a second holder, so holders="1" is the pager signal
        for bucket in ("1", "2", "3plus"):
            self.metrics.gauge(
                "bqueryd_tpu_replica_holders",
                "advertised shards by live holder count (failover needs a "
                "second holder; see BQUERYD_TPU_REPLICA_FACTOR)",
                labels={"holders": bucket},
                fn=(lambda b=bucket: self._holder_counts().get(b, 0)),
            )
        self.metrics.gauge(
            "bqueryd_tpu_workers_degraded",
            "registered workers currently scored degraded or wedged",
            fn=lambda: sum(1 for st in self.health.statuses().values()
                           if st.get("status") != obs.STATUS_OK),
        )
        self.query_seconds = self.metrics.histogram(
            "bqueryd_tpu_groupby_seconds",
            "end-to-end groupby wall at the controller (admission to reply)",
        )
        self.admission_wait_seconds = self.metrics.histogram(
            "bqueryd_tpu_admission_wait_seconds",
            "time queued in admission before launch",
        )
        self.admission.wait_observer = self._observe_admission_wait
        # the finished queries' timelines (rpc.trace, rpc.autopsy), the
        # slow ones (rpc.slow_queries), the SLO classes' accounting and
        # the periodic snapshot ring (rpc.timeline)
        self.trace_store = obs.TraceStore()
        self.slow_queries = obs.SlowQueryLog()
        self.slo = obs.slo.SLOTracker(self.metrics)
        self.timeline_ring = obs.slo.SnapshotTimeline()
        # the fleet capacity model: per-worker service rates from the WRM
        # histograms, arrival rates from the admission tap, evaluated each
        # heartbeat (rpc.capacity)
        self.capacity = obs.capacity.CapacityModel(
            on_advice=self._record_capacity_advice)
        self.admission.arrival_observer = self._observe_arrival
        for name, help_text, key in (
            ("bqueryd_tpu_capacity_fleet_utilization",
             "fleet utilization estimate ρ (dispatch rate over aggregate "
             "service rate, tempered by measured busy fractions)",
             "utilization"),
            ("bqueryd_tpu_capacity_fleet_state",
             "fleet saturation state code (0=ok 1=warm 2=saturated "
             "3=overloaded, hysteresis applied)", "state"),
            ("bqueryd_tpu_capacity_headroom_qps",
             "estimated additional query arrival rate the fleet can absorb "
             "before utilization crosses BQUERYD_TPU_CAPACITY_TARGET_RHO",
             "headroom_qps"),
            ("bqueryd_tpu_capacity_model_drift",
             "model-vs-measured queue-delay drift: (predicted - measured) / "
             "max(both) — near 0 means the M/G/1 prediction tracks reality",
             "model_drift"),
        ):
            self.metrics.gauge(
                name, help_text,
                fn=(lambda k=key: self.capacity.fleet_gauge(k)))
        self.metrics.gauge(
            "bqueryd_tpu_capacity_worker_resets",
            "WRM counter restarts the capacity model detected and rebased "
            "(worker processes restarting under the same node id)",
            fn=self.capacity.worker_resets,
        )
        self.metrics.gauge(
            "bqueryd_tpu_trace_buffer_evictions",
            "trace timelines evicted by the ring's entry/byte bounds "
            "(monotonic)",
            fn=lambda: self.trace_store.evictions,
        )
        self.metrics.gauge(
            "bqueryd_tpu_slow_query_evictions",
            "slow-query entries evicted by the ring's entry/byte bounds "
            "(monotonic)",
            fn=lambda: self.slow_queries.evictions,
        )
        # the flight ring behind rpc.debug_bundle(), and each worker's
        # heartbeat slice, kept after the worker is removed (its last words
        # are what a bundle is for), bounded to the newest entries
        self.flight = obs.FlightRecorder(node_id=self.address)
        self.metrics.gauge(
            "bqueryd_tpu_flight_evictions",
            "flight-ring events evicted by the entry/byte bounds (monotonic)",
            fn=lambda: self.flight.evictions,
        )
        self._worker_debug = {}       # worker_id -> {"data", "ts"}
        self._worker_debug_cap = 64
        self._append_segments = {}    # append fan-out key -> its state
        self._append_waiters = {}     # append dispatch token -> fan-out key
        from bqueryd_tpu_torch.obs import http as obs_http

        self._metrics_server = obs_http.maybe_start(self.metrics,
                                                    self.logger)
        self.msg_count_in = 0
        self.start_time = time.time()
        self.running = False
        self._loop_thread = None
        self.last_heartbeat = 0.0
        self.runfile_dir = runfile_dir
        self._write_runfiles()

    # -- runfiles ----------------------------------------------------------
    def _write_runfiles(self):
        self._runfiles = []
        try:
            for suffix, content in (
                ("address", self.address),
                ("pid", str(os.getpid())),
            ):
                path = os.path.join(
                    self.runfile_dir, f"bqueryd_tpu_controller.{suffix}"
                )
                with open(path, "w") as f:
                    f.write(content)
                self._runfiles.append(path)
        except OSError:
            self.logger.debug("runfile dir %s not writable", self.runfile_dir)

    def _remove_runfiles(self):
        for path in self._runfiles:
            try:
                os.remove(path)
            except OSError:
                pass

    # -- main loop ---------------------------------------------------------
    def go(self):
        self.running = True
        self._loop_thread = threading.current_thread()
        try:
            signal.signal(signal.SIGTERM, self._term_signal)
            if hasattr(signal, "SIGUSR1"):
                # local forensic dump: kill -USR1 <pid> writes the full
                # debug bundle without needing a live client
                signal.signal(signal.SIGUSR1, self._dump_debug_signal)
        except ValueError:
            pass  # not the main thread (in-process clusters)
        self.logger.info("controller %s running", self.address)
        try:
            while self.running:
                try:
                    self._loop_enter("other")
                    self.heartbeat()
                    self.free_dead_workers()
                    self.retry_stale_dispatches()
                    self.maybe_hedge()
                    # a staged window bounds the poll: its flush is due
                    # when it closes, not a full POLLING_TIMEOUT later
                    # (closed-loop clients send nothing while staged)
                    timeout_s = POLLING_TIMEOUT
                    if self._pending_window:
                        remaining = self._window_deadline() - time.time()
                        timeout_s = max(min(timeout_s, remaining), 0.0)
                    self._loop_enter("wait")
                    events = dict(self.poller.poll(int(timeout_s * 1000)))
                    if self.socket in events:
                        self._loop_enter("receive")
                        # drain everything available this tick, then
                        # dispatch in the same tick: a reply's Done frees
                        # its worker for the next message at once
                        while True:
                            try:
                                frames = self.socket.recv_multipart(
                                    zmq.NOBLOCK
                                )
                            except zmq.Again:
                                break
                            self.handle_in(frames)
                    self._loop_enter("other")
                    self._admit_ready()
                    self._flush_window()
                    self._loop_enter("dispatch")
                    self.dispatch_pending()
                    self._loop_enter("other")
                    self._sweep_append_segments()
                except Exception:
                    self.logger.exception("error in controller loop")
            self._loop_enter("other")  # the last part's seconds
        finally:
            self.stop()

    def _loop_enter(self, part):
        """The loop leaves its current part for ``part``
        (:class:`obs.LoopClock`); returns the part it left."""
        from bqueryd_tpu_torch import obs

        return self.loop_clock.enter(part, on=obs.enabled())[0]

    def _term_signal(self, *args):
        self.logger.info("SIGTERM received, stopping")
        self.running = False

    def _dump_debug_signal(self, *args):
        """SIGUSR1: write :meth:`build_debug_bundle` as one JSON file under
        ``BQUERYD_TPU_DEBUG_DIR`` (else the temporary directory)."""
        from bqueryd_tpu_torch.obs import flightrec

        try:
            path = flightrec.dump_bundle(self.build_debug_bundle(),
                                         role="controller")
            self.logger.warning("SIGUSR1: debug bundle written to %s", path)
        except Exception:
            self.logger.exception("SIGUSR1 debug dump failed")

    def stop(self):
        """Stop the node.  From another thread this only flags the loop;
        the loop thread deregisters and closes its socket on the way
        out."""
        self.running = False
        loop = self._loop_thread
        if (loop is not None and loop.is_alive()
                and threading.current_thread() is not loop):
            return
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        try:
            self.store.srem(bqueryd_tpu_torch.REDIS_SET_KEY, self.address)
        except Exception:
            self.logger.debug("deregistration failed", exc_info=True)
        self._remove_runfiles()
        if not self.socket.closed:
            self.socket.close()
            self.logger.info("controller %s stopped", self.address)

    # -- membership --------------------------------------------------------
    def heartbeat(self):
        now = time.time()
        if now - self.last_heartbeat < self.heartbeat_interval:
            return
        self.last_heartbeat = now
        # the capacity model's evaluation (states with hysteresis, shadow
        # advice; a no-op under BQUERYD_TPU_CAPACITY=0), before the
        # timeline snapshot, so that each ring entry carries this beat's
        self.capacity.evaluate(now=now)
        # one snapshot per BQUERYD_TPU_TIMELINE_INTERVAL_S (the ring paces
        # itself; <= 0 disables)
        self.timeline_ring.maybe_snapshot(self._timeline_snapshot, now=now)
        # serving housekeeping: abandon wedged rollup builds, hold the
        # retention caps, dispatch delta refreshes of stale entries
        self.serving.tick()
        self.store.sadd(bqueryd_tpu_torch.REDIS_SET_KEY, self.address)
        self._gossip()

    def _gossip(self):
        """Connect to the peer controllers in the store, forget those that
        left it, and send each this controller's info (``peer_info``); a
        peer that cannot be reached is removed from the store."""
        current = self.store.smembers(bqueryd_tpu_torch.REDIS_SET_KEY)
        for addr in current:
            if addr == self.address or addr in self.others:
                continue
            self.logger.debug("connecting to peer %s", addr)
            self.socket.connect(addr)
            self.others[addr] = {"last_seen": 0.0}
        for addr in list(self.others):
            if addr not in current:
                self.others.pop(addr, None)
                continue
            gossip = Message({"payload": "peer_info"})
            gossip["from"] = self.address
            gossip.add_as_binary("info", self.get_info(include_peers=False))
            try:
                self.socket.send_multipart(
                    [addr.encode(), gossip.to_json().encode()])
            except zmq.ZMQError:
                self.logger.warning("peer %s unreachable, removing", addr)
                self.store.srem(bqueryd_tpu_torch.REDIS_SET_KEY, addr)
                self.others.pop(addr, None)

    def free_dead_workers(self):
        """Cull workers silent longer than ``dead_worker_timeout``, but
        never one holding work younger than ``dispatch_timeout``: culling it
        would fail the very query it is busy with.  A worker known only
        from heartbeats (its loop never spoke) is culled after
        ``dispatch_hard_timeout``."""
        now = time.time()
        for worker_id, info in list(self.worker_map.items()):
            hb_since = info.get("hb_only")
            if hb_since and now - hb_since > self.dispatch_hard_timeout:
                self.logger.warning(
                    "hb-only worker %s never spoke on its main socket in "
                    "%.0fs, removing", worker_id, now - hb_since,
                )
                # its heartbeat thread still ticks: do not adopt it again
                # until its main socket speaks
                self._adoption_blocked[worker_id] = (
                    now + self.dispatch_hard_timeout
                )
                self.remove_worker(worker_id)
                continue
            if now - info.get("last_seen", now) <= self.dead_worker_timeout:
                continue
            if any(
                e["worker"] == worker_id
                and now - e["sent_at"] <= self.dispatch_timeout
                for e in self.inflight.values()
            ):
                continue
            self.logger.warning("culling dead worker %s", worker_id)
            self.remove_worker(worker_id)

    def remove_worker(self, worker_id):
        """Forget a worker and its files; re-queue its in-flight work onto
        another holder (a hedged flight collapses onto its surviving side
        instead).  An append or a rollup build pinned to it, queued or in
        flight, fails its fan-out or its rollup entry: it cannot complete
        any more.  Its debug slice is kept for the bundle."""
        if worker_id in self.worker_map:
            # forensic event, never gated
            self.flight.record("worker_removed", worker=worker_id)
        self.worker_map.pop(worker_id, None)
        self.health.remove(worker_id)
        self.capacity.remove_worker(worker_id)
        self._worker_wedged.pop(worker_id, None)
        if self._worker_metrics.pop(worker_id, None) is not None:
            self._worker_metrics_rev += 1
        for filename in list(self.files_map):
            self.files_map[filename].discard(worker_id)
            if not self.files_map[filename]:
                del self.files_map[filename]
                self.shard_stats.pop(filename, None)
        # an append waiting on this holder fails fast: the fan-out cannot
        # complete any more
        for seg_key, segment in list(self._append_segments.items()):
            gone = [t for t, w in segment["pending"].items()
                    if w == worker_id]
            for t in gone:
                segment["pending"].pop(t)
                self._append_waiters.pop(t, None)
                segment["errors"][worker_id] = (
                    "holder removed (worker lost before confirming)"
                )
            if gone and not segment["pending"]:
                self._finish_append_segment(seg_key, segment)
        # the worker's own queue: its pinned messages can never be sent
        for msg in self.worker_out_messages.pop(worker_id, []):
            self._fail_pinned(msg, "holder removed")
        for token, entry in list(self.inflight.items()):
            if entry.get("hedged") == worker_id:
                self.inflight.pop(token)
                self._collapse_hedge(token, entry, worker_id)
            elif entry["worker"] == worker_id:
                self.inflight.pop(token)
                if entry.get("hedged"):
                    self._collapse_hedge(token, entry, worker_id)
                else:
                    self._requeue(entry, reason=f"worker {worker_id} lost")

    def _fail_pinned(self, msg, reason):
        """A message pinned to one worker (``worker_id``: an append or a
        rollup build) that can no longer be answered: its rollup entry
        fails, or its append fan-out records the holder's failure."""
        token = msg.get("token")
        waiter = self._rollup_waiters.pop(token, None)
        if waiter is not None:
            self._fail_rollup(waiter[0], waiter[1], reason)
        seg_key = self._append_waiters.pop(token, None)
        segment = self._append_segments.get(seg_key)
        if segment is not None:
            holder = segment["pending"].pop(token, None)
            if holder is not None:
                segment["errors"][holder] = str(reason)[:300]
            if not segment["pending"]:
                self._finish_append_segment(seg_key, segment)

    def _retry_backoff(self, msg, retries):
        """The pause before the next dispatch attempt of one work unit:
        base * 2^retries, capped, stretched by up to 25% keyed on its
        token (stable across runs, different across shards, so that
        simultaneous failovers do not stampede one holder)."""
        return backoff.backoff_delay(
            retries, str(msg.get("token") or ""),
            base=RETRY_BACKOFF_BASE_S, cap=RETRY_BACKOFF_CAP_S,
        )

    def _requeue(self, entry, charge_retry=True, failed_worker=None,
                 reason=None):
        """Queue a failed dispatch attempt again, on another holder while
        one exists (``_excluded_workers``), after a backoff
        (``_not_before``), with the attempt in ``_attempt_history``; or,
        once ``max_dispatch_retries`` charged retries are spent, fail its
        queries with ``error_class`` "DispatchExhausted" and that history.
        ``entry`` is an inflight entry (``msg``, ``worker``, ``retries``).
        A message pinned to one worker is not re-queued: its append
        fan-out or rollup entry records the failure."""
        msg = entry["msg"]
        retries = entry.get("retries", 0)
        if failed_worker is None:
            failed_worker = entry.get("worker")
        reason = str(reason or "worker lost or dispatch timed out")
        if msg.get("worker_id") is not None:
            self._fail_pinned(msg, reason)
            return
        from bqueryd_tpu_torch import obs

        # the failed attempt's in-flight window as a dispatch span tagged
        # with the failure: a unit that sat on a lost worker autopsies as
        # dispatch time on that worker
        sent_at = entry.get("sent_at")
        wire = msg.get_trace()
        if sent_at is not None and wire and obs.enabled():
            self._append_spans(msg, [obs.make_span(
                wire["trace_id"], "dispatch", sent_at,
                max(time.time() - float(sent_at), 0.0),
                parent_span_id=wire.get("parent_span_id"),
                node=self.address,
                tags={"worker": failed_worker, "retries": retries,
                      "failed": reason[:120]},
            )])
        # the per-attempt history rides the message (bounded by the retry
        # budget); the exhaustion envelope hands it to the client
        history = list(msg.get("_attempt_history") or [])
        history.append({
            "worker": failed_worker,
            "reason": reason[:200],
            "retries": retries,
            "ts": round(time.time(), 3),
        })
        msg["_attempt_history"] = history
        if failed_worker:
            # the retry lands on a different holder while one exists
            excluded = list(msg.get("_excluded_workers") or [])
            if failed_worker not in excluded:
                excluded.append(failed_worker)
            msg["_excluded_workers"] = excluded
        if charge_retry and retries >= self.max_dispatch_retries:
            self._abort_work(
                msg,
                f"shard {msg.get('filename')} failed after {retries} "
                f"retries (worker lost, timed out, or faulted)",
                error_class="DispatchExhausted",
                attempts=history,
            )
            return
        if charge_retry and failed_worker:
            self.counters["failover_dispatches"] += 1
        msg["_retries"] = retries + 1 if charge_retry else retries
        backoff_s = self._retry_backoff(msg, retries)
        msg["_not_before"] = time.time() + backoff_s
        msg["_backoff_s"] = round(backoff_s, 6)
        # each attempt is a trace hop of its own: a fresh span id and
        # queue clock
        wire = msg.get_trace()
        if wire:
            msg.set_trace(dict(wire, span_id=os.urandom(8).hex()))
            msg["_dispatch_queued_ts"] = time.time()
        if msg.get("token"):
            self._requeued_tokens.add(msg.get("token"))
        self.worker_out_messages.setdefault(msg.get("affinity"), []).append(
            msg)

    def _holder_counts(self):
        """Advertised shards bucketed by live holder count ("1", "2",
        "3plus"): the replica_holders gauges and get_info's replication
        view.  Memoized for 0.25 s, as one metrics scrape reads all three
        buckets."""
        now = time.time()
        cached = self._holder_counts_memo
        if cached is not None and now - cached[0] < 0.25:
            return cached[1]
        counts = {"1": 0, "2": 0, "3plus": 0}
        for holders in list(self.files_map.values()):
            n = len(holders)
            if n >= 3:
                counts["3plus"] += 1
            elif n:
                counts[str(n)] += 1
        self._holder_counts_memo = (now, counts)
        return counts

    # -- scheduling --------------------------------------------------------
    def find_free_worker(self, needs_local=False, filename=None, exclude=()):
        """A random free calc worker that advertises ``filename`` (one
        name, or every name of a batched shard group's list), on this
        controller's host when ``needs_local``.

        ``exclude`` is the failover set: holders this unit already failed
        on, avoided while any other candidate exists (a sole holder still
        serves: a transient fault may have cleared).  Among the rest,
        workers the health scorer rates degraded or wedged are used only
        when no healthy candidate is free (counted in
        ``health_avoided_dispatches``); ``BQUERYD_TPU_HEALTH_ROUTING=0``
        turns that preference off."""
        from bqueryd_tpu_torch.obs import health as health_mod

        needed = ([filename] if isinstance(filename, str)
                  else list(filename or []))
        candidates = [
            worker_id for worker_id, info in self.worker_map.items()
            if info.get("workertype") == "calc" and not info.get("busy")
            and all(worker_id in self.files_map.get(f, ()) for f in needed)
            and (not needs_local or info.get("node") == self.node_name)
        ]
        if exclude:
            kept = [w for w in candidates if w not in exclude]
            if kept:
                candidates = kept
        if not candidates:
            return None
        if len(candidates) > 1 and health_mod.routing_enabled():
            healthy = self.health.healthy_subset(candidates)
            if healthy and len(healthy) < len(candidates):
                self.counters["health_avoided_dispatches"] += 1
                candidates = healthy
        return random.choice(candidates)

    def dispatch_pending(self):
        """Drain the affinity queues round-robin, every message that can
        be placed this tick (the reference sends one per queue per tick).
        A message inside its failover backoff is skipped without blocking
        the queue behind it; a pinned message (``worker_id``) waits for its
        worker; the rest expire past their deadline, fail when no worker
        holds their files any more, or go to a free holder."""
        affinities = sorted(self.worker_out_messages,
                            key=lambda a: (a is None, str(a)))
        for offset in range(len(affinities)):
            affinity = affinities[
                (self._affinity_rr + offset) % len(affinities)]
            queue = self.worker_out_messages.get(affinity)
            if not queue:
                if affinity is not None:
                    self.worker_out_messages.pop(affinity, None)
                continue
            # messages queued while this one drains (a failed send's
            # requeue) land behind the kept ones
            self.worker_out_messages[affinity] = []
            kept = []
            for msg in queue:
                if self._place(msg, kept) is False:
                    kept.append(msg)
            self.worker_out_messages[affinity] = (
                kept + self.worker_out_messages.get(affinity, []))
        self._affinity_rr += 1

    def _place(self, msg, queue):
        """One queued message's fate this tick: False to keep it queued;
        anything else means it was sent, re-split into ``queue`` or
        dropped."""
        not_before = msg.get("_not_before")
        if not_before is not None and not_before > time.time():
            return False  # backing off
        if msg.get("payload") in DIRECT_VERBS:
            # an admin verb for one client: any free calc worker
            worker_id = self.find_free_worker()
            if worker_id is None:
                return False
            self._send_to_worker(worker_id, msg)
            return True
        pinned = msg.get("worker_id")
        if pinned is not None:
            # an append or a rollup build to one holder, while its fan-out
            # or its rollup entry waits
            if (msg["token"] not in self._append_waiters
                    and msg["token"] not in self._rollup_waiters):
                return None
            if self.worker_map.get(pinned, {}).get("busy", True):
                return False
            self._send_to_worker(pinned, msg)
            return True
        if not any(p in self.rpc_segments for p in self._work_parents(msg)):
            self._drop_work(msg.get("token"))
            return None  # every query waiting for it was aborted
        if msg.deadline_expired():
            # nobody waits any more: expire instead of dispatching
            self.counters["deadline_expired"] += 1
            self._abort_work(msg, "deadline exceeded before dispatch")
            return None
        filename = msg.get("filename")
        worker_id = self.find_free_worker(
            needs_local=msg.get("needs_local", False),
            filename=filename,
            exclude=frozenset(msg.get("_excluded_workers") or ()),
        )
        if worker_id is not None:
            self._send_to_worker(worker_id, msg)
            return True
        needed = [filename] if isinstance(filename, str) else filename
        missing = [f for f in needed if f not in self.files_map]
        if missing:
            # every holder is gone: no later tick can serve this
            self._abort_work(
                msg, f"file(s) no longer on any worker: {missing}",
            )
            return None
        if isinstance(filename, list) and not self._servable_by_one(
            filename
        ):
            # placement changed since batching: one message per shard,
            # carrying the batch's subscribers
            children = self._split_batch(msg)
            self._transfer_work(msg, children)
            queue.extend(children)
            return None
        return False  # its holders are busy

    def _servable_by_one(self, filenames):
        """True if any calc worker, busy or not, advertises every file."""
        common = set.intersection(
            *(self.files_map.get(f, set()) for f in filenames)
        )
        return any(
            self.worker_map.get(w, {}).get("workertype") == "calc"
            for w in common
        )

    def _split_batch(self, msg):
        """A batched shard-group CalcMessage as one message per shard
        (same parent, fresh tokens); the worker reads its tables from the
        positional filename."""
        args, kwargs = msg.get_args_kwargs()
        children = []
        for filename in msg["filename"]:
            child = CalcMessage(dict(msg))
            child.set_args_kwargs([filename] + list(args[1:]), kwargs)
            child["token"] = os.urandom(8).hex()
            child["filename"] = filename
            # each child is a dispatch attempt of its own: a fresh trace
            # hop and queue clock
            wire = child.get_trace()
            if wire:
                child.set_trace(dict(wire, span_id=os.urandom(8).hex()))
                child["_dispatch_queued_ts"] = time.time()
            children.append(child)
        return children

    # -- shared dispatch ---------------------------------------------------
    # Two concurrent admitted plans that need the same computation over the
    # same shard group share ONE dispatch: one read, one upload, one
    # kernel run, the payload fanned out to every subscriber
    # (counters["plan_shared_dispatches"]).
    def _register_work(self, msg, subscribers, work_key=None):
        token = msg.get("token")
        if not token:
            return
        self._work_subscribers[token] = list(subscribers)
        if work_key is not None:
            self._work_keys[token] = work_key
            self._work_index[work_key] = token

    def _drop_work(self, token):
        self._work_subscribers.pop(token, None)
        self._requeued_tokens.discard(token)
        key = self._work_keys.pop(token, None)
        if key is not None and self._work_index.get(key) == token:
            self._work_index.pop(key, None)

    def _work_parents(self, msg):
        """Every parent waiting for this work unit."""
        subs = self._work_subscribers.get(msg.get("token"))
        if subs:
            return list(subs)
        parent = msg.get("parent_token")
        return [parent] if parent else []

    def _transfer_work(self, msg, children):
        """Move a batch's subscribers onto its re-split children."""
        subs = self._work_subscribers.get(msg.get("token"))
        self._drop_work(msg.get("token"))
        if subs is None:
            return
        for child in children:
            self._register_work(child, subs)

    def _abort_work(self, msg, error_text, error_class=None, attempts=None):
        """Fail every parent subscribed to one work unit."""
        parents = self._work_parents(msg)
        self._drop_work(msg.get("token"))
        for parent in parents:
            self.abort_parent(parent, error_text, error_class=error_class,
                              attempts=attempts)

    def _dispatch_wire(self, worker_id, msg):
        """The send seam of the primary and the hedge dispatch: the
        ``controller.dispatch`` fault site (``drop``, ``duplicate``,
        ``delay``) and the ROUTER send.  False when the envelope was
        dropped by a fault; a gone peer's ``zmq.ZMQError`` propagates."""
        fault = chaos.fire(
            "controller.dispatch",
            worker=worker_id,
            verb=msg.get("payload"),
            token=msg.get("token"),
            filename=str(msg.get("filename")),
        ) if chaos.enabled() else None
        if fault is not None and fault.action == "drop":
            self.flight.record("chaos_dispatch_dropped", worker=worker_id,
                               token=msg.get("token"))
            return False
        frames = [worker_id.encode(), msg.to_json().encode()]
        self.socket.send_multipart(frames)
        if fault is not None and fault.action == "duplicate":
            self.socket.send_multipart(frames)
        return True

    def _send_to_worker(self, worker_id, msg):
        try:
            # a fault-dropped envelope "left" and never arrives: it is
            # tracked in flight, and the dispatch timeout recovers it
            self._dispatch_wire(worker_id, msg)
        except zmq.ZMQError as exc:
            self.logger.warning("send to worker %s failed: %s", worker_id, exc)
            self.remove_worker(worker_id)
            # a missing route (EHOSTUNREACH) is a fact of the controller's
            # routing, not evidence against the shard: re-queued without
            # charging the retry budget.  Any other send failure charges,
            # or a wedged worker that keeps re-registering would loop the
            # dispatch forever
            unroutable = getattr(exc, "errno", None) == zmq.EHOSTUNREACH
            self._requeue(
                {"msg": msg, "retries": msg.get("_retries", 0)},
                charge_retry=not unroutable,
                failed_worker=worker_id,
                reason=f"send failed: {exc}",
            )
            return
        if msg.isa("groupby"):
            self.counters["dispatched_shards"] += 1
            # the capacity model's per-worker dispatch rate and per-shard
            # heat map
            self.capacity.observe_dispatch(worker_id, msg.get("filename"))
        from bqueryd_tpu_torch import obs

        # every work envelope handed to a worker (hot path: under the
        # BQUERYD_TPU_METRICS kill switch)
        if obs.enabled():
            filename = msg.get("filename")
            self.flight.record(
                "dispatch",
                worker=worker_id,
                verb=msg.get("payload"),
                token=msg.get("token"),
                filename=(str(filename)[:200] if filename is not None
                          else None),
                trace_id=(msg.get_trace() or {}).get("trace_id"),
            )
        self._record_dispatch_span(msg, worker_id)
        info = self.worker_map.get(worker_id)
        if info is not None:
            info["busy"] = True
            # ROUTER_MANDATORY: the send would have raised on a gone peer
            info["last_seen"] = time.time()
        token = msg.get("token")
        if token:
            self._requeued_tokens.discard(token)
            self.inflight[token] = {
                "worker": worker_id, "sent_at": time.time(), "msg": msg,
                "parent": msg.get("parent_token"),
                "retries": msg.get("_retries", 0),
            }

    def _append_spans(self, msg, spans):
        """Add spans to the timeline of every query subscribed to the work
        unit ``msg``."""
        for parent in self._work_parents(msg):
            segment = self.rpc_segments.get(parent)
            if segment is not None and segment.get("obs"):
                segment["obs"]["spans"].extend(spans)

    def _record_dispatch_span(self, msg, worker_id, hedge=False):
        """One ``dispatch`` span per send: queue entry -> send, its span id
        the message's trace hop (the worker's calc span is its child), on
        the timeline of every query subscribed to the unit.  Its tags carry
        the attempt (worker, retries, the charged backoff that attribution
        carves out as ``retry_backoff``, the failover exclusions); a hedge
        is a zero-length marker tagged ``hedge``."""
        from bqueryd_tpu_torch import obs

        wire = msg.get_trace()
        queued_ts = msg.get("_dispatch_queued_ts")
        if not wire or queued_ts is None or not obs.enabled():
            return
        if hedge:
            # the original attempt's tags must not read as the hedge's
            tags = {"worker": worker_id, "hedge": True}
        else:
            tags = {
                "worker": worker_id,
                "filename": str(msg.get("filename")),
                "retries": msg.get("_retries", 0),
            }
            if msg.get("_backoff_s"):
                tags["backoff_s"] = msg.get("_backoff_s")
            if msg.get("_excluded_workers"):
                tags["excluded"] = list(msg.get("_excluded_workers"))
        now = time.time()
        self._append_spans(msg, [obs.make_span(
            wire["trace_id"], "dispatch",
            now if hedge else queued_ts,
            0.0 if hedge else max(now - float(queued_ts), 0.0),
            # a hedge duplicates the attempt's hop: its span gets an id of
            # its own
            span_id=None if hedge else wire["span_id"],
            parent_span_id=wire.get("parent_span_id"),
            node=self.address,
            tags=tags,
        )])

    def _record_inflight_span(self, msg, entry):
        """The send -> reply window of an attempt as a ``dispatch`` span
        tagged ``wait`` (the worker's spans carve its execution out at
        higher priority, so what is left is the wire and the loops' own
        time), and a hedged attempt's racing window tagged ``hedge``."""
        from bqueryd_tpu_torch import obs

        wire = msg.get_trace()
        sent_at = (entry or {}).get("sent_at")
        if not wire or sent_at is None or not obs.enabled():
            return
        now = time.time()
        spans = [obs.make_span(
            wire["trace_id"], "dispatch", sent_at,
            max(now - float(sent_at), 0.0),
            parent_span_id=wire.get("parent_span_id"),
            node=self.address,
            tags={"worker": entry.get("worker"),
                  "retries": entry.get("retries", 0), "wait": True},
        )]
        hedged_at = entry.get("hedged_at")
        if entry.get("hedged") and hedged_at is not None:
            spans.append(obs.make_span(
                wire["trace_id"], "dispatch", hedged_at,
                max(now - float(hedged_at), 0.0),
                parent_span_id=wire.get("parent_span_id"),
                node=self.address,
                tags={"worker": entry.get("hedged"), "hedge": True,
                      "wait": True},
            ))
        self._append_spans(msg, spans)

    # -- stale dispatches and hedging ----------------------------------------
    def retry_stale_dispatches(self):
        """Re-queue in-flight work older than ``dispatch_timeout`` whose
        worker stopped heartbeating, or older than
        ``dispatch_hard_timeout`` on a live one (which is then removed: a
        worker hung past the hard cap would sit busy and advertised
        forever).  A live worker inside the hard cap is left alone: a cold
        query (a kernel build, a first upload) may outlast
        ``dispatch_timeout``, and re-running it would double the work.  A
        hedge loser or an outdistanced attempt still computing an answered
        token is removed past the hard cap too."""
        now = time.time()
        for token, entry in list(self.inflight.items()):
            if token not in self.inflight:
                continue  # reclaimed by a remove_worker below
            age = now - entry["sent_at"]
            if age <= self.dispatch_timeout:
                continue
            winfo = self.worker_map.get(entry["worker"])
            worker_alive = (
                winfo is not None
                and now - winfo.get("last_seen", 0.0)
                <= self.dead_worker_timeout
            )
            if worker_alive and age <= self.dispatch_hard_timeout:
                continue
            self.logger.warning(
                "dispatch %s to %s timed out (age %.0fs, worker %s)",
                token, entry["worker"], age,
                "alive" if worker_alive else "dead",
            )
            # forensic event, never gated
            self.flight.record(
                "dispatch_timeout",
                token=token,
                worker=entry["worker"],
                age_s=round(age, 3),
                hard=age > self.dispatch_hard_timeout,
                worker_alive=worker_alive,
                filename=str(entry["msg"].get("filename"))[:200],
            )
            self.inflight.pop(token)
            if entry.get("hedged"):
                # the hedge duplicate still computes: collapse onto it
                # instead of a third dispatch
                self._collapse_hedge(token, entry, entry["worker"])
            else:
                self._requeue(
                    entry,
                    reason=f"dispatch timeout after {age:.0f}s "
                           f"(worker {'alive' if worker_alive else 'dead'})",
                )
            if worker_alive:
                self.logger.warning(
                    "worker %s hung past hard timeout, removing",
                    entry["worker"])
                self.remove_worker(entry["worker"])
        for token, rec in list(self._hedge_losers.items()):
            remaining = []
            for worker in rec["workers"]:
                if worker not in self.worker_map:
                    continue  # culled independently
                age = now - rec["since"]
                if age <= self.dispatch_hard_timeout:
                    remaining.append(worker)
                    continue
                self.logger.warning(
                    "hedge loser %s silent past hard timeout on %s, "
                    "removing", worker, token)
                self.flight.record("hedge_loser_timeout", token=token,
                                   worker=worker, age_s=round(age, 3))
                self.remove_worker(worker)
            if remaining:
                rec["workers"] = remaining
            else:
                self._hedge_losers.pop(token, None)

    def _mark_hedged(self, token, ts):
        """Put a token in the answered-token dedup ring, bounded to 256
        entries (a marker for a worker that dies before answering is never
        popped by a reply)."""
        self._hedged_tokens[token] = ts
        while len(self._hedged_tokens) > 256:
            self._hedged_tokens.pop(next(iter(self._hedged_tokens)))

    def _withdraw_queued(self, token):
        """Drop a queued, not yet dispatched message by token: a late reply
        of an earlier attempt answered it."""
        for affinity, queue in list(self.worker_out_messages.items()):
            kept = [m for m in queue if m.get("token") != token]
            if len(kept) != len(queue):
                self.worker_out_messages[affinity] = kept

    def _collapse_hedge(self, token, entry, failed_worker):
        """One side of a hedged pair is gone (a fault, a timeout, a cull):
        re-key the inflight entry onto the surviving side instead of
        re-queueing, exclude the failed side, and clear the token's dedup
        marker, so that the survivor's reply is THE reply."""
        hedged = entry.get("hedged")
        survivor = (hedged if failed_worker == entry.get("worker")
                    else entry["worker"])
        refiled = dict(entry, worker=survivor)
        refiled.pop("hedged", None)
        refiled.pop("hedged_at", None)
        if survivor == hedged:
            # the survivor's timeout clock starts at the hedge dispatch
            refiled["sent_at"] = entry.get("hedged_at", entry["sent_at"])
        excluded = list(entry["msg"].get("_excluded_workers") or [])
        if failed_worker and failed_worker not in excluded:
            excluded.append(failed_worker)
        entry["msg"]["_excluded_workers"] = excluded
        self._hedged_tokens.pop(token, None)
        self.inflight[token] = refiled
        self.flight.record("hedge_collapsed", token=token,
                           failed=failed_worker, survivor=survivor)
        return refiled

    def _note_losers(self, token, workers):
        """Keep hard-timeout reclaim handles on workers still computing an
        answered token (hedge losers, outdistanced attempts)."""
        workers = [w for w in workers if w]
        if workers:
            self._hedge_losers[token] = {"workers": workers,
                                         "since": time.time()}

    def _discard_loser(self, token, worker_id):
        """A tracked loser answered after all: stop holding its handle."""
        rec = self._hedge_losers.get(token)
        if rec is None:
            return
        rec["workers"] = [w for w in rec["workers"] if w != worker_id]
        if not rec["workers"]:
            self._hedge_losers.pop(token, None)

    def maybe_hedge(self):
        """Hedged dispatch of tail work (off unless ``hedge_ms`` > 0,
        ``BQUERYD_TPU_HEDGE_MS``): a groupby unit in flight past the
        threshold is sent again to a second free holder (not the original,
        not one it failed on).  The first reply wins; the other is counted
        in ``duplicate_replies`` and never merged."""
        if self.hedge_ms <= 0 or not self.inflight:
            return
        now = time.time()
        for token, entry in list(self.inflight.items()):
            if token not in self.inflight:
                # a remove_worker below re-queued it: its retry is parked,
                # and a dedup marker would discard the retry's reply
                continue
            if entry.get("hedged"):
                continue
            if (now - entry["sent_at"]) * 1000.0 < self.hedge_ms:
                continue
            msg = entry["msg"]
            if not msg.isa("groupby") or msg.get("worker_id"):
                # only the idempotent shard verb runs twice, and a pinned
                # message chose its worker
                continue
            exclude = {entry["worker"]} | set(
                msg.get("_excluded_workers") or ())
            target = self.find_free_worker(
                needs_local=msg.get("needs_local", False),
                filename=msg.get("filename"),
                exclude=exclude,
            )
            if target is None or target in exclude:
                continue  # no second holder free now
            try:
                if not self._dispatch_wire(target, msg):
                    continue  # dropped by a fault: a later tick may retry
            except zmq.ZMQError:
                # a gone peer: cull it, or every tick hedges onto it again
                self.remove_worker(target)
                continue
            entry["hedged"] = target
            entry["hedged_at"] = now
            self._mark_hedged(token, now)
            # the duplicate attempt on the timeline, beside the original
            self._record_dispatch_span(msg, target, hedge=True)
            if target in self.worker_map:
                self.worker_map[target]["busy"] = True
                self.worker_map[target]["last_seen"] = now
            self.counters["hedged_dispatches"] += 1
            self.flight.record(
                "hedged_dispatch", token=token, worker=target,
                original=entry["worker"],
                age_ms=round((now - entry["sent_at"]) * 1000.0, 1),
            )

    # -- inbound demux -----------------------------------------------------
    def handle_in(self, frames):
        self.msg_count_in += 1
        if len(frames) == 3 and frames[1] == b"":
            self.handle_rpc(frames[0], frames[2])
            return
        if len(frames) not in (2, 3):
            self.logger.warning("dropping %d-frame message", len(frames))
            return
        try:
            msg = msg_factory(frames[1])
        except messages.MalformedMessage:
            self.logger.warning("malformed worker message dropped")
            return
        if len(frames) == 3:
            msg["data"] = frames[2]
        elif msg.get("payload") == "peer_info":
            self.handle_peer(msg)
            return
        elif msg.get("_relayed") and msg.get("payload") in (
                "killall", "kill", "loglevel"):
            # a control verb a peer controller fanned out: run like an
            # RPC, with no client to answer
            getattr(self, f"rpc_{msg['payload']}")(msg)
            return
        self.handle_worker(frames[0], msg)

    # -- worker messages ---------------------------------------------------
    def handle_worker(self, sender, msg):
        worker_id = msg.get("worker_id") or sender.decode()
        now = time.time()
        if msg.isa(WorkerRegisterMessage):
            self._register(worker_id, msg, now)
            return
        info = self.worker_map.get(worker_id)
        if info is None:
            # a message from a culled worker: minimal liveness until its
            # next WRM re-registers it
            info = self.worker_map[worker_id] = {
                "worker_id": worker_id, "busy": False,
                "workertype": "unknown",
            }
        info["last_seen"] = now
        # any main-socket message proves the real route exists
        info.pop("hb_only", None)
        self._adoption_blocked.pop(worker_id, None)
        if msg.isa(BusyMessage):
            info["busy"] = True
        elif msg.isa(DoneMessage):
            info["busy"] = False
        elif msg.isa(StopMessage):
            self.remove_worker(worker_id)
        elif msg.isa(TicketDoneMessage):
            if not msg.get("error"):
                self._ticket_activated(msg.get("ticket"))
            self.release_ticket_waiters(msg.get("ticket"), msg.get("error"))
        elif msg.get("token"):
            info["busy"] = False
            self._absorb_reply(worker_id, msg)

    def _absorb_reply(self, worker_id, msg):
        """A worker's reply to a work unit, deduplicated by token: a
        hedge loser's reply, a late reply of an attempt that was re-queued
        and a fault-duplicated envelope are counted in
        ``duplicate_replies`` and never merged twice.  A late valid reply
        of an earlier attempt wins (holders compute identical payloads);
        a late error of one is dropped while a live attempt stands.  The
        ``controller.reply`` fault site (``drop``, ``duplicate``,
        ``delay``) fires here for shard replies."""
        token = msg["token"]
        fault = chaos.fire(
            "controller.reply",
            worker=worker_id,
            token=token,
            verb=msg.get("payload"),
            parent=msg.get("parent_token"),
        ) if chaos.enabled() and msg.get("parent_token") else None
        if fault is not None and fault.action == "drop":
            self.flight.record("chaos_reply_dropped", token=token,
                               worker=worker_id)
            return
        entry = self.inflight.pop(token, None)
        if entry is None and token in self._hedged_tokens:
            # the token was answered: first reply won, this one is counted
            # and dropped
            self._hedged_tokens.pop(token, None)
            self._discard_loser(token, worker_id)
            self.counters["duplicate_replies"] += 1
            return
        if entry is None and token in self._requeued_tokens:
            # the unit's retry waits in its queue and a late reply of the
            # failed attempt landed first
            if msg.isa(ErrorMessage):
                # a stale fault: the queued retry stands
                self.counters["duplicate_replies"] += 1
                self.flight.record("stale_reply_dropped", token=token,
                                   worker=worker_id,
                                   error=str(msg.get("payload"))[:200])
                return
            # a late valid result wins: withdraw the queued retry, and
            # mark the token so that another superseded attempt's later
            # reply is counted and dropped
            self._requeued_tokens.discard(token)
            self._withdraw_queued(token)
            self._mark_hedged(token, time.time())
        if entry is not None:
            assigned, hedged = entry.get("worker"), entry.get("hedged")
            outstanding = [w for w in (assigned, hedged)
                           if w is not None and w != worker_id]
            if worker_id not in (assigned, hedged):
                # a late reply of an earlier attempt, while the current
                # one computes on `outstanding`
                if msg.isa(ErrorMessage):
                    # a stale fault: the live attempt stands
                    self.inflight[token] = entry
                    self.counters["duplicate_replies"] += 1
                    self.flight.record("stale_reply_dropped", token=token,
                                       worker=worker_id,
                                       error=str(msg.get("payload"))[:200])
                    return
                # a late valid result wins; the live attempt's reply will
                # be deduplicated, and its workers keep reclaim handles
                self._mark_hedged(token, time.time())
                self._note_losers(token, outstanding)
            elif hedged and msg.isa(ErrorMessage):
                # one side of a hedged pair failed while the other still
                # computes: collapse onto the survivor, whose answer
                # decides (no re-queue, no retry charge, no abort)
                refiled = self._collapse_hedge(token, entry, worker_id)
                transient = bool(msg.get("transient"))
                if transient:
                    self.counters["transient_faults"] += 1
                self.flight.record(
                    "transient_fault" if transient else "hedge_side_error",
                    token=token, worker=worker_id,
                    survivor=refiled["worker"],
                    error=str(msg.get("payload"))[:200],
                )
                return
            elif hedged:
                self._mark_hedged(token, time.time())  # the loser is due
                if worker_id == hedged:
                    self.counters["hedge_wins"] += 1
                    self.flight.record("hedge_win", token=token,
                                       winner=worker_id, loser=assigned)
                else:
                    self.flight.record("hedge_loss", token=token,
                                       winner=worker_id, loser=hedged)
                self._note_losers(token, outstanding)
        else:
            if token in self._hedge_losers:
                # its ring marker was evicted, but the loser record proves
                # the token was answered: counted and dropped
                self._discard_loser(token, worker_id)
                self.counters["duplicate_replies"] += 1
                self.flight.record(
                    "stale_reply_dropped", token=token, worker=worker_id,
                    error=(str(msg.get("payload"))[:200]
                           if msg.isa(ErrorMessage) else None),
                )
                return
        self.process_worker_result(msg, entry)
        if fault is not None and fault.action == "duplicate":
            # the replay is a duplicate by definition: an open segment
            # counts it where its key is found again, so it is counted
            # here only when no open segment will
            parent = msg.get("parent_token")
            subs = self._work_subscribers.get(token) or (
                (parent,) if parent is not None else ())
            if not any(p in self.rpc_segments for p in subs):
                self.counters["duplicate_replies"] += 1
            self.process_worker_result(msg, None)

    def _register(self, worker_id, msg, now):
        if msg.get("liveness_only"):
            # a WRM from the worker's heartbeat thread: refresh a known
            # worker (its file list may lag the loop's rescan); adopt an
            # unknown one (a controller restart while the worker's loop is
            # deep in a long query) as busy and heartbeat-only, since the
            # ROUTER may only have a route to its ".hb" socket yet
            known = self.worker_map.get(worker_id)
            if known is not None:
                known["last_seen"] = now
                known["backend_wedged"] = bool(msg.get("backend_wedged"))
                self._absorb_worker_metrics(worker_id, msg)
                # the worker's stats advertisement rides either socket
                self._absorb_shard_stats(msg)
            elif self._adoption_blocked.get(worker_id, 0) <= now:
                info = dict(msg, last_seen=now, busy=True, hb_only=now)
                self.worker_map[worker_id] = info
                for filename in _served_files(info):
                    self.files_map.setdefault(filename, set()).add(worker_id)
                self._absorb_worker_metrics(worker_id, info)
                self._absorb_shard_stats(info)
            return
        prev = self.worker_map.get(worker_id, {})
        self._adoption_blocked.pop(worker_id, None)
        info = dict(msg)
        info["last_seen"] = now
        # an hb-only adoption's busy=True was a placeholder
        info["busy"] = False if prev.get("hb_only") else prev.get("busy", False)
        self.worker_map[worker_id] = info
        current = set(_served_files(info))
        for filename in current:
            self.files_map.setdefault(filename, set()).add(worker_id)
        for filename in list(self.files_map):
            if filename not in current:
                self.files_map[filename].discard(worker_id)
                if not self.files_map[filename]:
                    del self.files_map[filename]
                    self.shard_stats.pop(filename, None)
        self._absorb_worker_metrics(worker_id, info)
        self._absorb_shard_stats(info)

    def _absorb_worker_metrics(self, worker_id, info):
        """The health signals a WRM carries (the histogram snapshot, the
        error counter, the device-health latch) into the health scorer,
        the latch's flips into the flight ring (``worker_wedged``,
        ``worker_unwedged``), and the worker's debug slice (see
        :meth:`_absorb_worker_debug`).  The snapshot is popped from
        ``info``, so that ``worker_map`` stays lean."""
        snap = info.pop("metrics", None)
        wedged = bool(info.get("backend_wedged"))
        # the capacity model's service rate from the histogram deltas and
        # its bottleneck stage from the stage clocks, of calc workers only,
        # every heartbeat (its deltas need each cumulative total)
        pipeline_busy = info.pop("pipeline_busy", None)
        if info.get("workertype") == "calc" and isinstance(snap, dict):
            self.capacity.absorb_worker(
                worker_id, snap, pipeline_busy=pipeline_busy,
                wedged=wedged, pid=info.get("pid"),
            )
        if isinstance(snap, dict) and snap != self._worker_metrics.get(
                worker_id):
            self._worker_metrics[worker_id] = snap
            self._worker_metrics_rev += 1
        prev = self._worker_wedged.get(worker_id)
        self._worker_wedged[worker_id] = wedged
        if wedged and not prev:
            # forensic event, never gated
            self.flight.record("worker_wedged", worker=worker_id)
            self.logger.warning(
                "worker %s advertises a wedged device", worker_id)
        elif prev and not wedged:
            self.flight.record("worker_unwedged", worker=worker_id)
            self.logger.info("worker %s device recovered", worker_id)
        # every heartbeat is a sample, even with unchanged totals: a
        # silent window is a signal too
        self.health.observe(
            worker_id,
            snapshot=self._worker_metrics.get(worker_id),
            wedged=wedged,
            errors=info.get("work_errors"),
            pid=info.get("pid"),
        )
        self._absorb_worker_debug(worker_id, info)

    def _absorb_worker_debug(self, worker_id, info):
        """Keep the worker's debug-bundle slice (flight tail, device
        health) that rides its WRM; popped from ``info``, so that
        ``worker_map`` and ``rpc.info()`` stay lean.  Past the cap, removed
        workers' slices go first."""
        debug = info.pop("debug", None)
        if not isinstance(debug, dict):
            return
        self._worker_debug[worker_id] = {"data": debug, "ts": time.time()}
        while len(self._worker_debug) > self._worker_debug_cap:
            victim = min(
                self._worker_debug,
                key=lambda w: (w in self.worker_map,
                               self._worker_debug[w]["ts"]),
            )
            self._worker_debug.pop(victim, None)

    def _absorb_shard_stats(self, info):
        """Keep the freshest advertised stats per shard, and the worker's
        calibration summary.  Each entry is shape-checked: a malformed
        advertisement (a version-skewed or faulty worker) poisons at most
        its own shard's entry, never a query; a worker's summary replaces
        its previous one (``CalibrationStore.absorb(source=)``), so that a
        cumulative summary is never counted twice."""
        stats = info.get("shard_stats")
        if isinstance(stats, dict):
            for fname, entry in stats.items():
                if (isinstance(fname, str) and isinstance(entry, dict)
                        and isinstance(entry.get("cols", {}), dict)):
                    self.shard_stats[fname] = entry
        calibration = info.get("calibration")
        if isinstance(calibration, dict):
            try:
                self.calibration.absorb(
                    calibration,
                    source=info.get("worker_id") or "unidentified-worker",
                )
            except Exception:
                self.logger.debug("calibration absorb failed", exc_info=True)

    def process_worker_result(self, msg, entry=None):
        """A reply into the sink.  ``entry`` is the attempt's inflight
        entry (None for a replay or an attempt already re-queued): a
        ``transient`` error with one fails the unit over to another holder
        (:meth:`_requeue`; a bundle fails over whole, under its one
        token), without one it is a duplicate.  A payload whose shard
        group already has one in its segment is counted in
        ``duplicate_replies`` and overwrites its own identical copy."""
        token = msg.get("token")
        if token in self._append_waiters:
            self._absorb_append_reply(token, msg)
            return
        if isinstance(token, str) and token.startswith("append_"):
            # its fan-out already failed fast or timed out: the client
            # was answered
            return
        if token in self._rollup_waiters:
            # a controller-originated rollup build or refresh: absorbed by
            # the serving layer, never forwarded to a client
            self._absorb_rollup_reply(token, msg)
            return
        if isinstance(token, str) and token.startswith("rollup_"):
            # its entry was evicted or abandoned while the build ran
            # (matched by prefix: an ErrorMessage's payload is a traceback)
            self.flight.record("rollup_reply_orphaned", token=token)
            return
        if entry is not None and not (msg.isa(ErrorMessage)
                                      and msg.get("transient")):
            # a transient fault's failover records its own (failed) span
            self._record_inflight_span(msg, entry)
        if msg.isa(ErrorMessage) and msg.get("transient"):
            # a retryable fault: fail over instead of killing the query;
            # _requeue excludes the faulted worker and aborts with the
            # structured envelope only once the budget is spent
            reason = str(msg.get("payload") or "transient fault")
            reason = (reason.strip().splitlines() or ["transient fault"])[-1]
            if entry is not None:
                self.counters["transient_faults"] += 1
                self.flight.record("transient_fault", token=token,
                                   worker=entry.get("worker"),
                                   error=reason[:200])
                self._requeue(entry, failed_worker=entry.get("worker"),
                              reason=reason)
            else:
                # already re-queued or answered, or a replay: a duplicate
                # of a fault, not a new one
                self.counters["duplicate_replies"] += 1
            return
        subscribers = self._work_subscribers.get(token)
        if msg.get("parent_token") is None and not subscribers:
            # a verb answered for one client (sleep, readfile,
            # execute_code): a data frame is folded into the reply
            data = msg.pop("data", None)
            if data is not None:
                msg.add_as_binary("result", data)
            self.reply_rpc_message(token, msg)
            return
        self._drop_work(token)
        parents = (list(subscribers) if subscribers
                   else [msg.get("parent_token")])
        if msg.isa(ErrorMessage):
            for parent in parents:
                self.abort_parent(parent, msg.get("payload"))
            return
        if msg.get("_bundle_parents"):
            if msg.get("bundle_members") is not None:
                # one envelope with a payload per member
                self._demux_bundle(msg)
            else:
                # a worker that does not know bundles ran member 0's
                # positional params: handing that payload to every member
                # would be a wrong answer, so every member fails
                for parent in dict.fromkeys(msg["_bundle_parents"].values()):
                    self.abort_parent(
                        parent,
                        "bundle dispatched to a worker that does not "
                        "understand shared-scan bundles; keep "
                        "BQUERYD_TPU_BATCH_WINDOW_MS=0 until every calc "
                        "worker answers them",
                    )
            return
        filename = msg.get("filename")
        # a batched group's reply covers all its files with one merged
        # payload: completion counts covered files, not replies
        key = tuple(filename) if isinstance(filename, list) else (filename,)
        data = msg.get("data") or b""
        # once per reply, not per subscriber
        self.counters["reply_payload_bytes"] += len(data)
        spans = [s for s in msg.get("spans") or () if isinstance(s, dict)]
        delivered = counted = False
        for parent in parents:
            segment = self.rpc_segments.get(parent)
            if segment is None:
                continue  # that subscriber aborted earlier
            delivered = True
            counted = self._count_duplicate(segment, key, counted)
            self._record_result(segment, key, msg, data,
                                msg.get("phase_timings"))
            # the worker's spans join every subscriber's timeline
            if spans and segment.get("obs"):
                segment["obs"]["spans"].extend(spans)
            self._maybe_complete_segment(parent)
        if not delivered:
            self.logger.debug("orphaned result for token %s dropped", token)

    def _count_duplicate(self, segment, key, counted):
        """Count a payload whose shard group the segment already holds (a
        late retry, a hedge loser, a duplicated envelope): once per reply,
        not per subscriber.  Returns whether this reply is counted."""
        if key in segment["results"] and not counted:
            self.counters["duplicate_replies"] += 1
            return True
        return counted

    @staticmethod
    def _record_result(segment, key, msg, data, timings):
        """One shard group's payload, timings, route and merge mode into a
        segment."""
        segment["results"][key] = data
        segment["timings"][key] = timings
        effective = msg.get("effective_strategy")
        if isinstance(effective, str):
            segment["effective"][key] = effective
        merge_mode = msg.get("merge_mode")
        if isinstance(merge_mode, str):
            segment.setdefault("merge", {})[key] = merge_mode

    def _demux_bundle(self, msg):
        """A shared-scan bundle reply, per member: its data frame is one
        pickled ``{"payloads": {member_id: bytes}, "errors": {member_id:
        text}}`` envelope.  A member's error aborts that member's query
        alone; members whose query aborted earlier (supersede, deadline)
        are skipped; the rest complete.  The shared phase timings are
        scaled by each member's share (``member_shares``)."""
        bundle_parents = msg.get("_bundle_parents") or {}
        data = msg.get("data") or b""
        try:
            envelope = pickle.loads(data) if data else {}
        except Exception:
            for parent in dict.fromkeys(bundle_parents.values()):
                self.abort_parent(parent, "undecodable bundle reply")
            return
        member_payloads = envelope.get("payloads") or {}
        member_errors = envelope.get("errors") or {}
        member_shares = msg.get("member_shares")
        if not isinstance(member_shares, dict):
            member_shares = {}
        from bqueryd_tpu_torch import obs

        filename = msg.get("filename")
        key = tuple(filename) if isinstance(filename, list) else (filename,)
        spans = [s for s in msg.get("spans") or () if isinstance(s, dict)]
        counted = False
        for member_id, parent in bundle_parents.items():
            # this member's own demux clock: an earlier member's completion
            # (its merge and reply run in _maybe_complete_segment) must not
            # land in this member's demux span
            member_start_ts = time.time()
            member_clock = time.perf_counter()
            segment = self.rpc_segments.get(parent)
            if segment is None:
                continue  # that member aborted earlier
            error = member_errors.get(member_id)
            if error is not None:
                self.abort_parent(parent, error)
                continue
            buf = member_payloads.get(member_id)
            if buf is None:
                self.abort_parent(
                    parent, "bundle reply missing this member's payload")
                continue
            counted = self._count_duplicate(segment, key, counted)
            timings = msg.get("phase_timings")
            share = member_shares.get(member_id)
            try:
                share = float(share) if share is not None else None
            except (TypeError, ValueError):
                share = None
            if share is not None and isinstance(timings, dict):
                timings = {k: round(v * share, 6) for k, v in timings.items()
                           if isinstance(v, (int, float))}
                # underscore-named like _total: never a phase name
                timings["_member_share"] = round(share, 6)
            self._record_result(segment, key, msg, buf, timings)
            obs_state = segment.get("obs")
            if spans and obs_state:
                # true-wall copies tagged with the member's share, which
                # the autopsy reports beside them
                obs_state["spans"].extend(
                    dict(s, tags={**(s.get("tags") or {}),
                                  "bundle_share": round(share, 6)})
                    if share is not None else s
                    for s in spans
                )
                obs_state["spans"].append(obs.make_span(
                    obs_state["trace_id"], "demux", member_start_ts,
                    time.perf_counter() - member_clock,
                    parent_span_id=obs_state["qspan_id"],
                    node=self.address,
                ))
            self._maybe_complete_segment(parent)

    def _maybe_complete_segment(self, parent):
        """Reply to the client once every requested shard is covered (by a
        worker payload, a batched group payload or a plan-time prune)."""
        segment = self.rpc_segments.get(parent)
        if segment is None:
            return
        reply_started = time.time()
        # greedy disjoint cover, largest keys first: a re-split batch may
        # leave both a late group payload and its per-shard payloads, and
        # no shard may merge twice
        chosen, covered = [], set()
        for k in sorted(segment["results"], key=len, reverse=True):
            if covered.isdisjoint(k):
                chosen.append(k)
                covered.update(k)
        if not covered.issuperset(segment["filenames"]):
            return
        self.rpc_segments.pop(parent)
        # payloads in requested-filename order, not arrival order: raw
        # rows concatenate client-side in that order
        covering = {f: k for k in chosen for f in k}
        payloads = [
            segment["results"][k]
            for k in dict.fromkeys(covering[f] for f in segment["filenames"])
        ]
        compact = self._compact_timings
        # the answer's provenance: every shard group from a worker's result
        # cache -> "cached"; any delta-refreshed group -> "delta"; else a
        # recompute.  Served answers (_reply_served) say "rollup"/"subsume"
        routes = set(segment["effective"].values())
        if routes and routes <= {"cached"}:
            answer_source = "cached"
        elif "delta" in routes:
            answer_source = "delta"
        else:
            answer_source = "recompute"
        self._count_answer(answer_source)
        reply = pickle.dumps(
            {
                "ok": True,
                "payloads": payloads,
                "timings": compact(segment["timings"]),
                "answer_source": answer_source,
                "subsumed_from": None,
                "strategies": {
                    "hints": dict(segment["strategies"]),
                    "effective": compact(segment["effective"]),
                },
                "merge_modes": compact(segment.get("merge", {})),
            },
            protocol=messages.PICKLE_PROTOCOL,
        )
        self._finish_segment(segment, reply, parent=parent,
                             reply_started=reply_started)

    def _finish_segment(self, segment, reply_bytes=None, parent=None,
                        error=None, reply_started=None):
        """A query's last act: its reply (none for a retired run, whose
        client moved on), then its accounting
        (:meth:`_finalize_query_obs`; a verb a client sends after the
        reply is served after it, on this loop), and the release of its
        admission ticket, which may launch a queued plan.  The answer's
        assembly from ``reply_started`` through its send is the query's
        ``reply_serialization`` span at the controller."""
        if reply_bytes is not None:
            self.reply_rpc_raw(segment["client_token"], reply_bytes)
        obs_state = segment.get("obs")
        if reply_started is not None and obs_state:
            from bqueryd_tpu_torch import obs

            if obs.enabled():
                obs_state["spans"].append(obs.make_span(
                    obs_state["trace_id"], "reply_serialization",
                    reply_started, max(time.time() - reply_started, 0.0),
                    parent_span_id=obs_state["qspan_id"],
                    node=self.address,
                ))
        self._finalize_query_obs(parent, segment, error=error)
        ticket = segment.get("admission_ticket")
        if ticket is not None:
            self.admission.release(ticket)
            self._ticket_sigs.pop(ticket, None)
            self._admit_ready()

    @staticmethod
    def _compact_timings(timings):
        """Tuple-keyed per-group values -> JSON-safe keys: a group is
        labelled by its first file and the count of the others."""
        return {
            (k[0] if len(k) == 1 else f"{k[0]}+{len(k) - 1}more"): v
            for k, v in (timings or {}).items()
        }

    # -- query accounting ----------------------------------------------------
    @staticmethod
    def _new_obs_state(ctx):
        """A query's trace state: the client's context, the id of the
        controller's ``groupby`` span every query span is a child of, the
        spans its timeline is assembled from, and the submit time the
        admission span starts at."""
        from bqueryd_tpu_torch import obs

        return {
            "trace_id": ctx.trace_id,
            "root_span_id": ctx.span_id,
            "qspan_id": obs.new_id(),
            "spans": [],
            "submitted_ts": time.time(),
            # the monotonic twin, for the wall of an answer served before
            # any segment opens
            "submitted_clock": time.perf_counter(),
        }

    def _adopt_trace(self, msg):
        """The query's trace state from the client's context (one minted
        for a client that sent none), kept on ``msg``."""
        from bqueryd_tpu_torch import obs

        ctx = obs.TraceContext.from_wire(msg.get_trace())
        if ctx is None:
            ctx = obs.TraceContext.new_root()
        obs_state = self._new_obs_state(ctx)
        msg["_obs"] = obs_state
        return obs_state

    def _plan_span(self, obs_state, start_ts, clock):
        """The ``plan`` span: the plan's compile, from ``start_ts``."""
        from bqueryd_tpu_torch import obs

        if obs.enabled():
            obs_state["spans"].append(obs.make_span(
                obs_state["trace_id"], "plan", start_ts,
                time.perf_counter() - clock,
                parent_span_id=obs_state["qspan_id"], node=self.address,
            ))

    def _observe_admission_wait(self, wait_s):
        """Admission's wait hook: the queued time before launch, also the
        capacity model's measured wait (under its own switch)."""
        from bqueryd_tpu_torch import obs

        if obs.enabled():
            self.admission_wait_seconds.observe(wait_s)
        self.capacity.observe_queue_wait(wait_s, source="admission")

    def _observe_arrival(self, decision, payload):
        """Admission's arrival tap: every offered query (ADMIT, QUEUED
        and BUSY alike) in the capacity model's per-class arrival rate."""
        del decision  # offered load counts every outcome alike
        msg = payload[0] if payload else None
        slo_class = (self.slo.resolve(msg.get("slo_class"))
                     if msg is not None else "default")
        self.capacity.observe_arrival(slo_class)

    def _record_capacity_advice(self, rec):
        """The shadow advisor's sink: each new recommendation is a flight
        event and a counter; nothing acts on it."""
        action = rec.get("action")
        counter_key = f"capacity_{action}_advised"
        if counter_key in self.counters:
            self.counters[counter_key] += 1
        self.flight.record(
            "capacity_advice",
            action=action,
            n=rec.get("n"),
            shard=rec.get("shard"),
            to_worker=rec.get("to_worker"),
            reason=str(rec.get("reason"))[:200],
        )

    def _timeline_snapshot(self):
        """One ``rpc.timeline()`` entry: counters, queue and in-flight
        depths, fleet size, groupby latency quantiles, the SLO classes'
        state and the capacity slice."""
        from bqueryd_tpu_torch import obs

        snap = self.query_seconds.snapshot()
        admission = self.admission.stats()
        return {
            "counters": dict(self.counters),
            "inflight": len(self.inflight),
            "workers": len(self.worker_map),
            "admission_active": admission["active"],
            "admission_queued": admission["queued"],
            "groupby_count": sum(snap.get("counts", ())),
            "groupby_p50_s": obs.quantile_from_snapshot(snap, 0.5),
            "groupby_p99_s": obs.quantile_from_snapshot(snap, 0.99),
            "slo": self.slo.snapshot(),
            "capacity": self._capacity_timeline_fields(),
        }

    def _capacity_timeline_fields(self):
        """The compact capacity slice of each timeline entry."""
        fleet = self.capacity.snapshot().get("fleet") or {}
        return {
            key: fleet.get(key)
            for key in ("utilization", "state", "arrival_qps", "knee_qps",
                        "headroom_qps", "model_drift")
        }

    def _finalize_query_obs(self, parent, segment, error=None):
        """Every finished query (answered, aborted or retired) lands here
        once (:meth:`_account_query`), on the loop's clock as its
        ``finalize`` part."""
        if (self.loop_clock.part is None
                or threading.current_thread() is not self._loop_thread):
            self._account_query(parent, segment, error)
            return
        left = self._loop_enter("finalize")
        try:
            self._account_query(parent, segment, error)
        finally:
            self._loop_enter(left)

    def _account_query(self, parent, segment, error):
        """A finished query's ``queries_completed`` counter, and while the
        hot path is on the ``query_seconds`` observation, its SLO class's
        record, its timeline with its attribution in ``trace_store``, the
        capacity model's measured wait and, past the threshold, the
        slow-query ring."""
        from bqueryd_tpu_torch import obs

        wall = time.perf_counter() - segment.get(
            "created_clock", time.perf_counter())
        self.counters["queries_completed"] += 1
        obs_state = segment.get("obs")
        trace_id = (obs_state or {}).get("trace_id")
        if error is not None:
            # forensic event, never gated
            self.flight.record("query_failed", parent=parent,
                               trace_id=trace_id, wall_s=round(wall, 6),
                               error=str(error)[:300])
        if not obs.enabled():
            return
        if error is None:
            self.flight.record("query_done", parent=parent,
                               trace_id=trace_id, wall_s=round(wall, 6),
                               shards=len(segment.get("filenames", ())))
        self.query_seconds.observe(wall)
        # an absolute client deadline wins over the class target
        msg = segment.get("msg") or {}
        deadline = msg.get("deadline")
        margin_s = (float(deadline) - time.time()
                    if deadline is not None else None)
        self.slo.record(msg.get("slo_class"), wall, margin_s=margin_s,
                        ok=error is None)
        if not obs_state:
            return
        # the root span opens at submit, so that its admission child never
        # starts before it, and closes now
        submitted = obs_state.get("submitted_ts", segment["created"])
        spans = [obs.make_span(
            trace_id, "groupby", submitted,
            wall + max(segment["created"] - submitted, 0.0),
            span_id=obs_state["qspan_id"],
            parent_span_id=obs_state["root_span_id"],
            node=self.address,
            tags={"parent_token": parent},
        )]
        # a shared unit's worker spans carry the trace of the query that
        # created it: retagged, so that each timeline is self-consistent
        spans.extend(dict(span, trace_id=trace_id)
                     for span in obs_state["spans"])
        spans.sort(key=lambda s: s.get("start_ts", 0.0))
        timeline = {
            "trace_id": trace_id,
            "ok": error is None,
            "wall_s": round(wall, 6),
            "created_ts": segment["created"],
            "filenames": list(segment["filenames"]),
            "pruned": list(segment.get("pruned", ())),
            "spans": spans,
        }
        if segment.get("answer_source") is not None:
            timeline["answer_source"] = segment["answer_source"]
        if error is not None:
            timeline["error"] = str(error)[:500]
        # the attribution rides the stored timeline; a malformed span set
        # never breaks a query's completion
        try:
            timeline["attribution"] = obs.slo.attribute(timeline)
        except Exception:
            self.logger.exception("attribution failed for %s", trace_id)
        # the measured pre-worker wait (admission and dispatch segments)
        # against the capacity model's prediction
        attribution = timeline.get("attribution")
        if isinstance(attribution, dict) and error is None:
            segments = attribution.get("segments") or {}
            self.capacity.observe_queue_wait(
                segments.get("admission_wait", 0.0)
                + segments.get("dispatch", 0.0),
                source="autopsy",
            )
        self.trace_store.put(trace_id, timeline)
        recorded = self.slow_queries.maybe_record(wall, {
            "trace_id": trace_id,
            "ok": error is None,
            **({"error": str(error)[:200]} if error is not None else {}),
            "filenames": len(segment["filenames"]),
            "pruned_shards": len(segment.get("pruned", ())),
            "plan_signature": segment.get("plan_sig"),
            "slo_class": self.slo.resolve(msg.get("slo_class")),
            "strategy_hints": dict(segment.get("strategies", {})),
            "effective_strategies": self._compact_timings(
                segment.get("effective")),
            "phase_timings": self._compact_timings(segment.get("timings")),
            # the compact critical path (the full record: rpc.autopsy)
            "attribution": obs.slo.summarize(timeline.get("attribution")),
        })
        if recorded:
            self.counters["slow_queries"] += 1

    def abort_parent(self, parent, error_text, reply=True, error_class=None,
                     attempts=None):
        """Fail a query: detach it from its work units (a unit left with
        no subscriber dies, a shared one keeps computing for the others,
        its retries included), drop its queued work, release its ticket
        and, unless ``reply`` is false, send the client the error envelope
        with ``error_class`` and the failed ``attempts``."""
        segment = self.rpc_segments.pop(parent, None)
        if segment is None:
            return
        dead = set()
        for token, subs in list(self._work_subscribers.items()):
            if parent in subs:
                subs[:] = [p for p in subs if p != parent]
                if not subs:
                    dead.add(token)
                    self._drop_work(token)
        for token in dead:
            self.inflight.pop(token, None)
        for queue in self.worker_out_messages.values():
            queue[:] = [
                m for m in queue
                if m.get("token") not in dead
                and not (m.get("parent_token") == parent
                         and m.get("token") not in self._work_subscribers)
            ]
        self._finish_segment(
            segment,
            pickle.dumps(
                {"ok": False, "error": str(error_text),
                 "error_class": error_class,
                 "attempts": list(attempts or [])},
                protocol=messages.PICKLE_PROTOCOL,
            ) if reply else None,
            parent=parent,
            error=error_text,
        )

    def reply_rpc_raw(self, client_token, payload_bytes):
        client = binascii.unhexlify(client_token)
        try:
            self.socket.send_multipart([client, b"", payload_bytes])
        except zmq.ZMQError:
            self.logger.exception("could not reply to client %r", client_token)

    def reply_rpc_message(self, client_token, msg):
        if client_token is None:
            return  # a relayed verb: nobody to answer
        msg.pop("data", None)
        self.reply_rpc_raw(client_token, msg.to_json().encode())

    # -- RPC dispatch ------------------------------------------------------
    def handle_rpc(self, client, payload):
        token = binascii.hexlify(client).decode()
        try:
            msg = msg_factory(payload)
        except messages.MalformedMessage:
            self.reply_rpc_raw(token, b'{"payload": "malformed request"}')
            return
        msg["token"] = token
        verb = msg.get("payload")
        if verb not in CONTROLLER_VERBS:
            err = ErrorMessage(msg)
            err["payload"] = f"Sorry, unknown verb {verb!r}"
            self.reply_rpc_message(token, err)
            return
        try:
            getattr(self, f"rpc_{verb}")(msg)
        except Exception as exc:
            self.logger.exception("rpc %s failed", verb)
            err = ErrorMessage(msg)
            err["payload"] = f"{type(exc).__name__}: {exc}"
            self.reply_rpc_message(token, err)

    def rpc_ping(self, msg):
        reply = msg.copy()
        reply["payload"] = "pong"
        self.reply_rpc_message(msg["token"], reply)

    def rpc_info(self, msg):
        reply = msg.copy()
        reply.add_as_binary("result", self.get_info())
        self.reply_rpc_message(msg["token"], reply)

    def rpc_metrics(self, msg):
        """The Prometheus text of this controller's registry."""
        reply = msg.copy()
        reply.add_as_binary("result", self.metrics.render())
        self.reply_rpc_message(msg["token"], reply)

    def rpc_trace(self, msg):
        """The assembled timeline of one trace id (None once it left the
        ring): ``rpc.trace(rpc.last_trace_id)``."""
        args, _ = msg.get_args_kwargs()
        reply = msg.copy()
        reply.add_as_binary("result",
                            self.trace_store.get(args[0] if args else None))
        self.reply_rpc_message(msg["token"], reply)

    def rpc_slow_queries(self, msg):
        """The slow-query ring (``BQUERYD_TPU_SLOW_QUERY_MS``), newest
        last."""
        reply = msg.copy()
        reply.add_as_binary("result", self.slow_queries.entries())
        self.reply_rpc_message(msg["token"], reply)

    def rpc_autopsy(self, msg):
        """``rpc.autopsy(trace_id=None)``: the attributed critical path of
        one query (or of the newest), with its slow-query entry when it
        has one; None once its timeline left the ring."""
        args, kwargs = msg.get_args_kwargs()
        trace_id = args[0] if args else kwargs.get("trace_id")
        reply = msg.copy()
        reply.add_as_binary("result", self.build_autopsy(trace_id))
        self.reply_rpc_message(msg["token"], reply)

    def build_autopsy(self, trace_id=None):
        from bqueryd_tpu_torch import obs

        timeline = (self.trace_store.get(trace_id) if trace_id
                    else self.trace_store.latest())
        if timeline is None:
            return None
        record = timeline.get("attribution")
        if not isinstance(record, dict):
            # its attribution failed when it was stored: attribute now
            record = obs.slo.attribute(timeline)
        record = dict(record)
        slow = self.slow_queries.entry_for(record.get("trace_id"))
        if slow is not None:
            record["slow_query"] = slow
        return record

    def rpc_timeline(self, msg):
        """``rpc.timeline()``: the controller's snapshot ring, oldest
        first (one entry per ``BQUERYD_TPU_TIMELINE_INTERVAL_S``)."""
        reply = msg.copy()
        reply.add_as_binary("result", self.timeline_ring.entries())
        self.reply_rpc_message(msg["token"], reply)

    def rpc_capacity(self, msg):
        """``rpc.capacity()``: the fleet capacity model, evaluated now."""
        reply = msg.copy()
        reply.add_as_binary("result", self._capacity_bundle_section())
        self.reply_rpc_message(msg["token"], reply)

    def _capacity_bundle_section(self):
        """A fresh evaluation of the capacity model and its snapshot."""
        self.capacity.evaluate()
        return self.capacity.snapshot()

    def rpc_health(self, msg):
        """``rpc.health()``: each worker's health status (ok, degraded,
        wedged) from the rolling baselines, the view dispatch acts on."""
        from bqueryd_tpu_torch.obs import health as health_mod

        reply = msg.copy()
        reply.add_as_binary("result", {
            "workers": self.health.statuses(),
            "routing_enabled": health_mod.routing_enabled(),
        })
        self.reply_rpc_message(msg["token"], reply)

    def rpc_debug_bundle(self, msg):
        """``rpc.debug_bundle(trace_id=None)``: the cross-node forensic
        artifact (schema ``bqueryd_tpu.debug_bundle/4``), one JSON-safe
        dict."""
        args, kwargs = msg.get_args_kwargs()
        trace_id = args[0] if args else kwargs.get("trace_id")
        reply = msg.copy()
        reply.add_as_binary("result", self.build_debug_bundle(trace_id))
        self.reply_rpc_message(msg["token"], reply)

    def build_debug_bundle(self, trace_id=None):
        """The debug artifact from state the controller holds (the worker
        slices come from absorbed heartbeats, so a wedged or dead worker
        cannot stall it): the reference's sections, among them the
        requested (or newest) trace and its autopsy, the slow-query ring,
        the workers' merged histograms, the runtime versions and the
        kernel build directory, the SLO classes, the newest timeline
        entries and a fresh capacity evaluation.  Each worker's slice
        holds its ``compile`` registry, ``runtime``, ``compile_cache`` and
        ``device_memory``."""
        from bqueryd_tpu_torch import obs
        from bqueryd_tpu_torch.obs import profile as obs_profile

        timeline = (self.trace_store.get(trace_id) if trace_id
                    else self.trace_store.latest())
        now = time.time()
        controller_section = {
            "address": self.address,
            "node": self.node_name,
            "uptime_s": round(now - self.start_time, 3),
            "flight": self.flight.events(),
            "flight_evictions": self.flight.evictions,
            "counters": dict(self.counters),
            "admission": self.admission.stats(),
            "workers_known": sorted(self.worker_map),
            "inflight": {
                token: {
                    "worker": e["worker"],
                    "age_s": round(now - e["sent_at"], 3),
                    "retries": e.get("retries", 0),
                }
                for token, e in self.inflight.items()
            },
            "health": self.health.statuses(),
            "trace": timeline,
            # the attributed critical path of that trace
            "autopsy": (timeline or {}).get("attribution"),
            "slow_queries": self.slow_queries.entries(),
            "metrics": self.metrics.histogram_snapshot(),
            "worker_histograms": self._aggregate_worker_histograms(),
            "runtime": obs_profile.runtime_versions(),
            "compile_cache": obs_profile.compile_cache_info(),
            "calibration": {
                **self.calibration.stats(),
                "sample_cells": self.calibration.summary(max_cells=16),
            },
            "chaos": {
                "armed": chaos.enabled(),
                "injected_total": chaos.injected_total(),
                "site_stats": chaos.site_stats(),
            },
            "replication": self._replication_info(),
            "batch_window": self._batch_window_info(),
            "slo": self.slo.snapshot(),
            "timeline_ring": self.timeline_ring.entries()[-16:],
            "capacity": self._capacity_bundle_section(),
            "serving": self.serving.snapshot(),
        }
        snapshots = {}
        for worker_id in set(self.worker_map) | set(self._worker_debug):
            absorbed = self._worker_debug.get(worker_id)
            snapshots[worker_id] = {
                "data": absorbed["data"] if absorbed else None,
                "ts": absorbed["ts"] if absorbed else None,
                "registered": worker_id in self.worker_map,
            }
        # the data dirs, the runfile dir and the kernel build directory
        # are operational facts; any other path is reduced to
        # <redacted>/basename
        allowed = {self.runfile_dir}
        allowed.update(
            info.get("data_dir") for info in self.worker_map.values()
        )
        allowed.add(controller_section["compile_cache"].get("path"))
        for absorbed in self._worker_debug.values():
            cache = (absorbed.get("data") or {}).get("compile_cache") or {}
            allowed.add(cache.get("path"))
        return obs.build_bundle(
            controller_section, snapshots,
            trace_id=trace_id or (timeline or {}).get("trace_id"),
            allowed_path_prefixes=[p for p in allowed if p],
        )

    def _batch_window_info(self):
        """The micro-batch window's knobs and what is staged now."""
        from bqueryd_tpu_torch.plan import bundle as bundlemod

        state = {
            "window_ms": bundlemod.batch_window_ms(),
            "batch_max": bundlemod.batch_max(),
            "staged": len(self._pending_window),
        }
        if self._pending_window:
            state["opened_age_s"] = round(
                max(time.time() - self._window_opened, 0.0), 3)
        return state

    def _aggregate_worker_histograms(self):
        """Every worker's histograms merged by bucket-vector addition,
        memoized on the snapshots' revision (get_info runs once per peer
        per gossip tick)."""
        from bqueryd_tpu_torch import obs

        rev, cached = self._worker_hist_cache
        if rev == self._worker_metrics_rev:
            return cached
        merged = obs.merge_histogram_snapshots(self._worker_metrics.values())
        self._worker_hist_cache = (self._worker_metrics_rev, merged)
        return merged

    def get_info(self, include_peers=True):
        """The controller's state for ``rpc.info()``; ``others`` is the
        peers' gossiped info, left out of the gossip itself."""
        from bqueryd_tpu_torch.obs import profile as obs_profile

        info = {
            "address": self.address,
            "node": self.node_name,
            "uptime": time.time() - self.start_time,
            "msg_count_in": self.msg_count_in,
            "workers": self.worker_map,
            "worker_out_messages": {
                str(k): len(v) for k, v in self.worker_out_messages.items()
            },
            "inflight": len(self.inflight),
            "rpc_segments": len(self.rpc_segments),
            "counters": {
                **self.counters,
                "controller_loop_seconds": self.loop_clock.seconds(),
            },
            "admission": self.admission.stats(),
            "shard_stats_known": len(self.shard_stats),
            # the measured-cost model: counts, the controller's own cells
            # (the reference's keys) and each worker's gossiped ones
            "calibration": {
                **self.calibration.stats(),
                "sample_cells": self.calibration.summary(max_cells=16),
                "source_cells": self.calibration.source_cells(max_cells=16),
            },
            # replica placement: the factor, shards by live holder count
            # and those below it
            "replication": self._replication_info(),
            # every worker's histograms, merged (the buckets are fixed)
            "worker_histograms": self._aggregate_worker_histograms(),
            "trace_buffer": len(self.trace_store),
            "slow_queries": len(self.slow_queries),
            # this process's versions and kernel build directory, and each
            # worker's versions from its debug slice
            "runtime": obs_profile.runtime_versions(),
            "compile_cache": obs_profile.compile_cache_info(),
            "worker_runtime": {
                worker_id: (absorbed.get("data") or {}).get("runtime")
                for worker_id, absorbed in self._worker_debug.items()
                if worker_id in self.worker_map
            },
            "health": self.health.statuses(),
        }
        if include_peers:
            info["others"] = self.others
        return info

    def _replication_info(self):
        """Replica placement for get_info and the debug bundle: the
        configured factor, shards bucketed by live holder count, and the
        shards a failover cannot help yet (fewer holders than the factor,
        or than 2 under factor 0)."""
        return {
            "replica_factor": self.replica_factor,
            "shards_by_holders": self._holder_counts(),
            "under_replicated": sorted(
                f for f, holders in self.files_map.items()
                if len(holders) < (self.replica_factor or 2)
            )[:64],
        }

    def rpc_loglevel(self, msg):
        args, _ = msg.get_args_kwargs()
        self._fan_out_to_workers(msg)
        self._fan_out_to_peers(msg)
        level = {"debug": logging.DEBUG, "info": logging.INFO}.get(
            args[0] if args else "info", logging.INFO
        )
        bqueryd_tpu_torch.logger.setLevel(level)
        reply = msg.copy()
        reply["payload"] = "OK"
        self.reply_rpc_message(msg.get("token"), reply)

    # -- peers and the admin verbs -------------------------------------------
    def handle_peer(self, msg):
        addr = msg.get("from")
        if addr and addr != self.address:
            info = msg.get_from_binary("info", {})
            info["last_seen"] = time.time()
            self.others[addr] = info

    def _fan_out_to_workers(self, msg):
        for worker_id in list(self.worker_map):
            fan = msg.copy()
            fan.pop("token", None)
            try:
                self.socket.send_multipart(
                    [worker_id.encode(), fan.to_json().encode()])
            except zmq.ZMQError:
                pass

    def _fan_out_to_peers(self, msg):
        if msg.get("_relayed"):
            return  # relayed once, never again
        for addr in list(self.others):
            fan = msg.copy()
            fan.pop("token", None)
            fan["_relayed"] = True
            try:
                self.socket.send_multipart(
                    [addr.encode(), fan.to_json().encode()])
            except zmq.ZMQError:
                pass

    def _reply_ok(self, msg):
        reply = msg.copy()
        reply["payload"] = "OK"
        self.reply_rpc_message(msg.get("token"), reply)

    def rpc_kill(self, msg):
        """Stop this controller."""
        self._reply_ok(msg)
        self.running = False

    def rpc_killworkers(self, msg):
        """Stop every registered worker."""
        self._fan_out_to_workers(Message({"payload": "kill"}))
        self._reply_ok(msg)

    def rpc_killall(self, msg):
        """Stop every worker, every peer controller (relayed once) and this
        controller."""
        fan = msg.copy()
        fan.pop("token", None)  # the client is answered below, once
        self.rpc_killworkers(fan)
        if not msg.get("_relayed"):
            for addr in list(self.others):
                relay = RPCMessage({"payload": "killall", "_relayed": True})
                try:
                    self.socket.send_multipart(
                        [addr.encode(), relay.to_json().encode()])
                except zmq.ZMQError:
                    pass
        self._reply_ok(msg)
        self.running = False

    def rpc_sleep(self, msg):
        """``sleep(seconds)`` on one worker, answered when it wakes;
        ``sleep([s1, s2, ...])`` scatters one sleep per entry and answers
        at once."""
        args, kwargs = msg.get_args_kwargs()
        if args and isinstance(args[0], (list, tuple)):
            for duration in args[0]:
                scatter = CalcMessage({"payload": "sleep"})
                scatter.set_args_kwargs([duration], {})
                self.worker_out_messages[None].append(scatter)
            self._reply_ok(msg)
            return
        calc = CalcMessage({"payload": "sleep", "token": msg["token"]})
        calc.set_args_kwargs(args, kwargs)
        self.worker_out_messages[None].append(calc)

    def rpc_readfile(self, msg):
        """The bytes of a file inside a worker's data_dir."""
        calc = CalcMessage(dict(msg))
        calc["payload"] = "readfile"
        self.worker_out_messages[None].append(calc)

    def rpc_execute_code(self, msg):
        """Run ``function=module.fn`` on a worker (where the worker allows
        it); answered with its result under ``wait=True``, else at once."""
        args, kwargs = msg.get_args_kwargs()
        if "function" not in kwargs and not msg.get("function"):
            raise ValueError("execute_code requires function= kwarg")
        wait = kwargs.pop("wait", False)
        calc = CalcMessage(dict(msg))
        calc["payload"] = "execute_code"
        calc.set_args_kwargs(args, kwargs)
        if not wait:
            calc.pop("token", None)
            self.worker_out_messages[None].append(calc)
            self._reply_ok(msg)
        else:
            self.worker_out_messages[None].append(calc)

    def rpc_download(self, msg):
        """Register a download ticket (:func:`download.setup_download`)."""
        from bqueryd_tpu_torch.download import setup_download

        setup_download(self, msg)

    #: download tickets whose shard names are remembered for invalidation
    TICKET_MEMORY = 256

    def note_ticket(self, ticket, shard_names):
        """Remember the shards a download ticket activates."""
        self._ticket_files[ticket] = list(shard_names)
        while len(self._ticket_files) > self.TICKET_MEMORY:
            self._ticket_files.pop(next(iter(self._ticket_files)))

    def _ticket_activated(self, ticket):
        """A mover swapped a ticket's shards into its serving dir: the
        shards may hold other data under the same names, so their
        advertised stats are dropped (no plan-time pruning on old bounds
        until the workers advertise new ones) and every rollup over them
        goes stale (rebuilt before it serves again).  A ticket this
        controller did not register (a peer's) invalidates every shard.
        Each mover of a ticket reports it, so each node's activation
        invalidates again."""
        names = self._ticket_files.get(ticket)
        if names is None:
            names = sorted(set(self.files_map) | set(self.shard_stats))
        for name in names:
            self.shard_stats.pop(name, None)
            self.serving.note_append(name)
        self.flight.record("ticket_activated", ticket=ticket,
                           shards=len(names))

    def release_ticket_waiters(self, ticket, error=None):
        """Answer the client waiting on ``ticket`` (``wait=True``): "DONE",
        or the ticket's error."""
        segment = self.rpc_segments.pop(f"ticket_{ticket}", None)
        if segment is None:
            return
        if error:
            reply = ErrorMessage(segment["msg"])
            reply["payload"] = f"download ticket {ticket} failed: {error}"
        else:
            reply = segment["msg"].copy()
            reply["payload"] = "DONE"
        reply["ticket"] = ticket
        self.reply_rpc_message(segment["client_token"], reply)

    def rpc_groupby(self, msg):
        """Compile the query to a logical plan and queue one CalcMessage
        per shard group; the reply goes out when every shard is
        covered."""
        from bqueryd_tpu_torch.models.query import AGG_OPS, normalize_agg_list
        from bqueryd_tpu_torch.plan import plan_groupby

        args, kwargs = msg.get_args_kwargs()
        if len(args) != 4:
            raise ValueError(
                "groupby needs (filenames, groupby_cols, agg_list, where_terms)"
            )
        filenames, groupby_cols, agg_list, where_terms = args
        # an op outside the groupby surface fails here, as a structured
        # envelope, not as a worker traceback
        bad = sorted(
            {str(a[1]) for a in normalize_agg_list(agg_list)
             if a[1] not in AGG_OPS}
        )
        if bad:
            self.reply_rpc_raw(
                msg["token"],
                pickle.dumps(
                    {
                        "ok": False,
                        "error_class": "UnsupportedOp",
                        "error": (f"unsupported aggregation op(s) {bad}; "
                                  f"groupby supports {list(AGG_OPS)}; "
                                  f"joins, top-k, quantiles and window "
                                  f"rollups go through the query verb "
                                  f"(rpc.query)"),
                    },
                    protocol=messages.PICKLE_PROTOCOL,
                ),
            )
            return
        # the client's trace context is adopted (one is minted for a
        # client that sent none): the query's "groupby" span is a child of
        # the client's root span and the parent of every query span
        obs_state = self._adopt_trace(msg)
        plan_start, plan_clock = time.time(), time.perf_counter()
        plan = plan_groupby(
            filenames, groupby_cols, agg_list, where_terms,
            aggregate=kwargs.get("aggregate", True),
            expand_filter_column=kwargs.get("expand_filter_column"),
        )
        self._plan_span(obs_state, plan_start, plan_clock)
        self._admit_plan(msg, plan, kwargs)

    def rpc_query(self, msg):
        """The operator-DAG verb: compile the ``rpc.query(spec)`` dict into
        an :class:`~bqueryd_tpu_torch.plan.dag.OperatorDAG` (broadcast hash
        joins, per-group top-k, mergeable quantile sketches, time-window
        rollups), derive its groupby-shaped plan and dispatch it as a
        groupby, with the wire DAG on every message.  A spec that fails
        validation gets a structured envelope (``error_class``
        "UnsupportedOp" or "InvalidPlan")."""
        from bqueryd_tpu_torch.plan import dag as dagmod

        args, kwargs = msg.get_args_kwargs()
        if len(args) != 1 or not isinstance(args[0], dict):
            raise ValueError("query needs one spec dict argument")
        obs_state = self._adopt_trace(msg)
        plan_start, plan_clock = time.time(), time.perf_counter()
        try:
            dag = dagmod.compile_query(args[0])
            plan, dag_kwargs = dagmod.groupby_equivalent(dag)
        except dagmod.DagValidationError as exc:
            self.reply_rpc_raw(
                msg["token"],
                pickle.dumps(
                    {"ok": False, "error_class": exc.error_class,
                     "error": str(exc)},
                    protocol=messages.PICKLE_PROTOCOL,
                ),
            )
            return
        self._plan_span(obs_state, plan_start, plan_clock)
        self._admit_plan(msg, plan, dict(kwargs, **dag_kwargs))

    # -- admission, the micro-batch window and launch -----------------------
    def _admit_plan(self, msg, plan, kwargs):
        """The admission tail of the groupby-shaped verbs (groupby and
        query): the unknown-shard check, resend and supersede handling,
        BUSY backpressure, then staging or launch."""
        from bqueryd_tpu_torch import plan as planmod

        unknown = [f for f in plan.filenames if f not in self.files_map]
        if unknown:
            raise ValueError(f"filenames not found on any worker: {unknown}")
        # the serving layer: a proven subsumption or rollup hit answers
        # here, with no admission slot, no dispatch and no scan; a miss or
        # refusal falls through unchanged
        if self.serving.try_serve(msg, plan, kwargs):
            return
        token = msg["token"]
        # the quota bucket is the client-declared client_id, so that one
        # application's sockets share one quota; else the REQ identity
        quota_key = msg.get("client_id") or token
        # deadline and priority are not part of the resend signature: a
        # retry restamps a fresh deadline, and reading it as a new query
        # would restart a long run on every retry.  An identical resend
        # joins the run in flight, whose deadline governs.
        req_sig = (tuple(plan.filenames), plan.signature())

        def submit():
            return self.admission.submit(
                ticket_id=token, client=quota_key,
                priority=msg.get("priority", 0),
                deadline=msg.get("deadline"), payload=(msg, plan, kwargs),
            )

        decision = submit()
        if (decision == planmod.DUPLICATE
                and self._ticket_sigs.get(token) != req_sig):
            # a DIFFERENT query on a live identity: a REQ socket is
            # lockstep, so its client abandoned the earlier query, whose
            # reply would pair with this request.  Retire the abandoned
            # run silently and admit this one in its place.
            self.counters["admission_superseded"] += 1
            self._cancel_ticket(token)
            decision = submit()
        if decision == planmod.BUSY:
            self.counters["admission_busy"] += 1
            self.reply_rpc_raw(token, pickle.dumps(
                {"ok": False, "busy": True,
                 "error": "BUSY: admission queue full or client quota "
                          "exceeded; retry with backoff"},
                protocol=messages.PICKLE_PROTOCOL,
            ))
            return
        if decision == planmod.QUEUED:
            self._ticket_sigs[token] = req_sig
            self.counters["admission_queued"] += 1
            return  # launched later by _admit_ready
        if decision == planmod.DUPLICATE:
            # a client's resend of the query it already has in flight: that
            # run answers this identity; a second fan-out would double the
            # work and queue a stale reply for the client's next call
            self.logger.info("duplicate %s from client %s ignored (already "
                             "running)", msg.get("payload"), token[:12])
            return
        self._ticket_sigs[token] = req_sig
        try:
            self._stage_plan(msg, plan, kwargs)
        except Exception:
            self.admission.release(token)
            self._ticket_sigs.pop(token, None)
            raise

    def _cancel_ticket(self, ticket):
        """Silently retire a live ticket whose client moved on: a staged
        plan is dropped before the flush can launch it, a running one is
        detached from its work and finished with no reply, a queued one is
        dropped before it launches."""
        staged = [e for e in self._pending_window
                  if e[0].get("token") == ticket]
        if staged:
            self._pending_window = [e for e in self._pending_window
                                    if e[0].get("token") != ticket]
            if self.admission.release(ticket):
                self._ticket_sigs.pop(ticket, None)
            return
        parent = next((p for p, seg in self.rpc_segments.items()
                       if seg.get("admission_ticket") == ticket), None)
        if parent is not None:
            self.abort_parent(parent, "superseded", reply=False)
        elif self.admission.release(ticket):
            self._ticket_sigs.pop(ticket, None)

    def _reply_failed(self, msg, text):
        """Release a plan's ticket and send its client an error envelope:
        a plan that failed to launch, or expired while queued."""
        if self.admission.release(msg["token"]):
            self._ticket_sigs.pop(msg["token"], None)
        self.reply_rpc_raw(msg["token"], pickle.dumps(
            {"ok": False, "error": str(text)},
            protocol=messages.PICKLE_PROTOCOL,
        ))

    def _admit_ready(self):
        """Launch queued plans into freed capacity; expire stale ones."""
        if self._admitting:
            return  # re-entered through a completion inside a launch
        self._admitting = True
        try:
            while True:
                launch, expired = self.admission.pop_ready()
                if not launch and not expired:
                    return
                for msg, _plan, _kwargs in expired:
                    self.counters["deadline_expired"] += 1
                    self._reply_failed(
                        msg, "deadline exceeded while queued for admission")
                for msg, plan, kwargs in launch:
                    try:
                        self._stage_plan(msg, plan, kwargs)
                    except Exception as exc:
                        self.logger.exception("queued plan launch failed")
                        self._reply_failed(msg, exc)
        finally:
            self._admitting = False

    def _stage_plan(self, msg, plan, kwargs):
        """Launch now (window 0: the path without a window) or stage into
        the micro-batch window, so that concurrent compatible queries can
        fuse into one shared-scan dispatch."""
        from bqueryd_tpu_torch import obs
        from bqueryd_tpu_torch.plan import bundle as bundlemod

        window_ms = bundlemod.batch_window_ms()
        if window_ms <= 0:
            self._launch_plan(msg, plan, kwargs)
            return
        if not self._pending_window:
            self._window_opened = time.time()
            # a staging decision, on the timeline a slow query is read
            # from (hot path: under the kill switch)
            if obs.enabled():
                self.flight.record("window_open", window_ms=window_ms)
        # the batch_window span (staged -> flush) is carved out of the
        # admission wait in _open_query_segment
        obs_state = msg.get("_obs")
        if isinstance(obs_state, dict):
            obs_state["staged_ts"] = time.time()
        self._pending_window.append((msg, plan, kwargs))
        if len(self._pending_window) >= bundlemod.batch_max():
            self._flush_window(force=True)

    def _window_deadline(self):
        """When the open micro-batch window closes."""
        from bqueryd_tpu_torch.plan import bundle as bundlemod

        return self._window_opened + bundlemod.batch_window_ms() / 1000.0

    def _flush_window(self, force=False):
        """Close the micro-batch window: group the staged plans by
        compatibility key, launch each group of several as ONE shared-scan
        bundle and the rest alone.  A launch failure answers its own
        members and never poisons the other groups."""
        if not self._pending_window:
            return
        if not force and time.time() < self._window_deadline():
            return
        from bqueryd_tpu_torch.plan import bundle as bundlemod

        pending, self._pending_window = self._pending_window, []
        groups = {}
        for msg, plan, kwargs in pending:
            try:
                keep, pruned = self._prune_shards(plan)
                key = bundlemod.compat_key(plan, keep, kwargs)
            except Exception:
                # one malformed plan must not poison the window: it goes
                # alone, and its own launch answers the error
                self.logger.exception("window compatibility probe failed")
                # forensic event, never gated
                self.flight.record("window_degrade_solo",
                                   token=str(msg.get("token"))[:12])
                keep, pruned, key = list(plan.filenames), [], None
            if key is None:
                key = ("solo", id(msg))
            groups.setdefault(key, []).append(
                (msg, plan, kwargs, keep, pruned))
        from bqueryd_tpu_torch import obs

        if obs.enabled():
            self.flight.record(
                "window_flush",
                staged=len(pending),
                groups=len(groups),
                fused=sum(1 for g in groups.values() if len(g) > 1),
                held_ms=round(
                    max(time.time() - self._window_opened, 0.0) * 1000.0, 1),
            )
        for entries in groups.values():
            try:
                if len(entries) == 1:
                    msg, plan, kwargs, keep, pruned = entries[0]
                    self._launch_plan(msg, plan, kwargs,
                                      preplanned=(keep, pruned))
                else:
                    self._launch_bundle(entries)
            except Exception as exc:
                self.logger.exception("window flush launch failed")
                for msg, *_rest in entries:
                    self._reply_failed(msg, exc)

    def _prune_shards(self, plan):
        """Plan-time shard pruning: ``(keep, pruned)``.  A shard whose
        advertised min/max stats exclude the pushed-down filter is never
        dispatched."""
        from bqueryd_tpu_torch import plan as planmod

        planner_on = planmod.planner_enabled()
        keep, pruned = [], []
        for f in plan.filenames:
            stats = self.shard_stats.get(f)
            if (planner_on and plan.scan.pushdown and stats is not None
                    and not planmod.stats_can_match(stats,
                                                    plan.scan.pushdown)):
                pruned.append(f)
            else:
                keep.append(f)
        return keep, pruned

    def _open_query_segment(self, msg, plan, pruned):
        """The per-query result segment, under a fresh parent token; each
        bundle member has one of its own.  A pruned shard's (provably
        empty) payload slot is pre-filled, so that the client's merge is
        unchanged."""
        from bqueryd_tpu_torch import obs

        parent_token = os.urandom(8).hex()
        # the trace state rpc_groupby adopted (a caller that launches a
        # plan directly gets a fresh one)
        obs_state = msg.get("_obs")
        if not isinstance(obs_state, dict):
            obs_state = self._new_obs_state(obs.TraceContext.new_root())
        # the admission span covers submit -> launch, and the time staged
        # in the micro-batch window is a batch_window span of its own
        if obs.enabled():
            now = time.time()
            staged_ts = obs_state.get("staged_ts")
            admitted_until = (min(staged_ts, now) if staged_ts is not None
                              else now)
            obs_state["spans"].append(obs.make_span(
                obs_state["trace_id"], "admission",
                obs_state["submitted_ts"],
                max(admitted_until - obs_state["submitted_ts"], 0.0),
                parent_span_id=obs_state["qspan_id"], node=self.address,
            ))
            if staged_ts is not None:
                obs_state["spans"].append(obs.make_span(
                    obs_state["trace_id"], "batch_window", staged_ts,
                    max(now - staged_ts, 0.0),
                    parent_span_id=obs_state["qspan_id"],
                    node=self.address,
                ))
        # one launched query: the capacity model's shards-per-query
        # denominator
        self.capacity.observe_launch()
        self.rpc_segments[parent_token] = self._new_segment(
            msg, plan.filenames, pruned, obs_state,
            plan_sig=str(plan.signature()))
        return parent_token

    @staticmethod
    def _new_segment(msg, filenames, pruned, obs_state, plan_sig=None):
        """A query's result segment: a pruned shard's (provably empty)
        payload slot is pre-filled."""
        return {
            "client_token": msg["token"],
            "admission_ticket": msg["token"],
            "msg": msg,
            "filenames": list(filenames),
            "pruned": list(pruned),
            "results": {(f,): b"" for f in pruned},  # group key -> payload
            "timings": {},            # shard-group key -> phase_timings
            "strategies": {},         # hint -> dispatched shards
            "effective": {},          # shard-group key -> executed route
            "merge": {},              # shard-group key -> merge_mode
            "created": time.time(),
            # the monotonic anchor of the reported wall
            "created_clock": time.perf_counter(),
            "obs": obs_state,
            "plan_sig": plan_sig,
        }

    def _trace_hop(self, shard, parent, queued_ts):
        """A dispatch's trace hop: a child context of the query's groupby
        span (the worker's calc span is its child) and the queue clock the
        dispatch span starts at: ``queued_ts``, when the plan's dispatch
        began (its units' strategy selection and build are dispatch
        work)."""
        obs_state = self.rpc_segments.get(parent, {}).get("obs")
        if obs_state:
            shard.set_trace({
                "trace_id": obs_state["trace_id"],
                "span_id": os.urandom(8).hex(),
                "parent_span_id": obs_state["qspan_id"],
            })
            shard["_dispatch_queued_ts"] = queued_ts

    def _launch_plan(self, msg, plan, kwargs, preplanned=None):
        """Prune, open the segment and queue the plan's dispatch; with
        every shard pruned, answer at once.  ``preplanned`` is the (keep,
        pruned) a window flush already computed."""
        keep, pruned = (preplanned if preplanned is not None
                        else self._prune_shards(plan))
        self.counters["plan_pruned_shards"] += len(pruned)
        parent_token = self._open_query_segment(msg, plan, pruned)
        if not keep:
            self._maybe_complete_segment(parent_token)
            return
        try:
            self._dispatch_plan(msg, plan, kwargs, parent_token, keep)
        except Exception:
            # a half-launched parent can never complete: retire it with
            # the work it did queue; the caller answers the error
            self.abort_parent(parent_token, "launch failed", reply=False)
            raise

    def _launch_bundle(self, entries):
        """Launch a compatible micro-batch as shared-scan bundles: one
        CalcMessage per shard group carrying every member's fragment.  The
        worker runs one decode, alignment and upload pass and one device
        program, and the reply is demultiplexed per member
        (:meth:`_demux_bundle`).  A bundle carries no strategy hint: the
        shared scan runs its own route, so a hint could only reach the
        worker's rare member-by-member path."""
        from bqueryd_tpu_torch.plan import bundle as bundlemod

        dispatch_started = time.time()
        _msg0, plan0, kwargs0, keep, _pruned0 = entries[0]
        member_parents = {}   # member_id -> parent token
        members = []          # (member_id, plan, deadline)
        opened = []
        try:
            for msg, plan, _kwargs, _keep, pruned in entries:
                self.counters["plan_pruned_shards"] += len(pruned)
                parent_token = self._open_query_segment(msg, plan, pruned)
                opened.append(parent_token)
                member_id = os.urandom(6).hex()
                member_parents[member_id] = parent_token
                members.append((member_id, plan, msg.get("deadline")))
            groupby_cols = list(plan0.groupby.keys)
            agg_list0 = plan0.physical_agg_list()
            parents = [member_parents[m[0]] for m in members]
            # the envelope's deadline is the LAST member's (its expiry
            # implies every member's); each member's own deadline rides
            # its fragment record and is enforced by the worker
            deadlines = [m[2] for m in members]
            bundle_deadline = (max(deadlines)
                               if all(d is not None for d in deadlines)
                               else None)
            sole = len(keep) == 1
            affinity = kwargs0.get("affinity")
            for group in self._shard_groups(keep, groupby_cols, agg_list0,
                                            kwargs0):
                target = group if len(group) > 1 else group[0]
                for parent in parents:
                    strategies = self.rpc_segments[parent]["strategies"]
                    strategies["auto"] = (strategies.get("auto", 0)
                                          + len(group))
                shard = CalcMessage({"payload": "groupby"})
                if sole:
                    shard["sole_shard"] = True
                # the positional params carry the FIRST member's query, so
                # that _split_batch keeps working; the bundle fragment is
                # what a worker that knows bundles runs
                shard.set_args_kwargs(
                    [target, groupby_cols, agg_list0,
                     [list(t) for t in plan0.where_terms]],
                    {},
                )
                shard["token"] = os.urandom(8).hex()
                shard["parent_token"] = parents[0]
                shard["filename"] = target
                shard["affinity"] = affinity
                self._trace_hop(shard, parents[0], dispatch_started)
                if bundle_deadline is not None:
                    shard["deadline"] = bundle_deadline
                shard.add_as_binary("bundle", bundlemod.bundle_fragment(
                    plan0, group, members, sole=sole))
                shard["_bundle_parents"] = dict(member_parents)
                self._register_work(shard, parents)
                self.counters["plan_bundles"] += 1
                self.counters["plan_bundled_queries"] += len(members)
                # each member beyond the first shares a dispatch it would
                # have paid for itself
                self.counters["plan_shared_dispatches"] += len(members) - 1
                self.worker_out_messages.setdefault(affinity, []).append(
                    shard)
        except Exception:
            for parent in opened:
                self.abort_parent(parent, "bundle launch failed",
                                  reply=False)
            raise

    def _dispatch_plan(self, msg, plan, kwargs, parent_token, keep):
        """Queue one CalcMessage per group of the kept shards, each with
        its plan fragment and, for the ``query`` verb, the wire DAG; or
        join a queued or running identical unit.  A plain dispatch's
        fragment carries the kernel-strategy hint
        (``plan.select_calibrated``, counted in ``plan_strategy_hints``,
        ``plan_calibrated_overrides``, ``plan_explore_hints`` and
        ``plan_matmul_promotions``); a DAG dispatch carries none, as the
        DAG executor routes its own kernels."""
        from bqueryd_tpu_torch import plan as planmod
        from bqueryd_tpu_torch.plan import fragment_for

        dispatch_started = time.time()
        affinity = kwargs.get("affinity")
        planner_on = planmod.planner_enabled()
        dag_blob = None
        if kwargs.get("dag") is not None:
            planner_on = False
            # encoded once: the wire DAG carries the whole join table
            dag_blob = base64.b64encode(
                pickle.dumps(kwargs["dag"], protocol=messages.PICKLE_PROTOCOL)
            ).decode("ascii")
        groupby_cols = list(plan.groupby.keys)
        agg_list = plan.physical_agg_list()
        where_terms = plan.where_terms
        # one payload with no merge downstream (the reference's
        # count_distinct then ships final counts)
        sole = len(keep) == 1 and plan.aggregate_rows
        plan_sig = plan.signature()
        segment = self.rpc_segments[parent_token]
        for group in self._shard_groups(keep, groupby_cols, agg_list,
                                        kwargs):
            target = group if len(group) > 1 else group[0]
            strategy = None
            if planner_on:
                strategy, _est, _rows, reason = planmod.select_calibrated(
                    self.shard_stats, group, groupby_cols,
                    calibration=self.calibration,
                )
                if strategy == planmod.STRATEGY_AUTO:
                    strategy = None
                else:
                    self.counters["plan_strategy_hints"] += 1
                if reason == "measured":
                    self.counters["plan_calibrated_overrides"] += 1
                elif reason == "explore":
                    self.counters["plan_explore_hints"] += 1
                if strategy == planmod.STRATEGY_MATMUL_BINDING:
                    self.counters["plan_matmul_promotions"] += 1
            hint = strategy or "auto"
            segment["strategies"][hint] = (
                segment["strategies"].get(hint, 0) + len(group)
            )
            # identical pending work is joined, not dispatched again.  The
            # deadline is part of the identity (fusing across deadlines
            # would expire one client's work on another's budget), and so
            # is the affinity (a pinned query would run elsewhere)
            work_key = (tuple(group), plan_sig, sole, msg.get("deadline"),
                         affinity)
            existing = self._work_index.get(work_key)
            if existing is not None and existing in self._work_subscribers:
                self._work_subscribers[existing].append(parent_token)
                self.counters["plan_shared_dispatches"] += 1
                continue
            shard = CalcMessage({"payload": "groupby"})
            if sole:
                shard["sole_shard"] = True
            shard.set_args_kwargs(
                [target, groupby_cols, agg_list, where_terms],
                {k: v for k, v in kwargs.items()
                 if k in ("aggregate", "expand_filter_column")},
            )
            shard["token"] = os.urandom(8).hex()
            shard["parent_token"] = parent_token
            shard["filename"] = target
            shard["affinity"] = affinity
            self._trace_hop(shard, parent_token, dispatch_started)
            if msg.get("deadline") is not None:
                shard["deadline"] = msg["deadline"]
            shard.add_as_binary("plan", fragment_for(
                plan, group, strategy=strategy, sole=sole))
            if dag_blob is not None:
                shard["dag"] = dag_blob
            self._register_work(shard, [parent_token], work_key=work_key)
            self.worker_out_messages.setdefault(affinity, []).append(shard)

    def _shard_groups(self, filenames, groupby_cols, agg_list, kwargs):
        """Shards held by the same set of workers go out as ONE message,
        so a worker runs one executor call over all of them.  Only
        aggregations that merge by part kind batch: the mergeable ops, and
        for a DAG dispatch (``kwargs["dag"]``, whose ``batch`` flag
        ``plan.dag.groupby_equivalent`` sets) the top-k and sketch ops; raw
        rows and the distinct ops go one shard per message, as does
        ``batch=False`` and every query under ``BQUERYD_TPU_DEVICE_MERGE=0``
        (each shard's partial table then rides the wire and merges on the
        host, the reference's host-gather baseline)."""
        from bqueryd_tpu_torch.models.query import (
            MERGEABLE_OPS,
            normalize_agg_list,
        )
        from bqueryd_tpu_torch.parallel import devicemerge
        from bqueryd_tpu_torch.plan.dag import is_extended_op

        dag_riding = kwargs.get("dag") is not None
        batchable = (
            kwargs.get("batch", True)
            and kwargs.get("aggregate", True)
            and all(a[1] in MERGEABLE_OPS
                    or (dag_riding and is_extended_op(a[1]))
                    for a in normalize_agg_list(agg_list))
            and devicemerge.device_merge_enabled()
        )
        if not batchable:
            return [[f] for f in filenames]
        groups = {}
        for f in filenames:
            placement = tuple(sorted(self.files_map.get(f, ())))
            groups.setdefault(placement, []).append(f)
        return list(groups.values())

    # -- the serving layer's wire ------------------------------------------
    def _dispatch_rollup_build(self, entry, prior=None):
        """One ``rollup`` CalcMessage per shard of a rollup entry, pinned
        to a live holder (``worker_id``, that worker's affinity queue).  A refresh (``prior`` set) carries each shard's previous
        partials and the growth base they were computed from: the worker
        aggregates only the appended chunks when the base still holds."""
        spec = entry.spec
        dag_blob = None
        if spec.get("dag_wire") is not None:
            dag_blob = base64.b64encode(
                pickle.dumps(spec["dag_wire"],
                             protocol=messages.PICKLE_PROTOCOL)
            ).decode("ascii")
        keys, agg_list, where = spec["args"]
        for fname in entry.filenames:
            holders = self.files_map.get(fname) or set()
            worker_id = next(
                (w for w in sorted(holders) if w in self.worker_map), None
            )
            if worker_id is None:
                self._fail_rollup(entry.key, fname, "no-holder")
                return
            calc = CalcMessage({
                "payload": "rollup",
                "filename": fname,
                "token": f"rollup_{os.urandom(8).hex()}",
                "worker_id": worker_id,
            })
            calc.set_args_kwargs(
                [fname, keys, agg_list, where], {"aggregate": True}
            )
            if dag_blob is not None:
                calc["dag"] = dag_blob
            pinfo = (prior or {}).get(fname) or {}
            if pinfo.get("data") and pinfo.get("base") is not None:
                calc.add_as_binary("rollup_prior", pinfo["data"])
                calc.add_as_binary("rollup_base", pinfo["base"])
            self._rollup_waiters[calc["token"]] = (entry.key, fname)
            self.worker_out_messages.setdefault(worker_id, []).append(calc)
        self.flight.record(
            "rollup_dispatch", entry=entry.key,
            shards=len(entry.filenames), refresh=prior is not None,
        )

    def _fail_rollup(self, key, fname, reason):
        """Drop a rollup entry whose build cannot complete; serving stays
        on the dispatch path for its view."""
        self.serving.manager.fail(key, reason)
        self.flight.record("rollup_build_failed", entry=key, filename=fname,
                           reason=str(reason)[:200])

    def _absorb_rollup_reply(self, token, msg):
        """One shard's rollup build or refresh reply into the serving
        layer.  An error reply (a worker that does not know the verb
        included) drops the whole entry."""
        from bqueryd_tpu_torch.models.query import ResultPayload

        key, fname = self._rollup_waiters.pop(token)
        if msg.isa(ErrorMessage):
            text = str(msg.get("payload") or "rollup build failed")
            if "unhandled message payload" in text:
                text = ("UnsupportedVerb: the worker does not answer rollup "
                        "builds; rollups stay off until every calc worker "
                        "does")
            else:
                text = (text.strip().splitlines() or ["failed"])[-1]
            self._fail_rollup(key, fname, text)
            return
        data = msg.get("data")
        mode = msg.get("rollup_mode") or "rebuild"
        base = (msg.get_from_binary("rollup_base")
                if msg.get("rollup_base") else None)
        zones = (msg.get_from_binary("rollup_zones")
                 if msg.get("rollup_zones") else {})
        try:
            payload = dict(ResultPayload.from_bytes(data))
        except Exception:
            self._fail_rollup(key, fname, "undecodable payload")
            return
        groups = (len(payload.get("rows", ()))
                  if payload.get("kind") == "partials" else 0)
        state = self.serving.absorb_build(key, fname, {
            "data": data,
            "payload": payload,
            "base": base,
            "zones": zones,
            "groups": int(groups),
            "mode": mode,
        })
        if mode == "delta":
            self.counters["rollup_refreshes"] += 1
        elif mode == "rebuild":
            self.counters["rollup_builds"] += 1
        if state == "ready":
            self.flight.record("rollup_materialized", entry=key, mode=mode)

    def _reply_served(self, msg, payloads, source, subsumed_from):
        """Answer a groupby-shaped verb from the serving layer, in the
        envelope of :meth:`_maybe_complete_segment` (empty timings and
        strategies: nothing was dispatched) with the provenance pair.  A
        live admission ticket of this REQ identity is retired first: its
        run's reply would pair with the client's next request."""
        token = msg["token"]
        if token in self._ticket_sigs:
            self._cancel_ticket(token)
        self._count_answer(source)
        self.reply_rpc_raw(token, pickle.dumps(
            {
                "ok": True,
                "payloads": payloads,
                "timings": {},
                "strategies": {"hints": {}, "effective": {}},
                "merge_modes": {},
                "answer_source": source,
                "subsumed_from": subsumed_from,
            },
            protocol=messages.PICKLE_PROTOCOL,
        ))
        # a served answer is accounted as a dispatched one: its SLO
        # outcome, its query_seconds observation and a timeline of its
        # groupby span (the reference's served answers skip all of it)
        obs_state = msg.get("_obs")
        if isinstance(obs_state, dict):
            segment = self._new_segment(msg, [], [], obs_state)
            segment["created"] = obs_state["submitted_ts"]
            segment["created_clock"] = obs_state.get(
                "submitted_clock", segment["created_clock"])
            segment["answer_source"] = source
            segment["subsumed_from"] = subsumed_from
            self._finalize_query_obs(None, segment)

    def _count_answer(self, source):
        """The answer counter by provenance; every groupby-shaped reply
        with a result passes here once."""
        self.metrics.counter(
            "bqueryd_tpu_serve_answers_total",
            "groupby answers by provenance source "
            "(recompute|cached|delta|rollup|subsume)",
            labels={"source": source},
        ).inc()

    # -- streaming append ---------------------------------------------------
    def rpc_append(self, msg):
        """``rpc.append(filename, dataframe_like)``: send the batch to every
        holder of the shard, once per distinct (node, data_dir), so that
        workers sharing one directory apply it once, and reply when ALL
        holders confirmed.  A holder that fails leaves the replicas
        diverged: the error reply names it, and re-issuing the append is
        the repair."""
        args, _kwargs = msg.get_args_kwargs()
        if len(args) != 2:
            raise ValueError("append needs (filename, dataframe_like)")
        filename = args[0]
        holders = sorted(self.files_map.get(filename) or ())
        if not holders:
            raise ValueError(
                f"file {filename!r} is not served by any worker"
            )
        targets = {}
        for worker_id in holders:
            info = self.worker_map.get(worker_id) or {}
            group = (info.get("node"), info.get("data_dir") or worker_id)
            targets.setdefault(group, worker_id)
        # rollups over this shard go stale BEFORE any worker changes it: a
        # stale but unchanged entry refreshes back to ready, the reverse
        # order could serve pre-append partials as fresh
        self.serving.note_append(filename)
        deadline = msg.get("deadline")
        seg_key = f"append_{os.urandom(8).hex()}"
        segment = {
            "client_token": msg["token"],
            "filename": filename,
            "expires": (float(deadline) if deadline is not None
                        else time.time() + APPEND_TIMEOUT),
            "pending": {},   # dispatch token -> worker_id
            "results": {},   # worker_id -> result dict
            "errors": {},    # worker_id -> error text
        }
        for worker_id in sorted(targets.values()):
            calc = CalcMessage(dict(msg))
            calc["payload"] = "append"
            calc["filename"] = filename
            calc["token"] = f"append_{os.urandom(8).hex()}"
            calc["worker_id"] = worker_id
            segment["pending"][calc["token"]] = worker_id
            self._append_waiters[calc["token"]] = seg_key
            self.worker_out_messages.setdefault(worker_id, []).append(calc)
        self._append_segments[seg_key] = segment

    def _absorb_append_reply(self, token, msg):
        """One holder's append reply; when every holder answered, the
        client's reply."""
        seg_key = self._append_waiters.pop(token, None)
        segment = self._append_segments.get(seg_key)
        if segment is None:
            return
        worker_id = segment["pending"].pop(token, None)
        if worker_id is None:
            return
        if msg.isa(ErrorMessage):
            text = str(msg.get("payload") or "append failed")
            # a worker's traceback: its last line names the error
            text = (text.strip().splitlines() or ["append failed"])[-1]
            segment["errors"][worker_id] = text[:300]
        else:
            segment["results"][worker_id] = (
                msg.get_from_binary("result") or {}
            )
        if not segment["pending"]:
            self._finish_append_segment(seg_key, segment)

    def _finish_append_segment(self, seg_key, segment, timeout=False):
        self._append_segments.pop(seg_key, None)
        for token in list(segment["pending"]):
            self._append_waiters.pop(token, None)
        filename = segment["filename"]
        reply_to = segment["client_token"]
        if segment["errors"] or timeout:
            detail = "; ".join(
                f"{w}: {e}" for w, e in sorted(segment["errors"].items())
            )
            if timeout and segment["pending"]:
                waiting = ", ".join(sorted(segment["pending"].values()))
                detail = (f"{detail}; " if detail else "") + (
                    f"no reply from {waiting}")
            applied = (
                f" ({len(segment['results'])} holder(s) DID apply the "
                f"append: replicas may have diverged; re-issue the append)"
                if segment["results"] else ""
            )
            err = ErrorMessage({"token": reply_to})
            err["payload"] = f"append {filename!r} failed: {detail}{applied}"
            self.reply_rpc_message(reply_to, err)
            return
        reply = Message({"token": reply_to, "payload": "append"})
        reply.add_as_binary("result", {
            "filename": filename,
            "holders": segment["results"],
            "appended": max(
                (r.get("appended", 0) for r in segment["results"].values()),
                default=0,
            ),
        })
        self.reply_rpc_message(reply_to, reply)

    def _sweep_append_segments(self):
        """Fail append fan-outs whose holders never answered (a lost
        reply) instead of leaving the client waiting past its timeout."""
        now = time.time()
        for seg_key, segment in list(self._append_segments.items()):
            if now > segment["expires"]:
                self._finish_append_segment(seg_key, segment, timeout=True)

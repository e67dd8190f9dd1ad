"""The calc worker: per-query execution and the ZMQ worker node.

:func:`execute` is the port of ``bqueryd_tpu/worker.py``
``WorkerNode._execute``:

* a filter whose per-chunk zone maps prove most chunks unmatchable runs
  over views of the surviving chunks (``ops.chunk_pruned_table``), on
  every route below; basket expansion skips this, as it re-selects rows of
  a basket that live in pruned chunks;
* mergeable aggregate queries over more rows than the host-routing
  threshold (``models.query.host_kernel_rows`` at the query's worst host
  cost) go to the executor
  (:class:`~bqueryd_tpu_torch.parallel.executor.MeshQueryExecutor`): one
  key alignment, one kernel call over every shard's rows, the merge on the
  device; a ``"host"`` hint, a smaller group or a wedged device
  (:mod:`bqueryd_tpu_torch.utils.devicehealth`) skip it for the per-shard
  engine, which then runs each shard on the host;
* a composite key space past int64 (``ops.CompositeOverflow``) is served
  by the per-shard engine, which factorizes key tuples instead;
* a single shard that the executor does not take (raw rows, the distinct
  ops) goes to :meth:`QueryEngine.execute_local`;
* anything else runs per shard, then merges on the host by key value
  (distinct value sets by union): each shard's host work (key factorize,
  column decode) runs on the pipeline pool, its device work on the calling
  thread.

:class:`WorkerNode` answers ``groupby`` messages (and the operator DAGs of
the ``query`` verb, which ride them) through the DAG layer, its result
cache, its delta cache and then :func:`execute`, the executor's DAG fast
path or the per-shard ``DagExecutor``; a ``groupby`` carrying a shared-scan
``bundle`` through :meth:`MeshQueryExecutor.execute_bundle`, with a
payload per member; ``append`` messages by writing the rows; and
``rollup`` messages by building (or refreshing from appended chunks) one
shard's mergeable partials, behind the reference's control plane: one
ROUTER socket with a random hex identity connected out to every controller
in the coordination store, a WorkerRegisterMessage (WRM) with the served
``*.bcolz``/``*.bcolzs`` files and their metadata-only stats every
heartbeat, liveness WRMs from a second thread on sockets of its own,
Busy/Done around each work item, and the reply envelope of the reference
worker.  All query device work runs on the node's loop thread; the
startup warmup (:meth:`WorkerNode.warmup`, ``BQUERYD_TPU_WARMUP``, default
on) builds or loads the kernels, launches one and measures the dispatch
floor on a thread of its own, so that the node registers at once.
``SIGUSR1`` writes the node's debug snapshot as a JSON bundle under
``BQUERYD_TPU_DEBUG_DIR``.

Routing is decided before any device call and is never a fallback: a
device error is not caught on the query path; inside a node it becomes an
``ErrorMessage`` for the controller, never a retry on the host or on a
plain version.  A calc worker advertises its device-health latch
(``backend_wedged``) and its calibration cells (``calibration``,
:mod:`bqueryd_tpu_torch.plan.calibrate`) in every WRM.

Every node keeps a metrics registry and a flight ring (:mod:`obs`): each
accepted envelope, its outcome and each rollup build are recorded, and the
ring's tail with the device-health snapshot rides the WRM (``debug``) as
the node's slice of the controller's debug bundle.  The WRM also carries
the health signals the controller's scorer reads: ``work_errors`` and the
snapshot of the ``bqueryd_tpu_worker_groupby_seconds`` histogram
(``metrics``), observed once per groupby CalcMessage.  While the hot path
is on, the loop's wall is partitioned into :data:`LOOP_PARTS`
(``bqueryd_tpu_worker_loop_seconds_total{part}``), and a calc's timeline
opens with a ``worker_receive`` span from the frames' receipt to the calc
root (tagged ``loop_wait_s``, the poll wait since the previous work item
arrived).

Every role answers ``sleep`` and ``readfile`` (a file inside its data
dir); the calc worker also answers ``execute_code`` when
``BQUERYD_TPU_ENABLE_EXECUTE_CODE=1``.  :class:`DownloaderNode` and
:class:`MoveBcolzNode` are the distribution pipeline's roles
(:mod:`bqueryd_tpu_torch.download`): they fetch a ticket's blobs on a
thread pool and activate them, and resolve no device.

Resilience (:mod:`bqueryd_tpu_torch.chaos`): a work item that raises a
:class:`~bqueryd_tpu_torch.chaos.TransientError` replies an ErrorMessage
flagged ``transient``, which the controller fails over to another holder.
The ``worker.execute`` fault site (``raise``, ``delay``, ``wedge``,
``die_after_ack``) fires before each work item and ``worker.reply``
(``drop``, ``delay``) before its reply; a ``wedge`` latches this node
alone (``_chaos_wedged``: advertised as ``backend_wedged``, every later
groupby raises ``DeviceBusyError``), never the process-global device
latch.  With ``restart_check`` on, a memory watchdog after each work item
sheds the caches once RSS passes ``memory_limit_mb`` and stops the node
when that was not enough.
"""

import contextlib
import importlib
import logging
import os
import signal
import socket as socket_mod
import threading
import time
import traceback

import zmq

import bqueryd_tpu_torch
from bqueryd_tpu_torch import chaos, messages, obs
from bqueryd_tpu_torch.coordination import chaos_store, coordination_store
from bqueryd_tpu_torch.messages import (
    BusyMessage,
    DoneMessage,
    ErrorMessage,
    StopMessage,
    TicketDoneMessage,
    WorkerRegisterMessage,
    msg_factory,
)
from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge, pipeline
from bqueryd_tpu_torch.utils import devicehealth
from bqueryd_tpu_torch.utils.net import get_my_ip
from bqueryd_tpu_torch.utils.tracing import PhaseTimer

#: calc phase -> span name: the reference's mapping, and no span for the
#: port's own ``execute`` and ``delta`` phases (the phases inside them
#: are spans; the rest of their wall is the calc root's)
CALC_SPAN_NAMES = {**obs.PHASE_SPAN_NAMES, "execute": None, "delta": None}

#: what :meth:`WorkerBase._run_work` returns after a die_after_ack fault
_DIED = object()

#: the parts of the worker loop's wall
#: (``bqueryd_tpu_worker_loop_seconds_total{part}``): the poll; the frames'
#: receipt through decode, Busy, the fault and deadline checks; the work
#: item (``handle_work``); its reply, Done and the memory watchdog;
#: ``heartbeat`` (controllers, data files, the WRM)
LOOP_PARTS = ("wait", "receive", "work", "reply", "heartbeat")

DEFAULT_HEARTBEAT_INTERVAL = 20.0   # WRM re-broadcast / rescan period
DEFAULT_POLL_TIMEOUT = 1.0          # seconds per zmq poll tick
DEFAULT_MEMORY_LIMIT_MB = 2048      # RSS past which the watchdog acts
DOWNLOAD_DELAY = 5.0                # downloader ticket poll period
SHARD_EXTENSIONS = (".bcolz", ".bcolzs")


def execute(tables, query, engine, executor=None, strategy=None,
            report=None, timer=None):
    """Run ``query`` over ``tables``; always returns ONE payload.

    ``executor`` serves the mergeable aggregations when given; ``engine``
    the rest.  ``report``, a dict when given, receives the reply envelope
    keys of the reference worker: ``effective_strategy`` (the kernel
    route, "host" for the host route) and ``merge_mode`` ("device" for the
    executor, "host" for the per-shard host merge, "none" for one shard's
    payload), and, only when the filter ran through chunk pruning,
    ``chunk_prune``: ``(chunks_decoded, chunks_skipped)`` over all shards.
    ``timer``, a :class:`PhaseTimer` when given, times the ``prune``
    phase and the executor's phases.

    The executor runs only when the group's rows exceed
    ``host_kernel_rows`` at the worst shard's host cost
    (``_host_ns_estimate``), the hint is not ``"host"`` and the device is
    not wedged; otherwise the engine routes each shard itself."""
    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.models.query import (
        _host_ns_estimate,
        host_kernel_rows,
    )
    from bqueryd_tpu_torch.ops import predicates

    if report is None:
        report = {}
    report["effective_strategy"] = report["merge_mode"] = None
    report.pop("chunk_prune", None)
    if (query.where_terms and not query.expand_filter_column
            and predicates.chunk_prune_enabled()):
        with timer.phase("prune") if timer else contextlib.nullcontext():
            pruned = [predicates.chunk_pruned_table(t, query.where_terms)
                      for t in tables]
        decoded = sum(p[1] for p in pruned)
        skipped = sum(p[2] for p in pruned)
        if decoded or skipped:
            tables = [p[0] for p in pruned]
            report["chunk_prune"] = (decoded, skipped)
    total_rows = sum(int(t.nrows) for t in tables)
    if (executor is not None and strategy != "host"
            and executor.supports(query)
            and not devicehealth.backend_wedged()
            and total_rows > host_kernel_rows(max(
                (_host_ns_estimate(t, query.agg_list, total_rows)
                 for t in tables), default=None))):
        # the executor's phases (and their spans) time into ``timer``
        executor.timer = timer
        try:
            result = executor.execute(tables, query, strategy=strategy)
        except ops.CompositeOverflow:
            bqueryd_tpu_torch.logger.info(
                "composite key space exceeds int64; serving via the "
                "per-shard engine path"
            )
        else:
            report["effective_strategy"] = executor.last_effective_strategy
            report["merge_mode"] = executor.last_merge_mode
            return result
        finally:
            executor.timer = None
    if len(tables) == 1:
        result = engine.execute_local(tables[0], query, strategy=strategy)
        report["effective_strategy"] = engine.last_effective_strategy
        report["merge_mode"] = "none"
        return result
    pipeline.map_ordered(_host_stage(engine, query), tables)
    payloads = [
        engine.execute_local(t, query, strategy=strategy) for t in tables
    ]
    report["effective_strategy"] = engine.last_effective_strategy
    report["merge_mode"] = "host"
    return ResultPayload(hostmerge.merge_payloads(payloads))


def _fold_prune(report, prune_counts):
    """Fold a DAG run's per-shard (decoded, skipped) chunk counts into
    ``report["chunk_prune"]`` when any chunk was looked at."""
    decoded = sum(c[0] for c in prune_counts)
    skipped = sum(c[1] for c in prune_counts)
    if decoded or skipped:
        report["chunk_prune"] = (decoded, skipped)


def _host_stage(engine, query):
    """One shard's host work for ``query``: the factorize of its key
    columns, of its count_distinct value columns and of its basket column,
    and its column decodes, left in the engine's and the storage's caches
    for :meth:`QueryEngine.execute_local` (decodes only where the table
    keeps them in the decoded-column cache).  A shard the filter's stats
    rule out is skipped, as ``execute_local`` skips it."""
    from bqueryd_tpu_torch import ops

    columns = list(dict.fromkeys(
        list(query.in_cols) + [term[0] for term in query.where_terms or []]
    ))
    factorized = list(dict.fromkeys(
        list(query.groupby_cols)
        + [c for c, op in zip(query.in_cols, query.ops)
           if op == "count_distinct"]
    ))

    def run(table):
        if query.where_terms and not ops.shard_can_match(
            table, query.where_terms
        ):
            return
        for col in factorized:
            engine._key_codes(table, col)
        if query.expand_filter_column:
            engine._basket_codes(table, query.expand_filter_column)
        if table.auto_cache:
            for col in columns:
                table.column_raw(col)

    return run


class WorkerBase:
    """The event loop of a worker node: discovery, registration, liveness
    and the Busy/Done envelope around each work item.

    ``restart_check`` turns on the memory watchdog (off by default: a node
    that shares its process with others, as in-process clusters do, would
    read their memory as its own); ``memory_limit_mb`` is its limit."""

    workertype = "worker"
    #: the chaos wedge latch (the ``worker.execute`` site's ``wedge``):
    #: advertised in WRMs like the device-health latch, and every later
    #: groupby on this node raises the transient DeviceBusyError.  A class
    #: default, so that a node built piecemeal still answers prepare_wrm
    _chaos_wedged = False
    #: the work item on the loop: ``(wall, perf_counter)`` of its frames'
    #: receipt and the poll wait before it, for its ``worker_receive`` span
    _receipt = None

    def __init__(
        self,
        coordination_url=None,
        data_dir=None,
        loglevel=None,
        heartbeat_interval=DEFAULT_HEARTBEAT_INTERVAL,
        poll_timeout=DEFAULT_POLL_TIMEOUT,
        restart_check=False,
        memory_limit_mb=DEFAULT_MEMORY_LIMIT_MB,
    ):
        bqueryd_tpu_torch.configure_logging(loglevel or logging.INFO)
        self.worker_id = os.urandom(8).hex()
        self.logger = bqueryd_tpu_torch.logger.getChild(
            f"{self.workertype}.{self.worker_id[:6]}"
        )
        self.node_name = socket_mod.gethostname()
        # fault injection: armed only when BQUERYD_TPU_FAULT_PLAN is set;
        # the store is wrapped so that the coordination.store site can
        # partition THIS node from the store while its sockets stay up
        chaos.maybe_arm_from_env()
        self.store = chaos_store(
            coordination_store(
                coordination_url or bqueryd_tpu_torch.DEFAULT_COORDINATION_URL
            ),
            node_id=self.worker_id,
        )
        self.data_dir = data_dir or bqueryd_tpu_torch.DEFAULT_DATA_DIR
        if self.workertype == "calc" and not os.path.isdir(self.data_dir):
            raise ValueError(f"Datadir {self.data_dir} is not a valid directory")
        self.heartbeat_interval = heartbeat_interval
        self.poll_timeout = poll_timeout
        self.restart_check = restart_check
        self.memory_limit_mb = memory_limit_mb

        self.context = zmq.Context.instance()
        self.socket = self.context.socket(zmq.ROUTER)
        self.socket.identity = self.worker_id.encode()
        self.socket.setsockopt(zmq.LINGER, 500)
        self.poller = zmq.Poller()
        self.poller.register(self.socket, zmq.POLLIN)

        self.controllers = set()     # connected controller addresses
        self.data_files = []
        self.running = False
        self.start_time = time.time()
        self._loop_started = self.start_time  # reset in go()
        self.msg_count = 0
        self.last_heartbeat = 0.0
        self._hb_thread = None
        self._hb_stop = threading.Event()
        self._loop_thread = None

        # observability: a registry and a flight ring per node (nodes of
        # one process must not mix); the ring's tail rides the WRM
        self.metrics = obs.MetricsRegistry()
        self.metrics.gauge(
            "bqueryd_tpu_worker_rss_bytes",
            "resident set size of this worker process",
            fn=self._rss_bytes,
        )
        self.metrics.gauge(
            "bqueryd_tpu_fault_injected_total",
            "faults injected by the armed chaos plan, process-lifetime "
            "(0 while BQUERYD_TPU_FAULT_PLAN is unarmed)",
            fn=chaos.injected_total,
        )
        self.metrics.gauge(
            "bqueryd_tpu_worker_uptime_seconds",
            "seconds since this worker process started",
            fn=lambda: time.time() - self.start_time,
        )
        self.work_errors = self.metrics.counter(
            "bqueryd_tpu_worker_errors_total",
            "work items that raised (returned as ErrorMessage)",
        )
        self.loop_clock = obs.LoopClock(
            self.metrics, "bqueryd_tpu_worker_loop_seconds_total",
            "seconds of the worker loop's wall per part (wait, receive, "
            "work, reply, heartbeat); they sum to the loop's wall",
            LOOP_PARTS)
        #: poll wait since the last work item's receipt
        self._wait_s = 0.0
        self.flight = obs.FlightRecorder(node_id=self.worker_id)
        self.metrics.gauge(
            "bqueryd_tpu_flight_evictions",
            "flight-ring events evicted by the entry/byte bounds (monotonic)",
            fn=lambda: self.flight.evictions,
        )
        # /metrics and /healthz under BQUERYD_TPU_METRICS_PORT (the CLI's
        # --metrics_port), this node's registry
        from bqueryd_tpu_torch.obs import http as obs_http

        self._metrics_server = obs_http.maybe_start(self.metrics,
                                                    self.logger)

    # -- lifecycle ---------------------------------------------------------
    def go(self):
        self.running = True
        self._loop_thread = threading.current_thread()
        try:
            signal.signal(signal.SIGTERM, self._term_signal)
            if hasattr(signal, "SIGUSR1"):
                # local forensic dump: kill -USR1 <pid> writes this node's
                # debug snapshot as one JSON file, no controller needed
                signal.signal(signal.SIGUSR1, self._dump_debug_signal)
        except ValueError:
            pass  # not the main thread (in-process clusters)
        self.logger.info("starting %s worker %s", self.workertype,
                         self.worker_id)
        self._loop_started = time.time()
        self._start_heartbeat_thread()
        while self.running:
            try:
                self._loop_enter("heartbeat")
                self.heartbeat()
                self._loop_enter("wait")
                events = dict(self.poller.poll(int(self.poll_timeout * 1000)))
                if self.socket in events:
                    self._loop_enter("receive")
                    self.handle_in()
            except zmq.ZMQError:
                self.logger.exception("zmq error in worker loop")
                time.sleep(0.2)
            except Exception:
                self.logger.exception("error in worker loop")
        self._loop_enter("heartbeat")  # the last part's seconds
        self.stop()

    def _loop_enter(self, part):
        """The loop leaves its current part for ``part``
        (:class:`obs.LoopClock`), summing the poll's waits."""
        left, elapsed = self.loop_clock.enter(part, on=obs.enabled())
        if left == "wait":
            self._wait_s += elapsed

    def _term_signal(self, *args):
        self.logger.info("SIGTERM received, stopping")
        self.running = False

    def _dump_debug_signal(self, *args):
        """SIGUSR1: write this node's debug snapshot as a one-worker debug
        bundle (:func:`obs.flightrec.build_bundle`, with the controller's
        path redaction: only the data dir and the kernel build directory
        stay readable) under ``BQUERYD_TPU_DEBUG_DIR``."""
        from bqueryd_tpu_torch.obs import flightrec, profile

        try:
            allowed = [self.data_dir]
            cache_path = profile.compile_cache_info().get("path")
            if cache_path:
                allowed.append(cache_path)
            path = flightrec.dump_bundle(
                flightrec.build_bundle(
                    None,
                    {self.worker_id: {
                        "data": self._debug_snapshot(flight_limit=512),
                        "ts": time.time(),
                        "registered": True,
                    }},
                    allowed_path_prefixes=allowed,
                ),
                role=self.workertype,
            )
            self.logger.warning("SIGUSR1: debug snapshot written to %s",
                                path)
        except Exception:
            self.logger.exception("SIGUSR1 debug dump failed")

    def _request_stop_only(self):
        """Flag the loop (and the heartbeat thread) to exit.  True when the
        caller is not the loop thread of a live loop: zmq sockets belong to
        one thread, so the loop thread tears its sockets down itself when
        it leaves ``go``."""
        self.running = False
        self._hb_stop.set()
        loop = self._loop_thread
        external = (loop is not None and loop.is_alive()
                    and threading.current_thread() is not loop)
        if (not external and self._hb_thread is not None
                and self._hb_thread.ident is not None):
            self._hb_thread.join(timeout=2.0)
        return external

    def stop(self):
        """Stop the node.  From another thread this only flags the loop
        (:meth:`_request_stop_only`)."""
        if self._request_stop_only():
            return
        server = getattr(self, "_metrics_server", None)
        if server is not None:
            server.close()
            self._metrics_server = None
        for addr in list(self.controllers):
            try:
                self.send(addr, StopMessage({"worker_id": self.worker_id}))
            except zmq.ZMQError:
                pass
        if not self.socket.closed:
            self.socket.close()
            self.logger.info("worker %s stopped", self.worker_id)

    # -- liveness side-channel --------------------------------------------
    def _start_heartbeat_thread(self):
        """Send WRMs from a thread of their own, so that a long
        ``handle_work`` (a first kernel build, a cold 10M-row query)
        cannot starve liveness and get this busy worker culled."""
        self._hb_stop.clear()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop,
            name=f"hb-{self.worker_id[:6]}",
            daemon=True,
        )
        self._hb_thread.start()

    def _heartbeat_loop(self):
        # one DEALER per controller, owned by this thread (zmq sockets
        # belong to one thread), with the identity "<worker_id>.hb" so it
        # is never addressed as the worker; the controller keys liveness
        # on the worker_id inside the WRM.  A DEALER connected to several
        # peers would round-robin, so each connects to exactly one.
        socks = {}  # controller address -> DEALER connected only to it
        try:
            while not self._hb_stop.is_set() and self.running:
                try:
                    current = self.store.smembers(
                        bqueryd_tpu_torch.REDIS_SET_KEY
                    )
                    for addr in current - socks.keys():
                        sock = self.context.socket(zmq.DEALER)
                        sock.identity = (self.worker_id + ".hb").encode()
                        sock.setsockopt(zmq.LINGER, 0)
                        try:
                            sock.connect(addr)
                        except zmq.ZMQError:
                            sock.close()
                            continue
                        socks[addr] = sock
                    for addr in socks.keys() - current:
                        socks.pop(addr).close()
                    wrm = self.prepare_wrm()
                    wrm["liveness_only"] = True  # files rescanned on the loop
                    payload = wrm.to_json().encode()
                    for sock in socks.values():
                        try:
                            sock.send_multipart([payload], zmq.NOBLOCK)
                        except zmq.ZMQError:
                            pass
                except Exception:
                    self.logger.debug("heartbeat thread tick failed",
                                      exc_info=True)
                # well inside the controller's dead-worker timeout
                self._hb_stop.wait(min(self.heartbeat_interval, 10.0))
        finally:
            for sock in socks.values():
                sock.close()

    # -- discovery / registration -----------------------------------------
    def check_controllers(self):
        """Connect the ROUTER socket to every controller in the store and
        drop those that left it."""
        current = self.store.smembers(bqueryd_tpu_torch.REDIS_SET_KEY)
        for addr in current - self.controllers:
            self.logger.debug("connecting to controller %s", addr)
            self.socket.connect(addr)
            self.controllers.add(addr)
        for addr in self.controllers - current:
            self.logger.debug("dropping dead controller %s", addr)
            try:
                self.socket.disconnect(addr)
            except zmq.ZMQError:
                pass
            self.controllers.discard(addr)

    def check_datafiles(self):
        found = []
        if os.path.isdir(self.data_dir):
            for name in sorted(os.listdir(self.data_dir)):
                if name.endswith(SHARD_EXTENSIONS) and os.path.isdir(
                    os.path.join(self.data_dir, name)
                ):
                    found.append(name)
        self.data_files = found
        return found

    def shard_stats(self):
        """Per-shard planning stats advertised in the WRM, or None for a
        role without tables; the calc worker overrides it."""
        return None

    #: re-advertise unchanged shard stats at most this often: WRMs go out
    #: every heartbeat on two threads, and stats of every shard and column
    #: in each would make liveness cost grow with the data; the periodic
    #: re-send covers a controller restart, which loses absorbed stats
    STATS_READVERTISE_S = 60.0

    def _stats_to_advertise(self):
        """The shard stats for this WRM, or None when the receiver already
        has them (the same snapshot object, sent within the window).  In
        the first 10 s of the loop every WRM carries them: a WRM sent
        before the sockets connect is lost, and with it an advertisement
        that would otherwise wait a whole window."""
        stats = self.shard_stats()
        if stats is None:
            return None
        now = time.time()
        if (now - self._loop_started >= 10.0
                and stats is getattr(self, "_stats_sent_obj", None)
                and now - getattr(self, "_stats_sent_ts", 0.0)
                < self.STATS_READVERTISE_S):
            return None
        self._stats_sent_obj = stats
        self._stats_sent_ts = now
        return stats

    def _backend_wedged(self):
        """The device-health latch this node advertises.  A calc worker
        owns the device, so its heartbeat ticks the probe clock too: an
        idle wedged worker recovers without waiting for a query.  Other
        roles only read the latch.  A chaos ``wedge`` latches this node's
        advertisement alone (the process-global latch stays as it is)."""
        if self._chaos_wedged:
            return True
        return devicehealth.backend_wedged(launch=self.workertype == "calc")

    def _calibration_to_advertise(self):
        """The WRM calibration summary, or None (another role, calibration
        off, or nothing measured yet); a failure never breaks liveness."""
        if self.workertype != "calc":
            return None
        try:
            from bqueryd_tpu_torch.plan import calibrate

            return calibrate.summary_for_wire()
        except Exception:
            return None

    def _debug_snapshot(self, flight_limit=32):
        """This node's slice of a debug bundle: the flight ring's tail, the
        call and build registry of :mod:`obs.profile` (``compile``), the
        device-health snapshot, the runtime versions and the kernel build
        directory (``compile_cache``), and the device memory.  It rides the
        WRM (small: the tail and the registry are capped), so that the
        controller holds a slice even of a worker that has since died."""
        from bqueryd_tpu_torch.obs import profile

        prof = profile.profiler()
        return {
            "node_id": self.worker_id,
            "workertype": self.workertype,
            "pid": os.getpid(),
            "flight": self.flight.tail(flight_limit),
            "flight_evictions": self.flight.evictions,
            "compile": prof.snapshot(),
            "device_health": devicehealth.health_snapshot(),
            "device_memory": prof.device_memory(),
            "runtime": profile.runtime_versions(),
            "compile_cache": profile.compile_cache_info(),
        }

    #: re-send an unchanged debug slice at most this often (a restarted
    #: controller has lost the slices it absorbed)
    DEBUG_READVERTISE_S = 60.0

    def _debug_change_key(self):
        """What the slice depends on: the flight ring's sequence, the
        profiler's call sequence and build counters, and the wedge
        generation."""
        from bqueryd_tpu_torch.obs import profile

        prof = profile.profiler()
        return (self.flight.seq, prof._call_seq, prof.library_loads,
                prof.persistent_cache_hits, prof.persistent_cache_misses,
                devicehealth.health_snapshot()["wedge_generation"])

    def _debug_to_advertise(self):
        """The debug slice for this WRM, or None when it is unchanged since
        the last one sent, within the re-send window."""
        key = self._debug_change_key()
        now = time.time()
        if (key == getattr(self, "_debug_sent_key", None)
                and now - getattr(self, "_debug_sent_ts", 0.0)
                < self.DEBUG_READVERTISE_S):
            return None
        snapshot = self._debug_snapshot()
        self._debug_sent_key = key
        self._debug_sent_ts = now
        return snapshot

    def _pipeline_busy_to_advertise(self):
        """The stage clocks' busy snapshot for a calc WRM (cumulative
        seconds per stage, ``parallel.pipeline.clock``): the capacity
        model names each worker's bottleneck stage from its deltas.  None
        for the other roles, and on any failure."""
        if self.workertype != "calc":
            return None
        try:
            return pipeline.clock().snapshot()
        except Exception:
            return None

    def prepare_wrm(self):
        # getattr: a node built piecemeal (``__new__``) must still answer
        registry = getattr(self, "metrics", None)
        errors = getattr(self, "work_errors", None)
        try:
            debug = self._debug_to_advertise()
        except Exception:
            debug = None  # a debug failure must never break liveness
        return WorkerRegisterMessage(
            {
                "worker_id": self.worker_id,
                "node": self.node_name,
                "ip": get_my_ip(),
                "data_dir": self.data_dir,
                "data_files": self.data_files,
                "workertype": self.workertype,
                "pid": os.getpid(),
                "uptime": time.time() - self.start_time,
                "msg_count": self.msg_count,
                # the device-health latch, for rpc.info() and the
                # controller's health scorer ("wedged")
                "backend_wedged": self._backend_wedged(),
                # the error counter's total: the scorer's windowed error
                # rate is its delta across heartbeats
                "work_errors": errors.value if errors is not None else 0,
                # the histogram snapshot (the groupby latency family the
                # scorer reads)
                "metrics": (registry.histogram_snapshot()
                            if registry is not None else None),
                # metadata-only per-shard stats (rows, min/max,
                # cardinality) for the controller's plan-time pruning and
                # strategy hints; None when unchanged stats went out
                # recently
                "shard_stats": self._stats_to_advertise(),
                # the measured kernel-wall cells (plan.calibrate) the
                # controller's select_calibrated consults
                "calibration": self._calibration_to_advertise(),
                # the node's slice of the controller's debug bundle
                "debug": debug,
                # the stage clocks the capacity model reads
                "pipeline_busy": self._pipeline_busy_to_advertise(),
            }
        )

    def heartbeat(self):
        now = time.time()
        interval = self.heartbeat_interval
        # fast start: a WRM sent before the ROUTER handshake settles is
        # dropped, so re-send every second for the first 10 s
        if now - self._loop_started < 10.0:
            interval = min(interval, 1.0)
        if now - self.last_heartbeat < interval:
            return
        self.last_heartbeat = now
        self.check_controllers()
        self.check_datafiles()
        self.send_to_all(self.prepare_wrm())

    # -- messaging ---------------------------------------------------------
    def send(self, addr, msg):
        """Send to a controller by identity; a bytes ``data`` value
        travels as a frame of its own, so JSON never sees binary."""
        data = msg.pop("data", None)
        frames = [
            addr.encode() if isinstance(addr, str) else addr,
            msg.to_json().encode(),
        ]
        if data is not None:
            if isinstance(data, str):
                data = data.encode()
            frames.append(data)
        self.socket.send_multipart(frames)

    def send_to_all(self, msg):
        for addr in list(self.controllers):
            try:
                self.send(addr, msg.copy())
            except zmq.ZMQError as exc:
                self.logger.debug("send to %s failed: %s", addr, exc)

    def handle_in(self):
        frames = self.socket.recv_multipart()
        if len(frames) < 2:
            self.logger.warning("dropping short message: %r", frames)
            return
        sender, payload = frames[0], frames[1]
        self.msg_count += 1
        try:
            msg = msg_factory(payload)
        except messages.MalformedMessage:
            self.logger.warning("dropping malformed message from %r", sender)
            return
        if msg.isa(StopMessage) or msg.isa("kill"):
            self.running = False
            return
        if msg.isa("loglevel"):
            args, _ = msg.get_args_kwargs()
            level = {"debug": logging.DEBUG, "info": logging.INFO}.get(
                args[0] if args else "info", logging.INFO
            )
            bqueryd_tpu_torch.logger.setLevel(level)
            return
        if msg.isa("info"):
            self.send(sender, self.prepare_wrm())
            return
        self.handle(msg, sender)

    # -- work --------------------------------------------------------------
    def handle(self, msg, sender):
        """Busy, the work, the reply (an ``ErrorMessage`` with the
        traceback when it raised, flagged ``transient`` for a
        :class:`~bqueryd_tpu_torch.chaos.TransientError`), Done, then the
        memory watchdog."""
        clock = self.loop_clock.since
        if clock is not None and obs.enabled():
            self._receipt = (time.time() - (time.perf_counter() - clock),
                             clock, self._wait_s)
        self._wait_s = 0.0
        self.send_to_all(BusyMessage({"worker_id": self.worker_id}))
        wire = msg.get_trace()
        log_fields = {
            "trace_id": (wire or {}).get("trace_id"),
            "query_id": msg.get("parent_token") or msg.get("token"),
        }
        # every accepted envelope (hot path: under the kill switch; a
        # failure below is recorded regardless)
        if obs.enabled():
            self.flight.record(
                "envelope",
                verb=msg.get("payload"),
                token=msg.get("token"),
                parent=msg.get("parent_token"),
                trace_id=log_fields["trace_id"],
            )
        work_clock = time.perf_counter()
        # the correlation ids on every log line of this work (the JSON
        # formatter) and the trace context the profiler ranges carry; the
        # failure's traceback is logged inside both
        with obs.bind_log_context(**log_fields), obs.use_trace(
            obs.TraceContext.from_wire(wire)
        ):
            try:
                result = self._run_work(msg, log_fields, work_clock)
            finally:
                self._receipt = None
        if result is _DIED:
            return  # a hard crash: no reply, no Done, no goodbye
        self._reply(msg, sender, result)

    def _run_work(self, msg, log_fields, work_clock):
        """The work item under the fault site and the deadline check: its
        reply, an ``ErrorMessage`` when it raised, or ``_DIED`` after a
        ``die_after_ack`` fault."""
        try:
            # the worker.execute fault site: a transient raise (the
            # failover trigger), the wedge latch, die-after-ack (the Busy
            # above was the ack) and delay, all before the deadline check
            # so that an injected stall expires a deadline as a real one
            fault = chaos.fire(
                "worker.execute",
                worker=self.worker_id,
                verb=msg.get("payload"),
                token=msg.get("token"),
                filename=str(msg.get("filename")),
            ) if chaos.enabled() else None
            if fault is not None and fault.action == "die_after_ack":
                self._chaos_die()
                return _DIED
            if fault is not None and fault.action == "wedge":
                self._chaos_wedged = True
                self.flight.record("chaos_wedged")
                self.logger.warning(
                    "chaos: wedge latched, advertising backend_wedged")
            if self._chaos_wedged and msg.isa("groupby"):
                raise chaos.DeviceBusyError("chaos: device backend wedged")
            if msg.deadline_expired():
                # nobody waits for this answer any more
                raise TimeoutError(
                    f"deadline exceeded {-msg.deadline_remaining():.3f}s "
                    "before execution"
                )
            self._loop_enter("work")
            result = self.handle_work(msg)
        except Exception as exc:
            self.logger.exception("error handling work")
            self.work_errors.inc()
            # forensic event, never gated: the failure's first line
            self.flight.record(
                "work_error",
                verb=msg.get("payload"),
                token=msg.get("token"),
                trace_id=log_fields["trace_id"],
                error=f"{type(exc).__name__}: {exc}"[:300],
            )
            result = ErrorMessage(msg)
            result["payload"] = traceback.format_exc()
            if isinstance(exc, chaos.TransientError):
                # the retryable class: the controller fails the shard over
                # to another holder instead of aborting its query
                result["transient"] = True
            self._loop_enter("reply")
        else:
            self._loop_enter("reply")
            if obs.enabled():
                self.flight.record(
                    "work_done",
                    verb=msg.get("payload"),
                    token=msg.get("token"),
                    trace_id=log_fields["trace_id"],
                    wall_s=round(time.perf_counter() - work_clock, 6),
                )
        return result

    def _reply(self, msg, sender, result):
        """Send a work item's result (through the ``worker.reply`` fault
        site), then Done and the memory watchdog."""
        if result is not None:
            # the worker.reply fault site: drop loses the finished result
            # on the wire (the dispatch timeout and the failover recover
            # it), delay stretches the reply
            fault = chaos.fire(
                "worker.reply",
                worker=self.worker_id,
                verb=msg.get("payload"),
                token=msg.get("token"),
            ) if chaos.enabled() else None
            if fault is not None and fault.action == "drop":
                self.flight.record("chaos_reply_dropped",
                                   token=msg.get("token"))
                result = None
        if result is not None:
            try:
                self.send(sender, result)
            except zmq.ZMQError:
                self.logger.exception("could not send result to %r", sender)
        self.send_to_all(DoneMessage({"worker_id": self.worker_id}))
        self._check_mem()

    def _chaos_die(self):
        """die_after_ack: a hard crash after the work was accepted.  No
        reply, no Done, no StopMessage, and the heartbeat thread stops too
        (``_hb_stop``), or it would keep a dead node alive; the controller
        recovers through its dispatch timeout, the dead-worker cull and the
        failover.  The loop thread still closes its own sockets on exit."""
        self.logger.warning("chaos: die_after_ack, simulating a hard crash")
        self.flight.record("chaos_die_after_ack")
        self._hb_stop.set()
        self.send = lambda *a, **k: None  # silent from now on
        self.running = False

    # -- memory watchdog ---------------------------------------------------
    @staticmethod
    def _rss_bytes():
        """Resident set size of this process: psutil when it is installed,
        else ``/proc/self/statm`` (resident pages times the page size)."""
        try:
            import psutil
        except ImportError:
            with open("/proc/self/statm") as f:
                resident_pages = int(f.read().split()[1])
            return resident_pages * os.sysconf("SC_PAGE_SIZE")
        return psutil.Process(os.getpid()).memory_info().rss

    def _check_mem(self):
        """Past ``memory_limit_mb``, shed the caches; if that is not enough
        (or the RSS after it cannot be read), stop the loop so that a
        supervisor restarts the process."""
        if not self.restart_check:
            return
        try:
            rss_mb = self._rss_bytes() / 1e6
        except Exception:
            return
        if rss_mb <= self.memory_limit_mb:
            return
        shed_mb = self._shed_caches()
        if shed_mb is not None and shed_mb <= self.memory_limit_mb:
            return
        self.logger.warning(
            "RSS %s MB above limit %d MB, stopping for supervisor restart",
            "?" if shed_mb is None else f"{shed_mb:.0f}",
            self.memory_limit_mb,
        )
        self.running = False

    def _shed_caches(self):
        """Drop the query caches (decoded columns, the executor's working
        set, the engine's factorizations, the open tables, the result and
        delta caches) and collect; returns the RSS after it in MB, or None
        when it cannot be read."""
        import gc

        from bqueryd_tpu_torch.storage import free_cachemem

        free_cachemem()
        clear = getattr(self, "clear_caches", None)
        if clear is not None:
            clear()
        getattr(self, "_table_cache", {}).clear()
        gc.collect()
        try:
            return self._rss_bytes() / 1e6
        except Exception:
            return None

    def handle_work(self, msg):
        """The verbs every role answers: ``readfile`` and ``sleep``."""
        if msg.isa("readfile"):
            return self._readfile(msg)
        if msg.isa("sleep"):
            args, _ = msg.get_args_kwargs()
            duration = float(args[0]) if args else 0.0
            time.sleep(min(duration, 60.0))
            reply = msg.copy()
            reply.add_as_binary("result", f"slept {duration} {self.worker_id}")
            return reply
        raise ValueError(f"unhandled message payload {msg.get('payload')!r}")

    def _readfile(self, msg):
        """The bytes of a file strictly inside ``data_dir``: a path that
        resolves outside it raises."""
        args, _ = msg.get_args_kwargs()
        filename = args[0]
        path = os.path.realpath(os.path.join(self.data_dir, filename))
        if not path.startswith(os.path.realpath(self.data_dir) + os.sep):
            raise ValueError(f"path {filename!r} escapes data_dir")
        with open(path, "rb") as f:
            reply = msg.copy()
            reply["data"] = f.read()
            return reply


class WorkerNode(WorkerBase):
    """The calc worker: answers ``groupby`` CalcMessages (plain ones and
    the operator DAGs of the ``query`` verb), ``append`` and ``rollup``
    ones, on its own engine and executor, in the reference worker's order:
    the DAG layer, the result cache, the delta cache, then :func:`execute`
    (a plain DAG) or :meth:`_execute_dag` (an extended one: the fast path,
    else :class:`~bqueryd_tpu_torch.parallel.opexec.DagExecutor`).

    ``device`` is resolved when the node is built: ``cuda`` unless
    ``device="cpu"`` is passed; without a card it raises before any socket
    is opened or anything registered.  The executor runs over
    ``n_devices`` of them (``parallel.executor.resolve_devices``): by
    default every visible card (``CUDA_VISIBLE_DEVICES`` limits it), as
    the reference's mesh takes every local chip, and one device on the
    CPU.  With ``BQUERYD_TPU_DIST_*`` set the node first joins its
    multi-process job (``ops.maybe_init_distributed``) and then runs on
    its rank's own cards.  The node registers the executor's devices with
    the health probe and the memory profile."""

    workertype = "calc"

    def __init__(self, *args, device=None, n_devices=None, **kw):
        from bqueryd_tpu_torch import ops, resolve_device
        from bqueryd_tpu_torch.models.query import QueryEngine
        from bqueryd_tpu_torch.parallel import devicemerge
        from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor

        device = resolve_device(device)
        super().__init__(*args, **kw)
        # join first: a rank's executor runs on that rank's cards
        ops.maybe_init_distributed(self.logger)
        self.executor = MeshQueryExecutor(device=device, n_devices=n_devices)
        self.engine = QueryEngine(device=self.executor.device)
        # the health probe covers each card; the memory profile reads each
        devicehealth.watch(self.executor.devices)
        if self.executor.device.type == "cuda":
            obs.profile.profiler().watch_devices(self.executor.devices)
        self._table_cache = {}   # pinned identity -> table instance
        self._realpaths = {}     # rootdir as named -> its realpath
        self._result_cache = None
        self._delta_cache = None
        self._stats_collector = None
        #: set once the background warmup (:meth:`warmup`) has ended, or at
        #: ``go`` when ``BQUERYD_TPU_WARMUP=0`` starts none
        self.warmup_done = threading.Event()
        self._warmup_thread = None
        # the device-health latch as gauges: read-only snapshots, a scrape
        # never launches a probe
        snap = devicehealth.health_snapshot
        self.metrics.gauge(
            "bqueryd_tpu_backend_wedged",
            "1 while the accelerator backend is latched as wedged",
            fn=lambda: snap()["wedged"],
        )
        self.metrics.gauge(
            "bqueryd_tpu_device_probes_abandoned",
            "health probes written off as hung since the last success",
            fn=lambda: snap()["abandoned_probes"],
        )
        # the latency family the controller's health scorer and capacity
        # model read from the WRM's histogram snapshot
        self.groupby_seconds = self.metrics.histogram(
            "bqueryd_tpu_worker_groupby_seconds",
            "whole-CalcMessage wall on the worker (open to serialize)",
        )
        self.groupby_queries = self.metrics.counter(
            "bqueryd_tpu_worker_groupby_total",
            "groupby CalcMessages executed by this worker",
        )
        # streaming ingest, chunk pruning and the delta cache
        self.appends_total = self.metrics.counter(
            "bqueryd_tpu_worker_appends_total",
            "append CalcMessages applied by this worker",
        )
        self.append_rows_total = self.metrics.counter(
            "bqueryd_tpu_worker_append_rows_total",
            "rows appended into served shards by this worker",
        )
        self.chunks_decoded_total = self.metrics.counter(
            "bqueryd_tpu_chunks_decoded_total",
            "storage chunks the zone-map pruning pass kept for decode on "
            "filtered queries (with chunks_skipped: the decode fraction)",
        )
        self.chunks_skipped_total = self.metrics.counter(
            "bqueryd_tpu_chunks_skipped_total",
            "storage chunks proven unmatchable by per-chunk zone maps and "
            "never decoded",
        )
        self.delta_refreshes_total = self.metrics.counter(
            "bqueryd_tpu_delta_refreshes_total",
            "cached aggregate results refreshed by aggregating only "
            "appended chunks and merging the delta partial "
            "(ops.workingset.DeltaAggCache)",
        )
        self.metrics.gauge(
            "bqueryd_tpu_delta_cache_bytes",
            "serialized payload bytes held by the delta-maintained "
            "aggregate cache",
            fn=lambda: (
                0 if self._delta_cache is None
                else self._delta_cache.nbytes
            ),
        )
        self.reply_bytes = self.metrics.histogram(
            "bqueryd_tpu_reply_bytes",
            "serialized groupby result-payload size per calc reply "
            "(the wire bytes the device-resident merge shrinks)",
            buckets=obs.BYTES_BUCKETS,
        )
        # the device merge's byte movement (parallel/devicemerge): D2H
        # bytes per merge mode and the per-device partial bytes the
        # span-owned merge kept out of the fetch; process-global
        for mode in (devicemerge.MODE_DEVICE, devicemerge.MODE_HOST):
            self.metrics.gauge(
                "bqueryd_tpu_merge_bytes_fetched",
                "D2H bytes fetched by the partial-table merge, per mode "
                "(device = final spans only; host = every device's table)",
                labels={"mode": mode},
                fn=(lambda m=mode: devicemerge.stats().fetched(m)),
            )
            self.metrics.gauge(
                "bqueryd_tpu_merge_queries",
                "executor queries merged per merge mode (monotonic)",
                labels={"mode": mode},
                fn=(lambda m=mode: devicemerge.stats().count(m)),
            )
        # the executor's uploads and fetches, while the hot path is on
        self.metrics.gauge(
            "bqueryd_tpu_h2d_bytes_total",
            "bytes the executor's uploads copied host -> device "
            "(monotonic; working-set hits copy none)",
            fn=lambda: self.executor.h2d_bytes,
        )
        self.metrics.gauge(
            "bqueryd_tpu_d2h_bytes_total",
            "bytes the executor's fetches copied device -> host "
            "(monotonic)",
            fn=lambda: self.executor.d2h_bytes,
        )
        self.metrics.gauge(
            "bqueryd_tpu_merge_d2h_bytes_saved",
            "per-device partial-table bytes the device-resident merge kept "
            "out of the D2H fetch (monotonic)",
            fn=lambda: devicemerge.stats().saved(),
        )
        # the process-global build, call and device-memory profile on this
        # node's registry
        obs.profile.profiler().bind(self.metrics)
        self._bind_pipeline_metrics()

    def _bind_pipeline_metrics(self):
        """Pipeline and working-set telemetry on this node's registry: the
        stage busy clocks (process-global: the worker owns the process's
        data path), the executor's working-set segment counters and the
        result cache's counters.  All read by functions, so a scrape
        reads live state: the hit, miss and eviction counts as plain ints
        under the GIL, a segment's bytes through one ``nbytes`` read,
        never a ``stats()`` snapshot that takes every cache lock against
        the hot path."""
        self.metrics.gauge(
            "bqueryd_tpu_pipeline_threads",
            "effective shard-pipeline pool width "
            "(BQUERYD_TPU_PIPELINE_THREADS)",
            fn=pipeline.pipeline_threads,
        )
        for stage_name in pipeline.STAGES:
            self.metrics.gauge(
                "bqueryd_tpu_pipeline_busy_seconds",
                "cumulative wall spent inside each pipeline stage across "
                "all threads (sum > query wall proves stage overlap)",
                labels={"stage": stage_name},
                fn=(lambda s=stage_name: pipeline.clock().busy_seconds(s)),
            )

        def ws_stat(segment, field):
            cache = self.executor.workingset.segment(segment)
            return cache.nbytes if field == "bytes" else getattr(cache, field)

        for segment in ("align", "codes", "blocks"):
            for field, help_text in (
                ("bytes", "bytes held per working-set cache segment"),
                ("hits", "working-set cache hits per segment (monotonic)"),
                ("misses",
                 "working-set cache misses per segment (monotonic)"),
                ("evictions",
                 "working-set LRU evictions per segment (monotonic)"),
            ):
                self.metrics.gauge(
                    f"bqueryd_tpu_workingset_{field}",
                    help_text,
                    labels={"segment": segment},
                    fn=(lambda s=segment, f=field: ws_stat(s, f)),
                )
        self.metrics.gauge(
            "bqueryd_tpu_workingset_pressure_evictions",
            "device cache entries shed by the HBM watermark policy "
            "(monotonic)",
            fn=lambda: self.executor.workingset.pressure_evictions,
        )

        def result_stat(field):
            cache = self._result_cache
            if cache is None or cache is False:  # unbuilt or disabled
                return 0
            return getattr(cache, field)

        for field, help_text in (
            ("hits", "worker result-cache hits (monotonic)"),
            ("misses", "worker result-cache misses (monotonic)"),
            ("evictions", "worker result-cache LRU evictions (monotonic)"),
        ):
            self.metrics.gauge(
                f"bqueryd_tpu_result_cache_{field}",
                help_text,
                fn=(lambda f=field: result_stat(f)),
            )

    def _count_chunk_prune(self, report):
        """Fold an execution's ``report["chunk_prune"]`` (decoded, skipped)
        into the chunk counters."""
        counts = report.get("chunk_prune")
        if counts:
            self.chunks_decoded_total.inc(counts[0])
            self.chunks_skipped_total.inc(counts[1])

    @property
    def device(self):
        return self.engine.device

    def _calc_timer(self, msg):
        """``(timer, recorder)`` of one calc message: while the hot path is
        on, a :class:`obs.SpanRecorder` whose ``calc`` root adopts the
        envelope's trace context (a child of the controller's dispatch
        span), fed by the timer's phases; on the loop, its
        ``worker_receive`` span first."""
        recorder = None
        if obs.enabled():
            ctx = obs.TraceContext.from_wire(msg.get_trace())
            now = time.perf_counter()
            recorder = obs.SpanRecorder(
                trace_id=ctx.trace_id if ctx else obs.new_id(16),
                node=self.worker_id,
                root_name="calc",
                root_parent=ctx.span_id if ctx else None,
            )
            receipt, self._receipt = self._receipt, None
            if receipt is not None:
                start_ts, clock, wait_s = receipt
                recorder.spans.append(obs.make_span(
                    recorder.trace_id, "worker_receive", start_ts,
                    now - clock, parent_span_id=ctx.span_id if ctx else None,
                    node=self.worker_id,
                    tags={"loop_wait_s": round(wait_s, 6)},
                ))
        return PhaseTimer(recorder=recorder, span_names=CALC_SPAN_NAMES), \
            recorder

    def _profiling(self):
        """A ``torch.profiler`` Chrome trace of the block into
        ``BQUERYD_TPU_PROFILE_DIR`` when it is set."""
        profile_dir = os.environ.get("BQUERYD_TPU_PROFILE_DIR")
        if not profile_dir:
            return contextlib.nullcontext()
        from bqueryd_tpu_torch.utils.tracing import profiler_trace

        return profiler_trace(profile_dir, device=self.device)

    def _finish_calc(self, reply, data, timer, recorder, mem_tags=None):
        """The observability tail of a groupby reply: its spans (device
        memory on the calc root), the latency histograms and the reply
        size."""
        self.groupby_queries.inc()
        self.groupby_seconds.observe(timer.total())
        if recorder is None:
            return
        reply["spans"] = recorder.export(tags=mem_tags)
        self.reply_bytes.observe(len(data))
        for phase, seconds in timer.timings.items():
            name = CALC_SPAN_NAMES.get(phase, phase)
            self.metrics.histogram(
                "bqueryd_tpu_query_phase_seconds",
                "per-phase worker latency (storage decode, H2D, "
                "kernel, merge, ...)",
                labels={"phase": name or phase},
            ).observe(seconds)

    @staticmethod
    def _memory_tags(before, after):
        """Device-memory attribution of one query for its calc root span:
        the process's watermark, and what this query raised it by and added
        to live memory."""
        if after is None:
            return None
        before = before or after
        return {
            "device_hbm_watermark_bytes": after["peak_bytes_in_use"],
            "device_peak_delta_bytes": (after["peak_bytes_in_use"]
                                        - before["peak_bytes_in_use"]),
            "device_bytes_delta": (after["bytes_in_use"]
                                   - before["bytes_in_use"]),
        }

    def go(self):
        if os.environ.get("BQUERYD_TPU_WARMUP", "1") == "1":
            self._warmup_thread = threading.Thread(
                target=self.warmup,
                name=f"warmup-{self.worker_id[:6]}",
                daemon=True,
            )
            self._warmup_thread.start()
        else:
            self.warmup_done.set()
        super().go()

    def warmup(self):
        """Build or load the kernel library, create the CUDA context and
        launch ``onehot_rows_dot`` once (a tiny ``partial_tables`` and
        ``finalize`` on the worker's device), then measure the dispatch
        floor behind host routing, in the BACKGROUND: the worker registers
        at once instead of after a first nvcc build, which can take
        minutes.  A query that arrives meanwhile waits on the library's
        lock; the heartbeat thread keeps the busy worker alive.  A failure
        is logged and the worker carries on: its first query then raises
        on its own, and nothing falls back to the CPU.
        :attr:`warmup_done` is set when this ends, either way."""
        t0 = time.time()
        self.logger.info("starting kernel warmup in background")
        try:
            import numpy as np

            from bqueryd_tpu_torch import ops

            codes = np.zeros(8, dtype=np.int32)
            vals = np.ones(8, dtype=np.int64)
            partials = ops.partial_tables(codes, (vals,), ("sum",), 4, None,
                                          device=self.device)
            ops.finalize(partials, ("sum",))
            # a floor sampled while the build or the context creation held
            # the device is inflated: replace it with a clean one, or host
            # routing would mis-route for the process lifetime
            from bqueryd_tpu_torch.models.query import device_dispatch_floor

            device_dispatch_floor(remeasure=True, device=self.device)
            self.logger.info("kernel warmup done in %.1fs", time.time() - t0)
        except Exception:
            self.logger.exception("kernel warmup failed (continuing)")
        finally:
            self.warmup_done.set()

    def _open_table(self, rootdir):
        """The table instance of ``rootdir``'s current snapshot, with its
        identity pinned (``storage.ctable.pin_identity``): one ``stat`` of
        meta.json per call, and a ``realpath`` once per rootdir name, as a
        shard's path does not change under a running worker.  An append
        commits a new meta.json by rename, so the next call opens a new
        instance under a new identity, and every cache keyed on it (the
        result cache, the working set, the factorize cache) misses."""
        from bqueryd_tpu_torch.storage.ctable import ctable, pin_identity

        real = self._realpaths.get(rootdir)
        if real is None:
            real = self._realpaths[rootdir] = os.path.realpath(rootdir)
        try:
            st = os.stat(os.path.join(rootdir, "meta.json"))
        except FileNotFoundError:
            if not os.path.exists(rootdir):
                raise ValueError(f"Path {rootdir} does not exist") from None
            raise
        hit = self._table_cache.get((real, st.st_ino, st.st_mtime_ns))
        if hit is not None:
            return hit
        table = ctable(rootdir, mode="r", auto_cache=True)
        # pinned from the meta.json the instance read, which a concurrent
        # append may have replaced since the stat above
        identity = pin_identity(table, real)
        if len(self._table_cache) > 512:
            self._table_cache.clear()
        self._table_cache[identity] = table
        return table

    def shard_stats(self):
        """Metadata-only stats of every advertised shard (memoized, see
        :class:`~bqueryd_tpu_torch.plan.stats.StatsCollector`).
        ``BQUERYD_TPU_SHARD_STATS=0`` turns them off: the controller then
        prunes none of this worker's shards.  A failure to gather never
        breaks the heartbeat: it advertises no stats."""
        if os.environ.get("BQUERYD_TPU_SHARD_STATS", "1") == "0":
            return None
        try:
            if self._stats_collector is None:
                from bqueryd_tpu_torch.plan.stats import StatsCollector

                self._stats_collector = StatsCollector(
                    table_opener=self._open_table)
            return self._stats_collector.collect(self.data_dir,
                                                 list(self.data_files))
        except Exception:
            self.logger.debug("shard stats gathering failed", exc_info=True)
            return None

    # -- caches ------------------------------------------------------------
    @property
    def result_cache(self):
        """Serialized-result cache keyed by (table identities, query or
        DAG signature): a repeated query on unchanged shards costs one dict
        lookup and no kernel.  Bounded by
        ``BQUERYD_TPU_RESULT_CACHE_BYTES`` (default 256 MiB; 0 disables)."""
        if self._result_cache is None:
            from bqueryd_tpu_torch.utils.cache import BytesCappedCache

            try:
                cap = int(os.environ.get("BQUERYD_TPU_RESULT_CACHE_BYTES",
                                         256 * 1024**2))
            except ValueError:
                self.logger.warning(
                    "unparseable BQUERYD_TPU_RESULT_CACHE_BYTES, cache off"
                )
                cap = 0
            self._result_cache = BytesCappedCache(cap) if cap > 0 else False
        # an EMPTY cache is len()-falsy: compare with False explicitly
        return None if self._result_cache is False else self._result_cache

    def delta_cache(self):
        """The worker's :class:`~bqueryd_tpu_torch.ops.workingset.
        DeltaAggCache` (None while ``BQUERYD_TPU_DELTA_SERVE=0``)."""
        from bqueryd_tpu_torch.ops import workingset

        if not workingset.delta_serve_enabled():
            return None
        if self._delta_cache is None:
            self._delta_cache = workingset.DeltaAggCache()
        return self._delta_cache

    def clear_caches(self):
        """Drop every query cache of the node: results, delta bases, the
        executor's working set and the engine's factorizations."""
        if self._result_cache:
            self._result_cache.clear()
        if self._delta_cache is not None:
            self._delta_cache.clear()
        self.executor.clear_caches()
        self.engine.clear_caches()

    @staticmethod
    def _delta_eligible(query):
        """Shapes whose cached result a tail-only partial can refresh:
        plain mergeable aggregations.  Basket expansion re-selects OLD rows
        when a NEW row of the same basket matches; distinct counts carry
        value sets the flat merge forms don't cover here."""
        from bqueryd_tpu_torch import ops

        return (
            query is not None
            and query.aggregate
            and not query.expand_filter_column
            and all(op in ops.MERGEABLE_OPS for op in query.ops)
        )

    @staticmethod
    def _delta_key(tables, query):
        """The delta entry of a shard group: its tables' paths (the pinned
        identity's realpath, so that a grown table finds the entry of its
        earlier snapshot) and the query's signature."""
        return (
            tuple(t.identity[0] if t.identity else os.path.realpath(t.rootdir)
                  for t in tables),
            query.signature(),
        )

    def _serve_delta(self, cache, tables, query, timer):
        """Serve a grown shard group from the delta cache: aggregate ONLY
        the appended chunks of each grown table on the engine (one kernel
        launch per tail view) and merge the tail partials into the cached
        payload.  Returns the refreshed serialized payload, or None (no
        entry, no growth, or not an append-only growth: the caller
        recomputes)."""
        key = self._delta_key(tables, query)
        with timer.phase("delta"):
            entry = cache.get(key)
            if entry is None:
                return None
            per_table_ids = cache.refresh_ids(entry, tables)
            if per_table_ids is None:
                # a rewrite, reshard or shrink: recompute (and re-base)
                cache.discard(key)
                return None
        tails = [table.chunk_view(ids)
                 for table, ids in zip(tables, per_table_ids) if ids]
        if not tails:
            # no growth: an identical repeat is the RESULT cache's job, so
            # that BQUERYD_TPU_RESULT_CACHE_BYTES=0 really recomputes
            return None
        payloads = [ResultPayload.from_bytes(entry["data"])]
        with timer.phase("execute"):
            for view in tails:
                payloads.append(self.engine.execute_local(view, query))
        with timer.phase("hostmerge"):
            merged = ResultPayload(hostmerge.merge_payloads(payloads))
        with timer.phase("serialize"):
            data = merged.to_bytes()
        with timer.phase("delta"):
            cache.store(key, tables, data)
        cache.refreshes += 1
        cache.delta_rows += sum(int(v.nrows) for v in tails)
        self.delta_refreshes_total.inc()
        return data

    # -- work --------------------------------------------------------------
    def _append_rows(self, msg):
        """The ``append`` verb: apply a batch of rows (a DataFrame or a
        mapping of column arrays) to a shard this worker serves.  Column
        data and chunk indexes commit before the meta.json row count, so
        queries on this worker keep a consistent snapshot."""
        from bqueryd_tpu_torch.storage.ctable import ctable

        if os.environ.get("BQUERYD_TPU_APPEND", "1") == "0":
            raise ValueError(
                "streaming append disabled on this worker "
                "(BQUERYD_TPU_APPEND=0)"
            )
        args, _kwargs = msg.get_args_kwargs()
        if len(args) != 2:
            raise ValueError("append needs (filename, dataframe_like)")
        filename, frame = args
        rootdir = os.path.realpath(os.path.join(self.data_dir, filename))
        if not rootdir.startswith(os.path.realpath(self.data_dir) + os.sep):
            raise ValueError(f"path {filename!r} escapes data_dir")
        if not os.path.exists(os.path.join(rootdir, "meta.json")):
            raise ValueError(f"Path {rootdir} does not exist")
        table = ctable(rootdir, mode="a")
        appended = table.append(frame)
        self.appends_total.inc()
        self.append_rows_total.inc(int(appended))
        if self._stats_collector is not None:
            # the grown shard's bounds go out on the next heartbeat: stale
            # ones would let the controller prune its appended rows
            self._stats_collector.invalidate()
        reply = msg.copy()
        # the request's params carry the whole batch: echoing them back
        # per holder would double the wire cost
        reply.pop("params", None)
        reply.add_as_binary("result", {
            "filename": filename,
            "appended": int(appended),
            "rows": int(table.nrows),
            "worker": self.worker_id,
            "node": self.node_name,
        })
        return reply

    def _execute_dag(self, tables, dag, timer, report):
        """An extended operator DAG (join, top-k, quantile sketch, window).
        A batchable one (``plan.dag.dag_batchable``: the mergeable ops, top-k
        and sketches, unless ``BQUERYD_TPU_DAG_BATCH=0``) takes the fast
        path, :meth:`MeshQueryExecutor.execute_dag`: one pass and one
        device program over the whole shard group, ``merge_mode`` "device".
        What the fast path cannot serve (``DagFastPathUnsupported``) and a
        key space past int64 (``ops.CompositeOverflow``) run through the
        per-shard :class:`DagExecutor` and the host merge, ``merge_mode``
        "host" or "none"; any other error, a device error included,
        propagates.  A wedged device or a group at or under
        ``host_kernel_rows()`` skips the fast path: ``DagExecutor`` routes
        each shard.  ``report`` as :func:`execute` fills it."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.models.query import host_kernel_rows
        from bqueryd_tpu_torch.parallel.executor import (
            DagFastPathUnsupported,
        )
        from bqueryd_tpu_torch.parallel.opexec import DagExecutor
        from bqueryd_tpu_torch.plan import dag as dagmod

        total_rows = sum(int(t.nrows) for t in tables)
        if (dagmod.dag_batchable(dag)
                and not devicehealth.backend_wedged()
                and total_rows > host_kernel_rows()):
            self.executor.timer = timer
            try:
                payload = self.executor.execute_dag(tables, dag)
            except DagFastPathUnsupported as exc:
                self.logger.debug("DAG fast path unavailable (%s); serving "
                                  "it per shard", exc)
            except ops.CompositeOverflow:
                self.logger.info("composite key space exceeds int64; "
                                 "serving the DAG per shard")
            else:
                report["effective_strategy"] = (
                    self.executor.last_effective_strategy)
                report["merge_mode"] = self.executor.last_merge_mode
                _fold_prune(report, self.executor.last_prune_counts)
                return payload
            finally:
                self.executor.timer = None
        executor = DagExecutor(self.engine)
        payload = executor.execute(tables, dag, timer=timer)
        report["effective_strategy"] = executor.last_effective_strategy
        report["merge_mode"] = executor.last_merge_mode
        _fold_prune(report, executor._prune_counts)
        return payload

    @staticmethod
    def _rollup_census(table):
        """Column metadata a rollup's subsumption proofs need: per column
        its kind ("int" columns are null-free by dtype), its per-chunk zone
        maps, and whether nulls can occur.  Metadata only: no chunk is
        decoded."""
        import numpy as np

        from bqueryd_tpu_torch.storage.ctable import (
            KIND_DATETIME,
            KIND_NUMERIC,
        )

        cols = {}
        for name in table.names:
            k = table.kind(name)
            if k == KIND_NUMERIC:
                np_kind = np.dtype(table.physical_dtype(name)).kind
                kind = "int" if np_kind in "iu" else "float"
            elif k == KIND_DATETIME:
                kind = "datetime"
            else:
                kind = "dict"
            zones = (table.chunk_zone_maps(name)
                     if k in (KIND_NUMERIC, KIND_DATETIME) else None)
            cols[name] = {
                "kind": kind,
                "zones": zones,
                # float and datetime zone maps skip NaN/NaT rows: only an
                # int column is provably null-free
                "nulls": kind != "int",
            }
        return cols

    def _rollup_build(self, msg):
        """The ``rollup`` verb: the mergeable partials of one plan over ONE
        local shard.  A refresh request carries the prior partials and the
        growth base they were computed against (``rollup_prior``,
        ``rollup_base``): no new chunks answer ``fresh`` with the prior;
        an append-only growth aggregates only the appended chunks and
        merges them into the prior on the host (``delta``); anything else
        (a rewrite, a bad base, an extended DAG) rebuilds.  The reply
        carries the partials (``data``), ``rollup_mode``, the phase
        timings, the table's growth base (``rollup_base``) and its column
        census (``rollup_zones``)."""
        from bqueryd_tpu_torch.models.query import GroupByQuery
        from bqueryd_tpu_torch.ops import workingset
        from bqueryd_tpu_torch.plan import dag as dagmod

        timer, recorder = self._calc_timer(msg)
        args, _kwargs = msg.get_args_kwargs()
        filename, groupby_cols, agg_list, where_terms = args[:4]
        with timer.phase("open"):
            table = self._open_table(os.path.join(self.data_dir, filename))
        if msg.get("dag"):
            dag = dagmod.OperatorDAG.from_wire(msg.get_from_binary("dag"))
            dag.sole_payload = False  # rollups keep the mergeable form
        else:
            dag = dagmod.dag_from_query(GroupByQuery(
                groupby_cols, agg_list, where_terms or [], aggregate=True
            ))
        query = dag.plain_groupby_query()

        mode, data = "rebuild", None
        prior = msg.get_from_binary("rollup_prior")
        base = msg.get_from_binary("rollup_base")
        if prior is not None and base is not None and query is not None:
            new_ids = workingset.growth_since(base, table)
            if new_ids is not None and not new_ids:
                mode, data = "fresh", prior
            elif new_ids is not None:
                with timer.phase("execute"):
                    tail = self.engine.execute_local(
                        table.chunk_view(new_ids), query
                    )
                with timer.phase("hostmerge"):
                    merged = hostmerge.merge_payloads(
                        [ResultPayload.from_bytes(prior), tail]
                    )
                with timer.phase("serialize"):
                    data = ResultPayload(merged).to_bytes()
                mode = "delta"
        if data is None:
            with timer.phase("execute"):
                if query is not None:
                    payload = self.engine.execute_local(table, query)
                else:
                    payload = self._execute_dag([table], dag, timer, {})
            with timer.phase("serialize"):
                data = payload.to_bytes()
        self.flight.record(
            "rollup_build", filename=filename, mode=mode,
            bytes=len(data), token=msg.get("token"),
        )
        reply = msg.copy()
        for key in ("params", "dag", "rollup_prior", "rollup_base"):
            reply.pop(key, None)
        reply["data"] = data
        reply["rollup_mode"] = mode
        reply["phase_timings"] = timer.as_dict()
        if recorder is not None:
            reply["spans"] = recorder.export()
        reply.add_as_binary("rollup_base", workingset.table_growth_base(table))
        reply.add_as_binary("rollup_zones", self._rollup_census(table))
        return reply

    def _query_of(self, msg, args, kwargs):
        """``(query, dag, strategy)`` of a groupby CalcMessage.  Every
        message compiles through the DAG layer: a ``dag`` envelope key is
        the authoritative program (the ``query`` verb); otherwise the plan
        fragment (or the bare params) builds a plain DAG.  ``query`` is the
        plain DAG's field-exact :class:`GroupByQuery`, None for an extended
        DAG."""
        from bqueryd_tpu_torch.models.query import GroupByQuery
        from bqueryd_tpu_torch.plan import dag as dagmod
        from bqueryd_tpu_torch.plan import fragment_to_query

        if msg.get("dag"):
            dag = dagmod.OperatorDAG.from_wire(msg.get_from_binary("dag"))
            dag.sole_payload = bool(msg.get("sole_shard"))
            return dag.plain_groupby_query(), dag, None
        _filename, groupby_cols, agg_list, where_terms = args[:4]
        # a planning controller sends the rewritten plan fragment beside
        # the positional params: the fragment is authoritative; bare
        # params serve older controllers and direct callers
        fragment = msg.get_from_binary("plan") if msg.get("plan") else None
        strategy = None
        if fragment:
            from bqueryd_tpu_torch.plan import calibrate

            query = fragment_to_query(fragment)
            strategy = fragment.get("strategy")
            if strategy == "auto":
                strategy = None
            elif (strategy == "matmul" and fragment.get("strategy_binding")
                  and calibrate.enabled()):
                # the calibration-backed promotion, unless this worker runs
                # under the BQUERYD_TPU_CALIB=0 kill switch
                strategy = "matmul!"
        else:
            query = GroupByQuery(
                groupby_cols,
                agg_list,
                where_terms or [],
                aggregate=kwargs.get("aggregate", True),
                expand_filter_column=kwargs.get("expand_filter_column"),
                sole_payload=bool(msg.get("sole_shard")),
            )
        dag = dagmod.dag_from_query(query)
        return dag.plain_groupby_query(), dag, strategy

    def handle_work(self, msg):
        if msg.isa("execute_code"):
            return self.execute_code(msg)
        if msg.isa("append"):
            return self._append_rows(msg)
        if msg.isa("rollup"):
            return self._rollup_build(msg)
        if not msg.isa("groupby"):
            return super().handle_work(msg)
        if msg.get("bundle"):
            return self._handle_bundle(msg)
        from bqueryd_tpu_torch.storage.ctable import table_cache_key

        timer, recorder = self._calc_timer(msg)
        args, kwargs = msg.get_args_kwargs()
        query, dag, strategy = self._query_of(msg, args, kwargs)
        filename = args[0]
        filenames = filename if isinstance(filename, list) else [filename]
        with timer.phase("open"):
            tables = [self._open_table(os.path.join(self.data_dir, name))
                      for name in filenames]
        report = {"effective_strategy": None, "merge_mode": None}
        cache = self.result_cache
        cache_key = data = None
        if cache is not None:
            cache_key = (
                tuple(table_cache_key(t) for t in tables),
                # an extended DAG has no GroupByQuery form: its identity is
                # the DAG signature (join table, window, sketch params)
                query.signature() if query is not None else dag.signature(),
            )
            data = cache.get(cache_key)
            if data is not None:
                # a hit compiled nothing: the route says so
                report["effective_strategy"] = "cached"
        delta_cache = None
        if data is None and self._delta_eligible(query):
            delta_cache = self.delta_cache()
        if delta_cache is not None:
            data = self._serve_delta(delta_cache, tables, query, timer)
            if data is not None:
                report["effective_strategy"] = "delta"
                report["merge_mode"] = "host"
                if cache is not None and len(data) <= cache.max_bytes // 8:
                    cache.put(cache_key, data, nbytes=len(data))
        mem_tags = None
        if data is None:
            prof = obs.profile.profiler()
            mem_before = prof.memory_sample()
            with self._profiling(), timer.phase("execute"):
                # the prune phase and the executor's phases, when they
                # run, are timed inside execute
                if query is not None:
                    payload = execute(tables, query, self.engine,
                                      executor=self.executor,
                                      strategy=strategy, report=report,
                                      timer=timer)
                else:
                    payload = self._execute_dag(tables, dag, timer, report)
            self._count_chunk_prune(report)
            mem_tags = self._memory_tags(mem_before,
                                         prof.memory_sample())
            if recorder is not None:
                self._tag_spans(recorder, report)
            with timer.phase("serialize"):
                data = payload.to_bytes()
            if cache is not None and len(data) <= cache.max_bytes // 8:
                cache.put(cache_key, data, nbytes=len(data))
            if delta_cache is not None:
                # the delta base: the snapshots of the very table
                # instances this result was computed from
                with timer.phase("delta"):
                    delta_cache.store(self._delta_key(tables, query),
                                      tables, data)
        reply = msg.copy()
        # the request's DAG carries the whole join table: no echo
        reply.pop("dag", None)
        reply["data"] = data
        reply["phase_timings"] = timer.as_dict()
        if "chunk_prune" in report:
            # counts beside the prune phase, underscore-named like _total
            # so that no consumer reads them as seconds of a phase
            decoded, skipped = report["chunk_prune"]
            reply["phase_timings"]["_chunks_decoded"] = decoded
            reply["phase_timings"]["_chunks_skipped"] = skipped
        remaining = msg.deadline_remaining()
        if remaining is not None:
            reply["deadline_remaining"] = round(remaining, 4)
        if strategy is not None:
            reply["strategy"] = strategy
        if report["effective_strategy"] is not None:
            reply["effective_strategy"] = report["effective_strategy"]
        if report["merge_mode"] is not None:
            reply["merge_mode"] = report["merge_mode"]
        self._finish_calc(reply, data, timer, recorder, mem_tags)
        return reply

    @staticmethod
    def _tag_spans(recorder, report):
        """The kernel span carries the route the executor took, the prune
        span the chunks it decoded and skipped."""
        for span in recorder.spans:
            if (span.get("name") == "kernel"
                    and report.get("effective_strategy")):
                span.setdefault("tags", {})["effective_strategy"] = (
                    report["effective_strategy"])
            elif span.get("name") == "prune" and "chunk_prune" in report:
                decoded, skipped = report["chunk_prune"]
                tags = span.setdefault("tags", {})
                tags["chunks_decoded"] = decoded
                tags["chunks_skipped"] = skipped

    def _handle_bundle(self, msg):
        """A shared-scan bundle: one CalcMessage carrying several
        compatible member queries (:mod:`plan.bundle`).  The open, decode,
        alignment and uploads happen once; each member keeps its own
        identity: its result-cache key (the key of its solo run), its
        deadline (a member past it is dropped from the stack, not the
        bundle) and its errors.  A bundle :meth:`_bundle_mesh_eligible`
        admits goes to :meth:`MeshQueryExecutor.execute_bundle` (others run
        member by member); a key space past int64
        (``ops.CompositeOverflow``) or a member-shape rejection
        (``ValueError``) runs the members one by one through
        :func:`execute`, where a failing member fails alone.  A
        :class:`~bqueryd_tpu_torch.chaos.TransientError` fails the whole
        bundle (over to another holder, under its one token).  Any other
        error, a device error included, propagates.  The reply's data
        frame is one pickled ``{"v": 1, "payloads": {member_id: bytes},
        "errors": {member_id: text}}`` envelope, beside
        ``bundle_members``, ``member_shares``, ``phase_timings``,
        ``effective_strategy`` and ``merge_mode``."""
        import pickle

        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.plan import bundle as bundlemod
        from bqueryd_tpu_torch.plan import dag as dagmod
        from bqueryd_tpu_torch.storage.ctable import table_cache_key

        timer, recorder = self._calc_timer(msg)
        fragment = msg.get_from_binary("bundle")
        # each member through the DAG layer, as a solo groupby compiles:
        # the same query, the same result-cache key
        members = [
            (member_id, deadline,
             dagmod.dag_from_query(query).plain_groupby_query())
            for member_id, deadline, query
            in bundlemod.bundle_to_queries(fragment)
        ]
        strategy = bundlemod.fragment_strategy(fragment)
        filename = msg.get("filename") or fragment.get("filenames")
        filenames = filename if isinstance(filename, list) else [filename]
        with timer.phase("open"):
            tables = [self._open_table(os.path.join(self.data_dir, name))
                      for name in filenames]
        cache = self.result_cache
        tables_sig = tuple(table_cache_key(t) for t in tables)
        payloads = {}   # member_id -> serialized ResultPayload
        errors = {}     # member_id -> failure text
        active = {}     # member_id -> query still to execute
        now = time.time()
        for member_id, deadline, query in members:
            if deadline is not None and float(deadline) <= now:
                errors[member_id] = (
                    f"deadline exceeded {now - float(deadline):.3f}s "
                    "before execution")
                continue
            if cache is not None:
                hit = cache.get((tables_sig, query.signature()))
                if hit is not None:
                    payloads[member_id] = hit
                    continue
            active[member_id] = query
        cached_ids = list(payloads)
        report = {"effective_strategy": None, "merge_mode": None}
        results, walls = {}, {}
        if active:
            bundled = None
            if self._bundle_mesh_eligible(tables, list(active.values())):
                try:
                    bundled = self.mesh_executor_for_bundle(
                        tables, list(active.values()), timer, strategy)
                except chaos.TransientError:
                    # a transient device fault fails the whole bundle over
                    # to another holder, never one member
                    raise
                except ops.CompositeOverflow:
                    self.logger.info("composite key space exceeds int64; "
                                     "running the bundle's members one by "
                                     "one")
                except ValueError as exc:
                    self.logger.info("bundle rejected (%s); running its "
                                     "members one by one", exc)
            if bundled is not None:
                results = dict(zip(active, bundled))
                report["effective_strategy"] = (
                    self.executor.last_effective_strategy)
                report["merge_mode"] = self.executor.last_merge_mode
            else:
                for member_id, query in active.items():
                    t0 = time.perf_counter()
                    try:
                        with timer.phase("execute"):
                            results[member_id] = execute(
                                tables, query, self.engine,
                                executor=self.executor, strategy=strategy,
                                report=report, timer=timer)
                        self._count_chunk_prune(report)
                    except chaos.TransientError:
                        raise  # the whole bundle fails over, as above
                    except Exception as exc:
                        self.logger.exception("bundle member %s failed",
                                              member_id)
                        errors[member_id] = f"{type(exc).__name__}: {exc}"
                    else:
                        walls[member_id] = time.perf_counter() - t0
        with timer.phase("serialize"):
            for member_id, payload in results.items():
                data = payload.to_bytes()
                payloads[member_id] = data
                if cache is not None and len(data) <= cache.max_bytes // 8:
                    cache.put((tables_sig, active[member_id].signature()),
                              data, nbytes=len(data))
            data = pickle.dumps(
                {"v": 1, "payloads": payloads, "errors": errors},
                protocol=messages.PICKLE_PROTOCOL,
            )
        reply = msg.copy()
        reply["data"] = data
        reply["bundle_members"] = [m[0] for m in members]
        # a cache hit consumed no scan: its share is 0
        reply["member_shares"] = {
            **{m: 0.0 for m in cached_ids},
            **bundlemod.member_shares(list(results), walls=walls),
        }
        reply["phase_timings"] = timer.as_dict()
        effective = (report["effective_strategy"] if active
                     else ("cached" if payloads else None))
        if effective is not None:
            reply["effective_strategy"] = effective
        if report["merge_mode"] is not None:
            reply["merge_mode"] = report["merge_mode"]
        # one CalcMessage executed, whatever its member count
        self._finish_calc(reply, data, timer, recorder)
        return reply

    def _bundle_mesh_eligible(self, tables, queries):
        """Whether a bundle runs as one shared scan on the executor, as the
        solo path routes: every member mergeable, the device not wedged,
        and the group's rows above ``host_kernel_rows`` at the worst
        member's host cost.  A member the estimate cannot price (a column
        a shard lacks) sends the bundle member by member, where it fails
        alone."""
        from bqueryd_tpu_torch.models.query import (
            _host_ns_estimate,
            host_kernel_rows,
        )

        if devicehealth.backend_wedged():
            return False
        if not all(self.executor.supports(q) for q in queries):
            return False
        total_rows = sum(int(t.nrows) for t in tables)
        try:
            worst = max(
                (_host_ns_estimate(t, q.agg_list, total_rows)
                 for t in tables for q in queries),
                default=None,
            )
        except Exception:
            return False
        return total_rows > host_kernel_rows(worst)

    def mesh_executor_for_bundle(self, tables, queries, timer, strategy):
        """The shared scan of a bundle: one :class:`ResultPayload` per
        member, the executor's phases timed into ``timer``."""
        self.executor.timer = timer
        try:
            return self.executor.execute_bundle(tables, queries,
                                                strategy=strategy)
        finally:
            self.executor.timer = None

    def execute_code(self, msg):
        """Import a dotted function path and call it: remote execution for
        trusted clusters, off unless ``BQUERYD_TPU_ENABLE_EXECUTE_CODE=1``.
        The function's arguments travel as the call's ``args=[...]`` and
        ``kwargs={...}``, or as its other keywords."""
        if os.environ.get("BQUERYD_TPU_ENABLE_EXECUTE_CODE") != "1":
            raise PermissionError(
                "execute_code disabled; set BQUERYD_TPU_ENABLE_EXECUTE_CODE=1"
            )
        args, kwargs = msg.get_args_kwargs()
        function = msg.get("function") or kwargs.pop("function", None)
        if not function:
            raise ValueError("execute_code needs a function=module.path.fn")
        call_args = kwargs.pop("args", None) or list(args)
        call_kwargs = kwargs.pop("kwargs", None) or {}
        # any other keywords are the function's own (direct-kwarg convention)
        call_kwargs = {**kwargs, **call_kwargs}
        module_name, _, fn_name = function.rpartition(".")
        fn = getattr(importlib.import_module(module_name), fn_name)
        result = fn(*call_args, **call_kwargs)
        reply = msg.copy()
        reply.add_as_binary("result", result)
        return reply


class DownloaderNode(WorkerBase):
    """The ticket-driven blob downloader (the pipeline itself is
    :mod:`bqueryd_tpu_torch.download`).

    Fetches run on a small thread pool (``BQUERYD_TPU_DOWNLOAD_THREADS``,
    3) so that a slow or hung blob stream never blocks the loop: ticket
    polling, WRM heartbeats and cancellation stay live during long
    downloads.  Pool threads never touch the zmq socket: the controller's
    TicketDoneMessages go through a thread-safe outbox that the loop
    drains.  The role resolves no device and loads no kernel."""

    workertype = "download"

    def __init__(self, *args, **kw):
        download_threads = kw.pop("download_threads", None)
        kw.setdefault("heartbeat_interval", DEFAULT_HEARTBEAT_INTERVAL)
        super().__init__(*args, **kw)
        self.download_interval = DOWNLOAD_DELAY
        self._last_download_check = 0.0
        if download_threads is None:
            download_threads = int(
                os.environ.get("BQUERYD_TPU_DOWNLOAD_THREADS", "3")
            )
        self.download_threads = max(1, download_threads)
        self._download_pool = None
        self.downloads_done = self.metrics.counter(
            "bqueryd_tpu_downloads_total",
            "download tickets completed by this node",
        )
        self.downloads_failed = self.metrics.counter(
            "bqueryd_tpu_download_failures_total",
            "download tickets failed terminally by this node",
        )
        import queue

        self._outbox = queue.Queue()

    @property
    def download_pool(self):
        if self._download_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._download_pool = ThreadPoolExecutor(
                max_workers=self.download_threads,
                thread_name_prefix=f"dl-{self.worker_id[:6]}",
            )
        return self._download_pool

    def heartbeat(self):
        super().heartbeat()
        self._drain_outbox()
        now = time.time()
        if now - self._last_download_check >= self.download_interval:
            self._last_download_check = now
            try:
                self.check_downloads()
            except Exception:
                self.logger.exception("error checking downloads")

    def _drain_outbox(self):
        """Send controller notifications queued by pool threads (zmq sockets
        are single-thread-only, so only the event loop may send)."""
        import queue

        while True:
            try:
                msg = self._outbox.get_nowait()
            except queue.Empty:
                return
            self.send_to_all(msg)

    def stop(self):
        if self._request_stop_only():
            return  # outbox/socket teardown belongs to the loop thread
        if self._download_pool is not None:
            self._download_pool.shutdown(wait=False, cancel_futures=True)
        self._drain_outbox()
        super().stop()

    def check_downloads(self):
        from bqueryd_tpu_torch.download import check_downloads

        check_downloads(self)

    def run_download(self, ticket, fileurl, lock):
        """Run one claimed download on the pool; the claim lock is held for
        the download's lifetime and released by the pool thread."""

        def job():
            try:
                self.download_file(ticket, fileurl, lock=lock)
            except Exception as exc:
                self.logger.exception("download %s failed", fileurl)
                self.fail_ticket(ticket, fileurl, str(exc))
            finally:
                lock.release()

        self.download_pool.submit(job)

    def download_file(self, ticket, fileurl, lock=None):
        from bqueryd_tpu_torch.download import download_file

        download_file(self, ticket, fileurl, lock=lock)

    def file_downloader_progress(self, ticket, fileurl, progress):
        from bqueryd_tpu_torch.download import set_progress

        set_progress(self.store, self.node_name, ticket, fileurl, progress)

    def remove_ticket(self, ticket):
        from bqueryd_tpu_torch.download import remove_ticket

        remove_ticket(self, ticket)
        self.downloads_done.inc()
        self._outbox.put(TicketDoneMessage({"ticket": ticket}))

    def fail_ticket(self, ticket, fileurl, error):
        """Terminal download failure: poison the ticket (ERROR slot blocks
        activation on every node) and tell controllers so waiting clients get
        the error instead of the reference's false DONE."""
        from bqueryd_tpu_torch.download import fail_ticket

        fail_ticket(self, ticket, fileurl, error)
        self.downloads_failed.inc()
        self._outbox.put(
            TicketDoneMessage({"ticket": ticket, "error": str(error)})
        )


class MoveBcolzNode(DownloaderNode):
    """The second phase of the two-phase distribution commit: moves the
    downloaded shards of a ticket into the serving dir only when every
    slot on every node is DONE."""

    workertype = "movebcolz"

    def check_downloads(self):
        from bqueryd_tpu_torch.download import check_moves

        check_moves(self)

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
worker.  All device work runs on the node's loop thread.

Routing is decided before any device call and is never a fallback: a
device error is not caught on the query path; inside a node it becomes an
``ErrorMessage`` for the controller, never a retry on the host or on a
plain version.  A calc worker advertises its device-health latch
(``backend_wedged``) and its calibration cells (``calibration``,
:mod:`bqueryd_tpu_torch.plan.calibrate`) in every WRM.
"""

import contextlib
import logging
import os
import signal
import socket as socket_mod
import threading
import time
import traceback

import zmq

import bqueryd_tpu_torch
from bqueryd_tpu_torch import messages
from bqueryd_tpu_torch.coordination import coordination_store
from bqueryd_tpu_torch.messages import (
    BusyMessage,
    DoneMessage,
    ErrorMessage,
    StopMessage,
    WorkerRegisterMessage,
    msg_factory,
)
from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge, pipeline
from bqueryd_tpu_torch.utils import devicehealth
from bqueryd_tpu_torch.utils.net import get_my_ip
from bqueryd_tpu_torch.utils.tracing import PhaseTimer

DEFAULT_HEARTBEAT_INTERVAL = 20.0   # WRM re-broadcast / rescan period
DEFAULT_POLL_TIMEOUT = 1.0          # seconds per zmq poll tick
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
    phase.

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
    and the Busy/Done envelope around each work item."""

    workertype = "worker"

    def __init__(
        self,
        coordination_url=None,
        data_dir=None,
        loglevel=None,
        heartbeat_interval=DEFAULT_HEARTBEAT_INTERVAL,
        poll_timeout=DEFAULT_POLL_TIMEOUT,
    ):
        bqueryd_tpu_torch.configure_logging(loglevel or logging.INFO)
        self.worker_id = os.urandom(8).hex()
        self.logger = bqueryd_tpu_torch.logger.getChild(
            f"{self.workertype}.{self.worker_id[:6]}"
        )
        self.node_name = socket_mod.gethostname()
        self.store = coordination_store(
            coordination_url or bqueryd_tpu_torch.DEFAULT_COORDINATION_URL
        )
        self.data_dir = data_dir or bqueryd_tpu_torch.DEFAULT_DATA_DIR
        if self.workertype == "calc" and not os.path.isdir(self.data_dir):
            raise ValueError(f"Datadir {self.data_dir} is not a valid directory")
        self.heartbeat_interval = heartbeat_interval
        self.poll_timeout = poll_timeout

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

    # -- lifecycle ---------------------------------------------------------
    def go(self):
        self.running = True
        self._loop_thread = threading.current_thread()
        try:
            signal.signal(signal.SIGTERM, self._term_signal)
        except ValueError:
            pass  # not the main thread (in-process clusters)
        self.logger.info("starting %s worker %s", self.workertype,
                         self.worker_id)
        self._loop_started = time.time()
        self._start_heartbeat_thread()
        while self.running:
            try:
                self.heartbeat()
                events = dict(self.poller.poll(int(self.poll_timeout * 1000)))
                if self.socket in events:
                    self.handle_in()
            except zmq.ZMQError:
                self.logger.exception("zmq error in worker loop")
                time.sleep(0.2)
            except Exception:
                self.logger.exception("error in worker loop")
        self.stop()

    def _term_signal(self, *args):
        self.logger.info("SIGTERM received, stopping")
        self.running = False

    def stop(self):
        """Stop the node.  From another thread this only flags the loop:
        zmq sockets belong to one thread, so the loop thread tears its
        sockets down itself when it leaves ``go``."""
        self.running = False
        self._hb_stop.set()
        loop = self._loop_thread
        if (loop is not None and loop.is_alive()
                and threading.current_thread() is not loop):
            return
        if self._hb_thread is not None and self._hb_thread.ident is not None:
            self._hb_thread.join(timeout=2.0)
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
        roles only read the latch."""
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

    def prepare_wrm(self):
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
                # the device-health latch, for rpc.info()
                "backend_wedged": self._backend_wedged(),
                # metadata-only per-shard stats (rows, min/max,
                # cardinality) for the controller's plan-time pruning and
                # strategy hints; None when unchanged stats went out
                # recently
                "shard_stats": self._stats_to_advertise(),
                # the measured kernel-wall cells (plan.calibrate) the
                # controller's select_calibrated consults
                "calibration": self._calibration_to_advertise(),
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
        traceback when it raised), Done."""
        self.send_to_all(BusyMessage({"worker_id": self.worker_id}))
        try:
            if msg.deadline_expired():
                # nobody waits for this answer any more
                raise TimeoutError(
                    f"deadline exceeded {-msg.deadline_remaining():.3f}s "
                    "before execution"
                )
            result = self.handle_work(msg)
        except Exception:
            self.logger.exception("error handling work")
            result = ErrorMessage(msg)
            result["payload"] = traceback.format_exc()
        try:
            self.send(sender, result)
        except zmq.ZMQError:
            self.logger.exception("could not send result to %r", sender)
        self.send_to_all(DoneMessage({"worker_id": self.worker_id}))

    def handle_work(self, msg):
        raise ValueError(f"unhandled message payload {msg.get('payload')!r}")


class WorkerNode(WorkerBase):
    """The calc worker: answers ``groupby`` CalcMessages (plain ones and
    the operator DAGs of the ``query`` verb), ``append`` and ``rollup``
    ones, on its own engine and executor, in the reference worker's order:
    the DAG layer, the result cache, the delta cache, then :func:`execute`
    (a plain DAG) or :meth:`_execute_dag` (an extended one: the fast path,
    else :class:`~bqueryd_tpu_torch.parallel.opexec.DagExecutor`).

    ``device`` is resolved when the node is built: ``cuda`` unless
    ``device="cpu"`` is passed; without a card it raises before any socket
    is opened or anything registered."""

    workertype = "calc"

    def __init__(self, *args, device=None, **kw):
        from bqueryd_tpu_torch import resolve_device
        from bqueryd_tpu_torch.models.query import QueryEngine
        from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor

        device = resolve_device(device)
        super().__init__(*args, **kw)
        self.engine = QueryEngine(device=device)
        self.executor = MeshQueryExecutor(device=device)
        self._table_cache = {}   # pinned identity -> table instance
        self._realpaths = {}     # rootdir as named -> its realpath
        self._result_cache = None
        self._delta_cache = None
        self._stats_collector = None
        #: delta refreshes served, and appends applied with their rows
        self.delta_refreshes = 0
        self.appends = 0
        self.append_rows = 0

    @property
    def device(self):
        return self.engine.device

    def go(self):
        if self.device.type == "cuda":
            # build or load the kernels and create the CUDA context before
            # the first WRM: a first nvcc build inside a query could
            # outlast the dead-worker timeout
            import torch

            from bqueryd_tpu_torch.ops import onehot

            onehot._library()
            torch.empty(0, device=self.device)
            # the dispatch floor behind host routing, measured now that
            # the kernels are loaded and the context exists: a sample
            # taken during either would push the threshold to its cap
            from bqueryd_tpu_torch.models.query import device_dispatch_floor

            device_dispatch_floor(remeasure=True, device=self.device)
        super().go()

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
        self.delta_refreshes += 1
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
        self.appends += 1
        self.append_rows += int(appended)
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

        timer = PhaseTimer()
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
        reply = msg.copy()
        for key in ("params", "dag", "rollup_prior", "rollup_base"):
            reply.pop(key, None)
        reply["data"] = data
        reply["rollup_mode"] = mode
        reply["phase_timings"] = timer.as_dict()
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
        if msg.isa("append"):
            return self._append_rows(msg)
        if msg.isa("rollup"):
            return self._rollup_build(msg)
        if not msg.isa("groupby"):
            return super().handle_work(msg)
        if msg.get("bundle"):
            return self._handle_bundle(msg)
        from bqueryd_tpu_torch.storage.ctable import table_cache_key

        timer = PhaseTimer()
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
        if data is None:
            with timer.phase("execute"):
                # the prune phase, when it runs, is timed inside execute
                if query is not None:
                    payload = execute(tables, query, self.engine,
                                      executor=self.executor,
                                      strategy=strategy, report=report,
                                      timer=timer)
                else:
                    payload = self._execute_dag(tables, dag, timer, report)
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
        return reply

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
        :func:`execute`, where a failing member fails alone.  Any other
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

        timer = PhaseTimer()
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

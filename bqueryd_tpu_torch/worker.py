"""The calc worker: per-query execution and the ZMQ worker node.

:func:`execute` is the port of ``bqueryd_tpu/worker.py``
``WorkerNode._execute``:

* a filter whose per-chunk zone maps prove most chunks unmatchable runs
  over views of the surviving chunks (``ops.chunk_pruned_table``), on
  every route below; basket expansion skips this, as it re-selects rows of
  a basket that live in pruned chunks;
* mergeable aggregate queries go to the executor
  (:class:`~bqueryd_tpu_torch.parallel.executor.MeshQueryExecutor`): one
  key alignment, one kernel call over every shard's rows, the merge on the
  device;
* a composite key space past int64 (``ops.CompositeOverflow``) is served
  by the per-shard engine, which factorizes key tuples instead;
* a single shard that the executor does not take (raw rows, the distinct
  ops) goes to :meth:`QueryEngine.execute_local`;
* anything else runs per shard, then merges on the host by key value
  (distinct value sets by union): each shard's host work (key factorize,
  column decode) runs on the pipeline pool, its device work on the calling
  thread.

:class:`WorkerNode` runs :func:`execute` behind the reference's control
plane: one ROUTER socket with a random hex identity connected out to every
controller in the coordination store, a WorkerRegisterMessage (WRM) with
the served ``*.bcolz``/``*.bcolzs`` files every heartbeat, liveness WRMs
from a second thread on sockets of its own, Busy/Done around each work
item, and the reply envelope of the reference worker.  All device work
runs on the node's loop thread.

A device error is never caught on the query path: inside a node it
becomes an ``ErrorMessage`` for the controller, never a retry on the host
or on a plain version.  Latency-aware host routing waits for a later slice,
so the port never routes a query around the device.
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
    route) and ``merge_mode`` ("device" for the executor, "host" for the
    per-shard host merge, "none" for one shard's payload), and, only when
    the filter ran through chunk pruning, ``chunk_prune``:
    ``(chunks_decoded, chunks_skipped)`` over all shards.  ``timer``, a
    :class:`PhaseTimer` when given, times the ``prune`` phase."""
    from bqueryd_tpu_torch import ops
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
    if executor is not None and executor.supports(query):
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
    """The calc worker: answers ``groupby`` CalcMessages with
    :func:`execute` on its own engine and executor.

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
        self._table_cache = {}

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
        super().go()

    def _open_table(self, rootdir):
        """Tables cached by meta.json identity: a rewritten shard misses,
        and the executor's working set keys on the same identity."""
        from bqueryd_tpu_torch.storage.ctable import ctable, rootdir_cache_key

        key = rootdir_cache_key(rootdir)
        if key is not None:
            hit = self._table_cache.get(key)
            if hit is not None:
                return hit
        table = ctable(rootdir, mode="r", auto_cache=True)
        if key is not None:
            if len(self._table_cache) > 512:
                self._table_cache.clear()
            self._table_cache[key] = table
        return table

    def handle_work(self, msg):
        if not msg.isa("groupby"):
            return super().handle_work(msg)
        from bqueryd_tpu_torch.models.query import GroupByQuery
        from bqueryd_tpu_torch.plan import fragment_to_query

        timer = PhaseTimer()
        args, kwargs = msg.get_args_kwargs()
        filename, groupby_cols, agg_list, where_terms = args[:4]
        # a planning controller sends the rewritten plan fragment beside
        # the positional params: the fragment is authoritative; bare
        # params serve older controllers and direct callers
        fragment = msg.get_from_binary("plan") if msg.get("plan") else None
        strategy = None
        if fragment:
            query = fragment_to_query(fragment)
            strategy = fragment.get("strategy")
            if strategy == "auto":
                strategy = None
            elif strategy == "matmul" and fragment.get("strategy_binding"):
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
        filenames = filename if isinstance(filename, list) else [filename]
        tables = []
        with timer.phase("open"):
            for name in filenames:
                rootdir = os.path.join(self.data_dir, name)
                if not os.path.exists(rootdir):
                    raise ValueError(f"Path {rootdir} does not exist")
                tables.append(self._open_table(rootdir))
        report = {}
        with timer.phase("execute"):
            # the prune phase, when it runs, is timed inside execute
            payload = execute(tables, query, self.engine,
                              executor=self.executor, strategy=strategy,
                              report=report, timer=timer)
        with timer.phase("serialize"):
            data = payload.to_bytes()
        reply = msg.copy()
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

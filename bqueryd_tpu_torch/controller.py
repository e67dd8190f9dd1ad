"""ControllerNode: discovery, dispatch and the sink of queries and appends.

The port's copy of the part of ``bqueryd_tpu/controller.py`` that answers
``groupby``, ``query``, ``append``, ``ping``, ``info`` and ``loglevel``,
with the reference's wire behaviour:

* one ROUTER socket bound to a random port in 14300-14399, its identity
  ``tcp://ip:port`` registered in the coordination store;
* workers register and re-register with WorkerRegisterMessages (WRMs);
  silent ones are culled, and their in-flight work is re-queued onto
  another holder within a retry budget;
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
  (``backend_wedged``) is kept in its ``worker_map`` entry.

The controller imports neither torch nor pandas.  Not ported yet: the
serving layer (subsumption and rollups, whose hook has its place in
``_admit_plan``), capacity and health scoring of workers, stale-dispatch
retries and hedging, affinity pins, peer gossip, observability (spans,
flight events, metrics), chaos and downloads.

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
from bqueryd_tpu_torch import messages
from bqueryd_tpu_torch.coordination import coordination_store
from bqueryd_tpu_torch.messages import (
    BusyMessage,
    CalcMessage,
    DoneMessage,
    ErrorMessage,
    Message,
    StopMessage,
    WorkerRegisterMessage,
    msg_factory,
)
from bqueryd_tpu_torch.utils.env import env_num
from bqueryd_tpu_torch.utils.net import bind_to_random_port, get_my_ip

POLLING_TIMEOUT = 0.5        # seconds
DEAD_WORKER_TIMEOUT = 60.0   # cull workers silent longer than this
HEARTBEAT_INTERVAL = 2.0     # store re-registration period
DISPATCH_TIMEOUT = 120.0     # a worker holding younger work is not culled
DISPATCH_HARD_TIMEOUT = 1800.0  # a heartbeat-only worker is culled after it
MAX_DISPATCH_RETRIES = 2
#: how long an append fan-out waits for every holder's reply
APPEND_TIMEOUT = 120.0
RUNFILE_DIR = os.environ.get("BQUERYD_TPU_RUNFILE_DIR", "/srv")

CONTROLLER_VERBS = ("ping", "loglevel", "info", "groupby", "query",
                    "append")

#: the controller's counters, in ``get_info()["counters"]`` (the
#: reference's names and meanings)
COUNTERS = (
    "admission_busy",          # plans refused with BUSY
    "admission_queued",        # plans held in the admission queue
    "admission_superseded",    # live tickets retired by a new query
    "deadline_expired",        # plans or units expired before dispatch
    "plan_pruned_shards",      # shards the advertised stats excluded
    "plan_shared_dispatches",  # dispatches a plan joined instead of paying
    "plan_bundles",            # shared-scan bundle CalcMessages
    "plan_bundled_queries",    # members over all bundles
    "plan_strategy_hints",     # non-auto kernel-strategy hints issued
    "plan_calibrated_overrides",  # measured walls overrode the heuristic
    "plan_explore_hints",      # exploration hints sampling an unmeasured route
    "plan_matmul_promotions",  # calibration-backed binding matmul hints
    "dispatched_shards",       # groupby CalcMessages sent to workers
)


class ControllerNode:
    def __init__(
        self,
        coordination_url=None,
        loglevel=None,
        runfile_dir=RUNFILE_DIR,
        heartbeat_interval=HEARTBEAT_INTERVAL,
        dead_worker_timeout=None,
        port_range=(14300, 14400),
        admit_max_active=None,
        admit_queue_depth=None,
        admit_client_quota=None,
    ):
        from bqueryd_tpu_torch.plan import AdmissionController, calibrate

        bqueryd_tpu_torch.configure_logging(loglevel or logging.INFO)
        self.store = coordination_store(
            coordination_url or bqueryd_tpu_torch.DEFAULT_COORDINATION_URL
        )
        self.heartbeat_interval = heartbeat_interval
        self.dead_worker_timeout = (
            dead_worker_timeout if dead_worker_timeout is not None
            else env_num("BQUERYD_TPU_DEAD_WORKER_TIMEOUT",
                         DEAD_WORKER_TIMEOUT)
        )
        self.dispatch_timeout = env_num("BQUERYD_TPU_DISPATCH_TIMEOUT",
                                        DISPATCH_TIMEOUT)
        self.dispatch_hard_timeout = max(
            env_num("BQUERYD_TPU_DISPATCH_HARD_TIMEOUT",
                    DISPATCH_HARD_TIMEOUT),
            self.dispatch_timeout,
        )
        self.max_dispatch_retries = env_num(
            "BQUERYD_TPU_MAX_DISPATCH_RETRIES", MAX_DISPATCH_RETRIES, int
        )

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
        self.pending = []             # CalcMessages waiting for a worker
        self.inflight = {}            # work token -> {worker, sent_at, msg}
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
        # shared dispatch: every groupby work unit has a subscriber list,
        # the parents waiting for its payload
        self._work_subscribers = {}   # work token -> [parent token, ...]
        self._work_keys = {}          # work token -> shared-dispatch key
        self._work_index = {}         # shared-dispatch key -> work token
        # the micro-batch window: admitted plans staged until it closes,
        # then flushed grouped by compatibility key; empty at window 0
        self._pending_window = []     # [(msg, plan, kwargs), ...]
        self._window_opened = 0.0
        self.counters = dict.fromkeys(COUNTERS, 0)
        self._append_segments = {}    # append fan-out key -> its state
        self._append_waiters = {}     # append dispatch token -> fan-out key
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
        except ValueError:
            pass  # not the main thread (in-process clusters)
        self.logger.info("controller %s running", self.address)
        try:
            while self.running:
                try:
                    self.heartbeat()
                    self.free_dead_workers()
                    # a staged window bounds the poll: its flush is due
                    # when it closes, not a full POLLING_TIMEOUT later
                    # (closed-loop clients send nothing while staged)
                    timeout_s = POLLING_TIMEOUT
                    if self._pending_window:
                        remaining = self._window_deadline() - time.time()
                        timeout_s = max(min(timeout_s, remaining), 0.0)
                    events = dict(self.poller.poll(int(timeout_s * 1000)))
                    if self.socket in events:
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
                    self._admit_ready()
                    self._flush_window()
                    self.dispatch_pending()
                    self._sweep_append_segments()
                except Exception:
                    self.logger.exception("error in controller loop")
        finally:
            self.stop()

    def _term_signal(self, *args):
        self.logger.info("SIGTERM received, stopping")
        self.running = False

    def stop(self):
        """Stop the node.  From another thread this only flags the loop;
        the loop thread deregisters and closes its socket on the way
        out."""
        self.running = False
        loop = self._loop_thread
        if (loop is not None and loop.is_alive()
                and threading.current_thread() is not loop):
            return
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
        self.store.sadd(bqueryd_tpu_torch.REDIS_SET_KEY, self.address)

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
        """Forget a worker and its files; re-queue its in-flight work."""
        self.worker_map.pop(worker_id, None)
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
        for token, entry in list(self.inflight.items()):
            if entry["worker"] == worker_id:
                self.inflight.pop(token)
                self._requeue(entry["msg"], f"worker {worker_id} lost")

    def _requeue(self, msg, reason):
        """Queue a work unit again, or fail its query once it has used
        ``max_dispatch_retries`` retries.  An append goes to one holder
        only: its fan-out records that holder's failure instead."""
        if msg.get("target") is not None:
            return
        retries = msg.get("_retries", 0)
        if retries >= self.max_dispatch_retries:
            self._abort_work(
                msg,
                f"shard {msg.get('filename')} failed after {retries} "
                f"retries ({reason})",
                error_class="DispatchExhausted",
            )
            return
        msg["_retries"] = retries + 1
        self.pending.append(msg)

    # -- scheduling --------------------------------------------------------
    def find_free_worker(self, filename):
        """A random free calc worker that advertises ``filename``: one
        name, or every name of a batched shard group's list."""
        needed = [filename] if isinstance(filename, str) else list(filename)
        candidates = [
            worker_id for worker_id, info in self.worker_map.items()
            if info.get("workertype") == "calc" and not info.get("busy")
            and all(worker_id in self.files_map.get(f, ()) for f in needed)
        ]
        return random.choice(candidates) if candidates else None

    def dispatch_pending(self):
        """Send every queued message that a free worker can take, in queue
        order; expire those past their deadline and fail those whose files
        no worker holds any more."""
        queue, self.pending = self.pending, []
        for msg in queue:
            target = msg.get("target")
            if target is not None:
                # an append to one holder, while its fan-out waits
                if msg["token"] not in self._append_waiters:
                    continue
                if self.worker_map.get(target, {}).get("busy", True):
                    self.pending.append(msg)
                else:
                    self._send_to_worker(target, msg)
                continue
            if not any(p in self.rpc_segments
                       for p in self._work_parents(msg)):
                self._drop_work(msg.get("token"))
                continue  # every query waiting for it was aborted
            if msg.deadline_expired():
                # nobody waits any more: expire instead of dispatching
                self.counters["deadline_expired"] += 1
                self._abort_work(msg, "deadline exceeded before dispatch")
                continue
            filename = msg.get("filename")
            worker_id = self.find_free_worker(filename)
            if worker_id is not None:
                self._send_to_worker(worker_id, msg)
                continue
            needed = [filename] if isinstance(filename, str) else filename
            missing = [f for f in needed if f not in self.files_map]
            if missing:
                # every holder is gone: no later tick can serve this
                self._abort_work(
                    msg, f"file(s) no longer on any worker: {missing}",
                )
            elif isinstance(filename, list) and not self._servable_by_one(
                filename
            ):
                # placement changed since batching: one message per shard,
                # carrying the batch's subscribers
                children = self._split_batch(msg)
                self._transfer_work(msg, children)
                self.pending.extend(children)
            else:
                self.pending.append(msg)  # its holders are busy

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

    def _abort_work(self, msg, error_text, error_class=None):
        """Fail every parent subscribed to one work unit."""
        parents = self._work_parents(msg)
        self._drop_work(msg.get("token"))
        for parent in parents:
            self.abort_parent(parent, error_text, error_class=error_class)

    def _send_to_worker(self, worker_id, msg):
        try:
            self.socket.send_multipart(
                [worker_id.encode(), msg.to_json().encode()]
            )
        except zmq.ZMQError as exc:
            self.logger.warning("send to worker %s failed: %s", worker_id, exc)
            self.remove_worker(worker_id)
            self._requeue(msg, f"send failed: {exc}")
            return
        if msg.isa("groupby"):
            self.counters["dispatched_shards"] += 1
        info = self.worker_map[worker_id]
        info["busy"] = True
        # ROUTER_MANDATORY: the send would have raised on a gone peer
        info["last_seen"] = time.time()
        self.inflight[msg["token"]] = {
            "worker": worker_id, "sent_at": time.time(), "msg": msg,
        }

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
        elif msg.get("token"):
            info["busy"] = False
            self._absorb_reply(worker_id, msg)

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
                self._absorb_wedged(worker_id, msg)
                # the worker's stats advertisement rides either socket
                self._absorb_shard_stats(msg)
            elif self._adoption_blocked.get(worker_id, 0) <= now:
                info = dict(msg, last_seen=now, busy=True, hb_only=now)
                self.worker_map[worker_id] = info
                for filename in info.get("data_files") or []:
                    self.files_map.setdefault(filename, set()).add(worker_id)
                self._absorb_wedged(worker_id, info)
                self._absorb_shard_stats(info)
            return
        prev = self.worker_map.get(worker_id, {})
        self._adoption_blocked.pop(worker_id, None)
        info = dict(msg)
        info["last_seen"] = now
        # an hb-only adoption's busy=True was a placeholder
        info["busy"] = False if prev.get("hb_only") else prev.get("busy", False)
        self.worker_map[worker_id] = info
        current = set(info.get("data_files") or [])
        for filename in current:
            self.files_map.setdefault(filename, set()).add(worker_id)
        for filename in list(self.files_map):
            if filename not in current:
                self.files_map[filename].discard(worker_id)
                if not self.files_map[filename]:
                    del self.files_map[filename]
                    self.shard_stats.pop(filename, None)
        self._absorb_wedged(worker_id, info)
        self._absorb_shard_stats(info)

    def _absorb_wedged(self, worker_id, info):
        """Track each worker's advertised device-health latch and log its
        flips."""
        wedged = bool(info.get("backend_wedged"))
        prev = self._worker_wedged.get(worker_id)
        self._worker_wedged[worker_id] = wedged
        if wedged and not prev:
            self.logger.warning(
                "worker %s advertises a wedged device", worker_id)
        elif prev and not wedged:
            self.logger.info("worker %s device recovered", worker_id)

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

    def _absorb_reply(self, worker_id, msg):
        """A worker's reply to a work unit.  A late reply of an earlier
        attempt (its worker was culled and the unit re-queued) counts when
        it is a result: the first result wins.  Its errors are dropped
        while the live attempt stands."""
        token = msg["token"]
        entry = self.inflight.get(token)
        if entry is not None and entry["worker"] != worker_id:
            if msg.isa(ErrorMessage):
                return
        else:
            self.inflight.pop(token, None)
        self.pending = [m for m in self.pending if m.get("token") != token]
        self.process_worker_result(msg)

    def process_worker_result(self, msg):
        token = msg.get("token")
        if token in self._append_waiters:
            self._absorb_append_reply(token, msg)
            return
        if isinstance(token, str) and token.startswith("append_"):
            # its fan-out already failed fast or timed out: the client
            # was answered
            return
        subscribers = self._work_subscribers.get(token)
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
        delivered = False
        for parent in parents:
            segment = self.rpc_segments.get(parent)
            if segment is None:
                continue  # that subscriber aborted earlier
            delivered = True
            self._record_result(segment, key, msg, msg.get("data") or b"",
                                msg.get("phase_timings"))
            self._maybe_complete_segment(parent)
        if not delivered:
            self.logger.debug("orphaned result for token %s dropped", token)

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
            segment["merge"][key] = merge_mode

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
        filename = msg.get("filename")
        key = tuple(filename) if isinstance(filename, list) else (filename,)
        for member_id, parent in bundle_parents.items():
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
            self._maybe_complete_segment(parent)

    def _maybe_complete_segment(self, parent):
        """Reply to the client once every requested shard is covered (by a
        worker payload, a batched group payload or a plan-time prune)."""
        segment = self.rpc_segments.get(parent)
        if segment is None:
            return
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
        reply = pickle.dumps(
            {
                "ok": True,
                "payloads": payloads,
                "timings": compact(segment["timings"]),
                "answer_source": "recompute",
                "subsumed_from": None,
                "strategies": {
                    "hints": dict(segment["strategies"]),
                    "effective": compact(segment["effective"]),
                },
                "merge_modes": compact(segment["merge"]),
            },
            protocol=messages.PICKLE_PROTOCOL,
        )
        self._finish_segment(segment, reply)

    def _finish_segment(self, segment, reply_bytes=None):
        """A query's last act: its reply (none for a retired run, whose
        client moved on) and the release of its admission ticket, which
        may launch a queued plan."""
        if reply_bytes is not None:
            self.reply_rpc_raw(segment["client_token"], reply_bytes)
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
            for k, v in timings.items()
        }

    def abort_parent(self, parent, error_text, reply=True, error_class=None):
        """Fail a query: detach it from its work units (a unit left with
        no subscriber dies, a shared one keeps computing for the others),
        drop its queued work, release its ticket and, unless ``reply`` is
        false, send the client the error envelope."""
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
        self.pending = [
            m for m in self.pending
            if m.get("token") not in dead
            and not (m.get("parent_token") == parent
                     and m.get("token") not in self._work_subscribers)
        ]
        self._finish_segment(
            segment,
            pickle.dumps(
                {"ok": False, "error": str(error_text),
                 "error_class": error_class, "attempts": []},
                protocol=messages.PICKLE_PROTOCOL,
            ) if reply else None,
        )

    def reply_rpc_raw(self, client_token, payload_bytes):
        client = binascii.unhexlify(client_token)
        try:
            self.socket.send_multipart([client, b"", payload_bytes])
        except zmq.ZMQError:
            self.logger.exception("could not reply to client %r", client_token)

    def reply_rpc_message(self, client_token, msg):
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

    def get_info(self):
        return {
            "address": self.address,
            "node": self.node_name,
            "uptime": time.time() - self.start_time,
            "msg_count_in": self.msg_count_in,
            "workers": self.worker_map,
            "pending": len(self.pending),
            "inflight": len(self.inflight),
            "rpc_segments": len(self.rpc_segments),
            "counters": dict(self.counters),
            "admission": self.admission.stats(),
            "shard_stats_known": len(self.shard_stats),
            # the measured-cost model: counts, the controller's own cells
            # (the reference's keys) and each worker's gossiped ones
            "calibration": {
                **self.calibration.stats(),
                "sample_cells": self.calibration.summary(max_cells=16),
                "source_cells": self.calibration.source_cells(max_cells=16),
            },
            "others": {},
        }

    def rpc_loglevel(self, msg):
        args, _ = msg.get_args_kwargs()
        for worker_id in list(self.worker_map):
            fan = msg.copy()
            fan.pop("token", None)
            try:
                self.socket.send_multipart(
                    [worker_id.encode(), fan.to_json().encode()]
                )
            except zmq.ZMQError:
                pass
        level = {"debug": logging.DEBUG, "info": logging.INFO}.get(
            args[0] if args else "info", logging.INFO
        )
        bqueryd_tpu_torch.logger.setLevel(level)
        reply = msg.copy()
        reply["payload"] = "OK"
        self.reply_rpc_message(msg["token"], reply)

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
        plan = plan_groupby(
            filenames, groupby_cols, agg_list, where_terms,
            aggregate=kwargs.get("aggregate", True),
            expand_filter_column=kwargs.get("expand_filter_column"),
        )
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
        # the serving layer's answer (a subsumption or rollup hit, with no
        # admission slot and no dispatch) goes here once it is ported
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
        from bqueryd_tpu_torch.plan import bundle as bundlemod

        if bundlemod.batch_window_ms() <= 0:
            self._launch_plan(msg, plan, kwargs)
            return
        if not self._pending_window:
            self._window_opened = time.time()
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
                keep, pruned, key = list(plan.filenames), [], None
            if key is None:
                key = ("solo", id(msg))
            groups.setdefault(key, []).append(
                (msg, plan, kwargs, keep, pruned))
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
        parent_token = os.urandom(8).hex()
        self.rpc_segments[parent_token] = {
            "client_token": msg["token"],
            "admission_ticket": msg["token"],
            "filenames": list(plan.filenames),
            "pruned": list(pruned),
            "results": {(f,): b"" for f in pruned},  # group key -> payload
            "timings": {},            # shard-group key -> phase_timings
            "strategies": {},         # hint -> dispatched shards
            "effective": {},          # shard-group key -> executed route
            "merge": {},              # shard-group key -> merge_mode
        }
        return parent_token

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
                self.pending.append(shard)
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
            # deadline is part of the identity: fusing across deadlines
            # would expire one client's work on another's budget
            work_key = (tuple(group), plan_sig, sole, msg.get("deadline"))
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
            if msg.get("deadline") is not None:
                shard["deadline"] = msg["deadline"]
            shard.add_as_binary("plan", fragment_for(
                plan, group, strategy=strategy, sole=sole))
            if dag_blob is not None:
                shard["dag"] = dag_blob
            self._register_work(shard, [parent_token], work_key=work_key)
            self.pending.append(shard)

    def _shard_groups(self, filenames, groupby_cols, agg_list, kwargs):
        """Shards held by the same set of workers go out as ONE message,
        so a worker runs one executor call over all of them.  Only
        aggregations that merge by part kind batch: the mergeable ops, and
        for a DAG dispatch (``kwargs["dag"]``, whose ``batch`` flag
        ``plan.dag.groupby_equivalent`` sets) the top-k and sketch ops; raw
        rows and the distinct ops go one shard per message, as does
        ``batch=False``."""
        from bqueryd_tpu_torch.models.query import (
            MERGEABLE_OPS,
            normalize_agg_list,
        )
        from bqueryd_tpu_torch.plan.dag import is_extended_op

        dag_riding = kwargs.get("dag") is not None
        batchable = (
            kwargs.get("batch", True)
            and kwargs.get("aggregate", True)
            and all(a[1] in MERGEABLE_OPS
                    or (dag_riding and is_extended_op(a[1]))
                    for a in normalize_agg_list(agg_list))
        )
        if not batchable:
            return [[f] for f in filenames]
        groups = {}
        for f in filenames:
            placement = tuple(sorted(self.files_map.get(f, ())))
            groups.setdefault(placement, []).append(f)
        return list(groups.values())

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
            calc["target"] = worker_id
            segment["pending"][calc["token"]] = worker_id
            self._append_waiters[calc["token"]] = seg_key
            self.pending.append(calc)
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

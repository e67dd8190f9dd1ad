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

The controller imports neither torch nor pandas.  Not ported yet:
admission and micro-batch windows, shared-scan bundles, plan-time shard
pruning and calibrated strategy hints, stale-dispatch retries and hedging,
peer gossip, observability, chaos, downloads and rollups.

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


class ControllerNode:
    def __init__(
        self,
        coordination_url=None,
        loglevel=None,
        runfile_dir=RUNFILE_DIR,
        heartbeat_interval=HEARTBEAT_INTERVAL,
        dead_worker_timeout=None,
        port_range=(14300, 14400),
    ):
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
                    events = dict(
                        self.poller.poll(int(POLLING_TIMEOUT * 1000))
                    )
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
            self.abort_parent(
                msg.get("parent_token"),
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
            if msg.get("parent_token") not in self.rpc_segments:
                continue  # its query was aborted
            if msg.deadline_expired():
                self.abort_parent(msg.get("parent_token"),
                                  "deadline exceeded before dispatch")
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
                self.abort_parent(
                    msg.get("parent_token"),
                    f"file(s) no longer on any worker: {missing}",
                )
            elif isinstance(filename, list) and not self._servable_by_one(
                filename
            ):
                # placement changed since batching: one message per shard
                self.pending.extend(self._split_batch(msg))
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
            elif self._adoption_blocked.get(worker_id, 0) <= now:
                info = dict(msg, last_seen=now, busy=True, hb_only=now)
                self.worker_map[worker_id] = info
                for filename in info.get("data_files") or []:
                    self.files_map.setdefault(filename, set()).add(worker_id)
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
        parent = msg.get("parent_token")
        segment = self.rpc_segments.get(parent)
        if segment is None:
            self.logger.debug("orphaned result for parent %s dropped", parent)
            return
        if msg.isa(ErrorMessage):
            self.abort_parent(parent, msg.get("payload"))
            return
        filename = msg.get("filename")
        # a batched group's reply covers all its files with one merged
        # payload: completion counts covered files, not replies
        key = tuple(filename) if isinstance(filename, list) else (filename,)
        segment["results"][key] = msg.get("data") or b""
        segment["timings"][key] = msg.get("phase_timings")
        effective = msg.get("effective_strategy")
        if isinstance(effective, str):
            segment["effective"][key] = effective
        merge_mode = msg.get("merge_mode")
        if isinstance(merge_mode, str):
            segment["merge"][key] = merge_mode
        self._maybe_complete_segment(parent)

    def _maybe_complete_segment(self, parent):
        """Reply to the client once every requested shard is covered."""
        segment = self.rpc_segments[parent]
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
        self.reply_rpc_raw(segment["client_token"], reply)

    @staticmethod
    def _compact_timings(timings):
        """Tuple-keyed per-group values -> JSON-safe keys: a group is
        labelled by its first file and the count of the others."""
        return {
            (k[0] if len(k) == 1 else f"{k[0]}+{len(k) - 1}more"): v
            for k, v in timings.items()
        }

    def abort_parent(self, parent, error_text, reply=True, error_class=None):
        """Fail a query: drop its queued and in-flight work and, unless
        ``reply`` is false, send the client the error envelope."""
        segment = self.rpc_segments.pop(parent, None)
        if segment is None:
            return
        self.pending = [
            m for m in self.pending if m.get("parent_token") != parent
        ]
        for token, entry in list(self.inflight.items()):
            if entry["msg"].get("parent_token") == parent:
                self.inflight.pop(token)
        if reply:
            self.reply_rpc_raw(
                segment["client_token"],
                pickle.dumps(
                    {"ok": False, "error": str(error_text),
                     "error_class": error_class, "attempts": []},
                    protocol=messages.PICKLE_PROTOCOL,
                ),
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
        # a REQ client is lockstep: a new request means it gave up on any
        # earlier one, whose reply would now pair with the wrong request
        for parent, segment in list(self.rpc_segments.items()):
            if segment["client_token"] == token:
                self.abort_parent(parent, "superseded", reply=False)
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
        unknown = [f for f in plan.filenames if f not in self.files_map]
        if unknown:
            raise ValueError(f"filenames not found on any worker: {unknown}")
        parent_token = self._open_query_segment(msg, plan)
        self._dispatch_plan(msg, plan, kwargs, parent_token)

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
        unknown = [f for f in plan.filenames if f not in self.files_map]
        if unknown:
            raise ValueError(f"filenames not found on any worker: {unknown}")
        kwargs = dict(kwargs, **dag_kwargs)
        parent_token = self._open_query_segment(msg, plan)
        self._dispatch_plan(msg, plan, kwargs, parent_token)

    def _open_query_segment(self, msg, plan):
        """The per-query result segment, under a fresh parent token."""
        parent_token = os.urandom(8).hex()
        self.rpc_segments[parent_token] = {
            "client_token": msg["token"],
            "filenames": list(plan.filenames),
            "results": {},            # shard-group key -> payload bytes
            "timings": {},            # shard-group key -> phase_timings
            "strategies": {},         # hint -> dispatched shards
            "effective": {},          # shard-group key -> executed route
            "merge": {},              # shard-group key -> merge_mode
        }
        return parent_token

    def _dispatch_plan(self, msg, plan, kwargs, parent_token):
        """Queue one CalcMessage per shard group, each with its plan
        fragment and, for the ``query`` verb, the wire DAG.  No strategy
        hint is issued: the worker routes."""
        from bqueryd_tpu_torch.plan import fragment_for

        dag_blob = None
        if kwargs.get("dag") is not None:
            # encoded once: the wire DAG carries the whole join table
            dag_blob = base64.b64encode(
                pickle.dumps(kwargs["dag"], protocol=messages.PICKLE_PROTOCOL)
            ).decode("ascii")
        groupby_cols = list(plan.groupby.keys)
        agg_list = plan.physical_agg_list()
        where_terms = plan.where_terms
        # one payload with no merge downstream (the reference's
        # count_distinct then ships final counts)
        sole = len(plan.filenames) == 1 and plan.aggregate_rows
        segment = self.rpc_segments[parent_token]
        for group in self._shard_groups(
            plan.filenames, groupby_cols, agg_list, kwargs
        ):
            target = group if len(group) > 1 else group[0]
            segment["strategies"]["auto"] = (
                segment["strategies"].get("auto", 0) + len(group)
            )
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
            shard.add_as_binary("plan", fragment_for(plan, group, sole=sole))
            if dag_blob is not None:
                shard["dag"] = dag_blob
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

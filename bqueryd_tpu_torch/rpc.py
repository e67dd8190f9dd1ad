"""Query entry points of the port: the RPC client and an in-process
stand-in.

:class:`RPC` is the port of ``bqueryd_tpu/rpc.py`` ``RPC``: attribute
access becomes a remote call on a live controller found in the
coordination store (``rpc.groupby(...)``, ``rpc.info()``, ...), over one
zmq REQ socket with a ping-verified connection, reconnect and retry with
backoff, and ``last_call_duration``.  A ``groupby`` reply is a pickled
envelope of per-shard-group payloads, which the client merges by key value
and finalizes.  Unlike the reference it returns ``(order, {column:
np.ndarray})`` from ``hostmerge.finalize_table``, not a DataFrame, so no
pandas is needed.  ``RPC.query(spec)`` (the operator DAG: joins, top-k,
quantiles, window rollups) returns the same form, and ``RPC.append(
filename, data)`` adds rows to a served shard.  One instance is
single-thread lockstep: concurrent callers each hold their own.  Sockets
built with one ``client_id`` share that client's admission quota at the
controller; ``priority=`` orders a query in the admission queue; a BUSY
answer (admission backpressure) is retried with backoff and, on the last
attempt, raises :class:`RPCBusyError`.

:class:`LocalRPC` takes the same ``groupby`` arguments and runs the query
in-process through :func:`bqueryd_tpu_torch.worker.execute` with the
executor and the engine it owns, as a worker does: a test aid, and the
reference point for the cluster's own cost.
"""

import logging
import os
import pickle
import random
import time

import zmq

import bqueryd_tpu_torch
from bqueryd_tpu_torch import backoff, worker
from bqueryd_tpu_torch.coordination import coordination_store
from bqueryd_tpu_torch.messages import ErrorMessage, RPCMessage, msg_factory
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.storage.ctable import ctable


class LocalRPC:
    """Groupby over local shards on ``cuda`` (or on the CPU when
    ``device="cpu"`` is passed).  Mergeable aggregations run on the
    executor, the rest per shard on the engine."""

    def __init__(self, data_dir, device=None):
        self.data_dir = data_dir
        self.engine = QueryEngine(device=device)
        self.executor = MeshQueryExecutor(device=self.engine.device)
        #: the kernel route and merge mode of the last groupby (the
        #: reference worker's reply envelope keys), and its
        #: (chunks_decoded, chunks_skipped) when chunk pruning ran
        self.last_effective_strategy = None
        self.last_merge_mode = None
        self.last_chunk_prune = None
        self._tables = {}

    @property
    def device(self):
        return self.engine.device

    def _table(self, filename):
        path = os.path.join(self.data_dir, filename)
        table = self._tables.get(path)
        if table is None:
            table = self._tables[path] = ctable(path, mode="r")
        return table

    def groupby(self, filenames, groupby_cols, agg_list, where_terms=None,
                aggregate=True, expand_filter_column=None):
        """``(order, {column: np.ndarray})`` of the finalized result: the
        group keys then the aggregates (or the selected raw rows when
        ``aggregate=False``).  One file's payload is the whole answer, as
        a controller marks a single-shard fan-out (``sole_payload``)."""
        if isinstance(filenames, str):
            filenames = [filenames]
        query = GroupByQuery(
            list(groupby_cols), agg_list, list(where_terms or []),
            aggregate=aggregate, expand_filter_column=expand_filter_column,
            sole_payload=aggregate and len(filenames) == 1,
        )
        tables = [self._table(f) for f in filenames]
        report = {}
        payload = worker.execute(
            tables, query, self.engine, executor=self.executor,
            report=report,
        )
        self.last_effective_strategy = report["effective_strategy"]
        self.last_merge_mode = report["merge_mode"]
        self.last_chunk_prune = report.get("chunk_prune")
        merged = hostmerge.merge_payloads([payload])
        return hostmerge.finalize_table(merged)


class RPCError(Exception):
    pass


class RPCBusyError(RPCError):
    """A controller refused the query for admission backpressure: retry
    with backoff or shed load upstream."""


class RPC:
    def __init__(
        self,
        address=None,
        timeout=120,
        coordination_url=None,
        loglevel=logging.INFO,
        retries=3,
        client_id=None,
    ):
        bqueryd_tpu_torch.configure_logging(loglevel)
        self.logger = bqueryd_tpu_torch.logger.getChild("rpc")
        self.timeout = timeout
        self.retries = retries
        #: the admission quota bucket: sockets sharing a client_id share
        #: the controller's per-client quota; unset, each socket identity
        #: is its own bucket
        self.client_id = client_id
        self.last_call_duration = None
        #: attempts the most recent call consumed (1 = first try answered)
        self.last_call_attempts = None
        #: per-shard-group phase timings, the planner's hints and executed
        #: routes ({"hints": ..., "effective": ...}; a route is "cached" for
        #: a result-cache hit and "delta" for a delta refresh) and merge
        #: modes ("device", "host", "none") of the most recent groupby or
        #: query reply
        self.last_call_timings = None
        self.last_call_strategies = None
        self.last_call_merge_modes = None
        #: bytes of the most recent reply, and the client's deserialize,
        #: merge and finalize wall of the most recent groupby
        self.last_call_reply_bytes = None
        self.last_call_client_merge_s = None
        self.identity = os.urandom(8).hex()
        self.store = coordination_store(
            coordination_url or bqueryd_tpu_torch.DEFAULT_COORDINATION_URL
        )
        self.context = zmq.Context.instance()
        self.socket = None
        self.address = None
        self.connect(address)

    # -- connection --------------------------------------------------------
    def connect(self, address=None):
        if address:
            candidates = [address]
        else:
            candidates = list(
                self.store.smembers(bqueryd_tpu_torch.REDIS_SET_KEY)
            )
            random.shuffle(candidates)
        if not candidates:
            raise RPCError("No controllers found in the coordination store")
        for candidate in candidates:
            if self._try_connect(candidate):
                self.address = candidate
                self.logger.debug("connected to controller %s", candidate)
                return
        raise RPCError(f"No controller answered a ping among {candidates}")

    def _try_connect(self, address, ping_timeout=2000):
        self._close_socket()
        self.socket = self.context.socket(zmq.REQ)
        self.socket.identity = self.identity.encode()
        self.socket.setsockopt(zmq.LINGER, 0)
        self.socket.connect(address)
        ping = RPCMessage({"payload": "ping"})
        ping.set_args_kwargs([], {})
        self.socket.send(ping.to_json().encode())
        if self.socket.poll(ping_timeout, zmq.POLLIN):
            reply = msg_factory(self.socket.recv())
            return reply.get("payload") == "pong"
        self._close_socket()
        return False

    def _close_socket(self):
        if self.socket is not None:
            self.socket.close()
            self.socket = None

    # -- proxy -------------------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def remote_call(*args, **kwargs):
            return self._rpc(name, args, kwargs)

        remote_call.__name__ = name
        return remote_call

    def _rpc(self, name, args, kwargs):
        started = time.perf_counter()
        # deadline, priority and client_id ride the envelope, not the
        # call params: the worker must never see them as query arguments
        deadline = kwargs.pop("deadline", None)
        priority = kwargs.pop("priority", None)
        msg = RPCMessage({"payload": name})
        if deadline is not None:
            msg.set_deadline(seconds=float(deadline))
        if priority is not None:
            msg["priority"] = priority
        if self.client_id is not None:
            msg["client_id"] = self.client_id
        msg.set_args_kwargs(list(args), kwargs)
        wire = msg.to_json().encode()
        last_error = None
        for attempt in range(1, self.retries + 1):
            self.last_call_attempts = attempt
            try:
                if self.socket is None:
                    self.connect()
                self.socket.send(wire)
                if self.socket.poll(int(self.timeout * 1000), zmq.POLLIN):
                    reply = self.socket.recv()
                    self.last_call_reply_bytes = len(reply)
                    try:
                        result = self._parse_reply(name, reply)
                    except RPCBusyError:
                        # the send/recv cycle completed: back off and resend
                        if attempt >= self.retries:
                            raise
                        last_error = "BUSY backpressure"
                        time.sleep(self._backoff_delay(attempt))
                        continue
                    self.last_call_duration = time.perf_counter() - started
                    return result
                last_error = f"timeout after {self.timeout}s"
            except zmq.ZMQError as exc:
                last_error = str(exc)
            if attempt >= self.retries:
                # the REQ socket is mid-cycle (sent, reply never read):
                # drop it, so that the next call reconnects cleanly
                self._close_socket()
                break
            self.logger.warning(
                "rpc %s attempt %d failed (%s), backing off + reconnecting",
                name, attempt, last_error,
            )
            time.sleep(self._backoff_delay(attempt))
            try:
                self.connect()
            except RPCError as exc:
                last_error = str(exc)
        self.last_call_duration = time.perf_counter() - started
        raise RPCError(
            f"rpc {name} failed after {self.last_call_attempts} attempts: "
            f"{last_error}"
        )

    def query(self, spec, deadline=None, priority=None):
        """The operator-DAG verb: ``spec`` as
        :func:`bqueryd_tpu_torch.plan.dag.compile_query` takes it (broadcast
        hash joins of small dimension tables, per-group top-k, quantile
        sketches, time-window rollups).  Returns ``(order, {column:
        np.ndarray})`` as ``groupby`` does: a top-k column holds each
        group's best-first values as an array, a quantile column the
        sketch's estimate (relative error at most the op's alpha).  The
        spec is validated here first, so a malformed one fails without a
        round trip; the controller validates it again."""
        from bqueryd_tpu_torch.plan import dag as dagmod

        dagmod.compile_query(spec)
        kwargs = {}
        if deadline is not None:
            kwargs["deadline"] = deadline
        if priority is not None:
            kwargs["priority"] = priority
        return self._rpc("query", (spec,), kwargs)

    def append(self, filename, data, deadline=None):
        """Append a batch of rows (a DataFrame or a mapping of column
        arrays) to a served shard: the controller sends it to every holder
        of ``filename`` (one per distinct (node, data_dir)) and replies
        once all confirmed.  Returns ``{"filename", "appended", "holders":
        {worker: {...}}}``.  Queries racing the append see the pre- or the
        post-append snapshot, never a torn one; a repeated query after it
        is refreshed from the appended chunks alone where it can be.  A
        holder's failure raises, naming it."""
        kwargs = {} if deadline is None else {"deadline": deadline}
        return self._rpc("append", (filename, data), kwargs)

    def _backoff_delay(self, attempt):
        return backoff.backoff_delay(attempt - 1, f"{self.identity}:{attempt}")

    def _parse_reply(self, name, reply):
        if name in ("groupby", "query"):
            return self._parse_groupby_reply(reply)
        msg = msg_factory(reply)
        if isinstance(msg, ErrorMessage):
            raise RPCError(msg.get("payload"))
        if "result" in msg:
            return msg.get_from_binary("result")
        return msg.get("payload")

    def _parse_groupby_reply(self, reply):
        from bqueryd_tpu_torch.models.query import ResultPayload

        # errors raised at the controller come back as JSON messages,
        # results and structured failures as a pickled envelope
        if reply[:1] == b"{":
            raise RPCError(msg_factory(reply).get("payload"))
        envelope = pickle.loads(reply)
        if not envelope.get("ok"):
            if envelope.get("busy"):
                raise RPCBusyError(envelope.get("error"))
            error_class = envelope.get("error_class")
            text = str(envelope.get("error"))
            if error_class:
                text = f"{error_class}: {text}"
            err = RPCError(text)
            err.error_class = error_class
            err.attempts = envelope.get("attempts") or []
            raise err
        merge_clock = time.perf_counter()
        payloads = [ResultPayload.from_bytes(b) for b in envelope["payloads"]]
        self.last_call_timings = envelope.get("timings")
        self.last_call_strategies = envelope.get("strategies")
        self.last_call_merge_modes = envelope.get("merge_modes")
        result = hostmerge.finalize_table(hostmerge.merge_payloads(payloads))
        self.last_call_client_merge_s = time.perf_counter() - merge_clock
        return result

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
attempt, raises :class:`RPCBusyError`.  ``last_call_answer_source`` and
``last_call_subsumed_from`` say how the controller produced the last
answer; ``rpc.metrics()`` returns its Prometheus text and
``rpc.debug_bundle()`` its debug bundle, ``rpc.health()`` the controller's
per-worker health statuses.  Every call mints a trace context
(``last_trace_id``): ``rpc.trace(trace_id)`` returns the query's span
waterfall, :meth:`RPC.autopsy` its attributed critical path,
``rpc.slow_queries()`` the slow-query ring, ``rpc.timeline()`` the
controller's snapshot ring and :meth:`RPC.capacity` the fleet capacity
model; ``slo_class=`` names the client's SLO class.  ``rpc.download(filenames=[...], bucket=...,
scheme=..., wait=True)`` distributes shards; ``downloads()``,
``download_progress()``, ``get_download_data()`` and
``delete_download(ticket)`` read and cancel tickets straight from the
store.  ``legacy_merge=True`` restores the reference's sum-of-shard-means
for ``groupby``.  A failed query raises :class:`RPCError`; a
structured failure carries ``error_class`` (``"DispatchExhausted"`` when
every dispatch attempt of a shard failed) and ``attempts``, the worker and
reason of each failed attempt.

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

import numpy as np
import zmq

import bqueryd_tpu_torch
from bqueryd_tpu_torch import backoff, chaos, worker
from bqueryd_tpu_torch.coordination import coordination_store
from bqueryd_tpu_torch.messages import ErrorMessage, RPCMessage, msg_factory
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.storage.ctable import ctable


class LocalRPC:
    """Groupby over local shards on ``cuda`` (or on the CPU when
    ``device="cpu"`` is passed).  Mergeable aggregations run on the
    executor, over the ``devices`` list (by default every visible card,
    as the worker's, and one device on the CPU); the rest per shard on the
    engine."""

    def __init__(self, data_dir, device=None, devices=None):
        self.data_dir = data_dir
        self.engine = QueryEngine(device=device)
        self.executor = MeshQueryExecutor(device=self.engine.device,
                                          n_devices=None, devices=devices)
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
        legacy_merge=False,
        slo_class=None,
    ):
        bqueryd_tpu_torch.configure_logging(loglevel)
        self.logger = bqueryd_tpu_torch.logger.getChild("rpc")
        chaos.maybe_arm_from_env()
        self.timeout = timeout
        self.retries = retries
        #: the admission quota bucket: sockets sharing a client_id share
        #: the controller's per-client quota; unset, each socket identity
        #: is its own bucket
        self.client_id = client_id
        #: the reference's sum-of-shard-means quirk: each shard finalized
        #: alone, then every measure re-merged with "sum"
        self.legacy_merge = legacy_merge
        #: the SLO class this client declares on every request (envelope
        #: key ``slo_class``): the controller's deadline-margin histograms
        #: and burn rates bucket its queries under it (unknown: "default")
        self.slo_class = slo_class
        #: the trace id minted for the most recent call:
        #: ``rpc.trace(rpc.last_trace_id)``, ``rpc.autopsy(...)``
        self.last_trace_id = None
        # the client's deserialize-and-merge wall per trace id (the newest
        # 32), folded into autopsy() as its client_deserialize segment
        self._client_merge_by_trace = {}
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
        #: how the most recent groupby or query answer was produced
        #: ("recompute", "cached", "delta", or served by the controller:
        #: "rollup", "subsume") and, for a served one, the rollup that
        #: proved it
        self.last_call_answer_source = None
        self.last_call_subsumed_from = None
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
        if name == "groupby" and self.legacy_merge:
            # the quirk needs per-shard payloads: no batched dispatch
            kwargs.setdefault("batch", False)
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
        if self.slo_class is not None:
            msg["slo_class"] = self.slo_class
        # every call mints a root trace context: the controller parents
        # the query's spans to it
        from bqueryd_tpu_torch.obs.trace import TraceContext

        ctx = TraceContext.new_root()
        msg.set_trace(ctx)
        self.last_trace_id = ctx.trace_id
        msg.set_args_kwargs(list(args), kwargs)
        wire = msg.to_json().encode()
        last_error = None
        for attempt in range(1, self.retries + 1):
            self.last_call_attempts = attempt
            try:
                if self.socket is None:
                    self.connect()
                # the rpc.call fault site: "timeout" discards the reply
                # window, "disconnect" forces a reconnect, "delay"
                # stretches the call
                fault = chaos.fire(
                    "rpc.call", verb=name, attempt=attempt,
                ) if chaos.enabled() else None
                if fault is not None and fault.action == "disconnect":
                    self._close_socket()
                    raise zmq.ZMQError(zmq.ENOTCONN, "chaos: disconnected")
                self.socket.send(wire)
                answered = self.socket.poll(int(self.timeout * 1000),
                                            zmq.POLLIN)
                if fault is not None and fault.action == "timeout":
                    answered = False  # as if the reply never arrived
                if answered:
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
        self.last_call_answer_source = envelope.get("answer_source")
        self.last_call_subsumed_from = envelope.get("subsumed_from")
        if self.legacy_merge:
            result = self._legacy_merge_tables(payloads)
        else:
            result = hostmerge.finalize_table(
                hostmerge.merge_payloads(payloads))
        self.last_call_client_merge_s = time.perf_counter() - merge_clock
        if self.last_trace_id:
            self._client_merge_by_trace[self.last_trace_id] = (
                self.last_call_client_merge_s)
            while len(self._client_merge_by_trace) > 32:
                self._client_merge_by_trace.pop(
                    next(iter(self._client_merge_by_trace)))
        return result

    # -- query autopsy and fleet capacity -------------------------------------
    def autopsy(self, trace_id=None):
        """The attributed critical path of one query (default: the
        controller's newest trace): named non-overlapping segments, their
        coverage of the wall and the dispatch attempts.  When this client
        merged the query's reply itself, its deserialize-and-merge wall,
        which the controller cannot see, is added as the
        ``client_deserialize`` segment and the coverage recomputed over
        the longer wall."""
        record = self._rpc("autopsy", (trace_id,) if trace_id else (), {})
        if not isinstance(record, dict):
            return record
        merge_s = self._client_merge_by_trace.get(record.get("trace_id"))
        if merge_s:
            segments = record.setdefault("segments", {})
            segments["client_deserialize"] = round(merge_s, 6)
            wall = float(record.get("wall_s") or 0.0) + merge_s
            covered = float(record.get("covered_s") or 0.0) + merge_s
            record["wall_s"] = round(wall, 6)
            record["covered_s"] = round(covered, 6)
            if wall > 0:
                record["coverage"] = round(covered / wall, 4)
        return record

    def capacity(self):
        """The controller's fleet capacity model (``obs.capacity``): per
        worker μ, λ, ρ and saturation state, fleet utilization, the
        predicted saturation knee and headroom, predicted against measured
        queue delay, the per-shard dispatch heat map and the shadow
        advisor's recommendations, which nothing acts on."""
        return self._rpc("capacity", (), {})

    @staticmethod
    def _legacy_merge_tables(payloads):
        """The reference's quirk mode without pandas: each shard's payload
        finalized alone, the tables stacked, then every measure summed per
        key (so a mean is the sum of the shards' means), keys in ascending
        order.  Returns ``(order, {column: np.ndarray})``."""
        tables = []
        key_cols = None
        for payload in payloads:
            if payload.get("kind") == "empty":
                continue
            key_cols = payload.get("key_cols", key_cols)
            tables.append(hostmerge.finalize_table(
                hostmerge.merge_payloads([payload])))
        if not tables:
            return [], {}
        order = tables[0][0]
        stacked = {c: np.concatenate([t[1][c] for t in tables])
                   for c in order}
        if key_cols is None:
            return order, stacked
        codes = np.stack([np.unique(stacked[c], return_inverse=True)[1]
                          .reshape(-1) for c in key_cols], axis=1)
        groups, first, group_of = np.unique(
            codes, axis=0, return_index=True, return_inverse=True)
        group_of = group_of.reshape(-1)
        out = {c: stacked[c][first] for c in key_cols}
        for c in order:
            if c in key_cols:
                continue
            values = stacked[c]
            acc = np.zeros(len(groups), dtype=np.result_type(values.dtype,
                                                             np.int64))
            np.add.at(acc, group_of, values)
            out[c] = acc
        return order, out

    # -- download helpers (client-local, straight to the store) ------------
    def get_download_data(self):
        """Raw ticket hashes keyed by their full store key."""
        data = {}
        prefix = bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX
        for key in self.store.keys(prefix + "*"):
            data[key] = self.store.hgetall(key)
        return data

    def downloads(self):
        """In-flight download tickets as ``(ticket, "done/total")``
        tuples; per-slot detail: :meth:`download_progress`."""
        out = []
        prefix = bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX
        for key, entries in self.get_download_data().items():
            done = sum(1 for v in entries.values() if v.endswith("_DONE"))
            out.append((key[len(prefix):], f"{done}/{len(entries)}"))
        return out

    def download_progress(self):
        """Per-slot download states: ``[(ticket, {(node, fileurl):
        state})]``; ERROR states are visible here."""
        out = []
        prefix = bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX
        for key, entries in self.get_download_data().items():
            progress = {}
            for slot, value in entries.items():
                node, _, fileurl = slot.partition("_")
                _, _, state = value.rpartition("_")
                progress[(node, fileurl)] = state
            out.append((key[len(prefix):], progress))
        return out

    def delete_download(self, ticket):
        """Cancel a ticket by deleting its slots: a downloader aborts its
        fetch at the next chunk.  True when the ticket existed."""
        key = bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX + ticket
        existed = bool(self.store.hgetall(key))
        self.store.delete(key)
        return existed

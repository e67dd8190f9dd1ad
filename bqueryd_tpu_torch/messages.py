"""Wire protocol: JSON dict envelopes with base64-pickled binary fields.

The port's copy of ``bqueryd_tpu/messages.py``, byte-compatible with it: a
message is a plain dict serialized to JSON with at least ``msg_type``,
``payload``, ``version`` and ``created``; call parameters travel as a
pickled ``{'args': ..., 'kwargs': ...}`` dict, base64-encoded, under
``params``; :func:`msg_factory` maps ``msg_type`` to the same classes.  A
message of either package parses under the other's factory.

Envelope keys the port's nodes read and write:

* client -> controller: ``payload`` (the verb), ``params``, ``deadline``
  (absolute unix time), ``token`` (the client socket, set by the
  controller), ``trace`` (the tracing context ``{"trace_id", "span_id"[,
  "parent_span_id"]}``, :meth:`Message.set_trace`; the controller stamps a
  child context on every CalcMessage) and ``slo_class`` (the client's SLO
  class, ``RPC(slo_class=...)``, :mod:`obs.slo`);
* controller -> worker (``CalcMessage``): ``token`` (the work unit),
  ``parent_token`` (the client query), ``filename`` (one shard or a list
  for a batched shard group), ``sole_shard``, ``plan`` (the pickled plan
  fragment, ``plan.logical.fragment_for``), ``deadline``, ``affinity``
  (its queue), ``worker_id`` (an append or rollup build pinned to one
  worker); the controller's bookkeeping keys ``_retries``,
  ``_not_before``, ``_backoff_s``, ``_excluded_workers`` and
  ``_attempt_history`` ride along;
* worker -> controller: ``data`` (the result payload bytes, sent as a
  frame of its own), ``phase_timings`` (``{phase: s, "_total": s}``),
  ``spans`` (the worker's trace spans, ``obs.trace.SpanRecorder.export``),
  ``effective_strategy``, ``merge_mode``, ``strategy``,
  ``deadline_remaining``, ``transient`` (on an ErrorMessage: a retryable
  fault the controller fails over); ``WorkerRegisterMessage`` carries
  ``worker_id``, ``node``, ``ip``, ``data_dir``, ``data_files``,
  ``workertype``, ``pid``, ``uptime``, ``msg_count``, ``shard_stats``
  (per-shard planning stats), ``backend_wedged`` (bool, the device-health
  latch of ``utils.devicehealth``), ``calibration`` (the worker's
  measured-cost strategy cells, ``plan.calibrate.summary_for_wire``,
  absorbed controller-side per worker; None while calibration is off or
  nothing is measured), ``work_errors`` and ``metrics`` (the error
  counter and the histogram snapshot the health scorer reads), ``debug``,
  ``pipeline_busy`` (the stage clocks the capacity model reads) and, from
  the liveness thread, ``liveness_only``.

:data:`SPAN_SCHEMA` declares every span name a query's trace timeline
can hold.

Pickled payloads assume a trusted network, as the reference does;
:meth:`Message.get_from_binary` is the one place that unpickles.
"""

import base64
import json
import pickle
import time

PICKLE_PROTOCOL = 4

# -- wire schema --------------------------------------------------------------
# The single declared truth of every envelope key that crosses (or rides) the
# wire: the reference's key set, diffed by ``bqueryd_tpu_torch.analysis.wire``
# against the key literals the port's wire modules (controller.py /
# worker.py / rpc.py) actually read and write.  A key added on one side
# without the other is a lint failure, not a silent ``None`` three hops
# later.  Adding a key to the protocol means adding it here, with help text,
# in the same commit.

#: JSON envelope keys (Message dicts).  Keys prefixed ``_`` are controller-
#: internal riders: they travel inside the process (and harmlessly on the
#: wire) but no peer may ever rely on them.
ENVELOPE_SCHEMA = {
    # base Message fields (set by the constructor / accessors below)
    "msg_type": "message class discriminator (msg_factory dispatch)",
    "payload": "verb name on requests; result/error text on replies",
    "version": "protocol version, currently 1",
    "created": "sender timestamp (preserved across parse/copy)",
    "params": "base64-pickled {'args', 'kwargs'} call parameters",
    "deadline": "absolute unix deadline, propagated client->worker",
    "trace": "distributed-tracing context {trace_id, span_id, ...}",
    # client -> controller
    "token": "request identity: client socket token / shard work token",
    "priority": "admission queue priority (ascending)",
    "client_id": "admission quota bucket for RPC(client_id=...)",
    "slo_class": "client-declared SLO class (RPC(slo_class=...)): selects "
                 "the deadline-margin histogram / burn-rate bucket the "
                 "query's outcome lands in (obs.slo; unknown classes fold "
                 "into 'default')",
    "function": "remote-execution verb: pickled callable name",
    "needs_local": "route only to workers holding the file locally",
    # controller -> worker shard dispatch
    "parent_token": "client query a shard CalcMessage belongs to",
    "filename": "shard rootdir(s) this work unit covers",
    "affinity": "pin dispatch to one worker id",
    "sole_shard": "single-shard query: worker may finalize on device",
    "plan": "base64-pickled plan fragment (query + predicates + strategy)",
    "bundle": "base64-pickled shared-scan bundle fragment: shared shard "
              "group + group-key columns plus one record per member query "
              "(member_id, aggs, filters, deadline) — the worker executes "
              "the whole compatible micro-batch as one scan "
              "(plan.bundle.bundle_fragment)",
    "dag": "base64-pickled operator-DAG wire form (plan.dag.OperatorDAG."
           "to_wire): the rpc.query verb's compiled program — broadcast "
           "join dimension table, window rollup, post-derivation filter, "
           "and the ordered physical agg list with extended op strings "
           "(topk:<k>:..., quantile:<q>:<alpha>).  Authoritative on "
           "capable workers; pre-DAG workers fall back to the positional "
           "params and reject the extended ops, which the controller "
           "rewrites into the structured UnsupportedOp mixed-version "
           "error.  Extended partials ride the "
           "ordinary data frame as ResultPayload part kinds "
           "topk_values/topk_offsets and sketch_keys/sketch_counts/"
           "sketch_offsets (parallel.opexec)",
    "worker_id": "explicit dispatch target / WRM sender identity",
    "ticket": "download/movebcolz ticket id",
    # controller-originated rollup build/refresh (serve.rollup)
    "rollup_prior": "on rollup refresh dispatches: the entry's previous "
                    "partials bytes for this shard — the worker merges the "
                    "appended tail into them when the stored chunk prefix "
                    "still validates (ops.workingset.growth_since)",
    "rollup_base": "base64-pickled chunk-prefix fingerprint "
                   "(ops.workingset.table_growth_base): on refresh "
                   "dispatches, the prefix the prior partials were computed "
                   "against; on build/refresh replies, the fingerprint of "
                   "the shard the returned partials cover — the next "
                   "refresh validates against it",
    "rollup_mode": "rollup reply provenance: 'rebuild' (full scan), 'delta' "
                   "(tail chunks aggregated and hostmerged into the "
                   "prior), 'fresh' (no growth, prior returned verbatim)",
    "rollup_zones": "base64-pickled per-column census of the shard the "
                    "rollup covers ({col: {kind, zones, nulls}}): dtype "
                    "kind plus per-chunk (min,max) zone maps — what the "
                    "subsumption lattice's key-fold null-freedom and "
                    "full-chunk filter proofs check (serve.subsume)",
    # worker -> controller replies
    "data": "raw result payload bytes",
    "phase_timings": "per-phase seconds dict; whole-call wall under _total",
    "spans": "worker span list folded into the query trace timeline",
    "deadline_remaining": "seconds left at reply serialization",
    "strategy": "the planner's kernel-strategy hint, echoed on the reply",
    "effective_strategy": "physical kernel route the worker ran post-guards "
                          "(matmul/scatter/sort/host; 'cached' = result-"
                          "cache hit, nothing compiled; 'delta' = delta-"
                          "maintained refresh: only appended chunks "
                          "re-aggregated, merged into the cached result) — "
                          "hints may normalize",
    "merge_mode": "how the reply's partials merged: 'device' (the "
                  "executor's device merge, final table only fetched — "
                  "groupbys and batched extended-DAG dispatches), 'host' "
                  "(hostmerge.merge_payloads fallback, also "
                  "the per-shard DAG pipeline's cross-shard merge), 'none' "
                  "(single payload, nothing merged)",
    "bundle_members": "on shared-scan bundle replies: the member_id list "
                      "the reply's data frame covers (its bytes are one "
                      "pickled {payloads: {member_id: bytes}, errors: "
                      "{member_id: text}} envelope the controller "
                      "demultiplexes per member)",
    "member_shares": "on shared-scan bundle replies: {member_id: fraction} "
                     "of the bundle's shared scan wall each member is "
                     "accountable for (measured per-member walls on the "
                     "fallback path, an equal split on the one-program "
                     "mesh path, 0.0 for result-cache hits) — the "
                     "controller scales the shared phase_timings by it so "
                     "a slow BUNDLE never lands every member in the "
                     "slow-query ring with the whole bundle's wall",
    "transient": "on worker ErrorMessage replies: the failure is retryable "
                 "(chaos.TransientError class, e.g. DeviceBusyError) — the "
                 "controller fails the shard over to a different holder "
                 "instead of aborting the query",
    "error": "failure detail on error/ticketdone paths",
    "result": "base64-pickled rpc verb return value",
    # worker register messages (WRM heartbeats)
    "node": "worker host name",
    "ip": "worker advertised IP",
    "data_dir": "worker shard directory",
    "data_files": "shard files the worker serves",
    "workertype": "calc | download",
    "pid": "worker process id",
    "uptime": "seconds since worker start",
    "msg_count": "messages handled by the worker",
    "backend_wedged": "device-health latch (health scoring + routing)",
    "work_errors": "cumulative error-counter total (health windows)",
    "debug": "node debug-bundle slice (flight tail, compile registry, ...)",
    "shard_stats": "per-shard planning stats (rows, min/max, cardinality)",
    "calibration": "measured-cost strategy calibration summary "
                   "(plan.calibrate cells, absorbed controller-side)",
    "metrics": "histogram snapshot (bucket-vector mergeable)",
    "pipeline_busy": "cumulative per-stage StageClock busy seconds "
                     "(parallel.pipeline snapshot) — the controller's "
                     "capacity model (obs.capacity) derives per-stage busy "
                     "deltas from it to name each worker's bottleneck "
                     "stage; None for non-calc roles",
    "liveness_only": "heartbeat-thread WRM: skip data_files rescan",
    # controller gossip + bookkeeping riders
    "from": "gossiping controller address",
    "info": "base64-pickled controller info snapshot (peer gossip)",
    "others": "peer-controller snapshots inside rpc.info(include_peers)",
    "last_seen": "controller-local: last WRM/gossip arrival time",
    "busy": "controller-local: worker has work in flight",
    "hb_only": "controller-local: worker seen only via heartbeats so far",
    "_retries": "controller-internal: dispatch retry count rider",
    "_excluded_workers": "controller-internal: holders this shard already "
                         "failed on — failover dispatch avoids them while "
                         "another candidate exists",
    "_attempt_history": "controller-internal: per-attempt worker/fault "
                        "records, surfaced in the structured exhaustion "
                        "envelope (attempts key)",
    "_not_before": "controller-internal: failover backoff gate — the "
                   "dispatcher holds the shard until this timestamp",
    "_backoff_s": "controller-internal: the backoff delay charged before "
                  "this attempt's dispatch — the attribution layer carves "
                  "it out of the dispatch span as a retry_backoff segment",
    "_bundle_parents": "controller-internal: member_id -> parent_token map "
                       "of a bundle dispatch; rides the envelope so the "
                       "reply (msg.copy) carries its own demux table",
    "_dispatch_queued_ts": "controller-internal: dispatch queue-entry time",
    "_relayed": "controller-internal: fan-out marker on relayed verbs",
    "_obs": "controller-internal: per-query observability state rider",
}

#: the pickled groupby RESULT envelope (not a Message): what rpc.py unpickles
#: from a calc reply
RESULT_ENVELOPE_SCHEMA = {
    "ok": "False when the query failed (error carries the reason)",
    "busy": "admission BUSY backpressure marker (RPCBusyError client-side)",
    "payloads": "per-shard-group ResultPayload byte strings (client result "
                "envelope); in a shared-scan bundle reply data frame, the "
                "{member_id: ResultPayload bytes} demux map",
    "v": "version stamp of a shared-scan bundle reply data frame",
    "errors": "in a shared-scan bundle reply data frame: {member_id: text} "
              "member-only failures (deadline expiry, member-shape "
              "rejection) — the controller aborts just those members",
    "timings": "compacted per-phase timing summary",
    "strategies": "planner report: {hints: hint->dispatches, effective: "
                  "shard-group->executed kernel route}",
    "merge_modes": "shard-group -> merge_mode the worker reported "
                   "(device/host/none; see the merge_mode envelope key)",
    "error": "failure reason when ok is False",
    "error_class": "structured failure class when ok is False (e.g. "
                   "'DispatchExhausted' once the retry/failover budget is "
                   "spent); None for plain errors",
    "attempts": "per-attempt worker/fault history ({worker, reason, "
                "retries, ts} dicts) behind an error_class failure — the "
                "flight-recorder trail a client can act on",
    "answer_source": "answer provenance: 'recompute' | 'cached' "
                     "(every shard from a worker result cache) | 'delta' "
                     "(delta-maintained refresh) | 'rollup' (materialized "
                     "rollup served verbatim) | 'subsume' (folded from a "
                     "finer rollup by the subsumption lattice); surfaced "
                     "as rpc.last_call_answer_source",
    "subsumed_from": "on rollup/subsume answers: the materialized-view key "
                     "the answer was proven from (serve.subsume.view_key); "
                     "None on dispatched answers",
}

#: keys legitimately touched on only one side of the wire MODULES — the peer
#: lives elsewhere (the Message base class in this module, plan/admission,
#: client tooling).  Every waiver states where the other side is.
WIRE_ONE_SIDED_OK = {
    "msg_type": "written/read by Message.__init__ and msg_factory here",
    "version": "written by Message.__init__ here; never read yet (v1)",
    "created": "written by Message.__init__ here; age derived by readers",
    "params": "set_args_kwargs/get_args_kwargs accessors in this module",
    "deadline": "written via Message.set_deadline; read via the deadline "
                "helpers in this module",
    "trace": "set_trace/get_trace accessors in this module",
    "priority": "written by rpc.py; read by plan/admission.py (not a wire "
                "module)",
    "function": "read by worker.py execute_code; set by client tooling",
    "needs_local": "read by controller dispatch; set by download tooling",
    "ticket": "written by controller ticketdone replies; read by download "
              "tooling and coordination paths",
    "last_seen": "controller-local worker_map/gossip bookkeeping",
    "hb_only": "controller-local worker_map bookkeeping",
    "_obs": "controller-internal rider, intentionally unread elsewhere",
    "deadline_remaining": "informational reply field for clients/tests; "
                          "the controller deliberately ignores it",
    "strategy": "informational reply field (the hint echo) for "
                "clients/tests; dispatch accounting happens at send time",
    "others": "written into get_info(); read by rpc.info() clients/tests",
    "ip": "operator-facing WRM field surfaced via rpc.info(); the "
          "controller routes by socket identity, not this",
    "pid": "operator-facing WRM field surfaced via rpc.info()",
    "uptime": "operator-facing WRM field surfaced via rpc.info()",
    "msg_count": "operator-facing WRM field surfaced via rpc.info()",
    "v": "bundle data-envelope version stamp written by "
         "worker._handle_bundle; the controller's demux tolerates v1 only "
         "today, so nothing reads it yet",
}

#: every span name a query's trace timeline can hold, with its meaning;
#: the reference's table.  Raw entries are worker PhaseTimer phase names,
#: which reach the wire under their public name
#: (``obs.trace.PHASE_SPAN_NAMES``); each public name has an attribution
#: segment in ``obs.slo.SPAN_CATEGORIES``
SPAN_SCHEMA = {
    # controller-side spans
    "groupby": "the query's controller root span: submit -> final reply",
    "admission": "admission-queue wait: submit -> launch (or -> staging)",
    "batch_window": "micro-batch staging wait: window stage -> flush "
                    "(BQUERYD_TPU_BATCH_WINDOW_MS)",
    "plan": "logical-plan compilation + rewrites inside rpc_groupby",
    "dispatch": "one dispatch ATTEMPT: queue entry -> worker send; tags "
                "carry worker/retries/backoff_s/hedge so the attribution "
                "layer can split out retry_backoff and hedge duplicates",
    "demux": "shared-scan bundle reply demultiplex at the controller",
    # worker-side spans (public names)
    "calc": "the worker's root span for one CalcMessage",
    "storage_decode": "raw phase 'open': shard open + column decode",
    "prune": "raw phase: chunk-level predicate pruning",
    "filter": "raw phase 'mask': where-term mask evaluation",
    "factorize": "raw phase: key factorization (engine path)",
    "join_probe": "raw phase 'join': broadcast hash-join key factorize + "
                  "dimension probe gather (operator-DAG executor)",
    "window_rollup": "raw phase 'rollup': datetime-bucket derived group "
                     "key computation (operator-DAG executor)",
    "align": "raw phase: cross-shard key alignment / global key space",
    "h2d_transfer": "raw phase 'layout': host->device uploads (tag bytes: "
                    "what they copied, 0 on working-set hits)",
    "kernel": "raw phase 'aggregate': the kernel launches (their device "
              "time lands in the fetch that waits for them; tag device_s "
              "holds the CUDA-event time)",
    "d2h_fetch": "raw phase 'fetch': device->host fetch of the merged "
                 "result buffer (tag bytes: what it fetched)",
    "merge": "raw phases 'collect'/'hostmerge': materialization / host "
             "value-keyed merge of partials",
    "reply_serialization": "raw phase 'serialize': result payload encoding",
    # the port's own: the worker loop's receipt, riding the calc reply
    "worker_receive": "the worker loop's receipt of a work item: frames, "
                      "decode, Busy, the fault and deadline checks, to the "
                      "calc root (tag loop_wait_s: the poll wait before it)",
    # raw PhaseTimer names (surface via obs.trace.PHASE_SPAN_NAMES)
    "open": "raw name of storage_decode",
    "mask": "raw name of filter",
    "join": "raw name of join_probe",
    "rollup": "raw name of window_rollup",
    "layout": "raw name of h2d_transfer",
    "aggregate": "raw name of kernel",
    "fetch": "raw name of d2h_fetch",
    "collect": "raw name of merge (device-path materialization)",
    "hostmerge": "raw name of merge (host value-keyed merge)",
    "serialize": "raw name of reply_serialization",
}


class MalformedMessage(Exception):
    pass


class Message(dict):
    """A message is a dict; subclasses only pin ``msg_type``."""

    msg_type = None

    def __init__(self, datadict=None):
        super().__init__()
        if not datadict:
            datadict = {}
        self.update(datadict)
        self["payload"] = datadict.get("payload")
        self["version"] = datadict.get("version", 1)
        self["msg_type"] = self.msg_type
        # the sender's timestamp survives parse and copy
        self["created"] = datadict.get("created", time.time())

    def copy(self):
        return msg_factory(dict(self))

    def isa(self, payload_or_class):
        """True if this message's type matches ``payload_or_class`` (a
        Message subclass) or its payload equals it (a verb)."""
        if self.msg_type is not None and self.msg_type == getattr(
            payload_or_class, "msg_type", "_"
        ):
            return True
        return self.get("payload") == payload_or_class

    # -- binary fields -----------------------------------------------------
    def add_as_binary(self, key, value):
        self[key] = base64.b64encode(
            pickle.dumps(value, protocol=PICKLE_PROTOCOL)
        ).decode("ascii")

    def get_from_binary(self, key, default=None):
        buf = self.get(key)
        if not buf:
            return default
        if isinstance(buf, str):
            buf = buf.encode("ascii")
        return pickle.loads(base64.b64decode(buf))

    # -- deadlines ---------------------------------------------------------
    # An absolute unix timestamp under ``deadline``: the client stamps it,
    # the controller copies it onto every CalcMessage and expires queued
    # work past it, and the worker refuses work that arrives expired.
    def set_deadline(self, seconds):
        """A deadline ``seconds`` from now."""
        self["deadline"] = time.time() + float(seconds)

    def deadline_remaining(self, now=None):
        """Seconds until the deadline, or None when none is set."""
        deadline = self.get("deadline")
        if deadline is None:
            return None
        return float(deadline) - (time.time() if now is None else now)

    def deadline_expired(self, now=None):
        remaining = self.deadline_remaining(now)
        return remaining is not None and remaining <= 0

    # -- tracing -----------------------------------------------------------
    # The context is a plain dict, parsed by obs.trace.TraceContext.from_wire
    # at the hops that record spans.
    def set_trace(self, wire):
        """Attach a wire context dict (or a TraceContext, through its
        ``to_wire``); None clears."""
        if wire is None:
            self.pop("trace", None)
            return
        if hasattr(wire, "to_wire"):
            wire = wire.to_wire()
        self["trace"] = dict(wire)

    def get_trace(self):
        """The wire context dict, or None."""
        wire = self.get("trace")
        return wire if isinstance(wire, dict) else None

    # -- call params -------------------------------------------------------
    def set_args_kwargs(self, args, kwargs):
        self.add_as_binary("params", {"args": args, "kwargs": kwargs})

    def get_args_kwargs(self):
        params = self.get_from_binary("params", {})
        return params.get("args", []), params.get("kwargs", {})

    def to_json(self):
        return json.dumps(self)


class WorkerRegisterMessage(Message):
    msg_type = "worker_register"


class CalcMessage(Message):
    """A unit of work for a calc worker: positional ``params`` and, from a
    planning controller, the ``plan`` fragment the worker executes."""

    msg_type = "calc"


class RPCMessage(Message):
    msg_type = "rpc"


class ErrorMessage(Message):
    msg_type = "error"


class BusyMessage(Message):
    msg_type = "busy"


class DoneMessage(Message):
    msg_type = "done"


class StopMessage(Message):
    msg_type = "stop"


class TicketDoneMessage(Message):
    """A downloader's word that a download ticket finished (``ticket``),
    or failed (``error``): the controller answers the clients waiting on
    it."""

    msg_type = "ticketdone"


MSG_MAPPING = {
    "calc": CalcMessage,
    "rpc": RPCMessage,
    "error": ErrorMessage,
    "worker_register": WorkerRegisterMessage,
    "busy": BusyMessage,
    "done": DoneMessage,
    "ticketdone": TicketDoneMessage,
    "stop": StopMessage,
    None: Message,
}


def msg_factory(msg):
    """Parse ``msg`` (JSON str/bytes or dict) into its Message subclass;
    an unknown ``msg_type`` (the reference's other message types among
    them) gives the base class.  Unparseable input raises
    :class:`MalformedMessage`."""
    if isinstance(msg, bytes):
        msg = msg.decode("utf-8", errors="replace")
    if isinstance(msg, str):
        try:
            msg = json.loads(msg)
        except ValueError as exc:
            raise MalformedMessage(f"unparseable message: {exc}") from exc
    if not msg:
        return Message()
    msg_class = MSG_MAPPING.get(msg.get("msg_type"), Message)
    return msg_class(msg)

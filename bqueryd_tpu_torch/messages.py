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
  controller);
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
  counter and the histogram snapshot the health scorer reads), ``debug``
  and, from the liveness thread, ``liveness_only``.

Pickled payloads assume a trusted network, as the reference does;
:meth:`Message.get_from_binary` is the one place that unpickles.
"""

import base64
import json
import pickle
import time

PICKLE_PROTOCOL = 4


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

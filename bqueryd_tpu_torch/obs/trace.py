"""Distributed tracing: context propagation, span recording and storage.

The port's copy of ``bqueryd_tpu/obs/trace.py``, with the same wire form.
A query's identity is a ``trace_id`` minted by the RPC client and carried
in the message envelope (``messages.Message`` key ``"trace"``).  Every hop
derives child spans:

    client rpc span                                (root; client side)
      └─ controller "groupby" span                 (query lifetime)
           ├─ "admission" span                     (queue wait)
           ├─ "plan" span                          (compile + rewrite)
           └─ "dispatch" span (per work unit)      (queue -> send)
                └─ worker "calc" span              (whole CalcMessage)
                     ├─ "storage_decode" ("open")
                     ├─ "align" / "filter" ("mask")
                     ├─ "h2d_transfer" ("layout")
                     ├─ "kernel" ("aggregate": the CUDA launches)
                     ├─ "d2h_fetch" ("fetch": the packed device -> host
                     │            copy, which waits for the kernels)
                     ├─ "merge" ("collect"/"hostmerge")
                     └─ "reply_serialization" ("serialize")

The span names are declared in ``messages.SPAN_SCHEMA`` and each has an
attribution segment in :mod:`bqueryd_tpu_torch.obs.slo`.

Workers return their spans in calc replies (``"spans"``); the controller
assembles each query's timeline into a :class:`TraceStore` ring, read back
with ``rpc.trace(trace_id)``.  Span timestamps are wall clock
(``time.time()``), so that spans of several nodes share one timeline;
durations use ``time.perf_counter``.  The active context also rides a
contextvar, so that ``utils.tracing.trace_span`` can tag its profiler
ranges with the trace id.

Standard library only.
"""

import contextlib
import contextvars
import os
import time

#: envelope key carrying the wire TraceContext (see messages.py schema note)
TRACE_KEY = "trace"

#: worker PhaseTimer phase -> public span name (the taxonomy in the module
#: docstring); unmapped phases keep their own name
PHASE_SPAN_NAMES = {
    "open": "storage_decode",
    "mask": "filter",
    "join": "join_probe",
    "rollup": "window_rollup",
    "layout": "h2d_transfer",
    "aggregate": "kernel",
    "fetch": "d2h_fetch",
    "collect": "merge",
    "hostmerge": "merge",
    "serialize": "reply_serialization",
}

_current = contextvars.ContextVar("bqueryd_tpu_trace", default=None)


def new_id(nbytes=8):
    return os.urandom(nbytes).hex()


class TraceContext:
    """(trace_id, span_id, parent_span_id) — the propagation triple.

    ``span_id`` is the ACTIVE span at the sender; a receiver parents its own
    root span to it.  Wire form is a plain JSON-safe dict so it rides the
    message envelope without pickling."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id, span_id, parent_span_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    @classmethod
    def new_root(cls):
        return cls(trace_id=new_id(16), span_id=new_id())

    def child(self):
        """A context for the next hop: fresh span under the current one."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_id(),
            parent_span_id=self.span_id,
        )

    def to_wire(self):
        wire = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id:
            wire["parent_span_id"] = self.parent_span_id
        return wire

    @classmethod
    def from_wire(cls, wire):
        """Parse the envelope dict; None (or malformed) -> None."""
        if not isinstance(wire, dict):
            return None
        trace_id = wire.get("trace_id")
        span_id = wire.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        return cls(trace_id, span_id, wire.get("parent_span_id"))


def current_trace():
    """The TraceContext bound to this thread/task, or None."""
    return _current.get()


@contextlib.contextmanager
def use_trace(ctx):
    """Bind ``ctx`` as the active TraceContext for the block (contextvar:
    thread- and task-local)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def make_span(trace_id, name, start_ts, duration_s, span_id=None,
              parent_span_id=None, node=None, tags=None):
    """One JSON-safe span record."""
    span = {
        "trace_id": trace_id,
        "span_id": span_id or new_id(),
        "parent_span_id": parent_span_id,
        "name": name,
        "start_ts": round(float(start_ts), 6),
        "duration_s": round(float(duration_s), 6),
    }
    if node is not None:
        span["node"] = node
    if tags:
        span["tags"] = dict(tags)
    return span


class SpanRecorder:
    """Collects spans for one unit of work (a worker's CalcMessage, say).

    Opens a root span at construction; child spans default their parent to
    it.  ``export`` closes the root (duration = lifetime so far) and returns
    the JSON-safe span list, ready for a reply's ``"spans"`` field."""

    def __init__(self, trace_id, node=None, root_name="calc",
                 root_parent=None, span_names=None):
        self.trace_id = trace_id
        self.node = node
        self.span_names = span_names or {}
        self.root_span_id = new_id()
        self._root_name = root_name
        self._root_parent = root_parent
        self._root_start = time.time()
        self._root_clock = time.perf_counter()
        self.spans = []

    def record(self, name, start_ts, duration_s, parent_span_id=None,
               tags=None):
        self.spans.append(
            make_span(
                self.trace_id,
                self.span_names.get(name, name),
                start_ts,
                duration_s,
                parent_span_id=parent_span_id or self.root_span_id,
                node=self.node,
                tags=tags,
            )
        )

    @contextlib.contextmanager
    def span(self, name, parent_span_id=None, tags=None):
        start_ts = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(
                name, start_ts, time.perf_counter() - t0,
                parent_span_id=parent_span_id, tags=tags,
            )

    def export(self, tags=None):
        """Root span + children, oldest first.  ``tags`` land on the ROOT
        span — per-unit facts that belong to the whole calc (e.g. the
        worker's device-memory attribution for this query)."""
        root = make_span(
            self.trace_id,
            self._root_name,
            self._root_start,
            time.perf_counter() - self._root_clock,
            span_id=self.root_span_id,
            parent_span_id=self._root_parent,
            node=self.node,
            tags=tags,
        )
        return [root] + sorted(self.spans, key=lambda s: s["start_ts"])


class TraceStore:
    """Ring buffer of assembled per-query timelines, keyed by trace_id.

    Bounded by BOTH entry count (``BQUERYD_TPU_TRACE_BUFFER``, default 256)
    and bytes (``BQUERYD_TPU_TRACE_BUFFER_BYTES``, default 16 MiB): span
    counts scale with shard counts, so an entry-only cap let a long-running
    controller's wide-query timelines grow without limit.  ``evictions``
    counts entries dropped for either reason (exported as a gauge).  A
    timeline is ``{"trace_id", "wall_s", "created_ts", "ok", "spans": [...]}``
    plus any extra keys the controller attaches (filenames, pruned, ...)."""

    DEFAULT_MAX_BYTES = 16 << 20

    def __init__(self, capacity=None, max_bytes=None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("BQUERYD_TPU_TRACE_BUFFER", 256))
            except ValueError:
                capacity = 256
        if max_bytes is None:
            try:
                max_bytes = int(
                    os.environ.get(
                        "BQUERYD_TPU_TRACE_BUFFER_BYTES",
                        self.DEFAULT_MAX_BYTES,
                    )
                )
            except ValueError:
                max_bytes = self.DEFAULT_MAX_BYTES
        self.capacity = max(1, capacity)
        self.max_bytes = max(1024, max_bytes)
        self._order = []    # trace_ids, oldest first
        self._store = {}
        self._sizes = {}
        self._nbytes = 0
        self.evictions = 0

    def put(self, trace_id, timeline):
        from bqueryd_tpu_torch.obs.flightrec import approx_json_bytes

        if trace_id in self._store:
            self._order.remove(trace_id)
            self._nbytes -= self._sizes.pop(trace_id, 0)
        size = approx_json_bytes(timeline)
        self._store[trace_id] = timeline
        self._sizes[trace_id] = size
        self._nbytes += size
        self._order.append(trace_id)
        while len(self._order) > self.capacity or (
            self._nbytes > self.max_bytes and len(self._order) > 1
        ):
            evicted = self._order.pop(0)
            self._store.pop(evicted, None)
            self._nbytes -= self._sizes.pop(evicted, 0)
            self.evictions += 1

    def get(self, trace_id):
        return self._store.get(trace_id)

    def latest(self):
        """The newest timeline (or None) — the debug bundle's default when
        no trace_id is requested."""
        return self._store.get(self._order[-1]) if self._order else None

    @property
    def nbytes(self):
        return self._nbytes

    def __len__(self):
        return len(self._store)

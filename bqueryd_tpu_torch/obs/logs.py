"""Structured logging and the slow-query ring.

The port's copy of ``bqueryd_tpu/obs/logs.py``.  ``JsonLogFormatter``
renders every log record as one JSON object carrying
``trace_id``/``query_id``/``node_id``, so that a fleet's logs join the RPC
trace waterfall (``rpc.trace(trace_id)``).  The correlation fields come
from a contextvar the node binds while it handles a query
(:func:`bind_log_context`).  Opt in with ``BQUERYD_TPU_LOG_JSON=1``
(:func:`bqueryd_tpu_torch.configure_logging` installs the formatter).

``SlowQueryLog`` is the controller's ring of offending queries: every
finished groupby whose wall exceeds ``BQUERYD_TPU_SLOW_QUERY_MS``
(default 1000, read per call, 0 records everything) is kept with its plan
signature, strategy hints, pruned-shard count and per-shard phase
breakdown, read back with ``rpc.slow_queries()``.

Standard library only.
"""

import collections
import contextlib
import contextvars
import json
import logging
import os
import time

_log_ctx = contextvars.ContextVar("bqueryd_tpu_log_ctx", default=None)

DEFAULT_SLOW_QUERY_MS = 1000.0


def log_context():
    """The correlation dict bound to this thread/task (may be None)."""
    return _log_ctx.get()


@contextlib.contextmanager
def bind_log_context(**fields):
    """Bind correlation fields (trace_id=..., query_id=...) for the block;
    nested binds merge over the outer ones."""
    merged = dict(_log_ctx.get() or {})
    merged.update({k: v for k, v in fields.items() if v is not None})
    token = _log_ctx.set(merged)
    try:
        yield
    finally:
        _log_ctx.reset(token)


class JsonLogFormatter(logging.Formatter):
    """One JSON object per record: ts, level, logger, msg, node_id plus any
    bound correlation fields and exception text."""

    def __init__(self, node_id=None):
        super().__init__()
        self.node_id = node_id

    def format(self, record):
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if self.node_id is not None:
            out["node_id"] = self.node_id
        ctx = _log_ctx.get()
        if ctx:
            out.update(ctx)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def slow_query_threshold_ms():
    """Read per call so a live node can be re-tuned; invalid values fall
    back to the default rather than disabling the log silently."""
    raw = os.environ.get("BQUERYD_TPU_SLOW_QUERY_MS")
    if raw is None:
        return DEFAULT_SLOW_QUERY_MS
    try:
        return float(raw)
    except ValueError:
        return DEFAULT_SLOW_QUERY_MS


class SlowQueryLog:
    """Bounded ring buffer of offenders — bounded by BOTH entry count and
    bytes (``BQUERYD_TPU_SLOW_QUERY_BYTES``, default 4 MiB): entries carry
    per-shard phase breakdowns, so wide queries made the entry-only cap an
    unbounded-memory promise on long-running controllers.  ``evictions``
    counts entries dropped for either reason (exported as a gauge)."""

    DEFAULT_MAX_BYTES = 4 << 20

    def __init__(self, capacity=128, max_bytes=None):
        if max_bytes is None:
            try:
                max_bytes = int(
                    os.environ.get(
                        "BQUERYD_TPU_SLOW_QUERY_BYTES",
                        self.DEFAULT_MAX_BYTES,
                    )
                )
            except ValueError:
                max_bytes = self.DEFAULT_MAX_BYTES
        self.capacity = max(1, capacity)
        self.max_bytes = max(1024, max_bytes)
        self._entries = collections.deque()
        self._sizes = collections.deque()
        self._nbytes = 0
        self.evictions = 0

    def maybe_record(self, wall_s, entry):
        """Record ``entry`` if ``wall_s`` crosses the live threshold.
        Returns True when recorded."""
        from bqueryd_tpu_torch.obs.flightrec import approx_json_bytes

        if wall_s * 1000.0 < slow_query_threshold_ms():
            return False
        record = dict(entry)
        record.setdefault("ts", time.time())
        record["wall_ms"] = round(wall_s * 1000.0, 3)
        size = approx_json_bytes(record)
        self._entries.append(record)
        self._sizes.append(size)
        self._nbytes += size
        while len(self._entries) > self.capacity or (
            self._nbytes > self.max_bytes and len(self._entries) > 1
        ):
            self._entries.popleft()
            self._nbytes -= self._sizes.popleft()
            self.evictions += 1
        return True

    def entries(self):
        """Newest last, JSON-safe."""
        return list(self._entries)

    def entry_for(self, trace_id):
        """The (newest) ring entry for one trace id, or None — lets
        ``rpc.autopsy(trace_id)`` attach the offender's slow-query record
        (plan signature, strategy hints, scaled phase breakdown) to the
        attribution instead of making the operator join two verbs by
        hand."""
        if not trace_id:
            return None
        for record in reversed(self._entries):
            if record.get("trace_id") == trace_id:
                return dict(record)
        return None

    @property
    def nbytes(self):
        return self._nbytes

    def __len__(self):
        return len(self._entries)

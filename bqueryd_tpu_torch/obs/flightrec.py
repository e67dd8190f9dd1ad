"""The flight recorder and the cross-node debug bundle.

The port's copy of ``bqueryd_tpu/obs/flightrec.py``.  A
:class:`FlightRecorder` is a bounded, always-on ring per node of recent
envelopes, state changes and query outcomes: the record of what led up to
a wedge, a timeout or a lost worker.  It is bounded both in entries and in
bytes (one huge traceback must neither hold the whole history hostage nor
grow without limit), with an eviction counter to size it from data.

:func:`build_bundle` assembles the JSON debug artifact behind the
controller's ``rpc.debug_bundle()`` verb: the controller's section and
each worker's slice absorbed from its heartbeats.  A dead peer degrades the
bundle, never fails it: its last slice ships marked stale, and workers
that never reported are listed under ``"partial"``.  Every string passes
:func:`redact_paths`: a filesystem path outside the declared data roots
becomes ``<redacted>/basename``.

Standard library only.
"""

import collections
import json
import os
import re
import tempfile
import threading
import time

#: the bundle schema, the reference's: /4 carries the ``serving`` section
#: of the controller (rollup entry states, tracked-view heat, append
#: epochs and the latest subsumption decisions)
BUNDLE_SCHEMA = "bqueryd_tpu.debug_bundle/4"

DEFAULT_CAPACITY = 512
DEFAULT_MAX_BYTES = 1 << 20  # 1 MiB of ring per node

#: absorbed worker slices older than this are marked ``stale`` in the
#: bundle (the worker may be dead; its last words still ship)
DEFAULT_STALE_AFTER_S = 120.0


def approx_json_bytes(obj):
    """A cheap recursive estimate of ``obj``'s JSON size, for the ring's
    byte bound (an exact ``json.dumps`` per event would cost more than the
    event)."""
    if obj is None or isinstance(obj, bool):
        return 4
    if isinstance(obj, (int, float)):
        return 12
    if isinstance(obj, str):
        return len(obj) + 2
    if isinstance(obj, bytes):
        return len(obj) + 2
    if isinstance(obj, dict):
        return 2 + sum(
            approx_json_bytes(k) + approx_json_bytes(v) + 2
            for k, v in obj.items()
        )
    if isinstance(obj, (list, tuple, set)):
        return 2 + sum(approx_json_bytes(v) + 1 for v in obj)
    return len(str(obj)) + 2


class FlightRecorder:
    """Bounded ring of JSON-safe events, newest last.

    Hot-path callers check ``obs.enabled()`` themselves; rare forensic
    events (worker removals, failed builds) are recorded always.
    ``BQUERYD_TPU_FLIGHT_CAPACITY`` and ``BQUERYD_TPU_FLIGHT_BYTES`` set
    the bounds when the constructor is not given them."""

    #: lock discipline, statically checked by bqueryd_tpu_torch.analysis
    #: (lock-unguarded-attr)
    _bqtpu_guarded_ = {
        "_lock": ("_events", "_sizes", "_nbytes", "_evictions", "_seq"),
    }

    def __init__(self, node_id=None, capacity=None, max_bytes=None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("BQUERYD_TPU_FLIGHT_CAPACITY",
                                              DEFAULT_CAPACITY))
            except ValueError:
                capacity = DEFAULT_CAPACITY
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get("BQUERYD_TPU_FLIGHT_BYTES",
                                               DEFAULT_MAX_BYTES))
            except ValueError:
                max_bytes = DEFAULT_MAX_BYTES
        self.node_id = node_id
        self.capacity = max(1, capacity)
        self.max_bytes = max(1024, max_bytes)
        self._events = collections.deque()
        self._sizes = collections.deque()
        self._nbytes = 0
        self._evictions = 0
        self._seq = 0
        self._lock = threading.Lock()

    def record(self, kind, **fields):
        event = {"ts": round(time.time(), 6), "kind": kind}
        event.update(fields)
        size = approx_json_bytes(event)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
            self._sizes.append(size)
            self._nbytes += size
            while len(self._events) > self.capacity or (
                self._nbytes > self.max_bytes and len(self._events) > 1
            ):
                self._events.popleft()
                self._nbytes -= self._sizes.popleft()
                self._evictions += 1
        return event

    def events(self):
        """The whole ring, oldest first."""
        with self._lock:
            return [dict(e) for e in self._events]

    def tail(self, limit=32):
        """The newest ``limit`` events, oldest first: the heartbeat-sized
        view."""
        with self._lock:
            picked = list(self._events)[-max(1, limit):]
            return [dict(e) for e in picked]

    @property
    def seq(self):
        """Events recorded so far (a change key for advertisements)."""
        with self._lock:
            return self._seq

    @property
    def evictions(self):
        with self._lock:
            return self._evictions

    @property
    def nbytes(self):
        with self._lock:
            return self._nbytes

    def __len__(self):
        with self._lock:
            return len(self._events)


# -- redaction ----------------------------------------------------------------

#: an absolute filesystem path of depth >= 2; the lookbehind keeps URL
#: authority slashes (``tcp://host``) and interior path slashes from
#: matching as fresh path starts
_PATH_RE = re.compile(r"(?<![\w:/.])/(?:[\w.+-]+/)+[\w.+-]+")


def _redact_string(text, allowed):
    def sub(match):
        path = match.group(0)
        for prefix in allowed:
            if prefix and (
                path == prefix or path.startswith(prefix.rstrip("/") + "/")
            ):
                return path
        return "<redacted>/" + path.rsplit("/", 1)[-1]

    return _PATH_RE.sub(sub, text)


def redact_paths(obj, allowed_prefixes=()):
    """Replace, recursively, absolute filesystem paths outside the allowed
    roots with ``<redacted>/basename``, in dict keys too (worker slices key
    some maps by filename).  Other leaves pass through."""
    allowed = tuple(p for p in allowed_prefixes if p)
    if isinstance(obj, str):
        return _redact_string(obj, allowed)
    if isinstance(obj, dict):
        return {
            redact_paths(k, allowed): redact_paths(v, allowed)
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [redact_paths(v, allowed) for v in obj]
    return obj


# -- bundle assembly ----------------------------------------------------------

def build_bundle(controller_section, worker_snapshots, trace_id=None,
                 allowed_path_prefixes=(), stale_after_s=DEFAULT_STALE_AFTER_S,
                 now=None):
    """The cross-node debug artifact, with the reference's schema.

    ``controller_section``: the controller's own state dict.
    ``worker_snapshots``: ``{worker_id: {"data": <absorbed slice or None>,
    "ts": <absorb time>, "registered": bool}}``.  Workers with no slice
    land in ``"partial"``."""
    now = time.time() if now is None else now
    workers = {}
    partial = []
    for worker_id in sorted(worker_snapshots):
        snap = worker_snapshots[worker_id] or {}
        data = snap.get("data")
        entry = {
            "registered": bool(snap.get("registered")),
            "snapshot": data,
        }
        ts = snap.get("ts")
        if ts is not None:
            entry["age_s"] = round(max(now - ts, 0.0), 3)
            entry["stale"] = entry["age_s"] > stale_after_s
        if data is None:
            partial.append(worker_id)
        workers[worker_id] = entry
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "generated_ts": round(now, 6),
        "trace_id": trace_id,
        "controller": controller_section,
        "workers": workers,
        "partial": partial,
    }
    return redact_paths(bundle, allowed_path_prefixes)


def dump_bundle(bundle, role="node", directory=None):
    """Write a bundle as one JSON file and return its path.  Directory:
    ``directory``, else ``BQUERYD_TPU_DEBUG_DIR``, else the temporary
    directory."""
    directory = (
        directory
        or os.environ.get("BQUERYD_TPU_DEBUG_DIR")
        or tempfile.gettempdir()
    )
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory,
        f"bqueryd_tpu_debug_{role}_{os.getpid()}_{int(time.time())}.json",
    )
    with open(path, "w") as f:
        json.dump(bundle, f, default=str, indent=1)
    return path

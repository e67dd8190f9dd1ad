"""Observability of the port: metrics, tracing, logs, forensics and the
fleet's accounting.

The port's copy of ``bqueryd_tpu/obs``, re-exporting what the reference's
package does:

* :mod:`.metrics`   — typed Counter/Gauge/Histogram on a per-node
  registry, Prometheus text rendering (``rpc.metrics()`` and the opt-in
  ``/metrics`` endpoint of :mod:`.http`), fixed log-scale buckets whose
  cross-node merge is a vector add;
* :mod:`.trace`     — the trace context propagated client -> controller ->
  worker, span recording per phase, and the controller's timeline ring
  behind ``rpc.trace(trace_id)``;
* :mod:`.logs`      — the JSON log formatter carrying trace, query and
  node ids, and the slow-query ring behind ``rpc.slow_queries()``;
* :mod:`.profile`   — kernel-library build accounting, per-name and
  per-shape call registry of the device entry points, device-memory
  gauges (``torch.cuda.memory_stats``);
* :mod:`.flightrec` — a bounded always-on flight ring per node and the
  cross-node ``rpc.debug_bundle()`` artifact;
* :mod:`.health`    — per-worker health scoring from the WRM signals,
  which the controller's dispatch acts on (``rpc.health()``);
* :mod:`.slo`       — per-query critical-path attribution
  (``rpc.autopsy``), per-client-class SLO accounting and the controller's
  snapshot ring behind ``rpc.timeline()``;
* :mod:`.capacity`  — the controller's queueing-model capacity accounting
  behind ``rpc.capacity()``.

``BQUERYD_TPU_METRICS=0`` (read on every call) or :func:`set_enabled`
turns off the hot path (span recording, histogram observations, the
envelope and dispatch flight events, call accounting); the controller's
counters stay live, as they steer behaviour, and so do forensic events
(worker removals, failed queries).

Standard library only.
"""

import os

from bqueryd_tpu_torch.obs.logs import (  # noqa: F401
    JsonLogFormatter,
    SlowQueryLog,
    bind_log_context,
    log_context,
    slow_query_threshold_ms,
)
from bqueryd_tpu_torch.obs.metrics import (  # noqa: F401
    BYTES_BUCKETS,
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    LoopClock,
    MetricsRegistry,
    RegistryCounters,
    merge_histogram_snapshots,
    quantile_from_snapshot,
)
from bqueryd_tpu_torch.obs.trace import (  # noqa: F401
    PHASE_SPAN_NAMES,
    TRACE_KEY,
    SpanRecorder,
    TraceContext,
    TraceStore,
    current_trace,
    make_span,
    new_id,
    use_trace,
)
from bqueryd_tpu_torch.obs.flightrec import (  # noqa: F401
    BUNDLE_SCHEMA,
    FlightRecorder,
    approx_json_bytes,
    build_bundle,
    dump_bundle,
    redact_paths,
)
from bqueryd_tpu_torch.obs.health import (  # noqa: F401
    STATUS_DEGRADED,
    STATUS_OK,
    STATUS_WEDGED,
    HealthScorer,
)
from bqueryd_tpu_torch.obs import capacity  # noqa: F401
from bqueryd_tpu_torch.obs import profile  # noqa: F401
from bqueryd_tpu_torch.obs import slo  # noqa: F401

_enabled = True


def enabled():
    """Whether the observability hot path is on: ``BQUERYD_TPU_METRICS=0``
    (read per call) or :func:`set_enabled(False)` turns it off."""
    return _enabled and os.environ.get("BQUERYD_TPU_METRICS", "1") != "0"


def set_enabled(value):
    """Process-wide switch."""
    global _enabled
    _enabled = bool(value)

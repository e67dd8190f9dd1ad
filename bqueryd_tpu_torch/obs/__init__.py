"""Observability of the port: the metrics registry and the flight recorder.

The port's copy of the first part of ``bqueryd_tpu/obs``:

* :mod:`.metrics`   — typed Counter/Gauge/Histogram on a per-node
  registry, Prometheus text rendering (``rpc.metrics()``), fixed
  log-scale buckets whose cross-node merge is a vector add;
* :mod:`.flightrec` — a bounded always-on flight ring per node and the
  cross-node ``rpc.debug_bundle()`` artifact;
* :mod:`.health`    — per-worker health scoring from the WRM signals,
  which the controller's dispatch acts on (``rpc.health()``).

The reference's tracing, structured logs, slow-query log, compile
profiling, SLO accounting and capacity model are not ported yet.

``BQUERYD_TPU_METRICS=0`` (read on every call) or :func:`set_enabled`
turns off the hot-path events (the envelope and dispatch flight events);
the controller's counters stay live, as they steer behaviour, and so do
forensic events (worker removals, failed builds).

Standard library only.
"""

import os

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
from bqueryd_tpu_torch.obs.metrics import (  # noqa: F401
    BYTES_BUCKETS,
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistryCounters,
    merge_histogram_snapshots,
    quantile_from_snapshot,
)

_enabled = True


def enabled():
    """Whether the observability hot path is on: ``BQUERYD_TPU_METRICS=0``
    (read per call) or :func:`set_enabled(False)` turns it off."""
    return _enabled and os.environ.get("BQUERYD_TPU_METRICS", "1") != "0"


def set_enabled(value):
    """Process-wide switch."""
    global _enabled
    _enabled = bool(value)

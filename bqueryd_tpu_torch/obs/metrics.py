"""Typed metrics, a per-node registry and Prometheus text rendering.

The port's copy of ``bqueryd_tpu/obs/metrics.py``:

* :class:`Counter`   — monotonic, plus ``set_total`` for the controller's
  dict-compatible counter view (:class:`RegistryCounters`);
* :class:`Gauge`     — settable, or backed by a callback (``fn=``) read at
  render time;
* :class:`Histogram` — fixed log-scale buckets (:data:`LATENCY_BUCKETS_S`,
  :data:`BYTES_BUCKETS`) stored as a non-cumulative count vector, so that
  histograms of several nodes merge by vector addition
  (:func:`merge_histogram_snapshots`).

A :class:`MetricsRegistry` belongs to one node, not to the process: a
controller and its workers may run as threads of one process, and their
metrics must not mix.  Rendering follows the Prometheus text format
v0.0.4; :meth:`MetricsRegistry.lint` checks names (``^bqueryd_tpu_
[a-z0-9_]+$``), help texts and bucket vectors.  The rendered text of a
registry equals the reference's for the same sequence of operations.

Standard library only.
"""

import math
import re
import threading

METRIC_NAME_RE = re.compile(r"^bqueryd_tpu_[a-z0-9_]+$")

#: fixed log-scale latency buckets (seconds), ~2.5x steps from 100 µs to
#: 60 s; a module constant, as every node must hold the same vector for
#: the bucket-vector merge to be right
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
)

#: fixed log-scale size buckets (bytes), 4x steps from 256 B to 1 GiB
BYTES_BUCKETS = tuple(float(256 << (2 * i)) for i in range(12))


def _fmt_value(v):
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\""))
        for k, v in sorted(labels.items())
    )
    return "{%s}" % inner


class Counter:
    """Monotonic counter.  ``set_total`` exists only for
    :class:`RegistryCounters`, which mirrors absolute values."""

    kind = "counter"

    def __init__(self, name, help_text, labels=None):
        self.name = name
        self.help = help_text
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def set_total(self, value):
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value

    def samples(self):
        with self._lock:
            return [(self.name, self.labels, self._value)]


class Gauge:
    """Settable value, or one read from ``fn`` at render time."""

    kind = "gauge"

    def __init__(self, name, help_text, labels=None, fn=None):
        self.name = name
        self.help = help_text
        self.labels = dict(labels or {})
        self._fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    @property
    def value(self):
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                # a callback must never break rendering: NaN marks it
                # unreadable
                return float("nan")
        with self._lock:
            return self._value

    def samples(self):
        return [(self.name, self.labels, self.value)]


class Histogram:
    """Fixed-bucket histogram: non-cumulative per-bucket counts (the last
    slot is the +Inf overflow) and a running sum; rendering converts to
    cumulative ``_bucket{le=...}`` samples."""

    kind = "histogram"

    def __init__(self, name, help_text, labels=None, buckets=LATENCY_BUCKETS_S):
        self.name = name
        self.help = help_text
        self.labels = dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if value <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value

    @property
    def count(self):
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def snapshot(self):
        """JSON-safe ``{"buckets", "counts", "sum"}`` (counts
        non-cumulative)."""
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
            }

    def samples(self):
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
        out = []
        cumulative = 0
        for b, c in zip(self.buckets, counts):
            cumulative += c
            labels = dict(self.labels)
            labels["le"] = _fmt_value(float(b))
            out.append((self.name + "_bucket", labels, cumulative))
        cumulative += counts[-1]
        inf_labels = dict(self.labels)
        inf_labels["le"] = "+Inf"
        out.append((self.name + "_bucket", inf_labels, cumulative))
        out.append((self.name + "_sum", self.labels, total_sum))
        out.append((self.name + "_count", self.labels, cumulative))
        return out


class MetricsRegistry:
    """One node's metrics: get-or-create by (name, label set), grouped into
    families for rendering.  Creation takes the registry's lock; a metric's
    ``inc``/``observe`` takes only its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}   # (name, labels-frozenset) -> metric
        self._families = {}  # name -> (kind, help)

    def _get_or_create(self, cls, name, help_text, labels, **kw):
        key = (name, frozenset((labels or {}).items()))
        with self._lock:
            hit = self._metrics.get(key)
            if hit is not None:
                return hit
            family = self._families.get(name)
            if family is not None and family[0] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {family[0]}"
                )
            metric = cls(name, help_text, labels=labels, **kw)
            self._metrics[key] = metric
            self._families.setdefault(name, (cls.kind, help_text))
            return metric

    def register(self, metric):
        """Adopt an existing metric instance (one shared by several
        registries).  Registering the same instance again is a no-op;
        another instance under a taken (name, labels) key raises."""
        key = (metric.name, frozenset(metric.labels.items()))
        with self._lock:
            hit = self._metrics.get(key)
            if hit is metric:
                return metric
            if hit is not None:
                raise ValueError(
                    f"metric {metric.name!r} already registered with a "
                    "different instance"
                )
            family = self._families.get(metric.name)
            if family is not None and family[0] != metric.kind:
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{family[0]}"
                )
            self._metrics[key] = metric
            self._families.setdefault(metric.name, (metric.kind, metric.help))
            return metric

    def counter(self, name, help_text, labels=None):
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name, help_text, labels=None, fn=None):
        return self._get_or_create(Gauge, name, help_text, labels, fn=fn)

    def histogram(self, name, help_text, labels=None,
                  buckets=LATENCY_BUCKETS_S):
        return self._get_or_create(
            Histogram, name, help_text, labels, buckets=buckets
        )

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def render(self):
        """Prometheus text exposition format v0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
            families = dict(self._families)
        by_family = {}
        for metric in metrics:
            by_family.setdefault(metric.name, []).append(metric)
        lines = []
        for name in sorted(by_family):
            kind, help_text = families[name]
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for metric in by_family[name]:
                for sample_name, labels, value in metric.samples():
                    lines.append(
                        f"{sample_name}{_fmt_labels(labels)} "
                        f"{_fmt_value(value)}"
                    )
        return "\n".join(lines) + "\n"

    def histogram_snapshot(self):
        """Every histogram as a JSON-safe mergeable snapshot: ``{name:
        [{"labels", "buckets", "counts", "sum"}, ...]}``."""
        out = {}
        for metric in self.metrics():
            if metric.kind != "histogram":
                continue
            entry = metric.snapshot()
            entry["labels"] = dict(metric.labels)
            out.setdefault(metric.name, []).append(entry)
        return out

    def lint(self):
        """Violations as strings (empty when clean): a name that fails
        :data:`METRIC_NAME_RE` (counters may end in ``_total``), a missing
        help text, a histogram whose buckets are neither shared vector, a
        malformed label name."""
        problems = []
        for metric in self.metrics():
            base = metric.name
            if base.endswith("_total"):
                base = base[: -len("_total")]
            if not METRIC_NAME_RE.match(base):
                problems.append(
                    f"{metric.name}: name fails {METRIC_NAME_RE.pattern}")
            if not (metric.help or "").strip():
                problems.append(f"{metric.name}: missing help text")
            if metric.kind == "histogram" and metric.buckets not in (
                tuple(LATENCY_BUCKETS_S), tuple(BYTES_BUCKETS)
            ):
                problems.append(
                    f"{metric.name}: bucket vector is neither "
                    "LATENCY_BUCKETS_S nor BYTES_BUCKETS (cross-node "
                    "merge precondition: buckets must be a shared module "
                    "constant)"
                )
            for label in metric.labels:
                if not re.match(r"^[a-z][a-z0-9_]*$", label):
                    problems.append(f"{metric.name}: bad label name {label!r}")
        return problems


def quantile_from_snapshot(entry, q):
    """Approximate quantile of one snapshot entry: the upper bound of the
    bucket where the cumulative count reaches ``q`` (the +Inf slot reports
    the last finite bound).  None for an empty or malformed entry."""
    try:
        buckets = list(entry["buckets"])
        counts = list(entry["counts"])
    except (KeyError, TypeError):
        return None
    total = sum(counts)
    if total <= 0 or len(counts) != len(buckets) + 1:
        return None
    threshold = max(float(q), 0.0) * total
    cumulative = 0
    for bound, count in zip(buckets, counts):
        cumulative += count
        if cumulative >= threshold:
            return float(bound)
    return float(buckets[-1]) if buckets else None


def merge_histogram_snapshots(snapshots):
    """Merge :meth:`MetricsRegistry.histogram_snapshot` dicts by
    bucket-vector addition.  Series merge when (name, labels) match and the
    bucket vectors are identical; a mismatched one is named under
    ``"_skipped"`` instead of being added wrongly."""
    merged = {}   # name -> {labels_key: {"labels", "buckets", "counts", "sum"}}
    skipped = []
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for name, series in snap.items():
            if not isinstance(series, list):
                continue
            for entry in series:
                try:
                    labels = dict(entry.get("labels") or {})
                    buckets = list(entry["buckets"])
                    counts = list(entry["counts"])
                    esum = float(entry.get("sum", 0.0))
                except (KeyError, TypeError, ValueError):
                    skipped.append(name)
                    continue
                key = frozenset(labels.items())
                slot = merged.setdefault(name, {}).get(key)
                if slot is None:
                    merged[name][key] = {
                        "labels": labels,
                        "buckets": buckets,
                        "counts": counts,
                        "sum": esum,
                    }
                elif (slot["buckets"] != buckets
                      or len(slot["counts"]) != len(counts)):
                    skipped.append(name)
                else:
                    slot["counts"] = [
                        a + b for a, b in zip(slot["counts"], counts)
                    ]
                    slot["sum"] += esum
    out = {
        name: list(by_labels.values()) for name, by_labels in merged.items()
    }
    if skipped:
        out["_skipped"] = sorted(set(skipped))
    return out


class RegistryCounters(dict):
    """The controller's ``counters`` dict, backed by the registry: every
    ``counters["x"] = v`` (``+=`` included) also sets the typed
    :class:`Counter` ``bqueryd_tpu_<x>_total``, so the same numbers show in
    the Prometheus text with no second bookkeeping at the call sites."""

    def __init__(self, registry, spec):
        """``spec``: ordered mapping of dict key -> help text."""
        super().__init__()
        self._registry = registry
        self._mirror = {}
        for key, help_text in spec.items():
            self._mirror[key] = registry.counter(
                f"bqueryd_tpu_{key}_total", help_text
            )
            super().__setitem__(key, 0)

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        mirror = self._mirror.get(key)
        if mirror is None:
            # a key outside the spec still gets a metric; lint flags a
            # malformed name
            mirror = self._mirror[key] = self._registry.counter(
                f"bqueryd_tpu_{key}_total", f"controller counter {key}"
            )
        mirror.set_total(value)

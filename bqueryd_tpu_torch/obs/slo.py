"""Critical-path attribution and SLO accounting: where a query's wall went.

The port's copy of ``bqueryd_tpu/obs/slo.py``; its records equal the
reference's for the same timelines and clocks.  The port adds the worker
loop's ``worker_receive`` segment, a record's ``tagged`` sums and a
staged query's ``batch``.

:func:`attribute` turns an assembled trace timeline (a
:class:`bqueryd_tpu_torch.obs.trace.TraceStore` entry) into an
**attribution record**: the query's wall decomposed into named,
NON-OVERLAPPING segments, their covered share of the wall (``coverage``),
and the remainder reported as ``unattributed``.

Attribution is a priority sweep, not a tree walk: spans of concurrent
dispatches overlap on the wall clock, so every instant of the query
interval is charged to the most specific span active at that instant
(:data:`SEGMENT_PRIORITY`: a kernel beats the calc root it nests in,
worker phases beat the dispatch window, everything beats the groupby root,
whose uncovered residue is ``unattributed``).  Dispatch spans carry their
attempt metadata (retries, ``backoff_s``, the hedge flag) as tags:
attribution carves each attempt's backoff out as ``retry_backoff`` and
lists the attempts.

On top sits the SLO layer:

* :class:`SLOTracker` — per-client-class accounting.  Classes come from
  ``BQUERYD_TPU_SLO_CLASSES`` (``name:target_s[:objective]`` comma list;
  a ``default`` class always exists); clients declare theirs with
  ``RPC(slo_class=...)`` (envelope key ``slo_class``).  Each finished
  query observes its deadline margin into
  ``bqueryd_tpu_slo_margin_seconds{slo_class=...}``, bumps
  ``bqueryd_tpu_slo_queries_total`` / ``bqueryd_tpu_slo_violations_total``
  and feeds the rolling-window burn-rate gauges
  ``bqueryd_tpu_slo_burn_rate{slo_class=...,window=...}`` (the violation
  rate over the window divided by the class's error budget).
* :class:`SnapshotTimeline` — a bounded ring of periodic controller
  snapshots (counters, queue depths, latency quantiles, burn rates) behind
  ``rpc.timeline()``.

Standard library only.
"""

import os
import threading
import time

from bqueryd_tpu_torch.utils.env import env_num

#: span name -> attribution segment: every public span name that
#: ``messages.SPAN_SCHEMA`` declares has a segment here, so that no span
#: falls into ``unattributed`` for want of one
SPAN_CATEGORIES = {
    "groupby": "query",                 # the root: residue = unattributed
    "admission": "admission_wait",
    "batch_window": "batch_window_wait",
    "plan": "plan",
    "dispatch": "dispatch",             # backoff_s tag splits retry_backoff
    "demux": "bundle_demux",
    "calc": "worker_other",             # worker residue outside any phase
    "storage_decode": "storage_decode",
    "prune": "storage_decode",          # chunk pruning is scan-side work
    "filter": "filter",
    "factorize": "align",               # key factorization is alignment work
    "align": "align",
    "join_probe": "join_probe",         # DAG broadcast-join probe gather
    "window_rollup": "window_rollup",   # DAG datetime-bucket key derivation
    "h2d_transfer": "h2d_transfer",
    "kernel": "kernel",
    "d2h_fetch": "d2h_fetch",
    "merge": "collective_merge",
    "reply_serialization": "reply_serialization",
    "worker_receive": "worker_receive",
}

#: numeric span tags an attribution record sums per segment (``tagged``):
#: the bytes a transfer moved, the worker's poll wait before a work item
SUMMED_TAGS = ("bytes", "loop_wait_s")

#: segments synthesized by attribution (or the client) without a recorded
#: span of their own, so that a synthetic segment is told from an
#: undeclared span name
SYNTHETIC_SEGMENTS = (
    "retry_backoff",        # carved out of dispatch spans via tags.backoff_s
    "hedge_dispatch",       # dispatch spans tagged hedge=True
    "client_deserialize",   # measured client-side, added by RPC.autopsy()
    "unattributed",         # the honest remainder
)

#: sweep priority, most-specific first: where spans overlap, the earliest
#: entry here wins the instant.  Worker phases beat the calc root they nest
#: in; worker spans beat the dispatch window they execute inside; dispatch
#: machinery beats admission/window staging; the "query" root loses to
#: everything (its exclusive residue is what ``unattributed`` reports).
SEGMENT_PRIORITY = (
    "d2h_fetch",
    "kernel",
    "collective_merge",
    "h2d_transfer",
    "filter",
    "join_probe",
    "window_rollup",
    "align",
    "storage_decode",
    "reply_serialization",
    "worker_other",
    "worker_receive",
    "bundle_demux",
    "retry_backoff",
    "hedge_dispatch",
    "dispatch",
    "plan",
    "batch_window_wait",
    "admission_wait",
    "client_deserialize",
    "query",
)

_PRIO = {name: i for i, name in enumerate(SEGMENT_PRIORITY)}

#: the attribution coverage a query with real walls is held to
COVERAGE_TARGET = 0.95


def _segment_for(span_name):
    """Segment for a span name; unknown names keep themselves as segment
    (visible in the record instead of vanishing) at dispatch-ish priority."""
    return SPAN_CATEGORIES.get(span_name, span_name)


def _intervals_from_spans(spans):
    """(start, end, segment, span) tuples, with dispatch spans split into
    their backoff window (``retry_backoff``) and live queue/send time, and
    hedge dispatches re-labelled ``hedge_dispatch``."""
    out = []
    for span in spans:
        if not isinstance(span, dict):
            continue
        try:
            start = float(span.get("start_ts"))
            dur = max(float(span.get("duration_s", 0.0)), 0.0)
        except (TypeError, ValueError):
            continue
        name = span.get("name")
        segment = _segment_for(name)
        tags = span.get("tags") or {}
        if segment == "dispatch":
            if tags.get("hedge"):
                out.append((start, start + dur, "hedge_dispatch", span))
                continue
            try:
                backoff = min(max(float(tags.get("backoff_s", 0.0)), 0.0), dur)
            except (TypeError, ValueError):
                backoff = 0.0
            if backoff > 0.0:
                out.append((start, start + backoff, "retry_backoff", span))
                if dur > backoff:
                    out.append((start + backoff, start + dur, "dispatch", span))
                continue
        out.append((start, start + dur, segment, span))
    return out


def attribute(timeline):
    """Build the attribution record for one assembled trace timeline.

    Returns a JSON-safe dict: ``trace_id``, ``ok``, ``wall_s`` (the groupby
    root span's duration — submit to final reply at the controller),
    ``segments`` ({segment: seconds}, non-overlapping by construction,
    summing with ``unattributed`` to ``wall_s``), ``coverage`` (attributed
    fraction of the wall), ``covered_s``, ``tagged`` (``{segment: {tag:
    sum}}`` of the :data:`SUMMED_TAGS` its spans carry, when any does),
    ``attempts`` (per dispatch
    attempt: worker, retries, backoff, hedge — the ``_attempt_history``
    view a client can act on), ``bundle`` (member share metadata when
    the query rode a shared-scan bundle) and, for a query the micro-batch
    window staged, ``batch`` (``staged``, ``members``, ``shared_scan``).
    Never raises on malformed timelines — attribution is forensics, not
    the query path."""
    spans = [s for s in (timeline or {}).get("spans") or []
             if isinstance(s, dict)]
    record = {
        "trace_id": (timeline or {}).get("trace_id"),
        "ok": (timeline or {}).get("ok"),
        "wall_s": 0.0,
        "covered_s": 0.0,
        "coverage": 0.0,
        "segments": {},
        "unattributed_s": 0.0,
        "attempts": [],
    }
    root = next((s for s in spans if s.get("name") == "groupby"), None)
    intervals = _intervals_from_spans(spans)
    if root is not None:
        try:
            q0 = float(root.get("start_ts"))
            q1 = q0 + max(float(root.get("duration_s", 0.0)), 0.0)
        except (TypeError, ValueError):
            root = None
    if root is None:
        if not intervals:
            return record
        q0 = min(i[0] for i in intervals)
        q1 = max(i[1] for i in intervals)
    wall = max(q1 - q0, 0.0)
    record["wall_s"] = round(wall, 6)
    if wall <= 0.0:
        return record

    # priority sweep over the elementary intervals of the query window:
    # each instant goes to the most-specific active segment; instants where
    # only the "query" root is active are the unattributed residue.  Event
    # sweep with per-segment active counts — O(n log n) in span count plus
    # O(#segments) per boundary, so a wide fan-out's hundreds of spans stay
    # cheap enough for per-query assembly
    events = []   # (ts, +1/-1, segment)
    for start, end, segment, _span in intervals:
        start, end = max(start, q0), min(end, q1)
        if end > start:
            events.append((start, 1, segment))
            events.append((end, -1, segment))
    events.sort(key=lambda e: e[0])
    bounds = sorted({q0, q1, *(ts for ts, _d, _s in events)})
    active = {}   # segment -> open-span count
    segments = {}
    ei = 0
    for lo, hi in zip(bounds, bounds[1:]):
        while ei < len(events) and events[ei][0] <= lo:
            _ts, delta, segment = events[ei]
            count = active.get(segment, 0) + delta
            if count > 0:
                active[segment] = count
            else:
                active.pop(segment, None)
            ei += 1
        if hi <= lo:
            continue
        best = "query"
        best_prio = _PRIO["query"]
        for segment in active:
            prio = _PRIO.get(segment, _PRIO["dispatch"])
            if prio < best_prio:
                best, best_prio = segment, prio
        segments[best] = segments.get(best, 0.0) + (hi - lo)

    unattributed = segments.pop("query", 0.0)
    covered = sum(segments.values())
    record["segments"] = {
        name: round(seconds, 6)
        for name, seconds in sorted(
            segments.items(), key=lambda kv: -kv[1]
        )
    }
    record["unattributed_s"] = round(unattributed, 6)
    record["covered_s"] = round(covered, 6)
    record["coverage"] = round(covered / wall, 4) if wall else 0.0
    tagged = {}
    for span in spans:
        tags = span.get("tags") or {}
        for tag in SUMMED_TAGS:
            value = tags.get(tag)
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                sums = tagged.setdefault(_segment_for(span.get("name")), {})
                sums[tag] = sums.get(tag, 0) + value
    if tagged:
        record["tagged"] = tagged

    # per-attempt dispatch history (tagged in _record_dispatch_span):
    # each retry with its backoff window, each hedge duplicate, each
    # failover exclusion — the msg's _attempt_history, as the trace sees it
    attempts = []
    failed_spans = []
    for span in spans:
        if span.get("name") != "dispatch":
            continue
        tags = span.get("tags") or {}
        if tags.get("wait"):
            # the send→reply / hedge-race transit windows (one per reply):
            # covered time, not attempts of their own
            continue
        if tags.get("failed"):
            # a failed attempt's in-flight window: an ANNOTATION of the
            # attempt its queue-entry span already represents, folded in
            # below — one entry per physical dispatch attempt
            failed_spans.append((tags, span))
            continue
        attempts.append({
            "worker": tags.get("worker"),
            "retries": tags.get("retries", 0),
            "backoff_s": tags.get("backoff_s", 0.0),
            "hedge": bool(tags.get("hedge")),
            "excluded": tags.get("excluded") or [],
            "start_ts": span.get("start_ts"),
            "duration_s": span.get("duration_s"),
        })
    for tags, span in failed_spans:
        match = next(
            (
                a for a in attempts
                if a["worker"] == tags.get("worker")
                and a["retries"] == tags.get("retries", 0)
                and "failed" not in a
            ),
            None,
        )
        if match is not None:
            match["failed"] = tags.get("failed")
            # how long the shard sat on that worker before failover fired
            match["inflight_s"] = span.get("duration_s")
        else:
            # no matching queue span (e.g. trimmed timeline): keep the
            # failure visible as its own entry rather than dropping it
            attempts.append({
                "worker": tags.get("worker"),
                "retries": tags.get("retries", 0),
                "backoff_s": 0.0,
                "hedge": False,
                "excluded": [],
                "start_ts": span.get("start_ts"),
                "duration_s": span.get("duration_s"),
                "failed": tags.get("failed"),
            })
    attempts.sort(key=lambda a: a.get("start_ts") or 0.0)
    record["attempts"] = attempts

    # shared-scan bundle metadata: the worker spans carry this member's
    # share of the shared wall (tagged at demux) — the true-wall segments
    # above stay untouched; the share contextualizes them per member
    share = None
    for span in spans:
        tags = span.get("tags") or {}
        if "bundle_share" in tags:
            try:
                share = float(tags["bundle_share"])
            except (TypeError, ValueError):
                share = None
            break
    if share is not None:
        worker_segments = {
            "worker_other", "storage_decode", "filter", "align",
            "h2d_transfer", "kernel", "d2h_fetch", "collective_merge",
            "reply_serialization",
        }
        record["bundle"] = {
            "share": round(share, 6),
            # this member's accountable slice of the shared scan phases
            "member_segments": {
                name: round(seconds * share, 6)
                for name, seconds in segments.items()
                if name in worker_segments
            },
        }

    # what the micro-batch window's flush did with a staged query (the
    # controller's ``batch``), and whether the worker ran its dispatch as
    # one shared scan: every bundle calc span tagged path "shared"
    batch = (timeline or {}).get("batch")
    if isinstance(batch, dict):
        paths = [(s.get("tags") or {}).get("path") for s in spans
                 if s.get("name") == "calc"]
        paths = [p for p in paths if p is not None]
        record["batch"] = {
            "staged": batch.get("staged"),
            "members": batch.get("members"),
            "shared_scan": bool(paths) and all(p == "shared" for p in paths),
        }
    return record


def summarize(record, top=6):
    """Compact attribution view for slow-query ring entries: coverage plus
    the largest segments (full records live in the trace timeline)."""
    if not isinstance(record, dict):
        return None
    segments = record.get("segments") or {}
    ranked = sorted(segments.items(), key=lambda kv: -kv[1])[:top]
    return {
        "coverage": record.get("coverage"),
        "unattributed_s": record.get("unattributed_s"),
        "segments": dict(ranked),
        "attempts": len(record.get("attempts") or ()),
    }


# -- SLO accounting -----------------------------------------------------------

DEFAULT_CLASS = "default"
DEFAULT_TARGET_S = 2.0
DEFAULT_OBJECTIVE = 0.99

#: rolling windows the burn-rate gauges report (label value -> seconds)
BURN_WINDOWS = {"5m": 300.0, "1h": 3600.0}

#: burn-rate bookkeeping granularity: per-class (bucket -> total/violated)
#: counts, NOT raw events — a raw-event cap would silently shrink the 1h
#: window to however long the cap lasts at production QPS (a class that
#: burned hard for 50 minutes then recovered must not report 0.0)
_BURN_BUCKET_S = 60.0


def parse_classes(raw=None):
    """``BQUERYD_TPU_SLO_CLASSES`` -> {class: {"target_s", "objective"}}.

    Format: comma list of ``name:target_s[:objective]`` (e.g.
    ``interactive:0.5:0.999,batch:30``).  Malformed entries are dropped
    (accounting must not take the controller down); a ``default`` class
    always exists so undeclared/unknown client classes have a home."""
    if raw is None:
        raw = os.environ.get("BQUERYD_TPU_SLO_CLASSES", "")
    classes = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        name = bits[0].strip()
        if not name:
            continue
        try:
            target = float(bits[1]) if len(bits) > 1 else DEFAULT_TARGET_S
            objective = (
                float(bits[2]) if len(bits) > 2 else DEFAULT_OBJECTIVE
            )
        except ValueError:
            continue
        if target <= 0.0 or not (0.0 < objective < 1.0):
            continue
        classes[name] = {"target_s": target, "objective": objective}
    classes.setdefault(
        DEFAULT_CLASS,
        {"target_s": DEFAULT_TARGET_S, "objective": DEFAULT_OBJECTIVE},
    )
    return classes


class SLOTracker:
    """Per-class SLO accounting on a node's metrics registry.

    ``record()`` is the one entry point: the controller calls it for every
    finished groupby with the query's wall, its deadline margin (absolute
    deadlines win over the class target when the client set one), and
    whether it succeeded.  Derived state: margin histograms, query /
    violation counters, and rolling-window burn rates exposed as
    callback-backed gauges (read at scrape time, no upkeep thread)."""


    #: lock discipline, statically checked by bqueryd_tpu_torch.analysis
    _bqtpu_guarded_ = {"_lock": ("_events",)}

    def __init__(self, registry, classes=None):
        self.classes = classes or parse_classes()
        self._lock = threading.Lock()
        self._events = {}     # class -> {bucket_idx: [total, violated]}
        self._hist = {}
        self._queries = {}
        self._violations = {}
        for name in self.classes:
            self._hist[name] = registry.histogram(
                "bqueryd_tpu_slo_margin_seconds",
                "deadline margin of finished queries (seconds left on the "
                "client deadline, or on the class target when none was "
                "set; negative margins clamp to 0 here and count as "
                "violations)",
                labels={"slo_class": name},
            )
            self._queries[name] = registry.counter(
                "bqueryd_tpu_slo_queries_total",
                "finished queries per SLO class",
                labels={"slo_class": name},
            )
            self._violations[name] = registry.counter(
                "bqueryd_tpu_slo_violations_total",
                "queries that failed or finished past their deadline / "
                "class target",
                labels={"slo_class": name},
            )
            for window in BURN_WINDOWS:
                registry.gauge(
                    "bqueryd_tpu_slo_burn_rate",
                    "rolling-window violation rate over the class error "
                    "budget (1.0 = burning exactly at budget, >1 = the "
                    "objective is being missed)",
                    labels={"slo_class": name, "window": window},
                    fn=(
                        lambda c=name, w=window:
                        self.burn_rate(c, BURN_WINDOWS[w])
                    ),
                )

    def resolve(self, declared):
        """Class for a client-declared name (unknown/None -> default)."""
        return declared if declared in self.classes else DEFAULT_CLASS

    def record(self, slo_class, wall_s, margin_s=None, ok=True, now=None):
        """Account one finished query; returns (class, violated)."""
        now = time.time() if now is None else now
        cls = self.resolve(slo_class)
        target = self.classes[cls]["target_s"]
        if margin_s is None:
            margin_s = target - float(wall_s)
        violated = (not ok) or margin_s < 0.0
        self._hist[cls].observe(max(float(margin_s), 0.0))
        self._queries[cls].inc()
        if violated:
            self._violations[cls].inc()
        # bucketed counts: volume-independent memory (at most window/bucket
        # + 1 buckets per class survive trimming), so sustained QPS can
        # never shrink the labeled window
        bucket = int(now // _BURN_BUCKET_S)
        oldest = int(
            (now - max(BURN_WINDOWS.values())) // _BURN_BUCKET_S
        )
        with self._lock:
            buckets = self._events.setdefault(cls, {})
            slot = buckets.setdefault(bucket, [0, 0])
            slot[0] += 1
            if violated:
                slot[1] += 1
            for idx in [i for i in buckets if i < oldest]:
                del buckets[idx]
        return cls, violated

    def burn_rate(self, slo_class, window_s, now=None):
        """Violation rate over the window divided by the class's error
        budget; 0.0 with no traffic (nothing burning).  Bucketed at
        ``_BURN_BUCKET_S`` granularity (the bucket straddling the window
        edge counts in full — one minute of slack on an hour window)."""
        now = time.time() if now is None else now
        cls = self.resolve(slo_class)
        cutoff = int((now - float(window_s)) // _BURN_BUCKET_S)
        total = violated = 0
        with self._lock:
            for idx, (count, bad) in self._events.get(cls, {}).items():
                if idx >= cutoff:
                    total += count
                    violated += bad
        if not total:
            return 0.0
        budget = 1.0 - self.classes[cls]["objective"]
        return (violated / total) / budget if budget > 0 else 0.0

    def snapshot(self, now=None):
        """JSON-safe per-class state for rpc.timeline() / debug bundles."""
        now = time.time() if now is None else now
        out = {}
        for name, spec in self.classes.items():
            out[name] = {
                "target_s": spec["target_s"],
                "objective": spec["objective"],
                "queries": int(self._queries[name].value),
                "violations": int(self._violations[name].value),
                "burn_rate": {
                    label: round(self.burn_rate(name, seconds, now=now), 4)
                    for label, seconds in BURN_WINDOWS.items()
                },
            }
        return out


# -- controller timeline ring -------------------------------------------------

DEFAULT_TIMELINE_INTERVAL_S = 10.0
DEFAULT_TIMELINE_ENTRIES = 360


def timeline_interval_s():
    """Snapshot period; <= 0 disables the ring.  Read per tick so a live
    controller can be re-tuned (the ring itself is bounded either way)."""
    return env_num(
        "BQUERYD_TPU_TIMELINE_INTERVAL_S", DEFAULT_TIMELINE_INTERVAL_S
    )


class SnapshotTimeline:
    """Bounded ring of periodic registry snapshots behind ``rpc.timeline()``.

    The controller's heartbeat calls :meth:`maybe_snapshot` with a builder
    callable; the ring paces itself (``BQUERYD_TPU_TIMELINE_INTERVAL_S``)
    and keeps the newest ``BQUERYD_TPU_TIMELINE_ENTRIES`` entries, so "what
    changed in the last hour" is one verb instead of two hand-taken
    ``rpc.info()`` dumps diffed by eye."""

    def __init__(self, capacity=None):
        if capacity is None:
            capacity = env_num(
                "BQUERYD_TPU_TIMELINE_ENTRIES", DEFAULT_TIMELINE_ENTRIES,
                int,
            )
        self.capacity = max(1, capacity)
        self._entries = []
        self._last_ts = 0.0
        #: builder failures (logged too): a broken snapshot builder must
        #: not fail invisibly — an empty rpc.timeline() with a non-zero
        #: failure count is a diagnosable state, a silently empty one is
        #: not
        self.failures = 0

    def maybe_snapshot(self, build, now=None):
        """Append ``build()`` if the interval elapsed; returns True when a
        snapshot was taken.  A builder failure never reaches the caller
        (the timeline is monitoring, never the query path) but is logged
        and counted; ``_last_ts`` advances FIRST, so a failing builder is
        retried once per interval, not hot-looped every heartbeat."""
        interval = timeline_interval_s()
        if interval <= 0:
            return False
        now = time.time() if now is None else now
        if now - self._last_ts < interval:
            return False
        self._last_ts = now
        try:
            entry = dict(build() or {})
        except Exception:
            self.failures += 1
            import logging

            logging.getLogger("bqueryd_tpu_torch").exception(
                "timeline snapshot builder failed"
            )
            return False
        entry["ts"] = round(now, 3)
        self._entries.append(entry)
        if len(self._entries) > self.capacity:
            del self._entries[: len(self._entries) - self.capacity]
        return True

    def entries(self):
        """Oldest first, JSON-safe."""
        return list(self._entries)

    def __len__(self):
        return len(self._entries)

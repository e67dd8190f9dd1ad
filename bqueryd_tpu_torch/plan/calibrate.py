"""Measured-cost kernel-strategy calibration: the planner feedback loop.

The port's copy of ``bqueryd_tpu/plan/calibrate.py``, cell for cell and
decision for decision, so a port controller and a JAX one choose alike on
the same gossip.  The heuristic of :mod:`.strategy` picks a route from
(rows, estimated groups) against fixed thresholds; this module closes the
loop with measured kernel walls:

* workers :func:`record` the wall of every untainted dispatch under its
  (rows-bucket, groups-bucket, dtype, backend, strategy) cell.  The port's
  executor and engine time ``partial_tables`` through its synchronising
  fetch and skip a window that built the kernels or launched a shape for
  the first time (``ops.onehot.build_marker``); the backend tag is the
  torch device type, ``"cuda"`` on the card, and host-routed walls land
  under ``"host"``;
* cells keep an EWMA wall plus min/count, optionally persisted across
  restarts (``BQUERYD_TPU_CALIB_PATH``) and gossiped to controllers in WRM
  ``calibration`` summaries (schema in ``messages.py``);
* the controller's :meth:`CalibrationStore.choose` ranks the legal
  candidate strategies: measured cells (>= ``BQUERYD_TPU_CALIB_MIN_SAMPLES``)
  by their EWMA wall, unmeasured ones by an analytic unit count scaled by
  the measured cells' seconds-per-unit.  A bucket with no measurements
  returns the heuristic unchanged, and ``BQUERYD_TPU_CALIB=0`` restores it
  everywhere at once;
* exploration is deterministic and bounded: once the bucket has measured
  data, every ~``1/BQUERYD_TPU_CALIB_EPSILON``-th decision samples the
  least-measured legal candidate, as an advisory hint only.

Control-plane module: stdlib only, so the controller imports it.  One lock
guards all mutable state; file I/O happens outside it.
"""

import json
import math
import os
import threading

#: routes calibration may measure/choose between.  "host" walls are recorded
#: too (host-routed queries are real data points) but never chosen: host
#: routing stays latency-threshold-driven (models.query.host_kernel_rows).
MEASURABLE_STRATEGIES = ("matmul", "scatter", "sort", "host")

#: EWMA weight of a new wall sample: heavy enough to track data/backend
#: drift within ~10 samples, light enough that one noisy wall cannot flip a
#: decision by itself
EWMA_ALPHA = 0.25

#: sample-count cap per cell: keeps merged gossip counts bounded and the
#: EWMA responsive (a cell "full" at 1024 still re-learns in ~10 samples)
MAX_CELL_COUNT = 1024

#: cells kept per store / shipped per WRM summary (LRU-by-update eviction)
MAX_CELLS = 512
MAX_WIRE_CELLS = 128


def enabled():
    """Calibration master switch (read per call: live-tunable).
    ``BQUERYD_TPU_CALIB=0`` restores the heuristic planner exactly: no
    recording, no gossip, no calibrated decisions, no binding hints."""
    return os.environ.get("BQUERYD_TPU_CALIB", "1") != "0"


def calib_path():
    """Persistence path for the process store, or None (memory only — the
    default: test/CI processes must not leak samples across runs)."""
    path = os.environ.get("BQUERYD_TPU_CALIB_PATH", "")
    return None if path in ("", "-", "0") else path


def epsilon():
    """Exploration rate in [0, 1]; 0 disables exploration."""
    try:
        eps = float(os.environ.get("BQUERYD_TPU_CALIB_EPSILON", "0.05"))
    except ValueError:
        eps = 0.05
    return min(max(eps, 0.0), 1.0)


def min_samples():
    """Measured walls a cell needs before calibration trusts it."""
    try:
        n = int(os.environ.get("BQUERYD_TPU_CALIB_MIN_SAMPLES", "3"))
    except ValueError:
        n = 3
    return max(n, 1)


def rows_bucket(rows):
    """log2 bucket: data drift within ~2x reuses the same measurements."""
    return int(math.log2(max(int(rows), 1))) if rows else 0


def groups_bucket(groups):
    return rows_bucket(groups)


def dtype_tag(dtypes):
    """Compact dtype dimension of a cell key: what actually changes kernel
    economics is float64 (scatters regardless of route) vs float32 (Dekker
    limbs on the contraction) vs integer (byte limbs).  ``dtypes`` is an
    iterable of dtype-likes; empty (rows-count-only queries) tags as
    ``int``."""
    tags = set()
    for dt in dtypes or ():
        name = str(getattr(dt, "name", dt))
        if name in ("float64", "f64"):
            tags.add("f64")
        elif name.startswith("float") or name.startswith("bfloat"):
            tags.add("f32")
        else:
            tags.add("int")
    for tag in ("f64", "f32", "int"):
        if tag in tags:
            return tag
    return "int"


def cell_key(rows_b, groups_b, dtype, backend, strategy):
    return f"r{int(rows_b)}|g{int(groups_b)}|{dtype}|{backend}|{strategy}"


def parse_key(key):
    """Inverse of :func:`cell_key`; None for malformed (version-skewed)
    keys — one bad gossip entry must never poison the store."""
    if not isinstance(key, str):
        return None
    parts = key.split("|")
    if len(parts) != 5:
        return None
    rb, gb, dtype, backend, strategy = parts
    if not (rb.startswith("r") and gb.startswith("g")):
        return None
    try:
        rows_b, groups_b = int(rb[1:]), int(gb[1:])
    except ValueError:
        return None
    if strategy not in MEASURABLE_STRATEGIES:
        return None
    return rows_b, groups_b, dtype, backend, strategy


def analytic_units(strategy, rows, groups):
    """Backend-free relative cost of a route at (rows, groups), in
    arbitrary units: the one-hot contraction is rows x groups MACs, the
    blocked scatter is a per-limb rows pass plus its ``blocks x groups``
    table, the sort is
    ``rows log rows`` comparisons per limb.  Scale (seconds per unit) is
    learned from whatever cells ARE measured, making this the analytical
    cold-start prior for the unmeasured ones."""
    rows = max(int(rows), 1)
    groups = max(int(groups), 1)
    if strategy == "matmul":
        return float(rows) * groups
    if strategy == "sort":
        return float(rows) * max(math.log2(max(rows, 2)), 1.0) * 8.0
    # scatter: 4 16-bit limb passes over rows + the blocked bucket table,
    # whose blocks x groups cells are written AND reduced (memory-bound):
    # the term that makes extreme cardinality favour the sort, matching
    # ops.kernel_route's _MAX_BLOCK_SEGMENTS economics
    blocks = -(-rows // 65536)
    return float(rows) * 8.0 + float(blocks) * groups * 8.0


class CalibrationStore:
    """Thread-safe calibrated cost model over strategy cells (see module
    docstring).  One instance per process on workers (the global
    :func:`store`), one per controller fed by WRM gossip."""

    #: records between auto-saves when a persistence path is configured
    SAVE_EVERY = 32

    #: gossip sources tracked before the oldest is evicted
    MAX_PEERS = 256

    def __init__(self, path=None):
        self._lock = threading.Lock()
        self._path = path          # None -> BQUERYD_TPU_CALIB_PATH per call
        self._cells = {}           # key -> cell dict (JSON-safe), own samples
        # source id -> {key: cell}: absorbed peer summaries.  Kept PER
        # SOURCE and REPLACED wholesale on each absorb — a worker's WRM
        # summary is its cumulative state, so re-merging it every heartbeat
        # would double-count the same samples until one noisy wall passed
        # the min-samples floor on repetition alone
        self._peers = {}
        self._decisions = {}       # bucket key -> calibrated-decision count
        self.samples_total = 0
        self.absorbed_total = 0
        self._records_since_save = 0

    # -- recording -----------------------------------------------------------
    def record(self, rows, groups, dtype, backend, strategy, wall_s,
               flops=None, bytes_accessed=None):
        """Fold one measured kernel wall into its cell.  Callers are
        expected to skip compile-tainted walls (a jit-cache miss inflates
        the sample by the compile)."""
        if not enabled() or strategy not in MEASURABLE_STRATEGIES:
            return
        try:
            wall_s = float(wall_s)
        except (TypeError, ValueError):
            return
        if not (wall_s > 0.0) or not math.isfinite(wall_s):
            return
        key = cell_key(
            rows_bucket(rows), groups_bucket(groups), dtype, backend,
            strategy,
        )
        save_now = False
        with self._lock:
            cell = self._cells.pop(key, None)
            if cell is None:
                cell = {"n": 0, "ewma_s": wall_s, "min_s": wall_s}
            cell["n"] = min(cell["n"] + 1, MAX_CELL_COUNT)
            cell["ewma_s"] = (
                cell["ewma_s"] * (1.0 - EWMA_ALPHA) + wall_s * EWMA_ALPHA
            )
            cell["min_s"] = min(cell["min_s"], wall_s)
            if flops:
                cell["flops"] = float(flops)
            if bytes_accessed:
                cell["bytes_accessed"] = float(bytes_accessed)
            # re-insert at the back: dict order is the LRU-by-update order
            self._cells[key] = cell
            while len(self._cells) > MAX_CELLS:
                self._cells.pop(next(iter(self._cells)))
            self.samples_total += 1
            self._records_since_save += 1
            if self._records_since_save >= self.SAVE_EVERY:
                self._records_since_save = 0
                save_now = True
        if save_now:
            self.save()  # file I/O outside the lock

    # -- decisions -----------------------------------------------------------
    def _measured_locked(self, rows_b, groups_b, dtype, candidates):
        """{strategy: (n, ewma_s, units)} over trusted cells of the bucket,
        merged n-weighted across backend (homogeneous-fleet assumption: a
        mixed CPU/GPU fleet's cells stay separate per backend but the
        controller cannot know which backend will serve a dispatch) and —
        when ``dtype`` is None, the controller's stats-only view — across
        dtype tags too.  Must be called with the lock held."""
        floor = min_samples()
        merged = {}
        sources = [self._cells.items()]
        sources.extend(peer.items() for peer in self._peers.values())
        for key, cell in (pair for src in sources for pair in src):
            parsed = parse_key(key)
            if parsed is None:
                continue
            rb, gb, dt, _backend, strategy = parsed
            if rb != rows_b or gb != groups_b or strategy not in candidates:
                continue
            if dtype is not None and dt != dtype:
                continue
            n, ewma = cell.get("n", 0), cell.get("ewma_s")
            if not isinstance(ewma, (int, float)) or n <= 0:
                continue
            prev = merged.get(strategy)
            if prev is None:
                merged[strategy] = [n, float(ewma)]
            else:
                total = prev[0] + n
                prev[1] = (prev[1] * prev[0] + float(ewma) * n) / total
                prev[0] = total
        return {
            s: (n, ewma) for s, (n, ewma) in merged.items() if n >= floor
        }

    def choose(self, total_rows, est_groups, dtype, candidates, heuristic):
        """Pick a strategy for one dispatch from measured evidence.

        Returns ``(strategy, reason)`` with reason one of:

        * ``cold``     — no trusted measurement in this bucket: ``heuristic``
          unchanged (the bit-identical cold-start contract);
        * ``explore``  — deterministic epsilon slot: the least-measured
          legal candidate, as an ADVISORY hint;
        * ``agree``    — MEASURED walls rank the heuristic's route best;
        * ``measured`` — MEASURED walls rank another route best;
        * ``prior``    — the winning route has no measurements of its own
          (ranked by the analytic prior alone): advisory-strength evidence,
          so callers must not make such a choice binding.
        """
        candidates = tuple(
            c for c in candidates if c in MEASURABLE_STRATEGIES
        )
        if (
            not enabled()
            or heuristic not in candidates
            or not candidates
            or total_rows is None
            or est_groups is None
        ):
            return heuristic, "cold"
        rows_b = rows_bucket(total_rows)
        groups_b = groups_bucket(est_groups)
        with self._lock:
            measured = self._measured_locked(
                rows_b, groups_b, dtype, candidates
            )
            if not measured:
                # a cold bucket NEVER deviates (and never explores): today's
                # heuristic, bit for bit
                return heuristic, "cold"
            bucket = f"r{rows_b}|g{groups_b}|{dtype}"
            decision_n = self._decisions.get(bucket, 0) + 1
            self._decisions[bucket] = decision_n
            if len(self._decisions) > MAX_CELLS:
                self._decisions.pop(next(iter(self._decisions)))
        eps = epsilon()
        unmeasured = [c for c in candidates if c not in measured]
        if eps > 0.0 and unmeasured:
            period = max(int(round(1.0 / eps)), 2)
            if decision_n % period == 0:
                # deterministic bounded exploration of the least-measured
                # candidate; advisory by construction (the caller only
                # promotes 'measured'/'agree' choices to binding)
                return unmeasured[0], "explore"
        # seconds-per-analytic-unit learned from the measured cells scales
        # the analytical prior for the unmeasured ones (cost_analysis-shaped
        # FLOPs/bytes grounding, see analytic_units)
        scales = [
            ewma / max(analytic_units(s, total_rows, est_groups), 1.0)
            for s, (_n, ewma) in measured.items()
        ]
        scale = sorted(scales)[len(scales) // 2]
        predicted = {}
        for cand in candidates:
            if cand in measured:
                predicted[cand] = measured[cand][1]
            else:
                predicted[cand] = (
                    analytic_units(cand, total_rows, est_groups) * scale
                )
        best = min(predicted, key=lambda s: (predicted[s], s != heuristic))
        backed = best in measured  # real walls, not prior extrapolation
        if best == heuristic:
            return heuristic, "agree" if backed else "prior"
        # hysteresis: an override must beat the heuristic's own prediction
        # by >10%, or run-to-run noise would flip routes (and recompile
        # programs) endlessly
        if predicted[best] > predicted[heuristic] * 0.9:
            return heuristic, (
                "agree" if heuristic in measured else "prior"
            )
        return best, "measured" if backed else "prior"

    # -- gossip / persistence ------------------------------------------------
    def summary(self, max_cells=MAX_WIRE_CELLS):
        """JSON-safe wire summary (newest-updated cells first) for the WRM
        ``calibration`` key and the persistence file."""
        with self._lock:
            keys = list(self._cells)[-max_cells:]
            cells = {k: dict(self._cells[k]) for k in keys}
            return {
                "v": 1,
                "samples_total": self.samples_total,
                "cells": cells,
            }

    def source_cells(self, max_cells=16):
        """The newest ``max_cells`` cells each gossip source contributed,
        ``{source: {key: cell}}``: what a controller decides from (its own
        :meth:`summary` holds only cells it recorded itself)."""
        with self._lock:
            return {
                source: {k: dict(cells[k]) for k in list(cells)[-max_cells:]}
                for source, cells in self._peers.items()
            }

    @staticmethod
    def _clean_cells(wire):
        """Validated {key: cell} copies from a wire summary.  Malformed
        entries are dropped one by one — gossip from a version-skewed
        worker must never poison local measurements."""
        if not isinstance(wire, dict):
            return {}
        cells = wire.get("cells")
        if not isinstance(cells, dict):
            return {}
        clean = {}
        for key, cell in cells.items():
            if parse_key(key) is None or not isinstance(cell, dict):
                continue
            n, ewma = cell.get("n"), cell.get("ewma_s")
            if (
                not isinstance(n, int)
                or isinstance(n, bool)
                or n <= 0
                or not isinstance(ewma, (int, float))
                or not math.isfinite(float(ewma))
                or float(ewma) <= 0.0
            ):
                continue
            min_s = cell.get("min_s", ewma)
            entry = {
                "n": min(n, MAX_CELL_COUNT),
                "ewma_s": float(ewma),
                "min_s": float(min_s)
                if isinstance(min_s, (int, float)) else float(ewma),
            }
            for extra in ("flops", "bytes_accessed"):
                value = cell.get(extra)
                if isinstance(value, (int, float)):
                    entry[extra] = float(value)
            clean[key] = entry
            if len(clean) >= MAX_WIRE_CELLS:
                break
        return clean

    def absorb(self, wire, source=None):
        """Fold a peer summary into the model; returns absorbed cell count.

        With ``source`` (the gossip path: one summary per worker per WRM),
        the summary REPLACES that source's previous contribution — a WRM
        summary is the worker's cumulative state, so n-weighted re-merging
        on every heartbeat would double-count the same samples until one
        noisy wall cleared the min-samples floor by repetition alone.
        Without ``source`` (persistence load, legacy callers), cells merge
        n-weighted into the store's own, counts capped."""
        clean = self._clean_cells(wire)
        if not clean:
            return 0
        with self._lock:
            if source is not None:
                self._peers.pop(source, None)
                self._peers[source] = clean
                while len(self._peers) > self.MAX_PEERS:
                    self._peers.pop(next(iter(self._peers)))
                self.absorbed_total += len(clean)
                return len(clean)
            for key, cell in clean.items():
                mine = self._cells.pop(key, None)
                if mine is None:
                    mine = cell
                else:
                    total = mine["n"] + cell["n"]
                    mine["ewma_s"] = (
                        mine["ewma_s"] * mine["n"]
                        + cell["ewma_s"] * cell["n"]
                    ) / total
                    mine["n"] = min(total, MAX_CELL_COUNT)
                    mine["min_s"] = min(mine["min_s"], cell["min_s"])
                    for extra in ("flops", "bytes_accessed"):
                        if extra in cell:
                            mine[extra] = cell[extra]
                self._cells[key] = mine
                while len(self._cells) > MAX_CELLS:
                    self._cells.pop(next(iter(self._cells)))
                self.absorbed_total += 1
        return len(clean)

    def save(self, path=None):
        """Atomic JSON dump (tmp + rename); failures are silent — losing a
        calibration file must never fail a query path."""
        path = path or self._path or calib_path()
        if not path:
            return False
        try:
            payload = json.dumps(self.summary(max_cells=MAX_CELLS))
            tmp = f"{path}.tmp.{os.getpid()}"
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
            return True
        except OSError:
            return False

    def load(self, path=None):
        """Absorb a previously-saved summary; missing/corrupt files load as
        empty (cold start)."""
        path = path or self._path or calib_path()
        if not path:
            return 0
        try:
            with open(path) as f:
                wire = json.load(f)
        except (OSError, ValueError):
            return 0
        return self.absorb(wire)

    def stats(self):
        """Monitoring/bench snapshot.  ``cells`` counts own AND absorbed
        peer cells (the decision surface); ``samples_total`` counts only
        locally-recorded walls."""
        with self._lock:
            return {
                "cells": len(self._cells)
                + sum(len(p) for p in self._peers.values()),
                "sources": len(self._peers),
                "samples_total": self.samples_total,
                "absorbed_total": self.absorbed_total,
            }


# -- process-global store (workers record into it; WRMs gossip it) -----------

_store = None
_store_lock = threading.Lock()


def store():
    """The process-global worker-side store, lazily created and (when
    ``BQUERYD_TPU_CALIB_PATH`` is set) warmed from the persistence file."""
    global _store
    with _store_lock:
        if _store is None:
            _store = CalibrationStore()
            _store.load()
        return _store


def _reset_for_tests():
    """Fresh process-global store (tests must not leak samples into each
    other's planner decisions)."""
    global _store
    with _store_lock:
        _store = CalibrationStore()
        return _store


def record_sample(rows, groups, dtypes, backend, strategy, wall_s,
                  flops=None, bytes_accessed=None):
    """Worker-side convenience over :meth:`CalibrationStore.record`; a
    recording failure must never reach the query path."""
    if not enabled():
        return
    try:
        store().record(
            rows, groups, dtype_tag(dtypes), backend, strategy, wall_s,
            flops=flops, bytes_accessed=bytes_accessed,
        )
    except Exception:
        pass


def summary_for_wire():
    """The WRM ``calibration`` payload, or None (disabled / nothing yet)."""
    if not enabled():
        return None
    s = store()
    if not s.stats()["cells"]:
        return None
    return s.summary()

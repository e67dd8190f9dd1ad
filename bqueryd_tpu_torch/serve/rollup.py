"""Materialized rollups: the partials of hot plans, held by the controller.

The port's copy of ``bqueryd_tpu/serve/rollup.py``.  The controller
watches the admitted plans that subsumption can serve
(:func:`bqueryd_tpu_torch.serve.subsume.plan_view`), scores each view with
an exponentially decaying hit count, and materializes those that stay hot:
one ``rollup`` message per file builds the view's mergeable partials, with
the column census and the growth base that later proofs and refreshes
need, and the reply lives here.

Freshness: every entry keeps the growth base
(:func:`bqueryd_tpu_torch.ops.workingset.table_growth_base`) its partials
were computed from; :meth:`RollupManager.note_append` marks covering
entries ``stale`` when an append for their file is dispatched, before any
row lands (a stale but unchanged entry refreshes back to ready, never the
reverse); the refresh checks the stored base on the worker (``growth_since``):
an exact prefix aggregates only the new chunks and merges them into the
prior partials, anything else rebuilds.  A stale or building entry is never
served from.

Bookkeeping only: no sockets, no clock reads (callers pass ``now``), no
NumPy.  Dispatch and reply absorption live in the controller.
"""

import os


def _env_int(name, default):
    try:
        # bqtpu: allow[config-dynamic-env-key] callers pass literal registered names: ROLLUP_MAX and ROLLUP_CACHE_BYTES below; both in ENV_REGISTRY
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name, default):
    try:
        # bqtpu: allow[config-dynamic-env-key] callers pass literal registered names: ROLLUP_HEAT_MIN and ROLLUP_HEAT_HALFLIFE_S below; both in ENV_REGISTRY
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def rollup_max():
    """Most live rollup entries (``BQUERYD_TPU_ROLLUP_MAX``)."""
    return _env_int("BQUERYD_TPU_ROLLUP_MAX", 16)


def heat_min():
    """Decayed hit score a view must reach to be materialized
    (``BQUERYD_TPU_ROLLUP_HEAT_MIN``)."""
    return _env_float("BQUERYD_TPU_ROLLUP_HEAT_MIN", 3.0)


def heat_halflife_s():
    """Half-life of the heat in seconds
    (``BQUERYD_TPU_ROLLUP_HEAT_HALFLIFE_S``)."""
    return _env_float("BQUERYD_TPU_ROLLUP_HEAT_HALFLIFE_S", 300.0)


def cache_bytes():
    """Byte budget of the stored partials
    (``BQUERYD_TPU_ROLLUP_CACHE_BYTES``)."""
    return _env_int("BQUERYD_TPU_ROLLUP_CACHE_BYTES", 256 * 1024 * 1024)


#: seconds after which an unfinished build or refresh is abandoned
BUILD_TIMEOUT_S = 120.0


class RollupEntry:
    """One materialized view: per-file partials and their proof
    metadata."""

    __slots__ = (
        "key", "view", "spec", "state", "per_file", "epochs",
        "started_at", "ready_at", "last_hit", "hits", "nbytes",
    )

    def __init__(self, key, view, spec, epochs, now):
        self.key = key
        self.view = view
        #: {"args": [keys, agg_list, where_terms], "dag_wire": dag | None}
        self.spec = spec
        self.state = "building"
        #: {fname: {"data", "payload", "base", "zones", "groups", "mode"}}
        self.per_file = {}
        #: the append epochs the stored partials correspond to
        self.epochs = dict(epochs)
        self.started_at = now
        self.ready_at = None
        self.last_hit = now
        self.hits = 0
        self.nbytes = 0

    @property
    def filenames(self):
        return self.view["filenames"]

    def group_rows(self):
        """Stored partial groups over all files (the fold's cost)."""
        return sum(f.get("groups", 0) for f in self.per_file.values())

    def meta(self):
        """{filename: column census} for the subsumption proofs."""
        return {f: info.get("zones") or {} for f, info in self.per_file.items()}

    def snapshot(self):
        """The entry's row of the debug bundle."""
        return {
            "key": self.key,
            "state": self.state,
            "keys": list(self.view["keys"]),
            "filenames": list(self.filenames),
            "windowed": self.view.get("dag_sig") is not None,
            "hits": self.hits,
            "bytes": self.nbytes,
            "group_rows": self.group_rows(),
            "modes": {f: i.get("mode") for f, i in self.per_file.items()},
        }


class RollupManager:
    """Heat and the entries' lifecycle; the controller owns dispatch and
    absorption."""

    def __init__(self):
        self._heat = {}          # view_key -> (score, last_seen)
        self._views = {}         # view_key -> (view, spec), latest shape
        self.entries = {}        # view_key -> RollupEntry
        self.file_epochs = {}    # filename -> int, bumped per append dispatch
        self.evictions = 0

    # -- heat ---------------------------------------------------------------
    def note_query(self, key, view, spec, now):
        """Record one admitted eligible query; True when the view has just
        crossed the materialization threshold and has no entry yet."""
        score, last = self._heat.get(key, (0.0, now))
        hl = heat_halflife_s()
        if hl > 0 and now > last:
            score *= 0.5 ** ((now - last) / hl)
        score += 1.0
        self._heat[key] = (score, now)
        self._views[key] = (view, spec)
        if len(self._heat) > 4 * max(rollup_max(), 1):
            self._decay_prune(now)
        return key not in self.entries and score >= heat_min()

    def _decay_prune(self, now):
        hl = heat_halflife_s()
        for key in list(self._heat):
            score, last = self._heat[key]
            if hl > 0:
                score *= 0.5 ** (max(now - last, 0.0) / hl)
            if score < 0.5 and key not in self.entries:
                del self._heat[key]
                self._views.pop(key, None)

    # -- lifecycle ----------------------------------------------------------
    def start_build(self, key, now):
        """A ``building`` entry for a hot view (None if it has one)."""
        if key in self.entries:
            return None
        view, spec = self._views[key]
        entry = RollupEntry(key, view, spec, {
            f: self.file_epochs.get(f, 0) for f in view["filenames"]
        }, now)
        self.entries[key] = entry
        return entry

    def absorb(self, key, fname, info, now):
        """Store one file's build or refresh reply; the entry turns
        ``ready`` once every file is in and no append came meanwhile.
        Returns its state, or None for an unknown or retired key."""
        entry = self.entries.get(key)
        if entry is None or fname not in entry.filenames:
            return None
        entry.per_file[fname] = info
        entry.nbytes = sum(
            len(f.get("data") or b"") for f in entry.per_file.values()
        )
        if set(entry.per_file) == set(entry.filenames):
            current = {f: self.file_epochs.get(f, 0) for f in entry.filenames}
            if current == entry.epochs:
                entry.state = "ready"
                entry.ready_at = now
            else:
                # an append was dispatched during the build: never serve it
                entry.state = "stale"
        return entry.state

    def fail(self, key, _reason=None):
        """Drop an entry whose build or refresh failed."""
        return self.entries.pop(key, None)

    def note_append(self, filename, now):
        """An append for ``filename`` is being dispatched: bump its epoch
        and mark covering entries stale.  Returns the keys it flipped."""
        self.file_epochs[filename] = self.file_epochs.get(filename, 0) + 1
        flipped = []
        for entry in self.entries.values():
            if filename in entry.filenames and entry.state != "building":
                if entry.state != "stale":
                    flipped.append(entry.key)
                entry.state = "stale"
        return flipped

    def begin_refresh(self, key, now):
        """Move a stale entry back to ``building`` for a refresh: ``(entry,
        prior_per_file)`` or None."""
        entry = self.entries.get(key)
        if entry is None or entry.state != "stale":
            return None
        prior = entry.per_file
        entry.per_file = {}
        entry.state = "building"
        entry.started_at = now
        entry.epochs = {
            f: self.file_epochs.get(f, 0) for f in entry.filenames
        }
        return entry, prior

    def stale_keys(self):
        return [k for k, e in self.entries.items() if e.state == "stale"]

    # -- serving ------------------------------------------------------------
    def candidates(self, filenames):
        """Ready entries over exactly ``filenames`` whose epochs still
        match: the only ones subsumption may reason over."""
        out = []
        for entry in self.entries.values():
            if entry.state != "ready" or entry.filenames != tuple(filenames):
                continue
            current = {f: self.file_epochs.get(f, 0) for f in entry.filenames}
            if current != entry.epochs:
                entry.state = "stale"
                continue
            out.append(entry)
        return out

    def note_hit(self, key, now):
        entry = self.entries.get(key)
        if entry is not None:
            entry.hits += 1
            entry.last_hit = now

    # -- retention ----------------------------------------------------------
    def sweep(self, now):
        """Abandon wedged builds and hold the count and byte caps; returns
        the dropped keys with their reasons."""
        dropped = []
        for key, entry in list(self.entries.items()):
            if (entry.state == "building"
                    and now - entry.started_at > BUILD_TIMEOUT_S):
                del self.entries[key]
                dropped.append((key, "build-timeout"))
        limit = max(rollup_max(), 0)
        budget = max(cache_bytes(), 0)

        def _victims():
            live = [e for e in self.entries.values() if e.state != "building"]
            live.sort(key=lambda e: (e.last_hit, e.hits))
            return live

        while len(self.entries) > limit:
            victims = _victims()
            if not victims:
                break
            victim = victims[0]
            del self.entries[victim.key]
            self.evictions += 1
            dropped.append((victim.key, "count-cap"))
        while sum(e.nbytes for e in self.entries.values()) > budget:
            victims = _victims()
            if not victims:
                break
            victim = victims[0]
            del self.entries[victim.key]
            self.evictions += 1
            dropped.append((victim.key, "byte-cap"))
        return dropped

    def snapshot(self):
        """The ``serving.rollups`` section of the debug bundle."""
        return {
            "entries": [e.snapshot() for e in self.entries.values()],
            "tracked_views": len(self._heat),
            "file_epochs": dict(self.file_epochs),
            "evictions": self.evictions,
        }

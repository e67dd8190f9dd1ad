"""Per-shard statistics of the port: gathered by calc workers, advertised
in their WorkerRegisterMessage, consumed by the controller's planner.

The port's copy of ``bqueryd_tpu/plan/stats.py``.  A shard's stats are
metadata-only reads; nothing is decompressed:

* ``rows`` from the table's meta.json;
* per-column ``min``/``max`` from the chunk writer's stats in each column's
  meta (:meth:`ctable.col_stats`), datetime columns in int64 ns, and, when
  a shard only grew, the new chunks' zone maps folded into the previous
  bounds;
* per-column key ``card``inality from whichever cheap source exists: a
  dict column's dictionary length, or the on-disk factorize sidecar
  (``factor.npz``) a previous query wrote, of which only the ``uniques``
  member is read.

Every value comes from the tables' JSON metadata, so a WRM carries the
stats as JSON.

``stats_can_match`` is the controller's twin of
:func:`bqueryd_tpu_torch.ops.predicates.shard_can_match`: it decides from
advertised stats alone whether a shard can hold ANY row matching a filter
conjunction, so a provably empty shard is pruned at plan time and never
dispatched.  It prunes only on plain numeric comparisons (the controller
has no dictionaries and translates no datetimes); anything else matches.
``zone_can_match`` is the per-chunk test that chunk pruning
(:mod:`..ops.predicates`) runs over the zone maps the writer stores.

Control-plane module: NumPy only, no torch.
"""

import os
import time
import zlib

import numpy as np

#: numbers the controller compares against min/max stats without any
#: column-kind translation (bool is excluded: bool storage has no stats)
_NUMBER = (int, float)


def _sidecar_cardinality(table, name):
    """len(uniques) from the column's factorize sidecar, or None.  Loads
    only the stamp and uniques members of the npz, never the codes."""
    path = table._col_path(name, "factor.npz")
    stamp = table.factor_stamp(name)
    if stamp is None or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if not np.array_equal(z["stamp"], stamp):
                return None
            return int(z["uniques"].shape[0])
    except Exception:
        return None


def column_cardinality(table, name):
    """Best-known distinct-value count of a column, or None (unknown)."""
    if table.kind(name) == "dict":
        dictionary = table.dictionary(name)
        return None if dictionary is None else len(dictionary)
    return _sidecar_cardinality(table, name)


def _chunk_prefix_sig(table, name, count):
    """CRC of the identity (offset, csize, crc) of the first ``count``
    committed chunks of a column: the metadata-only fingerprint the
    incremental gather checks, so that a shard replaced in place (same
    name, as many chunks or more, other bytes) never passes as an
    append."""
    committed = getattr(table, "committed_chunks", None)
    if committed is None:
        return None
    chunks = committed(name)
    if chunks is None or len(chunks) < count:
        return None
    sig = 0
    for c in chunks[:count]:
        sig = zlib.crc32(
            f"{c.get('offset')}:{c.get('csize')}:{c.get('crc')};".encode(),
            sig,
        )
    return sig


def gather_table_stats(table, prev=None):
    """One shard's advertised stats (a JSON-safe dict).

    ``prev`` is the previous snapshot of the same shard, if any.  When the
    table only grew since (chunk counts did not shrink and the old chunks
    are an unchanged prefix, checked per column by the ``sig``
    fingerprint), the work is incremental: min/max fold the new chunks'
    zone maps into the previous bounds, and an unchanged column's
    cardinality probe (the sidecar open, the one read here that is not
    O(1)) is skipped.  Any other change, an in-place replacement among
    them, fails the fingerprint and takes the full gather."""
    prev_cols = (prev or {}).get("cols") if isinstance(prev, dict) else None
    if not isinstance(prev_cols, dict):
        prev_cols = {}
    cols = {}
    for name in table.names:
        kind = table.kind(name)
        entry = {"kind": kind}
        counts = (table.chunk_rows(name) if hasattr(table, "chunk_rows")
                  else None)
        nchunks = len(counts) if counts is not None else None
        if nchunks is not None:
            entry["chunks"] = nchunks
            entry["sig"] = _chunk_prefix_sig(table, name, nchunks)
        pentry = prev_cols.get(name)
        grown = (
            isinstance(pentry, dict)
            and pentry.get("kind") == kind
            and nchunks is not None
            and isinstance(pentry.get("chunks"), int)
            and nchunks >= pentry["chunks"]
            # the old chunks must be an unchanged prefix of the index: an
            # in-place replacement with as many chunks is not growth
            and pentry.get("sig") is not None
            and _chunk_prefix_sig(table, name, pentry["chunks"])
            == pentry["sig"]
        )
        if (grown and "min" in pentry and "max" in pentry
                and nchunks > pentry["chunks"]):
            # fold only the appended chunks' zone maps into the previous
            # bounds; a new chunk without a zone map takes col_stats
            maps = table.chunk_zone_maps(name)
            new = maps[pentry["chunks"]:] if maps is not None else [None]
            if all(m is not None for m in new):
                entry["min"] = min([pentry["min"]] + [m[0] for m in new])
                entry["max"] = max([pentry["max"]] + [m[1] for m in new])
        if "min" not in entry:
            stats = table.col_stats(name)
            if stats is not None:
                entry["min"], entry["max"] = stats
        if kind == "dict":
            # exact and O(1): the persistent dictionary only grows
            dictionary = table.dictionary(name)
            if dictionary is not None:
                entry["card"] = len(dictionary)
        elif grown and nchunks == pentry["chunks"] and "card" in pentry:
            # an unchanged column: reuse instead of opening the sidecar
            entry["card"] = pentry["card"]
        elif grown and nchunks > pentry["chunks"]:
            # an appended column: its sidecar's stamp covers the data
            # bytes, so the probe can only miss; the cardinality comes
            # back after the next query stores a fresh sidecar
            pass
        else:
            card = column_cardinality(table, name)
            if card is not None:
                entry["card"] = card
        cols[name] = entry
    return {"rows": int(table.nrows), "cols": cols}


class StatsCollector:
    """Memoized per-shard stats of a worker's data dir.

    Called from the worker's loop and from its liveness thread, so a
    gather stays cheap: each shard's stats are kept and gathered again only
    when its meta identity or its factorize sidecars change (a query that
    writes a sidecar refreshes the advertised cardinality)."""

    #: least seconds between two stamp sweeps: inside the window
    #: collect() returns the previous snapshot OBJECT without touching the
    #: filesystem, and ``prepare_wrm`` skips re-advertising it by identity
    MIN_REFRESH_S = 5.0

    def __init__(self, table_opener=None, min_refresh_s=None):
        self._open = table_opener
        self._memo = {}  # shard name -> (stamp, stats dict)
        self.min_refresh_s = (
            self.MIN_REFRESH_S if min_refresh_s is None else min_refresh_s
        )
        self._snapshot = None
        self._snapshot_names = None
        self._snapshot_ts = 0.0

    def invalidate(self):
        """Drop the snapshot window, so that the NEXT collect re-stamps
        every shard at once.  The worker's append path calls it: a grown
        shard must advertise fresh bounds on the next heartbeat, or the
        controller would prune a shard whose appended rows match.  The
        per-shard memos stay: the re-stamp finds the grown shard and
        refreshes it incrementally."""
        self._snapshot = None
        self._snapshot_names = None
        self._snapshot_ts = 0.0

    def _stamp(self, rootdir, table):
        """Identity of everything the stats derive from: the table's meta
        and each column's factor sidecar mtime (present or absent)."""
        from bqueryd_tpu_torch.storage.ctable import rootdir_cache_key

        parts = [rootdir_cache_key(rootdir)]
        for name in table.names:
            try:
                st = os.stat(table._col_path(name, "factor.npz"))
                parts.append((name, st.st_mtime_ns, st.st_size))
            except OSError:
                parts.append((name, None))
        return tuple(parts)

    def collect(self, data_dir, names):
        """{shard name: stats} of every shard that opens cleanly.  Returns
        the SAME dict object until the refresh window elapses or the shard
        list changes: callers may use identity to detect staleness."""
        now = time.time()
        if (
            self._snapshot is not None
            and now - self._snapshot_ts < self.min_refresh_s
            and self._snapshot_names == tuple(names)
        ):
            return self._snapshot
        out = {}
        for name in names:
            rootdir = os.path.join(data_dir, name)
            try:
                table = (self._open(rootdir) if self._open is not None
                         else _default_open(rootdir))
                stamp = self._stamp(rootdir, table)
                hit = self._memo.get(name)
                if hit is not None and hit[0] == stamp:
                    out[name] = hit[1]
                    continue
                # a stale memo: gather again, incrementally against it
                stats = gather_table_stats(
                    table, prev=hit[1] if hit is not None else None
                )
                self._memo[name] = (stamp, stats)
                out[name] = stats
            except Exception:
                continue  # an unreadable shard advertises no stats
        for gone in set(self._memo) - set(names):
            self._memo.pop(gone, None)
        # keep the previous snapshot OBJECT when nothing changed, so that
        # prepare_wrm's identity check keeps suppressing re-sends
        if self._snapshot is not None and out == self._snapshot:
            out = self._snapshot
        self._snapshot = out
        self._snapshot_names = tuple(names)
        self._snapshot_ts = now
        return out


def _default_open(rootdir):
    from bqueryd_tpu_torch.storage.ctable import ctable

    return ctable(rootdir, mode="r", auto_cache=True)


def zone_can_match(lo, hi, op, value):
    """True unless NO value in a chunk's ``[lo, hi]`` zone map can satisfy
    ``(op, value)``.  Values are physical (datetimes as int64 ns); anything
    incomparable conservatively matches: garbage reads as "cannot prune",
    never raises mid-query.

    Only the provable ops prune.  ``!=``/``not in`` never do, even when
    ``lo == hi``: a float chunk's zone map skips NaNs, and NaN rows satisfy
    ``!=``."""
    try:
        if op == "==":
            return not (value < lo or value > hi)
        if op == ">":
            return hi > value
        if op == ">=":
            return hi >= value
        if op == "<":
            return lo < value
        if op == "<=":
            return lo <= value
        if op == "in":
            if isinstance(value, (list, tuple, set, frozenset)) and value:
                return any(not (v < lo or v > hi) for v in value)
            return True
    except TypeError:
        return True
    return True


def stats_can_match(stats, where_terms):
    """False only if NO row of the shard can satisfy the conjunction,
    judged from advertised stats alone: ``shard_can_match`` restricted to
    plain numeric comparisons.  Unknown columns, kinds, ops or value types,
    and malformed stats, conservatively match."""
    cols = stats.get("cols") if isinstance(stats, dict) else None
    if not isinstance(cols, dict):
        cols = {}
    for term in where_terms or []:
        try:
            column, op, value = term
        except (TypeError, ValueError):
            continue
        entry = cols.get(column)
        if not isinstance(entry, dict) or entry.get("kind") != "numeric":
            continue
        lo, hi = entry.get("min"), entry.get("max")
        # the advertised bounds must be numbers themselves: garbage stats
        # read as "cannot prune", never raise mid-launch
        if not isinstance(lo, _NUMBER) or not isinstance(hi, _NUMBER):
            continue
        if op == "in":
            if (
                isinstance(value, (list, tuple, set, frozenset))
                and value
                and all(isinstance(v, _NUMBER) for v in value)
                and all(v < lo or v > hi for v in value)
            ):
                return False
            continue
        if not isinstance(value, _NUMBER) or isinstance(value, bool):
            continue
        if op == "==" and (value < lo or value > hi):
            return False
        if op == ">" and hi <= value:
            return False
        if op == ">=" and hi < value:
            return False
        if op == "<" and lo >= value:
            return False
        if op == "<=" and lo > value:
            return False
    return True

"""Device-resident working set of the executor: alignment, codes, measure
blocks.

The port of ``bqueryd_tpu/ops/workingset.py``: three named LRU segments
with byte budgets and hit/miss/eviction counters,

* ``align`` (host): dense global codes + dictionaries per (table set,
  groupby columns);
* ``codes`` (device): packed group codes with the row filter folded in,
  per (table set, groupby columns, filter, device);
* ``blocks`` (device): packed wire-dtype measure columns per (table set,
  column, device).

Keys carry each shard's identity (rootdir + meta.json inode/mtime + rows,
:func:`bqueryd_tpu_torch.storage.ctable.table_cache_key`), so a rewritten
shard misses, and a query with another measure or filter still hits the
segments it shares.  Tensors are accounted by their own bytes.

:meth:`WorkingSet.evict_under_pressure` sheds LRU device entries (blocks
before codes) while any of its devices' allocated bytes stand above
``BQUERYD_TPU_HBM_EVICT_WATERMARK`` x that device's memory; on the CPU
there is no sample and it does nothing.

:class:`DeltaAggCache` keeps the worker's delta-maintained aggregates of
streaming ingest: a cached result of a shard group whose tables only grew
is refreshed from the appended chunks alone (:func:`growth_since`).

A :class:`WorkingSet` belongs to one executor, never to the process.
"""

import logging
import os
import threading

from bqueryd_tpu_torch.utils.cache import BytesCappedCache, sizeof

#: segments holding device tensors, in memory-pressure eviction order:
#: blocks first, the biggest and cheapest to rebuild from the cached
#: alignment
DEVICE_SEGMENTS = ("blocks", "codes")

#: every segment, in eviction-preference order
SEGMENTS = ("blocks", "codes", "align")

_DEFAULT_BUDGETS = {
    # host alignment (dense codes + combos + dictionaries)
    "align": ("BQUERYD_TPU_ALIGN_CACHE_BYTES", 512 * 1024**2),
    # device folded group codes, one entry per (table set, keys, filter)
    "codes": ("BQUERYD_TPU_CODES_CACHE_BYTES", 256 * 1024**2),
    # device packed measure blocks, one entry per (table set, column)
    "blocks": ("BQUERYD_TPU_HBM_CACHE_BYTES", 1024 * 1024**2),
}


def _budget(segment):
    env, default = _DEFAULT_BUDGETS[segment]
    try:
        # bqtpu: allow[config-dynamic-env-key] keys come from _DEFAULT_BUDGETS above; all three are in ENV_REGISTRY
        return int(os.environ.get(env, default))
    except ValueError:
        logging.getLogger("bqueryd_tpu_torch").warning(
            "unparseable %s, using default %d", env, default
        )
        return default


def evict_watermark():
    """Fraction of the device memory above which device cache is shed
    (``BQUERYD_TPU_HBM_EVICT_WATERMARK``, default 0.9; <=0 disables)."""
    try:
        return float(os.environ.get("BQUERYD_TPU_HBM_EVICT_WATERMARK", 0.9))
    except ValueError:
        return 0.9


def memory_sample(device):
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of a CUDA
    device, or None for the CPU.  In use is ``torch.cuda.memory_stats``'s
    ``allocated_bytes.all.current`` -- the live tensors, which is what
    dropping cache entries frees (the caching allocator keeps the freed
    blocks reserved for reuse) -- and the peak its ``.peak``, the process's
    high watermark; the limit is the card's total memory from
    ``torch.cuda.mem_get_info``."""
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    import torch

    stats = torch.cuda.memory_stats(device)
    _free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def pressure_sample(devices):
    """The sample of the most pressed of ``devices`` (the highest share of
    its memory in use), each card read once; None when none is a CUDA
    device.  Blocks are spread evenly over the devices, so the fullest
    card is the one that runs out first."""
    samples = [memory_sample(d) for d in dict.fromkeys(devices or ())]
    samples = [s for s in samples if s and s.get("bytes_limit")]
    if not samples:
        return None
    return max(samples, key=lambda s: s["bytes_in_use"] / s["bytes_limit"])


class WorkingSet:
    """Named LRU cache segments and the device-memory-pressure eviction
    policy (module docstring).  ``devices`` are where the device
    segments' tensors live; their memory is what the pressure policy
    samples."""

    #: lock discipline, statically checked by bqueryd_tpu_torch.analysis
    #: (lock-unguarded-attr).  ``_segments`` is read-only after __init__
    #: (the per-segment caches carry their own locks), so only the
    #: pressure-eviction counter is guarded.
    _bqtpu_guarded_ = {"_pressure_lock": ("pressure_evictions",)}

    def __init__(self, devices=()):
        self.devices = tuple(devices)
        self._segments = {
            name: BytesCappedCache(_budget(name), sizeof=sizeof)
            for name in SEGMENTS
        }
        self._pressure_lock = threading.Lock()
        self.pressure_evictions = 0  # entries shed by the watermark policy

    def segment(self, name):
        return self._segments[name]

    def clear(self):
        for cache in self._segments.values():
            cache.clear()

    def stats(self):
        """Per-segment counters and the pressure-eviction total."""
        out = {
            name: cache.stats() for name, cache in self._segments.items()
        }
        with self._pressure_lock:
            out["pressure_evictions"] = self.pressure_evictions
        return out

    def evict_under_pressure(self, sample=None, watermark=None):
        """Shed LRU device-segment entries while the device's allocated
        bytes stand above the watermark.  ``sample`` is a
        ``{"bytes_in_use", "bytes_limit"}`` dict (default:
        :func:`pressure_sample` of this set's devices, every card read;
        None -- the CPU -- is a no-op).  Returns the accounted bytes freed.  ``blocks`` go before
        ``codes``: measure blocks rebuild from the cached alignment with
        one decode and upload, codes also re-run the mask fold."""
        if watermark is None:
            watermark = evict_watermark()
        if watermark <= 0:
            return 0
        if sample is None:
            sample = pressure_sample(self.devices)
        if not sample:
            return 0
        limit = sample.get("bytes_limit") or 0
        in_use = sample.get("bytes_in_use") or 0
        if limit <= 0 or in_use <= watermark * limit:
            return 0
        target = int(in_use - watermark * limit)
        freed = 0
        for name in DEVICE_SEGMENTS:
            seg_freed, seg_count = self._segments[name].evict_bytes(
                target - freed
            )
            freed += seg_freed
            with self._pressure_lock:
                self.pressure_evictions += seg_count
            if freed >= target:
                break
        if freed:
            logging.getLogger("bqueryd_tpu_torch").info(
                "device memory pressure: shed %d cached bytes "
                "(in use %d > %.0f%% of %d)",
                freed, in_use, watermark * 100, limit,
            )
        return freed


# -- delta-maintained hot aggregates (streaming ingest) ---------------------
#
# A cached groupby result for a shard group whose ctables only GREW (the
# streaming-append signature) is refreshed by running the kernels over the
# appended chunks alone and
# merging the delta partial into the cached partial through the same
# value-keyed hostmerge forms every cross-shard merge uses — sum/count/
# count_na/min/max merge exactly, mean merges through its (sum, count)
# partials.  Non-mergeable shapes (distinct counts, basket expansion, raw
# rows) never enter; the existing identity-keyed (meta inode + row count)
# invalidation of every other cache remains the correctness backstop: any
# non-append change (reshard, activation, rewrite) fails the chunk-prefix
# validation below and drops the entry to a full recompute.

def delta_serve_enabled():
    """Delta maintenance kill switch (``BQUERYD_TPU_DELTA_SERVE``,
    default on)."""
    return os.environ.get("BQUERYD_TPU_DELTA_SERVE", "1") == "1"


def _delta_budget():
    try:
        return int(
            os.environ.get(
                "BQUERYD_TPU_DELTA_CACHE_BYTES", 128 * 1024**2
            )
        )
    except ValueError:
        return 128 * 1024**2


def table_growth_base(table):
    """The append-diff base of one table INSTANCE: its committed per-column
    chunk indexes + row count, captured from the snapshot the computation
    actually read.  None when the table exposes no committed chunk grid
    (legacy formats, torn state) — such tables never delta-serve."""
    committed = getattr(table, "committed_chunks", None)
    if committed is None:
        return None
    cols = {}
    for name in table.names:
        snap = committed(name)
        if snap is None:
            return None
        cols[name] = [dict(c) for c in snap]
    return {
        "rows": int(table.nrows),
        "names": list(table.names),
        "cols": cols,
    }


def growth_since(base, table):
    """The NEW committed chunk ids of ``table`` relative to ``base``
    (possibly empty), or None when the table is not an append-only growth
    of the base.  Validation is exact: the base's chunk dicts (offset,
    csize, crc, zone map) must be a verbatim prefix of the current index
    for EVERY column — any rewrite mismatches and the caller recomputes."""
    if base is None or not isinstance(base, dict):
        return None
    committed = getattr(table, "committed_chunks", None)
    if committed is None:
        return None
    if list(table.names) != base.get("names"):
        return None
    if int(table.nrows) < base.get("rows", 0):
        return None
    new_ids = None
    grown_rows = None
    for name, bchunks in base.get("cols", {}).items():
        cur = committed(name)
        if cur is None or len(cur) < len(bchunks):
            return None
        if cur[: len(bchunks)] != bchunks:
            return None
        ids = list(range(len(bchunks), len(cur)))
        rows = sum(int(c["nrows"]) for c in cur[len(bchunks):])
        if new_ids is None:
            new_ids, grown_rows = ids, rows
        elif ids != new_ids or rows != grown_rows:
            return None  # desynchronized chunk grid: not a clean append
    if new_ids is None:
        new_ids, grown_rows = [], 0
    if grown_rows != int(table.nrows) - base["rows"]:
        return None
    return new_ids


class DeltaAggCache:
    """Byte-bounded cache of delta-maintainable aggregate results.

    Entries are keyed by (table identity tuple, query signature) —
    supplied by the worker — and hold the serialized merged
    :class:`~bqueryd_tpu_torch.models.query.ResultPayload` plus the growth base
    of every table it covers.  ``refresh_ids`` validates a later lookup
    against live tables and names the appended chunks to re-aggregate."""

    def __init__(self, max_bytes=None):
        self._cache = BytesCappedCache(
            _delta_budget() if max_bytes is None else max_bytes
        )
        #: cached results refreshed by aggregating only appended chunks
        self.refreshes = 0
        #: rows the delta kernels aggregated instead of the full tables
        self.delta_rows = 0

    def get(self, key):
        return self._cache.get(key)

    def discard(self, key):
        self._cache.delete(key)

    def store(self, key, tables, data):
        """Record ``data`` (serialized payload bytes) as the delta base for
        ``tables`` — a no-op when any table exposes no growth base."""
        bases = [table_growth_base(t) for t in tables]
        if any(b is None for b in bases):
            return False
        # refreshes REPLACE the entry (put() keeps an existing key)
        self._cache.delete(key)
        self._cache.put(
            key, {"bases": bases, "data": data}, nbytes=len(data)
        )
        return True

    @property
    def nbytes(self):
        return self._cache.nbytes

    def refresh_ids(self, entry, tables):
        """Per-table NEW chunk ids for a cached entry against live tables,
        or None when any table is not an append-only growth of its base
        (the caller drops the entry and recomputes)."""
        bases = entry.get("bases") or []
        if len(bases) != len(tables):
            return None
        out = []
        for base, table in zip(bases, tables):
            ids = growth_since(base, table)
            if ids is None:
                return None
            out.append(ids)
        return out

    def clear(self):
        self._cache.clear()

"""Byte-capped caches shared by the storage, engine and working-set layers
(a copy of ``bqueryd_tpu/utils/cache.py``)."""

import threading


def sizeof(value):
    """Accounted bytes of a cache value: a tensor counts its own elements
    (``numel * element_size``, not the storage it may view), anything else
    its ``nbytes``."""
    numel = getattr(value, "numel", None)
    if callable(numel):
        return int(numel()) * int(value.element_size())
    return int(getattr(value, "nbytes", 0))


class BytesCappedCache:
    """Dict-shaped cache with a byte budget and LRU eviction.

    Entries evict least-recently-used-first, one at a time, until the new
    entry fits; an entry larger than the whole budget is rejected instead
    of being inserted into a permanently over-budget cache.  ``get``
    refreshes recency.  Thread-safe.
    """

    #: lock discipline, statically checked by bqueryd_tpu_torch.analysis
    #: (rule lock-unguarded-attr): these attributes may only be touched
    #: inside ``with self._lock`` (or in ``*_locked`` helpers)
    _bqtpu_guarded_ = {
        "_lock": (
            "_data", "_sizes", "_bytes",
            "hits", "misses", "evictions", "rejected",
        ),
    }

    def __init__(self, max_bytes, sizeof=lambda v: v.nbytes):
        self.max_bytes = int(max_bytes)
        self._sizeof = sizeof
        self._data = {}      # insertion/recency-ordered (dict is ordered)
        self._sizes = {}     # key -> accounted bytes
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0   # entries dropped to make room (monotonic)
        self.rejected = 0    # oversize entries refused outright (monotonic)

    def get(self, key):
        with self._lock:
            if key in self._data:
                # refresh recency: move to the MRU end
                value = self._data.pop(key)
                self._data[key] = value
                self.hits += 1
                return value
            self.misses += 1
            return None

    def put(self, key, value, nbytes=None):
        size = int(self._sizeof(value) if nbytes is None else nbytes)
        with self._lock:
            if key in self._data:
                return
            if size > self.max_bytes:
                self.rejected += 1
                return
            while self._bytes + size > self.max_bytes and self._data:
                old, _ = next(iter(self._data.items()))
                self._data.pop(old)
                self._bytes -= self._sizes.pop(old)
                self.evictions += 1
            self._data[key] = value
            self._sizes[key] = size
            self._bytes += size

    def evict_bytes(self, target_bytes):
        """Evict LRU entries until at least ``target_bytes`` of accounted
        bytes are freed (or the cache is empty).  Returns ``(bytes_freed,
        entries_evicted)``, counted inside the lock so the memory-pressure
        caller (:meth:`bqueryd_tpu_torch.ops.workingset.WorkingSet.
        evict_under_pressure`) never misattributes a concurrent capacity
        eviction."""
        freed = 0
        count = 0
        with self._lock:
            while freed < target_bytes and self._data:
                key, _ = next(iter(self._data.items()))
                self._data.pop(key)
                freed += self._sizes.pop(key)
                count += 1
                self.evictions += 1
            self._bytes -= freed
        return freed, count

    def delete(self, key):
        """Drop ``key`` if present (a refreshed entry replaces its old
        value this way: ``put`` keeps an existing key)."""
        with self._lock:
            if key in self._data:
                self._data.pop(key)
                self._bytes -= self._sizes.pop(key)

    def clear(self):
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._bytes = 0

    def stats(self):
        """JSON-safe counters snapshot."""
        with self._lock:
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejected": self.rejected,
            }

    @property
    def nbytes(self):
        with self._lock:
            return self._bytes

    def __len__(self):
        with self._lock:
            return len(self._data)

    def __contains__(self, key):
        with self._lock:
            return key in self._data

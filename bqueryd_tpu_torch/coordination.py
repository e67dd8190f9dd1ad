"""Coordination store: cluster membership.

The port's copy of the part of ``bqueryd_tpu/coordination.py`` that the
nodes use.  Controllers register their addresses in a string set; workers
and clients read it to find them.  Three backends behind one small
interface, chosen by URL:

* ``redis://...`` — a Redis server through redis-py, imported only when
  such a URL is opened;
* ``mem://<name>`` — a process-local store shared by name (threads-as-nodes
  clusters).  Its state belongs to this module, so a ``mem://`` store of
  the port is not the reference package's store of the same name;
* ``file:///path`` — one JSON file per key under a directory, every
  mutation under an ``fcntl`` lock: multi-process clusters on one host.
  Both packages read and write the same files.

Only what the nodes need: string sets and key scans.  The reference's
hashes and TTL locks serve parts of its controller that are not ported.
"""

import fnmatch
import json
import os
import threading

__all__ = ["coordination_store", "CoordinationStore"]


class CoordinationStore:
    """Abstract store; see the module docstring for the operation set."""

    url = None

    def sadd(self, key, member):
        raise NotImplementedError

    def srem(self, key, member):
        raise NotImplementedError

    def smembers(self, key):
        raise NotImplementedError

    def keys(self, pattern="*"):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# mem:// — shared-by-name in-process store
# ---------------------------------------------------------------------------

class _MemState:
    def __init__(self):
        self.lock = threading.RLock()
        self.sets = {}


_MEM_REGISTRY = {}
_MEM_REGISTRY_LOCK = threading.Lock()


class MemoryStore(CoordinationStore):
    def __init__(self, url):
        self.url = url
        with _MEM_REGISTRY_LOCK:
            self._state = _MEM_REGISTRY.setdefault(url, _MemState())

    def sadd(self, key, member):
        with self._state.lock:
            self._state.sets.setdefault(key, set()).add(str(member))

    def srem(self, key, member):
        with self._state.lock:
            self._state.sets.get(key, set()).discard(str(member))

    def smembers(self, key):
        with self._state.lock:
            return set(self._state.sets.get(key, set()))

    def keys(self, pattern="*"):
        with self._state.lock:
            return [k for k in self._state.sets
                    if fnmatch.fnmatchcase(k, pattern)]


# ---------------------------------------------------------------------------
# file:// — filesystem-backed store (multi-process, single host)
# ---------------------------------------------------------------------------

class FileStore(CoordinationStore):
    """One JSON file per key under the root dir; every mutation runs under
    an ``fcntl`` flock on ``<root>/.store.lock`` so concurrent processes
    serialize.  Key names are encoded to stay filesystem-safe."""

    def __init__(self, url):
        self.url = url
        self.root = url[len("file://"):] or "/tmp/bqueryd_tpu_store"
        os.makedirs(self.root, exist_ok=True)
        self._guard_path = os.path.join(self.root, ".store.lock")

    def _enc(self, key):
        return key.replace("/", "%2F") + ".json"

    def _dec(self, fname):
        return fname[:-5].replace("%2F", "/")

    class _Guard:
        def __init__(self, path):
            self.path = path

        def __enter__(self):
            import fcntl

            self.fd = open(self.path, "a+")
            fcntl.flock(self.fd, fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            import fcntl

            fcntl.flock(self.fd, fcntl.LOCK_UN)
            self.fd.close()

    def _guard(self):
        return FileStore._Guard(self._guard_path)

    def _load(self, key):
        path = os.path.join(self.root, self._enc(key))
        if not os.path.exists(path):
            return None
        with open(path) as f:
            try:
                return json.load(f)
            except ValueError:
                return None

    def _save(self, key, obj):
        path = os.path.join(self.root, self._enc(key))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    def sadd(self, key, member):
        with self._guard():
            obj = self._load(key) or {"type": "set", "v": []}
            if str(member) not in obj["v"]:
                obj["v"].append(str(member))
            self._save(key, obj)

    def srem(self, key, member):
        with self._guard():
            obj = self._load(key)
            if obj and str(member) in obj["v"]:
                obj["v"].remove(str(member))
                self._save(key, obj)

    def smembers(self, key):
        with self._guard():
            obj = self._load(key)
            return set(obj["v"]) if obj else set()

    def keys(self, pattern="*"):
        with self._guard():
            names = [
                self._dec(f)
                for f in os.listdir(self.root)
                if f.endswith(".json") and not f.startswith(".")
            ]
            return [k for k in names if fnmatch.fnmatchcase(k, pattern)]


# ---------------------------------------------------------------------------
# redis:// — a Redis server (redis-py imported on use)
# ---------------------------------------------------------------------------

class RedisStore(CoordinationStore):
    def __init__(self, url):
        import redis

        self.url = url
        self._r = redis.from_url(url, decode_responses=True)

    def sadd(self, key, member):
        self._r.sadd(key, member)

    def srem(self, key, member):
        self._r.srem(key, member)

    def smembers(self, key):
        return set(self._r.smembers(key))

    def keys(self, pattern="*"):
        return list(self._r.keys(pattern))


def coordination_store(url):
    """The backend for ``url``; a store instance passes through unchanged
    (tests inject doubles)."""
    if isinstance(url, CoordinationStore):
        return url
    if url.startswith("mem://"):
        return MemoryStore(url)
    if url.startswith("file://"):
        return FileStore(url)
    if url.startswith("redis://") or url.startswith("rediss://"):
        return RedisStore(url)
    raise ValueError(f"unsupported coordination url: {url!r}")

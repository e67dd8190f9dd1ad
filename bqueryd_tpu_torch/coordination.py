"""Coordination store: cluster membership, download tickets and locks.

The port's copy of ``bqueryd_tpu/coordination.py``.  Controllers register
their addresses in a string set; workers and clients read it to find
them.  A download is a ticket, one string hash per ticket, its slots
claimed by downloaders with TTL locks.  Three backends behind one small
interface, chosen by URL:

* ``redis://...`` — a Redis server through redis-py, imported only when
  such a URL is opened;
* ``mem://<name>`` — a process-local store shared by name (threads-as-nodes
  clusters).  Its state belongs to this module, so a ``mem://`` store of
  the port is not the reference package's store of the same name;
* ``file:///path`` — one JSON file per key under a directory, every
  mutation under an ``fcntl`` lock: multi-process clusters on one host.
  Both packages read and write the same files, so a ticket registered by
  one package's controller is claimed by the other's downloader.

The operations: string sets, string hashes, key scans, deletes and TTL
locks (:class:`StoreLock`, or redis-py's lock behind
:class:`_RedisLockAdapter`).  All values are ``str``.

:func:`chaos_store` wraps a store with the ``coordination.store`` fault
site (:class:`ChaosStore`), so that a fault plan can partition one node
from the store, its locks included, while its sockets stay up.
"""

import fnmatch
import json
import os
import threading
import time

__all__ = [
    "coordination_store", "chaos_store", "CoordinationStore", "ChaosStore",
    "StoreLock", "StorePartitioned",
]


class StorePartitioned(OSError):
    """The coordination store is unreachable (injected by the chaos
    ``coordination.store`` site's ``partition`` action — the shape a real
    Redis ConnectionError takes).  Callers already treat store access as
    fallible: heartbeat ticks skip, loops log and continue."""


class StoreLock:
    """A named lock with a TTL, mirroring redis-py's ``Lock`` surface
    (``acquire(blocking=False)`` / ``release()``) used at reference
    bqueryd/worker.py:400-416.  Expired locks are claimable by others."""

    def __init__(self, store, name, ttl):
        self.store = store
        self.name = name
        self.ttl = ttl
        self.token = os.urandom(8).hex()

    def acquire(self, blocking=True, timeout=None):
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self.store._lock_acquire(self.name, self.token, self.ttl):
                return True
            if not blocking:
                return False
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(0.05)

    def release(self):
        self.store._lock_release(self.name, self.token)

    def extend(self, additional_time):
        """Push the expiry ``additional_time`` seconds past now; long-running
        holders (a blob fetch outlasting the claim TTL) call this from their
        progress path so the claim can't expire mid-download and be re-claimed
        into a duplicate concurrent fetch."""
        return self.store._lock_acquire(
            self.name, self.token, additional_time
        )

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class CoordinationStore:
    """Abstract store; see module docstring for the operation set."""

    url = None

    # sets
    def sadd(self, key, member):
        raise NotImplementedError

    def srem(self, key, member):
        raise NotImplementedError

    def smembers(self, key):
        raise NotImplementedError

    # hashes
    def hset(self, key, field, value):
        raise NotImplementedError

    def hget(self, key, field):
        raise NotImplementedError

    def hgetall(self, key):
        raise NotImplementedError

    def hdel(self, key, *fields):
        raise NotImplementedError

    # keys
    def keys(self, pattern="*"):
        raise NotImplementedError

    def delete(self, *keys):
        raise NotImplementedError

    def flushdb(self):
        raise NotImplementedError

    # locks
    def lock(self, name, ttl):
        return StoreLock(self, name, ttl)

    def _lock_acquire(self, name, token, ttl):
        raise NotImplementedError

    def _lock_release(self, name, token):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# mem:// — shared-by-name in-process store
# ---------------------------------------------------------------------------

class _MemState:
    def __init__(self):
        self.lock = threading.RLock()
        self.sets = {}
        self.hashes = {}
        self.locks = {}  # name -> (token, expiry)


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

    def hset(self, key, field, value):
        with self._state.lock:
            self._state.hashes.setdefault(key, {})[str(field)] = str(value)

    def hget(self, key, field):
        with self._state.lock:
            return self._state.hashes.get(key, {}).get(str(field))

    def hgetall(self, key):
        with self._state.lock:
            return dict(self._state.hashes.get(key, {}))

    def hdel(self, key, *fields):
        with self._state.lock:
            h = self._state.hashes.get(key, {})
            for f in fields:
                h.pop(str(f), None)
            if not h:
                self._state.hashes.pop(key, None)

    def keys(self, pattern="*"):
        now = time.time()
        with self._state.lock:
            live_locks = {
                k for k, (_tok, exp) in self._state.locks.items() if exp > now
            }
            names = set(self._state.sets) | set(self._state.hashes) | live_locks
            return [k for k in names if fnmatch.fnmatchcase(k, pattern)]

    def delete(self, *keys):
        with self._state.lock:
            for k in keys:
                self._state.sets.pop(k, None)
                self._state.hashes.pop(k, None)
                self._state.locks.pop(k, None)

    def flushdb(self):
        with self._state.lock:
            self._state.sets.clear()
            self._state.hashes.clear()
            self._state.locks.clear()

    def _lock_acquire(self, name, token, ttl):
        now = time.time()
        with self._state.lock:
            held = self._state.locks.get(name)
            if held is not None and held[1] > now and held[0] != token:
                return False
            self._state.locks[name] = (token, now + ttl)
            return True

    def _lock_release(self, name, token):
        with self._state.lock:
            held = self._state.locks.get(name)
            if held is not None and held[0] == token:
                self._state.locks.pop(name, None)


# ---------------------------------------------------------------------------
# file:// — filesystem-backed store (multi-process, single host)
# ---------------------------------------------------------------------------

class FileStore(CoordinationStore):
    """One JSON file per key under the root dir; every mutation runs under an
    ``fcntl`` flock on ``<root>/.store.lock`` so concurrent processes
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

    def _remove(self, key):
        path = os.path.join(self.root, self._enc(key))
        if os.path.exists(path):
            os.remove(path)

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

    def hset(self, key, field, value):
        with self._guard():
            obj = self._load(key) or {"type": "hash", "v": {}}
            obj["v"][str(field)] = str(value)
            self._save(key, obj)

    def hget(self, key, field):
        with self._guard():
            obj = self._load(key)
            return obj["v"].get(str(field)) if obj else None

    def hgetall(self, key):
        with self._guard():
            obj = self._load(key)
            return dict(obj["v"]) if obj else {}

    def hdel(self, key, *fields):
        with self._guard():
            obj = self._load(key)
            if not obj:
                return
            for f in fields:
                obj["v"].pop(str(f), None)
            if obj["v"]:
                self._save(key, obj)
            else:
                self._remove(key)

    def keys(self, pattern="*"):
        with self._guard():
            names = [
                self._dec(f)
                for f in os.listdir(self.root)
                if f.endswith(".json") and not f.startswith(".")
            ]
            return [k for k in names if fnmatch.fnmatchcase(k, pattern)]

    def delete(self, *keys):
        with self._guard():
            for k in keys:
                self._remove(k)

    def flushdb(self):
        with self._guard():
            for f in os.listdir(self.root):
                if f.endswith(".json"):
                    os.remove(os.path.join(self.root, f))

    def _lock_acquire(self, name, token, ttl):
        # Locks are ordinary keys (visible to keys(), clearable with delete()),
        # matching how they would appear on a real Redis deployment.
        now = time.time()
        with self._guard():
            obj = self._load(name)
            if (
                obj
                and obj.get("type") == "lock"
                and obj["v"].get("expiry", 0) > now
                and obj["v"].get("token") != token
            ):
                return False
            self._save(name, {"type": "lock", "v": {"token": token, "expiry": now + ttl}})
            return True

    def _lock_release(self, name, token):
        with self._guard():
            obj = self._load(name)
            if obj and obj.get("type") == "lock" and obj["v"].get("token") == token:
                self._remove(name)


# ---------------------------------------------------------------------------
# redis:// — real Redis (gated on redis-py being installed)
# ---------------------------------------------------------------------------

class RedisStore(CoordinationStore):
    def __init__(self, url):
        import redis  # gated import: optional dependency

        self.url = url
        self._r = redis.from_url(url, decode_responses=True)

    def sadd(self, key, member):
        self._r.sadd(key, member)

    def srem(self, key, member):
        self._r.srem(key, member)

    def smembers(self, key):
        return set(self._r.smembers(key))

    def hset(self, key, field, value):
        self._r.hset(key, field, value)

    def hget(self, key, field):
        return self._r.hget(key, field)

    def hgetall(self, key):
        return self._r.hgetall(key)

    def hdel(self, key, *fields):
        if fields:
            self._r.hdel(key, *fields)

    def keys(self, pattern="*"):
        return list(self._r.keys(pattern))

    def delete(self, *keys):
        if keys:
            self._r.delete(*keys)

    def flushdb(self):
        self._r.flushdb()

    def lock(self, name, ttl):
        # thread_local=False: the claim is acquired on the event-loop thread
        # but released (and extended) by the download-pool thread; redis-py's
        # default thread-local token would make that cross-thread release
        # silently fail and pin the lock for its full TTL
        return _RedisLockAdapter(
            self._r.lock(name, timeout=ttl, thread_local=False)
        )


class _RedisLockAdapter:
    """Presents redis-py's Lock with the StoreLock surface so code written
    against mem:///file:// behaves identically on redis://: ``acquire``'s
    ``timeout`` means overall blocking time (redis-py calls it
    ``blocking_timeout``), and releasing an expired lock is a silent no-op
    (redis-py raises LockError; the reference had to catch it explicitly at
    reference bqueryd/worker.py:407-411)."""

    def __init__(self, redis_lock):
        self._lock = redis_lock

    def acquire(self, blocking=True, timeout=None):
        return self._lock.acquire(blocking=blocking, blocking_timeout=timeout)

    def release(self):
        import redis.exceptions

        try:
            self._lock.release()
        except redis.exceptions.LockError:
            pass

    def extend(self, additional_time):
        import redis.exceptions

        try:
            # replace_ttl: expiry becomes now+additional_time (StoreLock
            # semantics), not a cumulative add
            return self._lock.extend(additional_time, replace_ttl=True)
        except redis.exceptions.LockError:
            return False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def coordination_store(url):
    """Construct the right backend for ``url``.  Accepts an existing store
    instance unchanged so tests can inject doubles (the reference's
    subclass-level seam strategy, SURVEY.md §4)."""
    if isinstance(url, (CoordinationStore, ChaosStore)):
        return url
    if url.startswith("mem://"):
        return MemoryStore(url)
    if url.startswith("file://"):
        return FileStore(url)
    if url.startswith("redis://") or url.startswith("rediss://"):
        return RedisStore(url)
    raise ValueError(f"unsupported coordination url: {url!r}")


# ---------------------------------------------------------------------------
# chaos seam — coordination.store injection site
# ---------------------------------------------------------------------------

class ChaosStore:
    """Delegating wrapper that fires the ``coordination.store`` chaos site
    before every operation, tagged with this node's id so a fault plan can
    partition ONE worker from the store while its zmq sockets stay up (the
    Redis-partition scenario).  The ``partition`` action raises
    :class:`StorePartitioned`; disarmed, each op pays one None check in
    ``chaos.fire``.

    Deliberately NOT a :class:`CoordinationStore` subclass: the base class
    defines every operation (as ``NotImplementedError`` stubs), which would
    shadow the ``__getattr__`` delegation below."""

    _OPS = (
        "sadd", "srem", "smembers", "hset", "hget", "hgetall", "hdel",
        "keys", "delete", "flushdb", "lock",
    )

    def __init__(self, inner, node_id=None):
        self._inner = inner
        self._node_id = node_id
        self.url = inner.url

    def _guarded(self, op):
        from bqueryd_tpu_torch import chaos

        if not chaos.enabled():
            return
        fault = chaos.fire(
            "coordination.store", op=op, node=self._node_id
        )
        if fault is not None and fault.action == "partition":
            raise StorePartitioned(
                f"chaos: coordination store partitioned from "
                f"{self._node_id or 'node'} (op {op})"
            )

    def __getattr__(self, name):
        # only store OPERATIONS are guarded; anything else (url, private
        # helpers a backend exposes) passes straight through
        attr = getattr(self._inner, name)
        if name not in self._OPS:
            return attr

        def guarded(*args, **kwargs):
            self._guarded(name)
            result = attr(*args, **kwargs)
            if name == "lock":
                # the factory hands back a StoreLock bound to the INNER
                # store — wrap it so acquire/extend/release fail during a
                # partition window too (a real Redis partition kills the
                # lock operations, not just the factory call)
                result = _ChaosLock(result, self._guarded)
            return result

        guarded.__name__ = name
        return guarded


class _ChaosLock:
    """StoreLock proxy handed out by :class:`ChaosStore`: every lock
    operation re-fires the ``coordination.store`` site (op ``lock``) so a
    partitioned node loses its in-flight locks the way a real partition
    takes them — mid-acquire, mid-extend, mid-release."""

    def __init__(self, inner, guard):
        self._inner = inner
        self._guard = guard

    def acquire(self, *args, **kwargs):
        self._guard("lock")
        return self._inner.acquire(*args, **kwargs)

    def release(self):
        self._guard("lock")
        return self._inner.release()

    def extend(self, additional_time):
        self._guard("lock")
        return self._inner.extend(additional_time)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def chaos_store(store, node_id=None):
    """Wrap ``store`` with the ``coordination.store`` injection seam.
    Nodes wrap unconditionally — the disarmed cost is one None check per
    store op, and store ops run at heartbeat cadence, not query cadence."""
    if isinstance(store, ChaosStore):
        return store
    return ChaosStore(store, node_id=node_id)

"""The port's coordination store against the reference's cases.

Every case of ``tests/test_coordination.py`` runs on the port's
``mem://`` and ``file://`` stores (its ``coordination_store`` and the
download module's ``CancelWatch`` swapped for the port's).  Then the
port's own contracts: the two packages' ``file://`` stores read each
other's sets, hashes and locks; a file-store TTL lock has one winner
across processes; a released or expired lock is claimable by the other
package; and ``_RedisLockAdapter`` keeps the ``StoreLock`` surface over a
redis-py style lock.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import test_coordination as ref
from bqueryd_tpu.coordination import coordination_store as jax_store
from bqueryd_tpu_torch import coordination as port_coordination
from bqueryd_tpu_torch import download as port_download
from bqueryd_tpu_torch.coordination import coordination_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STORE_CASES = [
    "test_set_ops",
    "test_hash_ops",
    "test_keys_pattern_and_delete",
    "test_lock_mutual_exclusion",
    "test_lock_ttl_expiry",
    "test_concurrent_lock_single_winner",
    "test_lock_extend_keeps_claim_past_original_ttl",
    "test_cancel_watch_extends_lock_on_progress",
]


@pytest.fixture(params=["mem", "file"])
def store(request, tmp_path, monkeypatch):
    """A flushed port store, and the reference module's names on the
    port's."""
    import bqueryd_tpu
    import bqueryd_tpu.download as jax_download

    monkeypatch.setattr(ref, "coordination_store", coordination_store)
    monkeypatch.setitem(sys.modules, "bqueryd_tpu.download", port_download)
    monkeypatch.setattr(bqueryd_tpu, "download", port_download)
    assert jax_download is not port_download
    if request.param == "mem":
        url = f"mem://torch-coord-{os.urandom(4).hex()}"
    else:
        url = f"file://{tmp_path}/store"
    s = coordination_store(url)
    s.flushdb()
    return s


@pytest.mark.parametrize("case", STORE_CASES)
def test_reference_store_case_on_port(case, store, monkeypatch):
    fn = getattr(ref, case)
    args = {"store": store, "monkeypatch": monkeypatch}
    fn(*(args[p] for p in fn.__code__.co_varnames[:fn.__code__.co_argcount]))


def test_reference_url_cases_on_port(monkeypatch):
    monkeypatch.setattr(ref, "coordination_store", coordination_store)
    ref.test_mem_store_shared_by_url()
    ref.test_bad_url_rejected()


def test_file_stores_of_both_packages_read_each_other(tmp_path):
    url = f"file://{tmp_path}/shared"
    port, jax = coordination_store(url), jax_store(url)
    port.sadd("bqueryd_controllers", "tcp://127.0.0.1:14301")
    jax.hset("bqueryd_download_ticket_t1", "n1_localfs://b/f.zip", "1_-1")
    port.hset("bqueryd_download_ticket_t1", "n2_localfs://b/f.zip", "2_DONE")
    assert jax.smembers("bqueryd_controllers") == {"tcp://127.0.0.1:14301"}
    assert port.hgetall("bqueryd_download_ticket_t1") == jax.hgetall(
        "bqueryd_download_ticket_t1") == {
        "n1_localfs://b/f.zip": "1_-1", "n2_localfs://b/f.zip": "2_DONE"}
    assert sorted(port.keys("bqueryd_*")) == sorted(jax.keys("bqueryd_*"))
    # a lock held by one package excludes the other until released
    held = port.lock("bqueryd_download_lock_x", ttl=60)
    assert held.acquire(blocking=False)
    assert not jax.lock("bqueryd_download_lock_x", ttl=60).acquire(
        blocking=False)
    held.release()
    other = jax.lock("bqueryd_download_lock_x", ttl=0.05)
    assert other.acquire(blocking=False)
    time.sleep(0.1)  # expired: claimable by the port
    assert port.lock("bqueryd_download_lock_x", ttl=60).acquire(
        blocking=False)
    jax.delete("bqueryd_download_ticket_t1")
    assert port.hgetall("bqueryd_download_ticket_t1") == {}


_CONTEND = """
import json, sys, time
from bqueryd_tpu_torch.coordination import coordination_store
store = coordination_store(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
lock = store.lock("race", ttl=60)
print(json.dumps(lock.acquire(blocking=False)))
"""


def test_file_lock_has_one_winner_across_processes(tmp_path):
    url = f"file://{tmp_path}/procs"
    coordination_store(url).flushdb()
    start = time.time() + 2.0
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _CONTEND, url,
                               str(start)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    wins = [json.loads(p.communicate(timeout=60)[0].strip().splitlines()[-1])
            for p in procs]
    assert sorted(wins) == [False] * 5 + [True]


class _FakeRedisLock:
    """redis-py's Lock surface: ``blocking_timeout``, cumulative or
    replaced extends, and LockError on a release it no longer owns."""

    def __init__(self):
        self.calls = []
        self.owned = False

    def acquire(self, blocking=True, blocking_timeout=None):
        self.calls.append(("acquire", blocking, blocking_timeout))
        self.owned = True
        return True

    def release(self):
        import redis.exceptions

        if not self.owned:
            raise redis.exceptions.LockError("not owned")
        self.owned = False

    def extend(self, additional_time, replace_ttl=False):
        import redis.exceptions

        self.calls.append(("extend", additional_time, replace_ttl))
        if not self.owned:
            raise redis.exceptions.LockError("expired")
        return True


def test_redis_lock_adapter_keeps_the_store_lock_surface(monkeypatch):
    """Without redis-py here a stub ``redis.exceptions`` stands in: the
    adapter maps ``timeout`` to ``blocking_timeout``, extends with
    ``replace_ttl`` and swallows the LockError of a lost lock."""
    import types

    exceptions = types.ModuleType("redis.exceptions")
    exceptions.LockError = type("LockError", (Exception,), {})
    redis_mod = types.ModuleType("redis")
    redis_mod.exceptions = exceptions
    monkeypatch.setitem(sys.modules, "redis", redis_mod)
    monkeypatch.setitem(sys.modules, "redis.exceptions", exceptions)
    inner = _FakeRedisLock()
    lock = port_coordination._RedisLockAdapter(inner)
    assert lock.acquire(blocking=False, timeout=3)
    assert lock.extend(30) is True
    lock.release()
    lock.release()  # lost: silent
    assert lock.extend(30) is False
    assert inner.calls == [("acquire", False, 3), ("extend", 30, True),
                           ("extend", 30, True)]

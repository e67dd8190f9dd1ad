"""The port's fault injection and health scoring against the reference's.

``tests/test_chaos.py``'s cases run on ``bqueryd_tpu_torch.chaos`` (its
module globals swapped for the port's), the lock-partition case on the
port's store and its lock proxy.  The health cases of
``tests/test_obs_forensics.py`` run on ``bqueryd_tpu_torch.obs`` the same
way.  Then the two packages side by side: for plans drawn from those
cases, the same seed and the same sequence of ``fire`` calls inject the
same faults; the same ``observe`` sequences give the same statuses; the
controller's failover backoff and the client's retry backoff give the same
delays for the same tokens.
"""

import inspect
import json
import os

import numpy as np
import pytest

import test_chaos as ref_chaos_cases
import test_obs_forensics as ref_forensics
from bqueryd_tpu import chaos as jax_chaos
from bqueryd_tpu.obs import health as jax_health
from bqueryd_tpu_torch import chaos as port_chaos
from bqueryd_tpu_torch import obs as port_obs
from bqueryd_tpu_torch.chaos import plan as port_plan
from bqueryd_tpu_torch.obs import health as port_health
from tests.conftest import wait_until
from tests.torch_fixtures import disarmed_port_chaos  # noqa: F401

#: the cases of tests/test_chaos.py that reach chaos through its module
#: globals; the store and client cases follow below on the port's own
#: classes
PLAN_CASES = [
    "test_disarmed_fire_is_none_and_free",
    "test_arm_from_dict_inline_json_and_path",
    "test_maybe_arm_from_env",
    "test_match_fnmatch_strings_and_equality",
    "test_times_after_every_counters",
    "test_seeded_probability_is_deterministic",
    "test_window_semantics_open_fire_exhaust",
    "test_window_honors_times_every_and_probability",
    "test_site_patterns_and_first_match_wins",
    "test_generic_raise_action_and_error_taxonomy",
    "test_stats_count_injected_faults",
    "test_rule_counters_are_thread_safe",
]

HEALTH_CASES = [
    "test_health_scorer_error_rate_degrades",
    "test_health_scorer_wedged_flag_wins",
    "test_health_scorer_latency_outlier_vs_fleet",
    "test_health_scorer_young_worker_is_ok_and_remove",
    "test_health_scorer_statuses_memo_invalidates_on_observe",
    "test_health_routing_env_gate",
]

MALFORMED = ref_chaos_cases.test_malformed_plans_fail_loudly_at_arm_time \
    .pytestmark[0].args[1]


def _call(fn, fixtures):
    return fn(**{name: fixtures[name]
                 for name in inspect.signature(fn).parameters})


@pytest.mark.parametrize("case", PLAN_CASES)
def test_reference_chaos_case_on_port(case, monkeypatch, tmp_path):
    monkeypatch.setattr(ref_chaos_cases, "chaos", port_chaos)
    monkeypatch.setattr(ref_chaos_cases, "chaos_plan", port_plan)
    _call(getattr(ref_chaos_cases, case),
          {"monkeypatch": monkeypatch, "tmp_path": tmp_path})


@pytest.mark.parametrize("bad", MALFORMED,
                         ids=[f"bad{i}" for i in range(len(MALFORMED))])
def test_reference_malformed_plan_on_port(bad, monkeypatch):
    monkeypatch.setattr(ref_chaos_cases, "chaos", port_chaos)
    ref_chaos_cases.test_malformed_plans_fail_loudly_at_arm_time(bad)


@pytest.mark.parametrize("case", HEALTH_CASES)
def test_reference_health_case_on_port(case, monkeypatch):
    monkeypatch.setattr(ref_forensics, "obs", port_obs)
    monkeypatch.setattr(ref_forensics, "health", port_health)
    _call(getattr(ref_forensics, case), {"monkeypatch": monkeypatch})


def test_port_sites_and_taxonomy_match_reference():
    assert port_plan.SITES == jax_chaos.plan.SITES
    assert port_plan.GENERIC_ACTIONS == jax_chaos.plan.GENERIC_ACTIONS
    assert issubclass(port_chaos.DeviceBusyError, port_chaos.TransientError)
    assert issubclass(port_chaos.TransientError, RuntimeError)
    assert not issubclass(port_chaos.FaultInjected, port_chaos.TransientError)
    assert port_health.LATENCY_FAMILY == jax_health.LATENCY_FAMILY


# -- the coordination partition seam -----------------------------------------

def test_chaos_store_partitions_one_node():
    from bqueryd_tpu_torch.coordination import (
        ChaosStore,
        StorePartitioned,
        chaos_store,
        coordination_store,
    )

    url = f"mem://torch-chaos-store-{os.urandom(4).hex()}"
    victim = chaos_store(coordination_store(url), node_id="w-a")
    bystander = chaos_store(coordination_store(url), node_id="w-b")
    assert chaos_store(victim) is victim
    assert coordination_store(victim) is victim
    assert isinstance(victim, ChaosStore) and victim.url == url
    victim.sadd("k", "1")  # disarmed: plain delegation
    assert victim.smembers("k") == {"1"}
    port_chaos.arm({"faults": [{
        "site": "coordination.store", "action": "partition",
        "match": {"node": "w-a"}, "window_s": 30,
    }]})
    for op, args in (("smembers", ("k",)), ("sadd", ("k", "2")),
                     ("srem", ("k", "1")), ("keys", ())):
        with pytest.raises(StorePartitioned, match=op):
            getattr(victim, op)(*args)
    # the partition is per node: the other store keeps working
    assert bystander.smembers("k") == {"1"}
    assert port_chaos.site_stats() == {"coordination.store": 4}
    port_chaos.disarm()
    assert victim.smembers("k") == {"1"}
    assert issubclass(StorePartitioned, OSError)


def test_reference_lock_partition_case_on_port(monkeypatch):
    """``test_chaos_store_partitions_inflight_locks`` on the port's store:
    a lock taken before the partition window loses extend and release in
    it (the ``_ChaosLock`` proxy), and a new lock cannot be acquired."""
    import bqueryd_tpu.coordination as jax_coordination
    from bqueryd_tpu_torch import coordination as port_coordination

    monkeypatch.setattr(ref_chaos_cases, "chaos", port_chaos)
    for name in ("StorePartitioned", "chaos_store", "coordination_store"):
        monkeypatch.setattr(jax_coordination, name,
                            getattr(port_coordination, name))
    ref_chaos_cases.test_chaos_store_partitions_inflight_locks(
        f"mem://torch-chaos-lock-{os.urandom(4).hex()}")
    assert port_chaos.site_stats() == {"coordination.store": 3}


def test_worker_heartbeat_survives_a_partitioned_store(tmp_path):
    """A partitioned worker's store reads raise inside the heartbeat
    thread's tick, which logs and carries on (no WRM reaches a controller,
    so it is culled); the thread stays alive."""
    from bqueryd_tpu_torch.coordination import StorePartitioned
    from bqueryd_tpu_torch.worker import WorkerNode

    worker = WorkerNode(
        coordination_url=f"mem://torch-chaos-hb-{os.urandom(4).hex()}",
        data_dir=str(tmp_path), heartbeat_interval=0.05, device="cpu",
    )
    try:
        port_chaos.arm({"faults": [{
            "site": "coordination.store", "action": "partition",
            "match": {"node": worker.worker_id}, "window_s": 30,
        }]})
        with pytest.raises(StorePartitioned):
            worker.check_controllers()
        worker.running = True
        worker._start_heartbeat_thread()
        wait_until(lambda: port_chaos.site_stats().get(
            "coordination.store", 0) >= 3, timeout=10,
            desc="heartbeat ticks against the partitioned store")
        assert worker._hb_thread.is_alive()
    finally:
        port_chaos.disarm()
        worker.running = False
        worker._hb_stop.set()
        worker._hb_thread.join(timeout=2)
        worker.socket.close()


# -- the RPC client's backoff ------------------------------------------------

def test_rpc_backoff_delay_grows_caps_and_jitters_deterministically():
    from bqueryd_tpu.rpc import RPC as JaxRPC
    from bqueryd_tpu_torch import backoff
    from bqueryd_tpu_torch.rpc import RPC

    client = RPC.__new__(RPC)  # no sockets: the backoff arithmetic only
    client.identity = "deadbeef00000000"
    delays = [client._backoff_delay(a) for a in range(1, 10)]
    for attempt, delay in zip(range(1, 10), delays):
        expected = min(backoff.BACKOFF_BASE_S * (2 ** (attempt - 1)),
                       backoff.BACKOFF_CAP_S)
        assert expected <= delay <= expected * 1.25, (attempt, delay)
    assert delays == [client._backoff_delay(a) for a in range(1, 10)]
    other = RPC.__new__(RPC)
    other.identity = "feedface00000000"
    assert [other._backoff_delay(a) for a in range(1, 10)] != delays
    # the reference client paces the same identity the same way
    ref = JaxRPC.__new__(JaxRPC)
    ref.identity = client.identity
    assert [ref._backoff_delay(a) for a in range(1, 10)] == delays


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retry_backoff_matches_reference(seed):
    from bqueryd_tpu.controller import ControllerNode as JaxController
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.messages import CalcMessage

    rng = np.random.default_rng(seed)
    for _ in range(40):
        msg = CalcMessage({"payload": "groupby",
                           "token": os.urandom(8).hex() if rng.random() > 0.1
                           else None})
        retries = int(rng.integers(0, 8))
        want = JaxController._retry_backoff(None, msg, retries)
        got = ControllerNode._retry_backoff(None, msg, retries)
        assert got == want


# -- the same plans, the same calls, the same faults -------------------------

def _plan(*faults, seed=0):
    return {"seed": seed, "faults": list(faults)}


#: plans drawn from the reference cases, each with the call sequence that
#: drives it: (site, ctx) pairs
PARITY_PLANS = {
    "counters": (_plan({"site": "controller.dispatch", "action": "drop",
                        "after": 1, "every": 2, "times": 2}),
                 [("controller.dispatch", {})] * 8),
    "match": (_plan({"site": "worker.execute", "action": "wedge",
                     "match": {"verb": "group*", "attempt": 2}}),
              [("worker.execute", {"verb": "groupby", "attempt": 1}),
               ("worker.execute", {"verb": "sleep", "attempt": 2}),
               ("worker.execute", {"attempt": 2}),
               ("worker.execute", {"verb": "groupby", "attempt": 2})]),
    "probability": (_plan({"site": "rpc.call", "action": "timeout",
                           "probability": 0.5}, seed=7),
                    [("rpc.call", {"verb": "groupby", "attempt": i % 3})
                     for i in range(64)]),
    "probability_seed8": (_plan({"site": "rpc.call", "action": "timeout",
                                 "probability": 0.3}, seed=8),
                          [("rpc.call", {})] * 64),
    "window_times": (_plan({"site": "coordination.store",
                            "action": "partition", "window_s": 30.0,
                            "times": 2}),
                     [("coordination.store", {"op": "smembers"})] * 6),
    "window_every_probability": (
        _plan({"site": "coordination.store", "action": "partition",
               "window_s": 30.0, "every": 3, "probability": 0.5}, seed=3),
        [("coordination.store", {"op": "sadd", "node": "w"})] * 40),
    "patterns": (_plan({"site": "worker.*", "action": "delay",
                        "args": {"seconds": 0}, "match": {"verb": "sleep"}},
                       {"site": "worker.execute", "action": "wedge",
                        "times": 3}),
                 [("worker.execute", {"verb": v})
                  for v in ("sleep", "groupby", "groupby", "sleep",
                            "groupby", "groupby")]),
    "raise": (_plan({"site": "worker.device", "action": "raise",
                     "args": {"error": "DeviceBusyError", "message": "busy!"},
                     "every": 2},
                    {"site": "worker.execute", "action": "raise",
                     "args": {"error": "NoSuchClass"}, "times": 1}),
              [("worker.device", {"n_tables": 2}),
               ("worker.execute", {"verb": "groupby"})] * 4),
    "worker_matched": (_plan({"site": "worker.execute",
                              "action": "die_after_ack",
                              "match": {"verb": "groupby", "worker": "ab*"},
                              "times": 1},
                             {"site": "worker.reply", "action": "drop",
                              "after": 2},
                             seed=5),
                       [("worker.execute", {"verb": "groupby",
                                            "worker": w})
                        for w in ("cd01", "ab02", "ab03")]
                       + [("worker.reply", {"worker": "ab02"})] * 5),
}


def _drive(module, spec, calls):
    module._reset_for_tests()
    module.arm(json.dumps(spec))
    out = []
    for site, ctx in calls:
        try:
            fault = module.fire(site, **ctx)
        except Exception as exc:  # an injected raise
            out.append(("raise", type(exc).__name__, str(exc)))
            continue
        out.append(None if fault is None
                   else (fault.site, fault.action, fault.rule_index,
                         dict(fault.args)))
    result = (out, module.plan_stats(), module.site_stats(),
              module.injected_total())
    module._reset_for_tests()
    return result


@pytest.mark.parametrize("name", sorted(PARITY_PLANS))
def test_same_plan_same_calls_same_faults(name):
    spec, calls = PARITY_PLANS[name]
    want = _drive(jax_chaos, spec, calls)
    got = _drive(port_chaos, spec, calls)
    assert got == want
    assert any(f is not None for f in got[0])


# -- the same observations, the same statuses --------------------------------

def _snap(count, total):
    return {port_health.LATENCY_FAMILY: [
        {"labels": {}, "buckets": [1.0], "counts": [count], "sum": total}]}


def _observe_sequences():
    """The forensics health cases' sequences, a worker restart, and seeded
    random fleets with errors, outliers and wedges."""
    seqs = {
        "errors": [("w1", _snap(0, 0.0), False, 0, None, 100.0),
                   ("w1", _snap(0, 0.0), False, 10, None, 110.0)],
        "wedged": [("w1", _snap(5, 0.1), True, 0, None, 100.0)],
        "outlier": [(w, _snap(c, c * p), False, 0, None, t)
                    for w, p in (("fast1", 0.01), ("fast2", 0.012),
                                 ("slow", 0.5))
                    for c, t in ((0, 100.0), (10, 110.0))],
        "restart": [("w1", _snap(40, 4.0), False, 2, 11, 100.0),
                    ("w1", _snap(50, 5.0), False, 2, 11, 110.0),
                    ("w1", _snap(3, 9.0), False, 0, 12, 120.0),
                    ("w1", _snap(9, 27.0), False, 0, 12, 130.0)],
    }
    for seed in range(4):
        rng = np.random.default_rng(seed)
        state = {f"w{i}": [0, 0.0, 0] for i in range(4)}
        seq = []
        for step in range(30):
            wid = f"w{int(rng.integers(0, 4))}"
            st = state[wid]
            st[0] += int(rng.integers(0, 6))
            st[1] += float(rng.random() * (5.0 if wid == "w3" else 0.2))
            st[2] += int(rng.integers(0, 3)) if wid == "w2" else 0
            seq.append((wid, _snap(st[0], st[1]), bool(rng.random() < 0.05),
                        st[2], None, 100.0 + 20.0 * step))
        seqs[f"random{seed}"] = seq
    return seqs


@pytest.mark.parametrize("name", sorted(_observe_sequences()))
def test_health_statuses_match_reference(name):
    seq = _observe_sequences()[name]
    want_scorer = jax_health.HealthScorer(window_s=300.0)
    got_scorer = port_health.HealthScorer(window_s=300.0)
    for wid, snap, wedged, errors, pid, now in seq:
        for scorer in (want_scorer, got_scorer):
            scorer.observe(wid, snapshot=snap, wedged=wedged, errors=errors,
                           pid=pid, now=now)
        assert got_scorer.statuses() == want_scorer.statuses()
    ids = sorted({s[0] for s in seq})
    assert got_scorer.healthy_subset(ids) == want_scorer.healthy_subset(ids)
    assert [got_scorer.status(w) for w in ids] == [
        want_scorer.status(w) for w in ids]

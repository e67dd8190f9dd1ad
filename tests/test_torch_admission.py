"""Admission, shard stats and plan-time pruning of the port against the
JAX package's.

* ``plan.stats``: ``gather_table_stats`` (full, and incremental after an
  append, and after an in-place replacement), ``StatsCollector`` and
  ``stats_can_match`` over shards written by the JAX package's ctable with
  ``tests/test_ingest.py``'s frames, and ``tests/test_plan.py``'s stats
  terms: the port's dicts and decisions equal the JAX package's;
* ``plan.admission``: the same ``submit``/``release``/``pop_ready``
  sequences as ``tests/test_plan.py``'s admission cases give equal
  decisions and launch order on both packages;
* the controller cases of ``tests/test_plan.py`` (plan-time pruning,
  shared dispatch, resend, supersede, deadlines, BUSY, quotas, the
  admission queue, stats absorption, the staged window, the bundle reply
  without members) on a port controller whose replies are captured;
* the worker's advertisement: its WRM carries JSON-safe stats equal to the
  JAX package's, re-advertised only when they change or after
  ``STATS_READVERTISE_S``, invalidated by an append, off under
  ``BQUERYD_TPU_SHARD_STATS=0``;
* on a port cluster (threads over TCP ZMQ on 127.0.0.1): a query whose
  filter the advertised stats exclude on every shard is answered with no
  dispatch, as pandas answers it; a JAX ``RPC`` reads a port BUSY reply;
  at window 0 the controller's CalcMessages are those of the port's
  controller without a window (no staging, one message per shard group,
  the same keys and plan fragment).
"""

import json
import logging
import os
import pickle
import threading
import time

import numpy as np
import pytest

from bqueryd_tpu import plan as jax_plan
from bqueryd_tpu.plan import stats as jax_stats
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import plan as planmod
from bqueryd_tpu_torch.controller import ControllerNode
from bqueryd_tpu_torch.messages import (
    CalcMessage,
    RPCMessage,
    WorkerRegisterMessage,
)
from bqueryd_tpu_torch.plan import AdmissionController, stats_can_match
from bqueryd_tpu_torch.plan import stats as port_stats
from bqueryd_tpu_torch.storage.ctable import ctable
from test_ingest import _frame
from test_plan import STATS, shard_stats
from test_plan import test_stats_can_match as _ref_stats_case
from tests.conftest import wait_until
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

QUIET = logging.WARNING
RPC_TIMEOUT = 30

#: tests/test_plan.py's stats_can_match terms and decisions
STATS_TERMS = _ref_stats_case.pytestmark[0].args[1]


# -- plan.stats ----------------------------------------------------------------

@pytest.mark.parametrize("term,expected", STATS_TERMS)
def test_stats_can_match_matches_reference(term, expected):
    assert stats_can_match(STATS, [term]) is expected
    assert jax_stats.stats_can_match(STATS, [term]) is expected


@pytest.mark.parametrize("stats,terms", [
    (STATS, [("x", ">", 12), ("x", ">", 99)]),
    (STATS, [("x", ">", 12), ("x", "<", 19)]),
    (5, [("x", ">", 1)]),
    ({"cols": 3}, [("x", ">", 1)]),
    ({"cols": {"x": {"kind": "numeric", "min": "a", "max": "b"}}},
     [("x", ">", 1)]),
    (STATS, [("x", "==")]),
    (STATS, [("x", "in", [True])]),
])
def test_stats_can_match_conjunctions_and_garbage(stats, terms):
    assert (stats_can_match(stats, terms)
            is jax_stats.stats_can_match(stats, terms))


def _both_tables(root):
    return ctable(root, mode="r"), jax_ctable(root, mode="r")


def test_gather_stats_full_matches_reference(tmp_path):
    root = str(tmp_path / "t.bcolzs")
    jax_ctable.fromdataframe(_frame(400), root, chunklen=100)
    port_t, jax_t = _both_tables(root)
    got = port_stats.gather_table_stats(port_t)
    assert got == jax_stats.gather_table_stats(jax_t)
    assert got["rows"] == 400 and got["cols"]["v"]["chunks"] == 4
    assert got["cols"]["s"]["card"] == 3
    # JSON-safe: a WRM carries it as it is
    assert json.loads(json.dumps(got)) == got


def test_gather_stats_incremental_on_append_matches_reference(
        tmp_path, monkeypatch):
    import pandas as pd

    root = str(tmp_path / "t.bcolzs")
    jax_ctable.fromdataframe(_frame(400), root, chunklen=100)
    port_t, jax_t = _both_tables(root)
    prev = port_stats.gather_table_stats(port_t)
    jax_prev = jax_stats.gather_table_stats(jax_t)
    jax_ctable(root, mode="a").append_dataframe(pd.DataFrame({
        "g": [1], "v": [5000], "f": [0.5], "s": ["zz"], "seq": [9999],
        "ts": _frame(1)["ts"],
    }))
    calls = []
    real = port_stats._sidecar_cardinality
    monkeypatch.setattr(port_stats, "_sidecar_cardinality",
                        lambda t, n: calls.append(n) or real(t, n))
    port_t, jax_t = _both_tables(root)
    fresh = port_stats.gather_table_stats(port_t, prev=prev)
    assert calls == [], "grown-only columns must skip the sidecar probe"
    assert fresh == jax_stats.gather_table_stats(jax_t, prev=jax_prev)
    assert fresh["rows"] == 401
    assert fresh["cols"]["v"]["max"] == 5000
    assert fresh["cols"]["v"]["chunks"] == 5
    assert fresh["cols"]["s"]["card"] == 4
    full = port_stats.gather_table_stats(port_t)
    assert fresh["cols"]["v"]["min"] == full["cols"]["v"]["min"]
    assert fresh["cols"]["v"]["max"] == full["cols"]["v"]["max"]


def test_gather_stats_rejects_in_place_replacement(tmp_path):
    root = str(tmp_path / "t.bcolzs")
    old = _frame(400, seed=40)
    old["v"] += 100_000
    jax_ctable.fromdataframe(old, root, chunklen=100)
    prev = port_stats.gather_table_stats(ctable(root, mode="r"))
    assert prev["cols"]["v"]["min"] >= 99_000
    jax_ctable.fromdataframe(_frame(500, seed=41), root, chunklen=100)
    port_t, jax_t = _both_tables(root)
    fresh = port_stats.gather_table_stats(port_t, prev=prev)
    full = port_stats.gather_table_stats(port_t)
    assert fresh["cols"]["v"]["min"] == full["cols"]["v"]["min"] < 0
    assert fresh["cols"]["v"]["max"] == full["cols"]["v"]["max"]
    assert fresh == jax_stats.gather_table_stats(jax_t, prev=prev)


def test_stats_collector_matches_reference_and_invalidates(tmp_path):
    root = str(tmp_path / "t.bcolzs")
    jax_ctable.fromdataframe(_frame(100), root)
    collector = port_stats.StatsCollector(min_refresh_s=3600.0)
    jax_collector = jax_stats.StatsCollector(min_refresh_s=3600.0)
    first = collector.collect(str(tmp_path), ["t.bcolzs", "missing.bcolzs"])
    assert first == jax_collector.collect(str(tmp_path),
                                          ["t.bcolzs", "missing.bcolzs"])
    assert set(first) == {"t.bcolzs"} and first["t.bcolzs"]["rows"] == 100
    jax_ctable(root, mode="a").append_dataframe(
        _frame(20, seed=5, offset=100))
    # inside the refresh window: the same snapshot object
    assert collector.collect(str(tmp_path),
                             ["t.bcolzs", "missing.bcolzs"]) is first
    collector.invalidate()
    jax_collector.invalidate()
    fresh = collector.collect(str(tmp_path), ["t.bcolzs", "missing.bcolzs"])
    assert fresh["t.bcolzs"]["rows"] == 120
    assert fresh == jax_collector.collect(str(tmp_path),
                                          ["t.bcolzs", "missing.bcolzs"])


# -- plan.admission -------------------------------------------------------------

def _run_sequence(cls, ctor, steps):
    """Drive one admission controller; the log of every result."""
    adm = cls(**ctor)
    log = []
    for step in steps:
        op, args = step[0], step[1:]
        if op == "submit":
            ticket, client, kw = args
            log.append(adm.submit(ticket, client, **kw))
        elif op == "release":
            log.append(adm.release(args[0]))
        elif op == "pop":
            log.append(adm.pop_ready(now=args[0] if args else None))
    stats = adm.stats()
    return log, stats


NOW = 1_000_000.0

#: tests/test_plan.py's admission cases as (ctor, steps) sequences
ADMISSION_SEQUENCES = {
    "backpressure and release": (
        {"max_active": 1, "queue_depth": 1, "client_quota": 0},
        [("submit", "t1", "c1", {"payload": "p1"}),
         ("submit", "t2", "c2", {"payload": "p2"}),
         ("submit", "t3", "c3", {"payload": "p3"}),
         ("submit", "t1", "c1", {"payload": "p1"}),
         ("submit", "t2", "c2", {"payload": "p2"}),
         ("release", "t1"), ("pop",)]),
    "client quota": (
        {"max_active": 8, "queue_depth": 8, "client_quota": 1},
        [("submit", "t1", "same", {"payload": "p1"}),
         ("submit", "t2", "same", {"payload": "p2"}),
         ("submit", "t3", "other", {"payload": "p3"}),
         ("release", "t1"),
         ("submit", "t4", "same", {"payload": "p4"})]),
    "deadline expiry in queue": (
        {"max_active": 1, "queue_depth": 4},
        [("submit", "t1", "c1", {"payload": "p1"}),
         ("submit", "t2", "c2", {"deadline": NOW - 1, "payload": "p2"}),
         ("pop", NOW), ("release", "t1")]),
    "priority order": (
        {"max_active": 1, "queue_depth": 8},
        [("submit", "t0", "c", {"payload": "p0"}),
         ("submit", "tlow", "c1", {"priority": 5, "payload": "low"}),
         ("submit", "thigh", "c2", {"priority": 1, "payload": "high"}),
         ("release", "t0"), ("pop", NOW)]),
    "deadline sweep behind priority": (
        {"max_active": 1, "queue_depth": 8},
        [("submit", "t0", "c", {"payload": "p0"}),
         ("submit", "ta", "c1", {"priority": 1, "deadline": NOW + 10,
                                 "payload": "a"}),
         ("submit", "tb", "c2", {"priority": 9, "deadline": NOW - 5,
                                 "payload": "b"}),
         ("pop", NOW), ("release", "t0"), ("pop", NOW),
         ("release", "ta"), ("release", "ta"), ("release", "tb")]),
    "fifo within a priority": (
        {"max_active": 1, "queue_depth": 8},
        [("submit", "t0", "c", {"payload": "p0"}),
         ("submit", "t1", "c", {"payload": "p1"}),
         ("submit", "t2", "c", {"payload": "p2"}),
         ("release", "t1"), ("release", "t0"), ("pop", NOW)]),
}


@pytest.mark.parametrize("name", sorted(ADMISSION_SEQUENCES))
def test_admission_sequences_match_reference(name):
    ctor, steps = ADMISSION_SEQUENCES[name]
    port = _run_sequence(AdmissionController, ctor, steps)
    ref = _run_sequence(jax_plan.AdmissionController, ctor, steps)
    assert port == ref
    assert (planmod.ADMIT, planmod.QUEUED, planmod.BUSY,
            planmod.DUPLICATE) == (jax_plan.ADMIT, jax_plan.QUEUED,
                                   jax_plan.BUSY, jax_plan.DUPLICATE)


def test_admission_env_defaults_match_reference(monkeypatch):
    for name, value in (("BQUERYD_TPU_ADMIT_MAX_ACTIVE", "3"),
                        ("BQUERYD_TPU_ADMIT_QUEUE_DEPTH", "junk"),
                        ("BQUERYD_TPU_ADMIT_CLIENT_QUOTA", "2")):
        monkeypatch.setenv(name, value)
    port = AdmissionController().stats()
    assert port == jax_plan.AdmissionController().stats()
    assert (port["max_active"], port["queue_depth"],
            port["client_quota"]) == (3, 256, 2)


# -- the controller --------------------------------------------------------------

def _capturing(node):
    node._replies = []
    node.reply_rpc_raw = (
        lambda client_token, payload: node._replies.append(
            (client_token, payload)))
    return node


@pytest.fixture
def new_controller(tmp_path):
    nodes = []

    def make(**kw):
        node = _capturing(ControllerNode(
            coordination_url=f"mem://admit-{os.urandom(4).hex()}",
            loglevel=QUIET, runfile_dir=str(tmp_path), **kw))
        nodes.append(node)
        return node

    yield make
    for node in nodes:
        node.socket.close()


@pytest.fixture
def controller(new_controller):
    return new_controller()


def register(controller, worker_id, files, busy=True, stats=None):
    controller.worker_map[worker_id] = {
        "worker_id": worker_id, "workertype": "calc", "busy": busy,
        "last_seen": time.time(), "node": controller.node_name,
    }
    for f in files:
        controller.files_map.setdefault(f, set()).add(worker_id)
        if stats is not None:
            controller.shard_stats[f] = stats.get(f) or stats


def groupby_msg(filenames, where=None, token="00", deadline=None,
                client_id=None, **kwargs):
    msg = RPCMessage({"payload": "groupby", "token": token})
    msg.set_args_kwargs(
        [filenames, ["k"], [["v", "sum", "v"]], where or []], kwargs)
    if deadline is not None:
        msg["deadline"] = deadline
    if client_id is not None:
        msg["client_id"] = client_id
    return msg


def queued(controller):
    return [m for queue in controller.worker_out_messages.values()
            for m in queue]


def clear_queues(controller):
    for queue in controller.worker_out_messages.values():
        queue.clear()


def reply_to(msg, data):
    reply = CalcMessage(dict(msg))
    reply["data"] = data
    return reply


def test_plan_time_pruning_skips_excluded_shards(controller):
    stats = {"a.bcolzs": shard_stats(100, {"k": 3}, lo=0, hi=50),
             "b.bcolzs": shard_stats(100, {"k": 3}, lo=1000, hi=2000)}
    register(controller, "w1", ["a.bcolzs", "b.bcolzs"], stats=stats)
    controller.rpc_groupby(
        groupby_msg(["a.bcolzs", "b.bcolzs"], where=[["x", ">", 100]]))
    assert len(queued(controller)) == 1  # x has no stats: both, batched
    clear_queues(controller)
    controller.rpc_segments.clear()
    controller.rpc_groupby(groupby_msg(
        ["a.bcolzs", "b.bcolzs"], where=[["k", "<", 60]], token="01"))
    (msg,) = queued(controller)
    assert msg["filename"] == "a.bcolzs"
    assert controller.counters["plan_pruned_shards"] == 1
    (segment,) = controller.rpc_segments.values()
    assert segment["results"] == {("b.bcolzs",): b""}


def test_all_shards_pruned_replies_immediately(controller):
    register(controller, "w1", ["a.bcolzs"],
             stats={"a.bcolzs": shard_stats(100, {"k": 3}, lo=0, hi=50)})
    controller.rpc_groupby(
        groupby_msg(["a.bcolzs"], where=[["k", ">", 99]], token="aa"))
    assert not queued(controller)
    assert not controller.rpc_segments
    ((client, payload),) = controller._replies
    envelope = pickle.loads(payload)
    assert client == "aa" and envelope["ok"] is True
    assert envelope["payloads"] == [b""]
    assert controller.admission.stats()["active"] == 0


def test_planner_disabled_restores_static_fanout(controller, monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_PLANNER", "0")
    register(controller, "w1", ["a.bcolzs"],
             stats={"a.bcolzs": shard_stats(100, {"k": 3}, lo=0, hi=50)})
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], where=[["k", ">", 99]]))
    (msg,) = queued(controller)
    assert msg.get_from_binary("plan")["strategy"] is None
    assert controller.counters["plan_pruned_shards"] == 0


def test_shared_dispatch_fuses_identical_queries(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="bb"))
    (msg,) = queued(controller)
    assert controller.counters["plan_shared_dispatches"] == 1
    assert len(controller.rpc_segments) == 2
    assert len(controller._work_subscribers[msg["token"]]) == 2
    controller.process_worker_result(reply_to(msg, b"payload-bytes"))
    assert not controller.rpc_segments
    assert sorted(c for c, _ in controller._replies) == ["aa", "bb"]
    for _, payload in controller._replies:
        envelope = pickle.loads(payload)
        assert envelope["ok"] and envelope["payloads"] == [b"payload-bytes"]
    assert not controller._work_subscribers and not controller._work_index
    assert controller.admission.stats()["active"] == 0


def test_client_resend_does_not_duplicate_fanout(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    assert len(queued(controller)) == 1
    assert len(controller.rpc_segments) == 1
    assert controller.admission.stats()["active"] == 1
    (msg,) = queued(controller)
    controller.process_worker_result(reply_to(msg, b"x"))
    assert [c for c, _ in controller._replies] == ["aa"]
    assert controller.admission.stats()["active"] == 0
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    assert controller.admission.stats()["active"] == 1


def test_retry_with_fresh_deadline_joins_inflight_run(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa",
                                       deadline=time.time() + 60))
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa",
                                       deadline=time.time() + 90))
    assert controller.counters["admission_superseded"] == 0
    assert len(queued(controller)) == 1
    assert controller.admission.stats()["active"] == 1


def test_new_query_on_live_identity_supersedes(controller):
    register(controller, "w1", ["a.bcolzs", "b.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    old_msgs = queued(controller)
    controller.rpc_groupby(
        groupby_msg(["b.bcolzs"], where=[["k", ">", 1]], token="aa"))
    assert controller.counters["admission_superseded"] == 1
    assert controller.admission.stats()["active"] == 1
    (segment,) = controller.rpc_segments.values()
    assert segment["filenames"] == ["b.bcolzs"]
    for msg in old_msgs:
        assert msg["token"] not in controller._work_subscribers
    (new_msg,) = queued(controller)
    assert new_msg["token"] in controller._work_subscribers
    # a late reply of the abandoned run reaches nobody
    controller.process_worker_result(reply_to(old_msgs[0], b"stale"))
    assert controller._replies == []
    controller.process_worker_result(reply_to(new_msg, b"x"))
    assert [c for c, _ in controller._replies] == ["aa"]
    assert controller.admission.stats()["active"] == 0


def test_different_deadlines_do_not_fuse(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa",
                                       deadline=time.time() + 0.05))
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="bb"))
    assert len(queued(controller)) == 2
    assert controller.counters["plan_shared_dispatches"] == 0
    time.sleep(0.1)
    controller.dispatch_pending()
    (remaining,) = queued(controller)
    assert remaining.get("deadline") is None
    ((client, payload),) = controller._replies
    assert client == "aa" and not pickle.loads(payload)["ok"]
    assert controller.counters["deadline_expired"] == 1
    assert controller.admission.stats()["active"] == 1  # bb's


def test_different_queries_do_not_fuse(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller.rpc_groupby(
        groupby_msg(["a.bcolzs"], where=[["k", ">", 1]], token="bb"))
    assert len(queued(controller)) == 2
    assert controller.counters["plan_shared_dispatches"] == 0


def test_aborted_subscriber_does_not_kill_shared_work(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="bb"))
    (msg,) = queued(controller)
    aa_parent = next(p for p, s in controller.rpc_segments.items()
                     if s["client_token"] == "aa")
    controller.abort_parent(aa_parent, "client gave up")
    assert queued(controller) == [msg]
    controller.process_worker_result(reply_to(msg, b"x"))
    done = {c: pickle.loads(p) for c, p in controller._replies}
    assert done["aa"]["ok"] is False and done["bb"]["ok"] is True
    assert controller.admission.stats()["active"] == 0


def test_malformed_stats_advertisement_is_quarantined(controller):
    register(controller, "w1", ["a.bcolzs"])
    controller._absorb_shard_stats({"shard_stats": 5})
    controller._absorb_shard_stats({"shard_stats": {"a.bcolzs": 7}})
    controller._absorb_shard_stats({"shard_stats": {
        "b.bcolzs": {"rows": 1, "cols": []}}})
    assert not controller.shard_stats
    controller._absorb_shard_stats({"shard_stats": {"a.bcolzs": {
        "rows": "many",
        "cols": {"k": {"kind": "numeric", "min": "lo", "max": 3}},
    }}})
    controller.rpc_groupby(
        groupby_msg(["a.bcolzs"], where=[["k", ">", 1]], token="aa"))
    assert len(queued(controller)) == 1
    assert controller.counters["plan_pruned_shards"] == 0


def test_failed_launch_leaves_no_zombie_segment(controller, monkeypatch):
    register(controller, "w1", ["a.bcolzs", "b.bcolzs"])
    orig = controller._register_work
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("mid-launch failure")
        return orig(*args, **kwargs)

    monkeypatch.setattr(controller, "_register_work", flaky)
    with pytest.raises(RuntimeError):
        controller.rpc_groupby(groupby_msg(["a.bcolzs", "b.bcolzs"],
                                           token="aa", batch=False))
    assert not controller.rpc_segments
    assert not controller._work_subscribers and not controller._work_index
    assert not queued(controller)
    assert controller.admission.stats()["active"] == 0


def test_admission_busy_reply(new_controller):
    node = new_controller(admit_max_active=1, admit_queue_depth=1)
    register(node, "w1", ["a.bcolzs"])
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="bb"))
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="cc"))
    assert node.counters["admission_busy"] == 1
    assert node.counters["admission_queued"] == 1
    ((client, payload),) = node._replies
    envelope = pickle.loads(payload)
    assert client == "cc"
    assert envelope["busy"] is True and envelope["ok"] is False
    (msg,) = queued(node)
    clear_queues(node)  # the dispatch
    node.process_worker_result(reply_to(msg, b"x"))
    assert {c for c, _ in node._replies} == {"aa", "cc"}
    (msg2,) = queued(node)  # bb launched into the freed capacity
    node.process_worker_result(reply_to(msg2, b"y"))
    assert {c for c, _ in node._replies} == {"aa", "bb", "cc"}
    assert node.admission.stats()["active"] == 0


def test_client_quota_binds_across_sockets(new_controller):
    node = new_controller(admit_client_quota=1)
    register(node, "w1", ["a.bcolzs"])
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa", client_id="app1"))
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="bb", client_id="app1"))
    assert node.counters["admission_busy"] == 1
    ((client, payload),) = node._replies
    assert client == "bb" and pickle.loads(payload)["busy"] is True
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="cc", client_id="app2"))
    assert node.counters["admission_busy"] == 1


def test_admission_queue_launches_after_release(new_controller):
    node = new_controller(admit_max_active=1, admit_queue_depth=4)
    register(node, "w1", ["a.bcolzs", "b.bcolzs"])
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    node.rpc_groupby(groupby_msg(["b.bcolzs"], token="bb"))
    (msg,) = queued(node)
    node.process_worker_result(reply_to(msg, b"x"))
    assert any(m["filename"] == "b.bcolzs" for m in queued(node))


def test_queued_plan_expires_past_its_deadline(new_controller):
    """A plan that waits in the admission queue past its deadline is
    answered with an error and never launched."""
    node = new_controller(admit_max_active=1, admit_queue_depth=4)
    register(node, "w1", ["a.bcolzs", "b.bcolzs"])
    node.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    node.rpc_groupby(groupby_msg(["b.bcolzs"], token="bb",
                                 deadline=time.time() + 0.05))
    time.sleep(0.1)
    node._admit_ready()
    ((client, payload),) = node._replies
    assert client == "bb" and "deadline" in pickle.loads(payload)["error"]
    assert node.counters["deadline_expired"] == 1
    stats = node.admission.stats()
    assert stats["active"] == 1 and stats["queued"] == 0


def test_queued_dispatch_expires_past_deadline(controller):
    register(controller, "w1", ["a.bcolzs"], busy=True)
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa",
                                       deadline=time.time() + 0.05))
    (msg,) = queued(controller)
    assert msg.get("deadline") is not None
    time.sleep(0.1)
    controller.dispatch_pending()
    assert not queued(controller)
    assert controller.counters["deadline_expired"] == 1
    ((client, payload),) = controller._replies
    envelope = pickle.loads(payload)
    assert not envelope["ok"] and "deadline" in envelope["error"]
    assert controller.admission.stats()["active"] == 0


def test_wrm_shard_stats_absorbed(controller):
    controller.handle_worker(b"w9", WorkerRegisterMessage({
        "worker_id": "w9", "workertype": "calc", "data_files": ["a.bcolzs"],
        "shard_stats": {"a.bcolzs": {"rows": 42, "cols": {}}},
    }))
    assert controller.shard_stats["a.bcolzs"]["rows"] == 42
    # a liveness WRM of a known worker carries stats too
    controller.handle_worker(b"w9", WorkerRegisterMessage({
        "worker_id": "w9", "workertype": "calc", "liveness_only": True,
        "data_files": ["a.bcolzs"],
        "shard_stats": {"a.bcolzs": {"rows": 43, "cols": {}}},
    }))
    assert controller.shard_stats["a.bcolzs"]["rows"] == 43
    controller.handle_worker(b"w9", WorkerRegisterMessage(
        {"worker_id": "w9", "workertype": "calc", "data_files": []}))
    assert "a.bcolzs" not in controller.shard_stats
    assert controller.get_info()["shard_stats_known"] == 0


def test_supersede_drops_staged_window_plan(controller, monkeypatch):
    register(controller, "w1", ["a.bcolzs", "b.bcolzs"])
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "60000")
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    assert len(controller._pending_window) == 1
    assert not controller.rpc_segments
    controller.rpc_groupby(
        groupby_msg(["b.bcolzs"], where=[["k", ">", 1]], token="aa"))
    assert controller.counters["admission_superseded"] == 1
    (staged,) = controller._pending_window
    assert staged[1].filenames == ["b.bcolzs"]
    assert controller.admission.stats()["active"] == 1
    controller._flush_window(force=True)
    (segment,) = controller.rpc_segments.values()
    assert segment["filenames"] == ["b.bcolzs"]
    assert controller._replies == []


def test_bundle_reply_without_members_aborts_not_misdelivers(
        controller, monkeypatch):
    register(controller, "w1", ["a.bcolzs"])
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "60000")
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller.rpc_groupby(
        groupby_msg(["a.bcolzs"], where=[["k", ">", 1]], token="bb"))
    controller._flush_window(force=True)
    assert controller.counters["plan_bundles"] == 1
    (msg,) = queued(controller)
    assert msg.get("bundle") and msg.get("_bundle_parents")
    controller.process_worker_result(reply_to(msg, b"member0-payload"))
    assert sorted(c for c, _ in controller._replies) == ["aa", "bb"]
    for _client, payload in controller._replies:
        envelope = pickle.loads(payload)
        assert envelope["ok"] is False
        assert "BQUERYD_TPU_BATCH_WINDOW_MS=0" in envelope["error"]
    assert not controller.rpc_segments
    assert controller.admission.stats()["active"] == 0


def test_bundle_demux_releases_every_ticket(controller, monkeypatch):
    """A member aborted by its error in the demux, a member whose query
    was superseded while in flight and a completed member all leave no
    ticket; the completed member's timings are scaled by its share."""
    register(controller, "w1", ["a.bcolzs"])
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "60000")
    for token, t in (("aa", 1), ("bb", 2), ("cc", 3)):
        controller.rpc_groupby(groupby_msg(
            ["a.bcolzs"], where=[["k", ">", t]], token=token))
    controller._flush_window(force=True)
    (msg,) = queued(controller)
    members = msg["_bundle_parents"]
    by_client = {controller.rpc_segments[p]["client_token"]: m
                 for m, p in members.items()}
    # cc's client moves on: its run is retired while in flight
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="cc",
                                       where=[["k", ">", 9]]))
    assert controller.counters["admission_superseded"] == 1
    reply = reply_to(msg, pickle.dumps({
        "v": 1,
        "payloads": {by_client["aa"]: b"A", by_client["cc"]: b"C"},
        "errors": {by_client["bb"]: "member failed"},
    }))
    reply["bundle_members"] = list(members)
    reply["member_shares"] = {by_client["aa"]: 0.5, by_client["cc"]: 0.5}
    reply["phase_timings"] = {"execute": 2.0, "_total": 4.0}
    controller.process_worker_result(reply)
    replies = {c: pickle.loads(p) for c, p in controller._replies}
    assert replies["aa"]["ok"] and replies["aa"]["payloads"] == [b"A"]
    assert replies["aa"]["timings"]["a.bcolzs"] == {
        "execute": 1.0, "_total": 2.0, "_member_share": 0.5}
    assert replies["bb"]["ok"] is False
    assert "member failed" in replies["bb"]["error"]
    assert set(replies) == {"aa", "bb"}  # no reply for the retired run
    # only the superseding query of cc holds a ticket
    assert controller.admission.stats()["active"] == 1


def test_window_flush_launch_failure_answers_members(controller,
                                                     monkeypatch):
    register(controller, "w1", ["a.bcolzs"])
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "60000")
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller.rpc_groupby(
        groupby_msg(["a.bcolzs"], where=[["k", ">", 1]], token="bb"))

    def broken(*args, **kwargs):
        raise RuntimeError("no shard groups today")

    monkeypatch.setattr(controller, "_shard_groups", broken)
    controller._flush_window(force=True)
    assert sorted(c for c, _ in controller._replies) == ["aa", "bb"]
    assert not controller.rpc_segments and not queued(controller)
    assert controller.admission.stats()["active"] == 0


def test_window_closes_on_its_deadline_or_when_full(controller,
                                                    monkeypatch):
    register(controller, "w1", ["a.bcolzs"])
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "50")
    monkeypatch.setenv("BQUERYD_TPU_BATCH_MAX", "3")
    controller.rpc_groupby(groupby_msg(["a.bcolzs"], token="aa"))
    controller._flush_window()
    assert len(controller._pending_window) == 1  # still open
    time.sleep(0.06)
    controller._flush_window()
    assert not controller._pending_window and len(queued(controller)) == 1
    for i, token in enumerate(("b1", "b2", "b3")):
        controller.rpc_groupby(groupby_msg(
            ["a.bcolzs"], where=[["k", ">", i]], token=token))
    # the third staged plan filled the window: flushed as one bundle
    assert not controller._pending_window
    assert controller.counters["plan_bundles"] == 1
    assert controller.counters["plan_bundled_queries"] == 3


# -- the worker's advertisement ----------------------------------------------------

def test_worker_advertises_json_safe_stats(tmp_path, monkeypatch,
                                           mem_store_url):
    from bqueryd_tpu.worker import WorkerNode as JaxWorker
    from bqueryd_tpu_torch.worker import WorkerNode

    for i in range(2):
        jax_ctable.fromdataframe(_frame(300, seed=i),
                                 str(tmp_path / f"s{i}.bcolzs"), chunklen=100)
    port = WorkerNode(coordination_url=f"mem://adv-{os.urandom(4).hex()}",
                      data_dir=str(tmp_path), loglevel=QUIET, device="cpu")
    ref = JaxWorker(coordination_url=mem_store_url, data_dir=str(tmp_path),
                    loglevel=QUIET, restart_check=False)
    try:
        for w in (port, ref):
            w.check_datafiles()
        wrm = port.prepare_wrm()
        stats = wrm["shard_stats"]
        assert set(stats) == {"s0.bcolzs", "s1.bcolzs"}
        assert stats == ref.shard_stats()
        wire = json.loads(wrm.to_json())
        assert wire["shard_stats"] == stats
        # in the loop's first 10 s every WRM carries them (an early WRM
        # may be lost); after it, unchanged stats wait for the window
        assert port.prepare_wrm()["shard_stats"] == stats
        port._loop_started -= 10.0
        assert port.prepare_wrm()["shard_stats"] is None
        port._stats_sent_ts -= port.STATS_READVERTISE_S + 1
        assert port.prepare_wrm()["shard_stats"] == stats
        # an append invalidates the snapshot: the grown bounds go out
        msg = CalcMessage({"payload": "append"})
        msg.set_args_kwargs(["s0.bcolzs", {
            "g": np.array([1]), "v": np.array([5000]),
            "f": np.array([0.5], dtype=np.float32), "s": np.array(["zz"]),
            "seq": np.array([9999]),
            "ts": np.array(["2024-01-01"], dtype="datetime64[ns]"),
        }], {})
        port.handle_work(msg)
        grown = port.prepare_wrm()["shard_stats"]
        assert grown["s0.bcolzs"]["rows"] == 301
        assert grown["s0.bcolzs"]["cols"]["v"]["max"] == 5000
        monkeypatch.setenv("BQUERYD_TPU_SHARD_STATS", "0")
        assert port.shard_stats() is None
        assert port.prepare_wrm()["shard_stats"] is None
    finally:
        port.socket.close()
        ref.socket.close()


def test_stats_failure_never_breaks_the_heartbeat(tmp_path, monkeypatch):
    from bqueryd_tpu_torch.worker import WorkerNode

    port = WorkerNode(coordination_url=f"mem://adv-{os.urandom(4).hex()}",
                      data_dir=str(tmp_path), loglevel=QUIET, device="cpu")
    try:
        def broken(*a, **k):
            raise OSError("disk gone")

        monkeypatch.setattr(port_stats.StatsCollector, "collect", broken)
        wrm = port.prepare_wrm()
        assert wrm["shard_stats"] is None and wrm["worker_id"]
    finally:
        port.socket.close()


# -- a port cluster ---------------------------------------------------------------

@pytest.fixture(scope="module")
def loopback():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        yield


@pytest.fixture
def cluster(loopback, tmp_path):
    """A port controller and a port calc worker (CPU) over two shards of
    test_ingest.py's frames, found through a file:// store."""
    from bqueryd_tpu_torch.worker import WorkerNode

    frames = [_frame(400, seed=7), _frame(400, seed=8, offset=400)]
    shards = ["p_0.bcolzs", "p_1.bcolzs"]
    for frame, name in zip(frames, shards):
        jax_ctable.fromdataframe(frame, str(tmp_path / name), chunklen=100)
    url = f"file://{tmp_path / 'store'}"
    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=str(tmp_path),
                                heartbeat_interval=0.05)
    worker = WorkerNode(coordination_url=url, data_dir=str(tmp_path),
                        loglevel=QUIET, heartbeat_interval=0.1,
                        poll_timeout=0.05, device="cpu")
    nodes = [controller, worker]
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    try:
        wait_until(lambda: all(n in controller.shard_stats for n in shards),
                   desc="shards and their stats advertised")
        yield {"controller": controller, "worker": worker, "url": url,
               "shards": shards, "frames": frames}
    finally:
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)


def _port_rpc(url, **kw):
    from bqueryd_tpu_torch.rpc import RPC

    return RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
               loglevel=QUIET, **kw)


def test_stats_excluded_query_is_answered_without_dispatch(cluster):
    import pandas as pd

    c = cluster
    controller = c["controller"]
    rpc = _port_rpc(c["url"])
    try:
        dispatched = controller.counters["dispatched_shards"]
        order, cols = rpc.groupby(c["shards"], ["g"], [["v", "sum", "vs"]],
                                  [["v", ">", 1000]])
        assert controller.counters["plan_pruned_shards"] == 2
        assert controller.counters["dispatched_shards"] == dispatched
        df = pd.concat(c["frames"], ignore_index=True)
        want = df[df["v"] > 1000].groupby("g")["v"].sum()
        assert len(want) == 0
        # every payload slot pre-filled empty: the reference's answer with
        # no columns (a JAX client gets an empty DataFrame)
        assert (order, cols) == ([], {})
        # one shard pruned, the other answered
        order, cols = rpc.groupby(c["shards"], ["g"], [["v", "sum", "vs"]],
                                  [["seq", ">=", 400]])
        assert controller.counters["plan_pruned_shards"] == 3
        want = df[df["seq"] >= 400].groupby("g")["v"].sum()
        np.testing.assert_array_equal(cols["g"], want.index.to_numpy())
        np.testing.assert_array_equal(cols["vs"], want.to_numpy())
    finally:
        rpc._close_socket()
    wait_until(lambda: controller.admission.stats()["active"] == 0,
               desc="tickets released")


def test_reference_client_reads_a_port_busy_reply(cluster):
    """A JAX ``RPC`` gets its own ``RPCBusyError`` from the port's BUSY
    envelope, as the port's ``RPC`` gets the port's."""
    from bqueryd_tpu.rpc import RPC as JaxRPC
    from bqueryd_tpu.rpc import RPCBusyError as JaxBusy
    from bqueryd_tpu_torch.rpc import RPCBusyError

    c = cluster
    controller = c["controller"]
    controller.admission.max_active = 0
    controller.admission.queue_depth = 0
    client = JaxRPC(coordination_url=c["url"], timeout=RPC_TIMEOUT,
                    retries=1, loglevel=QUIET)
    rpc = _port_rpc(c["url"], client_id="app")
    try:
        with pytest.raises(JaxBusy):
            client.groupby(c["shards"], ["g"], [["v", "sum", "vs"]], [])
        with pytest.raises(RPCBusyError):
            rpc.groupby(c["shards"], ["g"], [["v", "sum", "vs"]], [])
        assert controller.counters["admission_busy"] == 2
    finally:
        controller.admission.max_active = 64
        controller.admission.queue_depth = 256
        client._close_socket()
        rpc._close_socket()
    # and answers again once there is room
    rpc = _port_rpc(c["url"])
    try:
        order, _cols = rpc.groupby(c["shards"], ["g"], [["v", "sum", "vs"]],
                                   [], priority=3)
        assert order == ["g", "vs"]
    finally:
        rpc._close_socket()


def test_rpc_sends_client_id_and_priority_on_the_envelope(cluster,
                                                          monkeypatch):
    c = cluster
    seen = []
    controller = c["controller"]
    real = controller._admit_plan

    def spy(msg, plan, kwargs):
        seen.append((msg.get("client_id"), msg.get("priority"),
                     dict(kwargs)))
        return real(msg, plan, kwargs)

    monkeypatch.setattr(controller, "_admit_plan", spy)
    rpc = _port_rpc(c["url"], client_id="dash-1")
    try:
        rpc.groupby(c["shards"], ["g"], [["v", "sum", "vs"]], [], priority=2)
        rpc.query({"table": c["shards"], "groupby": ["g"],
                   "aggs": [["v", "sum", "vs"]]}, priority=1)
    finally:
        rpc._close_socket()
    assert [s[:2] for s in seen] == [("dash-1", 2), ("dash-1", 1)]
    # the envelope keys never reach the query's own arguments
    assert all("priority" not in s[2] and "client_id" not in s[2]
               for s in seen)


def _window_zero_expected(msg, plan, group, sole):
    """The CalcMessage the port's controller built for one shard group
    before it had admission and a window, with the affinity key the
    affinity queues add (None: unpinned, as in the reference)."""
    from bqueryd_tpu_torch.plan import fragment_for

    target = group if len(group) > 1 else group[0]
    shard = CalcMessage({"payload": "groupby"})
    if sole:
        shard["sole_shard"] = True
    shard.set_args_kwargs(
        [target, list(plan.groupby.keys), plan.physical_agg_list(),
         plan.where_terms], {})
    shard["token"] = msg["token"]
    shard["parent_token"] = msg["parent_token"]
    shard["filename"] = target
    shard["affinity"] = None
    shard["created"] = msg["created"]
    shard.add_as_binary("plan", fragment_for(plan, group, sole=sole))
    return shard


@pytest.mark.parametrize("files,where", [
    (["a.bcolzs"], []),
    (["a.bcolzs", "b.bcolzs"], [["k", ">", 1]]),
])
def test_window_zero_calc_messages_are_unchanged(controller, monkeypatch,
                                                 files, where):
    monkeypatch.delenv("BQUERYD_TPU_BATCH_WINDOW_MS", raising=False)
    register(controller, "w1", ["a.bcolzs", "b.bcolzs"])
    controller.rpc_groupby(groupby_msg(files, where=where, token="aa"))
    assert not controller._pending_window
    (msg,) = queued(controller)
    plan = planmod.plan_groupby(files, ["k"], [["v", "sum", "v"]], where)
    want = _window_zero_expected(msg, plan, files, sole=len(files) == 1)
    assert dict(msg) == dict(want)

"""The port's resilience layer against the reference's cases.

``tests/test_cluster_resilience.py``'s cases run on port nodes: during each
case the names its body imports from the JAX package (``ControllerNode``,
``WorkerNode``, ``RPC``, ``RPCError``, the messages, ``chaos``) point at
the port's (:func:`on_port`), so the reference's own assertions hold the
port's controller, worker and client.  The port's worker runs on the CPU,
and its ``RPC`` answers are seen as DataFrames.  Included:

* controller-level cases on a port ``ControllerNode`` with no loop: an
  unroutable dispatch, hb-only adoption and its expiry, a hedged entry's
  collapse, stale replies while a retry waits, orphan losers, a hedge
  side's error, overlapping batch payloads, ``maybe_hedge`` after a
  mid-loop requeue and a replayed transient error;
* cluster cases over threads on 127.0.0.1: die-after-ack, DAG top-k and
  quantile failover, batched DAG failover, a transient device fault,
  duplicated and dropped replies, a partitioned worker culled and its work
  re-queued, dispatch exhaustion, a hedged first reply, a late reply of a
  superseded attempt, a hedge side's transient fault, bundle failover,
  append-delta failover, a dead worker culled and rejoining, a busy worker
  not culled, a retry landing on a replacement, and the memory watchdog.

The autopsy and capacity cases run in ``tests/test_torch_capacity.py``.
Then the port's own contracts: a JAX ``RPC`` reads the
port's ``DispatchExhausted`` envelope, appends and rollup builds are
pinned with ``worker_id`` (no ``target``) and carry the reference's wire
keys, a transient device fault launches nothing, the chaos wedge stays per
worker, ``rpc.health()`` and the debug bundle's sections, and the WRM's
health signals.  Every wait is a bounded poll.
"""

import inspect
import logging
import os
import threading
import time
import types

import numpy as np
import pandas as pd
import pytest

import bqueryd_tpu
import test_cluster_resilience as ref
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import chaos as port_chaos
from bqueryd_tpu_torch import controller as port_controller
from bqueryd_tpu_torch import messages as port_messages
from bqueryd_tpu_torch import rpc as port_rpc
from bqueryd_tpu_torch import worker as port_worker
from tests.conftest import wait_until
from tests.torch_fixtures import (  # noqa: F401
    CPUWorkerNode,
    FrameRPC,
    disarmed_port_chaos,
    fresh_port_calibration,
    on_port,
)

QUIET = logging.WARNING


CONTROLLER_CASES = [
    "test_hb_only_adoption_is_busy_until_main_socket_speaks",
    "test_unroutable_dispatch_does_not_charge_retry_budget",
    "test_hb_only_adoption_expires_after_hard_timeout",
    "test_requeue_of_hedged_entry_collapses_onto_surviving_duplicate",
    "test_stale_replies_while_retry_parked_neither_abort_nor_reexecute",
    "test_orphan_loser_error_after_ring_eviction_does_not_abort",
    "test_hedged_nontransient_error_defers_to_survivor",
    "test_segment_completion_tolerates_overlapping_batch_and_children",
    "test_maybe_hedge_skips_entries_requeued_mid_loop",
    "test_replayed_transient_error_counts_once",
]

CLUSTER_CASES = [
    "test_die_after_ack_fails_over_to_replica_holder",
    "test_dag_topk_quantile_fails_over_under_kill_worker",
    "test_batched_dag_fails_over_as_whole_group_under_kill_worker",
    "test_transient_device_fault_retries_on_other_holder",
    "test_duplicated_reply_is_deduped_by_query_token",
    "test_dropped_reply_recovers_via_failover",
    "test_redis_partitioned_worker_is_culled_and_inflight_requeued",
    "test_dispatch_exhaustion_returns_structured_error",
    "test_hedged_dispatch_first_reply_wins",
    "test_late_reply_from_superseded_worker_wins_and_keeps_reclaim_handle",
    "test_hedged_transient_fault_defers_to_outstanding_duplicate",
    "test_bundle_shared_scan_fails_over_as_one_unit",
    "test_append_delta_failover_chaos",
    "test_dead_worker_culled_and_rejoins",
    "test_busy_worker_outliving_dead_timeout_not_culled",
    "test_shard_retry_lands_on_replacement_worker",
    "test_controller_peering_and_killall",
    "test_two_controllers_both_get_heartbeats_during_long_work",
    "test_stop_is_a_shutdown_request_and_deregisters",
    "test_groupby_through_either_controller",
    "test_concurrent_clients_survive_worker_churn",
]

EXECUTE_CODE_CASES = [
    "test_execute_code_roundtrip",
    "test_execute_code_direct_kwargs",
    "test_execute_code_disabled_by_default",
]

WATCHDOG_CASES = [
    "test_memory_watchdog_stops_over_limit_worker",
    "test_memory_watchdog_unmeasurable_shed_still_stops",
    "test_memory_watchdog_shed_recovery_keeps_running",
]


def _store_url():
    return f"mem://torch-resilience-{os.urandom(4).hex()}"


@pytest.mark.parametrize("case", CONTROLLER_CASES)
def test_reference_controller_case_on_port(case, on_port):
    getattr(ref, case)(_store_url())


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_reference_cluster_case_on_port(case, on_port, tmp_path,
                                        monkeypatch):
    fn = getattr(ref, case)
    if case == "test_concurrent_clients_survive_worker_churn":
        # the case's churn starts 0.6 s into the query stream, which the
        # port's CPU workers finish sooner: each groupby is held 0.1 s so
        # that both kills land while the clients still query
        port_chaos.arm({"seed": 1, "faults": [{
            "site": "worker.execute", "action": "delay",
            "match": {"verb": "groupby"}, "args": {"seconds": 0.1},
        }]})
    if "monkeypatch" in inspect.signature(fn).parameters:
        fn(tmp_path, _store_url(), monkeypatch)
    else:
        fn(tmp_path, _store_url())


@pytest.mark.parametrize("case", EXECUTE_CODE_CASES)
def test_reference_execute_code_case_on_port(case, on_port, tmp_path,
                                             monkeypatch):
    """The reference's ``small_cluster`` (one controller, one calc worker)
    built of port nodes, each ``execute_code`` case run on it."""
    cluster = ref.small_cluster.__wrapped__(tmp_path, _store_url())
    nodes = next(cluster)
    try:
        assert type(nodes["worker"]) is CPUWorkerNode
        getattr(ref, case)(nodes, monkeypatch)
    finally:
        next(cluster, None)


@pytest.mark.parametrize("case", WATCHDOG_CASES)
def test_reference_watchdog_case_on_port(case, on_port, tmp_path,
                                         monkeypatch):
    fn = getattr(ref, case)
    if case == "test_memory_watchdog_stops_over_limit_worker":
        fn(tmp_path, _store_url())
    else:
        fn(tmp_path, _store_url(), monkeypatch)


def test_reference_helpers_build_port_nodes(on_port, tmp_path):
    """The swap reaches the reference's helpers: its replica cluster is
    made of port nodes and its client is the port's."""
    url = _store_url()
    controller, workers, threads, expected, shards = ref._replica_cluster(
        tmp_path, url)
    try:
        assert type(controller) is port_controller.ControllerNode
        assert all(type(w) is CPUWorkerNode for w in workers)
        rpc, got = ref._ask_sum(url, shards)
        assert isinstance(rpc, FrameRPC) and got == expected
    finally:
        ref._stop([controller] + workers, threads)


# -- the port's own contracts ------------------------------------------------

def _port_replicas(tmp_path, n_workers=2, **controller_kwargs):
    """A port controller and ``n_workers`` CPU workers over one shard
    directory (every shard has every worker as a holder), small timeouts,
    a file:// store (so that a JAX client finds the controller too)."""
    rng = np.random.default_rng(5)
    frames = {}
    for name in ("rep_0.bcolzs", "rep_1.bcolzs"):
        df = pd.DataFrame({
            "g": rng.integers(0, 4, 300).astype(np.int64),
            "v": rng.integers(-(2**40), 2**40, 300).astype(np.int64),
        })
        frames[name] = df
        jax_ctable.fromdataframe(df, str(tmp_path / name))
    url = f"file://{tmp_path / 'store'}"
    kwargs = dict(heartbeat_interval=0.05, dead_worker_timeout=1.0,
                  dispatch_timeout=1.5)
    kwargs.update(controller_kwargs)
    controller = port_controller.ControllerNode(
        coordination_url=url, loglevel=QUIET, runfile_dir=str(tmp_path),
        **kwargs)
    workers = [
        CPUWorkerNode(coordination_url=url, data_dir=str(tmp_path),
                      loglevel=QUIET, heartbeat_interval=0.2,
                      poll_timeout=0.05)
        for _ in range(n_workers)
    ]
    threads = ref._start(controller, *workers)
    wait_until(lambda: all(len(controller.files_map.get(n, ())) >= n_workers
                           for n in frames)
               and all(w.worker_id in controller.worker_map
                       and not controller.worker_map[w.worker_id].get(
                           "hb_only") for w in workers),
               desc="every shard advertised by every worker, each "
                    "registered from its own loop")
    expected = pd.concat(frames.values()).groupby("g")["v"].sum().to_dict()
    return controller, workers, threads, expected, sorted(frames), url


def test_jax_rpc_reads_port_dispatch_exhaustion(loopback_ip, tmp_path):
    from bqueryd_tpu.rpc import RPC as JaxRPC
    from bqueryd_tpu.rpc import RPCError as JaxRPCError

    controller, workers, threads, _expected, shards, url = _port_replicas(
        tmp_path)
    try:
        port_chaos.arm({"seed": 6, "faults": [{
            "site": "worker.execute", "action": "raise",
            "match": {"verb": "groupby"},
            "args": {"error": "DeviceBusyError"},
        }]})
        client = JaxRPC(coordination_url=url, timeout=30, retries=1,
                        loglevel=QUIET)
        with pytest.raises(JaxRPCError) as excinfo:
            client.groupby(shards, ["g"], [["v", "sum", "s"]], [])
        err = excinfo.value
        assert err.error_class == "DispatchExhausted"
        attempts = err.attempts
        assert len(attempts) == controller.max_dispatch_retries + 1
        assert {a["worker"] for a in attempts} == {
            w.worker_id for w in workers}
        assert all("DeviceBusyError" in a["reason"] for a in attempts)
        assert [a["retries"] for a in attempts] == [0, 1, 2]
        assert controller.counters["transient_faults"] == len(attempts)
        assert controller.counters["failover_dispatches"] == 2
    finally:
        port_chaos.disarm()
        ref._stop([controller] + workers, threads)


@pytest.fixture
def loopback_ip(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")


def _ws_entries(worker):
    """Entries in a worker executor's working set, every segment."""
    from bqueryd_tpu_torch.ops.workingset import SEGMENTS

    return sum(len(worker.executor.workingset.segment(name))
               for name in SEGMENTS)


def test_transient_device_fault_launches_nothing_and_fails_over(
        loopback_ip, tmp_path, monkeypatch):
    """The worker.device site fires before any upload or launch: the
    faulted attempt uploads nothing and leaves the executor's working set
    as it was, and the retry on the other holder answers."""
    from bqueryd_tpu_torch.parallel import executor as executor_mod

    uploads = []
    real_upload = executor_mod._upload

    def counted_upload(arr, device):
        uploads.append(threading.current_thread())
        return real_upload(arr, device)

    monkeypatch.setattr(executor_mod, "_upload", counted_upload)
    controller, workers, threads, expected, shards, url = _port_replicas(
        tmp_path)
    try:
        rpc = port_rpc.RPC(coordination_url=url, timeout=30, retries=1,
                           loglevel=QUIET)
        entries_before = [_ws_entries(w) for w in workers]
        port_chaos.arm({"seed": 1, "faults": [{
            "site": "worker.device", "action": "raise",
            "args": {"error": "DeviceBusyError"}, "times": 1,
        }]})
        order, cols = rpc.groupby(shards, ["g"], [["v", "sum", "s"]], [])
        assert dict(zip(cols["g"].tolist(), cols["s"].tolist())) == expected
        assert controller.counters["transient_faults"] == 1
        assert controller.counters["failover_dispatches"] == 1
        assert port_chaos.site_stats() == {"worker.device": 1}
        (failed,) = [e for e in controller.flight.events()
                     if e["kind"] == "transient_fault"]
        faulted = next(w for w in workers
                       if w.worker_id == failed["worker"])
        answered = next(w for w in workers if w is not faulted)
        # the faulted attempt uploaded and cached nothing
        assert faulted._loop_thread not in uploads
        assert answered._loop_thread in uploads
        assert _ws_entries(faulted) == entries_before[workers.index(faulted)]
        assert _ws_entries(answered) > entries_before[
            workers.index(answered)]
        assert faulted.groupby_seconds.count == 0
        assert answered.groupby_seconds.count == 1
    finally:
        port_chaos.disarm()
        ref._stop([controller] + workers, threads)


def test_chaos_wedge_stays_per_worker_and_health_routes_around(
        loopback_ip, tmp_path):
    """A chaos wedge latches one worker's advertisement (never the
    process-global latch): rpc.health() lists it as wedged, the flight
    ring records worker_wedged, dispatch prefers the other holder, and the
    wedged worker answers no groupby after the latch."""
    from bqueryd_tpu_torch.utils import devicehealth

    controller, workers, threads, expected, shards, url = _port_replicas(
        tmp_path)
    try:
        rpc = port_rpc.RPC(coordination_url=url, timeout=30, retries=1,
                           loglevel=QUIET)
        victim = workers[0]
        port_chaos.arm({"seed": 2, "faults": [{
            "site": "worker.execute", "action": "wedge",
            "match": {"verb": "groupby", "worker": victim.worker_id},
            "times": 1,
        }]})
        # the first query lands on the victim (the other holder is busy)
        other = workers[1].worker_id
        controller.worker_map[other]["busy"] = True
        result = {}
        asker = threading.Thread(target=lambda: result.setdefault(
            "got", rpc.groupby(shards, ["g"], [["v", "sum", "s"]], [])))
        asker.start()
        wait_until(lambda: victim._chaos_wedged, desc="the wedge latched")
        controller.worker_map[other]["busy"] = False
        asker.join(timeout=30)
        _order, cols = result["got"]
        assert dict(zip(cols["g"].tolist(), cols["s"].tolist())) == expected
        assert controller.counters["transient_faults"] == 1
        assert devicehealth.health_snapshot()["wedged"] == 0
        assert victim.prepare_wrm()["backend_wedged"] is True
        assert workers[1].prepare_wrm()["backend_wedged"] is False
        wait_until(lambda: rpc.health()["workers"].get(
            victim.worker_id, {}).get("status") == "wedged",
            desc="rpc.health() lists the victim as wedged")
        health = rpc.health()
        assert health["routing_enabled"] is True
        assert health["workers"][other]["status"] == "ok"
        assert any(e["kind"] == "worker_wedged"
                   and e["worker"] == victim.worker_id
                   for e in controller.flight.events())
        port_chaos.disarm()
        answered = victim.groupby_seconds.count
        avoided = controller.counters["health_avoided_dispatches"]
        for _ in range(3):
            _order, cols = rpc.groupby(shards, ["g"], [["v", "sum", "s"]],
                                       [])
            assert dict(zip(cols["g"].tolist(),
                            cols["s"].tolist())) == expected
        assert victim.groupby_seconds.count == answered
        assert controller.counters["health_avoided_dispatches"] >= avoided + 1
        bundle = rpc.debug_bundle()
        section = bundle["controller"]
        assert section["health"][victim.worker_id]["status"] == "wedged"
        assert section["chaos"]["armed"] is False
        assert section["chaos"]["site_stats"] == {"worker.execute": 1}
        info = rpc.info()
        assert info["worker_out_messages"] == {"None": 0}
        assert info["workers"][victim.worker_id]["backend_wedged"] is True
        metrics = rpc.metrics()
        assert "bqueryd_tpu_workers_degraded 1" in metrics
        assert "bqueryd_tpu_fault_injected_total 1" in metrics
    finally:
        port_chaos.disarm()
        ref._stop([controller] + workers, threads)


def test_wrm_carries_health_signals(tmp_path):
    worker = CPUWorkerNode(coordination_url=_store_url(),
                           data_dir=str(tmp_path), loglevel=QUIET)
    try:
        wrm = worker.prepare_wrm()
        assert wrm["work_errors"] == 0
        assert "bqueryd_tpu_worker_groupby_seconds" in wrm["metrics"]
        worker.work_errors.inc()
        worker.groupby_seconds.observe(0.01)
        wrm = worker.prepare_wrm()
        assert wrm["work_errors"] == 1
        (entry,) = wrm["metrics"]["bqueryd_tpu_worker_groupby_seconds"]
        assert sum(entry["counts"]) == 1
        assert worker._rss_bytes() > 0
    finally:
        worker.socket.close()


def test_rss_reads_proc_statm_without_psutil(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_psutil(name, *args, **kwargs):
        if name == "psutil":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_psutil)
    rss = port_worker.WorkerBase._rss_bytes()
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    assert abs(rss - pages * os.sysconf("SC_PAGE_SIZE")) < 64 << 20


def test_watchdog_sheds_the_executor_working_set(tmp_path, monkeypatch):
    worker = CPUWorkerNode(coordination_url=_store_url(),
                           data_dir=str(tmp_path), loglevel=QUIET,
                           restart_check=True, memory_limit_mb=100)
    try:
        cleared = []
        monkeypatch.setattr(worker.executor, "clear_caches",
                            lambda: cleared.append("executor"))
        readings = iter([200e6, 50e6])
        monkeypatch.setattr(worker, "_rss_bytes", lambda: next(readings))
        worker.running = True
        worker._check_mem()
        assert cleared == ["executor"] and worker.running is True
        monkeypatch.setattr(worker, "_rss_bytes", lambda: 50e6)
        worker._check_mem()  # under the limit: nothing shed
        assert cleared == ["executor"]
        worker.restart_check = False
        monkeypatch.setattr(worker, "_rss_bytes", lambda: 500e6)
        worker._check_mem()  # the watchdog is off
        assert worker.running is True
    finally:
        worker.socket.close()


# -- pinned messages: worker_id and the affinity queues ----------------------

def _bare(store, controller_cls):
    node = controller_cls(coordination_url=store, loglevel=QUIET,
                          runfile_dir="/nonexistent")
    node.worker_map["w1"] = {"worker_id": "w1", "workertype": "calc",
                             "busy": True, "node": "n", "data_dir": "/d"}
    node.files_map["t.bcolzs"] = {"w1"}
    return node


def test_append_and_rollup_messages_are_pinned_like_the_reference():
    from bqueryd_tpu.controller import ControllerNode as JaxController
    from bqueryd_tpu.messages import RPCMessage as JaxRPCMessage

    frame = {"g": np.arange(4, dtype=np.int64)}
    pinned = {}
    for label, cls, msg_cls in (
            ("jax", JaxController, JaxRPCMessage),
            ("port", port_controller.ControllerNode,
             port_messages.RPCMessage)):
        node = _bare(f"mem://torch-pinned-{label}-{os.urandom(4).hex()}",
                     cls)
        try:
            req = msg_cls({"payload": "append", "token": "ab" * 8})
            req.set_args_kwargs(["t.bcolzs", frame], {})
            node.rpc_append(req)
            (append,) = node.worker_out_messages["w1"]
            entry = types.SimpleNamespace(
                key="k", filenames=["t.bcolzs"],
                spec={"args": [["g"], [["v", "sum", "vs"]], []],
                      "dag_wire": None})
            node._dispatch_rollup_build(entry)
            _, build = node.worker_out_messages["w1"]
            pinned[label] = (append, build)
        finally:
            node.socket.close()
    for (jax_msg, port_msg) in zip(pinned["jax"], pinned["port"]):
        assert port_msg["worker_id"] == "w1" == jax_msg["worker_id"]
        assert "target" not in port_msg
        assert set(port_msg) == set(jax_msg)


def test_pinned_message_waits_for_its_worker_and_fails_with_it():
    node = _bare(_store_url(), port_controller.ControllerNode)
    sent = []
    node.socket.send_multipart = sent.append
    try:
        req = port_messages.RPCMessage({"payload": "append",
                                        "token": "cd" * 8})
        req.set_args_kwargs(["t.bcolzs", {"g": np.arange(3)}], {})
        node.rpc_append(req)
        node.dispatch_pending()  # w1 is busy
        assert sent == [] and len(node.worker_out_messages["w1"]) == 1
        node.worker_map["w1"]["busy"] = False
        node.dispatch_pending()
        assert len(sent) == 1 and not node.worker_out_messages.get("w1")
        (entry,) = node.inflight.values()
        assert entry["msg"]["worker_id"] == "w1"
        replies = []
        node.reply_rpc_message = lambda tok, msg: replies.append(msg)
        # a dispatch timeout on a pinned append fails its fan-out, never
        # re-queues it to another worker
        node._requeue(entry, reason="dispatch timeout")
        assert not any(node.worker_out_messages.values())
        (reply,) = replies
        assert "dispatch timeout" in reply["payload"]
        node.maybe_hedge()  # a pinned message is never hedged
        assert node.counters["hedged_dispatches"] == 0
    finally:
        node.socket.close()


def test_affinity_queue_and_backoff_do_not_block_the_queue():
    """A message inside its failover backoff is skipped without blocking
    the queue behind it, and a groupby's affinity kwarg picks its queue
    and its shared-dispatch identity."""
    node = _bare(_store_url(), port_controller.ControllerNode)
    sent = []
    node.socket.send_multipart = sent.append
    node.worker_map["w1"]["busy"] = False
    try:
        msgs = []
        for token in ("a1", "a2"):
            req = port_messages.RPCMessage({"payload": "groupby",
                                            "token": token * 8})
            req.set_args_kwargs([["t.bcolzs"], ["g"], [["v", "sum", "v"]],
                                 [["v", ">", len(msgs)]]],
                                {"affinity": "pool-a"})
            node.rpc_groupby(req)
            msgs.append(req)
        queue = node.worker_out_messages["pool-a"]
        assert len(queue) == 2 and not node.worker_out_messages[None]
        assert all(m["affinity"] == "pool-a" for m in queue)
        queue[0]["_not_before"] = time.time() + 60
        node.dispatch_pending()
        # the second went out; the first waits out its backoff
        assert len(sent) == 1
        assert [m["token"] for m in node.worker_out_messages["pool-a"]] == [
            queue[0]["token"]]
    finally:
        node.socket.close()


def test_abort_of_one_subscriber_keeps_a_shared_retry():
    """A shared unit re-queued for failover keeps its subscribers: one
    query's abort detaches only that query, and the retry stands for the
    other; with no subscriber left the retry is dropped."""
    node = _bare(_store_url(), port_controller.ControllerNode)
    node.reply_rpc_raw = lambda *a: None
    try:
        msg = port_messages.CalcMessage({
            "payload": "groupby", "token": "t1", "parent_token": "p1",
            "filename": "t.bcolzs",
        })
        for parent in ("p1", "p2"):
            node.rpc_segments[parent] = {
                "client_token": "00", "filenames": ["t.bcolzs"],
                "results": {}, "timings": {}, "strategies": {},
                "effective": {}, "merge": {}, "admission_ticket": None}
        node._register_work(msg, ["p1", "p2"])
        node._requeue({"msg": msg, "worker": "w1", "retries": 0},
                      reason="worker w1 lost")
        assert node.worker_out_messages[None] == [msg]
        assert msg["_excluded_workers"] == ["w1"]
        node.abort_parent("p1", "client went away", reply=False)
        assert node.worker_out_messages[None] == [msg]
        assert node._work_subscribers["t1"] == ["p2"]
        assert "t1" in node._requeued_tokens
        node.abort_parent("p2", "client went away", reply=False)
        assert node.worker_out_messages[None] == []
        assert "t1" not in node._work_subscribers
        assert "t1" not in node._requeued_tokens
    finally:
        node.socket.close()

"""The port's worker and controller loops on the trace: the loops' wall
split into parts, the ``worker_receive`` span and the bytes each transfer
span moved; everything under the ``BQUERYD_TPU_METRICS`` kill switch.  A port cluster of threads on the
CPU, over tests/test_obs.py's data."""

import contextlib
import logging
import os
import threading
import time

import pytest

import test_obs as ref_obs
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import obs as port_obs
from bqueryd_tpu_torch.utils import tracing as port_tracing
from tests.conftest import wait_until
from tests.torch_fixtures import (  # noqa: F401
    disarmed_port_chaos,
    fresh_port_calibration,
)

QUIET = logging.WARNING
SHARDS = [f"taxi-{i}.bcolzs" for i in range(ref_obs.NR_SHARDS)]
#: the executor path for every query, and no result cache to answer one
CLUSTER_ENV = {"BQUERYD_TPU_IP": "127.0.0.1",
               "BQUERYD_TPU_HOST_KERNEL_ROWS": "0",
               "BQUERYD_TPU_RESULT_CACHE_BYTES": "0",
               "BQUERYD_TPU_CALIB": "0"}


def _write_shards(root):
    df = ref_obs._taxi_df()
    for i, name in enumerate(SHARDS):
        jax_ctable.fromdataframe(df.iloc[i::ref_obs.NR_SHARDS],
                                 str(root / name))


@contextlib.contextmanager
def _cluster(root):
    """A port controller and a CPU worker as threads, each ``go`` bracketed
    by ``perf_counter`` marks (``walls[node]``, set once it returned), and
    a client."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    url = f"mem://looptrace-{os.urandom(4).hex()}"
    controller = ControllerNode(
        coordination_url=url, loglevel=QUIET, runfile_dir=str(root),
        heartbeat_interval=0.2, dead_worker_timeout=10.0)
    worker = WorkerNode(
        coordination_url=url, data_dir=str(root), loglevel=QUIET,
        heartbeat_interval=0.2, poll_timeout=0.1, device="cpu")
    walls = {}

    def run(node):
        t0 = time.perf_counter()
        node.go()
        walls[node] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(n,), daemon=True)
               for n in (controller, worker)]
    for t in threads:
        t.start()
    wait_until(lambda: controller.files_map.get(SHARDS[-1]),
               desc="worker registration")
    rpc = RPC(coordination_url=url, timeout=60, loglevel=QUIET)
    try:
        yield {"rpc": rpc, "controller": controller, "worker": worker,
               "walls": walls, "threads": threads}
    finally:
        rpc._close_socket()
        for n in (controller, worker):
            n.running = False
        for t in threads:
            t.join(timeout=10)


@pytest.fixture(scope="module")
def loop_cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("looptrace")
    _write_shards(root)
    with pytest.MonkeyPatch.context() as mp:
        for key, value in CLUSTER_ENV.items():
            mp.setenv(key, value)
        with _cluster(root) as cluster:
            yield cluster


def _query(rpc, threshold):
    """A filtered groupby over every shard: a new ``threshold`` misses the
    codes working set."""
    return rpc.groupby(SHARDS, ["payment_type"],
                       [["total_amount", "sum", "total_amount"]],
                       [["trip_distance", ">", threshold]])


def _timeline(cluster, threshold):
    """The query's timeline, read through a verb served after its
    accounting (the controller replies before it accounts)."""
    rpc = cluster["rpc"]
    _query(rpc, threshold)
    trace_id = rpc.last_trace_id
    rpc.ping()
    return rpc.trace(trace_id)


def _named(timeline, name):
    return [s for s in timeline["spans"] if s["name"] == name]


# -- the loops' parts --------------------------------------------------------------

def test_loop_parts_sum_to_the_loop_walls(tmp_path, monkeypatch):
    """Every second of each node's loop lands in exactly one part: the
    parts sum to the loop's wall within 2%, and each part the queries
    exercise is there."""
    from bqueryd_tpu_torch import controller as controller_mod
    from bqueryd_tpu_torch import worker as worker_mod

    _write_shards(tmp_path)
    for key, value in CLUSTER_ENV.items():
        monkeypatch.setenv(key, value)
    with _cluster(tmp_path) as cluster:
        deadline = time.perf_counter() + 1.5
        i = 0
        while time.perf_counter() < deadline:
            _query(cluster["rpc"], 0.01 * i)
            i += 1
        info = cluster["rpc"].info()
    walls = cluster["walls"]
    assert not any(t.is_alive() for t in cluster["threads"])
    worker, controller = cluster["worker"], cluster["controller"]
    for node, parts in ((worker, worker_mod.LOOP_PARTS),
                        (controller, controller_mod.LOOP_PARTS)):
        seconds = node.loop_clock.seconds()
        assert set(seconds) == set(parts)
        loop_wall = node.loop_clock.since - node.loop_clock.first
        assert sum(seconds.values()) == pytest.approx(loop_wall, rel=0.02)
        assert min(seconds.values()) >= 0.0
        # the loop inside its ``go``, which starts and stops threads and
        # sockets around it
        assert 0.5 * walls[node] < loop_wall <= walls[node]
    w = worker.loop_clock.seconds()
    assert w["work"] > 0 and w["wait"] > 0 and w["reply"] > 0
    c = controller.loop_clock.seconds()
    assert c["finalize"] > 0 and c["dispatch"] > 0 and c["receive"] > 0
    # on the nodes' registries and in rpc.info()
    assert set(info["counters"]["controller_loop_seconds"]) == set(
        controller_mod.LOOP_PARTS)
    text = worker.metrics.render()
    assert 'bqueryd_tpu_worker_loop_seconds_total{part="work"}' in text
    assert ('bqueryd_tpu_controller_loop_seconds_total{part="finalize"}'
            in controller.metrics.render())


def test_loop_clock_credits_each_part_it_leaves():
    registry = port_obs.MetricsRegistry()
    clock = port_obs.LoopClock(registry, "bqueryd_tpu_x_seconds_total",
                               "x", ("a", "b"))
    assert clock.enter("a") == (None, 0.0)   # the first entry only starts it
    time.sleep(0.01)
    left, first = clock.enter("b")
    assert left == "a" and first >= 0.01
    # a nested part and back: the outer part keeps what ran around it
    time.sleep(0.002)
    left, second = clock.enter("a")
    assert left == "b"
    assert clock.seconds() == pytest.approx({"a": first, "b": second})
    assert sum(clock.seconds().values()) == pytest.approx(
        clock.since - clock.first)
    # off (the kill switch): nothing is credited
    before = clock.seconds()
    time.sleep(0.005)
    assert clock.enter("b", on=False) == ("a", 0.0)
    assert clock.seconds() == before
    assert 'bqueryd_tpu_x_seconds_total{part="a"}' in registry.render()


def test_controller_finalize_off_the_loop_leaves_its_clock(loop_cluster,
                                                           monkeypatch):
    """Query accounting outside the controller's loop thread (a test's
    direct call) is not charged to the loop's parts."""
    controller = loop_cluster["controller"]
    clock = controller.loop_clock
    entries = []
    enter = clock.enter

    def spy(part, on=True):
        entries.append((threading.current_thread(), part))
        return enter(part, on)

    accounted = []
    monkeypatch.setattr(clock, "enter", spy)
    monkeypatch.setattr(controller, "_account_query",
                        lambda *a: accounted.append(a))
    controller._finalize_query_obs(None, {}, error=None)
    assert accounted == [(None, {}, None)]
    assert not [p for t, p in entries if t is threading.current_thread()]


# -- the worker's receipt on the query's timeline ------------------------------------

def test_worker_receive_rides_the_calc_reply(loop_cluster):
    timeline = _timeline(loop_cluster, 1.25)
    receive = _named(timeline, "worker_receive")
    calc = _named(timeline, "calc")
    assert len(receive) == len(calc) == 1
    span, root = receive[0], calc[0]
    assert span["tags"]["loop_wait_s"] >= 0.0
    # from the frames' receipt to the calc root, a sibling of the root
    assert span["start_ts"] <= root["start_ts"]
    assert span["start_ts"] + span["duration_s"] == pytest.approx(
        root["start_ts"], abs=2e-3)
    assert span["parent_span_id"] == root["parent_span_id"]
    record = loop_cluster["rpc"].autopsy(timeline["trace_id"])
    assert record["segments"]["worker_receive"] > 0.0
    assert record["tagged"]["worker_receive"]["loop_wait_s"] == (
        span["tags"]["loop_wait_s"])
    # the segment takes time from nothing the sweep covered before
    without = port_obs.slo.attribute(dict(timeline, spans=[
        s for s in timeline["spans"] if s["name"] != "worker_receive"]))
    assert record["coverage"] >= without["coverage"]


# -- bytes to and from the device ----------------------------------------------------

def test_transfer_spans_carry_the_bytes_they_moved(loop_cluster,
                                                   monkeypatch):
    from bqueryd_tpu_torch.parallel import executor as executor_mod

    worker = loop_cluster["worker"]
    handed = []
    upload = executor_mod._upload

    def spy(arr, device):
        handed.append(int(arr.nbytes))
        return upload(arr, device)

    monkeypatch.setattr(executor_mod, "_upload", spy)
    worker.clear_caches()
    h2d_before = worker.executor.h2d_bytes
    cold = _timeline(loop_cluster, 2.5)
    layout = _named(cold, "h2d_transfer")
    assert handed and sum(s["tags"]["bytes"] for s in layout) == sum(handed)
    # the mask's column uploads (trip_distance, float64) ride the filter
    masks = _named(cold, "filter")
    assert sum(s["tags"]["bytes"] for s in masks) == 8 * len(
        ref_obs._taxi_df())
    assert worker.executor.h2d_bytes - h2d_before == sum(handed) + sum(
        s["tags"]["bytes"] for s in masks)
    fetch = _named(cold, "d2h_fetch")
    assert fetch and all(s["tags"]["bytes"] > 0 for s in fetch)
    record = loop_cluster["rpc"].autopsy(cold["trace_id"])
    assert record["tagged"]["h2d_transfer"]["bytes"] == sum(handed)
    assert record["tagged"]["d2h_fetch"]["bytes"] == sum(
        s["tags"]["bytes"] for s in fetch)
    # the same query again: the working set holds every block
    handed.clear()
    warm = _timeline(loop_cluster, 2.5)
    assert not handed
    assert [s["tags"]["bytes"] for s in _named(warm, "h2d_transfer")] == [0] * len(
        _named(warm, "h2d_transfer"))
    text = worker.metrics.render()
    assert (f"bqueryd_tpu_h2d_bytes_total {worker.executor.h2d_bytes}"
            in text)
    assert (f"bqueryd_tpu_d2h_bytes_total {worker.executor.d2h_bytes}"
            in text)


def test_phase_timer_tags_filled_in_the_block_land_on_the_span():
    recorder = port_obs.SpanRecorder("t" * 32)
    timer = port_tracing.PhaseTimer(recorder=recorder)
    tags = {}
    with timer.phase("layout", tags):
        tags["bytes"] = 7
    with timer.phase("mask"):
        pass
    layout, mask = recorder.spans
    assert layout["tags"] == {"bytes": 7}
    assert "tags" not in mask


# -- the kill switch -------------------------------------------------------------------

def test_nothing_new_is_recorded_under_the_kill_switch(loop_cluster):
    rpc = loop_cluster["rpc"]
    worker, controller = loop_cluster["worker"], loop_cluster["controller"]
    port_obs.set_enabled(False)
    try:
        rpc.ping()
        before = (worker.loop_clock.seconds(),
                  controller.loop_clock.seconds(),
                  worker.executor.h2d_bytes, worker.executor.d2h_bytes)
        worker.clear_caches()
        _query(rpc, 5.0)
        rpc.ping()
        after = (worker.loop_clock.seconds(),
                 controller.loop_clock.seconds(),
                 worker.executor.h2d_bytes, worker.executor.d2h_bytes)
    finally:
        port_obs.set_enabled(True)
    assert after == before

"""The port's device-health latch (``bqueryd_tpu_torch.utils.devicehealth``)
through ``tests/test_devicehealth.py``'s cases, on the port's module and
nodes: probe seams simulate a wedge without real hangs, and a wedged port
engine, worker and cluster answer exactly from the host kernels.  One case
more: a ``device="cpu"`` worker never calls ``torch.cuda``."""

import logging
import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu_torch.utils import devicehealth
from tests.conftest import wait_until
from test_torch_cluster import loopback, running  # noqa: F401
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

QUIET = logging.WARNING


@pytest.fixture(autouse=True)
def _reset_latch():
    devicehealth.force_state(False)
    yield
    devicehealth.force_state(False)


def _write(df, root):
    from bqueryd_tpu_torch.storage.ctable import ctable

    ctable.fromdataframe(df, root)
    return ctable(root, mode="r")


def test_latch_flips_when_probe_overdue_and_recovers_without_release(
    monkeypatch,
):
    hang_forever = threading.Event()  # never set: a true wedge
    calls = {"n": 0}

    def probe():
        calls["n"] += 1
        if calls["n"] == 1:
            hang_forever.wait(5)  # parked (bounded for test hygiene)

    monkeypatch.setattr(devicehealth, "_probe_fn", probe)
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_PROBE_TIMEOUT_S", "0.05")
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_PROBE_INTERVAL_S", "0.05")
    devicehealth._last_probe_start = 0.0
    t0 = time.perf_counter()
    assert devicehealth.backend_wedged() is False  # probe just launched
    assert time.perf_counter() - t0 < 1.0, "must never block"
    time.sleep(0.1)
    assert devicehealth.backend_wedged() is True  # overdue -> latched
    deadline = time.time() + 5
    while devicehealth.backend_wedged() and time.time() < deadline:
        time.sleep(0.02)
    assert devicehealth.backend_wedged() is False
    assert calls["n"] >= 2, "a fresh probe must have been launched"
    hang_forever.set()
    # the released probe returns a success, which unlatches: let it land
    # here, not inside the next test's latch
    for t in threading.enumerate():
        if t.name == "bqueryd-device-probe":
            t.join(5)


def test_probe_error_latches_and_recovers(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_PROBE_INTERVAL_S", "0.05")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA error: device lost")

    monkeypatch.setattr(devicehealth, "_probe_fn", flaky)
    devicehealth._last_probe_start = 0.0
    devicehealth.backend_wedged()  # launches the erroring probe
    deadline = time.time() + 5
    while not devicehealth.backend_wedged() and time.time() < deadline:
        time.sleep(0.02)
    assert devicehealth.backend_wedged() is True
    deadline = time.time() + 5
    while devicehealth.backend_wedged() and time.time() < deadline:
        time.sleep(0.05)
    assert devicehealth.backend_wedged() is False


def test_default_probe_runs_on_the_watched_device(monkeypatch):
    """With no watched device the default probe never launches; with one,
    a probe is one op and a fetch on it."""
    monkeypatch.setattr(devicehealth, "_device", None)
    devicehealth._last_probe_start = 0.0
    devicehealth.backend_wedged()
    assert devicehealth._probe_started is None
    devicehealth.watch("cpu")
    devicehealth._last_probe_start = 0.0
    assert devicehealth.backend_wedged() is False
    wait_until(lambda: devicehealth._probe_started is None,
               desc="the probe's return")
    assert devicehealth.health_snapshot()["wedged"] == 0


def test_run_with_deadline_abandons_hung_fn():
    ev = threading.Event()
    t0 = time.perf_counter()
    done, result = devicehealth.run_with_deadline(ev.wait, 0.05)
    assert not done and result is None
    assert time.perf_counter() - t0 < 1.0
    ev.set()  # release the parked thread
    done, result = devicehealth.run_with_deadline(lambda: 41 + 1, 5)
    assert done and result == 42


def test_host_kernel_rows_wedged_overrides_env(monkeypatch):
    from bqueryd_tpu_torch.models import query as q

    monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "0")
    assert q.host_kernel_rows() == 0
    devicehealth.force_state(True)
    assert q.host_kernel_rows() == 1 << 62


def test_dispatch_floor_deadline_miss_latches(monkeypatch):
    from bqueryd_tpu_torch.models import query as q

    monkeypatch.setattr(q, "_measured_floor", None)
    monkeypatch.setattr(
        devicehealth, "run_with_deadline", lambda fn, t: (False, None)
    )
    floor = q.device_dispatch_floor(remeasure=True)
    assert floor == devicehealth.probe_timeout_s()
    assert devicehealth.backend_wedged() is True
    # the garbage floor is not cached: recovery remeasures
    assert q._measured_floor is None


def test_wedged_engine_serves_exact_results(monkeypatch, tmp_path):
    """With the latch set, a mergeable groupby (with and without a
    filter), the run counts, a count_distinct and a basket filter answer
    exactly from the host kernels, and nothing reaches the device ops."""
    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.ops import groupby as gb
    from bqueryd_tpu_torch.parallel import hostmerge

    monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "0")
    rng = np.random.default_rng(5)
    n = 30_000
    df = pd.DataFrame({
        "k": rng.integers(0, 9, n).astype(np.int64),
        "v": rng.integers(-(2**40), 2**40, n).astype(np.int64),
        "basket": rng.integers(0, 500, n).astype(np.int64),
    })
    tbl = _write(df, str(tmp_path / "w.bcolzs"))
    devicehealth.force_state(True)
    engine = QueryEngine(device="cpu")

    def no_device(*_a, **_k):
        raise AssertionError("a device op ran while wedged")

    for name in ("partial_tables", "groupby_sorted_count_distinct",
                 "groupby_count_distinct"):
        monkeypatch.setattr(ops, name, no_device)
        monkeypatch.setattr(gb, name, no_device)

    def run(query):
        payload = engine.execute_local(tbl, query)
        return hostmerge.payload_to_dataframe(
            hostmerge.merge_payloads([payload])
        ).sort_values(query.groupby_cols).reset_index(drop=True)

    got = run(GroupByQuery(["k"], [["v", "sum", "s"]], [], aggregate=True))
    assert engine.last_effective_strategy == "host"
    exp = df.groupby("k")["v"].sum()
    np.testing.assert_array_equal(got["s"].to_numpy(), exp.to_numpy())

    got = run(GroupByQuery(["k"], [["v", "sum", "s"]], [["v", ">", 0]],
                           aggregate=True))
    exp = df[df["v"] > 0].groupby("k")["v"].sum()
    np.testing.assert_array_equal(got["s"].to_numpy(), exp.to_numpy())

    got = run(GroupByQuery(["k"], [["basket", "sorted_count_distinct", "d"]],
                           [], aggregate=True))
    b, k = df["basket"].to_numpy(), df["k"].to_numpy()
    prev_same = np.concatenate(
        [[False], (b[1:] == b[:-1]) & (k[1:] == k[:-1])])
    exp = pd.DataFrame({"k": k, "new": ~prev_same}).groupby("k")["new"].sum()
    np.testing.assert_array_equal(got["d"].to_numpy(), exp.to_numpy())

    for sole in (False, True):
        got = run(GroupByQuery(["k"], [["basket", "count_distinct", "d"]],
                               [], aggregate=True, sole_payload=sole))
        exp = df.groupby("k")["basket"].nunique()
        np.testing.assert_array_equal(got["d"].to_numpy(), exp.to_numpy())

    codes = df["basket"].to_numpy()
    mask = df["v"].to_numpy() > 0
    got_mask = ops.expand_mask_by_group(codes, mask, n_groups=500)
    assert isinstance(got_mask, np.ndarray)
    np.testing.assert_array_equal(got_mask, np.isin(codes, codes[mask]))


def test_wedged_worker_routes_around_the_executor(monkeypatch, tmp_path):
    """``worker.execute`` must not touch the executor while latched."""
    from bqueryd_tpu_torch import worker
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.parallel import hostmerge

    monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "0")
    rng = np.random.default_rng(6)
    frames, tables = [], []
    for s in range(2):
        df = pd.DataFrame({
            "k": rng.integers(0, 9, 60_000).astype(np.int64),
            "v": rng.integers(-100, 100, 60_000).astype(np.int64),
        })
        frames.append(df)
        tables.append(_write(df, str(tmp_path / f"wm{s}.bcolzs")))

    class MustNotRun:
        @staticmethod
        def supports(query):
            return True

        def execute(self, tables, query, strategy=None):
            raise AssertionError("executor touched while wedged")

    devicehealth.force_state(True)
    q = GroupByQuery(["k"], [["v", "sum", "s"]], [], aggregate=True)
    report = {}
    payload = worker.execute(tables, q, QueryEngine(device="cpu"),
                             executor=MustNotRun(), report=report)
    got = hostmerge.payload_to_dataframe(
        hostmerge.merge_payloads([payload])).sort_values("k")
    exp = pd.concat(frames).groupby("k")["v"].sum()
    np.testing.assert_array_equal(got["s"].to_numpy(), exp.to_numpy())
    assert report == {"effective_strategy": "host", "merge_mode": "host"}


def _bare_worker():
    from bqueryd_tpu_torch.worker import WorkerNode

    w = WorkerNode.__new__(WorkerNode)
    w.worker_id, w.node_name = "w1", "n1"
    w.data_dir, w.data_files = "/nonexistent", []
    w.start_time = w._loop_started = time.time()
    w.msg_count = 0
    return w


def test_prepare_wrm_carries_backend_wedged(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_SHARD_STATS", "0")
    worker = _bare_worker()
    devicehealth.force_state(False)
    assert worker.prepare_wrm()["backend_wedged"] is False
    devicehealth.force_state(True)
    assert worker.prepare_wrm()["backend_wedged"] is True


def test_wedged_cluster_serves_via_rpc(loopback, tmp_path):  # noqa: F811
    """A port cluster with the latch set answers an RPC groupby exactly,
    and rpc.info() shows the worker advertising backend_wedged."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.storage.ctable import ctable
    from bqueryd_tpu_torch.worker import WorkerNode

    rng = np.random.default_rng(9)
    n = 40_000
    df = pd.DataFrame({
        "k": rng.integers(0, 9, n).astype(np.int64),
        "v": rng.integers(-(2**40), 2**40, n).astype(np.int64),
    })
    ctable.fromdataframe(df, str(tmp_path / "t.bcolzs"))
    url = f"mem://torch-wedge-{os.urandom(4).hex()}"
    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=str(tmp_path),
                                heartbeat_interval=0.2)
    worker = WorkerNode(coordination_url=url, data_dir=str(tmp_path),
                        loglevel=QUIET, heartbeat_interval=0.2,
                        poll_timeout=0.05, device="cpu")
    with running([controller, worker]):
        devicehealth.force_state(True)
        wait_until(lambda: "t.bcolzs" in controller.files_map,
                   desc="worker registration")
        rpc = RPC(coordination_url=url, timeout=30, loglevel=QUIET)
        try:
            order, cols = rpc.groupby(["t.bcolzs"], ["k"],
                                      [["v", "sum", "s"]], [])
            exp = df.groupby("k")["v"].sum()
            at = np.argsort(cols["k"])
            np.testing.assert_array_equal(cols["k"][at], exp.index)
            np.testing.assert_array_equal(cols["s"][at], exp.to_numpy())
            assert list(rpc.last_call_strategies["effective"].values()) == [
                "host"]
            wait_until(lambda: any(
                w.get("backend_wedged")
                for w in rpc.info()["workers"].values()),
                desc="wedged flag visible in info()")
        finally:
            rpc._close_socket()
            devicehealth.force_state(False)


def test_wedge_marker_catches_transient_wedge():
    clean_start = devicehealth.wedge_marker()
    assert not devicehealth.window_dirty(clean_start)
    devicehealth.latch_wedged()
    devicehealth.force_state(False)  # recovered before the end read
    assert devicehealth.backend_wedged(launch=False) is False
    assert devicehealth.window_dirty(clean_start)


def test_forced_flips_count_as_wedge_generations():
    start = devicehealth.health_snapshot()["wedge_generation"]
    devicehealth.force_state(True)
    devicehealth.force_state(True)  # already latched: no new flip
    devicehealth.force_state(False)
    devicehealth.force_state(True)
    snap = devicehealth.health_snapshot()
    assert snap["wedge_generation"] == start + 2
    assert snap["wedged"] == 1 and snap["abandoned_probes"] == 0


def test_detection_disabled_by_zero_timeout(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_PROBE_TIMEOUT_S", "0")
    devicehealth.force_state(True)
    assert devicehealth.backend_wedged() is False


def test_cpu_worker_never_calls_torch_cuda(monkeypatch, loopback,  # noqa: F811
                                           tmp_path):
    """A ``device="cpu"`` worker's probes, floor, routing and queries run
    without one ``torch.cuda`` call: on a CPU-only torch any such call
    would raise inside the probe and latch the device as wedged."""
    import torch

    from bqueryd_tpu_torch.models import query as q
    from bqueryd_tpu_torch.storage.ctable import ctable
    from bqueryd_tpu_torch.worker import WorkerNode

    calls = []
    for name in ("is_available", "current_device", "synchronize",
                 "device_count", "get_device_name", "empty_cache",
                 "memory_allocated", "init"):
        if hasattr(torch.cuda, name):
            monkeypatch.setattr(
                torch.cuda, name,
                lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.delenv("BQUERYD_TPU_HOST_KERNEL_ROWS", raising=False)
    monkeypatch.setenv("BQUERYD_TPU_DEVICE_PROBE_INTERVAL_S", "0")
    monkeypatch.setattr(q, "_measured_floor", None)
    df = pd.DataFrame({"k": np.arange(2_000) % 7,
                       "v": np.arange(2_000, dtype=np.int64)})
    ctable.fromdataframe(df, str(tmp_path / "c.bcolzs"))
    worker = WorkerNode(coordination_url=f"mem://cpu-{os.urandom(4).hex()}",
                        data_dir=str(tmp_path), loglevel=QUIET,
                        device="cpu")
    try:
        devicehealth._last_probe_start = 0.0
        assert worker.prepare_wrm()["backend_wedged"] is False
        wait_until(lambda: devicehealth._probe_started is None,
                   desc="the probe's return")
        assert q.device_dispatch_floor(remeasure=True) > 0
        assert q.host_kernel_rows() > 0
        from bqueryd_tpu_torch.messages import CalcMessage

        msg = CalcMessage({"payload": "groupby", "token": "t"})
        msg.set_args_kwargs(["c.bcolzs", ["k"], [["v", "sum", "s"]], []], {})
        reply = worker.handle_work(msg)
        want = "host" if 2_000 <= q.host_kernel_rows() else "matmul"
        assert reply["effective_strategy"] == want
        worker.clear_caches()
        monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "1000000")
        assert worker.handle_work(msg)["effective_strategy"] == "host"
        assert devicehealth.backend_wedged(launch=False) is False
    finally:
        worker.socket.close()
    assert calls == []

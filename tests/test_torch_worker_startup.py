"""The port worker's startup and telemetry, on the CPU beside the JAX
worker: the background kernel warmup (``BQUERYD_TPU_WARMUP``), SIGUSR1
debug dumps from the worker and the controller, the worker's ingest,
chunk-pruning, pipeline, working-set and result-cache metric series, and
the small gaps closed with them (``ops.groupby_aggregate``,
``BQUERYD_TPU_ALIGN_THREADS``, ``BQUERYD_TPU_NATIVE_LIB``).

Values compare exactly (ints and counters) or within the reference's
float tolerance (``rtol=2e-5``, ``tests/test_differential_fuzz.py``)."""

import glob
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu_torch import ops as port_ops
from bqueryd_tpu_torch.messages import CalcMessage
from bqueryd_tpu_torch.storage.ctable import ctable
from tests.conftest import wait_until
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401
from test_ingest import _frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = logging.WARNING
CPU = "cpu"
RTOL = 2e-5
AGGS = [["v", "sum", "vs"], ["f", "mean", "fm"]]

#: the series the worker gained, with the reference's names
NEW_SERIES = (
    "bqueryd_tpu_worker_appends_total",
    "bqueryd_tpu_worker_append_rows_total",
    "bqueryd_tpu_chunks_decoded_total",
    "bqueryd_tpu_chunks_skipped_total",
    "bqueryd_tpu_delta_refreshes_total",
    "bqueryd_tpu_delta_cache_bytes",
    "bqueryd_tpu_pipeline_threads",
    "bqueryd_tpu_pipeline_busy_seconds",
    "bqueryd_tpu_workingset_bytes",
    "bqueryd_tpu_workingset_hits",
    "bqueryd_tpu_workingset_misses",
    "bqueryd_tpu_workingset_evictions",
    "bqueryd_tpu_workingset_pressure_evictions",
    "bqueryd_tpu_result_cache_hits",
    "bqueryd_tpu_result_cache_misses",
    "bqueryd_tpu_result_cache_evictions",
)


def _store():
    return f"mem://torch-startup-{os.urandom(4).hex()}"


def _port_worker(data_dir, **kw):
    from bqueryd_tpu_torch.worker import WorkerNode

    return WorkerNode(coordination_url=_store(), data_dir=str(data_dir),
                      loglevel=QUIET, device=CPU, **kw)


def _jax_worker(data_dir):
    from bqueryd_tpu.worker import WorkerNode

    return WorkerNode(coordination_url=f"mem://jax-startup-"
                      f"{os.urandom(4).hex()}", data_dir=str(data_dir),
                      loglevel=QUIET, restart_check=False)


def _msg(module, filenames, where=None):
    msg = module.CalcMessage({"payload": "groupby", "token": "00"})
    msg.set_args_kwargs([filenames, ["g"], AGGS, where or []], {})
    return msg


def _append_msg(module, filename, frame):
    msg = module.CalcMessage({"payload": "append", "token": "append_00"})
    msg.set_args_kwargs([filename, frame], {})
    return msg


def _families(registry):
    """``{name: [help, [label strings]]}`` parsed from a registry's
    Prometheus text."""
    out = {}
    for line in registry.render().splitlines():
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            out.setdefault(name, [help_text, []])[0] = help_text
        elif line and not line.startswith("#"):
            head = line.rsplit(" ", 1)[0]
            name, _, labels = head.partition("{")
            out.setdefault(name, [None, []])[1].append(labels.rstrip("}"))
    return out


def _values(registry, names):
    """``{'name{labels}': value}`` of the named series."""
    out = {}
    for line in registry.render().splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name = head.partition("{")[0]
        if name in names:
            out[head] = float(value)
    return out


# -- the warmup ----------------------------------------------------------------

@pytest.fixture
def shard_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    data = tmp_path / "data"
    data.mkdir()
    ctable.fromdataframe(_frame(1200, seed=21), str(data / "t.bcolzs"),
                         chunklen=100)
    return data


def _run(nodes):
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    return threads


def _stop(nodes, threads):
    for n in nodes:
        n.running = False
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "a node did not stop"


def test_warmup_does_not_gate_registration(shard_dir, tmp_path,
                                           monkeypatch):
    """With the warmup held, the worker still registers its shards with
    the controller and answers a query; the warmup then ends and sets
    ``warmup_done``."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    monkeypatch.setenv("BQUERYD_TPU_WARMUP", "1")
    release = threading.Event()
    started = threading.Event()
    real_warmup = WorkerNode.warmup

    def slowed(self):
        started.set()
        release.wait(30)
        real_warmup(self)

    monkeypatch.setattr(WorkerNode, "warmup", slowed)
    url = _store()
    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=str(tmp_path),
                                heartbeat_interval=0.1)
    worker = WorkerNode(coordination_url=url, data_dir=str(shard_dir),
                        loglevel=QUIET, device=CPU,
                        heartbeat_interval=0.1, poll_timeout=0.05)
    threads = _run([controller, worker])
    try:
        assert started.wait(10)
        wait_until(lambda: "t.bcolzs" in controller.files_map,
                   desc="registration during the warmup")
        assert not worker.warmup_done.is_set()
        assert worker._warmup_thread.is_alive()
        assert worker._warmup_thread.daemon
        rpc = RPC(coordination_url=url, timeout=30, retries=1,
                  loglevel=QUIET)
        try:
            order, cols = rpc.groupby(["t.bcolzs"], ["g"], AGGS, [])
        finally:
            rpc._close_socket()
        df = _frame(1200, seed=21)
        want = df.groupby("g")["v"].sum()
        np.testing.assert_array_equal(
            np.asarray(cols["vs"])[np.argsort(cols["g"])],
            want.sort_index().to_numpy())
        assert not worker.warmup_done.is_set()
        release.set()
        assert worker.warmup_done.wait(30)
    finally:
        release.set()
        _stop([controller, worker], threads)


def test_warmup_off_starts_no_thread(shard_dir, monkeypatch):
    from bqueryd_tpu_torch.worker import WorkerNode

    monkeypatch.setenv("BQUERYD_TPU_WARMUP", "0")
    calls = []
    monkeypatch.setattr(WorkerNode, "warmup",
                        lambda self: calls.append(self))
    worker = _port_worker(shard_dir, heartbeat_interval=0.1,
                          poll_timeout=0.05)
    before = {t.name for t in threading.enumerate()}
    threads = _run([worker])
    try:
        assert worker.warmup_done.wait(10)
        time.sleep(0.2)
        assert worker._warmup_thread is None
        assert calls == []
        assert not any(t.name.startswith("warmup-")
                       for t in threading.enumerate()
                       if t.name not in before)
    finally:
        _stop([worker], threads)


def test_warmup_result_equals_the_jax_warmup():
    """The warmup's tiny ``partial_tables`` + ``finalize`` on the port
    equals the JAX package's on the same inputs (int sum: exact)."""
    from bqueryd_tpu import ops as jax_ops

    codes = np.zeros(8, dtype=np.int32)
    vals = np.ones(8, dtype=np.int64)
    port = port_ops.partial_tables(codes, (vals,), ("sum",), 4, None,
                                   device=CPU)
    jax = jax_ops.partial_tables(codes, (vals,), ("sum",), 4, None)
    port_final = port_ops.finalize(port, ("sum",))
    jax_final = jax_ops.finalize(jax, ("sum",))
    np.testing.assert_array_equal(np.asarray(port["rows"]),
                                  np.asarray(jax["rows"]))
    np.testing.assert_array_equal(port_final[0].numpy(),
                                  np.asarray(jax_final[0]))
    assert port_final[0].tolist() == [8, 0, 0, 0]


def test_warmup_runs_the_kernel_path_and_remeasures_the_floor(
        shard_dir, monkeypatch):
    """``warmup()`` calls the instrumented contraction once at its tiny
    shape (no launch on the CPU: the plain version) and remeasures the
    dispatch floor on the worker's device; it sets ``warmup_done``."""
    from bqueryd_tpu_torch.models import query as q
    from bqueryd_tpu_torch.obs import profile
    from bqueryd_tpu_torch.ops import onehot

    profile._reset_for_tests()
    floors = []
    monkeypatch.setattr(q, "device_dispatch_floor",
                        lambda remeasure=False, device=None:
                        floors.append((remeasure, device)) or 1e-5)
    worker = _port_worker(shard_dir)
    try:
        launches = sum(onehot.LAUNCHES.values())
        worker.warmup()
        assert worker.warmup_done.is_set()
        assert floors == [(True, worker.device)]
        programs = profile.profiler().snapshot()["programs"]
        assert {p["name"] for p in programs} >= {"ops.partial_tables",
                                                 "ops.onehot_rows_dot"}
        assert sum(onehot.LAUNCHES.values()) == launches
    finally:
        worker.socket.close()
        profile._reset_for_tests()


def test_warmup_failure_is_logged_and_carries_on(shard_dir, monkeypatch,
                                                 caplog):
    """A failing warmup logs and sets ``warmup_done``; nothing is retried
    on another device."""
    def boom(*args, **kwargs):
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(port_ops, "partial_tables", boom)
    worker = _port_worker(shard_dir)
    try:
        with caplog.at_level(logging.ERROR, logger="bqueryd_tpu_torch"):
            worker.warmup()
        assert worker.warmup_done.is_set()
        assert "kernel warmup failed" in caplog.text
    finally:
        worker.socket.close()


# -- SIGUSR1 -------------------------------------------------------------------

def _bundle_files(directory, role):
    return sorted(glob.glob(os.path.join(
        directory, f"bqueryd_tpu_debug_{role}_*.json")))


def test_sigusr1_dumps_from_cli_nodes(shard_dir, tmp_path):
    """A port controller and worker as processes each write a JSON bundle
    with the reference's sections on SIGUSR1, then answer a further query;
    SIGTERM still stops both with exit 0."""
    from bqueryd_tpu.worker import WorkerNode as JaxWorkerNode
    from bqueryd_tpu_torch.rpc import RPC

    debug = tmp_path / "debug"
    url = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=REPO,
               BQUERYD_TPU_RUNFILE_DIR=str(tmp_path),
               BQUERYD_TPU_DEBUG_DIR=str(debug), BQUERYD_TPU_IP="127.0.0.1")
    node = [sys.executable, "-m", "bqueryd_tpu_torch.node"]
    procs = {
        "controller": subprocess.Popen(
            node + ["controller", f"--coordination={url}"],
            cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE),
        "calc": subprocess.Popen(
            node + ["worker", f"--coordination={url}",
                    f"--data_dir={shard_dir}", "--device=cpu"],
            cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE),
    }
    rpc = None
    try:
        import bqueryd_tpu_torch
        from bqueryd_tpu_torch.coordination import coordination_store

        wait_until(lambda: all(p.poll() is None for p in procs.values())
                   and coordination_store(url).smembers(
                       bqueryd_tpu_torch.REDIS_SET_KEY),
                   timeout=60, desc="CLI controller registered")
        rpc = RPC(coordination_url=url, timeout=30, retries=1,
                  loglevel=QUIET)
        wait_until(lambda: "t.bcolzs" in {
            f for w in rpc.info()["workers"].values()
            for f in w.get("data_files") or []}, timeout=60,
            desc="CLI worker serving")
        for role, proc in procs.items():
            proc.send_signal(signal.SIGUSR1)
            wait_until(lambda role=role: _bundle_files(str(debug), role),
                       timeout=30, desc=f"{role} bundle")
        worker_bundle = json.load(open(_bundle_files(str(debug), "calc")[0]))
        ctrl_bundle = json.load(open(
            _bundle_files(str(debug), "controller")[0]))
        # the reference's sections: the JAX worker's own dump
        jax_dir = tmp_path / "jax_debug"
        os.environ["BQUERYD_TPU_DEBUG_DIR"] = str(jax_dir)
        try:
            jax_worker = JaxWorkerNode(
                coordination_url=f"mem://jax-usr1-{os.urandom(4).hex()}",
                data_dir=str(shard_dir), loglevel=QUIET,
                restart_check=False)
            jax_worker._dump_debug_signal()
            jax_worker.socket.close()
        finally:
            del os.environ["BQUERYD_TPU_DEBUG_DIR"]
        jax_bundle = json.load(open(_bundle_files(str(jax_dir), "calc")[0]))
        assert set(worker_bundle) == set(jax_bundle)
        assert set(ctrl_bundle) == set(jax_bundle)
        (slice_,) = worker_bundle["workers"].values()
        (jax_slice,) = jax_bundle["workers"].values()
        assert set(slice_) == set(jax_slice)
        assert set(jax_slice["snapshot"]) <= set(slice_["snapshot"])
        assert slice_["snapshot"]["pid"] == procs["calc"].pid
        assert ctrl_bundle["controller"]["address"]
        # the nodes keep serving
        order, cols = rpc.groupby(["t.bcolzs"], ["g"], AGGS, [])
        want = _frame(1200, seed=21).groupby("g")["f"].mean()
        np.testing.assert_allclose(
            np.asarray(cols["fm"])[np.argsort(cols["g"])],
            want.sort_index().to_numpy(), rtol=RTOL)
    finally:
        if rpc is not None:
            rpc._close_socket()
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
    for proc in procs.values():
        assert proc.returncode == 0, proc.stderr.read().decode()[-2000:]


def test_sigusr1_worker_bundle_redacts_paths(shard_dir, tmp_path,
                                             monkeypatch):
    """The worker's dump keeps its data dir readable and redacts other
    absolute paths, as the controller's bundle does."""
    monkeypatch.setenv("BQUERYD_TPU_DEBUG_DIR", str(tmp_path / "dbg"))
    worker = _port_worker(shard_dir)
    try:
        worker.flight.record("note", path="/secret/elsewhere/file.bcolz",
                             ok=str(shard_dir / "t.bcolzs"))
        worker._dump_debug_signal()
    finally:
        worker.socket.close()
    (path,) = _bundle_files(str(tmp_path / "dbg"), "calc")
    text = open(path).read()
    assert "/secret/elsewhere" not in text
    assert str(shard_dir / "t.bcolzs") in text


# -- the metric series ---------------------------------------------------------

def test_new_series_names_labels_and_help_equal_a_jax_worker(shard_dir):
    port = _port_worker(shard_dir)
    jax = _jax_worker(shard_dir)
    try:
        port_fams = _families(port.metrics)
        jax_fams = _families(jax.metrics)
        for name in NEW_SERIES:
            assert name in port_fams, name
            assert port_fams[name][0] == jax_fams[name][0], name
            assert sorted(port_fams[name][1]) == sorted(
                jax_fams[name][1]), name
    finally:
        port.socket.close()
        jax.socket.close()


def test_counters_equal_a_jax_worker_after_the_same_sequence(tmp_path):
    """A query, an append, a pruned query and the delta refresh of the
    first query: the ingest, chunk and delta counters of a port worker and
    a JAX worker agree exactly, and so do their answers."""
    import bqueryd_tpu.messages as jax_messages
    import bqueryd_tpu_torch.messages as port_messages
    from bqueryd_tpu.models.query import ResultPayload as JaxPayload
    from bqueryd_tpu_torch.models.query import ResultPayload

    workers = {}
    for side in ("port", "jax"):
        data = tmp_path / side
        data.mkdir()
        ctable.fromdataframe(_frame(1200, seed=22), str(data / "t.bcolzs"),
                             chunklen=100)
        workers[side] = (_port_worker(data) if side == "port"
                         else _jax_worker(data))
    modules = {"port": port_messages, "jax": jax_messages}
    names = set(NEW_SERIES[:5])
    try:
        replies = {}
        for side, worker in workers.items():
            mod = modules[side]
            worker.handle_work(_msg(mod, ["t.bcolzs"]))
            worker.handle_work(_append_msg(
                mod, "t.bcolzs", _frame(120, seed=23, offset=1200)))
            worker.handle_work(_msg(mod, ["t.bcolzs"],
                                    where=[["seq", ">", 1150]]))
            replies[side] = worker.handle_work(_msg(mod, ["t.bcolzs"]))
            assert replies[side]["effective_strategy"] == "delta"
        port_values = _values(workers["port"].metrics, names)
        jax_values = _values(workers["jax"].metrics, names)
        assert port_values == jax_values
        assert port_values["bqueryd_tpu_worker_append_rows_total"] == 120
        assert port_values["bqueryd_tpu_chunks_skipped_total"] > 0
        assert workers["port"].delta_refreshes_total.value == 1
        assert workers["port"].appends_total.value == 1
        assert workers["port"].append_rows_total.value == 120
        from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
        from bqueryd_tpu_torch.parallel import hostmerge

        order, cols = hostmerge.finalize_table(hostmerge.merge_payloads(
            [ResultPayload.from_bytes(replies["port"]["data"])]))
        want = jax_hostmerge.payload_to_dataframe(
            jax_hostmerge.merge_payloads(
                [JaxPayload.from_bytes(replies["jax"]["data"])]),
        ).sort_values("g")
        at = np.argsort(cols["g"])
        np.testing.assert_array_equal(cols["g"][at], want["g"].to_numpy())
        np.testing.assert_array_equal(cols["vs"][at], want["vs"].to_numpy())
        np.testing.assert_allclose(cols["fm"][at], want["fm"].to_numpy(),
                                   rtol=RTOL)
    finally:
        for worker in workers.values():
            worker.socket.close()


def test_series_read_live_state(shard_dir, monkeypatch):
    """The result-cache, working-set and stage gauges read the live
    objects at each scrape: a repeat is a result-cache hit, and with the
    result cache off a warm query hits every working-set segment."""
    from bqueryd_tpu_torch.parallel import pipeline

    worker = _port_worker(shard_dir)
    try:
        msg = CalcMessage({"payload": "groupby", "token": "00"})
        msg.set_args_kwargs([["t.bcolzs"], ["g"], AGGS, []], {})
        for _ in range(2):
            worker.handle_work(msg)
        values = _values(worker.metrics, set(NEW_SERIES))
        assert values["bqueryd_tpu_result_cache_hits"] == 1
        assert values["bqueryd_tpu_result_cache_misses"] == 1
        assert values["bqueryd_tpu_pipeline_threads"] == (
            pipeline.pipeline_threads())
        worker._result_cache = False   # off from here
        for _ in range(2):
            worker.handle_work(msg)
        values = _values(worker.metrics, set(NEW_SERIES))
        for segment in ("align", "codes", "blocks"):
            label = f'{{segment="{segment}"}}'
            assert values["bqueryd_tpu_workingset_hits" + label] > 0
            assert values["bqueryd_tpu_workingset_bytes" + label] > 0
        busy = [values[f'bqueryd_tpu_pipeline_busy_seconds{{stage="{s}"}}']
                for s in pipeline.STAGES]
        assert all(b >= 0 for b in busy) and sum(busy) > 0
        assert values["bqueryd_tpu_result_cache_hits"] == 0
    finally:
        worker.socket.close()


# -- the small gaps ------------------------------------------------------------

def _taxi_like(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "payment_type": rng.integers(1, 5, n).astype(np.int64),
        "fare_amount": rng.random(n).astype(np.float64) * 50,
        "passenger_count": rng.integers(0, 7, n).astype(np.int64),
    })


@pytest.mark.parametrize("op", ["sum", "mean", "count", "min", "max"])
def test_groupby_aggregate_matches_the_reference(op):
    """``tests/test_ops.py``'s ``run_groupby`` cases through the port's
    ``ops.groupby_aggregate`` beside the JAX package's (floats within
    rtol 2e-5, ints and counts exact)."""
    from bqueryd_tpu import ops as jax_ops

    df = _taxi_like()
    codes, uniques = jax_ops.factorize(df["payment_type"].to_numpy())
    values = df["fare_amount"].to_numpy()
    got_tables, got_rows = port_ops.groupby_aggregate(
        codes, (values,), (op,), len(uniques), device=CPU)
    want_tables, want_rows = jax_ops.groupby_aggregate(
        codes, (values,), (op,), n_groups=len(uniques))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_allclose(got_tables[0].numpy(),
                               np.asarray(want_tables[0]), rtol=RTOL)


def test_groupby_aggregate_int64_sum_bit_exact_with_mask():
    rng = np.random.default_rng(11)
    n = 50_000
    keys = rng.integers(0, 50, n).astype(np.int64)
    values = rng.integers(-(2**40), 2**40, n).astype(np.int64)
    mask = rng.random(n) < 0.7
    codes, uniques = port_ops.factorize(keys)
    tables, rows = port_ops.groupby_aggregate(
        codes, (values,), ("sum",), len(uniques), mask=mask, device=CPU)
    expected = np.zeros(len(uniques), dtype=np.int64)
    np.add.at(expected, codes[mask], values[mask])
    assert tables[0].dtype.is_floating_point is False
    np.testing.assert_array_equal(tables[0].numpy(), expected)
    np.testing.assert_array_equal(
        rows.numpy(), np.bincount(codes[mask], minlength=len(uniques)))


@pytest.mark.parametrize("cap,expect", [(None, 8), ("1", 1), ("3", 3)])
def test_align_threads_caps_the_alignment_fan_out(monkeypatch, cap,
                                                  expect):
    """``BQUERYD_TPU_ALIGN_THREADS`` caps the executor's shard map (the
    pool itself keeps its width), as the reference's ``_map_shards``."""
    from bqueryd_tpu_torch.parallel import pipeline
    from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor

    monkeypatch.setenv("BQUERYD_TPU_PIPELINE_THREADS", "8")
    if cap is None:
        monkeypatch.delenv("BQUERYD_TPU_ALIGN_THREADS", raising=False)
    else:
        monkeypatch.setenv("BQUERYD_TPU_ALIGN_THREADS", cap)
    active = [0]
    peak = [0]
    lock = threading.Lock()
    gate = threading.Barrier(expect, timeout=5) if expect > 1 else None

    def work(i):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        if gate is not None and i < expect:
            gate.wait()
        time.sleep(0.01)
        with lock:
            active[0] -= 1
        return i * i

    out = MeshQueryExecutor._map_shards(work, range(16))
    assert out == [i * i for i in range(16)]
    assert peak[0] == expect
    assert pipeline.pipeline_threads() == 8


def test_align_threads_executor_answer_unchanged(tmp_path, monkeypatch):
    """A sequential alignment (``ALIGN_THREADS=1``) answers the same
    multi-shard query as the default fan-out."""
    from bqueryd_tpu_torch.rpc import LocalRPC

    frames = [_frame(800, seed=30 + i) for i in range(3)]
    names = []
    for i, df in enumerate(frames):
        name = f"s{i}.bcolzs"
        ctable.fromdataframe(df, str(tmp_path / name))
        names.append(name)
    answers = []
    for cap in ("1", "4"):
        monkeypatch.setenv("BQUERYD_TPU_ALIGN_THREADS", cap)
        rpc = LocalRPC(str(tmp_path), device=CPU)
        answers.append(rpc.groupby(names, ["g"], AGGS, []))
    (o1, c1), (o2, c2) = answers
    assert o1 == o2
    np.testing.assert_array_equal(c1["vs"], c2["vs"])
    np.testing.assert_allclose(c1["fm"], c2["fm"], rtol=RTOL)


def test_native_lib_env_is_the_first_candidate(monkeypatch, tmp_path):
    from bqueryd_tpu.storage import native as jax_native
    from bqueryd_tpu_torch.storage import native

    lib = str(tmp_path / "libcustom.so")
    monkeypatch.setenv("BQUERYD_TPU_NATIVE_LIB", lib)
    paths = list(native._candidate_paths())
    assert paths[0] == lib
    assert list(jax_native._candidate_paths())[0] == lib
    assert paths[1].endswith(os.path.join("native", "build",
                                          "libtpucolz.so"))
    monkeypatch.delenv("BQUERYD_TPU_NATIVE_LIB")
    assert list(native._candidate_paths())[0] == paths[1]


def test_native_lib_env_loads_the_named_library(monkeypatch, tmp_path):
    """A process whose ``BQUERYD_TPU_NATIVE_LIB`` names the built library
    loads that file (by its path) and decodes with it."""
    from bqueryd_tpu_torch.storage import native

    built = [p for p in native._candidate_paths() if os.path.exists(p)]
    if not built:
        native.get_lib()
        built = [p for p in native._candidate_paths() if os.path.exists(p)]
    assert built, "the native library did not build"
    copy = tmp_path / "libnamed.so"
    copy.write_bytes(open(built[0], "rb").read())
    code = (
        "import json\n"
        "from bqueryd_tpu_torch.storage import native\n"
        "lib = native.get_lib()\n"
        "print(json.dumps(lib._name if lib is not None else None))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO,
                 BQUERYD_TPU_NATIVE_LIB=str(copy)),
    ).stdout
    assert json.loads(out.strip().splitlines()[-1]) == str(copy)


def test_hicard_group_ceiling_reads_the_reference_name(monkeypatch):
    """``BQUERYD_TPU_PALLAS_HICARD_GROUPS`` bounds the hicard contraction
    route, as it bounds the reference's; past it the sort route runs."""
    import torch

    from bqueryd_tpu_torch.ops import groupby as port_gb

    measures = [torch.zeros(4, dtype=torch.int64)]
    n, groups = 1_000_000, 70_000
    monkeypatch.delenv("BQUERYD_TPU_PALLAS_HICARD_GROUPS", raising=False)
    assert port_gb.hicard_groups_limit() == 1 << 18
    assert port_gb.kernel_route(None, measures, ("sum",), n,
                                groups) == "matmul"
    monkeypatch.setenv("BQUERYD_TPU_PALLAS_HICARD_GROUPS", "65536")
    assert port_gb.hicard_groups_limit() == 65536
    assert port_gb.kernel_route(None, measures, ("sum",), n,
                                groups) != "matmul"
    monkeypatch.setenv("BQUERYD_TPU_PALLAS_HICARD_GROUPS", "junk")
    assert port_gb.hicard_groups_limit() == 1 << 18

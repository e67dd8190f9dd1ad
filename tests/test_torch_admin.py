"""The port's admin verbs, the rest of ``tests/test_rpc_cluster.py`` and the
CLI's download roles.

The reference's ``cluster`` (a controller, a calc worker, a dummy
downloader that stages an empty shard, a mover) is built of port nodes
(``on_port``) and the reference's cases run on it: ``info``'s shape,
``sleep``, ``readfile`` and its path-traversal guard, a download ticket's
registration and its release by the dummy downloader, and
``legacy_merge``'s sum of shard means.  Then the port's own contracts:
the verb set against the reference's, a scattered ``sleep``, a
fire-and-forget ``execute_code``, ``killworkers`` and ``killall`` ending
every loop, the replication view in ``info``, the metrics and the debug
bundle, and the CLI's ``downloader`` and ``movebcolz`` roles as processes
activating a zipped shard that the CLI worker answers.
"""

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

import test_rpc_cluster as ref
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import controller as port_controller
from bqueryd_tpu_torch import rpc as port_rpc
from bqueryd_tpu_torch import worker as port_worker
from bqueryd_tpu_torch.blob import LocalFSBackend
from bqueryd_tpu_torch.coordination import coordination_store
from bqueryd_tpu_torch.utils.net import zip_to_file
from tests.conftest import wait_until
from tests.torch_fixtures import (  # noqa: F401
    CPUWorkerNode,
    disarmed_port_chaos,
    fresh_port_calibration,
    on_port,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = logging.WARNING

CLUSTER_CASES = [
    "test_info_shape",
    "test_sleep_roundtrip",
    "test_readfile_returns_bytes",
    "test_readfile_rejects_path_traversal",
    "test_download_ticket_registration",
    "test_download_wait_released_by_dummy_downloader",
    "test_legacy_merge_sum_of_shard_means",
]


@pytest.fixture(scope="module")
def taxi_df():
    return ref.taxi_like_df()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory, taxi_df):
    return ref.data_dir.__wrapped__(tmp_path_factory, taxi_df)


@pytest.fixture
def port_cluster(on_port, data_dir):
    fixture = ref.cluster.__wrapped__(data_dir)
    cluster = next(fixture)
    try:
        yield cluster
    finally:
        next(fixture, None)


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_reference_cluster_case_on_port(case, port_cluster, taxi_df,
                                        data_dir):
    assert type(port_cluster["controller"]) is port_controller.ControllerNode
    assert type(port_cluster["worker"]) is CPUWorkerNode
    assert isinstance(port_cluster["downloader"], port_worker.DownloaderNode)
    fn = getattr(ref, case)
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    args = {"cluster": port_cluster, "taxi_df": taxi_df,
            "data_dir": data_dir}
    fn(*(args[p] for p in params))


def test_verbs_are_the_references_but_the_unported_subsystems():
    import bqueryd_tpu.controller as jax_controller

    unported = ("trace", "slow_queries", "autopsy", "timeline", "capacity")
    assert port_controller.CONTROLLER_VERBS == tuple(
        v for v in jax_controller.CONTROLLER_VERBS if v not in unported)
    for verb in port_controller.CONTROLLER_VERBS:
        assert callable(getattr(port_controller.ControllerNode,
                                f"rpc_{verb}"))


# -- a small port cluster of its own ------------------------------------------

def _start(*nodes):
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    return threads


@pytest.fixture
def small(tmp_path, monkeypatch):
    """A port controller, CPU calc worker, downloader and mover on a data
    dir of two shards, in one ``mem://`` store."""
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    monkeypatch.setenv("BQUERYD_TPU_REPLICA_FACTOR", "2")
    url = f"mem://torch-admin-{os.urandom(4).hex()}"
    rng = np.random.default_rng(8)
    for i in range(2):
        jax_ctable.fromdataframe(pd.DataFrame({
            "g": rng.integers(0, 5, 400).astype(np.int64),
            "v": rng.integers(0, 1000, 400).astype(np.int64),
        }), str(tmp_path / f"a{i}.bcolzs"))
    common = dict(coordination_url=url, data_dir=str(tmp_path),
                  loglevel=QUIET, heartbeat_interval=0.1, poll_timeout=0.05)
    controller = port_controller.ControllerNode(
        coordination_url=url, loglevel=QUIET, runfile_dir=str(tmp_path),
        heartbeat_interval=0.1)
    calc = CPUWorkerNode(**common)
    downloader = port_worker.DownloaderNode(**common)
    mover = port_worker.MoveBcolzNode(**common)
    nodes = [controller, calc, downloader, mover]
    threads = _start(*nodes)
    wait_until(lambda: len(controller.worker_map) == 3
               and len(controller.files_map) == 2, desc="registration")
    rpc = port_rpc.RPC(coordination_url=url, timeout=30, loglevel=QUIET)
    yield {"rpc": rpc, "controller": controller, "calc": calc,
           "nodes": nodes, "threads": threads, "url": url}
    for n in nodes:
        n.running = False
    for t in threads:
        t.join(timeout=10)


def test_scattered_sleep_and_fire_and_forget_execute_code(small,
                                                          monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_ENABLE_EXECUTE_CODE", "1")
    rpc, controller = small["rpc"], small["controller"]
    assert rpc.sleep([0.01, 0.02]) == "OK"
    assert rpc.execute_code(function="math.gcd", args=[4, 6]) == "OK"
    wait_until(lambda: not any(controller.worker_out_messages.values())
               and not controller.inflight, desc="scattered work drained")
    assert "slept 0.05" in rpc.sleep(0.05)
    assert rpc.execute_code(function="math.gcd", args=[4, 6],
                            wait=True) == 2


def test_replication_view_metrics_and_bundle(small):
    """Only the calc worker holds the shards (the downloader and mover
    list the same dir): each shard has one holder, under the factor 2."""
    rpc = small["rpc"]
    info = rpc.info()
    assert info["replication"] == {
        "replica_factor": 2,
        "shards_by_holders": {"1": 2, "2": 0, "3plus": 0},
        "under_replicated": ["a0.bcolzs", "a1.bcolzs"],
    }
    assert info["others"] == {}
    text = rpc.metrics()
    assert 'bqueryd_tpu_replica_holders{holders="1"} 2' in text
    assert 'bqueryd_tpu_replica_holders{holders="3plus"} 0' in text
    bundle = rpc.debug_bundle()
    assert bundle["controller"]["replication"] == info["replication"]


def test_killworkers_then_killall_end_every_loop(small):
    rpc, nodes, threads = small["rpc"], small["nodes"], small["threads"]
    assert rpc.killworkers() == "OK"
    for node, thread in zip(nodes[1:], threads[1:]):
        thread.join(timeout=5)
        assert not thread.is_alive(), type(node).__name__
    assert nodes[0].running
    assert rpc.killall() == "OK"
    threads[0].join(timeout=5)
    assert not threads[0].is_alive()
    assert not nodes[0].store.smembers("bqueryd_controllers")


def test_killall_relays_to_peers_once(tmp_path, monkeypatch):
    """Two controllers with a worker each: ``killall`` through one stops
    both controllers and both workers; the relayed verb is not relayed
    again."""
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    url = f"mem://torch-killall-{os.urandom(4).hex()}"
    controllers = [port_controller.ControllerNode(
        coordination_url=url, loglevel=QUIET,
        runfile_dir=str(tmp_path / f"c{i}"), heartbeat_interval=0.1)
        for i in range(2)]
    workers = [CPUWorkerNode(coordination_url=url, data_dir=str(tmp_path),
                             loglevel=QUIET, heartbeat_interval=0.1,
                             poll_timeout=0.05) for _ in range(2)]
    relayed = []
    real = port_controller.ControllerNode.rpc_killall

    def spy(self, msg):
        relayed.append((self.address, bool(msg.get("_relayed"))))
        return real(self, msg)

    monkeypatch.setattr(port_controller.ControllerNode, "rpc_killall", spy)
    nodes = controllers + workers
    threads = _start(*nodes)
    try:
        a, b = controllers
        wait_until(lambda: b.address in a.others and a.address in b.others
                   and all(w.worker_id in c.worker_map
                           for c in controllers for w in workers),
                   desc="peers and workers registered")
        rpc = port_rpc.RPC(coordination_url=url, address=a.address,
                           timeout=30, loglevel=QUIET)
        assert rpc.killall() == "OK"
        for t in threads:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in threads)
        assert sorted(relayed) == sorted([(a.address, False),
                                          (b.address, True)])
    finally:
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=5)


def test_gossip_fills_others_with_the_peers_info(tmp_path, monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    url = f"mem://torch-gossip-{os.urandom(4).hex()}"
    controllers = [port_controller.ControllerNode(
        coordination_url=url, loglevel=QUIET,
        runfile_dir=str(tmp_path / f"c{i}"), heartbeat_interval=0.1)
        for i in range(2)]
    threads = _start(*controllers)
    try:
        a, b = controllers
        wait_until(lambda: a.others.get(b.address, {}).get("address")
                   == b.address, desc="b's info gossiped to a")
        info = port_rpc.RPC(coordination_url=url, address=a.address,
                            timeout=30, loglevel=QUIET).info()
        peer = info["others"][b.address]
        assert "others" not in peer and peer["last_seen"] > 0
        assert peer["replication"]["replica_factor"] == 0
    finally:
        for n in controllers:
            n.running = False
        for t in threads:
            t.join(timeout=5)


# -- the CLI's download roles --------------------------------------------------

def _spawn(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "bqueryd_tpu_torch.node", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def test_cli_download_roles_activate_a_shard(tmp_path):
    """A controller, a CPU worker, a downloader and a mover as processes on
    a ``file://`` store, the blob store under ``BQUERYD_TPU_BLOB_DIR``:
    ``download(wait=True)`` activates the zipped shard, the worker answers
    it, and every process exits 0 on SIGTERM."""
    serving = tmp_path / "serving"
    serving.mkdir()
    blobs = tmp_path / "blobs"
    build = tmp_path / "build"
    build.mkdir()
    df = pd.DataFrame({"g": np.arange(300, dtype=np.int64) % 4,
                       "v": np.arange(300, dtype=np.int64)})
    jax_ctable.fromdataframe(df, str(build / "cli.bcolzs"))
    zip_path, _ = zip_to_file(str(build / "cli.bcolzs"), str(build))
    LocalFSBackend(root=str(blobs)).put("bcolz", "cli.bcolzs.zip", zip_path)
    url = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=REPO, BQUERYD_TPU_IP="127.0.0.1",
               BQUERYD_TPU_BLOB_DIR=str(blobs),
               BQUERYD_TPU_RUNFILE_DIR=str(tmp_path))
    roles = [["controller"],
             ["worker", f"--data_dir={serving}", "--device=cpu"],
             ["downloader", f"--data_dir={serving}"],
             ["movebcolz", f"--data_dir={serving}"]]
    procs = [_spawn([*r, f"--coordination={url}"], env) for r in roles]
    try:
        store = coordination_store(url)
        wait_until(lambda: store.smembers("bqueryd_controllers"),
                   timeout=60, desc="controller registered")
        rpc = port_rpc.RPC(coordination_url=url, timeout=60, loglevel=QUIET)
        wait_until(lambda: len(rpc.info()["workers"]) == 3, timeout=60,
                   desc="three workers registered")
        assert rpc.download(filenames=["cli.bcolzs.zip"], bucket="bcolz",
                            scheme="localfs", wait=True) == "DONE"
        wait_until(lambda: "cli.bcolzs" in rpc.info()["workers"][next(
            w for w, i in rpc.info()["workers"].items()
            if i["workertype"] == "calc")]["data_files"],
            timeout=60, desc="activated shard advertised")
        order, cols = rpc.groupby(["cli.bcolzs"], ["g"],
                                  [["v", "sum", "s"]], [])
        assert dict(zip(cols["g"].tolist(), cols["s"].tolist())) == (
            df.groupby("g")["v"].sum().to_dict())
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        outs = []
        deadline = time.time() + 30
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.time(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
    assert [p.returncode for p in procs] == [0, 0, 0, 0], [
        o.decode(errors="replace")[-2000:] for o in outs]

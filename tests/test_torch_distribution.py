"""The port's dataset distribution against the reference's cases.

``tests/test_distribution_e2e.py`` (LocalFS, S3 and Azure through the
fakes, a slow fetch, mid-flight cancellation, concurrent tickets) and
``tests/test_scheduling.py`` (batching, a poisoned ticket, a ticket's
error, concurrent clients, 64 shards on two workers) run on port nodes:
during each case the names the reference imports point at the port's
(``on_port``: the controller, the CPU calc worker, the downloader and
mover, the client, the store, ``zip_to_file`` and the blob and download
modules).  Then the port's own contracts:

* a ticket registered by one package's controller is claimed, fetched and
  activated by the other package's downloader and mover through a
  ``file://`` store, and the shard, zipped by the other package, is served
  by the registering package's calc worker (both directions);
* ``placement_nodes`` picks the JAX package's holders on a grid of files,
  node sets and factors;
* a shard distributed again under its name with other data is answered
  fresh with the serving layer and the result cache on;
* a ticket's activation drops the controller's stats and rollups of its
  shards, and a failed ticket activates nothing.

Every wait is a bounded poll; the nodes' threads are joined on teardown.
"""

import json
import logging
import os
import threading

import numpy as np
import pandas as pd
import pytest

import test_distribution_e2e as ref_e2e
import test_scheduling as ref_sched
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import controller as port_controller
from bqueryd_tpu_torch import download as port_download
from bqueryd_tpu_torch import messages as port_messages
from bqueryd_tpu_torch import rpc as port_rpc
from bqueryd_tpu_torch import worker as port_worker
from bqueryd_tpu_torch.blob import LocalFSBackend
from bqueryd_tpu_torch.utils.net import zip_to_file as port_zip
from tests.conftest import wait_until
from tests.torch_fixtures import (  # noqa: F401
    CPUWorkerNode,
    disarmed_port_chaos,
    fresh_port_calibration,
    on_port,
)

QUIET = logging.WARNING


def _url():
    return f"mem://torch-dist-{os.urandom(4).hex()}"


# -- the reference's distribution cases --------------------------------------

PIPELINE_CASES = [
    "test_full_distribution_pipeline",
    "test_heartbeats_continue_during_slow_fetch",
    "test_midflight_cancellation_aborts_download",
    "test_downloads_shape_matches_reference",
    "test_full_distribution_pipeline_over_s3",
    "test_full_distribution_pipeline_over_azure",
    "test_concurrent_tickets_activate_exactly_once",
]


@pytest.mark.parametrize("case", PIPELINE_CASES)
def test_reference_pipeline_case_on_port(case, on_port, tmp_path):
    """The reference's ``pipeline`` (controller, calc worker, downloader
    and mover on one serving dir, a LocalFS object store) built of port
    nodes, each case run on it."""
    url = _url()
    fixture = ref_e2e.pipeline.__wrapped__(tmp_path, url)
    pipeline = next(fixture)
    try:
        assert type(pipeline["downloader"]) is port_worker.DownloaderNode
        assert type(pipeline["mover"]) is port_worker.MoveBcolzNode
        assert type(pipeline["controller"]) is port_controller.ControllerNode
        fn = getattr(ref_e2e, case)
        params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
        args = {"pipeline": pipeline, "tmp_path": tmp_path,
                "mem_store_url": url}
        fn(*(args[p] for p in params))
    finally:
        next(fixture, None)


@pytest.mark.parametrize("case", [
    "test_s3_backend_streams_chunks_with_progress",
    "test_s3_fetch_retry_after_midstream_failure",
    "test_azure_backend_streams_chunks_with_progress",
])
def test_reference_backend_case_on_port(case, on_port, tmp_path,
                                        monkeypatch):
    fn = getattr(ref_e2e, case)
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
            "mem_store_url": _url()}
    fn(*(args[p] for p in params))


# -- the reference's scheduling cases ----------------------------------------

CONTROLLER_CASES = [
    "test_colocated_shards_batch_into_one_message",
    "test_split_placement_batches_per_worker_set",
    "test_duplicate_filenames_deduplicated",
    "test_unservable_batch_resplits_to_per_shard",
    "test_vanished_file_aborts_parent_fast",
    "test_batch_respects_non_mergeable_ops",
    "test_ticket_error_released_to_waiting_client",
]


@pytest.fixture
def sched_on_port(on_port, monkeypatch):
    """``test_scheduling``'s module-level names on the port's."""
    monkeypatch.setattr(ref_sched, "ControllerNode",
                        port_controller.ControllerNode)
    monkeypatch.setattr(ref_sched, "RPCMessage", port_messages.RPCMessage)


@pytest.mark.parametrize("case", CONTROLLER_CASES)
def test_reference_scheduling_case_on_port(case, sched_on_port, tmp_path):
    fixture = ref_sched.controller.__wrapped__(tmp_path)
    controller = next(fixture)
    try:
        assert type(controller) is port_controller.ControllerNode
        getattr(ref_sched, case)(controller)
    finally:
        next(fixture, None)


@pytest.mark.parametrize("case", [
    "test_failed_download_poisons_ticket",
    "test_concurrent_clients_all_get_correct_results",
    "test_wide_fanout_64_shards_two_workers",
])
def test_reference_scheduling_cluster_case_on_port(case, sched_on_port,
                                                   tmp_path):
    getattr(ref_sched, case)(tmp_path, _url())


# -- across the packages ------------------------------------------------------

def _frame(seed, n=600):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "g": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.integers(-(2**40), 2**40, n).astype(np.int64),
    })


def _zipped(tmp_path, backend, name, df, zipper, bucket="bcolz"):
    """``df`` written as shard ``name`` and put into ``backend`` as
    ``<name>.zip``, zipped by ``zipper``."""
    build = tmp_path / f"build_{os.urandom(3).hex()}"
    build.mkdir()
    jax_ctable.fromdataframe(df, str(build / name))
    zip_path, _crc = zipper(str(build / name), str(build))
    backend.put(bucket, f"{name}.zip", zip_path)
    return f"{name}.zip"


def _start(*nodes):
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    return threads


def _stop(nodes, threads):
    for n in nodes:
        n.running = False
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def _sums(got):
    order, cols = got if isinstance(got, tuple) else (
        list(got.columns), {c: got[c].to_numpy() for c in got.columns})
    return dict(zip(cols["g"].tolist(), cols["s"].tolist()))


@pytest.mark.parametrize("direction", ["jax_ticket_port_movers",
                                       "port_ticket_jax_movers"])
def test_ticket_crosses_packages(direction, tmp_path, monkeypatch):
    """One package's controller registers the ticket and its calc worker
    serves the shard; the other package's downloader fetches and unzips it
    (zipped by that package too) and its mover activates it, all through
    one ``file://`` store."""
    import bqueryd_tpu.controller as jax_controller
    import bqueryd_tpu.download as jax_download
    import bqueryd_tpu.rpc as jax_rpc
    import bqueryd_tpu.utils.net as jax_net
    import bqueryd_tpu.worker as jax_worker

    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    serving = tmp_path / "serving"
    serving.mkdir()
    backend = LocalFSBackend(root=str(tmp_path / "blobs"))
    url = f"file://{tmp_path / 'store'}"
    jax_side = direction == "jax_ticket_port_movers"
    df = _frame(31 if jax_side else 37)
    zipper = port_zip if jax_side else jax_net.zip_to_file
    name = f"cross_{direction[:3]}.bcolzs"
    blob = _zipped(tmp_path, backend, name, df, zipper)
    common = dict(coordination_url=url, data_dir=str(serving),
                  loglevel=QUIET, heartbeat_interval=0.2, poll_timeout=0.05)
    if jax_side:
        controller = jax_controller.ControllerNode(
            coordination_url=url, loglevel=QUIET, runfile_dir=str(tmp_path),
            heartbeat_interval=0.1)
        calc = jax_worker.WorkerNode(restart_check=False, **common)
        downloader = port_worker.DownloaderNode(**common)
        mover = port_worker.MoveBcolzNode(**common)
    else:
        controller = port_controller.ControllerNode(
            coordination_url=url, loglevel=QUIET, runfile_dir=str(tmp_path),
            heartbeat_interval=0.1)
        calc = CPUWorkerNode(**common)
        downloader = jax_worker.DownloaderNode(**common)
        mover = jax_worker.MoveBcolzNode(**common)
    downloader.blob_backend = backend
    downloader.download_interval = mover.download_interval = 0.2
    nodes = (controller, calc, downloader, mover)
    threads = _start(*nodes)
    try:
        wait_until(lambda: len(controller.worker_map) >= 3,
                   desc="nodes registered")
        client = (jax_rpc.RPC if jax_side else port_rpc.RPC)(
            coordination_url=url, timeout=60, loglevel=QUIET)
        assert client.download(filenames=[blob], bucket="bcolz", wait=True,
                               scheme="localfs") == "DONE"
        meta = json.loads(
            (serving / name / jax_download.METADATA_FILENAME).read_text())
        assert set(meta) == {"ticket", "timestamp"}
        wait_until(lambda: name in controller.files_map,
                   desc="activated shard advertised")
        got = _sums(client.groupby([name], ["g"], [["v", "sum", "s"]], []))
        assert got == df.groupby("g")["v"].sum().to_dict()
        # the ticket's slots were cleared by the mover on activation
        assert not client.store.keys(
            port_download.ticket_key(meta["ticket"]))
    finally:
        _stop(nodes, threads)


def test_placement_matches_the_jax_package():
    import bqueryd_tpu.download as jax_download

    rng = np.random.default_rng(3)
    for n_nodes in (1, 2, 3, 5, 8):
        nodes = [f"node-{i:02d}.{rng.integers(1000)}" for i in range(n_nodes)]
        for factor in (-1, 0, 1, 2, 3, 7, 9):
            for i in range(40):
                filename = f"taxi_{i}.bcolzs.zip"
                assert (port_download.placement_nodes(filename, nodes, factor)
                        == jax_download.placement_nodes(filename, nodes,
                                                        factor))


def test_store_keys_match_the_jax_package():
    import bqueryd_tpu
    import bqueryd_tpu_torch

    for name in ("REDIS_SET_KEY", "REDIS_TICKET_KEY_PREFIX",
                 "REDIS_DOWNLOAD_LOCK_PREFIX", "REDIS_DOWNLOAD_LOCK_DURATION"):
        assert getattr(bqueryd_tpu_torch, name) == getattr(bqueryd_tpu, name)
    assert (port_download.lock_name("n", "t", "s3://b/k")
            == __import__("bqueryd_tpu.download").download.lock_name(
                "n", "t", "s3://b/k"))


# -- re-distribution under a live shard ---------------------------------------

@pytest.fixture
def port_pipeline(tmp_path, monkeypatch):
    """A port controller, CPU calc worker, downloader and mover on one
    serving dir with a LocalFS object store, the serving layer on (a
    rollup is built at a view's first query) and the result cache on."""
    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    monkeypatch.setenv("BQUERYD_TPU_SERVE", "1")
    monkeypatch.setenv("BQUERYD_TPU_ROLLUP_HEAT_MIN", "1")
    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", str(64 << 20))
    url = _url()
    serving = tmp_path / "serving"
    serving.mkdir()
    backend = LocalFSBackend(root=str(tmp_path / "blobs"))
    common = dict(coordination_url=url, data_dir=str(serving),
                  loglevel=QUIET, heartbeat_interval=0.2, poll_timeout=0.05)
    controller = port_controller.ControllerNode(
        coordination_url=url, loglevel=QUIET, runfile_dir=str(tmp_path),
        heartbeat_interval=0.1)
    calc = CPUWorkerNode(**common)
    downloader = port_worker.DownloaderNode(**common)
    downloader.blob_backend = backend
    mover = port_worker.MoveBcolzNode(**common)
    downloader.download_interval = mover.download_interval = 0.2
    nodes = (controller, calc, downloader, mover)
    threads = _start(*nodes)
    wait_until(lambda: len(controller.worker_map) >= 3,
               desc="nodes registered")
    rpc = port_rpc.RPC(coordination_url=url, timeout=60, loglevel=QUIET)
    yield {"rpc": rpc, "controller": controller, "calc": calc,
           "backend": backend, "serving": serving}
    _stop(nodes, threads)


def test_redistributed_shard_answers_fresh(port_pipeline, tmp_path):
    """A shard distributed again under its name with other data (another
    seed, another row count) is answered with the new data, though the
    old answer sits in the worker's result cache and in a rollup."""
    pipe = port_pipeline
    rpc, controller = pipe["rpc"], pipe["controller"]
    name = "taxi_0.bcolzs"
    query = ([name], ["g"], [["v", "sum", "s"]], [])
    old, new = _frame(1, n=700), _frame(2, n=650)
    for df in (old, new):
        blob = _zipped(tmp_path, pipe["backend"], name, df, port_zip)
        assert rpc.download(filenames=[blob], bucket="bcolz", wait=True,
                            scheme="localfs") == "DONE"
        wait_until(lambda: name in controller.files_map,
                   desc="shard advertised")
        want = df.groupby("g")["v"].sum().to_dict()
        if df is old:
            # served three times: computed, then from the result cache or
            # from the rollup its first query built
            for _ in range(3):
                assert _sums(rpc.groupby(*query)) == want
            wait_until(lambda: any(
                e.state == "ready"
                for e in controller.serving.manager.entries.values()),
                desc="rollup of the old shard ready")
            assert _sums(rpc.groupby(*query)) == want
            assert rpc.last_call_answer_source in ("rollup", "subsume")
        else:
            assert _sums(rpc.groupby(*query)) == want
            assert rpc.last_call_answer_source == "recompute"
            wait_until(lambda: any(
                e.state == "ready"
                for e in controller.serving.manager.entries.values()),
                desc="rollup rebuilt over the new shard")
            assert _sums(rpc.groupby(*query)) == want


def test_ticket_activation_drops_stats_and_stales_rollups(tmp_path):
    """The controller's bookkeeping when a mover reports a ticket done:
    the ticket's shards lose their advertised stats and their rollups'
    epochs move; a ticket it never registered invalidates every shard; a
    failed ticket invalidates nothing."""
    controller = port_controller.ControllerNode(
        coordination_url=_url(), loglevel=QUIET, runfile_dir=str(tmp_path))
    try:
        controller.files_map = {"a.bcolzs": {"w"}, "b.bcolzs": {"w"}}
        controller.shard_stats = {"a.bcolzs": {"rows": 1},
                                  "b.bcolzs": {"rows": 2}}
        controller.note_ticket("t1", ["a.bcolzs"])
        epochs = controller.serving.manager.file_epochs
        before = dict(epochs)
        controller.handle_worker(b"mover", port_messages.TicketDoneMessage(
            {"ticket": "t1", "error": "bucket on fire",
             "worker_id": "mover"}))
        assert set(controller.shard_stats) == {"a.bcolzs", "b.bcolzs"}
        assert dict(epochs) == before
        controller.handle_worker(b"mover", port_messages.TicketDoneMessage(
            {"ticket": "t1", "worker_id": "mover"}))
        assert set(controller.shard_stats) == {"b.bcolzs"}
        controller.handle_worker(b"mover", port_messages.TicketDoneMessage(
            {"ticket": "peer-ticket", "worker_id": "mover"}))
        assert controller.shard_stats == {}
        events = [e["kind"] for e in controller.flight.events()]
        assert events.count("ticket_activated") == 2
    finally:
        controller.socket.close()


def test_missing_blob_fails_the_ticket_and_activates_nothing(on_port,
                                                             tmp_path):
    """A download of a blob the store does not hold: the RPC raises the
    ticket's error, the slot reads ERROR, and nothing reaches the serving
    dir."""
    url = _url()
    fixture = ref_e2e.pipeline.__wrapped__(tmp_path, url)
    pipeline = next(fixture)
    try:
        rpc = pipeline["rpc"]
        with pytest.raises(port_rpc.RPCError, match="failed"):
            rpc.download(filenames=["absent.bcolzs.zip"], bucket="bcolz",
                         wait=True, scheme="localfs")
        states = [s for _t, slots in rpc.download_progress()
                  for s in slots.values()]
        assert states and all(s.startswith("ERROR") for s in states)
        assert sorted(os.listdir(pipeline["serving"])) in ([], ["incoming"])
        assert pipeline["downloader"].downloads_failed.value == 1
    finally:
        next(fixture, None)

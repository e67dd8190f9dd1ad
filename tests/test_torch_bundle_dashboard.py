"""The shared dashboard through the micro-batch window, on the CPU at a
small size: the benchmark's ``taxi10m-w40`` deployment and its
``dashboard-c16`` shapes.

* ``MeshQueryExecutor.execute_bundle`` over a seeded taxi dataset
  (``portbench.datagen``, 200,000 rows in 10 shards): each of the five
  dashboard shapes as one bundle of members with a threshold each and one
  unfiltered member, every member held against ``portbench.reference``
  (NumPy, nothing of the port) by ``portbench.check.compare``: keys,
  counts and integer sums bit for bit, float means within the
  configuration's ``float_rel_err``;
* a port cluster (controller and CPU worker as threads over TCP ZMQ on
  127.0.0.1) at a 40 ms window: the autopsy's ``batch`` of each staged
  query, the worker's ``calc`` span tags and its
  ``bqueryd_tpu_worker_bundles_total{path}`` and
  ``bqueryd_tpu_worker_bundle_members_total{path}`` series, for a shared
  scan, for each reason a bundle runs member by member, and at window 0.
"""

import json
import logging
import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from bqueryd_tpu_torch import ops
from bqueryd_tpu_torch.models.query import GroupByQuery
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.storage.ctable import ctable
from portbench import check, datagen, reference
from portbench.traffic import Traffic
from tests.conftest import wait_until
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(os.path.dirname(HERE), "portbench")
ROWS = 200_000
SEED = 2**31 + 2101
QUIET = logging.WARNING
RPC_TIMEOUT = 30
#: the queries of one window in the cluster cases
N_MEMBERS = 4


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


CONFIG = _load("configs", "taxi10m-w40.json")
TRAFFIC = _load("traffic", "dashboard-c16.json")
COLUMNS = {c["name"]: c for c in CONFIG["columns"]}


@pytest.fixture(scope="module")
def taxi(tmp_path_factory):
    """The deployment's dataset at 200,000 rows, written by the port's
    ctable, and its query generator."""
    root = tmp_path_factory.mktemp("taxi_w40")
    ds = datagen.Dataset(CONFIG, SEED, rows=ROWS)
    ds.write(str(root), processes=1)
    return str(root), ds, Traffic(TRAFFIC, ds.shards, SEED)


def _thresholds(n, salt):
    """``n`` distinct filter values of the traffic's grid."""
    f = TRAFFIC["filter"]
    grid = int(round((f["high"] - f["low"]) / f["step"]))
    picks = np.random.default_rng([SEED, salt]).choice(grid, n,
                                                       replace=False)
    return [f["low"] + int(k) * f["step"] for k in picks]


def _query(q):
    return GroupByQuery(list(q["groupby"]), [list(a) for a in q["aggs"]],
                        [tuple(t) for t in q["where"]])


def _numbers(ds, query, answer):
    """``check.compare``'s three numbers of one ``(order, columns)``
    answer."""
    lows, cards = reference.radix(COLUMNS, query["groupby"])
    order, columns = answer
    return check.compare(reference.answer(ds.parts, COLUMNS, query), order,
                         columns, query, ds.key_ints, lows, cards)


def _assert_exact(ds, query, answer):
    numbers = _numbers(ds, query, answer)
    limits = CONFIG["limits"]
    assert all(numbers[n] <= limits[n] for n in check.NUMBERS), (
        query, numbers)


@pytest.mark.parametrize("shape", list(TRAFFIC["shapes"]))
def test_execute_bundle_of_each_dashboard_shape_matches_the_reference(
        taxi, shape):
    """Members with their own thresholds and one without a filter, as a
    flush of one shape fuses them, against the plain NumPy reference."""
    root, ds, traffic = taxi
    queries = [traffic.query(shape, t)
               for t in _thresholds(4, len(shape))] + [traffic.query(shape)]
    tables = [ctable(os.path.join(root, ds.names[i]), mode="r")
              for i in queries[0]["shards"]]
    ex = MeshQueryExecutor(device="cpu")
    payloads = ex.execute_bundle(tables, [_query(q) for q in queries])
    assert len(payloads) == len(queries)
    for query, payload in zip(queries, payloads):
        answer = hostmerge.finalize_table(hostmerge.merge_payloads([payload]))
        _assert_exact(ds, query, answer)
    # the comparison tells members apart: the unfiltered answer is not
    # the most selective member's
    narrowest = max(range(len(queries) - 1),
                    key=lambda i: queries[i]["where"][0][2])
    assert _numbers(ds, queries[narrowest], hostmerge.finalize_table(
        hostmerge.merge_payloads([payloads[-1]])))["int_mismatches"] > 0


# -- the cluster: the window, the autopsy and the worker's path ---------------

@pytest.fixture(scope="module")
def cluster(taxi, tmp_path_factory):
    """A port controller and a port calc worker (CPU) over the dataset,
    as threads, coordinated through a ``file://`` store."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.worker import WorkerNode

    root, ds, traffic = taxi
    run = tmp_path_factory.mktemp("w40_cluster")
    url = f"file://{run / 'store'}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                    runfile_dir=str(run),
                                    heartbeat_interval=0.05)
        worker = WorkerNode(coordination_url=url, data_dir=root,
                            loglevel=QUIET, heartbeat_interval=0.1,
                            poll_timeout=0.05, device="cpu")
        nodes = [controller, worker]
        threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
        for t in threads:
            t.start()
        try:
            wait_until(lambda: all(n in controller.files_map
                                   and n in controller.shard_stats
                                   for n in ds.names),
                       desc="shards and their stats advertised")
            yield {"controller": controller, "worker": worker, "url": url,
                   "ds": ds, "traffic": traffic}
        finally:
            for n in nodes:
                n.running = False
            for t in threads:
                t.join(timeout=10)
        assert not any(t.is_alive() for t in threads), "a node did not stop"


@contextmanager
def _held(controller):
    """The controller's loop held at its next heartbeat: queries sent
    meanwhile wait on its socket, and its next receive drains them all in
    one tick, so that they are staged together."""
    parked, release = threading.Event(), threading.Event()

    def held():
        parked.set()
        release.wait(30)
        del controller.heartbeat  # the class's own again
        controller.heartbeat()

    controller.heartbeat = held
    assert parked.wait(30), "the controller's loop never reached a heartbeat"
    try:
        yield
    finally:
        release.set()


def _series(node, name, path):
    """One labelled series of a node's ``/metrics``, 0 before its first
    increment."""
    key = f'{name}{{path="{path}"}}'
    for line in node.metrics.render().splitlines():
        series, _, value = line.rpartition(" ")
        if series == key:
            return float(value)
    return 0.0


SERIES = ("bqueryd_tpu_worker_bundles_total",
          "bqueryd_tpu_worker_bundle_members_total")


def _window_of(c, queries):
    """Send ``queries`` at once, one ``RPC`` each, staged in one tick; the
    answers and each query's autopsy and trace, in order."""
    from bqueryd_tpu_torch.rpc import RPC

    rpcs = [RPC(coordination_url=c["url"], timeout=RPC_TIMEOUT,
                loglevel=QUIET) for _ in queries]
    files = c["ds"].names
    answers, errors = {}, {}
    sending = [threading.Event() for _ in queries]

    def ask(i, query):
        sending[i].set()
        try:
            answers[i] = rpcs[i].groupby([files[s] for s in query["shards"]],
                                         query["groupby"], query["aggs"],
                                         query["where"])
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors[i] = exc

    threads = [threading.Thread(target=ask, args=(i, q), daemon=True)
               for i, q in enumerate(queries)]
    try:
        with _held(c["controller"]):
            for t in threads:
                t.start()
            for event in sending:
                assert event.wait(30)
            time.sleep(0.2)
        for t in threads:
            t.join(RPC_TIMEOUT + 10)
        assert not errors, errors
        records = []
        for rpc in rpcs:
            trace_id = rpc.last_trace_id
            autopsy = wait_until(lambda: rpc.autopsy(trace_id),
                                 desc="the query's autopsy")
            records.append((autopsy, rpc.trace(trace_id)))
    finally:
        for rpc in rpcs:
            rpc._close_socket()
    return [answers[i] for i in range(len(queries))], records


def _ineligible(worker, mp):
    mp.setattr(worker, "_bundle_mesh_eligible", lambda *_a, **_k: False)


def _raising(exc):
    def patch(worker, mp):
        def boom(*_a, **_k):
            raise exc
        mp.setattr(worker.executor, "execute_bundle", boom)
    return patch


#: (case, window ms, how the worker is made to fall back, the calc span's
#: path and reason)
CASES = [
    ("shared", "40", None, "shared", None),
    ("ineligible", "40", _ineligible, "members", "ineligible"),
    ("rejected", "40", _raising(ValueError("a member's shape")), "members",
     "rejected"),
    ("overflow", "40", _raising(ops.CompositeOverflow("past int64")),
     "members", "overflow"),
    ("window 0", "0", None, None, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_window_records_what_its_flush_and_the_worker_did(cluster, case):
    """N concurrent queries of one shape: at 40 ms every autopsy's
    ``batch`` reads the N staged plans, the N members of their dispatch
    and whether the worker shared the scan, which its ``calc`` span tags
    and its bundle series say too; at window 0 nothing is staged and no
    autopsy has ``batch``.  Every answer equals the reference's."""
    _label, window_ms, fall_back, path, reason = case
    c = cluster
    worker, ds = c["worker"], c["ds"]
    # thresholds of their own: no case's answer is in the result cache
    queries = [c["traffic"].query("sharded", t)
               for t in _thresholds(N_MEMBERS, 1000 + CASES.index(case))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", window_ms)
        if fall_back is not None:
            fall_back(worker, mp)
        before = {(s, p): _series(worker, s, p)
                  for s in SERIES for p in ("shared", "members")}
        answers, records = _window_of(c, queries)
        after = {k: _series(worker, *k) for k in before}
    for query, answer in zip(queries, answers):
        _assert_exact(ds, query, answer)
    calcs = [s for _a, trace in records for s in trace["spans"]
             if s["name"] == "calc"]
    if path is None:
        assert all("batch" not in autopsy for autopsy, _t in records)
        assert all("path" not in (s.get("tags") or {}) for s in calcs)
        assert after == before
        return
    for autopsy, _trace in records:
        assert autopsy["batch"] == {"staged": N_MEMBERS,
                                    "members": N_MEMBERS,
                                    "shared_scan": path == "shared"}
    # one dispatch: its calc span reaches every member's timeline
    assert {s["span_id"] for s in calcs} and len(
        {s["span_id"] for s in calcs}) == 1
    tags = calcs[0]["tags"]
    assert tags["path"] == path and tags["members"] == N_MEMBERS
    assert tags.get("reason") == reason
    other = "members" if path == "shared" else "shared"
    assert after[(SERIES[0], path)] - before[(SERIES[0], path)] == 1
    assert after[(SERIES[1], path)] - before[(SERIES[1], path)] == N_MEMBERS
    assert after[(SERIES[0], other)] == before[(SERIES[0], other)]

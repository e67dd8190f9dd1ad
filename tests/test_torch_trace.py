"""The port's tracing, logs, slow-query ring and ``/metrics`` endpoint
(``bqueryd_tpu_torch.obs.trace``, ``.logs``, ``.http``,
``bqueryd_tpu_torch.utils.tracing``) against the JAX package's.

``tests/test_obs.py``'s PhaseTimer, trace-span, trace-context, store,
formatter, slow-query and HTTP cases and ``tests/test_obs_forensics.py``'s
byte bounds run on both packages (the port's by swapping the modules those
cases import); one seeded sequence of operations gives equal stores, rings
and log lines in both.  Then a port cluster on the CPU runs
``tests/test_obs.py``'s cluster cases (the waterfall, ``rpc.metrics()``,
slow queries over RPC, the worker histograms in ``info``, live registries'
lint, ``last_call_duration``) and the port's own kill-switch case, the
device-path spans (the executor's phases, the fetch debited from the
kernel phase), the profiler hooks, the CLI flags, and a JAX ``RPC`` whose
trace id reaches a port controller's ``rpc.trace``.
"""

import inspect
import json
import logging
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import bqueryd_tpu.obs as jax_obs
import bqueryd_tpu.utils as jax_utils
import test_obs as ref_obs
import test_obs_forensics as ref_forensics
from bqueryd_tpu.obs import logs as jax_logs
from bqueryd_tpu.obs import trace as jax_trace
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import obs as port_obs
from bqueryd_tpu_torch.obs import flightrec as port_flightrec
from bqueryd_tpu_torch.obs import http as port_http
from bqueryd_tpu_torch.obs import logs as port_logs
from bqueryd_tpu_torch.obs import trace as port_trace
from bqueryd_tpu_torch.utils import tracing as port_tracing
from tests.conftest import wait_until
from tests.torch_fixtures import (  # noqa: F401
    disarmed_port_chaos,
    fresh_port_calibration,
)

PACKAGES = ("jax", "port")
QUIET = logging.WARNING


@pytest.fixture
def on_package(monkeypatch):
    """``on_package("port")`` points the names the reference's cases
    import (``obs``, ``flightrec``, ``bqueryd_tpu.utils.tracing``,
    ``bqueryd_tpu.obs.http``) at the port's."""
    def use(pkg):
        if pkg != "port":
            return
        for mod in (ref_obs, ref_forensics):
            monkeypatch.setattr(mod, "obs", port_obs)
        monkeypatch.setattr(ref_forensics, "flightrec", port_flightrec)
        monkeypatch.setitem(sys.modules, "bqueryd_tpu.utils.tracing",
                            port_tracing)
        monkeypatch.setattr(jax_utils, "tracing", port_tracing,
                            raising=False)
        monkeypatch.setitem(sys.modules, "bqueryd_tpu.obs.http", port_http)
        monkeypatch.setattr(jax_obs, "http", port_http, raising=False)
    return use


def _call(fn, monkeypatch, tmp_path):
    """A reference case with the fixtures its signature names."""
    given = {"monkeypatch": monkeypatch, "tmp_path": tmp_path}
    return fn(*(given[p] for p in inspect.signature(fn).parameters))


OBS_CASES = [
    "test_phase_timer_total_is_monotonic",
    "test_phase_timer_total_key_never_collides",
    "test_phase_timer_records_spans_with_mapped_names",
    "test_trace_span_noop_when_profile_unset",
    "test_trace_context_wire_roundtrip",
    "test_trace_store_ring_eviction",
    "test_json_log_formatter_carries_context",
    "test_slow_query_log_threshold_and_capacity",
    "test_metrics_http_endpoint_serves_registry",
    "test_metrics_http_maybe_start_off_by_default",
]

FORENSIC_CASES = [
    "test_trace_store_byte_bound_and_latest",
    "test_trace_store_update_does_not_leak_bytes",
    "test_slow_query_log_byte_bound",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", OBS_CASES)
def test_reference_obs_case(case, pkg, on_package, monkeypatch, tmp_path):
    on_package(pkg)
    _call(getattr(ref_obs, case), monkeypatch, tmp_path)


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", FORENSIC_CASES)
def test_reference_byte_bound_case(case, pkg, on_package, monkeypatch,
                                   tmp_path):
    on_package(pkg)
    _call(getattr(ref_forensics, case), monkeypatch, tmp_path)


# -- one seeded sequence, both packages ----------------------------------------

def _timelines(seed, n):
    rng = np.random.default_rng(seed)
    return [
        {"trace_id": f"t{i}",
         "pad": "x" * int(rng.integers(10, 900)),
         "spans": [{"name": "kernel",
                    "duration_s": float(rng.random())}]}
        for i in range(n)
    ]


@pytest.mark.parametrize("capacity,max_bytes", [(8, 1 << 20), (1000, 4096),
                                                (5, 6000)])
def test_trace_store_matches_reference(capacity, max_bytes):
    stores = [mod.TraceStore(capacity=capacity, max_bytes=max_bytes)
              for mod in (jax_trace, port_trace)]
    for timeline in _timelines(7, 60) + _timelines(8, 5):
        for store in stores:
            store.put(timeline["trace_id"], dict(timeline))
    jax_store, port_store = stores
    assert port_store.evictions == jax_store.evictions
    assert port_store.nbytes == jax_store.nbytes
    assert len(port_store) == len(jax_store)
    assert port_store.latest() == jax_store.latest()
    assert port_store._order == jax_store._order


@pytest.mark.parametrize("threshold_ms", ["0", "400", "bad"])
def test_slow_query_ring_matches_reference(monkeypatch, threshold_ms):
    monkeypatch.setenv("BQUERYD_TPU_SLOW_QUERY_MS", threshold_ms)
    rng = np.random.default_rng(11)
    logs = [mod.SlowQueryLog(capacity=16, max_bytes=8192)
            for mod in (jax_logs, port_logs)]
    for i in range(80):
        wall = float(rng.exponential(1.0))
        entry = {"trace_id": f"q{i}", "ts": 1000.0 + i,
                 "pad": "y" * int(rng.integers(0, 700))}
        recorded = [log.maybe_record(wall, entry) for log in logs]
        assert recorded[0] == recorded[1]
    jax_log, port_log = logs
    assert port_log.entries() == jax_log.entries()
    assert port_log.evictions == jax_log.evictions
    assert port_log.nbytes == jax_log.nbytes
    assert port_log.entry_for("q79") == jax_log.entry_for("q79")
    assert port_log.entry_for(None) is None


def test_json_log_lines_match_reference():
    record = logging.LogRecord("bqueryd_tpu_torch.worker", logging.ERROR,
                               __file__, 1, "failed %d", (3,), None)
    lines = []
    for mod in (jax_obs, port_obs):
        formatter = mod.JsonLogFormatter(node_id="n1")
        with mod.bind_log_context(trace_id="abc", query_id="q"):
            with mod.bind_log_context(query_id="q2", shard=None):
                lines.append(json.loads(formatter.format(record)))
    assert lines[0] == lines[1]
    assert lines[1]["query_id"] == "q2" and "shard" not in lines[1]


def test_span_records_match_reference():
    """make_span and a SpanRecorder's export have the reference's shape;
    the ids are random, the rest equal."""
    kwargs = dict(span_id="s1", parent_span_id="p1", node="n",
                  tags={"worker": "w"})
    assert (port_obs.make_span("t", "kernel", 12.3456789, 0.1234567,
                               **kwargs)
            == jax_obs.make_span("t", "kernel", 12.3456789, 0.1234567,
                                 **kwargs))
    exports = []
    for mod in (jax_obs, port_obs):
        rec = mod.SpanRecorder("t" * 32, node="w", root_parent="d1",
                               span_names=mod.PHASE_SPAN_NAMES)
        rec.record("layout", 5.0, 0.5)
        rec.record("open", 4.0, 0.25, tags={"x": 1})
        exports.append([{k: v for k, v in s.items()
                         if k not in ("span_id", "parent_span_id",
                                      "start_ts", "duration_s")}
                        for s in rec.export(tags={"m": 2})])
    assert exports[0] == exports[1]
    assert port_obs.PHASE_SPAN_NAMES == jax_obs.PHASE_SPAN_NAMES
    assert port_obs.TRACE_KEY == jax_obs.TRACE_KEY


def test_wire_trace_keys_match_reference():
    """``trace`` and ``slo_class`` ride the reference's envelope keys, and
    the span table is the reference's."""
    from bqueryd_tpu import messages as jax_messages
    from bqueryd_tpu_torch import messages as port_messages

    ctx = port_obs.TraceContext.new_root()
    msg = port_messages.RPCMessage({"payload": "groupby"})
    msg.set_trace(ctx)
    msg["slo_class"] = "interactive"
    parsed = jax_messages.msg_factory(msg.to_json())
    assert parsed.get_trace() == ctx.to_wire()
    assert parsed["slo_class"] == "interactive"
    back = port_messages.msg_factory(parsed.to_json())
    assert back.get_trace() == ctx.to_wire()
    back.set_trace(None)
    assert back.get_trace() is None
    # the reference's span names, and the port's worker-loop receipt
    assert (port_messages.SPAN_SCHEMA.keys() - jax_messages.SPAN_SCHEMA.keys()
            == {"worker_receive"})
    assert jax_messages.SPAN_SCHEMA.keys() <= port_messages.SPAN_SCHEMA.keys()


# -- PhaseTimer: debit, threads, unrecorded phases -------------------------------

def test_phase_timer_debit_nets_out_a_nested_phase():
    timer = port_tracing.PhaseTimer()
    with timer.phase("aggregate"):
        t0 = time.perf_counter()
        with timer.phase("fetch"):
            time.sleep(0.01)
        timer.debit("aggregate", time.perf_counter() - t0)
    assert timer.timings["fetch"] >= 0.01
    assert 0.0 <= timer.timings["aggregate"] < timer.timings["fetch"]


def test_phase_timer_sums_phases_of_several_threads():
    recorder = port_obs.SpanRecorder("t" * 32, node="w")
    timer = port_tracing.PhaseTimer(recorder=recorder)

    def work():
        for _ in range(50):
            with timer.phase("decode"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # every occurrence reached the recorder through the timer
    assert len(recorder.spans) == 200
    assert timer.timings["decode"] >= 0.0


def test_phase_mapped_to_none_is_timed_but_not_a_span():
    from bqueryd_tpu_torch.worker import CALC_SPAN_NAMES

    recorder = port_obs.SpanRecorder("t" * 32, node="w")
    timer = port_tracing.PhaseTimer(recorder=recorder,
                                    span_names=CALC_SPAN_NAMES)
    for phase in ("execute", "delta", "layout"):
        with timer.phase(phase):
            pass
    assert set(timer.timings) == {"execute", "delta", "layout"}
    assert [s["name"] for s in recorder.spans] == ["h2d_transfer"]
    # every span the worker can record is declared
    from bqueryd_tpu_torch.messages import SPAN_SCHEMA

    assert {n for n in CALC_SPAN_NAMES.values() if n} <= set(SPAN_SCHEMA)


def test_trace_span_opens_a_profiler_range_tagged_with_the_trace(
        monkeypatch, tmp_path):
    monkeypatch.setenv("BQUERYD_TPU_PROFILE", "1")
    ctx = port_obs.TraceContext.new_root()
    with port_tracing.profiler_trace(str(tmp_path), device="cpu"):
        with port_obs.use_trace(ctx):
            with port_tracing.trace_span("aggregate", device="cpu"):
                sum(range(1000))
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == f"aggregate[{ctx.trace_id}]"
               for e in events)


def test_trace_span_without_profile_touches_no_torch(monkeypatch):
    monkeypatch.delenv("BQUERYD_TPU_PROFILE", raising=False)
    monkeypatch.setitem(sys.modules, "torch.profiler", None)
    with port_tracing.trace_span("kernel", device="cuda"):
        pass


def test_profiler_trace_exports_even_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with port_tracing.profiler_trace(str(tmp_path)):
            raise RuntimeError("boom")
    assert len(os.listdir(tmp_path)) == 1


# -- the device path's spans -----------------------------------------------------

def _executor_spans(tmp_path, where=()):
    from bqueryd_tpu_torch.models.query import GroupByQuery
    from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
    from bqueryd_tpu_torch.storage.ctable import ctable
    import pandas as pd

    rng = np.random.default_rng(5)
    df = pd.DataFrame({"g": rng.integers(0, 7, 3000).astype(np.int64),
                       "v": rng.integers(-50, 50, 3000).astype(np.int64)})
    paths = []
    for i in range(2):
        path = str(tmp_path / f"e{i}.bcolzs")
        jax_ctable.fromdataframe(df.iloc[i::2].reset_index(drop=True), path)
        paths.append(path)
    tables = [ctable(p, mode="r") for p in paths]
    recorder = port_obs.SpanRecorder("t" * 32, node="w")
    timer = port_tracing.PhaseTimer(recorder=recorder,
                                    span_names=port_obs.PHASE_SPAN_NAMES)
    executor = MeshQueryExecutor(device="cpu")
    executor.timer = timer
    executor.execute(tables, GroupByQuery(["g"], [["v", "sum", "s"]],
                                          list(where)))
    return timer, recorder


def test_executor_phases_become_the_device_path_spans(tmp_path):
    timer, recorder = _executor_spans(tmp_path, where=[["v", ">", 0]])
    names = [s["name"] for s in recorder.spans]
    for name in ("align", "filter", "h2d_transfer", "kernel", "d2h_fetch",
                 "merge"):
        assert name in names, names
    # the fetch runs inside aggregate and is debited from it: the kernel
    # phase's timing excludes it, its span still spans it
    kernel = next(s for s in recorder.spans if s["name"] == "kernel")
    fetch = next(s for s in recorder.spans if s["name"] == "d2h_fetch")
    assert kernel["start_ts"] <= fetch["start_ts"]
    assert (timer.timings["aggregate"]
            <= kernel["duration_s"] - fetch["duration_s"] + 1e-5)
    # on the CPU no CUDA event pair runs: no device time is claimed
    assert "device_s" not in (kernel.get("tags") or {})


def test_instrumented_partial_tables_counts_calls_per_shape(tmp_path):
    from bqueryd_tpu_torch.obs import profile

    before = {sig: e["calls"] for sig, e in
              profile.profiler().programs.items()}
    _executor_spans(tmp_path)
    after = profile.profiler().programs
    grew = {e["name"] for sig, e in after.items()
            if e["calls"] > before.get(sig, 0)}
    assert {"ops.partial_tables", "ops.onehot_rows_dot"} <= grew
    entry = next(e for e in after.values()
                 if e["name"] == "ops.onehot_rows_dot")
    assert entry["flops"] > 0 and entry["bytes_accessed"] > 0


# -- the CLI -----------------------------------------------------------------------

def test_cli_flags_set_the_observability_knobs(monkeypatch):
    from bqueryd_tpu_torch import node

    monkeypatch.delenv("BQUERYD_TPU_METRICS_PORT", raising=False)
    monkeypatch.delenv("BQUERYD_TPU_LOG_JSON", raising=False)
    monkeypatch.setattr(node, "shell", lambda *a, **k: None)
    assert node.main(["--metrics_port", "0", "--log_json",
                      "--coordination", "mem://cli-flags"]) == 0
    assert os.environ["BQUERYD_TPU_METRICS_PORT"] == "0"
    assert os.environ["BQUERYD_TPU_LOG_JSON"] == "1"


def test_log_json_installs_the_formatter(monkeypatch):
    import bqueryd_tpu_torch

    monkeypatch.setenv("BQUERYD_TPU_LOG_JSON", "1")
    saved = list(bqueryd_tpu_torch.logger.handlers)
    for h in saved:
        bqueryd_tpu_torch.logger.removeHandler(h)
    try:
        bqueryd_tpu_torch.configure_logging(logging.INFO)
        formatters = [h.formatter for h in bqueryd_tpu_torch.logger.handlers
                      if isinstance(h, logging.StreamHandler)]
        assert any(isinstance(f, port_obs.JsonLogFormatter)
                   for f in formatters)
    finally:
        for h in list(bqueryd_tpu_torch.logger.handlers):
            bqueryd_tpu_torch.logger.removeHandler(h)
        for h in saved:
            bqueryd_tpu_torch.logger.addHandler(h)


# -- a port cluster: tests/test_obs.py's cluster cases -----------------------------

@pytest.fixture(scope="module")
def port_obs_cluster(tmp_path_factory):
    """tests/test_obs.py's ``obs_cluster`` on port nodes (the worker on the
    CPU), over the same data."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    df = ref_obs._taxi_df()
    root = tmp_path_factory.mktemp("port_obs_cluster")
    jax_ctable.fromdataframe(df, str(root / "taxi.bcolz"))
    for i in range(ref_obs.NR_SHARDS):
        jax_ctable.fromdataframe(df.iloc[i::ref_obs.NR_SHARDS],
                                 str(root / f"taxi-{i}.bcolzs"))
    url = f"mem://port-obs-{os.urandom(4).hex()}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        controller = ControllerNode(
            coordination_url=url, loglevel=QUIET, runfile_dir=str(root),
            heartbeat_interval=0.2, dead_worker_timeout=10.0)
        worker = WorkerNode(
            coordination_url=url, data_dir=str(root), loglevel=QUIET,
            heartbeat_interval=0.2, poll_timeout=0.1, device="cpu")
        threads = [threading.Thread(target=n.go, daemon=True)
                   for n in (controller, worker)]
        for t in threads:
            t.start()
        wait_until(lambda: controller.files_map.get("taxi.bcolz"),
                   desc="worker registration")
        rpc = RPC(coordination_url=url, timeout=60, loglevel=QUIET)
        yield {"rpc": rpc, "controller": controller, "worker": worker,
               "df": df, "root": str(root), "url": url}
        rpc._close_socket()
        for n in (controller, worker):
            n.running = False
        for t in threads:
            t.join(timeout=10)


CLUSTER_CASES = [
    "test_trace_waterfall_covers_required_spans",
    "test_rpc_metrics_prometheus_exposition",
    "test_slow_query_log_over_rpc",
    "test_worker_histograms_aggregate_into_info",
    "test_live_registries_pass_lint",
    "test_last_call_duration_uses_perf_counter",
]


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_reference_cluster_case_on_port(case, port_obs_cluster, on_package):
    on_package("port")
    getattr(ref_obs, case)(port_obs_cluster)


def test_kill_switch_disables_the_hot_path(port_obs_cluster):
    """tests/test_obs.py's kill-switch case, its race removed: the
    controller replies before it accounts, so the switch stays off until
    a verb served after the query (a ping) has returned."""
    rpc = port_obs_cluster["rpc"]
    controller = port_obs_cluster["controller"]
    before = controller.query_seconds.count
    completed = controller.counters["queries_completed"]
    port_obs.set_enabled(False)
    try:
        ref_obs._groupby(rpc)
        trace_id = rpc.last_trace_id
        rpc.ping()
    finally:
        port_obs.set_enabled(True)
    assert controller.query_seconds.count == before
    assert rpc.trace(trace_id) is None
    assert rpc.autopsy(trace_id) is None
    assert controller.counters["queries_completed"] == completed + 1


def test_waterfall_carries_route_and_device_memory_tags(port_obs_cluster):
    rpc = port_obs_cluster["rpc"]
    # a result-cache hit would execute nothing
    port_obs_cluster["worker"].clear_caches()
    ref_obs._groupby(rpc)
    timeline = rpc.trace(rpc.last_trace_id)
    spans = {s["name"]: s for s in timeline["spans"]}
    assert spans["kernel"]["tags"]["effective_strategy"]
    # the controller's reply assembly and the dispatch's wait windows
    assert "reply_serialization" in spans
    waits = [s for s in timeline["spans"] if s["name"] == "dispatch"
             and (s.get("tags") or {}).get("wait")]
    assert len(waits) == 1
    # CPU: no CUDA context, so no device-memory tags on the calc root
    assert "device_hbm_watermark_bytes" not in (spans["calc"].get("tags")
                                                or {})
    record = rpc.autopsy(timeline["trace_id"])
    total = sum(record["segments"].values()) + record["unattributed_s"]
    assert total == pytest.approx(record["wall_s"], abs=1e-3)


def test_metrics_endpoint_of_a_port_node(tmp_path, monkeypatch):
    """``BQUERYD_TPU_METRICS_PORT=0`` (the CLI's ``--metrics_port 0``)
    serves a node's registry over HTTP until it stops."""
    from bqueryd_tpu_torch.controller import ControllerNode

    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    monkeypatch.setenv("BQUERYD_TPU_METRICS_PORT", "0")
    controller = ControllerNode(
        coordination_url=f"mem://metrics-{os.urandom(4).hex()}",
        loglevel=QUIET, runfile_dir=str(tmp_path))
    try:
        port = controller._metrics_server.port
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        for family in ("bqueryd_tpu_capacity_fleet_utilization",
                       "bqueryd_tpu_trace_buffer_evictions",
                       "bqueryd_tpu_groupby_seconds_bucket"):
            assert family in body
    finally:
        controller.stop()
    assert controller._metrics_server is None


def test_jax_rpc_trace_id_reaches_a_port_controller(tmp_path, monkeypatch):
    """A JAX ``RPC`` (through a file:// store) mints the trace; the port
    controller adopts it, so ``rpc.trace`` and ``rpc.autopsy`` of the JAX
    client read the port's timeline of that very query."""
    from bqueryd_tpu.rpc import RPC as JaxRPC
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.worker import WorkerNode

    monkeypatch.setenv("BQUERYD_TPU_IP", "127.0.0.1")
    df = ref_obs._taxi_df(n=600)
    jax_ctable.fromdataframe(df, str(tmp_path / "t.bcolz"))
    store = tmp_path / "store"
    store.mkdir()
    url = f"file://{store}"
    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=str(tmp_path),
                                heartbeat_interval=0.2)
    worker = WorkerNode(coordination_url=url, data_dir=str(tmp_path),
                        loglevel=QUIET, heartbeat_interval=0.2,
                        poll_timeout=0.05, device="cpu")
    threads = [threading.Thread(target=n.go, daemon=True)
               for n in (controller, worker)]
    for t in threads:
        t.start()
    try:
        wait_until(lambda: controller.files_map.get("t.bcolz"),
                   desc="worker registration")
        rpc = JaxRPC(coordination_url=url, timeout=30, loglevel=QUIET)
        rpc.groupby(["t.bcolz"], ["payment_type"],
                    [["total_amount", "sum", "total_amount"]], [])
        trace_id = rpc.last_trace_id
        timeline = rpc.trace(trace_id)
        assert timeline["trace_id"] == trace_id
        root = next(s for s in timeline["spans"] if s["name"] == "groupby")
        assert all(s["trace_id"] == trace_id for s in timeline["spans"])
        assert root["parent_span_id"] not in {
            s["span_id"] for s in timeline["spans"]}
        assert rpc.autopsy(trace_id)["trace_id"] == trace_id
    finally:
        for n in (controller, worker):
            n.running = False
        for t in threads:
            t.join(timeout=10)

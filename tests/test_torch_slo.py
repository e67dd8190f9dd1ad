"""The port's critical-path attribution and SLO accounting
(``bqueryd_tpu_torch.obs.slo``) against the JAX package's.

``tests/test_slo.py``'s pure cases (the attribution sweep, the summary,
the class parser, the SLO tracker, the burn windows, the timeline ring,
the quantile reader, the bundle member shares) run on both packages, and
the same timelines and clocks give equal ``attribute``, ``summarize``,
``SLOTracker`` and ``SnapshotTimeline`` records in both: synthetic
timelines with overlapping shards, a bundle's shares, a hedge and a
failover's backoff.  Then a port cluster on the CPU: the reference's
unknown-trace and timeline-ring cases, and the port's own autopsy round
trip, SLO classes, bundle sections, member shares and window flight
events.  Those read the controller through its verbs or a bounded poll
(the controller replies before it accounts) and assert the exact
identities, no coverage threshold: a warm CPU micro-query's coverage
depends on the machine's load, so the threshold is held on the card.
Served answers (the serving layer's rollups) are accounted like
dispatched ones.
"""

import inspect
import logging
import os
import sys
import threading

import numpy as np
import pandas as pd
import pytest

import bqueryd_tpu.plan as jax_plan
import test_slo as ref_slo
from bqueryd_tpu.obs import metrics as jax_metrics
from bqueryd_tpu.obs import slo as jax_slo
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import obs as port_obs
from bqueryd_tpu_torch.obs import metrics as port_metrics
from bqueryd_tpu_torch.obs import slo as port_slo
from bqueryd_tpu_torch.plan import bundle as port_bundle
from tests.conftest import wait_until
from tests.torch_fixtures import (  # noqa: F401
    disarmed_port_chaos,
    fresh_port_calibration,
)
from test_serving import serving_cluster  # noqa: F401

PACKAGES = ("jax", "port")
QUIET = logging.WARNING


@pytest.fixture
def on_package(monkeypatch):
    """``on_package("port")`` points ``tests/test_slo.py``'s ``obs``,
    ``slo``, ``MetricsRegistry``, ``quantile_from_snapshot``, the metrics
    module and ``bqueryd_tpu.plan.bundle`` at the port's."""
    def use(pkg):
        if pkg != "port":
            return
        monkeypatch.setattr(ref_slo, "obs", port_obs)
        monkeypatch.setattr(ref_slo, "slo", port_slo)
        monkeypatch.setattr(ref_slo, "MetricsRegistry",
                            port_metrics.MetricsRegistry)
        monkeypatch.setattr(ref_slo, "quantile_from_snapshot",
                            port_metrics.quantile_from_snapshot)
        monkeypatch.setitem(sys.modules, "bqueryd_tpu.obs.metrics",
                            port_metrics)
        monkeypatch.setitem(sys.modules, "bqueryd_tpu.plan.bundle",
                            port_bundle)
        monkeypatch.setattr(jax_plan, "bundle", port_bundle)
    return use


PURE_CASES = [
    "test_attribute_simple_decomposition",
    "test_attribute_overlapping_concurrent_shards_never_double_count",
    "test_attribute_splits_backoff_out_of_retry_dispatch",
    "test_attribute_hedge_dispatch_tagged",
    "test_attribute_bundle_share_reports_member_slice",
    "test_attribute_unknown_span_name_stays_visible",
    "test_attribute_malformed_inputs_never_raise",
    "test_attribute_without_root_uses_span_envelope",
    "test_summarize_compacts_record",
    "test_every_public_span_name_has_priority",
    "test_parse_classes_formats_and_default",
    "test_slo_tracker_records_margins_and_violations",
    "test_slo_burn_rate_windows",
    "test_slo_burn_window_survives_high_qps",
    "test_snapshot_timeline_paces_and_bounds",
    "test_snapshot_timeline_disabled_and_builder_failure",
    "test_quantile_from_snapshot",
    "test_member_shares_proportional_and_equal",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_slo_case(case, pkg, on_package, monkeypatch):
    on_package(pkg)
    fn = getattr(ref_slo, case)
    fn(*([monkeypatch] if inspect.signature(fn).parameters else []))


def test_declared_tables_match_reference():
    for name in ("SYNTHETIC_SEGMENTS", "COVERAGE_TARGET", "BURN_WINDOWS",
                 "DEFAULT_CLASS", "DEFAULT_TARGET_S", "DEFAULT_OBJECTIVE"):
        assert getattr(port_slo, name) == getattr(jax_slo, name), name
    # the reference's segments and order, and the port's worker-loop
    # receipt, a segment of its own
    added = {"worker_receive"}
    assert {k: v for k, v in port_slo.SPAN_CATEGORIES.items()
            if k not in added} == jax_slo.SPAN_CATEGORIES
    assert all(port_slo.SPAN_CATEGORIES[n] == n for n in added)
    assert tuple(s for s in port_slo.SEGMENT_PRIORITY
                 if s not in added) == tuple(jax_slo.SEGMENT_PRIORITY)
    assert added <= set(port_slo.SEGMENT_PRIORITY)
    from bqueryd_tpu_torch.messages import SPAN_SCHEMA

    # every public span name the port can record attributes to a segment
    public = {n for n in SPAN_SCHEMA if n in port_slo.SPAN_CATEGORIES}
    assert public == set(port_slo.SPAN_CATEGORIES)


# -- equal records from the same timelines -----------------------------------------

def _span(mod, name, start, dur, tags=None, trace_id="t1", span_id=None,
          parent=None):
    return mod.make_span(trace_id, name, start, dur, tags=tags,
                         span_id=span_id or f"{name}-{start}",
                         parent_span_id=parent)


def _plain(mod):
    t0 = 1000.0
    return [_span(mod, "groupby", t0, 0.5),
            _span(mod, "plan", t0, 0.002),
            _span(mod, "admission", t0 + 0.002, 0.01),
            _span(mod, "dispatch", t0 + 0.012, 0.004,
                  tags={"worker": "w1", "retries": 0}),
            _span(mod, "dispatch", t0 + 0.016, 0.45,
                  tags={"worker": "w1", "retries": 0, "wait": True}),
            _span(mod, "calc", t0 + 0.02, 0.44),
            _span(mod, "storage_decode", t0 + 0.021, 0.03),
            _span(mod, "h2d_transfer", t0 + 0.06, 0.05),
            _span(mod, "kernel", t0 + 0.11, 0.25, tags={"device_s": 0.2}),
            _span(mod, "d2h_fetch", t0 + 0.3, 0.05),
            _span(mod, "merge", t0 + 0.36, 0.04),
            _span(mod, "reply_serialization", t0 + 0.4, 0.05)]


def _sharded(mod, seed):
    """Overlapping per-shard calc spans of a random shard group."""
    rng = np.random.default_rng(seed)
    t0 = 50.0
    spans = [_span(mod, "groupby", t0, 2.0)]
    for i in range(12):
        start = t0 + float(rng.uniform(0.0, 1.5))
        dur = float(rng.uniform(0.05, 0.4))
        spans.append(_span(mod, "calc", start, dur, span_id=f"c{i}"))
        for name in ("storage_decode", "kernel", "merge"):
            sub = start + float(rng.uniform(0, dur / 2))
            spans.append(_span(mod, name, sub, float(rng.uniform(0, dur / 3)),
                               span_id=f"{name}{i}"))
    return spans


def _hedge(mod):
    t0 = 10.0
    return [_span(mod, "groupby", t0, 1.0),
            _span(mod, "dispatch", t0, 0.01, tags={"worker": "w1"}),
            _span(mod, "dispatch", t0 + 0.3, 0.0,
                  tags={"worker": "w2", "hedge": True}),
            _span(mod, "dispatch", t0 + 0.3, 0.5,
                  tags={"worker": "w2", "hedge": True, "wait": True}),
            _span(mod, "calc", t0 + 0.35, 0.4)]


def _failover(mod):
    t0 = 20.0
    return [_span(mod, "groupby", t0, 2.0),
            _span(mod, "dispatch", t0, 0.01,
                  tags={"worker": "w1", "retries": 0}),
            _span(mod, "dispatch", t0 + 0.01, 0.8,
                  tags={"worker": "w1", "retries": 0,
                        "failed": "worker w1 lost"}),
            _span(mod, "dispatch", t0 + 0.81, 0.4,
                  tags={"worker": "w2", "retries": 1, "backoff_s": 0.3,
                        "excluded": ["w1"]}),
            _span(mod, "calc", t0 + 1.3, 0.6)]


def _bundle(mod):
    t0 = 5.0
    spans = [_span(mod, "groupby", t0, 1.0),
             _span(mod, "batch_window", t0 + 0.01, 0.04),
             _span(mod, "demux", t0 + 0.9, 0.01)]
    for name, start, dur in (("calc", 0.1, 0.7), ("kernel", 0.3, 0.2),
                             ("merge", 0.6, 0.1)):
        spans.append(_span(mod, name, t0 + start, dur,
                           tags={"bundle_share": 0.375}))
    return spans


TIMELINES = {
    "plain": _plain,
    "sharded_1": lambda mod: _sharded(mod, 1),
    "sharded_2": lambda mod: _sharded(mod, 2),
    "hedge": _hedge,
    "failover": _failover,
    "bundle": _bundle,
}


@pytest.mark.parametrize("shape", sorted(TIMELINES))
@pytest.mark.parametrize("ok", [True, False])
def test_attribute_and_summarize_match_reference(shape, ok):
    records = []
    for mod in (jax_slo, port_slo):
        obs_mod = jax_metrics if mod is jax_slo else port_metrics
        del obs_mod
        spans = TIMELINES[shape](ref_slo.obs if mod is jax_slo else port_obs)
        timeline = {"trace_id": "t1", "ok": ok, "spans": spans}
        record = mod.attribute(timeline)
        records.append((record, mod.summarize(record),
                        mod.summarize(record, top=2)))
    assert records[0] == records[1]
    record = records[1][0]
    total = sum(record["segments"].values()) + record["unattributed_s"]
    assert total == pytest.approx(record["wall_s"], abs=1e-5)


@pytest.mark.parametrize("raw", ["", "interactive:0.5:0.999,batch:30",
                                 "a:1,a:2:0.5,,b:-1,c:x,d:1:1.5"])
def test_slo_tracker_matches_reference(raw):
    rng = np.random.default_rng(3)
    events = [(str(rng.choice(["interactive", "batch", "a", "zzz", None])),
               float(rng.exponential(0.8)),
               None if rng.random() < 0.6 else float(rng.normal(0, 1)),
               bool(rng.random() < 0.9), 10_000.0 + i * 7.0)
              for i in range(400)]
    outs = []
    for mod, metrics in ((jax_slo, jax_metrics), (port_slo, port_metrics)):
        registry = metrics.MetricsRegistry()
        tracker = mod.SLOTracker(registry, classes=mod.parse_classes(raw))
        results = [tracker.record(c if c != "None" else None, wall,
                                  margin_s=margin, ok=ok, now=now)
                   for c, wall, margin, ok, now in events]
        now = events[-1][-1]
        outs.append((results, tracker.snapshot(now=now),
                     {c: tracker.burn_rate(c, 600.0, now=now)
                      for c in tracker.classes},
                     registry.render()))
    assert outs[0] == outs[1]


def test_snapshot_timeline_matches_reference(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_TIMELINE_INTERVAL_S", "4")
    monkeypatch.setenv("BQUERYD_TPU_TIMELINE_ENTRIES", "7")
    rings = [mod.SnapshotTimeline() for mod in (jax_slo, port_slo)]
    taken = [[ring.maybe_snapshot(lambda i=i: {"i": i}, now=100.0 + i * 1.5)
              for i in range(60)] for ring in rings]
    assert taken[0] == taken[1]
    assert rings[0].entries() == rings[1].entries()
    assert len(rings[1]) == 7


# -- a port cluster -----------------------------------------------------------------

@pytest.fixture(scope="module")
def port_slo_cluster(tmp_path_factory):
    """tests/test_slo.py's ``slo_cluster`` on port nodes (the worker on the
    CPU): two shards, the SLO classes ``interactive`` and ``batch``, a
    fast timeline ring and every query a slow one."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.worker import WorkerNode

    tmp_path = tmp_path_factory.mktemp("port_slo_cluster")
    url = f"mem://port-slo-{os.urandom(4).hex()}"
    rng = np.random.default_rng(23)
    df = pd.DataFrame({
        "g": rng.integers(0, 6, 4000).astype(np.int64),
        "v": rng.integers(-1000, 1000, 4000).astype(np.int64),
        "w": rng.random(4000),
    })
    shards = ["slo_0.bcolzs", "slo_1.bcolzs"]
    for i, name in enumerate(shards):
        jax_ctable.fromdataframe(df.iloc[i::2].reset_index(drop=True),
                                 str(tmp_path / name))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        mp.setenv("BQUERYD_TPU_SLO_CLASSES", "interactive:0.5:0.999,batch:30")
        mp.setenv("BQUERYD_TPU_TIMELINE_INTERVAL_S", "0.2")
        mp.setenv("BQUERYD_TPU_SLOW_QUERY_MS", "0")
        controller = ControllerNode(
            coordination_url=url, loglevel=QUIET, runfile_dir=str(tmp_path),
            heartbeat_interval=0.05)
        worker = WorkerNode(
            coordination_url=url, data_dir=str(tmp_path), loglevel=QUIET,
            heartbeat_interval=0.1, poll_timeout=0.05, device="cpu")
        threads = [threading.Thread(target=n.go, daemon=True)
                   for n in (controller, worker)]
        for t in threads:
            t.start()
        wait_until(lambda: all(n in controller.files_map for n in shards),
                   desc="shards advertised")
        yield {"controller": controller, "worker": worker, "df": df,
               "shards": shards, "url": url, "tmp_path": tmp_path}
        for n in (controller, worker):
            n.running = False
        for t in threads:
            t.join(timeout=10)


def _rpc(cluster, **kwargs):
    from bqueryd_tpu_torch.rpc import RPC

    return RPC(coordination_url=cluster["url"], timeout=60, loglevel=QUIET,
               **kwargs)


def _query(rpc, cluster, where=()):
    return rpc.groupby(cluster["shards"], ["g"], [["v", "sum", "s"]],
                       list(where))


@pytest.fixture
def as_jax_rpc(monkeypatch):
    """The reference cases' ``from bqueryd_tpu.rpc import RPC`` builds the
    port's client."""
    import bqueryd_tpu.rpc as jax_rpc
    from tests.torch_fixtures import FrameRPC

    monkeypatch.setattr(jax_rpc, "RPC", FrameRPC)


@pytest.mark.parametrize("case", ["test_autopsy_unknown_trace_returns_none",
                                  "test_timeline_ring_e2e"])
def test_reference_cluster_case_on_port(case, port_slo_cluster, as_jax_rpc):
    getattr(ref_slo, case)(port_slo_cluster)


def test_autopsy_roundtrip(port_slo_cluster):
    """tests/test_slo.py's autopsy round trip, with the exact identities
    and no coverage threshold."""
    rpc = _rpc(port_slo_cluster)
    _query(rpc, port_slo_cluster)
    _query(rpc, port_slo_cluster)
    trace_id = rpc.last_trace_id
    record = rpc.autopsy(trace_id)
    assert record["trace_id"] == trace_id and record["ok"] is True
    segments = record["segments"]
    # the repeat is the worker's result-cache hit: no kernel phase
    assert {"dispatch", "admission_wait", "storage_decode",
            "client_deserialize"} <= set(segments)
    assert ref_slo.total_of(record) == pytest.approx(record["wall_s"],
                                                     abs=1e-3)
    assert record["covered_s"] == pytest.approx(
        sum(segments.values()), abs=1e-4)
    assert record["coverage"] == pytest.approx(
        record["covered_s"] / record["wall_s"], abs=1e-3)
    assert record["attempts"] and record["attempts"][0]["worker"]
    assert record["slow_query"]["trace_id"] == trace_id
    assert (record["slow_query"]["attribution"]["segments"]
            .keys() <= set(segments))
    # with no trace id: the newest timeline, which an autopsy call adds
    # nothing to
    assert rpc.autopsy()["trace_id"] == trace_id


def test_slo_classes_and_margins(port_slo_cluster):
    """tests/test_slo.py's SLO-class case, read through the debug bundle's
    ``slo`` section and the slow-query ring instead of the controller's
    state right after the call."""
    before = _rpc(port_slo_cluster).debug_bundle()["controller"]["slo"]
    rpc = _rpc(port_slo_cluster, slo_class="interactive")
    _query(rpc, port_slo_cluster)
    trace_id = rpc.last_trace_id
    after = rpc.debug_bundle()["controller"]["slo"]
    assert (after["interactive"]["queries"]
            == before["interactive"]["queries"] + 1)
    assert (after["interactive"]["violations"]
            <= before["interactive"]["violations"] + 1)
    (entry,) = [e for e in rpc.slow_queries() if e["trace_id"] == trace_id]
    assert entry["slo_class"] == "interactive"
    metrics = rpc.metrics()
    assert 'bqueryd_tpu_slo_queries_total{slo_class="interactive"}' in metrics
    rpc2 = _rpc(port_slo_cluster, slo_class="not_a_class")
    _query(rpc2, port_slo_cluster)
    latest = rpc2.debug_bundle()["controller"]["slo"]
    assert latest["default"]["queries"] == before["default"]["queries"] + 1
    assert "not_a_class" not in latest


def test_debug_bundle_carries_the_new_sections(port_slo_cluster):
    rpc = _rpc(port_slo_cluster)
    _query(rpc, port_slo_cluster)
    trace_id = rpc.last_trace_id
    bundle = rpc.debug_bundle(trace_id)
    assert bundle["schema"] == "bqueryd_tpu.debug_bundle/4"
    section = bundle["controller"]
    assert section["trace"]["trace_id"] == trace_id
    assert section["autopsy"]["trace_id"] == trace_id
    assert 0.0 < section["autopsy"]["coverage"] <= 1.0
    assert any(e["trace_id"] == trace_id for e in section["slow_queries"])
    assert "bqueryd_tpu_worker_groupby_seconds" in section[
        "worker_histograms"] or section["worker_histograms"] == {}
    assert "torch" in section["runtime"]
    assert section["compile_cache"]["path"]
    assert {"default", "interactive", "batch"} <= set(section["slo"])
    assert isinstance(section["timeline_ring"], list)
    capacity = section["capacity"]
    assert capacity["enabled"] is True
    assert capacity["fleet"]["state"] in ("ok", "warm", "saturated",
                                          "overloaded")
    assert "recommendations" in capacity
    worker_id = port_slo_cluster["worker"].worker_id
    wait_until(
        lambda: (rpc.debug_bundle()["workers"][worker_id]["snapshot"]
                 or {}).get("compile"),
        desc="the worker's slice with its compile section")
    slice_ = rpc.debug_bundle()["workers"][worker_id]["snapshot"]
    assert {"compile", "runtime", "compile_cache",
            "device_memory"} <= set(slice_)
    assert slice_["device_memory"] == []  # no CUDA context on the CPU
    import json

    json.dumps(bundle)


def test_bundle_member_shares_scale_slow_query_timings(port_slo_cluster,
                                                      monkeypatch):
    """tests/test_slo.py's member-share case, reading the slow-query ring
    and the autopsies through the verbs."""
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "300")
    controller = port_slo_cluster["controller"]
    bundles_before = controller.counters["plan_bundles"]
    wheres = ([["w", ">", 0.3]], [["w", ">", 0.6]])
    trace_ids, errors = {}, []

    def run(i):
        try:
            rpc = _rpc(port_slo_cluster)
            _query(rpc, port_slo_cluster, wheres[i])
            trace_ids[i] = rpc.last_trace_id
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not errors and len(trace_ids) == 2
    assert controller.counters["plan_bundles"] > bundles_before
    rpc = _rpc(port_slo_cluster)
    entries = {e["trace_id"]: e for e in rpc.slow_queries()}
    shares = []
    for trace_id in trace_ids.values():
        entry = entries[trace_id]
        for timings in entry["phase_timings"].values():
            shares.append(timings["_member_share"])
            assert timings["_total"] <= entry["wall_ms"] / 1000.0 + 1e-3
        record = rpc.autopsy(trace_id)
        assert record["bundle"]["share"] == pytest.approx(shares[-1],
                                                         abs=1e-6)
        assert "bundle_demux" in record["segments"]
        assert "batch_window_wait" in record["segments"]
    assert sum(shares) == pytest.approx(1.0, abs=1e-3)


def test_window_flight_events_recorded(port_slo_cluster, monkeypatch):
    """tests/test_slo.py's window case: ``window_open`` and
    ``window_flush`` in the flight ring (recorded before the dispatch),
    the autopsy through the verb."""
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "100")
    controller = port_slo_cluster["controller"]
    rpc = _rpc(port_slo_cluster)
    _query(rpc, port_slo_cluster)
    trace_id = rpc.last_trace_id
    kinds = [e["kind"] for e in controller.flight.events()]
    assert "window_open" in kinds and "window_flush" in kinds
    flush = [e for e in controller.flight.events()
             if e["kind"] == "window_flush"][-1]
    assert flush["staged"] >= 1 and flush["groups"] >= 1
    assert flush["fused"] == 0
    assert "batch_window_wait" in rpc.autopsy(trace_id)["segments"]


def test_served_answer_is_accounted(port_slo_cluster, monkeypatch):
    """A rollup-served answer (no dispatch) lands in the accounting as a
    dispatched one does: its SLO record, its ``groupby_seconds``
    observation and a timeline of its root span, so that ``rpc.autopsy()``
    returns it and not the query before it.  The reference's served
    answers skip all of it."""
    monkeypatch.setenv("BQUERYD_TPU_SERVE", "1")
    monkeypatch.setenv("BQUERYD_TPU_ROLLUP_HEAT_MIN", "1")
    controller = port_slo_cluster["controller"]
    rpc = _rpc(port_slo_cluster, slo_class="batch")
    query = (port_slo_cluster["shards"], ["g"], [["v", "max", "vmax"]], [])
    first = rpc.groupby(*query)
    wait_until(lambda: any(e.state == "ready" for e in
                           controller.serving.manager.entries.values()),
               desc="rollup materialization")
    before = rpc.debug_bundle()["controller"]
    metrics_before = rpc.metrics()
    served = rpc.groupby(*query)
    assert rpc.last_call_answer_source == "rollup"
    trace_id = rpc.last_trace_id
    by_key = [dict(zip(r[1]["g"].tolist(), r[1]["vmax"].tolist()))
              for r in (first, served)]
    assert by_key[0] == by_key[1]
    record = rpc.autopsy()
    assert record["trace_id"] == trace_id and record["ok"] is True
    timeline = rpc.trace(trace_id)
    assert timeline["answer_source"] == "rollup"
    names = sorted(s["name"] for s in timeline["spans"])
    assert names == ["groupby", "plan"]
    from bqueryd_tpu_torch.messages import SPAN_SCHEMA

    assert set(names) <= set(SPAN_SCHEMA)
    after = rpc.debug_bundle()["controller"]
    assert (after["slo"]["batch"]["queries"]
            == before["slo"]["batch"]["queries"] + 1)
    assert (after["counters"]["queries_completed"]
            == before["counters"]["queries_completed"] + 1)
    assert (after["counters"]["dispatched_shards"]
            == before["counters"]["dispatched_shards"])

    def count(text):
        line = next(x for x in text.splitlines()
                    if x.startswith("bqueryd_tpu_groupby_seconds_count"))
        return int(float(line.rsplit(" ", 1)[1]))

    assert count(rpc.metrics()) == count(metrics_before) + 1
    (entry,) = [e for e in rpc.slow_queries() if e["trace_id"] == trace_id]
    assert entry["slo_class"] == "batch" and entry["filenames"] == 0


def test_reference_served_answer_skips_accounting(serving_cluster):
    """The reference's gap the port closes (``ROADMAP.md`` Queue 3): on a
    JAX cluster a rollup-served answer leaves the SLO classes, the
    ``groupby_seconds`` histogram, the trace store, ``queries_completed``
    and the slow-query ring as they were, and ``rpc.autopsy()`` then
    returns the query before it."""
    import json
    import test_serving as ref_serving

    rpc = serving_cluster["rpc"]
    controller = serving_cluster["controller"]
    rpc.groupby(*ref_serving.Q)
    first_trace = rpc.last_trace_id
    wait_until(lambda: ref_serving._ready_keys(controller),
               desc="rollup materialization")

    def accounting():
        rpc.ping()  # served after the last query's accounting
        return (json.dumps(controller.slo.snapshot(), sort_keys=True),
                sum(controller.query_seconds.snapshot()["counts"]),
                len(controller.trace_store),
                controller.counters["queries_completed"],
                len(controller.slow_queries))

    before = accounting()
    rpc.groupby(*ref_serving.Q)
    assert rpc.last_call_answer_source == "rollup"
    served_trace = rpc.last_trace_id
    assert accounting() == before
    assert before[1:4] == (1, 1, 1)
    assert controller.trace_store.get(served_trace) is None
    assert rpc.autopsy()["trace_id"] == first_trace

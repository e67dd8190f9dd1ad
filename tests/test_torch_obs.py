"""The port's metrics registry and flight recorder (``bqueryd_tpu_torch.obs``)
against the JAX package's (``bqueryd_tpu.obs``).

``tests/test_obs.py``'s registry cases and ``tests/test_obs_forensics.py``'s
flight-recorder, redaction and bundle cases run on both packages (the port's
by swapping the modules' ``obs`` and ``flightrec``); one sequence of
operations gives equal rendered text, snapshots, merges, lint results,
events and bundles in both; and the port's controller and worker registries
lint clean, with the reference's help texts for every counter the port
keeps.  Everything here is exact: no floats are computed differently.
"""

import json
import logging
import os
import sys

import pytest

import test_obs as ref_obs
import test_obs_forensics as ref_forensics
from bqueryd_tpu import obs as jax_obs
from bqueryd_tpu.obs import flightrec as jax_flightrec
from bqueryd_tpu.obs import metrics as jax_metrics
from bqueryd_tpu_torch import obs as port_obs
from bqueryd_tpu_torch.obs import flightrec as port_flightrec
from bqueryd_tpu_torch.obs import metrics as port_metrics
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

PACKAGES = ("jax", "port")


@pytest.fixture
def on_package(monkeypatch):
    """``on_package("port")`` points the reference test modules' ``obs``,
    ``flightrec`` and ``bqueryd_tpu.obs.metrics`` at the port's."""
    def use(pkg):
        if pkg == "port":
            monkeypatch.setattr(ref_obs, "obs", port_obs)
            monkeypatch.setattr(ref_forensics, "obs", port_obs)
            monkeypatch.setattr(ref_forensics, "flightrec", port_flightrec)
            monkeypatch.setitem(sys.modules, "bqueryd_tpu.obs.metrics",
                                port_metrics)
    return use


REGISTRY_CASES = [
    "test_counter_and_gauge_render",
    "test_gauge_callback_failure_is_nan_not_crash",
    "test_histogram_buckets_cumulative_and_sum",
    "test_histogram_family_labels",
    "test_merge_histogram_snapshots_vector_add",
    "test_merge_histogram_snapshots_rejects_mismatched_buckets",
    "test_registry_counters_dict_compat",
    "test_registry_lint_clean_and_violations",
]

FORENSIC_CASES = [
    "test_flight_recorder_entry_bound_and_tail",
    "test_flight_recorder_byte_bound",
    "test_flight_recorder_events_are_json_safe",
    "test_approx_json_bytes_tracks_size",
    "test_redact_paths_outside_data_root",
    "test_redact_paths_redacts_dict_keys",
    "test_redact_paths_allows_prefix_not_substring",
    "test_build_bundle_schema_partial_and_roundtrip",
    "test_build_bundle_redacts_foreign_paths",
    "test_registry_register_adopts_shared_instance",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", REGISTRY_CASES)
def test_reference_registry_case(case, pkg, on_package):
    on_package(pkg)
    getattr(ref_obs, case)()


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", FORENSIC_CASES)
def test_reference_forensic_case(case, pkg, on_package):
    on_package(pkg)
    getattr(ref_forensics, case)()


# -- one sequence of operations, both packages ---------------------------------

def _drive_registry(mod):
    """Fill a registry through every kind of metric; returns it."""
    reg = mod.MetricsRegistry()
    c = reg.counter("bqueryd_tpu_things_total", "things seen")
    c.inc()
    c.inc(2.5)
    reg.counter("bqueryd_tpu_answers_total", "answers",
                labels={"source": "rollup"}).inc()
    reg.counter("bqueryd_tpu_answers_total", "answers",
                labels={"source": 'odd"quote\\'}).inc(3)
    g = reg.gauge("bqueryd_tpu_depth", "queue depth")
    g.set(4)
    g.inc(2)
    g.dec(0.5)
    reg.gauge("bqueryd_tpu_live", "callback", fn=lambda: 7)
    reg.gauge("bqueryd_tpu_broken", "callback raising", fn=lambda: 1 / 0)
    for labels in ({"phase": "kernel"}, {"phase": "merge"}, None):
        h = reg.histogram("bqueryd_tpu_phase_seconds", "per phase",
                          labels=labels)
        for v in (0.0, 0.0001, 0.00011, 0.3, 61.0, 1e9):
            h.observe(v)
    sizes = reg.histogram("bqueryd_tpu_reply_bytes", "reply sizes",
                          buckets=mod.BYTES_BUCKETS)
    for v in (1, 256, 257, 5_000_000, 2**31):
        sizes.observe(v)
    counters = mod.RegistryCounters(reg, {"plan_pruned_shards": "pruned",
                                          "rollup_builds": "builds"})
    counters["plan_pruned_shards"] += 3
    counters["rollup_builds"] += 1
    counters["unspecced"] = 2
    return reg


def test_rendered_text_and_snapshots_match_reference():
    want, got = _drive_registry(jax_metrics), _drive_registry(port_metrics)
    assert got.render() == want.render()
    assert got.histogram_snapshot() == want.histogram_snapshot()
    assert got.lint() == want.lint()
    assert port_metrics.LATENCY_BUCKETS_S == jax_metrics.LATENCY_BUCKETS_S
    assert port_metrics.BYTES_BUCKETS == jax_metrics.BYTES_BUCKETS
    snaps = [want.histogram_snapshot(), _drive_registry(
        jax_metrics).histogram_snapshot(), {"bad": "shape"},
        {"bqueryd_tpu_phase_seconds": [{"labels": {}, "buckets": [1.0],
                                        "counts": [0, 1], "sum": 2.0}]}]
    assert (port_metrics.merge_histogram_snapshots(snaps)
            == jax_metrics.merge_histogram_snapshots(snaps))
    entry = want.histogram_snapshot()["bqueryd_tpu_phase_seconds"][0]
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert (port_metrics.quantile_from_snapshot(entry, q)
                == jax_metrics.quantile_from_snapshot(entry, q))
    for bad in ({}, {"buckets": [1.0], "counts": [0, 0]},
                {"buckets": [1.0], "counts": [1]}):
        assert port_metrics.quantile_from_snapshot(bad, 0.5) is None
        assert jax_metrics.quantile_from_snapshot(bad, 0.5) is None


def test_family_kind_clash_raises_like_reference():
    for mod in (jax_metrics, port_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("bqueryd_tpu_x", "x")
        with pytest.raises(ValueError):
            reg.gauge("bqueryd_tpu_x", "x", labels={"a": "b"})


def _drive_flight(mod):
    ring = mod.FlightRecorder(node_id="n1", capacity=6, max_bytes=1500)
    for i in range(12):
        ring.record("tick", i=i, pad="y" * (i * 20))
    ring.record("rollup_dispatch", entry="rollup:g:abc", shards=10,
                refresh=False)
    return ring


def test_flight_ring_matches_reference():
    want, got = _drive_flight(jax_flightrec), _drive_flight(port_flightrec)

    def strip(events):
        return [{k: v for k, v in e.items() if k != "ts"} for e in events]

    assert strip(got.events()) == strip(want.events())
    assert strip(got.tail(3)) == strip(want.tail(3))
    assert (got.evictions, got.nbytes, len(got)) == (
        want.evictions, want.nbytes, len(want))
    assert got.seq == want._seq


@pytest.mark.parametrize("obj", [
    None, True, 3, 2.5, "abc", b"xy", [1, "a", None], (1, 2), {1, 2},
    {"a": {"b": [1, 2.0, "c"]}, "t": ("/x/y",)}, object,
])
def test_approx_json_bytes_matches_reference(obj):
    assert (port_flightrec.approx_json_bytes(obj)
            == jax_flightrec.approx_json_bytes(obj))


def test_redaction_and_bundle_match_reference(monkeypatch):
    section = {
        "address": "tcp://127.0.0.1:14300",
        "flight": [{"kind": "work_error",
                    "error": 'File "/home/u/app/x.py", line 3'}],
        "serving": {"rollups": {"file_epochs": {"/srv/data/t.bcolz": 1}}},
        "paths": ["/srv/data/a.bcolz", "/srv/data-evil/b", "rel/c.bcolz"],
    }
    workers = {
        "w-live": {"data": {"flight": [], "device_health": {"wedged": 0}},
                   "ts": 990.0, "registered": True},
        "w-old": {"data": {"flight": []}, "ts": 100.0, "registered": False},
        "w-silent": {"data": None, "ts": None, "registered": True},
    }
    kw = dict(trace_id=None, allowed_path_prefixes=["/srv/data"], now=1000.0)
    want = jax_flightrec.build_bundle(section, workers, **kw)
    got = port_flightrec.build_bundle(section, workers, **kw)
    assert got == want
    assert got["schema"] == "bqueryd_tpu.debug_bundle/4"
    assert json.loads(json.dumps(got)) == got
    monkeypatch.setenv("BQUERYD_TPU_DEBUG_DIR", "")
    assert (port_flightrec.redact_paths(section, ["/srv/data"])
            == jax_flightrec.redact_paths(section, ["/srv/data"]))


def test_dump_bundle_writes_json(tmp_path):
    bundle = port_flightrec.build_bundle({"flight": []}, {}, now=5.0)
    path = port_flightrec.dump_bundle(bundle, role="controller",
                                      directory=str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        assert json.load(f) == bundle


def test_flight_bounds_from_env_like_reference(monkeypatch):
    monkeypatch.setenv("BQUERYD_TPU_FLIGHT_CAPACITY", "3")
    monkeypatch.setenv("BQUERYD_TPU_FLIGHT_BYTES", "not-a-number")
    for mod in (jax_flightrec, port_flightrec):
        ring = mod.FlightRecorder()
        assert ring.capacity == 3
        assert ring.max_bytes == mod.DEFAULT_MAX_BYTES


def test_kill_switch_matches_reference(monkeypatch):
    for mod in (jax_obs, port_obs):
        monkeypatch.delenv("BQUERYD_TPU_METRICS", raising=False)
        assert mod.enabled()
        monkeypatch.setenv("BQUERYD_TPU_METRICS", "0")
        assert not mod.enabled()
        monkeypatch.setenv("BQUERYD_TPU_METRICS", "1")
        mod.set_enabled(False)
        try:
            assert not mod.enabled()
        finally:
            mod.set_enabled(True)
        assert mod.enabled()


# -- the port's nodes ------------------------------------------------------------

def test_port_controller_counters_keep_reference_help_texts(tmp_path):
    from bqueryd_tpu.controller import COUNTER_SPECS as REF_SPECS
    from bqueryd_tpu_torch.controller import COUNTER_SPECS, ControllerNode

    for key, help_text in COUNTER_SPECS.items():
        assert REF_SPECS[key] == help_text, key
    assert {"rollup_builds", "rollup_refreshes",
            "rollup_evictions"} <= set(COUNTER_SPECS)
    controller = ControllerNode(
        coordination_url=f"mem://obs-{tmp_path.name}",
        loglevel=logging.WARNING, runfile_dir=str(tmp_path))
    try:
        counters = controller.counters
        assert dict(counters) == dict.fromkeys(COUNTER_SPECS, 0)
        counters["dispatched_shards"] += 2
        text = controller.metrics.render()
        assert "bqueryd_tpu_dispatched_shards_total 2" in text
        assert "bqueryd_tpu_workers_known 0" in text
        assert "bqueryd_tpu_flight_evictions 0" in text
        assert controller.metrics.lint() == []
        # the same counters through the reference's registry class give
        # the same text
        reg = jax_metrics.MetricsRegistry()
        mirror = jax_metrics.RegistryCounters(reg, REF_SPECS)
        mirror["dispatched_shards"] = 2
        for key in COUNTER_SPECS:
            name = f"bqueryd_tpu_{key}_total"
            want = [line for line in reg.render().splitlines()
                    if line.split(" ")[0] in (name,) or f" {name} " in line]
            got = [line for line in text.splitlines()
                   if line.split(" ")[0] in (name,) or f" {name} " in line]
            assert got == want, key
    finally:
        controller.socket.close()


def test_port_worker_registry_and_debug_slice(tmp_path):
    from bqueryd_tpu_torch.utils import devicehealth
    from bqueryd_tpu_torch.worker import WorkerNode

    worker = WorkerNode(coordination_url=f"mem://obs-{tmp_path.name}",
                        data_dir=str(tmp_path), loglevel=logging.WARNING,
                        device="cpu")
    try:
        text = worker.metrics.render()
        for name in ("bqueryd_tpu_backend_wedged",
                     "bqueryd_tpu_device_probes_abandoned",
                     "bqueryd_tpu_worker_uptime_seconds",
                     "bqueryd_tpu_worker_errors_total",
                     "bqueryd_tpu_flight_evictions"):
            assert f"# TYPE {name} " in text
        assert worker.metrics.lint() == []
        wrm = worker.prepare_wrm()
        debug = wrm["debug"]
        assert debug["node_id"] == worker.worker_id
        assert debug["workertype"] == "calc"
        assert debug["device_health"] == devicehealth.health_snapshot()
        assert debug["flight"] == []
        # unchanged: not sent again inside the re-send window
        assert worker.prepare_wrm()["debug"] is None
        worker.flight.record("tick")
        again = worker.prepare_wrm()["debug"]
        assert [e["kind"] for e in again["flight"]] == ["tick"]
        json.dumps(again)
    finally:
        worker.socket.close()

"""The port's serving layer (``bqueryd_tpu_torch.serve``) against the JAX
package's (``bqueryd_tpu.serve``).

* Units: the same logical plans, compiled by each package, give equal
  ``plan_view`` and ``view_key``; ``tests/test_serving.py``'s lattice,
  transform and manager cases run on both packages (the port's by swapping
  the module's ``subsume``, ``rollupmod`` and ``hostmerge``); both
  ``apply_transform`` give identical arrays on the same partials, and both
  ``RollupManager`` go through equal states for one sequence of operations.
* The port worker's ``rollup`` verb runs ``tests/test_serving.py``'s
  worker cases.
* A port controller with a port calc worker (CPU) runs
  ``tests/test_serving.py``'s six cluster cases through the port's
  ``RPC`` (its ``(order, columns)`` answer seen as a DataFrame), and a JAX
  ``RPC`` reads a served reply's provenance from a port controller.
* The provenance of a dispatched answer: "cached" when a worker's result
  cache answered, read alike by the port's and the JAX ``RPC``.

Tolerances: keys, counts and int aggregates exact.  The reference's
lattice, transform and worker cases keep their own rtol 1e-6 (they pass
there on the port too); the cluster cases and the port's own checks hold
float means to ``tests/test_differential_fuzz.py:_compare``'s rtol 2e-5,
atol 1e-6 (``_assert_parity_port``), as the port's CPU contraction sums
float32 per block over 3,000 rows.  No served query may log "serving
layer error" or "rollup fold failed", or record a "render-error"
decision.
"""

import logging
import threading

import numpy as np
import pandas as pd
import pytest

import test_serving as ref
from bqueryd_tpu import plan as jax_plan
from bqueryd_tpu.plan import dag as jax_dag
from bqueryd_tpu.serve import rollup as jax_rollup
from bqueryd_tpu.serve import subsume as jax_subsume
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
import bqueryd_tpu_torch
from bqueryd_tpu_torch import messages
from bqueryd_tpu_torch import plan as port_plan
from bqueryd_tpu_torch.parallel import hostmerge as port_hostmerge
from bqueryd_tpu_torch.plan import dag as port_dag
from bqueryd_tpu_torch.serve import rollup as port_rollup
from bqueryd_tpu_torch.serve import subsume as port_subsume
from tests.conftest import wait_until
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6
QUIET = logging.WARNING
RPC_TIMEOUT = 30
PACKAGES = ("jax", "port")


@pytest.fixture
def on_package(monkeypatch):
    """``on_package("port")`` points ``tests/test_serving.py``'s lattice,
    manager and merge modules at the port's; "jax" leaves them."""
    def use(pkg):
        if pkg == "port":
            monkeypatch.setattr(ref, "subsume", port_subsume)
            monkeypatch.setattr(ref, "rollupmod", port_rollup)
            monkeypatch.setattr(ref, "hostmerge", port_hostmerge)
    return use


# -- units: plan views --------------------------------------------------------

GROUPBY_PLANS = [
    (["t.bcolzs"], ["g"], [["v", "sum", "vs"]], [["seq", ">", 5]], {}),
    (["a.bcolzs", "b.bcolzs"], ["g", "g2"],
     [["v", "sum", "vs"], ["f", "mean", "fm"], ["v", "count", "n"]],
     [], {}),
    (["t.bcolzs"], [], [["v", "max", "vx"]], [["g", "in", [1, 2]]], {}),
    (["t.bcolzs"], ["g"], [["v", "count_distinct", "vd"]], [], {}),
    (["t.bcolzs"], ["g"], [["v", "sum", "vs"]], [],
     {"aggregate": False}),
    (["t.bcolzs"], ["g"], [["v", "sum", "vs"]], [["s", "==", "1"]],
     {"expand_filter_column": "g2"}),
]

DAG_SPECS = [
    {"table": ["t.bcolzs"],
     "groupby": [{"window": {"on": "ts", "every": "1h", "alias": "h"}}],
     "aggs": [["v", "sum", "vs"]]},
    {"table": ["a.bcolzs", "b.bcolzs"],
     "groupby": ["g", {"window": {"on": "ts", "every": "30m"}}],
     "aggs": [["v", "sum", "vs"], ["f", "mean", "fm"]],
     "where": [["seq", ">", 3]]},
    {"table": ["t.bcolzs"], "groupby": ["region"],
     "aggs": [["v", "sum", "vs"]],
     "join": {"table": {"g": np.arange(5), "region": np.arange(5) % 2},
              "on": "g", "select": ["region"]}},
    {"table": ["t.bcolzs"], "groupby": ["g"],
     "aggs": [["v", "topk", "t3", {"k": 3}]]},
]


def _views(plans):
    views = [(jax_subsume.plan_view(j), port_subsume.plan_view(p))
             for j, p in plans]
    for want, got in views:
        assert got == want
        assert port_subsume.view_key(got) == jax_subsume.view_key(want)
        assert (port_subsume.plan_eligible(got)
                == jax_subsume.plan_eligible(want))
    return views


@pytest.mark.parametrize("case", range(len(GROUPBY_PLANS)))
def test_plan_view_and_key_match_reference(case):
    files, keys, aggs, where, kw = GROUPBY_PLANS[case]
    args = dict(aggregate=kw.get("aggregate", True),
                expand_filter_column=kw.get("expand_filter_column"))
    _views([(jax_plan.plan_groupby(files, keys, aggs, where, **args),
             port_plan.plan_groupby(files, keys, aggs, where, **args))])


@pytest.mark.parametrize("case", range(len(DAG_SPECS)))
def test_dag_plan_view_and_key_match_reference(case):
    spec = DAG_SPECS[case]
    (want, got), = _views([
        (jax_dag.groupby_equivalent(jax_dag.compile_query(spec))[0],
         port_dag.groupby_equivalent(port_dag.compile_query(spec))[0])])
    assert got["dag_sig"] is not None


def test_dag_signature_layout_pins_join_and_window():
    """``serve/subsume.py`` reads the join at index 6 and the window at
    index 7 of ``OperatorDAG.signature()``, in both packages."""
    spec = {"table": ["t.bcolzs"],
            "groupby": ["region", {"window": {"on": "ts", "every": "1h",
                                              "alias": "h"}}],
            "aggs": [["v", "sum", "vs"]],
            "join": {"table": {"g": np.arange(3), "region": np.arange(3)},
                     "on": "g", "select": ["region"]}}
    hour = 3_600_000_000_000
    for dagmod, subsume in ((port_dag, port_subsume),
                            (jax_dag, jax_subsume)):
        assert (subsume._DAG_JOIN_IDX, subsume._DAG_WINDOW_IDX) == (6, 7)
        dag = dagmod.compile_query(spec)
        sig = dag.signature()
        assert sig[subsume._DAG_JOIN_IDX][:2] == ("g", "g")
        assert sig[subsume._DAG_WINDOW_IDX] == ("ts", hour, "h", 0)
        plain = dagmod.compile_query({k: v for k, v in spec.items()
                                      if k != "join"})
        plain_sig = plain.signature()
        assert plain_sig[subsume._DAG_JOIN_IDX] is None
        assert plain_sig[subsume._DAG_WINDOW_IDX] == ("ts", hour, "h", 0)
    assert len(port_dag.compile_query(spec).signature()) == len(
        jax_dag.compile_query(spec).signature())


# -- units: the reference's lattice and manager cases, on both packages -------

LATTICE_CASES = [
    "test_plan_eligibility_refusals",
    "test_match_exact_and_filename_refusal",
    "test_key_fold_match_and_null_refusal",
    "test_agg_projection_and_missing_agg",
    "test_zone_proof_filter_match_and_partial_refusal",
    "test_zone_full_select_table",
    "test_window_fold_alignment_rules",
    "test_choose_source_prefers_cheapest_and_refuses_tiny_tables",
    "test_collapse_partials_passthrough_and_exact",
    "test_heat_threshold_decays",
    "test_entry_lifecycle_ready_stale_refresh",
    "test_append_racing_a_build_never_serves",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", LATTICE_CASES)
def test_reference_lattice_and_manager_case(case, pkg, on_package):
    on_package(pkg)
    getattr(ref, case)()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reference_sweep_case(pkg, on_package, monkeypatch):
    on_package(pkg)
    ref.test_sweep_caps_and_build_timeout(monkeypatch)


TRANSFORM_CASES = [
    "test_apply_transform_key_fold_parity",
    "test_apply_transform_agg_projection_parity",
    "test_apply_transform_window_refloor_parity",
    "test_apply_transform_window_preserves_datetime_dtype",
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", TRANSFORM_CASES)
def test_reference_transform_case(case, pkg, on_package, tmp_path):
    """The partials come from the JAX engine in both runs; the transform
    and the merge are the package's."""
    on_package(pkg)
    getattr(ref, case)(tmp_path)


def _partials(tmp_path, df, keys, aggs):
    return ref._partials(tmp_path, df, keys, aggs)


def _same_payload(got, want):
    """Equal payload dicts: every array with its dtype and values."""
    assert set(got) == set(want)
    for field in ("kind", "key_cols", "ops", "out_cols", "value_kinds"):
        assert got.get(field) == want.get(field), field
    assert list(got["keys"]) == list(want["keys"])
    for col in want["keys"]:
        a, b = np.asarray(got["keys"][col]), np.asarray(want["keys"][col])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    assert len(got["aggs"]) == len(want["aggs"])
    for g, w in zip(got["aggs"], want["aggs"]):
        assert set(g) == set(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)


def _transform_inputs(tmp_path):
    minute, hour = 60_000_000_000, 3_600_000_000_000
    df = ref._frame(2000, seed=3)
    aggs = [["v", "sum", "vs"], ["f", "mean", "fm"], ["v", "min", "vmin"],
            ["v", "count", "n"]]
    fine = _partials(tmp_path, df, ["g", "g2"], aggs)
    n = 1500
    rng = np.random.RandomState(7)
    wdf = pd.DataFrame({
        "b": (np.arange(n, dtype=np.int64) * minute // 7) // minute * minute,
        "v": rng.randint(-50, 50, n).astype(np.int64),
    })
    window = _partials(tmp_path, wdf, ["b"], [["v", "sum", "vs"]])
    dt = dict(window)
    dt["keys"] = dict(dt["keys"])
    dt["keys"]["b"] = np.asarray(dt["keys"]["b"],
                                 dtype=np.int64).view("datetime64[ns]")
    return [
        (fine, {"kind": "fold", "keys": ("g",)}),
        (fine, {"kind": "fold", "aggs": (1, 3)}),
        (fine, {"kind": "fold", "keys": ("g2",), "aggs": (2,)}),
        (window, {"kind": "fold", "window": ("b", hour, 0)}),
        (dt, {"kind": "fold", "window": ("b", hour, 0)}),
        (dt, {"kind": "fold", "window": ("b", 4 * hour, 2 * minute)}),
        (fine, {"kind": "exact"}),
    ]


def test_apply_transform_arrays_match_reference(tmp_path):
    for payload, transform in _transform_inputs(tmp_path):
        want = jax_subsume.apply_transform(payload, transform)
        got = port_subsume.apply_transform(payload, transform)
        _same_payload(got, want)
        if transform["kind"] == "fold" and "window" in transform:
            assert np.asarray(got["keys"]["b"]).dtype == np.asarray(
                payload["keys"]["b"]).dtype


@pytest.mark.parametrize("total_rows", [0, 40, 5_000, 1_000_000])
def test_choose_source_matches_reference(total_rows):
    matches = [
        ("rollup:a", {"kind": "exact"}, 5_000),
        ("rollup:b", {"kind": "fold"}, 50),
        ("rollup:c", {"kind": "zone"}, 50),
        ("rollup:d", {"kind": "fold"}, 0),
    ]
    for k in range(len(matches) + 1):
        assert (port_subsume.choose_source(matches[:k], total_rows)
                == jax_subsume.choose_source(matches[:k], total_rows))
    for groups in (0, 1, 50, 5_000, 10**7):
        assert (port_subsume.serving_cost(groups, 1)
                == jax_subsume.serving_cost(groups, 1))
        assert (port_subsume.recompute_cost(groups, 3)
                == jax_subsume.recompute_cost(groups, 3))


def _manager_steps(info):
    """One sequence of RollupManager operations: (name, call)."""
    va = ref._view(filenames=("a.bcolzs", "b.bcolzs"))
    vb = ref._view(keys=("g", "g2"), filenames=("a.bcolzs",))
    spec = {"args": [["g"], [["v", "sum", "vs"]], []], "dag_wire": None}
    return [
        ("q1", lambda m: m.note_query("k1", va, spec, 0.0)),
        ("q2", lambda m: m.note_query("k1", va, spec, 10.0)),
        ("q3", lambda m: m.note_query("k1", va, spec, 20.0)),
        ("q4", lambda m: m.note_query("k1", va, spec, 30.0)),
        ("b1", lambda m: m.start_build("k1", 30.0) is not None),
        ("b1again", lambda m: m.start_build("k1", 31.0)),
        ("a1", lambda m: m.absorb("k1", "a.bcolzs", dict(info), 32.0)),
        ("race", lambda m: m.note_append("b.bcolzs", 33.0)),
        ("a2", lambda m: m.absorb("k1", "b.bcolzs", dict(info), 34.0)),
        ("cand0", lambda m: [e.key for e in m.candidates(
            ("a.bcolzs", "b.bcolzs"))]),
        ("stale", lambda m: m.stale_keys()),
        ("refresh", lambda m: sorted(m.begin_refresh("k1", 35.0)[1])),
        ("r1", lambda m: m.absorb("k1", "a.bcolzs", dict(info), 36.0)),
        ("r2", lambda m: m.absorb("k1", "b.bcolzs", dict(info), 36.0)),
        ("cand1", lambda m: [e.key for e in m.candidates(
            ("a.bcolzs", "b.bcolzs"))]),
        ("hit", lambda m: m.note_hit("k1", 40.0)),
        ("qb", lambda m: [m.note_query("k2", vb, spec, 41.0 + i)
                          for i in range(4)]),
        ("b2", lambda m: m.start_build("k2", 45.0) is not None),
        ("a3", lambda m: m.absorb("k2", "a.bcolzs", dict(info), 46.0)),
        ("append_a", lambda m: m.note_append("a.bcolzs", 47.0)),
        ("unknown", lambda m: m.absorb("nope", "a.bcolzs", dict(info), 48.0)),
        ("sweep", lambda m: m.sweep(49.0)),
        ("fail", lambda m: m.fail("k2") is not None),
        ("sweep_late", lambda m: m.sweep(49.0 + port_rollup.BUILD_TIMEOUT_S)),
    ]


@pytest.mark.parametrize("cap", [None, "1", "0"])
def test_rollup_manager_state_sequences_match_reference(cap, monkeypatch):
    if cap is not None:
        monkeypatch.setenv("BQUERYD_TPU_ROLLUP_MAX", cap)
    monkeypatch.setenv("BQUERYD_TPU_ROLLUP_HEAT_HALFLIFE_S", "60")
    info = {"data": b"x" * 10, "payload": {}, "base": b"b", "zones": {},
            "groups": 4, "mode": "rebuild"}
    want_mgr, got_mgr = jax_rollup.RollupManager(), port_rollup.RollupManager()
    for name, call in _manager_steps(info):
        want, got = call(want_mgr), call(got_mgr)
        assert got == want, name
        assert got_mgr.snapshot() == want_mgr.snapshot(), name


def test_rollup_env_defaults_match_reference(monkeypatch):
    for name in ("BQUERYD_TPU_ROLLUP_MAX", "BQUERYD_TPU_ROLLUP_HEAT_MIN",
                 "BQUERYD_TPU_ROLLUP_HEAT_HALFLIFE_S",
                 "BQUERYD_TPU_ROLLUP_CACHE_BYTES"):
        monkeypatch.delenv(name, raising=False)
    for fn in ("rollup_max", "heat_min", "heat_halflife_s", "cache_bytes"):
        assert getattr(port_rollup, fn)() == getattr(jax_rollup, fn)()
    assert (port_rollup.rollup_max(), port_rollup.heat_min(),
            port_rollup.heat_halflife_s(), port_rollup.cache_bytes()) == (
        16, 3.0, 300.0, 256 * 1024 * 1024)
    assert port_rollup.BUILD_TIMEOUT_S == jax_rollup.BUILD_TIMEOUT_S


# -- the port worker's rollup verb -----------------------------------------------

def _port_worker(tmp_path, _store_url=None):
    from bqueryd_tpu_torch.worker import WorkerNode

    return WorkerNode(coordination_url=f"mem://serve-{tmp_path.name}",
                      data_dir=str(tmp_path), loglevel=QUIET, device="cpu")


_REF_ROLLUP_MSG = ref._rollup_msg


def _port_rollup_msg(*args, **kwargs):
    """``tests/test_serving.py``'s rollup message, parsed by the port."""
    return messages.msg_factory(_REF_ROLLUP_MSG(*args, **kwargs).to_json())


def _assert_parity_port(got, expected, keys=("g",)):
    """``tests/test_serving.py``'s parity check at the port's tolerance:
    the port's CPU contraction sums float32 per block, so a float mean
    is held to rtol 2e-5, atol 1e-6 (``_compare``'s) instead of 1e-6."""
    got = ref._sorted(got, list(keys))
    np.testing.assert_array_equal(got["vs"], expected["vs"])
    np.testing.assert_allclose(got["fm"].to_numpy(),
                               expected["fm"].to_numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [
    "test_worker_rollup_build_census_and_parity",
    "test_worker_rollup_refresh_delta_and_fresh",
])
def test_reference_worker_case_on_port_worker(case, tmp_path, mem_store_url,
                                              monkeypatch):
    monkeypatch.setattr(ref, "_worker_for", _port_worker)
    monkeypatch.setattr(ref, "_rollup_msg", _port_rollup_msg)
    getattr(ref, case)(tmp_path, mem_store_url)


def test_port_worker_records_rollup_builds_in_its_flight_ring(tmp_path):
    df = ref._frame(600, seed=5)
    jax_ctable.fromdataframe(df, str(tmp_path / "t.bcolzs"), chunklen=256)
    worker = _port_worker(tmp_path)
    try:
        reply = worker.handle_work(_port_rollup_msg("t.bcolzs"))
        base = reply.get_from_binary("rollup_base")
        worker.handle_work(_port_rollup_msg(
            "t.bcolzs", prior=reply["data"], base=base))
        builds = [e for e in worker.flight.events()
                  if e["kind"] == "rollup_build"]
        assert [e["mode"] for e in builds] == ["rebuild", "fresh"]
        assert builds[0]["filename"] == "t.bcolzs"
        assert builds[0]["bytes"] == len(reply["data"])
        assert builds[0]["token"] == "rollup_test"
    finally:
        worker.socket.close()


# -- a port cluster -------------------------------------------------------------

class _Failures(logging.Handler):
    """Collects the serving layer's internal-error log records."""

    TEXTS = ("serving layer error", "rollup fold failed")

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        if any(t in record.getMessage() for t in self.TEXTS):
            self.records.append(record.getMessage())


class FrameRPC:
    """The port's ``RPC`` with its ``(order, columns)`` answers as the
    DataFrames ``tests/test_serving.py`` reads."""

    def __init__(self, rpc):
        self._rpc = rpc

    def groupby(self, *args, **kwargs):
        order, cols = self._rpc.groupby(*args, **kwargs)
        return pd.DataFrame({c: cols[c] for c in order}, columns=order)

    def __getattr__(self, name):
        return getattr(self._rpc, name)


@pytest.fixture(scope="module")
def loopback():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        yield


def _cluster(tmp_path, monkeypatch, serve="1", result_cache=None):
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.worker import WorkerNode

    monkeypatch.setenv("BQUERYD_TPU_SERVE", serve)
    monkeypatch.setenv("BQUERYD_TPU_ROLLUP_HEAT_MIN", "1")
    if result_cache is not None:
        monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", result_cache)
    df = ref._frame(3000, seed=21)
    jax_ctable.fromdataframe(df, str(tmp_path / "t.bcolzs"), chunklen=256)
    url = f"file://{tmp_path / 'store'}"
    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=str(tmp_path),
                                heartbeat_interval=0.1)
    worker = WorkerNode(coordination_url=url, data_dir=str(tmp_path),
                        loglevel=QUIET, heartbeat_interval=0.1,
                        poll_timeout=0.05, device="cpu")
    return controller, worker, df, url


@pytest.fixture
def port_serving_cluster(loopback, tmp_path, monkeypatch):
    """``tests/test_serving.py``'s ``serving_cluster`` on port nodes: a port
    controller and a port calc worker on the CPU over one 3,000-row shard,
    serving on, the heat threshold at 1, found through a file:// store."""
    from bqueryd_tpu_torch.rpc import RPC

    controller, worker, df, url = _cluster(tmp_path, monkeypatch)
    failures = _Failures()
    bqueryd_tpu_torch.logger.addHandler(failures)
    nodes = [controller, worker]
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    rpc = None
    try:
        def _stats_known():
            stats = controller.shard_stats.get("t.bcolzs") or {}
            if stats.get("rows") == 3000:
                return True
            worker._stats_sent_ts = 0.0
            return False

        wait_until(_stats_known, desc="shard stats advertisement")
        # the stats may ride a liveness WRM of a worker adopted from its
        # heartbeat thread before its loop's own WRM lists its files
        wait_until(lambda: "t.bcolzs" in controller.files_map
                   and not controller.worker_map.get(
                       worker.worker_id, {}).get("hb_only"),
                   desc="the worker's own registration")
        rpc = RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
                  loglevel=QUIET)
        yield {"rpc": FrameRPC(rpc), "controller": controller,
               "worker": worker, "df": df, "tmp_path": tmp_path, "url": url}
        assert failures.records == []
        assert not any(r[1] == "render-error"
                       for d in controller.serving.decisions
                       for r in d["rejected"])
    finally:
        bqueryd_tpu_torch.logger.removeHandler(failures)
        if rpc is not None:
            rpc._close_socket()
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)


CLUSTER_CASES = [
    "test_rollup_materializes_and_serves",
    "test_key_fold_and_zone_subsumption_end_to_end",
    "test_append_invalidates_then_delta_refreshes",
    "test_kill_switch_restores_dispatch_path",
    "test_mixed_version_worker_degrades_to_recompute",
    "test_debug_bundle_serving_section_and_flight_events",
]


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_reference_cluster_case_on_port_nodes(case, port_serving_cluster,
                                              monkeypatch):
    monkeypatch.setattr(ref, "_assert_parity", _assert_parity_port)
    fn = getattr(ref, case)
    if case in ("test_kill_switch_restores_dispatch_path",
                "test_mixed_version_worker_degrades_to_recompute"):
        fn(port_serving_cluster, monkeypatch)
    else:
        fn(port_serving_cluster)


def test_served_answer_dispatches_nothing_and_records_its_path(
        port_serving_cluster):
    c = port_serving_cluster
    rpc, controller = c["rpc"], c["controller"]
    rpc.groupby(*ref.Q)
    wait_until(lambda: ref._ready_keys(controller), desc="materialization")
    key = ref._ready_keys(controller)[0]
    dispatched = controller.counters["dispatched_shards"]
    worker_msgs = c["worker"].msg_count
    got = rpc.groupby(*ref.Q)
    served_trace = rpc.last_trace_id
    assert rpc.last_call_answer_source == "rollup"
    assert rpc.last_call_subsumed_from == key
    assert controller.counters["dispatched_shards"] == dispatched
    assert c["worker"].msg_count == worker_msgs
    assert rpc.last_call_strategies == {"hints": {}, "effective": {}}
    _assert_parity_port(got, ref._expected(c["df"]))
    metrics = rpc.metrics()
    assert 'bqueryd_tpu_serve_answers_total{source="rollup"} 1' in metrics
    assert "bqueryd_tpu_rollup_builds_total 1" in metrics
    assert controller.metrics.lint() == []
    assert c["worker"].metrics.lint() == []
    # the worker's slice of the bundle: its flight tail and device health
    wait_until(lambda: any(
        e["kind"] == "rollup_build"
        for e in (controller._worker_debug.get(c["worker"].worker_id)
                  or {"data": {"flight": []}})["data"]["flight"]),
        desc="worker slice with the rollup build")
    bundle = rpc.debug_bundle()
    slice_ = bundle["workers"][c["worker"].worker_id]["snapshot"]
    assert slice_["device_health"]["wedged"] == 0
    assert {"envelope", "rollup_build", "work_done"} <= {
        e["kind"] for e in slice_["flight"]}
    section = bundle["controller"]
    # the observability sections, the served answer's trace the newest
    assert {"trace", "autopsy", "slow_queries", "worker_histograms",
            "runtime", "compile_cache", "slo", "timeline_ring",
            "capacity"} <= set(section)
    assert section["trace"]["trace_id"] == served_trace
    assert section["trace"]["answer_source"] == "rollup"
    assert {"address", "node", "uptime_s", "flight", "flight_evictions",
            "counters", "admission", "workers_known", "inflight", "metrics",
            "calibration", "batch_window", "serving", "health",
            "chaos", "replication"} <= set(section)
    assert section["counters"]["rollup_builds"] == 1
    kinds = [e["kind"] for e in section["flight"]]
    assert "dispatch" in kinds and "rollup_dispatch" in kinds


def test_reference_rpc_reads_a_port_served_reply(port_serving_cluster):
    """A JAX ``RPC`` against a port controller: a dispatched, then a served
    answer with its provenance pair, equal to the port ``RPC``'s."""
    from bqueryd_tpu.rpc import RPC as JaxRPC

    c = port_serving_cluster
    controller = c["controller"]
    client = JaxRPC(coordination_url=c["url"], timeout=RPC_TIMEOUT,
                    retries=1, loglevel=QUIET)
    try:
        first = client.groupby(*ref.Q)
        assert client.last_call_answer_source in ("recompute", "cached")
        assert client.last_call_subsumed_from is None
        wait_until(lambda: ref._ready_keys(controller),
                   desc="materialization")
        served = client.groupby(*ref.Q)
        assert client.last_call_answer_source == "rollup"
        assert client.last_call_subsumed_from == ref._ready_keys(
            controller)[0]
        expected = ref._expected(c["df"])
        _assert_parity_port(first, expected)
        _assert_parity_port(served, expected)
        port_served = c["rpc"].groupby(*ref.Q)
        assert c["rpc"].last_call_answer_source == "rollup"
        port_served = ref._sorted(port_served, ["g"])
        served = ref._sorted(served, ["g"])
        assert list(port_served.columns) == list(served.columns)
        for col in served.columns:
            assert port_served[col].dtype == served[col].dtype
            np.testing.assert_array_equal(port_served[col], served[col])
        # the bundle reads alike
        assert client.debug_bundle()["schema"] == "bqueryd_tpu.debug_bundle/4"
    finally:
        client._close_socket()


# -- the provenance of a dispatched answer ------------------------------------

@pytest.fixture
def cached_cluster(loopback, tmp_path, monkeypatch):
    """A port cluster with serving off and the worker's result cache on."""
    controller, worker, df, url = _cluster(
        tmp_path, monkeypatch, serve="0", result_cache=str(64 * 1024**2))
    nodes = [controller, worker]
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    try:
        wait_until(lambda: "t.bcolzs" in controller.files_map,
                   desc="shard advertised")
        yield {"controller": controller, "df": df, "url": url}
    finally:
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=10)


def test_result_cache_answer_reads_cached_in_both_clients(cached_cluster):
    """The same groupby twice: the second is answered from the worker's
    result cache, and the port's and the JAX ``RPC`` read "cached"."""
    from bqueryd_tpu.rpc import RPC as JaxRPC
    from bqueryd_tpu_torch.rpc import RPC

    c = cached_cluster
    rpc = RPC(coordination_url=c["url"], timeout=RPC_TIMEOUT, retries=1,
              loglevel=QUIET)
    client = JaxRPC(coordination_url=c["url"], timeout=RPC_TIMEOUT,
                    retries=1, loglevel=QUIET)
    try:
        first = FrameRPC(rpc).groupby(*ref.Q)
        assert rpc.last_call_answer_source == "recompute"
        assert rpc.last_call_subsumed_from is None
        second = FrameRPC(rpc).groupby(*ref.Q)
        assert rpc.last_call_strategies["effective"] == {"t.bcolzs": "cached"}
        assert rpc.last_call_answer_source == "cached"
        third = client.groupby(*ref.Q)
        assert client.last_call_answer_source == "cached"
        assert client.last_call_subsumed_from is None
        expected = ref._expected(c["df"])
        for got in (first, second, third):
            _assert_parity_port(got, expected)
        text = rpc.metrics()
        assert 'bqueryd_tpu_serve_answers_total{source="recompute"} 1' in text
        assert 'bqueryd_tpu_serve_answers_total{source="cached"} 2' in text
    finally:
        rpc._close_socket()
        client._close_socket()


# -- the controller's rollup wire, without a worker ----------------------------

@pytest.fixture
def bare_controller(tmp_path, monkeypatch):
    """A port controller that never runs its loop, with one registered
    calc worker ``w1`` holding ``t.bcolzs``; serving on."""
    from bqueryd_tpu_torch.controller import ControllerNode

    monkeypatch.setenv("BQUERYD_TPU_SERVE", "1")
    controller = ControllerNode(
        coordination_url=f"mem://serving-{tmp_path.name}", loglevel=QUIET,
        runfile_dir=str(tmp_path))
    sent = []
    controller.socket.send_multipart = sent.append
    controller.worker_map["w1"] = {"worker_id": "w1", "workertype": "calc",
                                   "busy": True}
    controller.files_map["t.bcolzs"] = {"w1"}
    try:
        yield controller, sent
    finally:
        controller.socket.close()


def _building_entry(controller):
    mgr = controller.serving.manager
    spec = {"args": [["g"], [["v", "sum", "vs"]], []], "dag_wire": None}
    for _ in range(3):
        mgr.note_query("k", ref._view(), spec, 0.0)
    return mgr.start_build("k", 0.0)


def test_removed_holder_fails_its_queued_rollup_build(bare_controller):
    controller, sent = bare_controller
    entry = _building_entry(controller)
    controller._dispatch_rollup_build(entry)
    (token, waiter), = controller._rollup_waiters.items()
    assert waiter == ("k", "t.bcolzs") and token.startswith("rollup_")
    (msg,) = controller.worker_out_messages["w1"]
    assert msg.isa("rollup") and msg["worker_id"] == "w1"
    assert "target" not in msg
    controller.dispatch_pending()  # w1 is busy: the build waits
    assert sent == [] and controller.worker_out_messages["w1"] == [msg]
    controller.remove_worker("w1")
    assert controller.serving.manager.entries == {}
    assert controller._rollup_waiters == {}
    kinds = [e["kind"] for e in controller.flight.events()]
    assert kinds[:2] == ["rollup_dispatch", "worker_removed"]
    failed = [e for e in controller.flight.events()
              if e["kind"] == "rollup_build_failed"]
    assert [(e["entry"], e["reason"]) for e in failed] == [
        ("k", "holder removed")]
    controller.dispatch_pending()  # the removed worker's queue is gone
    assert not any(controller.worker_out_messages.values()) and sent == []


def test_rollup_without_holder_and_orphaned_reply(bare_controller):
    from bqueryd_tpu_torch.messages import ErrorMessage

    controller, sent = bare_controller
    entry = _building_entry(controller)
    controller.files_map.clear()
    controller._dispatch_rollup_build(entry)
    assert controller.serving.manager.entries == {}
    assert not any(controller.worker_out_messages.values())
    assert controller._rollup_waiters == {}
    # a late reply of a retired build: recorded, never forwarded
    orphan = ErrorMessage({"token": "rollup_0123", "payload": "boom"})
    controller.process_worker_result(orphan)
    assert sent == []
    kinds = [e["kind"] for e in controller.flight.events()]
    assert kinds == ["rollup_build_failed", "rollup_reply_orphaned"]


def test_dispatch_flight_event_obeys_the_metrics_kill_switch(
        bare_controller, monkeypatch):
    from bqueryd_tpu_torch.messages import CalcMessage

    controller, sent = bare_controller
    controller.worker_map["w1"]["busy"] = False
    for value in ("1", "0"):
        monkeypatch.setenv("BQUERYD_TPU_METRICS", value)
        msg = CalcMessage({"payload": "groupby", "token": f"t{value}",
                           "filename": "t.bcolzs"})
        controller._send_to_worker("w1", msg)
    events = [e for e in controller.flight.events()
              if e["kind"] == "dispatch"]
    assert [(e["token"], e["worker"], e["verb"], e["filename"])
            for e in events] == [("t1", "w1", "groupby", "t.bcolzs")]
    assert len(sent) == 2 and controller.counters["dispatched_shards"] == 2

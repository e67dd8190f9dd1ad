"""The port's strategy selection (``plan/strategy.py``) and measured-cost
calibration (``plan/calibrate.py``) against the JAX package's.

Seeded sequences of records, gossip and decisions run through both
packages' stores and selectors and must decide alike at every step; the
port's controller carries hints and absorbs gossip as
``tests/test_plan.py`` and ``tests/test_calibration.py`` hold the
reference's to; the port's executor and engine record samples under the
``"cpu"`` backend tag here (``"cuda"`` on the card); and a hint crosses
between the packages in both directions.
"""

import logging
import os

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.plan import calibrate as jax_calibrate
from bqueryd_tpu.plan import strategy as jax_strategy
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch.plan import calibrate
from bqueryd_tpu_torch.plan import strategy
from test_calibration import shard_stats, warm
from test_torch_admission import (  # noqa: F401
    controller,
    groupby_msg,
    new_controller,
    queued,
    register,
)

QUIET = logging.WARNING
CPU = "cpu"
STRATS = ("matmul", "scatter", "sort", "host")


@pytest.fixture(autouse=True)
def _fresh_stores():
    calibrate._reset_for_tests()
    jax_calibrate._reset_for_tests()
    yield
    calibrate._reset_for_tests()


# -- plan/strategy.py ---------------------------------------------------------

def _random_stats(rng, n_files):
    stats = {}
    for i in range(n_files):
        if rng.random() < 0.05:
            stats[f"s{i}"] = "garbage"
            continue
        cols = {}
        for col in ("a", "b", "c"):
            if rng.random() < 0.05:
                continue
            lo = int(rng.integers(0, 1000))
            cols[col] = {"kind": "numeric", "min": lo,
                         "max": lo + int(rng.integers(0, 1000)),
                         "card": int(rng.choice([1, 2, 9, 265, 9000,
                                                  70_000, 2_000_000]))}
        stats[f"s{i}"] = {"rows": int(rng.choice([0, 1000, 10**6, 10**7,
                                                   10**9])),
                          "cols": cols}
    return stats


@pytest.mark.parametrize("env", [{}, {"BQUERYD_TPU_MATMUL_GROUPS": "300"},
                                 {"BQUERYD_TPU_MATMUL_CELLS": "1000000"}])
@pytest.mark.parametrize("seed", range(4))
def test_heuristic_selection_matches_reference(monkeypatch, env, seed):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(seed)
    for _ in range(60):
        stats = _random_stats(rng, int(rng.integers(1, 5)))
        files = list(stats) + (["missing"] if rng.random() < 0.1 else [])
        cols = list(rng.choice(["a", "b", "c"], int(rng.integers(1, 3)),
                               replace=False))
        assert strategy.select_for_group(stats, files, cols) == (
            jax_strategy.select_for_group(stats, files, cols))
        ok = [s for s in stats.values() if isinstance(s, dict)]
        assert strategy.estimate_groups(ok, cols) == (
            jax_strategy.estimate_groups(ok, cols))
        rows, est = int(rng.integers(0, 10**9)), int(rng.integers(0, 10**7))
        assert strategy.choose_strategy(rows, est) == (
            jax_strategy.choose_strategy(rows, est))
        assert strategy.candidate_strategies(rows, est) == (
            jax_strategy.candidate_strategies(rows, est))
    assert strategy.STRATEGIES == jax_strategy.STRATEGIES


# -- plan/calibrate.py: identical sequences -----------------------------------

def _sequence(seed, n_steps=300):
    """A seeded sequence of store operations over a few buckets."""
    rng = np.random.default_rng(seed)
    buckets = [(10_000_000, 9), (1_000_000, 265), (10_000_000, 70_000),
               (1_000_000, 4), (2_000_000, 2_000_000)]
    steps = []
    for _ in range(n_steps):
        rows, groups = buckets[int(rng.integers(len(buckets)))]
        r = rng.random()
        if r < 0.5:
            steps.append(("record", rows, groups,
                          str(rng.choice(["int", "f32", "f64"])),
                          str(rng.choice(["cpu", "cuda", "host"])),
                          str(rng.choice(STRATS + ("bogus",))),
                          float(rng.choice([rng.random() * 0.1, 0.0, -1.0,
                                            np.nan]))
                          if rng.random() < 0.05 else
                          float(rng.random() * 0.1 + 1e-4)))
        elif r < 0.8:
            heuristic = jax_strategy.choose_strategy(rows, groups)
            steps.append(("choose", rows, groups,
                          None if rng.random() < 0.7 else "int",
                          jax_strategy.candidate_strategies(rows, groups),
                          heuristic))
        elif r < 0.9:
            steps.append(("select", rows, groups))
        else:
            steps.append(("gossip", int(rng.integers(3)), int(rng.integers(
                1, 6)), rows, groups, str(rng.choice(STRATS)),
                float(rng.random() * 0.1 + 1e-4)))
    return steps


def _run_sequence(cal, strat, steps):
    store = cal.CalibrationStore()
    out = []
    for step in steps:
        kind = step[0]
        if kind == "record":
            store.record(*step[1:])
            out.append(store.stats())
        elif kind == "choose":
            out.append(store.choose(*step[1:]))
        elif kind == "select":
            _k, rows, groups = step
            stats = {"a": shard_stats(rows, {"k": groups})}
            out.append(strat.select_calibrated(stats, ["a"], ["k"],
                                               calibration=store))
        else:
            _k, source, n, rows, groups, route, wall = step
            peer = cal.CalibrationStore()
            for _ in range(n):
                peer.record(rows, groups, "int", "cuda", route, wall)
            out.append(store.absorb(peer.summary(), source=f"w{source}"))
    out.append(store.summary())
    out.append(store.stats())
    return out


@pytest.mark.parametrize("env", [
    {}, {"BQUERYD_TPU_CALIB_EPSILON": "0.5"},
    {"BQUERYD_TPU_CALIB_EPSILON": "0"}, {"BQUERYD_TPU_CALIB_MIN_SAMPLES": "1"},
    {"BQUERYD_TPU_CALIB": "0"}, {"BQUERYD_TPU_CALIB_EPSILON": "junk"},
])
@pytest.mark.parametrize("seed", range(3))
def test_store_sequences_decide_like_the_reference(monkeypatch, env, seed):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    steps = _sequence(seed)
    got = _run_sequence(calibrate, strategy, steps)
    want = _run_sequence(jax_calibrate, jax_strategy, steps)
    assert got == want
    reasons = {o[-1] for o in got if isinstance(o, tuple)}
    if not env:
        assert {"cold", "measured"} <= reasons


def test_knobs_and_helpers_match_reference(monkeypatch, tmp_path):
    for value in ("", "-", "0", str(tmp_path / "c.json")):
        monkeypatch.setenv("BQUERYD_TPU_CALIB_PATH", value)
        assert calibrate.calib_path() == jax_calibrate.calib_path()
    for value in ("0.2", "7", "-1", "x"):
        monkeypatch.setenv("BQUERYD_TPU_CALIB_EPSILON", value)
        monkeypatch.setenv("BQUERYD_TPU_CALIB_MIN_SAMPLES", value)
        assert calibrate.epsilon() == jax_calibrate.epsilon()
        assert calibrate.min_samples() == jax_calibrate.min_samples()
    for rows in (0, 1, 7, 10**7, 2**40):
        for route in STRATS:
            assert calibrate.analytic_units(route, rows, rows // 3 + 1) == (
                jax_calibrate.analytic_units(route, rows, rows // 3 + 1))
        assert calibrate.rows_bucket(rows) == jax_calibrate.rows_bucket(rows)
    for dtypes in ([], [np.float64], [np.int8, np.float32], ["bfloat16"],
                   [np.dtype("uint64")]):
        assert calibrate.dtype_tag(dtypes) == jax_calibrate.dtype_tag(dtypes)
    for key in ("r23|g3|int|cuda|matmul", "r1|g2|f32|cpu|host", "x",
                "r1|g2|int|cpu|warp", "ra|g2|int|cpu|sort", None):
        assert calibrate.parse_key(key) == jax_calibrate.parse_key(key)


def test_persistence_round_trips_across_packages(tmp_path):
    path = str(tmp_path / "calib.json")
    store = calibrate.CalibrationStore(path=path)
    warm(store, "scatter", 0.02, n=7, backend="cuda")
    warm(store, "matmul", 0.01, n=4, backend="cuda")
    assert store.save()
    ref = jax_calibrate.CalibrationStore(path=path)
    assert ref.load() == 2
    assert ref.summary()["cells"] == store.summary()["cells"]
    back = calibrate.CalibrationStore(path=path)
    assert back.load() == 2
    assert back.choose(10_000_000, 9, "int", ("matmul", "scatter", "sort"),
                       "scatter")[0] == "matmul"
    assert calibrate.CalibrationStore(
        path=str(tmp_path / "absent.json")).load() == 0


def test_kill_switch_stops_recording_and_gossip(monkeypatch):
    calibrate.record_sample(10**6, 16, [np.dtype(np.int64)], "cuda",
                            "scatter", 0.02)
    wire = calibrate.summary_for_wire()
    assert wire and "r19|g4|int|cuda|scatter" in wire["cells"]
    monkeypatch.setenv("BQUERYD_TPU_CALIB", "0")
    assert calibrate.summary_for_wire() is None
    calibrate.record_sample(10**6, 16, [np.dtype(np.int64)], "cuda",
                            "scatter", 0.02)
    assert calibrate.store().stats()["samples_total"] == 1


# -- test_plan.py:228 and :466 on the port ------------------------------------

def test_strategy_hints_are_bit_exact():
    """Every route a hint can force computes the identical partial
    tables."""
    from bqueryd_tpu_torch import ops

    rng = np.random.RandomState(7)
    codes = rng.randint(0, 37, 5000).astype(np.int32)
    vals = rng.randint(-(10**12), 10**12, 5000).astype(np.int64)
    fvals = rng.random(5000).astype(np.float64)
    mask = rng.random(5000) > 0.3

    def run(hint):
        return ops.tree_to_numpy(ops.partial_tables(
            codes, (vals, fvals), ("sum", "mean"), 37, mask,
            strategy=hint, device=CPU))

    base = run(None)
    for hint in ("scatter", "sort", "matmul", "matmul!", "auto"):
        got = run(hint)
        assert np.array_equal(base["rows"], got["rows"])
        assert np.array_equal(base["aggs"][0]["sum"], got["aggs"][0]["sum"])
        np.testing.assert_allclose(base["aggs"][1]["sum"],
                                   got["aggs"][1]["sum"], rtol=1e-12)
    with pytest.raises(ValueError):
        run("warp-drive")


def test_strategy_hint_rides_the_fragment(controller):  # noqa: F811
    stats = {"a.bcolzs": shard_stats(10_000_000, {"k": 9})}
    register(controller, "w1", ["a.bcolzs"], stats=stats)
    controller.rpc_groupby(groupby_msg(["a.bcolzs"]))
    (msg,) = queued(controller)
    frag = msg.get_from_binary("plan")
    assert frag["strategy"] == "matmul"
    assert frag["strategy_binding"] is False
    assert controller.counters["plan_strategy_hints"] == 1
    assert frag["agg_list"] == [["v", "sum", "v"]]


def test_calibrated_hints_and_counters(new_controller,  # noqa: F811
                                       monkeypatch):
    """A warm controller model overrides, explores and promotes, counted
    as the reference counts them; ``BQUERYD_TPU_PLANNER=0`` and a DAG
    dispatch issue no hint."""
    controller = new_controller(admit_max_active=64, admit_client_quota=0)
    stats = {"a.bcolzs": shard_stats(10_000_000, {"k": 9})}
    register(controller, "w1", ["a.bcolzs"], stats=stats)
    warm(controller.calibration, "scatter", 0.01)
    warm(controller.calibration, "matmul", 0.10)
    seen = []

    def hint(token):
        # a filter of its own per query: no shared dispatch to join
        seen.append(token)
        controller.rpc_groupby(groupby_msg(
            ["a.bcolzs"], token=token, where=[["v", ">", len(seen)]]))
        msg = queued(controller)[-1]
        for queue in controller.worker_out_messages.values():
            queue.clear()
        return msg.get_from_binary("plan")

    frag = hint("aa")
    assert (frag["strategy"], frag["strategy_binding"]) == ("scatter", False)
    assert controller.counters["plan_calibrated_overrides"] == 1
    monkeypatch.setenv("BQUERYD_TPU_CALIB_EPSILON", "0.5")
    frag = hint("bb")  # decision 2: the explore slot
    assert frag["strategy"] == "sort"
    assert controller.counters["plan_explore_hints"] == 1
    warm(controller.calibration, "matmul", 0.0001, n=20)
    monkeypatch.setenv("BQUERYD_TPU_CALIB_EPSILON", "0")
    frag = hint("cc")
    assert (frag["strategy"], frag["strategy_binding"]) == ("matmul", True)
    assert controller.counters["plan_matmul_promotions"] == 1
    assert controller.counters["plan_strategy_hints"] == 3
    monkeypatch.setenv("BQUERYD_TPU_PLANNER", "0")
    assert hint("dd")["strategy"] is None
    monkeypatch.delenv("BQUERYD_TPU_PLANNER")
    controller.rpc_query(_query_msg("ee"))
    (msg,) = queued(controller)
    assert msg.get_from_binary("plan")["strategy"] is None
    assert controller.counters["plan_strategy_hints"] == 3


def _query_msg(token):
    from bqueryd_tpu_torch.messages import RPCMessage

    msg = RPCMessage({"payload": "query", "token": token})
    msg.set_args_kwargs([{"table": ["a.bcolzs"], "groupby": ["k"],
                          "aggs": [["v", "topk", "t", {"k": 2}]]}], {})
    return msg


def test_controller_absorbs_calibration_gossip(controller):  # noqa: F811
    """WRM summaries replace their worker's previous one (a repeated
    cumulative summary is not counted twice), malformed gossip is inert,
    and ``get_info()["calibration"]`` shows the model."""
    import time

    peer = calibrate.CalibrationStore()
    peer.record(10_000_000, 9, "int", "cuda", "scatter", 0.03)  # one wall
    wrm = {"worker_id": "w1", "calibration": peer.summary(),
           "data_files": [], "workertype": "calc"}
    for _ in range(calibrate.min_samples() + 2):
        controller._register("w1", dict(wrm), time.time())
    assert controller.calibration.stats()["cells"] == 1
    assert controller.calibration.choose(
        10_000_000, 9, None, ("matmul", "scatter", "sort"), "matmul"
    ) == ("matmul", "cold")
    controller._absorb_shard_stats({"worker_id": "w2",
                                    "calibration": "junk"})
    controller._absorb_shard_stats({"worker_id": "w2",
                                    "calibration": {"cells": ["x"]}})
    assert controller.calibration.stats()["cells"] == 1
    peer2 = calibrate.CalibrationStore()
    warm(peer2, "scatter", 0.03, n=5, backend="cuda")
    controller._register("w2", {**wrm, "worker_id": "w2",
                                "calibration": peer2.summary(),
                                "liveness_only": True}, time.time())
    controller._register("w2", {**wrm, "worker_id": "w2",
                                "calibration": peer2.summary()}, time.time())
    info = controller.get_info()["calibration"]
    assert info["sources"] == 2 and info["cells"] == 2
    assert info["sample_cells"]["cells"] == {}  # nothing recorded itself
    assert set(info["source_cells"]["w2"]) == {"r23|g3|int|cuda|scatter"}
    assert info["source_cells"]["w2"]["r23|g3|int|cuda|scatter"]["n"] == 5
    assert controller.calibration.choose(
        10_000_000, 9, None, ("matmul", "scatter", "sort"), "matmul"
    )[1] in ("measured", "prior")


def test_controller_tracks_the_wedge_latch(controller):  # noqa: F811
    import time

    wrm = {"worker_id": "w1", "data_files": [], "workertype": "calc",
           "backend_wedged": True}
    controller._register("w1", dict(wrm), time.time())
    assert controller._worker_wedged["w1"] is True
    assert controller.get_info()["workers"]["w1"]["backend_wedged"] is True
    controller._register("w1", {**wrm, "backend_wedged": False,
                                "liveness_only": True}, time.time())
    assert controller._worker_wedged["w1"] is False
    assert controller.worker_map["w1"]["backend_wedged"] is False


# -- the worker side ----------------------------------------------------------

@pytest.fixture
def served(tmp_path):
    rng = np.random.default_rng(17)
    df = pd.DataFrame({"k": rng.integers(0, 9, 20_000).astype(np.int64),
                       "v": rng.integers(-1000, 1000, 20_000).astype(
                           np.int64)})
    jax_ctable.fromdataframe(df, str(tmp_path / "a.bcolzs"))
    return str(tmp_path), df


def _port_worker(data_dir):
    from bqueryd_tpu_torch.worker import WorkerNode

    return WorkerNode(coordination_url=f"mem://cw-{os.urandom(4).hex()}",
                      data_dir=data_dir, loglevel=QUIET, device=CPU)


def _jax_worker(data_dir):
    from bqueryd_tpu.worker import WorkerNode

    return WorkerNode(coordination_url=f"mem://jw-{os.urandom(4).hex()}",
                      data_dir=data_dir, loglevel=QUIET, restart_check=False)


def _calc(fragment, filename="a.bcolzs"):
    from bqueryd_tpu_torch.messages import CalcMessage

    msg = CalcMessage({"payload": "groupby", "token": "t"})
    msg.set_args_kwargs([filename, ["k"], [["v", "sum", "v"]], []], {})
    msg.add_as_binary("plan", fragment)
    return msg


@pytest.mark.parametrize("calib", ["1", "0"])
def test_worker_rebuilds_the_binding_unless_killed(monkeypatch, served,
                                                   calib):
    from bqueryd_tpu_torch.plan import fragment_for, plan_groupby

    monkeypatch.setenv("BQUERYD_TPU_CALIB", calib)
    data_dir, df = served
    plan = plan_groupby(["a.bcolzs"], ["k"], [["v", "sum", "v"]], [])
    worker = _port_worker(data_dir)
    try:
        for hint, want in (("matmul!", "matmul!" if calib == "1"
                            else "matmul"),
                           ("matmul", "matmul"), ("scatter", "scatter"),
                           (None, None)):
            msg = _calc(fragment_for(plan, ["a.bcolzs"], strategy=hint))
            args, kwargs = msg.get_args_kwargs()
            _q, _dag, strat = worker._query_of(msg, args, kwargs)
            assert strat == want
            reply = worker.handle_work(msg)
            assert reply.get("strategy") == want
    finally:
        worker.socket.close()


def test_executor_and_engine_record_samples(monkeypatch, served):
    """The executor's and the engine's walls land in the process store
    under the device type ("cpu" here), host-routed walls under "host";
    the WRM carries them."""
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
    from bqueryd_tpu_torch.storage.ctable import ctable

    data_dir, _df = served
    table = ctable(os.path.join(data_dir, "a.bcolzs"), mode="r")
    query = GroupByQuery(["k"], [["v", "sum", "v"]])
    MeshQueryExecutor(device=CPU).execute([table], query)
    engine = QueryEngine(device=CPU)
    engine.execute_local(table, query)
    assert engine.last_effective_strategy == "matmul"
    monkeypatch.setenv("BQUERYD_TPU_HOST_KERNEL_ROWS", "1000000")
    engine.execute_local(table, query)
    assert engine.last_effective_strategy == "host"
    cells = calibrate.store().summary()["cells"]
    assert cells["r14|g3|int|cpu|matmul"]["n"] == 2
    assert cells["r14|g3|int|host|host"]["n"] == 1
    worker = _port_worker(data_dir)
    try:
        assert set(worker.prepare_wrm()["calibration"]["cells"]) == set(cells)
        monkeypatch.setenv("BQUERYD_TPU_CALIB", "0")
        assert worker.prepare_wrm()["calibration"] is None
    finally:
        worker.socket.close()


def test_first_launch_walls_are_not_samples(monkeypatch, served):
    """A window that built the kernel library or launched a shape for the
    first time (``onehot.build_marker`` moved) records nothing."""
    from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
    from bqueryd_tpu_torch.ops import onehot
    from bqueryd_tpu_torch.storage.ctable import ctable

    data_dir, _df = served
    table = ctable(os.path.join(data_dir, "a.bcolzs"), mode="r")
    marks = iter([(0, 0), (0, 1), (0, 1), (0, 1)])
    monkeypatch.setattr(onehot, "build_marker", lambda: next(marks))
    engine = QueryEngine(device=CPU)
    engine.execute_local(table, GroupByQuery(["k"], [["v", "sum", "v"]]))
    assert calibrate.store().stats()["samples_total"] == 0
    engine.execute_local(table, GroupByQuery(["k"], [["v", "sum", "v"]]))
    assert calibrate.store().stats()["samples_total"] == 1


def _warm_for_promotion(store):
    warm(store, "scatter", 0.10, rows=20_000, groups=9)
    warm(store, "matmul", 0.01, rows=20_000, groups=9)


def test_jax_controller_hint_reaches_a_port_worker(served, tmp_path):
    from bqueryd_tpu.controller import ControllerNode as JaxController
    from test_plan import groupby_msg as jax_groupby_msg
    from test_plan import queued as jax_queued
    from test_plan import register as jax_register

    data_dir, _df = served
    ctl = JaxController(coordination_url=f"mem://jc-{os.urandom(4).hex()}",
                        loglevel=QUIET, runfile_dir=str(tmp_path))
    worker = _port_worker(data_dir)
    try:
        jax_register(ctl, "w1", ["a.bcolzs"],
                     stats={"a.bcolzs": shard_stats(20_000, {"k": 9})})
        _warm_for_promotion(ctl.calibration)
        ctl.rpc_groupby(jax_groupby_msg(["a.bcolzs"]))
        (msg,) = jax_queued(ctl)
        assert msg.get_from_binary("plan")["strategy_binding"] is True
        reply = worker.handle_work(_calc(msg.get_from_binary("plan")))
        assert reply["strategy"] == "matmul!"
        assert reply["effective_strategy"] == "matmul"
    finally:
        worker.socket.close()
        ctl.socket.close()


def test_port_controller_hint_reaches_a_jax_worker(served,
                                                   controller):  # noqa: F811
    data_dir, _df = served
    register(controller, "w1", ["a.bcolzs"],
             stats={"a.bcolzs": shard_stats(20_000, {"k": 9})})
    _warm_for_promotion(controller.calibration)
    controller.rpc_groupby(groupby_msg(["a.bcolzs"]))
    (msg,) = queued(controller)
    fragment = msg.get_from_binary("plan")
    assert (fragment["strategy"], fragment["strategy_binding"]) == (
        "matmul", True)
    worker = _jax_worker(data_dir)
    try:
        from bqueryd_tpu.messages import msg_factory

        jax_msg = msg_factory(_calc(fragment).to_json())
        reply = worker.handle_work(jax_msg)
        assert reply["strategy"] == "matmul!"
    finally:
        worker.socket.close()

"""Shared-scan bundles of the port against the JAX package's.

The same NumPy inputs go through the port and the JAX package:

* ``plan.bundle``: ``compat_key`` over ``tests/test_concurrency.py``'s
  plan shapes, ``bundle_fragment`` and ``bundle_to_queries`` round trips,
  ``member_shares`` and the window knobs, all equal;
* ``ops.bundle_partial_tables`` on the shapes of each contraction branch
  (``mma`` up to 32 groups, ``table`` past it, hicard past 8,192 groups)
  and of the scatter route, against the JAX function, which
  ``tests/conftest.py``'s CPU backend runs as its batched segment sums,
  and against the port's own solo ``partial_tables`` per member;
* ``MeshQueryExecutor.execute_bundle`` over ``test_concurrency.py``'s
  ``swarm_df`` shards, against the JAX ``execute_bundle`` on the 8 virtual
  CPU devices and against the port's solo ``execute`` per member,
  including filters that exclude whole shards and chunks;
* the worker: a port worker answers a bundle CalcMessage built by the JAX
  ``bundle_fragment`` as the JAX worker does;
* the cluster cases of ``test_concurrency.py`` on a port cluster (port
  controller, port calc worker on the CPU, port ``RPC``, threads over TCP
  ZMQ on 127.0.0.1), and a JAX ``RPC`` reading a port bundle member's
  reply.

Tolerances: keys, row counts and ints bit-equal; floats within
``tests/test_differential_fuzz.py:_compare``'s rtol 2e-5, atol 1e-6.
"""

import logging
import os
import pickle
import threading
import time
from contextlib import contextmanager

import jax
import numpy as np
import pytest

import bqueryd_tpu.ops as jops
from bqueryd_tpu.models.query import GroupByQuery as JaxQuery
from bqueryd_tpu.models.query import ResultPayload as JaxPayload
from bqueryd_tpu.parallel import hostmerge as jax_hostmerge
from bqueryd_tpu.parallel.executor import MeshQueryExecutor as JaxExecutor
from bqueryd_tpu.parallel.executor import make_mesh
from bqueryd_tpu.plan import bundle as jax_bundle
from bqueryd_tpu.plan import plan_groupby as jax_plan_groupby
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import messages
from bqueryd_tpu_torch.models.query import GroupByQuery, ResultPayload
from bqueryd_tpu_torch.ops import groupby as tg
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.plan import bundle as bundlemod
from bqueryd_tpu_torch.plan import plan_groupby
from bqueryd_tpu_torch.storage.ctable import ctable
from test_concurrency import swarm_df
from test_torch_groupby import _inputs, assert_trees_match
from tests.conftest import wait_until
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6
QUIET = logging.WARNING
RPC_TIMEOUT = 30
N_SHARDS = 3


def _close(got, want, what=""):
    """Ints and keys bit-equal with their dtypes; floats within rtol 2e-5,
    atol 1e-6."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        assert got.dtype == want.dtype, f"{what}: {got.dtype} {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=what)


def _same_table(got, want):
    """Two ``(order, {col: array})`` results, or a port result and a
    DataFrame, row for row after sorting by the key columns."""
    order, cols = got
    if not isinstance(want, tuple):
        want = (list(want.columns), {c: want[c].to_numpy() for c in want})
    w_order, w_cols = want
    assert list(order) == list(w_order)
    n_keys = len([c for c in order if c in ("k", "k2")])
    keys = order[:n_keys]
    g_idx = np.lexsort([cols[k] for k in reversed(keys)])
    w_idx = np.lexsort([w_cols[k] for k in reversed(keys)])
    for c in order:
        _close(np.asarray(cols[c])[g_idx], np.asarray(w_cols[c])[w_idx], c)


def _finalized(payload):
    return hostmerge.finalize_table(hostmerge.merge_payloads([payload]))


# -- plan.bundle -------------------------------------------------------------

KEEP = ["a.bcolzs", "b.bcolzs"]

#: (label, plan args, plan kwargs, keep, dispatch kwargs), the shapes of
#: test_concurrency.py's compat_key cases
COMPAT_CASES = [
    ("sum filtered", (["k"], [["v", "sum", "v"]], [["w", ">", 1.0]]), {},
     KEEP, {}),
    ("mean filtered", (["k"], [["w", "mean", "m"]], [["w", "<", 9.0]]), {},
     KEEP, {}),
    ("other keys", (["k2"], [["v", "sum", "v"]], []), {}, KEEP, {}),
    ("one shard", (["k"], [["v", "sum", "v"]], []), {}, KEEP[:1], {}),
    ("raw rows", (["k"], [["v", "sum", "v"]], []), {"aggregate": False},
     KEEP, {}),
    ("basket", (["k"], [["v", "sum", "v"]], []),
     {"expand_filter_column": "k2"}, KEEP, {}),
    ("distinct", (["k"], [["v", "count_distinct", "nd"]], []), {}, KEEP,
     {}),
    ("batch off", (["k"], [["v", "sum", "v"]], []), {}, KEEP,
     {"batch": False}),
    ("all pruned", (["k"], [["v", "sum", "v"]], []), {}, [], {}),
    ("affinity", (["k"], [["v", "sum", "v"]], []), {}, KEEP,
     {"affinity": "w1"}),
]


@pytest.mark.parametrize("case", COMPAT_CASES, ids=[c[0] for c in COMPAT_CASES])
def test_compat_key_matches_reference(case):
    _label, args, plan_kw, keep, kwargs = case
    port = bundlemod.compat_key(plan_groupby(KEEP, *args, **plan_kw), keep,
                                kwargs)
    ref = jax_bundle.compat_key(jax_plan_groupby(KEEP, *args, **plan_kw),
                                keep, kwargs)
    assert port == ref


def test_compat_key_fuses_across_measures_and_filters():
    keys = {bundlemod.compat_key(plan_groupby(KEEP, *c[1], **c[2]), c[3],
                                 c[4]) for c in COMPAT_CASES[:2]}
    assert len(keys) == 1 and None not in keys


@pytest.mark.parametrize("strategy", [None, "scatter", "matmul!"])
def test_bundle_fragment_round_trip_matches_reference(strategy):
    args1 = (["k"], [["v", "sum", "v"]], [["w", ">", 2.0]])
    args2 = (["k"], [["v", "mean", "m"], ["w", "max", "wx"]], [])
    p1, p2 = plan_groupby(KEEP, *args1), plan_groupby(KEEP, *args2)
    j1, j2 = jax_plan_groupby(KEEP, *args1), jax_plan_groupby(KEEP, *args2)
    port = bundlemod.bundle_fragment(
        p1, KEEP, [("m1", p1, None), ("m2", p2, 123.0)], strategy=strategy,
        sole=False)
    ref = jax_bundle.bundle_fragment(
        j1, KEEP, [("m1", j1, None), ("m2", j2, 123.0)], strategy=strategy,
        sole=False)
    assert port == ref
    got = bundlemod.bundle_to_queries(port)
    want = jax_bundle.bundle_to_queries(ref)
    assert [(m, d) for m, d, _q in got] == [(m, d) for m, d, _q in want]
    for (_m, _d, g), (_m2, _d2, w) in zip(got, want):
        assert g.signature() == w.signature()
        assert (g.groupby_cols, g.agg_list, g.where_terms, g.ops) == (
            w.groupby_cols, w.agg_list, w.where_terms, w.ops)
    # the binding hint is rebuilt as the reference rebuilds it
    assert (bundlemod.fragment_strategy(port)
            == jax_bundle.fragment_strategy(ref) == strategy)
    with pytest.raises(ValueError):
        bundlemod.bundle_to_queries({"v": 99, "members": []})


@pytest.mark.parametrize("walls", [None, {"a": 1.0, "b": 3.0},
                                   {"a": 0.0, "b": 1.0}])
def test_member_shares_match_reference(walls):
    assert (bundlemod.member_shares(["a", "b"], walls=walls)
            == jax_bundle.member_shares(["a", "b"], walls=walls))
    assert bundlemod.member_shares([]) == {}


@pytest.mark.parametrize("value", [None, "25.5", "garbage", "-3"])
def test_window_knobs_match_reference(monkeypatch, value):
    for name in ("BQUERYD_TPU_BATCH_WINDOW_MS", "BQUERYD_TPU_BATCH_MAX"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert bundlemod.batch_window_ms() == jax_bundle.batch_window_ms()
    assert bundlemod.batch_max() == jax_bundle.batch_max()


# -- ops.bundle_partial_tables -------------------------------------------------

#: (label, n, n_groups, measure kinds): the member loop's contraction
#: branch (mma up to 32 groups, table past it, hicard past 8,192 groups
#: with int sums only) or the scatter route (float64, min/max)
BPT_CASES = [
    ("mma", 4096, 11, ("int64_small", "float32")),
    ("table", 4096, 300, ("int64_small", "float32")),
    ("hicard", 20000, 9000, ("int64_small", "int32")),
    ("scatter", 4096, 11, ("float64", "int64_big")),
]


def _member_specs(label):
    """Three members over the two measure slots: one masked by mask 0,
    one unfiltered, one masked by mask 1; hicard takes int sums and
    counts only, the others every mergeable op."""
    if label == "hicard":
        return ((0, ((0, "sum"), (0, "count"))),
                (None, ((1, "sum"),)),
                (1, ((1, "sum"), (0, "mean"))))
    return ((0, ((0, "sum"), (0, "count"))),
            (None, ((1, "mean"),)),
            (1, ((1, "min"), (0, "max"), (1, "count_na"))))


@pytest.mark.parametrize("case", BPT_CASES, ids=[c[0] for c in BPT_CASES])
def test_bundle_partial_tables_matches_reference_and_solo(case):
    """Ints bit-equal, floats within rtol 2e-5, atol 1e-6, against the JAX
    function and against the port's solo partial_tables per member."""
    label, n, n_groups, kinds = case
    codes, measures, _mask, _sent = _inputs(11, n, n_groups, kinds, False)
    rng = np.random.default_rng(3)
    masks = np.stack([rng.random(n) > 0.4, rng.random(n) > 0.7])
    specs = _member_specs(label)
    port = tg.bundle_partial_tables(codes, masks, measures, specs, n_groups,
                                    device="cpu")
    ref = jax.device_get(jops.bundle_partial_tables(
        codes.astype(np.int32), masks, measures, specs, n_groups))
    assert len(port) == len(ref) == len(specs)
    for got, want, (mask_idx, aggs) in zip(port, ref, specs):
        got = tg.tree_to_numpy(got)
        assert_trees_match(got, want)
        solo = tg.tree_to_numpy(tg.partial_tables(
            codes, tuple(measures[s] for s, _op in aggs),
            tuple(op for _s, op in aggs), n_groups,
            mask=None if mask_idx is None else masks[mask_idx],
            device="cpu"))
        assert_trees_match(got, solo)


@pytest.mark.parametrize("bad", ["count_distinct", "sentinel_sum"])
def test_bundle_partial_tables_rejects_like_reference(bad):
    codes, measures, _m, _s = _inputs(2, 64, 5, ("int64_small",), False)
    if bad == "count_distinct":
        specs, sentinels = ((None, ((0, "count_distinct"),)),), None
    else:
        specs, sentinels = ((None, ((0, "sum"),)),), (0,)
    with pytest.raises(ValueError):
        tg.bundle_partial_tables(codes, None, measures, specs, 5,
                                 null_sentinels=sentinels, device="cpu")
    with pytest.raises(ValueError):
        jops.bundle_partial_tables(codes.astype(np.int32), None, measures,
                                   specs, 5, null_sentinels=sentinels)


# -- MeshQueryExecutor.execute_bundle ----------------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """test_concurrency.py's swarm_df in three shards, written by the JAX
    package's ctable with chunks of 1,000 rows, plus a fourth shard whose
    ``w`` is far above the others' (a filter can exclude it whole)."""
    df = swarm_df()
    base = tmp_path_factory.mktemp("torch_bundles")
    frames = [df.iloc[i::N_SHARDS].reset_index(drop=True)
              for i in range(N_SHARDS)]
    high = df.iloc[:1500].reset_index(drop=True).copy()
    high["w"] = high["w"] + 100.0
    frames.append(high)
    names = []
    for i, frame in enumerate(frames):
        name = f"b_{i}.bcolzs"
        jax_ctable.fromdataframe(frame, str(base / name), chunklen=1000)
        names.append(name)
    return str(base), frames, names


def _port_tables(root, names):
    return [ctable(os.path.join(root, n), mode="r") for n in names]


BUNDLE_QUERIES = [
    (["k"], [["v", "sum", "v_sum"]], [("w", ">", 6.0)]),
    (["k"], [["v", "sum", "v_sum"]], [("w", ">", 1.5)]),
    (["k"], [["w", "mean", "w_mean"]], []),
    (["k"], [["v", "min", "v_min"], ["v", "max", "v_max"]], [("w", "<", 8.0)]),
    (["k"], [["v", "sum", "s"], ["v", "count", "n"], ["w", "mean", "m"]],
     [("w", ">", 3.0)]),
    # excludes the fourth shard whole and most chunks of the others
    (["k"], [["v", "sum", "s"], ["v", "count", "n"]], [("w", ">", 9.9)]),
    (["k", "k2"], [["v", "sum", "s"]], [("w", ">", 50.0)]),
]


@pytest.mark.parametrize("gcols", [["k"], ["k", "k2"]])
def test_execute_bundle_matches_reference_and_solo(sharded, gcols):
    """Each member against the JAX execute_bundle and against the port's
    own solo execute, which prunes shards and chunks the bundle scans."""
    root, _frames, names = sharded
    specs = [q for q in BUNDLE_QUERIES if q[0] == gcols]
    if gcols == ["k", "k2"]:
        specs = [(gcols, a, w) for _g, a, w in BUNDLE_QUERIES[:3]] + specs
    tables = _port_tables(root, names)
    ex = MeshQueryExecutor(device="cpu")
    port = ex.execute_bundle(tables, [GroupByQuery(*s) for s in specs])
    assert ex.last_merge_mode == "device"
    jex = JaxExecutor(mesh=make_mesh())
    jtables = [jax_ctable(os.path.join(root, n), mode="r") for n in names]
    ref = jex.execute_bundle(jtables, [JaxQuery(*s) for s in specs])
    assert len(port) == len(ref) == len(specs)
    for spec, got, want in zip(specs, port, ref):
        got_t = _finalized(got)
        want_df = jax_hostmerge.payload_to_dataframe(
            jax_hostmerge.merge_payloads([want]))
        _same_table(got_t, want_df)
        solo = ex.execute(tables, GroupByQuery(*spec))
        _same_table(got_t, _finalized(solo))


def test_execute_bundle_matches_pandas(sharded):
    root, frames, names = sharded
    import pandas as pd

    df = pd.concat(frames, ignore_index=True)
    ex = MeshQueryExecutor(device="cpu")
    got = ex.execute_bundle(_port_tables(root, names), [
        GroupByQuery(["k"], [["v", "sum", "v_sum"]], [("w", ">", 5.0)]),
        GroupByQuery(["k"], [["v", "count", "n"]], [("w", "<", 5.0)]),
    ])
    exp0 = (df[df["w"] > 5.0].groupby("k")["v"].sum().reset_index()
            .rename(columns={"v": "v_sum"}))
    exp1 = (df[df["w"] < 5.0].groupby("k")["v"].count().reset_index()
            .rename(columns={"v": "n"}))
    _same_table(_finalized(got[0]), exp0)
    _same_table(_finalized(got[1]), exp1)


def test_execute_bundle_shares_scan_work(sharded):
    """One alignment, one codes upload and one measure upload for four
    members; a second bundle is warm on the scan side, and an unfiltered
    solo query hits the bundle's codes entry."""
    root, _frames, names = sharded
    tables = _port_tables(root, names)
    ex = MeshQueryExecutor(device="cpu")
    queries = [GroupByQuery(["k"], [["v", "sum", "a"]], [("w", ">", t)])
               for t in (1.0, 2.0, 3.0, 4.0)]
    ex.execute_bundle(tables, queries)
    stats = ex.workingset.stats()
    assert stats["align"]["misses"] == 1
    assert stats["codes"]["misses"] == 1
    assert stats["blocks"]["misses"] == 1
    before = stats["codes"]["hits"]
    ex.execute_bundle(tables, queries[:2])
    stats = ex.workingset.stats()
    assert stats["align"]["misses"] == 1
    assert stats["codes"]["hits"] > before
    ex.execute(tables, GroupByQuery(["k"], [["v", "sum", "a"]]))
    assert ex.workingset.stats()["codes"]["misses"] == 1


@pytest.mark.parametrize("bad", ["keys", "distinct", "column", "datetime"])
def test_execute_bundle_rejects_with_value_error(tmp_path, sharded, bad):
    root, _frames, names = sharded
    ex = MeshQueryExecutor(device="cpu")
    good = GroupByQuery(["k"], [["v", "sum", "a"]])
    tables = _port_tables(root, names)
    if bad == "keys":
        other = GroupByQuery(["k2"], [["v", "sum", "a"]])
        match = "group-key"
    elif bad == "distinct":
        other = GroupByQuery(["k"], [["v", "count_distinct", "a"]])
        match = "mergeable"
    elif bad == "column":
        other = GroupByQuery(["k"], [["no_such_column", "sum", "a"]])
        match = "no_such_column"
    else:
        import pandas as pd

        frame = swarm_df(n=200)
        frame["ts"] = pd.date_range("2024-01-01", periods=200, freq="s")
        jax_ctable.fromdataframe(frame, str(tmp_path / "ts.bcolzs"))
        tables = _port_tables(str(tmp_path), ["ts.bcolzs"])
        other = GroupByQuery(["k"], [["ts", "sum", "a"]])
        match = "datetime"
    with pytest.raises(ValueError, match=match):
        ex.execute_bundle(tables, [good, other])


def test_execute_bundle_of_nothing():
    assert MeshQueryExecutor(device="cpu").execute_bundle([], []) == []


# -- the worker's bundle verb --------------------------------------------------

@pytest.fixture
def workers(sharded, mem_store_url):
    """A port worker and a JAX worker over one data dir."""
    from bqueryd_tpu.worker import WorkerNode as JaxWorker
    from bqueryd_tpu_torch.worker import WorkerNode

    root, _frames, _names = sharded
    port = WorkerNode(coordination_url=f"mem://bundle-{os.urandom(4).hex()}",
                      data_dir=root, loglevel=QUIET, device="cpu")
    ref = JaxWorker(coordination_url=mem_store_url, data_dir=root,
                    loglevel=QUIET, restart_check=False)
    try:
        yield port, ref
    finally:
        port.socket.close()
        ref.socket.close()


def _jax_bundle_msg(names, member_args, deadlines=None):
    """A bundle CalcMessage as the JAX controller's ``_launch_bundle``
    builds it: the JAX ``bundle_fragment``, member 0's positional
    params."""
    from bqueryd_tpu.messages import CalcMessage as JaxCalcMessage

    plans = [jax_plan_groupby(names, *a) for a in member_args]
    deadlines = deadlines or [None] * len(plans)
    members = [(f"m{i}", p, d) for i, (p, d) in enumerate(zip(plans,
                                                             deadlines))]
    msg = JaxCalcMessage({"payload": "groupby", "token": "bundle-token",
                          "parent_token": "p0"})
    target = names if len(names) > 1 else names[0]
    msg.set_args_kwargs([target, list(plans[0].groupby.keys),
                         plans[0].physical_agg_list(),
                         [list(t) for t in plans[0].where_terms]], {})
    msg["filename"] = target
    msg.add_as_binary("bundle", jax_bundle.bundle_fragment(
        plans[0], names, members, sole=len(names) == 1))
    msg["_bundle_parents"] = {f"m{i}": f"p{i}" for i in range(len(plans))}
    return msg


def _envelope(reply):
    envelope = pickle.loads(reply["data"])
    assert envelope["v"] == 1
    return envelope


def test_port_worker_answers_a_reference_bundle(workers, sharded):
    """The same JAX-built bundle to both workers: equal members, errors,
    shares and merge mode; payloads equal member for member."""
    port, ref = workers
    _root, _frames, names = sharded
    member_args = [
        (["k"], [["v", "sum", "s"]], [["w", ">", 4.0]]),
        (["k"], [["w", "mean", "m"], ["v", "max", "vx"]], []),
        (["k"], [["v", "sum", "s"], ["v", "count", "n"]], [["w", "<", 2.5]]),
    ]
    msg = _jax_bundle_msg(names, member_args)
    got = port.handle_work(messages.msg_factory(msg.to_json()))
    want = ref.handle_work(msg.copy())
    assert got["bundle_members"] == want["bundle_members"] == ["m0", "m1",
                                                               "m2"]
    assert got["member_shares"] == want["member_shares"]
    assert got["merge_mode"] == want["merge_mode"] == "device"
    g_env, w_env = _envelope(got), _envelope(want)
    assert g_env["errors"] == w_env["errors"] == {}
    for mid in ("m0", "m1", "m2"):
        got_t = _finalized(ResultPayload.from_bytes(g_env["payloads"][mid]))
        want_df = jax_hostmerge.payload_to_dataframe(
            jax_hostmerge.merge_payloads([JaxPayload.from_bytes(
                w_env["payloads"][mid])]))
        _same_table(got_t, want_df)
    for phase in ("open", "align", "mask", "layout", "aggregate", "collect",
                  "serialize"):
        assert phase in got["phase_timings"], phase


def test_worker_bundle_isolates_members(workers, sharded):
    """An expired member is dropped from the stack and a member with an
    unknown column fails alone on the per-member path; a member answered
    before comes from the result cache under its solo key."""
    port, _ref = workers
    _root, _frames, names = sharded
    member_args = [
        (["k"], [["v", "sum", "s"]], [["w", ">", 4.0]]),
        (["k"], [["v", "sum", "s"]], [["w", ">", 5.0]]),
        (["k"], [["no_such_column", "sum", "s"]], []),
    ]
    msg = _jax_bundle_msg(names, member_args,
                          deadlines=[None, time.time() - 1.0, None])
    reply = port.handle_work(messages.msg_factory(msg.to_json()))
    env = _envelope(reply)
    assert set(env["payloads"]) == {"m0"}
    assert set(env["errors"]) == {"m1", "m2"}
    assert "deadline" in env["errors"]["m1"]
    assert "no_such_column" in env["errors"]["m2"]
    # m0 again, alone in a bundle: a result-cache hit, shared with the solo
    # groupby of the same query
    again = port.handle_work(messages.msg_factory(
        _jax_bundle_msg(names, member_args[:1]).to_json()))
    assert again["effective_strategy"] == "cached"
    assert again["member_shares"] == {"m0": 0.0}
    assert _envelope(again)["payloads"]["m0"] == env["payloads"]["m0"]


def test_bundle_fallback_catches_only_overflow_and_value_error(
        workers, sharded, monkeypatch):
    """CompositeOverflow and a ValueError run the members one by one; any
    other error (a device error) propagates to the worker's reply."""
    from bqueryd_tpu_torch import ops

    port, _ref = workers
    _root, _frames, names = sharded
    msg = _jax_bundle_msg(names, [
        (["k"], [["v", "sum", "s"]], [["w", ">", 4.0]]),
        (["k"], [["v", "sum", "s"]], [["w", ">", 3.0]]),
    ])
    monkeypatch.setenv("BQUERYD_TPU_RESULT_CACHE_BYTES", "0")
    port._result_cache = None
    for exc in (ops.CompositeOverflow("wide"), ValueError("shape")):
        def boom(*a, exc=exc, **k):
            raise exc
        monkeypatch.setattr(port.executor, "execute_bundle", boom)
        reply = port.handle_work(messages.msg_factory(msg.to_json()))
        env = _envelope(reply)
        assert set(env["payloads"]) == {"m0", "m1"} and not env["errors"]
        assert "execute" in reply["phase_timings"]

    def device_error(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(port.executor, "execute_bundle", device_error)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.handle_work(messages.msg_factory(msg.to_json()))


# -- the cluster: the admission window end to end ------------------------------

@pytest.fixture(scope="module")
def loopback():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        yield


@contextmanager
def _running(nodes):
    threads = [threading.Thread(target=n.go, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    try:
        yield
    finally:
        for n in nodes:
            n.running = False
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads), "a node did not stop"


@pytest.fixture
def swarm_cluster(loopback, tmp_path):
    """A port controller and a port calc worker (CPU) serving two shards
    of swarm_df, test_concurrency.py's swarm_cluster."""
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.worker import WorkerNode

    df = swarm_df(n=6_000, seed=31)
    shards = ["c_0.bcolzs", "c_1.bcolzs"]
    for i, name in enumerate(shards):
        jax_ctable.fromdataframe(df.iloc[i::2].reset_index(drop=True),
                                 str(tmp_path / name))
    url = f"file://{tmp_path / 'store'}"
    controller = ControllerNode(coordination_url=url, loglevel=QUIET,
                                runfile_dir=str(tmp_path),
                                heartbeat_interval=0.05)
    worker = WorkerNode(coordination_url=url, data_dir=str(tmp_path),
                        loglevel=QUIET, heartbeat_interval=0.1,
                        poll_timeout=0.05, device="cpu")
    with _running([controller, worker]):
        wait_until(lambda: all(n in controller.files_map for n in shards)
                   and all(n in controller.shard_stats for n in shards),
                   desc="shards and their stats advertised")
        yield {"controller": controller, "worker": worker, "df": df,
               "shards": shards, "url": url}


def _concurrent(url, queries, client_ids=None, delays=None, retries=3):
    """One thread and one port RPC per query: results and errors by
    index.  A query's optional fifth entry is its deadline in seconds."""
    from bqueryd_tpu_torch.rpc import RPC

    results, errors = {}, {}

    def run(i, query):
        time.sleep((delays or {}).get(i, 0.0))
        rpc = None
        try:
            rpc = RPC(coordination_url=url, timeout=RPC_TIMEOUT,
                      loglevel=QUIET, retries=retries,
                      client_id=(client_ids or {}).get(i))
            kwargs = {"deadline": query[4]} if len(query) == 5 else {}
            results[i] = rpc.groupby(*query[:4], **kwargs)
        except Exception as exc:  # noqa: BLE001 - surfaced via errors
            errors[i] = exc
        finally:
            if rpc is not None:
                rpc._close_socket()

    threads = [threading.Thread(target=run, args=(i, q), daemon=True)
               for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(RPC_TIMEOUT * retries + 10)
    return results, errors


def _pandas(df, gcol, out, op="sum", term=None):
    sel = df if term is None else df[df["w"] > term]
    agg = getattr(sel.groupby(gcol)["v"], op)().reset_index()
    return agg.rename(columns={"v": out})


def _settled(controller):
    wait_until(lambda: not controller.inflight and not controller.rpc_segments
               and not controller.admission.stats()["active"],
               desc="every query settled and its ticket released")


def test_window_zero_stages_nothing(swarm_cluster, monkeypatch):
    monkeypatch.delenv("BQUERYD_TPU_BATCH_WINDOW_MS", raising=False)
    c = swarm_cluster
    results, errors = _concurrent(
        c["url"], [(c["shards"], ["k"], [["v", "sum", "s"]], [])])
    assert not errors
    assert c["controller"].counters["plan_bundles"] == 0
    assert not c["controller"]._pending_window
    _same_table(results[0], _pandas(c["df"], "k", "s"))


def test_window_fuses_compatible_queries_with_parity(swarm_cluster,
                                                     monkeypatch):
    """Distinct-but-compatible concurrent queries fuse into one bundle per
    shard group; every member equals its window-0 answer, and pandas."""
    c = swarm_cluster
    df, shards, url = c["df"], c["shards"], c["url"]
    queries = [
        (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 7.0]]),
        (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 2.0]]),
        (shards, ["k"], [["w", "mean", "m"]], []),
    ]
    monkeypatch.delenv("BQUERYD_TPU_BATCH_WINDOW_MS", raising=False)
    ref, errors = _concurrent(url, queries)
    assert not errors
    counters = c["controller"].counters
    assert counters["plan_bundles"] == 0
    dispatched = counters["dispatched_shards"]
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "300")
    fused, errors = _concurrent(url, queries)
    assert not errors
    assert counters["plan_bundles"] == 1
    assert counters["plan_bundled_queries"] == 3
    assert counters["plan_shared_dispatches"] >= 2
    # ONE CalcMessage for the shard group
    assert counters["dispatched_shards"] - dispatched == 1
    for i in range(len(queries)):
        _same_table(fused[i], ref[i])
    _same_table(fused[0], _pandas(df, "k", "s", term=7.0))
    _settled(c["controller"])


def test_window_keeps_incompatible_queries_separate(swarm_cluster,
                                                    monkeypatch):
    c = swarm_cluster
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "300")
    before = c["controller"].counters["plan_bundles"]
    results, errors = _concurrent(c["url"], [
        (c["shards"], ["k"], [["v", "sum", "s"]], []),
        (c["shards"], ["k2"], [["v", "sum", "s"]], []),
    ])
    assert not errors
    assert c["controller"].counters["plan_bundles"] == before
    for i, gcol in enumerate(["k", "k2"]):
        _same_table(results[i], _pandas(c["df"], gcol, "s"))


def test_bundle_member_deadline_isolation(swarm_cluster, monkeypatch):
    """A member whose deadline expires inside the window fails with ITS
    error; bundle-mates answer, in one dispatch."""
    c = swarm_cluster
    df, shards, url = c["df"], c["shards"], c["url"]
    controller = c["controller"]
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "600")
    dispatched = controller.counters["dispatched_shards"]
    results, errors = _concurrent(url, [
        (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 4.0]]),
        (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 5.0]], 0.1),
        (shards, ["k"], [["v", "sum", "s"]], []),
    ], retries=1)
    assert set(errors) == {1}
    assert "deadline" in str(errors[1]).lower()
    assert set(results) == {0, 2}
    _same_table(results[0], _pandas(df, "k", "s", term=4.0))
    _same_table(results[2], _pandas(df, "k", "s"))
    assert controller.counters["dispatched_shards"] - dispatched == 1
    _settled(controller)


def test_bundle_member_quota_rejection_isolation(swarm_cluster, monkeypatch):
    """A query over its client's quota while that client's first query is
    staged gets BUSY; the staged bundle completes."""
    from bqueryd_tpu_torch.rpc import RPCBusyError

    c = swarm_cluster
    df, shards, url = c["df"], c["shards"], c["url"]
    controller = c["controller"]
    controller.admission.client_quota = 1
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "800")
    try:
        results, errors = _concurrent(url, [
            (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 3.0]]),
            (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 6.0]]),
            (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 1.0]]),
        ], client_ids={0: "app-a", 1: "app-b", 2: "app-a"},
            delays={2: 0.25}, retries=1)
        assert set(errors) == {2}
        assert isinstance(errors[2], RPCBusyError)
        assert controller.counters["admission_busy"] >= 1
        for i, term in ((0, 3.0), (1, 6.0)):
            _same_table(results[i], _pandas(df, "k", "s", term=term))
        _settled(controller)
    finally:
        controller.admission.client_quota = 0


def test_bundle_member_error_isolation(swarm_cluster, monkeypatch):
    c = swarm_cluster
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "400")
    results, errors = _concurrent(c["url"], [
        (c["shards"], ["k"], [["v", "sum", "s"]], []),
        (c["shards"], ["k"], [["no_such_column", "sum", "s"]], []),
    ], retries=1)
    assert set(errors) == {1} and set(results) == {0}
    _same_table(results[0], _pandas(c["df"], "k", "s"))
    _settled(c["controller"])


def test_identical_queries_share_dispatch_at_window_zero(swarm_cluster,
                                                          monkeypatch):
    """Two concurrent IDENTICAL queries at window 0 join one dispatch."""
    c = swarm_cluster
    controller = c["controller"]
    monkeypatch.delenv("BQUERYD_TPU_BATCH_WINDOW_MS", raising=False)
    # the worker busy, so that both plans find the unit still queued
    controller.worker_map[next(iter(controller.worker_map))]["busy"] = True
    shared = controller.counters["plan_shared_dispatches"]
    dispatched = controller.counters["dispatched_shards"]
    query = (c["shards"], ["k"], [["v", "sum", "s"]], [["w", ">", 4.44]])

    def release():
        wait_until(lambda: len(controller.rpc_segments) == 2,
                   desc="both plans launched")
        controller.worker_map[next(iter(controller.worker_map))][
            "busy"] = False

    t = threading.Thread(target=release, daemon=True)
    t.start()
    results, errors = _concurrent(c["url"], [query, query])
    t.join(10)
    assert not errors
    assert controller.counters["plan_shared_dispatches"] - shared >= 1
    assert controller.counters["dispatched_shards"] - dispatched == 1
    for i in (0, 1):
        _same_table(results[i], _pandas(c["df"], "k", "s", term=4.44))


def test_reference_client_reads_bundle_members(swarm_cluster, monkeypatch):
    """A JAX ``RPC`` among the members of a port bundle reads its own
    member's answer (the demultiplexed reply envelope)."""
    from bqueryd_tpu.rpc import RPC as JaxRPC

    c = swarm_cluster
    df, shards, url = c["df"], c["shards"], c["url"]
    monkeypatch.setenv("BQUERYD_TPU_BATCH_WINDOW_MS", "400")
    before = c["controller"].counters["plan_bundles"]
    out = {}

    def jax_client():
        client = JaxRPC(coordination_url=url, timeout=RPC_TIMEOUT,
                        retries=1, loglevel=QUIET)
        try:
            out["jax"] = client.groupby(shards, ["k"], [["v", "sum", "s"]],
                                        [["w", ">", 3.3]])
            out["modes"] = client.last_call_merge_modes
        finally:
            client._close_socket()

    t = threading.Thread(target=jax_client, daemon=True)
    t.start()
    results, errors = _concurrent(url, [
        (shards, ["k"], [["v", "sum", "s"]], [["w", ">", 6.6]])])
    t.join(RPC_TIMEOUT + 10)
    assert not errors
    assert c["controller"].counters["plan_bundles"] == before + 1
    want = _pandas(df, "k", "s", term=3.3).sort_values("k")
    got = out["jax"].sort_values("k")
    np.testing.assert_array_equal(got["k"].to_numpy(), want["k"].to_numpy())
    np.testing.assert_array_equal(got["s"].to_numpy(), want["s"].to_numpy())
    assert set(out["modes"].values()) == {"device"}
    _same_table(results[0], _pandas(df, "k", "s", term=6.6))

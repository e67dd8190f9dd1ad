"""The port worker's ``rollup`` verb against the JAX worker's.

The same ``rollup`` CalcMessage goes to the port's ``WorkerNode.handle_work``
(on the CPU, ``device="cpu"``) and to the JAX ``WorkerNode``'s, over one
shard written by the JAX package's ctable with ``tests/test_serving.py``'s
frames.  The replies are compared mode for mode (``rebuild``, ``fresh``
after no growth, ``delta`` after an append, ``rebuild`` on a bad growth
base, an extended DAG), and so are the decoded partials, the column census
(``rollup_zones``) and the growth base (``rollup_base``); the partials are
also finalized against pandas.  Tolerances: keys, row counts and ints
bit-equal; float sums and means within
``tests/test_differential_fuzz.py:_compare``'s rtol 2e-5, atol 1e-6.
"""

import logging

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.messages import CalcMessage as JaxCalcMessage
from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from bqueryd_tpu_torch import messages
from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.plan import dag as dagmod
from test_serving import _frame
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6
QUIET = logging.WARNING
AGGS = [["v", "sum", "vs"], ["f", "mean", "fm"]]


def _msg(fname, keys=("g",), aggs=None, where=None, prior=None, base=None,
         dag=None):
    """One ``rollup`` CalcMessage, as ``tests/test_serving.py`` builds it
    (the JAX package's class; the port parses the same JSON)."""
    msg = JaxCalcMessage({"payload": "rollup", "token": "rollup_test"})
    msg.set_args_kwargs(
        [fname, list(keys), aggs or AGGS, where or []], {"aggregate": True}
    )
    if prior is not None:
        msg.add_as_binary("rollup_prior", prior)
        msg.add_as_binary("rollup_base", base)
    if dag is not None:
        msg.add_as_binary("dag", dag.to_wire())
    return msg


@pytest.fixture
def workers(tmp_path, mem_store_url):
    """``(port worker, JAX worker, data dir)`` over one data dir."""
    from bqueryd_tpu.worker import WorkerNode as JaxWorker
    from bqueryd_tpu_torch.worker import WorkerNode

    port = WorkerNode(coordination_url=f"mem://rollup-{tmp_path.name}",
                      data_dir=str(tmp_path), loglevel=QUIET, device="cpu")
    ref = JaxWorker(coordination_url=mem_store_url, data_dir=str(tmp_path),
                    loglevel=QUIET, restart_check=False)
    try:
        yield port, ref, tmp_path
    finally:
        port.socket.close()
        ref.socket.close()


def _both(port, ref, msg):
    """The port's and the JAX worker's replies to the same message."""
    got = port.handle_work(messages.msg_factory(msg.to_json()))
    want = ref.handle_work(msg.copy())
    return got, want


def _same_payload(got, want):
    """Keys, rows and ints bit-equal with their dtypes; floats within rtol
    2e-5, atol 1e-6."""
    assert got["kind"] == want["kind"]
    assert list(got["key_cols"]) == list(want["key_cols"])
    assert list(got["ops"]) == list(want["ops"])
    for col in want["keys"]:
        np.testing.assert_array_equal(got["keys"][col], want["keys"][col])
    np.testing.assert_array_equal(got["rows"], want["rows"])
    for g, w in zip(got["aggs"], want["aggs"]):
        assert set(g) == set(w)
        for name in w:
            a, b = np.asarray(g[name]), np.asarray(w[name])
            if b.dtype.kind == "f" and name != "topk_values":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b)


def _same_reply(got, want, mode):
    """Equal modes, partials, census and growth base; the request's prior,
    base, DAG and params are not echoed."""
    assert got.get("rollup_mode") == want.get("rollup_mode") == mode
    _same_payload(ResultPayload.from_bytes(got["data"]),
                  ResultPayload.from_bytes(want["data"]))
    assert (got.get_from_binary("rollup_zones")
            == want.get_from_binary("rollup_zones"))
    assert (got.get_from_binary("rollup_base")
            == want.get_from_binary("rollup_base"))
    assert "params" not in got and "dag" not in got
    assert "rollup_prior" not in got
    assert isinstance(got["phase_timings"], dict)


def _finalized(reply, keys):
    merged = hostmerge.merge_payloads([ResultPayload.from_bytes(reply["data"])])
    return (hostmerge.payload_to_dataframe(merged).sort_values(list(keys))
            .reset_index(drop=True))


def _pandas_agg(df, keys=("g",)):
    return (df.groupby(list(keys), as_index=False)
            .agg(vs=("v", "sum"), fm=("f", "mean"))
            .sort_values(list(keys)).reset_index(drop=True))


def _against_pandas(got, want):
    np.testing.assert_array_equal(got["vs"], want["vs"])
    np.testing.assert_allclose(got["fm"].to_numpy(), want["fm"].to_numpy(),
                               rtol=RTOL, atol=ATOL)


def test_rollup_build_census_and_parity(workers):
    port, ref, root = workers
    df = _frame(1500, seed=11)
    jax_ctable.fromdataframe(df, str(root / "t.bcolzs"), chunklen=256)
    got, want = _both(port, ref, _msg("t.bcolzs", keys=("g", "g2")))
    _same_reply(got, want, "rebuild")
    assert ResultPayload.from_bytes(got["data"])["kind"] == "partials"
    _against_pandas(_finalized(got, ("g", "g2")), _pandas_agg(df, ("g", "g2")))
    # the census carries what the subsumption proofs need
    zones = got.get_from_binary("rollup_zones")
    assert zones["g"]["kind"] == "int" and not zones["g"]["nulls"]
    assert zones["f"]["kind"] == "float" and zones["f"]["nulls"]
    assert zones["s"]["kind"] == "dict" and zones["s"]["zones"] is None
    assert [z[0] for z in zones["seq"]["zones"]][:2] == [0, 256]
    assert got.get_from_binary("rollup_base")["rows"] == 1500


def test_rollup_refresh_fresh_delta_and_rebuild(workers):
    port, ref, root = workers
    path = str(root / "t.bcolzs")
    df = _frame(1500, seed=12)
    jax_ctable.fromdataframe(df, path, chunklen=256)
    first, first_ref = _both(port, ref, _msg("t.bcolzs"))
    _same_reply(first, first_ref, "rebuild")
    base = first_ref.get_from_binary("rollup_base")
    # no growth: the prior partials come back untouched
    again, again_ref = _both(port, ref, _msg(
        "t.bcolzs", prior=first_ref["data"], base=base))
    _same_reply(again, again_ref, "fresh")
    assert again["data"] == first_ref["data"]
    # an append: only the tail is aggregated and merged into the prior
    extra = _frame(300, seed=13, offset=1500)
    jax_ctable(path, mode="a").append_dataframe(extra)
    delta, delta_ref = _both(port, ref, _msg(
        "t.bcolzs", prior=first_ref["data"], base=base))
    _same_reply(delta, delta_ref, "delta")
    full = pd.concat([df, extra], ignore_index=True)
    _against_pandas(_finalized(delta, ("g",)), _pandas_agg(full))
    assert delta.get_from_binary("rollup_base")["rows"] == 1800
    # a bad growth base rebuilds from scratch
    rebuilt, rebuilt_ref = _both(port, ref, _msg(
        "t.bcolzs", prior=first_ref["data"], base=b"bogus"))
    _same_reply(rebuilt, rebuilt_ref, "rebuild")
    _against_pandas(_finalized(rebuilt, ("g",)), _pandas_agg(full))


def test_rollup_with_filter_and_port_prior(workers):
    """A filtered rollup refreshed from the PORT's own prior and base: the
    port's growth base drives the JAX worker's delta as well."""
    port, ref, root = workers
    path = str(root / "t.bcolzs")
    df = _frame(2000, seed=14)
    jax_ctable.fromdataframe(df, path, chunklen=300)
    where = [["seq", ">", 500]]
    first, first_ref = _both(port, ref, _msg("t.bcolzs", where=where))
    _same_reply(first, first_ref, "rebuild")
    extra = _frame(700, seed=15, offset=2000)
    jax_ctable(path, mode="a").append_dataframe(extra)
    delta, delta_ref = _both(port, ref, _msg(
        "t.bcolzs", where=where, prior=first["data"],
        base=first.get_from_binary("rollup_base")))
    _same_reply(delta, delta_ref, "delta")
    full = pd.concat([df, extra], ignore_index=True)
    _against_pandas(_finalized(delta, ("g",)),
                    _pandas_agg(full[full["seq"] > 500]))


def test_extended_dag_rollup_rebuilds_through_execute_dag(workers):
    """An extended DAG's rollup always rebuilds (even with a prior and a
    valid base), through the worker's DAG route: on the port the fast
    path, one device merge."""
    port, ref, root = workers
    path = str(root / "t.bcolzs")
    df = _frame(1500, seed=16)
    jax_ctable.fromdataframe(df, path, chunklen=256)
    spec = {"table": ["t.bcolzs"], "groupby": ["g"],
            "aggs": [["v", "sum", "vs"], ["v", "topk", "top3", {"k": 3}],
                     ["f", "quantile", "p50", {"q": 0.5}]]}
    dag = dagmod.compile_query(spec)
    plan, _kwargs = dagmod.groupby_equivalent(dag)
    msg = _msg("t.bcolzs", keys=plan.groupby.keys,
               aggs=plan.physical_agg_list(), dag=dag)
    ran = []
    execute_dag = port.executor.execute_dag

    def spy(tables, dag_):
        ran.append(len(tables))
        return execute_dag(tables, dag_)

    port.executor.execute_dag = spy
    got, want = _both(port, ref, msg)
    _same_reply(got, want, "rebuild")
    assert ran == [1]
    base = want.get_from_binary("rollup_base")
    msg = _msg("t.bcolzs", keys=plan.groupby.keys,
               aggs=plan.physical_agg_list(), dag=dag, prior=want["data"],
               base=base)
    got, want = _both(port, ref, msg)
    _same_reply(got, want, "rebuild")
    frame = _finalized(got, ("g",))
    for i, g in enumerate(frame["g"]):
        part = df[df["g"] == g]
        assert int(frame["vs"][i]) == int(part["v"].sum())
        np.testing.assert_array_equal(
            frame["top3"][i], np.sort(part["v"].to_numpy())[::-1][:3])
        e = float(np.quantile(part["f"].astype(np.float64), 0.5,
                              method="lower"))
        assert abs(float(frame["p50"][i]) - e) <= abs(e) * 0.01 + 1e-9


def test_rollup_unknown_shard_raises(workers):
    port, _ref, _root = workers
    with pytest.raises(ValueError, match="does not exist"):
        port.handle_work(messages.msg_factory(_msg("nope.bcolzs").to_json()))

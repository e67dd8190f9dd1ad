"""The port's control plane against the reference's: a port cluster (port
controller, port calc worker on the CPU, port ``RPC``) and a reference
cluster (the same three from ``bqueryd_tpu``, JAX on the CPU) run as
threads in this process and answer the same queries over TCP ZMQ.

The data and the query cases are the differential fuzz's
(``tests/test_differential_fuzz.py``), plus the shapes of
``tests/test_rpc_cluster.py``: one file, sharded, filtered, raw rows and
``batch=False``.  Ints must match bit for bit, floats within ``_compare``'s
tolerance.  Then the port's own contracts: one device merge per batched
shard group, structured errors that reach the client in time, messages and
replies that parse under either package, the worker's device resolution,
and the CLI.

Every node binds and advertises 127.0.0.1 (``BQUERYD_TPU_IP``), every RPC
waits at most ``RPC_TIMEOUT`` seconds once, and the nodes' threads are
joined on teardown.
"""

import logging
import os
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pandas as pd
import pytest

from bqueryd_tpu.storage.ctable import ctable as jax_ctable
from tests.conftest import wait_until
from test_differential_fuzz import (
    CASES,
    RAW_CASES,
    _compare,
    _dataset,
    _expected,
    _filter_df,
)
from tests.torch_fixtures import fresh_port_calibration  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPC_TIMEOUT = 30
PORT_CASES = list(range(len(CASES)))
QUIET = logging.WARNING


@pytest.fixture(scope="module")
def loopback():
    """Nodes advertise 127.0.0.1, for the module's duration."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BQUERYD_TPU_IP", "127.0.0.1")
        yield


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The fuzz dataset written by the JAX package's ctable, served by both
    clusters from one directory."""
    root = tmp_path_factory.mktemp("torch_cluster")
    frames = _dataset(20241016)
    names = []
    for i, df in enumerate(frames):
        name = f"shard_{i}.bcolzs"
        jax_ctable.fromdataframe(df, str(root / name))
        names.append(name)
    return str(root), frames, names


@contextmanager
def running(nodes):
    """Each node's loop on a thread of its own; stopped and joined on
    exit."""
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


@contextmanager
def port_cluster(url, data_dir):
    from bqueryd_tpu_torch.controller import ControllerNode
    from bqueryd_tpu_torch.rpc import RPC
    from bqueryd_tpu_torch.worker import WorkerNode

    controller = ControllerNode(
        coordination_url=url, loglevel=QUIET, runfile_dir=data_dir,
        heartbeat_interval=0.2,
    )
    worker = WorkerNode(
        coordination_url=url, data_dir=data_dir, loglevel=QUIET,
        heartbeat_interval=0.2, poll_timeout=0.05, device="cpu",
    )
    with running([controller, worker]):
        wait_until(lambda: len(controller.files_map) >= 3,
                   desc="port worker registration")
        rpc = RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
                  loglevel=QUIET)
        try:
            yield {"rpc": rpc, "controller": controller, "worker": worker}
        finally:
            rpc._close_socket()


@pytest.fixture(scope="module")
def port(loopback, shards):
    data_dir, _frames, _names = shards
    with port_cluster(f"mem://torch-cluster-{os.urandom(4).hex()}",
                      data_dir) as cluster:
        yield cluster


@pytest.fixture(scope="module")
def ref(loopback, shards):
    from bqueryd_tpu.controller import ControllerNode
    from bqueryd_tpu.rpc import RPC
    from bqueryd_tpu.worker import WorkerNode

    data_dir, _frames, _names = shards
    url = f"mem://ref-cluster-{os.urandom(4).hex()}"
    controller = ControllerNode(
        coordination_url=url, loglevel=QUIET, runfile_dir=data_dir,
        heartbeat_interval=0.2,
    )
    worker = WorkerNode(
        coordination_url=url, data_dir=data_dir, loglevel=QUIET,
        restart_check=False, heartbeat_interval=0.2, poll_timeout=0.05,
    )
    with running([controller, worker]):
        wait_until(lambda: len(controller.files_map) >= 3,
                   desc="reference worker registration")
        rpc = RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
                  loglevel=QUIET)
        try:
            yield {"rpc": rpc, "controller": controller}
        finally:
            rpc._close_socket()


def frame(result):
    """A port ``(order, columns)`` result as the reference client's
    DataFrame (object dtype for strings, as ``payload_to_dataframe``)."""
    order, columns = result
    data = {
        c: pd.Series(columns[c], dtype=object)
        if columns[c].dtype == object else columns[c]
        for c in order
    }
    return pd.DataFrame(data, columns=order)


@pytest.mark.parametrize("case_i", PORT_CASES)
def test_port_cluster_matches_reference_cluster(shards, port, ref, case_i):
    _data_dir, frames, names = shards
    gcols, aggs, where = CASES[case_i]
    got = frame(port["rpc"].groupby(names, gcols, aggs, where))
    want = ref["rpc"].groupby(names, gcols, aggs, where)
    _compare(got, want, gcols, aggs)
    _compare(got, _expected(frames, gcols, aggs, where), gcols, aggs)


# the shapes of test_rpc_cluster: one file, filtered, batch=False
SHAPES = {
    "one_file": (slice(0, 1), ["k_int"],
                 [["v_small", "sum", "s"], ["v_float", "mean", "m"],
                  ["v_small", "count", "n"]], [], {}),
    "filtered_str_key": (slice(None), ["k_str"],
                         [["v_big", "sum", "s"], ["v_float", "max", "hi"]],
                         [["sel", ">", 0.5]], {}),
    "batch_false": (slice(None), ["k_int", "k_str"],
                    [["v_small", "sum", "s"], ["v_float", "mean", "m"]],
                    [], {"batch": False}),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_port_cluster_shapes_match_reference(shards, port, ref, shape):
    _data_dir, frames, names = shards
    sl, gcols, aggs, where, kwargs = SHAPES[shape]
    rpc = port["rpc"]
    got = frame(rpc.groupby(names[sl], gcols, aggs, where, **kwargs))
    want = ref["rpc"].groupby(names[sl], gcols, aggs, where, **kwargs)
    _compare(got, want, gcols, aggs)
    _compare(got, _expected(frames[sl], gcols, aggs, where), gcols, aggs)
    groups = len(names[sl]) if kwargs.get("batch") is False else 1
    assert len(rpc.last_call_timings) == groups
    assert set(rpc.last_call_timings) == set(ref["rpc"].last_call_timings)
    # the executor serves every group, one shard or several
    assert set(rpc.last_call_merge_modes.values()) == {"device"}


@pytest.mark.parametrize("case_i", range(len(RAW_CASES)))
def test_raw_rows_match_reference_cluster(shards, port, ref, case_i):
    """aggregate=False: the filtered rows of every shard, concatenated in
    the requested filename order by both clusters."""
    _data_dir, frames, names = shards
    gcols, in_cols, where = RAW_CASES[case_i]
    aggs = [[c, "sum", c] for c in in_cols]
    rpc = port["rpc"]
    got = frame(rpc.groupby(names, gcols, aggs, where, aggregate=False))
    want = ref["rpc"].groupby(names, gcols, aggs, where, aggregate=False)
    cols = list(dict.fromkeys(gcols + in_cols))
    assert list(got.columns) == list(want.columns) == cols
    expected = _filter_df(pd.concat(frames, ignore_index=True), where)[cols]
    assert len(got) == len(want) == len(expected)
    for c in cols:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            assert g.astype(str).tolist() == w.astype(str).tolist(), c
    # one message per shard, merged on the client
    assert len(rpc.last_call_timings) == len(names)


def test_batched_group_merges_once_on_the_device(shards, port, monkeypatch):
    """Co-located mergeable shards travel as ONE CalcMessage; the worker's
    executor runs ONE partial_tables call over all their rows and reports
    the device merge."""
    from bqueryd_tpu_torch import ops

    _data_dir, frames, names = shards
    calls = []
    real = ops.partial_tables

    def counting(*args, **kwargs):
        calls.append(threading.current_thread().name)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "partial_tables", counting)
    # the heuristic hints alone: no wall an earlier query recorded
    # steers this one
    monkeypatch.setenv("BQUERYD_TPU_CALIB", "0")
    rpc, controller = port["rpc"], port["controller"]
    wait_until(lambda: all(n in controller.shard_stats for n in names),
               desc="every shard's advertised stats")
    gcols, aggs = ["k_int"], [["v_small", "sum", "s"], ["v_big", "max", "x"]]
    got = frame(rpc.groupby(names, gcols, aggs, []))
    _compare(got, _expected(frames, gcols, aggs, []), gcols, aggs)
    assert len(calls) == 1
    # the worker's loop thread ran it, not the controller's or this one
    assert calls[0] != threading.current_thread().name
    (key,) = rpc.last_call_timings
    assert key == f"{names[0]}+{len(names) - 1}more"
    assert rpc.last_call_merge_modes == {key: "device"}
    # one hint for the whole group: the heuristic's choice from the
    # advertised stats, the reference's on the same stats
    from bqueryd_tpu.plan import strategy as jax_strategy
    from bqueryd_tpu_torch.plan import strategy

    hint = strategy.select_for_group(controller.shard_stats, names, gcols)[0]
    assert hint == jax_strategy.select_for_group(
        controller.shard_stats, names, gcols)[0]
    assert rpc.last_call_strategies["hints"] == {hint: len(names)}
    assert rpc.last_call_strategies["effective"][key] in (
        "matmul", "scatter", "sort")
    timings = rpc.last_call_timings[key]
    assert set(timings) >= {"open", "execute", "serialize", "_total"}
    assert rpc.last_call_reply_bytes > 0
    assert rpc.last_call_client_merge_s > 0


def _timed_error(rpc, *args, **kwargs):
    from bqueryd_tpu_torch.rpc import RPCError

    t0 = time.perf_counter()
    with pytest.raises(RPCError) as err:
        rpc.groupby(*args, **kwargs)
    assert time.perf_counter() - t0 < RPC_TIMEOUT
    assert rpc.last_call_attempts == 1
    return err.value


def test_unknown_file_errors(port):
    err = _timed_error(port["rpc"], ["nope.bcolzs"], ["k_int"],
                       [["v_small", "sum", "s"]], [])
    assert "not found" in str(err)


def test_unsupported_op_is_a_structured_error(shards, port):
    _data_dir, _frames, names = shards
    err = _timed_error(port["rpc"], names, ["k_int"],
                       [["v_small", "median", "s"]], [])
    assert err.error_class == "UnsupportedOp"
    assert "median" in str(err)


@pytest.mark.parametrize("op", ["count_distinct", "sorted_count_distinct"])
@pytest.mark.parametrize("n_files", [1, 3])
def test_distinct_ops_match_reference_cluster(shards, port, ref, op,
                                              n_files):
    """The distinct ops go one shard per message; one file's payload is
    sole (count_distinct ships device-sorted counts), several files'
    count_distinct sets union at the client.  Ints bit for bit against the
    reference cluster."""
    _data_dir, frames, names = shards
    gcols = ["k_str"]
    aggs = [["v_small", op, "d"], ["v_float", "sum", "s"]]
    rpc = port["rpc"]
    got = frame(rpc.groupby(names[:n_files], gcols, aggs, []))
    want = ref["rpc"].groupby(names[:n_files], gcols, aggs, [])
    _compare(got, want, gcols, aggs)
    got = got.sort_values(gcols).reset_index(drop=True)
    want = want.sort_values(gcols).reset_index(drop=True)
    assert got["d"].dtype == np.int64
    np.testing.assert_array_equal(got["d"].to_numpy(), want["d"].to_numpy())
    assert len(rpc.last_call_timings) == n_files
    assert set(rpc.last_call_merge_modes.values()) == {"none"}
    if op == "count_distinct":
        _compare(got, _expected(frames[:n_files], gcols, aggs[:1], []),
                 gcols, aggs[:1])


@pytest.mark.parametrize(
    "where", [[["sel", ">", 0.97]], [["v_small", ">", 900]]])
def test_basket_expansion_matches_reference_cluster(shards, port, ref,
                                                    where):
    """expand_filter_column through both clusters: the shard group runs on
    the worker's executor, each shard's filter widened to whole baskets."""
    _data_dir, frames, names = shards
    gcols, aggs = ["k_int"], [["v_small", "sum", "s"],
                              ["v_float", "mean", "m"]]
    rpc = port["rpc"]
    got = frame(rpc.groupby(names, gcols, aggs, where,
                            expand_filter_column="basket"))
    want = ref["rpc"].groupby(names, gcols, aggs, where,
                              expand_filter_column="basket")
    _compare(got, want, gcols, aggs)
    expanded = []
    for df in frames:
        hit = _filter_df(df, where).index
        expanded.append(df[df["basket"].isin(df.loc[hit, "basket"].unique())])
    _compare(got, _expected(expanded, gcols, aggs, []), gcols, aggs)
    assert set(rpc.last_call_merge_modes.values()) == {"device"}


def test_sorted_count_distinct_on_basket_sorted_data(shards, port, ref):
    """Shards sorted by (group, value), the layout the op exists for: the
    run counts summed across shards equal pandas nunique per shard, through
    both clusters (the reference fuzz's test of the same name)."""
    data_dir, _frames, _names = shards
    rng = np.random.default_rng(77)
    frames, names = [], []
    for i in range(2):
        n = 3_000
        df = pd.DataFrame({
            "g": np.sort(rng.integers(0, 5, n)).astype(np.int64),
            "v": rng.integers(0, 40, n).astype(np.int64),
        }).sort_values(["g", "v"], kind="stable").reset_index(drop=True)
        name = f"sorted_{i}.bcolzs"
        jax_ctable.fromdataframe(df, os.path.join(data_dir, name))
        frames.append(df)
        names.append(name)
    for cluster in (port, ref):
        wait_until(lambda c=cluster: all(
            n in c["controller"].files_map for n in names),
            desc="the sorted shards' registration")
    aggs = [["v", "sorted_count_distinct", "nd"]]
    expected = sum(
        df.groupby("g")["v"].nunique() for df in frames
    ).sort_index()
    for got in (frame(port["rpc"].groupby(names, ["g"], aggs, [])),
                ref["rpc"].groupby(names, ["g"], aggs, [])):
        got = got.sort_values("g").reset_index(drop=True)
        assert got["g"].tolist() == expected.index.tolist()
        assert got["nd"].tolist() == expected.tolist()


def test_messages_parse_under_either_package(shards):
    """A CalcMessage and an RPCMessage of either package parse under the
    other's factory with the same params and plan fragment, and both
    controllers compile the same fragment for every fuzz case."""
    from bqueryd_tpu import messages as ref_messages
    from bqueryd_tpu import plan as ref_plan
    from bqueryd_tpu_torch import messages as port_messages
    from bqueryd_tpu_torch import plan as port_plan

    _data_dir, _frames, names = shards
    for gcols, aggs, where in CASES:
        ref_logical = ref_plan.plan_groupby(names, gcols, aggs, where)
        port_logical = port_plan.plan_groupby(names, gcols, aggs, where)
        assert port_logical.signature() == ref_logical.signature()
        assert port_logical.rewrites == ref_logical.rewrites
        ref_frag = ref_plan.fragment_for(ref_logical, names)
        port_frag = port_plan.fragment_for(port_logical, names)
        assert port_frag == ref_frag
        assert (port_plan.fragment_to_query(port_frag).signature()
                == port_plan.fragment_to_query(ref_frag).signature())
    for src, dst in ((port_messages, ref_messages),
                     (ref_messages, port_messages)):
        calc = src.CalcMessage({"payload": "groupby"})
        calc.set_args_kwargs([names, ["k_int"], [["v_small", "sum", "s"]],
                              []], {"aggregate": True})
        calc["token"], calc["parent_token"] = "t0", "p0"
        calc["filename"] = names
        calc.set_deadline(seconds=5)
        calc.add_as_binary("plan", ref_frag)
        rpc = src.RPCMessage({"payload": "groupby"})
        rpc.set_args_kwargs([names], {})
        for msg, cls in ((calc, dst.CalcMessage), (rpc, dst.RPCMessage)):
            parsed = dst.msg_factory(msg.to_json().encode())
            assert type(parsed) is cls
            assert parsed.get_args_kwargs() == msg.get_args_kwargs()
            assert dict(parsed) == dict(msg)
        parsed = dst.msg_factory(calc.to_json())
        assert parsed.get_from_binary("plan") == ref_frag
        assert 0 < parsed.deadline_remaining() <= 5


def test_reference_client_reads_a_port_cluster(loopback, shards, ref,
                                               tmp_path):
    """The reference ``RPC``, finding a port controller through a file://
    store, parses the port's reply envelope into the same DataFrame the
    reference cluster gives."""
    from bqueryd_tpu.rpc import RPC as RefRPC

    data_dir, _frames, names = shards
    url = f"file://{tmp_path / 'store'}"
    with port_cluster(url, data_dir):
        client = RefRPC(coordination_url=url, timeout=RPC_TIMEOUT,
                        retries=1, loglevel=QUIET)
        try:
            for gcols, aggs, where in (CASES[5], CASES[11]):
                got = client.groupby(names, gcols, aggs, where)
                want = ref["rpc"].groupby(names, gcols, aggs, where)
                _compare(got, want, gcols, aggs)
                assert list(got.columns) == list(want.columns)
                assert client.last_call_merge_modes == {
                    f"{names[0]}+{len(names) - 1}more": "device"}
            # count_distinct: the reference client unions the port
            # workers' value sets, one payload per shard
            for gcols, aggs, where in (CASES[17], CASES[18]):
                got = client.groupby(names, gcols, aggs, where)
                want = ref["rpc"].groupby(names, gcols, aggs, where)
                _compare(got, want, gcols, aggs)
                assert client.last_call_merge_modes == {
                    n: "none" for n in names}
            assert client.ping() == "pong"
        finally:
            client._close_socket()


def test_worker_node_needs_a_card_or_an_explicit_cpu(loopback, shards,
                                                     monkeypatch, tmp_path):
    """Without a card and without device="cpu" the worker raises before
    it opens a socket or registers anywhere."""
    import torch

    from bqueryd_tpu_torch.coordination import coordination_store
    from bqueryd_tpu_torch.worker import WorkerNode

    data_dir, _frames, _names = shards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    url = f"file://{tmp_path / 'store'}"
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            WorkerNode(coordination_url=url, data_dir=data_dir,
                       loglevel=QUIET, device=device)
    assert coordination_store(url).keys() == []


def test_cli_nodes_answer_a_query(loopback, shards, tmp_path):
    """``python -m bqueryd_tpu_torch.node controller`` and ``... worker
    --device=cpu`` as processes, found through a file:// store, answer a
    groupby from the port client; SIGTERM stops both."""
    from bqueryd_tpu_torch.rpc import RPC

    data_dir, frames, names = shards
    url = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, PYTHONPATH=REPO,
               BQUERYD_TPU_RUNFILE_DIR=str(tmp_path))
    node = [sys.executable, "-m", "bqueryd_tpu_torch.node"]
    procs = [
        subprocess.Popen(node + ["controller", f"--coordination={url}"],
                         cwd=str(tmp_path), env=env,
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE),
        subprocess.Popen(node + ["worker", f"--coordination={url}",
                                 f"--data_dir={data_dir}", "--device=cpu"],
                         cwd=str(tmp_path), env=env,
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE),
    ]
    try:
        wait_until(lambda: all(p.poll() is None for p in procs)
                   and _controller_registered(url), timeout=60, desc="CLI cluster")
        rpc = RPC(coordination_url=url, timeout=RPC_TIMEOUT, retries=1,
                  loglevel=QUIET)
        gcols, aggs = ["k_str"], [["v_small", "sum", "s"],
                                  ["v_float", "mean", "m"]]
        wait_until(lambda: _files_served(rpc, names), timeout=60,
                   desc="CLI worker serving every shard")
        got = frame(rpc.groupby(names, gcols, aggs, []))
        _compare(got, _expected(frames, gcols, aggs, []), gcols, aggs)
        rpc._close_socket()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
    for p in procs:
        assert p.returncode == 0, p.stderr.read().decode()[-2000:]


def _controller_registered(url):
    """True once a controller is registered in the store at ``url``."""
    import bqueryd_tpu_torch
    from bqueryd_tpu_torch.coordination import coordination_store

    return bool(coordination_store(url).smembers(
        bqueryd_tpu_torch.REDIS_SET_KEY))


def _files_served(rpc, names):
    workers = rpc.info()["workers"].values()
    served = {f for w in workers for f in w.get("data_files") or []}
    return set(names) <= served

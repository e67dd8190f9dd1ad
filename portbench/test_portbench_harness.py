"""The whole harness rehearsed on the CPU at a small size: every cell, a
cell added as files alone, the faults the check has to catch, and what
the harness may not import."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import harness, rehearse, spec

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ROWS = 200_000
#: the cells of BENCHMARK.json, then those of shelved.json
CELLS = ["taxi10m.dashboard-c8", "h2o1e7.basic-c1"]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_of_each_cell(tmpdir_env, cell_root, cell):
    root = cell_root(cell)
    result = rehearse.rehearse(cell, 2**31 + 31, 2.0, ROWS, root=root)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {
        m["name"] for m in spec.Cell(cell, root).end_to_end}
    assert {"qps", "setup_s"} <= set(result["metrics"])
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert "device" not in result
    assert list(result["checks"])[:3] == ["missing_groups", "int_mismatches",
                                          "float_rel_err"]
    assert not os.listdir(tmpdir_env)  # the run's directory is gone


def test_traced_rehearsal_reports_the_host_layers(tmpdir_env):
    result = rehearse.rehearse("taxi10m.dashboard-c8", 2**31 + 32, 2.0, ROWS,
                               trace=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"client_merge_ms", "dispatch_wait_ms",
                                      "worker_ms"}


def test_the_measurement_command_fails_without_a_card(tmpdir_env):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


DUMMY_READER = '''"""``queries_seen``: queries sent in the window."""


def read(window):
    return float(len(window.records))
'''


def _add_mini_cell(root, bench, chips=1):
    """A mini configuration, mix and reader, added as files alone: the
    cell ``mini.c2`` on ``chips`` cards."""
    cfg = {"name": "mini", "rows": 40_000, "shards": 2, "table_prefix": "mini",
           "columns": [
               {"name": "k", "kind": "int", "dtype": "int64", "low": 0,
                "high": 7},
               {"name": "s", "kind": "dict", "format": "v{}", "low": 0,
                "high": 30},
               {"name": "x", "kind": "float", "dtype": "float64", "low": 0.0,
                "high": 1.0}],
           "env": {"BQUERYD_TPU_RESULT_CACHE_BYTES": "0"},
           "limits": {"missing_groups": 0, "int_mismatches": 0,
                      "float_rel_err": 1e-9}}
    (root / "portbench/configs/mini.json").write_text(json.dumps(cfg))
    traffic = {"loop": "closed", "clients": 2, "order": "cycle",
               "shapes": {"a": {"shards": "all", "groupby": ["k", "s"],
                                "aggs": [["x", "mean", "xm"],
                                         ["k", "count", "n"]]}}}
    (root / "portbench/traffic/mini-c2.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/queries_seen.py").write_text(DUMMY_READER)
    bench["configs"].append({"name": "mini", "source": "a test",
                             "file": "portbench/configs/mini.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mini.c2", "config": "mini",
                               "traffic": "mini-c2", "chips": chips,
                               "why": "a test"})
    bench["per_layer"].append({"name": "queries_seen", "unit": "queries",
                               "better": "higher",
                               "source": "program_counter", "layer": "client",
                               "moves": "qps", "workloads": ["mini.c2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_added_as_files_alone_runs(checkout, tmpdir_env):
    root, bench = checkout
    _add_mini_cell(root, bench)
    result = rehearse.rehearse("mini.c2", 5, 1.0, None, trace=True,
                               root=str(root))
    assert result["correct"]
    assert result["metrics"]["queries_seen"]["value"] == result["attempted"]


def _logged(err, prefix):
    """The JSON that the harness logged after ``prefix``."""
    lines = [line for line in err.splitlines()
             if line.startswith(f"[portbench] {prefix}")]
    assert lines, prefix
    return json.loads(lines[-1][len(f"[portbench] {prefix}"):])


def test_a_four_card_cell_runs_one_worker_over_four_devices(
        checkout, tmpdir_env, capsys):
    root, bench = checkout
    _add_mini_cell(root, bench, chips=4)
    result = rehearse.rehearse("mini.c2", 2**31 + 41, 1.0, None, trace=True,
                               root=str(root))
    err = capsys.readouterr().err
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert _logged(err, "worker ready: ")["devices"] == ["cpu"] * 4
    # the window's merge counters (metrics_before -> metrics_after)
    deltas = _logged(err, "worker /metrics deltas over the window: ")
    assert deltas['bqueryd_tpu_merge_queries{mode="device"}'] > 0
    assert deltas["bqueryd_tpu_merge_d2h_bytes_saved"] > 0
    assert 'bqueryd_tpu_merge_queries{mode="host"}' not in deltas


def test_a_worker_over_other_devices_than_the_cell_asks_ends_the_run(
        checkout, tmpdir_env, monkeypatch):
    root, bench = checkout
    _add_mini_cell(root, bench, chips=4)
    spawn = harness.spawn

    def two_cards(cmd, env, log_path):
        if "--cards" in cmd:
            cmd = list(cmd)
            cmd[cmd.index("--cards") + 1] = "2"
        return spawn(cmd, env, log_path)

    monkeypatch.setattr(harness, "spawn", two_cards)
    with pytest.raises(harness.RunError, match=r"asks for 4 cards; the "
                       r"worker runs over 2"):
        rehearse.rehearse("mini.c2", 2**31 + 43, 1.0, None, root=str(root))
    assert os.listdir(tmpdir_env) == ["checkout"]  # the run's dir is gone


FORKING_NODE = """
import os, signal, sys, time
child = os.fork()
if child == 0:
    signal.signal(signal.SIGTERM, signal.SIG_IGN)  # outlives a SIGTERM
    time.sleep(600)
    os._exit(0)
with open(sys.argv[1], "w") as f:
    f.write(str(child))
time.sleep(600)
"""


def test_the_deployment_reaps_what_its_nodes_start(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "GROUP_GRACE_S", 1.0)
    pid_file = tmp_path / "child.pid"
    proc = harness.spawn([sys.executable, "-c", FORKING_NODE, str(pid_file)],
                         dict(os.environ), str(tmp_path / "node.log"))
    try:
        harness._wait(pid_file.exists, 60, "the node's child")
        harness._wait(pid_file.read_text, 60, "the child's pid")
        child = int(pid_file.read_text())
        assert os.getpgid(proc.pid) == proc.pid != os.getpgid(0)
        assert sorted(harness.group_members(proc.pid)) == sorted(
            [proc.pid, child])
        harness.reap({"node": proc})
        assert proc.returncode is not None
        assert harness.group_members(proc.pid) == []
    finally:
        if harness.group_members(proc.pid):
            os.killpg(proc.pid, 9)


def test_only_the_workers_cards_are_sampled(tmp_path):
    assert harness.smi_cards(1, {}) == ["0"]
    assert harness.smi_cards(4, {}) == ["0", "1", "2", "3"]
    visible = {"CUDA_VISIBLE_DEVICES": "3, 5,GPU-ab12,7"}
    assert harness.smi_cards(1, visible) == ["3"]
    assert harness.smi_cards(3, visible) == ["3", "5", "GPU-ab12"]
    assert harness.smi_cards(1, {"CUDA_VISIBLE_DEVICES": ""}) == []
    assert harness._nvidia_smi_sampler(str(tmp_path), []) is None
    rows = ["0, 1980, 2619, 110.5, 700.00, 40", "0, 1755, 2619, 300.0, 700.00,"
            " 44", "0, 1800, 2619, 200.0, 700.00, 42"]
    (tmp_path / "smi.csv").write_text("\n".join(rows) + "\n")
    one = harness._smi_summary(str(tmp_path))
    assert list(one) == ["sm_mhz", "mem_mhz", "power_w", "power_limit_w",
                         "temp_c"]
    assert one["sm_mhz"] == [1755.0, 1800.0, 1980.0]
    rows += ["2, 1500, 2619, 90.0, 500.00, 30"]
    (tmp_path / "smi.csv").write_text("\n".join(rows) + "\n")
    two = harness._smi_summary(str(tmp_path))
    assert two == {"card 0": one, "card 2": {
        "sm_mhz": [1500.0] * 3, "mem_mhz": [2619.0] * 3,
        "power_w": [90.0] * 3, "power_limit_w": [500.0] * 3,
        "temp_c": [30.0] * 3}}


JAX_READER = '''"""``loads_jax``: a reader that imports a module named ``jax``."""

import os
import sys


def read(window):
    sys.path.insert(0, os.environ["PORTBENCH_TEST_STUBS"])
    try:
        import jax  # noqa: F401
    finally:
        sys.path.pop(0)
    return 1.0
'''


def test_a_reader_that_loads_jax_leaves_the_run_without_a_result(
        tmp_path, checkout, tmpdir_env, monkeypatch):
    root, bench = checkout
    stubs = tmp_path / "stubs"
    (stubs / "jax").mkdir(parents=True)
    (stubs / "jax" / "__init__.py").write_text('"""A stub."""\n')
    monkeypatch.setenv("PORTBENCH_TEST_STUBS", str(stubs))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    (root / "portbench/metrics/loads_jax.py").write_text(JAX_READER)
    bench["per_layer"].append({"name": "loads_jax", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "client", "moves": "qps",
                               "workloads": [CELLS[0]]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        with pytest.raises(harness.RunError, match=r"loaded here: \['jax'\]"):
            rehearse.rehearse(CELLS[0], 7, 1.0, ROWS, trace=True,
                              root=str(root))
    finally:
        sys.modules.pop("jax", None)


def test_the_command_prints_no_result_with_jax_loaded(monkeypatch, capsys):
    from portbench import run

    def run_cell(*_args, **_kwargs):
        sys.modules["jax"] = sys
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
                "device": {"kind": "a card", "count": 1,
                           "memory_peak_bytes": 1},
                "checks": {}}

    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc == 1 and out.out == ""
    assert "['jax']" in out.err


FAULTS = '''"""A fault planted under the benchmark worker's timed path.

Python imports this file at start-up from PYTHONPATH. It acts only in
``node.py worker``, where it wraps ``bqueryd_tpu_torch.worker.execute``
as ``PORTBENCH_FAULT`` says, then hands over to the installation's own
sitecustomize, if there is one.
"""

import os
import sys


def _plant(fault):
    import numpy as np

    from bqueryd_tpu_torch import worker

    execute = worker.execute
    first = {}

    def faulty(tables, query, *args, **kwargs):
        if fault == "drop_half":
            # half of the batch left out, the rest aggregated
            return execute(tables[:max(1, len(tables) // 2)], query, *args,
                           **kwargs)
        payload = execute(tables, query, *args, **kwargs)
        if fault == "stale":
            # the first answer of a shape, whatever its filter
            key = (tuple(query.groupby_cols), repr(query.agg_list))
            return first.setdefault(key, payload)
        if fault == "alter":
            # one value changed where it is produced
            if payload.get("kind") == "partials":
                part = payload["aggs"][0]
                name = sorted(part)[0]
            elif payload.get("kind") == "rows":
                part = payload["columns"]
                name = payload["order"][-1]
            else:
                return payload
            values = np.array(part[name], copy=True)
            values[0] += 1
            part[name] = values
        return payload

    worker.execute = faulty


if os.path.basename(sys.argv[0]) == "node.py" and sys.argv[1:2] == ["worker"]:
    _plant(os.environ["PORTBENCH_FAULT"])

_here = os.path.dirname(os.path.abspath(__file__))
for _dir in sys.path:
    _path = os.path.join(os.path.abspath(_dir or "."), "sitecustomize.py")
    if os.path.dirname(_path) != _here and os.path.exists(_path):
        with open(_path) as _f:
            exec(compile(_f.read(), _path, "exec"),
                 {"__name__": "sitecustomize", "__file__": _path})
        break
'''

#: the faults each cell can have: h2o1e7's questions repeat, so a stale
#: answer is a right one there
CELL_FAULTS = [("taxi10m.dashboard-c8", "stale"),
               ("taxi10m.dashboard-c8", "drop_half"),
               ("taxi10m.dashboard-c8", "alter"),
               ("h2o1e7.basic-c1", "drop_half"),
               ("h2o1e7.basic-c1", "alter")]


def _plant(monkeypatch, where, fault):
    """Every process the run starts imports ``FAULTS`` at start-up."""
    (where / "sitecustomize.py").write_text(FAULTS)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(where)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("PORTBENCH_FAULT", fault)


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(tmp_path, tmpdir_env,
                                                   cell_root, monkeypatch,
                                                   cell, fault):
    root = cell_root(cell)
    _plant(monkeypatch, tmp_path, fault)
    result = rehearse.rehearse(cell, 2**31 + 33, 1.5, ROWS, root=root)
    assert not result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_broken_timed_path_comes_out_not_correct_at_the_cells_size(
        card, tmp_path, cell_root, monkeypatch, cell, fault):
    """The measurement command itself, at the cell's size on the card,
    with a 10 s window."""
    root = cell_root(cell)
    _plant(monkeypatch, tmp_path, fault)
    run_tmp = tmp_path / "tmp"
    run_tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(run_tmp))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "portbench", "run.py"),
         "--workload", cell, "--seed", str(2**31 + 4001), "--seconds", "10",
         "--trace", "0"],
        capture_output=True, text=True, cwd=root, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    sys.stderr.write(f"{cell} {fault}: {json.dumps(result['checks'])}\n")
    assert not result["correct"], result["checks"]


FORBIDDEN = {"jax", "jaxlib", "flax", "bqueryd_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def _sources():
    for base, _dirs, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_nothing_here_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_nothing_here_reads_the_old_benchmark_or_the_smoke_test():
    for path in _sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        with open(path) as f:
            text = f.read()
        assert "bench.py" not in text and "chip_smoke" not in text, path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "roofline.py", "stats.py",
                 "devtrace.py", "traffic.py"):
        tops = {m.split(".")[0] for m in _imports(os.path.join(HERE, name))}
        assert "bqueryd_tpu_torch" not in tops, name


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from portbench import node

    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "bqueryd_tpu_torch_x", sys)
    assert node.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "bqueryd_tpu.ops", sys)
    assert node.forbidden_modules() == ["bqueryd_tpu.ops", "jax.numpy"]
    assert spec.ROOT == ROOT

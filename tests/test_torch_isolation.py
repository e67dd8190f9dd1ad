"""The port stands alone: it imports no jax and nothing of bqueryd_tpu, and
its entry points run on the CPU only when asked to."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bqueryd_tpu_torch
from bqueryd_tpu_torch.models.query import QueryEngine
from bqueryd_tpu_torch.ops import groupby as tg
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch import node
from bqueryd_tpu_torch.rpc import LocalRPC
from bqueryd_tpu_torch.worker import WorkerNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import bqueryd_tpu_torch
names = ["bqueryd_tpu_torch"]
for info in pkgutil.walk_packages(bqueryd_tpu_torch.__path__,
                                  "bqueryd_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m.startswith("jaxlib.") or m == "bqueryd_tpu"
    or m.startswith("bqueryd_tpu.")
)
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    result = json.loads(out.strip().splitlines()[-1])
    assert result["leaked"] == []
    for module in ("bqueryd_tpu_torch.ops.onehot", "bqueryd_tpu_torch.rpc",
                   "bqueryd_tpu_torch.worker",
                   "bqueryd_tpu_torch.parallel.hostmerge",
                   "bqueryd_tpu_torch.parallel.executor",
                   "bqueryd_tpu_torch.parallel.pipeline",
                   "bqueryd_tpu_torch.ops.workingset",
                   "bqueryd_tpu_torch.controller",
                   "bqueryd_tpu_torch.node",
                   "bqueryd_tpu_torch.messages",
                   "bqueryd_tpu_torch.coordination",
                   "bqueryd_tpu_torch.plan.logical",
                   "bqueryd_tpu_torch.plan.stats",
                   "bqueryd_tpu_torch.plan.dag",
                   "bqueryd_tpu_torch.ops.relops",
                   "bqueryd_tpu_torch.parallel.opexec",
                   "bqueryd_tpu_torch.ops.predicates",
                   "bqueryd_tpu_torch.utils.tracing"):
        assert module in result["imported"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bqueryd_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        bqueryd_tpu_torch.resolve_device("cuda")
    assert bqueryd_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        bqueryd_tpu_torch.resolve_device("mps")


def test_entry_points_need_an_explicit_cpu_request(no_cuda, tmp_path):
    with pytest.raises(RuntimeError):
        QueryEngine()
    with pytest.raises(RuntimeError):
        LocalRPC(str(tmp_path))
    with pytest.raises(RuntimeError):
        MeshQueryExecutor()
    store = f"mem://isolation-{os.urandom(4).hex()}"
    with pytest.raises(RuntimeError):
        WorkerNode(coordination_url=store, data_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        node.main(["worker", f"--coordination={store}",
                   f"--data_dir={tmp_path}"])
    codes = np.zeros(4, dtype=np.int32)
    values = np.ones(4, dtype=np.int64)
    with pytest.raises(RuntimeError):
        tg.partial_tables(codes, (values,), ("sum",), 1)
    assert QueryEngine(device="cpu").device.type == "cpu"
    assert LocalRPC(str(tmp_path), device="cpu").device.type == "cpu"
    assert MeshQueryExecutor(device="cpu").device.type == "cpu"
    worker = WorkerNode(coordination_url=store, data_dir=str(tmp_path),
                        device="cpu")
    assert worker.device.type == "cpu"
    worker.stop()
    out = tg.partial_tables(codes, (values,), ("sum",), 1, device="cpu")
    assert int(out["aggs"][0]["sum"][0]) == 4


def test_relational_operators_need_an_explicit_cpu_request(no_cuda):
    from bqueryd_tpu_torch.ops import relops

    codes = np.zeros(4, dtype=np.int64)
    values = np.arange(4.0)
    for call in (lambda d: relops.gather_positions(np.arange(2), codes, d),
                 lambda d: relops.topk_partials(codes, values, 2, True, 1,
                                                device=d),
                 lambda d: relops.sketch_bin(values, 0.01, d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(None)
        call("cpu")

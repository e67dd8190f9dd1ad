"""Settings of the benchmark's own tests (``python -m pytest portbench``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none: the look happens
inside the fixture, never while a module is imported.

Cells left out of ``BENCHMARK.json`` (``shelved.json``) run from a
checkout of the benchmark that adds them back (``cell_root``).
"""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control at the cell's size runs on "
                    "the card (python3 portbench/control.py)")
    return torch.device("cuda")


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """A run's TMPDIR of its own."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


def _with_shelved(bench):
    """``BENCHMARK.json`` as a dict with the shelved cells added back."""
    with open(os.path.join(HERE, "shelved.json")) as f:
        shelved = json.load(f)
    for group in ("configs", "workloads", "end_to_end"):
        bench[group] += shelved[group]
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + shelved["per_layer"].get(
            m["name"], [])
    return bench


def _copy(root):
    """The benchmark under ``root``, beside a link to the program."""
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "bqueryd_tpu_torch"),
               root / "bqueryd_tpu_torch")


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark under ``tmp_path`` beside a link to the
    program, and its ``BENCHMARK.json`` with the shelved cells, as a dict
    (written back by the test)."""
    root = tmp_path / "checkout"
    _copy(root)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return root, _with_shelved(json.load(f))


@pytest.fixture
def cell_root(tmp_path_factory):
    """``cell_root(name)``: the root to run a cell from: the repo's own
    for a cell of ``BENCHMARK.json``, a checkout that adds the shelved
    cells back for one of ``shelved.json``."""
    made = []

    def root_for(name):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        if name in {w["name"] for w in bench["workloads"]}:
            return ROOT
        if not made:
            root = tmp_path_factory.mktemp("shelved")
            _copy(root)
            made.append(root)
            (root / "BENCHMARK.json").write_text(
                json.dumps(_with_shelved(bench)))
        return str(made[0])
    return root_for

"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics.  A cell names a configuration (its ``file``), a
traffic mix (``portbench/traffic/<traffic>.json``, whose ``loop`` names
``portbench/loops/<loop>.py``) and, through the metrics that list it, the
per-layer readers (``portbench/metrics/<metric>.py``).  A later cell, mix,
loop or metric is added as files and entries, and nothing here changes.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with everything it names, read from the
    files under ``root``."""

    def __init__(self, name, root=ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "portbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.benchmark = json.load(f)
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.benchmark["configs"]}
        self.config_entry = configs[self.workload["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        traffic_path = os.path.join(self.bench_dir, "traffic",
                                    f"{self.workload['traffic']}.json")
        with open(traffic_path) as f:
            self.traffic = json.load(f)
        self.chips = int(self.workload["chips"])

    def _reported(self, group):
        """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that
        this cell reports: those whose ``workloads`` list it, or that have
        no such list."""
        return [m for m in self.benchmark[group]
                if self.name in m.get("workloads", [self.name])]

    @property
    def end_to_end(self):
        return self._reported("end_to_end")

    @property
    def per_layer(self):
        return self._reported("per_layer")

    def loop(self):
        """The module that runs this cell's traffic (``loops/<loop>.py``)."""
        kind = self.traffic["loop"]
        return _load_module(os.path.join(self.bench_dir, "loops",
                                         f"{kind}.py"),
                            f"portbench_loop_{kind}")

    def reader(self, metric):
        """The reader of one per-layer metric (``metrics/<name>.py``)."""
        return _load_module(os.path.join(self.bench_dir, "metrics",
                                         f"{metric}.py"),
                            f"portbench_metric_{metric}")

"""The port's static analysis suite (``bqueryd_tpu_torch/analysis/``).

The reference's ``tests/test_analysis.py`` cases on synthetic trees of the
port's package (one parametrised case per rule, the ``launch-*`` rules
among them), the shipped port tree at zero gating findings with an empty
baseline, the CLI's exit codes and runtime, parity with the reference
(schema keys, span names, lock declarations AST against AST, registry
names and defaults with the not-ported list spelt out), and the runtime
lock-order recorder over the port's pipeline, working set, metrics,
flight recorder and caches."""

import ast
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from bqueryd_tpu_torch.analysis import default_analyzers, run_suite
from bqueryd_tpu_torch.analysis.concurrency import LockDisciplineAnalyzer
from bqueryd_tpu_torch.analysis.configreg import (
    ENV_REGISTRY,
    EXTERNAL_ENV_ALLOWED,
    ConfigRegistryAnalyzer,
    EnvVar,
    registry_markdown_rows,
)
from bqueryd_tpu_torch.analysis.core import (
    BASELINE_FILENAME,
    Finding,
    Project,
    known_rules,
    load_baseline,
    parse_suppressions,
    readme_section,
    run_suite as core_run_suite,
)
from bqueryd_tpu_torch.analysis.lockorder import (
    LockOrderError,
    LockOrderRecorder,
)
from bqueryd_tpu_torch.analysis.metricslint import (
    MetricNameAnalyzer,
    MetricReadmeAnalyzer,
)
from bqueryd_tpu_torch.analysis.purity import LaunchPurityAnalyzer
from bqueryd_tpu_torch.analysis.spans import SpanSchemaAnalyzer
from bqueryd_tpu_torch.analysis.wire import WireSchemaAnalyzer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "bqueryd_tpu_torch"

#: the reference's variables with no reader in the port, each with its
#: reason (ROADMAP's "deliberately not ported" list)
NOT_PORTED_VARS = {
    "BQUERYD_TPU_PLATFORM": "forces a JAX platform",
    "BQUERYD_TPU_PALLAS": "routes the contraction past the Pallas kernels; "
                          "the port's route is always its CUDA kernels",
    "BQUERYD_TPU_PALLAS_HICARD_GT": "a Pallas tile size",
    "BQUERYD_TPU_PALLAS_HICARD_KT": "a Pallas tile size",
    "BQUERYD_TPU_PACKED_FETCH": "the port always fetches one packed buffer",
    "BQUERYD_TPU_SHAPE_BUCKETS": "the jit shape grid",
    "BQUERYD_TPU_FORCE_MATMUL": "the JAX CPU-backend override",
    "BQUERYD_TPU_COST_ANALYSIS": "HLO cost analysis",
}

#: registered in both, with the port's own default or read time
PORT_DEFAULTS = {
    # the reference's "auto" is JAX's own detection on a TPU pod; the port
    # joins a torch.distributed job only when told its size and rank
    "BQUERYD_TPU_DIST_NPROCS": "1",
    "BQUERYD_TPU_DIST_PROC_ID": "0",
}
PORT_READ_TIMES = {
    # the kernel build directory is resolved per build, not latched at
    # import like the reference's XLA compile cache
    "BQUERYD_TPU_COMPILE_CACHE": "call",
}

#: the reference's jit rules and their port rules (purity's docstring)
JIT_TO_LAUNCH = {
    "jit-impure-time": "launch-impure-time",
    "jit-impure-env": "launch-impure-env",
    "jit-host-numpy": "launch-host-numpy",
    "jit-traced-coerce": "launch-host-coerce",
    "jit-traced-branch": "launch-tensor-branch",
    "jit-lru-closure": "launch-lru-closure",
    "jit-uninstrumented": "launch-uninstrumented",
}
NOT_PORTED_RULES = {"jit-nonhashable-static": "a launch has no static "
                                              "arguments"}

PORT_SECTION = "## PyTorch/CUDA port\n\n"


def _port_file(rel):
    with open(os.path.join(REPO_ROOT, PKG, rel), encoding="utf-8") as f:
        return f.read()


def make_project(tmp_path, files, readme="(no config table)"):
    """A throwaway tree of the port's package: ``files`` maps package-
    relative paths to source text; the README holds ``readme`` inside a
    port section."""
    pkg = tmp_path / PKG
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    for rel, text in files.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.parent != pkg and not (
            path.parent / "__init__.py"
        ).exists():
            (path.parent / "__init__.py").write_text("")
        path.write_text(text)
    (tmp_path / "README.md").write_text(PORT_SECTION + readme + "\n")
    return Project(str(tmp_path))


def rules_of(result):
    return {f.rule for f in result.new}


# -- framework ---------------------------------------------------------------

def test_pragma_requires_reason_and_rule():
    sups, problems = parse_suppressions(
        "x = 1  # bqtpu: allow[some-rule] measured, tolerable\n"
        "y = 2  # bqtpu: allow[other-rule]\n"
        "z = 3  # bqtpu: allow[]\n"
    )
    assert len(sups) == 1 and sups[0].rules == ("some-rule",)
    assert sups[0].reason == "measured, tolerable"
    assert len(problems) == 2


def test_pragma_in_docstring_is_not_a_pragma():
    sups, problems = parse_suppressions(
        '"""docs show the syntax: # bqtpu: allow[rule-id] reason"""\n'
    )
    assert sups == [] and problems == []


def test_pragma_suppresses_same_line_and_standalone_previous_line(tmp_path):
    project = make_project(tmp_path, {
        "mod.py": (
            "import os\n"
            "# bqtpu: allow[config-unregistered-env] test fixture var\n"
            'A = os.environ.get("BQUERYD_TPU_FIXTURE_ONLY")\n'
            'B = os.environ.get("BQUERYD_TPU_FIXTURE_TWO")'
            "  # bqtpu: allow[config-unregistered-env] also a fixture\n"
            'C = os.environ.get("BQUERYD_TPU_FIXTURE_THREE")\n'
        ),
    })
    reg = {
        v.name: v for v in [EnvVar(
            "BQUERYD_TPU_FIXTURE_THREE", "str", "-", "x")]
    }
    result = core_run_suite(
        project=project, analyzers=[ConfigRegistryAnalyzer(registry=reg)],
    )
    suppressed_rules = {f.rule for f, _reason in result.suppressed}
    assert "config-unregistered-env" in suppressed_rules
    assert len(result.suppressed) == 2
    assert "config-unregistered-env" not in rules_of(result)


def test_unknown_rule_pragma_is_a_finding(tmp_path):
    project = make_project(tmp_path, {
        "mod.py": "x = 1  # bqtpu: allow[no-such-rule] because reasons\n",
    })
    result = core_run_suite(project=project, analyzers=[])
    assert "analysis-unknown-rule" in rules_of(result)


def test_reference_rule_ids_are_unknown_to_the_port(tmp_path):
    """A ``jit-*`` pragma copied from the reference names a rule the port
    does not declare: it is a finding, not a silent suppression."""
    project = make_project(tmp_path, {
        "ops/kern.py": "x = 1  # bqtpu: allow[jit-impure-time] copied\n",
    })
    result = core_run_suite(project=project, analyzers=[])
    assert "analysis-unknown-rule" in rules_of(result)


def test_baseline_grandfathers_and_stale_entries_flag(tmp_path):
    files = {
        "mod.py": 'import os\nA = os.environ.get("BQUERYD_TPU_LEGACY_X")\n',
    }
    project = make_project(tmp_path, files)
    analyzer = ConfigRegistryAnalyzer(registry={})
    result = core_run_suite(project=project, analyzers=[analyzer])
    (unmatched,) = [
        f for f in result.new if f.rule == "config-unregistered-env"
    ]

    baseline = tmp_path / BASELINE_FILENAME
    baseline.write_text(json.dumps({
        unmatched.fingerprint: "grandfathered: pre-registry legacy knob",
    }))
    # the default baseline is the port's own file at the root
    result2 = core_run_suite(project=project, analyzers=[analyzer])
    assert "config-unregistered-env" not in rules_of(result2)
    assert any(
        f.fingerprint == unmatched.fingerprint
        for f, _ in result2.baselined
    )

    baseline.write_text(json.dumps({"bogus:rule:path": "stale"}))
    result3 = core_run_suite(
        project=project, analyzers=[ConfigRegistryAnalyzer(registry={
            "BQUERYD_TPU_LEGACY_X": EnvVar(
                "BQUERYD_TPU_LEGACY_X", "str", "-", "x"),
        })],
        baseline_path=str(baseline),
    )
    assert "analysis-stale-baseline" in rules_of(result3)


def test_reference_baseline_file_is_never_read(tmp_path):
    """The JAX package's ``ANALYSIS_BASELINE.json`` grandfathers nothing
    in the port."""
    project = make_project(tmp_path, {
        "mod.py": 'import os\nA = os.environ.get("BQUERYD_TPU_LEGACY_X")\n',
    })
    analyzer = ConfigRegistryAnalyzer(registry={})
    (finding,) = [f for f in core_run_suite(
        project=project, analyzers=[analyzer]).new
        if f.rule == "config-unregistered-env"]
    (tmp_path / "ANALYSIS_BASELINE.json").write_text(json.dumps({
        finding.fingerprint: "the reference's file",
    }))
    result = core_run_suite(project=project, analyzers=[analyzer])
    assert "config-unregistered-env" in rules_of(result)
    assert BASELINE_FILENAME == "ANALYSIS_BASELINE_TORCH.json"


def test_unused_pragma_is_a_finding(tmp_path):
    project = make_project(tmp_path, {
        "mod.py": (
            "# bqtpu: allow[config-unregistered-env] nothing here anymore\n"
            "x = 1\n"
        ),
    })
    result = core_run_suite(
        project=project, analyzers=[ConfigRegistryAnalyzer(registry={})],
    )
    assert "analysis-unused-pragma" in rules_of(result)
    result2 = core_run_suite(project=project, analyzers=[])
    assert "analysis-unused-pragma" not in rules_of(result2)


def test_fingerprint_is_line_independent():
    a = Finding("r", "p.py", 10, "msg", symbol="sym")
    b = Finding("r", "p.py", 99, "different msg", symbol="sym")
    assert a.fingerprint == b.fingerprint


def test_readme_scope_is_the_port_section(tmp_path):
    """Doc coverage reads the README's port section only: a variable the
    rest of the README documents is neither unknown nor documentation."""
    text = (
        "# title\n\n## Configuration\n\n| `BQUERYD_TPU_PLATFORM` | x |\n\n"
        "## PyTorch/CUDA port (`bqueryd_tpu_torch/`)\n\n"
        "| `BQUERYD_TPU_KNOB` | 1 | a knob |\n\n## Deployment\n\n"
        "`BQUERYD_TPU_OTHER`\n"
    )
    section = readme_section(text)
    assert "BQUERYD_TPU_KNOB" in section
    assert "BQUERYD_TPU_PLATFORM" not in section
    assert "BQUERYD_TPU_OTHER" not in section
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        'import os\ndef knob():\n'
        '    return os.environ.get("BQUERYD_TPU_KNOB")\n')
    (tmp_path / "README.md").write_text(text)
    registry = {"BQUERYD_TPU_KNOB": EnvVar("BQUERYD_TPU_KNOB", "int", "1",
                                           "a knob")}
    result = core_run_suite(
        project=Project(str(tmp_path)),
        analyzers=[ConfigRegistryAnalyzer(registry=registry)],
    )
    assert result.new == []


def test_readme_without_port_section_is_one_finding(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "__init__.py").write_text("x = 1\n")
    (tmp_path / "README.md").write_text("# only the JAX package\n")
    result = core_run_suite(project=Project(str(tmp_path)))
    assert "analysis-missing-readme" in rules_of(result)
    assert "config-undocumented" not in rules_of(result)


# -- one seeded violation per rule -------------------------------------------

LOCKED_CLASS = """
import threading


class Box:
    _bqtpu_guarded_ = {"_lock": ("_data", "_count")}

    def __init__(self):
        self._lock = threading.Lock()
        self._data = {}
        self._count = 0

    def ok(self):
        with self._lock:
            self._count += 1
            return dict(self._data)

    def _drop_locked(self):
        self._data.clear()

    def racy(self):
        self._count += 1          # unguarded write

    def racy_helper(self):
        self._drop_locked()       # *_locked called lock-free
"""

#: a launch boundary with one violation of each launch rule: ``_launch``
#: calls a library symbol ``*_launch``; ``rows_dot`` reaches it and is
#: never instrumented; ``outer`` caches a closure
IMPURE_LAUNCH = """
import functools
import os
import time

import numpy as np


def _launch(codes, rows, n):
    lib = _library()
    t = time.perf_counter()
    e = os.environ.get("BQUERYD_TPU_METRICS")
    if codes.sum() > 0:
        n = int(rows)
    z = np.asarray(codes)
    first = codes.item()
    return lib.kern_launch(codes.data_ptr(), rows.data_ptr(), n)


def rows_dot(codes, rows, n):
    if codes.device.type == "cpu":
        return None
    return _launch(codes, rows, n)


def outer():
    big = [1, 2, 3]

    @functools.lru_cache(maxsize=8)
    def closure_cache(k):
        return big[k]

    return closure_cache
"""

#: a clean boundary: metadata branches, host-value coercion, an
#: instrumented wrapper reached through a factory as the port's groupby
#: does (``_kernel_call("name")``)
PURE_LAUNCH = """
def _library():
    return None


def _launch(codes, rows, n_rows, plan):
    n = codes.shape[0]
    if n == 0 or rows is None:
        return None
    if plan.branch == "mma" and len(codes) > 0:
        lib = _library()
        return lib.kern_launch(codes.data_ptr(), int(n_rows), n)
    return None


def rows_dot(codes, rows, n_rows):
    if codes.device.type == "cpu" or codes.dtype is None:
        return None
    return _launch(codes, rows, n_rows, None)
"""

PURE_LAUNCH_CALLER = """
from bqueryd_tpu_torch.obs import profile as _profile
from bqueryd_tpu_torch.ops import kern


def _kernel_call(name):
    def call(*args):
        return getattr(kern, name)(*args)

    return _profile.instrument(f"ops.{name}", call)


_rows_dot = _kernel_call("rows_dot")
"""


def _wire_files(controller, worker="", rpc=""):
    return {
        "messages.py": _port_file("messages.py"),
        "controller.py": controller,
        "worker.py": worker,
        "rpc.py": rpc,
    }


def _span_files(extra_site="", schema_extra="", categories_extra="",
                silent=""):
    return {
        "messages.py": (
            "SPAN_SCHEMA = {\n"
            "    'groupby': 'root',\n"
            "    'calc': 'worker root',\n"
            "    'open': 'raw name of storage_decode',\n"
            "    'storage_decode': 'decode',\n"
            f"{schema_extra}"
            "}\n"
        ),
        "obs/trace.py": (
            "PHASE_SPAN_NAMES = {'open': 'storage_decode'}\n"
        ),
        "obs/slo.py": (
            "SPAN_CATEGORIES = {\n"
            "    'groupby': 'query',\n"
            "    'calc': 'worker_other',\n"
            "    'storage_decode': 'storage_decode',\n"
            f"{categories_extra}"
            "}\n"
            "SYNTHETIC_SEGMENTS = ('unattributed',)\n"
        ),
        "worker.py": (
            f"CALC_SPAN_NAMES = {{**{{}}, {silent}}}\n"
            "def handle(timer, recorder, make_span):\n"
            "    with timer.phase('open'):\n"
            "        pass\n"
            "    make_span('t', 'groupby', 0, 1)\n"
            "    SpanRecorder(root_name='calc')\n"
            f"{extra_site}"
            "def SpanRecorder(root_name=None):\n"
            "    return root_name\n"
        ),
    }


def _config(files, readme="(no config table)", registry=None):
    return (files, readme,
            lambda: [ConfigRegistryAnalyzer(registry=registry or {})])


CONFIG_REGISTRY = {v.name: v for v in [
    EnvVar("BQUERYD_TPU_LIVE_KNOB", "int", "1", "live", "call"),
    EnvVar("BQUERYD_TPU_DEAD_KNOB", "int", "1", "dead", "call"),
    EnvVar("BQUERYD_TPU_TRACE_THING", "int", "1", "a", "call"),
    EnvVar("BQUERYD_TPU_TRACE_THING_BYTES", "int", "1", "b", "call"),
]}
CONFIG_SOURCE = {
    "mod.py": (
        "import os\n"
        'A = os.environ.get("BQUERYD_TPU_UNKNOWN_KNOB")\n'
        'B = os.environ.get("SOMEONE_ELSES_VAR")\n'
        'C = os.environ.get("BQUERYD_TPU_LIVE_KNOB")\n'
        "def f(name):\n"
        "    return os.environ.get(name)\n"
    ),
}

#: rule -> (files, readme, analyzers factory): the smallest tree that
#: seeds that rule's violation
SEEDED = {
    "config-unregistered-env": _config(CONFIG_SOURCE,
                                       registry=CONFIG_REGISTRY),
    "config-external-env": _config(CONFIG_SOURCE, registry=CONFIG_REGISTRY),
    "config-import-time-read": _config(CONFIG_SOURCE,
                                       registry=CONFIG_REGISTRY),
    "config-dynamic-env-key": _config(CONFIG_SOURCE,
                                      registry=CONFIG_REGISTRY),
    "config-dead-var": _config(CONFIG_SOURCE, registry=CONFIG_REGISTRY),
    "config-undocumented": _config(CONFIG_SOURCE, registry=CONFIG_REGISTRY),
    "config-readme-unknown": _config(
        CONFIG_SOURCE, "documents BQUERYD_TPU_GHOST_VAR only",
        CONFIG_REGISTRY),
    "config-name-collision": _config(CONFIG_SOURCE,
                                     registry=CONFIG_REGISTRY),
    "lock-unguarded-attr": ({"mod.py": LOCKED_CLASS}, "",
                            lambda: [LockDisciplineAnalyzer()]),
    "lock-helper-outside-lock": ({"mod.py": LOCKED_CLASS}, "",
                                 lambda: [LockDisciplineAnalyzer()]),
    "lock-missing-lock-attr": ({"mod.py": (
        "class Odd:\n"
        "    _bqtpu_guarded_ = {\"_ghost_lock\": (\"_x\",)}\n"
        "    def get(self):\n"
        "        return 1\n"
    )}, "", lambda: [LockDisciplineAnalyzer()]),
    "lock-bad-declaration": ({"mod.py": (
        "ATTRS = (\"_x\",)\n"
        "class Box:\n"
        "    _bqtpu_guarded_ = {\"_lock\": ATTRS}\n"
        "    def racy(self):\n"
        "        return self._x\n"
    )}, "", lambda: [LockDisciplineAnalyzer()]),
    **{
        rule: ({"ops/kern.py": IMPURE_LAUNCH}, "",
               lambda: [LaunchPurityAnalyzer()])
        for rule in (
            "launch-impure-time", "launch-impure-env", "launch-host-numpy",
            "launch-host-coerce", "launch-tensor-branch",
            "launch-lru-closure", "launch-uninstrumented",
        )
    },
    "wire-undeclared-key": (_wire_files(
        "def handle(msg):\n    msg[\"brand_new_key\"] = 1\n"), "",
        lambda: [WireSchemaAnalyzer()]),
    "wire-one-sided-key": (_wire_files(
        "def handle(msg):\n    msg[\"sole_shard\"] = True\n"), "",
        lambda: [WireSchemaAnalyzer()]),
    "wire-dead-key": (_wire_files("def handle(msg):\n    return msg\n"), "",
                      lambda: [WireSchemaAnalyzer()]),
    "wire-missing-schema": ({
        "messages.py": "SPAN_SCHEMA = {}\n",
        "controller.py": "def handle(msg):\n    return msg.get('token')\n",
    }, "", lambda: [WireSchemaAnalyzer()]),
    "span-undeclared-name": (_span_files(
        extra_site="    timer.phase('rogue_phase')\n"), "",
        lambda: [SpanSchemaAnalyzer()]),
    "span-unattributed-name": (_span_files(
        extra_site="    timer.phase('warp')\n",
        schema_extra="    'warp': 'new phase',\n"), "",
        lambda: [SpanSchemaAnalyzer()]),
    "span-dead-name": (_span_files(
        schema_extra="    'ghost': 'never recorded',\n",
        categories_extra="    'ghost': 'query',\n"), "",
        lambda: [SpanSchemaAnalyzer()]),
    "span-unranked-segment": ({
        "messages.py": "SPAN_SCHEMA = {'groupby': 'root'}\n",
        "obs/trace.py": "PHASE_SPAN_NAMES = {}\n",
        "obs/slo.py": (
            "SPAN_CATEGORIES = {'groupby': 'query'}\n"
            "SYNTHETIC_SEGMENTS = ('retry_backoff', 'unattributed')\n"
            "SEGMENT_PRIORITY = ('query',)\n"
        ),
        "worker.py": "def f(make_span):\n    make_span('t', 'groupby', 0, 1)\n",
    }, "", lambda: [SpanSchemaAnalyzer()]),
    "span-missing-schema": ({
        "worker.py": "def f(timer):\n    timer.phase('open')\n",
    }, "", lambda: [SpanSchemaAnalyzer()]),
    "metric-name-format": ({"m.py": (
        "def setup(reg):\n    reg.counter(\"Bad-Name\", \"help text\")\n"
    )}, "", lambda: [MetricNameAnalyzer()]),
    "metric-missing-help": ({"m.py": (
        "def setup(reg):\n    reg.gauge(\"bqueryd_tpu_thing\", \"\")\n"
    )}, "", lambda: [MetricNameAnalyzer()]),
    "metric-readme-coverage": ({"m.py": (
        "def setup(reg):\n    reg.gauge(\"bqueryd_tpu_thing\", \"x\")\n"
    )}, "no metrics table at all", lambda: [MetricReadmeAnalyzer()]),
}


def test_every_declared_analyzer_rule_has_a_seeded_case():
    rules = set()
    for analyzer in default_analyzers():
        rules |= set(analyzer.RULES)
    assert rules == set(SEEDED)


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_rule_fires_on_seeded_violation(tmp_path, rule):
    files, readme, analyzers = SEEDED[rule]
    project = make_project(tmp_path, files, readme=readme)
    result = core_run_suite(project=project, analyzers=analyzers())
    assert rule in rules_of(result), [f.render() for f in result.new]
    assert result.gating


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_cli_exits_1_on_seeded_violation(tmp_path, capsys, rule):
    """Every seeded violation flips ``python -m bqueryd_tpu_torch.analysis``
    to exit 1 (the analyzer that owns the rule, run alone)."""
    from bqueryd_tpu_torch.analysis.__main__ import main

    files, readme, analyzers = SEEDED[rule]
    make_project(tmp_path, files, readme=readme)
    owner = analyzers()[0].name
    rc = main(["--format", "json", "--root", str(tmp_path),
               "--analyzer", owner])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and payload["exit_code"] == 1


def test_config_doc_and_dead_checks_match_exact_tokens(tmp_path):
    project = make_project(tmp_path, {
        "mod.py": (
            "import os\n"
            'A = os.environ.get("BQUERYD_TPU_RING_BYTES")\n'
        ),
    }, readme="| `BQUERYD_TPU_RING_BYTES` | 16 MiB | byte cap |")
    registry = {v.name: v for v in [
        EnvVar("BQUERYD_TPU_RING", "int", "256", "entry cap", "call",
               related=("BQUERYD_TPU_RING_BYTES",)),
        EnvVar("BQUERYD_TPU_RING_BYTES", "int", "16 MiB", "byte cap",
               "call", related=("BQUERYD_TPU_RING",)),
    ]}
    result = core_run_suite(
        project=project,
        analyzers=[ConfigRegistryAnalyzer(registry=registry)],
    )
    undocumented = {
        f.symbol for f in result.new if f.rule == "config-undocumented"
    }
    dead = {f.symbol for f in result.new if f.rule == "config-dead-var"}
    assert undocumented == {"BQUERYD_TPU_RING"}
    assert dead == {"BQUERYD_TPU_RING"}


def test_registry_markdown_rows_cover_every_var():
    rows = registry_markdown_rows()
    assert len(rows) == len(ENV_REGISTRY)
    for name in ENV_REGISTRY:
        assert any(name in row for row in rows)


def test_readme_port_section_holds_the_registry_table():
    """The port section's config table is ``registry_markdown_rows()``."""
    with open(os.path.join(REPO_ROOT, "README.md"), encoding="utf-8") as f:
        section = readme_section(f.read())
    for row in registry_markdown_rows():
        assert row in section


def test_trace_buffer_near_collision_is_reconciled():
    entries = ENV_REGISTRY["BQUERYD_TPU_TRACE_BUFFER"]
    byts = ENV_REGISTRY["BQUERYD_TPU_TRACE_BUFFER_BYTES"]
    assert "BQUERYD_TPU_TRACE_BUFFER_BYTES" in entries.related
    assert "BQUERYD_TPU_TRACE_BUFFER" in byts.related
    assert "ENTRY-COUNT" in entries.help and "BYTE" in byts.help


def test_lock_discipline_flags_unguarded_and_helper(tmp_path):
    project = make_project(tmp_path, {"mod.py": LOCKED_CLASS})
    result = core_run_suite(
        project=project, analyzers=[LockDisciplineAnalyzer()],
    )
    by_rule = {}
    for f in result.new:
        by_rule.setdefault(f.rule, []).append(f)
    (unguarded,) = by_rule["lock-unguarded-attr"]
    assert unguarded.symbol == "Box.racy._count"
    (helper,) = by_rule["lock-helper-outside-lock"]
    assert "racy_helper" in helper.symbol


def test_lock_discipline_multi_item_with(tmp_path):
    project = make_project(tmp_path, {"mod.py": (
        "import threading\n"
        "class Box:\n"
        "    _bqtpu_guarded_ = {\"_lock\": (\"_data\",)}\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._data = {}\n"
        "    def both(self, ctx):\n"
        "        with self._lock, ctx(self._data):\n"
        "            return len(self._data)\n"
    )})
    result = core_run_suite(
        project=project, analyzers=[LockDisciplineAnalyzer()],
    )
    assert "lock-unguarded-attr" not in rules_of(result)


# -- launch purity ------------------------------------------------------------

def test_launch_purity_symbols_name_each_violation(tmp_path):
    project = make_project(tmp_path, {"ops/kern.py": IMPURE_LAUNCH})
    result = core_run_suite(project=project,
                            analyzers=[LaunchPurityAnalyzer()])
    got = {(f.rule, f.symbol) for f in result.new}
    assert {
        ("launch-impure-time", "_launch.time.perf_counter"),
        ("launch-impure-env", "_launch.os.environ"),
        ("launch-tensor-branch", "_launch.if.codes"),
        ("launch-host-coerce", "_launch.int.rows"),
        ("launch-host-coerce", "_launch.codes.item"),
        ("launch-host-numpy", "_launch.np.asarray"),
        ("launch-lru-closure", "closure_cache"),
        ("launch-uninstrumented", "rows_dot"),
    } <= got
    # the metadata branch in the wrapper is host-side
    assert ("launch-tensor-branch", "rows_dot.if.codes") not in got


def test_launch_purity_clean_idioms_pass(tmp_path):
    """Metadata branches, ``is None``/``len`` checks, host-value coercion
    and a wrapper instrumented through a factory produce no findings."""
    project = make_project(tmp_path, {
        "ops/kern.py": PURE_LAUNCH,
        "ops/groupby.py": PURE_LAUNCH_CALLER,
    })
    result = core_run_suite(project=project,
                            analyzers=[LaunchPurityAnalyzer()])
    assert [f.render() for f in result.new] == []


def test_launch_purity_flags_a_direct_wrapper_call(tmp_path):
    project = make_project(tmp_path, {
        "ops/kern.py": PURE_LAUNCH,
        "ops/groupby.py": PURE_LAUNCH_CALLER,
        "parallel/executor.py": (
            "from bqueryd_tpu_torch.ops import kern\n"
            "def run(codes, rows):\n"
            "    return kern.rows_dot(codes, rows, 3)\n"
        ),
    })
    result = core_run_suite(project=project,
                            analyzers=[LaunchPurityAnalyzer()])
    assert {(f.rule, f.symbol) for f in result.new} == {
        ("launch-uninstrumented", "call:rows_dot")}


def test_launch_boundary_of_the_shipped_kernels():
    """The boundary found in ``ops/onehot.py`` is the two wrappers and
    their launchers, and the wrappers are instrumented in
    ``ops/groupby.py``."""
    from bqueryd_tpu_torch.analysis.purity import (
        _instrumented_names,
        launch_boundary,
        tensor_params,
    )

    tree = ast.parse(_port_file("ops/onehot.py"))
    boundary = launch_boundary(tree)
    assert set(boundary) == {"onehot_rows_dot", "onehot_rows_dot_hicard",
                             "_launch_base", "_launch_hicard"}
    assert tensor_params(boundary["_launch_base"]) == {"codes", "rows"}
    names = _instrumented_names([ast.parse(_port_file("ops/groupby.py"))])
    assert {"onehot_rows_dot", "onehot_rows_dot_hicard"} <= names


def test_purity_rule_table_maps_every_reference_rule():
    from bqueryd_tpu.analysis.purity import JitPurityAnalyzer
    from bqueryd_tpu_torch.analysis import purity

    assert set(JitPurityAnalyzer.RULES) == (
        set(JIT_TO_LAUNCH) | set(NOT_PORTED_RULES))
    assert set(JIT_TO_LAUNCH.values()) == set(LaunchPurityAnalyzer.RULES)
    for jit_rule, launch_rule in JIT_TO_LAUNCH.items():
        assert jit_rule in purity.__doc__ and launch_rule in purity.__doc__
    assert "jit-nonhashable-static" in purity.__doc__


# -- wire and span schemas ----------------------------------------------------

def test_wire_result_envelope_anchored_on_pickle_dumps(tmp_path):
    project = make_project(tmp_path, {
        "messages.py": _port_file("messages.py"),
        "controller.py": (
            "import pickle\n"
            "def bookkeeping():\n"
            "    info = {\"busy\": False, \"error\": None}\n"
            "    return info\n"
            "def reply_ok(payloads):\n"
            "    return pickle.dumps({\"ok\": True, \"payloads\": payloads,"
            " \"timings\": {}, \"sneaky\": 1})\n"
        ),
        "worker.py": "",
        "rpc.py": (
            "import pickle\n"
            "def parse(raw):\n"
            "    envelope = pickle.loads(raw)\n"
            "    if envelope.get(\"busy\"):\n"
            "        raise RuntimeError(envelope.get(\"error\"))\n"
            "    return envelope[\"payloads\"], envelope.get(\"timings\")\n"
        ),
    })
    result = core_run_suite(project=project, analyzers=[WireSchemaAnalyzer()])
    assert any(
        f.rule == "wire-undeclared-key" and f.symbol == "sneaky"
        for f in result.new
    )
    one_sided = {
        f.symbol for f in result.new if f.rule == "wire-one-sided-key"
    }
    assert {"busy", "error", "ok"} <= one_sided
    assert "payloads" not in one_sided and "timings" not in one_sided


def test_wire_schema_read_from_analyzed_tree_only(tmp_path):
    """A tree's own schema decides; with none, no package is imported in
    its place: one finding."""
    project = make_project(tmp_path, {
        "messages.py": (
            'ENVELOPE_SCHEMA = {"payload": "verb", "custom_key": "theirs"}\n'
            "RESULT_ENVELOPE_SCHEMA = {}\n"
            "WIRE_ONE_SIDED_OK = {}\n"
        ),
        "controller.py": (
            "def handle(msg):\n"
            "    msg[\"custom_key\"] = 1\n"
            "    return msg.get(\"custom_key\"), msg.get(\"payload\"),"
            " msg.get(\"token\")\n"
        ),
        "worker.py": "def f(msg):\n    msg[\"payload\"] = 1\n",
        "rpc.py": "",
    })
    result = core_run_suite(project=project, analyzers=[WireSchemaAnalyzer()])
    undeclared = {
        f.symbol for f in result.new if f.rule == "wire-undeclared-key"
    }
    assert "custom_key" not in undeclared
    assert "token" in undeclared
    (tmp_path / PKG / "messages.py").write_text("X = 1\n")
    result = core_run_suite(project=Project(str(tmp_path)),
                            analyzers=[WireSchemaAnalyzer()])
    assert [f.rule for f in result.new] == ["wire-missing-schema"]


def test_wire_receivers_cover_the_worker_error_reply(tmp_path):
    """``result["transient"] = True`` on the worker's ErrorMessage is the
    write of the key the controller reads."""
    project = make_project(tmp_path, _wire_files(
        "def absorb(msg):\n    return msg.get('transient')\n",
        worker="def fail(result):\n    result['transient'] = True\n",
    ))
    result = core_run_suite(project=project, analyzers=[WireSchemaAnalyzer()])
    assert "transient" not in {
        f.symbol for f in result.new if f.rule == "wire-one-sided-key"
    }


def test_wire_schema_covers_shipped_tree():
    project = Project(REPO_ROOT)
    result = core_run_suite(
        project=project, analyzers=[WireSchemaAnalyzer()],
        baseline_path=os.path.join(REPO_ROOT, BASELINE_FILENAME),
    )
    assert [f.render() for f in result.new] == []


def test_span_lint_clean_project(tmp_path):
    project = make_project(tmp_path, _span_files())
    result = core_run_suite(project=project,
                            analyzers=[SpanSchemaAnalyzer()])
    assert [f.render() for f in result.new] == []


def test_span_lint_silent_phase_is_not_a_span(tmp_path):
    """A phase a ``*SPAN_NAMES`` map sends to None emits no span: its site
    needs no schema entry, while an unmapped one still flags."""
    project = make_project(tmp_path, _span_files(
        extra_site="    timer.phase('execute')\n",
        silent="'execute': None",
    ))
    result = core_run_suite(project=project,
                            analyzers=[SpanSchemaAnalyzer()])
    assert [f.render() for f in result.new] == []
    project = make_project(tmp_path, _span_files(
        extra_site="    timer.phase('execute')\n",
    ))
    result = core_run_suite(project=project,
                            analyzers=[SpanSchemaAnalyzer()])
    assert {(f.rule, f.symbol) for f in result.new} == {
        ("span-undeclared-name", "execute")}


def test_shipped_silent_phases_are_the_worker_calc_phases():
    from bqueryd_tpu_torch.analysis.spans import silent_phases

    assert silent_phases(ast.parse(_port_file("worker.py"))) == {
        "execute", "delta"}


# -- parity with the reference ------------------------------------------------

def test_wire_schema_keys_equal_the_reference():
    import bqueryd_tpu.messages as jax_messages
    import bqueryd_tpu_torch.messages as port_messages

    for name in ("ENVELOPE_SCHEMA", "RESULT_ENVELOPE_SCHEMA",
                 "WIRE_ONE_SIDED_OK"):
        assert set(getattr(port_messages, name)) == set(
            getattr(jax_messages, name)), name


def test_span_schema_names_equal_the_reference():
    import bqueryd_tpu.messages as jax_messages
    import bqueryd_tpu_torch.messages as port_messages
    from bqueryd_tpu.obs import slo as jax_slo, trace as jax_trace
    from bqueryd_tpu_torch.obs import slo as port_slo, trace as port_trace

    # the reference's, and the port's worker-loop receipt with its segment
    added = {"worker_receive"}
    assert (set(port_messages.SPAN_SCHEMA) - added
            == set(jax_messages.SPAN_SCHEMA))
    assert added <= set(port_messages.SPAN_SCHEMA)
    assert port_trace.PHASE_SPAN_NAMES == jax_trace.PHASE_SPAN_NAMES
    assert {k: v for k, v in port_slo.SPAN_CATEGORIES.items()
            if k not in added} == jax_slo.SPAN_CATEGORIES
    assert tuple(s for s in port_slo.SEGMENT_PRIORITY
                 if s not in added) == tuple(jax_slo.SEGMENT_PRIORITY)


def _declarations(package):
    """``{(relpath, class): literal}`` of every ``_bqtpu_guarded_`` in a
    package, from its source (AST, not import)."""
    out = {}
    root = os.path.join(REPO_ROOT, package)
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if rel.startswith("analysis"):
                continue
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for stmt in node.body:
                    if (isinstance(stmt, ast.Assign)
                            and isinstance(stmt.targets[0], ast.Name)
                            and stmt.targets[0].id == "_bqtpu_guarded_"):
                        out[(rel, node.name)] = ast.literal_eval(stmt.value)
    return out


def test_lock_declarations_equal_the_reference():
    reference = _declarations("bqueryd_tpu")
    port = _declarations(PKG)
    assert len(reference) == 12
    assert port == reference


def test_registry_names_and_defaults_equal_the_reference():
    from bqueryd_tpu.analysis.configreg import (
        ENV_REGISTRY as JAX_REGISTRY,
    )

    assert set(ENV_REGISTRY) == set(JAX_REGISTRY) - set(NOT_PORTED_VARS)
    for name, var in ENV_REGISTRY.items():
        ref = JAX_REGISTRY[name]
        assert var.default == PORT_DEFAULTS.get(name, ref.default), name
        assert var.read_time == PORT_READ_TIMES.get(name, ref.read_time), \
            name
        assert var.type == ref.type, name
        # related= may only drop a cross-reference to a var not ported
        assert set(var.related) == set(ref.related) - set(NOT_PORTED_VARS)
    # registry order is the reference's (the README table's order)
    assert list(ENV_REGISTRY) == [
        n for n in JAX_REGISTRY if n not in NOT_PORTED_VARS]
    assert "CUDA_HOME" in EXTERNAL_ENV_ALLOWED
    assert not any(v.startswith(("JAX_", "XLA_"))
                   for v in EXTERNAL_ENV_ALLOWED)


def test_not_ported_vars_have_no_reader_in_the_port():
    tokens = set()
    for dirpath, _dirs, files in os.walk(os.path.join(REPO_ROOT, PKG)):
        for name in files:
            if name.endswith(".py") and "analysis" not in dirpath:
                with open(os.path.join(dirpath, name),
                          encoding="utf-8") as f:
                    text = f.read()
                tokens |= {v for v in NOT_PORTED_VARS if f'"{v}"' in text}
    assert tokens == set()


def test_metric_name_pattern_equals_the_runtime_lint():
    from bqueryd_tpu_torch.analysis.metricslint import METRIC_NAME_RE
    from bqueryd_tpu_torch.obs import metrics

    assert METRIC_NAME_RE.pattern == metrics.METRIC_NAME_RE.pattern


def test_rule_sets_match_the_reference_but_purity():
    from bqueryd_tpu.analysis import default_analyzers as jax_analyzers

    port = {a.name: set(a.RULES) for a in default_analyzers()}
    ref = {a.name: set(a.RULES) for a in jax_analyzers()}
    assert port.pop("launch-purity") == set(JIT_TO_LAUNCH.values())
    assert ref.pop("jit-purity") == set(JIT_TO_LAUNCH) | set(
        NOT_PORTED_RULES)
    ref["wire-schema"].add("wire-missing-schema")
    ref["span-schema"].add("span-missing-schema")
    assert port == ref


# -- lock-order recorder ------------------------------------------------------

def test_lockorder_abba_cycle_detected_with_sites():
    recorder = LockOrderRecorder()
    a = recorder.lock("A")
    b = recorder.lock("B")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    cycles = recorder.cycles()
    assert cycles and set(cycles[0]) == {"A", "B"}
    report = recorder.report()
    assert "lock-order cycle: A -> B -> A" in report
    assert report.count(__file__) == 4
    assert "while holding" in report
    with pytest.raises(LockOrderError):
        recorder.assert_no_cycles()


def test_lockorder_reports_both_orientations_over_same_locks():
    recorder = LockOrderRecorder()
    a, b, c = (recorder.lock(n) for n in "ABC")
    for first, second, third in ((a, b, c), (a, c, b)):
        with first:
            with second:
                with third:
                    pass
    cycles = {tuple(cyc) for cyc in recorder.cycles()}
    assert ("B", "C") in cycles or ("C", "B") in cycles
    assert len(cycles) == len(recorder.cycles())


def test_lockorder_consistent_order_is_clean():
    recorder = LockOrderRecorder()
    a = recorder.lock("A")
    b = recorder.lock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert recorder.cycles() == []
    recorder.assert_no_cycles()


def test_lockorder_self_deadlock_raises():
    recorder = LockOrderRecorder()
    a = recorder.lock("A")
    with a:
        with pytest.raises(LockOrderError, match="self-deadlock"):
            a.acquire()


def test_lockorder_real_pipeline_and_worker_paths_run_clean(monkeypatch):
    """The port's shared caches, working set, stage clock, metrics
    registry and flight ring under instrumented locks from several
    threads: the acquisition graph stays acyclic."""
    from bqueryd_tpu_torch.obs.flightrec import FlightRecorder
    from bqueryd_tpu_torch.obs.metrics import MetricsRegistry
    from bqueryd_tpu_torch.ops.workingset import DeltaAggCache, WorkingSet
    from bqueryd_tpu_torch.parallel import pipeline
    from bqueryd_tpu_torch.utils.cache import BytesCappedCache

    for env in ("BQUERYD_TPU_ALIGN_CACHE_BYTES",
                "BQUERYD_TPU_CODES_CACHE_BYTES",
                "BQUERYD_TPU_HBM_CACHE_BYTES"):
        monkeypatch.setenv(env, str(1 << 14))
    recorder = LockOrderRecorder()
    cache = BytesCappedCache(1 << 16, sizeof=len)
    ws = WorkingSet()
    registry = MetricsRegistry()
    counter = registry.counter("bqueryd_tpu_lockorder_test_total", "t")
    hist = registry.histogram("bqueryd_tpu_lockorder_test_seconds", "t")
    registry.gauge("bqueryd_tpu_lockorder_cache_bytes", "t",
                   fn=lambda: cache.nbytes)
    flight = FlightRecorder(node_id="t", capacity=64, max_bytes=1 << 14)
    clock = pipeline.StageClock()
    delta = DeltaAggCache(max_bytes=1 << 16)

    assert recorder.instrument_object(cache)
    recorder.instrument_object(ws)
    for name in ("align", "codes", "blocks"):
        recorder.instrument_object(ws.segment(name), prefix=f"ws.{name}")
    recorder.instrument_object(registry)
    recorder.instrument_object(counter, prefix="Counter")
    recorder.instrument_object(hist, prefix="Histogram")
    recorder.instrument_object(flight)
    recorder.instrument_object(clock, prefix="StageClock")
    recorder.instrument_object(delta._cache, prefix="DeltaAggCache")

    sample = {"bytes_in_use": 10 * (1 << 14), "bytes_limit": 1 << 14}

    def storm(seed):
        for i in range(50):
            key = f"k{(seed * 50 + i) % 17}"
            cache.put(key, b"x" * 100)
            cache.get(key)
            cache.nbytes, len(cache)
            seg = ws.segment(("align", "codes", "blocks")[i % 3])
            seg.put((seed, i % 7), b"y" * 200, nbytes=200)
            seg.get((seed, i % 7))
            ws.stats()
            if i % 10 == 0:
                ws.evict_under_pressure(sample=sample, watermark=0.9)
            counter.inc()
            hist.observe(0.001 * i)
            registry.render()
            flight.record("rpc", verb="groupby", seq=i)
            flight.tail(8)
            len(flight), flight.nbytes, flight.evictions
            clock.add("decode", 0.001)
            clock.busy_seconds("decode")
            clock.snapshot()
            delta.nbytes

    threads = [threading.Thread(target=storm, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    assert recorder.acquisitions > 0
    assert recorder.cycles() == [], recorder.report()


def test_lockorder_instrumented_pipeline_map_ordered_clean(monkeypatch):
    from bqueryd_tpu_torch.parallel import pipeline

    monkeypatch.setenv("BQUERYD_TPU_PIPELINE_THREADS", "4")
    recorder = LockOrderRecorder()
    restore_pool = recorder.instrument_module_lock(pipeline, "_pool_lock")
    restore_clock = pipeline._clock._lock
    clock_wrapped = recorder.instrument_object(
        pipeline.clock(), prefix="StageClock"
    )
    try:
        assert clock_wrapped

        def work(i):
            with pipeline.stage("decode"):
                with pipeline.stage("kernel"):
                    return i * 2

        out = pipeline.map_ordered(work, range(32), max_workers=3)
        assert out == [i * 2 for i in range(32)]
        assert recorder.cycles() == [], recorder.report()
    finally:
        restore_pool()
        pipeline._clock._lock = restore_clock


# -- root robustness, the shipped tree, the CLI -------------------------------

def test_sourceless_root_fails_loudly(tmp_path):
    with pytest.raises(FileNotFoundError, match="source checkout"):
        Project(str(tmp_path))


def test_shipped_tree_has_zero_gating_findings():
    """The gate: the full suite over the port's tree is clean with its
    shipped (empty) baseline."""
    result = run_suite(root=REPO_ROOT)
    assert [f.render() for f in result.gating] == []
    assert load_baseline(os.path.join(REPO_ROOT, BASELINE_FILENAME)) == {}
    assert {
        "config-registry", "lock-discipline", "launch-purity",
        "wire-schema", "span-schema", "metric-lint", "metric-readme",
    } == set(result.analyzers_run)
    # every reference pragma counterpart is used, none other
    assert len(result.suppressed) == 4
    assert {f.rule for f, _ in result.suppressed} == {
        "config-dynamic-env-key"}


def test_shipped_tree_with_empty_baseline_file(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    result = run_suite(root=REPO_ROOT, baseline_path=str(empty))
    assert result.gating == []


def test_suite_runtime_stays_fast():
    t0 = time.perf_counter()
    run_suite(root=REPO_ROOT)
    assert time.perf_counter() - t0 < 10.0


def test_cli_json_clean_and_violation_exit_codes(tmp_path, capsys):
    from bqueryd_tpu_torch.analysis.__main__ import main

    rc = main(["--format", "json", "--root", REPO_ROOT])
    out = capsys.readouterr().out
    assert rc == 0
    payload = json.loads(out)
    assert payload["schema"] == "bqueryd_tpu_torch.analysis/1"
    assert payload["exit_code"] == 0
    assert payload["findings"] == []
    assert payload["counts_by_analyzer"]["config-registry"] == len(
        payload["suppressed"]
    )

    make_project(tmp_path, {
        "mod.py": 'import os\nX = os.environ.get("BQUERYD_TPU_NEW_KNOB")\n',
    })
    rc = main(["--format", "json", "--root", str(tmp_path)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and payload["exit_code"] == 1
    assert any(
        f["rule"] == "config-unregistered-env" for f in payload["findings"]
    )


def test_cli_list_rules_and_unknown_analyzer(capsys):
    from bqueryd_tpu_torch.analysis.__main__ import main

    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in known_rules(default_analyzers()):
        assert f"{rule}:" in out
    assert "jit-impure-time" not in out
    assert main(["--analyzer", "no-such"]) == 2


def test_cli_internal_error_exits_2(tmp_path, capsys):
    from bqueryd_tpu_torch.analysis.__main__ import main

    assert main(["--root", str(tmp_path)]) == 2
    assert "analysis suite error" in capsys.readouterr().err


def test_cli_subprocess_imports_no_torch_jax_or_reference():
    """``python -m bqueryd_tpu_torch.analysis`` exits 0 on the shipped
    tree within the runtime bound and loads neither torch, jax nor
    anything of ``bqueryd_tpu``."""
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['x', '--format', 'json']\n"
        "try:\n"
        "    runpy.run_module('bqueryd_tpu_torch.analysis',"
        " run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    rc = exc.code\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('torch', 'jax', 'jaxlib', 'bqueryd_tpu', 'numpy', 'pandas'))\n"
        "print(json.dumps({'rc': rc, 'heavy': heavy}))\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT),
    )
    assert time.perf_counter() - t0 < 60.0
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail == {"rc": 0, "heavy": []}
    report = json.loads("\n".join(lines[:-1]))
    assert report["exit_code"] == 0 and report["findings"] == []

"""Metric lints, migrated into the analysis framework as static analyzers.

The original, :meth:`bqueryd_tpu_torch.obs.metrics.MetricsRegistry.lint`,
runs against LIVE registries from tests and keeps doing so (it sees
runtime-constructed names like the ``RegistryCounters`` mirrors, which no
static pass can).  These analyzers are its static twins over the source,
README coverage included (checked against the README's port section):
every metric name
LITERAL at a registration/construction site is checked for the naming
contract and README coverage without having to boot a node, so the suite
CLI covers the whole package in milliseconds.

* ``metric-name-format`` — literal metric name fails
  ``^bqueryd_tpu_[a-z0-9_]+$`` (counters may suffix ``_total``);
* ``metric-missing-help`` — registration with a missing/empty literal help
  string;
* ``metric-readme-coverage`` — literal metric name absent from the README
  metrics documentation.

F-string/computed names are skipped here; the runtime lint owns those.
"""

import ast
import re

from bqueryd_tpu_torch.analysis.core import Finding

#: the naming contract of ``obs.metrics.METRIC_NAME_RE``, kept here so that
#: the suite loads nothing of the package it analyzes (a test holds the two
#: equal)
METRIC_NAME_RE = re.compile(r"^bqueryd_tpu_[a-z0-9_]+$")

#: registration-call attribute names and constructor class names whose first
#: argument is a metric name literal
_REGISTRATION_ATTRS = frozenset({"counter", "gauge", "histogram"})
_CONSTRUCTOR_NAMES = frozenset({"Counter", "Gauge", "Histogram"})


def _metric_sites(tree):
    """(name, help_or_None, lineno) per literal registration site."""
    sites = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        is_reg = (
            isinstance(func, ast.Attribute)
            and func.attr in _REGISTRATION_ATTRS
        )
        is_ctor = isinstance(func, ast.Name) and func.id in _CONSTRUCTOR_NAMES
        if isinstance(func, ast.Attribute) and (
            func.attr in _CONSTRUCTOR_NAMES
        ):
            is_ctor = True
        if not (is_reg or is_ctor):
            continue
        if not node.args or not isinstance(node.args[0], ast.Constant):
            continue
        name = node.args[0].value
        if not isinstance(name, str):
            continue
        help_text = None
        if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
            if isinstance(node.args[1].value, str):
                help_text = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "help_text" and isinstance(kw.value, ast.Constant):
                help_text = kw.value.value
        sites.append((name, help_text, node.lineno))
    return sites


class MetricNameAnalyzer:
    """Static twin of ``MetricsRegistry.lint`` (names + help text)."""

    name = "metric-lint"

    RULES = {
        "metric-name-format":
            "literal metric name fails ^bqueryd_tpu_[a-z0-9_]+$",
        "metric-missing-help":
            "metric registered with no (or empty) literal help text",
    }

    def run(self, project):
        findings = []
        for sf in project.files:
            if sf.tree is None:
                continue
            for name, help_text, lineno in _metric_sites(sf.tree):
                base = name[:-len("_total")] if name.endswith(
                    "_total"
                ) else name
                if not METRIC_NAME_RE.match(base):
                    findings.append(Finding(
                        "metric-name-format", sf.relpath, lineno,
                        f"metric name {name!r} fails "
                        f"{METRIC_NAME_RE.pattern}",
                        symbol=name,
                    ))
                if help_text is not None and not help_text.strip():
                    findings.append(Finding(
                        "metric-missing-help", sf.relpath, lineno,
                        f"metric {name!r} registered with empty help text",
                        symbol=name,
                    ))
        return findings


class MetricReadmeAnalyzer:
    """Static twin of ``readme_coverage_problems``: every literal metric
    name must appear in the README metrics documentation."""

    name = "metric-readme"

    RULES = {
        "metric-readme-coverage":
            "literal metric name missing from the README metrics table",
    }

    def run(self, project):
        if project.readme_text is None:
            # the framework's analysis-missing-readme finding covers this
            return []
        findings = []
        seen = set()
        for sf in project.files:
            if sf.tree is None:
                continue
            for name, _help, lineno in _metric_sites(sf.tree):
                if name in seen:
                    continue
                seen.add(name)
                if name not in project.readme_text:
                    findings.append(Finding(
                        "metric-readme-coverage", sf.relpath, lineno,
                        f"metric {name!r} registered here but missing from "
                        "the README metrics table",
                        symbol=name,
                    ))
        return findings

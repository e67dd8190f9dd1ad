"""Span-coverage guard: literal span sites vs the schema in ``messages.py``.

A query autopsy (``rpc.autopsy``) is only as complete as its span taxonomy:
a new dispatch path that opens a ``timer.phase("...")`` or records a
``make_span(...)`` under an undeclared name ships latency that the
attribution sweep can only bucket as ``unattributed`` — silently eroding
the >= 95% coverage contract the bench gates on.  Wire-lint style, this
analyzer extracts every literal SPAN SITE in the package and diffs it
against two declared truths:

* ``messages.SPAN_SCHEMA`` — every span/phase name that may appear on a
  trace timeline (``span-undeclared-name`` / ``span-dead-name``);
* ``obs.slo.SPAN_CATEGORIES`` — the attribution map: every PUBLIC span
  name (raw PhaseTimer names resolve through ``obs.trace.PHASE_SPAN_NAMES``
  first) must map to a segment (``span-unattributed-name``), and every
  segment — mapped or synthetic (``obs.slo.SYNTHETIC_SEGMENTS``) — must
  rank in ``SEGMENT_PRIORITY`` (``span-unranked-segment``: an unranked
  segment silently falls back to dispatch priority in the sweep).

A phase a ``*SPAN_NAMES`` map of the package (a module-level dict such
as ``worker.CALC_SPAN_NAMES``) maps to ``None`` emits no span: its wall
stays its parent's, so its sites are not checked against the schema (the
port's ``execute`` and ``delta`` calc phases, whose inner phases are
spans).

The declared truths are read from the analyzed tree only; a tree without
a literal ``SPAN_SCHEMA`` is a finding (``span-missing-schema``), and no
package is imported in its place.

Span sites are: ``<x>.phase("name")`` / ``<x>._phase("name")`` /
``<x>.span("name")`` (PhaseTimer / SpanRecorder context managers),
``make_span(trace_id, "name", ...)`` (second positional), and
``SpanRecorder(root_name="name")``.  Non-literal names are fine — they can
only re-emit already-declared names (the generic passthroughs in
PhaseTimer/QueryEngine).  ``pipeline.stage(...)`` is NOT a span site (stage
clocks are worker-local gauges, never timeline spans).
"""

import ast

from bqueryd_tpu_torch.analysis.core import Finding, module_literal

#: method names whose first literal argument opens a span/phase
_PHASE_ATTRS = ("phase", "_phase", "span")


def _literal_dict(tree, name):
    """A module-level ``name = {...literal...}`` from a parsed tree."""
    value = module_literal(tree, name)
    return value if isinstance(value, dict) else None


def _literal_tuple(tree, name):
    value = module_literal(tree, name)
    return tuple(value) if isinstance(value, (tuple, list)) else None


def silent_phases(tree):
    """Phase names a module-level ``*SPAN_NAMES = {...}`` dict maps to
    ``None`` (``**`` entries are skipped: they re-map declared names)."""
    names = set()
    for node in tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.endswith("SPAN_NAMES")
            and isinstance(node.value, ast.Dict)
        ):
            continue
        for key, value in zip(node.value.keys, node.value.values):
            if (
                isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and isinstance(value, ast.Constant)
                and value.value is None
            ):
                names.add(key.value)
    return names


class _SpanSiteVisitor(ast.NodeVisitor):
    def __init__(self):
        self.sites = {}   # name -> [lineno, ...]

    def _mark(self, node, lineno):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            self.sites.setdefault(node.value, []).append(lineno)

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _PHASE_ATTRS:
            if node.args:
                self._mark(node.args[0], node.lineno)
        name = (
            func.id if isinstance(func, ast.Name)
            else func.attr if isinstance(func, ast.Attribute) else None
        )
        if name == "make_span" and len(node.args) >= 2:
            self._mark(node.args[1], node.lineno)
        if name == "SpanRecorder":
            for kw in node.keywords:
                if kw.arg == "root_name":
                    self._mark(kw.value, node.lineno)
        self.generic_visit(node)


class SpanSchemaAnalyzer:
    name = "span-schema"

    RULES = {
        "span-undeclared-name":
            "a literal span/phase site uses a name not declared in "
            "messages.SPAN_SCHEMA",
        "span-unattributed-name":
            "a declared span name (public form) has no segment in "
            "obs.slo.SPAN_CATEGORIES — rpc.autopsy would drop its time "
            "into 'unattributed'",
        "span-dead-name":
            "a declared span name with no span site anywhere and no "
            "PHASE_SPAN_NAMES mapping — dead schema entry",
        "span-unranked-segment":
            "a segment (SPAN_CATEGORIES value or SYNTHETIC_SEGMENTS "
            "entry) missing from SEGMENT_PRIORITY — the sweep would "
            "silently rank it at dispatch priority",
        "span-missing-schema":
            "the analyzed tree lacks a literal SPAN_SCHEMA (messages.py), "
            "PHASE_SPAN_NAMES (obs/trace.py) or SPAN_CATEGORIES "
            "(obs/slo.py)",
    }

    def _declared(self, project):
        """(SPAN_SCHEMA, PHASE_SPAN_NAMES, SPAN_CATEGORIES, SYNTHETIC,
        PRIORITY) read from the ANALYZED tree (same contract as the wire
        analyzer: a checkout diffs against its own schema); the first three
        are None where the tree lacks them."""
        schema = phase_names = categories = synthetic = priority = None
        sf = project.file(f"{project.package}/messages.py")
        if sf is not None and sf.tree is not None:
            schema = _literal_dict(sf.tree, "SPAN_SCHEMA")
        sf = project.file(f"{project.package}/obs/trace.py")
        if sf is not None and sf.tree is not None:
            phase_names = _literal_dict(sf.tree, "PHASE_SPAN_NAMES")
        sf = project.file(f"{project.package}/obs/slo.py")
        if sf is not None and sf.tree is not None:
            categories = _literal_dict(sf.tree, "SPAN_CATEGORIES")
            synthetic = _literal_tuple(sf.tree, "SYNTHETIC_SEGMENTS")
            priority = _literal_tuple(sf.tree, "SEGMENT_PRIORITY")
        return (
            schema, phase_names, categories,
            tuple(synthetic or ()), tuple(priority or ()),
        )

    def run(self, project):
        (
            schema, phase_names, categories, synthetic, priority,
        ) = self._declared(project)
        findings = []
        schema_file = f"{project.package}/messages.py"
        slo_file = f"{project.package}/obs/slo.py"
        missing = [
            (what, where) for what, where, value in (
                ("SPAN_SCHEMA", schema_file, schema),
                ("PHASE_SPAN_NAMES", f"{project.package}/obs/trace.py",
                 phase_names),
                ("SPAN_CATEGORIES", slo_file, categories),
            ) if value is None
        ]
        if missing:
            return [
                Finding(
                    "span-missing-schema", where, 0,
                    f"no literal {what} in {where} — span sites cannot be "
                    "checked",
                    symbol=what,
                )
                for what, where in missing
            ]

        silent = set()
        for sf in project.files:
            if sf.tree is not None:
                silent |= silent_phases(sf.tree)

        sites = {}   # name -> [(path, line), ...]
        for sf in project.files:
            if sf.tree is None:
                continue
            visitor = _SpanSiteVisitor()
            visitor.visit(sf.tree)
            for name, linenos in visitor.sites.items():
                sites.setdefault(name, []).extend(
                    (sf.relpath, lineno) for lineno in linenos
                )

        for name in sorted(sites):
            if name not in schema and name not in silent:
                path, line = sites[name][0]
                findings.append(Finding(
                    "span-undeclared-name", path, line,
                    f"span/phase name {name!r} used at a span site but not "
                    "declared in messages.SPAN_SCHEMA",
                    symbol=name,
                ))

        for name in sorted(schema):
            public = phase_names.get(name, name)
            if public not in categories:
                findings.append(Finding(
                    "span-unattributed-name", slo_file, 0,
                    f"declared span name {name!r} (public {public!r}) has "
                    "no segment in obs.slo.SPAN_CATEGORIES — its time "
                    "would land in 'unattributed'",
                    symbol=name,
                ))
            used = name in sites or name in phase_names.values()
            if not used:
                findings.append(Finding(
                    "span-dead-name", schema_file, 0,
                    f"declared span name {name!r} has no span site in the "
                    "package and is not a PHASE_SPAN_NAMES mapping — dead "
                    "schema entry",
                    symbol=name,
                ))

        # every segment the sweep can produce must hold an explicit rank
        # ("unattributed" is the residue, never ranked); priority () means
        # the analyzed tree has no slo module — nothing to rank against
        if priority:
            segments = set(categories.values()) | {
                s for s in synthetic if s != "unattributed"
            }
            for segment in sorted(segments - set(priority)):
                findings.append(Finding(
                    "span-unranked-segment", slo_file, 0,
                    f"segment {segment!r} is produced by the attribution "
                    "map but missing from SEGMENT_PRIORITY — it would "
                    "silently rank at dispatch priority",
                    symbol=segment,
                ))
        return findings

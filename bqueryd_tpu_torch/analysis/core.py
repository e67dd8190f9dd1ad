"""Analysis framework core: findings, suppressions, baseline, project model.

The port's copy of ``bqueryd_tpu/analysis/core.py``.  It analyzes
``bqueryd_tpu_torch/`` by default, reads its own baseline
(``ANALYSIS_BASELINE_TORCH.json``) and checks documentation against the
README's port section only (``## PyTorch/CUDA port``, up to the next
``## `` heading): the rest of the README documents the JAX package, whose
knobs and metrics the port does not all have.

Every analyzer (config registry, lock discipline, launch purity, wire
schema, span schema, metric lints) produces :class:`Finding` objects over one shared
:class:`Project` (parsed-once ASTs of every package module).  The framework
owns the three escape hatches so no analyzer grows private ones:

* **inline pragma** — ``# bqtpu: allow[rule-id] <reason>`` on the offending
  line (or as a standalone comment on the line above) suppresses that rule
  there.  A reason is MANDATORY: a bare pragma is itself a finding
  (``analysis-bad-pragma``), as is a pragma naming a rule no analyzer
  declares (``analysis-unknown-rule``) — suppressions must not outlive the
  rules they silence.
* **baseline file** — ``ANALYSIS_BASELINE_TORCH.json`` at the repo root maps
  finding fingerprints to justification strings for grandfathered findings.
  Fingerprints are ``rule:path:symbol`` (no line numbers, so unrelated edits
  don't churn the baseline).  A baseline entry matching nothing is a finding
  (``analysis-stale-baseline``): the baseline can only shrink.
* **severity** — ``error`` findings gate (non-zero exit / test failure);
  ``warning`` and ``info`` report without gating.

Control-plane module: stdlib only (ast, json, os, time).
"""

import ast
import json
import os
import re
import time

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

#: default baseline filename, resolved against the project root
BASELINE_FILENAME = "ANALYSIS_BASELINE_TORCH.json"

#: the README section the doc-coverage rules read: the port's own
README_SECTION = "## PyTorch/CUDA port"

_PRAGMA_RE = re.compile(
    r"#\s*bqtpu:\s*allow\[(?P<rules>[a-z0-9_,\s-]*)\]\s*(?P<reason>.*)$"
)

# framework-owned rules (analyzers declare their own in their RULES dicts)
FRAMEWORK_RULES = {
    "analysis-parse-error": "a package module failed to parse as Python",
    "analysis-bad-pragma": "suppression pragma without a reason",
    "analysis-unknown-rule": "suppression pragma names a rule no analyzer declares",
    "analysis-stale-baseline": "baseline entry whose finding no longer occurs",
    "analysis-unused-pragma":
        "suppression pragma that matched no finding this run",
    "analysis-missing-readme":
        "project root has no README.md port section — doc-coverage rules "
        "cannot run",
}


class Finding:
    """One analyzer hit.  ``symbol`` is the stable anchor (env-var name,
    ``Class.attr``, envelope key, function name) used for the fingerprint so
    baselines survive line drift."""

    def __init__(self, rule, path, line, message, symbol=None,
                 severity=SEV_ERROR):
        self.rule = rule
        self.path = path            # project-relative, '/'-separated
        self.line = int(line or 0)
        self.message = message
        self.symbol = symbol if symbol is not None else message[:60]
        self.severity = severity

    @property
    def fingerprint(self):
        return f"{self.rule}:{self.path}:{self.symbol}"

    def to_dict(self):
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "severity": self.severity,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self):
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        )

    def __repr__(self):
        return f"<Finding {self.fingerprint} @{self.line}>"


class Suppression:
    def __init__(self, line, rules, reason):
        self.line = line
        self.rules = rules          # tuple of rule ids ("*" allowed)
        self.reason = reason
        self.used = False

    def matches(self, rule):
        return "*" in self.rules or rule in self.rules


def module_literal(tree, name):
    """The literal value of a module-level ``name = <literal>`` assignment
    in a parsed tree, or None (absent, non-literal, or unparseable).  The
    shared extraction for analyzers that diff code against a declared
    schema constant (wire envelope schemas, span schemas) — one walker
    instead of a per-analyzer copy."""
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
        ):
            try:
                return ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return None
    return None


def _comment_lines(text):
    """(lineno, comment_text) for every real COMMENT token — tokenizing (not
    regexing raw lines) keeps pragma syntax mentioned in docstrings from
    parsing as live pragmas."""
    import io
    import tokenize

    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparseable file: the AST pass reports it; no pragmas here
        return []
    return out


def parse_suppressions(text):
    """Extract ``# bqtpu: allow[rule] reason`` pragmas.  Returns
    ``(suppressions, problems)`` where problems are (line, message) pairs for
    malformed pragmas (no reason / empty rule list)."""
    suppressions = []
    problems = []
    for lineno, line in _comment_lines(text):
        if "bqtpu:" not in line:
            continue
        match = _PRAGMA_RE.search(line)
        if match is None:
            problems.append((lineno, "malformed 'bqtpu:' pragma (expected "
                             "'# bqtpu: allow[rule-id] <reason>')"))
            continue
        rules = tuple(
            r.strip() for r in match.group("rules").split(",") if r.strip()
        )
        reason = match.group("reason").strip()
        if not rules:
            problems.append((lineno, "pragma allows no rules"))
            continue
        if not reason:
            problems.append(
                (lineno, f"pragma allow[{','.join(rules)}] has no reason — "
                         "every suppression must say why")
            )
            continue
        suppressions.append(Suppression(lineno, rules, reason))
    return suppressions, problems


class SourceFile:
    """One parsed package module: text, lines, AST, pragmas."""

    def __init__(self, abspath, relpath):
        self.abspath = abspath
        self.relpath = relpath
        with open(abspath, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = None
        self.parse_error = None
        try:
            self.tree = ast.parse(self.text, filename=relpath)
        except SyntaxError as exc:
            self.parse_error = f"{exc.msg} (line {exc.lineno})"
        self.suppressions, self.pragma_problems = parse_suppressions(
            self.text
        )

    def suppression_for(self, finding):
        """The pragma covering ``finding``, or None.  A pragma applies to its
        own line and — when it is a standalone comment — to the next line."""
        for sup in self.suppressions:
            if not sup.matches(finding.rule):
                continue
            if sup.line == finding.line:
                return sup
            if sup.line == finding.line - 1 and self._standalone(sup.line):
                return sup
        return None

    def _standalone(self, lineno):
        line = self.lines[lineno - 1] if lineno - 1 < len(self.lines) else ""
        return line.lstrip().startswith("#")


def readme_section(text, heading=README_SECTION):
    """The part of ``text`` from the line starting with ``heading`` up to
    the next ``## `` heading, or None when no line starts with it."""
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if line.startswith(heading):
            end = next(
                (j for j in range(i + 1, len(lines))
                 if lines[j].startswith("## ")),
                len(lines),
            )
            return "".join(lines[i:end])
    return None


class Project:
    """The analyzed tree: every ``.py`` under the package dir, parsed once,
    plus the README's port section for doc-coverage rules."""

    def __init__(self, root, package="bqueryd_tpu_torch"):
        self.root = os.path.abspath(root)
        self.package = package
        self.files = []
        package_dir = os.path.join(self.root, package)
        for dirpath, dirnames, filenames in os.walk(package_dir):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__"
            )
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                abspath = os.path.join(dirpath, name)
                rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
                self.files.append(SourceFile(abspath, rel))
        if not self.files:
            # a wheel install's site-packages parent, a typo'd --root: fail
            # loudly instead of producing an empty-but-green run
            raise FileNotFoundError(
                f"{package_dir}: no Python sources found — --root must "
                "point at a source checkout"
            )
        #: None (not "") when the file or its port section is absent, so
        #: doc-coverage rules can report ONE missing-readme finding instead
        #: of one bogus undocumented finding per registered name
        self.readme_text = None
        readme = os.path.join(self.root, "README.md")
        if os.path.exists(readme):
            with open(readme, "r", encoding="utf-8") as f:
                self.readme_text = readme_section(f.read())

    def file(self, relpath):
        for sf in self.files:
            if sf.relpath == relpath:
                return sf
        return None

    def framework_findings(self):
        """Parse errors + malformed pragmas (+ missing README) as findings."""
        out = []
        if self.readme_text is None:
            out.append(Finding(
                "analysis-missing-readme", "README.md", 0,
                "README.md or its port section "
                f"({README_SECTION!r}) not found at the project root — "
                "doc-coverage rules (config table, metrics table) skipped",
                symbol="readme",
            ))
        for sf in self.files:
            if sf.parse_error:
                out.append(Finding(
                    "analysis-parse-error", sf.relpath, 0, sf.parse_error,
                    symbol="parse",
                ))
            for lineno, message in sf.pragma_problems:
                # default (message-derived) symbol: line numbers in
                # fingerprints would churn baselines on unrelated edits
                out.append(Finding(
                    "analysis-bad-pragma", sf.relpath, lineno, message,
                ))
        return out


def load_baseline(path):
    """``{fingerprint: justification}`` from the baseline file (missing file
    = empty baseline)."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: baseline must be a JSON object")
    return {str(k): str(v) for k, v in data.items()}


class SuiteResult:
    """Outcome of one suite run: new findings (gate), suppressed/baselined
    (reported, don't gate), per-rule and per-analyzer counts, wall time."""

    def __init__(self):
        self.new = []               # gating findings
        self.suppressed = []        # (finding, reason)
        self.baselined = []         # (finding, justification)
        self.per_analyzer = {}      # analyzer name -> raw finding count
        self.duration_s = 0.0
        self.files_scanned = 0
        self.analyzers_run = []

    @property
    def gating(self):
        return [f for f in self.new if f.severity == SEV_ERROR]

    def counts_by_rule(self):
        counts = {}
        for f in self.new:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return counts

    def to_dict(self):
        return {
            "schema": "bqueryd_tpu_torch.analysis/1",
            "files_scanned": self.files_scanned,
            "analyzers": self.analyzers_run,
            "duration_s": round(self.duration_s, 4),
            "findings": [f.to_dict() for f in self.new],
            "suppressed": [
                {**f.to_dict(), "reason": reason}
                for f, reason in self.suppressed
            ],
            "baselined": [
                {**f.to_dict(), "justification": just}
                for f, just in self.baselined
            ],
            "counts_by_rule": self.counts_by_rule(),
            "counts_by_analyzer": dict(self.per_analyzer),
            "exit_code": 1 if self.gating else 0,
        }

    def render_text(self):
        lines = []
        for f in sorted(
            self.new, key=lambda f: (f.path, f.line, f.rule)
        ):
            lines.append(f.render())
        lines.append(
            f"-- {len(self.new)} finding(s) "
            f"({len(self.gating)} gating), "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.baselined)} baselined, "
            f"{self.files_scanned} files, "
            f"{len(self.analyzers_run)} analyzers, "
            f"{self.duration_s:.2f}s"
        )
        return "\n".join(lines)


def known_rules(analyzers):
    rules = dict(FRAMEWORK_RULES)
    for a in analyzers:
        rules.update(a.RULES)
    return rules


def run_suite(root=None, analyzers=None, baseline_path=None, project=None):
    """Run ``analyzers`` (default: the full registered suite) over the tree
    at ``root`` and fold suppressions + baseline into a :class:`SuiteResult`.
    """
    from bqueryd_tpu_torch.analysis import default_analyzers

    t0 = time.perf_counter()
    if analyzers is None:
        analyzers = default_analyzers()
    if project is None:
        if root is None:
            # package dir sits at <root>/bqueryd_tpu_torch/analysis/core.py
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            )))
        project = Project(root)
    if baseline_path is None:
        baseline_path = os.path.join(project.root, BASELINE_FILENAME)
    baseline = load_baseline(baseline_path)

    result = SuiteResult()
    result.files_scanned = len(project.files)
    raw = project.framework_findings()
    result.per_analyzer["framework"] = len(raw)
    for analyzer in analyzers:
        found = list(analyzer.run(project))
        result.per_analyzer[analyzer.name] = len(found)
        result.analyzers_run.append(analyzer.name)
        raw.extend(found)

    # the known-rule universe is the FULL default suite plus whatever custom
    # analyzers ran: running a subset (--analyzer) must not misflag pragmas
    # for the families that sat out
    rules = known_rules(default_analyzers())
    rules.update(known_rules(analyzers))
    # unknown-rule pragmas: a suppression for a rule nobody declares is dead
    # weight that would silently mask a future rename
    for sf in project.files:
        for sup in sf.suppressions:
            for rule in sup.rules:
                if rule != "*" and rule not in rules:
                    raw.append(Finding(
                        "analysis-unknown-rule", sf.relpath, sup.line,
                        f"pragma suppresses unknown rule {rule!r}",
                        symbol=rule,
                    ))

    matched_fingerprints = set()
    for finding in raw:
        sf = project.file(finding.path)
        sup = sf.suppression_for(finding) if sf is not None else None
        if sup is not None:
            sup.used = True
            result.suppressed.append((finding, sup.reason))
            continue
        just = baseline.get(finding.fingerprint)
        if just is not None:
            matched_fingerprints.add(finding.fingerprint)
            result.baselined.append((finding, just))
            continue
        result.new.append(finding)

    for fingerprint, just in sorted(baseline.items()):
        if fingerprint not in matched_fingerprints:
            result.new.append(Finding(
                "analysis-stale-baseline", BASELINE_FILENAME, 0,
                f"baseline entry {fingerprint!r} matched no finding "
                f"(justification: {just!r}) — remove it",
                symbol=fingerprint,
            ))

    # unused pragmas: same only-shrinks contract as the baseline.  Only
    # gate pragmas whose rules BELONG to an analyzer that actually ran —
    # a subset run (--analyzer) must not misflag the families that sat out
    ran_rules = set(FRAMEWORK_RULES)
    for analyzer in analyzers:
        ran_rules.update(analyzer.RULES)
    for sf in project.files:
        for sup in sf.suppressions:
            if sup.used or "*" in sup.rules:
                continue
            if all(rule in ran_rules for rule in sup.rules):
                result.new.append(Finding(
                    "analysis-unused-pragma", sf.relpath, sup.line,
                    f"pragma allow[{','.join(sup.rules)}] matched no "
                    "finding — the suppressed code was fixed; remove the "
                    "pragma",
                    symbol=f"pragma@{','.join(sup.rules)}",
                ))

    result.duration_s = time.perf_counter() - t0
    return result

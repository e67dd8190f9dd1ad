"""Wire-schema drift guard: envelope keys vs the schema in ``messages.py``.

The protocol is JSON dict envelopes; a key added on one side of the wire
(``controller.py``) without the other (``worker.py``/``rpc.py``) is not a
type error anywhere — it is a silent protocol bug that surfaces as a
``None`` default three hops later.  This analyzer extracts every envelope
key LITERAL the wire modules read or write and diffs the result against the
declared schema (:data:`bqueryd_tpu_torch.messages.ENVELOPE_SCHEMA` /
``RESULT_ENVELOPE_SCHEMA``):

* ``wire-undeclared-key`` — a wire module touches an envelope key the
  schema does not declare;
* ``wire-one-sided-key`` — a declared key that is only ever written or only
  ever read across the wire modules (unless the schema entry explicitly
  waives it via ``WIRE_ONE_SIDED_OK`` with the reason — e.g. keys consumed
  by external clients or produced by the base ``Message`` constructor);
* ``wire-dead-key`` — a declared key neither read nor written anywhere;
* ``wire-missing-schema`` — the analyzed tree's ``messages.py`` declares no
  literal ``ENVELOPE_SCHEMA``.  The schemas are read from the analyzed
  tree only: no package is imported in their place.

Extraction is receiver-name based: within the three wire modules, variables
conventionally holding envelopes (``msg``, ``reply``, ``wrm``, ``shard``,
...) are treated as Message dicts; ``X.get("k")`` / ``X["k"]`` /
``"k" in X`` / ``X.pop("k")`` count as reads, ``X["k"] = v`` /
``X.add_as_binary("k", ...)`` / ``X.setdefault("k", v)`` and dict literals
passed to ``*Message({...})`` constructors count as writes.  The pickled
groupby result envelope (``{"ok": ..., "payloads": ...}``) is covered by
extracting every key of a dict literal serialized via ``pickle.dumps(...)``
— its single write idiom in the wire modules.
"""

import ast

from bqueryd_tpu_torch.analysis.core import Finding, module_literal

WIRE_FILES = ("controller.py", "worker.py", "rpc.py")

#: variable names that hold wire envelopes in the wire modules — the
#: receiver convention the extraction keys on (``segment``/``info``/
#: ``entry`` etc. are controller-local bookkeeping dicts, deliberately out)
RECEIVERS = frozenset({
    "msg", "reply", "wrm", "shard", "calc", "child", "err", "scatter",
    "fan", "envelope", "newmsg", "gossip",
    # the port worker's reply under construction (ErrorMessage or copy)
    "result",
    # the controller's worker_map entry: the absorbed WRM dict plus the
    # controller-local bookkeeping keys declared in the schema
    "info",
})


def _schema(project):
    """``(declared, one_sided_ok)`` read from the ANALYZED tree's
    ``messages.py`` (``--root`` diffs a checkout against its own schema),
    or None when that file declares no literal ``ENVELOPE_SCHEMA``."""
    sf = project.file(f"{project.package}/messages.py")
    if sf is None or sf.tree is None:
        return None
    found = {}
    for name in (
        "ENVELOPE_SCHEMA", "RESULT_ENVELOPE_SCHEMA", "WIRE_ONE_SIDED_OK",
    ):
        value = module_literal(sf.tree, name)
        if isinstance(value, dict):
            found[name] = value
    if "ENVELOPE_SCHEMA" not in found:
        return None
    declared = dict(found["ENVELOPE_SCHEMA"])
    declared.update(found.get("RESULT_ENVELOPE_SCHEMA", {}))
    return declared, dict(found.get("WIRE_ONE_SIDED_OK", {}))


class _KeyUseVisitor(ast.NodeVisitor):
    def __init__(self):
        self.reads = {}    # key -> [lineno]
        self.writes = {}   # key -> [lineno]

    def _mark(self, table, key_node, lineno):
        if isinstance(key_node, ast.Constant) and isinstance(
            key_node.value, str
        ):
            table.setdefault(key_node.value, []).append(lineno)

    @staticmethod
    def _receiver(node):
        return isinstance(node, ast.Name) and node.id in RECEIVERS

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute) and self._receiver(func.value):
            if func.attr in ("get", "get_from_binary", "pop") and node.args:
                self._mark(self.reads, node.args[0], node.lineno)
            elif func.attr in ("add_as_binary", "setdefault") and node.args:
                self._mark(self.writes, node.args[0], node.lineno)
        # CalcMessage({...}) / RPCMessage({...}) constructor payloads
        if isinstance(func, ast.Name) and func.id.endswith("Message"):
            for arg in node.args:
                if isinstance(arg, ast.Dict):
                    for key in arg.keys:
                        self._mark(self.writes, key, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if self._receiver(node.value):
            if isinstance(node.ctx, ast.Load):
                self._mark(self.reads, node.slice, node.lineno)
            else:
                self._mark(self.writes, node.slice, node.lineno)
        self.generic_visit(node)

    def visit_Compare(self, node):
        if len(node.ops) == 1 and isinstance(
            node.ops[0], (ast.In, ast.NotIn)
        ) and self._receiver(node.comparators[0]):
            self._mark(self.reads, node.left, node.lineno)
        self.generic_visit(node)


class _ResultEnvelopeVisitor(ast.NodeVisitor):
    """Writes of the pickled result envelope, anchored on its ONE
    serialization idiom — a dict literal as the first argument of
    ``pickle.dumps(...)``.  Matching bare dict literals by key intersection
    would count controller bookkeeping dicts that happen to share a key
    ('busy', 'error') and leave the guard vacuous for the real envelope.
    EVERY key of a pickled envelope counts as a write (so an undeclared key
    added to the envelope is caught, not just drift on declared ones)."""

    def __init__(self):
        self.writes = {}

    @staticmethod
    def _is_pickle_dumps(func):
        if isinstance(func, ast.Attribute) and func.attr == "dumps":
            return isinstance(func.value, ast.Name) and func.value.id in (
                "pickle", "pkl",
            )
        return isinstance(func, ast.Name) and func.id == "dumps"

    def visit_Call(self, node):
        if self._is_pickle_dumps(node.func) and node.args and isinstance(
            node.args[0], ast.Dict
        ):
            for key in node.args[0].keys:
                if isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    self.writes.setdefault(key.value, []).append(
                        node.lineno
                    )
        self.generic_visit(node)


class WireSchemaAnalyzer:
    name = "wire-schema"

    RULES = {
        "wire-undeclared-key":
            "wire module touches an envelope key not declared in "
            "messages.ENVELOPE_SCHEMA / RESULT_ENVELOPE_SCHEMA",
        "wire-one-sided-key":
            "declared envelope key written but never read (or read but "
            "never written) across the wire modules",
        "wire-dead-key":
            "declared envelope key neither read nor written in any wire "
            "module",
        "wire-missing-schema":
            "the analyzed tree's messages.py declares no literal "
            "ENVELOPE_SCHEMA",
    }

    def run(self, project):
        schema_file = f"{project.package}/messages.py"
        schema = _schema(project)
        if schema is None:
            return [Finding(
                "wire-missing-schema", schema_file, 0,
                "no literal ENVELOPE_SCHEMA in messages.py — the wire "
                "modules' envelope keys cannot be checked",
                symbol="ENVELOPE_SCHEMA",
            )]
        declared, one_sided_ok = schema
        findings = []
        reads = {}
        writes = {}

        for sf in project.files:
            name = sf.relpath.rsplit("/", 1)[-1]
            if sf.tree is None or name not in WIRE_FILES:
                continue
            visitor = _KeyUseVisitor()
            visitor.visit(sf.tree)
            envelope = _ResultEnvelopeVisitor()
            envelope.visit(sf.tree)
            for key, sites in visitor.reads.items():
                reads.setdefault(key, []).extend(
                    (sf.relpath, s) for s in sites
                )
            for table in (visitor.writes, envelope.writes):
                for key, sites in table.items():
                    writes.setdefault(key, []).extend(
                        (sf.relpath, s) for s in sites
                    )

        for key in sorted(set(reads) | set(writes)):
            if key not in declared:
                path, line = (reads.get(key) or writes.get(key))[0]
                findings.append(Finding(
                    "wire-undeclared-key", path, line,
                    f"envelope key {key!r} used on the wire but not "
                    "declared in messages.py schemas",
                    symbol=key,
                ))

        for key in sorted(declared):
            read = bool(reads.get(key))
            written = bool(writes.get(key))
            if key in one_sided_ok:
                continue
            if not read and not written:
                findings.append(Finding(
                    "wire-dead-key", schema_file, 0,
                    f"declared envelope key {key!r} is neither read nor "
                    "written by any wire module — dead schema entry",
                    symbol=key,
                ))
            elif read != written:
                side = "read" if read else "written"
                other = "written" if read else "read"
                where = (reads if read else writes)[key][0]
                findings.append(Finding(
                    "wire-one-sided-key", where[0], where[1],
                    f"envelope key {key!r} is {side} (e.g. here) but never "
                    f"{other} in any wire module — one-sided key; declare "
                    "it in messages.WIRE_ONE_SIDED_OK with the reason if "
                    "the peer lives outside controller/worker/rpc",
                    symbol=key,
                ))
        return findings

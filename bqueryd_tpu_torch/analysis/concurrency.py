"""Static lock-discipline checker for declared guarded attributes.

The query path is concurrent: one shared stage pool mutating LRU caches,
stage clocks, metric registries and flight rings from many threads.
Each of those classes already takes a lock on its hot paths — what nothing
checked is that EVERY touch of the shared state happens under it.  A missed
``with self._lock`` is exactly the bug class that surfaces as one flaky test
a month later.

Classes opt in by declaring their guarded attributes next to the state they
protect::

    class BytesCappedCache:
        #: lock discipline, checked by bqueryd_tpu_torch.analysis (lock-unguarded-attr)
        _bqtpu_guarded_ = {"_lock": ("_data", "_sizes", "_bytes")}

``_bqtpu_guarded_`` maps lock-attribute name to the attributes it guards (a
bare tuple is shorthand for ``{"_lock": (...)}``).  The analyzer then walks
every method and reports any ``self.<attr>`` touch (read or write) of a
guarded attribute that is not lexically inside ``with self.<lock>`` —
except in ``__init__`` (construction happens-before publication) and in
methods named ``*_locked`` (the convention for helpers whose contract is
"caller holds the lock"; the analyzer verifies that convention's other half
by flagging any CALL of a ``*_locked`` method outside the lock).

This is lexical, not interprocedural, by design: the discipline it enforces
is "take the lock in the method that touches the state", which is also the
discipline that keeps the code reviewable.  Accesses that are deliberately
lock-free (GIL-atomic monitoring reads) carry an inline
``# bqtpu: allow[lock-unguarded-attr] <why>`` pragma, so every exception is
written down where it happens.
"""

import ast

from bqueryd_tpu_torch.analysis.core import Finding

DECLARATION_ATTR = "_bqtpu_guarded_"


def _literal_declaration(node):
    """Parse the ``_bqtpu_guarded_ = {...}`` class-body assignment into
    ``{lock_attr: (attr, ...)}``.  Returns None if the node isn't the
    declaration at all, and the string ``"unparseable"`` when it IS the
    declaration but not a literal — the caller must turn that into a
    finding, never silently skip the class (a refactor to a computed value
    would otherwise disable the whole check while CI stays green)."""
    if not isinstance(node, ast.Assign) or len(node.targets) != 1:
        return None
    target = node.targets[0]
    if not isinstance(target, ast.Name) or target.id != DECLARATION_ATTR:
        return None
    try:
        value = ast.literal_eval(node.value)
    except (ValueError, SyntaxError):
        return "unparseable"
    if isinstance(value, (tuple, list)):
        return {"_lock": tuple(value)}
    if isinstance(value, dict):
        return {
            str(lock): tuple(attrs) for lock, attrs in value.items()
        }
    return "unparseable"


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking which declared locks are lexically
    held (``with self.<lock>:`` nesting)."""

    def __init__(self, guarded, relpath, classname, methodname):
        self.guarded = guarded          # attr -> lock name
        self.locks = set(guarded.values())
        self.relpath = relpath
        self.classname = classname
        self.methodname = methodname
        self.held = set()
        self.findings = []

    def _self_attr(self, node):
        return (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr
        ) or None

    def visit_With(self, node):
        # items are processed left to right, mirroring runtime semantics:
        # in ``with self._lock, ctx(self._data):`` the lock IS held while
        # the second context expression evaluates
        newly = set()
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            if attr in self.locks:
                if attr not in self.held:
                    newly.add(attr)
                    self.held.add(attr)
            else:
                # non-lock context expressions may touch guarded state
                # (e.g. ``with open(self._path)``): check them as usual
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        self.held -= newly

    def visit_Attribute(self, node):
        attr = self._self_attr(node)
        if attr:
            lock = self.guarded.get(attr)
            if lock is not None and lock not in self.held:
                self.findings.append(Finding(
                    "lock-unguarded-attr", self.relpath, node.lineno,
                    f"{self.classname}.{self.methodname} touches guarded "
                    f"attribute self.{attr} outside 'with self.{lock}'",
                    symbol=f"{self.classname}.{self.methodname}.{attr}",
                ))
        self.generic_visit(node)

    def visit_Call(self, node):
        # the *_locked convention's caller side: such helpers must only be
        # invoked while the guarding lock is held
        func = node.func
        attr = self._self_attr(func)
        if attr and attr.endswith("_locked") and self.locks - self.held:
            held_none = not (self.locks & self.held)
            if held_none:
                self.findings.append(Finding(
                    "lock-helper-outside-lock", self.relpath, node.lineno,
                    f"{self.classname}.{self.methodname} calls "
                    f"self.{attr}() without holding any declared lock — "
                    "the *_locked suffix promises the caller holds it",
                    symbol=f"{self.classname}.{self.methodname}.{attr}",
                ))
        self.generic_visit(node)


class LockDisciplineAnalyzer:
    name = "lock-discipline"

    RULES = {
        "lock-unguarded-attr":
            "declared-guarded attribute touched outside its lock's 'with' "
            "block",
        "lock-helper-outside-lock":
            "*_locked helper called without holding a declared lock",
        "lock-missing-lock-attr":
            "_bqtpu_guarded_ names a lock attribute the class never "
            "assigns",
        "lock-bad-declaration":
            "_bqtpu_guarded_ is not a literal dict/tuple — the class "
            "cannot be checked",
    }

    def run(self, project):
        findings = []
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                declaration = None
                for stmt in node.body:
                    declaration = _literal_declaration(stmt)
                    if declaration is not None:
                        break
                if declaration == "unparseable" or declaration == {}:
                    # an opted-in class whose declaration we cannot read
                    # must FAIL, not silently lose its checking
                    findings.append(Finding(
                        "lock-bad-declaration", sf.relpath, node.lineno,
                        f"{node.name}._bqtpu_guarded_ must be a literal "
                        "dict {lock: (attrs...)} or tuple of attrs — a "
                        "computed value silently disables the lock check "
                        "for the whole class",
                        symbol=node.name,
                    ))
                    continue
                if declaration is None:
                    continue
                attr_to_lock = {}
                for lock, attrs in declaration.items():
                    for attr in attrs:
                        attr_to_lock[attr] = lock
                assigned = {
                    n.attr
                    for meth in node.body
                    if isinstance(meth, ast.FunctionDef)
                    for n in ast.walk(meth)
                    if isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    and isinstance(n.ctx, ast.Store)
                }
                for lock in declaration:
                    if lock not in assigned:
                        findings.append(Finding(
                            "lock-missing-lock-attr", sf.relpath,
                            node.lineno,
                            f"{node.name}._bqtpu_guarded_ names lock "
                            f"{lock!r} but no method assigns self.{lock}",
                            symbol=f"{node.name}.{lock}",
                        ))
                for meth in node.body:
                    if not isinstance(meth, ast.FunctionDef):
                        continue
                    if meth.name == "__init__" or meth.name.endswith(
                        "_locked"
                    ):
                        # __init__ publishes nothing concurrently; *_locked
                        # helpers run under the caller's lock (their call
                        # sites are checked instead)
                        continue
                    checker = _MethodChecker(
                        attr_to_lock, sf.relpath, node.name, meth.name
                    )
                    for stmt in meth.body:
                        checker.visit(stmt)
                    findings.extend(checker.findings)
        return findings

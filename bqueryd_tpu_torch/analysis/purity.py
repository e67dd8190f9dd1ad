"""Launch-boundary purity lint over ``ops/`` and ``parallel/executor.py``.

The port has no ``jax.jit``.  Its counterpart of the reference's jit
boundary is the kernel launch: the wrappers ``onehot_rows_dot`` and
``onehot_rows_dot_hicard`` (``ops/onehot.py``) and the functions they reach
that launch from the kernel library (``_launch_base``, ``_launch_hicard``).
A host effect there runs once per launch on the query's hot path: a
``time.*`` or environment read per call, or a device->host sync that stalls
the stream the launches are queued on (``.item()``, ``.tolist()``,
``.cpu()``, a Python branch on a tensor's value).  The profiler's
call accounting (``obs.profile.instrument``) counts what reaches a launch;
``launch-uninstrumented`` keeps every wrapper inside that accounting.

The boundary is found, not declared: a **launcher** is a function whose
body calls a library symbol named ``*_launch`` (``lib.onehot_mma_launch``);
the boundary is the launchers plus every function of the same module that
calls one of them, transitively.  A boundary function's **tensor
parameters** are those its body reads tensor metadata of (``.shape``,
``.dtype``, ``.device``, ``.data_ptr()``, ``.stride()``, ...); the rest
(``n_rows``, ``plan``) are host values and free to coerce and branch on.

Each reference rule and its port rule:

==========================  ================================================
reference (``jit-*``)       port (``launch-*``)
==========================  ================================================
``jit-impure-time``         ``launch-impure-time``: ``time.*`` call in the
                            boundary
``jit-impure-env``          ``launch-impure-env``: environment access in the
                            boundary
``jit-host-numpy``          ``launch-host-numpy``: ``np.*`` applied to a
                            tensor parameter (a device->host copy)
``jit-traced-coerce``       ``launch-host-coerce``: ``float()``/``int()``/
                            ``bool()`` of a tensor parameter, or its
                            ``.item()``, ``.tolist()``, ``.cpu()``,
                            ``.numpy()`` (a device sync)
``jit-traced-branch``       ``launch-tensor-branch``: ``if``/``while`` on a
                            tensor parameter's value (its metadata and
                            ``is None`` are fine)
``jit-lru-closure``         ``launch-lru-closure``: unchanged, over the same
                            scope
``jit-uninstrumented``      ``launch-uninstrumented``: a public boundary
                            function never named at an ``instrument(...)``
                            site (directly or through a factory that wraps
                            its argument with ``instrument``), or called
                            directly from another package module
``jit-nonhashable-static``  not ported: a launch has no static arguments
==========================  ================================================
"""

import ast
import os

from bqueryd_tpu_torch.analysis.core import Finding

#: the launch boundary lives in the kernel layer; control-plane modules
#: launch nothing and would only add noise
SCOPE_DIRS = ("ops",)
SCOPE_FILES = ("parallel/executor.py",)

#: tensor attributes that read metadata only (no device sync): reading one
#: marks the receiver as a tensor, and a branch on one is host-side
METADATA_ATTRS = frozenset({
    "shape", "dtype", "device", "data_ptr", "stride", "is_contiguous",
    "dim", "ndim", "numel", "element_size", "is_cuda", "layout",
})

#: tensor methods that copy to the host or synchronize the stream
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


def in_scope(relpath, package):
    rel = relpath.split("/", 1)[1] if "/" in relpath else relpath
    head = rel.split("/", 1)[0]
    return head in SCOPE_DIRS or rel in SCOPE_FILES


def _call_name(func):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_launcher(func_def):
    """True when the body calls a kernel-library symbol ``*_launch``."""
    for node in ast.walk(func_def):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr.endswith("_launch")
        ):
            return True
    return False


def _called_names(func_def):
    return {
        node.func.id
        for node in ast.walk(func_def)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
    }


def launch_boundary(tree):
    """``{name: FunctionDef}`` of the module-level functions in the launch
    boundary: the launchers and their callers in this module,
    transitively."""
    functions = {
        node.name: node for node in tree.body
        if isinstance(node, ast.FunctionDef)
    }
    boundary = {n for n, f in functions.items() if _is_launcher(f)}
    grew = True
    while grew:
        grew = False
        for name, func in functions.items():
            if name not in boundary and _called_names(func) & boundary:
                boundary.add(name)
                grew = True
    return {name: functions[name] for name in boundary}


def tensor_params(func_def):
    """Parameters the body reads tensor metadata of."""
    params = {a.arg for a in func_def.args.args}
    found = set()
    for node in ast.walk(func_def):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in METADATA_ATTRS
            and isinstance(node.value, ast.Name)
            and node.value.id in params
        ):
            found.add(node.value.id)
    return found


class _LaunchBodyChecker(ast.NodeVisitor):
    def __init__(self, relpath, func_name, tensors):
        self.relpath = relpath
        self.func_name = func_name
        self.tensors = tensors
        self.findings = []

    def _finding(self, rule, node, message, anchor):
        self.findings.append(Finding(
            rule, self.relpath, node.lineno,
            f"in launch path {self.func_name}: {message}",
            symbol=f"{self.func_name}.{anchor}",
        ))

    def _is_tensor_name(self, node):
        return isinstance(node, ast.Name) and node.id in self.tensors

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            root = func.value
            if isinstance(root, ast.Name):
                if root.id == "time":
                    self._finding(
                        "launch-impure-time", node,
                        f"time.{func.attr}() runs on every launch",
                        f"time.{func.attr}",
                    )
                elif root.id == "np" and any(
                    self._is_tensor_name(a) for a in node.args
                ):
                    self._finding(
                        "launch-host-numpy", node,
                        f"np.{func.attr}() applied to a tensor argument "
                        "copies it to the host",
                        f"np.{func.attr}",
                    )
                elif root.id == "os" and func.attr == "getenv":
                    self._finding(
                        "launch-impure-env", node,
                        "os.getenv() read on every launch",
                        "os.getenv",
                    )
            if func.attr in SYNC_METHODS and self._is_tensor_name(
                func.value
            ):
                self._finding(
                    "launch-host-coerce", node,
                    f"{func.value.id}.{func.attr}() synchronizes the "
                    "device on every launch",
                    f"{func.value.id}.{func.attr}",
                )
        elif isinstance(func, ast.Name):
            if func.id in ("float", "int", "bool") and node.args and (
                self._is_tensor_name(node.args[0])
            ):
                self._finding(
                    "launch-host-coerce", node,
                    f"{func.id}({node.args[0].id}) coerces a tensor "
                    "argument to a host scalar (a device sync)",
                    f"{func.id}.{node.args[0].id}",
                )
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if (
            node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id == "os"
        ):
            self._finding(
                "launch-impure-env", node,
                "os.environ read on every launch",
                "os.environ",
            )
        self.generic_visit(node)

    def _value_uses(self, test):
        """Tensor-parameter names the test reads the VALUE of: a name
        under a metadata attribute, or compared with ``is``, is exempt."""
        exempt = set()
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr in METADATA_ATTRS:
                exempt.add(id(sub.value))
            elif isinstance(sub, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops
            ):
                exempt.update(id(x) for x in [sub.left, *sub.comparators])
            elif isinstance(sub, ast.Call) and _call_name(sub.func) in (
                "len", "isinstance",
            ):
                exempt.update(id(a) for a in sub.args)
        for sub in ast.walk(test):
            if self._is_tensor_name(sub) and id(sub) not in exempt:
                yield sub

    def _check_branch(self, node, kind):
        for sub in self._value_uses(node.test):
            self._finding(
                "launch-tensor-branch", node,
                f"{kind} branches on the value of tensor argument "
                f"{sub.id!r}: a device sync on every launch",
                f"{kind}.{sub.id}",
            )
            return

    def visit_If(self, node):
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch(node, "while")
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        # nested defs: their params shadow the outer tensor names
        inner = {a.arg for a in node.args.args}
        outer = self.tensors
        self.tensors = self.tensors - inner
        self.generic_visit(node)
        self.tensors = outer


def _is_lru_cache_decorator(dec):
    target = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(target, ast.Attribute):
        return target.attr == "lru_cache"
    return isinstance(target, ast.Name) and target.id == "lru_cache"


def _is_instrument_call(node):
    return isinstance(node, ast.Call) and _call_name(node.func) == "instrument"


def _instrumented_names(trees):
    """Names reached through ``instrument(...)``: Name and string
    arguments of an ``instrument`` call, and of any call to a factory
    function whose body calls ``instrument`` (``_kernel_call("name")``)."""
    names = set()
    factories = set()

    def take(args):
        for arg in args:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
                elif isinstance(sub, ast.Constant) and isinstance(
                    sub.value, str
                ):
                    names.add(sub.value)

    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and any(
                _is_instrument_call(sub) for sub in ast.walk(node)
            ):
                factories.add(node.name)
            if _is_instrument_call(node):
                take(node.args)
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Name
            ) and node.func.id in factories:
                take(node.args)
    return names


class LaunchPurityAnalyzer:
    name = "launch-purity"

    RULES = {
        "launch-impure-time": "time.* call inside the launch boundary",
        "launch-impure-env": "environment access inside the launch boundary",
        "launch-host-numpy": "host numpy applied to a tensor argument",
        "launch-host-coerce":
            "host scalar coercion or host copy of a tensor argument "
            "(.item/.tolist/.cpu/.numpy, float/int/bool)",
        "launch-tensor-branch":
            "Python branch on a tensor argument's value",
        "launch-lru-closure":
            "functools.lru_cache on a closure (cache keyed on captured "
            "object identity; pins tensors)",
        "launch-uninstrumented":
            "public launch wrapper not reached through the profiler's "
            "instrument()",
    }

    def run(self, project):
        files = [
            sf for sf in project.files
            if sf.tree is not None and in_scope(sf.relpath, project.package)
        ]
        instrumented = _instrumented_names([sf.tree for sf in files])
        findings = []
        wrappers = {}    # public boundary name -> defining relpath
        for sf in files:
            findings.extend(self._check_file(sf, instrumented, wrappers))
        findings.extend(self._direct_calls(project, wrappers))
        return findings

    def _check_file(self, sf, instrumented, wrappers):
        findings = []
        module_name = os.path.basename(sf.relpath)
        boundary = launch_boundary(sf.tree)
        for name, func in sorted(boundary.items()):
            checker = _LaunchBodyChecker(
                sf.relpath, name, tensor_params(func)
            )
            for stmt in func.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
            if name.startswith("_"):
                continue
            wrappers[name] = sf.relpath
            if name not in instrumented:
                findings.append(Finding(
                    "launch-uninstrumented", sf.relpath, func.lineno,
                    f"launch wrapper {name!r} in {module_name} is never "
                    "reached through profile.instrument(): its calls are "
                    "invisible to the profiler's call accounting",
                    symbol=name,
                ))
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.FunctionDef):
                for dec in node.decorator_list:
                    if _is_lru_cache_decorator(dec) and self._is_nested(
                        sf.tree, node
                    ):
                        findings.append(Finding(
                            "launch-lru-closure", sf.relpath, node.lineno,
                            f"lru_cache on nested function {node.name!r}: "
                            "the cache outlives the closure and keys on "
                            "captured identity",
                            symbol=node.name,
                        ))
        return findings

    @staticmethod
    def _direct_calls(project, wrappers):
        """A call of a launch wrapper by name from another package module
        bypasses the instrumented entry points."""
        findings = []
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node.func)
                home = wrappers.get(name)
                if home is None or home == sf.relpath:
                    continue
                findings.append(Finding(
                    "launch-uninstrumented", sf.relpath, node.lineno,
                    f"direct call of launch wrapper {name!r} (defined in "
                    f"{home}) bypasses the instrumented entry points",
                    symbol=f"call:{name}",
                ))
        return findings

    @staticmethod
    def _is_nested(tree, func_def):
        """True when ``func_def`` is defined inside another function."""
        class Finder(ast.NodeVisitor):
            def __init__(self):
                self.nested = False
                self._stack = 0

            def visit_FunctionDef(self, node):
                if node is func_def:
                    if self._stack > 0:
                        self.nested = True
                    return
                self._stack += 1
                self.generic_visit(node)
                self._stack -= 1

            visit_AsyncFunctionDef = visit_FunctionDef

        finder = Finder()
        finder.visit(tree)
        return finder.nested

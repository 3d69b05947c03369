"""AST lint for ``@tick_path`` methods: Python-level host syncs (the
reference ``analysis/astlint.py``, in PyTorch's idiom).

``synccheck`` runs inside the engine's steps; this pass sees the Python
glue *between* them, the per-tick driver methods where a stray
``int(device_scalar)`` or ``bool(x.sum())`` silently serializes the
stream (and, inside a CUDA graph capture, is an error).  It runs a small
order-sensitive taint analysis over each function marked
``@tick_path(allowed_fetches=N)``:

* **device** values are the results of ``torch.*`` calls (not
  ``torch.from_numpy`` and the like, which stay on the host), of the
  engine's step graphs (``self._decode(...)`` / ``self._verify(...)``, any
  ``*_jit`` attribute, and callables bound from ``*_fn`` / ``_make_*``
  builders), and of methods on device values;
* ``host_fetch(x)`` is the one sanctioned fetch: every call counts against
  ``allowed_fetches`` (STR002 when exceeded) and its result is host data;
* ``int()`` / ``float()`` / ``bool()`` of a device value, ``.item()`` /
  ``.tolist()`` / ``.cpu()`` / ``.numpy()`` / ``.to("cpu")`` on one,
  ``np.asarray`` of one, or a device value as an ``if`` / ``while`` test or
  a ``for`` iterator is a hidden host sync -> STR001;
* ``torch.as_tensor`` / ``torch.tensor`` of a bare name the function
  neither binds nor receives, or ``.to(...)`` / ``.cuda()`` on one, is
  per-tick re-staging of data that should have been staged at admission
  -> STR004.

Loop-carried taint is handled by running each body twice and reporting
only on the second pass.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis import Finding

DEVICE_ROOTS = {"torch"}
#: ``torch.*`` calls whose result lives on the host (or is no tensor).
TORCH_HOST = {"from_numpy", "device", "dtype", "Size", "is_tensor", "numel",
              "get_default_dtype", "no_grad", "inference_mode", "cuda", "backends"}
#: The engine's tick graphs, called as ``self.<attr>(...)``.
STEP_ATTRS = {"_decode", "_verify"}
HOST_COERCIONS = {"int", "float", "bool"}
#: Methods that copy a device value to the host (each a blocking D2H).
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
FETCH_NAMES = {"host_fetch"}
STAGING_CALLS = {("torch", "as_tensor"), ("torch", "tensor")}
STAGING_METHODS = {"to", "cuda"}
# numpy results are host-side by construction
HOST_ROOTS = {"np", "numpy", "math"}


def _dotted_root(node: ast.expr) -> str | None:
    """Leftmost name of a Name/Attribute chain (``torch.argmax`` -> torch)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _decorator_name(dec: ast.expr) -> str | None:
    node = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _tick_decorator(fn: ast.FunctionDef) -> ast.expr | None:
    for dec in fn.decorator_list:
        if _decorator_name(dec) == "tick_path":
            return dec
    return None


def _allowed_fetches(dec: ast.expr) -> int:
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "allowed_fetches" and isinstance(kw.value, ast.Constant):
                return int(kw.value.value)
    return 0


def _assigned_names(fn: ast.FunctionDef) -> set[str]:
    """Every name the function binds (params, assignments, loops, withs)."""
    names = {a.arg for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs}
    if fn.args.vararg:
        names.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        names.add(fn.args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For,
                             ast.comprehension)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            for sub in ast.walk(node.optional_vars):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
        elif isinstance(node, ast.NamedExpr):
            names.add(node.target.id)
    return names


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")`` or ``x.to(torch.device("cpu"))``."""
    vals = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value.startswith("cpu"):
            return True
    return False


def _is_builder(value: ast.expr) -> bool:
    """A call that returns a step callable: ``*_fn(...)`` / ``_make_*(...)``."""
    if not (isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute)):
        return False
    attr = value.func.attr
    return attr.endswith("_fn") or attr.startswith("_make_")


class _FnLint:
    """Taint walk over one @tick_path function."""

    def __init__(self, fn: ast.FunctionDef, target: str):
        self.fn = fn
        self.target = target
        self.allowed = _allowed_fetches(_tick_decorator(fn))
        self.bound = _assigned_names(fn)
        self.tainted: set[str] = set()
        self.dev_callables: set[str] = set()
        self.fetches: list[int] = []  # linenos of sanctioned fetches
        self.findings: list[Finding] = []
        self.report = False  # second pass only

    # -- device-ness of an expression ------------------------------------

    def is_device(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self.is_device(node.value)
        if isinstance(node, ast.Call):
            return self.call_is_device(node)
        if isinstance(node, ast.BinOp):
            return self.is_device(node.left) or self.is_device(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand)
        if isinstance(node, ast.Compare):
            return self.is_device(node.left) or any(
                self.is_device(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.is_device(v) for v in node.values)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_device(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_device(node.body) or self.is_device(node.orelse)
        return False

    def call_is_device(self, node: ast.Call) -> bool:
        func = node.func
        if isinstance(func, ast.Name):
            return func.id in self.dev_callables  # else host (coercions flagged elsewhere)
        if isinstance(func, ast.Attribute):
            root = _dotted_root(func)
            if root in HOST_ROOTS:
                return False
            if root in DEVICE_ROOTS:
                chain = func
                while isinstance(chain.value, ast.Attribute):
                    chain = chain.value
                return chain.attr not in TORCH_HOST and func.attr not in TORCH_HOST
            if func.attr.endswith("_jit") or (
                    func.attr in STEP_ATTRS and isinstance(func.value, ast.Name)
                    and func.value.id == "self"):
                return True
            # method on a device value (x.sum(), x.to(torch.int32))
            if self.is_device(func.value):
                return func.attr not in HOST_METHODS and not (
                    func.attr == "to" and _to_cpu(node))
        return False

    # -- fetch / sync classification of one Call -------------------------

    def scan_call(self, node: ast.Call) -> None:
        func = node.func
        args_device = any(self.is_device(a) for a in node.args)
        name = func.id if isinstance(func, ast.Name) else None
        attr = func.attr if isinstance(func, ast.Attribute) else None
        root = _dotted_root(func) if isinstance(func, ast.Attribute) else None
        on_device = isinstance(func, ast.Attribute) and self.is_device(func.value)

        if name in FETCH_NAMES:
            self.fetches.append(node.lineno)
        elif name in HOST_COERCIONS and args_device:
            self.emit("STR001", node.lineno,
                      f"{name}() coerces a device value to host (implicit blocking D2H)")
        elif root in HOST_ROOTS and attr in {"asarray", "array"} and args_device:
            self.emit("STR001", node.lineno,
                      f"np.{attr}() of a device value (implicit blocking D2H; "
                      "host_fetch is the sanctioned copy)")
        elif on_device and (attr in HOST_METHODS or (attr == "to" and _to_cpu(node))):
            self.emit("STR001", node.lineno,
                      f".{attr}() on a device value (implicit blocking D2H)")

        # STR004: per-tick H2D restage of a name this function never binds
        staged = None
        if (root, attr) in STAGING_CALLS and node.args and isinstance(node.args[0], ast.Name):
            staged = node.args[0].id
        elif attr in STAGING_METHODS and isinstance(func.value, ast.Name) \
                and func.value.id not in HOST_ROOTS | DEVICE_ROOTS:
            staged = func.value.id
        if staged is not None and staged not in self.bound:
            self.emit("STR004", node.lineno,
                      f"staging of '{staged}' (not bound in this function) re-uploads "
                      "admission-time data every tick")

    def emit(self, rule: str, lineno: int, msg: str) -> None:
        if self.report:
            self.findings.append(Finding(rule=rule, target=f"{self.target}:{lineno}",
                                         message=msg, pass_name="sync"))

    # -- statement walk ---------------------------------------------------

    def taint_target(self, target: ast.expr, device: bool) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if device else self.tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.taint_target(e, device)
        elif isinstance(target, ast.Starred):
            self.taint_target(target.value, device)
        # attribute/subscript targets: not tracked as locals

    def handle_assign_value(self, value: ast.expr) -> bool:
        """Device-ness of an assigned value, honoring fetch semantics."""
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
                and value.func.id in FETCH_NAMES:
            return False  # fetched -> host (counted in scan_call)
        return self.is_device(value)

    def walk_stmts(self, stmts: Iterable[ast.stmt]) -> None:
        for stmt in stmts:
            for call in [n for n in ast.walk(stmt) if isinstance(n, ast.Call)]:
                self.scan_call(call)

            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = stmt.value
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                if value is None:
                    continue
                # builder call -> the bound name is a device callable
                if _is_builder(value):
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.dev_callables.add(t.id)
                    continue
                device = self.handle_assign_value(value)
                for t in targets:
                    self.taint_target(t, device)
            elif isinstance(stmt, (ast.If, ast.While)):
                if self.is_device(stmt.test):
                    self.emit("STR001", stmt.lineno,
                              "branching on a device value (implicit blocking D2H in "
                              "the test)")
                self.walk_stmts(stmt.body)
                self.walk_stmts(stmt.orelse)
            elif isinstance(stmt, ast.For):
                if self.is_device(stmt.iter):
                    self.emit("STR001", stmt.lineno,
                              "iterating a device value (implicit blocking D2H per "
                              "element)")
                self.taint_target(stmt.target, False)
                self.walk_stmts(stmt.body)
                self.walk_stmts(stmt.orelse)
            elif isinstance(stmt, ast.With):
                self.walk_stmts(stmt.body)
            elif isinstance(stmt, ast.Try):
                self.walk_stmts(stmt.body)
                for h in stmt.handlers:
                    self.walk_stmts(h.body)
                self.walk_stmts(stmt.orelse)
                self.walk_stmts(stmt.finalbody)
            # returning a raw device value is fine (the caller decides);
            # coercions inside any statement were scanned above.

    def run(self) -> list[Finding]:
        # pass 1: propagate taint (incl. loop-carried); pass 2: report
        self.walk_stmts(self.fn.body)
        self.report = True
        self.fetches = []
        self.walk_stmts(self.fn.body)
        if len(self.fetches) > self.allowed:
            self.findings.append(Finding(
                rule="STR002", target=f"{self.target}:{self.fn.lineno}",
                message=(f"{len(self.fetches)} sanctioned fetches on a tick path declaring "
                         f"allowed_fetches={self.allowed} (lines {self.fetches})"),
                pass_name="sync"))
        return self.findings


def lint_source(source: str, module_name: str) -> list[Finding]:
    """Lint every ``@tick_path`` function in a module's source text."""
    tree = ast.parse(source)
    findings: list[Finding] = []
    stack: list[tuple[str, ast.AST]] = [("", tree)]
    while stack:
        prefix, node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                stack.append((f"{prefix}{child.name}.", child))
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(child, ast.FunctionDef) and _tick_decorator(child) is not None:
                    target = f"{module_name}.{prefix}{child.name}"
                    findings.extend(_FnLint(child, target).run())
                stack.append((f"{prefix}{child.name}.", child))
    return findings


def lint_module(module) -> list[Finding]:
    """Lint a live module object (reads its source file)."""
    import inspect

    return lint_source(inspect.getsource(module), module.__name__)

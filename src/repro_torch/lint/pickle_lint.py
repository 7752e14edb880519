"""R4: static pickle-safety for sweep units; the port's copy of
``repro.lint.pickle_lint``, unchanged.

``run_grid`` ships ``GridPoint``s across a process pool; anything that
reaches them must pickle.  The statically catchable offenders are
lambdas, generator expressions, and locally-defined (closure)
functions passed by name — the classic "works with 1 worker, dies with
ProcessPoolExecutor" class of bug.  The rule walks every
``GridPoint(...)`` / ``run_grid(...)`` call site and flags those three
shapes inside the arguments (R401).
"""

from __future__ import annotations

import ast
from typing import List, Set

from .findings import Finding

__all__ = ["check_pickle", "SWEEP_ENTRYPOINTS"]

SWEEP_ENTRYPOINTS = frozenset({"GridPoint", "run_grid"})


def _leaf_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


class _PickleVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        # per-function-frame set of locally defined function names;
        # anything in an enclosing frame is a closure if passed onward
        self._local_defs: List[Set[str]] = []

    def _qual(self) -> str:
        return ".".join(self._scope) if self._scope else "module"

    def _visit_func(self, node) -> None:
        if self._local_defs:                 # nested def = closure risk
            self._local_defs[-1].add(node.name)
        self._scope.append(node.name)
        self._local_defs.append(set())
        self.generic_visit(node)
        self._local_defs.pop()
        self._scope.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_Call(self, node: ast.Call) -> None:
        if _leaf_name(node.func) in SWEEP_ENTRYPOINTS:
            target = _leaf_name(node.func)
            values = list(node.args) \
                + [kw.value for kw in node.keywords]
            local = set().union(*self._local_defs) \
                if self._local_defs else set()
            for value in values:
                self._check_arg(node, target, value, local)
        self.generic_visit(node)

    def _check_arg(self, call: ast.Call, target: str, value: ast.AST,
                   local: Set[str]) -> None:
        # a local function *called* here only contributes its (plain
        # data) return value; only a local function passed *as a value*
        # ships the closure itself through the pool
        called = {id(sub.func) for sub in ast.walk(value)
                  if isinstance(sub, ast.Call)}
        for sub in ast.walk(value):
            if isinstance(sub, ast.Lambda):
                self.findings.append(Finding(
                    "R401", self.path, sub.lineno, self._qual(),
                    f"lambda passed into `{target}(...)` cannot "
                    "pickle across the sweep's process pool; use a "
                    "module-level function"))
            elif isinstance(sub, ast.GeneratorExp):
                self.findings.append(Finding(
                    "R401", self.path, sub.lineno, self._qual(),
                    f"generator expression passed into `{target}(...)`"
                    " cannot pickle; materialize a list/tuple"))
            elif isinstance(sub, ast.Name) and sub.id in local \
                    and id(sub) not in called:
                self.findings.append(Finding(
                    "R401", self.path, sub.lineno, self._qual(),
                    f"locally-defined function `{sub.id}` passed into "
                    f"`{target}(...)` is a closure and cannot pickle; "
                    "hoist it to module level"))


def check_pickle(source: str, path: str) -> List[Finding]:
    tree = ast.parse(source, filename=path)
    v = _PickleVisitor(path)
    v.visit(tree)
    return v.findings

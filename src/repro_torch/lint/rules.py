"""R1 (nondeterminism sources) and R2 (ordering hazards) AST rules; the
port's copy of ``repro.lint.rules``, whose R102 also flags torch's
process-global RNG.

These are the "race detector" half of the determinism contract
(DESIGN.md 3, 10): any call that reads host state (wall clock,
process-global RNG, hash seed) or any ordering operation whose key can
tie on a float is a path by which host nondeterminism leaks into a
virtual-time trace.

Rule ids
--------
R101  wall-clock read (``time.time``/``perf_counter``/``datetime.now``)
R102  process-global / unseeded RNG (``random.*`` module calls,
      legacy ``np.random.*``, ``torch.manual_seed``/``torch.seed`` and
      torch's sampling functions called without ``generator=``,
      ``os.urandom``, ``secrets``, ``uuid1/4``)
R103  env-dependent builtin ``hash()``
R201  iteration over a ``set``/``frozenset`` (unordered under
      PYTHONHASHSEED) reaching loop/comprehension order
R202  ``.popitem()`` without an explicit ``last=`` argument
R203  ``sorted``/``min``/``max``/``.sort``/``heappush`` whose key is a
      bare float without the ``(float, int_seq)`` tie-break the event
      calendar mandates (cluster/ + serving/ only)

All rules are syntactic and deliberately conservative: a site is only
flagged on a *positive* signal (a known wall-clock name, a key that
looks like a float), never on "could not prove safe".  False negatives
are accepted; false positives in hot paths are not, because every one
costs an inline suppression with a reason.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from .findings import Finding

__all__ = ["scan_source", "NondetVisitor"]

# -- R101: wall-clock reads --------------------------------------------------
# matched as a suffix of the resolved dotted name, so both
# `time.perf_counter()` and `from time import perf_counter` hit
_WALLCLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns", "time.clock_gettime",
    "datetime.now", "datetime.utcnow", "datetime.today", "date.today",
}

# -- R102: global / unseeded RNG --------------------------------------------
# calling into the process-global `random` module is flagged; constructing
# a seeded `random.Random(seed)` instance is the sanctioned idiom and is not
_RANDOM_OK = {"Random"}
# numpy's new-style explicit-generator API is the sanctioned idiom; the
# legacy `np.random.<dist>` global-state calls are not
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "SFC64", "MT19937", "BitGenerator"}
# torch keeps one process-global generator a device: seeding it is flagged,
# and so is a sampling call that draws from it (no ``generator=``); a
# ``torch.Generator(...)`` instance passed as ``generator=`` is the
# sanctioned idiom, as ``default_rng`` is numpy's
_TORCH_GLOBAL_SEED = {"manual_seed", "seed"}
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli",
                   "multinomial", "normal", "rand_like", "randn_like",
                   "randint_like"}

# -- R203: float-key heuristics ---------------------------------------------
# a name "looks like a float" when it carries a unit/rate suffix used
# throughout this codebase for virtual-time quantities
_FLOAT_NAME = re.compile(
    r"(_ms|_s|_sec|_secs|_rate|_frac|_coef|_util|_score)$"
    r"|^(t|t_\w+|dt|now|deadline|latency|util|utilization|load|"
    r"attainment|score|cost|weight)$")
# a name that "looks like" the mandated integer tie-break sequence
_INTSEQ_NAME = re.compile(
    r"(seq|rid|idx|index|count|counter|tick|_id|id_)", re.IGNORECASE)


def _looks_float(node: ast.AST) -> bool:
    """Positive signal that an expression is a bare float key."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, float)
    if isinstance(node, ast.Name):
        return bool(_FLOAT_NAME.search(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_FLOAT_NAME.search(node.attr))
    if isinstance(node, ast.Subscript):        # e["t_ms"], row["latency_s"]
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return bool(_FLOAT_NAME.search(sl.value))
        return False
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Div):       # any ratio is a float
            return True
        return _looks_float(node.left) or _looks_float(node.right)
    if isinstance(node, ast.UnaryOp):
        return _looks_float(node.operand)
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        if name in ("float", "abs", "sum"):
            return True
        return bool(_FLOAT_NAME.search(name))
    return False


def _looks_intseq(node: ast.AST) -> bool:
    """Positive signal that an expression is the integer tie-break."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) \
            and not isinstance(node.value, bool)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in ("next", "len", "int",
                                                  "id"):
            return True
        if isinstance(fn, ast.Attribute) and fn.attr in ("index",):
            return True
        return False
    if isinstance(node, ast.Name):
        return bool(_INTSEQ_NAME.search(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_INTSEQ_NAME.search(node.attr))
    if isinstance(node, ast.UnaryOp):
        return _looks_intseq(node.operand)
    return False


def _is_set_expr(node: ast.AST) -> bool:
    """Syntactically a set/frozenset value (literal, constructor call,
    set comprehension, or an algebra of such)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class NondetVisitor(ast.NodeVisitor):
    """Single-pass visitor emitting R1xx / R2xx findings for one file."""

    def __init__(self, path: str, *, tiebreak_scope: bool = False,
                 allow_wallclock: bool = False):
        self.path = path
        # R203 only applies where the event-calendar contract does
        self.tiebreak_scope = tiebreak_scope
        # timing harnesses (perf_guard, run.py) legitimately read clocks
        self.allow_wallclock = allow_wallclock
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        self._aliases: Dict[str, str] = {}    # local name -> dotted origin

    # -- plumbing ----------------------------------------------------------

    def _qual(self) -> str:
        return ".".join(self._scope) if self._scope else "module"

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.path, line=getattr(node, "lineno", 0),
            scope=self._qual(), message=message))

    def _dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve a call target to a dotted name, through local import
        aliases (`from time import perf_counter` -> `time.perf_counter`)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self._aliases.get(node.id, node.id))
        else:
            return None
        return ".".join(reversed(parts))

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self._aliases[a.asname or a.name.split(".")[0]] = a.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for a in node.names:
                self._aliases[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
        self.generic_visit(node)

    def _visit_scoped(self, node, name: str) -> None:
        self._scope.append(name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_FunctionDef(self, node):
        self._visit_scoped(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._visit_scoped(node, node.name)

    def visit_ClassDef(self, node):
        self._visit_scoped(node, node.name)

    # -- R1: nondeterminism sources ----------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self._dotted(node.func)
        if dotted:
            self._check_r1(node, dotted)
            self._check_r2_calls(node, dotted)
        self.generic_visit(node)

    def _check_r1(self, node: ast.Call, dotted: str) -> None:
        parts = dotted.split(".")
        tail2 = ".".join(parts[-2:])
        if not self.allow_wallclock and (dotted in _WALLCLOCK
                                         or tail2 in _WALLCLOCK):
            self._emit("R101", node,
                       f"wall-clock read `{dotted}()`; virtual time must "
                       "come from the simulator clock")
            return
        root, leaf = parts[0], parts[-1]
        if root == "random" and len(parts) == 2 \
                and leaf not in _RANDOM_OK:
            self._emit("R102", node,
                       f"process-global RNG `{dotted}()`; use a seeded "
                       "`random.Random(seed)` instance")
        elif "random" in parts[:-1] and root in ("np", "numpy") \
                and leaf not in _NP_RANDOM_OK:
            self._emit("R102", node,
                       f"legacy global numpy RNG `{dotted}()`; use "
                       "`np.random.default_rng(seed)`")
        elif root == "torch" and parts[1:-1] in ([], ["random"]) \
                and leaf in _TORCH_GLOBAL_SEED:
            self._emit("R102", node,
                       f"seeds torch's process-global RNG `{dotted}()`; "
                       "use a seeded `torch.Generator` instance")
        elif root == "torch" and len(parts) == 2 \
                and leaf in _TORCH_SAMPLERS \
                and not any(kw.arg == "generator" for kw in node.keywords):
            self._emit("R102", node,
                       f"`{dotted}()` without `generator=` draws from "
                       "torch's process-global RNG; pass a seeded "
                       "`torch.Generator`")
        elif dotted in ("os.urandom", "uuid.uuid1", "uuid.uuid4") \
                or root == "secrets":
            self._emit("R102", node,
                       f"entropy source `{dotted}()` is unseedable")
        elif isinstance(node.func, ast.Name) \
                and self._aliases.get(node.func.id, "") == "" \
                and node.func.id == "hash":
            self._emit("R103", node,
                       "builtin `hash()` varies with PYTHONHASHSEED; "
                       "do not let it reach ordering or keys")

    # -- R2: ordering hazards ----------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self._emit("R201", node.iter,
                       "iteration over a set/frozenset is "
                       "PYTHONHASHSEED-ordered; sort it or use a "
                       "dict/list")
        self.generic_visit(node)

    def _check_comp(self, node) -> None:
        for gen in node.generators:
            if _is_set_expr(gen.iter):
                self._emit("R201", gen.iter,
                           "comprehension over a set/frozenset is "
                           "PYTHONHASHSEED-ordered; sort it or use a "
                           "dict/list")
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = \
        visit_GeneratorExp = _check_comp

    def _check_r2_calls(self, node: ast.Call, dotted: str) -> None:
        leaf = dotted.split(".")[-1]
        if leaf == "popitem" and "." in dotted:
            if not any(kw.arg == "last" for kw in node.keywords):
                self._emit("R202", node,
                           "`.popitem()` without `last=`; plain-dict "
                           "popitem order is insertion-history dependent"
                           " - pass `last=True/False` on an OrderedDict")
            return
        if not self.tiebreak_scope:
            return
        if leaf in ("sorted", "min", "max", "sort", "nsmallest",
                    "nlargest"):
            self._check_key_lambda(node, leaf)
        elif leaf in ("heappush", "heappushpop", "heapreplace"):
            self._check_heappush(node, leaf)

    def _check_key_lambda(self, node: ast.Call, leaf: str) -> None:
        key = next((kw.value for kw in node.keywords
                    if kw.arg == "key"), None)
        if not isinstance(key, ast.Lambda):
            return
        body = key.body
        if isinstance(body, ast.Tuple):
            return                         # has (at least the shape of) a
            #                                tie-break tuple; trust it
        if _looks_float(body):
            self._emit("R203", node,
                       f"`{leaf}(key=...)` on a bare float key "
                       f"`{ast.unparse(body)}`; ties are then broken by "
                       "input order - use the (float, int_seq) tuple "
                       "from DESIGN.md 3")

    def _check_heappush(self, node: ast.Call, leaf: str) -> None:
        if len(node.args) < 2:
            return
        item = node.args[1]
        if isinstance(item, ast.Tuple):
            elts = item.elts
            if elts and _looks_float(elts[0]) and (
                    len(elts) < 2 or not _looks_intseq(elts[1])):
                self._emit("R203", node,
                           f"`{leaf}` tuple leads with a float and lacks "
                           "an integer tie-break in slot 2; heap order "
                           "on ties is then arbitrary - use "
                           "(t, next(seq), ...) per DESIGN.md 3")
        elif _looks_float(item):
            self._emit("R203", node,
                       f"`{leaf}` of a bare float "
                       f"`{ast.unparse(item)}`; wrap it as "
                       "(t, next(seq), payload) per DESIGN.md 3")


def scan_source(source: str, path: str, *, tiebreak_scope: bool = False,
                allow_wallclock: bool = False) -> List[Finding]:
    """Run the R1/R2 visitor over one file's source."""
    tree = ast.parse(source, filename=path)
    v = NondetVisitor(path, tiebreak_scope=tiebreak_scope,
                      allow_wallclock=allow_wallclock)
    v.visit(tree)
    return v.findings

"""R3 (legacy-default contract) and R5 (``__slots__`` roster) checkers;
the port's copy of ``repro.lint.surface``, unchanged.

Both are *roster driven*: ``contract.CONTRACT`` and
``contract.SLOTS_REQUIRED`` name the surfaces, this module diffs the
live AST against them.  A roster entry with no matching code is itself
a finding (stale roster), so the table cannot silently rot.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .contract import CONTRACT, SLOTS_REQUIRED
from .findings import Finding

__all__ = ["check_contract", "check_slots"]

# (param name, default source or None, line)
_Param = Tuple[str, Optional[str], int]


def _params_of(node: ast.AST) -> List[_Param]:
    """Public parameters of a function, an ``__init__``, or a dataclass
    field block — with each default's source spelling."""
    if isinstance(node, ast.ClassDef):
        init = next((n for n in node.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is not None:
            return _params_of(init)[1:]      # drop self
        out: List[_Param] = []
        for st in node.body:                 # dataclass field block
            if isinstance(st, ast.AnnAssign) \
                    and isinstance(st.target, ast.Name) \
                    and not st.target.id.startswith("_"):
                default = ast.unparse(st.value) if st.value else None
                out.append((st.target.id, default, st.lineno))
        return out
    assert isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    a = node.args
    pos = list(a.posonlyargs) + list(a.args)
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = []
    for p, d in zip(pos, defaults):
        out.append((p.arg, ast.unparse(d) if d is not None else None,
                    p.lineno))
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        out.append((p.arg, ast.unparse(d) if d is not None else None,
                    p.lineno))
    return [(n, d, ln) for n, d, ln in out if not n.startswith("_")]


def _toplevel_defs(source: str, path: str) -> Dict[str, ast.AST]:
    tree = ast.parse(source, filename=path)
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))}


def check_contract(sources: Dict[str, str],
                   repo_root: Path) -> List[Finding]:
    """R301-R304 over every surface registered in ``CONTRACT``."""
    findings: List[Finding] = []
    for path, surfaces in CONTRACT.items():
        src = sources.get(path)
        defs = _toplevel_defs(src, path) if src is not None else {}
        for name, entry in surfaces.items():
            table: Dict[str, Optional[str]] = entry["params"]
            pinned_by: str = entry["pinned_by"]
            node = defs.get(name)
            if node is None:
                findings.append(Finding(
                    "R302", path, 1, name,
                    f"contract table registers `{name}` but it is not "
                    f"defined at top level in {path} - fix the table or "
                    "the code"))
                continue
            if not (repo_root / pinned_by).exists():
                findings.append(Finding(
                    "R304", path, node.lineno, name,
                    f"pinned_by test `{pinned_by}` does not exist; the "
                    "defaults of this surface are pinned by nothing"))
            actual = _params_of(node)
            seen = set()
            for pname, default, line in actual:
                seen.add(pname)
                if pname not in table:
                    if default is not None:
                        findings.append(Finding(
                            "R303", path, line, name,
                            f"knob `{pname}={default}` is not in the "
                            "contract table; register it in "
                            "lint/contract.py with the test that pins "
                            "it"))
                    else:
                        findings.append(Finding(
                            "R303", path, line, name,
                            f"parameter `{pname}` is not in the "
                            "contract table (not even as REQUIRED)"))
                    continue
                want = table[pname]
                if want is None:             # REQUIRED by design
                    if default is not None:
                        findings.append(Finding(
                            "R302", path, line, name,
                            f"`{pname}` is REQUIRED in the contract "
                            f"table but now defaults to `{default}`"))
                elif default is None:
                    findings.append(Finding(
                        "R301", path, line, name,
                        f"config knob `{pname}` lost its default "
                        f"(contract pins `{want}`); zero-arg "
                        "construction must stay legacy-bit-identical"))
                elif default != want:
                    findings.append(Finding(
                        "R302", path, line, name,
                        f"default drift: `{pname}={default}` but the "
                        f"contract table pins `{want}` (pinned by "
                        f"{pinned_by}) - change both, with a golden "
                        "regen or bit-identity argument"))
            for pname in table:
                if pname not in seen:
                    findings.append(Finding(
                        "R302", path, node.lineno, name,
                        f"contract table lists `{pname}` but "
                        f"`{name}` no longer has that parameter - "
                        "update the table"))
    return findings


def _declares_slots(node: ast.ClassDef) -> bool:
    for st in node.body:
        if isinstance(st, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__slots__"
                for t in st.targets):
            return True
        if isinstance(st, ast.AnnAssign) \
                and isinstance(st.target, ast.Name) \
                and st.target.id == "__slots__":
            return True
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call):
            fn = dec.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if name == "dataclass" and any(
                    kw.arg == "slots"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in dec.keywords):
                return True
    return False


def check_slots(sources: Dict[str, str]) -> List[Finding]:
    """R501 over every class in ``SLOTS_REQUIRED``."""
    findings: List[Finding] = []
    for path, cls in SLOTS_REQUIRED:
        src = sources.get(path)
        if src is None:
            findings.append(Finding(
                "R501", path, 1, cls,
                f"slots roster names {path} but it was not scanned"))
            continue
        node = _toplevel_defs(src, path).get(cls)
        if not isinstance(node, ast.ClassDef):
            findings.append(Finding(
                "R501", path, 1, cls,
                f"slots roster names `{cls}` but no such top-level "
                f"class in {path} - fix the roster"))
            continue
        if not _declares_slots(node):
            findings.append(Finding(
                "R501", path, node.lineno, cls,
                f"hot-path class `{cls}` has no `__slots__` (or "
                "`@dataclass(slots=True)`); per-instance dicts cost "
                "memory at fleet scale and admit silent attribute "
                "typos"))
    return findings

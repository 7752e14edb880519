"""R6: the golden-impact analyzer (``python -m repro_torch.lint
--impact``); the port's copy of ``repro.lint.impact``, over the port's
tree.

Classifies a diff as **trace-affecting** (the golden traces in
``tests/golden/`` could change, so the PR owes either a regen or a
bit-identity argument per DESIGN.md 3) or **trace-neutral** (it
provably cannot change a trace bit).

The map is module-level, matching how the repo is layered:

* the trace-producing call graph is ``src/repro_torch/cluster/`` +
  ``src/repro_torch/serving/`` + ``src/repro_torch/core/`` — every
  module the fleet loop executes between an arrival and a stamped
  Request;
* inside that graph, ``telemetry.py`` and ``invariants.py`` are
  *consumers*: they aggregate and assert over finished traces and are
  neutral by construction, and ``serving/calibrate.py`` times the card
  and is never executed by a trace;
* tests, benchmarks, examples (the repo's and the port's), docs, CI,
  packaging, and the lint package itself never execute during a trace;
* the model/kernel side of the port (models, kernels, optim, ...) is
  outside the graph — its numerics are pinned by its own test tiers;
* the reference package ``src/repro/`` never runs in the port's traces.

For an affecting ``.py`` file where both sides of the diff are
available, the verdict is refined by comparing the two ASTs with
docstrings stripped: an identical dump means the edit was
comments/formatting/docstrings only, which is downgraded to neutral.
That is the precise reason R6 lives in the *linter*: it can prove a
diff harmless in exactly the cases a path-prefix map cannot.
"""

from __future__ import annotations

import ast
import json
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

__all__ = ["FileImpact", "ImpactReport", "classify_path",
           "classify_change", "classify_diff", "git_changes",
           "impact_from_git"]

AFFECTING = "trace-affecting"
NEUTRAL = "trace-neutral"

# consumers of finished traces inside the otherwise-affecting graph
_NEUTRAL_FILES = {
    "src/repro_torch/cluster/telemetry.py",
    "src/repro_torch/cluster/invariants.py",
    "src/repro_torch/serving/calibrate.py",
}
_NEUTRAL_PREFIXES = (
    "tests/", "benchmarks/", "examples/", "docs/", ".github/",
    "src/repro_torch/lint/", "src/repro_torch/examples/",
)
# the trace-producing call graph
_AFFECTING_PREFIXES = (
    "src/repro_torch/cluster/", "src/repro_torch/serving/",
    "src/repro_torch/core/",
)


@dataclass
class FileImpact:
    path: str
    verdict: str          # AFFECTING | NEUTRAL
    reason: str

    def as_dict(self):
        return {"path": self.path, "verdict": self.verdict,
                "reason": self.reason}


@dataclass
class ImpactReport:
    files: List[FileImpact]

    @property
    def verdict(self) -> str:
        return AFFECTING if any(f.verdict == AFFECTING
                                for f in self.files) else NEUTRAL

    def render_text(self) -> str:
        lines = [f"{f.path}: {f.verdict} - {f.reason}"
                 for f in self.files]
        n_aff = sum(1 for f in self.files if f.verdict == AFFECTING)
        lines.append(f"== impact: {self.verdict} "
                     f"({n_aff}/{len(self.files)} file(s) affecting)")
        if self.verdict == AFFECTING:
            lines.append("   this diff can change tests/golden/ - it "
                         "owes a golden regen or a bit-identity "
                         "argument (DESIGN.md 3)")
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "verdict": self.verdict,
            "files": [f.as_dict() for f in self.files],
        }, indent=1, sort_keys=True)


def classify_path(path: str) -> FileImpact:
    """Path-prefix verdict, before any AST refinement."""
    p = path.replace("\\", "/")
    if p in _NEUTRAL_FILES:
        return FileImpact(p, NEUTRAL,
                          "trace consumer (aggregates/asserts over "
                          "finished traces) or the card's timing harness")
    if p.startswith(_NEUTRAL_PREFIXES):
        return FileImpact(p, NEUTRAL, "never executes during a trace")
    if p.endswith((".md", ".rst", ".txt", ".toml", ".cfg", ".ini",
                   ".yml", ".yaml", ".json")):
        return FileImpact(p, NEUTRAL, "docs/config/packaging")
    if p.startswith(_AFFECTING_PREFIXES):
        return FileImpact(p, AFFECTING,
                          "inside the trace-producing call graph")
    if p.startswith("src/repro_torch/"):
        return FileImpact(p, NEUTRAL,
                          "outside the trace call graph (model/kernel "
                          "side; pinned by its own test tiers)")
    if p.startswith("src/repro/"):
        return FileImpact(p, NEUTRAL,
                          "the reference package; the port's traces "
                          "never run it")
    return FileImpact(p, NEUTRAL, "outside src/repro_torch/")


def _stripped_dump(source: str) -> Optional[str]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                body.pop(0)
            if not body:
                body.append(ast.Pass())
    return ast.dump(tree, include_attributes=False)


def classify_change(path: str, old_source: Optional[str],
                    new_source: Optional[str]) -> FileImpact:
    """Per-file verdict, refined by docstring-stripped AST equality
    when both sides of an affecting .py diff are available."""
    base = classify_path(path)
    if base.verdict != AFFECTING or not path.endswith(".py"):
        return base
    if old_source is None or new_source is None:
        base.reason += " (added/deleted file)"
        return base
    old_dump, new_dump = _stripped_dump(old_source), \
        _stripped_dump(new_source)
    if old_dump is not None and old_dump == new_dump:
        return FileImpact(path, NEUTRAL,
                          "in the trace call graph, but the "
                          "docstring-stripped AST is unchanged "
                          "(comments/formatting only)")
    return base


def classify_diff(changes: List[Tuple[str, Optional[str],
                                      Optional[str]]]) -> ImpactReport:
    return ImpactReport([classify_change(p, old, new)
                         for p, old, new in changes])


# -- git plumbing -----------------------------------------------------------

def _git(repo_root: Path, *argv: str) -> str:
    return subprocess.run(
        ["git", "-C", str(repo_root), *argv],
        check=True, capture_output=True, text=True).stdout


def _show(repo_root: Path, rev: str, path: str) -> Optional[str]:
    try:
        return _git(repo_root, "show", f"{rev}:{path}")
    except subprocess.CalledProcessError:
        return None                          # absent at that rev


def git_changes(repo_root: Path, range_spec: str
                ) -> List[Tuple[str, Optional[str], Optional[str]]]:
    """(path, old_source, new_source) for every file in BASE..HEAD.

    ``range_spec`` is anything `git diff` accepts (`BASE..HEAD`,
    `BASE...HEAD`, a single rev meaning rev-vs-worktree).
    """
    if "..." in range_spec:
        base, head = range_spec.split("...", 1)
        base = _git(repo_root, "merge-base", base or "HEAD",
                    head or "HEAD").strip()
    elif ".." in range_spec:
        base, head = range_spec.split("..", 1)
    else:
        base, head = range_spec, ""          # rev vs worktree
    names = _git(repo_root, "diff", "--name-only", range_spec)
    out: List[Tuple[str, Optional[str], Optional[str]]] = []
    for path in sorted(filter(None, names.splitlines())):
        old = _show(repo_root, base, path)
        if head:
            new = _show(repo_root, head or "HEAD", path)
        else:
            f = repo_root / path
            new = f.read_text() if f.exists() else None
        out.append((path, old, new))
    return out


def impact_from_git(repo_root: Path, range_spec: str) -> ImpactReport:
    return classify_diff(git_changes(repo_root, range_spec))

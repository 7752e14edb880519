"""Orchestration: collect sources, run every rule family, apply
suppressions, diff against the committed baseline; the port's copy of
``repro.lint.runner``, over the port's tree.

Split from the CLI so tests can lint an in-memory source map (fixture
snippets) without touching the filesystem or git.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import pickle_lint, rules, surface
from .contract import (BASELINE_PATH, SCAN_ROOTS, TIEBREAK_PREFIXES,
                       WALLCLOCK_ALLOWLIST)
from .findings import (Finding, apply_suppressions, assign_indices,
                       diff_baseline, load_baseline, render_json,
                       render_text, save_baseline)

__all__ = ["LintResult", "collect_sources", "lint_sources", "run_lint",
           "lint_snippet"]


@dataclass
class LintResult:
    findings: List[Finding]
    new: List[Finding]
    stale_baseline: List[str]
    baseline: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale_baseline

    def render_text(self) -> str:
        return render_text(self.findings, self.new, self.stale_baseline)

    def render_json(self) -> str:
        return render_json(self.findings, self.new, self.stale_baseline)


def collect_sources(repo_root: Path,
                    roots: Sequence[str] = SCAN_ROOTS
                    ) -> Dict[str, str]:
    """repo-relative posix path -> source, for every scanned .py file."""
    out: Dict[str, str] = {}
    for root in roots:
        base = repo_root / root
        if not base.exists():
            continue
        for f in sorted(base.rglob("*.py")):
            rel = f.relative_to(repo_root).as_posix()
            if rel.startswith("src/repro_torch/lint/"):
                continue                     # the linter lints the
                #                              simulator, not itself
            out[rel] = f.read_text()
    return out


def lint_sources(sources: Dict[str, str], repo_root: Path,
                 *, structural: bool = True) -> List[Finding]:
    """All rule families over a source map.  ``structural=False`` skips
    the roster-driven R3/R5 checks (used for fixture snippets, whose
    paths are not real contract surfaces)."""
    findings: List[Finding] = []
    for path, src in sources.items():
        findings.extend(rules.scan_source(
            src, path,
            tiebreak_scope=path.startswith(TIEBREAK_PREFIXES),
            allow_wallclock=path in WALLCLOCK_ALLOWLIST))
        findings.extend(pickle_lint.check_pickle(src, path))
    if structural:
        findings.extend(surface.check_contract(sources, repo_root))
        findings.extend(surface.check_slots(sources))
    apply_suppressions(findings, sources)
    return assign_indices(findings)


def run_lint(repo_root: Path, *,
             baseline_path: Optional[Path] = None,
             write_baseline: bool = False) -> LintResult:
    """The full gate: scan the tree, diff against the baseline."""
    bpath = baseline_path or (repo_root / BASELINE_PATH)
    sources = collect_sources(repo_root)
    findings = lint_sources(sources, repo_root)
    if write_baseline:
        save_baseline(bpath, findings)
    baseline = load_baseline(bpath)
    new, stale = diff_baseline(findings, baseline)
    return LintResult(findings, new, stale, baseline)


def lint_snippet(source: str,
                 path: str = "src/repro_torch/cluster/snippet.py"
                 ) -> List[Finding]:
    """Lint one in-memory snippet (fixture-test helper).  The default
    path puts the snippet inside the tie-break scope; pass a path
    outside ``cluster/``/``serving/`` to test scope gating."""
    return lint_sources({path: source}, Path("."), structural=False)

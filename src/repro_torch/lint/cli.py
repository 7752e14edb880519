"""``python -m repro_torch.lint`` — the determinism-contract gate over
the port's virtual-time layers.

Exit codes: 0 clean (no new findings, no stale baseline), 1 gate
failure, 2 usage error.  Deliberately importable without torch, jax or
numpy:
lint-only environments (CI's lint job, pre-commit) run this on a bare
interpreter.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

from .contract import EXPLAIN, explain
from .impact import impact_from_git
from .runner import run_lint

__all__ = ["main"]


def _find_repo_root(start: Path) -> Path:
    for cand in (start, *start.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="determinism-contract linter (DESIGN.md 10): "
                    "machine-checks the bit-identity guarantees of "
                    "the port's virtual-time simulators")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="override the baseline file path")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather the current findings and exit 0")
    ap.add_argument("--impact", metavar="BASE..HEAD", default=None,
                    help="classify a git diff as trace-affecting vs "
                    "trace-neutral instead of linting")
    ap.add_argument("--explain", metavar="RULE", default=None,
                    help="print a rule's rationale and the DESIGN.md "
                    "section it enforces")
    args = ap.parse_args(argv)

    if args.explain is not None:
        text = explain(args.explain)
        if text is None:
            print(f"unknown rule `{args.explain}`; known: "
                  + ", ".join(sorted(EXPLAIN)), file=sys.stderr)
            return 2
        print(text)
        return 0

    root = (args.root or _find_repo_root(Path.cwd())).resolve()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"not a repro_torch repo root: {root}", file=sys.stderr)
        return 2

    if args.impact is not None:
        try:
            report = impact_from_git(root, args.impact)
        except Exception as e:  # bad range, not a git repo, ...
            print(f"--impact failed: {e}", file=sys.stderr)
            return 2
        print(report.render_json() if args.json
              else report.render_text())
        return 0

    result = run_lint(root, baseline_path=args.baseline,
                      write_baseline=args.write_baseline)
    print(result.render_json() if args.json else result.render_text())
    return 0 if result.ok else 1


if __name__ == "__main__":                   # pragma: no cover
    sys.exit(main())

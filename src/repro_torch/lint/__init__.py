"""repro_torch.lint: the determinism-contract linter (DESIGN.md 10) over
the port's virtual-time layers, ``src/repro_torch/{cluster,serving,core}``.

The port's own copy of ``repro.lint``, which scans only ``src/repro/``.
Its rules are the reference's; its paths, contract table and allowlists
are the port's (``contract.py``), and R102 also flags torch's
process-global RNG.

An AST-based static-analysis pass that machine-checks the bit-identity
guarantees of DESIGN.md 3 — no wall clocks, seeded RNG only,
``(float, int_seq)`` tie-breaks, legacy-bit-identical knob defaults,
picklable sweep units, ``__slots__`` on hot-path classes — plus the
``--impact`` analyzer that tells a PR whether it owes a golden regen.

Stdlib-only by design: importable (and runnable, as
``python -m repro_torch.lint``) on an interpreter with no torch, jax or
numpy, so lint-only CI environments stay cheap.
"""

from .findings import Finding
from .impact import (classify_change, classify_diff, classify_path,
                     impact_from_git, ImpactReport)
from .runner import (collect_sources, lint_snippet, lint_sources,
                     LintResult, run_lint)

__all__ = ["Finding", "LintResult", "ImpactReport", "run_lint",
           "lint_sources", "lint_snippet", "collect_sources",
           "classify_path", "classify_change", "classify_diff",
           "impact_from_git"]

"""Finding model, in-line suppressions, and the committed baseline
(DESIGN.md 10); the port's copy of ``repro.lint.findings``.

A ``Finding`` is one violation of the determinism contract at one source
location.  Its identity (``key``) is deliberately **line-number free** -
``RULE:path:scope#occurrence`` - so a committed baseline survives
unrelated edits above a grandfathered site; only adding/removing a
violation inside the same scope shifts keys.

Suppressions are per-line: ``# lint: disable=R203(reason)`` on the
statement's first physical line silences exactly that rule there.  The
reason is not optional in spirit - the text output prints it, review
reads it - but the parser tolerates a bare rule id so a suppression
can never be syntactically "wrong enough" to be ignored.

The baseline file (``lint/baseline.json``) holds grandfathered finding
keys.  The gate is zero-*new*-violations: a finding whose key is in the
baseline passes, a baseline key with no matching finding is **stale**
and also fails (the debt was paid; the ledger must say so).  Regenerate
with ``python -m repro_torch.lint --write-baseline``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Finding", "assign_indices", "suppressions_for",
           "apply_suppressions", "load_baseline", "save_baseline",
           "diff_baseline", "render_text", "render_json"]

# `# lint: disable=R101, R203(reason text)` - comma-separated rule tokens,
# each optionally carrying a parenthesized reason
_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=(.+)$")
_TOKEN_RE = re.compile(r"\s*([A-Za-z][A-Za-z0-9_]*)\s*(?:\(([^)]*)\))?")


@dataclass
class Finding:
    """One determinism-contract violation at one source location."""

    rule: str                  # stable rule id, e.g. "R203"
    path: str                  # repo-relative posix path
    line: int                  # 1-based line of the offending node
    scope: str                 # dotted qualname ("module" at top level)
    message: str
    index: int = 0             # occurrence counter within (rule, path, scope)
    suppressed: Optional[str] = None   # suppression reason when silenced

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.scope}#{self.index}"

    def render(self) -> str:
        tail = f"  [suppressed: {self.suppressed}]" if self.suppressed \
            else ""
        return (f"{self.path}:{self.line}: {self.rule} ({self.scope}) "
                f"{self.message}{tail}")

    def as_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "scope": self.scope, "message": self.message,
                "key": self.key, "suppressed": self.suppressed}


def assign_indices(findings: Sequence[Finding]) -> List[Finding]:
    """Stamp each finding's occurrence index within its (rule, path,
    scope) bucket, in source order, so keys are stable and unique."""
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    seen: Dict[Tuple[str, str, str], int] = {}
    for f in ordered:
        bucket = (f.rule, f.path, f.scope)
        f.index = seen.get(bucket, 0)
        seen[bucket] = f.index + 1
    return ordered


def suppressions_for(source: str) -> Dict[int, Dict[str, str]]:
    """line (1-based) -> {rule_id: reason} parsed from disable comments."""
    out: Dict[int, Dict[str, str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        rules: Dict[str, str] = {}
        for tok in m.group(1).split(","):
            tm = _TOKEN_RE.match(tok)
            if tm:
                rules[tm.group(1)] = (tm.group(2) or "").strip() \
                    or "no reason given"
        if rules:
            out[i] = rules
    return out


def apply_suppressions(findings: Iterable[Finding],
                       sources: Dict[str, str]) -> None:
    """Mark findings silenced by a same-line disable comment.  ``all``
    as the rule id silences every rule on that line."""
    cache: Dict[str, Dict[int, Dict[str, str]]] = {}
    for f in findings:
        src = sources.get(f.path)
        if src is None:
            continue
        sup = cache.setdefault(f.path, suppressions_for(src))
        rules = sup.get(f.line, {})
        if f.rule in rules:
            f.suppressed = rules[f.rule]
        elif "all" in rules:
            f.suppressed = rules["all"]


# -- baseline ---------------------------------------------------------------

def load_baseline(path: Path) -> List[str]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    keys = data.get("findings", []) if isinstance(data, dict) else data
    if not isinstance(keys, list) \
            or not all(isinstance(k, str) for k in keys):
        raise ValueError(f"malformed baseline {path}: want a JSON list "
                         "of finding keys under 'findings'")
    return keys


def save_baseline(path: Path, findings: Sequence[Finding]) -> None:
    keys = sorted(f.key for f in findings if not f.suppressed)
    path.write_text(json.dumps(
        {"comment": "grandfathered determinism-lint findings; the gate "
                    "fails on NEW findings or on stale entries here - "
                    "regen: python -m repro_torch.lint --write-baseline",
         "findings": keys}, indent=1) + "\n")


def diff_baseline(findings: Sequence[Finding], baseline: Sequence[str]
                  ) -> Tuple[List[Finding], List[str]]:
    """(new findings not grandfathered, stale baseline keys)."""
    active = {f.key: f for f in findings if not f.suppressed}
    base = set(baseline)
    new = [f for k, f in sorted(active.items()) if k not in base]
    stale = sorted(base - set(active))
    return new, stale


# -- rendering --------------------------------------------------------------

def render_text(findings: Sequence[Finding], new: Sequence[Finding],
                stale: Sequence[str]) -> str:
    lines: List[str] = []
    suppressed = [f for f in findings if f.suppressed]
    for f in findings:
        lines.append(f.render())
    lines.append(f"-- {len(findings)} finding(s): "
                 f"{len(new)} new, "
                 f"{len(findings) - len(new) - len(suppressed)} "
                 f"grandfathered, {len(suppressed)} suppressed")
    if stale:
        lines.append(f"-- {len(stale)} STALE baseline entr"
                     f"{'y' if len(stale) == 1 else 'ies'} "
                     "(fixed findings still in lint/baseline.json; "
                     "run --write-baseline):")
        lines.extend(f"   {k}" for k in stale)
    if new:
        lines.append(f"-- {len(new)} NEW finding(s) "
                     "(fix, suppress with a reason, or --write-baseline):")
        lines.extend(f"   {f.key}" for f in new)
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], new: Sequence[Finding],
                stale: Sequence[str]) -> str:
    return json.dumps({
        "findings": [f.as_dict() for f in findings],
        "new": [f.key for f in new],
        "stale_baseline": list(stale),
        "counts": {
            "total": len(findings),
            "new": len(new),
            "suppressed": sum(1 for f in findings if f.suppressed),
            "stale_baseline": len(stale),
        },
        "ok": not new and not stale,
    }, indent=1, sort_keys=True)

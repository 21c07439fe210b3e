"""The port's reprolint engine: findings, pragmas, baselines, tiers.

The JAX package's engine (``repro.analysis.engine``) over the port's
rules.  A :class:`Finding` is one structural hazard at ``path:line`` with
a rule id (RETRACE / COLLECTIVE / DTYPE / PRNG / PURITY / BENCH, the
same six) and a fix hint.  Three suppression mechanisms, in order:

1. **pragmas** — ``# reprolint: disable=RULE[,RULE2|all]`` on the finding
   line silences it there; ``# reprolint: disable-file=RULE`` anywhere in
   the file silences the rule file-wide.  The syntax is the JAX
   package's, so one pragma means the same to both linters;
2. **baseline** — a committed JSON file of fingerprinted pre-existing
   findings (:func:`fingerprint`: rule + relative path + enclosing
   function + normalized source line, so plain line drift does not
   invalidate it).  Baselined findings are reported but never gate.  The
   port's (``analysis/baseline.json``) is empty;
3. **tier** — every scanned root carries a severity tier; ``error``-tier
   findings gate (exit 1 of ``python -m repro_torch.analysis``),
   ``report``-tier findings (``chip_*.py``, ``tests/test_torch_*.py``)
   are informational only.

The rules live in :mod:`repro_torch.analysis.rules_trace`,
:mod:`~repro_torch.analysis.rules_collective`,
:mod:`~repro_torch.analysis.rules_numeric` and
:mod:`~repro_torch.analysis.rules_bench`; each exports ``check(tree, src,
path) -> list[Finding]`` functions listed by :func:`all_rules`.
"""
from __future__ import annotations

import dataclasses
import json
import re
from collections import Counter
from pathlib import Path

from repro_torch.analysis import astlib

RULE_IDS = ("RETRACE", "COLLECTIVE", "DTYPE", "PRNG", "PURITY", "BENCH")

TIER_ERROR = "error"
TIER_REPORT = "report"

_PRAGMA = re.compile(r"#\s*reprolint:\s*(disable(?:-file)?)\s*=\s*"
                     r"([A-Za-z_,\s]+|all)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    ``context`` is the enclosing function name (or ``<module>``) and
    ``code`` the stripped source line — together with ``rule`` and
    ``path`` they form the line-drift-stable baseline fingerprint."""
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    context: str = "<module>"
    code: str = ""
    tier: str = TIER_ERROR
    baselined: bool = False

    def render(self) -> str:
        tag = " [baseline]" if self.baselined else ""
        tail = f"  hint: {self.hint}" if self.hint else ""
        return (f"{self.path}:{self.line}: {self.rule}{tag}: "
                f"{self.message}{tail}")


def fingerprint(f: Finding) -> tuple[str, str, str, str]:
    return (f.rule, f.path, f.context, " ".join(f.code.split()))


# --- pragma handling -------------------------------------------------------


def parse_pragmas(source: str):
    """Returns ``(line -> set(rules), file-wide set(rules))``; the token
    ``all`` expands to every rule id."""
    per_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(text)
        if not m:
            continue
        kind, raw = m.group(1), m.group(2)
        rules = set(RULE_IDS) if raw.strip() == "all" else {
            tok.strip().upper() for tok in raw.split(",") if tok.strip()}
        if kind == "disable-file":
            file_wide |= rules
        else:
            per_line.setdefault(i, set()).update(rules)
    return per_line, file_wide


def apply_pragmas(findings: list[Finding], source: str) -> list[Finding]:
    per_line, file_wide = parse_pragmas(source)
    out = []
    for f in findings:
        if f.rule in file_wide or f.rule in per_line.get(f.line, ()):
            continue
        out.append(f)
    return out


# --- baseline --------------------------------------------------------------


def load_baseline(path: str | Path) -> Counter:
    """Committed baseline -> multiset of fingerprints.  A missing file is
    an empty baseline (everything gates)."""
    p = Path(path)
    if not p.exists():
        return Counter()
    data = json.loads(p.read_text())
    return Counter(tuple(entry) for entry in data.get("findings", []))


def save_baseline(findings: list[Finding], path: str | Path) -> None:
    """Persist current gating findings as the new baseline.  Entries are
    sorted so regeneration is deterministic and diffs reviewable."""
    entries = sorted(fingerprint(f) for f in findings
                     if f.tier == TIER_ERROR)
    payload = {"comment": "reprolint baseline — pre-existing findings "
                          "suppressed from gating; regenerate with "
                          "python -m repro_torch.analysis --update-baseline",
               "findings": [list(e) for e in entries]}
    Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True)
                          + "\n")


def apply_baseline(findings: list[Finding],
                   baseline: Counter) -> list[Finding]:
    """Mark findings present in the baseline multiset as ``baselined``
    (reported, non-gating).  Each baseline entry absorbs one finding."""
    budget = Counter(baseline)
    out = []
    for f in findings:
        fp = fingerprint(f)
        if budget[fp] > 0:
            budget[fp] -= 1
            f = dataclasses.replace(f, baselined=True)
        out.append(f)
    return out


# --- running rules ---------------------------------------------------------


def all_rules():
    """Rule checkers, imported lazily so ``repro_torch.analysis`` stays
    importable without pulling every rule module up front."""
    from repro_torch.analysis import (rules_bench, rules_collective,
                                rules_numeric, rules_trace)
    return (rules_trace.check_retrace, rules_trace.check_purity,
            rules_collective.check_collective,
            rules_numeric.check_dtype, rules_numeric.check_prng,
            rules_bench.check_bench)


def lint_source(source: str, path: str = "<string>", *,
                tier: str = TIER_ERROR,
                rules=None) -> list[Finding]:
    """Lint one source string.  Findings come back pragma-filtered and
    sorted by line.

    >>> fs = lint_source('''
    ... import torch
    ... def f(step):
    ...     for i in range(3):
    ...         g = CapturedStep(step)
    ... ''')
    >>> [(f.rule, f.line) for f in fs]
    [('RETRACE', 5)]
    """
    tree = astlib.parse_module(source, path)
    src_lines = source.splitlines()
    findings: list[Finding] = []
    for rule in (rules or all_rules()):
        for f in rule(tree, source, path):
            code = (src_lines[f.line - 1].strip()
                    if 0 < f.line <= len(src_lines) else "")
            findings.append(dataclasses.replace(f, code=code, tier=tier))
    findings = apply_pragmas(findings, source)
    return sorted(findings, key=lambda f: (f.line, f.rule))


def lint_file(path: str | Path, *, root: str | Path | None = None,
              tier: str = TIER_ERROR) -> list[Finding]:
    p = Path(path)
    rel = str(p.relative_to(root)) if root else str(p)
    try:
        source = p.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("PURITY", rel, 0, f"unreadable file: {e}",
                        tier=tier)]
    try:
        findings = lint_source(source, rel, tier=tier)
    except SyntaxError as e:
        return [Finding("PURITY", rel, e.lineno or 0,
                        f"syntax error: {e.msg}", tier=tier)]
    return findings


def lint_paths(paths, *, root: str | Path | None = None,
               tier: str = TIER_ERROR,
               baseline: Counter | None = None) -> list[Finding]:
    """Lint ``.py`` files under each path (file or directory), apply the
    baseline, and return all findings sorted by (path, line)."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    findings: list[Finding] = []
    for f in files:
        findings.extend(lint_file(f, root=root, tier=tier))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if baseline:
        findings = apply_baseline(findings, baseline)
    return findings


def gating(findings: list[Finding]) -> list[Finding]:
    """The subset that should fail a check run: error-tier, unbaselined."""
    return [f for f in findings
            if f.tier == TIER_ERROR and not f.baselined]


def summarize(findings: list[Finding]) -> str:
    by_rule = Counter(f.rule for f in findings)
    total = sum(by_rule.values())
    parts = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    return f"{total} finding(s)" + (f" ({parts})" if parts else "")

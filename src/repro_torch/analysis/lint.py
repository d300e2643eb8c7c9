"""Repo-discipline linter: engine, suppressions, ratchet (DESIGN.md §12).

Rules live in :mod:`repro_torch.analysis.rules`; this module walks files,
applies rules by module path, honors suppression comments, and compares
unsuppressed findings against a committed ratchet baseline so CI fails
on *new* violations only.

Suppression syntax (same line or the line immediately above)::

    x = torch.cumsum(want, 0) - want  # lint: allow[RPR103] integer counts; DESIGN §9 ...

The justification text after the rule list is mandatory — a bare
``allow`` keeps the original finding and adds an ``RPR000`` finding.

Ratchet: ``.lint-ratchet-torch.json`` maps ``"RULE:path" -> count``.  A
run regresses when any (rule, path) bucket exceeds its baseline count.
The committed baseline is empty — every finding in the port was either
fixed or suppressed with a justification.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re

from .rules import Finding, Rule, all_rules

__all__ = [
    "LintReport",
    "Suppressed",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "ratchet_regressions",
    "repo_root",
    "write_baseline",
]

_ALLOW = re.compile(r"#\s*lint:\s*allow\[([A-Z0-9_,\s]+)\]\s*(.*)$")
DEFAULT_BASELINE = ".lint-ratchet-torch.json"


@dataclasses.dataclass(frozen=True)
class Suppressed:
    finding: Finding
    justification: str


@dataclasses.dataclass
class LintReport:
    findings: "list[Finding]"
    suppressed: "list[Suppressed]"
    n_files: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> "dict[str, int]":
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.key()] = out.get(f.key(), 0) + 1
        return out

    def as_json(self) -> dict:
        return {
            "ok": self.ok,
            "n_files": self.n_files,
            "findings": [f.as_json() for f in self.findings],
            "suppressed": [
                {**s.finding.as_json(), "justification": s.justification}
                for s in self.suppressed
            ],
        }


def repo_root() -> pathlib.Path:
    """src/repro_torch/analysis/lint.py -> the repository root."""
    return pathlib.Path(__file__).resolve().parents[3]


def module_path(path: "pathlib.Path") -> str:
    """Path of ``path`` relative to the ``repro_torch`` package (rule
    scoping); files outside the package fall back to their basename."""
    parts = list(path.resolve().parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "repro_torch":
            return "/".join(parts[i + 1 :])
    return path.name


def _suppressions(lines: "list[str]") -> "dict[int, tuple[set[str], str, int]]":
    """line -> (rule ids allowed, justification, comment line).  A trailing
    allow comment covers its own line; a comment-only allow covers the
    first code line below it (continuation comment lines are skipped)."""
    out: dict[int, tuple[set[str], str, int]] = {}
    for i, text in enumerate(lines, start=1):
        m = _ALLOW.search(text)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        just = m.group(2).strip()
        out[i] = (ids, just, i)
        if text.strip().startswith("#"):
            j = i + 1
            while j <= len(lines) and lines[j - 1].strip().startswith("#"):
                j += 1
            out[j] = (ids, just, i)
    return out


def lint_source(
    source: str,
    modpath: str,
    rules: "list[Rule] | None" = None,
) -> "tuple[list[Finding], list[Suppressed]]":
    """Lint one module's source; ``modpath`` scopes the rules (e.g.
    ``core/tabu.py``).  Returns (unsuppressed findings, suppressions)."""
    rules = all_rules() if rules is None else rules
    tree = ast.parse(source)
    lines = source.splitlines()
    allow = _suppressions(lines)
    findings: list[Finding] = []
    suppressed: list[Suppressed] = []
    bare_reported: set[int] = set()
    for rule in rules:
        if not rule.applies(modpath):
            continue
        for f in sorted(rule.check(tree, modpath), key=lambda f: (f.line, f.col)):
            entry = allow.get(f.line)
            if entry is not None and f.rule in entry[0]:
                ids, just, cline = entry
                if just:
                    suppressed.append(Suppressed(f, just))
                    continue
                if cline not in bare_reported:
                    bare_reported.add(cline)
                    findings.append(
                        Finding(
                            "RPR000",
                            modpath,
                            cline,
                            0,
                            "suppression without justification — cite the "
                            "DESIGN.md section that permits the exception",
                        )
                    )
                findings.append(f)
                continue
            findings.append(f)
    return findings, suppressed


def lint_paths(
    paths: "list[pathlib.Path | str] | None" = None,
    rules: "list[Rule] | None" = None,
) -> LintReport:
    """Lint every ``.py`` file under the given paths (default:
    ``src/repro_torch`` of this checkout)."""
    if not paths:
        paths = [repo_root() / "src" / "repro_torch"]
    files: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files += sorted(p.rglob("*.py"))
        else:
            files.append(p)
    findings: list[Finding] = []
    suppressed: list[Suppressed] = []
    for f in files:
        fs, ss = lint_source(f.read_text(), module_path(f), rules)
        findings += fs
        suppressed += ss
    return LintReport(findings=findings, suppressed=suppressed, n_files=len(files))


# ------------------------------------------------------------------ #
# Ratchet                                                            #
# ------------------------------------------------------------------ #
def load_baseline(path: "pathlib.Path | str | None" = None) -> "dict[str, int]":
    path = pathlib.Path(path) if path else repo_root() / DEFAULT_BASELINE
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("counts", {}).items()}


def ratchet_regressions(
    report: LintReport, baseline: "dict[str, int]"
) -> "list[str]":
    """(rule, path) buckets whose unsuppressed count exceeds the baseline."""
    out = []
    for key, n in sorted(report.counts().items()):
        allowed = baseline.get(key, 0)
        if n > allowed:
            out.append(f"{key}: {n} finding(s), baseline allows {allowed}")
    return out


def write_baseline(
    report: LintReport, path: "pathlib.Path | str | None" = None
) -> pathlib.Path:
    path = pathlib.Path(path) if path else repo_root() / DEFAULT_BASELINE
    payload = {
        "comment": "lint ratchet baseline: allowed unsuppressed findings per "
        "RULE:path bucket; CI fails only on counts above these "
        "(see DESIGN.md §12)",
        "counts": report.counts(),
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path

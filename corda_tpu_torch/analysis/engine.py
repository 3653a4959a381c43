"""Rule engine for the invariant analyzer.

One parse per file: the engine reads each ``*.py`` under the scanned paths,
builds the AST and the source-line table once, and hands a ``FileContext``
to every rule whose scope matches the file. Rules return ``Finding``s; the
engine then applies the two escape hatches:

  * inline suppression — ``# lint: allow(<rule>) <reason>`` on the finding's
    anchor line or the line directly above it. A reason is MANDATORY: an
    allow() with no reason (or naming an unknown rule) is itself reported
    under the ``bad-suppression`` rule, so the tree can never accumulate
    unexplained exemptions.
  * baseline — a checked-in JSON file enumerating accepted pre-existing
    sites as (rule, path, code, reason) entries, matched by the stripped
    source text of the finding's anchor line (robust to line drift). Each
    entry absorbs up to ``count`` findings (default 1); excess findings
    surface normally. Entries whose file no longer exists, whose reason is
    empty, or which matched nothing this run are reported under the
    ``stale-baseline`` rule — the baseline shrinks monotonically or fails
    tier-1.

Exit contract (used by ``__main__`` and tests/test_torch_analysis.py):
zero live findings == the tree upholds every machine-checked invariant.

The port's own copy of ``corda_tpu/analysis/engine.py``: paths rebase on
the ``corda_tpu_torch`` package directory, and ``DEFAULT_BASELINE`` is the
port's own file.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "Finding",
    "FileContext",
    "Rule",
    "Report",
    "analyze_paths",
    "analyze_source",
    "load_baseline",
    "baseline_entries_from_findings",
    "DEFAULT_BASELINE",
]

# Checked-in baseline lives next to the engine so `python -m
# corda_tpu_torch.analysis` finds it without flags from any cwd.
DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([A-Za-z0-9_-]+)\)\s*(.*)")

# Engine-level pseudo-rules (never suppressible themselves).
BAD_SUPPRESSION = "bad-suppression"
STALE_BASELINE = "stale-baseline"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix path as scanned (package-relative for scoping)
    line: int
    message: str
    hint: str = ""
    code: str = ""     # stripped source text of the anchor line

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "code": self.code}


class FileContext:
    """Everything a rule needs about one file, parsed once."""

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # Parent links let rules walk outward (enclosing function stack).
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def enclosing_functions(self, node: ast.AST) -> list[ast.AST]:
        """Innermost-first stack of FunctionDef/AsyncFunctionDef containing
        ``node`` (lambdas excluded — they can't carry the constructs the
        rules scope by)."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule.name, self.path, line, message,
                       hint=rule.hint, code=self.line_text(line))


class Rule:
    """Base rule: subclasses set ``name``, ``contract`` (the prose invariant
    this rule machine-checks), ``hint`` (the fix direction shown with every
    finding), optionally ``scope`` (path substrings; empty = whole tree),
    and implement ``check(ctx) -> list[Finding]``."""

    name = ""
    contract = ""
    hint = ""
    scope: tuple[str, ...] = ()
    exclude: tuple[str, ...] = ()

    def applies_to(self, path: str) -> bool:
        if any(part in path for part in self.exclude):
            return False
        if not self.scope:
            return True
        return any(part in path for part in self.scope)

    def check(self, ctx: FileContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    checked_files: int = 0
    rules: tuple[str, ...] = ()

    @property
    def clean(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "checked_files": self.checked_files,
            "rules": list(self.rules),
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
            "clean": self.clean,
        }


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------


def _parse_suppressions(ctx: FileContext,
                        known_rules: set[str]) -> tuple[dict, list[Finding]]:
    """-> ({line -> set(rule names allowed on/below that comment)}, bad
    suppression findings). A comment on line N covers findings anchored on
    line N (trailing comment) and line N+1 (comment-above style)."""
    allowed: dict[int, set[str]] = {}
    bad: list[Finding] = []
    for i, text in enumerate(ctx.lines, start=1):
        m = _ALLOW_RE.search(text)
        if m is None:
            continue
        rule, reason = m.group(1), m.group(2).strip()
        if rule not in known_rules:
            bad.append(Finding(
                BAD_SUPPRESSION, ctx.path, i,
                f"allow() names unknown rule {rule!r}",
                hint="suppressions must name an active rule",
                code=text.strip()))
            continue
        if not reason:
            bad.append(Finding(
                BAD_SUPPRESSION, ctx.path, i,
                f"allow({rule}) carries no reason",
                hint="every suppression must say WHY the site is exempt: "
                     "lint: allow(<rule>) <reason>",
                code=text.strip()))
            continue
        allowed.setdefault(i, set()).add(rule)
        allowed.setdefault(i + 1, set()).add(rule)
    return allowed, bad


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path | str | None) -> list[dict]:
    if path is None:
        return []
    p = Path(path)
    if not p.exists():
        return []
    doc = json.loads(p.read_text())
    return list(doc.get("entries", ()))


def baseline_entries_from_findings(findings: list[Finding],
                                   reason: str) -> list[dict]:
    """Entry list for --write-baseline: one entry per distinct
    (rule, path, code) with the multiplicity as count."""
    grouped: dict[tuple, int] = {}
    for f in findings:
        grouped[(f.rule, f.path, f.code)] = \
            grouped.get((f.rule, f.path, f.code), 0) + 1
    return [{"rule": r, "path": p, "code": c, "count": n, "reason": reason}
            for (r, p, c), n in sorted(grouped.items())]


class _Baseline:
    def __init__(self, entries: list[dict]):
        self.entries = entries
        # (rule, path, code) -> remaining absorb budget
        self.budget: dict[tuple, int] = {}
        self.used: dict[tuple, int] = {}
        for e in entries:
            key = (e.get("rule"), e.get("path"), e.get("code"))
            self.budget[key] = self.budget.get(key, 0) + int(
                e.get("count", 1))
            self.used.setdefault(key, 0)

    def absorb(self, f: Finding) -> bool:
        key = (f.rule, f.path, f.code)
        if self.budget.get(key, 0) > 0:
            self.budget[key] -= 1
            self.used[key] += 1
            return True
        return False

    def stale_findings(self, seen_paths: set[str]) -> list[Finding]:
        out = []
        for e in self.entries:
            rule, path = e.get("rule"), e.get("path", "")
            reason = str(e.get("reason", "")).strip()
            key = (rule, path, e.get("code"))
            if not reason:
                out.append(Finding(
                    STALE_BASELINE, path, 0,
                    f"baseline entry for [{rule}] carries no reason",
                    hint="every baseline entry must say WHY the site is "
                         "accepted"))
            elif path not in seen_paths:
                out.append(Finding(
                    STALE_BASELINE, path, 0,
                    f"baseline entry for [{rule}] names a file that was "
                    "not scanned (deleted or renamed)",
                    hint="remove the entry — baselines shrink, never rot"))
            elif self.used.get(key, 0) == 0:
                out.append(Finding(
                    STALE_BASELINE, path, 0,
                    f"baseline entry for [{rule}] matched no finding "
                    f"(site fixed?): {e.get('code', '')!r}",
                    hint="remove the entry — the violation it excused is "
                         "gone"))
        return out


# ---------------------------------------------------------------------------
# Driving
# ---------------------------------------------------------------------------


def _iter_py_files(paths) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


def _scoped_path(p: Path) -> str:
    """Path used for rule scoping and reports: rebased to start at the
    package dir ("corda_tpu_torch/...") when the file lives under one, else
    the given path as-is (fixtures, out-of-tree scans)."""
    parts = p.as_posix().split("/")
    if "corda_tpu_torch" in parts:
        return "/".join(parts[parts.index("corda_tpu_torch"):])
    return p.as_posix()


def _check_file(path: str, source: str, rules, report: Report,
                baseline: _Baseline | None) -> None:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        report.findings.append(Finding(
            "syntax-error", path, e.lineno or 1, str(e.msg),
            hint="the analyzer (and the interpreter) must be able to "
                 "parse every file"))
        return
    ctx = FileContext(path, source, tree)
    known = {r.name for r in rules}
    allowed, bad = _parse_suppressions(ctx, known)
    report.findings.extend(bad)
    for rule in rules:
        if not rule.applies_to(path):
            continue
        for f in rule.check(ctx):
            if f.rule in allowed.get(f.line, ()):
                report.suppressed.append(f)
            elif baseline is not None and baseline.absorb(f):
                report.baselined.append(f)
            else:
                report.findings.append(f)


def analyze_paths(paths, rules=None, baseline_path=DEFAULT_BASELINE,
                  use_baseline: bool = True) -> Report:
    """Run every rule over every python file under ``paths``."""
    if rules is None:
        from .rules import ALL_RULES

        rules = ALL_RULES
    baseline = _Baseline(load_baseline(baseline_path)) if use_baseline \
        else None
    report = Report(rules=tuple(r.name for r in rules))
    seen: set[str] = set()
    for file_path in _iter_py_files(paths):
        scoped = _scoped_path(file_path)
        seen.add(scoped)
        try:
            source = file_path.read_text()
        except (OSError, UnicodeDecodeError) as e:
            report.findings.append(Finding(
                "syntax-error", scoped, 1, f"unreadable: {e}"))
            continue
        report.checked_files += 1
        _check_file(scoped, source, rules, report, baseline)
    if baseline is not None:
        report.findings.extend(baseline.stale_findings(seen))
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report


def analyze_source(source: str, path: str, rules=None,
                   baseline_entries: list[dict] | None = None) -> Report:
    """Test hook: run the rules over one in-memory snippet under a chosen
    scoping path (e.g. "corda_tpu_torch/node/services/raft.py")."""
    if rules is None:
        from .rules import ALL_RULES

        rules = ALL_RULES
    baseline = _Baseline(baseline_entries) if baseline_entries else None
    report = Report(rules=tuple(r.name for r in rules))
    _check_file(path, source, rules, report, baseline)
    if baseline is not None:
        report.findings.extend(baseline.stale_findings({path}))
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report

"""Shared lint framework: findings, reviewed allowlists, file walking.

Every AST lint in this package (hotpath, locks, nondet) produces
:class:`Finding` objects and filters them through a reviewed
:class:`Allowlist` whose entries REQUIRE a written safety argument — an
allowlist entry without a reason is itself an error. The framework also
reports *stale* allowlist entries (entries matching nothing), so the
allowlist can only shrink to fit the code, never silently outgrow it.

Finding keys are ``<rule>:<symbol>`` strings, stable across line-number
churn; the allowlist maps ``repo-relative-path -> {key: reason}``.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["Finding", "Allowlist", "LintReport", "repo_root", "walk_py"]


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent.parent


@dataclasses.dataclass
class Finding:
    """One lint hit: ``key`` is ``<rule>:<symbol>`` (allowlist-stable),
    ``message`` explains the hazard, ``why`` the rule's rationale."""
    file: str          # repo-relative path
    line: int
    rule: str
    symbol: str        # function/attr the finding anchors to
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.symbol}"

    def describe(self) -> str:
        return f"{self.file}:{self.line}: [{self.key}] {self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d


class Allowlist:
    """Reviewed exceptions: ``{file: {finding-key: safety argument}}``.

    Matching is exact on (file, key). Every entry must carry a
    non-empty written reason; :meth:`stale` lists entries that matched
    no finding (dead entries must be deleted, not accumulated)."""

    def __init__(self, entries: Dict[str, Dict[str, str]]):
        for path, keys in entries.items():
            for key, reason in keys.items():
                if not isinstance(reason, str) or len(reason.strip()) < 10:
                    raise ValueError(
                        f"allowlist entry {path}:{key} needs a written "
                        f"safety argument (got {reason!r})")
        self._entries = entries
        self._hits: set = set()

    def match(self, finding: Finding) -> str:
        """Return the safety argument if allowlisted, else ''."""
        reason = self._entries.get(finding.file, {}).get(finding.key, "")
        if reason:
            self._hits.add((finding.file, finding.key))
        return reason

    def stale(self) -> List[str]:
        out = []
        for path, keys in self._entries.items():
            for key in keys:
                if (path, key) not in self._hits:
                    out.append(f"{path}:{key}")
        return sorted(out)


@dataclasses.dataclass
class LintReport:
    """One lint pass's result: open findings fail the gate; allowlisted
    ones are carried (with their safety argument) for visibility."""
    name: str
    files_scanned: int
    findings: List[Finding]
    allowlisted: List[Tuple[Finding, str]]
    stale_allowlist: List[str]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_allowlist

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "findings": [f.to_dict() for f in self.findings],
            "allowlisted": [
                {**f.to_dict(), "reason": reason}
                for f, reason in self.allowlisted],
            "stale_allowlist": self.stale_allowlist,
        }

    def describe(self) -> str:
        lines = [f.describe() for f in self.findings]
        lines += [f"stale allowlist entry (delete it): {e}"
                  for e in self.stale_allowlist]
        return "\n".join(lines)


def finish_report(name: str, files_scanned: int,
                  raw: Iterable[Finding],
                  allowlist: Allowlist) -> LintReport:
    """Split raw findings into open vs allowlisted and close the report."""
    findings: List[Finding] = []
    allowed: List[Tuple[Finding, str]] = []
    for f in raw:
        reason = allowlist.match(f)
        if reason:
            allowed.append((f, reason))
        else:
            findings.append(f)
    return LintReport(name=name, files_scanned=files_scanned,
                      findings=findings, allowlisted=allowed,
                      stale_allowlist=allowlist.stale())


def walk_py(paths: Sequence[str],
            root: pathlib.Path = None) -> List[pathlib.Path]:
    """Expand repo-relative files/dirs to sorted .py paths."""
    root = root or repo_root()
    out: List[pathlib.Path] = []
    for p in paths:
        full = root / p
        if full.is_dir():
            out.extend(sorted(full.rglob("*.py")))
        elif full.exists():
            out.append(full)
    return out

"""Machine-readable analysis findings and the committed-baseline diff.

The port's copy of ``repro.analysis.report``, which imports no framework:
every ``repro_torch.analysis`` pass (the AST linter, the graph contracts)
reports :class:`Finding` records and writes them in one JSON schema,
``repro.analysis_report/v1``, the reference's, so that a report from
either package reads the same.

Grandfathering works like a lint baseline file: the port's baseline is
``src/repro_torch/analysis/baseline.json`` (the reference's
``ANALYSIS_BASELINE.json`` covers ``src/repro``), which lists known
findings by the stable key ``(rule, path, symbol, message)``.  A finding
matched by an active baseline entry is *grandfathered* (reported, but it
does not fail the run); anything else is *new* and exits non-zero.  An
entry may carry ``expires: "YYYY-MM-DD"``, past which it stops
suppressing, and a ``reason`` that says why the finding is acceptable.
Entries that no longer match anything are reported as *stale*, so the
baseline shrinks as debt is paid.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

REPORT_SCHEMA = "repro.analysis_report/v1"
BASELINE_SCHEMA = "repro.analysis_baseline/v1"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding, stable across line drift.

    ``key()`` deliberately excludes the line number: the baseline matches
    on where a finding lives logically (rule + file + enclosing symbol +
    message), so reformatting a file does not invalidate grandfathering.
    """
    rule: str          # "RL001".."RL005", "GC00x"
    path: str          # repo-relative posix path ("" for non-file findings)
    line: int          # 1-based; 0 when not applicable
    symbol: str        # enclosing qualname, or "<module>" / scenario name
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else self.symbol
        return f"{loc}: {self.rule} [{self.symbol}] {self.message}"


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    message: str
    count: int = 1
    reason: str = ""
    expires: Optional[str] = None     # "YYYY-MM-DD"; None = never

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def active(self, today: Optional[datetime.date] = None) -> bool:
        if self.expires is None:
            return True
        today = today or datetime.date.today()
        return today <= datetime.date.fromisoformat(self.expires)


def load_baseline(path: str) -> List[BaselineEntry]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{path}: expected schema {BASELINE_SCHEMA!r}, "
            f"got {doc.get('schema')!r}")
    fields = {f.name for f in dataclasses.fields(BaselineEntry)}
    entries = []
    for i, e in enumerate(doc.get("entries", ())):
        unknown = set(e) - fields
        if unknown:
            raise ValueError(f"{path}: entry {i} has unknown fields "
                             f"{sorted(unknown)}")
        entries.append(BaselineEntry(**e))
    return entries


@dataclasses.dataclass
class Diff:
    """The baseline diff CI gates on: ``new`` findings exit non-zero."""
    new: List[Finding]
    grandfathered: List[Finding]
    expired: List[Finding]           # matched only an expired entry
    stale: List[BaselineEntry]       # entry matched nothing

    @property
    def ok(self) -> bool:
        return not self.new and not self.expired


def diff_findings(findings: Sequence[Finding],
                  baseline: Sequence[BaselineEntry],
                  today: Optional[datetime.date] = None) -> Diff:
    """Split findings into new / grandfathered against the baseline.

    Each baseline entry absorbs up to ``count`` findings with its key;
    surplus findings with a known key are still *new* (a rule regressing
    further inside an allowlisted file must fail CI).
    """
    budget: Counter = Counter()
    expired_keys = set()
    for e in baseline:
        if e.active(today):
            budget[e.key()] += e.count
        else:
            expired_keys.add(e.key())
    new, grandfathered, expired = [], [], []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            grandfathered.append(f)
        elif f.key() in expired_keys:
            expired.append(f)
        else:
            new.append(f)
    used = {f.key() for f in grandfathered}
    stale = [e for e in baseline
             if e.active(today) and e.key() not in used]
    return Diff(new=new, grandfathered=grandfathered, expired=expired,
                stale=stale)


def make_report(findings: Sequence[Finding], diff: Optional[Diff] = None,
                tool: str = "repro_torch.analysis", extra: Optional[dict] = None
                ) -> dict:
    """The ``repro.analysis_report/v1`` document (CI artifact payload)."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    doc = {
        "schema": REPORT_SCHEMA,
        "tool": tool,
        "findings": [f.to_dict() for f in findings],
        "summary": {
            "total": len(findings),
            "by_rule": dict(sorted(by_rule.items())),
        },
    }
    if diff is not None:
        doc["summary"].update(
            new=len(diff.new), grandfathered=len(diff.grandfathered),
            expired=len(diff.expired), stale_baseline=len(diff.stale))
        doc["new_findings"] = [f.to_dict() for f in diff.new]
        doc["stale_baseline_entries"] = [dataclasses.asdict(e)
                                         for e in diff.stale]
    if extra:
        doc.update(extra)
    return doc


def write_report(doc: dict, path: str) -> None:
    import os
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")


def baseline_from_findings(findings: Sequence[Finding],
                           reason: str = "grandfathered at introduction"
                           ) -> dict:
    """Render findings as a fresh baseline document (``lint --write-
    baseline`` seeds or refreshes the port's ``baseline.json`` with it)."""
    counts: Counter = Counter(f.key() for f in findings)
    entries = []
    for (rule, path, symbol, message), count in sorted(counts.items()):
        e = {"rule": rule, "path": path, "symbol": symbol,
             "message": message, "reason": reason}
        if count > 1:
            e["count"] = count
        entries.append(e)
    return {"schema": BASELINE_SCHEMA, "entries": entries}

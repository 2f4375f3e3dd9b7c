"""Machine-readable validation verdicts: ``CheckResult`` + ``ValidationReport``.

The port's own copy of ``repro/validate/report.py``: the same checks, the
same schema, so both packages' reports compare as dicts.

A report is a flat list of checks — (metric, population, value, band,
status) — so CI can grep one JSON artifact for ``"status": "fail"`` and a
human can read the same thing as a table.  ``skip`` marks checks whose
statistic could not be computed (no qualifying neurons, too few bins); a
skipped check never fails a report but stays visible in it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional

SCHEMA = "repro.validation_report/v1"


@dataclasses.dataclass
class CheckResult:
    metric: str              # "rate" | "cv_isi" | "correlation" | "synchrony"
    population: str          # population name, or "all" for network-wide
    value: float
    lo: float
    hi: float
    status: str              # "pass" | "fail" | "skip"
    detail: str = ""

    @staticmethod
    def judge(metric: str, population: str, value: float, band,
              detail: str = "") -> "CheckResult":
        if value is None or (isinstance(value, float) and math.isnan(value)):
            status = "skip"
            value = float("nan")
        else:
            value = float(value)
            status = "pass" if band.contains(value) else "fail"
        return CheckResult(metric=metric, population=population, value=value,
                           lo=band.lo, hi=band.hi, status=status,
                           detail=detail)


@dataclasses.dataclass
class ValidationReport:
    checks: List[CheckResult]
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def passed(self) -> bool:
        """True when no check failed (skips are allowed but kept visible)."""
        return not self.failures()

    def failures(self) -> List[CheckResult]:
        return [c for c in self.checks if c.status == "fail"]

    def by_population(self) -> Dict[str, str]:
        """Per-population verdict: fail > skip > pass over its checks."""
        out: Dict[str, str] = {}
        for c in self.checks:
            prev = out.get(c.population)
            rank = {"pass": 0, "skip": 1, "fail": 2}
            if prev is None or rank[c.status] > rank[prev]:
                out[c.population] = c.status
        return out

    def to_dict(self) -> Dict:
        return _clean({
            "schema": SCHEMA,
            "passed": self.passed,
            "meta": dict(self.meta),
            "by_population": self.by_population(),
            "checks": [dataclasses.asdict(c) for c in self.checks],
        })

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        s = json.dumps(self.to_dict(), indent=indent, allow_nan=False)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    def table(self) -> str:
        """Human-readable fixed-width rendering of the same checks."""
        lines = [f"{'metric':<12} {'pop':<6} {'value':>9}   "
                 f"{'band':<18} status"]
        for c in self.checks:
            val = "-" if math.isnan(c.value) else f"{c.value:9.3f}"
            band = f"[{c.lo:.3f}, {c.hi:.3f}]"
            mark = {"pass": "ok", "fail": "FAIL", "skip": "skip"}[c.status]
            lines.append(f"{c.metric:<12} {c.population:<6} {val:>9}   "
                         f"{band:<18} {mark}")
        verdict = "PASSED" if self.passed else "FAILED"
        lines.append(f"-- validation {verdict} "
                     f"({len(self.failures())} failing check(s))")
        return "\n".join(lines)


def _clean(obj):
    """NaNs (skipped checks) serialise as null; numpy scalars as python."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if hasattr(obj, "item"):
        obj = obj.item()
    if isinstance(obj, float) and math.isnan(obj):
        return None
    return obj

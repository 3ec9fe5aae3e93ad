"""The one record both analysis passes report (the port of
``repro/analysis/findings.py``).

A finding is a structured diff entry, not a log line: ``kind`` names the
violated rule, ``where`` locates it (a recorded collective's name such as
``all-reduce#12``, or ``path:line``), ``expected``/``actual`` carry the
two sides of the diff, and ``plan_leaf`` ties a contract finding back to
the plan element (bucket index, table name) whose contract the step
broke.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    kind: str                 # rule id, e.g. "missing-collective"
    where: str = ""           # a recorded collective or "path:line"
    expected: str = ""
    actual: str = ""
    plan_leaf: str = ""       # bucket index / table name / config field
    message: str = ""

    def to_dict(self) -> dict:
        return {"kind": self.kind, "where": self.where,
                "expected": self.expected, "actual": self.actual,
                "plan_leaf": self.plan_leaf, "message": self.message}

    def __str__(self) -> str:
        parts = [self.kind]
        if self.where:
            parts.append(f"at {self.where}")
        if self.plan_leaf:
            parts.append(f"[{self.plan_leaf}]")
        if self.expected or self.actual:
            parts.append(f"expected {self.expected!r} got {self.actual!r}")
        if self.message:
            parts.append(f"— {self.message}")
        return " ".join(parts)

"""Findings and the grandfather baseline.

A finding is one violation at one source location. Its ``ident`` is
deliberately LINE-FREE — ``checker:file:code:key`` — so a baseline
entry keeps matching while unrelated edits move the code around, and
stops matching the moment the underlying violation is actually fixed
(at which point the stale entry itself becomes a finding: the baseline
must shrink, never silently rot).

The gate is therefore "no NEW violations": everything the checkers
find must either be fixed or carry a ``lint_baseline.json`` entry with
a human-written reason.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SEVERITIES = ("error", "warning")


@dataclass
class Finding:
    checker: str      # e.g. "lock-discipline"
    code: str         # e.g. "blocking-under-lock"
    file: str         # repo-relative path
    line: int
    message: str
    key: str = ""     # stable discriminator (lock pair, metric name, ...)
    severity: str = "error"
    hint: str = ""    # fix-it suggestion

    @property
    def ident(self) -> str:
        return f"{self.checker}:{self.file}:{self.code}:{self.key}"

    def render(self) -> str:
        text = (
            f"{self.file}:{self.line} {self.severity} "
            f"{self.checker}[{self.code}] {self.message}"
        )
        if self.hint:
            text += f"\n    hint: {self.hint}"
        return text


@dataclass
class Baseline:
    """``lint_baseline.json``: grandfathered findings, each with a
    reason. Matching is by line-free ident; entries that match nothing
    are stale and reported as findings themselves."""

    entries: Dict[str, str] = field(default_factory=dict)  # ident -> reason
    path: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, "r", encoding="utf-8") as handle:
                raw = json.load(handle)
        except FileNotFoundError:
            return cls(path=path)
        entries: Dict[str, str] = {}
        for entry in raw.get("findings", []):
            entries[str(entry["id"])] = str(entry.get("reason", ""))
        return cls(entries=entries, path=path)

    def save(self, path: Optional[str] = None) -> None:
        target = path or self.path
        assert target, "baseline has no path"
        payload: Dict[str, Any] = {
            "version": 1,
            "findings": [
                {"id": ident, "reason": reason}
                for ident, reason in sorted(self.entries.items())
            ],
        }
        with open(target, "w", encoding="utf-8") as handle:
            json.dump(payload, handle, indent=2)
            handle.write("\n")

    def split(self, findings: List[Finding]):
        """Partition findings into (fresh, suppressed) and compute the
        stale baseline idents (entries matching no current finding).

        A suppressing entry must also be JUSTIFIED: ``--write-baseline``
        stubs reasons as ``TODO: justify``, and an entry still carrying
        a stub (or an empty reason) is itself a finding — the baseline
        may only hold keeps a human has written a reason for, so stubs
        expire instead of quietly becoming permanent."""
        fresh: List[Finding] = []
        suppressed: List[Finding] = []
        seen = set()
        for finding in findings:
            if finding.ident in self.entries:
                suppressed.append(finding)
                seen.add(finding.ident)
            else:
                fresh.append(finding)
        for ident in sorted(seen):
            reason = self.entries.get(ident, "").strip()
            if not reason or reason.upper().startswith("TODO"):
                fresh.append(
                    Finding(
                        checker="baseline",
                        code="unjustified-keep",
                        file=self.path or "lint_baseline.json",
                        line=1,
                        key=ident,
                        message=(
                            f"baseline entry {ident!r} suppresses a "
                            "finding without a written reason "
                            f"({reason or 'empty'!r})"
                        ),
                        hint=(
                            "replace the stub with WHY this violation "
                            "is a deliberate keep, or fix the violation "
                            "and delete the entry"
                        ),
                    )
                )
        stale = sorted(set(self.entries) - seen)
        for ident in stale:
            fresh.append(
                Finding(
                    checker="baseline",
                    code="stale-entry",
                    file=self.path or "lint_baseline.json",
                    line=1,
                    key=ident,
                    message=(
                        f"baseline entry {ident!r} matches no current "
                        "finding — the violation it grandfathers is gone"
                    ),
                    hint="delete the entry from lint_baseline.json",
                )
            )
        return fresh, suppressed

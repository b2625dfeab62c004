"""Finding/report data model, inline suppressions, and the baseline ratchet.

Baseline entries are keyed by ``(path, rule, symbol)`` — never by line
number — so unrelated edits to a file don't churn the baseline. The
ratchet direction is one-way: a finding missing from the baseline fails
the run ("no new findings"), and a baseline entry that no longer fires is
*stale* and must be deleted ("the baseline only shrinks").
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

BASELINE_VERSION = 1

_SUPPRESS_RE = re.compile(r"#\s*reprolint:\s*ignore(?:\[([a-z0-9_,\- ]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``symbol`` is the stable identity used for baseline matching (e.g.
    ``Coordinator.assignments`` or ``_mix_vector:np.random.RandomState``);
    ``message`` names the violated contract and the whitelist/suppression
    that would apply, run_parity-style.
    """

    path: str
    line: int
    col: int
    rule: str
    symbol: str
    message: str

    @property
    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.path, self.rule, self.symbol)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "symbol": self.symbol,
            "message": self.message,
        }


@dataclass
class Report:
    """The outcome of one analysis run."""

    findings: List[Finding] = field(default_factory=list)  # non-suppressed
    new: List[Finding] = field(default_factory=list)  # not in baseline
    baselined: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale_baseline: List[Tuple[str, str, str]] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def ok(self) -> bool:
        return not self.new

    def to_dict(self) -> Dict[str, object]:
        from .config import RULE_CONTRACTS

        return {
            "tool": "reprolint",
            "baseline_version": BASELINE_VERSION,
            "files_scanned": self.files_scanned,
            "rules": dict(RULE_CONTRACTS),
            "findings": [f.to_dict() for f in self.findings],
            "new": [f.to_dict() for f in self.new],
            "baselined": [f.to_dict() for f in self.baselined],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "stale_baseline": [
                {"path": p, "rule": r, "symbol": s} for p, r, s in self.stale_baseline
            ],
            "ok": self.ok,
        }


# ---------------------------------------------------------------------------
# Inline suppressions
# ---------------------------------------------------------------------------


def suppressed_rules_by_line(source: str) -> Dict[int, Optional[frozenset]]:
    """Map 1-based line numbers to the rules suppressed on that line.

    ``# reprolint: ignore`` suppresses every rule on its line (value
    ``None``); ``# reprolint: ignore[rule-a,rule-b]`` suppresses only the
    listed rules.
    """
    out: Dict[int, Optional[frozenset]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = frozenset(r.strip() for r in m.group(1).split(",") if r.strip())
    return out


def is_suppressed(finding: Finding, table: Dict[int, Optional[frozenset]]) -> bool:
    rules = table.get(finding.line, "absent")
    if rules == "absent":
        return False
    return rules is None or finding.rule in rules  # type: ignore[operator]


# ---------------------------------------------------------------------------
# Baseline I/O
# ---------------------------------------------------------------------------


def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {data.get('version')!r}"
        )
    out = []
    for e in data.get("findings", []):
        out.append((e["path"], e["rule"], e["symbol"]))
    return out


def dump_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = sorted(
        {f.baseline_key for f in findings}
    )
    data = {
        "version": BASELINE_VERSION,
        "comment": (
            "Grandfathered reprolint findings. Ratchet: entries may only be "
            "removed (after fixing or inline-suppressing the finding), never "
            "added — new findings must be fixed, not baselined."
        ),
        "findings": [
            {"path": p, "rule": r, "symbol": s} for p, r, s in entries
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=False)
        f.write("\n")


def split_against_baseline(
    findings: Sequence[Finding], baseline: Sequence[Tuple[str, str, str]]
) -> Tuple[List[Finding], List[Finding], List[Tuple[str, str, str]]]:
    """Partition into (new, baselined) and compute stale baseline entries."""
    bset = set(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    seen: set = set()
    for f in findings:
        if f.baseline_key in bset:
            old.append(f)
            seen.add(f.baseline_key)
        else:
            new.append(f)
    stale = sorted(bset - seen)
    return new, old, stale

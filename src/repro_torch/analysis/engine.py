"""The reprolint runner: file collection, two-pass scan, baseline compare.

Pass 1 parses every file and collects the tree-wide frozen-class set (a
``ScenarioSpec`` parameter in ``simulator.py`` must be recognized even
though the class is defined in ``scenarios.py``). Pass 2 runs the five
checkers per file, applies inline suppressions, then partitions the
surviving findings against the baseline.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from . import floatops, frozen, observers, purge, rng
from .astutil import import_map
from .findings import (
    Finding,
    Report,
    is_suppressed,
    load_baseline,
    split_against_baseline,
    suppressed_rules_by_line,
)

_CHECKERS = (rng.check, purge.check, floatops.check, observers.check)


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in ("__pycache__", ".git")
                )
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        out.append(os.path.join(dirpath, name))
        elif p.endswith(".py"):
            out.append(p)
    # the analyzer does not lint itself (its config literals mention every
    # forbidden spelling)
    me = os.path.dirname(os.path.abspath(__file__))
    return [f for f in out if os.path.dirname(os.path.abspath(f)) != me]


def _relpath(path: str, root: Optional[str]) -> str:
    if root:
        try:
            return os.path.relpath(path, root).replace(os.sep, "/")
        except ValueError:  # pragma: no cover - cross-drive on windows
            pass
    return path.replace(os.sep, "/")


def run_checks(
    paths: Sequence[str],
    baseline_path: Optional[str] = None,
    root: Optional[str] = None,
) -> Report:
    """Run every reprolint rule over ``paths`` (files or directories).

    Returns a :class:`Report`; ``report.ok`` is False iff there are
    non-suppressed findings absent from the baseline.
    """
    files = collect_files(paths)
    parsed: List[Tuple[str, str, ast.Module, str]] = []  # (file, rel, tree, src)
    frozen_names: FrozenSet[str] = frozenset()
    for f in files:
        with open(f, "r", encoding="utf-8") as fh:
            src = fh.read()
        tree = ast.parse(src, filename=f)
        parsed.append((f, _relpath(f, root), tree, src))
        frozen_names = frozen_names | frozen.discover_frozen(tree)

    report = Report(files_scanned=len(parsed))
    all_findings: List[Finding] = []
    for _, rel, tree, src in parsed:
        imports = import_map(tree)
        file_findings: List[Finding] = []
        for checker in _CHECKERS:
            file_findings.extend(checker(rel, tree, imports))
        file_findings.extend(frozen.check(rel, tree, imports, frozen=frozen_names))
        table = suppressed_rules_by_line(src)
        for fnd in sorted(file_findings, key=lambda x: (x.line, x.col, x.rule)):
            if is_suppressed(fnd, table):
                report.suppressed.append(fnd)
            else:
                all_findings.append(fnd)

    report.findings = all_findings
    baseline = load_baseline(baseline_path) if baseline_path else []
    report.new, report.baselined, report.stale_baseline = split_against_baseline(
        all_findings, baseline
    )
    return report

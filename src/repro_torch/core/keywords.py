"""Keyword hierarchies and preferences (§2.4).

BOINC defines two keyword hierarchies: science areas and project locations.
Volunteers mark keywords yes/no; the scheduler prefers jobs with "yes"
keywords and never sends jobs with "no" keywords. Science United's
coordinated model (§10.1) is built on the same mechanism.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

# The paper's two hierarchies, abbreviated. parent == None marks a root.
SCIENCE_KEYWORDS: Dict[str, Optional[str]] = {
    "science": None,
    "physics": "science",
    "astrophysics": "physics",
    "particle_physics": "physics",
    "biomedicine": "science",
    "cancer_research": "biomedicine",
    "drug_discovery": "biomedicine",
    "mathematics": "science",
    "climate": "science",
    "machine_learning": "science",  # adaptation: ML workloads are first-class
}

LOCATION_KEYWORDS: Dict[str, Optional[str]] = {
    "world": None,
    "asia": "world",
    "europe": "world",
    "united_states": "world",
    "uc_berkeley": "united_states",
    "texas": "united_states",
}


def ancestors(keyword: str, tree: Dict[str, Optional[str]]) -> Tuple[str, ...]:
    """Keyword plus its chain of parents up to the root."""
    out = []
    k: Optional[str] = keyword
    while k is not None:
        out.append(k)
        k = tree.get(k)
    return tuple(out)


@dataclass
class KeywordPrefs:
    """A volunteer's yes/no keyword marks (§2.4)."""

    yes: frozenset = field(default_factory=frozenset)
    no: frozenset = field(default_factory=frozenset)

    @staticmethod
    def make(yes: Iterable[str] = (), no: Iterable[str] = ()) -> "KeywordPrefs":
        return KeywordPrefs(yes=frozenset(yes), no=frozenset(no))

    def empty(self) -> bool:
        return not self.yes and not self.no


def keyword_score(
    job_keywords: Sequence[str],
    prefs: KeywordPrefs,
    tree: Dict[str, Optional[str]] = SCIENCE_KEYWORDS,
) -> Optional[float]:
    """Score a job's keywords against volunteer prefs (§6.4).

    Returns None if the job carries a "no" keyword (job must be skipped);
    otherwise the number of "yes" matches (ancestors count: marking
    "physics" yes matches an "astrophysics" job).
    """
    if prefs.empty():
        return 0.0
    score = 0.0
    for kw in job_keywords:
        chain = ancestors(kw, tree) if kw in tree else (kw,)
        for a in chain:
            if a in prefs.no:
                return None
            if a in prefs.yes:
                score += 1.0
                break
    return score

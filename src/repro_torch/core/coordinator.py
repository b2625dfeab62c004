"""The coordinated volunteer-computing model (§10.1): Science United.

"volunteers register for scientific areas (using the keyword mechanism)
rather than for specific projects. SU dynamically attaches hosts to projects
based on these science preferences. ... SU has a mechanism (based on the
linear-bounded model) for allocating computing power among projects. This
means that a prospective new project can be guaranteed a certain amount of
computing power before any investment is made."

Implemented as an account manager (§2.3): clients attach to the coordinator;
the AM reply tells them which vetted projects to attach/detach. Allocation
shares drive a linear-bounded balance per project; hosts are (re)assigned to
the highest-balance project whose keywords pass the volunteer's prefs.

In the TPU adaptation this is the multi-tenant fleet coordinator: "projects"
are experiments/teams with guaranteed shares; "science keywords" are
workload/capability tags.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .allocation import LinearBoundedAllocator
from .client import Client, ProjectAttachment
from .keywords import KeywordPrefs, keyword_score
from .types import ResourceType


@dataclass
class VettedProject:
    """A project registered with the coordinator (§10.1: 'vetted by SU')."""

    name: str
    keywords: Tuple[str, ...]
    share: float = 1.0  # guaranteed relative allocation
    resource_types: Tuple[ResourceType, ...] = (ResourceType.CPU,)


@dataclass
class AMReply:
    attach: List[ProjectAttachment]
    detach: List[str]


@dataclass
class Coordinator:
    """Science United: keyword-driven host->project assignment with
    linear-bounded power allocation."""

    projects: Dict[str, VettedProject] = field(default_factory=dict)
    allocator: LinearBoundedAllocator = field(
        default_factory=lambda: LinearBoundedAllocator(default_cap=24 * 3600.0)
    )
    # volunteer_id -> keyword prefs
    volunteer_prefs: Dict[int, KeywordPrefs] = field(default_factory=dict)
    # host -> currently assigned project
    assignments: Dict[int, str] = field(default_factory=dict)

    def vet_project(self, project: VettedProject, now: float = 0.0) -> None:
        self.projects[project.name] = project
        self.allocator.ensure(project.name, now).rate = project.share

    def register_volunteer(self, volunteer_id: int, prefs: KeywordPrefs) -> None:
        self.volunteer_prefs[volunteer_id] = prefs

    # ------------------------------------------------------------------

    def eligible_projects(self, volunteer_id: int) -> List[str]:
        """Projects whose keywords pass the volunteer's yes/no marks."""
        prefs = self.volunteer_prefs.get(volunteer_id, KeywordPrefs())
        out = []
        for name, p in self.projects.items():
            score = keyword_score(p.keywords, prefs)
            if score is None:
                continue  # "no" keyword: never assign (§2.4)
            out.append((score, name))
        out.sort(key=lambda t: (-t[0], t[1]))
        return [n for _, n in out]

    def am_rpc(self, host_id: int, volunteer_id: int, now: float,
               used_seconds: float = 0.0) -> AMReply:
        """Periodic AM RPC (§2.3): returns attach/detach directives.

        ``used_seconds`` reports computing done for the current assignment
        since the last RPC; it debits the project's allocation balance so
        power is shared per the linear-bounded model.
        """
        current = self.assignments.get(host_id)
        if current is not None and used_seconds > 0:
            self.allocator.debit(current, used_seconds, now)

        eligible = self.eligible_projects(volunteer_id)
        if not eligible:
            if current is not None:
                del self.assignments[host_id]
                return AMReply(attach=[], detach=[current])
            return AMReply(attach=[], detach=[])

        # highest-balance eligible project wins (§3.9 / §10.1)
        best = max(eligible, key=lambda n: self.allocator.balance(n, now))
        if best == current:
            return AMReply(attach=[], detach=[])
        detach = [current] if current else []
        self.assignments[host_id] = best
        p = self.projects[best]
        return AMReply(
            attach=[
                ProjectAttachment(name=best, resource_types=p.resource_types)
            ],
            detach=detach,
        )

    # ------------------------------------------------------------------

    def forget_host(self, host_id: int) -> Optional[str]:
        """Purge a departed host's assignment row (churn hygiene).

        Without this, a churned host stays in ``assignments`` forever:
        ``attached_hosts`` keeps reporting it, so a project's apparent
        fleet never shrinks, and long-churn coordinated runs leak one row
        per departed host. Returns the project the host was assigned to
        (None if unassigned) so callers can surface a detach if the host
        ever reappears. The volunteer's prefs are *not* touched — a
        volunteer outlives any one host (§2.3) and may attach new ones.
        """
        return self.assignments.pop(host_id, None)

    def forget_volunteer(self, volunteer_id: int) -> None:
        """Drop a volunteer's keyword prefs (account deletion, §2.3)."""
        self.volunteer_prefs.pop(volunteer_id, None)

    def attached_hosts(self, project: str) -> List[int]:
        return [h for h, p in self.assignments.items() if p == project]

    def guaranteed_share(self, project: str) -> float:
        total = sum(p.share for p in self.projects.values())
        return self.projects[project].share / total if total else 0.0

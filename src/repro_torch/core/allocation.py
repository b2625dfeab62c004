"""The linear-bounded allocation model (§3.9).

"For each submitter, the system maintains a balance that grows linearly at a
particular rate, up to a fixed maximum. ... When a submitter uses resources,
their balance is decreased accordingly. At any given point, the jobs of the
submitter with the greatest balance are given priority. ... Given a mix of
continuous and sporadic workloads, this policy prioritizes small batches,
thereby minimizing average batch turnaround."

BOINC reuses the same model for client project scheduling priorities (§6.1)
and Science United project allocation (§10.1); so do we: the grid runtime
uses it to arbitrate submitters, and the client uses it for project priority.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class _Account:
    rate: float  # balance growth per second
    cap: float  # maximum balance
    balance: float = 0.0
    last_update: float = 0.0
    total_used: float = 0.0


@dataclass
class LinearBoundedAllocator:
    """Fair-share arbiter over named accounts (submitters or projects)."""

    default_rate: float = 1.0
    default_cap: float = 3600.0
    accounts: Dict[str, _Account] = field(default_factory=dict)

    def add_account(self, name: str, rate: float = None, cap: float = None, now: float = 0.0) -> None:
        self.accounts[name] = _Account(
            rate=self.default_rate if rate is None else rate,
            cap=self.default_cap if cap is None else cap,
            last_update=now,
        )

    def ensure(self, name: str, now: float = 0.0) -> _Account:
        if name not in self.accounts:
            self.add_account(name, now=now)
        return self.accounts[name]

    def _accrue(self, acct: _Account, now: float) -> None:
        dt = max(0.0, now - acct.last_update)
        acct.balance = min(acct.cap, acct.balance + acct.rate * dt)
        acct.last_update = now

    def balance(self, name: str, now: float) -> float:
        acct = self.ensure(name, now)
        self._accrue(acct, now)
        return acct.balance

    def debit(self, name: str, amount: float, now: float) -> None:
        """Charge ``amount`` (resource-seconds or credit) to an account."""
        acct = self.ensure(name, now)
        self._accrue(acct, now)
        acct.balance -= amount  # may go negative: over-served accounts wait
        acct.total_used += amount

    def priority(self, name: str, now: float) -> float:
        """Scheduling priority == current balance (§3.9)."""
        return self.balance(name, now)

    def ranked(self, now: float):
        """Accounts in dispatch-priority order (highest balance first)."""
        names = list(self.accounts)
        return sorted(names, key=lambda n: -self.balance(n, now))

"""Exponential backoff for all client/server interactions (§2.2).

"All client/server interactions handle failure using exponential back-off in
order to limit the rate of requests when a server resumes after a period of
being off-line."
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class ExponentialBackoff:
    """Retry controller with exponential backoff and uniform jitter.

    ``register_failure(now)`` schedules the next permissible attempt;
    ``register_success()`` resets. ``ready(now)`` gates RPC issue.
    """

    min_interval: float = 60.0
    max_interval: float = 4 * 3600.0
    multiplier: float = 2.0
    jitter: float = 0.2  # +/- fraction of the interval
    seed: int = 0

    n_failures: int = 0
    next_time: float = 0.0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def ready(self, now: float) -> bool:
        return now >= self.next_time

    def current_interval(self) -> float:
        if self.n_failures == 0:
            return 0.0
        raw = self.min_interval * (self.multiplier ** (self.n_failures - 1))
        return min(raw, self.max_interval)

    def register_failure(self, now: float) -> float:
        """Record a failed attempt; returns the scheduled retry time."""
        self.n_failures += 1
        interval = self.current_interval()
        if self.jitter > 0.0:
            lo = 1.0 - self.jitter
            hi = 1.0 + self.jitter
            interval *= self._rng.uniform(lo, hi)
        self.next_time = now + interval
        return self.next_time

    def register_success(self) -> None:
        self.n_failures = 0
        self.next_time = 0.0

"""Server-side job runtime estimation (§6.3).

The server maintains, for each (host H, app version V), the sample mean and
variance of runtime(J)/est_flop_count(J); also per app version V across all
hosts. ``proj_flops(H, V)`` is the estimated FLOPS adjusted for systematic
error in est_flop_count:

  * >= ``min_samples`` samples of R(H,V): use 1/mean(R(H,V))
  * else >= ``min_samples`` samples of R(V): use 1/mean(R(V))
  * else: the peak FLOPS of V on H.

est_runtime(J,H,V) = est_flop_count(J) / proj_flops(H,V).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .types import AppVersion, Host, Job


@dataclass
class OnlineStats:
    """Welford online mean/variance."""

    n: int = 0
    mean: float = 0.0
    _m2: float = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self._m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(max(0.0, self.variance))


@dataclass
class RuntimeEstimator:
    """Tracks runtime/est_flop_count statistics and projects FLOPS (§6.3)."""

    min_samples: int = 10  # the paper's threshold ("currently 10")
    host_version: Dict[Tuple[int, int], OnlineStats] = field(default_factory=dict)
    version: Dict[int, OnlineStats] = field(default_factory=dict)
    # host -> version ids with (host, version) stats, so churn cleanup is
    # O(host's versions) instead of a full host_version scan
    _host_versions: Dict[int, set] = field(default_factory=dict)

    def record(self, host: Host, version: AppVersion, job: Job, runtime: float) -> None:
        """Record an observed (runtime, est_flop_count) sample."""
        if runtime <= 0.0 or job.est_flop_count <= 0.0:
            return
        r = runtime / job.est_flop_count  # seconds per FLOP
        self.host_version.setdefault((host.id, version.id), OnlineStats()).add(r)
        self._host_versions.setdefault(host.id, set()).add(version.id)
        self.version.setdefault(version.id, OnlineStats()).add(r)

    def forget_host(self, host_id: int) -> None:
        """Drop a departed host's per-(host, version) stats (§4 churn):
        they can never be read again — ``proj_flops`` is only consulted for
        hosts requesting work — and long-churn populations would otherwise
        accumulate rows forever. Version-level aggregates are kept."""
        for vid in self._host_versions.pop(host_id, ()):
            self.host_version.pop((host_id, vid), None)

    def peak_flops(self, host: Host, version: AppVersion) -> float:
        ev = version.plan_class.evaluate(host)
        if ev is None:
            return 0.0
        _, pf = ev
        return pf

    def proj_flops(self, host: Host, version: AppVersion) -> float:
        hv = self.host_version.get((host.id, version.id))
        if hv is not None and hv.n >= self.min_samples and hv.mean > 0:
            return 1.0 / hv.mean
        v = self.version.get(version.id)
        if v is not None and v.n >= self.min_samples and v.mean > 0:
            return 1.0 / v.mean
        return self.peak_flops(host, version)

    def est_runtime(self, job: Job, host: Host, version: AppVersion) -> float:
        pf = self.proj_flops(host, version)
        if pf <= 0.0:
            return float("inf")
        return job.est_flop_count / pf

    def est_runtime_variance(self, job: Job, host: Host, version: AppVersion) -> float:
        """Runtime variance estimate — groundwork for low-latency scheduling
        (§10.7 suggests using sample variance to bound deadline-miss
        probability; we expose it for the grid runtime's straggler logic)."""
        hv = self.host_version.get((host.id, version.id))
        if hv is None or hv.n < 2:
            return 0.0
        return (hv.stddev * job.est_flop_count) ** 2

    def size_quantile(self, host: Host, version: AppVersion, n_classes: int, all_flops: list) -> int:
        """Which size-class quantile this host's speed falls in (§3.5):
        larger jobs go to faster hosts. ``all_flops`` is the population of
        proj_flops values used to compute quantile boundaries."""
        if n_classes <= 1 or not all_flops:
            return 0
        pf = self.proj_flops(host, version)
        sorted_f = sorted(all_flops)
        rank = sum(1 for f in sorted_f if f <= pf)
        q = int(rank * n_classes / (len(sorted_f) + 1))
        return min(n_classes - 1, q)

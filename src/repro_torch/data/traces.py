"""Availability-trace loading, fitting, and replay synthesis.

"The Computational and Storage Potential of Volunteer Computing" measured
real volunteer host populations and found (a) heavy-tailed on/off session
lengths, (b) strong diurnal waves — hosts are online when their owners are
awake, so availability swings with local time-of-day — and (c) correlated
outages (whole sites or power regions dropping at once). The hand-written
``make_population`` model (exponential on/off with a flat rate) cannot
express any of these.

This module closes that gap for the scenario layer
(``repro_torch.core.scenarios``):

  * :func:`load_bundled_trace` parses the small session trace shipped at
    ``host_sessions.csv`` (columns ``host, tz, start, duration``; a session
    is one contiguous online period);
  * :func:`fit_trace` fits lognormal on-session / off-gap distributions by
    log-moment matching and extracts a 24-bin diurnal profile (mean
    off-gap weight per local hour-of-day, normalized to mean 1.0);
  * :func:`synthesize_toggles` replays a fit into one host's absolute
    availability-toggle schedule — deterministic given the caller's
    ``random.Random`` — which plugs straight into
    ``HostSpec.avail_schedule`` (the simulator consumes scheduled toggles
    without touching its own RNG stream, so scalar/vector parity is
    untouched);
  * :func:`apply_outage` splices a correlated outage window (power cut,
    site failure) into a toggle schedule.

Everything here is pure: same inputs, same schedule, no module state.
"""
from __future__ import annotations

import math
import os
import random
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

HOUR = 3600.0
DAY = 86400.0

_BUNDLED = os.path.join(os.path.dirname(__file__), "host_sessions.csv")


class Session(NamedTuple):
    """One contiguous online period of one traced host."""

    host: int
    tz: float  # timezone offset, hours
    start: float  # seconds since trace start
    duration: float  # seconds online


@dataclass(frozen=True)
class TraceFit:
    """Lognormal session model + diurnal profile fitted from a trace."""

    on_mu: float  # mean of log(on-session seconds)
    on_sigma: float
    off_mu: float  # mean of log(off-gap seconds)
    off_sigma: float
    # mean off-gap weight per local hour-of-day the gap *started* in,
    # normalized to mean 1.0 — the diurnal wave (long gaps start at night)
    diurnal: Tuple[float, ...]
    availability: float  # overall on-fraction of the trace
    n_sessions: int

    def median_on(self) -> float:
        return math.exp(self.on_mu)

    def median_off(self) -> float:
        return math.exp(self.off_mu)


def load_trace(path: str) -> List[Session]:
    """Parse a ``host,tz,start,duration`` session CSV (# comments allowed)."""
    out: List[Session] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("host,"):
                continue
            h, tz, s, d = line.split(",")
            out.append(Session(int(h), float(tz), float(s), float(d)))
    return out


def load_bundled_trace() -> List[Session]:
    """The small availability trace shipped with the repo."""
    return load_trace(_BUNDLED)


def _log_moments(xs: Sequence[float]) -> Tuple[float, float]:
    logs = [math.log(x) for x in xs if x > 0.0]
    n = len(logs)
    if n == 0:
        return 0.0, 0.0
    mu = sum(logs) / n
    var = sum((v - mu) ** 2 for v in logs) / max(n - 1, 1)
    return mu, math.sqrt(var)


def fit_trace(sessions: Sequence[Session]) -> TraceFit:
    """Fit the lognormal on/off model and the diurnal profile."""
    ons = [s.duration for s in sessions]
    offs: List[float] = []
    # per-hour off-gap sums/counts, keyed by the local hour the gap started
    hour_sum = [0.0] * 24
    hour_n = [0] * 24
    by_host: dict = {}
    for s in sessions:
        by_host.setdefault(s.host, []).append(s)
    span_on = 0.0
    span_total = 0.0
    for host_sessions in by_host.values():
        host_sessions.sort(key=lambda s: s.start)
        for a, b in zip(host_sessions, host_sessions[1:]):
            gap = b.start - (a.start + a.duration)
            if gap <= 0.0:
                continue
            offs.append(gap)
            local = ((a.start + a.duration) / HOUR + a.tz) % 24.0
            h = int(local)
            hour_sum[h] += gap
            hour_n[h] += 1
        first, last = host_sessions[0], host_sessions[-1]
        span_on += sum(s.duration for s in host_sessions)
        span_total += (last.start + last.duration) - first.start
    on_mu, on_sigma = _log_moments(ons)
    off_mu, off_sigma = _log_moments(offs)
    mean_gap = (sum(offs) / len(offs)) if offs else 1.0
    weights = [
        (hour_sum[h] / hour_n[h] / mean_gap) if hour_n[h] else 1.0
        for h in range(24)
    ]
    mean_w = sum(weights) / 24.0
    diurnal = tuple(w / mean_w for w in weights)
    return TraceFit(
        on_mu=on_mu,
        on_sigma=on_sigma,
        off_mu=off_mu,
        off_sigma=off_sigma,
        diurnal=diurnal,
        availability=span_on / span_total if span_total > 0 else 1.0,
        n_sessions=len(ons),
    )


def synthesize_toggles(
    fit: TraceFit,
    rng: random.Random,
    horizon: float,
    tz_offset: float = 0.0,
    scale: float = 1.0,
    diurnal: bool = True,
    start: float = 0.0,
    min_off: float = 60.0,
) -> Tuple[float, ...]:
    """Replay a fit into one host's absolute availability-toggle times.

    The host is online at ``start``; each returned time flips its state
    (off, on, off, ...). On-sessions and off-gaps are lognormal draws from
    the fit; with ``diurnal`` the off-gap is additionally weighted by the
    profile bin of the local hour the host went offline — the timezone
    wave. Deterministic given the ``rng`` state; draws nothing from any
    other stream.
    """
    t = start
    toggles: List[float] = []
    while True:
        on = scale * math.exp(rng.gauss(fit.on_mu, fit.on_sigma))
        t += on
        if t >= horizon:
            break
        toggles.append(t)  # -> off
        w = 1.0
        if diurnal:
            local = (t / HOUR + tz_offset) % 24.0
            w = fit.diurnal[int(local)]
        off = scale * math.exp(rng.gauss(fit.off_mu, fit.off_sigma)) * w
        t += max(off, min_off)
        if t >= horizon:
            break
        toggles.append(t)  # -> on
    return tuple(toggles)


def toggles_to_intervals(
    toggles: Sequence[float], horizon: float, start: float = 0.0
) -> List[Tuple[float, float]]:
    """Online intervals of a toggle schedule (host online at ``start``)."""
    out: List[Tuple[float, float]] = []
    t = start
    on = True
    for x in toggles:
        if on and x > t:
            out.append((t, x))
        t = x
        on = not on
    if on and horizon > t:
        out.append((t, horizon))
    return out


def intervals_to_toggles(
    intervals: Sequence[Tuple[float, float]], horizon: float
) -> Tuple[float, ...]:
    """Inverse of :func:`toggles_to_intervals`. The first interval must
    begin at 0 (the simulator registers hosts online); an end at or past
    the horizon stays on through it and emits no toggle."""
    assert intervals and intervals[0][0] == 0.0, "host must start online"
    out: List[float] = []
    for i, (a, b) in enumerate(intervals):
        if i > 0:
            out.append(a)  # off-gap ends: back on
        if b < horizon:
            out.append(b)  # session ends: go off
    return tuple(out)


def apply_outage(
    toggles: Sequence[float],
    outage_start: float,
    outage_end: float,
    horizon: float,
) -> Tuple[float, ...]:
    """Splice a forced-offline window into a toggle schedule.

    Subtracts ``[outage_start, outage_end)`` from the schedule's online
    intervals and re-derives the toggle times. ``outage_start`` must be
    positive: hosts register online at t=0 and the simulator has no
    start-offline representation.
    """
    assert 0.0 < outage_start < outage_end, "outage must start after t=0"
    clipped: List[Tuple[float, float]] = []
    for a, b in toggles_to_intervals(toggles, horizon):
        if b <= outage_start or a >= outage_end:
            clipped.append((a, b))
            continue
        if a < outage_start:
            clipped.append((a, outage_start))
        if b > outage_end:
            clipped.append((outage_end, b))
    if not clipped or clipped[0][0] != 0.0:
        # the host was (or is now) offline from t=0 — unrepresentable;
        # keep it online for a vanishing first instant instead
        eps = min(1.0, outage_start / 2.0)
        clipped.insert(0, (0.0, eps))
    return intervals_to_toggles(clipped, horizon)

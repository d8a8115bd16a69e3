"""Open-loop admission control: arrival streams + dynamic read bursts.

The port's copy of ``repro.serving.admission`` (numpy only): the
arrival arrays equal the reference's bit for bit.

The benchmark runner's read bursts are *closed-loop*: the
client submits the next request only after the previous one returned,
so a fixed ``read_batch_size`` is always the right burst shape and
queueing delay does not exist.  Production traffic is open-loop --
requests arrive on their own schedule whether or not the server keeps
up -- which changes both sides of the problem:

* a fixed-size burst must WAIT for its last member to arrive; on a
  sparse stream the burst head pays up to ``size - 1`` inter-arrival
  gaps of queueing delay before the dispatch even starts.  Bursts must
  therefore close on a DEADLINE as well as on size (the tail-latency
  vs throughput knob every batching server exposes);
* under a traffic spike the server falls behind and every queued
  request's completion slides; background tuning work that would have
  been free inside an idle gap now lands on the critical path.  The
  build lane must be throttled by load -- and past a point the
  lowest-utility tuning work shed outright -- so the system degrades
  by deferring physical-design improvement, never by dropping queries.

This module provides the pieces: seeded arrival-time generators
(Poisson and a heavy-tailed ON/OFF bursty process -- the self-similar
flash-crowd shape), the size-or-deadline burst former over an ordered
workload stream, and the backlog-pressure estimate the runner uses to
pause or shed build work.  ``serving/slo.py`` turns the resulting
open-loop latencies into the p50/p99/p999 + deadline-miss report, and
``bench_db/runner.py`` wires it all to ``Database.execute_batch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

ARRIVAL_KINDS = ("uniform", "poisson", "bursty")


def uniform_arrivals(n: int, mean_ms: float) -> np.ndarray:
    """Fixed-cadence arrivals: request i arrives at (i+1) * mean_ms."""
    return np.arange(1, n + 1, dtype=np.float64) * mean_ms


def poisson_arrivals(n: int, mean_ms: float, seed: int = 0) -> np.ndarray:
    """Poisson process: exponential inter-arrival gaps, mean
    ``mean_ms``, deterministic per seed."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(mean_ms, size=n))


def bursty_arrivals(
    n: int,
    mean_ms: float,
    seed: int = 0,
    peak_ratio: float = 8.0,
    on_frac: float = 0.125,
    epoch_ms: Optional[float] = None,
    alpha: float = 1.5,
) -> np.ndarray:
    """Self-similar ON/OFF arrival process (flash-crowd shape).

    A Markov-modulated Poisson process: the stream alternates between
    an ON state (rate ``peak_ratio`` times the OFF rate) and an OFF
    state, with epoch durations drawn from a Pareto distribution with
    tail index ``alpha`` (heavy-tailed sojourn times are what makes
    aggregate traffic self-similar rather than smoothing out).  Rates
    are solved so the long-run mean inter-arrival time is ``mean_ms``
    with a fraction ``on_frac`` of time spent in the ON state;
    ``epoch_ms`` sets the mean ON-epoch duration (default
    ``32 * mean_ms``).  Deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    lam_off = 1.0 / (mean_ms * (on_frac * peak_ratio + (1.0 - on_frac)))
    lam_on = peak_ratio * lam_off
    mean_on = epoch_ms if epoch_ms is not None else 32.0 * mean_ms
    mean_off = mean_on * (1.0 - on_frac) / on_frac

    def pareto(mean: float) -> float:
        # (pareto(a) + 1) * xm has mean xm * a / (a - 1)
        xm = mean * (alpha - 1.0) / alpha
        return float((rng.pareto(alpha) + 1.0) * xm)

    times = []
    t = 0.0
    on = True  # open with a burst: the cold-start stress case
    while len(times) < n:
        dur = pareto(mean_on if on else mean_off)
        rate = lam_on if on else lam_off
        tt = t
        while len(times) < n:
            gap = float(rng.exponential(1.0 / rate))
            if tt + gap > t + dur:
                break
            tt += gap
            times.append(tt)
        t += dur
        on = not on
    return np.asarray(times, np.float64)


def _single_stream(
    kind: str,
    n: int,
    mean_ms: float,
    seed: int,
    peak_ratio: float,
    on_frac: float,
) -> np.ndarray:
    if kind == "uniform":
        return uniform_arrivals(n, mean_ms)
    if kind == "poisson":
        return poisson_arrivals(n, mean_ms, seed)
    return bursty_arrivals(
        n, mean_ms, seed, peak_ratio=peak_ratio, on_frac=on_frac
    )


def make_arrivals(
    kind: str,
    n: int,
    mean_ms: float,
    seed: int = 0,
    peak_ratio: float = 8.0,
    on_frac: float = 0.125,
    tenants: int = 1,
) -> np.ndarray:
    """Arrival-time vector (monotone, ms) for ``n`` requests.  A
    non-positive ``mean_ms`` means everything arrives at t=0 (pure
    backlog-drain / throughput mode).

    ``peak_ratio`` and ``on_frac`` shape the bursty stream's ON state
    (ignored by uniform/poisson); the defaults reproduce the
    historical constants bit for bit.  ``tenants > 1`` superimposes
    that many independently seeded streams, each generated at mean
    inter-arrival ``tenants * mean_ms`` so the aggregate keeps mean
    ``mean_ms`` -- uncorrelated per-tenant flash crowds, the
    multi-tenant mix.  Deterministic per (seed, tenants).
    """
    if kind not in ARRIVAL_KINDS:
        raise ValueError(
            f"arrival stream {kind!r}; known: {', '.join(ARRIVAL_KINDS)}"
        )
    if n <= 0:
        return np.zeros(0, np.float64)
    if mean_ms <= 0.0:
        return np.zeros(n, np.float64)
    tenants = max(int(tenants), 1)
    if tenants > 1:
        streams = [
            _single_stream(
                kind, n, mean_ms * tenants, seed + 7919 * t,
                peak_ratio, on_frac,
            )
            for t in range(tenants)
        ]
        return np.sort(np.concatenate(streams), kind="stable")[:n]
    return _single_stream(kind, n, mean_ms, seed, peak_ratio, on_frac)


@dataclass(frozen=True)
class BurstDecision:
    """One planned dispatch: stream items [start, end) at
    ``dispatch_at`` (absolute ms on the simulated clock)."""

    end: int
    dispatch_at: float


def next_burst(
    arrivals: np.ndarray,
    batchable: Sequence[bool],
    phases: Sequence[int],
    start: int,
    now: float,
    max_size: int,
    deadline_ms: Optional[float],
) -> BurstDecision:
    """Plan the next dispatch boundary over the timestamped stream.

    Mirrors a real admission timer without peeking at the future: the
    stage opens at ``t0 = max(now, head arrival)`` -- when the head
    arrives, or when the server frees up and finds it queued -- and
    closes at the EARLIEST of

    * the ``max_size``-th member's arrival (size close),
    * ``deadline_ms`` past the stage opening (deadline close;
      ``None`` disables the timer -- the fixed-size baseline).
      Anchoring the timer at ``t0`` rather than the head's arrival
      matters under backlog: every queued request has already
      "arrived by the close", so a loaded server still forms FULL
      batches (throughput preserved) and the deadline only bounds
      how long a burst waits for *future* arrivals,
    * the arrival of a non-batchable statement or a phase change
      (sequential semantics: mutations flush the stage, exactly like
      the closed-loop runner).

    Items join only if they arrive by the close time, so a straggler
    past the deadline starts the next burst instead.  ``arrivals``
    must be non-decreasing; the returned ``dispatch_at`` is always >=
    ``now`` and >= every member's arrival time.
    """
    n = len(arrivals)
    t0 = max(now, float(arrivals[start]))
    if not batchable[start] or max_size <= 1:
        return BurstDecision(start + 1, t0)
    close = t0 + deadline_ms if deadline_ms is not None else float("inf")
    j = start
    while j - start + 1 < max_size:
        k = j + 1
        if k >= n:  # stream end: nothing more can join
            return BurstDecision(j + 1, max(t0, float(arrivals[j])))
        joins = batchable[k] and phases[k] == phases[start]
        if joins and float(arrivals[k]) <= close:
            j = k
            continue
        if joins:  # next member misses the deadline: the timer fires
            return BurstDecision(j + 1, max(t0, close))
        # blocker (mutation / phase change): flush when it arrives or
        # when the deadline fires, whichever is earlier
        return BurstDecision(j + 1, max(t0, min(float(arrivals[k]), close)))
    return BurstDecision(j + 1, max(t0, float(arrivals[j])))


def backlog_depth(arrivals: np.ndarray, served: int, now: float) -> int:
    """Requests that have arrived by ``now`` but are not yet served
    (``served`` = stream position: queries dispatched so far).
    ``arrivals`` must be non-decreasing."""
    return max(int(np.searchsorted(arrivals, now, side="right")) - served, 0)


def recent_arrival_gap_ms(
    arrivals: np.ndarray, now: float, window: int = 16
) -> float:
    """Mean inter-arrival gap over the last ``window`` requests that
    have arrived by ``now`` -- the live arrival-rate estimate a real
    admission controller keeps (only past arrivals are read; the
    future of the stream is never peeked).  inf until two requests
    have arrived, and 0.0 on a simultaneous clump (rate is then
    effectively unbounded)."""
    j = int(np.searchsorted(arrivals, now, side="right"))
    if j < 2:
        return float("inf")
    i = max(j - 1 - window, 0)
    return float(arrivals[j - 1] - arrivals[i]) / (j - 1 - i)


def slo_pressure(
    depth: int,
    service_ms: float,
    slo_ms: Optional[float],
    headroom: float = 0.5,
    capacity_frac: float = 1.0,
) -> bool:
    """Load-aware throttle predicate: True when the estimated wait to
    drain the backlog (``depth`` requests at the measured per-query
    ``service_ms``) eats more than ``headroom`` of the SLO.  With no
    SLO, or before any service-time measurement, there is no pressure
    signal and the build lane runs free.

    ``capacity_frac`` is the degraded-mode hook: the fraction of
    serving capacity still up (``ReplicaSet.frac_up`` under replica
    outages).  Lost capacity shrinks the effective headroom
    proportionally, so the same backlog trips the urgent-drain
    throttle EARLIER while a replica is down -- the serving ladder
    reacts to the outage before the tail does.  At the default 1.0
    the predicate is bit-identical to the healthy one."""
    if slo_ms is None or service_ms <= 0.0:
        return False
    return depth * service_ms > headroom * capacity_frac * slo_ms

"""Open-loop SLO accounting for the serving front end.

The port's copy of ``repro.serving.slo`` (numpy only).

Closed-loop replay hides queueing delay: a slow query simply delays
the next submission, so per-query latency is pure service time.  Under
an open-loop arrival stream (Poisson, bursty) requests arrive whether
or not the server keeps up, and the user-visible latency is completion
minus *arrival* -- queue wait included.  The serving numbers that
matter are therefore the open-loop tail (p50/p99/p999) and the
deadline-miss rate against a latency SLO, sliced per workload phase
(a flash crowd's misses must not hide inside a calm phase's average).
This module turns a run's per-query open-loop latencies into that
report; the runner attaches it to ``RunResult.slo_report``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class SloSlice:
    """Latency digest of one slice (a phase, or the whole run)."""

    n: int
    p50_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float
    miss_rate: float  # fraction over the SLO (0.0 when no SLO is set)

    def summary(self) -> Dict[str, float]:
        return {
            "n": self.n,
            "p50_ms": round(self.p50_ms, 5),
            "p99_ms": round(self.p99_ms, 5),
            "p999_ms": round(self.p999_ms, 5),
            "mean_ms": round(self.mean_ms, 5),
            "miss_rate": round(self.miss_rate, 5),
        }


EMPTY_SLICE = SloSlice(0, 0.0, 0.0, 0.0, 0.0, 0.0)


def digest(
    latencies_ms: Sequence[float], slo_ms: Optional[float] = None
) -> SloSlice:
    """Percentile + miss-rate digest of one latency sample.  Empty
    samples digest to zeros (write-only phases must not crash
    reporting -- same contract as ``RunResult.percentile``)."""
    lat = np.asarray(latencies_ms, np.float64)
    if lat.size == 0:
        return EMPTY_SLICE
    p50, p99, p999 = np.percentile(lat, [50.0, 99.0, 99.9])
    miss = float(np.mean(lat > slo_ms)) if slo_ms else 0.0
    return SloSlice(
        int(lat.size),
        float(p50),
        float(p99),
        float(p999),
        float(lat.mean()),
        miss,
    )


@dataclass(frozen=True)
class SloReport:
    """Per-phase + overall open-loop latency/SLO report.

    The fault-injection fields default to the healthy run (full
    availability, zero downtime, nothing dropped), so fault-free
    reports are unchanged: ``availability`` is the fraction of offered
    statements that were served (dropped statements -- scans routed to
    a crashed replica with recovery off -- are the complement),
    ``downtime_ms`` the summed per-replica outage time on the
    simulated clock."""

    slo_ms: Optional[float]
    overall: SloSlice
    phases: Tuple[Tuple[int, SloSlice], ...]  # (phase_id, digest), sorted
    availability: float = 1.0
    downtime_ms: float = 0.0
    dropped: int = 0

    def phase(self, phase_id: int) -> SloSlice:
        for pid, s in self.phases:
            if pid == phase_id:
                return s
        return EMPTY_SLICE

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {"slo_ms": self.slo_ms}
        out.update(self.overall.summary())
        out["availability"] = round(self.availability, 6)
        out["downtime_ms"] = round(self.downtime_ms, 5)
        out["dropped"] = self.dropped
        out["phases"] = {pid: s.summary() for pid, s in self.phases}
        return out


def compute_slo(
    latencies_ms: Sequence[float],
    phases: Sequence[int],
    slo_ms: Optional[float] = None,
    availability: float = 1.0,
    downtime_ms: float = 0.0,
    dropped: int = 0,
) -> SloReport:
    """Build the per-phase SLO report from parallel latency/phase
    sequences (the runner's ``latencies_ms`` / ``phases``); the
    optional fault fields flow through verbatim."""
    lat = np.asarray(latencies_ms, np.float64)
    ph = np.asarray(phases, np.int64)
    if lat.shape != ph.shape:
        raise ValueError(
            f"latencies/phases length mismatch: {lat.shape} vs {ph.shape}"
        )
    per_phase = tuple(
        (int(p), digest(lat[ph == p], slo_ms))
        for p in sorted(set(ph.tolist()))
    )
    return SloReport(
        slo_ms,
        digest(lat, slo_ms),
        per_phase,
        availability=availability,
        downtime_ms=downtime_ms,
        dropped=dropped,
    )

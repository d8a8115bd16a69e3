"""Seeded fault schedules: the frozen description of a run's failures.

The port's copy of ``repro.faults.schedule`` (no JAX there; the port
imports nothing of the reference package), equal draw for draw.

A ``FaultSchedule`` is pure data -- outage epochs on the simulated
clock plus per-category fault rates -- and every decision derived from
it routes through ``unit_hash``: a keyed blake2b of (seed, category,
sequence number) mapped to [0, 1).  That makes fault injection

* deterministic per seed (the chaos harness replays a schedule and
  asserts bit-identical results),
* PYTHONHASHSEED-independent (no ``hash()``, no set/dict iteration),
* wall-time-free (nothing reads ``time``; the simulated clock is the
  only notion of "when").

Build-quantum failures target the async build lane
(``core.build_service``); the legacy serialized tuning path applies
quanta inline and is not fault-injected.  Replica outages require a
replica tier, which the port does not have yet -- the runner rejects a
schedule with outages on a single-engine run instead of silently
ignoring them, as the reference's does.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple


def unit_hash(seed: int, tag: str) -> float:
    """Deterministic uniform draw in [0, 1) for (seed, tag): a keyed
    blake2b digest, so per-category sequence tags ("scan:17:0") give
    independent, replayable decisions."""
    key = int(seed).to_bytes(8, "little", signed=True)
    h = hashlib.blake2b(tag.encode("utf-8"), digest_size=8, key=key)
    return int.from_bytes(h.digest(), "little") / 2.0**64


@dataclass(frozen=True)
class ReplicaOutage:
    """One replica crash epoch on the simulated clock: replica
    ``replica`` is DOWN on [down_ms, up_ms).  With recovery disabled
    the crash is permanent (``up_ms`` is ignored -- a dead replica
    never rejoins in the no-failover baseline)."""

    replica: int
    down_ms: float
    up_ms: float


@dataclass(frozen=True)
class FaultSchedule:
    """Everything that will go wrong in one run, as frozen data.

    ``scan_error_rate`` is the per-dispatch probability of a transient
    scan error; the engine retries the dispatch (each retry costs the
    dispatch's latency again, capped at ``scan_retries_max``
    consecutive errors).  ``straggler_rate`` is the per-dispatch
    probability of straggler latency: ``straggler_ms`` extra
    simulated milliseconds on that dispatch.  ``build_fail_rate`` is
    the per-attempt probability that applying a build quantum fails
    (the build lane retries with exponential backoff and quarantines
    quanta that keep failing).  All rates default to zero: the empty
    schedule injects nothing and is bit-identical to running without
    a schedule at all."""

    seed: int = 0
    outages: Tuple[ReplicaOutage, ...] = ()
    scan_error_rate: float = 0.0
    scan_retries_max: int = 3
    straggler_rate: float = 0.0
    straggler_ms: float = 0.25
    build_fail_rate: float = 0.0

    def is_zero_fault(self) -> bool:
        """True when this schedule can never inject anything."""
        return (
            not self.outages
            and self.scan_error_rate <= 0.0
            and self.straggler_rate <= 0.0
            and self.build_fail_rate <= 0.0
        )


def staggered_outages(
    n_replicas: int,
    horizon_ms: float,
    seed: int = 0,
    count: int | None = None,
    down_frac: float = 0.25,
) -> Tuple[ReplicaOutage, ...]:
    """``count`` disjoint outages round-robin over the replicas.

    The horizon is cut into equal slots; slot k hosts one outage of
    replica ``k % n_replicas`` with a hashed start jitter and a
    duration of at most ``down_frac`` of the slot, so at most ONE
    replica is ever down at a time -- the quorum-preserving schedule
    the chaos invariant tests use (an all-down instant is a separate,
    deliberately constructed case)."""
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if count is None:
        count = n_replicas
    if count <= 0 or horizon_ms <= 0.0:
        return ()
    slot = horizon_ms / count
    out = []
    for k in range(count):
        u0 = unit_hash(seed, f"outage-start:{k}")
        u1 = unit_hash(seed, f"outage-len:{k}")
        down_ms = k * slot + u0 * slot * (1.0 - down_frac)
        dur = slot * down_frac * (0.5 + 0.5 * u1)
        out.append(
            ReplicaOutage(
                replica=k % n_replicas,
                down_ms=down_ms,
                up_ms=min(down_ms + dur, (k + 1) * slot),
            )
        )
    return tuple(out)


def chaos_schedule(
    seed: int = 0,
    n_replicas: int = 1,
    horizon_ms: float = 0.0,
    intensity: float = 0.1,
    straggler_ms: float = 0.25,
) -> FaultSchedule:
    """Convenience generator: every fault category at ``intensity``,
    plus staggered replica outages when a replica tier and a clock
    horizon are given.  Deterministic per seed."""
    outages = ()
    if n_replicas > 1 and horizon_ms > 0.0:
        outages = staggered_outages(n_replicas, horizon_ms, seed=seed)
    return FaultSchedule(
        seed=seed,
        outages=outages,
        scan_error_rate=intensity,
        straggler_rate=intensity,
        straggler_ms=straggler_ms,
        build_fail_rate=intensity,
    )

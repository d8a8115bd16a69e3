"""Deterministic fault injection for the simulated-clock engine.

The port's copy of ``repro.faults``:

* ``schedule.py`` -- ``FaultSchedule``, a frozen, seeded description
  of every fault a run will experience (replica crash/rejoin epochs,
  transient scan errors, straggler dispatch latency, build-quantum
  failures), plus deterministic generators for building one.
* ``injector.py`` -- ``FaultInjector``, the runtime oracle the engine
  consults: "does this scan dispatch hit a transient error / a
  straggler", "does this build attempt fail" (and, for a replica
  tier, "is replica r down at clock t").  Every answer is a
  counter-based hash of (seed, category, sequence number): no wall
  time, no ``random`` module, no PYTHONHASHSEED dependence -- the same
  schedule replays the same faults bit for bit.

Faults perturb latency and build pacing only: MVCC visibility depends
on execution order, never on clock values, so with recovery on any
schedule yields query results equal to the fault-free run's, and a
zero-fault schedule equals running without one in every field.  The
port runs them on one engine; outages need a replica tier, which is
not ported yet, and a schedule with outages raises in ``run_workload``.
"""

from __future__ import annotations

from repro_torch.faults.injector import FaultInjector
from repro_torch.faults.schedule import (
    FaultSchedule,
    ReplicaOutage,
    chaos_schedule,
    staggered_outages,
    unit_hash,
)


class FaultError(RuntimeError):
    """Base class for typed fault-path errors."""


class ClusterUnavailable(FaultError):
    """Routing found zero eligible replicas: every replica is DOWN at
    once.  Raised instead of an opaque crash so serving layers can
    catch the condition by type."""


class ReplicaUnavailable(FaultError):
    """A statement was routed to a DOWN replica with recovery
    disabled (the no-failover baseline drops such statements)."""


__all__ = [
    "ClusterUnavailable",
    "FaultError",
    "FaultInjector",
    "FaultSchedule",
    "ReplicaOutage",
    "ReplicaUnavailable",
    "chaos_schedule",
    "staggered_outages",
    "unit_hash",
]

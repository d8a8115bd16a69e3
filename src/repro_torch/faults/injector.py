"""Runtime fault oracle: the engine's single point of fault truth.

The port's copy of ``repro.faults.injector``, equal draw for draw.

One ``FaultInjector`` wraps one ``FaultSchedule`` for one run.  The
executor consults it per scan dispatch (``scan_fault``), the build
service per quantum-apply attempt (``build_fault``), and the replica
tier per set-level operation (``replica_down``).  Each category keeps
its own monotone sequence counter, so decisions depend only on
(seed, category, how many decisions came before) -- the same workload
replays the same faults regardless of wall time or hash seed.

``recovery`` selects the failure semantics downstream machinery
applies (failover + catch-up replay + build retry when True; the
drop-and-stay-dead baseline when False); the injector itself only
answers "did a fault fire", plus the permanent-crash reading of
outages when recovery is off.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.faults.schedule import FaultSchedule, unit_hash


class FaultInjector:
    """Deterministic per-run fault decisions + telemetry counters."""

    def __init__(self, schedule: FaultSchedule, recovery: bool = True):
        self.schedule = schedule
        self.recovery = bool(recovery)
        self._scan_seq = 0
        self._build_seq = 0
        # telemetry (RunResult.fault_* fields)
        self.scan_retries = 0
        self.straggler_events = 0
        self.build_failures = 0

    # -- replica outages -------------------------------------------------
    def replica_down(self, replica: int, now_ms: float) -> bool:
        """Is ``replica`` inside one of its outage epochs at
        ``now_ms``?  With recovery off a crash is permanent: the
        rejoin edge is ignored and the replica stays down forever."""
        for o in self.schedule.outages:
            if o.replica != replica:
                continue
            if self.recovery:
                if o.down_ms <= now_ms < o.up_ms:
                    return True
            elif o.down_ms <= now_ms:
                return True
        return False

    # -- scan dispatch faults --------------------------------------------
    def scan_fault(self) -> Tuple[int, float]:
        """Fault draw for ONE scan dispatch: (transient retries,
        straggler extra ms).  Retries model consecutive transient
        errors -- the dispatch is re-issued, paying its latency again
        per retry; stragglers add flat extra latency.  Returns (0,
        0.0) without consuming a sequence number when both rates are
        zero, so a zero-fault schedule leaves the engine's arithmetic
        untouched bit for bit."""
        sch = self.schedule
        if sch.scan_error_rate <= 0.0 and sch.straggler_rate <= 0.0:
            return 0, 0.0
        seq = self._scan_seq
        self._scan_seq += 1
        retries = 0
        while (
            retries < sch.scan_retries_max
            and unit_hash(sch.seed, f"scan:{seq}:{retries}")
            < sch.scan_error_rate
        ):
            retries += 1
        extra = 0.0
        if unit_hash(sch.seed, f"straggler:{seq}") < sch.straggler_rate:
            extra = sch.straggler_ms
            self.straggler_events += 1
        self.scan_retries += retries
        return retries, extra

    # -- build-quantum faults --------------------------------------------
    def build_fault(self) -> bool:
        """Does THIS build-quantum apply attempt fail?  Consumes one
        build sequence number per attempt, so a retried quantum draws
        independently each attempt."""
        rate = self.schedule.build_fail_rate
        if rate <= 0.0:
            return False
        seq = self._build_seq
        self._build_seq += 1
        fails = unit_hash(self.schedule.seed, f"build:{seq}") < rate
        if fails:
            self.build_failures += 1
        return fails

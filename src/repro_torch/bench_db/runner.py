"""Workload runner: drives a tuner over a workload on a simulated clock.

Port of ``repro.bench_db.runner`` (the closed loop).

Timing model
------------
Latency is accounted in the engine's tuple-touch units converted at
``time_per_unit_ms``.  A query's latency is its execution cost plus
any in-query physical-design work its tuner performs.

Background tuning cycles fire on a simulated-time schedule (the FAST /
MOD / SLOW frequencies of Section V-B).  Cycle work is charged to the
cumulative execution time *unless* the system is inside an idle window
(phase starts can be configured to throttle the client, Figure 6), in
which case the work rides on idle resources for free.

Phase boundaries can optionally drop every ad-hoc index ("diurnal"
mode, Figure 6) -- tuner *models* survive drops.

Every field of ``RunResult`` but ``wall_s`` (a host clock around the
run) and ``execution_tiers`` (which tier served each query) is a
function of the simulated clock and the query results, so a run is
deterministic and equals the reference's run field for field, for
the predictive tuner and for every baseline of ``core.baselines``
(online, adaptive, SMIX, holistic, DIS).  The options whose slices are
not ported yet -- replicas, fault schedules,
the open loop (arrival streams, burst deadlines), the asynchronous
build lane and the device mesh -- raise ``NotImplementedError`` at the
top of ``run_workload``, before any state changes.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench_db.workloads import Workload
from repro_torch.core.executor import Database

TUNING_FREQ_MS = {"fast": 100.0, "mod": 1000.0, "slow": 10000.0, "dis": None}


@dataclass
class ExecOptions:
    """How queries execute: storage partitioning + dispatch shape."""

    # >1: submit consecutive read scans through Database.execute_batch.
    read_batch_size: int = 1
    # >1: partition tables round-robin by page.
    num_shards: int = 1
    # Device mesh (not ported yet): None and False run the single-card
    # dispatch; True, or mesh_query_axis > 1, raises.
    mesh: Optional[bool] = None
    mesh_query_axis: int = 1
    # Route batched scan dispatches through the CUDA kernels
    # (Database.execute_batch use_kernel); on CPU tensors their plain
    # versions run.
    use_kernel: bool = False


@dataclass
class TuningOptions:
    """When tuning cycles fire and how their build work is applied."""

    tuning_interval_ms: Optional[float] = 100.0  # None = disabled
    idle_at_phase_start_ms: float = 0.0          # throttled client window
    drop_indexes_at_phase_end: bool = False      # diurnal mode
    max_cycles_per_gap: int = 50                 # clamp catch-up storms
    # Asynchronous build lane (not ported yet): None keeps the
    # serialized schedule; 'deterministic' and 'overlap' raise.
    async_tuning: Optional[str] = None
    build_quantum_pages: int = 8
    build_queue_cap: int = 64
    # Shard-aware tuning: scans record per-shard page-access counters,
    # the tuner forecasts per-shard heat and sizes per-shard build
    # quanta by utility.  False keeps every path equal to the
    # single-shard engine for any shard count.
    shard_aware_tuning: bool = False
    # Coverage-bitmap tuning (core.index.PageCoverage): crack_on_scan
    # lets every scan adopt up to crack_pages_per_scan of the pages it
    # just table-scanned into a matching building VAP index, and
    # index_decay lets the tuner clear the coldest covered pages when
    # the built footprint exceeds its storage budget.
    crack_on_scan: bool = False
    crack_pages_per_scan: int = 8
    index_decay: bool = False
    # Overlap-mode cycle sizing (not ported yet, with the build lane).
    adaptive_build_budget: bool = False


@dataclass
class ServingOptions:
    """Open-loop serving front end and SLO machinery.

    Only ``arrival_ms`` (a closed-loop client cadence: a query faster
    than it leaves an idle gap that absorbs tuning work) is ported;
    an ``arrival_stream`` or a ``burst_deadline_ms`` selects the open
    loop, which raises.
    """

    arrival_ms: float = 0.0  # closed-loop client cadence (0 = none)
    arrival_stream: Optional[str] = None
    arrival_seed: int = 0
    arrival_peak_ratio: float = 8.0
    arrival_on_frac: float = 0.125
    arrival_tenants: int = 1
    burst_deadline_ms: Optional[float] = None
    slo_ms: Optional[float] = None
    slo_headroom: float = 0.5
    build_throttle: bool = False
    load_shed_tuning: bool = False
    build_throttle_patience: int = 3


@dataclass
class ReplicaOptions:
    """Replica tier (not ported yet): ``n_replicas > 1`` raises."""

    n_replicas: int = 1
    divergent_tuning: bool = False


@dataclass
class FaultOptions:
    """Deterministic fault injection (not ported yet): a
    ``fault_schedule`` raises."""

    fault_schedule: Optional[object] = None
    fault_recovery: bool = True
    fault_build_max_attempts: int = 4
    fault_build_backoff_ms: float = 4.0


class RunConfig:
    """Run configuration, grouped by concern.

    The supported surface is the five option groups::

        RunConfig(
            execution=ExecOptions(num_shards=4),
            tuning=TuningOptions(shard_aware_tuning=True),
        )

    plus the globally shared ``time_per_unit_ms``.  A flat kwarg
    (``RunConfig(num_shards=4)``) lands on the owning group and emits a
    ``DeprecationWarning``; flat attribute access (``cfg.num_shards``)
    reads and writes the owning group's field.
    """

    def __init__(
        self,
        execution: Optional[ExecOptions] = None,
        tuning: Optional[TuningOptions] = None,
        serving: Optional[ServingOptions] = None,
        replica: Optional[ReplicaOptions] = None,
        faults: Optional[FaultOptions] = None,
        time_per_unit_ms: float = 1e-4,
        **flat,
    ):
        self.execution = execution if execution is not None else ExecOptions()
        self.tuning = tuning if tuning is not None else TuningOptions()
        self.serving = serving if serving is not None else ServingOptions()
        self.replica = replica if replica is not None else ReplicaOptions()
        self.faults = faults if faults is not None else FaultOptions()
        self.time_per_unit_ms = time_per_unit_ms
        for name, value in flat.items():
            group = _FLAT_TO_GROUP.get(name)
            if group is None:
                raise TypeError(
                    f"RunConfig got an unexpected keyword argument {name!r}"
                )
            warnings.warn(
                f"flat RunConfig kwarg {name!r} is deprecated; use "
                f"RunConfig({group}={type(getattr(self, group)).__name__}"
                f"({name}=...))",
                DeprecationWarning,
                stacklevel=2,
            )
            setattr(getattr(self, group), name, value)

    def __repr__(self) -> str:
        return (
            f"RunConfig(execution={self.execution!r}, "
            f"tuning={self.tuning!r}, serving={self.serving!r}, "
            f"replica={self.replica!r}, faults={self.faults!r}, "
            f"time_per_unit_ms={self.time_per_unit_ms!r})"
        )


# group field name -> owning RunConfig attribute, derived from the
# dataclasses so the shim can never drift from the groups.
_FLAT_TO_GROUP: Dict[str, str] = {
    f.name: group
    for group, cls in (
        ("execution", ExecOptions),
        ("tuning", TuningOptions),
        ("serving", ServingOptions),
        ("replica", ReplicaOptions),
        ("faults", FaultOptions),
    )
    for f in fields(cls)
}


def _flat_alias(group: str, name: str) -> property:
    def get(self):
        return getattr(getattr(self, group), name)

    def set_(self, value):
        setattr(getattr(self, group), name, value)

    return property(get, set_)


for _name, _group in _FLAT_TO_GROUP.items():
    setattr(RunConfig, _name, _flat_alias(_group, _name))
del _name, _group


@dataclass
class RunResult:
    latencies_ms: List[float] = field(default_factory=list)
    phases: List[int] = field(default_factory=list)
    cumulative_ms: float = 0.0        # queries + charged tuner work
    tuner_work_units: float = 0.0
    tuner_charged_ms: float = 0.0
    tuner_overlapped_ms: float = 0.0  # build work on the concurrent lane
    wall_s: float = 0.0
    index_counts: List[int] = field(default_factory=list)
    built_fraction: List[float] = field(default_factory=list)
    # The fields below stay at their defaults in the closed loop
    # without a build lane, serving, replicas or faults; they keep the
    # reference's record shape.
    build_pages_per_ms: float = 0.0
    build_escalations: int = 0
    build_pages_per_cycle: int = 0
    slo_report: Optional[object] = None
    deadline_miss_rate: float = 0.0
    build_throttle_deferrals: int = 0
    build_shed_quanta: int = 0
    # execution tier -> queries served by it (ScanEngine.last_tier).
    execution_tiers: Dict[str, int] = field(default_factory=dict)
    replica_routing: List[int] = field(default_factory=list)
    # Per-statement (agg_sum, count, rows_modified) in served order.
    results: List[Tuple[int, int, int]] = field(default_factory=list)
    dropped_queries: int = 0
    availability: float = 1.0
    fault_downtime_ms: float = 0.0
    fault_scan_retries: int = 0
    fault_stragglers: int = 0
    fault_build_failures: int = 0
    fault_quarantined_builds: int = 0

    def percentile(self, p: float) -> float:
        """Latency percentile, 0.0 on empty runs."""
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(self.latencies_ms, p))

    @property
    def mean_latency_ms(self) -> float:
        return float(np.mean(self.latencies_ms)) if self.latencies_ms else 0.0

    @property
    def p99_latency_ms(self) -> float:
        return self.percentile(99)

    @property
    def p999_latency_ms(self) -> float:
        return self.percentile(99.9)

    def summary(self) -> Dict[str, float]:
        if self.slo_report is not None:
            return {
                "queries": len(self.latencies_ms),
                "mean_latency_ms": round(self.mean_latency_ms, 5),
                "p50_ms": round(self.percentile(50), 5),
                "p99_ms": round(self.p99_latency_ms, 5),
                "p999_ms": round(self.p999_latency_ms, 5),
                "deadline_miss_rate": round(self.deadline_miss_rate, 5),
                "tuner_charged_ms": round(self.tuner_charged_ms, 3),
                "tuner_overlapped_ms": round(self.tuner_overlapped_ms, 3),
                "build_throttle_deferrals": self.build_throttle_deferrals,
                "build_shed_quanta": self.build_shed_quanta,
                "wall_s": round(self.wall_s, 2),
            }
        return {
            "queries": len(self.latencies_ms),
            "cumulative_ms": round(self.cumulative_ms, 3),
            "mean_latency_ms": round(self.mean_latency_ms, 5),
            "p99_latency_ms": round(self.p99_latency_ms, 5),
            "tuner_work_units": round(self.tuner_work_units, 1),
            "tuner_charged_ms": round(self.tuner_charged_ms, 3),
            "tuner_overlapped_ms": round(self.tuner_overlapped_ms, 3),
            "build_pages_per_ms": round(self.build_pages_per_ms, 2),
            "build_escalations": self.build_escalations,
            "wall_s": round(self.wall_s, 2),
        }


def _check_ported(cfg: RunConfig) -> None:
    """Raise for an option whose slice is not ported yet."""
    missing = []
    if cfg.n_replicas > 1:
        missing.append("replicas (n_replicas > 1): core.replica")
    if cfg.fault_schedule is not None:
        missing.append("fault schedules: faults/")
    if cfg.arrival_stream is not None or cfg.burst_deadline_ms is not None:
        missing.append("the open loop (arrival_stream / burst_deadline_ms): "
                       "serving/")
    if cfg.async_tuning in ("deterministic", "overlap"):
        missing.append(f"async_tuning={cfg.async_tuning!r}: BuildService")
    elif cfg.async_tuning is not None:
        raise ValueError(f"async_tuning: {cfg.async_tuning!r}")
    if cfg.mesh or cfg.mesh_query_axis > 1:
        missing.append("the device mesh (mesh=True / mesh_query_axis > 1): "
                       "parallel/mesh")
    if missing:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(missing))


def run_workload(
    db: Database, tuner, workload: Workload, cfg: RunConfig
) -> RunResult:
    """Drive ``tuner`` over ``workload`` on the simulated clock (the
    closed-loop replay driver), on the database's device."""
    _check_ported(cfg)
    return _run_closed_loop(db, tuner, workload, cfg)


def _run_closed_loop(
    db: Database, tuner, workload: Workload, cfg: RunConfig
) -> RunResult:
    """Single-core closed-loop timing model.

    Background cycle work first consumes accumulated *idle credit*
    (arrival gaps + explicit phase-start throttle windows); any
    overflow is non-preemptible and BLOCKS the next query.
    """
    if cfg.num_shards != db.num_shards:
        db.reshard(cfg.num_shards)
    db.shard_aware_tuning = bool(cfg.shard_aware_tuning)
    db.crack_on_scan = bool(cfg.crack_on_scan)
    db.crack_pages_per_scan = int(cfg.crack_pages_per_scan)
    db.index_decay = bool(cfg.index_decay)

    res = RunResult()
    next_cycle_ms = (
        db.clock_ms + cfg.tuning_interval_ms
        if cfg.tuning_interval_ms
        else float("inf")
    )
    idle_until_ms = db.clock_ms + cfg.idle_at_phase_start_ms
    idle_credit_ms = cfg.idle_at_phase_start_ms
    blocking_ms = 0.0   # carried into the next query's latency
    prev_phase = 0

    def run_due_cycles():
        nonlocal next_cycle_ms, idle_credit_ms, blocking_ms
        if cfg.tuning_interval_ms is None:
            return
        fired = 0
        while db.clock_ms >= next_cycle_ms and fired < cfg.max_cycles_per_gap:
            idle = (db.clock_ms < idle_until_ms) or idle_credit_ms > 0.0
            work = tuner.tuning_cycle(idle=idle)
            work_ms = work * cfg.time_per_unit_ms
            res.tuner_work_units += work
            absorbed = min(idle_credit_ms, work_ms)
            idle_credit_ms -= absorbed
            charged = work_ms - absorbed
            res.tuner_charged_ms += charged
            blocking_ms += charged
            db.clock_ms += max(charged, 1e-9)
            next_cycle_ms += cfg.tuning_interval_ms
            fired += 1
        if db.clock_ms >= next_cycle_ms:  # drop missed slots
            missed = (db.clock_ms - next_cycle_ms) // cfg.tuning_interval_ms
            next_cycle_ms += (int(missed) + 1) * cfg.tuning_interval_ms

    def account(phase, q, stats):
        """Per-query bookkeeping shared by the single and batch paths."""
        nonlocal blocking_ms, idle_credit_ms
        extra_units = tuner.on_query(q, stats)
        extra_ms = extra_units * cfg.time_per_unit_ms
        db.clock_ms += extra_ms
        lat = stats.latency_ms + extra_ms + blocking_ms
        blocking_ms = 0.0
        res.latencies_ms.append(lat)
        res.phases.append(phase)
        res.cumulative_ms += lat
        res.results.append((stats.agg_sum, stats.count, stats.rows_modified))
        if stats.tier:
            res.execution_tiers[stats.tier] = (
                res.execution_tiers.get(stats.tier, 0) + 1
            )
        res.index_counts.append(len(db.indexes))
        fracs = [
            b.built_fraction(db.tables[b.desc.table])
            for b in db.indexes.values()
        ]
        res.built_fraction.append(float(np.mean(fracs)) if fracs else 0.0)
        if cfg.arrival_ms > 0.0 and lat < cfg.arrival_ms:
            gap = cfg.arrival_ms - lat
            db.clock_ms += gap
            idle_credit_ms += gap

    # Read bursts: consecutive batchable scans are staged and submitted
    # through the batched execution path in one dispatch.  Tuning
    # cycles fire at burst boundaries (the burst is one uninterruptible
    # unit of client work); mutations and phase changes flush the stage
    # first, preserving sequential semantics.
    batch_n = max(int(cfg.read_batch_size), 1)
    staged: List[Tuple[int, object]] = []

    def flush_burst():
        if not staged:
            return
        run_due_cycles()
        stats_list = db.execute_batch(
            [q for _, q in staged], use_kernel=cfg.use_kernel
        )
        for (ph, q), stats in zip(staged, stats_list):
            account(ph, q, stats)
        staged.clear()

    t_start = time.perf_counter()
    for phase, q in workload:
        if phase != prev_phase:
            flush_burst()
            if cfg.drop_indexes_at_phase_end:
                for name in list(db.indexes):
                    db.drop_index(name)
            idle_until_ms = db.clock_ms + cfg.idle_at_phase_start_ms
            idle_credit_ms += cfg.idle_at_phase_start_ms
            if cfg.idle_at_phase_start_ms > 0:
                # traverse the idle window so due cycles fire inside
                end = idle_until_ms
                while db.clock_ms < end and cfg.tuning_interval_ms:
                    db.clock_ms = min(end, max(next_cycle_ms, db.clock_ms))
                    run_due_cycles()
                    if next_cycle_ms > end:
                        break
                db.clock_ms = max(db.clock_ms, end)
            prev_phase = phase

        if batch_n > 1 and q.kind == "scan" and q.join_table is None:
            staged.append((phase, q))
            if len(staged) >= batch_n:
                flush_burst()
            continue

        flush_burst()
        run_due_cycles()
        stats = db.execute(q)
        account(phase, q, stats)
    flush_burst()
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
    res.wall_s = time.perf_counter() - t_start
    return res

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

The asynchronous build lane (``async_tuning`` "deterministic" and
"overlap", ``core.build_service.BuildService``), the open-loop serving
driver (``arrival_stream`` / ``burst_deadline_ms``: completion minus
arrival, the SLO report, the build throttle and load shedding), the
replica tier (``ReplicaOptions``: ``core.replica``, cost routing,
divergent tuning lanes) and fault schedules (replica outages with
failover and catch-up replay, transient scan errors, stragglers,
build-quantum failures with retry, backoff and quarantine) follow the
reference's code paths.

Every field of ``RunResult`` but ``wall_s`` (a host clock around the
run), ``execution_tiers`` (which tier served each query) and
``build_pages_per_ms`` (the build lane's measured throughput) is a
function of the simulated clock and the query results, so a run is
deterministic and equals the reference's run field for field, for
the predictive tuner and for every baseline of ``core.baselines``.
The reference's wall-clock inputs stay so here: the overlap lane's
escalated drains once its queue passes ``build_queue_cap``
(``build_escalations`` counts them) and ``adaptive_build_budget``; a
run that must replay bit for bit has ``build_escalations == 0`` and
leaves adaptive sizing off.  The options whose slice is not ported
yet -- the device mesh -- raise ``NotImplementedError`` at the top of
``run_workload``, before any state changes.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, fields, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bench_db.workloads import Workload
from repro_torch.core.build_service import BuildService
from repro_torch.core.executor import Database
from repro_torch.core.replica import ReplicaSet, ReplicaSetTuner
from repro_torch.faults import FaultInjector, FaultSchedule
from repro_torch.serving.admission import (
    backlog_depth,
    make_arrivals,
    next_burst,
    recent_arrival_gap_ms,
    slo_pressure,
)
from repro_torch.serving.slo import SloReport, compute_slo

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
    # Async tuning pipeline (core.build_service).  None keeps the
    # serialized schedule (tuning_cycle at burst boundaries).
    # "deterministic" routes every cycle through the decide/apply
    # split but drains all build quanta at the boundary: results and
    # accounting equal serialized, for any shard count.  "overlap"
    # drains quanta on a concurrent build lane between the burst's
    # batched dispatches: build work no longer blocks queries (it is
    # recorded as tuner_overlapped_ms), undrained quanta carry over to
    # the next burst.
    async_tuning: Optional[str] = None  # None | 'deterministic' | 'overlap'
    build_quantum_pages: int = 8        # overlap-mode slice size
    # Overlap-mode backpressure: queue depth above which the build
    # lane escalates drains (a wall-clock-shaped schedule).
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
    # Adaptive cycle sizing (overlap mode only): resize
    # TunerConfig.pages_per_cycle each cycle from the build lane's
    # measured throughput (BuildService.suggested_pages_per_cycle).
    # It reads the wall clock, so a run with it on does not replay.
    adaptive_build_budget: bool = False


@dataclass
class ServingOptions:
    """Open-loop serving front end (repro_torch.serving) + SLO machinery.

    Setting ``arrival_stream`` (or a burst deadline) switches
    run_workload into the open-loop driver: requests arrive on a
    seeded schedule ("uniform" | "poisson" | "bursty", mean
    inter-arrival = arrival_ms), read bursts close on read_batch_size
    OR burst_deadline_ms past the stage opening (whichever fires
    first), and recorded latency is completion minus ARRIVAL --
    queueing delay included.  With both unset, ``arrival_ms`` is a
    closed-loop client cadence: a query faster than it leaves an idle
    gap that absorbs tuning work.  idle_at_phase_start_ms is ignored
    open-loop: idleness comes from the stream.
    """

    arrival_ms: float = 0.0
    arrival_stream: Optional[str] = None
    arrival_seed: int = 0
    # Bursty stream shape: ON-state rate inflation, ON-state duty
    # cycle, and tenants > 1 superimposes that many independently
    # seeded streams (the aggregate keeps the mean).
    arrival_peak_ratio: float = 8.0
    arrival_on_frac: float = 0.125
    arrival_tenants: int = 1
    burst_deadline_ms: Optional[float] = None
    # Per-query latency SLO: feeds the deadline-miss report and, with
    # ``build_throttle``, the load-aware throttle -- build drains are
    # deferred while the backlog's estimated wait exceeds
    # ``slo_headroom`` of the SLO.  ``load_shed_tuning`` also sheds
    # the lowest-utility queued quanta down to build_queue_cap under
    # pressure (degrade tuning, never queries).
    slo_ms: Optional[float] = None
    slo_headroom: float = 0.5
    build_throttle: bool = False
    load_shed_tuning: bool = False
    # Anti-starvation bound: after this many consecutive deferred
    # drain boundaries the next drain is forced even under pressure.
    build_throttle_patience: int = 3


@dataclass
class ReplicaOptions:
    """Replica tier (``core.replica``).

    ``n_replicas > 1`` wraps the database and tuner in a
    ``ReplicaSet`` / ``ReplicaSetTuner`` on the database's device:
    data-equal replicas (each past 0 on its own copy of the tables),
    scans cost-routed to the cheapest, one tuning lane per replica,
    divergent when ``divergent_tuning``.  1 never wraps."""

    n_replicas: int = 1
    divergent_tuning: bool = False


@dataclass
class FaultOptions:
    """Deterministic fault injection (repro_torch.faults) + recovery.

    ``fault_schedule`` attaches a seeded ``FaultSchedule`` to the run:
    replica outages, transient scan errors, straggler dispatch latency
    and build-quantum failures.  Outages need a replica tier
    (``ReplicaOptions.n_replicas > 1``): on one engine a schedule with
    outages raises ``ValueError``.  ``fault_recovery`` on fails over
    (routing skips a DOWN replica, which replays its catch-up log at
    rejoin) and retries failed quanta with exponential backoff
    (``fault_build_backoff_ms * 2**attempt``, quarantine after
    ``fault_build_max_attempts`` failures); off, a crash is permanent,
    statements routed to the dead replica drop and failed quanta are
    discarded.  None injects nothing."""

    fault_schedule: Optional[FaultSchedule] = None
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
    # Build-lane telemetry: measured drain throughput (wall clock) and
    # how often backpressure escalated the drain frequency.
    build_pages_per_ms: float = 0.0
    build_escalations: int = 0
    # adaptive cycle sizing: pages_per_cycle after the final resize
    build_pages_per_cycle: int = 0
    # Open-loop telemetry: latencies_ms are completion-minus-arrival
    # there, and the SLO report slices them per phase.
    slo_report: Optional[SloReport] = None
    deadline_miss_rate: float = 0.0
    build_throttle_deferrals: int = 0   # drains deferred under pressure
    build_shed_quanta: int = 0          # quanta dropped by load shedding
    # execution tier -> queries served by it (ScanEngine.last_tier).
    execution_tiers: Dict[str, int] = field(default_factory=dict)
    # Replica routing: the replica id that served each routed scan /
    # read burst, in order (empty without a replica tier).
    replica_routing: List[int] = field(default_factory=list)
    # Per-statement (agg_sum, count, rows_modified) in served order:
    # a fault schedule with recovery on reproduces the fault-free
    # run's list (latency may shift, results never).
    results: List[Tuple[int, int, int]] = field(default_factory=list)
    # Fault telemetry: served fraction of offered statements, outage
    # time (replica tier only) and the injector's event counters.
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
    """Raise for an option whose slice is not ported yet, and for an
    unknown async mode."""
    if cfg.async_tuning not in (None, "deterministic", "overlap"):
        raise ValueError(f"async_tuning: {cfg.async_tuning!r}")
    if cfg.mesh or cfg.mesh_query_axis > 1:
        raise NotImplementedError(
            "not ported yet: the device mesh (mesh=True / "
            "mesh_query_axis > 1): parallel/mesh")


def run_workload(
    db: Database, tuner, workload: Workload, cfg: RunConfig
) -> RunResult:
    """Drive ``tuner`` over ``workload`` on the simulated clock, on the
    database's device: the closed-loop replay driver, or (when an
    arrival stream / burst deadline is configured) the open-loop
    serving driver.  With ``cfg.replica.n_replicas > 1`` the database
    and tuner are first wrapped in the replica tier (``core.replica``);
    1 never wraps.  A fault schedule attaches a ``FaultInjector`` (to
    every replica); its counters land in the result."""
    _check_ported(cfg)
    schedule = cfg.faults.fault_schedule
    if (schedule is not None and schedule.outages
            and cfg.replica.n_replicas <= 1):
        raise ValueError(
            "FaultSchedule.outages require a replica tier "
            "(ReplicaOptions.n_replicas > 1): a single engine has "
            "nothing to fail over to"
        )
    rs: Optional[ReplicaSet] = None
    if cfg.replica.n_replicas > 1:
        # Reshard BEFORE cloning so that every replica adopts the
        # target layout (the drivers' own reshard check then no-ops).
        if cfg.num_shards != db.num_shards:
            db.reshard(cfg.num_shards)
        rs = ReplicaSet(db, cfg.replica.n_replicas,
                        divergent=cfg.replica.divergent_tuning)
        tuner = ReplicaSetTuner(rs, tuner)
        db = rs
    injector: Optional[FaultInjector] = None
    if schedule is not None:
        injector = FaultInjector(
            schedule, recovery=cfg.faults.fault_recovery
        )
        db.fault_injector = injector  # fans out across replicas
    if cfg.arrival_stream is not None or cfg.burst_deadline_ms is not None:
        res = _run_open_loop(db, tuner, workload, cfg)
    else:
        res = _run_closed_loop(db, tuner, workload, cfg)
    if rs is not None:
        res.replica_routing = list(rs.routed_queries)
    if injector is not None:
        res.fault_scan_retries = injector.scan_retries
        res.fault_stragglers = injector.straggler_events
        res.fault_build_failures = injector.build_failures
        if rs is not None:
            res.fault_downtime_ms = float(sum(rs.downtime_ms))
        offered = len(res.latencies_ms) + res.dropped_queries
        res.availability = (
            len(res.latencies_ms) / offered if offered else 1.0
        )
        if res.slo_report is not None:
            res.slo_report = replace(
                res.slo_report,
                availability=res.availability,
                downtime_ms=res.fault_downtime_ms,
                dropped=res.dropped_queries,
            )
    return res


def _prepare(db: Database, tuner, cfg: RunConfig):
    """Shared set-up of both drivers: the layout, the tuning flags and
    the build service (None without an async mode)."""
    if cfg.num_shards != db.num_shards:
        db.reshard(cfg.num_shards)
    db.shard_aware_tuning = bool(cfg.shard_aware_tuning)
    db.crack_on_scan = bool(cfg.crack_on_scan)
    db.crack_pages_per_scan = int(cfg.crack_pages_per_scan)
    db.index_decay = bool(cfg.index_decay)
    if cfg.async_tuning is None:
        return None
    overlap = cfg.async_tuning == "overlap"
    # Deterministic mode keeps the serialized quantum slices; overlap
    # sub-slices them so the engine can drain fine-grained quanta
    # between burst dispatches.
    return BuildService(
        db,
        tuner,
        quantum_pages=cfg.build_quantum_pages if overlap else None,
        max_queue_depth=cfg.build_queue_cap if overlap else None,
        injector=db.fault_injector,
        max_attempts=cfg.fault_build_max_attempts,
        backoff_ms=cfg.fault_build_backoff_ms,
    )


def _overlap_drainer(service: BuildService, res: RunResult,
                     cfg: RunConfig):
    """One drain opportunity on the concurrent build lane (the
    engine's between-dispatch hook): applies ``drain_burst_size()``
    quanta; their work is recorded but never enters the blocking path.
    Returns the drained work-ms."""

    def overlap_quantum() -> float:
        total_ms = 0.0
        for _ in range(service.drain_burst_size()):
            units = service.apply_next()
            if units <= 0.0:
                continue
            u_ms = units * cfg.time_per_unit_ms
            res.tuner_work_units += units
            res.tuner_overlapped_ms += u_ms
            total_ms += u_ms
        return total_ms

    return overlap_quantum


def _record_service(res: RunResult, service: Optional[BuildService]) -> None:
    if service is not None:
        res.build_pages_per_ms = service.pages_per_ms
        res.build_escalations = service.escalations
        res.fault_quarantined_builds = len(service.quarantined)


def _finish_wall(db: Database, res: RunResult, t_start: float) -> None:
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
    res.wall_s = time.perf_counter() - t_start


def _run_closed_loop(
    db: Database, tuner, workload: Workload, cfg: RunConfig
) -> RunResult:
    """Single-core closed-loop timing model.

    Background cycle work first consumes accumulated *idle credit*
    (arrival gaps + explicit phase-start throttle windows); any
    overflow is non-preemptible and BLOCKS the next query.
    """
    service = _prepare(db, tuner, cfg)
    overlap = cfg.async_tuning == "overlap"

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

    # Adaptive cycle sizing: only the overlap lane measures real drain
    # throughput, and only its schedule may depend on the wall clock.
    adaptive = overlap and cfg.adaptive_build_budget and hasattr(tuner, "cfg")

    def resize_cycle_budget() -> None:
        """Feed the lane's measured throughput (pages/ms) back into
        TunerConfig.pages_per_cycle, clamped to [1,
        max_build_pages_per_cycle]."""
        pages = service.suggested_pages_per_cycle()
        if pages is None:
            return
        cap = tuner.cfg.max_build_pages_per_cycle
        tuner.cfg.pages_per_cycle = min(max(pages, 1), cap)
        res.build_pages_per_cycle = tuner.cfg.pages_per_cycle

    def run_cycle(idle: bool) -> float:
        """One due tuning cycle's *synchronous* work units."""
        if service is None:
            return tuner.tuning_cycle(idle=idle)
        if cfg.async_tuning == "deterministic":
            # Decide, then drain the whole queue at the boundary: the
            # serialized schedule through the split pipeline.
            return service.decide(idle=idle) + service.drain()
        if adaptive:
            resize_cycle_budget()
        return service.decide(idle=idle)  # overlap: quanta drain in-burst

    overlap_quantum = (_overlap_drainer(service, res, cfg) if overlap
                       else None)

    def run_due_cycles():
        nonlocal next_cycle_ms, idle_credit_ms, blocking_ms
        if cfg.tuning_interval_ms is None:
            return
        fired = 0
        while db.clock_ms >= next_cycle_ms and fired < cfg.max_cycles_per_gap:
            idle = (db.clock_ms < idle_until_ms) or idle_credit_ms > 0.0
            work = run_cycle(idle)
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
        if overlap:
            # Idle windows feed the concurrent build lane too: drain
            # carryover quanta against the idle credit.
            while idle_credit_ms > 0.0 and service.pending():
                idle_credit_ms = max(idle_credit_ms - overlap_quantum(), 0.0)

    def account(phase, q, stats):
        """Per-query bookkeeping shared by the single and batch paths."""
        nonlocal blocking_ms, idle_credit_ms
        if stats is None:
            # A dropped statement (recovery off, routed to a dead
            # replica): only the drop counts; pending blocking work
            # carries to the next served query.
            res.dropped_queries += 1
            return
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
    if overlap:
        db.engine.after_dispatch = overlap_quantum
    try:
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
                        db.clock_ms = min(end, max(next_cycle_ms,
                                                   db.clock_ms))
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
    finally:
        if overlap:
            db.engine.after_dispatch = None
    _record_service(res, service)
    _finish_wall(db, res, t_start)
    return res


def _run_open_loop(
    db: Database, tuner, workload: Workload, cfg: RunConfig
) -> RunResult:
    """Open-loop serving driver (arrival-stream mode).

    Requests arrive on a seeded schedule (``serving.admission``).  The
    admission layer forms read bursts dynamically -- close on
    ``read_batch_size`` OR ``burst_deadline_ms`` past the stage
    opening; mutations and phase changes flush the stage as in the
    closed loop -- and each burst goes through
    ``Database.execute_batch``.  Recorded latency is completion minus
    ARRIVAL: charged tuning work advances the clock and so delays
    every queued request.

    Graceful degradation: with ``build_throttle`` the deterministic
    lane's boundary drains shrink to the urgent share while the
    backlog's estimated wait exceeds ``slo_headroom`` of the SLO (the
    patience bound forces a full drain after too many deferrals); in
    overlap mode the concurrent lane is paused instead.
    ``load_shed_tuning`` drops the lowest-utility queued quanta down
    to ``build_queue_cap`` under pressure.  Queries are never dropped.
    """
    service = _prepare(db, tuner, cfg)
    overlap = cfg.async_tuning == "overlap"

    items = list(workload)
    n = len(items)
    arrivals = db.clock_ms + make_arrivals(
        cfg.arrival_stream or "uniform",
        n,
        cfg.arrival_ms,
        seed=cfg.arrival_seed,
        peak_ratio=cfg.arrival_peak_ratio,
        on_frac=cfg.arrival_on_frac,
        tenants=cfg.arrival_tenants,
    )
    batch_n = max(int(cfg.read_batch_size), 1)
    batchable = np.array(
        [
            q.kind == "scan" and q.join_table is None and batch_n > 1
            for _, q in items
        ],
        bool,
    )
    phase_arr = np.array([p for p, _ in items], np.int64)

    res = RunResult()
    next_cycle_ms = (
        db.clock_ms + cfg.tuning_interval_ms
        if cfg.tuning_interval_ms
        else float("inf")
    )
    idle_credit_ms = 0.0
    served = 0                 # stream position: queries dispatched
    staged_end = 0             # end of the burst currently being formed
    ewma_service_ms = 0.0      # measured per-query service latency
    defer_streak = 0           # consecutive throttled drain boundaries
    prev_phase = 0

    def pressured() -> bool:
        # Overload = arrived requests that will STILL be queued after
        # the staged burst dispatches (one batch in flight is the
        # steady state, not a backlog).
        depth = backlog_depth(arrivals, max(served, staged_end), db.clock_ms)
        # Degraded mode: a lost replica shrinks serving capacity, so
        # the same backlog trips the throttle earlier (1.0 -- a plain
        # engine or a healthy set -- changes nothing).
        frac_up = getattr(db, "frac_up", None)
        return slo_pressure(
            depth, ewma_service_ms, cfg.slo_ms, cfg.slo_headroom,
            capacity_frac=frac_up() if frac_up is not None else 1.0)

    def defer_ok() -> bool:
        # Deferring build work is safe only when the backlog is
        # transient: the measured service time keeps up with the
        # measured arrival rate.  Underwater, the stale physical
        # design IS the problem -- build through the storm.
        gap = recent_arrival_gap_ms(arrivals, db.clock_ms)
        return ewma_service_ms <= gap

    def shed_if_over_cap() -> None:
        if cfg.load_shed_tuning and service.pending() > cfg.build_queue_cap:
            res.build_shed_quanta += service.shed_lowest_utility(
                cfg.build_queue_cap
            )

    def run_cycle(idle: bool) -> float:
        nonlocal defer_streak
        if service is None:
            return tuner.tuning_cycle(idle=idle)
        work = service.decide(idle=idle)
        if overlap:
            return work        # quanta drain on the concurrent lane
        # Deterministic lane: under backlog pressure only the URGENT
        # share drains at the boundary (the hot index a storm is
        # full-scanning builds through it); speculative quanta wait
        # for an idle gap.  The patience bound forces a full drain
        # after too many deferred boundaries, and an unsustainable
        # storm sheds the lowest-utility quanta past the cap.
        if (
            cfg.build_throttle
            and service.pending() > 0
            and pressured()
            and defer_streak < cfg.build_throttle_patience
        ):
            defer_streak += 1
            res.build_throttle_deferrals += 1
            work += service.drain_urgent()
            if not defer_ok():
                shed_if_over_cap()
            return work
        defer_streak = 0
        return work + service.drain()

    overlap_quantum = (_overlap_drainer(service, res, cfg) if overlap
                       else None)

    def run_due_cycles() -> None:
        nonlocal next_cycle_ms, idle_credit_ms
        if cfg.tuning_interval_ms is None:
            return
        fired = 0
        while db.clock_ms >= next_cycle_ms and fired < cfg.max_cycles_per_gap:
            work = run_cycle(idle_credit_ms > 0.0)
            work_ms = work * cfg.time_per_unit_ms
            res.tuner_work_units += work
            absorbed = min(idle_credit_ms, work_ms)
            idle_credit_ms -= absorbed
            charged = work_ms - absorbed
            res.tuner_charged_ms += charged
            db.clock_ms += max(charged, 1e-9)
            next_cycle_ms += cfg.tuning_interval_ms
            fired += 1
        if db.clock_ms >= next_cycle_ms:  # drop missed slots
            missed = (db.clock_ms - next_cycle_ms) // cfg.tuning_interval_ms
            next_cycle_ms += (int(missed) + 1) * cfg.tuning_interval_ms
        if overlap:
            # idle gaps feed the concurrent lane (carryover quanta
            # ride the credit) -- but not while the throttle holds it
            while idle_credit_ms > 0.0 and service.pending():
                if cfg.build_throttle and pressured():
                    break
                drained = overlap_quantum()
                if drained <= 0.0:
                    break
                idle_credit_ms = max(idle_credit_ms - drained, 0.0)

    def advance_to(target_ms: float) -> None:
        """Idle the server up to ``target_ms`` (waiting for arrivals or
        the burst timer): the gap accrues idle credit and due tuning
        cycles fire inside it."""
        nonlocal idle_credit_ms
        gap = target_ms - db.clock_ms
        if gap <= 0.0:
            return
        idle_credit_ms += gap
        if cfg.tuning_interval_ms is not None:
            while next_cycle_ms <= target_ms:
                db.clock_ms = max(db.clock_ms, next_cycle_ms)
                run_due_cycles()
                if db.clock_ms >= target_ms:
                    break
        db.clock_ms = max(db.clock_ms, target_ms)

    def account_open(ph: int, stats, arrival: float,
                     completion: float) -> None:
        lat = completion - arrival
        res.latencies_ms.append(lat)
        res.phases.append(ph)
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

    t_start = time.perf_counter()
    if overlap:
        db.engine.after_dispatch = overlap_quantum
    try:
        while served < n:
            start = served
            ph = int(phase_arr[start])
            if ph != prev_phase:
                if cfg.drop_indexes_at_phase_end:
                    for name in list(db.indexes):
                        db.drop_index(name)
                prev_phase = ph
            d = next_burst(
                arrivals,
                batchable,
                phase_arr,
                start,
                db.clock_ms,
                batch_n,
                cfg.burst_deadline_ms,
            )
            staged_end = d.end
            advance_to(d.dispatch_at)
            run_due_cycles()
            # Idle credit expires at dispatch: past idle time cannot
            # absorb future work, so cycles that fire during a backlog
            # are CHARGED -- the pressure the throttle relieves.
            idle_credit_ms = 0.0
            if overlap and cfg.build_throttle:
                # The deterministic lane's patience bound, for the
                # concurrent lane's pause.
                was_paused = service.paused
                service.paused = (
                    pressured()
                    and defer_ok()
                    and defer_streak < cfg.build_throttle_patience
                )
                if service.paused:
                    defer_streak += 1
                    if not was_paused:
                        res.build_throttle_deferrals += 1
                    shed_if_over_cap()
                else:
                    defer_streak = 0
            burst = items[start:d.end]
            base = db.clock_ms
            if len(burst) == 1 and not batchable[start]:
                stats_list = [db.execute(burst[0][1])]
            else:
                stats_list = db.execute_batch(
                    [q for _, q in burst], use_kernel=cfg.use_kernel
                )
            cum = 0.0
            for k, ((bph, q), stats) in enumerate(zip(burst, stats_list)):
                if stats is None:
                    # A dropped statement (recovery off): no service
                    # time, no latency sample, only the availability hit.
                    res.dropped_queries += 1
                    continue
                extra_units = tuner.on_query(q, stats)
                extra_ms = extra_units * cfg.time_per_unit_ms
                db.clock_ms += extra_ms
                service_ms = stats.latency_ms + extra_ms
                cum += service_ms
                a = 0.25
                ewma_service_ms = (
                    service_ms
                    if ewma_service_ms == 0.0
                    else (1.0 - a) * ewma_service_ms + a * service_ms
                )
                account_open(bph, stats, float(arrivals[start + k]),
                             base + cum)
            served = d.end
    finally:
        if overlap:
            db.engine.after_dispatch = None
    _record_service(res, service)
    if service is not None:
        res.build_shed_quanta = service.shed_quanta
    res.slo_report = compute_slo(res.latencies_ms, res.phases, cfg.slo_ms)
    res.deadline_miss_rate = res.slo_report.overall.miss_rate
    _finish_wall(db, res, t_start)
    return res

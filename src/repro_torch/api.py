"""Public facade of the PyTorch port.

    from repro_torch.api import Database, RunConfig, run_workload

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device named they raise.
"""

from __future__ import annotations

from repro_torch.bench_db.queries import QueryGen
from repro_torch.bench_db.runner import (
    TUNING_FREQ_MS,
    ExecOptions,
    FaultOptions,
    ReplicaOptions,
    RunConfig,
    RunResult,
    ServingOptions,
    TuningOptions,
    run_workload,
)
from repro_torch.bench_db.schema import TunerDB, make_tuner_db
from repro_torch.bench_db.workloads import (
    Workload,
    affinity_workload,
    hybrid_workload,
    segments_workload,
    shifting_workload,
)
from repro_torch.core.baselines import (
    AdaptiveTuner,
    DisabledTuner,
    HolisticTuner,
    OnlineTuner,
    SmixTuner,
)
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.executor import Database, ExecStats, Query
from repro_torch.core.index import (
    PageCoverage,
    ShardedIndex,
    eligible_global_pages,
)
from repro_torch.core.replica import ReplicaSet, ReplicaSetTuner
from repro_torch.core.table import (
    ShardedTable,
    Table,
    shard_table,
    stack_shards,
    unshard_table,
)
from repro_torch.core.tuner import PredictiveTuner, TunerConfig, make_dl_tuner
from repro_torch.faults import (
    ClusterUnavailable,
    FaultError,
    FaultInjector,
    FaultSchedule,
    ReplicaOutage,
    ReplicaUnavailable,
    chaos_schedule,
    staggered_outages,
)
from repro_torch.parallel.mesh import (
    ScanMesh,
    force_local_devices,
    make_scan_mesh,
)
from repro_torch.serving.prefix_cache import PredictivePrefixCache
from repro_torch.serving.scheduler import BatchScheduler, Request
from repro_torch.serving.slo import SloReport

__all__ = [
    "TUNING_FREQ_MS",
    "AdaptiveTuner",
    "BatchScheduler",
    "ClusterUnavailable",
    "Database",
    "DisabledTuner",
    "ExecOptions",
    "ExecStats",
    "FaultError",
    "FaultInjector",
    "FaultOptions",
    "FaultSchedule",
    "HolisticTuner",
    "IndexDescriptor",
    "OnlineTuner",
    "PageCoverage",
    "PredictivePrefixCache",
    "PredictiveTuner",
    "Query",
    "QueryGen",
    "ReplicaOptions",
    "ReplicaOutage",
    "ReplicaSet",
    "ReplicaSetTuner",
    "ReplicaUnavailable",
    "Request",
    "RunConfig",
    "RunResult",
    "ScanMesh",
    "ServingOptions",
    "ShardedIndex",
    "ShardedTable",
    "SloReport",
    "SmixTuner",
    "Table",
    "TunerConfig",
    "TunerDB",
    "TuningOptions",
    "Workload",
    "affinity_workload",
    "chaos_schedule",
    "eligible_global_pages",
    "force_local_devices",
    "hybrid_workload",
    "make_dl_tuner",
    "make_scan_mesh",
    "make_tuner_db",
    "run_workload",
    "segments_workload",
    "shard_table",
    "shifting_workload",
    "stack_shards",
    "staggered_outages",
    "unshard_table",
]

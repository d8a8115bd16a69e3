"""TUNER benchmark schema, query templates, workload generators and
the closed-loop runner (paper Section V), with the reference's numpy
RNG streams."""
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
    MIXTURES,
    Workload,
    affinity_workload,
    hybrid_workload,
    segments_workload,
    shifting_workload,
)

__all__ = ["MIXTURES", "TUNING_FREQ_MS", "ExecOptions", "FaultOptions",
           "QueryGen", "ReplicaOptions", "RunConfig", "RunResult",
           "ServingOptions", "TunerDB", "TuningOptions", "Workload",
           "affinity_workload", "hybrid_workload", "make_tuner_db",
           "run_workload", "segments_workload", "shifting_workload"]

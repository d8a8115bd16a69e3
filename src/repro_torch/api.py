"""Public facade of the PyTorch port.

    from repro_torch.api import Database, PredictiveTuner, make_tuner_db

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device named they raise.
"""

from __future__ import annotations

from repro_torch.bench_db.queries import QueryGen
from repro_torch.bench_db.schema import TunerDB, make_tuner_db
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.executor import Database, ExecStats, Query
from repro_torch.core.index import (
    PageCoverage,
    ShardedIndex,
    eligible_global_pages,
)
from repro_torch.core.table import (
    ShardedTable,
    Table,
    shard_table,
    stack_shards,
    unshard_table,
)
from repro_torch.core.tuner import PredictiveTuner, TunerConfig

__all__ = [
    "Database",
    "ExecStats",
    "IndexDescriptor",
    "PageCoverage",
    "PredictiveTuner",
    "Query",
    "QueryGen",
    "ShardedIndex",
    "ShardedTable",
    "Table",
    "TunerConfig",
    "TunerDB",
    "eligible_global_pages",
    "make_tuner_db",
    "shard_table",
    "stack_shards",
    "unshard_table",
]

"""Baseline indexing approaches on the same substrate (paper Section VI).

Port of ``repro.core.baselines``.  Every tuner exposes the two hooks
the workload runner drives:

  on_query(q, stats) -> float    in-query physical-design work units
                                 (charged to the query's latency)
  tuning_cycle(idle) -> float    background work units

Only ``DisabledTuner`` (DIS, the no-tuning arm of Figure 10) is ported;
the online, adaptive, self-managing and holistic tuners come with VBP
indexes.
"""
from __future__ import annotations

from repro_torch.core.executor import Database, ExecStats, Query
from repro_torch.core.tuner import TunerConfig


class DisabledTuner:
    """DIS baseline: no tuning at all."""

    name = "disabled"

    def __init__(self, db: Database, config: TunerConfig | None = None):
        self.db = db

    def on_query(self, q: Query, stats: ExecStats) -> float:
        return 0.0

    def tuning_cycle(self, idle: bool = False) -> float:
        return 0.0

"""Serving substrate: the request scheduler (``scheduler.py``), the
predictively managed prefix cache (``prefix_cache.py``: the paper's
index tuner applied to KV-cache management), and the open-loop front
end -- arrival streams, SLO-deadline burst admission and load-shed
backpressure (``admission.py``) plus the per-phase p50 / p99 / p999 +
deadline-miss reporter (``slo.py``)."""
from repro_torch.serving.admission import (
    BurstDecision,
    backlog_depth,
    make_arrivals,
    next_burst,
    slo_pressure,
)
from repro_torch.serving.prefix_cache import PredictivePrefixCache
from repro_torch.serving.scheduler import BatchScheduler, Request
from repro_torch.serving.slo import SloReport, SloSlice, compute_slo

__all__ = [
    "BatchScheduler",
    "BurstDecision",
    "PredictivePrefixCache",
    "Request",
    "SloReport",
    "SloSlice",
    "backlog_depth",
    "compute_slo",
    "make_arrivals",
    "next_burst",
    "slo_pressure",
]

"""The open-loop serving front end: arrival streams, SLO-deadline
burst admission and load-shed backpressure (``admission.py``), and the
per-phase p50 / p99 / p999 + deadline-miss reporter (``slo.py``).

The reference's ``serving`` package also holds the LM stack's request
scheduler and prefix cache; the port has not reached the LM stack."""
from repro_torch.serving.admission import (
    BurstDecision,
    backlog_depth,
    make_arrivals,
    next_burst,
    slo_pressure,
)
from repro_torch.serving.slo import SloReport, SloSlice, compute_slo

__all__ = [
    "BurstDecision",
    "SloReport",
    "SloSlice",
    "backlog_depth",
    "compute_slo",
    "make_arrivals",
    "next_burst",
    "slo_pressure",
]

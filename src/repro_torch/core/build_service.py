"""Build quanta: the decide/apply split over incremental VAP builds.

Port of the serialized part of ``repro.core.build_service``.
``PredictiveTuner.decide`` returns a ``CyclePlan`` whose build work is
an ordered list of ``BuildQuantum`` records; ``apply_quantum`` applies
one against the live catalog.  Applying a cycle's quanta in order does
exactly the work of the monolithic tuning cycle.  The asynchronous
``BuildService`` lane (overlap mode, backpressure, retries) is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class BuildQuantum:
    """One interleavable slice of index-build work."""

    index_name: str
    pages: int
    # None = advance the global prefix (round-robin over shards on
    # sharded storage); an int targets that shard's local prefix.
    shard: Optional[int] = None
    # Forecast utility of the owning index at decide time.
    utility: float = 0.0
    # Explicit global page ids for bitmap-mode (coverage) indexes:
    # hot-range-first scheduling.  Empty = build the lowest uncovered
    # pages (coverage) or advance the prefix (legacy).  ``pages`` is
    # the slice budget either way (== len(page_list) when present).
    page_list: tuple = ()


@dataclass
class CyclePlan:
    """Output of a tuner's decide step: pending build work + the work
    units the decision stages themselves consumed."""

    quanta: List[BuildQuantum] = field(default_factory=list)
    decide_work: float = 0.0


def apply_quantum(db, quantum: BuildQuantum) -> float:
    """Apply one build quantum against the live catalog; returns work
    units.  Skips (0.0) when the index was dropped or finished since
    the quantum was planned."""
    bi = db.indexes.get(quantum.index_name)
    if bi is None or not bi.building or bi.scheme not in ("vap", "full"):
        return 0.0
    return db.vap_build_step(bi, quantum.pages, shard=quantum.shard,
                             page_list=quantum.page_list or None)

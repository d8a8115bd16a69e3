"""Lightweight workload monitor (paper Sections IV-A / IV-B).

Tracks per-query metadata in a bounded ring buffer: statement kind,
referenced table, predicate attribute sets (equal/range/join), GROUP
BY / ORDER BY attributes, measured tuples scanned, rows modified, and
whether an index served the access path.  Snapshots over the last
``window`` queries provide (a) the three classifier features and
(b) the per-attribute-set access statistics that drive candidate
index enumeration.
"""

from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Iterable, Tuple

import numpy as np

AttrSet = Tuple[int, ...]


@dataclass(frozen=True)
class QueryRecord:
    """One executed statement, as seen by the monitor."""

    kind: str  # 'scan' | 'update' | 'insert'
    table: str
    pred_attrs: AttrSet  # attributes in WHERE predicates (ordered)
    accessed_attrs: AttrSet = ()  # predicates + projection + aggregate
    selectivity: float = 0.0  # measured match fraction (scans/updates)
    tuples_scanned: int = 0  # measured rows touched by the access path
    used_index: bool = False  # True if an index served the access path
    rows_modified: int = 0  # for mutators
    ts_ms: float = 0.0  # simulated wall clock
    template: str = ""  # benchmark template id (diagnostics only)
    # Pages this statement scanned per shard (shard-aware tuning only;
    # () on unsharded/legacy runs).
    shard_pages: Tuple[int, ...] = ()
    # (attr, lo, hi) per range predicate -- the hot-range build
    # scheduler's value signal (zone maps map these to pages).
    pred_ranges: Tuple = ()


@dataclass
class WorkloadMonitor:
    """Ring buffer + derived statistics.

    The window is bounded by count AND (optionally) by age: a
    time-based horizon means the window drains during idle periods, so
    purely retrospective decision logic goes blind after a quiet gap
    -- which is precisely the blind spot the predictive forecaster
    covers (Figure 6).
    """

    window: int = 256
    max_age_ms: float | None = None
    records: Deque[QueryRecord] = field(default_factory=deque)

    def observe(self, rec: QueryRecord) -> None:
        self.records.append(rec)
        while len(self.records) > self.window:
            self.records.popleft()

    def prune(self, now_ms: float) -> None:
        if self.max_age_ms is None:
            return
        horizon = now_ms - self.max_age_ms
        while self.records and self.records[0].ts_ms < horizon:
            self.records.popleft()

    def clear(self) -> None:
        self.records.clear()

    # ---- classifier features (Section IV-A) ---------------------------
    def snapshot_features(self) -> Tuple[np.ndarray, int]:
        """Returns (features[3], n_samples)."""
        recs = list(self.records)
        n = len(recs)
        if n == 0:
            return np.zeros(3, np.float32), 0
        scans = sum(1 for r in recs if r.kind == "scan")
        mutators = max(n - scans, 0)
        ratio = scans / max(mutators, 1)
        via_index = sum(r.tuples_scanned for r in recs if r.used_index)
        total = max(sum(r.tuples_scanned for r in recs), 1)
        idx_ratio = via_index / total
        avg_scanned = sum(r.tuples_scanned for r in recs) / n
        return np.array([ratio, idx_ratio, avg_scanned], np.float32), n

    # ---- candidate statistics (Section IV-B) ---------------------------
    def attr_set_counts(self, table: str) -> Counter:
        """How often each predicate attribute set was queried (scans and
        predicated updates both count: the paper keeps indexes that help
        UPDATE row lookup even in write-heavy phases)."""
        c: Counter = Counter()
        for r in self.records:
            if r.table != table or not r.pred_attrs:
                continue
            c[tuple(r.pred_attrs)] += 1
        return c

    def scan_records(self, table: str) -> Iterable[QueryRecord]:
        return [
            r for r in self.records if r.table == table and r.kind == "scan"
        ]

    def mutator_records(self, table: str) -> Iterable[QueryRecord]:
        return [
            r
            for r in self.records
            if r.table == table and r.kind in ("update", "insert")
        ]

    def tables(self) -> Iterable[str]:
        return sorted({r.table for r in self.records})

    # ---- per-shard page-access counters (shard-aware tuning) -----------
    def shard_page_counts(self, table: str, n_shards: int) -> np.ndarray:
        """Pages scanned per shard over the window's scan records --
        the access-heat signal behind per-shard build scheduling.
        Records without shard accounting (unsharded runs, mutators,
        pure index scans) contribute nothing."""
        heat = np.zeros(n_shards, np.float64)
        for r in self.records:
            if r.table != table or r.kind != "scan" or not r.shard_pages:
                continue
            sp = r.shard_pages[:n_shards]
            heat[: len(sp)] += sp
        return heat

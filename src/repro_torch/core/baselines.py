"""Baseline indexing approaches on the same substrate (paper Section VI:
online, adaptive, self-managing, holistic).

Port of ``repro.core.baselines``.  Every tuner exposes the two hooks
the workload runner drives:

  on_query(q, stats) -> float    in-query physical-design work units
                                 (charged to the query's latency -- this
                                 is where immediate-DL latency spikes
                                 come from)
  tuning_cycle(idle) -> float    background work units

Differences vs. the predictive tuner (Table I):

* OnlineTuner      retrospective DL, FULL scheme, always-on background
* AdaptiveTuner    immediate DL, VBP, refines ONLY during query processing
* SmixTuner        immediate DL, VBP, + shrinks the configuration (LRU
                   drop) when over budget
* HolisticTuner    immediate DL, VBP, + uses idle cycles to populate
                   randomly chosen candidate indexes; drops only when
                   over the storage budget

The decisions are host logic, made in the reference's order (the
catalog is a dict in creation order, so ``min`` over ``last_used_ms``
breaks ties as the reference does, and ``HolisticTuner`` draws from its
own ``np.random.default_rng(seed)`` in the reference's order); the
physical work they ask for (FULL builds, VBP populations) runs on the
table's device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import knapsack
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.executor import Database, ExecStats, Query
from repro_torch.core.tuner import TunerConfig, enumerate_candidates


class DisabledTuner:
    """DIS baseline: no tuning at all."""

    name = "disabled"

    def __init__(self, db: Database, config: TunerConfig | None = None):
        self.db = db

    def on_query(self, q: Query, stats: ExecStats) -> float:
        return 0.0

    def tuning_cycle(self, idle: bool = False) -> float:
        return 0.0


class OnlineTuner:
    """Retrospective DL + FULL scheme (Bruno/Chaudhuri, COLT style).

    Examines the last-k window; once a candidate's window utility
    clears the threshold it builds the ENTIRE index in one cycle (the
    computationally expensive change the paper criticises), and the
    index becomes usable only when complete.
    """

    name = "online"
    scheme = "full"

    def __init__(self, db: Database, config: TunerConfig | None = None):
        self.db = db
        self.cfg = config or TunerConfig()

    def on_query(self, q: Query, stats: ExecStats) -> float:
        return 0.0

    def tuning_cycle(self, idle: bool = False) -> float:
        db, cfg = self.db, self.cfg
        work = 0.0
        cands = enumerate_candidates(db, cfg.candidate_min_count,
                                     cfg.max_candidates)
        scans = {t: list(db.monitor.scan_records(t)) for t in db.monitor.tables()}
        muts = {t: list(db.monitor.mutator_records(t)) for t in db.monitor.tables()}

        descs = {d.name: d for d, _ in cands}
        for b in db.indexes.values():
            descs.setdefault(b.desc.name, b.desc)
        names = list(descs)
        utils, sizes = [], []
        for name in names:
            d = descs[name]
            n_rows = int(db.tables[d.table].n_rows)
            u = cm.overall_utility(d, scans.get(d.table, ()),
                                   muts.get(d.table, ()), n_rows)
            utils.append(max(u, 0.0))
            sizes.append(cm.index_size_bytes(n_rows))
        if names:
            keep = knapsack.solve(np.asarray(utils), np.asarray(sizes),
                                  cfg.storage_budget_bytes)
            chosen = {names[i] for i in range(len(names)) if keep[i]}
        else:
            chosen = set()
        for name in list(db.indexes):
            if name not in chosen:
                db.drop_index(name)
        for name in chosen:
            if name not in db.indexes:
                bi = db.create_index(descs[name], scheme="full")
                # FULL: build everything at once -- the expensive change.
                t = db.tables[descs[name].table]
                work += db.vap_build_step(bi, t.n_pages)
        # Finish any index that gained pages from appends.
        for bi in db.indexes.values():
            if bi.scheme == "full" and bi.building:
                t = db.tables[bi.desc.table]
                work += db.vap_build_step(bi, t.n_pages)
        return work


class AdaptiveTuner:
    """Immediate DL + VBP; refines indexes only during query processing
    (database cracking).  The sub-domain population work is returned
    from ``on_query`` and charged to the triggering query's latency."""

    name = "adaptive"
    scheme = "vbp"

    def __init__(self, db: Database, config: TunerConfig | None = None):
        self.db = db
        self.cfg = config or TunerConfig()

    def _index_for(self, q: Query):
        db = self.db
        for bi in db.indexes_on(q.table):
            if bi.scheme == "vbp" and cm.index_matches(bi.desc, q.table, q.attrs):
                return bi
        # immediate DL: k=1, create on first sight
        lead = tuple(q.attrs[:2])
        if not lead:
            return None
        return db.create_index(IndexDescriptor(q.table, lead), scheme="vbp")

    def on_query(self, q: Query, stats: ExecStats) -> float:
        if q.kind != "scan" or not q.attrs:
            return 0.0
        bi = self._index_for(q)
        if bi is None:
            return 0.0
        t = self.db.tables[q.table]
        return self.db.vbp_populate(bi, q, max_add=t.capacity)

    def tuning_cycle(self, idle: bool = False) -> float:
        return 0.0  # adaptive indexing has no background component


class SmixTuner(AdaptiveTuner):
    """Self-managing indexes: adaptive + shrink.  When the storage
    budget is exceeded the least-recently-used index is dropped.
    (Our variant supports range queries; the original SMIX does not.)"""

    name = "smix"

    def on_query(self, q: Query, stats: ExecStats) -> float:
        work = super().on_query(q, stats)
        db, cfg = self.db, self.cfg
        while (db.total_index_bytes() > cfg.storage_budget_bytes
               and len(db.indexes) > 1):
            lru = min(db.indexes.values(), key=lambda b: b.last_used_ms)
            db.drop_index(lru.desc.name)
        return work


class HolisticTuner(AdaptiveTuner):
    """Holistic indexing: immediate DL + VBP + idle-resource builds with
    RANDOM index selection (the strategy the paper implemented for its
    comparison), proactively populating even unqueried attributes.
    Drops only when over the storage budget."""

    name = "holistic"

    def __init__(self, db: Database, config: TunerConfig | None = None,
                 seed: int = 0, subdomain_width: int = 50_000):
        super().__init__(db, config)
        self.rng = np.random.default_rng(seed)
        self.subdomain_width = subdomain_width

    def tuning_cycle(self, idle: bool = False) -> float:
        db = self.db
        work = 0.0
        # Random proactive population (value-based, idle resources).
        tables = list(db.tables)
        if not tables:
            return 0.0
        tname = tables[int(self.rng.integers(len(tables)))]
        t = db.tables[tname]
        attr = int(self.rng.integers(1, t.n_attrs))
        desc = IndexDescriptor(tname, (attr,))
        bi = db.indexes.get(desc.name)
        if bi is None:
            bi = db.create_index(desc, scheme="vbp")
        lo = int(self.rng.integers(1, 1_000_000))
        hi = min(lo + self.subdomain_width, 1_000_000)
        probe = Query(kind="scan", table=tname, attrs=(attr,),
                      los=(lo,), his=(hi,))
        work += db.vbp_populate(bi, probe, max_add=t.capacity)
        # Drop only when over budget (by design, the paper notes this
        # keeps stale indexes alive through workload shifts).
        while (db.total_index_bytes() > self.cfg.storage_budget_bytes
               and len(db.indexes) > 1):
            lru = min(db.indexes.values(), key=lambda b: b.last_used_ms)
            db.drop_index(lru.desc.name)
        return work

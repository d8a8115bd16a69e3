"""Predictive index tuner -- Algorithm 1 of the paper.

Port of ``repro.core.tuner`` on plain and sharded storage.  Every
tuning cycle runs the observe-react-learn template:

  Stage I   workload classification (CART decision tree)
  Stage II  candidate enumeration, what-if utility, 0-1 knapsack under
            the storage budget, amortised state transition using
            lightweight VAP build quanta
  Stage III Holt-Winters update with the observed overall utility; the
            forecast feeds the next cycle's knapsack

Stage III advances one batched forecaster state over every descriptor
ever seen, row i for the cycle's ``names[i]``: one ``update_batch`` and
one ``forecast_batch`` a cycle, read back at once.  The tuner retains
the rows of dropped indexes so their future utility stays predictable.
The forecaster runs in float32 on the database's device.

Coverage-bitmap scheduling (``Database.crack_on_scan`` /
``index_decay``): a bitmap-mode VAP index's cycle slice becomes an
explicit hot-range-first page list -- the monitor window's predicate
ranges on the leading key attribute, mapped to pages through the zone
map, hottest pages first -- and a decay pass clears the coldest
covered pages' bits while the built footprint exceeds the storage
budget.

Shard-aware scheduling (``Database.shard_aware_tuning``): on sharded
storage each building index's cycle slice is split into per-shard
quanta sized by forecast utility (predicted per-shard scan heat x
unbuilt pages, ``cost_model.shard_build_utility``), so cold or
complete shards stop absorbing budget.  Without it the slice
round-robins across shards in global page order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import cost_model as cm
from repro_torch.core import forecaster as hw
from repro_torch.core import knapsack
from repro_torch.core.build_service import (
    BuildQuantum,
    CyclePlan,
    apply_quantum,
)
from repro_torch.core.classifier import (
    READ_INTENSIVE,
    UNKNOWN,
    WRITE_INTENSIVE,
    CartClassifier,
    default_classifier,
)
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.executor import Database, ExecStats, Query
from repro_torch.core.index import (
    ShardedIndex,
    build_pages_remaining,
    eligible_global_pages,
    shard_remaining_pages,
)
from repro_torch.core.table import ShardedTable


@dataclass
class TunerConfig:
    storage_budget_bytes: float = 256e6
    pages_per_cycle: int = 32  # VAP lightweight build step
    max_build_pages_per_cycle: int = 64  # total across all building indexes
    season_len: int = 16  # Holt-Winters seasonality period (cycles)
    alpha: float = 0.5
    beta: float = 0.3
    gamma: float = 0.4
    u_min_read: float = 0.0  # min forecast utility to keep an index
    u_min_write: float = 0.25  # scaled-up threshold in write phases
    candidate_min_count: int = 3  # appearances in window before considering
    max_candidates: int = 16
    redundancy_dampening: float = 0.5  # utility factor for correlated cands


def enumerate_candidates(
    db: Database, min_count: int, max_candidates: int
) -> List[Tuple[IndexDescriptor, int]]:
    """Candidate single- and two-attribute indexes from the monitor's
    predicate statistics: attribute sets seen at least ``min_count``
    times in the window, most frequent first."""
    out: List[Tuple[IndexDescriptor, int]] = []
    for table in db.monitor.tables():
        for attrs, count in db.monitor.attr_set_counts(table).most_common():
            if count < min_count:
                continue
            key = tuple(attrs[:2])  # engine supports 1- and 2-attr keys
            out.append((IndexDescriptor(table, key), count))
            if len(key) > 1:  # the single-attr prefix is also a candidate
                out.append((IndexDescriptor(table, key[:1]), count))
    seen: Dict[str, Tuple[IndexDescriptor, int]] = {}
    for desc, count in out:
        if desc.name not in seen or seen[desc.name][1] < count:
            seen[desc.name] = (desc, count)
    ranked = sorted(seen.values(), key=lambda dc: -dc[1])
    return ranked[:max_candidates]


class PredictiveTuner:
    """The paper's tuner: predictive DL + VAP scheme.

    ``use_forecaster=False`` degrades the decision logic to the purely
    retrospective variant and ``immediate=True`` to the immediate
    variant (k=1) -- the two DL baselines of Figure 6.

    ``hw_state`` is Stage III's batched Holt-Winters state: row i models
    ``list(descs)[i]``.  ``descs`` only grows, so a cycle's names extend
    the rows of the one before, and new names get fresh rows appended.
    """

    name = "predictive"
    scheme = "vap"

    def __init__(
        self,
        db: Database,
        config: TunerConfig | None = None,
        classifier: Optional[CartClassifier] = None,
        use_forecaster: bool = True,
        immediate: bool = False,
    ):
        self.db = db
        self.cfg = config or TunerConfig()
        self.classifier = classifier or default_classifier()
        self.use_forecaster = use_forecaster
        self.immediate = immediate
        self.hw_state: Optional[hw.HWState] = None  # row i: names[i]
        self._smoothing: Tuple[tuple, tuple] = ((), ())  # values, tensors
        self.descs: Dict[str, IndexDescriptor] = {}  # every desc ever seen
        self.forecasts: Dict[str, float] = {}  # U from last Stage III
        # per-(table, n_shards) heat forecaster (shard-aware tuning)
        self.shard_heat: Dict[Tuple[str, int], hw.ShardHeatForecaster] = {}
        self.last_label: int = UNKNOWN
        self.cycles: int = 0

    # ---- immediate hook: predictive DL does no in-query work ----------
    def on_query(self, q: Query, stats: ExecStats) -> float:
        return 0.0

    def tuning_cycle(self, idle: bool = False) -> float:
        """One serialized cycle: decide, then apply every build
        quantum inline."""
        with telemetry.span("tuner.cycle"):
            plan = self.decide(idle=idle)
            work = plan.decide_work
            for quantum in plan.quanta:
                work += apply_quantum(self.db, quantum)
            return work

    def decide(self, idle: bool = False) -> CyclePlan:
        """The decision stages of Algorithm 1, with the cycle's build
        work returned as ``BuildQuantum`` records."""
        with telemetry.span("tuner.decide"):
            return self._decide()

    def _decide(self) -> CyclePlan:
        db, cfg = self.db, self.cfg
        with telemetry.span("tuner.monitor"):
            db.monitor.prune(db.clock_ms)
            shard_aware = bool(getattr(db, "shard_aware_tuning", False))
            if shard_aware:
                self._observe_shard_heat()
            feats, n = db.monitor.snapshot_features()

        # Stage I: workload classification
        with telemetry.span("tuner.classify"):
            label = self.classifier.predict(feats, n_samples=n)
        if label != UNKNOWN:
            self.last_label = label

        # Stage II: action generation ---------------------------------
        with telemetry.span("tuner.monitor"):
            scans, muts = self._candidates()

        with telemetry.span("tuner.utility"):
            names, utilities, sizes, force, observed = self._utilities(
                scans, muts)

        with telemetry.span("tuner.knapsack"):
            thresholds = {
                WRITE_INTENSIVE: cfg.u_min_write,
                READ_INTENSIVE: cfg.u_min_read,
            }
            u_min = thresholds.get(self.last_label, cfg.u_min_read)
            u_arr = np.asarray(utilities, np.float64)
            scale = max(u_arr.max(), 1.0) if u_arr.size else 1.0
            eligible = (u_arr / scale) > u_min

            keep = knapsack.solve(
                np.where(eligible, u_arr, 0.0),
                np.asarray(sizes),
                cfg.storage_budget_bytes,
                force_keep=np.asarray(force, bool),
            )

        # State transition (amortised): drops now, builds via VAP steps.
        with telemetry.span("tuner.transition"):
            chosen = {names[i] for i in range(len(names)) if keep[i]}
            for name in list(db.indexes):
                if name not in chosen:
                    db.drop_index(name)
            for name in chosen:
                if name not in db.indexes:
                    db.create_index(self.descs[name], scheme=self.scheme)

            # Memory-cap decay (bitmap mode), before build quanta are
            # planned, so this cycle's page lists see the decayed bitmap.
            if getattr(db, "index_decay", False):
                self._decay_cold_pages()

        with telemetry.span("tuner.plan_quanta"):
            quanta = self._plan_quanta(names, utilities, shard_aware)

        # Stage III: index utility forecasting ------------------------
        # (the per-shard heat models were advanced at cycle start)
        with telemetry.span("tuner.forecast"):
            if self.use_forecaster and names:
                self._forecast(names, observed)
        self.cycles += 1
        return CyclePlan(quanta=quanta)

    def _n_modelled(self) -> int:
        """How many descriptors Stage III has modelled: the first that
        many of ``names``."""
        return 0 if self.hw_state is None else self.hw_state.level.shape[0]

    def _forecast(self, names, observed) -> None:
        """Stage III: one observation per descriptor into the batched
        state (fresh rows for names new this cycle bootstrap from it),
        and every one-step forecast read back at once."""
        cfg, dev = self.cfg, self.db.device
        st, k = self.hw_state, len(names) - self._n_modelled()
        if k:
            fresh = hw.init_state(cfg.season_len, batch=k, device=dev)
            st = fresh if st is None else hw.HWState(
                *(torch.cat(pair) for pair in zip(st, fresh)))
        values = (cfg.alpha, cfg.beta, cfg.gamma)
        if self._smoothing[0] != values:
            self._smoothing = (values, tuple(
                torch.tensor(v, dtype=torch.float32, device=dev)
                for v in values))
        ys = np.array([observed[name] for name in names], np.float32)
        st = hw.update_batch(st, torch.from_numpy(ys).to(dev),
                             *self._smoothing[1])
        self.hw_state = st
        telemetry.count("tuner.forecast_series", len(names))
        self.forecasts.update(zip(names, hw.forecast_batch(st, 1).tolist()))

    def _candidates(self):
        """Register the window's candidates; the monitor window's scan
        and mutator records by table (the last statement's alone for
        the immediate variant)."""
        db, cfg = self.db, self.cfg
        min_count = 1 if self.immediate else cfg.candidate_min_count
        for desc, _count in enumerate_candidates(
            db, min_count, cfg.max_candidates
        ):
            self.descs.setdefault(desc.name, desc)

        if self.immediate:
            # k=1: only the most recent statement informs the decision.
            recs = list(db.monitor.records)[-1:]
            scans = {}
            muts = {}
            for r in recs:
                bucket = scans if r.kind == "scan" else muts
                bucket.setdefault(r.table, []).append(r)
                if r.pred_attrs:
                    d = IndexDescriptor(r.table, tuple(r.pred_attrs[:2]))
                    self.descs.setdefault(d.name, d)
        else:
            scans = {
                t: list(db.monitor.scan_records(t))
                for t in db.monitor.tables()
            }
            muts = {
                t: list(db.monitor.mutator_records(t))
                for t in db.monitor.tables()
            }
        return scans, muts

    def _utilities(self, scans, muts):
        """What-if utility of every descriptor ever seen over the
        window (forecast-lifted, redundancy-dampened): names,
        utilities, sizes, forced keeps and the observed utilities."""
        db, cfg = self.db, self.cfg
        names = list(self.descs)
        modelled = self._n_modelled()
        utilities, sizes, force = [], [], []
        observed: Dict[str, float] = {}
        for i, name in enumerate(names):
            desc = self.descs[name]
            n_rows = db.tables[desc.table].n_rows
            o = cm.overall_utility(
                desc,
                scans.get(desc.table, ()),
                muts.get(desc.table, ()),
                n_rows,
            )
            upd_u = cm.update_lookup_utility(
                desc, muts.get(desc.table, ()), n_rows
            )
            o = max(o, 0.0) + upd_u
            observed[name] = o
            if self.use_forecaster and i < modelled:
                u = max(self.forecasts.get(name, o), o)
            else:
                u = o
            utilities.append(u)
            sizes.append(cm.index_size_bytes(n_rows))
            force.append(name in db.indexes and upd_u > 0.0)

        # Redundancy dampening: correlated candidates (same leading
        # attribute as an already-built index) get discounted.
        built_leading = {
            (b.desc.table, b.desc.key_attrs[0]) for b in db.indexes.values()
        }
        for i, name in enumerate(names):
            d = self.descs[name]
            correlated = (d.table, d.key_attrs[0]) in built_leading
            if name not in db.indexes and correlated:
                utilities[i] *= cfg.redundancy_dampening
        return names, utilities, sizes, force, observed

    def _plan_quanta(self, names, utilities, shard_aware: bool):
        """Lightweight build work, bounded per cycle and rebalanced
        across building indexes by forecast utility; shard-aware
        tuning splits each index's slice into per-shard quanta."""
        db, cfg = self.db, self.cfg
        quanta: List[BuildQuantum] = []
        util_by_name = dict(zip(names, utilities))
        building = [
            b
            for b in db.indexes.values()
            if b.scheme in ("vap",) and b.building
        ]
        steps = (
            cm.allocate_cycle_budget(
                [
                    float(util_by_name.get(b.desc.name, 0.0))
                    for b in building
                ],
                [self._build_pages_left(b) for b in building],
                cfg.max_build_pages_per_cycle,
                cfg.pages_per_cycle,
            )
            if building
            else []
        )
        for b, step in zip(building, steps):
            step = int(step)
            if step <= 0:
                continue
            t = db.tables[b.desc.table]
            per_shard = (
                shard_aware
                and isinstance(t, ShardedTable)
                and isinstance(b.vap, ShardedIndex)
            )
            u = float(util_by_name.get(b.desc.name, 0.0))
            if b.coverage is not None:
                pl = self._hot_range_pages(b, step)
                if pl is not None:
                    if pl:
                        quanta.append(
                            BuildQuantum(b.desc.name, len(pl), utility=u,
                                         page_list=tuple(pl))
                        )
                    continue
                # No range signal in the window: a quantum without a
                # page list builds the lowest uncovered pages.
            if per_shard:
                alloc = self._shard_step_allocation(b, t, step)
                quanta.extend(
                    BuildQuantum(b.desc.name, p, shard=s, utility=u)
                    for s, p in alloc
                )
            else:
                quanta.append(BuildQuantum(b.desc.name, step, utility=u))
        return quanta

    # ---- shard-aware build scheduling ---------------------------------
    def _observe_shard_heat(self) -> None:
        """Feed every sharded table's per-shard page-access counters
        (monitor window) into its heat forecaster: one batched update
        per table per cycle, on the database's device."""
        for name, t in self.db.tables.items():
            if not isinstance(t, ShardedTable):
                continue
            key = (name, t.n_shards)
            fc = self.shard_heat.get(key)
            if fc is None:
                fc = hw.ShardHeatForecaster(
                    t.n_shards,
                    season_len=self.cfg.season_len,
                    alpha=self.cfg.alpha,
                    beta=self.cfg.beta,
                    gamma=self.cfg.gamma,
                    device=self.db.device,
                )
                self.shard_heat[key] = fc
            fc.observe(self.db.monitor.shard_page_counts(name, t.n_shards))

    def _shard_step_allocation(self, b, t: ShardedTable, step: int):
        """Split one index's cycle slice across shards by forecast
        utility: predicted per-shard heat x pages left to build.
        Deterministic, and never allocates to complete shards."""
        fc = self.shard_heat.get((b.desc.table, t.n_shards))
        heat = fc.predict() if fc is not None else np.ones(t.n_shards)
        remaining = shard_remaining_pages(b.vap, t)
        util = cm.shard_build_utility(heat, remaining, t.page_size)
        alloc = cm.allocate_build_pages(util, remaining, step)
        return [(s, int(p)) for s, p in enumerate(alloc) if p > 0]

    def _build_pages_left(self, b) -> int:
        """Pages this building index still has to cover."""
        if b.coverage is not None:
            return int(self.db.coverage_pages_left(b))
        t = self.db.tables[b.desc.table]
        if isinstance(b.vap, ShardedIndex):
            return int(sum(shard_remaining_pages(b.vap, t)))
        return int(build_pages_remaining(b.vap, t))

    # ---- coverage-bitmap scheduling (hot ranges, decay) ---------------
    def _range_heat(self, b, pages: np.ndarray):
        """How many of the monitor window's range predicates on the
        index's leading key attribute each page's zone-map range
        intersects; None when the window has no such predicate.

        A range [lo, hi] misses a page [pmin, pmax] when lo > pmax or
        hi < pmin, never both while lo <= hi and pmin <= pmax: such a
        page's heat is the ranges less the two counts, each a search in
        sorted bounds.  Inverted ranges and empty pages (past the full
        watermark) take the direct compare."""
        lead = b.desc.key_attrs[0]
        ranges = [
            (int(lo), int(hi))
            for r in self.db.monitor.scan_records(b.desc.table)
            for attr, lo, hi in r.pred_ranges
            if attr == lead
        ]
        if not ranges:
            return None
        mins, maxs = self.db.zone_map(b.desc.table, lead)
        pmin, pmax = mins[pages], maxs[pages]
        lo, hi = np.array(ranges, np.int64).T
        fwd = lo <= hi
        heat = (np.searchsorted(np.sort(lo[fwd]), pmax, side="right")
                - np.searchsorted(np.sort(hi[fwd]), pmin, side="left"))
        empty = np.flatnonzero(pmin > pmax)
        if empty.size:
            heat[empty] = _meets(pmin[empty], pmax[empty], lo[fwd], hi[fwd])
        heat += _meets(pmin, pmax, lo[~fwd], hi[~fwd])
        telemetry.count("tuner.heat_ranges", len(ranges))
        telemetry.count("tuner.heat_direct",
                        int(np.count_nonzero(~fwd)) + empty.size)
        return heat.astype(np.int64, copy=False)

    def _hot_range_pages(self, b, step: int):
        """Hot-range-first build order for a bitmap-mode index: the
        uncovered pages most window predicates touch, hottest first
        (page id breaks ties).  A page list capped at ``step``, or None
        when the window has no range signal."""
        t = self.db.tables[b.desc.table]
        eligible = eligible_global_pages(t)
        open_pages = eligible[~b.coverage.built[eligible]]
        if open_pages.size == 0:
            return []
        heat = self._range_heat(b, open_pages)
        if heat is None or not heat.any():
            return None
        # One unique key per page, in (-heat, page) order: the first
        # ``step`` without sorting the rest.
        key = open_pages - heat * (int(open_pages.max()) + 1)
        step = int(step)
        if step < key.size:
            first = np.argpartition(key, step - 1)[:step]
            order = first[np.argsort(key[first])]
        else:
            order = np.argsort(key)
        return [int(p) for p in open_pages[order]]

    def _decay_cold_pages(self) -> None:
        """Memory-cap decay: while the built footprint exceeds the
        storage budget, clear the coldest covered pages' bits (fewest
        window predicate intersections; page id breaks ties).  Entries
        are not compacted -- masked scans re-scan cleared pages -- and
        a decayed index reopens (building, not complete)."""
        db, cfg = self.db, self.cfg
        over = db.total_index_bytes() - cfg.storage_budget_bytes
        for b in db.indexes.values():
            if over <= 0:
                break
            cov = b.coverage
            if cov is None:
                continue
            covered = np.flatnonzero(cov.built)
            if covered.size == 0:
                continue
            t = db.tables[b.desc.table]
            page_bytes = 12.0 * t.page_size
            heat = self._range_heat(b, covered)
            if heat is None:
                heat = np.zeros(covered.size, np.int64)
            order = np.lexsort((covered, heat))
            n_drop = min(int(np.ceil(over / page_bytes)), covered.size)
            cov.clear_pages(covered[order[:n_drop]])
            b.building, b.complete = True, False
            over -= n_drop * page_bytes


def _meets(pmin, pmax, lo, hi) -> np.ndarray:
    """For each page [pmin, pmax], how many of the ranges [lo, hi] it
    intersects, compared range by range."""
    heat = np.zeros(pmin.size, np.int64)
    for l, h in zip(lo.tolist(), hi.tolist()):
        heat += (pmin <= h) & (pmax >= l)
    return heat


def make_dl_tuner(
    db: Database,
    dl: str,
    config: TunerConfig | None = None,
    classifier: Optional[CartClassifier] = None,
) -> PredictiveTuner:
    """Figure 6 factory: the three decision logics on identical VAP
    substrate.  dl in {'predictive', 'retrospective', 'immediate'}."""
    if dl == "predictive":
        t = PredictiveTuner(db, config, classifier)
    elif dl == "retrospective":
        t = PredictiveTuner(db, config, classifier, use_forecaster=False)
    elif dl == "immediate":
        t = PredictiveTuner(
            db, config, classifier, use_forecaster=False, immediate=True
        )
    else:
        raise ValueError(dl)
    t.name = dl
    return t

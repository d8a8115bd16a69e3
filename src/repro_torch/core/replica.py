"""Replica tier: divergent per-replica tuning and cost-routed queries.

Port of ``repro.core.replica``.  A ``ReplicaSet`` holds N full copies
of the database (each its own ``Database`` and ``PredictiveTuner``
build lane), keeps them equal in DATA by fanning every mutation out to
all replicas at the same simulated clock, and lets their INDEX
configurations diverge: each tuning cycle clusters the monitor's
window by candidate-index similarity (Jaccard over per-query
candidate sets) and gives one cluster to each replica as its tuning
target.  Every scan (or read burst) is routed to the replica whose
planner reports the cheapest what-if cost
(``QueryPlanner.estimate_scan_cost``, host-only), ties to the lowest
replica id.

Storage.  The port's mutators write into a table's tensors in place
(``core.table``), so replicas cannot share them as the reference's
immutable arrays can: every replica past 0 owns a copy of each table
(``clone_table``), made when the set is built.  A fanned-out INSERT or
UPDATE then writes each replica's own tensors once.  All replicas live
on the one device of replica 0's tables (``ReplicaSet.device``): the
tier is N engines on one card, never a placement across devices.

Bit-exactness.  ``ReplicaSet`` duck-types ``Database`` (and
``ReplicaSetTuner`` the tuner protocol), so both ``run_workload``
drivers treat the set like a single engine.  Replica 0 IS the wrapped
database and tuner, and mirrored mode (``divergent=False``) is the
single engine: identical catalogs give identical costs, so the router
always picks replica 0; every lane runs the same decide on the same
global window and the cycle's quanta are queued once, untagged, so the
fan-out in ``apply_quantum`` advances every catalog in lockstep for
the charge of one build; clocks re-synchronise at every set-level
boundary.  Divergent mode changes what each lane's tuner sees (its
cluster of the window) and how the cycle's page budget is shared
(``cost_model.allocate_cycle_budget``), never the data: results stay
exact because every replica holds the same rows.

Failover (``repro_torch.faults``).  With a fault injector attached,
every set-level operation first polls the outage schedule.  While a
replica is DOWN (recovery on) routing skips it; mutations fan out to
the up replicas and append ``("mut", base_clock, query)`` to the down
replica's catch-up log; mirrored monitor records buffer as ``("rec",
record)``.  Rejoin replays the log in order, each mutation at its
ORIGINAL base clock with the replica's drain hook off, as a live
secondary applies it, so the rejoined replica's MVCC timestamps,
tables and monitor window equal a replica that never crashed.  All
replicas down at once raises ``ClusterUnavailable``.  With recovery
off a crash is permanent and the router stays blind: statements routed
to a dead replica drop (``dropped_statements``).
"""

from __future__ import annotations

import copy
from collections import deque
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.build_service import (
    BuildQuantum,
    CyclePlan,
    apply_quantum,
)
from repro_torch.core.executor import Database
from repro_torch.core.table import clone_table
from repro_torch.core.tuner import PredictiveTuner
from repro_torch.faults import ClusterUnavailable


def candidate_signature(rec) -> Optional[frozenset]:
    """The candidate indexes a monitor record argues for: the (table,
    key-prefix) pairs ``tuner.enumerate_candidates`` derives from it.
    None for records with no candidate signal (mutations, scans without
    a predicate): those go to every cluster."""
    if rec.kind != "scan" or not rec.pred_attrs:
        return None
    key = tuple(rec.pred_attrs[:2])
    sig = {(rec.table, key)}
    if len(key) > 1:
        sig.add((rec.table, key[:1]))
    return frozenset(sig)


def cluster_assignments(records, n_clusters: int) -> List[int]:
    """Cluster the window's records by candidate-index similarity.

    Signatures are ranked by (-frequency, sorted contents); the top
    ``n_clusters`` seed one cluster each and the rest join the cluster
    whose accumulated candidate union they overlap most (Jaccard; ties
    to the lowest cluster id).  No hashes, randomness or wall time.
    Returns one cluster id per record; -1 marks records without a
    candidate signal, which every lane receives."""
    sigs = [candidate_signature(r) for r in records]
    counts: Dict[frozenset, int] = {}
    for s in sigs:
        if s is not None:
            counts[s] = counts.get(s, 0) + 1
    ordered = sorted(counts, key=lambda s: (-counts[s], sorted(s)))
    unions: List[set] = []
    cluster_of: Dict[frozenset, int] = {}
    for s in ordered:
        if len(unions) < n_clusters:
            cluster_of[s] = len(unions)
            unions.append(set(s))
            continue
        best, best_j = 0, -1.0
        for c, u in enumerate(unions):
            denom = len(s | u)
            j = (len(s & u) / denom) if denom else 0.0
            if j > best_j:
                best, best_j = c, j
        cluster_of[s] = best
        unions[best] |= s
    return [-1 if s is None else cluster_of[s] for s in sigs]


def clone_tuner(
    tuner: PredictiveTuner, db: Database, share_cfg: bool = True
) -> PredictiveTuner:
    """A replica's own tuner: ``tuner``'s decision logic and learned
    state, bound to ``db``.  Mirrored lanes share the TunerConfig (a
    runtime adaptation such as the adaptive build budget must reach
    every lane alike); divergent lanes get a copy so that per-lane
    budget overrides stay local.  Forecaster states are replaced, never
    updated in place (``forecaster.update`` returns new states), so
    dict copies may share them; the shard-heat forecasters, which hold
    tensors, are deep-copied."""
    if not isinstance(tuner, PredictiveTuner):
        raise TypeError(
            "ReplicaSet tuning requires a PredictiveTuner "
            f"(got {type(tuner).__name__})"
        )
    cfg = tuner.cfg if share_cfg else replace(tuner.cfg)
    t = PredictiveTuner(
        db,
        config=cfg,
        classifier=tuner.classifier,
        use_forecaster=tuner.use_forecaster,
        immediate=tuner.immediate,
    )
    t.name = tuner.name
    t.models = dict(tuner.models)
    t.forecasts = dict(tuner.forecasts)
    t.descs = dict(tuner.descs)
    t.shard_heat = copy.deepcopy(tuner.shard_heat)
    t.last_label = tuner.last_label
    t.cycles = tuner.cycles
    return t


class _EngineProxy:
    """Engine-shaped view over a replica set: attribute writes (the
    overlap drain hook) fan out to every replica's ScanEngine, reads
    resolve against replica 0."""

    def __init__(self, dbs):
        object.__setattr__(self, "_dbs", dbs)

    def __getattr__(self, name):
        return getattr(self._dbs[0].engine, name)

    def __setattr__(self, name, value):
        for d in self._dbs:
            setattr(d.engine, name, value)


class ReplicaSet:
    """N data-equal replicas with divergent index catalogs, on one
    device.

    Duck-types the ``Database`` surface the drivers touch: ``execute``
    / ``execute_batch`` (routed), the simulated clock and tuning flags
    (fanned out), ``indexes`` (merged view), ``engine`` (proxy),
    ``device``.  Wrap BEFORE any index exists: catalogs are per replica
    and an inherited index would exist on replica 0 only."""

    def __init__(self, db: Database, n_replicas: int, divergent: bool = False):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if db.indexes:
            raise ValueError(
                "wrap the database before any index exists: replica "
                "catalogs start empty and diverge from there"
            )
        self.divergent = divergent
        self.dbs: List[Database] = [db]
        for _ in range(1, n_replicas):
            d = Database(
                {name: clone_table(t) for name, t in db.tables.items()},
                time_per_unit_ms=db.time_per_unit_ms,
                monitor_window=db.monitor.window,
                monitor_max_age_ms=db.monitor.max_age_ms,
            )
            if d.num_shards != db.num_shards:
                raise ValueError("replica adopted a different shard layout")
            d.layouts = dict(db.layouts)
            d.clock_ms = db.clock_ms
            d.update_cap = db.update_cap
            d.shard_aware_tuning = db.shard_aware_tuning
            d.crack_on_scan = db.crack_on_scan
            d.crack_pages_per_scan = db.crack_pages_per_scan
            d.index_decay = db.index_decay
            d.fault_injector = db.fault_injector
            for rec in db.monitor.records:
                d.monitor.observe(rec)
            self.dbs.append(d)
        self.engine = _EngineProxy(self.dbs)
        # One routed replica id per scan / read burst, in order.
        self.routed_queries: List[int] = []
        # Failover state: DOWN flags, per-replica catch-up logs
        # (("mut", base_clock_ms, query) | ("rec", monitor_record), in
        # arrival order) and availability telemetry.
        self._down: List[bool] = [False] * n_replicas
        self._down_since: List[float] = [0.0] * n_replicas
        self._catchup: List[list] = [[] for _ in range(n_replicas)]
        self.downtime_ms: List[float] = [0.0] * n_replicas
        self.dropped_statements = 0
        self.failover_routes = 0
        self.rejoins = 0

    # -- replica plumbing ------------------------------------------------
    @property
    def device(self) -> torch.device:
        """The set's one device (replica 0's tables'); the build lane
        synchronises it to time quanta, the runner to time the run."""
        return self.dbs[0].device

    def build_targets(self, replica: Optional[int]):
        """Catalogs one build quantum applies to (``apply_quantum``):
        an untagged quantum advances every replica in lockstep, a
        tagged one its own lane only."""
        if replica is None:
            return tuple(self.dbs)
        return (self.dbs[replica],)

    def _sync_clock(self, value: float) -> None:
        for d in self.dbs:
            d.clock_ms = value

    def _mirror_records(self, src: int, k: int) -> None:
        """Copy the last ``k`` monitor records of replica ``src`` into
        every other replica's monitor: the window is global (clustering,
        not visibility, diverges the lanes).  Records for a DOWN replica
        buffer in its catch-up log (recovery on) so that the window
        replays in order at rejoin."""
        if k <= 0:
            return
        inj = self.fault_injector
        recs = list(self.dbs[src].monitor.records)[-k:]
        for i, d in enumerate(self.dbs):
            if i == src:
                continue
            if self._down[i]:
                if inj is not None and inj.recovery:
                    self._catchup[i].extend(("rec", rec) for rec in recs)
                continue
            for rec in recs:
                d.monitor.observe(rec)

    # -- fault injection: outage polling and rejoin replay ---------------
    def frac_up(self) -> float:
        """Fraction of replicas serving: the capacity signal by which
        degraded-mode admission scales its SLO headroom."""
        n = len(self.dbs)
        return (n - sum(self._down)) / n

    def _poll_faults(self) -> None:
        """Advance outage state to the current simulated clock: mark
        replicas entering an outage DOWN, replay the catch-up logs of
        replicas whose outage has ended.  A no-op without an injector
        or without outages."""
        inj = self.fault_injector
        if inj is None or not inj.schedule.outages:
            return
        now = self.dbs[0].clock_ms
        for r in range(len(self.dbs)):
            down = inj.replica_down(r, now)
            if down and not self._down[r]:
                self._down[r] = True
                self._down_since[r] = now
            elif self._down[r] and not down:
                self._rejoin(r, now)

    def _rejoin(self, r: int, now_ms: float) -> None:
        """Replay replica ``r``'s catch-up log and mark it UP.

        Each logged mutation re-executes at its original base clock
        with the drain hook off, as a live secondary applied it, so the
        MVCC timestamps and therefore the stored tensors equal a
        replica that never crashed.  Buffered monitor records then
        replay in order.  The replica rejoins at ``now_ms``, the
        set-level clock at poll time."""
        d = self.dbs[r]
        hook = d.engine.after_dispatch
        d.engine.after_dispatch = None
        try:
            for entry in self._catchup[r]:
                if entry[0] == "mut":
                    _, base_ms, q = entry
                    d.clock_ms = base_ms
                    d.execute(q, observe=False)
                else:
                    d.monitor.observe(entry[1])
        finally:
            d.engine.after_dispatch = hook
        self._catchup[r] = []
        d.clock_ms = now_ms
        self._down[r] = False
        self.downtime_ms[r] += now_ms - self._down_since[r]
        self.rejoins += 1

    def _eligible(self) -> List[int]:
        """Replica ids routing may pick.  Failover (recovery on) skips
        DOWN replicas and raises ``ClusterUnavailable`` when none is
        left; recovery off keeps the router blind: a dead replica stays
        routable and statements sent to it drop."""
        inj = self.fault_injector
        if inj is None or not inj.recovery or not any(self._down):
            return list(range(len(self.dbs)))
        up = [r for r in range(len(self.dbs)) if not self._down[r]]
        if not up:
            raise ClusterUnavailable(
                f"all {len(self.dbs)} replicas down at clock "
                f"{self.dbs[0].clock_ms:.3f} ms"
            )
        self.failover_routes += 1
        return up

    # -- routing ---------------------------------------------------------
    def route_scan(self, q) -> int:
        """Cheapest eligible replica for one scan under the current
        catalogs (what-if cost, ties to the lowest id).  A single
        candidate answers without consulting any planner."""
        elig = self._eligible()
        if len(elig) == 1:
            return elig[0]
        return min(
            elig,
            key=lambda r: (self.dbs[r].planner.estimate_scan_cost(q), r),
        )

    def route_burst(self, queries) -> int:
        """Cheapest eligible replica for a whole read burst (summed
        what-if cost: the burst is one dispatch unit and is not split).
        A single eligible replica or an empty burst answers without
        consulting any planner (the lowest eligible id serves)."""
        elig = self._eligible()
        if len(elig) == 1 or not queries:
            return elig[0]
        return min(
            elig,
            key=lambda r: (
                sum(
                    self.dbs[r].planner.estimate_scan_cost(q)
                    for q in queries
                ),
                r,
            ),
        )

    # -- execution (Database surface) ------------------------------------
    def execute(self, q, observe: bool = True):
        self._poll_faults()
        if q.kind == "scan":
            r = self.route_scan(q)
            self.routed_queries.append(r)
            if self._down[r]:
                # Recovery off: the router is blind to the crash and the
                # dead replica serves nothing; the scan drops (None
                # stats, which the drivers count against availability).
                self.dropped_statements += 1
                return None
            stats = self.dbs[r].execute(q, observe=observe)
            if observe:
                self._mirror_records(r, 2 if q.join_table is not None else 1)
            self._sync_clock(self.dbs[r].clock_ms)
            return stats
        # Mutation: fan out to every UP replica at the same base clock,
        # so the MVCC timestamps (and the stored data) stay equal; a
        # DOWN replica logs it for replay at this base clock (recovery
        # on) or misses it for good (recovery off).  The set's clock
        # advances by the primary's latency: replicas apply the write
        # in parallel.
        inj = self.fault_injector
        ups = [i for i in range(len(self.dbs)) if not self._down[i]]
        if not ups:
            if inj is not None and inj.recovery:
                raise ClusterUnavailable(
                    f"all {len(self.dbs)} replicas down at clock "
                    f"{self.dbs[0].clock_ms:.3f} ms"
                )
            self.dropped_statements += 1
            return None
        base = self.dbs[0].clock_ms
        stats0 = None
        primary = ups[0]
        for i, d in enumerate(self.dbs):
            if self._down[i]:
                if inj is not None and inj.recovery:
                    self._catchup[i].append(("mut", base, q))
                continue
            d.clock_ms = base
            if i == primary:
                stats0 = d.execute(q, observe=observe)
                continue
            # A secondary application is a replay: no observation (the
            # record is mirrored below) and no drain opportunity (the
            # set-level dispatch fired one on the primary).
            hook = d.engine.after_dispatch
            d.engine.after_dispatch = None
            try:
                d.execute(q, observe=False)
            finally:
                d.engine.after_dispatch = hook
        if observe:
            self._mirror_records(primary, 1)
        self._sync_clock(base + stats0.latency_ms)
        return stats0

    def execute_batch(self, queries, observe: bool = True,
                      use_kernel: bool = False):
        """Batched execution with per-burst routing: maximal runs of
        batchable scans (the split ``Database.execute_batch`` makes) go
        whole to the cheapest replica, which runs them through its own
        ``execute_batch`` (its kernels); other statements flush the run
        and fan out through ``execute``."""
        out: list = [None] * len(queries)
        pending: list = []  # [(position, query)]

        def flush():
            if not pending:
                return
            self._poll_faults()
            r = self.route_burst([q for _, q in pending])
            self.routed_queries.append(r)
            if self._down[r]:
                # Recovery off: the whole burst went to a dead replica
                # and drops (its positions keep None stats).
                self.dropped_statements += len(pending)
                pending.clear()
                return
            d = self.dbs[r]
            res = d.execute_batch(
                [q for _, q in pending],
                observe=observe,
                use_kernel=use_kernel,
            )
            for (pos, _), st in zip(pending, res):
                out[pos] = st
            if observe:
                self._mirror_records(r, len(pending))
            self._sync_clock(d.clock_ms)
            pending.clear()

        for i, q in enumerate(queries):
            if q.kind == "scan" and q.join_table is None:
                pending.append((i, q))
            else:
                flush()
                out[i] = self.execute(q, observe=observe)
        flush()
        return out

    # -- Database surface: clock, flags, catalog views -------------------
    @property
    def clock_ms(self) -> float:
        return self.dbs[0].clock_ms

    @clock_ms.setter
    def clock_ms(self, value: float) -> None:
        self._sync_clock(value)

    @property
    def tables(self):
        return self.dbs[0].tables

    @property
    def monitor(self):
        return self.dbs[0].monitor

    @property
    def time_per_unit_ms(self) -> float:
        return self.dbs[0].time_per_unit_ms

    @property
    def num_shards(self) -> int:
        return self.dbs[0].num_shards

    @property
    def indexes(self) -> Dict[str, object]:
        """Merged catalog view (telemetry, phase drops): every
        replica's indexes by name, the first replica winning on
        duplicates.  A mirrored set reports replica 0's catalog."""
        merged: Dict[str, object] = {}
        for d in self.dbs:
            for name, bi in d.indexes.items():
                merged.setdefault(name, bi)
        return merged

    def drop_index(self, name: str) -> None:
        for d in self.dbs:
            d.drop_index(name)

    def reshard(self, num_shards: int) -> None:
        for d in self.dbs:
            d.reshard(num_shards)

    def _fan_flag(name: str):  # noqa: N805 - descriptor factory
        def get(self):
            return getattr(self.dbs[0], name)

        def set_(self, value):
            for d in self.dbs:
                setattr(d, name, value)

        return property(get, set_)

    shard_aware_tuning = _fan_flag("shard_aware_tuning")
    crack_on_scan = _fan_flag("crack_on_scan")
    crack_pages_per_scan = _fan_flag("crack_pages_per_scan")
    index_decay = _fan_flag("index_decay")
    fault_injector = _fan_flag("fault_injector")
    del _fan_flag


class ReplicaSetTuner:
    """Tuner protocol over a ReplicaSet: one PredictiveTuner per
    replica (replica 0's is the wrapped tuner), one decide per cycle.

    Mirrored mode runs every lane's decide on the same global window
    and queues replica 0's quanta untagged, so the build queue and all
    accounting downstream equal the single engine's.  Divergent mode
    first shares the cycle's page budget across lanes by demand
    (``cost_model.allocate_cycle_budget``), then runs each lane's decide
    on its cluster of the window with its budget share, and tags the
    quanta with the lane id."""

    scheme = "vap"

    def __init__(self, rs: ReplicaSet, tuner: PredictiveTuner):
        self.rs = rs
        self.name = getattr(tuner, "name", "predictive")
        self.tuners: List[PredictiveTuner] = [tuner]
        for r in range(1, len(rs.dbs)):
            self.tuners.append(
                clone_tuner(tuner, rs.dbs[r], share_cfg=not rs.divergent)
            )

    @property
    def cfg(self):
        """Replica 0's TunerConfig: mirrored lanes share the object, so
        runtime adaptations reach every lane; divergent lanes own
        copies and adapt on their own."""
        return self.tuners[0].cfg

    def on_query(self, q, stats) -> float:
        return self.tuners[0].on_query(q, stats)

    # -- decide / apply split --------------------------------------------
    def decide(self, idle: bool = False) -> CyclePlan:
        if not self.rs.divergent:
            plans = [t.decide(idle=idle) for t in self.tuners]
            return CyclePlan(
                quanta=list(plans[0].quanta),
                decide_work=max(p.decide_work for p in plans),
            )
        return self._decide_divergent(idle)

    def tuning_cycle(self, idle: bool = False) -> float:
        """Serialized cycle: decide, then apply inline, charging the
        max over lanes (replicas build in parallel)."""
        plan = self.decide(idle=idle)
        lane_work: Dict[Optional[int], float] = {}
        for quantum in plan.quanta:
            lane_work[quantum.replica] = lane_work.get(
                quantum.replica, 0.0
            ) + apply_quantum(self.rs, quantum)
        return plan.decide_work + max(lane_work.values(), default=0.0)

    def _lane_budget_shares(self, assign: List[int]) -> List[int]:
        """Split the cycle's page budget across lanes: weight = the
        lane's share of the window (its cluster's record count), cap =
        the pages its building indexes still need (a lane with demand
        but no building index may take the whole budget, so that its
        first create does not starve)."""
        budget = self.tuners[0].cfg.max_build_pages_per_cycle
        utils: List[float] = []
        remaining: List[int] = []
        for r, (t, d) in enumerate(zip(self.tuners, self.rs.dbs)):
            cnt = sum(1 for a in assign if a == r)
            left = sum(
                t._build_pages_left(b)
                for b in d.indexes.values()
                if b.scheme == "vap" and b.building
            )
            if left == 0 and cnt > 0:
                left = budget
            utils.append(float(cnt))
            remaining.append(int(left))
        shares = cm.allocate_cycle_budget(utils, remaining, budget, budget)
        return [int(s) for s in shares]

    def _decide_divergent(self, idle: bool) -> CyclePlan:
        rs = self.rs
        # Prune every replica's global window alike BEFORE clustering,
        # so each lane's filtered view derives from the same window.
        for d in rs.dbs:
            d.monitor.prune(d.clock_ms)
        records = list(rs.dbs[0].monitor.records)
        assign = cluster_assignments(records, len(rs.dbs))
        shares = self._lane_budget_shares(assign)
        quanta: List[BuildQuantum] = []
        works: List[float] = [0.0]
        for r, (t, d) in enumerate(zip(self.tuners, rs.dbs)):
            lane_recs = [
                rec for rec, a in zip(records, assign) if a == r or a < 0
            ]
            orig = d.monitor.records
            d.monitor.records = deque(lane_recs)
            old_budget = t.cfg.max_build_pages_per_cycle
            t.cfg.max_build_pages_per_cycle = shares[r]
            try:
                plan = t.decide(idle=idle)
            finally:
                t.cfg.max_build_pages_per_cycle = old_budget
                d.monitor.records = orig
            works.append(plan.decide_work)
            quanta.extend(replace(q, replica=r) for q in plan.quanta)
        return CyclePlan(quanta=quanta, decide_work=max(works))


def replica_index_summary(rs: ReplicaSet) -> List[Tuple[int, List[str]]]:
    """Per-replica catalog listing (telemetry, tests): sorted index
    names per replica id."""
    return [(r, sorted(d.indexes)) for r, d in enumerate(rs.dbs)]

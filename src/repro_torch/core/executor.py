"""Query execution: the Database facade over the planner/engine split.

Port of ``repro.core.executor.Database``.  Owns the
tables, built indexes and layout state of one database and executes
benchmark statements, returning *measured* statistics in the same
tuple-touch units the what-if cost model estimates in.  Cost, latency,
the simulated clock and the monitor window are computed exactly as in
the reference; only ``ExecStats.wall_s`` (the clock reading of the
tracer span around the dispatch, synchronised with the device when
the table lives on CUDA; ``repro_torch.telemetry``) and ``tier``
differ by nature.

Coverage-bitmap tuning is ported: with ``crack_on_scan`` or
``index_decay`` set before an index is created, the VAP index carries
a ``PageCoverage`` bitmap; scans then adopt pages they table-scanned
(``_crack_adopt``), build quanta may name explicit page lists, and the
tuner's decay pass clears cold pages.

Sharded storage is ported: pass ``num_shards > 1`` (or call
``reshard``) to partition every table round-robin by page, or hand in
pre-sharded ``ShardedTable``s, which are adopted as they are.  Results
and accounting equal the single-shard engine's for any shard count.
``vap_build_step(shard=)`` builds one shard's local prefix; the index
then stitches per shard (``pershard_built``).  With
``shard_aware_tuning`` set, every scan on sharded storage reports the
pages it table-scans per shard (``ExecStats.shard_pages``, also in its
monitor record): the heat signal of the tuner's per-shard quanta.

Value-based partial (VBP) indexes are ported: ``create_index(...,
"vbp")`` makes one (a ``ShardedVbpState`` on sharded storage), the
baseline tuners populate it through ``vbp_populate``, a covered
sub-domain plans a pure index scan over it, and every INSERT and
UPDATE drops its coverage claims.  So are HIGH-S equi-joins
(``_exec_join``): the pair count is taken on the table's device from
the outer scan's contrib planes and the sorted live inner values.

Fault injection is ported for one engine: with a ``fault_injector``
(``repro_torch.faults.FaultInjector``) every single scan and every
batched group dispatch draws once, after its latency is priced, for
transient retries (each pays the dispatch's latency again) and
straggler time (a group shares it evenly over its members).  The
draws are counter-based, so they fall exactly where the reference's
do; results never change, only latency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import IndexDescriptor
from repro_torch.core.engine import ScanEngine, ShardScanResult
from repro_torch.core.index import (
    ShardedIndex,
    ShardedVbpState,
    advance_build,
    advance_build_shard,
    build_page_list,
    coverage_from_state,
    eligible_global_pages,
    make_index,
    make_sharded_index,
    make_sharded_vbp,
    make_vbp,
    shard_full_pages,
    sharded_vbp_populate_subdomain,
    vbp_invalidate_coverage,
    vbp_n_entries,
    vbp_populate_subdomain,
)
from repro_torch.core.layout import LayoutState, scan_width_factor
from repro_torch.core.monitor import QueryRecord, WorkloadMonitor
from repro_torch.core.planner import (
    BuiltIndex,
    IntervalUnion,
    QueryPlanner,
    scan_cost,
)
from repro_torch.core.table import (
    ShardedTable,
    Table,
    insert_rows,
    round_robin_layout,
    shard_table,
    sharded_insert_rows,
    sharded_update_rows,
    unshard_table,
    update_rows,
)


@dataclass
class Query:
    kind: str  # 'scan' | 'update' | 'insert'
    table: str
    attrs: Tuple[int, ...] = ()
    los: Tuple[int, ...] = ()
    his: Tuple[int, ...] = ()
    agg_attr: int = 2
    proj_attrs: Tuple[int, ...] = ()
    set_attrs: Tuple[int, ...] = ()
    set_vals: Tuple[int, ...] = ()
    rows: Optional[np.ndarray] = None  # INSERT payload
    # HIGH-S equi-join: R.join_attr == S.join_inner_attr
    join_table: Optional[str] = None
    join_attr: int = 0
    join_inner_attr: int = 0
    template: str = ""

    @property
    def accessed_attrs(self) -> Tuple[int, ...]:
        return tuple(
            sorted(
                set(self.attrs)
                | set(self.proj_attrs)
                | ({self.agg_attr} if self.kind == "scan" else set())
                | set(self.set_attrs)
            )
        )


@dataclass
class ExecStats:
    cost_units: float  # tuple-touch units (simulated work)
    latency_ms: float  # simulated latency
    wall_s: float  # measured wall time of the dispatch
    used_index: bool
    agg_sum: int = 0
    count: int = 0
    rows_modified: int = 0
    populate_units: float = 0.0  # in-query VBP population work
    shard_pages: Tuple[int, ...] = ()  # shard-aware tuning only
    tier: str = ""  # ScanEngine.TIERS


class Database:
    """Tables + index configuration + layout + monitor + simulated clock."""

    def __init__(
        self,
        tables: Dict[str, object],
        time_per_unit_ms: float = 1e-4,
        monitor_window: int = 256,
        monitor_max_age_ms: float | None = None,
        num_shards: int = 1,
    ):
        for name, t in tables.items():
            if not isinstance(t, (Table, ShardedTable)):
                raise TypeError(f"table {name!r} is a {type(t).__name__}")
        self.tables: Dict[str, object] = dict(tables)
        self.num_shards = 1
        self.indexes: Dict[str, BuiltIndex] = {}
        self.layouts: Dict[str, LayoutState] = {
            name: LayoutState(n_attrs=t.n_attrs, n_pages=t.n_pages)
            for name, t in self.tables.items()
        }
        self.monitor = WorkloadMonitor(
            window=monitor_window, max_age_ms=monitor_max_age_ms
        )
        self.clock_ms: float = 0.0
        self.time_per_unit_ms = time_per_unit_ms
        self.update_cap = 512  # max rows materialised per UPDATE
        # Coverage-bitmap tuning: ``crack_on_scan`` lets a scan adopt
        # pages it just table-scanned into a matching building VAP
        # index; ``index_decay`` lets the tuner drop cold built pages
        # under the storage cap.  Both default off: then no index
        # carries a PageCoverage and every scan keeps the legacy
        # prefix paths.
        self.crack_on_scan: bool = False
        self.crack_pages_per_scan: int = 8
        self.index_decay: bool = False
        # Shard-aware tuning: scans record per-shard page-access
        # counters and build quanta may target single shards.
        # ``pershard_built`` tracks indexes whose shard-local prefixes
        # were built by shard-targeted quanta (``vap_build_step(
        # shard=)``): their hybrid scans stitch per shard.
        self.shard_aware_tuning: bool = False
        self.pershard_built: set = set()
        # Fault injection (repro_torch.faults.FaultInjector): consulted
        # once per scan dispatch for transient retries and straggler
        # latency.  None (the default) skips every consult.
        self.fault_injector = None
        self._round_robin_cache: Dict[str, bool] = {}
        self._zone_maps: Dict[tuple, tuple] = {}
        self.planner = QueryPlanner(self)
        self.engine = ScanEngine()
        counts = {t.n_shards for t in self.tables.values()
                  if isinstance(t, ShardedTable)}
        if num_shards > 1:
            self.reshard(num_shards)
        elif counts:
            # Adopt pre-sharded tables as they are when the layout is
            # uniform; rebuild only to normalise a mixed layout.
            target = max(counts)
            if counts == {target} and all(
                isinstance(t, ShardedTable) for t in self.tables.values()
            ):
                self.num_shards = target
            else:
                self.reshard(target)

    @property
    def device(self) -> torch.device:
        return next(iter(self.tables.values())).device

    def reshard(self, num_shards: int) -> None:
        """Re-partition every table round-robin over ``num_shards``.
        Built indexes are dropped (their rid spaces change); tuners
        rebuild them.  Layout state survives: page ids are global
        either way."""
        for name in list(self.indexes):
            self.drop_index(name)
        for name, t in self.tables.items():
            if isinstance(t, ShardedTable):
                t = unshard_table(t)
            self.tables[name] = (
                shard_table(t, num_shards) if num_shards > 1 else t
            )
        self.num_shards = num_shards
        self._round_robin_cache.clear()
        self._zone_maps.clear()

    def table_is_round_robin(self, name: str) -> bool:
        """Cached: does ``name``'s layout map global page ids
        round-robin onto shards?  The mutators keep the answer, so it
        changes only on reshard (which clears the cache)."""
        got = self._round_robin_cache.get(name)
        if got is None:
            t = self.tables[name]
            got = not isinstance(t, ShardedTable) or round_robin_layout(t)
            self._round_robin_cache[name] = got
        return got

    def _timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` as the tracer span ``name`` and return (result,
        wall seconds of finished work): device work is synchronised
        inside the span, whose clock reading is the wall time."""
        with telemetry.stopwatch(name) as sw:
            out = fn(*args, **kwargs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return out, sw.seconds

    # ------------------------------------------------------------------
    # Index configuration actions (used by tuners)
    # ------------------------------------------------------------------
    def create_index(self, desc: IndexDescriptor, scheme: str) -> BuiltIndex:
        t = self.tables[desc.table]
        if desc.name in self.indexes:
            return self.indexes[desc.name]
        bi = BuiltIndex(desc=desc, scheme=scheme, created_ms=self.clock_ms)
        sharded = isinstance(t, ShardedTable)
        if scheme in ("vap", "full"):
            bi.vap = (make_sharded_index(t) if sharded
                      else make_index(t.capacity, t.device))
            self.ensure_coverage(bi)
        else:
            bi.vbp = (make_sharded_vbp(t) if sharded
                      else make_vbp(t.capacity, t.device))
            bi.cov_union = IntervalUnion()
        self.indexes[desc.name] = bi
        return bi

    def drop_index(self, name: str) -> None:
        self.indexes.pop(name, None)
        self.pershard_built.discard(name)

    def indexes_on(self, table: str):
        return [b for b in self.indexes.values() if b.desc.table == table]

    def total_index_bytes(self) -> float:
        return sum(b.size_bytes() for b in self.indexes.values())

    def ensure_coverage(self, bi: BuiltIndex) -> bool:
        """Attach a built-page bitmap to a VAP index when coverage
        tuning is on (``crack_on_scan`` / ``index_decay``), seeded from
        the index's built prefix.  Once attached, every build goes
        through ``vap_build_step``'s page lists: replaying
        ``advance_build`` over covered pages would duplicate entries."""
        if bi.coverage is not None:
            return True
        if (
            bi.scheme != "vap"
            or not (self.crack_on_scan or self.index_decay)
            or not self.table_is_round_robin(bi.desc.table)
        ):
            return False
        bi.coverage = coverage_from_state(bi.vap, self.tables[bi.desc.table])
        return True

    def coverage_pages_left(self, bi: BuiltIndex) -> int:
        """Uncovered fully populated pages of a bitmap-mode index."""
        t = self.tables[bi.desc.table]
        eligible = eligible_global_pages(t)
        return int((~bi.coverage.built[eligible]).sum())

    def zone_map(self, table: str, attr: int):
        """Per-GLOBAL-page (min, max) of ``attr`` over the fully
        populated pages (advisory page-pruning metadata); pages outside
        the full watermark get an empty (max < min) range.  Sharded
        storage spans ``S * max_pages`` global ids.  Cached per (table,
        attr) until the table mutates."""
        key = (table, attr)
        got = self._zone_maps.get(key)
        if got is not None:
            return got
        t = self.tables[table]
        psz = t.page_size
        if isinstance(t, ShardedTable):
            S = t.n_shards
            n_global = S * t.max_pages
            parts = [(s + S * np.arange(r // psz), t.data[s, : r // psz])
                     for s, r in enumerate(t.local_rows) if r // psz]
        else:
            n_global = t.n_pages
            full = t.n_rows // psz
            parts = [(np.arange(full), t.data[:full])] if full else []
        mins = np.full(n_global, np.iinfo(np.int32).max, np.int64)
        maxs = np.full(n_global, np.iinfo(np.int32).min, np.int64)
        for gids, pages in parts:
            vals = pages[:, :, attr]
            mins[gids] = vals.amin(dim=1).cpu().numpy()
            maxs[gids] = vals.amax(dim=1).cpu().numpy()
        got = (mins, maxs)
        self._zone_maps[key] = got
        return got

    def _choose_index(self, q: Query) -> Optional[BuiltIndex]:
        return self.planner.choose_index(q)

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def execute(self, q: Query, observe: bool = True) -> ExecStats:
        with telemetry.span("executor.execute"):
            return self._execute(q, observe)

    def _execute(self, q: Query, observe: bool) -> ExecStats:
        if q.kind == "scan":
            stats = self._exec_scan(q)
        elif q.kind == "update":
            stats = self._exec_update(q)
        elif q.kind == "insert":
            stats = self._exec_insert(q)
        else:
            raise ValueError(q.kind)
        self.engine.dispatch_complete()
        self.clock_ms += stats.latency_ms
        if observe:
            n_rows = self.tables[q.table].n_rows
            self.monitor.observe(
                QueryRecord(
                    kind=q.kind,
                    table=q.table,
                    pred_attrs=tuple(q.attrs),
                    accessed_attrs=q.accessed_attrs,
                    selectivity=(
                        stats.count / max(n_rows, 1)
                        if q.kind == "scan"
                        else stats.rows_modified / max(n_rows, 1)
                    ),
                    tuples_scanned=int(stats.cost_units),
                    used_index=stats.used_index,
                    rows_modified=stats.rows_modified,
                    ts_ms=self.clock_ms,
                    template=q.template,
                    shard_pages=stats.shard_pages,
                    pred_ranges=tuple(zip(q.attrs, q.los, q.his)),
                )
            )
            if q.join_table is not None:
                # The inner side of an equi-join is an indexable access
                # path too (HIGH-S benefits from join-attribute indexes).
                n_inner = self.tables[q.join_table].n_rows
                self.monitor.observe(
                    QueryRecord(
                        kind="scan",
                        table=q.join_table,
                        pred_attrs=(q.join_inner_attr,),
                        selectivity=min(stats.count / max(n_inner, 1), 1.0),
                        tuples_scanned=n_inner,
                        used_index=stats.used_index,
                        rows_modified=0,
                        ts_ms=self.clock_ms,
                        template=q.template + ":join",
                    )
                )
        return stats

    def _exec_scan(self, q: Query) -> ExecStats:
        t = self.tables[q.table]
        layout = self.layouts[q.table]
        plan = self.planner.plan_scan(q)
        bi = plan.index
        r, wall = self._timed(
            "engine.dispatch",
            self.engine.scan,
            t,
            plan,
            tuple(q.attrs),
            q.los,
            q.his,
            self.clock_ms_i32(),
            q.agg_attr,
            contribs=q.join_table is not None,
        )
        vals = torch.stack([r.agg_sum, r.count, r.pages_scanned,
                            r.entries_probed, r.start_page]).tolist()
        agg_sum, count, pages, probed, r_start = vals
        if plan.path == "table":
            start_page, entries = 0, 0.0
        elif plan.path in ("hybrid", "hybrid_ps", "hybrid_masked"):
            start_page, entries = r_start, float(probed)
        else:  # pure index scan: no table pages touched
            start_page, entries = t.n_pages, float(probed)
        cost = scan_cost(
            layout, q.accessed_attrs, t.page_size, pages, entries, start_page
        )
        populate = self._crack_adopt(q, plan, start_page)
        cost += populate
        used = bi is not None
        if used:
            bi.last_used_ms = self.clock_ms
        if q.join_table is not None:
            count, join_cost, join_used = self._exec_join(q, r)
            cost += join_cost
            used = used or join_used
        lat_ms = cost * self.time_per_unit_ms
        if self.fault_injector is not None:
            # Transient errors re-issue the dispatch (its latency is
            # paid again per retry); stragglers add flat extra time.
            # Guarded so a fault-free draw leaves lat_ms untouched.
            retries, extra_ms = self.fault_injector.scan_fault()
            if retries or extra_ms:
                lat_ms += retries * lat_ms + extra_ms
        return ExecStats(
            cost_units=cost,
            latency_ms=lat_ms,
            wall_s=wall,
            used_index=used,
            agg_sum=agg_sum,
            count=count,
            populate_units=populate,
            shard_pages=self._shard_pages_of(t, plan),
            tier=self.engine.last_tier or "",
        )

    def _crack_adopt(self, q: Query, plan, start_page: int) -> float:
        """Crack-on-scan: adopt up to ``crack_pages_per_scan`` of the
        pages this scan just table-scanned into a matching building
        bitmap-mode VAP index (``build_page_list`` + bit flips).  The
        extraction and merge work is charged to the triggering query
        and reported as ``populate_units``."""
        if not self.crack_on_scan or plan.path not in (
            "table", "hybrid", "hybrid_ps", "hybrid_masked"
        ):
            return 0.0
        bi = plan.index
        if bi is None:
            # Full table scans crack too: any building bitmap index
            # whose leading key the predicate constrains may adopt.
            for cand in self.indexes_on(q.table):
                if (
                    cand.scheme == "vap"
                    and cand.building
                    and cand.coverage is not None
                    and cm.index_matches(cand.desc, q.table, q.attrs)
                ):
                    bi = cand
                    break
        if (
            bi is None
            or bi.scheme != "vap"
            or not bi.building
            or bi.coverage is None
        ):
            return 0.0
        t = self.tables[q.table]
        cov = bi.coverage
        eligible = eligible_global_pages(t)
        # Pages the scan visited: the table-scan region starts at the
        # stitch point (0 for full scans; under the masked stitch every
        # uncovered page lies at or past the covered prefix).
        open_pages = eligible[(eligible >= start_page) & ~cov.built[eligible]]
        take = open_pages[: self.crack_pages_per_scan]
        if take.size == 0:
            return 0.0
        with telemetry.span("executor.crack_adopt"):
            self._cover_pages(bi, t, take, eligible)
        telemetry.count("index.pages_adopted", take.size)
        return float(take.size * t.page_size)

    def _shard_pages_of(self, t, plan) -> Tuple[int, ...]:
        """Per-shard pages the planned access path table-scans -- the
        monitor's shard-heat signal (advisory: it sizes build quanta,
        never results or accounting, so this host-side form ignores the
        transient rho_m part of the stitch)."""
        if not (self.shard_aware_tuning and isinstance(t, ShardedTable)):
            return ()
        psz = t.page_size
        lused = [(r + psz - 1) // psz for r in t.local_rows]
        if plan.path == "table":
            return tuple(lused)
        if plan.path == "hybrid_masked" and plan.pinned_coverage is not None:
            built, S = plan.pinned_coverage.built_host, t.n_shards
            return tuple(
                int(u - built[s + S * np.arange(u)].sum())
                for s, u in enumerate(lused)
            )
        state = plan.index_state
        if plan.path in ("hybrid", "hybrid_ps") and isinstance(
            state, ShardedIndex
        ):
            return tuple(
                max(u - b, 0) for u, b in zip(lused, state.shard_built)
            )
        return (0,) * t.n_shards  # pure index scan

    @staticmethod
    def _cover_pages(bi: BuiltIndex, t, take, eligible) -> None:
        """Index the pages ``take`` and set their coverage bits; the
        index closes once every eligible page is covered."""
        if take.size:
            bi.vap = build_page_list(bi.vap, t, bi.desc.key_attrs, take)
            bi.coverage.set_pages(take)
        if bi.coverage.built[eligible].all():
            bi.complete = True
            bi.building = False

    # ------------------------------------------------------------------
    # Batched execution (read bursts)
    # ------------------------------------------------------------------
    def execute_batch(
        self, queries, observe: bool = True, use_kernel: bool = False
    ):
        """Execute a burst of queries, batching compatible read scans.

        Scans that share (table, attrs, agg_attr) and access path run
        in ONE dispatch (with ``use_kernel`` the table-scan and hybrid
        groups go through kernel K1).  Results and accounting are
        bit-identical to ``[self.execute(q) for q in queries]``: a run
        of consecutive scans executes against the burst-start snapshot
        (reads do not mutate, and every version predates it), cost /
        clock / monitor accounting is replayed per query in order, and
        mutations flush the pending burst and run through ``execute``.
        Returns the per-query ``ExecStats`` in input order.
        """
        out: list = [None] * len(queries)
        pending: list = []  # [(position, query)]

        def flush():
            if pending:
                self._exec_scan_burst(pending, out, observe, use_kernel)
                pending.clear()

        with telemetry.span("executor.execute_batch"):
            for i, q in enumerate(queries):
                if q.kind == "scan" and q.join_table is None:
                    pending.append((i, q))
                else:
                    flush()
                    out[i] = self.execute(q, observe=observe)
            flush()
        return out

    def _exec_scan_burst(
        self, pending, out, observe: bool, use_kernel: bool
    ) -> None:
        """Plan, group and execute one burst of batchable scans."""
        self.planner.begin_snapshot()
        try:
            groups: Dict[tuple, list] = {}
            for pos, q in pending:
                plan = self.planner.plan_scan(q)
                key = (q.table, tuple(q.attrs), q.agg_attr) + plan.group_key
                groups.setdefault(key, []).append((pos, q, plan))

            ts = self.clock_ms_i32()
            # pos -> (sum, count, pages, entries, start_page, wall, tier)
            raw: Dict[int, tuple] = {}
            # pos -> (retries, straggler-share ms).  One fault draw per
            # GROUP dispatch (the dispatch is the fault domain); its
            # straggler latency is shared evenly across members.
            fault_by_pos: Dict[int, tuple] = {}
            for group_key, members in groups.items():
                table_name, attrs, agg_attr, _path, _idx = group_key
                t = self.tables[table_name]
                dev = t.device
                los = torch.tensor([q.los for _, q, _ in members],
                                   dtype=torch.int32, device=dev)
                his = torch.tensor([q.his for _, q, _ in members],
                                   dtype=torch.int32, device=dev)
                tss = torch.full((len(members),), ts, dtype=torch.int32,
                                 device=dev)
                plan = members[0][2]
                r, wall = self._timed(
                    "engine.dispatch",
                    self.engine.scan_batch,
                    t,
                    plan.path,
                    plan.index_state,
                    plan.key_attrs,
                    attrs,
                    los,
                    his,
                    tss,
                    agg_attr,
                    use_kernel=use_kernel,
                    coverage=plan.pinned_coverage,
                )
                tier = self.engine.last_tier or ""
                # Drain point between this group's dispatch and the
                # next, outside the timed region: ``_timed`` waits for
                # the group's kernels before it reads the clock, so a
                # quantum's work never lands in a group's wall time.
                self.engine.dispatch_complete()
                if self.fault_injector is not None:
                    retries, extra_ms = self.fault_injector.scan_fault()
                    if retries or extra_ms:
                        share = extra_ms / len(members)
                        for pos, _q, _plan in members:
                            fault_by_pos[pos] = (retries, share)
                rows = torch.stack(list(r)).cpu().tolist()
                for k, (pos, _q, _plan) in enumerate(members):
                    raw[pos] = tuple(int(col[k]) for col in rows) + (
                        wall / len(members),
                        tier,
                    )
        finally:
            self.planner.end_snapshot()

        # Accounting replay in input order (host-side, same arithmetic
        # and clock/monitor trajectory as the per-query loop).
        plan_by_pos = {
            pos: plan for ms in groups.values() for pos, _q, plan in ms
        }
        for pos, q in pending:
            agg_sum, count, n_pages, n_entries, start_page, wall, tier = raw[
                pos
            ]
            t = self.tables[q.table]
            layout = self.layouts[q.table]
            plan_q = plan_by_pos[pos]
            bi_q = plan_q.index
            cost = scan_cost(
                layout,
                q.accessed_attrs,
                t.page_size,
                n_pages,
                float(n_entries),
                start_page,
            )
            # Crack adoption replays per query, in order, as in the
            # sequential loop; the results stay burst-consistent since
            # every dispatch above ran against the pinned views.
            populate = self._crack_adopt(q, plan_q, start_page)
            cost += populate
            used = bi_q is not None
            if used:
                bi_q.last_used_ms = self.clock_ms
            lat_ms = cost * self.time_per_unit_ms
            if pos in fault_by_pos:
                retries, share = fault_by_pos[pos]
                lat_ms += retries * lat_ms + share
            stats = ExecStats(
                cost_units=cost,
                latency_ms=lat_ms,
                wall_s=wall,
                used_index=used,
                agg_sum=agg_sum,
                count=count,
                populate_units=populate,
                shard_pages=self._shard_pages_of(t, plan_q),
                tier=tier,
            )
            self.clock_ms += stats.latency_ms
            if observe:
                self.monitor.observe(
                    QueryRecord(
                        kind="scan",
                        table=q.table,
                        pred_attrs=tuple(q.attrs),
                        accessed_attrs=q.accessed_attrs,
                        selectivity=stats.count / max(t.n_rows, 1),
                        tuples_scanned=int(stats.cost_units),
                        used_index=stats.used_index,
                        rows_modified=0,
                        ts_ms=self.clock_ms,
                        template=q.template,
                        shard_pages=stats.shard_pages,
                        pred_ranges=tuple(zip(q.attrs, q.los, q.his)),
                    )
                )
            out[pos] = stats

    def _exec_join(self, q: Query, outer):
        """HIGH-S equi-join: count the pairs between the outer scan's
        matches and the inner table's rows live at the snapshot on
        ``join_attr == join_inner_attr``.  Cost model: index nested
        loop when a VAP / FULL index leads with the inner join
        attribute, hash join (one inner pass) otherwise.  The count runs
        on the tables' device (the outer rows from the scan's contrib
        planes, the sorted live inner values, ``searchsorted``); only
        the count comes back.  Returns (pairs, cost, used_index)."""
        inner_t = self.tables[q.join_table]
        outer_t = self.tables[q.table]
        ts = int(self.clock_ms) + 1
        contrib = (outer.contribs if isinstance(outer, ShardScanResult)
                   else outer.contrib)
        outer_vals = outer_t.data[..., q.join_attr][contrib > 0]
        live = (inner_t.begin_ts <= ts) & (ts < inner_t.end_ts)
        inner_vals = torch.sort(inner_t.data[..., q.join_inner_attr][live]
                                ).values
        lo = torch.searchsorted(inner_vals, outer_vals, right=False)
        hi = torch.searchsorted(inner_vals, outer_vals, right=True)
        pairs = int((hi - lo).sum())

        n_outer = int(outer_vals.numel())
        n_inner = inner_t.n_rows
        inner_idx = None
        for bi in self.indexes_on(q.join_table):
            if (
                bi.desc.key_attrs
                and bi.desc.key_attrs[0] == q.join_inner_attr
                and bi.scheme in ("vap", "full")
            ):
                inner_idx = bi
                break
        if inner_idx is not None:
            frac = inner_idx.built_fraction(inner_t)
            probes = n_outer * (np.log2(max(n_inner, 2)) * cm.INDEX_PROBE_COST)
            cost = probes + (1.0 - frac) * n_inner
            inner_idx.last_used_ms = self.clock_ms
            return pairs, float(cost), True
        return pairs, float(n_inner), False

    def _exec_update(self, q: Query) -> ExecStats:
        t = self.tables[q.table]
        layout = self.layouts[q.table]
        (new_t, n_upd), wall = self._timed(
            "executor.update_rows",
            sharded_update_rows if isinstance(t, ShardedTable)
            else update_rows,
            t,
            tuple(q.attrs),
            q.los,
            q.his,
            tuple(q.set_attrs),
            tuple(q.set_vals),
            self.clock_ms_i32(),
            max_new=self.update_cap,
        )
        self.tables[q.table] = new_t
        # Row lookup: table scan unless an index matches the predicate.
        bi = self._choose_index(q)
        if bi is not None and bi.scheme in ("vap",):
            frac = bi.built_fraction(t)
            lookup = (
                1.0 - frac
            ) * float(t.n_rows) + cm.INDEX_PROBE_COST * n_upd
            bi.last_used_ms = self.clock_ms
        else:
            width = scan_width_factor(layout, tuple(q.attrs), 0)
            lookup = float(t.n_rows) * (width / layout.n_attrs)
        maint = cm.tau_maintenance(n_upd) * max(
            len(self.indexes_on(q.table)), 0
        )
        cost = lookup + maint + float(n_upd)
        self._after_mutation(q.table)
        return ExecStats(
            cost_units=cost,
            latency_ms=cost * self.time_per_unit_ms,
            wall_s=wall,
            used_index=bi is not None,
            rows_modified=n_upd,
        )

    def _exec_insert(self, q: Query) -> ExecStats:
        t = self.tables[q.table]
        rows = np.asarray(q.rows, np.int32)
        new_t, wall = self._timed(
            "executor.insert_rows",
            sharded_insert_rows if isinstance(t, ShardedTable)
            else insert_rows,
            t,
            torch.from_numpy(rows),
            self.clock_ms_i32(),
            rows.shape[0],
        )
        self.tables[q.table] = new_t
        n = rows.shape[0]
        maint = cm.tau_maintenance(n) * max(len(self.indexes_on(q.table)), 0)
        cost = float(n) + maint
        self._after_mutation(q.table)
        return ExecStats(
            cost_units=cost,
            latency_ms=cost * self.time_per_unit_ms,
            wall_s=wall,
            used_index=False,
            rows_modified=n,
        )

    def _after_mutation(self, table: str) -> None:
        """Inserted rows are unknown to VBP covering intervals: drop the
        coverage claims (entries stay; scans re-check visibility).
        Zone maps summarise page contents, so they re-derive too."""
        for key in [k for k in self._zone_maps if k[0] == table]:
            del self._zone_maps[key]
        for bi in self.indexes_on(table):
            if bi.scheme == "vbp":
                bi.vbp = vbp_invalidate_coverage(bi.vbp)
                bi.cov_union.clear()

    # ------------------------------------------------------------------
    # Tuner-side physical work, charged by the caller
    # ------------------------------------------------------------------
    def vap_build_step(self, bi: BuiltIndex, pages: int,
                       shard: Optional[int] = None,
                       page_list=None) -> float:
        """Advance a VAP/FULL index by one resumable build quantum of
        ``pages`` pages (``index.advance_build``); returns work units.
        On sharded storage the budget round-robins across shards in
        global page order -- unless ``shard`` targets one shard's local
        prefix, which relaxes the global prefix invariant and flips the
        index's hybrid scans to the per-shard stitch.  Bitmap-mode
        indexes (``bi.coverage`` attached) build through
        ``_coverage_build_step``: an explicit ``page_list`` quantum
        (hot-range-first), or the lowest uncovered pages."""
        t = self.tables[bi.desc.table]
        if bi.coverage is not None:
            return self._coverage_build_step(bi, t, pages, shard, page_list)
        if shard is None:
            bi.vap, done = advance_build(bi.vap, t, bi.desc.key_attrs, pages)
            full_pages = t.n_rows // t.page_size
        else:
            bi.vap, done = advance_build_shard(
                bi.vap, t, bi.desc.key_attrs, shard, pages)
            self.pershard_built.add(bi.desc.name)
            full_pages = sum(shard_full_pages(t))
        if bi.vap.built_pages >= full_pages:
            bi.complete = True
            bi.building = False
        telemetry.count("index.pages_built", done)
        return float(done * t.page_size)

    def _coverage_build_step(self, bi: BuiltIndex, t, pages: int,
                             shard: Optional[int], page_list) -> float:
        """Bitmap-mode build quantum.  Every entry goes through
        ``build_page_list``, never ``advance_build`` (the bitmap is the
        dedup authority).  A ``page_list`` is filtered against the live
        bitmap at apply time, so replaying a stale quantum is a no-op;
        with none the lowest uncovered pages build first, which is the
        legacy page order, and a ``shard`` target keeps only that
        shard's pages (p % S)."""
        cov = bi.coverage
        eligible = eligible_global_pages(t)
        open_mask = ~cov.built[eligible]
        if page_list is not None:
            open_set = set(eligible[open_mask].tolist())
            take = np.asarray(
                [int(p) for p in page_list if int(p) in open_set][
                    : int(pages)],
                np.int64,
            )
        else:
            open_pages = eligible[open_mask]
            if shard is not None and isinstance(t, ShardedTable):
                open_pages = open_pages[open_pages % t.n_shards == shard]
            take = open_pages[: int(pages)]
        self._cover_pages(bi, t, take, eligible)
        telemetry.count("index.pages_built", take.size)
        return float(take.size * t.page_size)

    def vbp_populate(self, bi: BuiltIndex, q: Query, max_add: int) -> float:
        """Populate the sub-domain ``q`` touches; returns work units
        (charged to the query by immediate-DL tuners: the latency
        spike).  Cost model: partitioning the still-uncracked region
        (early cracks touch nearly the whole column, later ones little)
        plus a sorted insertion per harvested entry; the population
        piggybacks on the query's own scan, so no scan term."""
        t = self.tables[bi.desc.table]
        max_add = min(int(max_add), t.capacity)
        entries_before = vbp_n_entries(bi.vbp)
        lo, hi = self.planner.vbp_bounds(bi, q)
        populate = (
            sharded_vbp_populate_subdomain
            if isinstance(bi.vbp, ShardedVbpState)
            else vbp_populate_subdomain
        )
        bi.vbp, n_added = populate(bi.vbp, t, bi.desc.key_attrs, lo, hi,
                                   self.clock_ms_i32(), max_add=max_add)
        if n_added < max_add:  # the whole sub-domain fit: now covered
            hlo, hhi = self.planner.vbp_host_key_bounds(bi, q)
            bi.cov_union.add(hlo, hhi)
        uncracked = max(t.n_rows - entries_before, 0)
        return float(n_added) * 8.0 + 0.5 * float(uncracked)

    def clock_ms_i32(self) -> int:
        """Snapshot timestamp of the next statement (int32 range)."""
        return min(int(self.clock_ms) + 1, 2**31 - 2)

"""What-if cost model (paper Section IV-B).

Estimates the optimizer cost eta(r) of a scan under the current index
configuration, eta(r, I) under a hypothetical extra index I, and the
maintenance cost tau(w, I) an index imposes on a mutator.  Costs are
in *tuple-touch units*: 1 unit == inspecting one tuple.  The same
units are produced by the execution engine's measured statistics
(ScanResult.pages_scanned etc.), so estimated and observed utilities
are directly comparable -- that is what lets the forecaster's
reinforcement signal be bootstrapped from what-if estimates (Algorithm
1) and then refined with observations.

    QPU(I, R) = sum_r  eta(r) - eta(r, I)        (query processing utility)
    IMC(I, W) = sum_w  tau(w, I)                 (index maintenance cost)
    OverallUtility = QPU - IMC
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.monitor import AttrSet, QueryRecord

# Relative per-tuple cost constants.  An index entry probe is cheaper
# than a heap-tuple inspection (sorted, narrow); maintenance writes are
# more expensive (sort insertion + space management).
INDEX_PROBE_COST = 0.25
MAINT_COST_PER_ROW = 2.0
PAGE_OVERHEAD = 0.0  # columnar pages: no per-page slop in tuple units


@dataclass(frozen=True)
class IndexDescriptor:
    """A (candidate or built) index: table + ordered key attributes."""

    table: str
    key_attrs: AttrSet

    @property
    def name(self) -> str:
        return f"{self.table}:{','.join(map(str, self.key_attrs))}"


def index_matches(
    desc: IndexDescriptor, table: str, pred_attrs: AttrSet
) -> bool:
    """Can ``desc`` accelerate a predicate over ``pred_attrs``?  The
    index's *leading* attribute must be constrained (classic B-tree /
    sorted-run matching rule)."""
    return (
        desc.table == table
        and len(desc.key_attrs) > 0
        and desc.key_attrs[0] in pred_attrs
    )


def eta_table_scan(n_rows: int) -> float:
    return float(n_rows) * (1.0 + PAGE_OVERHEAD)


def eta_with_index(
    n_rows: int,
    selectivity: float,
    built_fraction: float,
    covered_attrs: int,
    pred_attrs: int,
) -> float:
    """Cost of the (hybrid) scan using a partially built index.

    The indexed prefix costs selectivity * rows_indexed entry probes;
    the remainder is table scanned.  A fully built index degenerates
    to the classic log + matches formula; built_fraction == 0
    degenerates to a full table scan.  Indexes covering more of the
    predicate attributes filter better (smaller effective match set to
    post-process), modelled by a mild discount.
    """
    n = max(float(n_rows), 1.0)
    f = min(max(built_fraction, 0.0), 1.0)
    sel = min(max(selectivity, 0.0), 1.0)
    coverage_discount = 1.0 if covered_attrs >= pred_attrs else 1.25
    probe_cost = INDEX_PROBE_COST * coverage_discount
    probe = math.log2(n + 1.0) + sel * n * f * probe_cost
    rest = (1.0 - f) * n
    return probe + rest


def tau_maintenance(rows_modified: int) -> float:
    return MAINT_COST_PER_ROW * float(rows_modified)


def qpu(
    desc: IndexDescriptor,
    scans: Iterable[QueryRecord],
    n_rows: int,
    built_fraction: float = 1.0,
) -> float:
    """Query-processing utility of ``desc`` over the scan set (what-if:
    compares a plain table scan against the index at built_fraction)."""
    total = 0.0
    for r in scans:
        if not index_matches(desc, r.table, r.pred_attrs):
            continue
        covered = len(set(desc.key_attrs) & set(r.pred_attrs))
        with_idx = eta_with_index(
            n_rows, r.selectivity, built_fraction, covered, len(r.pred_attrs)
        )
        without = eta_table_scan(n_rows)
        total += max(without - with_idx, 0.0)
    return total


def imc(desc: IndexDescriptor, mutators: Iterable[QueryRecord]) -> float:
    """Index-maintenance cost of ``desc`` over the mutator set."""
    total = 0.0
    for w in mutators:
        if w.table != desc.table:
            continue
        total += tau_maintenance(w.rows_modified)
    return total


def overall_utility(
    desc: IndexDescriptor,
    scans,
    mutators,
    n_rows: int,
    built_fraction: float = 1.0,
) -> float:
    return qpu(desc, scans, n_rows, built_fraction) - imc(desc, mutators)


def update_lookup_utility(
    desc: IndexDescriptor, mutators: Iterable[QueryRecord], n_rows: int
) -> float:
    """Utility an index provides to UPDATE row lookup (the paper keeps
    such indexes even in write-intensive phases, footnote 1)."""
    total = 0.0
    for w in mutators:
        if w.kind != "update":
            continue
        if not index_matches(desc, w.table, w.pred_attrs):
            continue
        covered = len(set(desc.key_attrs) & set(w.pred_attrs))
        with_idx = eta_with_index(
            n_rows, w.selectivity, 1.0, covered, len(w.pred_attrs)
        )
        total += max(eta_table_scan(n_rows) - with_idx, 0.0)
    return total


def index_size_bytes(n_rows: int) -> float:
    """Estimated storage footprint: 12 bytes/entry (two int32 key
    components + int32 rid)."""
    return 12.0 * float(n_rows)


# ---------------------------------------------------------------------------
# Per-shard build utility (shard-aware tuning)
# ---------------------------------------------------------------------------
#
# On sharded storage the what-if utility of ONE more built page is not
# uniform: a page on a shard whose table-scan suffix the workload keeps
# touching saves ``page_size`` tuple-touches per future scan, while a
# page on a cold (or already fully built) shard saves nothing.  The
# monitor's per-shard page-access counters measure the former; the
# remaining-unbuilt-page vector caps the latter.  These are advisory
# signals -- they drive the tuner's build *schedule*, never query
# results or accounting.


def shard_build_utility(
    heat: Sequence[float], remaining: Sequence[int], page_size: int
) -> np.ndarray:
    """Forecast utility of the next built page, per shard.

    ``heat`` is (forecast) pages-scanned per shard over the window;
    ``remaining`` the unbuilt fully-populated pages per shard.  A shard
    with nothing left to build has zero utility regardless of heat; a
    shard with work left keeps a small floor so fresh shards (no
    observations yet) still receive budget."""
    heat = np.asarray(heat, np.float64)
    remaining = np.asarray(remaining, np.int64)
    util = (heat + 1.0) * float(page_size)
    return np.where(remaining > 0, util, 0.0)


def allocate_build_pages(
    utilities: Sequence[float], remaining: Sequence[int], budget: int
) -> np.ndarray:
    """Split one cycle's page ``budget`` across shards proportionally
    to forecast utility, capped by each shard's remaining pages.

    Deterministic (largest-remainder rounding, ties to the lower shard
    id) so serialized and deterministic-async schedules emit identical
    per-shard quanta.  Unplaceable budget -- every positive-utility
    shard already full -- is simply not allocated: unlike the global
    round-robin this never wastes cycles on complete shards."""
    util = np.asarray(utilities, np.float64)
    remaining = np.asarray(remaining, np.int64)
    alloc = np.zeros(len(util), np.int64)
    budget = int(budget)
    while budget > 0:
        open_mask = (remaining - alloc > 0) & (util > 0.0)
        if not open_mask.any():
            break
        w = np.where(open_mask, util, 0.0)
        share = w * (budget / w.sum())
        floor = np.minimum(np.floor(share).astype(np.int64), remaining - alloc)
        left = budget - int(floor.sum())
        if left > 0:
            # largest fractional remainder first; ties to lower shard id
            frac = np.where(
                open_mask & (floor < remaining - alloc),
                share - np.floor(share),
                -1.0,
            )
            order = np.lexsort((np.arange(len(util)), -frac))
            for s in order:
                if left <= 0 or frac[s] < 0.0:
                    break
                floor[s] += 1
                left -= 1
        if floor.sum() == 0:
            break  # nothing placeable this round
        alloc += floor
        budget = left
    return alloc


def allocate_cycle_budget(
    utilities: Sequence[float],
    remaining: Sequence[int],
    budget: int,
    per_index_cap: int,
) -> np.ndarray:
    """Split one cycle's global page budget ACROSS building indexes by
    forecast utility -- the cross-index twin of
    ``allocate_build_pages`` (which splits ONE index's slice across
    its shards).

    Historically every building index took a fixed
    ``pages_per_cycle`` slice in catalog order until the cycle budget
    ran out, so a cold index ahead in the catalog could starve a hot
    one behind it.  Here the whole ``budget`` is utility-proportional:
    each index keeps a +1 utility floor (fresh indexes with no
    forecast yet must still build) masked by work left, and stays
    capped at ``min(remaining, per_index_cap)``; cap overflow
    redistributes to the other indexes by the same deterministic
    largest-remainder rule, so the cycle budget is spent whenever any
    index can absorb it.  Complete indexes receive nothing.
    """
    util = np.asarray(utilities, np.float64)
    remaining = np.asarray(remaining, np.int64)
    weights = np.where(remaining > 0, np.maximum(util, 0.0) + 1.0, 0.0)
    cap = np.minimum(remaining, int(per_index_cap))
    return allocate_build_pages(weights, cap, budget)

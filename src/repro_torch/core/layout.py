"""Incremental storage-layout tuner (paper Section VI-D).

DBMS-X pairs the index tuner with a layout tuner that morphs pages
from the default row-oriented layout (NSM) towards a hybrid layout
that co-locates attributes accessed together, so scans touch only the
bytes they need.  We model a table's layout as a partition of its
attributes into groups plus a per-page ``transformed`` bitmap; the
tuner transforms a bounded number of pages per cycle (the paper
measures ~2.6 ms per 1000-tuple page) towards the current target
grouping, derived greedily from the monitor's attribute co-access
statistics.

The effective scan cost of a page, in attribute-touch units per tuple:

* untransformed page: ``n_attrs``      (row store reads whole tuples)
* transformed page:   total width of the groups that intersect the
  query's accessed-attribute set (predicate + projection + aggregate)

so a transformed page with a well-matched grouping costs only the
accessed attributes.  This is the quantity ``scan_width_factor``
returns; the executor multiplies it into the table-scan component of
a query's cost.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

LAYOUT_TRANSFORM_MS_PER_PAGE = 2.6 * (1.0 / 1000.0)  # per tuple, paper: 2.6ms/1000-tuple page


@dataclass
class LayoutState:
    """Layout of one table."""

    n_attrs: int
    n_pages: int
    groups: List[Tuple[int, ...]] = field(default_factory=list)
    transformed: np.ndarray = None  # (n_pages,) bool
    target_groups: List[Tuple[int, ...]] = field(default_factory=list)

    def __post_init__(self):
        if not self.groups:
            self.groups = [tuple(range(self.n_attrs))]  # NSM: one fat group
        if self.transformed is None:
            self.transformed = np.zeros(self.n_pages, bool)
        if not self.target_groups:
            self.target_groups = list(self.groups)


def derive_target_groups(n_attrs: int, accessed_sets: Sequence[Tuple[int, ...]]
                         ) -> List[Tuple[int, ...]]:
    """Greedy grouping from co-access statistics: the most frequent
    accessed-attribute set becomes a leading group, then the next most
    frequent over the remaining attributes, etc.; leftovers form a
    tail group.  (H2O/Peloton-style greedy partitioning.)"""
    remaining = set(range(n_attrs))
    counts = Counter(tuple(sorted(s)) for s in accessed_sets if s)
    groups: List[Tuple[int, ...]] = []
    for aset, _ in counts.most_common():
        take = tuple(sorted(set(aset) & remaining))
        if len(take) == 0:
            continue
        groups.append(take)
        remaining -= set(take)
        if not remaining:
            break
    if remaining:
        groups.append(tuple(sorted(remaining)))
    return groups


@dataclass
class LayoutTuner:
    """Transforms ``pages_per_cycle`` pages toward the target grouping
    each tuning cycle; returns the simulated milliseconds spent."""

    pages_per_cycle: int = 64
    page_size: int = 1024

    def retarget(self, state: LayoutState,
                 accessed_sets: Sequence[Tuple[int, ...]]) -> None:
        target = derive_target_groups(state.n_attrs, accessed_sets)
        if target != state.target_groups:
            state.target_groups = target
            state.transformed[:] = False  # re-morph toward the new target

    def cycle(self, state: LayoutState) -> float:
        todo = np.nonzero(~state.transformed)[0][: self.pages_per_cycle]
        if len(todo) == 0:
            return 0.0
        state.transformed[todo] = True
        state.groups = list(state.target_groups)
        return len(todo) * self.page_size * LAYOUT_TRANSFORM_MS_PER_PAGE


def scan_width_factor(state: LayoutState, accessed: Tuple[int, ...],
                      from_page: int = 0) -> float:
    """Average per-tuple attribute-touch width over pages >= from_page.

    Untransformed pages cost the full row width; transformed pages cost
    the total width of the groups overlapping ``accessed``.
    """
    acc = set(accessed)
    tuned_width = sum(len(g) for g in state.groups if acc & set(g))
    tuned_width = max(tuned_width, 1)
    pages = state.transformed[from_page:]
    if len(pages) == 0:
        return float(state.n_attrs)
    frac_tuned = float(pages.mean())
    return frac_tuned * tuned_width + (1.0 - frac_tuned) * state.n_attrs

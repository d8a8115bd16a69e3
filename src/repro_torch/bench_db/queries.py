"""TUNER query templates (paper Section V-A).

Scans:
  LOW-S   single-attribute comparison predicate + aggregate
  MOD-S   two-attribute conjunctive comparison predicate (needs a
          multi-attribute index)
  HIGH-S  MOD-S + equi-join against a second relation

Updates:
  LOW-U   single-attribute predicate, sets a random attribute subset
  HIGH-U  two-attribute predicate
  INS     bulk row insert

Selectivity and projectivity are dialled via quantile bounds and the
projection attribute count, mirroring the delta_1/delta_2/k knobs of
the paper's templates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from repro_torch.bench_db.schema import DOMAIN, TunerDB, zipf_attrs
from repro_torch.core.executor import Query


@dataclass
class QueryGen:
    db: TunerDB
    table: str = "narrow"
    selectivity: float = 0.01
    projectivity: float = 0.10
    seed: int = 11
    rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self._proj_cache = None

    # -- helpers ---------------------------------------------------------
    def _n_attrs(self) -> int:
        return self.db.tables[self.table].n_attrs

    def _proj(self) -> Tuple[int, ...]:
        # Projection attribute set is fixed per generator (the paper's
        # templates project the same a_1..a_k list across a workload) --
        # this is what lets the layout tuner converge on a grouping.
        if self._proj_cache is None:
            p = self._n_attrs() - 1
            k = max(1, int(round(self.projectivity * p)))
            self._proj_cache = tuple(sorted(
                int(a) for a in self.rng.choice(np.arange(1, p + 1), size=k,
                                                replace=False)))
        return self._proj_cache

    def _bounds(self, sel: float, pos: Optional[float] = None):
        if pos is None:
            pos = float(self.rng.uniform(0.0, max(1.0 - sel, 1e-6)))
        return self.db.quantile_bounds(self.table, sel, pos)

    # -- scan templates ---------------------------------------------------
    def low_s(self, attr: int = 1, pos: Optional[float] = None) -> Query:
        lo, hi = self._bounds(self.selectivity, pos)
        return Query(kind="scan", table=self.table, attrs=(attr,),
                     los=(lo,), his=(hi,), agg_attr=min(2, self._n_attrs() - 1),
                     proj_attrs=self._proj(), template="LOW-S")

    def mod_s(self, attrs: Tuple[int, int] = (1, 2),
              pos: Optional[float] = None) -> Query:
        # split selectivity between both attributes: sel = s0 * s1
        s_each = float(np.sqrt(self.selectivity))
        lo0, hi0 = self._bounds(s_each, pos)
        lo1, hi1 = self._bounds(s_each, pos)
        return Query(kind="scan", table=self.table, attrs=tuple(attrs),
                     los=(lo0, lo1), his=(hi0, hi1),
                     agg_attr=min(3, self._n_attrs() - 1),
                     proj_attrs=self._proj(), template="MOD-S")

    def high_s(self, attrs: Tuple[int, int] = (1, 2), join_table: str = "narrow",
               join_attr: int = 4, join_inner_attr: int = 4,
               pos: Optional[float] = None) -> Query:
        q = self.mod_s(attrs, pos)
        return Query(kind="scan", table=q.table, attrs=q.attrs, los=q.los,
                     his=q.his, agg_attr=q.agg_attr, proj_attrs=q.proj_attrs,
                     join_table=join_table, join_attr=join_attr,
                     join_inner_attr=join_inner_attr, template="HIGH-S")

    # -- update templates ---------------------------------------------------
    def low_u(self, attr: int = 1, n_set: int = 3, sel: float = 0.002,
              pos: Optional[float] = None) -> Query:
        lo, hi = self._bounds(sel, pos)
        p = self._n_attrs() - 1
        set_attrs = tuple(int(a) for a in
                          self.rng.choice(np.arange(1, p + 1), size=n_set,
                                          replace=False))
        set_vals = tuple(int(v) for v in
                         self.rng.integers(1, DOMAIN, size=n_set))
        return Query(kind="update", table=self.table, attrs=(attr,),
                     los=(lo,), his=(hi,), set_attrs=set_attrs,
                     set_vals=set_vals, template="LOW-U")

    def high_u(self, attrs: Tuple[int, int] = (1, 2), n_set: int = 3,
               sel: float = 0.002, pos: Optional[float] = None) -> Query:
        s_each = float(np.sqrt(sel))
        lo0, hi0 = self._bounds(s_each, pos)
        lo1, hi1 = self._bounds(s_each, pos)
        p = self._n_attrs() - 1
        set_attrs = tuple(int(a) for a in
                          self.rng.choice(np.arange(1, p + 1), size=n_set,
                                          replace=False))
        set_vals = tuple(int(v) for v in
                         self.rng.integers(1, DOMAIN, size=n_set))
        return Query(kind="update", table=self.table, attrs=tuple(attrs),
                     los=(lo0, lo1), his=(hi0, hi1), set_attrs=set_attrs,
                     set_vals=set_vals, template="HIGH-U")

    def ins(self, n: int = 16) -> Query:
        p = self._n_attrs() - 1
        rows = np.concatenate([
            self.rng.integers(1, DOMAIN, size=(n, 1)),
            zipf_attrs(self.rng, n, p)], axis=1).astype(np.int32)
        return Query(kind="insert", table=self.table, rows=rows,
                     template="INS")

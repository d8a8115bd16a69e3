"""TUNER database schema (paper Section V).

Port of ``repro.bench_db.schema``.  Two tables: ``narrow`` (p = 20
attributes) and ``wide`` (p = 200); each row is a timestamp attribute
a_0 plus p integer attributes a_1..a_p drawn from a Zipf distribution
over [1, 1m].  The paper loads 10m tuples per table.  The numpy RNG
streams are the reference's, so one seed yields identical tables and
quantile samples in both packages; the tables live on ``device``
(``cuda`` unless the caller names another).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core.table import Table, load_table, resolve_device

ZIPF_A = 1.25
DOMAIN = 1_000_000


def zipf_attrs(rng: np.random.Generator, n: int, p: int) -> np.ndarray:
    """(n, p) Zipf values folded into [1, DOMAIN] (paper's Section V)."""
    raw = rng.zipf(ZIPF_A, size=(n, p)).astype(np.int64)
    # Fold the unbounded tail into the domain while keeping the skew:
    # multiply by a large odd constant and wrap (cheap hash).
    vals = (raw * 2654435761) % DOMAIN + 1
    return vals.astype(np.int32)


@dataclass
class TunerDB:
    tables: Dict[str, Table]
    quantiles: Dict[str, np.ndarray]  # per-table sorted sample of values
    n_rows: int
    rng: np.random.Generator

    def quantile_bounds(self, table: str, sel: float, pos: float):
        """Predicate bounds [lo, hi] hitting ~``sel`` fraction of rows,
        anchored at quantile position ``pos`` in [0, 1-sel]."""
        qs = self.quantiles[table]
        n = len(qs)
        i0 = int(pos * (n - 1))
        i1 = min(int((pos + sel) * (n - 1)), n - 1)
        lo, hi = int(qs[i0]), int(qs[i1])
        if lo > hi:
            lo, hi = hi, lo
        return lo, hi


def make_tuner_db(n_rows: int = 40_000, page_size: int = 256,
                  narrow_attrs: int = 20, wide_attrs: int = 200,
                  headroom: float = 1.5, seed: int = 7,
                  include_wide: bool = False, device=None) -> TunerDB:
    """Build the TUNER database at a given scale on ``device``.

    ``headroom`` reserves extra pages for MVCC appends; the wide table
    is optional (only the layout experiment needs it).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tables: Dict[str, Table] = {}
    quantiles: Dict[str, np.ndarray] = {}

    def build(name: str, p: int):
        vals = np.concatenate([
            np.arange(1, n_rows + 1, dtype=np.int32)[:, None],  # a_0
            zipf_attrs(rng, n_rows, p)], axis=1)
        n_pages = int(np.ceil(n_rows / page_size * headroom))
        tables[name] = load_table(vals, page_size=page_size,
                                  n_pages=n_pages, device=dev)
        # all attrs share the distribution; sample one column
        quantiles[name] = np.sort(vals[:, 1])

    build("narrow", narrow_attrs)
    if include_wide:
        build("wide", wide_attrs)
    return TunerDB(tables=tables, quantiles=quantiles, n_rows=n_rows, rng=rng)

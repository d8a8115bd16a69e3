"""Carry state across from the reference package.

``from_reference`` takes the fields of the reference's ``Table`` and
``AdHocIndex`` records as numpy arrays (``np.asarray(x)`` on the JAX
side, done by the caller, so this module imports nothing of JAX) and
returns the port's records on ``device``; ``coverage_from_reference``
does the same for a ``PageCoverage`` bitmap (a host numpy record on
both sides, plain or sharded alike).  Sharded records arrive as the
reference's nesting: a ``ShardedTable`` as ``(shards, n_rows)`` with
one table 4-tuple per shard, a ``ShardedIndex`` as ``(shards,)`` with
one index 5-tuple per shard; they become the port's stacked
``ShardedTable`` / ``ShardedIndex``.  A VBP state (``vbp_from_reference``)
arrives as its seven fields with the entries in the index form above:
a plain one becomes a ``VbpState``, a sharded one (the reference's
tuple of shards) a ``ShardedVbpState`` over the stacked entries.  The
tests use them to start both packages from one state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.index import (
    AdHocIndex,
    PageCoverage,
    ShardedIndex,
    ShardedVbpState,
    VbpState,
    stack_indexes,
)
from repro_torch.core.table import (
    Table,
    attribute_major,
    resolve_device,
    stack_shards,
)


def _tensor(x, device) -> torch.Tensor:
    # torch.tensor copies, so later in-place mutations never reach the
    # caller's arrays.
    return torch.tensor(np.asarray(x, np.int32), device=device)


def table_from_reference(fields, device=None):
    """``fields``: (data, begin_ts, end_ts, n_rows) numpy arrays, or a
    sharded table's (shards, n_rows) -> ``ShardedTable``."""
    dev = resolve_device(device)
    if len(fields) == 2:
        shards, n_rows = fields
        return stack_shards([table_from_reference(f, dev) for f in shards],
                            int(np.asarray(n_rows)))
    data, begin_ts, end_ts, n_rows = fields
    data = np.array(data, np.int32)  # writable, for torch.from_numpy
    values = attribute_major(data.shape[:-2], *data.shape[-2:], dev)
    values.copy_(torch.from_numpy(data))  # into the attribute-major store
    return Table(values, _tensor(begin_ts, dev), _tensor(end_ts, dev),
                 int(np.asarray(n_rows)))


def index_from_reference(fields, device=None):
    """``fields``: (key_hi, key_lo, rids, n_entries, built_pages), or a
    sharded index's (shards,) -> ``ShardedIndex``."""
    dev = resolve_device(device)
    if len(fields) == 1:
        return stack_indexes([index_from_reference(f, dev)
                              for f in fields[0]])
    key_hi, key_lo, rids, n_entries, built_pages = fields
    return AdHocIndex(_tensor(key_hi, dev), _tensor(key_lo, dev),
                      _tensor(rids, dev), int(np.asarray(n_entries)),
                      int(np.asarray(built_pages)))


def vbp_from_reference(fields, device=None):
    """``fields``: (index, cov_lo_hi, cov_lo_lo, cov_hi_hi, cov_hi_lo,
    n_cov, in_index), ``index`` in ``index_from_reference``'s form; a
    sharded index gives a ``ShardedVbpState``."""
    dev = resolve_device(device)
    index, *cov, n_cov, in_index = fields
    index = index_from_reference(index, dev)
    cov = [np.array(c, np.int32) for c in cov]
    in_index = torch.tensor(np.asarray(in_index, bool), device=dev)
    cls = ShardedVbpState if isinstance(index, ShardedIndex) else VbpState
    return cls(index, *cov, int(np.asarray(n_cov)), in_index)


def coverage_from_reference(fields, device=None) -> PageCoverage:
    """``fields``: (built, max_entry_page, page_size) of a reference
    ``PageCoverage`` -- its bits, its highest entry page and its page
    size."""
    built, max_entry_page, page_size = fields
    cov = PageCoverage(len(built), int(page_size), resolve_device(device))
    cov.built[:] = np.asarray(built, bool)
    cov.max_entry_page = int(max_entry_page)
    return cov


def from_reference(tables: Optional[Dict[str, tuple]] = None,
                   indexes: Optional[Dict[str, tuple]] = None,
                   device=None):
    """Convert named reference records; returns (tables, indexes)
    dicts of port records on ``device``.  An entry of ``indexes`` with
    seven fields is a VBP state (``vbp_from_reference``), any other an
    index."""
    tables = {k: table_from_reference(v, device)
              for k, v in (tables or {}).items()}
    indexes = {k: (vbp_from_reference if len(v) == 7
                   else index_from_reference)(v, device)
               for k, v in (indexes or {}).items()}
    return tables, indexes

"""Carry state across from the reference package.

``from_reference`` takes the fields of the reference's ``Table`` and
``AdHocIndex`` records as numpy arrays (``np.asarray(x)`` on the JAX
side, done by the caller, so this module imports nothing of JAX) and
returns the port's records on ``device``; ``coverage_from_reference``
does the same for a ``PageCoverage`` bitmap (a host numpy record on
both sides).  The tests use them to start both packages from one
state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.index import AdHocIndex, PageCoverage
from repro_torch.core.table import Table, resolve_device


def _tensor(x, device) -> torch.Tensor:
    # torch.tensor copies, so later in-place mutations never reach the
    # caller's arrays.
    return torch.tensor(np.asarray(x, np.int32), device=device)


def table_from_reference(fields, device=None) -> Table:
    """``fields``: (data, begin_ts, end_ts, n_rows) numpy arrays."""
    dev = resolve_device(device)
    data, begin_ts, end_ts, n_rows = fields
    return Table(_tensor(data, dev), _tensor(begin_ts, dev),
                 _tensor(end_ts, dev), int(np.asarray(n_rows)))


def index_from_reference(fields, device=None) -> AdHocIndex:
    """``fields``: (key_hi, key_lo, rids, n_entries, built_pages)."""
    dev = resolve_device(device)
    key_hi, key_lo, rids, n_entries, built_pages = fields
    return AdHocIndex(_tensor(key_hi, dev), _tensor(key_lo, dev),
                      _tensor(rids, dev), int(np.asarray(n_entries)),
                      int(np.asarray(built_pages)))


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
    dicts of port records on ``device``."""
    tables = {k: table_from_reference(v, device)
              for k, v in (tables or {}).items()}
    indexes = {k: index_from_reference(v, device)
               for k, v in (indexes or {}).items()}
    return tables, indexes

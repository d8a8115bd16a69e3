"""An order-free digest of a table's live rows.

Each row hashes to 64 bits (a polynomial over its columns in wrapping
int64 arithmetic, then MurmurHash3's 64-bit finaliser); the digest is
the number of live rows and the wrapping sum of their hashes.  Two
tables whose live rows are the same multiset give the same digest,
wherever each row sits; any other pair agrees by chance only.  It runs
column by column on the device, so a 201-column table needs one int64
row vector beside it.
"""

from __future__ import annotations

import torch

_P = 0x100000001B3  # the polynomial's odd multiplier
_M1 = 0xFF51AFD7ED558CCD - 2**64
_M2 = 0xC4CEB9FE1A85EC53 - 2**64


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ _shr(x, 33)
    x = x * _M1
    x = x ^ _shr(x, 33)
    x = x * _M2
    return x ^ _shr(x, 33)


def rows_digest(plane, n_attrs: int, live: torch.Tensor):
    """(live rows, hash sum) of the rows where ``live`` holds;
    ``plane(a)`` gives attribute ``a``'s flat int32 plane, aligned with
    ``live``."""
    acc = torch.zeros(live.shape[0], dtype=torch.int64, device=live.device)
    for a in range(n_attrs):
        acc = acc * _P + (plane(a).to(torch.int64) + 1)
    h = _mix(acc)
    total = torch.where(live, h, torch.zeros_like(h)).sum()
    return int(live.sum()), int(total)

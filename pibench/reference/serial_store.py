"""The plain reference: a serial, append-only version store in PyTorch.

It holds the same semantics the configurations state, written
independently of the program under test and importing nothing of it:

* The store keeps row versions in slots, in the order they were
  written; a slot is live until a later statement ends it.
* Serial MVCC: statements apply one after another, and every statement
  sees every earlier statement's writes.
* A scan returns the exact int32 sum (wrapping) of its aggregate
  attribute over the live rows that satisfy every range predicate
  (inclusive bounds), and their count.
* An UPDATE ends at most ``update_cap`` matching live rows, the first
  in slot order, and appends a copy of each, in that order, with the
  set attributes replaced; it reports how many it changed.
* Nothing is written past the capacity: the reference raises instead.

``agg_dtype`` is the precision of a scan's sum.  The exact reference
sums in int64 and wraps to int32; the control sums in float32, the
nearest precision below exact integer arithmetic, and so breaks the
guarantee that answers are exact.
"""

from __future__ import annotations

import torch

I32 = 2**32


class SerialStore:
    def __init__(self, n_attrs: int, capacity: int, device,
                 update_cap: int, agg_dtype=torch.int64):
        self.n_attrs = int(n_attrs)
        self.capacity = int(capacity)
        self.update_cap = int(update_cap)
        self.agg_dtype = agg_dtype
        self.cols = torch.zeros((self.n_attrs, self.capacity),
                                dtype=torch.int32, device=device)
        self.live = torch.zeros(self.capacity, dtype=torch.bool,
                                device=device)
        self.n = 0

    def plane(self, a: int) -> torch.Tensor:
        return self.cols[a]

    def loaded(self, n_rows: int) -> None:
        """Mark the first ``n_rows`` slots, filled by the caller, live."""
        self.live[:n_rows] = True
        self.n = int(n_rows)

    def _match(self, attrs, los, his) -> torch.Tensor:
        m = self.live[:self.n].clone()
        for a, lo, hi in zip(attrs, los, his):
            c = self.cols[a, :self.n]
            m &= (c >= int(lo)) & (c <= int(hi))
        return m

    def scan(self, attrs, los, his, agg_attr):
        """(sum, count) as 0-d int64 device tensors; the sum wrapped to
        int32's range."""
        m = self._match(attrs, los, his)
        vals = self.cols[agg_attr, :self.n].to(self.agg_dtype)
        s = torch.where(m, vals, torch.zeros_like(vals)).sum()
        s = s.to(torch.float64).round().to(torch.int64) if (
            s.dtype.is_floating_point) else s
        s = torch.remainder(s + 2**31, I32) - 2**31
        return s, m.sum()

    def update(self, attrs, los, his, set_attrs, set_vals) -> int:
        m = self._match(attrs, los, his)
        idx = torch.nonzero(m).view(-1)[:self.update_cap]
        k = int(idx.numel())
        if k == 0:
            return 0
        if self.n + k > self.capacity:
            raise RuntimeError("the reference store is full")
        self.live[idx] = False
        new = self.cols[:, idx]  # a copy
        for a, v in zip(set_attrs, set_vals):
            new[int(a)] = int(v)
        self.cols[:, self.n:self.n + k] = new
        self.live[self.n:self.n + k] = True
        self.n += k
        return k

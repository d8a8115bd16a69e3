"""K2: single-query fused filter+aggregate table scan.

Port of the Pallas TPU kernel ``repro.kernels.filter_agg.filter_agg``,
with its optional hybrid-scan ``start_page`` suffix.  The CUDA kernel
(``csrc/filter_agg.cu``, ``filter_agg_launch``) keeps the first port's
tile body, shared with K3, with the query's bounds passed by value; a
one-query K1 batch and K2 agree bit for bit (chip_smoke.py phase 2).

``filter_agg`` is the wrapper: for tensors on the CPU it takes
``filter_agg_plain``; for CUDA tensors it launches the kernel or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import batched_filter_agg as _bfa
from repro_torch.kernels.ref import masked_filter_agg_ref

I32_MIN = _bfa.I32_MIN
I32_MAX = _bfa.I32_MAX

launches = 0  # kernel launches since the last reset (plain runs excluded)


def _scalars(lo0, hi0, lo1, hi1, ts, start_page):
    vals = [int(v) for v in (lo0, hi0, lo1, hi1, ts, start_page)]
    for v in vals:
        if not I32_MIN <= v <= I32_MAX:
            raise ValueError(f"bound {v} does not fit int32")
    return vals


def filter_agg_plain(pred0, pred1, agg, begin_ts, end_ts, lo0, hi0, lo1,
                     hi1, ts, start_page=None):
    """Plain PyTorch version of K2: the oracle
    ``ref.masked_filter_agg_ref`` (start page 0 when none is given)."""
    vals = _scalars(lo0, hi0, lo1, hi1, ts, start_page or 0)
    return masked_filter_agg_ref(pred0, pred1, agg, begin_ts, end_ts, *vals)


def filter_agg(pred0, pred1, agg, begin_ts, end_ts, lo0, hi0, lo1, hi1, ts,
               start_page=None, block_pages=None):
    """Fused filter+aggregate scan of one query.  See
    ``ref.filter_agg_ref`` for the contract; ``start_page`` switches on
    the hybrid-scan page skip (``ref.masked_filter_agg_ref``).  Bounds
    are Python ints or 0-d tensors; returns (sum, count), 0-d int32."""
    planes = (pred0, pred1, agg, begin_ts, end_ts)
    dev = pred0.device
    _bfa.check_planes(planes, unit_stride=dev.type == "cuda")
    if dev.type == "cpu":
        return filter_agg_plain(*planes, lo0, hi0, lo1, hi1, ts,
                                start_page=start_page)
    if dev.type != "cuda":
        raise ValueError(f"no K2 kernel for device {dev}")
    from repro_torch.kernels._build import library

    global launches
    n_pages, page_size = pred0.shape
    bp = int(block_pages or _bfa.tile_pages(n_pages, page_size))
    vals = _scalars(lo0, hi0, lo1, hi1, ts, start_page or 0)
    if n_pages == 0:
        out = torch.zeros((2, 1), dtype=torch.int32, device=dev)
        return out[0, 0], out[1, 0]
    index, out, stream = _bfa._launch_args(dev, 1)
    err = library().filter_agg_launch(
        index,
        *[x.data_ptr() for x in planes],
        n_pages * page_size,
        page_size,
        bp * page_size,
        *vals,
        out.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    launches += 1
    return out[0, 0], out[1, 0]

"""K1, K3 and K4: multi-query fused filter+aggregate table scans.

Ports of the Pallas TPU kernels ``repro.kernels.batched_filter_agg.
batched_filter_agg`` (K1), ``sharded_batched_filter_agg`` (K4) and
``sharded_batched_filter_agg_masked`` (K3).  One launch evaluates a
whole batch of conjunctive range-aggregate queries over shared column
planes; the CUDA C++ kernels are in ``csrc/filter_agg.cu``
(``batched_filter_agg_launch``, ``sharded_filter_agg_launch`` and
``masked_filter_agg_launch``, where the source note explains the
design and what bounds them).  K4 scans S stacked shards from
per-(shard, query) local start pages; K3 scans only the pages a
coverage bitmap leaves uncovered, over S stacked shards.

``batched_filter_agg``, ``sharded_batched_filter_agg`` and
``sharded_batched_filter_agg_masked`` are the wrappers: for tensors on
the CPU they take the plain PyTorch version beside them
(``..._plain``); for CUDA tensors they launch the kernel or raise.
``launches`` counts K1 launches, ``sharded_launches`` K4 launches and
``masked_launches`` K3 launches.

Column planes are (n_pages, page_size) int32 views of a table's
attribute values (``data[..., a]``), never copied per dispatch.  The
port stores tables attribute-major (``core/table.py``), so each plane
is one unit-stride run.  The kernels read row r of a plane at
``plane[r]`` (K1 and K4 with 16-byte loads) and take only such planes
on the card: ``check_planes`` raises on a plane whose row stride is
not 1.

Each wrapper does little on the host, since a burst's kernel calls are
short: it checks its operands, allocates one (2, B) output and hands
the pointers to the C entry point, which zeroes the output on the
stream and launches.

Tiling: K1 / K4 walk a list of live tiles of ``stream_tile_rows``
rows (``TILE_ROWS``, or ``block_pages`` pages rounded up to a 16-byte
multiple) with a grid sized to the card.  K3 has no tile: its work
items are the coverage words (32 pages each) of every shard, walked by
a grid sized to the card (``masked_launch_shape``); a block lists the
open pages of the words it pulls and streams about ``TILE_ROWS`` rows
of them per step.  The result does not depend on the tiling -- int32
additions wrap associatively and commutatively;
tests/test_torch_kernels_cuda.py holds the kernels against the plain
versions at several tile and page sizes and coverage patterns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import (
    batched_filter_agg_ref,
    sharded_batched_filter_agg_masked_ref,
    sharded_batched_filter_agg_ref,
)

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1

# Rows of one tile: 256 threads x 4 sixteen-byte words of 4 rows (K1 /
# K4; K3's step), 256 threads x 4 rows x 4 passes (K2).
TILE_ROWS = 4096

launches = 0  # K1 launches since the last reset (plain runs excluded)
sharded_launches = 0  # K4 launches since the last reset
masked_launches = 0  # K3 launches since the last reset


def tile_pages(n_pages: int, page_size: int) -> int:
    """Pages per CUDA block: whole pages summing to about ``TILE_ROWS``
    rows (at least one page, at most the table)."""
    return max(1, min(int(n_pages), TILE_ROWS // int(page_size)))


def stream_tile_rows(page_size: int, block_pages: int | None) -> int:
    """Rows per tile of K1 / K4's live-tile list: ``TILE_ROWS``, or
    ``block_pages`` pages rounded up to a multiple of 4 rows (16
    bytes), so that tiles start on 16-byte words."""
    if block_pages is None:
        return TILE_ROWS
    return -(-int(block_pages) * int(page_size) // 4) * 4


def _row_stride(plane: torch.Tensor, name: str) -> int:
    """Element stride between consecutive rows of a ([S,] n_pages,
    page_size) plane; raises unless its rows are evenly spaced."""
    stride = plane.stride(-1)
    span = stride
    for dim in range(plane.dim() - 2, -1, -1):
        span *= plane.shape[dim + 1]
        if plane.shape[dim] > 1 and plane.stride(dim) != span:
            raise ValueError(f"{name} rows are not evenly spaced "
                             f"(strides {plane.stride()})")
    return stride


def check_planes(planes, ndim=2, names=("pred0", "pred1", "agg",
                                        "begin_ts", "end_ts"),
                 unit_stride=False):
    """Validate the five column planes: int32, one shape and device,
    rows evenly spaced.  With ``unit_stride`` (every kernel, on the
    card) each plane must have row stride 1 -- one contiguous run, as
    the attribute-major tables give."""
    shape, device = planes[0].shape, planes[0].device
    if len(shape) != ndim:
        raise ValueError(f"column planes must be {ndim}-D, got "
                         f"{tuple(shape)}")
    for x, n in zip(planes, names):
        if x.dtype != torch.int32:
            raise TypeError(f"{n} must be int32, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{n} has shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if x.device != device:
            raise ValueError(f"{n} is on {x.device}, expected {device}")
        if x.is_contiguous():  # row stride 1
            continue
        stride = _row_stride(x, n)
        if unit_stride:
            raise ValueError(
                f"{n} has row stride {stride}: the kernels read "
                f"unit-stride planes (store the table attribute-major)")


def _launch_args(dev, nq):
    """(device index, (2, nq) int32 output, raw stream) of a launch on
    the current stream of ``dev``."""
    out = torch.empty((2, nq), dtype=torch.int32, device=dev)
    # The raw handle, without building a torch.cuda.Stream: a burst's
    # kernel calls are short, so the wrapper's host time counts.
    return dev.index, out, torch._C._cuda_getCurrentRawStream(dev.index)


def batched_filter_agg_plain(pred0, pred1, agg, begin_ts, end_ts, los0,
                             his0, los1, his1, tss, start_pages):
    """Plain PyTorch version of K1: the oracle
    ``ref.batched_filter_agg_ref``."""
    return batched_filter_agg_ref(pred0, pred1, agg, begin_ts, end_ts, los0,
                                  his0, los1, his1, tss, start_pages)


def _query_operand(x, n_queries, device, name):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != torch.int32 or x.shape != (n_queries,):
        raise ValueError(f"{name} must be ({n_queries},) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    return x.contiguous()


def batched_filter_agg(
    pred0,
    pred1,
    agg,
    begin_ts,
    end_ts,
    los0,
    his0,
    los1,
    his1,
    tss,
    start_pages,
    block_pages: int | None = None,
):
    """Multi-query fused filter+aggregate scan.

    Column planes are (n_pages, page_size) int32, shared by every query
    of the batch; per-query operands ``los0/his0/los1/his1/tss/
    start_pages`` are (n_queries,) int32 tensors on the same device.
    Single-attribute queries pass los1 = INT32_MIN, his1 = INT32_MAX;
    full scans pass start_pages = 0.  Returns (sums, counts), each
    (n_queries,) int32.
    """
    planes = (pred0, pred1, agg, begin_ts, end_ts)
    dev = pred0.device
    check_planes(planes, unit_stride=dev.type == "cuda")
    n_pages, page_size = pred0.shape
    nq = los0.shape[0]
    ops = [
        _query_operand(x, nq, dev, n)
        for x, n in zip(
            (los0, his0, los1, his1, tss, start_pages),
            ("los0", "his0", "los1", "his1", "tss", "start_pages"),
        )
    ]
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 kernel for device {dev}")
    if nq == 0 or n_pages == 0:
        out = torch.zeros((2, nq), dtype=torch.int32, device=dev)
        return out.unbind(0)
    if dev.type == "cpu":
        return batched_filter_agg_plain(*planes, *ops)
    from repro_torch.kernels._build import library

    global launches
    index, out, stream = _launch_args(dev, nq)
    err = library().batched_filter_agg_launch(
        index,
        *[x.data_ptr() for x in planes],
        n_pages,
        page_size,
        stream_tile_rows(page_size, block_pages),
        *[x.data_ptr() for x in ops],
        nq,
        out.data_ptr(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    launches += 1
    return out.unbind(0)


def sharded_batched_filter_agg_plain(pred0, pred1, agg, begin_ts, end_ts,
                                     los0, his0, los1, his1, tss,
                                     start_pages, local_pages):
    """Plain PyTorch version of K4: the oracle
    ``ref.sharded_batched_filter_agg_ref``."""
    return sharded_batched_filter_agg_ref(
        pred0, pred1, agg, begin_ts, end_ts, los0, his0, los1, his1, tss,
        start_pages, local_pages)


def sharded_batched_filter_agg(
    pred0,
    pred1,
    agg,
    begin_ts,
    end_ts,
    los0,
    his0,
    los1,
    his1,
    tss,
    start_pages,
    local_pages,
    block_pages: int | None = None,
):
    """Multi-shard multi-query filter+aggregate scan (K4).

    Column planes are (S, n_pages, page_size) int32 stacked per shard;
    per-query operands ``los0/his0/los1/his1/tss`` are (n_queries,)
    int32; ``start_pages`` (S, n_queries) int32 holds each (shard,
    query) pair's LOCAL stitch point (zeros = full scans);
    ``local_pages`` (S,) int32 is each shard's real page count -- pages
    at or past it contribute nothing.  Returns (sums, counts), each
    (n_queries,) int32, summed over shards.
    """
    planes = (pred0, pred1, agg, begin_ts, end_ts)
    dev = pred0.device
    check_planes(planes, ndim=3, unit_stride=dev.type == "cuda")
    n_shards, n_pages, page_size = pred0.shape
    nq = los0.shape[0]
    ops = [
        _query_operand(x, nq, dev, n)
        for x, n in zip((los0, his0, los1, his1, tss),
                        ("los0", "his0", "los1", "his1", "tss"))
    ]
    local_pages = _query_operand(local_pages, n_shards, dev, "local_pages")
    if not isinstance(start_pages, torch.Tensor) or (
            start_pages.dtype != torch.int32
            or tuple(start_pages.shape) != (n_shards, nq)):
        raise ValueError(f"start_pages must be ({n_shards}, {nq}) int32")
    if start_pages.device != dev:
        raise ValueError(f"start_pages is on {start_pages.device}, "
                         f"expected {dev}")
    start_pages = start_pages.contiguous()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K4 kernel for device {dev}")
    if nq == 0 or n_pages == 0 or n_shards == 0:
        out = torch.zeros((2, nq), dtype=torch.int32, device=dev)
        return out.unbind(0)
    if dev.type == "cpu":
        return sharded_batched_filter_agg_plain(
            *planes, *ops, start_pages, local_pages)
    from repro_torch.kernels._build import library

    global sharded_launches
    index, out, stream = _launch_args(dev, nq)
    err = library().sharded_filter_agg_launch(
        index,
        *[x.data_ptr() for x in planes],
        n_shards,
        n_pages,
        page_size,
        stream_tile_rows(page_size, block_pages),
        *[x.data_ptr() for x in ops],
        start_pages.data_ptr(),
        nq,
        local_pages.data_ptr(),
        out.data_ptr(),
        stream,
    )
    if err != 0:  # among them more shards than the kernel's shard table
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    sharded_launches += 1
    return out.unbind(0)


def sharded_batched_filter_agg_masked_plain(pred0, pred1, agg, begin_ts,
                                            end_ts, los0, his0, los1, his1,
                                            tss, words, local_pages):
    """Plain PyTorch version of K3: the oracle
    ``ref.sharded_batched_filter_agg_masked_ref``."""
    return sharded_batched_filter_agg_masked_ref(
        pred0, pred1, agg, begin_ts, end_ts, los0, his0, los1, his1, tss,
        words, local_pages)


def sharded_batched_filter_agg_masked(
    pred0,
    pred1,
    agg,
    begin_ts,
    end_ts,
    los0,
    his0,
    los1,
    his1,
    tss,
    words,
    local_pages,
):
    """Multi-shard multi-query scan of the UNCOVERED pages (K3).

    Column planes are (S, n_pages, page_size) int32 stacked per shard
    (a plain table passes S = 1); per-query operands ``los0/his0/los1/
    his1/tss`` are (n_queries,) int32; ``words`` is (S, W) int32, the
    packed coverage words (``index.PageCoverage.packed_words``), with
    W * 32 >= n_pages; ``local_pages`` (S,) int32 is each shard's real
    page count -- pages at or past it contribute nothing.  Returns
    (sums, counts), each (n_queries,) int32 over uncovered pages only.
    """
    planes = (pred0, pred1, agg, begin_ts, end_ts)
    dev = pred0.device
    check_planes(planes, ndim=3, unit_stride=dev.type == "cuda")
    n_shards, n_pages, page_size = pred0.shape
    nq = los0.shape[0]
    ops = [
        _query_operand(x, nq, dev, n)
        for x, n in zip((los0, his0, los1, his1, tss),
                        ("los0", "his0", "los1", "his1", "tss"))
    ]
    local_pages = _query_operand(local_pages, n_shards, dev, "local_pages")
    shape = words.shape
    if words.dtype != torch.int32 or len(shape) != 2 or (
            shape[0] != n_shards):
        raise ValueError(f"words must be ({n_shards}, W) int32, got "
                         f"{tuple(shape)} {words.dtype}")
    if words.device != dev:
        raise ValueError(f"words is on {words.device}, expected {dev}")
    n_words = shape[1]
    if n_words * 32 < n_pages:
        raise ValueError(f"{n_words} coverage words per shard cannot cover "
                         f"{n_pages} pages (need W * 32 >= n_pages)")
    words = words.contiguous()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K3 kernel for device {dev}")
    if nq == 0 or n_pages == 0 or n_shards == 0:
        out = torch.zeros((2, nq), dtype=torch.int32, device=dev)
        return out.unbind(0)
    if dev.type == "cpu":
        return sharded_batched_filter_agg_masked_plain(
            *planes, *ops, words, local_pages)
    from repro_torch.kernels._build import library

    global masked_launches
    index, out, stream = _launch_args(dev, nq)
    err = library().masked_filter_agg_launch(
        index,
        *[x.data_ptr() for x in planes],
        n_shards,
        n_pages,
        page_size,
        *[x.data_ptr() for x in ops],
        nq,
        words.data_ptr(),
        n_words,
        local_pages.data_ptr(),
        out.data_ptr(),
        stream,
    )
    if err != 0:  # among them about 2^31 stacked pages or more
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    masked_launches += 1
    return out.unbind(0)


def masked_launch_shape(device, n_shards: int, n_pages: int):
    """(work items, grid blocks) of a K3 launch over ``n_shards`` shards
    of ``n_pages`` pages on the CUDA ``device``: one item per coverage
    word, a grid sized to the card."""
    from repro_torch.kernels._build import library

    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    shape = (ctypes.c_longlong * 2)()
    err = library().masked_filter_agg_shape(index, n_shards, n_pages, shape)
    if err != 0:
        raise RuntimeError(f"K3 grid query failed: CUDA error {err}")
    return int(shape[0]), int(shape[1])

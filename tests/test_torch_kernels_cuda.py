"""The port's CUDA kernels K1-K4 against their plain PyTorch versions.

These need the card (marker ``cuda``): each test skips without a CUDA
device.  The file imports nothing of JAX, so it runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.table import attribute_major
from repro_torch.kernels import batched_filter_agg as bfa
from repro_torch.kernels import filter_agg as fa

I32_MIN, I32_MAX = -(2**31), 2**31 - 1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _attr_major(values):
    """A (..., page_size, n_attrs) numpy array in the port's
    attribute-major table storage (CPU)."""
    data = attribute_major(values.shape[:-2], *values.shape[-2:], "cpu")
    data.copy_(torch.from_numpy(values))
    return data


def _planes(seed, n_pages=300, psz=64, n_attrs=5):
    """Column planes of an attribute-major (n_pages, psz, n_attrs) table
    with values that wrap int32 sums and MVCC gaps."""
    rng = np.random.default_rng(seed)
    data = _attr_major(rng.integers(
        2**30, I32_MAX, size=(n_pages, psz, n_attrs)).astype(np.int32))
    begin = torch.from_numpy(
        rng.integers(0, 20, size=(n_pages, psz)).astype(np.int32))
    end = torch.from_numpy(np.where(
        rng.random((n_pages, psz)) < 0.2,
        rng.integers(5, 30, size=(n_pages, psz)), I32_MAX).astype(np.int32))
    begin.view(-1)[-psz // 2:] = I32_MAX
    return data[..., 1], data[..., 3], data[..., 2], begin, end


def _queries(seed, B, n_pages=300):
    rng = np.random.default_rng(seed)
    lo = rng.integers(2**30, 2**31 - 2**29, size=(B, 2))
    cols = [lo[:, 0], lo[:, 0] + 2**29, lo[:, 1], lo[:, 1] + 2**29,
            rng.integers(0, 30, size=B), rng.integers(0, n_pages + 5, size=B)]
    return [torch.from_numpy(np.asarray(c, np.int32)) for c in cols]


@pytest.mark.parametrize("B", [1, 8, 70])
@pytest.mark.parametrize("block_pages", [None, 1, 7])
def test_cuda_k1_matches_plain(cuda, B, block_pages):
    planes, q = _planes(B), _queries(B, B)
    before = bfa.launches
    s, c = bfa.batched_filter_agg(*[x.to(cuda) for x in planes],
                                  *[x.to(cuda) for x in q],
                                  block_pages=block_pages)
    torch.cuda.synchronize()
    assert bfa.launches == before + 1
    ps, pc = bfa.batched_filter_agg_plain(*planes, *q)
    assert torch.equal(s.cpu(), ps) and torch.equal(c.cpu(), pc)


@pytest.mark.parametrize("start_page", [None, 0, 40, 400])
def test_cuda_k2_matches_plain(cuda, start_page):
    planes = _planes(2)
    args = (2**30, I32_MAX, I32_MIN, I32_MAX, 11)
    before = fa.launches
    s, c = fa.filter_agg(*[x.to(cuda) for x in planes], *args,
                         start_page=start_page)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ps, pc = fa.filter_agg_plain(*planes, *args, start_page=start_page)
    assert (int(s), int(c)) == (int(ps), int(pc))


COVERS = ("empty", "prefix", "scattered", "runs", "alternate",
          "one_per_word", "full")


def _coverage(rng, cover, S, n_pages):
    """(S, n_pages) bool built flags: none, a prefix, random pages, hot
    windows (runs of 40 built pages every 64, as phase 5's windows are
    runs), every other page, one open page per 32-page word, all."""
    page = np.arange(n_pages)[None, :].repeat(S, 0)
    built = {"empty": page < 0,
             "prefix": page < 100,
             "scattered": rng.random((S, n_pages)) < 0.6,
             "runs": (page + 17 * np.arange(S)[:, None]) % 64 < 40,
             "alternate": page % 2 == 1,
             "one_per_word": page % 32 != 7,
             "full": page >= 0}[cover]
    if S > 1 and cover != "empty":
        built[1] = True  # a shard whose every page is covered
    return built


def _pack(built, W):
    """(S, W) int32 packed little-endian coverage words (0-bits past the
    flags)."""
    S, n = built.shape
    bits = np.pad(built, ((0, 0), (0, W * 32 - n))).astype(np.uint32)
    return torch.from_numpy((bits.reshape(S, W, 32) << np.arange(
        32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32).view(np.int32))


def _masked_inputs(seed, S, n_pages=333, psz=32, cover="scattered", B=9):
    """Stacked (S, n_pages, psz) planes with ragged real page counts
    (padding pages invisible), B queries, and packed coverage words
    (W * 32 > n_pages)."""
    rng = np.random.default_rng(seed)
    data = _attr_major(rng.integers(
        2**30, I32_MAX, size=(S, n_pages, psz, 5)).astype(np.int32))
    begin = rng.integers(0, 20, size=(S, n_pages, psz)).astype(np.int32)
    end = np.where(rng.random((S, n_pages, psz)) < 0.2,
                   rng.integers(5, 30, size=(S, n_pages, psz)),
                   I32_MAX).astype(np.int32)
    local = np.array([n_pages - 37 * s for s in range(S)], np.int32)
    for s in range(S):
        begin[s, local[s]:] = I32_MAX
    words = _pack(_coverage(rng, cover, S, n_pages), -(-n_pages // 32) + 1)
    planes = (data[..., 1], data[..., 3], data[..., 2],
              torch.from_numpy(begin), torch.from_numpy(end))
    q = _queries(seed, B, n_pages)[:5]
    return planes, q, words, torch.from_numpy(local)


def _run_k3(cuda, planes, q, words, local):
    """K3 on the card against its plain version on the same card."""
    planes = [x.to(cuda) for x in planes]
    q = [x.to(cuda) for x in q]
    words, local = words.to(cuda), local.to(cuda)
    before = bfa.masked_launches
    s, c = bfa.sharded_batched_filter_agg_masked(*planes, *q, words, local)
    torch.cuda.synchronize()
    assert bfa.masked_launches == before + 1
    ps, pc = bfa.sharded_batched_filter_agg_masked_plain(*planes, *q, words,
                                                         local)
    assert torch.equal(s, ps) and torch.equal(c, pc)
    return s, c


@pytest.mark.parametrize("B", [1, 8, 65])
@pytest.mark.parametrize("cover", COVERS)
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("psz", [3, 8, 32, 256])
def test_cuda_k3_matches_plain(cuda, psz, S, cover, B):
    planes, q, words, local = _masked_inputs(psz + 3 * S + B, S, psz=psz,
                                             cover=cover, B=B)
    s, c = _run_k3(cuda, planes, q, words, local)
    if cover == "full":  # every word is all ones: no row is loaded
        assert not c.any() and not s.any()
    elif cover != "one_per_word":
        assert c.any()


def _offset_plane(x, rows, device):
    """A copy of ``x`` on ``device`` whose storage starts ``rows`` int32
    values past an allocation's start (a view, unit stride)."""
    flat = torch.zeros(x.numel() + rows, dtype=x.dtype, device=device)
    flat[rows:] = x.reshape(-1).to(device)
    return flat[rows:].view(x.shape)


@pytest.mark.parametrize("offsets", [(1,) * 5, (3,) * 5, (2,) * 5,
                                     (0, 1, 2, 3, 0)])
@pytest.mark.parametrize("psz", [3, 8, 256])
def test_cuda_k3_offset_planes_match_plain(cuda, psz, offsets):
    """Planes that start mid-word (all at one offset: 16-byte loads
    from a shifted word grid) and planes that disagree modulo 16 bytes
    (loaded row by row)."""
    planes, q, words, local = _masked_inputs(psz * 5 + sum(offsets), 2,
                                             n_pages=150, psz=psz,
                                             cover="alternate")
    planes = [_offset_plane(x, o, cuda) for x, o in zip(planes, offsets)]
    assert planes[0].data_ptr() % 16 == 4 * offsets[0]
    _run_k3(cuda, planes, q, words, local)


@pytest.mark.parametrize("psz", [1, 3])
def test_cuda_k3_more_work_items_than_resident_blocks(cuda, psz):
    """More coverage words than 32 per resident block (at most 8 blocks
    of 256 threads per SM): every block pulls words more than once."""
    S, n_pages = 2, 600_000
    planes, q, _, local = _masked_inputs(psz, S, n_pages=n_pages, psz=psz,
                                         cover="empty")
    rng = np.random.default_rng(psz)
    words = _pack(rng.random((S, n_pages)) < 0.5, -(-n_pages // 32))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert S * n_pages // 32 > 32 * 8 * sms
    _run_k3(cuda, planes, q, words, local)


def test_cuda_k3_prefix_equals_k1(cuda):
    planes, q, words, local = _masked_inputs(5, 1, cover="prefix")
    local[0] = planes[0].shape[1]
    s3, c3 = bfa.sharded_batched_filter_agg_masked(
        *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
        words.to(cuda), local.to(cuda))
    starts = torch.full((q[0].shape[0],), 100, dtype=torch.int32)
    s1, c1 = bfa.batched_filter_agg(*[x[0].to(cuda) for x in planes],
                                    *[x.to(cuda) for x in q],
                                    starts.to(cuda))
    assert torch.equal(s3, s1) and torch.equal(c3, c1)


def test_cuda_k3_rejects_short_coverage_words(cuda):
    planes, q, words, local = _masked_inputs(6, 2)
    before = bfa.masked_launches
    with pytest.raises(ValueError, match="W \\* 32 >= n_pages"):
        bfa.sharded_batched_filter_agg_masked(  # 10 words < 333 pages
            *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
            words[:, :333 // 32].to(cuda), local.to(cuda))
    assert bfa.masked_launches == before


def _sharded_inputs(seed, S, start_kind, n_pages=333, psz=32, B=9):
    """Stacked (S, n_pages, psz) planes with ragged real page counts
    (padding pages invisible), queries, and an (S, B) table of local
    start pages."""
    planes, q, _, local = _masked_inputs(seed, S, n_pages, psz)
    rng = np.random.default_rng(seed)
    g = rng.integers(0, S * n_pages, size=B)
    sid = np.arange(S)[:, None]
    starts = {
        "zero": np.zeros((S, B)),
        "global": np.maximum((g[None, :] - sid + S - 1) // S, 0),
        "divergent": rng.integers(0, n_pages, size=(S, B)),
        "beyond": local.numpy()[:, None] + rng.integers(0, 4, size=(S, B)),
    }[start_kind].astype(np.int32)
    return planes, q, torch.from_numpy(starts), local


@pytest.mark.parametrize("start_kind", ["zero", "global", "divergent",
                                        "beyond"])
@pytest.mark.parametrize("block_pages", [None, 1, 7, 40])
@pytest.mark.parametrize("S", [1, 4])
def test_cuda_k4_matches_plain(cuda, S, block_pages, start_kind):
    planes, q, starts, local = _sharded_inputs(S + 11, S, start_kind)
    before = bfa.sharded_launches
    s, c = bfa.sharded_batched_filter_agg(
        *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
        starts.to(cuda), local.to(cuda), block_pages=block_pages)
    torch.cuda.synchronize()
    assert bfa.sharded_launches == before + 1
    ps, pc = bfa.sharded_batched_filter_agg_plain(*planes, *q, starts,
                                                  local)
    assert torch.equal(s.cpu(), ps) and torch.equal(c.cpu(), pc)
    if start_kind == "beyond":  # every tile returns before loading a row
        assert not c.any() and not s.any()


def test_cuda_k4_one_shard_equals_k1(cuda):
    planes, q, starts, local = _sharded_inputs(12, 1, "divergent")
    local[0] = planes[0].shape[1]
    s4, c4 = bfa.sharded_batched_filter_agg(
        *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
        starts.to(cuda), local.to(cuda))
    s1, c1 = bfa.batched_filter_agg(*[x[0].to(cuda) for x in planes],
                                    *[x.to(cuda) for x in q],
                                    starts[0].to(cuda))
    assert torch.equal(s4, s1) and torch.equal(c4, c1)


def test_cuda_k4_zero_starts_equal_a_full_scan(cuda):
    planes, q, starts, local = _sharded_inputs(13, 4, "zero")
    s4, c4 = bfa.sharded_batched_filter_agg(
        *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
        starts.to(cuda), local.to(cuda))
    flat = [x.reshape(-1, x.shape[-1]).to(cuda) for x in planes]
    s1, c1 = bfa.batched_filter_agg(
        *flat, *[x.to(cuda) for x in q],
        torch.zeros(q[0].shape[0], dtype=torch.int32, device=cuda))
    assert torch.equal(s4, s1) and torch.equal(c4, c1)


def test_cuda_k4_rejects_bad_start_pages(cuda):
    planes, q, starts, local = _sharded_inputs(14, 2, "zero")
    before = bfa.sharded_launches
    with pytest.raises(ValueError, match="start_pages"):
        bfa.sharded_batched_filter_agg(
            *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
            starts[:, :-1].to(cuda), local.to(cuda))
    assert bfa.sharded_launches == before


# The stream path (K1 / K4): page sizes whose pages are not a multiple
# of 16 bytes (3) and that are (8, 32, 256), ragged shards, batches
# that cross the 64-query chunk, sums that wrap int32.

def _stream_inputs(seed, S, psz, B, n_pages=None, starts="mixed"):
    """Attribute-major stacked (S, n_pages, psz) planes with ragged real
    page counts (padding invisible), B queries and an (S, B) table of
    local start pages: ``mixed`` (zeros, mid-shard, past the real
    pages) or ``beyond`` (every start past local_pages)."""
    rng = np.random.default_rng(seed)
    n_pages = n_pages or max(8, 6000 // psz)
    data = _attr_major(rng.integers(
        2**30, I32_MAX, size=(S, n_pages, psz, 5)).astype(np.int32))
    begin = rng.integers(0, 20, size=(S, n_pages, psz)).astype(np.int32)
    end = np.where(rng.random((S, n_pages, psz)) < 0.2,
                   rng.integers(5, 30, size=(S, n_pages, psz)),
                   I32_MAX).astype(np.int32)
    local = np.array([n_pages] + list(rng.integers(
        n_pages // 2, n_pages + 1, size=S - 1)), np.int32)
    for s in range(S):
        begin[s, local[s]:] = I32_MAX
    if starts == "beyond":
        st = local[:, None] + rng.integers(0, 3, size=(S, B))
    else:
        st = rng.integers(0, n_pages + 2, size=(S, B))
        st[:, 0] = 0
    lo = rng.integers(2**30, 2**31 - 2**29, size=(B, 2))
    q = [lo[:, 0], lo[:, 0] + 2**29, lo[:, 1], lo[:, 1] + 2**29,
         rng.integers(0, 30, size=B)]
    planes = (data[..., 1], data[..., 3], data[..., 2],
              torch.from_numpy(begin), torch.from_numpy(end))
    return (planes, [torch.from_numpy(np.asarray(c, np.int32)) for c in q],
            torch.from_numpy(st.astype(np.int32)), torch.from_numpy(local))


def _run_k4(cuda, planes, q, starts, local, block_pages=None):
    before = bfa.sharded_launches
    s, c = bfa.sharded_batched_filter_agg(
        *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
        starts.to(cuda), local.to(cuda), block_pages=block_pages)
    torch.cuda.synchronize()
    assert bfa.sharded_launches == before + 1
    ps, pc = bfa.sharded_batched_filter_agg_plain(*planes, *q, starts, local)
    assert torch.equal(s.cpu(), ps) and torch.equal(c.cpu(), pc)
    return s, c


@pytest.mark.parametrize("B", [1, 8, 33, 65])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("psz", [3, 8, 32, 256])
def test_cuda_stream_k4_matches_plain(cuda, psz, S, B):
    planes, q, starts, local = _stream_inputs(psz * 7 + S * 3 + B, S, psz,
                                              B)
    s, c = _run_k4(cuda, planes, q, starts, local,
                   block_pages=1 if B in (8, 65) else None)
    assert c.any()  # the full scan of query 0 matches rows


@pytest.mark.parametrize("B", [1, 8, 33, 65])
@pytest.mark.parametrize("psz", [3, 8, 32, 256])
def test_cuda_stream_k1_matches_plain(cuda, psz, B):
    planes, q, starts, _ = _stream_inputs(psz + B, 1, psz, B)
    planes = [x[0] for x in planes]
    before = bfa.launches
    s, c = bfa.batched_filter_agg(*[x.to(cuda) for x in planes],
                                  *[x.to(cuda) for x in q],
                                  starts[0].to(cuda))
    torch.cuda.synchronize()
    assert bfa.launches == before + 1
    ps, pc = bfa.batched_filter_agg_plain(*planes, *q, starts[0])
    assert torch.equal(s.cpu(), ps) and torch.equal(c.cpu(), pc)


@pytest.mark.parametrize("psz", [3, 8, 32, 256])
def test_cuda_stream_k4_starts_past_local_pages_give_zeros(cuda, psz):
    planes, q, starts, local = _stream_inputs(psz, 4, psz, 8,
                                              starts="beyond")
    s, c = _run_k4(cuda, planes, q, starts, local)
    assert not c.any() and not s.any()


def test_cuda_stream_more_live_tiles_than_blocks(cuda):
    planes, q, starts, local = _stream_inputs(31, 2, 3, 9, n_pages=3000)
    starts[:, :] = 0
    n_tiles = 2 * 3000 * 3 // bfa.stream_tile_rows(3, 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert n_tiles > 8 * sms  # at most 8 blocks of 256 threads per SM
    _run_k4(cuda, planes, q, starts, local, block_pages=1)


@pytest.mark.parametrize("B", [8, 65])
@pytest.mark.parametrize("psz", [3, 256])
def test_cuda_stream_k1_equals_k4_at_one_shard(cuda, psz, B):
    planes, q, starts, _ = _stream_inputs(psz * B, 1, psz, B)
    planes = [x.to(cuda) for x in planes]
    q = [x.to(cuda) for x in q]
    full = torch.tensor([planes[0].shape[1]], dtype=torch.int32,
                        device=cuda)
    s4, c4 = bfa.sharded_batched_filter_agg(*planes, *q, starts.to(cuda),
                                            full)
    s1, c1 = bfa.batched_filter_agg(*[x[0] for x in planes], *q,
                                    starts[0].to(cuda))
    assert torch.equal(s4, s1) and torch.equal(c4, c1)


def test_cuda_stream_offset_planes_match_plain(cuda):
    """Planes that start mid-word (every plane 12 bytes past a 16-byte
    boundary) and planes that disagree modulo 16 bytes (page size 3 on
    an odd page count) both take the stream path."""
    planes, q, starts, local = _stream_inputs(41, 1, 3, 8, n_pages=400)
    offset = [x[:, 1:] for x in planes]  # 3 rows = 12 bytes in
    _run_k4(cuda, offset, q, starts, local - 1)
    planes, q, starts, local = _stream_inputs(42, 1, 3, 8, n_pages=401)
    _run_k4(cuda, planes, q, starts, local)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_cuda_kernels_reject_strided_planes(cuda, kernel):
    """Every kernel reads unit-stride planes only: a plane of a
    row-major 21-attribute table (row stride 21) raises, and nothing
    launches."""
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(
        0, 100, size=(40, 8, 21)).astype(np.int32)).to(cuda)
    begin = torch.zeros((40, 8), dtype=torch.int32, device=cuda)
    end = torch.full((40, 8), I32_MAX, dtype=torch.int32, device=cuda)
    planes = (data[..., 3], data[..., 1], data[..., 2], begin, end)
    stacked = [x[None] for x in planes]
    q = [torch.zeros(2, dtype=torch.int32, device=cuda)] * 5
    local = torch.tensor([40], dtype=torch.int32, device=cuda)
    call = {
        "K1": lambda: bfa.batched_filter_agg(*planes, *q, q[0]),
        "K2": lambda: fa.filter_agg(*planes, 0, 1, 0, 1, 0),
        "K3": lambda: bfa.sharded_batched_filter_agg_masked(
            *stacked, *q, torch.zeros((1, 2), dtype=torch.int32,
                                      device=cuda), local),
        "K4": lambda: bfa.sharded_batched_filter_agg(
            *stacked, *q, q[0][None], local),
    }[kernel]
    counts = (bfa.launches, fa.launches, bfa.masked_launches,
              bfa.sharded_launches)
    with pytest.raises(ValueError, match="row stride 21"):
        call()
    assert (bfa.launches, fa.launches, bfa.masked_launches,
            bfa.sharded_launches) == counts


def test_cuda_k4_rejects_more_shards_than_its_shard_table(cuda):
    """K4 keeps its shard table in shared memory (at most 1,024 shards):
    a launch over more raises, and the counter does not move."""
    S = 1025
    planes = [torch.zeros((S, 1, 4), dtype=torch.int32, device=cuda)
              for _ in range(5)]
    q = [torch.zeros(2, dtype=torch.int32, device=cuda)] * 5
    n4 = bfa.sharded_launches
    with pytest.raises(RuntimeError, match="K4 launch failed"):
        bfa.sharded_batched_filter_agg(
            *planes, *q, torch.zeros((S, 2), dtype=torch.int32, device=cuda),
            torch.ones(S, dtype=torch.int32, device=cuda))
    assert bfa.sharded_launches == n4


@pytest.mark.parametrize("num_shards,aware", [(1, False), (4, True)],
                         ids=["1-shard", "4-shard-aware"])
def test_cuda_run_workload_kernel_twin_equals_plain_twin(cuda, num_shards,
                                                        aware):
    """A 72-query read_heavy hybrid_workload through ``run_workload`` on
    the card at the CPU tests' size (3,000 rows, pages of 128): the run
    with ``use_kernel`` launches K1 (K4 on 4 shards) and equals the run
    on the plain path in every RunResult field but wall_s and
    execution_tiers."""
    import dataclasses

    from repro_torch import api as P

    src = P.make_tuner_db(n_rows=3_000, page_size=128, device=cuda)
    out = {}
    for use_kernel in (True, False):
        tables = {k: t._replace(data=t.data.clone(),
                                begin_ts=t.begin_ts.clone(),
                                end_ts=t.end_ts.clone())
                  for k, t in src.tables.items()}
        tdb = P.TunerDB(tables=tables, quantiles=src.quantiles,
                        n_rows=src.n_rows, rng=None)
        gen = P.QueryGen(tdb, selectivity=0.01, seed=23)
        wl = P.hybrid_workload(gen, "read_heavy", total=72, phase_len=24,
                               seed=2)
        db = P.Database(dict(tdb.tables))
        cfg = P.RunConfig(
            execution=P.ExecOptions(read_batch_size=6, num_shards=num_shards,
                                    use_kernel=use_kernel),
            tuning=P.TuningOptions(tuning_interval_ms=2.0,
                                   shard_aware_tuning=aware))
        before = (bfa.launches, bfa.sharded_launches)
        out[use_kernel] = P.run_workload(db, P.make_dl_tuner(db, "predictive"),
                                         wl, cfg)
        launched = (bfa.launches - before[0],
                    bfa.sharded_launches - before[1])
        if use_kernel:
            assert launched[num_shards > 1] > 0
            assert out[True].execution_tiers == {"kernel": 67}
        else:
            assert launched == (0, 0)
    for f in dataclasses.fields(P.RunResult):
        if f.name not in ("wall_s", "execution_tiers"):
            assert getattr(out[True], f.name) == getattr(out[False], f.name), (
                f.name)
    assert out[True].tuner_work_units > 0.0


@pytest.mark.parametrize("num_shards", [1, 4], ids=["K1", "K4-vbp"])
def test_cuda_adaptive_bursts_kernel_twin_equals_plain_twin(cuda,
                                                            num_shards):
    """The baselines' read bursts on the card: an ``AdaptiveTuner`` run
    (VBP populations on every scan, ``pure_vbp`` once a sub-domain is
    covered) of 72 read_heavy queries in bursts of 6.  The run with
    ``use_kernel`` launches K1 for the table groups on one shard and K4
    on 4 shards (a ``ShardedVbpState`` over stacked shards), and equals
    the plain run in every RunResult field but wall_s and
    execution_tiers, with the same VBP index states."""
    import dataclasses

    from repro_torch import api as P

    src = P.make_tuner_db(n_rows=3_000, page_size=128, device=cuda)
    out, dbs = {}, {}
    for use_kernel in (True, False):
        tables = {k: t._replace(data=t.data.clone(),
                                begin_ts=t.begin_ts.clone(),
                                end_ts=t.end_ts.clone())
                  for k, t in src.tables.items()}
        tdb = P.TunerDB(tables=tables, quantiles=src.quantiles,
                        n_rows=src.n_rows, rng=None)
        gen = P.QueryGen(tdb, selectivity=0.01, seed=23)
        wl = P.hybrid_workload(gen, "read_heavy", total=72, phase_len=24,
                               seed=2)
        db = P.Database(dict(tdb.tables))
        cfg = P.RunConfig(
            execution=P.ExecOptions(read_batch_size=6, num_shards=num_shards,
                                    use_kernel=use_kernel),
            tuning=P.TuningOptions(tuning_interval_ms=2.0))
        before = (bfa.launches, bfa.sharded_launches)
        out[use_kernel] = P.run_workload(db, P.AdaptiveTuner(db), wl, cfg)
        dbs[use_kernel] = db
        launched = (bfa.launches - before[0],
                    bfa.sharded_launches - before[1])
        if use_kernel:
            assert launched[num_shards > 1] > 0
            assert launched[num_shards == 1] == 0
        else:
            assert launched == (0, 0)
    for f in dataclasses.fields(P.RunResult):
        if f.name not in ("wall_s", "execution_tiers"):
            assert getattr(out[True], f.name) == getattr(out[False], f.name), (
                f.name)
    assert list(dbs[True].indexes) == list(dbs[False].indexes)
    for name, a in dbs[True].indexes.items():
        b = dbs[False].indexes[name]
        assert a.scheme == "vbp" and a.cov_union.ivs == b.cov_union.ivs
        for x, y in zip(a.vbp.index[:3], b.vbp.index[:3]):
            assert torch.equal(x, y)
        assert torch.equal(a.vbp.in_index, b.vbp.in_index)
    assert any(dbs[True].planner.plan_scan(q).path == "pure_vbp"
               for _, q in wl if q.kind == "scan")



def _lane_twins(cuda, serving, num_shards=1, faults=None, **tuning):
    """The async build lane on the card at the CPU tests' size (3,000
    rows, pages of 128, 160 read_heavy queries in bursts of 6): a run
    with ``use_kernel`` and one on the plain path, equal in every
    RunResult field but wall_s, execution_tiers and build_pages_per_ms.
    Returns the kernel run's result and its K1 / K3 / K4 launches."""
    import dataclasses

    from repro_torch import api as P

    src = P.make_tuner_db(n_rows=3_000, page_size=128, device=cuda)
    out, launches = {}, None
    for use_kernel in (True, False):
        tables = {k: t._replace(data=t.data.clone(),
                                begin_ts=t.begin_ts.clone(),
                                end_ts=t.end_ts.clone())
                  for k, t in src.tables.items()}
        tdb = P.TunerDB(tables=tables, quantiles=src.quantiles,
                        n_rows=src.n_rows, rng=None)
        gen = P.QueryGen(tdb, selectivity=0.01, seed=23)
        wl = P.hybrid_workload(gen, "read_heavy", total=160, phase_len=40,
                               seed=2)
        db = P.Database(dict(tdb.tables))
        cfg = P.RunConfig(
            execution=P.ExecOptions(read_batch_size=6, num_shards=num_shards,
                                    use_kernel=use_kernel),
            tuning=P.TuningOptions(tuning_interval_ms=2.0, **tuning),
            serving=P.ServingOptions(**serving),
            faults=P.FaultOptions(
                fault_schedule=None if faults is None
                else P.FaultSchedule(**faults)))
        counters = ("launches", "masked_launches", "sharded_launches")
        before = [getattr(bfa, c) for c in counters]
        out[use_kernel] = P.run_workload(db, P.make_dl_tuner(db, "predictive"),
                                         wl, cfg)
        launched = tuple(getattr(bfa, c) - b
                         for c, b in zip(counters, before))
        if use_kernel:
            launches = launched
        else:
            assert launched == (0, 0, 0)
    for f in dataclasses.fields(P.RunResult):
        if f.name not in ("wall_s", "execution_tiers", "build_pages_per_ms"):
            assert getattr(out[True], f.name) == getattr(out[False], f.name), (
                f.name)
    assert out[True].build_escalations == 0
    return out[True], launches


@pytest.mark.parametrize("num_shards,crack", [(1, False), (4, False),
                                              (1, True)],
                         ids=["K1", "K4", "K3-crack"])
def test_cuda_overlap_lane_kernel_twin_equals_plain_twin(cuda, num_shards,
                                                         crack):
    """Overlap mode: quanta run between a burst's kernel groups on the
    card while the groups scan the states pinned at burst start; the
    kernel twin equals the plain twin in every simulated field."""
    res, (k1, k3, k4) = _lane_twins(
        cuda, {}, num_shards, async_tuning="overlap", crack_on_scan=crack)
    assert res.tuner_overlapped_ms > 0.0 and res.tuner_charged_ms == 0.0
    assert res.build_pages_per_ms > 0.0
    assert (k4 if num_shards > 1 else k3 if crack else k1) > 0


@pytest.mark.parametrize("mode", ["deterministic", "overlap"])
def test_cuda_open_loop_kernel_twin_equals_plain_twin(cuda, mode):
    """The open loop (bursty arrivals, deadline bursts, the build
    throttle) under every transient fault category, kernel twin against
    plain twin on the card.  Retried quanta come back in clumps, so the
    queue cap is set past the deepest queue: the lane's drains then
    never escalate (an escalated drain's size reads the wall clock)."""
    res, (k1, _, _) = _lane_twins(
        cuda, dict(arrival_stream="bursty", arrival_ms=0.5, arrival_seed=7,
                   slo_ms=2.0, burst_deadline_ms=0.5, build_throttle=True),
        faults=dict(seed=7, scan_error_rate=0.15, straggler_rate=0.2,
                    straggler_ms=0.3, build_fail_rate=0.3),
        async_tuning=mode, build_queue_cap=512)
    assert k1 > 0 and res.slo_report is not None
    assert res.build_throttle_deferrals > 0
    assert res.fault_scan_retries + res.fault_stragglers > 0


def _replica_burst(device, use_kernel):
    """A 3-replica set at the CPU tests' size (3,000 rows, pages of 128)
    whose replica 1 alone holds a half-built index on attribute 1, and
    a standalone engine with replica 1's catalog.  Runs two read bursts
    of 6 through the set -- attribute 1 (routed to replica 1, a hybrid
    group) and attribute 2 (no index: replica 0) -- and the attribute-1
    burst through the standalone engine.  Returns (set stats, routes,
    set launches, standalone launches)."""
    from repro_torch import api as P
    from repro_torch.core.table import clone_table

    src = P.make_tuner_db(n_rows=3_000, page_size=128, device=device)

    def indexed(db):
        bi = db.create_index(P.IndexDescriptor("narrow", (1,)), "vap")
        db.vap_build_step(bi, 12)
        return db

    def fresh():
        return P.Database({k: clone_table(t) for k, t in src.tables.items()})

    rs = P.ReplicaSet(fresh(), 3)
    indexed(rs.dbs[1])
    solo = indexed(fresh())
    gen = P.QueryGen(src, selectivity=0.01, seed=23)
    hot = [gen.low_s(attr=1) for _ in range(6)]
    cold = [gen.low_s(attr=2) for _ in range(6)]
    before = bfa.launches
    stats = rs.execute_batch(hot, use_kernel=use_kernel)
    stats += rs.execute_batch(cold, use_kernel=use_kernel)
    set_launches = bfa.launches - before
    before = bfa.launches
    solo.execute_batch(hot, use_kernel=use_kernel)
    solo.execute_batch(cold, use_kernel=use_kernel)
    return stats, rs.routed_queries, set_launches, bfa.launches - before


def test_cuda_replica_burst_launches_on_the_routed_replica_only(cuda):
    """The replica tier on the card: each routed read burst runs K1 on
    the replica the router chose and on no other (the set launches what
    one engine launches for the same bursts), and its answers equal the
    plain twin's."""
    stats, routes, launched, solo = _replica_burst(cuda, True)
    plain, plain_routes, plain_launched, _ = _replica_burst(cuda, False)
    assert routes == plain_routes == [1, 0]
    assert launched == solo > 0 and plain_launched == 0
    key = ("cost_units", "latency_ms", "used_index", "agg_sum", "count")
    for a, b in zip(stats, plain):
        assert a.tier == "kernel"
        assert [getattr(a, f) for f in key] == [getattr(b, f) for f in key]

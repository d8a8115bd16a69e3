"""The port's CUDA kernels K1-K4 against their plain PyTorch versions.

These need the card (marker ``cuda``): each test skips without a CUDA
device.  The file imports nothing of JAX, so it runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched_filter_agg as bfa
from repro_torch.kernels import filter_agg as fa

I32_MIN, I32_MAX = -(2**31), 2**31 - 1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _planes(seed, n_pages=300, psz=64, n_attrs=5):
    """Strided column planes of a (n_pages, psz, n_attrs) table with
    values that wrap int32 sums and MVCC gaps."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(
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


def _masked_inputs(seed, S, n_pages=333, psz=32, cover="scattered"):
    """Stacked (S, n_pages, psz) planes with ragged real page counts
    (padding pages invisible), queries, and packed coverage words."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(
        2**30, I32_MAX, size=(S, n_pages, psz, 5)).astype(np.int32))
    begin = rng.integers(0, 20, size=(S, n_pages, psz)).astype(np.int32)
    end = np.where(rng.random((S, n_pages, psz)) < 0.2,
                   rng.integers(5, 30, size=(S, n_pages, psz)),
                   I32_MAX).astype(np.int32)
    local = np.array([n_pages - 37 * s for s in range(S)], np.int32)
    for s in range(S):
        begin[s, local[s]:] = I32_MAX
    built = {"empty": np.zeros((S, n_pages), bool),
             "prefix": np.arange(n_pages)[None, :].repeat(S, 0) < 100,
             "scattered": rng.random((S, n_pages)) < 0.6,
             "full": np.ones((S, n_pages), bool)}[cover]
    W = -(-n_pages // 32)
    bits = np.pad(built, ((0, 0), (0, W * 32 - n_pages))).astype(np.uint32)
    words = (bits.reshape(S, W, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32).view(np.int32)
    planes = (data[..., 1], data[..., 3], data[..., 2],
              torch.from_numpy(begin), torch.from_numpy(end))
    q = _queries(seed, 9, n_pages)[:5]
    return planes, q, torch.from_numpy(words), torch.from_numpy(local)


@pytest.mark.parametrize("cover", ["empty", "prefix", "scattered", "full"])
@pytest.mark.parametrize("block_pages", [None, 1, 7, 40])
@pytest.mark.parametrize("S", [1, 4])
def test_cuda_k3_matches_plain(cuda, S, block_pages, cover):
    planes, q, words, local = _masked_inputs(S + 3, S, cover=cover)
    before = bfa.masked_launches
    s, c = bfa.sharded_batched_filter_agg_masked(
        *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
        words.to(cuda), local.to(cuda), block_pages=block_pages)
    torch.cuda.synchronize()
    assert bfa.masked_launches == before + 1
    ps, pc = bfa.sharded_batched_filter_agg_masked_plain(*planes, *q, words,
                                                         local)
    assert torch.equal(s.cpu(), ps) and torch.equal(c.cpu(), pc)
    if cover == "full":  # every tile returns before loading a row
        assert not c.any() and not s.any()


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
        bfa.sharded_batched_filter_agg_masked(
            *[x.to(cuda) for x in planes], *[x.to(cuda) for x in q],
            words[:, :-1].to(cuda), local.to(cuda))
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

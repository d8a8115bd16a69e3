"""The port's CUDA kernels K1/K2 against their plain PyTorch versions.

These need the card: each test skips without a CUDA device.  The file
imports nothing of JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched_filter_agg as bfa
from repro_torch.kernels import filter_agg as fa

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


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

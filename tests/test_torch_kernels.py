"""Parity of the port's scan kernels K1/K2/K4 with the Pallas kernels.

The port's wrappers run their plain PyTorch versions here (CPU
tensors); the reference runs its Pallas kernels in interpret mode, as
its own tests do.  Same numpy inputs, bit-equal int32 results.  The
CUDA kernels themselves are compared with the plain versions on the
card (tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.batched_filter_agg import (
    batched_filter_agg as ref_batched,
    sharded_batched_filter_agg as ref_sharded,
)
from repro.kernels.filter_agg import filter_agg as ref_single
from repro.core.table import load_table as ref_load_table
from repro_torch.core.convert import table_from_reference
from repro_torch.core.table import shard_table
from repro_torch.kernels import _build, ops
from repro_torch.kernels import batched_filter_agg as bfa
from repro_torch.kernels import filter_agg as fa
from repro_torch.kernels import ref as port_ref

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
N_PAGES, PSZ, N_ATTRS = 20, 64, 5


def _planes(seed, n_pages=N_PAGES, psz=PSZ, wrap=False):
    """(data, begin_ts, end_ts) numpy with MVCC gaps: some rows not
    yet visible, some terminated, a tail of empty slots."""
    rng = np.random.default_rng(seed)
    if wrap:  # values near INT32_MAX: sums overflow int32
        data = rng.integers(2**30, I32_MAX, size=(n_pages, psz, N_ATTRS))
    else:
        data = rng.integers(0, 1000, size=(n_pages, psz, N_ATTRS))
    data = data.astype(np.int32)
    begin = rng.integers(0, 20, size=(n_pages, psz)).astype(np.int32)
    end = np.where(rng.random((n_pages, psz)) < 0.2,
                   rng.integers(5, 30, size=(n_pages, psz)),
                   I32_MAX).astype(np.int32)
    begin.reshape(-1)[-psz // 2:] = I32_MAX  # unoccupied slots
    return data, begin, end


def _queries(seed, B, n_attrs_pred, start_kind, n_pages=N_PAGES, wrap=False):
    rng = np.random.default_rng(seed + 1)
    hi_dom = I32_MAX if wrap else 1000
    lo_dom = 2**30 if wrap else 0
    los = rng.integers(lo_dom, hi_dom, size=(B, 2)).astype(np.int64)
    width = (hi_dom - lo_dom) // 2
    his = np.minimum(los + width, I32_MAX)
    if n_attrs_pred == 1:
        los[:, 1], his[:, 1] = I32_MIN, I32_MAX
    tss = rng.integers(0, 30, size=B)
    starts = {
        "zero": np.zeros(B),
        "mid": rng.integers(0, n_pages, size=B),
        "at_end": np.full(B, n_pages),
        "beyond": np.full(B, n_pages + 7),
        "mixed": rng.integers(0, n_pages + 3, size=B),
    }[start_kind]
    cols = [los[:, 0], his[:, 0], los[:, 1], his[:, 1], tss, starts]
    return [np.asarray(c, np.int32) for c in cols]


def _views(data, begin, end, attrs, agg_attr, as_torch):
    conv = torch.from_numpy if as_torch else jnp.asarray
    d = conv(data)
    p0 = d[:, :, attrs[0]]
    p1 = d[:, :, attrs[1]] if len(attrs) == 2 else p0
    return p0, p1, d[:, :, agg_attr], conv(begin), conv(end)


CASES = [
    (attrs, start, wrap)
    for attrs in ((1,), (1, 3))
    for start in ("zero", "mid", "at_end", "beyond", "mixed")
    for wrap in (False, True)
]


@pytest.mark.parametrize("attrs,start,wrap", CASES)
def test_k1_plain_matches_pallas(attrs, start, wrap):
    data, begin, end = _planes(seed=len(attrs) * 10 + wrap, wrap=wrap)
    q = _queries(seed=3, B=5, n_attrs_pred=len(attrs), start_kind=start,
                 wrap=wrap)
    ref = ref_batched(*_views(data, begin, end, attrs, 4, False),
                      *[jnp.asarray(x) for x in q], block_pages=8,
                      interpret=True)
    out = bfa.batched_filter_agg(*_views(data, begin, end, attrs, 4, True),
                                 *[torch.from_numpy(x) for x in q])
    oracle = port_ref.batched_filter_agg_ref(
        *_views(data, begin, end, attrs, 4, True),
        *[torch.from_numpy(x) for x in q])
    for r, o, orc in zip(ref, out, oracle):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        np.testing.assert_array_equal(orc.numpy(), np.asarray(r))


def test_k1_sums_wrap_like_int32():
    data, begin, end = _planes(seed=5, wrap=True)
    begin[:] = 0
    end[:] = I32_MAX
    q = [np.array([v], np.int32) for v in
         (I32_MIN, I32_MAX, I32_MIN, I32_MAX, 0, 0)]
    s, c = bfa.batched_filter_agg(*_views(data, begin, end, (1,), 4, True),
                                  *[torch.from_numpy(x) for x in q])
    exact = int(data[:, :, 4].astype(np.int64).sum())
    assert exact > I32_MAX  # the true sum overflows
    wrapped = (exact + 2**31) % 2**32 - 2**31
    assert int(s[0]) == wrapped
    assert int(c[0]) == N_PAGES * PSZ


@pytest.mark.parametrize("start_page", [None, 0, 7, N_PAGES, N_PAGES + 3])
@pytest.mark.parametrize("attrs", [(2,), (1, 2)])
def test_k2_plain_matches_pallas(start_page, attrs):
    data, begin, end = _planes(seed=11)
    lo0, hi0, lo1, hi1, ts = 100, 700, 200, 900, 12
    if len(attrs) == 1:
        lo1, hi1 = I32_MIN, I32_MAX
    kw = {} if start_page is None else {"start_page": start_page}
    rs, rc = ref_single(*_views(data, begin, end, attrs, 4, False), lo0,
                        hi0, lo1, hi1, ts, block_pages=8, interpret=True,
                        **({} if start_page is None else
                           {"start_page": jnp.int32(start_page)}))
    s, c = fa.filter_agg(*_views(data, begin, end, attrs, 4, True), lo0, hi0,
                         lo1, hi1, ts, **kw)
    assert (int(s), int(c)) == (int(rs), int(rc))
    assert s.dtype == torch.int32 and s.shape == ()


@pytest.mark.parametrize("start_page", [0, 9])
def test_k1_single_query_batch_equals_k2(start_page):
    data, begin, end = _planes(seed=13)
    vals = (50, 600, I32_MIN, I32_MAX, 15, start_page)
    s1, c1 = fa.filter_agg(*_views(data, begin, end, (3,), 4, True), *vals[:5],
                           start_page=start_page)
    sb, cb = bfa.batched_filter_agg(
        *_views(data, begin, end, (3,), 4, True),
        *[torch.tensor([v], dtype=torch.int32) for v in vals])
    assert (int(sb[0]), int(cb[0])) == (int(s1), int(c1))


def test_k1_result_independent_of_tile_size():
    """The Pallas kernel's result does not depend on its block size and
    the port equals it at each; the CUDA kernel's own tile sizes are
    held against the plain version in test_torch_kernels_cuda.py."""
    data, begin, end = _planes(seed=17, n_pages=37)
    q = _queries(seed=4, B=6, n_attrs_pred=2, start_kind="mixed",
                 n_pages=37)
    outs = set()
    for bp in (3, 8, 37):
        r = ref_batched(*_views(data, begin, end, (1, 2), 3, False),
                        *[jnp.asarray(x) for x in q], block_pages=bp,
                        interpret=True)
        s, c = bfa.batched_filter_agg(
            *_views(data, begin, end, (1, 2), 3, True),
            *[torch.from_numpy(x) for x in q], block_pages=bp)
        assert (s.tolist(), c.tolist()) == tuple(np.asarray(x).tolist()
                                                  for x in r)
        outs.add((tuple(s.tolist()), tuple(c.tolist())))
    assert len(outs) == 1
    assert bfa.tile_pages(58594, 256) == 16
    assert bfa.tile_pages(3, 64) == 3


# ---------------------------------------------------------------------------
# K4: the sharded scan (S stacked shards, per-(shard, query) local starts)
# ---------------------------------------------------------------------------

K4_PAGES = 21  # not a multiple of the Pallas block (8)


def _k4_inputs(S, start_kind, seed):
    """Stacked (S, K4_PAGES, PSZ) planes with ragged real page counts
    (padding pages invisible), 6 queries and an (S, 6) table of local
    start pages."""
    rng = np.random.default_rng(seed)
    data, begin, end = _planes(seed, n_pages=S * K4_PAGES, wrap=True)
    shape = (S, K4_PAGES, PSZ)
    data = data.reshape(shape + (N_ATTRS,))
    begin, end = begin.reshape(shape), end.reshape(shape)
    local = np.array([K4_PAGES - 5 * s for s in range(S)], np.int32)
    for s in range(S):
        begin[s, local[s]:] = I32_MAX
    q = _queries(seed, B=6, n_attrs_pred=2, start_kind="zero", wrap=True)
    B = 6
    g = rng.integers(0, S * K4_PAGES, size=B)
    sid = np.arange(S)[:, None]
    starts = {
        "zero": np.zeros((S, B)),
        "global": np.maximum((g[None, :] - sid + S - 1) // S, 0),
        "divergent": rng.integers(0, K4_PAGES, size=(S, B)),
        "beyond": local[:, None] + rng.integers(0, 4, size=(S, B)),
    }[start_kind].astype(np.int32)
    return data, begin, end, q[:5], starts, local


def _k4_views(data, begin, end, as_torch):
    conv = torch.from_numpy if as_torch else jnp.asarray
    d = conv(data)
    return d[..., 1], d[..., 3], d[..., 4], conv(begin), conv(end)


@pytest.mark.parametrize("start_kind", ["zero", "global", "divergent",
                                        "beyond"])
@pytest.mark.parametrize("S", [1, 3])
def test_k4_plain_matches_pallas(S, start_kind):
    data, begin, end, q, starts, local = _k4_inputs(S, start_kind, S + 7)
    ref = ref_sharded(*_k4_views(data, begin, end, False),
                      *[jnp.asarray(x) for x in q], jnp.asarray(starts),
                      jnp.asarray(local), block_pages=8, interpret=True)
    args = (*_k4_views(data, begin, end, True),
            *[torch.from_numpy(x) for x in q], torch.from_numpy(starts),
            torch.from_numpy(local))
    before = bfa.sharded_launches
    out = bfa.sharded_batched_filter_agg(*args)
    assert bfa.sharded_launches == before  # the CPU takes the plain version
    oracle = port_ref.sharded_batched_filter_agg_ref(*args)
    for r, o, orc in zip(ref, out, oracle):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        np.testing.assert_array_equal(orc.numpy(), np.asarray(r))
    if start_kind == "beyond":
        assert not out[1].any()


@pytest.mark.parametrize("start_kind", ["zero", "divergent"])
def test_k4_one_shard_equals_k1(start_kind):
    data, begin, end, q, starts, local = _k4_inputs(1, start_kind, 5)
    local[0] = K4_PAGES
    k4 = bfa.sharded_batched_filter_agg(
        *_k4_views(data, begin, end, True),
        *[torch.from_numpy(x) for x in q], torch.from_numpy(starts),
        torch.from_numpy(local))
    k1 = bfa.batched_filter_agg(
        *[x[0] for x in _k4_views(data, begin, end, True)],
        *[torch.from_numpy(x) for x in q], torch.from_numpy(starts[0]))
    assert [x.tolist() for x in k4] == [x.tolist() for x in k1]


def test_k4_zero_starts_equal_a_full_scan():
    """Zero local starts over S shards = K1 from page 0 over all
    stacked pages (padding pages are invisible)."""
    data, begin, end, q, starts, local = _k4_inputs(3, "zero", 6)
    k4 = bfa.sharded_batched_filter_agg(
        *_k4_views(data, begin, end, True),
        *[torch.from_numpy(x) for x in q], torch.from_numpy(starts),
        torch.from_numpy(local))
    flat = [x.reshape(-1, PSZ) for x in _k4_views(data, begin, end, True)]
    k1 = bfa.batched_filter_agg(*flat, *[torch.from_numpy(x) for x in q],
                                torch.zeros(6, dtype=torch.int32))
    assert [x.tolist() for x in k4] == [x.tolist() for x in k1]


def test_k4_wrapper_validates_operands():
    data, begin, end, q, starts, local = _k4_inputs(2, "zero", 8)
    planes = _k4_views(data, begin, end, True)
    qt = [torch.from_numpy(x) for x in q]
    with pytest.raises(ValueError, match="start_pages"):
        bfa.sharded_batched_filter_agg(*planes, *qt,
                                       torch.from_numpy(starts[:1]),
                                       torch.from_numpy(local))
    with pytest.raises(ValueError, match="local_pages"):
        bfa.sharded_batched_filter_agg(*planes, *qt,
                                       torch.from_numpy(starts),
                                       torch.from_numpy(local[:1]))
    with pytest.raises(ValueError, match="3-D"):
        bfa.sharded_batched_filter_agg(*[x[0] for x in planes], *qt,
                                       torch.from_numpy(starts),
                                       torch.from_numpy(local))
    meta = [torch.empty((2, 4, 8), dtype=torch.int32, device="meta")] * 5
    mq = [torch.zeros((6,), dtype=torch.int32, device="meta")] * 5
    before = bfa.sharded_launches
    with pytest.raises(ValueError, match="no K4 kernel"):
        bfa.sharded_batched_filter_agg(
            *meta, *mq, torch.zeros((2, 6), dtype=torch.int32, device="meta"),
            torch.zeros((2,), dtype=torch.int32, device="meta"))
    assert bfa.sharded_launches == before


def _ref_and_port_table(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1000, size=(900, N_ATTRS)).astype(np.int32)
    rt = ref_load_table(vals, page_size=PSZ, n_pages=18)
    pt = table_from_reference([np.asarray(x) for x in rt], device="cpu")
    return rt, pt


@pytest.mark.parametrize("attrs", [(1,), (1, 3)])
def test_ops_adapters_match_reference(attrs):
    rt, pt = _ref_and_port_table(seed=21)
    los = tuple([150] * len(attrs))
    his = tuple([650] * len(attrs))
    r = ref_ops.scan_table(rt, attrs, los, his, 0, 4)
    p = ops.scan_table(pt, attrs, los, his, 0, 4)
    assert (int(p[0]), int(p[1])) == (int(r[0]), int(r[1]))
    r = ref_ops.scan_table_hybrid(rt, attrs, los, his, 0, 4, start_page=5)
    p = ops.scan_table_hybrid(pt, attrs, los, his, 0, 4, start_page=5)
    assert (int(p[0]), int(p[1])) == (int(r[0]), int(r[1]))
    blos = np.array([[100 + 50 * i] * len(attrs) for i in range(4)],
                    np.int32)
    bhis = blos + 300
    tss = np.zeros(4, np.int32)
    starts = np.array([0, 3, 17, 40], np.int32)
    r = ref_ops.scan_table_batched(rt, attrs, jnp.asarray(blos),
                                   jnp.asarray(bhis), jnp.asarray(tss), 2,
                                   start_pages=jnp.asarray(starts))
    p = ops.scan_table_batched(pt, attrs, torch.from_numpy(blos),
                               torch.from_numpy(bhis), torch.from_numpy(tss),
                               2, start_pages=torch.from_numpy(starts))
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_unported_adapters_raise():
    """Every adapter is ported now.  On one table: the masked adapter
    (K3) with an empty bitmap scans every page, as K1 from page 0 does;
    the sharded adapters over a one-shard ``ShardedTable`` -- K4 with
    zero starts, K3 with an empty bitmap -- equal it too.  Predicates
    on more than two columns still raise."""
    _, pt = _ref_and_port_table(seed=3)
    los = torch.tensor([[100], [400]], dtype=torch.int32)
    his, tss = los + 300, torch.zeros(2, dtype=torch.int32)
    words = torch.zeros((1, 1), dtype=torch.int32)
    got = ops.scan_table_batched_masked(pt, (1,), los, his, tss, 2, words)
    want = ops.scan_table_batched(pt, (1,), los, his, tss, 2)
    assert [x.tolist() for x in got] == [x.tolist() for x in want]
    st = shard_table(pt, 1)
    starts = torch.zeros((1, 2), dtype=torch.int32)
    for got in (ops.scan_shards_batched(st, (1,), los, his, tss, 2, starts),
                ops.scan_shards_batched_masked(st, (1,), los, his, tss, 2,
                                               words)):
        assert [x.tolist() for x in got] == [x.tolist() for x in want]
    with pytest.raises(ValueError, match="1 or 2 predicate"):
        ops.scan_shards_batched(st, (1, 2, 3), los, his, tss, 2, starts)


def test_wrappers_import_without_nvcc_and_never_fall_back(monkeypatch,
                                                          tmp_path):
    if not torch.cuda.is_available():  # importing built nothing
        assert _build._LIB is None
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not _build.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
        assert not (tmp_path / "b").exists()
    # A tensor on a device without a kernel raises; no plain fallback.
    meta = [torch.empty((4, 8), dtype=torch.int32, device="meta")] * 5
    q = [torch.zeros((2,), dtype=torch.int32, device="meta")] * 6
    before = (bfa.launches, fa.launches)
    with pytest.raises(ValueError, match="no K1 kernel"):
        bfa.batched_filter_agg(*meta, *q)
    with pytest.raises(ValueError, match="no K2 kernel"):
        fa.filter_agg(*meta, 0, 1, 0, 1, 0)
    assert (bfa.launches, fa.launches) == before


def test_wrapper_validates_operands():
    data, begin, end = _planes(seed=1)
    planes = _views(data, begin, end, (1,), 4, True)
    q = [torch.zeros((3,), dtype=torch.int32) for _ in range(6)]
    with pytest.raises(TypeError):
        bfa.batched_filter_agg(planes[0].to(torch.int64), *planes[1:], *q)
    with pytest.raises(ValueError):  # rows not evenly spaced
        bfa.batched_filter_agg(torch.from_numpy(data)[:, ::2, 1],
                               *planes[1:], *q)
    with pytest.raises(ValueError):  # per-query operand of wrong length
        bfa.batched_filter_agg(*planes, *q[:5],
                               torch.zeros((2,), dtype=torch.int32))

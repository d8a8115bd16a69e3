"""The index builds' merge (``core.index._merge_sorted``) against the
stable sort of the whole concatenation it replaces.

A build's new (key_hi, key_lo, rid) entries go into the sorted index
by a merge: the new run alone is sorted, each entry's slot is found by
binary search, and the result is cut to the capacity.  Every test here
holds the three arrays, padding slots and their rids included, to the
stable sort of [old, new] by the packed key, cut to the capacity, on
one-column and two-column keys.  The last ones run each build site (VAP
steps, page lists, VBP, plain and sharded) once with the merge and
once with the sort in its place.
"""
import _torch_threads  # noqa: F401  (first: pins torch's threads)

import numpy as np
import pytest
import torch

from repro_torch.bench_db.queries import QueryGen
from repro_torch.bench_db.schema import make_tuner_db
from repro_torch.core import index as ix
from repro_torch.core import table as tb

I32_MAX = ix.I32_MAX


def concat_sort(index, kh, kl, rids):
    """The stable sort of [old, new] by the packed key, cut to the
    capacity: what every build did before the merge."""
    h = torch.cat([index.key_hi, kh.to(torch.int32)])
    lo = torch.cat([index.key_lo, kl.to(torch.int32)])
    r = torch.cat([index.rids, rids.to(torch.int32)])
    keys = h.to(torch.int64) * 2**32 + (lo.to(torch.int64) + 2**31)
    order = torch.sort(keys, stable=True).indices[:index.capacity]
    return h[order], lo[order], r[order]


def sorted_index(rng, cap, n_old, key_max, two_attr=True):
    """An index of ``cap`` slots whose first ``n_old`` hold sorted
    random keys in [0, key_max) (ties in any rid order) and whose
    padding slots hold invalid keys and arbitrary rids."""
    kh = rng.integers(0, key_max, n_old)
    kl = rng.integers(0, key_max, n_old) if two_attr else np.zeros(n_old)
    order = np.lexsort((kl, kh))
    h = np.full(cap, I32_MAX, np.int32)
    lo = np.full(cap, I32_MAX, np.int32)
    h[:n_old], lo[:n_old] = kh[order], kl[order]
    rids = rng.integers(0, 2**31 - 1, cap).astype(np.int32)
    return ix.AdHocIndex(torch.from_numpy(h), torch.from_numpy(lo),
                         torch.from_numpy(rids), n_old, 0)


def new_run(rng, m, key_max, pad_share, two_attr=True, rid_dtype=np.int64):
    """``m`` new entries in random order, about ``pad_share`` of them
    padding (invalid keys with real rids)."""
    kh = rng.integers(0, key_max, m).astype(np.int32)
    kl = (rng.integers(0, key_max, m) if two_attr
          else np.zeros(m)).astype(np.int32)
    pad = rng.random(m) < pad_share
    kh[pad], kl[pad] = I32_MAX, I32_MAX
    rids = rng.integers(0, 2**31 - 1, m).astype(rid_dtype)
    return (torch.from_numpy(kh), torch.from_numpy(kl),
            torch.from_numpy(rids))


def assert_merge_is_the_sort(index, kh, kl, rids):
    want = concat_sort(index, kh, kl, rids)
    got = ix._merge_sorted(index, kh, kl, rids)
    for name, g, w in zip(("key_hi", "key_lo", "rids"), got, want):
        assert g.dtype == torch.int32 and g.shape == (index.capacity,)
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("key_max", [3, 50, 2**31 - 2])
def test_random_runs_with_ties_and_padding(seed, key_max):
    """Heavy ties (3 distinct keys), some, and almost none; padding in
    both runs; the new run up to the free slots or past them."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 400))
    n_old = int(rng.integers(0, cap + 1))
    m = int(rng.integers(0, cap + 20))
    two = bool(seed % 2)
    index = sorted_index(rng, cap, n_old, key_max, two)
    assert_merge_is_the_sort(index, *new_run(rng, m, key_max, 0.3, two))


def test_an_empty_new_run_leaves_the_arrays():
    rng = np.random.default_rng(1)
    index = sorted_index(rng, 64, 40, 10)
    kh, kl, rids = new_run(rng, 0, 10, 0.0)
    assert_merge_is_the_sort(index, kh, kl, rids)
    got = ix._merge_sorted(index, kh, kl, rids)
    for g, a in zip(got, index[:3]):
        assert torch.equal(g, a) and g.data_ptr() != a.data_ptr()


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("pad_share", [0.0, 0.5, 1.0])
def test_a_full_index_keeps_its_entries_before_padding(pad_share, two):
    """n_old = capacity: new real keys push the largest old ones out;
    new padding never gets in."""
    rng = np.random.default_rng(7)
    index = sorted_index(rng, 128, 128, 20, two)
    assert_merge_is_the_sort(index, *new_run(rng, 48, 20, pad_share, two))


@pytest.mark.parametrize("n_old", [0, 3, 6, 8])
def test_one_column_keys_of_int32_max_go_before_padding(n_old):
    """A real one-column key of I32_MAX is (I32_MAX, 0): it sorts before
    the padding (I32_MAX, I32_MAX), old and new alike."""
    kh = np.array([4, 9, I32_MAX, I32_MAX, I32_MAX, 2, I32_MAX, 9])
    old = ix.AdHocIndex(
        torch.tensor(np.sort(kh[:n_old]).tolist() + [I32_MAX] * (8 - n_old),
                     dtype=torch.int32),
        torch.tensor([0] * n_old + [I32_MAX] * (8 - n_old),
                     dtype=torch.int32),
        torch.arange(100, 108, dtype=torch.int32), n_old, 0)
    new = (torch.tensor([I32_MAX, 3, I32_MAX, I32_MAX], dtype=torch.int32),
           torch.tensor([0, 0, I32_MAX, 0], dtype=torch.int32),
           torch.tensor([1, 2, 3, 4]))
    assert_merge_is_the_sort(old, *new)


def test_new_entries_go_after_old_ones_of_their_key():
    index = ix.AdHocIndex(
        torch.tensor([1, 2, 2, I32_MAX, I32_MAX], dtype=torch.int32),
        torch.tensor([0, 5, 5, I32_MAX, I32_MAX], dtype=torch.int32),
        torch.tensor([10, 11, 12, 7, 8], dtype=torch.int32), 3, 0)
    kh = torch.tensor([2, I32_MAX, 1], dtype=torch.int32)
    kl = torch.tensor([5, I32_MAX, 0], dtype=torch.int32)
    rids = torch.tensor([20, 21, 22])
    got = ix._merge_sorted(index, kh, kl, rids)
    assert [t.tolist() for t in got] == [
        [1, 1, 2, 2, 2], [0, 0, 5, 5, 5], [10, 22, 11, 12, 20]]
    assert_merge_is_the_sort(index, kh, kl, rids)


def test_a_pinned_state_is_not_written():
    """The merge writes new tensors: a plan's pinned arrays keep what
    they held."""
    rng = np.random.default_rng(3)
    index = sorted_index(rng, 256, 100, 30, two_attr=False)
    before = [a.clone() for a in index[:3]]
    ix._merge_sorted(index, *new_run(rng, 64, 30, 0.2, False))
    for a, b in zip(index[:3], before):
        assert torch.equal(a, b)


# -- the build sites, merge against sort --------------------------------

SRC = make_tuner_db(n_rows=3_000, page_size=64, device="cpu")


def both_ways(monkeypatch, build):
    """``build()`` with the merge, then with the concatenation's sort
    in its place."""
    merged = build()

    def sort_instead(index, kh, kl, rids):
        return concat_sort(index, kh, kl, rids)

    with monkeypatch.context() as mp:
        mp.setattr(ix, "_merge_sorted", sort_instead)
        sorted_ = build()
    return merged, sorted_


def assert_states_equal(a, b):
    for name in ("key_hi", "key_lo", "rids"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(),
                                      err_msg=name)
    assert a.n_entries == b.n_entries and a.built_pages == b.built_pages


def narrow(S=None):
    t = tb.clone_table(SRC.tables["narrow"])
    return t if S is None else tb.shard_table(t, S)


@pytest.mark.parametrize("S", [None, 2, 4])
@pytest.mark.parametrize("key_attrs", [(1,), (2, 3)])
def test_vap_steps_equal_the_sort(monkeypatch, S, key_attrs):
    table = narrow(S)

    def build():
        state = (ix.make_index(table.capacity, "cpu") if S is None
                 else ix.make_sharded_index(table))
        for pages in (5, 1, 8, 3, 40):
            state, _ = ix.advance_build(state, table, key_attrs, pages)
        return state

    merged, sorted_ = both_ways(monkeypatch, build)
    assert merged.built_pages == 3_000 // 64  # every full page
    assert_states_equal(merged, sorted_)


def test_per_shard_steps_equal_the_sort(monkeypatch):
    table = narrow(4)

    def build():
        state = ix.make_sharded_index(table)
        for shard, pages in ((2, 3), (0, 1), (2, 4), (3, 6)):
            state, _ = ix.advance_build_shard(state, table, (1,), shard,
                                              pages)
        return state

    assert_states_equal(*both_ways(monkeypatch, build))


@pytest.mark.parametrize("S", [None, 4])
def test_page_lists_equal_the_sort(monkeypatch, S):
    table = narrow(S)
    rng = np.random.default_rng(11)
    lists = [rng.permutation(40)[:n] for n in (7, 1, 12)]
    lists.append(np.arange(40, 46)[::-1])

    def build():
        state = (ix.make_index(table.capacity, "cpu") if S is None
                 else ix.make_sharded_index(table))
        for pages in lists:
            state = ix.build_page_list(state, table, (2, 1), pages)
        return state

    assert_states_equal(*both_ways(monkeypatch, build))


@pytest.mark.parametrize("key_attrs", [(1,), (1, 2)])
@pytest.mark.parametrize("sharded", [False, True])
def test_vbp_populations_equal_the_sort(monkeypatch, sharded, key_attrs):
    table = narrow(4 if sharded else None)
    gen = QueryGen(SRC, selectivity=0.05, seed=19)
    qs = [gen.low_s(attr=1) for _ in range(6)]

    def build():
        state = (ix.make_sharded_vbp(table) if sharded
                 else ix.make_vbp(table.capacity, "cpu"))
        populate = (ix.sharded_vbp_populate_subdomain if sharded
                    else ix.vbp_populate_subdomain)
        added = []
        for k, q in enumerate(qs):
            lo, hi = ix.key_range(int(q.los[0]), int(q.his[0]),
                                  *((1, 500_000) if len(key_attrs) > 1
                                    else ()))
            state, n = populate(state, table, key_attrs, lo, hi, 0,
                                max_add=40 + 30 * k)
            added.append(n)
        return state.index, added

    (a, na), (b, nb) = both_ways(monkeypatch, build)
    assert na == nb and sum(na) > 0
    assert_states_equal(a, b)

"""The data and the statement stream are fixed by the seed."""
import numpy as np
import torch

from pibench import datagen
from pibench.traffic import Traffic

from conftest import tiny_cell


def table_planes(n_attrs, n_rows, seed):
    cols = torch.zeros((n_attrs, n_rows), dtype=torch.int32)
    datagen.fill_columns(lambda a: cols[a], n_attrs, n_rows, seed)
    return cols


def test_data_is_a_function_of_the_seed():
    a = table_planes(6, 5_000, 2**31 + 11)
    assert torch.equal(a, table_planes(6, 5_000, 2**31 + 11))
    assert not torch.equal(a[1:], table_planes(6, 5_000, 5)[1:])
    assert torch.equal(a[0], torch.arange(1, 5_001, dtype=torch.int32))
    assert int(a[1:].min()) >= 1 and int(a[1:].max()) <= datagen.DOMAIN


def test_data_follows_the_tuner_law():
    """The share of the most frequent values (Zipf ranks 1-3) and the
    spread of distinct values match numpy's Zipf(1.25), folded alike."""
    n = 200_000
    ours = table_planes(2, n, 3)[1].numpy()
    raw = np.random.default_rng(3).zipf(datagen.ZIPF_A, n).astype(np.int64)
    theirs = ((raw * datagen.FOLD) % datagen.DOMAIN + 1).astype(np.int32)
    for rank in (1, 2, 3):
        v = (rank * datagen.FOLD) % datagen.DOMAIN + 1
        assert abs((ours == v).mean() - (theirs == v).mean()) < 0.006
    u_ours, u_theirs = len(np.unique(ours)), len(np.unique(theirs))
    assert abs(u_ours - u_theirs) / u_theirs < 0.03


def make_traffic(name, seed, stream=0):
    cell = tiny_cell(name)
    q = np.sort(table_planes(cell.config["n_attrs"], 4_000, seed)[1].numpy())
    return Traffic(cell.traffic, cell.config["n_attrs"], q, seed, stream)


def test_stream_is_a_function_of_the_seed():
    for name in ("narrow-rh-shift", "wide-rh-mods", "narrow-ro-crack",
                 "narrow-wh-shift"):
        a = make_traffic(name, 2**31 + 3)
        b = make_traffic(name, 2**31 + 3)
        c = make_traffic(name, 4)
        assert [a.segment(k) for k in (0, 7)] == [b.segment(k)
                                                   for k in (0, 7)]
        assert a.segment(0) != c.segment(0)
        # A segment does not depend on which segments came before it.
        assert make_traffic(name, 2**31 + 3).segment(7) == a.segment(7)
        # The warm-up draws another stream.
        assert make_traffic(name, 2**31 + 3, stream=1).segment(0) \
            != a.segment(0)


def test_stream_keeps_its_mix():
    t = make_traffic("narrow-rh-shift", 9)
    items = [x for k in range(20) for x in t.segment(k)]
    scans = [s for _, s in items if s.kind == "scan"]
    assert 0.86 < len(scans) / len(items) < 0.94
    assert {s.template for _, s in items} == {"LOW-S", "LOW-U", "HIGH-U"}
    for phase in range(4):
        attrs = {s.attrs[0] for p, s in items if p == phase}
        assert attrs == {t.phase_attrs(phase)[0]}
    w = make_traffic("wide-rh-mods", 9)
    items = [x for k in range(5) for x in w.segment(k)]
    assert {s.template for _, s in items} == {"MOD-S", "HIGH-U"}
    assert all(len(s.attrs) == 2 and s.attrs == w.phase_attrs(p)
               for p, s in items)
    ro = make_traffic("narrow-ro-crack", 9)
    assert all(s.kind == "scan" for _, s in ro.segment(3))

"""The check that decides ``correct``: the reference agrees with the
program at a tiny size on the CPU (the kernels' plain versions), and
the control and each fault the cells can have make it come out false.

The runs skip only the harness's look for a card (``run_cell`` on the
CPU) and drive the rest of a run: set-up, warm-up, the window through
``run_workload``, the reference after it, the comparison.
"""
import io

import pytest
import torch

from pibench import harness
from pibench.reference.serial_store import SerialStore

from conftest import tiny_cell

CELLS = {
    "narrow-rh-shift": {},
    "wide-rh-mods": {},
    "narrow-ro-crack": {},
    "narrow-wh-shift": dict(headroom=10.0),
}


def run(cell, seed=2**31 + 5, seconds=1.0, traced=False):
    return harness.run_cell(cell, seed, seconds, traced, device="cpu",
                            log=io.StringIO())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_program_agrees_with_the_reference(name):
    result, r = run(tiny_cell(name, **CELLS[name]))
    assert result["attempted"] >= 100
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"


def control_mismatches(name, seed):
    """Scans whose float32-summed answer (the control) differs from the
    exact reference's, over one segment-sized stream of the cell."""
    cell = tiny_cell(name)
    cfg = cell.config
    table = harness.make_table(cfg, seed, "cpu")
    from pibench import datagen
    from pibench.traffic import Traffic

    q = datagen.quantile_sample(table.data[..., 1].reshape(-1)[
        :cfg["n_rows"]])
    gen = Traffic(cell.traffic, cfg["n_attrs"], q, seed)
    sent = [s for k in range(3) for _, s in gen.segment(k)]
    exact, _ = harness.reference_answers(cfg, seed, sent, "cpu")
    ctrl, _ = harness.reference_answers(cfg, seed, sent, "cpu",
                                        agg_dtype=torch.float32)
    return sum(a != b for s, a, b in zip(sent, exact, ctrl)
               if s.kind == "scan")


@pytest.mark.parametrize("name", ["narrow-rh-shift", "wide-rh-mods",
                                  "narrow-ro-crack"])
def test_control_is_not_correct(name):
    """The reference summed in float32 disagrees on many scans."""
    for seed in (1, 2, 3):
        assert control_mismatches(name, seed) > 10


def test_store_semantics():
    s = SerialStore(3, 8, "cpu", update_cap=2)
    s.cols[1, :4] = torch.tensor([5, 6, 5, 5], dtype=torch.int32)
    s.cols[2, :4] = torch.tensor([1, 2, 3, -(2**31)], dtype=torch.int32)
    s.loaded(4)
    assert [int(x) for x in s.scan((1,), (5,), (5,), 2)] == [
        4 - 2**31, 3]
    assert s.update((1,), (5,), (5,), (2,), (7,)) == 2  # the first two
    assert s.n == 6 and s.live.tolist() == [False, True, False, True,
                                           True, True, False, False]
    assert [int(x) for x in s.scan((1,), (5,), (5,), 2)] == [
        14 - 2**31, 3]
    with pytest.raises(RuntimeError):
        s.update((1,), (5,), (6,), (2,), (0,))  # 4 rows, 2 slots left:
        s.update((1,), (5,), (6,), (2,), (0,))  # the second overflows


# -- faults planted in the program --------------------------------------

def frozen_update(table, attrs, los, his, set_attrs, set_vals, ts, max_new):
    """An UPDATE that reports its rows and leaves the state unchanged."""
    from repro_torch.core.table import conj_predicate_mask, visible_mask

    m = conj_predicate_mask(table, attrs, los, his) & visible_mask(
        table, int(ts))
    return table, min(int(m.sum()), int(max_new))


def half_batch(fn):
    """A scan kernel that answers the first half of a burst and gives
    the rest the mean of those answers."""
    def plain(*args):
        sums, cnts = fn(*args)
        h = (sums.shape[0] + 1) // 2
        if sums.shape[0] > 1:
            sums, cnts = sums.clone(), cnts.clone()
            sums[h:] = sums[:h].double().mean().to(torch.int32)
            cnts[h:] = cnts[:h].double().mean().to(torch.int32)
        return sums, cnts
    return plain


def altered(fn):
    """A scan kernel whose first answer is off by one where it is made."""
    def plain(*args):
        sums, cnts = fn(*args)
        sums = sums.clone()
        sums[0] += 1
        return sums, cnts
    return plain


@pytest.mark.parametrize("name", ["narrow-rh-shift", "wide-rh-mods",
                                  "narrow-wh-shift"])
def test_unchanged_state_is_not_correct(monkeypatch, name):
    import repro_torch.core.executor as ex

    monkeypatch.setattr(ex, "update_rows", frozen_update)
    result, _ = run(tiny_cell(name, **CELLS[name]))
    assert not result["correct"]
    assert result["checks"]["final_rows_wrong"]["value"] == 1


@pytest.mark.parametrize("fault", [half_batch, altered])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_kernel_faults_are_not_correct(monkeypatch, fault, name):
    from repro_torch.kernels import batched_filter_agg as bfa

    for attr in ("batched_filter_agg_plain",
                 "sharded_batched_filter_agg_masked_plain"):
        monkeypatch.setattr(bfa, attr, fault(getattr(bfa, attr)))
    result, _ = run(tiny_cell(name, **CELLS[name]))
    assert not result["correct"]
    assert result["checks"]["scan_answers_wrong"]["value"] > 0


def test_cell_runs_on_the_card(cuda_device):
    result, _ = harness.run_cell(tiny_cell("narrow-rh-shift"), 11, 1.0,
                                 True, device=cuda_device,
                                 log=io.StringIO())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0

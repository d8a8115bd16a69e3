"""The cell ``narrow-rh-overlap`` at a tiny size on the CPU: the tuner's
build quanta drain on the overlap lane between a burst's dispatches,
the answers agree with the plain reference (``SerialStore``, which
``harness.run_cell`` replays the window on), and the lane's pages are
read by ``lane_pages_per_s`` in a traced run."""
import io

import torch

from pibench import harness, spec
from repro_torch.bench_db.runner import TuningOptions

from conftest import tiny_cell


def test_the_overlap_configuration_states_the_lane_the_run_uses():
    """``tuner-narrow-10m-overlap`` is ``tuner-narrow-10m`` plus the
    build lane's settings, and those are the ones the run is given: the
    mix's ``async_tuning`` and the runner's default quanta and cap."""
    cell = spec.load_cell("narrow-rh-overlap")
    cfg = cell.config
    assert cfg["name"] == "tuner-narrow-10m-overlap"
    base = spec.load_cell("narrow-rh-shift").config
    lane = {"async_tuning", "build_quantum_pages", "build_queue_cap"}
    skip = {"name", "source", "assumed"}
    assert {k: v for k, v in cfg.items() if k not in lane | skip} == {
        k: v for k, v in base.items() if k not in skip}
    given = TuningOptions(**cell.traffic["options"])
    assert {k: getattr(given, k) for k in lane} == {k: cfg[k] for k in lane}


def test_the_overlap_cell_agrees_with_the_reference_and_builds():
    cell = tiny_cell("narrow-rh-overlap")
    assert cell.traffic["options"] == {"async_tuning": "overlap"}
    assert "lane_pages_per_s" in cell.per_layer
    assert "tuner_cycle_ms" not in cell.per_layer
    result, run = harness.run_cell(cell, 2**31 + 9, 1.0, True,
                                   device="cpu", log=io.StringIO())
    assert result["attempted"] >= 100
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert run.cycle_walls_s == []  # the lane calls decide, not a cycle
    assert run.vap_pages > 0
    assert result["metrics"]["lane_pages_per_s"]["value"] == (
        run.vap_pages / run.window_s) > 0


def test_the_control_is_not_correct_on_the_overlap_cell(monkeypatch):
    """The reference summed in float32 (the control), put in place of
    the exact one inside ``harness.run_cell``, is found wrong on the
    overlap cell while the lane builds: the check that decides
    ``correct`` tells the two precisions apart with the lane on."""
    exact = harness.reference_answers

    def control(cfg, seed, sent, device, agg_dtype=torch.int64):
        return exact(cfg, seed, sent, device, agg_dtype=torch.float32)

    monkeypatch.setattr(harness, "reference_answers", control)
    for seed in (1, 2):
        result, run = harness.run_cell(tiny_cell("narrow-rh-overlap"), seed,
                                       1.0, True, device="cpu",
                                       log=io.StringIO())
        assert run.vap_pages > 0
        assert not result["correct"]
        assert result["checks"]["scan_answers_wrong"]["value"] > 10

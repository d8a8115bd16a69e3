"""Parity of the port's LM serving pieces (``repro_torch.serving.
scheduler`` and ``prefix_cache``) with the reference's.

The same lookup / token streams, made from a seed with numpy, drive a
reference and a port instance side by side: every ``lookup`` return,
every ``cycle()`` dict, every entry (``covered_len`` included), the
monitor maps and each Holt-Winters state are compared after every step,
with no tolerance -- the port's forecaster is bit-equal to the
reference's.  The reference's own properties (tests/test_serving.py,
tests/test_runtime.py) then run on the port: scheduler liveness,
partial builds serving lookups, models surviving eviction, every chosen
prefix materialised, the canonical budget order, aging, and a cycle
that replays across ``PYTHONHASHSEED`` values.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.serving import BatchScheduler as RBatchScheduler
from repro.serving import PredictivePrefixCache as RPrefixCache
from repro_torch.serving import BatchScheduler, PredictivePrefixCache

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _cache(**kw):
    return PredictivePrefixCache(device="cpu", **kw)


def _assert_same_cache(ref, port):
    assert port.cycles == ref.cycles
    assert port.known_lengths == ref.known_lengths
    assert port.idle_cycles == ref.idle_cycles
    assert {p: dataclasses.astuple(e) for p, e in port.entries.items()} == {
        p: dataclasses.astuple(e) for p, e in ref.entries.items()}
    assert list(port.entries) == list(ref.entries)  # insertion order
    assert sorted(port.models) == sorted(ref.models)
    for pid, rs in ref.models.items():
        for name, x in zip(rs._fields, port.models[pid]):
            np.testing.assert_array_equal(x.numpy(),
                                          np.asarray(getattr(rs, name)),
                                          err_msg=f"{pid}.{name}")


def _stream(seed, n_prefixes, cycles, season=6):
    """Per cycle, the (prefix, length) lookups of a recurring-prefix
    stream: each prefix has a daily profile (hits by cycle mod
    ``season``), Poisson noise, and a few one-shot prefixes."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 400, n_prefixes)
    profile = rng.integers(0, 6, (n_prefixes, season))
    out = []
    for c in range(cycles):
        hits = rng.poisson(profile[:, c % season])
        items = [(f"p{k:02d}", int(lengths[k]))
                 for k in range(n_prefixes) for _ in range(hits[k])]
        if rng.random() < 0.3:
            items.append((f"once{c}", int(rng.integers(8, 64))))
        order = rng.permutation(len(items))
        out.append([items[i] for i in order])
    return out


CACHE_CASES = {  # (constructor kwargs, stream kwargs)
    "recurring": (dict(hbm_budget_bytes=2_000.0, bytes_per_token=2.0,
                       tokens_per_cycle=256, season_len=6,
                       max_idle_cycles=4),
                  dict(seed=1, n_prefixes=12, cycles=60)),
    "tight_budget": (dict(hbm_budget_bytes=300.0, bytes_per_token=1.0,
                          tokens_per_cycle=64, max_idle_cycles=3),
                     dict(seed=2, n_prefixes=8, cycles=40)),
    "roomy": (dict(hbm_budget_bytes=1e9, bytes_per_token=100.0,
                   tokens_per_cycle=4096),
              dict(seed=3, n_prefixes=5, cycles=30)),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_prefix_cache_matches_reference_step_for_step(case):
    kw, skw = CACHE_CASES[case]
    ref, port = RPrefixCache(**kw), _cache(**kw)
    for lookups in _stream(**skw):
        for pid, length in lookups:
            assert port.lookup(pid, length) == ref.lookup(pid, length)
        assert port.cycle() == ref.cycle()
        _assert_same_cache(ref, port)


def test_scheduler_matches_reference_on_a_random_stream():
    rng = np.random.default_rng(4)
    ref, port = RBatchScheduler(max_batch=3, eos_id=7), BatchScheduler(
        max_batch=3, eos_id=7)
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            prompt = rng.integers(0, 50, rng.integers(1, 6))
            budget = int(rng.integers(-2, 5))
            pid = None if rng.random() < 0.5 else "sys"
            assert port.submit(prompt, budget, pid) == ref.submit(
                prompt, budget, pid)
        elif op == 1:
            assert [r.rid for r in port.admit()] == [
                r.rid for r in ref.admit()]
        else:
            toks = {r.rid: int(rng.integers(0, 10)) for r in ref.active
                    if rng.random() < 0.8}
            ref.record_tokens(toks)
            port.record_tokens(toks)
        for a, b in ((port.queue, ref.queue), (port.active, ref.active)):
            assert [(r.rid, r.prompt.tolist(), r.max_new_tokens,
                     r.prefix_id, r.generated, r.done) for r in a] == [
                (r.rid, r.prompt.tolist(), r.max_new_tokens, r.prefix_id,
                 r.generated, r.done) for r in b]
        assert (port.retired, port.idle) == (ref.retired, ref.idle)


# ---------------------------------------------------------------------------
# The reference's properties, on the port
# ---------------------------------------------------------------------------

def test_scheduler_admit_generate_retire():
    s = BatchScheduler(max_batch=2, eos_id=99)
    r0 = s.submit(np.arange(4), max_new_tokens=2)
    r1 = s.submit(np.arange(4), max_new_tokens=8)
    r2 = s.submit(np.arange(4), max_new_tokens=8)
    assert [r.rid for r in s.admit()] == [r0, r1]
    s.record_tokens({r0: 1, r1: 1})
    s.record_tokens({r0: 2, r1: 99})
    assert s.retired == 2 and s.active == []
    assert [r.rid for r in s.admit()] == [r2]
    for _ in range(8):
        s.record_tokens({r2: 5})
    assert s.idle and s.retired == 3


def test_scheduler_zero_budget_and_missing_rid_still_drain():
    s = BatchScheduler(max_batch=1)
    s.submit(np.arange(3), max_new_tokens=0)
    s.submit(np.arange(3), max_new_tokens=-5)
    live = s.submit(np.arange(3), max_new_tokens=1)
    assert [r.rid for r in s.admit()] == [live]
    assert s.retired == 2
    s.record_tokens({live: 7})
    assert s.idle and s.retired == 3
    s = BatchScheduler(max_batch=2)
    ghost = s.submit(np.arange(3), max_new_tokens=2)
    live = s.submit(np.arange(3), max_new_tokens=2)
    s.admit()
    s.record_tokens({ghost: 1, live: 1})
    next(r for r in s.active if r.rid == ghost).done = True
    s.record_tokens({live: 1})
    assert s.idle and s.retired == 2
    s = BatchScheduler(max_batch=2)
    for _ in range(3):
        s.submit(np.array([1, 2, 3]), max_new_tokens=2)
    assert len(s.admit()) == 2 and len(s.queue) == 1
    for _ in range(2):
        s.record_tokens({r.rid: 7 for r in s.active})
    assert len(s.active) == 0 and len(s.admit()) == 1


def _drive(pc, traffic, cycles):
    for _ in range(cycles):
        for pid, length, hits in traffic:
            for _ in range(hits):
                pc.lookup(pid, length)
        pc.cycle()


def test_prefix_cache_partial_build_and_recurring_prefix():
    pc = _cache(hbm_budget_bytes=1e9, bytes_per_token=1.0,
                tokens_per_cycle=100)
    _drive(pc, [("sys", 250, 4)], cycles=2)
    assert pc.entries["sys"].covered_len == 200
    assert pc.lookup("sys", 250) == 200
    pc.cycle()
    assert pc.lookup("sys", 250) == 250
    pc = _cache(hbm_budget_bytes=1e6, bytes_per_token=100.0,
                tokens_per_cycle=512, season_len=4)
    _drive(pc, [("sys", 1000, 10)], cycles=6)
    assert pc.entries["sys"].covered_len == 1000


def test_prefix_cache_eviction_keeps_model_and_respects_budget():
    pc = _cache(hbm_budget_bytes=100.0, bytes_per_token=1.0,
                tokens_per_cycle=1000)
    _drive(pc, [("a", 80, 8), ("b", 90, 1)], cycles=3)
    assert "a" in pc.entries and "b" not in pc.entries
    assert "b" in pc.models
    pc = _cache(hbm_budget_bytes=100 * 100.0, bytes_per_token=100.0,
                tokens_per_cycle=1000)
    _drive(pc, [("big", 500, 1), ("small", 80, 5)], cycles=4)
    assert "big" not in pc.entries
    assert pc.entries["small"].covered_len == 80


def test_prefix_cache_chosen_prefix_materialised_in_canonical_order():
    pc = _cache(hbm_budget_bytes=1e9, bytes_per_token=1.0,
                tokens_per_cycle=100)
    _drive(pc, [("hot", 100, 9), ("warm", 100, 2)], cycles=1)
    assert pc.entries["hot"].covered_len == 100
    assert pc.entries["warm"].covered_len == 0  # chosen, unfunded
    pc.cycle()
    assert pc.entries["warm"].covered_len == 100
    pc = _cache(hbm_budget_bytes=1e9, bytes_per_token=1.0,
                tokens_per_cycle=60)
    _drive(pc, [("z", 60, 3), ("a", 60, 3)], cycles=1)
    assert pc.entries["a"].covered_len == 60
    assert pc.entries["z"].covered_len == 0


def test_prefix_cache_aging():
    pc = _cache(hbm_budget_bytes=1e9, bytes_per_token=1.0,
                tokens_per_cycle=1000, max_idle_cycles=4)
    pc.lookup("once", 50)
    for _ in range(30):
        pc.cycle()
    assert "once" not in pc.known_lengths and "once" not in pc.models
    assert "once" not in pc.entries and "once" not in pc.idle_cycles
    assert pc.lookup("once", 50) == 0 and "once" in pc.known_lengths
    pc = _cache(hbm_budget_bytes=1e9, bytes_per_token=1.0,
                tokens_per_cycle=1000, max_idle_cycles=2)
    _drive(pc, [("sys", 100, 3)], cycles=12)
    assert "sys" in pc.known_lengths and "sys" in pc.entries


def test_prefix_cache_device_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        assert PredictivePrefixCache(hbm_budget_bytes=1.0,
                                     bytes_per_token=1.0).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictivePrefixCache(hbm_budget_bytes=1.0, bytes_per_token=1.0)


_HASHSEED_SCRIPT = """
import sys
from {module} import PredictivePrefixCache
kw = {{"device": "cpu"}} if "torch" in "{module}" else {{}}
pc = PredictivePrefixCache(hbm_budget_bytes=300.0, bytes_per_token=1.0,
                           tokens_per_cycle=64, max_idle_cycles=3, **kw)
traffic = [("sys-a", 120, 5), ("sys-b", 120, 5), ("tool", 90, 2),
           ("rag", 200, 1), ("one-shot", 40, 0)]
pc.lookup("one-shot", 40)
for cyc in range(12):
    for pid, length, hits in traffic:
        for _ in range(hits if cyc % 3 else hits + 1):
            pc.lookup(pid, length)
    diag = pc.cycle()
state = sorted((p, e.covered_len) for p, e in pc.entries.items())
print(state, sorted(pc.known_lengths.items()), round(diag["bytes"], 6))
"""


def test_prefix_cache_cycle_deterministic_across_hash_seeds():
    """The port under three ``PYTHONHASHSEED`` values prints the same
    state as the reference."""
    outs = []
    env0 = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu")
    for module, seed in (("repro.serving", "0"), ("repro_torch.serving", "0"),
                         ("repro_torch.serving", "1"),
                         ("repro_torch.serving", "2")):
        out = subprocess.run(
            [sys.executable, "-c", _HASHSEED_SCRIPT.format(module=module)],
            capture_output=True, text=True, env=dict(env0,
                                                     PYTHONHASHSEED=seed),
            check=True, timeout=120)
        outs.append(out.stdout)
    assert outs[0] and len(set(outs)) == 1, outs

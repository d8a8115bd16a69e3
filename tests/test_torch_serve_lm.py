"""Parity of the port's LM serving path -- ``make_serve_steps`` and the
``launch.serve`` launcher -- with the reference's, on the CPU.

The launcher's scheduler stops on the token budget alone (``eos_id``
-1), so ``served``, ``covered_tokens`` and the prefix cache's entries do
not depend on the model's numbers: the port's run must equal the
reference's exactly.  The serve steps' greedy tokens are compared on
weights carried across from the reference, in float32.  The package's
LM modules import nothing of JAX or of the reference.  Last, the two
draws on which the reference's own property tests fail
(tests/test_core_components.py, ROADMAP queue 3 items 3-4) are pinned:
the port's knapsack and forecaster, which the prefix cache on this path
runs, give the reference's answers bit for bit on them.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.core import forecaster as R_hw
from repro.core import knapsack as R_knap
from repro.launch import serve as R_serve
from repro.models import init_params as r_init
from repro.train.steps import make_serve_steps as r_steps
from repro_torch.core import forecaster as P_hw
from repro_torch.core import knapsack as P_knap
from repro_torch.launch import serve as P_serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.train.steps import make_serve_steps as p_steps

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _serve(module, argv, monkeypatch):
    """Run ``module.main(argv)``; return its result and every prefix
    cache it made."""
    made = []
    cls = module.PredictivePrefixCache

    def record(*a, **k):
        made.append(cls(*a, **k))
        return made[-1]

    monkeypatch.setattr(module, "PredictivePrefixCache", record)
    return module.main(argv), made


def _entries(cache):
    return {p: dataclasses.astuple(e) for p, e in cache.entries.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "mixtral-8x22b", "hymba-1.5b",
                                  "xlstm-350m"])
def test_launcher_matches_reference(arch, monkeypatch):
    """The smoke launcher of every family (dense; MoE; the attention +
    SSM hybrid; xLSTM) against the reference's."""
    argv = ["--arch", arch, "--smoke"]
    ref, (rc,) = _serve(R_serve, argv, monkeypatch)
    got, (pc,) = _serve(P_serve, argv + ["--device", "cpu"], monkeypatch)
    assert ref[0] == 24
    if arch == "qwen3-1.7b":
        assert ref == (24, 320)
    assert got == ref
    assert _entries(pc) == _entries(rc) and len(pc.entries) == 2
    assert pc.cycles == rc.cycles
    assert pc.known_lengths == rc.known_lengths
    assert (pc.hbm_budget_bytes, pc.bytes_per_token, pc.tokens_per_cycle) == (
        rc.hbm_budget_bytes, rc.bytes_per_token, rc.tokens_per_cycle)


def test_launcher_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        got, (pc,) = _serve(P_serve, ["--smoke"], monkeypatch)
        assert got == (24, 320) and pc.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        P_serve.main(["--smoke"])


def test_serve_steps_match_reference():
    """Greedy int32 tokens of prefill and six decode steps, and the
    cache after them, on the reference's weights in float32."""
    rcfg = r_smoke("qwen2_7b").scaled(dtype="float32")
    pcfg = ModelConfig(**dataclasses.asdict(rcfg))
    params = jax.tree.map(np.asarray, r_init(rcfg, jax.random.PRNGKey(3)))
    model = params_from_reference(pcfg, params, "cpu")
    s_max = 24
    r_pre, r_dec = (jax.jit(f) for f in r_steps(rcfg, s_max))
    p_pre, p_dec = p_steps(pcfg, s_max)
    toks = np.random.default_rng(0).integers(1, 512, (2, 16)).astype(np.int32)
    rt, rcache = r_pre(params, {"tokens": jnp.asarray(toks)})
    pt, pcache = p_pre(model, {"tokens": torch.from_numpy(toks)})
    assert pt.dtype == torch.int32 and pt.shape == (2,)
    for pos in range(16, 22):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        rt, rcache = r_dec(params, rt[:, None], rcache,
                           jnp.asarray(pos, jnp.int32))
        pt, pcache = p_dec(model, pt[:, None], pcache, pos)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
    for key in rcache:
        np.testing.assert_allclose(pcache[key].numpy(),
                                   np.asarray(rcache[key]), rtol=1e-5,
                                   atol=1e-5)


def test_lm_modules_import_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.configs, repro_torch.models, "
        "repro_torch.models.convert, repro_torch.train.steps, "
        "repro_torch.launch.serve, chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# The reference's two failing property draws (ROADMAP queue 3 items 3-4)
# ---------------------------------------------------------------------------

def test_knapsack_replays_the_reference_on_its_failing_draw():
    """``test_knapsack_feasible_and_near_optimal``'s draw: both items fit
    the budget exactly, the optimum keeps both, and the discretisation
    (resolution 1024) rounds the pair past the budget -- in both
    packages, which keep the same one item."""
    utils, sizes, budget = np.array([1.0, 1.0]), np.array([1.0, 0.1]), 1.1
    keep_r = np.asarray(R_knap.solve(utils, sizes, budget, resolution=1024))
    keep_p = np.asarray(P_knap.solve(utils, sizes, budget, resolution=1024))
    np.testing.assert_array_equal(keep_p, keep_r)
    assert keep_p.sum() == 1
    (r_keep, r_best), (p_keep, p_best) = (
        k.brute_force(utils, sizes, budget) for k in (R_knap, P_knap))
    np.testing.assert_array_equal(np.asarray(p_keep), np.asarray(r_keep))
    assert p_best == r_best == 2.0


def test_forecaster_replays_the_reference_on_its_failing_draw():
    """``test_hw_matches_reference``'s draw: the float32 forecaster
    drifts 2.19e-4 (relative) from the float64 oracle, past the test's
    2e-4, and the port's forecasts equal the reference's bit for bit."""
    ys = [32471, 13636, 82266, 48265, 77958, 0, 77943, 22244, 81866,
          55884, 0, 0]
    m = 6
    rs, ps = R_hw.init_state(m), P_hw.init_state(m, device="cpu")
    rf, pf = [], []
    for y in ys:
        rs, ps = R_hw.update(rs, float(y)), P_hw.update(ps, float(y))
        rf.append(np.float32(R_hw.forecast(rs, 1)))
        pf.append(np.float32(P_hw.forecast(ps, 1).numpy()))
        for name, x in zip(rs._fields, ps):
            np.testing.assert_array_equal(x.numpy(), np.asarray(
                getattr(rs, name)))
    np.testing.assert_array_equal(np.array(pf).view(np.uint32),
                                  np.array(rf).view(np.uint32))
    _, oracle = R_hw.ref_holt_winters(np.asarray(ys, np.float64), m)
    oracle = np.asarray(oracle)
    nz = oracle != 0
    drift = np.max(np.abs(np.array(pf, np.float64)[nz] - oracle[nz])
                   / np.abs(oracle[nz]))
    assert drift == pytest.approx(2.19e-4, rel=0.01)

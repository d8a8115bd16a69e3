"""Parity of the port's training loss (``repro_torch.models.loss_fn``)
and its gradients with the reference's, at smoke sizes on the CPU, and
the reference's own training properties (tests/test_models.py) on the
port.  The train step, the optimizer and the state converter are held in
tests/test_torch_train_steps.py.

Both sides take the same numpy inputs; the reference's weights cross
with ``params_from_reference`` and the reference runs jitted.
Tolerances, float32: the loss rtol / atol 1e-5; gradients rtol / atol
1e-4 (measured: the largest gradient difference past rtol 1e-4 alone is
1.2e-6).
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import model as RM
from repro_torch.data import TokenPipeline
from repro_torch.models import model as PM
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference, tree_items
from repro_torch.train import optimizer as PO
from repro_torch.train import steps as PS

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_ARCHS = ["qwen3_1_7b", "granite_moe_1b_a400m", "hymba_1_5b",
               "xlstm_350m"]


def _cfgs(arch, **over):
    rcfg = RC.get_smoke_config(arch).scaled(**{"dtype": "float32", **over})
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _batch(rcfg, S, seed=0, mask=False):
    """numpy inputs: tokens (or embeds and, for the VLM, M-RoPE
    positions), labels and, with ``mask``, a loss mask."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(1, rcfg.vocab_size, (2, S)).astype(np.int32)}
    if rcfg.input_kind == "embeds":
        b["embeds"] = rng.standard_normal((2, S, rcfg.d_model)).astype(
            np.float32)
    else:
        b["tokens"] = rng.integers(1, rcfg.vocab_size, (2, S)).astype(
            np.int32)
    if rcfg.family == "vlm":
        b["mrope_positions"] = np.stack([np.broadcast_to(
            np.arange(S, dtype=np.int32) // k, (2, S)) for k in (1, 2, 4)])
    if mask:
        b["loss_mask"] = rng.random((2, S)) < 0.7
    return b


def _port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


_ref_init = jax.jit(RM.init_params, static_argnums=0)


def _ref_params(rcfg, seed=1):
    return _ref_init(rcfg, jax.random.PRNGKey(seed))


def _close_trees(port, ref, what, **tol):
    """Every leaf of a port tree (nested dict, LM) against the
    reference pytree's leaves in flatten order."""
    r_leaves = jax.tree.leaves(ref)
    p_items = tree_items(port)
    assert len(r_leaves) == len(p_items), what
    for (path, p), r in zip(p_items, r_leaves):
        if isinstance(p, list):
            p = torch.stack([t.detach() for t in p])
        np.testing.assert_allclose(_np(p), np.asarray(r), err_msg=f"{what} "
                                   f"{path}", **(tol or TOL))


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(rcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: RM.loss_fn(p, rcfg, b)))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` over 48 positions (three chunks of 16) with and
    without a loss mask, and its gradient for every master, against
    ``jax.value_and_grad`` of the reference's, on its weights.  The VLM
    and audio configs take their embedding inputs (the VLM with M-RoPE
    positions)."""
    rcfg, pcfg = _cfgs(arch)
    rparams = _ref_params(rcfg)
    model = params_from_reference(pcfg, jax.tree.map(np.asarray, rparams),
                                  "cpu")
    S = 48
    assert S // min(rcfg.loss_chunk, S) == 3
    for mask in (False, True):
        batch = _batch(rcfg, S, seed=int(mask), mask=mask)
        rl, rg = _ref_value_and_grad(rcfg)(rparams, batch)
        pl, pg = PS.value_and_grad(model, pcfg, _port(batch))
        assert pl.dtype == torch.float32 and pl.dim() == 0
        np.testing.assert_allclose(float(pl), float(rl), **LOSS_TOL)
        _close_trees(pg, rg, f"grad (mask={mask})")
        with torch.no_grad():
            np.testing.assert_allclose(
                float(PM.loss_fn(model, pcfg, _port(batch))), float(rl),
                **LOSS_TOL)
    # nothing is left bound to the autograd graph
    for m in model.modules():
        for t in getattr(m, "compute", {}).values():
            assert t.grad_fn is None and not t.requires_grad


def test_loss_needs_whole_chunks():
    rcfg, pcfg = _cfgs("qwen3_1_7b")
    model = PM.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="loss chunk"):
        PM.loss_fn(model, pcfg, _port(_batch(rcfg, 24)))


def test_remat_changes_no_gradient():
    """``cfg.remat`` checkpoints each layer (its cast inside); with it
    off the same gradients come out, bit for bit."""
    rcfg, pcfg = _cfgs("hymba_1_5b")
    model = PM.init_params(pcfg, torch.Generator().manual_seed(2), "cpu")
    batch = _port(_batch(rcfg, 32))
    l1, g1 = PS.value_and_grad(model, pcfg, batch)
    off = dataclasses.replace(pcfg, remat=False)
    model.cfg = off
    l2, g2 = PS.value_and_grad(model, off, batch)
    assert float(l1) == float(l2)
    for (_, a), (_, b) in zip(tree_items(g1), tree_items(g2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_smoke_train_step(arch):
    """``tests/test_models.py``'s smoke train step on the port: one bf16
    step of every smoke config (the VLM and audio on their embedding
    inputs) gives a finite loss within ``(0.5, 2) * ln V`` and a finite
    global norm."""
    pcfg = ModelConfig(**dataclasses.asdict(RC.get_smoke_config(arch)))
    state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    step = PS.make_train_step(pcfg, PO.cosine_schedule(1e-3, 2, 100))
    state, m = step(state, _port(_batch(pcfg, 32)))
    lnv = np.log(pcfg.vocab_size)
    assert 0.5 * lnv < float(m["loss"]) < 2.0 * lnv, (arch, float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"])) and int(state.opt.step) == 1


def test_training_reduces_loss():
    """``tests/test_models.py::test_training_reduces_loss`` on the port:
    60 steps of qwen3-1.7b's smoke config (bf16) on the token pipeline,
    ``cosine_schedule(3e-3, 5, 60)``: the last loss at least 0.5 below
    the first."""
    pcfg = ModelConfig(**dataclasses.asdict(RC.get_smoke_config(
        "qwen3_1_7b")))
    pipe = TokenPipeline(pcfg.vocab_size, 64, 8, seed=0)
    step = PS.make_train_step(pcfg, PO.cosine_schedule(3e-3, 5, 60))
    state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    losses = []
    for s in range(60):
        state, m = step(state, _port(pipe.batch_at(s)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]

"""Step factories: the port of ``repro.train.steps``.

``make_train_step`` builds the canonical step: loss -> grads ->
global-norm clip -> AdamW, eagerly (the reference jits it).  Gradients
are taken with ``torch.autograd.grad`` over the masters, each layer
slot's stacked on a leading axis as the reference's leaves are, and
the serving copies are cast anew after the update.

``make_serve_steps`` builds (prefill_step, decode_one) for serving,
run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models import decode_step, init_params, loss_fn, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import nest, param_leaves
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         zeros_tree)


class TrainState(NamedTuple):
    params: object                   # the LM (float32 masters)
    opt: AdamWState
    ef: Optional[object] = None      # error-feedback residuals


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     bits8: bool = False, error_feedback: bool = False,
                     device=None) -> TrainState:
    """A fresh model drawn from ``generator`` on ``device`` (the card
    unless the caller names another), zero moments, and zero residuals
    when ``error_feedback``."""
    params = init_params(cfg, generator, device)
    opt = adamw_init(params, bits8=bits8)
    ef = zeros_tree(params) if error_feedback else None
    return TrainState(params, opt, ef)


def value_and_grad(model, cfg: ModelConfig, batch):
    """(loss, grads): ``loss_fn`` and its gradient with respect to every
    master, as a nested dict in the reference's layout (a layer slot's
    gradients stacked on a leading axis)."""
    leaves = param_leaves(model)
    flat = [t for _, leaf in leaves
            for t in (leaf if isinstance(leaf, list) else [leaf])]
    with torch.enable_grad():
        loss = loss_fn(model, cfg, batch)
        gs = list(torch.autograd.grad(loss, flat, materialize_grads=True))
    grads = []
    for path, leaf in leaves:   # each layer's gradients freed once stacked
        if isinstance(leaf, list):
            g = torch.stack(gs[:len(leaf)])
            del gs[:len(leaf)]
        else:
            g = gs.pop(0)
        grads.append((path, g))
    return loss.detach(), nest(grads)


def make_train_step(cfg: ModelConfig, lr_fn: Callable,
                    max_grad_norm: float = 1.0, bits8: bool = False,
                    compress_pod_grads: bool = False, mesh=None):
    """Returns step(state, batch) -> (state, metrics), the metrics being
    float32 scalars on the device: ``loss``, ``grad_norm`` (before
    clipping) and ``lr``.  ``lr_fn`` reads the step count before the
    update, as the reference's does (a warm-up from 0 gives the first
    step a learning rate of 0).  The masters and float32 moments are
    updated in place."""
    if compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads needs a 'pod' mesh axis, which comes with "
            "parallel/sharding.py (ROADMAP queue 1 item 2(f))")

    def base_step(state: TrainState, batch):
        loss, grads = value_and_grad(state.params, cfg, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(state.opt.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr,
                                   bits8=bits8)
        params.cast_()
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt, state.ef), metrics

    return base_step


def make_serve_steps(cfg: ModelConfig, s_max: int):
    """(prefill_step, decode_one).  Both sample greedily: the argmax of
    the logits as int32 (the first maximum on ties, as ``jnp.argmax``)."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, cache = prefill(params, cfg, batch, s_max=s_max)
        return logits.argmax(dim=-1).to(torch.int32), cache

    @torch.inference_mode()
    def decode_one(params, tokens, cache, pos):
        logits, cache = decode_step(params, cfg, tokens, cache, pos)
        return logits.argmax(dim=-1).to(torch.int32), cache

    return prefill_step, decode_one

"""Step factories: the port of ``repro.train.steps``.

``make_train_step`` builds the canonical step: loss -> grads ->
global-norm clip -> AdamW, eagerly (the reference jits it).  Gradients
are taken with ``torch.autograd.grad`` over the masters, each layer
slot's stacked on a leading axis as the reference's leaves are, and
the serving copies are cast anew after the update.  With
``compress_pod_grads=True`` the pods of a mesh's 'pod' axis each take
the gradients of their slice of the batch, and the cross-pod reduction
is the int8 error-feedback all-reduce of ``parallel.compression``.

``make_serve_steps`` builds (prefill_step, decode_one) for serving,
run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models import decode_step, init_params, loss_fn, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import nest, param_leaves, tree_items
from repro_torch.parallel import compression
from repro_torch.parallel import sharding as shardlib
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         zeros_tree)


class TrainState(NamedTuple):
    params: object                   # the LM (float32 masters)
    opt: AdamWState
    ef: Optional[tuple] = None       # error-feedback residuals, per pod


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     bits8: bool = False, error_feedback: int = 0,
                     device=None) -> TrainState:
    """A fresh model drawn from ``generator`` on ``device`` (the card
    unless the caller names another), zero moments, and zero residuals
    for ``error_feedback`` pods (``True`` is one): a tuple of one tree
    per pod, the form the pod step keeps them in."""
    params = init_params(cfg, generator, device)
    opt = adamw_init(params, bits8=bits8)
    ef = tuple(zeros_tree(params) for _ in range(int(error_feedback)))
    return TrainState(params, opt, ef or None)


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


def pod_batch(batch, pod: int, n_pods: int):
    """Pod ``pod``'s contiguous slice of the batch's leading axis (axis
    1 of ``mrope_positions``, whose leading axis is its 3 sections)."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "mrope_positions" else 0
        n = v.shape[axis]
        if n % n_pods:
            raise ValueError(f"batch {k!r} of {n} rows does not split "
                             f"over {n_pods} pods")
        out[k] = v.narrow(axis, pod * (n // n_pods), n // n_pods)
    return out


def make_train_step(cfg: ModelConfig, lr_fn: Callable,
                    max_grad_norm: float = 1.0, bits8: bool = False,
                    compress_pod_grads: bool = False, mesh=None):
    """Returns step(state, batch) -> (state, metrics), the metrics being
    float32 scalars on the device: ``loss``, ``grad_norm`` (before
    clipping) and ``lr``.  ``lr_fn`` reads the step count before the
    update, as the reference's does (a warm-up from 0 gives the first
    step a learning rate of 0).  The masters and float32 moments are
    updated in place.

    With ``compress_pod_grads`` (``mesh`` must have a 'pod' axis) the
    step is the reference's ``compressed_step``, run by one controller
    over the pods: pod i takes its contiguous slice of the batch
    (``pod_batch``) and its loss and gradients with no mesh active;
    ``compression.compressed_psum`` reduces each gradient leaf over the
    pods' list with error feedback; the loss is the pods' mean; then
    clip, ``lr_fn`` and AdamW as in the plain step.  The state needs
    one residual tree per pod (``init_train_state(...,
    error_feedback=n_pods)``).  The reference declares its residuals
    replicated over the pods, but each pod's device keeps the residual
    of its own quantisation; the port keeps them so, explicitly, as
    ``state.ef[i]`` for pod i.  The tensor- and data-parallel axes inside
    a pod are not run apart: each pod's gradients are taken on the
    whole state."""

    def update(state: TrainState, loss, grads, ef):
        """Clip, ``lr_fn`` and AdamW from the (reduced) gradients."""
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(state.opt.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr,
                                   bits8=bits8)
        params.cast_()
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt, ef), metrics

    def base_step(state: TrainState, batch):
        loss, grads = value_and_grad(state.params, cfg, batch)
        return update(state, loss, grads, state.ef)

    if not compress_pod_grads:
        return base_step

    if mesh is None or "pod" not in mesh.shape:
        raise AssertionError(
            "compressed pod reduction needs a 'pod' mesh axis")
    n_pods = int(mesh.shape["pod"])

    def compressed_step(state: TrainState, batch):
        if state.ef is None or len(state.ef) != n_pods:
            raise ValueError(f"the compressed pod step needs one residual "
                             f"tree per pod: init_train_state(..., "
                             f"error_feedback={n_pods})")
        losses, pod_grads = [], []
        for i in range(n_pods):
            with shardlib.activate(None):
                loss, grads = value_and_grad(state.params, cfg,
                                             pod_batch(batch, i, n_pods))
            losses.append(loss)
            pod_grads.append(tree_items(grads))
        del grads          # each leaf now held by pod_grads alone
        ef_items = [dict(tree_items(e)) for e in state.ef]
        out_g, out_e = [], [[] for _ in range(n_pods)]
        for k, (path, g) in enumerate(pod_grads[0]):
            xs = [pg[k][1] for pg in pod_grads]
            for pg in pod_grads:   # each pod's gradient freed once reduced
                pg[k] = (path, None)
            reduced, errors = compression.compressed_psum(
                xs, [e[path] for e in ef_items])
            del xs
            out_g.append((path, reduced.to(g.dtype)))
            for i, e in enumerate(errors):
                out_e[i].append((path, e))
        loss = torch.stack(losses).sum() / n_pods   # jax.lax.pmean
        return update(state, loss, nest(out_g),
                      tuple(nest(e) for e in out_e))

    return compressed_step


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

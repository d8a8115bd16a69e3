"""AdamW with optional blockwise-8-bit moment states: the port of
``repro.train.optimizer``.

The 8-bit mode quantises both Adam moments per 256-element block with
a float32 absmax scale (bitsandbytes-style), over each leaf flattened
whole: a layer leaf is the reference's, stacked over the layers, so a
block whose layer share is not a multiple of 256 spans two layers and
its absmax covers both, as in the reference.

Trees are the reference's pytrees: nested dicts of tensors, or an
``LM``, whose leaves are its masters with each layer slot as the list
of its layers' tensors (``models.convert.param_leaves``).  Gradients
and moments are nested dicts keyed like the parameters, a layer leaf
stacked.  Unlike the reference, ``adamw_update`` writes the new
parameters into the given tensors (and float32 moments into the
state's), and ``clip_by_global_norm`` scales the gradients in place:
at full size a second copy of either would not be free.

The 8-bit mode replays a defect of the reference (ROADMAP queue 3
item 6): linear absmax blocks round small second moments to a payload
of 0, the update is then ``m / (0 + eps)``, and training diverges.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.convert import nest, tree_items

QBLOCK = 256


class Quant8(NamedTuple):
    q: torch.Tensor        # int8 payload, original shape
    scale: torch.Tensor    # float32 absmax per block, shape (nblocks,)


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """A flat tensor zero-padded to whole blocks, as (nblocks, QBLOCK)."""
    return F.pad(flat, (0, (-flat.numel()) % QBLOCK)).view(-1, QBLOCK)


def _quantize8(x: torch.Tensor) -> Quant8:
    flat = x.reshape(-1)
    blocks = _blocks(flat)
    # 127 as a tensor on the device: CUDA divides by a host scalar as a
    # product with its reciprocal, one ulp off the reference's quotient
    amax = blocks.abs().amax(dim=1)
    scale = (amax / amax.new_full((), 127.0)).clamp_min(1e-12)
    q = torch.round(blocks / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return Quant8(q.view(-1)[:flat.numel()].view(x.shape), scale.float())


def _dequantize8(qt: Quant8) -> torch.Tensor:
    flat = qt.q.reshape(-1).float()
    x = _blocks(flat) * qt.scale[:, None]
    return x.view(-1)[:flat.numel()].view(qt.q.shape)


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    mu: object             # nested dict of float32 tensors or Quant8
    nu: object


def zeros_tree(params):
    """float32 zeros shaped like each leaf of ``params`` (a layer leaf
    stacked), on its device, as a nested dict."""
    def z(leaf):
        layers = leaf if isinstance(leaf, list) else [leaf]
        lead = (len(layers),) if isinstance(leaf, list) else ()
        return torch.zeros(lead + tuple(layers[0].shape),
                           dtype=torch.float32, device=layers[0].device)

    return nest((path, z(leaf)) for path, leaf in tree_items(params))


def adamw_init(params, bits8: bool = False) -> AdamWState:
    """Zero moments for every leaf of ``params`` and a step count of 0,
    on the parameters' device."""
    def moments():
        zs = zeros_tree(params)
        if not bits8:
            return zs
        return nest((path, _quantize8(z)) for path, z in tree_items(zs))

    mu, nu = moments(), moments()
    first = tree_items(mu)[0][1]
    device = (first.q if bits8 else first).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      mu, nu)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, bits8: bool = False):
    """One AdamW step with the reference's float32 arithmetic, in its
    order: the bias corrections ``1 - b ** step`` in float32, the
    moments, ``(m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p``,
    and ``p - lr * update``.  ``lr`` is a float or a float32 scalar
    tensor.  Returns (params, the new state); the float32 masters are
    written in place."""
    step = state.step + 1
    t = step.float()
    one = torch.ones((), dtype=torch.float32, device=t.device)
    bc1 = 1.0 - (one * b1) ** t
    bc2 = 1.0 - (one * b2) ** t
    g_items, p_items = tree_items(grads), tree_items(params)
    mu, nu = dict(tree_items(state.mu)), dict(tree_items(state.nu))
    if [p for p, _ in g_items] != [p for p, _ in p_items]:
        raise ValueError("gradient and parameter trees differ")
    new_m, new_v = [], []
    for (path, g), (_, p) in zip(g_items, p_items):
        layers = p if isinstance(p, list) else [p]
        if any(x.dtype != torch.float32 for x in layers):
            raise ValueError(f"{path}: masters must be float32")
        g = g.float()
        m, v = mu[path], nu[path]
        if bits8:
            m_f = _dequantize8(m).mul_(b1).add_(g * (1 - b1))
            v_f = _dequantize8(v).mul_(b2).add_(g * (1 - b2) * g)
        else:
            m_f = m.mul_(b1).add_(g * (1 - b1))
            v_f = v.mul_(b2).add_(g * (1 - b2) * g)
        update = (m_f / bc1) / (torch.sqrt(v_f / bc2) + eps)
        ups = list(update.unbind(0)) if isinstance(p, list) else [update]
        decay = torch._foreach_mul(layers, weight_decay)
        torch._foreach_add_(decay, ups)           # update + wd * p
        torch._foreach_mul_(decay, lr)
        torch._foreach_sub_(layers, decay)        # p - lr * update
        new_m.append((path, _quantize8(m_f) if bits8 else m_f))
        new_v.append((path, _quantize8(v_f) if bits8 else v_f))
    return params, AdamWState(step, nest(new_m), nest(new_v))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale the gradients (in place) to a global norm of at most
    ``max_norm``; returns (grads, the float32 norm before clipping)."""
    leaves = [g for _, g in tree_items(grads)]
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) for an int32 step tensor: linear warm-up from 0 over
    ``warmup`` steps, then a cosine decay to 0 at ``total``; float32."""
    def lr(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr

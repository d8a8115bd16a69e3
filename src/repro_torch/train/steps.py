"""Step factories: the port of ``repro.train.steps.make_serve_steps``.

The reference jits both steps; PyTorch runs them eagerly, under
``torch.inference_mode()``.  The train step waits for the training
slice (ROADMAP queue 1 item 2(d)).
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


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

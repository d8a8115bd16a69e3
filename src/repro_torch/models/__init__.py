"""Model zoo of the port: decoder-only LM backbones over the ten
configs (``repro_torch.configs``): dense GQA, routed-expert MoE, the
attention + SSM hybrid, xLSTM, and the VLM and audio backbones, each
with init, forward, the chunked training loss, prefill and decode.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, decode_step, forward, init_cache,
                                      init_params, loss_fn, prefill)

__all__ = ["LM", "ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill"]

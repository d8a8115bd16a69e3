"""Unified model configuration covering all assigned architectures.

Port of ``repro.models.config``: the same dataclass, fields, defaults
and parameter counts, copied (the reference's ``repro.models``
package imports JAX).  ``remat`` checkpoints each layer of the training
forward (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` does; ``unroll_layers`` is a compile knob of XLA
(scan against a Python loop over the layers) that the port keeps as a
field, so configs stay field-for-field equal: eager PyTorch always
loops over its layers.  ``loss_chunk`` sets the training loss's chunk
of positions; ``pad_attn_heads`` pads the attention heads to a multiple
of the active mesh's tensor-parallel axis (``parallel.sharding``), and
nothing with no mesh active.

One dataclass; families select the block type:

* ``dense``   -- pre-norm GQA transformer (llama-style), optional
                 qk-norm / QKV bias / sliding window
* ``moe``     -- dense attention + top-k routed expert FFN
* ``hybrid``  -- hymba-style: parallel attention + Mamba heads per block
* ``ssm``     -- xLSTM: alternating mLSTM / sLSTM blocks (no separate FFN)
* ``vlm``     -- dense + M-RoPE (3-section rotary) + embedding inputs
                 (vision frontend is a stub per the assignment)
* ``audio``   -- dense backbone over precomputed EnCodec frame
                 embeddings (codec frontend is a stub)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # defaults to d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # sliding-window attention (0 = full)
    sliding_window: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 1              # hymba keeps d_inner == d_model
    # vlm
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # inputs: 'tokens' (embedding lookup) or 'embeds' (stub frontend)
    input_kind: str = "tokens"
    tie_embeddings: bool = True
    # numerics / compile
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True               # checkpoint each scanned layer
    loss_chunk: int = 512            # chunked cross-entropy (tokens/chunk)
    cache_repeated_kv: bool = False  # serve opt: store the KV cache with
                                     # GQA-repeated (+padded) heads so it
                                     # head-shards over the model axis and
                                     # decode touches only local shards
    pad_attn_heads: bool = False     # pad H to a multiple of the model
                                     # axis so attention head-shards even
                                     # when H % tp != 0 (e.g. 56 over 16)
    unroll_layers: bool = False      # python-loop layers instead of scan
                                     # (used by dry-run FLOP measurement:
                                     # cost_analysis counts loop bodies once)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ModelConfig":
        assert self.n_heads % self.n_kv_heads == 0
        assert self.family in ("dense", "moe", "hybrid", "ssm", "vlm",
                               "audio")
        if self.family == "moe":
            assert self.n_experts > 0 and self.experts_per_token > 0
        if self.family in ("hybrid",):
            assert self.ssm_state > 0
        if self.family == "ssm":
            assert self.n_layers % 2 == 0, "xLSTM alternates mLSTM/sLSTM"
        return self

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (for 6*N*D model FLOPs in the roofline;
    MoE counts are split into total vs active elsewhere)."""
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.vocab_size * d
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
        + (cfg.n_heads * hd) * d
    if cfg.family == "moe":
        ffn = cfg.n_experts * (3 * d * cfg.d_ff) + d * cfg.n_experts
    elif cfg.family == "ssm":
        # mLSTM/sLSTM blocks: projections counted in model.py init; use
        # an estimate of 8*d*d per block pair
        ffn = 4 * d * d
        attn = 4 * d * d
    else:
        ffn = 3 * d * cfg.d_ff
    if cfg.family == "hybrid":
        d_in = d * cfg.ssm_expand
        attn += 2 * d * d_in + d_in * (2 * cfg.ssm_state) + d_in * cfg.ssm_conv
    per_layer = attn + ffn + 2 * d
    total = emb + cfg.n_layers * per_layer + d
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (= total for non-MoE)."""
    if cfg.family != "moe":
        return param_count(cfg)
    d = cfg.d_model
    dense_ffn_active = cfg.experts_per_token * (3 * d * cfg.d_ff)
    ffn_total = cfg.n_experts * (3 * d * cfg.d_ff)
    return int(param_count(cfg) - cfg.n_layers * (ffn_total - dense_ffn_active))

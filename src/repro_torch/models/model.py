"""Model assembly for the attention families (``dense``, ``vlm``,
``audio``): the port of ``repro.models.model``'s init / forward /
prefill / decode.

The model is an ``nn.Module`` (``LM``: the embedding, an
``nn.ModuleList`` of ``Block``s and the final norm) holding float32
master weights; the module-level functions keep the reference's names
and signatures (``init_params``, ``forward``, ``prefill``,
``init_cache``, ``decode_step``), with the ``LM`` in the place of the
reference's parameter pytree.  The layer loop is a Python loop over the
blocks where the reference runs ``lax.scan``.

The reference casts each layer's masters to the compute dtype on every
call (``_cast_layer``).  A cast is deterministic, so the port casts
once when the weights are made (``LM.cast_``) and keeps the masters
beside the copies: the same numbers, and a decode step on the card
reads the bf16 copies instead of re-reading the float32 masters.

Prefill computes each layer's q / k / v once, writes K / V into the
cache and attends with them; the reference computes them twice (once
for the cache, once inside ``_attention_chunked``), with the same
result.  The caches keep the reference's layout, a leading layer axis:
``{"k", "v"}`` of (n_layers, B, S_cache, KV, hd) and, for the SWA ring,
``"pos_ids"`` (n_layers, S_cache); ``decode_step`` writes its entry
into them in place.

The ``moe``, ``hybrid`` and ``ssm`` families are the next LM slice
(ROADMAP queue 1 item 2(c)): every entry point here raises
``NotImplementedError`` for them before it makes a tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.table import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

ATTN_CHUNK = 1024         # query-chunk length for blockwise attention
PORTED_FAMILIES = ("dense", "vlm", "audio")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(MoE, hybrid and SSM blocks: ROADMAP queue 1 item 2(c)); "
            f"ported families: {', '.join(PORTED_FAMILIES)}")


def _check_cfg(model: "LM", cfg: ModelConfig) -> None:
    if cfg != model.cfg:
        raise ValueError("cfg differs from the config the model was made "
                         "with (its weights are cast to that dtype)")


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm transformer block: attention, then SwiGLU."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.norm2 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.mlp = (L.SwiGLU(d, cfg.d_ff, dtype, device) if cfg.d_ff > 0
                    else None)


class LM(L.Weights):
    """Decoder-only LM of an attention family.  Its parameters are
    uninitialised until ``init_params`` draws them or
    ``convert.params_from_reference`` copies them in; both end with
    ``cast_``.  ``.to(device)`` moves the masters and casts anew."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        cfg.validate()
        _check_family(cfg)
        self.cfg = cfg
        pdt = getattr(torch, cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = L.master((V, d), pdt, device)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings
            else L.master((d, V), pdt, device))
        self.final_norm = L.RMSNorm(d, cfg.norm_eps, pdt, device)
        self.blocks = nn.ModuleList(Block(cfg, pdt, device)
                                    for _ in range(cfg.n_layers))

    def cast_(self) -> "LM":
        """(Re)make every module's copies in the config's compute dtype."""
        dtype = _dtype(self.cfg)
        super().cast_(dtype)  # the embedding (and an untied head)
        for m in self.modules():
            if m is not self and isinstance(m, L.Weights):
                m.cast_(dtype)
        return self

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        return self.cast_()

    def head(self) -> torch.Tensor:
        """(d, V) output projection in the compute dtype."""
        if self.cfg.tie_embeddings:
            return self.compute["embed"].T
        return self.compute["lm_head"]


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """A randomly initialised model on ``device`` (the card unless the
    caller names another), drawn from ``generator`` (on that device).

    The distributions are the reference's: normal x 1/sqrt(fan_in) for
    every matrix, 0.02 for the embedding, 1/sqrt(fan_in x n_layers) for
    ``wo`` and ``w_down``, zeros for the QKV biases, ones for the norms;
    drawn weight by weight over the layers, in the reference's order.
    ``jax.random`` and ``torch.Generator`` give different numbers, so no
    draw equals the reference's bit for bit; tests carry the
    reference's weights across with ``convert.params_from_reference``.
    """
    cfg.validate()
    _check_family(cfg)
    device = resolve_device(device)
    model = LM(cfg, device)
    Lc = cfg.n_layers

    def normal(params, scale=None):
        for p in params:
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            p.normal_(generator=generator).mul_(
                scale or 1.0 / math.sqrt(fan_in))

    normal([model.embed], 0.02)
    if model.lm_head is not None:
        normal([model.lm_head])
    blocks = list(model.blocks)
    attn = [b.attn for b in blocks]
    H_hd = cfg.n_heads * cfg.hd
    for name in ("wq", "wk", "wv"):
        normal([getattr(a, name) for a in attn])
    normal([a.wo for a in attn], 1.0 / math.sqrt(H_hd * Lc))
    if cfg.d_ff > 0:
        mlp = [b.mlp for b in blocks]
        normal([m.w_gate for m in mlp])
        normal([m.w_up for m in mlp])
        normal([m.w_down for m in mlp], 1.0 / math.sqrt(cfg.d_ff * Lc))
    for a in attn:
        for name in ("bq", "bk", "bv"):
            if getattr(a, name) is not None:
                getattr(a, name).zero_()
        for name in ("q_norm", "k_norm"):
            if getattr(a, name) is not None:
                getattr(a, name).fill_(1.0)
    for n in [model.final_norm] + [b.norm1 for b in blocks] + [
            b.norm2 for b in blocks]:
        n.weight.fill_(1.0)
    return model.cast_()


# ---------------------------------------------------------------------------
# Blockwise attention (bounds the S^2 buffer)
# ---------------------------------------------------------------------------

def _attend_chunked(q, k, v, cfg: ModelConfig, mask_mode: str,
                    chunk: int = ATTN_CHUNK):
    """Attention over GQA-repeated heads in query chunks of ``chunk``:
    chunk [off, off + chunk) attends to keys [lo, off + chunk), with
    ``lo`` the window's chunk-aligned start (0 without one), so no
    strictly-future key is computed.  Returns (B, S, H, hd)."""
    S = q.shape[1]
    if S <= chunk:
        return L._attend(q, k, v, cfg, mask_mode)
    if S % chunk:
        raise ValueError(f"sequence {S} must divide the attention chunk "
                         f"{chunk}")
    outs = []
    for off in range(0, S, chunk):
        hi = off + chunk
        lo = 0
        if mask_mode == "causal_window" and cfg.sliding_window > 0:
            lo = max(0, ((off - cfg.sliding_window) // chunk) * chunk)
        outs.append(L._attend(q[:, off:hi], k[:, lo:hi], v[:, lo:hi], cfg,
                              mask_mode, off, lo))
    return torch.cat(outs, dim=1)


def _attention_chunked(x, p: L.AttnParams, cfg: ModelConfig, positions,
                       mask_mode, mrope_positions=None,
                       chunk: int = ATTN_CHUNK):
    """The reference's blockwise attention of x: (B, S, d) -> (B, S, d)."""
    q, k, v = L._qkv(x, p, cfg, positions, mrope_positions)
    return _attn_out(q, k, v, p, cfg, mask_mode, chunk)


def _attn_out(q, k, v, p: L.AttnParams, cfg: ModelConfig, mask_mode,
              chunk: int = ATTN_CHUNK):
    """Blockwise attention of given q / k / v, through ``wo``."""
    B, S = q.shape[:2]
    k, v = L._repeat_kv(k, v, cfg)
    q, k, v, H_real = L._maybe_pad_heads(q, k, v, cfg)
    out = _attend_chunked(q, k, v, cfg, mask_mode, chunk)[:, :, :H_real]
    return out.reshape(B, S, H_real * cfg.hd) @ p.wo


# ---------------------------------------------------------------------------
# Blocks, forward
# ---------------------------------------------------------------------------

def _mask_mode(cfg: ModelConfig) -> str:
    return "causal_window" if cfg.sliding_window > 0 else "causal"


def _block(x, blk: Block, cfg: ModelConfig, positions, mrope_positions=None,
           cache_k=None, cache_v=None):
    """One block over the whole sequence; with ``cache_k`` / ``cache_v``
    ((B, S_max, KV, hd) views of the layer's cache) its K / V are
    written into their first S slots."""
    h = blk.norm1(x)
    p = blk.attn.p
    q, k, v = L._qkv(h, p, cfg, positions, mrope_positions)
    if cache_k is not None:
        S = k.shape[1]
        cache_k[:, :S] = k
        cache_v[:, :S] = v
    x = x + _attn_out(q, k, v, p, cfg, _mask_mode(cfg))
    if blk.mlp is not None:
        x = x + blk.mlp(blk.norm2(x))
    return x


def _inputs_to_h(model: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.input_kind == "embeds":
        return batch["embeds"].to(_dtype(cfg))
    return model.compute["embed"][batch["tokens"].long()]


def _positions(batch, B: int, S: int, device):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device).expand(B, S)
    return positions


def forward(params: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence forward; returns final hidden states (B, S, d)."""
    _check_family(cfg)
    _check_cfg(params, cfg)
    h = _inputs_to_h(params, cfg, batch)
    B, S, _ = h.shape
    positions = _positions(batch, B, S, h.device)
    mrope = batch.get("mrope_positions") if cfg.family == "vlm" else None
    for blk in params.blocks:
        h = _block(h, blk, cfg, positions, mrope)
    return params.final_norm(h)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with the KV cache
# ---------------------------------------------------------------------------

def cache_heads(cfg: ModelConfig) -> int:
    """KV-head count stored in the cache.  With cache_repeated_kv the
    cache holds the GQA-repeated query heads (no padding: one card has
    no tensor-parallel axis)."""
    return cfg.n_heads if cfg.cache_repeated_kv else cfg.n_kv_heads


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               ring: Optional[bool] = None, device=None) -> Dict:
    """An empty cache on ``device`` (the card unless the caller names
    another): linear over ``s_max`` positions, or, for a sliding window
    shorter than ``s_max`` (or ``ring=True``), a ring of ``window``
    entries with their absolute positions (-1 = empty)."""
    _check_family(cfg)
    device = resolve_device(device)
    s_cache = s_max
    if ring is None:
        ring = cfg.sliding_window > 0 and s_max > cfg.sliding_window
    if ring:
        s_cache = cfg.sliding_window
    shape = (cfg.n_layers, batch, s_cache, cache_heads(cfg), cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}
    if ring:
        cache["pos_ids"] = torch.full((cfg.n_layers, s_cache), -1,
                                      dtype=torch.int32, device=device)
    return cache


def _logits(params: LM, h) -> torch.Tensor:
    """Next-token logits (B, V) in float32 from the last position."""
    h = params.final_norm(h)
    return (h[:, -1] @ params.head()).float()


def prefill(params: LM, cfg: ModelConfig, batch,
            s_max: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; return (next-token logits (B, V), cache) with
    K / V zero-padded to ``s_max`` positions."""
    _check_family(cfg)
    _check_cfg(params, cfg)
    h = _inputs_to_h(params, cfg, batch)
    B, S, _ = h.shape
    s_max = s_max or S
    positions = _positions(batch, B, S, h.device)
    mrope = batch.get("mrope_positions") if cfg.family == "vlm" else None
    shape = (cfg.n_layers, B, s_max, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=h.dtype, device=h.device),
             "v": torch.zeros(shape, dtype=h.dtype, device=h.device)}
    for i, blk in enumerate(params.blocks):
        h = _block(h, blk, cfg, positions, mrope, cache["k"][i],
                   cache["v"][i])
    return _logits(params, h), cache


def decode_step(params: LM, cfg: ModelConfig, tokens, cache: Dict,
                pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int (or embeds (B, 1, d)); pos:
    position of the new token.  Writes the new K / V into ``cache`` in
    place; returns (logits (B, V), cache)."""
    _check_family(cfg)
    _check_cfg(params, cfg)
    pos = int(pos)
    dt = _dtype(cfg)
    if cfg.input_kind == "embeds":
        h = tokens.to(dt)             # caller passes an embedding
    else:
        h = params.compute["embed"][tokens.long()]
    B = h.shape[0]
    mrope = None
    if cfg.family == "vlm":
        mrope = torch.full((3, B, 1), pos, dtype=torch.int32, device=h.device)
    pos_ids = cache.get("pos_ids")
    for i, blk in enumerate(params.blocks):
        attn_out, _, _, _ = L.attention_decode(
            blk.norm1(h), blk.attn.p, cfg, cache["k"][i], cache["v"][i], pos,
            mrope, cache_pos=None if pos_ids is None else pos_ids[i])
        h = h + attn_out
        if blk.mlp is not None:
            h = h + blk.mlp(blk.norm2(h))
    return _logits(params, h), cache

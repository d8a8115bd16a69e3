"""Attention-family building blocks of the LM: the port of the
attention half of ``repro.models.layers``.

Plain tensor functions under the reference's names and argument order
(``rms_norm``, ``rope_freqs``, ``apply_rope``, ``apply_mrope``,
``_qkv``, ``_maybe_pad_heads``, ``attention``, ``attention_decode``,
``swiglu``), and the modules that hold their weights (``RMSNorm``,
``Attention``, ``SwiGLU``).  Layouts are the reference's: activations
(B, S, d), heads (B, S, H, hd), weights (d_in, d_out), so a weight
carries across with no transpose.

The reference's dtype order is kept: ``rms_norm`` reduces in float32,
casts to the compute dtype, then multiplies by the weight; RoPE angles
are float32; softmax runs in float32 and is cast back before the value
product; masked logits take the minimum of the logits' own dtype.

One card has no tensor-parallel axis (the reference's
``axis_size("tp")`` is 1 there), so ``_maybe_pad_heads`` pads nothing
and the reference's sharding constraints are the identity; they are
not carried over.  The MoE, SSM and xLSTM blocks are the next LM slice
(ROADMAP queue 1 item 2(c)).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Weights: float32 masters and their compute-dtype copies
# ---------------------------------------------------------------------------

def master(shape, dtype, device) -> nn.Parameter:
    """An uninitialised master weight (inference only: no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Weights(nn.Module):
    """A module whose own parameters are the master weights (the
    config's ``param_dtype``) and whose ``compute`` dict holds them cast
    once to the compute dtype by ``cast_``.  The reference casts every
    layer's masters on every call (``model._cast_layer``); a cast is
    deterministic, so casting once gives the same numbers.  A copy is
    made only where the dtypes differ."""

    def cast_(self, dtype: torch.dtype) -> None:
        self.compute = {n: p.detach().to(dtype)
                        for n, p in self.named_parameters(recurse=False)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight


class RMSNorm(Weights):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = master((dim,), dtype, device)

    def forward(self, x):
        return rms_norm(x, self.compute["weight"], self.eps)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x, ang):
    """x rotated by float32 angles ``ang`` (..., seq, hd/2), cast back."""
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """Multimodal RoPE (Qwen2-VL): the rotary dimension is split into
    three sections rotated by temporal / height / width position
    streams.  positions3: (3, batch, seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    # section id per frequency; a short section list pads with 2
    sec = ([0] * sections[0] + [1] * sections[1] + [2] * sections[2]
           + [2] * half)[:half]
    sec = torch.tensor(sec, dtype=torch.long, device=x.device)
    pos_sel = positions3[sec].movedim(0, -1)            # (B, S, half)
    return _rotate(x, pos_sel.float() * freqs)


# ---------------------------------------------------------------------------
# Attention (GQA, qk-norm, bias, sliding window, KV cache)
# ---------------------------------------------------------------------------

class AttnParams(NamedTuple):
    wq: torch.Tensor            # (d, n_heads*hd)
    wk: torch.Tensor            # (d, n_kv*hd)
    wv: torch.Tensor            # (d, n_kv*hd)
    wo: torch.Tensor            # (n_heads*hd, d)
    bq: Optional[torch.Tensor]  # (n_heads*hd,) or None
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]
    q_norm: Optional[torch.Tensor]  # (hd,) qk-norm scales or None
    k_norm: Optional[torch.Tensor]


def _qkv(x, p: AttnParams, cfg, positions, mrope_positions=None):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _maybe_pad_heads(q, k, v, cfg):
    """The reference pads the GQA-repeated heads to a multiple of the
    tensor-parallel axis; on one card that axis is 1, so nothing is
    padded and the real head count is returned."""
    return q, k, v, q.shape[2]


def _repeat_kv(k, v, cfg):
    """Grouped-query attention: each KV head serves ``q_rep`` query
    heads (``jnp.repeat`` on the head axis)."""
    return (k.repeat_interleave(cfg.q_rep, dim=2),
            v.repeat_interleave(cfg.q_rep, dim=2))


def _attend(q, k, v, cfg, mask_mode: str, q_off: int = 0, k_off: int = 0):
    """softmax(q k^T / sqrt(hd)) v over GQA-repeated heads, for query
    rows ``q_off + i`` against key columns ``k_off + j`` under the
    causal (and, for 'causal_window', sliding-window) mask.
    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd); returns (B, Sq, H, hd)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(cfg.hd))
    rows = q_off + torch.arange(q.shape[1], device=q.device)[:, None]
    cols = k_off + torch.arange(k.shape[1], device=q.device)[None, :]
    mask = cols <= rows
    if mask_mode == "causal_window" and cfg.sliding_window > 0:
        mask &= (rows - cols) < cfg.sliding_window
    logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(x, p: AttnParams, cfg, positions, mask_mode: str = "causal",
              mrope_positions=None):
    """Full-sequence attention (training / prefill).

    mask_mode: 'causal' or 'causal_window' (sliding window).
    """
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions, mrope_positions)
    k, v = _repeat_kv(k, v, cfg)
    q, k, v, H_real = _maybe_pad_heads(q, k, v, cfg)
    out = _attend(q, k, v, cfg, mask_mode)[:, :, :H_real]
    return out.reshape(B, S, H_real * cfg.hd) @ p.wo


def attention_decode(x, p: AttnParams, cfg, cache_k, cache_v, pos: int,
                     mrope_positions=None, cache_pos=None):
    """One-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_cache, KV, hd); pos: absolute
    position of the new token (a Python int).

    Two cache modes:
    * linear (cache_pos is None): S_cache covers the whole sequence;
      the new entry lands at index ``pos``.
    * ring (cache_pos: (S_cache,) int32 of absolute positions, -1 =
      empty): used for sliding-window configs with contexts longer
      than the window -- the entry lands at ``pos % S_cache`` and
      validity / windowing is checked against the stored positions.

    The reference returns new caches; the port writes the new entry
    into ``cache_k`` / ``cache_v`` / ``cache_pos`` in place (a slot
    past a linear cache raises) and returns them.
    Returns (out (B,1,d), cache_k, cache_v, cache_pos).
    """
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S_cache, H_cache = cache_k.shape[1], cache_k.shape[2]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions, mrope_positions)
    repeated = H_cache != KV
    if repeated:
        # the cache stores GQA-repeated heads (cache_repeated_kv)
        k, v = _repeat_kv(k, v, cfg)
        q, k, v, _ = _maybe_pad_heads(q, k, v, cfg)
    slot = pos % S_cache if cache_pos is not None else pos
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    if cache_pos is not None:
        cache_pos[slot] = pos
        abs_pos = cache_pos
    else:
        abs_pos = torch.arange(S_cache, dtype=torch.int32, device=x.device)
    kk, vv = (cache_k, cache_v) if repeated else _repeat_kv(cache_k,
                                                             cache_v, cfg)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) * (1.0 / math.sqrt(hd))
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if cfg.sliding_window > 0:
        valid &= (pos - abs_pos) < cfg.sliding_window
    logits = logits.masked_fill(~valid, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(x.dtype), vv)
    out = out[:, :, :H].reshape(B, 1, H * hd)
    return out @ p.wo, cache_k, cache_v, cache_pos


class Attention(Weights):
    """The attention weights of one block; ``p`` is the
    ``AttnParams`` of the compute-dtype copies, which ``attention`` /
    ``attention_decode`` and the model's prefill take."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = master((d, H * hd), dtype, device)
        self.wk = master((d, KV * hd), dtype, device)
        self.wv = master((d, KV * hd), dtype, device)
        self.wo = master((H * hd, d), dtype, device)
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            self.register_parameter(
                name, master((n,), dtype, device) if cfg.qkv_bias else None)
        for name in ("q_norm", "k_norm"):
            self.register_parameter(
                name, master((hd,), dtype, device) if cfg.qk_norm else None)

    def cast_(self, dtype):
        super().cast_(dtype)
        self.p = AttnParams(*(self.compute.get(f) for f in AttnParams._fields))


# ---------------------------------------------------------------------------
# FFN: SwiGLU
# ---------------------------------------------------------------------------

class MlpParams(NamedTuple):
    w_gate: torch.Tensor   # (d, ff)
    w_up: torch.Tensor     # (d, ff)
    w_down: torch.Tensor   # (ff, d)


def swiglu(x, p: MlpParams):
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class SwiGLU(Weights):
    def __init__(self, d: int, ff: int, dtype, device):
        super().__init__()
        self.w_gate = master((d, ff), dtype, device)
        self.w_up = master((d, ff), dtype, device)
        self.w_down = master((ff, d), dtype, device)

    def cast_(self, dtype):
        super().cast_(dtype)
        self.p = MlpParams(**self.compute)

    def forward(self, x):
        return swiglu(x, self.p)

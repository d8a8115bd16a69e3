"""Model assembly for every family (``dense``, ``moe``, ``hybrid``,
``ssm``, ``vlm``, ``audio``): the port of ``repro.models.model``'s init
/ forward / prefill / decode.

The model is an ``nn.Module`` (``LM``: the embedding, an
``nn.ModuleList`` of blocks and the final norm) holding float32 master
weights; the module-level functions keep the reference's names and
signatures (``init_params``, ``forward``, ``prefill``, ``init_cache``,
``decode_step``), with the ``LM`` in the place of the reference's
parameter pytree.  The blocks are ``Block``s (attention, then SwiGLU
or the routed experts; the hybrid adds a parallel SSM and the mix of
the two) or, for xLSTM, ``XlstmPair``s (an mLSTM block, then an sLSTM
block) over ``n_layers // 2`` pairs.  The layer loop is a Python loop
over the blocks where the reference runs ``lax.scan``.

The reference casts each layer's masters to the compute dtype on every
call (``_cast_layer``).  A cast is deterministic, so for serving the
port casts once when the weights are made (``LM.cast_``) and keeps the
masters beside the copies: the same numbers, and a decode step on the
card reads the bf16 copies instead of re-reading the float32 masters.
In grad mode (``loss_fn``, the train step) ``forward`` casts each
layer's copies inside autograd, within the body that ``cfg.remat``
recomputes in the backward pass (``torch.utils.checkpoint``), as the
reference casts inside its remat body, and gathers the embedding from
the float32 master before the cast; the train step casts the serving
copies anew after each update.

Prefill computes each layer's q / k / v once, writes K / V into the
cache and attends with them; the reference computes them twice (once
for the cache, once inside ``_attention_chunked``), with the same
result.  Likewise the hybrid's SSM state and the mLSTM's (C, n, m)
state come from the same pass as the block's output, where the
reference runs a second pass (``_ssm_with_state``,
``_mlstm_final_state``).  The caches keep the reference's layout, a
leading layer (or pair) axis: ``{"k", "v"}`` of (n_layers, B, S_cache,
KV, hd) and, for the SWA ring, ``"pos_ids"`` (n_layers, S_cache); the
hybrid adds ``"ssm_h"`` / ``"ssm_conv"``; xLSTM holds the seven
recurrent tensors ``mlstm_C`` / ``_n`` / ``_m`` and ``slstm_h`` / ``_c``
/ ``_n`` / ``_m``.  ``decode_step`` writes its entry and the new
states into them in place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.table import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import axis_size

ATTN_CHUNK = 1024         # query-chunk length for blockwise attention


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_cfg(model: "LM", cfg: ModelConfig) -> None:
    if cfg != model.cfg:
        raise ValueError("cfg differs from the config the model was made "
                         "with (its weights are cast to that dtype)")


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

class Block(L.Weights):
    """One pre-norm block: attention (in parallel with an SSM, mixed by
    the softmax of ``mix``, for the hybrid), then SwiGLU or the routed
    experts.  Its own parameter is the hybrid's ``mix`` (2,) logits."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.norm2 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.moe = L.MoE(cfg, dtype, device) if cfg.family == "moe" else None
        self.mlp = (L.SwiGLU(d, cfg.d_ff, dtype, device)
                    if cfg.family != "moe" and cfg.d_ff > 0 else None)
        hybrid = cfg.family == "hybrid"
        self.ssm = L.SSM(cfg, dtype, device) if hybrid else None
        self.register_parameter(
            "mix", L.master((2,), dtype, device) if hybrid else None)

    def ffn(self, x):
        """The block's second half on its normed input (or nothing)."""
        if self.moe is not None:
            return self.moe(x)
        if self.mlp is not None:
            return self.mlp(x)
        return None


class XlstmPair(nn.Module):
    """One xLSTM pair: a pre-norm mLSTM block, then a pre-norm sLSTM
    block (which carries its own up-projection: no separate FFN)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.mlstm = L.MLSTM(cfg, dtype, device)
        self.norm2 = L.RMSNorm(d, cfg.norm_eps, dtype, device)
        self.slstm = L.SLSTM(cfg, dtype, device)


class LM(L.Weights):
    """Decoder-only LM.  Its parameters are uninitialised until
    ``init_params`` draws them or ``convert.params_from_reference``
    copies them in; both end with ``cast_``.  ``.to(device)`` moves the
    masters and casts anew."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        pdt = getattr(torch, cfg.param_dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = L.master((V, d), pdt, device)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings
            else L.master((d, V), pdt, device))
        self.final_norm = L.RMSNorm(d, cfg.norm_eps, pdt, device)
        if cfg.family == "ssm":
            blocks = (XlstmPair(cfg, pdt, device)
                      for _ in range(cfg.n_layers // 2))
        else:
            blocks = (Block(cfg, pdt, device) for _ in range(cfg.n_layers))
        self.blocks = nn.ModuleList(blocks)

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

@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """A randomly initialised model on ``device`` (the card unless the
    caller names another), drawn from ``generator`` (on that device).

    The distributions are the reference's: normal x 1/sqrt(fan_in) for
    every matrix (fan_in = the weight's second-to-last dimension, so
    the sLSTM's (H, 4 hd, hd) ``r_gates`` takes 4 hd), 0.02 for the
    embedding, 1/sqrt(fan_in x n_layers) for ``wo`` and every
    ``w_down`` (the full ``n_layers`` for xLSTM too, not the pair
    count), 1/sqrt(k) for the SSM's conv taps; zeros for the QKV
    biases, ``dt_bias`` and the hybrid's ``mix``, ones for the norms
    and ``d_skip``, and ``a_log = log(1..N)`` on every channel; drawn
    weight by weight over the layers, in the reference's order.
    ``jax.random`` and ``torch.Generator`` give different numbers, so no
    draw equals the reference's bit for bit; tests carry the
    reference's weights across with ``convert.params_from_reference``.
    """
    cfg.validate()
    device = resolve_device(device)
    model = LM(cfg, device)
    Lc = cfg.n_layers

    def normal(params, scale=None):
        for p in params:
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            p.normal_(generator=generator).mul_(
                scale or 1.0 / math.sqrt(fan_in))

    def each(mods, *names, scale=None):
        for name in names:
            normal([getattr(m, name) for m in mods], scale)

    normal([model.embed], 0.02)
    if model.lm_head is not None:
        normal([model.lm_head])
    blocks = list(model.blocks)
    ones = [model.final_norm.weight]
    for b in blocks:
        ones += [b.norm1.weight, b.norm2.weight]
    if cfg.family == "ssm":
        d_in = 2 * cfg.d_model
        ml = [b.mlstm for b in blocks]
        each(ml, "w_up", "wq", "wk", "wv", "w_if")
        each(ml, "w_down", scale=1.0 / math.sqrt(d_in * Lc))
        sl = [b.slstm for b in blocks]
        each(sl, "w_gates", "r_gates", "w_up")
        each(sl, "w_down",
             scale=1.0 / math.sqrt(L.slstm_ff(cfg.d_model) * Lc))
        ones += [m.ln for m in ml] + [s.ln for s in sl]
    else:
        attn = [b.attn for b in blocks]
        each(attn, "wq", "wk", "wv")
        each(attn, "wo", scale=1.0 / math.sqrt(cfg.n_heads * cfg.hd * Lc))
        for a in attn:
            for name in ("bq", "bk", "bv"):
                if getattr(a, name) is not None:
                    getattr(a, name).zero_()
            for name in ("q_norm", "k_norm"):
                if getattr(a, name) is not None:
                    ones.append(getattr(a, name))
        if cfg.family == "moe":
            moe = [b.moe for b in blocks]
            each(moe, "router", "w_gate", "w_up")
            each(moe, "w_down", scale=1.0 / math.sqrt(cfg.d_ff * Lc))
        elif cfg.d_ff > 0:
            mlp = [b.mlp for b in blocks]
            each(mlp, "w_gate", "w_up")
            each(mlp, "w_down", scale=1.0 / math.sqrt(cfg.d_ff * Lc))
        if cfg.family == "hybrid":
            d_in = cfg.d_model * cfg.ssm_expand
            ssm = [b.ssm for b in blocks]
            each(ssm, "w_in")
            each(ssm, "conv_w", scale=1.0 / math.sqrt(cfg.ssm_conv))
            each(ssm, "w_bcdt")
            a_log = torch.log(torch.arange(1, cfg.ssm_state + 1,
                                           dtype=torch.float32,
                                           device=device))
            for s in ssm:
                s.a_log.copy_(a_log.expand(d_in, -1))
                s.dt_bias.zero_()
                ones.append(s.d_skip)
            each(ssm, "w_out", scale=1.0 / math.sqrt(d_in * Lc))
            for b in blocks:
                b.mix.zero_()
    for w in ones:
        w.fill_(1.0)
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


def _mix(blk: Block, attn_out, ssm_out, dtype):
    """The hybrid's float32 softmax mix of the two branches."""
    w = torch.softmax(blk.compute["mix"].float(), dim=-1)
    return (w[0] * attn_out.float() + w[1] * ssm_out.float()).to(dtype)


def _block(x, blk: Block, cfg: ModelConfig, positions, mrope_positions=None,
           cache=None):
    """One block over the whole sequence.  With ``cache`` (the layer's
    views of the prefill cache: ``k`` / ``v`` of (B, S_max, KV, hd),
    and for the hybrid ``ssm_h`` / ``ssm_conv``) its K / V are written
    into their first S slots and its SSM state into the rest."""
    h = blk.norm1(x)
    p = blk.attn.p
    q, k, v = L._qkv(h, p, cfg, positions, mrope_positions)
    if cache is not None:
        S = k.shape[1]
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    attn_out = _attn_out(q, k, v, p, cfg, _mask_mode(cfg))
    if blk.ssm is not None:
        if cache is None:
            ssm_out = L.ssm_block(h, blk.ssm.p, cfg)
        else:
            ssm_out, (h_last, conv_last) = L.ssm_block(h, blk.ssm.p, cfg,
                                                       with_state=True)
            cache["ssm_h"].copy_(h_last)
            cache["ssm_conv"].copy_(conv_last)
        attn_out = _mix(blk, attn_out, ssm_out, x.dtype)
    x = x + attn_out
    ff = blk.ffn(blk.norm2(x))
    return x if ff is None else x + ff


XLSTM_KEYS = ("mlstm_C", "mlstm_n", "mlstm_m",
              "slstm_h", "slstm_c", "slstm_n", "slstm_m")


def _store_xlstm(cache: Dict, states) -> None:
    """Write a pair's seven recurrent states into its cache views."""
    for key, val in zip(XLSTM_KEYS, states):
        cache[key].copy_(val)


def _xlstm_pair(x, pair: XlstmPair, cfg: ModelConfig, cache=None):
    """One mLSTM + sLSTM pair over the whole sequence; with ``cache``
    (the pair's views of the seven recurrent tensors) the final states
    are written into it."""
    h = pair.norm1(x)
    if cache is None:
        x = x + L.mlstm_block(h, pair.mlstm.p, cfg)
        return x + L.slstm_scan(pair.norm2(x), pair.slstm.p, cfg)[0]
    out, m_state = L.mlstm_block(h, pair.mlstm.p, cfg, with_state=True)
    x = x + out
    out, s_state = L.slstm_scan(pair.norm2(x), pair.slstm.p, cfg)
    _store_xlstm(cache, m_state + s_state)
    return x + out


def _embed(model: LM, tokens, dtype) -> torch.Tensor:
    """Token rows gathered from the float32 master, then cast (the
    reference's order: gradients of repeated tokens sum in float32)."""
    return model.embed[tokens.long()].to(dtype)


def _inputs_to_h(model: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.input_kind == "embeds":
        return batch["embeds"].to(_dtype(cfg))
    return _embed(model, batch["tokens"], _dtype(cfg))


def _positions(batch, B: int, S: int, device):
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device).expand(B, S)
    return positions


def _run_layers(model: LM, cfg: ModelConfig, h, layer):
    """``h`` through every block by ``layer(h, block)``.  In grad mode
    each block computes with copies cast inside autograd, in a body that
    ``cfg.remat`` checkpoints (recomputed, cast included, in the
    backward pass)."""
    if not torch.is_grad_enabled():
        for blk in model.blocks:
            h = layer(h, blk)
        return h
    dtype = _dtype(cfg)

    def body(x, blk):
        with L.graph_copies(blk, dtype):
            return layer(x, blk)

    for blk in model.blocks:
        h = (checkpoint(body, h, blk, use_reentrant=False) if cfg.remat
             else body(h, blk))
    return h


def forward(params: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence forward; returns final hidden states (B, S, d)."""
    _check_cfg(params, cfg)
    h = _inputs_to_h(params, cfg, batch)
    B, S, _ = h.shape
    if cfg.family == "ssm":
        h = _run_layers(params, cfg, h,
                        lambda x, pair: _xlstm_pair(x, pair, cfg))
    else:
        positions = _positions(batch, B, S, h.device)
        mrope = batch.get("mrope_positions") if cfg.family == "vlm" else None
        h = _run_layers(params, cfg, h, lambda x, blk: _block(
            x, blk, cfg, positions, mrope))
    with L.graph_copies(params.final_norm, _dtype(cfg)):
        return params.final_norm(h)


def _head(params: LM, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) output projection's master: the tied embedding's
    transpose, or the untied head."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def loss_fn(params: LM, cfg: ModelConfig, batch) -> torch.Tensor:
    """Next-token cross-entropy (a float32 scalar), chunked over the
    sequence: per chunk of ``C = min(cfg.loss_chunk, S)`` positions the
    logits are a product in the compute dtype, cast to float32, and
    each position's loss is ``logsumexp - logit[label]`` where
    ``batch["loss_mask"]`` (if given) is set; the result is the summed
    loss over ``max(count, 1)``.  Past one chunk each chunk's loss is
    checkpointed, so the backward pass also holds one chunk's
    (B, C, V) float32 logits at a time, never the whole sequence's."""
    h = forward(params, cfg, batch)                    # (B, S, d)
    B, S, _ = h.shape
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    mask = (torch.ones((B, S), dtype=torch.bool, device=h.device)
            if mask is None else mask.bool())
    W = _head(params, cfg).to(_dtype(cfg))             # (d, V)
    C = min(cfg.loss_chunk, S)
    if S % C:
        raise ValueError(f"sequence {S} must divide the loss chunk {C}")

    def one(hx, lx, mx, W):
        logits = (hx @ W).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lx[..., None])[..., 0]
        return torch.where(mx, lse - ll, 0.0).sum()

    chunked = S > C and torch.is_grad_enabled()
    nll = 0.0
    for i in range(0, S, C):
        args = (h[:, i:i + C], labels[:, i:i + C], mask[:, i:i + C], W)
        nll = nll + (checkpoint(one, *args, use_reentrant=False) if chunked
                     else one(*args))
    return nll / mask.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-family caches
# ---------------------------------------------------------------------------

def cache_heads(cfg: ModelConfig) -> int:
    """KV-head count stored in the cache.  With cache_repeated_kv the
    cache holds the GQA-repeated query heads, padded with
    ``pad_attn_heads`` to a multiple of the active mesh's
    tensor-parallel axis (``axis_size("tp")``, 1 with no mesh), so the
    head dim shards over the model axis."""
    if not cfg.cache_repeated_kv:
        return cfg.n_kv_heads
    H = cfg.n_heads
    tp = max(axis_size("tp"), 1)
    if cfg.pad_attn_heads and H % tp:
        H = -(-H // tp) * tp
    return H


def _recurrent_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    """xLSTM's seven zero states, float32, on a leading pair axis."""
    half, d, H = cfg.n_layers // 2, cfg.d_model, cfg.n_heads
    hd_m, hd_s = 2 * d // H, d // H
    shapes = ((hd_m, hd_m), (hd_m,), (), (hd_s,), (hd_s,), (hd_s,), ())
    return {k: torch.zeros((half, batch, H) + s, dtype=torch.float32,
                           device=device) for k, s in zip(XLSTM_KEYS, shapes)}


def _ssm_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    """The hybrid's SSM states: ``ssm_h`` float32, ``ssm_conv`` (the
    last k - 1 raw conv inputs) in the compute dtype."""
    d_in = cfg.d_model * cfg.ssm_expand
    return {"ssm_h": torch.zeros((cfg.n_layers, batch, d_in, cfg.ssm_state),
                                 dtype=torch.float32, device=device),
            "ssm_conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                     d_in), dtype=_dtype(cfg), device=device)}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               ring: Optional[bool] = None, device=None) -> Dict:
    """An empty cache on ``device`` (the card unless the caller names
    another): for xLSTM the seven zero recurrent states; otherwise K /
    V linear over ``s_max`` positions, or, for a sliding window shorter
    than ``s_max`` (or ``ring=True``), a ring of ``window`` entries
    with their absolute positions (-1 = empty), and for the hybrid the
    SSM states."""
    device = resolve_device(device)
    if cfg.family == "ssm":
        return _recurrent_cache(cfg, batch, device)
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
    if cfg.family == "hybrid":
        cache.update(_ssm_cache(cfg, batch, device))
    return cache


def _logits(params: LM, h) -> torch.Tensor:
    """Next-token logits (B, V) in float32 from the last position."""
    h = params.final_norm(h)
    return (h[:, -1] @ params.head()).float()


def _layer(cache: Dict, i: int) -> Dict:
    """Layer (or pair) ``i``'s views of every per-layer cache tensor."""
    return {k: v[i] for k, v in cache.items()}


def prefill(params: LM, cfg: ModelConfig, batch,
            s_max: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; return (next-token logits (B, V), cache):
    K / V zero-padded to ``s_max`` positions (and the hybrid's SSM
    states after the prompt), or xLSTM's recurrent states after it."""
    _check_cfg(params, cfg)
    h = _inputs_to_h(params, cfg, batch)
    B, S, _ = h.shape
    if cfg.family == "ssm":
        cache = _recurrent_cache(cfg, B, h.device)
        for i, pair in enumerate(params.blocks):
            h = _xlstm_pair(h, pair, cfg, _layer(cache, i))
        return _logits(params, h), cache
    s_max = s_max or S
    positions = _positions(batch, B, S, h.device)
    mrope = batch.get("mrope_positions") if cfg.family == "vlm" else None
    shape = (cfg.n_layers, B, s_max, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=h.dtype, device=h.device),
             "v": torch.zeros(shape, dtype=h.dtype, device=h.device)}
    if cfg.family == "hybrid":
        cache.update(_ssm_cache(cfg, B, h.device))
    for i, blk in enumerate(params.blocks):
        h = _block(h, blk, cfg, positions, mrope, _layer(cache, i))
    return _logits(params, h), cache


def decode_step(params: LM, cfg: ModelConfig, tokens, cache: Dict,
                pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B, 1) int (or embeds (B, 1, d)); pos:
    position of the new token.  Writes the new K / V entry and the new
    recurrent states into ``cache`` in place; returns (logits (B, V),
    cache)."""
    _check_cfg(params, cfg)
    pos = int(pos)
    dt = _dtype(cfg)
    if cfg.input_kind == "embeds":
        h = tokens.to(dt)             # caller passes an embedding
    else:
        h = _embed(params, tokens, dt)
    if cfg.family == "ssm":
        for i, pair in enumerate(params.blocks):
            c = _layer(cache, i)
            out, C, n, m = L.mlstm_decode(
                pair.norm1(h), pair.mlstm.p, cfg, c["mlstm_C"], c["mlstm_n"],
                c["mlstm_m"])
            h = h + out
            out, state = L.slstm_scan(pair.norm2(h), pair.slstm.p, cfg,
                                      *(c[k] for k in XLSTM_KEYS[3:]))
            h = h + out
            _store_xlstm(c, (C, n, m) + state)
        return _logits(params, h), cache
    B = h.shape[0]
    mrope = None
    if cfg.family == "vlm":
        mrope = torch.full((3, B, 1), pos, dtype=torch.int32, device=h.device)
    pos_ids = cache.get("pos_ids")
    for i, blk in enumerate(params.blocks):
        hpre = blk.norm1(h)
        attn_out, _, _, _ = L.attention_decode(
            hpre, blk.attn.p, cfg, cache["k"][i], cache["v"][i], pos,
            mrope, cache_pos=None if pos_ids is None else pos_ids[i])
        if blk.ssm is not None:
            ssm_out, h_new, conv_new = L.ssm_decode(
                hpre, blk.ssm.p, cfg, cache["ssm_h"][i], cache["ssm_conv"][i])
            cache["ssm_h"][i] = h_new
            cache["ssm_conv"][i] = conv_new
            attn_out = _mix(blk, attn_out, ssm_out, h.dtype)
        h = h + attn_out
        ff = blk.ffn(blk.norm2(h))
        if ff is not None:
            h = h + ff
    return _logits(params, h), cache

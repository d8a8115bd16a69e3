"""Building blocks of the LM: the port of ``repro.models.layers``.

Plain tensor functions under the reference's names and argument order
(``rms_norm``, ``rope_freqs``, ``apply_rope``, ``apply_mrope``,
``_qkv``, ``_maybe_pad_heads``, ``attention``, ``attention_decode``,
``swiglu``, ``moe_ffn``, ``_ssm_scan``, ``ssm_block``, ``ssm_decode``,
``mlstm_block``, ``mlstm_decode``, ``slstm_scan``), and the modules
that hold their weights (``RMSNorm``, ``Attention``, ``SwiGLU``,
``MoE``, ``SSM``, ``MLSTM``, ``SLSTM``).  Layouts are the reference's:
activations (B, S, d), heads (B, S, H, hd), weights (d_in, d_out), so
a weight carries across with no transpose.

The reference's dtype order is kept: ``rms_norm`` reduces in float32,
casts to the compute dtype, then multiplies by the weight; RoPE angles
are float32; softmax runs in float32 and is cast back before the value
product; masked logits take the minimum of the logits' own dtype; the
router's gates, the xLSTM gates and stabilisers and the recurrent
states (``ssm_decode``'s, the mLSTM memory, the sLSTM cell) are
float32.

One card has no tensor-parallel axis (the reference's
``axis_size("tp")`` is 1 there), so ``_maybe_pad_heads`` pads nothing
and the reference's sharding constraints are the identity; they are
not carried over.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Weights: float32 masters and their compute-dtype copies
# ---------------------------------------------------------------------------

def master(shape, dtype, device) -> nn.Parameter:
    """An uninitialised master weight, which takes a gradient."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Weights(nn.Module):
    """A module whose own parameters are the master weights (the
    config's ``param_dtype``) and whose ``compute`` dict holds them in
    the compute dtype.  ``bind`` sets the copies the module computes
    with (subclasses also build their ``p`` tuple there).

    Two kinds of copies are bound.  ``cast_`` binds copies cast once,
    detached from autograd, which serving reads: the reference casts
    every layer's masters on every call (``model._cast_layer``), and a
    cast is deterministic, so casting once gives the same numbers (a
    copy is made only where the dtypes differ).  ``graph_copies`` binds,
    for the span of a ``with`` block in grad mode, copies cast inside
    autograd, so that gradients reach the masters."""

    def bind(self, copies: dict) -> None:
        self.compute = copies

    def cast_(self, dtype: torch.dtype) -> None:
        with torch.no_grad():
            self.bind({n: p.detach().to(dtype)
                       for n, p in self.named_parameters(recurse=False)})


@contextlib.contextmanager
def graph_copies(module: nn.Module, dtype: torch.dtype):
    """In grad mode, bind every ``Weights`` module of ``module`` to
    copies of its masters cast to ``dtype`` inside autograd, as the
    reference's ``_cast_layer`` casts inside each layer's remat body;
    the detached copies are bound again on exit.  Without grad mode it
    changes nothing: the detached copies hold the same numbers."""
    if not torch.is_grad_enabled():
        yield
        return
    mods = [m for m in module.modules() if isinstance(m, Weights)]
    kept = [m.compute for m in mods]
    for m in mods:
        m.bind({n: p.to(dtype)
                for n, p in m.named_parameters(recurse=False)})
    try:
        yield
    finally:
        for m, copies in zip(mods, kept):
            m.bind(copies)


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

    def bind(self, copies):
        super().bind(copies)
        self.p = AttnParams(*(copies.get(f) for f in AttnParams._fields))


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

    def bind(self, copies):
        super().bind(copies)
        self.p = MlpParams(**copies)

    def forward(self, x):
        return swiglu(x, self.p)


# ---------------------------------------------------------------------------
# MoE: top-k routed experts, GShard-style capacity dispatch
# ---------------------------------------------------------------------------

class MoeParams(NamedTuple):
    router: torch.Tensor    # (d, E)
    w_gate: torch.Tensor    # (E, d, ff)
    w_up: torch.Tensor      # (E, d, ff)
    w_down: torch.Tensor    # (E, ff, d)


def _pick_groups(T: int, target: int = 8192) -> int:
    g = max(T // target, 1)
    while T % g:
        g -= 1
    return g


def _top_k(gates, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (a
    stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(xg, router, cfg):
    """The router of ``moe_ffn`` over token groups xg: (G, Sg, d):
    float32 softmax gates, then the top ``experts_per_token``.  Returns
    (top gates (G, Sg, K) float32, expert ids (G, Sg, K) int64)."""
    gates = torch.softmax((xg @ router).float(), dim=-1)
    return _top_k(gates, cfg.experts_per_token)


def moe_capacity(cfg, Sg: int) -> int:
    """Per-expert capacity C of a group of Sg tokens: the reference's
    ``int(max(cf * Sg * K / E, K))`` rounded up to a multiple of 128.
    The rounding decides which tokens drop, so it is kept exactly."""
    E, K = cfg.n_experts, cfg.experts_per_token
    C = int(max(cfg.moe_capacity_factor * Sg * K / E, K))
    return -(-C // 128) * 128


def moe_ffn(x, p: MoeParams, cfg):
    """Top-k routing with grouped, capacity-bounded scatter / gather
    dispatch (GShard groups).

    Tokens are split into G groups; each group routes independently
    with capacity C per expert (``moe_capacity``).  A token's slot in
    its expert is the count of earlier (token, k) choices of that
    expert in flat (token, k) order; choices past C are dropped
    (combine weight 0) and their slot is the overflow slot E * C, which
    reads zeros.  Every expert runs its SwiGLU on all E * C rows of the
    dense dispatch, empty rows included.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = _pick_groups(T)
    Sg = T // G
    xg = x.reshape(G, Sg, d)
    topv, topi = moe_route(xg, p.router, cfg)              # (G, Sg, K)
    topv = (topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype)

    C = moe_capacity(cfg, Sg)
    flat_e = topi.reshape(G, Sg * K)
    # the count runs along the flat (token, k) axis, kept innermost so
    # the scan is over contiguous rows (the integers are the same)
    onehot = (flat_e[:, None, :] == torch.arange(
        E, device=x.device)[:, None]).to(torch.int32)      # (G, E, Sg*K)
    pos = ((onehot.cumsum(-1) - onehot) * onehot).sum(1)   # (G, Sg*K)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)       # (G, Sg*K)

    tok_of = (torch.arange(Sg * K, device=x.device) // K).expand(G, -1)
    buf = torch.full((G, E * C + 1), -1, dtype=torch.long, device=x.device)
    buf = buf.scatter(1, slot, tok_of)[:, :E * C]          # (G, E*C)
    occupied = buf >= 0
    rows = torch.arange(G, device=x.device)[:, None]
    expert_in = xg[rows, buf.clamp_min(0)].masked_fill(
        ~occupied[..., None], 0)                           # (G, E*C, d)
    expert_in = expert_in.reshape(G, E, C, d)
    g = torch.einsum("gecd,edf->gecf", expert_in, p.w_gate)
    u = torch.einsum("gecd,edf->gecf", expert_in, p.w_up)
    out_e = torch.einsum("gecf,efd->gecd", F.silu(g) * u, p.w_down)

    # combine from the token side; the overflow slot reads zeros
    out_flat = torch.cat([out_e.reshape(G, E * C, d),
                          out_e.new_zeros((G, 1, d))], dim=1)
    gathered = out_flat[rows, slot]                        # (G, Sg*K, d)
    w = torch.where(keep, topv.reshape(G, Sg * K), 0.0).to(x.dtype)
    out = (gathered * w[..., None]).reshape(G, Sg, K, d).sum(dim=2)
    return out.reshape(B, S, d)


class MoE(Weights):
    """The routed experts of one block; ``forward`` is ``moe_ffn``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
        self.router = master((d, E), dtype, device)
        self.w_gate = master((E, d, ff), dtype, device)
        self.w_up = master((E, d, ff), dtype, device)
        self.w_down = master((E, ff, d), dtype, device)

    def bind(self, copies):
        super().bind(copies)
        self.p = MoeParams(**copies)

    def forward(self, x):
        return moe_ffn(x, self.p, self.cfg)


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (hybrid / hymba blocks)
# ---------------------------------------------------------------------------

class SsmParams(NamedTuple):
    w_in: torch.Tensor      # (d, 2*d_in)  -> x, z
    conv_w: torch.Tensor    # (k, d_in) depthwise causal conv
    w_bcdt: torch.Tensor    # (d_in, 2*state + 1)  -> B, C, dt
    a_log: torch.Tensor     # (d_in, state)
    d_skip: torch.Tensor    # (d_in,)
    dt_bias: torch.Tensor   # (d_in,)
    w_out: torch.Tensor     # (d_in, d)


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a2 * a1, a2 * b1 + b2


def _associative_scan(a, b):
    """``jax.lax.associative_scan(combine, (a, b), axis=1)`` for the
    linear recurrence h_t = a_t h_(t-1) + b_t, by the same odd / even
    recursion (about 2 log2(L) levels of whole-tensor ops), so every
    element is combined in the reference's order and rounds as it
    does."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs: (0, 1), (2, 3), ...
    odd = _associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                      (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for first, ev, od in zip((a, b), even, odd):
        full = torch.empty_like(first)
        full[:, 0] = first[:, 0]
        full[:, 2::2] = ev
        full[:, 1::2] = od
        out.append(full)
    return tuple(out)


def _ssm_scan(u, dt, A, Bmat, Cmat, return_last: bool = False):
    """Selective scan via the associative scan (parallel over sequence).

    u: (B, L, d_in); dt: (B, L, d_in); A: (d_in, N);
    Bmat/Cmat: (B, L, N).  Returns y (B, L, d_in) and, with
    ``return_last``, the last state h[:, -1] (B, d_in, N) in float32
    (rounded to the compute dtype first, as the reference's prefill
    takes it).
    """
    da = torch.exp(dt[..., None] * A)                      # (B,L,d,N)
    db = dt[..., None] * Bmat[:, :, None, :]               # (B,L,d,N)
    xdb = u[..., None] * db
    _, h = _associative_scan(da, xdb)
    y = torch.einsum("bldn,bln->bld", h, Cmat)
    if return_last:
        return y, h[:, -1].float()
    return y


def _causal_conv(u_pad, conv_w, L: int):
    """The depthwise causal conv as the reference's Python sum:
    ((0 + t0) + t1) + ... over the k taps."""
    return sum(u_pad[:, i:i + L] * conv_w[i] for i in range(conv_w.shape[0]))


def ssm_block(x, p: SsmParams, cfg, with_state: bool = False):
    """Full-sequence Mamba-ish block (training / prefill).

    With ``with_state`` also returns the decode hand-off state, as the
    reference's ``model._ssm_with_state`` does from a second pass:
    (h_last (B, d_in, N) float32, conv_last (B, k - 1, d_in)), the
    conv state holding the raw (pre-conv) inputs of the last k - 1
    positions, zero-padded in front when the sequence is shorter."""
    B, L, d = x.shape
    u, z = (x @ p.w_in).chunk(2, dim=-1)                   # (B,L,d_in)
    k = p.conv_w.shape[0]
    u_pad = F.pad(u, (0, 0, k - 1, 0))
    conv_last = u_pad[:, L:L + k - 1]
    u = F.silu(_causal_conv(u_pad, p.conv_w, L))
    bcd = u @ p.w_bcdt
    N = cfg.ssm_state
    Bmat, Cmat, dt = bcd[..., :N], bcd[..., N:2 * N], bcd[..., 2 * N]
    dt = F.softplus(dt[..., None] + p.dt_bias)             # (B,L,d_in)
    A = -torch.exp(p.a_log.float()).to(x.dtype)
    y = _ssm_scan(u, dt, A, Bmat, Cmat, return_last=with_state)
    if with_state:
        y, h_last = y
    y = y + u * p.d_skip
    y = y * F.silu(z)
    out = y @ p.w_out
    if with_state:
        return out, (h_last, conv_last)
    return out


def ssm_decode(x, p: SsmParams, cfg, h_state, conv_state):
    """One-token SSM step.  h_state: (B, d_in, N) float32; conv_state:
    (B, k-1, d_in).  The state update runs in float32.  Returns (out
    (B, 1, d), h_new, new_conv)."""
    u, z = (x @ p.w_in).chunk(2, dim=-1)
    u = u[:, 0]                                            # (B, d_in)
    k = p.conv_w.shape[0]
    full = torch.cat([conv_state, u[:, None, :]], dim=1)   # (B,k,d_in)
    new_conv = full[:, 1:]
    u = F.silu(sum(full[:, i] * p.conv_w[i] for i in range(k)))
    bcd = u @ p.w_bcdt
    N = cfg.ssm_state
    Bv, Cv, dt = bcd[..., :N], bcd[..., N:2 * N], bcd[..., 2 * N]
    dt = F.softplus(dt[..., None] + p.dt_bias)             # (B, d_in)
    A = -torch.exp(p.a_log.float()).to(x.dtype)
    da = torch.exp(dt[..., None] * A)                      # (B,d_in,N)
    h_new = (da.float() * h_state
             + ((dt * u)[..., None] * Bv[:, None, :]).float())
    y = torch.einsum("bdn,bn->bd", h_new, Cv.float())
    y = y.to(x.dtype) + u * p.d_skip
    y = y * F.silu(z[:, 0])
    out = (y @ p.w_out)[:, None, :]
    return out.to(x.dtype), h_new, new_conv


class SSM(Weights):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, N, k = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
        d_in = d * cfg.ssm_expand
        self.w_in = master((d, 2 * d_in), dtype, device)
        self.conv_w = master((k, d_in), dtype, device)
        self.w_bcdt = master((d_in, 2 * N + 1), dtype, device)
        self.a_log = master((d_in, N), dtype, device)
        self.d_skip = master((d_in,), dtype, device)
        self.dt_bias = master((d_in,), dtype, device)
        self.w_out = master((d_in, d), dtype, device)

    def bind(self, copies):
        super().bind(copies)
        self.p = SsmParams(**copies)


# ---------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

class MlstmParams(NamedTuple):
    w_up: torch.Tensor      # (d, 2*d_in)   (x, z branches)
    wq: torch.Tensor        # (d_in, d_in)
    wk: torch.Tensor        # (d_in, d_in)
    wv: torch.Tensor        # (d_in, d_in)
    w_if: torch.Tensor      # (d_in, 2*heads)  input+forget gate projections
    ln: torch.Tensor        # (d_in,) group-norm scale
    w_down: torch.Tensor    # (d_in, d)


def mlstm_block(x, p: MlstmParams, cfg, row_chunk: int = 1024,
                with_state: bool = False):
    """Parallel (quadratic) mLSTM formulation for training / prefill --
    an attention-like form with exponential input gates and cumulative
    forget-gate decay (xLSTM paper, parallel form), rows processed in
    chunks of ``row_chunk`` (each against every column) above
    ``row_chunk``, which must then divide L.

    With ``with_state`` also returns the recurrent (C (B, H, hd, hd),
    n (B, H, hd), m (B, H)) state after the sequence, float32, for the
    prefill -> decode hand-off -- the reference's
    ``model._mlstm_final_state``, from this pass's k / v / gates."""
    B, L, d = x.shape
    H = cfg.n_heads
    u, z = (x @ p.w_up).chunk(2, dim=-1)
    d_in = u.shape[-1]
    hd = d_in // H
    q = (u @ p.wq).reshape(B, L, H, hd)
    k = (u @ p.wk).reshape(B, L, H, hd)
    v = (u @ p.wv).reshape(B, L, H, hd)
    gates = u @ p.w_if                                     # (B,L,2H)
    i_gate = gates[..., :H].float()                        # log-space input
    f_gate = F.logsigmoid(gates[..., H:].float())
    # D[t,s] = exp(cumsum_f(t) - cumsum_f(s) + i(s)) for s<=t (stabilised)
    csum = torch.cumsum(f_gate, dim=1)                     # (B,L,H)
    scale = 1.0 / math.sqrt(hd)
    cols = torch.arange(L, device=x.device)

    def rows(r0, C):
        logD = (csum[:, r0:r0 + C, None, :] - csum[:, None, :, :]
                + i_gate[:, None, :, :])                   # (B,C,L,H)
        causal = (cols[None, :] <= (r0 + cols[:C])[:, None])[None, :, :,
                                                            None]
        logD = logD.masked_fill(~causal, -math.inf)
        m = logD.amax(dim=2, keepdim=True)
        Dmat = torch.exp(logD - m)
        scores = torch.einsum("bthd,bshd->btsh", q[:, r0:r0 + C], k) * scale
        weights = scores * Dmat.to(scores.dtype)
        norm = weights.sum(dim=2).abs().clamp_min(1.0)
        return torch.einsum("btsh,bshd->bthd", weights, v) / norm[..., None]

    if L <= row_chunk:
        hsa = rows(0, L)
    else:
        if L % row_chunk:
            raise ValueError(f"sequence {L} must divide the mLSTM row "
                             f"chunk {row_chunk}")
        hsa = torch.cat([rows(r0, row_chunk)
                         for r0 in range(0, L, row_chunk)], dim=1)
    hsa = rms_norm(hsa.reshape(B, L, d_in), p.ln, cfg.norm_eps)
    out = (hsa * F.silu(z)) @ p.w_down
    if not with_state:
        return out
    logw = csum[:, -1:, :] - csum + i_gate                 # (B, L, H)
    m = logw.amax(dim=1)                                   # (B, H)
    wgt = torch.exp(logw - m[:, None, :])
    C = torch.einsum("bshv,bshk->bhvk", wgt[..., None] * v.float(),
                     k.float())
    n = torch.einsum("bsh,bshk->bhk", wgt, k.float())
    return out, (C, n, m)


def mlstm_decode(x, p: MlstmParams, cfg, C, n, m_state):
    """Recurrent mLSTM step.  C: (B,H,hd,hd) matrix memory; n: (B,H,hd)
    normaliser; m_state: (B,H) log-space stabiliser (all float32).
    Returns (out (B, 1, d), C_new, n_new, m_new)."""
    B = x.shape[0]
    H = cfg.n_heads
    u, z = (x @ p.w_up).chunk(2, dim=-1)
    u = u[:, 0]
    d_in = u.shape[-1]
    hd = d_in // H
    q = (u @ p.wq).reshape(B, H, hd)
    k = (u @ p.wk).reshape(B, H, hd)
    v = (u @ p.wv).reshape(B, H, hd)
    gates = u @ p.w_if
    i_g = gates[..., :H].float()
    f_g = F.logsigmoid(gates[..., H:].float())
    m_new = torch.maximum(f_g + m_state, i_g)
    f_eff = torch.exp(f_g + m_state - m_new)[..., None, None]
    i_eff = torch.exp(i_g - m_new)[..., None, None]
    scale = 1.0 / math.sqrt(hd)
    C_new = f_eff * C + i_eff * (v[..., :, None] * k[..., None, :])
    n_new = f_eff[..., 0] * n + i_eff[..., 0] * k
    qs = (q * scale).float()
    num = torch.einsum("bhd,bhvd->bhv", qs, C_new)
    den = torch.einsum("bhd,bhd->bh", qs, n_new).abs().clamp_min(1.0)
    hsa = (num / den[..., None]).reshape(B, d_in).to(x.dtype)
    hsa = rms_norm(hsa, p.ln, cfg.norm_eps)
    out = ((hsa * F.silu(z[:, 0])) @ p.w_down)[:, None, :]
    return out.to(x.dtype), C_new, n_new, m_new


class MLSTM(Weights):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        d_in = 2 * d  # mLSTM up-projection factor 2
        self.w_up = master((d, 2 * d_in), dtype, device)
        self.wq = master((d_in, d_in), dtype, device)
        self.wk = master((d_in, d_in), dtype, device)
        self.wv = master((d_in, d_in), dtype, device)
        self.w_if = master((d_in, 2 * H), dtype, device)
        self.ln = master((d_in,), dtype, device)
        self.w_down = master((d_in, d), dtype, device)

    def bind(self, copies):
        super().bind(copies)
        self.p = MlstmParams(**copies)


class SlstmParams(NamedTuple):
    w_gates: torch.Tensor   # (d, 4*d)  i,f,z,o projections (block-diag heads)
    r_gates: torch.Tensor   # (heads, 4*hd, hd) recurrent per-head weights
    w_up: torch.Tensor      # (d, ff_s)
    w_down: torch.Tensor    # (ff_s, d)
    ln: torch.Tensor        # (d,)


def slstm_ff(d: int) -> int:
    """The sLSTM block's up-projection width."""
    return max(int(d * 4 / 3), d)


def slstm_scan(x, p: SlstmParams, cfg, h0=None, c0=None, n0=None, m0=None):
    """Sequential sLSTM over the sequence: a Python loop over time where
    the reference runs ``lax.scan``.

    Exponential input gates with the standard max-stabiliser; heads are
    block-diagonal in the recurrent matrices.  Returns the output
    sequence and the final (h, c, n, m) state (float32) for decode
    hand-off.
    """
    B, L, d = x.shape
    H = cfg.n_heads
    hd = d // H
    gx = (x @ p.w_gates).reshape(B, L, H, 4 * hd).float()  # (B,L,H,4hd)

    def init(v):
        return (torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
                if v is None else v)

    h, c, n = init(h0), init(c0), init(n0)
    m = (torch.zeros((B, H), dtype=torch.float32, device=x.device)
         if m0 is None else m0)
    r_t = p.r_gates.transpose(1, 2)                        # (H, hd, 4hd)
    ys = torch.empty((B, L, H, hd), dtype=x.dtype, device=x.device)
    for t in range(L):
        rec = torch.bmm(h.to(x.dtype).transpose(0, 1), r_t).transpose(0, 1)
        g = gx[:, t] + rec.float()                         # (B,H,4hd)
        i_t, f_t, z_t, o_t = g.chunk(4, dim=-1)
        f_log = F.logsigmoid(f_t)
        m_new = torch.maximum(f_log.mean(-1) + m, i_t.mean(-1))
        i_eff = torch.exp(i_t - m_new[..., None])
        f_eff = torch.exp(f_log + (m - m_new)[..., None])
        c = f_eff * c + i_eff * torch.tanh(z_t)
        n = f_eff * n + i_eff
        h = torch.sigmoid(o_t) * c / n.clamp_min(1.0)
        m = m_new
        ys[:, t] = h
    y = rms_norm(ys.reshape(B, L, d), p.ln, cfg.norm_eps)
    out = F.gelu(y @ p.w_up, approximate="tanh") @ p.w_down
    return out, (h, c, n, m)


class SLSTM(Weights):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        hd, ff = d // H, slstm_ff(d)
        self.w_gates = master((d, 4 * d), dtype, device)
        self.r_gates = master((H, 4 * hd, hd), dtype, device)
        self.w_up = master((d, ff), dtype, device)
        self.w_down = master((ff, d), dtype, device)
        self.ln = master((d,), dtype, device)

    def bind(self, copies):
        super().bind(copies)
        self.p = SlstmParams(**copies)

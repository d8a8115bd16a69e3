"""Parity of the port's LM stack (``repro_torch.models``,
``repro_torch.configs``) with the reference's, at smoke sizes on the
CPU.

Configs, the registry and the parameter counts must be equal.  Every
layer function and the model's ``forward`` / ``prefill`` /
``decode_step`` take the same numpy inputs on both sides -- the
reference's weights carried across by ``params_from_reference``, with
the QKV biases and every norm scale perturbed away from their
zeros / ones so that those paths count -- and must agree within rtol
1e-5 / atol 1e-5 in float32 and rtol 0.05 / atol 0.05 in bfloat16 (the
reference's own prefill / decode consistency tolerance,
tests/test_models.py).  The reference runs on the
CPU, jitted.  The reference's own properties then run on the port:
prefill / decode consistency and the converter's round trip.  The MoE,
hybrid and xLSTM families are held to the reference in
tests/test_torch_models_families.py.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as PC
from repro.models import config as R_cfg
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.models import config as P_cfg
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_reference, params_to_numpy

B = 2
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0.05, atol=0.05)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    """The reference's ``fn`` jitted with ``static`` bound (a config is
    a frozen dataclass, so it hashes); eager JAX dispatches op by op."""
    return jax.jit(functools.partial(fn, **static))


def _close(port, ref, dtype, what=""):
    np.testing.assert_allclose(_np(port), _np(ref), err_msg=what,
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# Configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_and_counts_match_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        rc, pc = getattr(RC, getter)(arch), getattr(PC, getter)(arch)
        assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
        assert [f.name for f in dataclasses.fields(pc)] == [
            f.name for f in dataclasses.fields(rc)]
        assert (pc.hd, pc.q_rep) == (rc.hd, rc.q_rep)
        assert P_cfg.param_count(pc) == R_cfg.param_count(rc)
        assert P_cfg.active_param_count(pc) == R_cfg.active_param_count(rc)
        pc.validate()


def test_registry_matches_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert PC.ALIASES == RC.ALIASES
    assert PC.SHAPES == RC.SHAPES
    assert PC.cells() == RC.cells()
    for alias in RC.ALIASES:
        assert dataclasses.asdict(PC.get_config(alias)) == dataclasses.asdict(
            RC.get_config(alias))
    assert P_cfg.param_count(PC.get_config("qwen3-1.7b")) == 1_720_567_808
    dense = PC.get_smoke_config("qwen3_1_7b")
    assert dense.scaled(n_layers=3).n_layers == 3
    with pytest.raises(AssertionError):
        dense.scaled(n_kv_heads=3).validate()


# ---------------------------------------------------------------------------
# Layer functions
# ---------------------------------------------------------------------------

def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _attn_params(rng, cfg, dtype):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    arrs = {"wq": _rand(rng, (d, H * hd), d ** -0.5),
            "wk": _rand(rng, (d, KV * hd), d ** -0.5),
            "wv": _rand(rng, (d, KV * hd), d ** -0.5),
            "wo": _rand(rng, (H * hd, d), (H * hd) ** -0.5)}
    for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
        arrs[name] = _rand(rng, (n,), 0.1) if cfg.qkv_bias else None
    for name in ("q_norm", "k_norm"):
        arrs[name] = (1 + _rand(rng, (hd,), 0.1)) if cfg.qk_norm else None
    r = RL.AttnParams(**{k: None if a is None else _both(a, dtype)[0]
                         for k, a in arrs.items()})
    p = PL.AttnParams(**{k: None if a is None else _both(a, dtype)[1]
                         for k, a in arrs.items()})
    return r, p


ATTN_CFGS = {
    "qk_norm": lambda: RC.get_smoke_config("qwen3_1_7b"),
    "qkv_bias": lambda: RC.get_smoke_config("qwen2_7b"),
    "mha": lambda: RC.get_smoke_config("musicgen_large"),
    "window": lambda: RC.get_smoke_config("qwen3_1_7b").scaled(
        sliding_window=5),
}


def _pcfg(rcfg):
    return P_cfg.ModelConfig(**dataclasses.asdict(rcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_swiglu_match_reference(dtype):
    rng = np.random.default_rng(0)
    rx, px = _both(_rand(rng, (2, 5, 64), 3.0), dtype)
    rw, pw = _both(1 + _rand(rng, (64,), 0.1), dtype)
    _close(PL.rms_norm(px, pw, 1e-6), _jit(RL.rms_norm, eps=1e-6)(rx, rw),
           dtype)
    rq, pq = _both(_rand(rng, (2, 7, 4, 16)), dtype)
    # RoPE eagerly on the reference side: jitted, XLA rounds theta ** x
    # one ulp apart from its eager form, which at positions in the
    # thousands moves the reference's own output by 2.4e-5
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (1e6, 1e4):
        _close(PL.apply_rope(pq, torch.from_numpy(pos), theta),
               RL.apply_rope(rq, jnp.asarray(pos), theta), dtype, "rope")
    pos3 = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    for sections in ((4, 2, 2), (2, 2, 2), (16, 24, 24)):
        _close(PL.apply_mrope(pq, torch.from_numpy(pos3), 1e6, sections),
               RL.apply_mrope(rq, jnp.asarray(pos3), 1e6, sections), dtype,
               f"mrope {sections}")
    # SwiGLU's input is an rms-normed hidden state: unit scale
    rh, ph = _both(_rand(rng, (2, 5, 64)), dtype)
    mats = [_rand(rng, s, 64 ** -0.5) for s in ((64, 96), (64, 96), (96, 64))]
    r = RL.MlpParams(*(_both(m, dtype)[0] for m in mats))
    p = PL.MlpParams(*(_both(m, dtype)[1] for m in mats))
    _close(PL.swiglu(ph, p), _jit(RL.swiglu)(rh, r), dtype, "swiglu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_matches_reference(name, dtype):
    rcfg = ATTN_CFGS[name]().scaled(dtype=dtype)
    pcfg = _pcfg(rcfg)
    rng = np.random.default_rng(1)
    rp, pp = _attn_params(rng, rcfg, dtype)
    S = 12
    rx, px = _both(_rand(rng, (B, S, rcfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    for mode in ("causal", "causal_window"):
        want = _jit(RL.attention, cfg=rcfg, mask_mode=mode)(
            rx, rp, positions=jnp.asarray(pos))
        _close(PL.attention(px, pp, pcfg, torch.from_numpy(pos.copy()), mode),
               want, dtype, mode)
    pos3 = rng.integers(0, 40, (3, B, S)).astype(np.int32)
    vl = rcfg.scaled(mrope_sections=(4, 2, 2))
    want = _jit(RL.attention, cfg=vl, positions=None, mask_mode="causal")(
        rx, rp, mrope_positions=jnp.asarray(pos3))
    _close(PL.attention(px, pp, _pcfg(vl), None, "causal",
                        torch.from_numpy(pos3)), want, dtype, "mrope")


DECODE_CASES = {  # (config, cache mode)
    "linear": ("qk_norm", "linear"),
    "linear_bias": ("qkv_bias", "linear"),
    "ring": ("window", "ring"),
    "repeated_kv": ("qk_norm", "repeated"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_attention_decode_matches_reference(case, dtype):
    name, mode = DECODE_CASES[case]
    rcfg = ATTN_CFGS[name]().scaled(dtype=dtype)
    if mode == "repeated":
        rcfg = rcfg.scaled(cache_repeated_kv=True)
    pcfg = _pcfg(rcfg)
    rng = np.random.default_rng(2)
    rp, pp = _attn_params(rng, rcfg, dtype)
    heads = rcfg.n_heads if mode == "repeated" else rcfg.n_kv_heads
    s_cache = rcfg.sliding_window if mode == "ring" else 20
    ck = _rand(rng, (B, s_cache, heads, rcfg.hd))
    cv = _rand(rng, (B, s_cache, heads, rcfg.hd))
    cache_pos = None
    steps = (13, 14, 15) if mode == "ring" else (9, 10, 19)
    if mode == "ring":  # slots hold positions 8..12; slot 3 empty
        cache_pos = np.array([10, 11, 12, -1, 8], np.int32)
    rk, pk = _both(ck, dtype)
    rv, pv = _both(cv, dtype)
    rcp = None if cache_pos is None else jnp.asarray(cache_pos)
    pcp = None if cache_pos is None else torch.from_numpy(cache_pos.copy())
    for pos in steps:
        rx, px = _both(_rand(rng, (B, 1, rcfg.d_model)), dtype)
        r_out, rk, rv, rcp = _jit(RL.attention_decode, cfg=rcfg)(
            rx, rp, cache_k=rk, cache_v=rv, pos=jnp.asarray(pos, jnp.int32),
            cache_pos=rcp)
        p_out, pk, pv, pcp = PL.attention_decode(
            px, pp, pcfg, pk, pv, pos, cache_pos=pcp)
        _close(p_out, r_out, dtype, f"out at {pos}")
        _close(pk, rk, dtype, f"k at {pos}")
        _close(pv, rv, dtype, f"v at {pos}")
        if rcp is not None:
            np.testing.assert_array_equal(pcp.numpy(), np.asarray(rcp))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

MODEL_CFGS = {
    "qwen3_1_7b": lambda: RC.get_smoke_config("qwen3_1_7b"),
    "qwen2_7b": lambda: RC.get_smoke_config("qwen2_7b"),
    "qwen2_vl_7b": lambda: RC.get_smoke_config("qwen2_vl_7b"),
    "musicgen_large": lambda: RC.get_smoke_config("musicgen_large"),
    "window8": lambda: RC.get_smoke_config("qwen3_1_7b").scaled(
        sliding_window=8),
}


def _ref_params(rcfg, seed=0):
    """The reference's initial parameters as numpy, with the biases
    and norm scales perturbed (the reference starts them at 0 / 1)."""
    params = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(
        seed)))
    rng = np.random.default_rng(seed)
    layers = params["layers"]
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in layers["attn"]:
            a = layers["attn"][key]
            base = 0.0 if key.startswith("b") else 1.0
            layers["attn"][key] = base + _rand(rng, a.shape, 0.1)
    for key in ("norm1", "norm2"):
        layers[key] = 1 + _rand(rng, layers[key].shape, 0.1)
    params["final_norm"] = 1 + _rand(rng, params["final_norm"].shape, 0.1)
    return params


def _setup(name, dtype):
    rcfg = MODEL_CFGS[name]().scaled(dtype=dtype)
    pcfg = _pcfg(rcfg)
    params = _ref_params(rcfg)
    rparams = jax.tree.map(jnp.asarray, params)
    model = params_from_reference(pcfg, params, "cpu")
    return rcfg, pcfg, rparams, model


def _batch(cfg, S, seed=3, text=False):
    """numpy inputs: tokens or embeds, and M-RoPE streams for the VLM
    (three distinct streams, or with ``text`` the one position stream of
    text tokens, which decode assumes)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "embeds":
        out["embeds"] = _rand(rng, (B, S, cfg.d_model))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.family == "vlm":
        t = np.arange(S, dtype=np.int32)
        streams = (t, t, t) if text else (t, t // 3, t % 5)
        out["mrope_positions"] = np.stack(
            [np.broadcast_to(x, (B, S)) for x in streams]).astype(np.int32)
    return out


def _slice(batch, hi):
    return {k: v[..., :hi] if k == "mrope_positions" else v[:, :hi]
            for k, v in batch.items()}


def _to(batch, side):
    conv = jnp.asarray if side == "ref" else (
        lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return {k: conv(v) for k, v in batch.items()}


def _step_input(cfg, batch, i, side):
    key = "embeds" if cfg.input_kind == "embeds" else "tokens"
    x = np.ascontiguousarray(batch[key][:, i:i + 1])
    return jnp.asarray(x) if side == "ref" else torch.from_numpy(x)


def _ref_fns(rcfg, s_max):
    return (_jit(RM.forward, cfg=rcfg),
            _jit(RM.prefill, cfg=rcfg, s_max=s_max),
            _jit(RM.decode_step, cfg=rcfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODEL_CFGS))
def test_model_matches_reference(name, dtype):
    rcfg, pcfg, rparams, model = _setup(name, dtype)
    S, s_max = 16, 20
    batch = _batch(rcfg, S)
    r_fwd, r_pre, r_dec = _ref_fns(rcfg, s_max)
    with torch.inference_mode():
        _close(PM.forward(model, pcfg, _to(batch, "port")),
               r_fwd(rparams, batch=_to(batch, "ref")), dtype, "forward")
        prompt = _slice(batch, S - 2)
        r_logits, r_cache = r_pre(rparams, batch=_to(prompt, "ref"))
        p_logits, p_cache = PM.prefill(model, pcfg, _to(prompt, "port"),
                                       s_max=s_max)
        assert p_logits.dtype == torch.float32
        assert p_logits.shape == (B, rcfg.vocab_size)
        _close(p_logits, r_logits, dtype, "prefill logits")
        assert set(p_cache) == set(r_cache)
        for key in r_cache:
            _close(p_cache[key], r_cache[key], dtype, f"prefill cache {key}")
        for i in (S - 2, S - 1):  # two decode steps on the prefilled cache
            r_logits, r_cache = r_dec(rparams, tokens=_step_input(
                rcfg, batch, i, "ref"), cache=r_cache,
                pos=jnp.asarray(i, jnp.int32))
            p_logits, p_cache = PM.decode_step(
                model, pcfg, _step_input(rcfg, batch, i, "port"), p_cache, i)
            _close(p_logits, r_logits, dtype, f"decode logits at {i}")
            for key in r_cache:
                _close(p_cache[key], r_cache[key], dtype,
                       f"cache {key} at {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_cache_decode_matches_reference(dtype):
    """window8 decoding from an empty ring cache (s_max 40 > window 8)
    past the window's wrap, step for step."""
    rcfg, pcfg, rparams, model = _setup("window8", dtype)
    r_cache = RM.init_cache(rcfg, B, 40)
    p_cache = PM.init_cache(pcfg, B, 40, device="cpu")
    assert p_cache["k"].shape == r_cache["k"].shape == (
        rcfg.n_layers, B, 8, rcfg.n_kv_heads, rcfg.hd)
    np.testing.assert_array_equal(p_cache["pos_ids"].numpy(),
                                  np.asarray(r_cache["pos_ids"]))
    batch = _batch(rcfg, 12)
    r_dec = _ref_fns(rcfg, 40)[2]
    with torch.inference_mode():
        for i in range(12):
            r_logits, r_cache = r_dec(rparams, tokens=_step_input(
                rcfg, batch, i, "ref"), cache=r_cache,
                pos=jnp.asarray(i, jnp.int32))
            p_logits, p_cache = PM.decode_step(
                model, pcfg, _step_input(rcfg, batch, i, "port"), p_cache, i)
            _close(p_logits, r_logits, dtype, f"logits at {i}")
        for key in r_cache:
            _close(p_cache[key], r_cache[key], dtype, key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8, 12])
def test_attention_chunked_matches_reference(window, dtype):
    """S = 32 over chunks of 8: every chunk against keys [lo, off + 8)."""
    rcfg = RC.get_smoke_config("qwen3_1_7b").scaled(
        dtype=dtype, sliding_window=window)
    pcfg = _pcfg(rcfg)
    rng = np.random.default_rng(4)
    rp, pp = _attn_params(rng, rcfg, dtype)
    S = 32
    rx, px = _both(_rand(rng, (B, S, rcfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    mode = "causal_window" if window else "causal"
    got = PM._attention_chunked(px, pp, pcfg, torch.from_numpy(pos), mode,
                                chunk=8)
    want = _jit(RM._attention_chunked, cfg=rcfg, mask_mode=mode, chunk=8)(
        rx, rp, positions=jnp.asarray(pos))
    _close(got, want, dtype)
    # one chunk covering S is plain attention
    want = _jit(RL.attention, cfg=rcfg, mask_mode=mode)(
        rx, rp, positions=jnp.asarray(pos))
    _close(PM._attention_chunked(px, pp, pcfg, torch.from_numpy(pos), mode,
                                 chunk=S), want, dtype)
    with pytest.raises(ValueError, match="chunk"):
        PM._attention_chunked(px, pp, pcfg, torch.from_numpy(pos), mode,
                              chunk=12)


# ---------------------------------------------------------------------------
# The port's own properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_1_7b", "qwen2_7b", "qwen2_vl_7b",
                                  "musicgen_large", "deepseek_coder_33b",
                                  "yi_34b"])
def test_prefill_decode_consistency(arch):
    """tests/test_models.py's property on the port: decode(token_n |
    prefill(prompt[:n])) agrees with prefill(prompt[:n+1]) -- within
    1e-4 in float32 and the reference's 0.05 in bfloat16."""
    S = 32
    for dtype, atol in (("float32", 1e-4), ("bfloat16", 0.05)):
        cfg = PC.get_smoke_config(arch).scaled(dtype=dtype)
        model = PM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        batch = _to(_batch(cfg, S, seed=5, text=True), "port")
        with torch.inference_mode():
            logits_a, cache = PM.prefill(model, cfg, _slice(batch, S - 1),
                                         s_max=S)
            logits_b, _ = PM.prefill(model, cfg, batch, s_max=S)
            key = "embeds" if cfg.input_kind == "embeds" else "tokens"
            step, _ = PM.decode_step(model, cfg, batch[key][:, S - 1:S],
                                     cache, S - 1)
        assert torch.isfinite(step).all()
        np.testing.assert_allclose(step.numpy(), logits_b.numpy(),
                                   rtol=atol, atol=atol, err_msg=dtype)


@pytest.mark.parametrize("name", sorted(MODEL_CFGS))
def test_params_round_trip_exactly(name):
    rcfg = MODEL_CFGS[name]()
    params = _ref_params(rcfg, seed=7)
    model = params_from_reference(_pcfg(rcfg), params, "cpu")
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the compute copies are the masters cast once
    assert model.compute["embed"].dtype == torch.bfloat16
    torch.testing.assert_close(model.blocks[1].attn.p.wq,
                               model.blocks[1].attn.wq.to(torch.bfloat16),
                               rtol=0, atol=0)
    extra = dict(params, junk=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="junk"):
        params_from_reference(_pcfg(rcfg), extra, "cpu")


def test_init_params_draws_the_reference_distributions():
    cfg = PC.get_smoke_config("qwen2_7b").scaled(n_layers=4)
    model = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = params_to_numpy(model)
    d, ff, Lc = cfg.d_model, cfg.d_ff, cfg.n_layers
    hh = cfg.n_heads * cfg.hd
    for arr, std in ((p["embed"], 0.02), (p["lm_head"], d ** -0.5),
                     (p["layers"]["attn"]["wq"], d ** -0.5),
                     (p["layers"]["attn"]["wo"], (hh * Lc) ** -0.5),
                     (p["layers"]["mlp"]["w_down"], (ff * Lc) ** -0.5)):
        assert abs(arr.mean()) < 0.1 * std
        assert abs(arr.std() / std - 1) < 0.05
    assert (p["layers"]["attn"]["bq"] == 0).all()
    assert (p["layers"]["norm1"] == 1).all() and (p["final_norm"] == 1).all()
    again = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_array_equal(params_to_numpy(again)["embed"], p["embed"])


def test_entry_points_default_to_the_card():
    cfg = PC.get_smoke_config("qwen3_1_7b")
    if torch.cuda.is_available():
        gen = torch.Generator("cuda").manual_seed(0)
        assert PM.init_params(cfg, gen).device.type == "cuda"
        assert PM.init_cache(cfg, 1, 8)["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(cfg, {})


def test_model_refuses_another_config():
    cfg = PC.get_smoke_config("qwen3_1_7b")
    model = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="cfg differs"):
        PM.prefill(model, cfg.scaled(dtype="float32"), {"tokens": toks})
    # moving the model re-makes its compute copies on the new device
    moved = model.to("cpu")
    assert moved.compute["embed"].dtype == torch.bfloat16

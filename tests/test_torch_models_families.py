"""Parity of the port's MoE, hybrid (attention + SSM) and xLSTM families
(``repro_torch.models``) with the reference's, at smoke sizes on the
CPU.

Every layer function (``moe_ffn``, ``_ssm_scan``, ``ssm_block`` with
its decode hand-off state, ``ssm_decode``, ``mlstm_block`` whole and
in row chunks with its final state, ``mlstm_decode``, ``slstm_scan``)
and the model's ``forward`` / ``prefill`` / ``decode_step`` on the four
smoke configs (granite-moe, mixtral, hymba, xlstm) take the same numpy
inputs on both sides -- the reference's weights carried across by
``params_from_reference``, with the norm scales, ``d_skip``,
``dt_bias`` and the hybrid's ``mix`` perturbed away from their
ones / zeros so that those paths count -- and must agree within rtol
1e-5 / atol 1e-5 in float32 and rtol 0.05 / atol 0.05 in bfloat16
(tests/test_torch_models.py's ``TOL``).  The reference runs on the
CPU, jitted.

MoE routing flips.  A token's expert choice is discrete: where the
reference's K-th and (K+1)-th gates lie within a rounding of each
other, a bf16 rounding anywhere upstream (the router's product, or the
hidden state a layer earlier) can pick the other expert on one side
and move that token's output by far more than 0.05.  Both sides report
every MoE call's routing (the reference through ``jax.debug.callback``
inside its jitted run, the port through a hook on each ``MoE``
module).  A token whose expert set differs must have a reference gap
between its K-th and (K+1)-th gate of at most ``FLIP_ULPS`` bf16 ulps
of the K-th gate -- asserted -- and only such tokens are left out of
the bf16 comparison (their rows of the hidden states and of K / V, and
the logits of a sequence whose last token flipped).  In float32 no
token may flip and every token is compared.
"""

import contextlib
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
FLIP_ULPS = 4  # the widest reference gate gap a bf16 routing flip may have
FAMILY_ARCHS = ["granite_moe_1b_a400m", "mixtral_8x22b", "hymba_1_5b",
                "xlstm_350m"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jit(fn, **static):
    """The reference's ``fn`` jitted with ``static`` bound."""
    return jax.jit(functools.partial(fn, **static))


def _close(port, ref, dtype, what="", keep=None):
    """assert_allclose under ``TOL``; ``keep`` (a boolean mask over the
    leading axes) restricts the comparison to those rows."""
    p, r = _np(port), _np(ref)
    if keep is not None:
        p, r = p[keep], r[keep]
    np.testing.assert_allclose(p, r, err_msg=what, **TOL[dtype])


def _close_norm(port, ref, what=""):
    """The bf16 comparison of a state whose elements carry errors of
    their largest terms: the error's norm within 0.05 of the state's."""
    p, r = _np(port), _np(ref)
    err = np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-30)
    assert err <= TOL["bfloat16"]["rtol"], (what, err)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(
        np.ascontiguousarray(x)).to(TDT[dtype])


def _pcfg(rcfg):
    return P_cfg.ModelConfig(**dataclasses.asdict(rcfg))


def _params(named, dtype, nt_ref, nt_port):
    """Reference and port parameter tuples of numpy arrays ``named``."""
    return (nt_ref(**{k: _both(a, dtype)[0] for k, a in named.items()}),
            nt_port(**{k: _both(a, dtype)[1] for k, a in named.items()}))


# ---------------------------------------------------------------------------
# Routing records and bf16 flips
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """The bf16 spacing at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


@contextlib.contextmanager
def _reference_routes():
    """Patch the reference's ``moe_ffn`` so that a run traced inside the
    block reports each call's float32 gates (T, E), in call order.
    Jitted functions traced here are not cached."""
    calls = []
    orig = RL.moe_ffn

    def moe_ffn(x, p, cfg):
        T, d = x.shape[0] * x.shape[1], x.shape[2]
        G = RL._pick_groups(T)
        logits = jnp.einsum("gsd,de->gse", x.reshape(G, T // G, d), p.router)
        gates = jax.nn.softmax(logits.astype(jnp.float32), -1)
        jax.debug.callback(
            lambda g: calls.append(np.asarray(g).reshape(T, -1)), gates,
            ordered=True)
        return orig(x, p, cfg)

    RL.moe_ffn = moe_ffn
    try:
        yield calls
    finally:
        RL.moe_ffn = orig


@contextlib.contextmanager
def _port_routes(mods):
    """Record the port's expert ids (T, K) of each call of the ``MoE``
    modules ``mods``, in call order."""
    calls = []

    def hook(mod, args):
        x = args[0]
        T, d = x.shape[0] * x.shape[1], x.shape[2]
        G = PL._pick_groups(T)
        _, idx = PL.moe_route(x.reshape(G, T // G, d), mod.p.router, mod.cfg)
        calls.append(idx.reshape(T, -1).numpy())

    handles = [m.register_forward_pre_hook(hook) for m in mods]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def _flips(ref_calls, port_calls, K, dtype, S):
    """(b, s) of every token whose expert set differs between the two
    sides in any call, after asserting that each lies within
    ``FLIP_ULPS`` of a tie in the reference (none in float32)."""
    assert len(ref_calls) == len(port_calls)
    out = set()
    for gates, idx in zip(ref_calls, port_calls):
        order = np.argsort(-gates, axis=-1, kind="stable")
        differ = np.nonzero((np.sort(order[:, :K], -1)
                             != np.sort(idx, -1)).any(-1))[0]
        for t in differ:
            assert dtype == "bfloat16", ("a float32 routing flip", t)
            g = np.sort(gates[t])[::-1]
            gap = (g[K - 1] - g[K]) / _bf16_ulp(g[K - 1])
            assert gap <= FLIP_ULPS, (t, g, gap)
            out.add((t // S, t % S))
    return out


def _rows_kept(flipped, lead):
    """A boolean mask over (B, S) leading axes without the flipped
    tokens."""
    keep = np.ones(lead, bool)
    for b, s in flipped:
        if s < lead[1]:
            keep[b, s] = False
    return keep


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(rng, cfg, dtype):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    named = {"router": _rand(rng, (d, E), d ** -0.5),
             "w_gate": _rand(rng, (E, d, ff), d ** -0.5),
             "w_up": _rand(rng, (E, d, ff), d ** -0.5),
             "w_down": _rand(rng, (E, ff, d), ff ** -0.5)}
    return named, _params(named, dtype, RL.MoeParams, PL.MoeParams)


MOE_CASES = {  # sequence length, capacity factor
    "small": (16, 1.25),
    "drops": (256, 0.25),     # C = 128 < the ~256 choices per expert
    "groups": (8192, 1.25),   # T = 16,384: two GShard groups
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case, dtype):
    S, cf = MOE_CASES[case]
    rcfg = RC.get_smoke_config("granite_moe_1b_a400m").scaled(
        dtype=dtype, moe_capacity_factor=cf)
    pcfg = _pcfg(rcfg)
    rng = np.random.default_rng(10)
    named, (rp, pp) = _moe_params(rng, rcfg, dtype)
    rx, px = _both(_rand(rng, (B, S, rcfg.d_model)), dtype)
    with _reference_routes() as r_calls:
        want = jax.jit(functools.partial(RL.moe_ffn, cfg=rcfg))(rx, rp)
        jax.effects_barrier()
    mod = PL.MoE(pcfg, torch.float32, "cpu")
    with torch.no_grad():
        for k, a in named.items():
            getattr(mod, k).copy_(torch.from_numpy(a))
    mod.cast_(TDT[dtype])
    with _port_routes([mod]) as p_calls:
        got = mod(px)
    flipped = _flips(r_calls, p_calls, rcfg.experts_per_token, dtype, S)
    _close(got, want, dtype, case, _rows_kept(flipped, (B, S)))
    # the groups and the capacity are the reference's; only "drops"
    # sends an expert more choices than its capacity
    T = B * S
    G = PL._pick_groups(T)
    C = PL.moe_capacity(pcfg, T // G)
    assert G == RL._pick_groups(T) == (2 if case == "groups" else 1)
    assert C % 128 == 0
    counts = [np.bincount(ids.ravel(), minlength=rcfg.n_experts)
              for ids in p_calls[0].reshape(G, -1)]
    assert (np.max(counts) > C) == (case == "drops"), (counts, C)
    assert torch.isfinite(got).all()


def test_moe_top_k_keeps_the_lower_expert_on_ties():
    """Two equal router columns give equal gates: ``jax.lax.top_k``
    keeps the lower expert id, and so must the port (a stable
    descending sort; ``torch.topk`` promises no order on ties)."""
    rcfg = RC.get_smoke_config("granite_moe_1b_a400m").scaled(
        dtype="float32", n_experts=8, experts_per_token=3)
    pcfg = _pcfg(rcfg)
    rng = np.random.default_rng(11)
    named, _ = _moe_params(rng, rcfg, "float32")
    router = named["router"]
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 1]
    rp, pp = _params(named, "float32", RL.MoeParams, PL.MoeParams)
    rx, px = _both(_rand(rng, (B, 24, rcfg.d_model)), "float32")
    xg = px.reshape(1, B * 24, -1)
    gates = torch.softmax((xg @ pp.router).float(), -1)
    assert torch.equal(gates[..., 5], gates[..., 2])
    _, idx = PL.moe_route(xg, pp.router, pcfg)
    _, want = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    # the tie is met: some token keeps 2 (or 1) and not its twin
    picked = idx.numpy()
    assert ((picked == 2).any(-1) & ~(picked == 5).any(-1)).any()
    assert not ((picked == 5).any(-1) & ~(picked == 2).any(-1)).any()
    # many tied rows: the sort is stable on every one
    tied = torch.from_numpy(np.round(rng.random((64, 8)), 1).astype(
        np.float32))
    v, i = PL._top_k(tied, 3)
    rv, ri = jax.lax.top_k(jnp.asarray(tied.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    _close(PL.moe_ffn(px, pp, pcfg),
           _jit(RL.moe_ffn, cfg=rcfg)(rx, rp), "float32")


# ---------------------------------------------------------------------------
# Selective SSM
# ---------------------------------------------------------------------------

def _ssm_params(rng, cfg, dtype):
    d, N, k = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    d_in = d * cfg.ssm_expand
    named = {"w_in": _rand(rng, (d, 2 * d_in), d ** -0.5),
             "conv_w": _rand(rng, (k, d_in), k ** -0.5),
             "w_bcdt": _rand(rng, (d_in, 2 * N + 1), d_in ** -0.5),
             "a_log": np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                             (d_in, N))).astype(np.float32)
             + _rand(rng, (d_in, N), 0.1),
             "d_skip": 1 + _rand(rng, (d_in,), 0.1),
             "dt_bias": _rand(rng, (d_in,), 0.5),
             "w_out": _rand(rng, (d_in, d), d_in ** -0.5)}
    return _params(named, dtype, RL.SsmParams, PL.SsmParams)


def _hymba(dtype):
    rcfg = RC.get_smoke_config("hymba_1_5b").scaled(dtype=dtype)
    return rcfg, _pcfg(rcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2, 16, 37])
def test_ssm_scan_matches_reference(L, dtype):
    """The associative scan's odd / even recursion at lengths that are
    and are not powers of two."""
    rng = np.random.default_rng(12)
    d_in, N = 24, 4
    u = _rand(rng, (B, L, d_in))
    dt = np.log1p(np.exp(_rand(rng, (B, L, d_in))))
    A = -np.exp(_rand(rng, (d_in, N), 0.5))
    Bm, Cm = _rand(rng, (B, L, N)), _rand(rng, (B, L, N))
    args = [_both(a, dtype) for a in (u, dt, A, Bm, Cm)]
    want = _jit(RL._ssm_scan)(*(a[0] for a in args))
    _close(PL._ssm_scan(*(a[1] for a in args)), want, dtype, f"L={L}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_matches_reference(dtype):
    rcfg, pcfg = _hymba(dtype)
    rng = np.random.default_rng(13)
    rp, pp = _ssm_params(rng, rcfg, dtype)
    rx, px = _both(_rand(rng, (B, 37, rcfg.d_model)), dtype)
    _close(PL.ssm_block(px, pp, pcfg), _jit(RL.ssm_block, cfg=rcfg)(rx, rp),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 37])
def test_ssm_state_matches_reference(S, dtype):
    """The prefill hand-off against the reference's ``_ssm_with_state``:
    at S = 2 < k - 1 = 3 the conv state starts with a zero row."""
    rcfg, pcfg = _hymba(dtype)
    assert rcfg.ssm_conv == 4
    rng = np.random.default_rng(14)
    rp, pp = _ssm_params(rng, rcfg, dtype)
    rx, px = _both(_rand(rng, (B, S, rcfg.d_model)), dtype)
    r_out, (r_h, r_conv) = _jit(RM._ssm_with_state, cfg=rcfg)(rx, rp)
    p_out, (p_h, p_conv) = PL.ssm_block(px, pp, pcfg, with_state=True)
    assert p_h.dtype == torch.float32 and p_conv.dtype == TDT[dtype]
    assert p_conv.shape == r_conv.shape == (B, 3, rcfg.d_model)
    _close(p_out, r_out, dtype, "out")
    _close(p_h, r_h, dtype, "h_last")
    _close(p_conv, r_conv, dtype, "conv_last")
    if S == 2:
        assert (p_conv[:, 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_reference(dtype):
    rcfg, pcfg = _hymba(dtype)
    rng = np.random.default_rng(15)
    rp, pp = _ssm_params(rng, rcfg, dtype)
    d_in, N = rcfg.d_model, rcfg.ssm_state
    rh, ph = _both(_rand(rng, (B, d_in, N)), "float32")
    rc, pc = _both(_rand(rng, (B, 3, d_in)), dtype)
    step = _jit(RL.ssm_decode, cfg=rcfg)
    for i in range(3):
        rx, px = _both(_rand(rng, (B, 1, rcfg.d_model)), dtype)
        r_out, rh, rc = step(rx, rp, h_state=rh, conv_state=rc)
        p_out, ph, pc = PL.ssm_decode(px, pp, pcfg, ph, pc)
        assert ph.dtype == torch.float32
        _close(p_out, r_out, dtype, f"out {i}")
        _close(ph, rh, dtype, f"h {i}")
        _close(pc, rc, dtype, f"conv {i}")


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _xlstm(dtype):
    rcfg = RC.get_smoke_config("xlstm_350m").scaled(dtype=dtype)
    return rcfg, _pcfg(rcfg)


def _mlstm_params(rng, cfg, dtype):
    d, H = cfg.d_model, cfg.n_heads
    d_in = 2 * d
    named = {"w_up": _rand(rng, (d, 2 * d_in), d ** -0.5),
             "wq": _rand(rng, (d_in, d_in), d_in ** -0.5),
             "wk": _rand(rng, (d_in, d_in), d_in ** -0.5),
             "wv": _rand(rng, (d_in, d_in), d_in ** -0.5),
             "w_if": _rand(rng, (d_in, 2 * H), d_in ** -0.5),
             "ln": 1 + _rand(rng, (d_in,), 0.1),
             "w_down": _rand(rng, (d_in, d), d_in ** -0.5)}
    return _params(named, dtype, RL.MlstmParams, PL.MlstmParams)


def _slstm_params(rng, cfg, dtype):
    d, H = cfg.d_model, cfg.n_heads
    hd, ff = d // H, PL.slstm_ff(d)
    named = {"w_gates": _rand(rng, (d, 4 * d), d ** -0.5),
             "r_gates": _rand(rng, (H, 4 * hd, hd), (4 * hd) ** -0.5),
             "w_up": _rand(rng, (d, ff), d ** -0.5),
             "w_down": _rand(rng, (ff, d), ff ** -0.5),
             "ln": 1 + _rand(rng, (d,), 0.1)}
    return _params(named, dtype, RL.SlstmParams, PL.SlstmParams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row_chunk", [1024, 8])
def test_mlstm_block_matches_reference(row_chunk, dtype):
    """The parallel form whole (L <= row_chunk) and in four row chunks
    of 8, and its final (C, n, m) state against the reference's
    ``_mlstm_final_state``."""
    rcfg, pcfg = _xlstm(dtype)
    rng = np.random.default_rng(16)
    rp, pp = _mlstm_params(rng, rcfg, dtype)
    rx, px = _both(_rand(rng, (B, 32, rcfg.d_model)), dtype)
    want = _jit(RL.mlstm_block, cfg=rcfg, row_chunk=row_chunk)(rx, rp)
    out, state = PL.mlstm_block(px, pp, pcfg, row_chunk=row_chunk,
                                with_state=True)
    _close(out, want, dtype, "out")
    _close(PL.mlstm_block(px, pp, pcfg, row_chunk=row_chunk), want, dtype)
    r_state = _jit(RM._mlstm_final_state, cfg=rcfg)(rx, rp)
    for name, a, b in zip("Cnm", state, r_state):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _close(a, b, dtype, name)
    with pytest.raises(ValueError, match="row chunk"):
        PL.mlstm_block(px, pp, pcfg, row_chunk=12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_matches_reference(dtype):
    rcfg, pcfg = _xlstm(dtype)
    rng = np.random.default_rng(17)
    rp, pp = _mlstm_params(rng, rcfg, dtype)
    H, hd = rcfg.n_heads, 2 * rcfg.d_model // rcfg.n_heads
    rC, pC = _both(_rand(rng, (B, H, hd, hd), 0.3), "float32")
    rn, pn = _both(_rand(rng, (B, H, hd), 0.3), "float32")
    rm, pm = _both(_rand(rng, (B, H)), "float32")
    step = _jit(RL.mlstm_decode, cfg=rcfg)
    for i in range(3):
        rx, px = _both(_rand(rng, (B, 1, rcfg.d_model)), dtype)
        r_out, rC, rn, rm = step(rx, rp, C=rC, n=rn, m_state=rm)
        p_out, pC, pn, pm = PL.mlstm_decode(px, pp, pcfg, pC, pn, pm)
        _close(p_out, r_out, dtype, f"out {i}")
        for name, a, b in (("C", pC, rC), ("n", pn, rn), ("m", pm, rm)):
            assert a.dtype == torch.float32
            _close(a, b, dtype, f"{name} {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_slstm_scan_matches_reference(carried, dtype):
    rcfg, pcfg = _xlstm(dtype)
    rng = np.random.default_rng(18)
    rp, pp = _slstm_params(rng, rcfg, dtype)
    H, hd = rcfg.n_heads, rcfg.d_model // rcfg.n_heads
    rx, px = _both(_rand(rng, (B, 11, rcfg.d_model)), dtype)
    r_state = p_state = (None,) * 4
    if carried:
        pairs = [_both(_rand(rng, s, 0.5), "float32")
                 for s in ((B, H, hd),) * 3 + ((B, H),)]
        pairs[2] = _both(np.abs(_rand(rng, (B, H, hd))) + 0.5, "float32")
        r_state = tuple(a for a, _ in pairs)
        p_state = tuple(b for _, b in pairs)
    r_out, r_fin = _jit(RL.slstm_scan, cfg=rcfg)(
        rx, rp, **dict(zip(("h0", "c0", "n0", "m0"), r_state)))
    p_out, p_fin = PL.slstm_scan(px, pp, pcfg, *p_state)
    _close(p_out, r_out, dtype, "out")
    for name, a, b in zip("hcnm", p_fin, r_fin):
        assert a.dtype == torch.float32
        _close(a, b, dtype, name)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _ref_params(rcfg, seed=0):
    """The reference's initial parameters as numpy, with every norm
    scale, ``d_skip``, ``dt_bias`` and ``mix`` perturbed (the reference
    starts them at 1 / 0)."""
    params = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(
        seed)))
    rng = np.random.default_rng(seed)
    layers = params["layers"]

    def nudge(tree, key, base):
        tree[key] = base + _rand(rng, tree[key].shape, 0.1)

    for key in ("norm1", "norm2"):
        nudge(layers, key, 1.0)
    if "ssm" in layers:
        nudge(layers["ssm"], "d_skip", 1.0)
        nudge(layers["ssm"], "dt_bias", 0.0)
        layers["mix"] = _rand(rng, layers["mix"].shape, 0.5)
    for sub in ("mlstm", "slstm"):
        if sub in layers:
            nudge(layers[sub], "ln", 1.0)
    params["final_norm"] = 1 + _rand(rng, params["final_norm"].shape, 0.1)
    return params


def _tokens(cfg, S, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _setup(arch, dtype):
    rcfg = RC.get_smoke_config(arch).scaled(dtype=dtype)
    pcfg = _pcfg(rcfg)
    params = _ref_params(rcfg)
    return (rcfg, pcfg, jax.tree.map(jnp.asarray, params),
            params_from_reference(pcfg, params, "cpu"))


def _ref_run(rcfg, fn, *args, static=None, **kw):
    """The reference's ``fn`` jitted (``static`` bound), with its
    routing recorded for a MoE config (traced anew) or from the cache
    otherwise."""
    static = dict(static or {}, cfg=rcfg)
    if rcfg.family != "moe":
        return _jit(fn, **static)(*args, **kw), []
    with _reference_routes() as calls:
        out = jax.jit(functools.partial(fn, **static))(*args, **kw)
        jax.effects_barrier()
    return out, calls


def _port_run(model, fn, *args):
    mods = [b.moe for b in model.blocks if getattr(b, "moe", None) is not None]
    with _port_routes(mods) as calls:
        out = fn(model, *args)
    return out, calls


NORM_STATES = ("slstm_c", "slstm_n")


def _close_cache(key, port, ref, dtype, what, flipped):
    """One cache tensor under ``TOL`` (K / V without the flipped tokens'
    rows), or for the sLSTM's float32 cell and normaliser in bf16 by
    norm (see ``test_model_matches_reference``)."""
    if dtype == "bfloat16" and key in NORM_STATES:
        _close_norm(port, ref, what)
    else:
        _close(port, ref, dtype, what, _cache_keep(key, port, flipped))


def _cache_keep(key, cache_val, flipped):
    """Rows of a cache tensor to compare: K / V drop the flipped tokens'
    positions (on every layer); the recurrent states have none."""
    if key not in ("k", "v"):
        return None
    shape = cache_val.shape
    keep = _rows_kept(flipped, (shape[1], shape[2]))
    return np.broadcast_to(keep, (shape[0],) + keep.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_matches_reference(arch, dtype):
    """forward, prefill (logits and every cache tensor) and two decode
    steps.  In bf16 the reference runs with XLA's excess precision (a
    bf16 product immediately cast to float32 is not rounded), the port
    in true bf16: the sLSTM's exponential input gate turns those
    one-ulp differences in its gate inputs into ~3% of its float32 cell
    c and normaliser n, which breaks an elementwise atol where c's
    terms cancel, so in bf16 those two are held by norm (the error's
    norm within 0.05 of the state's); float32 holds them element by
    element."""
    rcfg, pcfg, rparams, model = _setup(arch, dtype)
    S, s_max = 16, 20
    K = rcfg.experts_per_token
    toks = _tokens(rcfg, S)
    rt, pt = jnp.asarray(toks), torch.from_numpy(toks)
    with torch.inference_mode():
        want, r_calls = _ref_run(rcfg, RM.forward, rparams,
                                 batch={"tokens": rt})
        got, p_calls = _port_run(model, PM.forward, pcfg, {"tokens": pt})
        flipped = _flips(r_calls, p_calls, K, dtype, S)
        _close(got, want, dtype, "forward", _rows_kept(flipped, (B, S)))

        n = S - 2
        (r_logits, r_cache), r_calls = _ref_run(
            rcfg, RM.prefill, rparams, batch={"tokens": rt[:, :n]},
            static=dict(s_max=s_max))
        (p_logits, p_cache), p_calls = _port_run(
            model, PM.prefill, pcfg, {"tokens": pt[:, :n]}, s_max)
        flipped = _flips(r_calls, p_calls, K, dtype, n)
        assert p_logits.dtype == torch.float32
        assert set(p_cache) == set(r_cache)
        last = ~_rows_kept(flipped, (B, n))[:, -1]
        _close(p_logits, r_logits, dtype, "prefill logits", ~last)
        for key in r_cache:
            assert p_cache[key].shape == r_cache[key].shape, key
            assert p_cache[key].dtype == TDT[str(r_cache[key].dtype)], key
            _close_cache(key, p_cache[key], r_cache[key], dtype,
                         f"prefill {key}", flipped)
        for i in (n, n + 1):  # two decode steps on the prefilled cache
            (r_logits, r_cache), r_calls = _ref_run(
                rcfg, RM.decode_step, rparams, tokens=rt[:, i:i + 1],
                cache=r_cache, pos=jnp.asarray(i, jnp.int32))
            (p_logits, p_cache), p_calls = _port_run(
                model, PM.decode_step, pcfg, pt[:, i:i + 1], p_cache, i)
            step = {(b, i) for b, _ in _flips(r_calls, p_calls, K, dtype, 1)}
            flipped |= step
            _close(p_logits, r_logits, dtype, f"decode logits at {i}",
                   np.array([(b, i) not in step for b in range(B)]))
            for key in r_cache:
                _close_cache(key, p_cache[key], r_cache[key], dtype,
                             f"{key} at {i}", flipped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_ring_decode_matches_reference(dtype):
    """hymba's smoke config (window 16) decoding 24 tokens from an empty
    ring cache (s_max 64 > 16), past the ring's wrap: attention on the
    ring and the SSM states on every step.  The logits are compared at
    every step and the cache after the last.  In bf16 the ring's K / V
    are held by norm (``_close_norm``): after 24 chained steps a K
    element is a RoPE rotation of components near 8, whose one-ulp
    (0.0625) differences (XLA keeps excess precision inside its
    fusions, the port rounds) do not cancel to within 0.05 where the
    rotation does; float32 holds them element by element."""
    rcfg, pcfg, rparams, model = _setup("hymba_1_5b", dtype)
    r_cache = RM.init_cache(rcfg, B, 64)
    p_cache = PM.init_cache(pcfg, B, 64, device="cpu")
    assert "pos_ids" in p_cache and p_cache["k"].shape[2] == 16
    toks = _tokens(rcfg, 24, seed=4)
    step = _jit(RM.decode_step, cfg=rcfg)
    with torch.inference_mode():
        for i in range(24):
            r_logits, r_cache = step(rparams, tokens=jnp.asarray(
                toks[:, i:i + 1]), cache=r_cache,
                pos=jnp.asarray(i, jnp.int32))
            p_logits, p_cache = PM.decode_step(
                model, pcfg, torch.from_numpy(toks[:, i:i + 1]), p_cache, i)
            _close(p_logits, r_logits, dtype, f"logits at {i}")
    assert set(p_cache) == set(r_cache)
    for key in r_cache:
        if dtype == "bfloat16" and key in ("k", "v"):
            _close_norm(p_cache[key], r_cache[key], key)
        else:
            _close(p_cache[key], r_cache[key], dtype, key)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_cache_matches_reference(arch):
    rcfg = RC.get_smoke_config(arch)
    pcfg = _pcfg(rcfg)
    for s_max in (24, 200):  # 200 > mixtral's and hymba's window: a ring
        want = RM.init_cache(rcfg, 3, s_max)
        got = PM.init_cache(pcfg, 3, s_max, device="cpu")
        assert set(got) == set(want)
        for key in want:
            assert got[key].shape == want[key].shape, key
            assert got[key].dtype == TDT.get(str(want[key].dtype),
                                             torch.int32), key
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          _np(want[key]))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_params_round_trip_exactly(arch):
    """Every config's reference tree (smoke size) crosses and comes back
    bit for bit: the moe / ssm / mix subtrees and xLSTM's pair-stacked
    mlstm / slstm / norms included."""
    rcfg = RC.get_smoke_config(arch)
    params = _ref_params(rcfg, seed=7)
    model = params_from_reference(_pcfg(rcfg), params, "cpu")
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    missing = dict(params, layers=dict(params["layers"]))
    missing["layers"].pop("norm2")
    with pytest.raises(ValueError, match="norm2"):
        params_from_reference(_pcfg(rcfg), missing, "cpu")


def _std_ok(arr, std):
    assert abs(arr.mean()) < 0.1 * std, (arr.mean(), std)
    assert abs(arr.std() / std - 1) < 0.05, (arr.std(), std)


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm"])
def test_init_params_draws_the_reference_distributions(family):
    arch = {"moe": "granite_moe_1b_a400m", "hybrid": "hymba_1_5b",
            "ssm": "xlstm_350m"}[family]
    cfg = PC.get_smoke_config(arch).scaled(n_layers=4)
    model = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = params_to_numpy(model)
    ref = jax.eval_shape(lambda: RM.init_params(
        RC.get_smoke_config(arch).scaled(n_layers=4), jax.random.PRNGKey(0)))
    assert jax.tree.structure(p) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    lay = p["layers"]
    d, Lc = cfg.d_model, cfg.n_layers
    _std_ok(p["embed"], 0.02)
    assert (p["final_norm"] == 1).all()
    assert (lay["norm1"] == 1).all() and (lay["norm2"] == 1).all()
    if family == "moe":
        _std_ok(lay["moe"]["router"], d ** -0.5)
        _std_ok(lay["moe"]["w_gate"], d ** -0.5)
        _std_ok(lay["moe"]["w_down"], (cfg.d_ff * Lc) ** -0.5)
    if family == "hybrid":
        ssm = lay["ssm"]
        _std_ok(ssm["conv_w"], cfg.ssm_conv ** -0.5)
        _std_ok(ssm["w_bcdt"], d ** -0.5)
        _std_ok(ssm["w_out"], (d * Lc) ** -0.5)
        # the reference's log(1..N), broadcast over layers and channels
        want = np.asarray(jnp.log(jnp.arange(1, cfg.ssm_state + 1,
                                             dtype=jnp.float32)))
        np.testing.assert_allclose(ssm["a_log"], np.broadcast_to(
            want, ssm["a_log"].shape), rtol=1e-7, atol=0)
        assert (ssm["d_skip"] == 1).all() and (ssm["dt_bias"] == 0).all()
        assert (lay["mix"] == 0).all() and lay["mix"].shape == (Lc, 2)
        _std_ok(lay["mlp"]["w_down"], (cfg.d_ff * Lc) ** -0.5)
    if family == "ssm":
        d_in, hd = 2 * d, d // cfg.n_heads
        ml, sl = lay["mlstm"], lay["slstm"]
        assert ml["wq"].shape[0] == Lc // 2
        _std_ok(ml["wq"], d_in ** -0.5)
        # both w_down scales take the full n_layers, not the pair count
        _std_ok(ml["w_down"], (d_in * Lc) ** -0.5)
        _std_ok(sl["w_down"], (PL.slstm_ff(d) * Lc) ** -0.5)
        # r_gates' fan-in is its second-to-last axis, 4 hd
        _std_ok(sl["r_gates"], (4 * hd) ** -0.5)
        assert (ml["ln"] == 1).all() and (sl["ln"] == 1).all()
    again = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_array_equal(params_to_numpy(again)["embed"], p["embed"])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_decode_consistency(arch):
    """tests/test_models.py's property on the port: decode(token_n |
    prefill(prompt[:n])) agrees with prefill(prompt[:n+1]) -- within
    1e-4 in float32 and the reference's 0.05 in bfloat16.  The
    recurrent cache is copied before its reuse (decode writes it in
    place)."""
    S = 32
    for dtype, atol in (("float32", 1e-4), ("bfloat16", 0.05)):
        cfg = PC.get_smoke_config(arch).scaled(dtype=dtype)
        model = PM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        toks = torch.from_numpy(_tokens(cfg, S, seed=5))
        with torch.inference_mode():
            logits_a, cache = PM.prefill(model, cfg, {"tokens": toks[:, :-1]},
                                         s_max=S)
            kept = {k: v.clone() for k, v in cache.items()}
            logits_b, _ = PM.prefill(model, cfg, {"tokens": toks}, s_max=S)
            step, after = PM.decode_step(model, cfg, toks[:, -1:], cache,
                                         S - 1)
            again, _ = PM.decode_step(model, cfg, toks[:, -1:], kept, S - 1)
        assert after is cache
        assert torch.isfinite(step).all()
        assert torch.equal(again, step)
        np.testing.assert_allclose(step.numpy(), logits_b.numpy(),
                                   rtol=atol, atol=atol, err_msg=dtype)


def test_every_config_serves_on_the_port():
    """All ten configs (smoke size) build, prefill and decode: no
    family is left unported."""
    for arch in PC.ARCH_IDS:
        cfg = PC.get_smoke_config(arch).scaled(n_layers=2)
        model = PM.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
        key = "embeds" if cfg.input_kind == "embeds" else "tokens"
        x = (torch.randn(1, 5, cfg.d_model) if key == "embeds"
             else torch.ones((1, 5), dtype=torch.int32))
        with torch.inference_mode():
            logits, cache = PM.prefill(model, cfg, {key: x}, s_max=8)
            step, _ = PM.decode_step(model, cfg, x[:, -1:], cache, 5)
        assert logits.shape == step.shape == (1, cfg.vocab_size), arch
        assert torch.isfinite(step).all(), arch
    assert not hasattr(PM, "PORTED_FAMILIES")
    assert not hasattr(PM, "_check_family")


@pytest.mark.parametrize("arch,count,tensors", [
    ("granite-moe-1b-a400m", 1_334_628_352, 1_334_628_352),
    ("hymba-1.5b", 1_259_011_200, 1_341_904_064),
    ("xlstm-350m", 252_888_064, 374_723_584),
])
def test_param_count_is_the_reference_estimate(arch, count, tensors):
    """``param_count`` is the reference's, copied: it leaves out the
    hybrid's ``w_out``, ``a_log``, ``d_skip``, ``dt_bias``, ``mix`` and
    ``w_bcdt``'s dt column, and estimates an xLSTM pair at 8 d^2
    (ROADMAP queue 3 item 5).  Both packages give the same count at the
    published config, and the port's model holds exactly the tensors
    of the reference's parameter tree (``jax.eval_shape``: nothing is
    allocated)."""
    rcfg = RC.get_config(arch)
    assert P_cfg.param_count(_pcfg(rcfg)) == R_cfg.param_count(rcfg) == count
    model = PM.LM(_pcfg(rcfg), "meta")
    assert sum(p.numel() for p in model.parameters()) == tensors
    shapes = jax.eval_shape(lambda: RM.init_params(rcfg, jax.random.PRNGKey(0)))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == tensors

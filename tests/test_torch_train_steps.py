"""Parity of the port's train step (``repro_torch.train``) with the
reference's, at smoke sizes on the CPU: ``make_train_step`` over three
steps, AdamW and its 8-bit moments, clipping, the schedule, and the
training-state converter.

Both sides take the same numpy inputs; the reference's state crosses
with ``train_state_from_reference`` and the reference runs jitted.
Tolerances, all float32: the loss rtol / atol 1e-5; the global norm,
updated masters and moments rtol / atol 1e-4.

The 8-bit moments are chaotic by design (one ulp moves a second-moment
payload between 0 and 1, and the update by orders of magnitude), so
they are held on identical inputs -- equal int8 payloads, scales within
one ulp -- and the whole 8-bit run only by the reference's own
divergence (ROADMAP queue 3 item 6), never by a wider tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import model as RM
from repro.train import optimizer as RO
from repro.train import steps as RS
from repro_torch.data import TokenPipeline
from repro_torch.models import model as PM
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (params_from_reference,
                                        params_to_numpy, tree_items,
                                        train_state_from_reference,
                                        train_state_to_numpy)
from repro_torch.train import optimizer as PO
from repro_torch.train import steps as PS

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_ARCHS = ["qwen3_1_7b", "granite_moe_1b_a400m", "hymba_1_5b",
               "xlstm_350m"]


def _cfgs(arch, **over):
    rcfg = RC.get_smoke_config(arch).scaled(**{"dtype": "float32", **over})
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _batch(rcfg, S, seed=0, mask=False):
    """numpy inputs: tokens (or embeds and, for the VLM, M-RoPE
    positions), labels and, with ``mask``, a loss mask."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(1, rcfg.vocab_size, (2, S)).astype(np.int32)}
    if rcfg.input_kind == "embeds":
        b["embeds"] = rng.standard_normal((2, S, rcfg.d_model)).astype(
            np.float32)
    else:
        b["tokens"] = rng.integers(1, rcfg.vocab_size, (2, S)).astype(
            np.int32)
    if rcfg.family == "vlm":
        b["mrope_positions"] = np.stack([np.broadcast_to(
            np.arange(S, dtype=np.int32) // k, (2, S)) for k in (1, 2, 4)])
    if mask:
        b["loss_mask"] = rng.random((2, S)) < 0.7
    return b


def _port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


_ref_init = jax.jit(RM.init_params, static_argnums=0)
_ref_init_state = jax.jit(RS.init_train_state, static_argnums=(0, 2))


def _ref_params(rcfg, seed=1):
    return _ref_init(rcfg, jax.random.PRNGKey(seed))


def _ref_state(rcfg, seed=1, bits8=False):
    return _ref_init_state(rcfg, jax.random.PRNGKey(seed), bits8)


def _to_port(pcfg, rstate):
    return train_state_from_reference(pcfg, jax.tree.map(np.asarray, rstate),
                                      "cpu")


def _close_trees(port, ref, what, **tol):
    """Every leaf of a port tree (nested dict, LM) against the
    reference pytree's leaves in flatten order."""
    r_leaves = jax.tree.leaves(ref)
    p_items = tree_items(port)
    assert len(r_leaves) == len(p_items), what
    for (path, p), r in zip(p_items, r_leaves):
        if isinstance(p, list):
            p = torch.stack([t.detach() for t in p])
        np.testing.assert_allclose(_np(p), np.asarray(r), err_msg=f"{what} "
                                   f"{path}", **(tol or TOL))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _ref_steps(rcfg, rstate, batches, lr_fn, bits8=False):
    step = jax.jit(RS.make_train_step(rcfg, lr_fn, bits8=bits8))
    out = []
    for b in batches:
        rstate, m = step(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return rstate, out


def _port_steps(pcfg, state, batches, lr_fn, bits8=False):
    step = PS.make_train_step(pcfg, lr_fn, bits8=bits8)
    out = []
    for b in batches:
        state, m = step(state, _port(b))
        out.append({k: float(v) for k, v in m.items()})
    return state, out


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch):
    """Three steps of ``make_train_step`` (float32 moments, a cosine
    schedule with a warm-up of 2, so the learning rate is 0 on the first
    step only) from the reference's state: the loss, the global norm and
    the learning rate of every step, then the masters, the step count
    and both moments."""
    rcfg, pcfg = _cfgs(arch)
    rstate = _ref_state(rcfg)
    state = _to_port(pcfg, rstate)
    batches = [_batch(rcfg, 32, seed=s) for s in range(3)]
    rstate, rm = _ref_steps(rcfg, rstate, batches,
                            RO.cosine_schedule(3e-3, 2, 10))
    state, pm = _port_steps(pcfg, state, batches,
                            PO.cosine_schedule(3e-3, 2, 10))
    for r, p in zip(rm, pm):
        np.testing.assert_allclose(p["loss"], r["loss"], **LOSS_TOL)
        np.testing.assert_allclose(p["grad_norm"], r["grad_norm"], **TOL)
        np.testing.assert_allclose(p["lr"], r["lr"], rtol=1e-6, atol=0)
    assert pm[0]["lr"] == 0.0 and pm[1]["lr"] > 0
    assert int(state.opt.step) == 3 == int(rstate.opt.step)
    _close_trees(state.params, rstate.params, "masters")
    _close_trees(state.opt.mu, rstate.opt.mu, "mu")
    _close_trees(state.opt.nu, rstate.opt.nu, "nu")
    assert state.ef is None
    # the serving copies are the new masters, cast
    for m in state.params.modules():
        for name, t in getattr(m, "compute", {}).items():
            assert torch.equal(t, getattr(m, name).detach())


def test_serve_then_train_then_serve():
    """A model that served under ``torch.inference_mode()`` trains (no
    inference tensor is saved for backward), and serving afterwards
    reads the updated masters: its logits equal a fresh model's made
    from the trained masters, and differ from before training."""
    rcfg, pcfg = _cfgs("qwen3_1_7b", dtype="bfloat16")
    state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    toks = torch.from_numpy(_batch(rcfg, 16)["tokens"])
    prefill_step, decode_one = PS.make_serve_steps(pcfg, 24)
    tok, cache = prefill_step(state.params, {"tokens": toks})
    decode_one(state.params, tok[:, None], cache, 16)
    with torch.inference_mode():
        before, _ = PM.prefill(state.params, pcfg, {"tokens": toks})
    step = PS.make_train_step(pcfg, lambda s: torch.tensor(1e-2))
    for s in range(2):
        state, m = step(state, _port(_batch(rcfg, 32, seed=s)))
        assert np.isfinite(float(m["loss"]))
    fresh = params_from_reference(pcfg, params_to_numpy(state.params), "cpu")
    with torch.inference_mode():
        got, _ = PM.prefill(state.params, pcfg, {"tokens": toks})
        want, _ = PM.prefill(fresh, pcfg, {"tokens": toks})
    assert torch.equal(got, want)
    assert not torch.equal(got, before)


def test_compress_pod_grads_raises_before_any_state_changes():
    rcfg, pcfg = _cfgs("qwen3_1_7b")
    state = PS.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                error_feedback=True, device="cpu")
    before = train_state_to_numpy(state)
    with pytest.raises(NotImplementedError, match=r"2\(f\)"):
        PS.make_train_step(pcfg, PO.cosine_schedule(1e-3, 2, 10),
                           compress_pod_grads=True)
    after = train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
    assert [p for p, _ in tree_items(state.ef)] == [
        p for p, _ in tree_items(state.opt.mu)]


# ---------------------------------------------------------------------------
# The state converter
# ---------------------------------------------------------------------------

_ref_quantize8 = jax.jit(RO._quantize8)


@pytest.mark.parametrize("bits8", [False, True])
def test_train_state_round_trips_exactly(bits8):
    """Every smoke config's reference state (a step count of 7, nonzero
    moments, error-feedback residuals) carried into the port and back,
    leaf for leaf and bit for bit, in the reference's leaf order."""
    rng = np.random.default_rng(6)
    for arch in RC.ARCH_IDS:
        rcfg, pcfg = _cfgs(arch, input_kind="tokens")
        rparams = _ref_params(rcfg, 3)

        def noise(p):
            return jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32))

        mu = jax.tree.map(noise, rparams)
        nu = jax.tree.map(lambda p: noise(p) ** 2, rparams)
        if bits8:
            mu = jax.tree.map(_ref_quantize8, mu)
            nu = jax.tree.map(_ref_quantize8, nu)
        rstate = RS.TrainState(rparams, RO.AdamWState(
            jnp.asarray(7, jnp.int32), mu, nu), jax.tree.map(noise, rparams))
        ref_np = jax.tree.map(np.asarray, rstate)
        state = train_state_from_reference(pcfg, ref_np, "cpu")
        back = train_state_to_numpy(state)
        r_leaves = jax.tree.leaves(ref_np)
        b_leaves = jax.tree.leaves(back)
        assert len(b_leaves) == len(r_leaves), arch
        for a, b in zip(b_leaves, r_leaves):
            assert a.dtype == b.dtype and a.shape == b.shape, arch
            np.testing.assert_array_equal(a, b, err_msg=arch)
        assert int(state.opt.step) == 7
        if bits8:
            q = tree_items(state.opt.mu)[0][1]
            assert isinstance(q, PO.Quant8) and q.q.dtype == torch.int8


# ---------------------------------------------------------------------------
# The optimizer (tests/test_runtime.py's cases, and the reference's
# numbers on identical inputs)
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    p = {"w": torch.tensor([5.0, -3.0])}
    st = PO.adamw_init(p)
    for _ in range(200):
        g = {"w": 2 * p["w"]}
        p, st = PO.adamw_update(g, st, p, lr=0.05, weight_decay=0.0)
    assert float(p["w"].abs().max()) < 0.2


def test_quantize8_roundtrip_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)) * 10).float()
    q = PO._quantize8(x)
    err = (PO._dequantize8(q) - x).abs().numpy()
    # blockwise absmax int8: error bounded by scale/2 per block
    assert err.max() <= float(x.abs().max()) / 127.0 + 1e-6


def test_adamw_bits8_tracks_fp32():
    p32 = {"w": torch.linspace(-2, 2, 64)}
    p8 = {"w": p32["w"].clone()}
    s32, s8 = PO.adamw_init(p32), PO.adamw_init(p8, bits8=True)
    rng = np.random.default_rng(1)
    for _ in range(30):
        g = torch.from_numpy(rng.normal(size=64)).float()
        p32, s32 = PO.adamw_update({"w": g.clone()}, s32, p32, lr=1e-2)
        p8, s8 = PO.adamw_update({"w": g.clone()}, s8, p8, lr=1e-2,
                                 bits8=True)
    diff = (p32["w"] - p8["w"]).abs()
    assert float(diff.max()) < 0.05, float(diff.max())


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, gn = PO.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-5)


def test_cosine_schedule_matches_reference():
    r, p = RO.cosine_schedule(3e-3, 10, 100), PO.cosine_schedule(3e-3, 10,
                                                                 100)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.vmap(r)(jnp.asarray(steps)))
    got = p(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32 and got[0] == 0.0
    # XLA's cos and PyTorch's differ by ulps near the end of the decay
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_adamw_float32_matches_reference_on_identical_inputs():
    """Five updates of a nested dict of leaves with weight decay and a
    learning-rate tensor, the moments carried between them."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 100), "b": {"c": (7,), "d": (2, 5, 4)}}
    ps = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes, is_leaf=lambda x: isinstance(x, tuple))
    rp = jax.tree.map(jnp.asarray, ps)
    pp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), ps)
    rs, st = RO.adamw_init(rp), PO.adamw_init(pp)
    for i in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), ps)
        lr = np.float32(1e-2 * (i + 1))
        rp, rs = RO.adamw_update(jax.tree.map(jnp.asarray, g), rs, rp,
                                 jnp.asarray(lr))
        pp, st = PO.adamw_update(jax.tree.map(torch.from_numpy, g), st, pp,
                                 torch.tensor(lr))
    _close_trees(pp, rp, "params", rtol=1e-6, atol=1e-6)
    _close_trees(st.mu, rs.mu, "mu", rtol=1e-6, atol=1e-7)
    _close_trees(st.nu, rs.nu, "nu", rtol=1e-6, atol=1e-9)


def test_quantize8_equals_reference_across_a_block_spanning_two_layers():
    """``_quantize8`` / ``_dequantize8`` of stacked leaves whose layer
    share is not a multiple of 256 (qwen3-1.7b's q_norm at full size is
    128 per layer; hymba-1.5b's SSM leaves 1,600; its mix 2): equal
    payloads and scales within one ulp; exact halves round to even."""
    rng = np.random.default_rng(5)
    for shape in ((2, 128), (3, 1600), (4, 2), (2, 300)):
        x = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        x.reshape(-1)[::37] = 0.0
        rq = RO._quantize8(jnp.asarray(x))
        pq = PO._quantize8(torch.from_numpy(x))
        np.testing.assert_array_equal(pq.q.numpy(), np.asarray(rq.q))
        np.testing.assert_array_max_ulp(pq.scale.numpy(),
                                        np.asarray(rq.scale), maxulp=1)
        same = RO.Quant8(jnp.asarray(pq.q.numpy()),
                         jnp.asarray(pq.scale.numpy()))
        np.testing.assert_array_equal(PO._dequantize8(pq).numpy(),
                                      np.asarray(RO._dequantize8(same)))
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5] + [0.0] * 250,
                      np.float32)
    pq = PO._quantize8(torch.from_numpy(halves))
    np.testing.assert_array_equal(pq.q.numpy()[:6], [127, 0, 2, 2, 0, -2])


def test_bits8_update_equals_reference_on_identical_inputs():
    """``adamw_update(bits8=True)`` against the reference's (run op by
    op: jitted, XLA fuses the moments' arithmetic and moves a payload by
    one in about 50,000) on identical inputs -- stacked leaves whose
    blocks span layers (64 and 300 per layer) and an unstacked one,
    moments quantised from seeded noise, three steps each from the same
    state: every int8 payload equal, every scale within one ulp, the
    masters within rtol / atol 1e-6."""
    rng = np.random.default_rng(7)
    shapes = {"embed": (50, 8), "layers": {"norm1": (2, 64),
                                            "w": (3, 300)}}
    leaf = lambda x: isinstance(x, tuple)       # noqa: E731
    for step in (1, 4, 30):
        def noise(shape, scale=1e-2):
            return (rng.standard_normal(shape) * scale).astype(np.float32)

        params = jax.tree.map(lambda s: noise(s, 1.0), shapes, is_leaf=leaf)
        grads = jax.tree.map(noise, shapes, is_leaf=leaf)
        mu = jax.tree.map(lambda s: _ref_quantize8(noise(s)), shapes,
                          is_leaf=leaf)
        nu = jax.tree.map(lambda s: _ref_quantize8(noise(s) ** 2), shapes,
                          is_leaf=leaf)
        ropt = RO.AdamWState(jnp.asarray(step, jnp.int32), mu, nu)
        rp, ro = RO.adamw_update(jax.tree.map(jnp.asarray, grads), ropt,
                                 jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(1e-3, jnp.float32), bits8=True)
        opt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ropt)
        opt = PO.AdamWState(opt.step, *(
            jax.tree.map(lambda q: PO.Quant8(*q), m, is_leaf=leaf)
            for m in (opt.mu, opt.nu)))
        pp, po = PO.adamw_update(
            jax.tree.map(torch.from_numpy, grads), opt,
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), params),
            torch.tensor(1e-3), bits8=True)
        for moments, ref in ((po.mu, ro.mu), (po.nu, ro.nu)):
            r_leaves = jax.tree.leaves(ref)
            p_items = tree_items(moments)
            assert len(r_leaves) == 2 * len(p_items)
            for (path, q), rq, rs in zip(p_items, r_leaves[::2],
                                         r_leaves[1::2]):
                np.testing.assert_array_equal(q.q.numpy(), np.asarray(rq),
                                              err_msg=f"{step} {path}")
                np.testing.assert_array_max_ulp(
                    q.scale.numpy(), np.asarray(rs), maxulp=1)
        _close_trees(pp, rp, "masters", rtol=1e-6, atol=1e-6)


def test_bits8_adamw_replays_the_reference_divergence():
    """ROADMAP queue 3 item 6: the reference's 8-bit moments round small
    second moments to 0 and training diverges.  qwen3-1.7b's smoke
    config in float32, ``TokenPipeline(512, 64, 8, seed=0)``,
    ``cosine_schedule(3e-3, 5, 60)``, from the reference's weights: the
    first losses agree, and after four steps both packages' loss stands
    more than 5 above the first (the reference's 6.27 -> 24.87), where
    float32 moments keep it near the first.  Not repaired: the port
    replays the reference."""
    rcfg, pcfg = _cfgs("qwen3_1_7b")
    pipe = TokenPipeline(512, 64, 8, seed=0)
    batches = [pipe.batch_at(s) for s in range(4)]
    _, rm = _ref_steps(rcfg, _ref_state(rcfg, seed=0, bits8=True), batches,
                       RO.cosine_schedule(3e-3, 5, 60), bits8=True)
    fn = PO.cosine_schedule(3e-3, 5, 60)
    state, pm = _port_steps(
        pcfg, _to_port(pcfg, _ref_state(rcfg, seed=0, bits8=True)), batches,
        fn, bits8=True)
    _, p32 = _port_steps(pcfg, _to_port(pcfg, _ref_state(rcfg, seed=0)),
                         batches, fn)
    np.testing.assert_allclose(pm[0]["loss"], rm[0]["loss"], **LOSS_TOL)
    assert rm[3]["loss"] > rm[0]["loss"] + 5, rm
    assert pm[3]["loss"] > pm[0]["loss"] + 5, pm
    assert p32[3]["loss"] < p32[0]["loss"] + 0.5, p32
    zeros = sum(int((q.q == 0).sum()) for _, q in tree_items(state.opt.nu))
    assert zeros > 0

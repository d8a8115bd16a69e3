"""The port's LM on the card against the port's LM on the CPU, at smoke
sizes, the same weights on both (``params_from_reference`` of the CPU
model's ``params_to_numpy``).  The CPU side is held to the reference by
tests/test_torch_models.py, so these chain the card to the reference.

These need the card (marker ``cuda``): each test skips without a CUDA
device.  The file imports nothing of JAX, so it runs on a machine that
has none:

    PYTHONPATH=src python -m pytest tests/test_torch_models_cuda.py

Tolerances: float32 rtol / atol 1e-5 (TF32 stays off, PyTorch's
default, so both sides multiply in float32 and differ only in the order
of their sums); bfloat16 rtol / atol 0.05, the reference's own prefill /
decode consistency tolerance.  As in tests/test_torch_models_families.py,
a bf16 MoE token whose expert set differs between the two sides must lie
within ``FLIP_ULPS`` bf16 ulps of a tie on the CPU side (asserted) and
only its rows are left out; the sLSTM's float32 cell and normaliser are
held by norm in bf16.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch import configs as PC
from repro_torch.launch import serve
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_reference, params_to_numpy

pytestmark = pytest.mark.cuda

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0.05, atol=0.05)}
CFGS = {
    "qwen3_1_7b": lambda: PC.get_smoke_config("qwen3_1_7b"),
    "qwen2_7b": lambda: PC.get_smoke_config("qwen2_7b"),
    "qwen2_vl_7b": lambda: PC.get_smoke_config("qwen2_vl_7b"),
    "musicgen_large": lambda: PC.get_smoke_config("musicgen_large"),
    "window8": lambda: PC.get_smoke_config("qwen3_1_7b").scaled(
        sliding_window=8),
    "granite_moe_1b_a400m": lambda: PC.get_smoke_config(
        "granite_moe_1b_a400m"),
    "mixtral_8x22b": lambda: PC.get_smoke_config("mixtral_8x22b"),
    "hymba_1_5b": lambda: PC.get_smoke_config("hymba_1_5b"),
    "xlstm_350m": lambda: PC.get_smoke_config("xlstm_350m"),
}
B, S = 2, 16
FLIP_ULPS = 4
NORM_STATES = ("slstm_c", "slstm_n")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _close(card, cpu, dtype, what, keep=None):
    a, b = card.float().cpu().numpy(), cpu.float().numpy()
    if dtype == "bfloat16" and what in NORM_STATES:
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= TOL[dtype]["rtol"], (what, err)
        return
    if keep is not None:
        a, b = a[keep], b[keep]
    np.testing.assert_allclose(a, b, err_msg=what, **TOL[dtype])


@contextlib.contextmanager
def _routes(model):
    """Each MoE call's float32 gates (T, E), in call order."""
    calls = []

    def hook(mod, args):
        x = args[0]
        T, d = x.shape[0] * x.shape[1], x.shape[2]
        xg = x.reshape(PL._pick_groups(T), -1, d)
        calls.append(torch.softmax((xg @ mod.p.router).float(), -1)
                     .reshape(T, -1).cpu().numpy())

    handles = [b.moe.register_forward_pre_hook(hook) for b in model.blocks
               if getattr(b, "moe", None) is not None]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def _flipped(card_calls, cpu_calls, K, dtype, seq):
    """(b, s) of the tokens whose expert set differs, each asserted to
    lie within ``FLIP_ULPS`` bf16 ulps of a tie on the CPU side."""
    out = set()
    for a, b in zip(card_calls, cpu_calls):
        top = [np.sort(np.argsort(-g, -1, kind="stable")[:, :K], -1)
               for g in (a, b)]
        for t in np.nonzero((top[0] != top[1]).any(-1))[0]:
            assert dtype == "bfloat16", ("a float32 routing flip", t)
            g = np.sort(b[t])[::-1]
            ulp = 2.0 ** (np.floor(np.log2(g[K - 1])) - 7)
            assert g[K - 1] - g[K] <= FLIP_ULPS * ulp, (t, g)
            out.add((t // seq, t % seq))
    return out


def _inputs(cfg, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    if cfg.input_kind == "embeds":
        x = {"embeds": torch.randn((B, S, cfg.d_model), generator=g)}
    else:
        x = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     dtype=torch.int32)}
    return {k: v.to(device) for k, v in x.items()}


def _pair(name, dtype, cuda):
    cfg = CFGS[name]().scaled(dtype=dtype)
    cpu = PM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return cfg, cpu, params_from_reference(cfg, params_to_numpy(cpu), cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_model_on_the_card_matches_the_cpu(name, dtype, cuda):
    """forward, prefill and one decode step; every cache tensor after
    it."""
    cfg, cpu, card = _pair(name, dtype, cuda)
    key = "embeds" if cfg.input_kind == "embeds" else "tokens"
    with torch.inference_mode():
        outs, routes = {}, {}
        for side, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
            x = _inputs(cfg, dev)
            with _routes(model) as calls:
                h = PM.forward(model, cfg, x)
                prompt = {key: x[key][:, :S - 1]}
                logits, cache = PM.prefill(model, cfg, prompt, s_max=S + 2)
                step, cache = PM.decode_step(model, cfg, x[key][:, S - 1:],
                                             cache, S - 1)
            outs[side] = (h, logits, step, cache)
            routes[side] = calls
        K, L = cfg.experts_per_token, len(card.blocks)
        card_r, cpu_r = routes["card"], routes["cpu"]
        flips = [_flipped(card_r[i * L:(i + 1) * L], cpu_r[i * L:(i + 1) * L],
                          K, dtype, seq)
                 for i, seq in enumerate((S, S - 1, 1))]
        keep = np.ones((B, S), bool)
        for b, s in flips[0] | flips[1]:
            keep[b, s] = False
        last = np.array([keep[b, S - 2] for b in range(B)])
        stepped = np.array([(b, 0) not in flips[2] for b in range(B)])
        (h, logits, step, cache), (h0, logits0, step0, cache0) = (
            outs["card"], outs["cpu"])
        _close(h, h0, dtype, "forward", keep)
        _close(logits, logits0, dtype, "prefill", last)
        _close(step, step0, dtype, "decode", stepped & last)
        assert set(cache) == set(cache0)
        rows = np.pad(keep, ((0, 0), (0, 2)), constant_values=True)
        rows[~stepped, S - 1] = False
        for k in cache0:
            kept = None
            if k in ("k", "v"):
                kept = np.broadcast_to(rows, (cache0[k].shape[0], B, S + 2))
            _close(cache[k], cache0[k], dtype, k, kept)


def test_ring_cache_on_the_card_matches_the_cpu(cuda):
    cfg, cpu, card = _pair("window8", "float32", cuda)
    caches = {"cpu": PM.init_cache(cfg, B, 40, device="cpu"),
              "card": PM.init_cache(cfg, B, 40, device=cuda)}
    toks = _inputs(cfg, "cpu")["tokens"]
    with torch.inference_mode():
        for i in range(12):
            a, _ = PM.decode_step(card, cfg, toks[:, i:i + 1].to(cuda),
                                  caches["card"], i)
            b, _ = PM.decode_step(cpu, cfg, toks[:, i:i + 1], caches["cpu"], i)
            _close(a, b, "float32", f"step {i}")
    assert torch.equal(caches["card"]["pos_ids"].cpu(),
                       caches["cpu"]["pos_ids"])


def test_moving_a_model_recasts_it(cuda):
    cfg, cpu, card = _pair("qwen3_1_7b", "bfloat16", cuda)
    moved = PM.init_params(cfg, torch.Generator().manual_seed(1), "cpu").to(
        cuda)
    assert moved.compute["embed"].device.type == "cuda"
    x = _inputs(cfg, cuda)
    with torch.inference_mode():
        assert torch.equal(PM.forward(moved, cfg, x), PM.forward(card, cfg, x))


def test_launcher_on_the_card(cuda):
    assert serve.main(["--arch", "qwen3-1.7b", "--smoke"]) == (24, 320)


# ---------------------------------------------------------------------------
# Training: one step, card against CPU
# ---------------------------------------------------------------------------

TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["qwen3_1_7b", "granite_moe_1b_a400m",
                                  "hymba_1_5b", "xlstm_350m"])
def test_train_step_on_the_card_matches_the_cpu(name, cuda):
    """One float32 train step, batch 2 x 32, from the same state
    (``train_state_from_reference`` of the CPU state's
    ``train_state_to_numpy``): ``make_train_step``'s loss rtol / atol
    1e-5 and its moments, every gradient leaf and the global norm rtol /
    atol 1e-4 (the gradients' sums -- the embedding's and the MoE
    dispatch's index adds -- run in another order on the card); then
    the AdamW update on identical inputs (the CPU's clipped gradients on
    both sides), its masters rtol / atol 1e-5.  The masters after each
    side's own step are not compared: the first step's update
    ``g / (|g| + eps)`` turns a gradient difference of 1e-9 near
    ``eps`` = 1e-8 into one of order 1.  The serving copies follow the
    masters."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.convert import (nest, train_state_from_reference,
                                            train_state_to_numpy,
                                            tree_items)
    from repro_torch.train import optimizer as PO
    from repro_torch.train import steps as PS

    cfg = CFGS[name]().scaled(dtype="float32")
    cpu = PS.init_train_state(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    start = train_state_to_numpy(cpu)
    b = TokenPipeline(cfg.vocab_size, 32, 2, seed=1).batch_at(0)
    lr = 1e-3
    outs = {}
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        st = train_state_from_reference(cfg, start, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        loss, grads = PS.value_and_grad(st.params, cfg, batch)
        grads, gnorm = PO.clip_by_global_norm(grads, 1.0)
        step = PS.make_train_step(cfg, lambda s: torch.tensor(lr))
        st, m = step(st, batch)
        outs[side] = (loss, grads, gnorm, st, m)
    (l_cpu, g_cpu, n_cpu, s_cpu, m_cpu), (l_card, g_card, n_card, s_card,
                                          m_card) = outs["cpu"], outs["card"]
    for a, c in ((l_card, l_cpu), (m_card["loss"], m_cpu["loss"])):
        np.testing.assert_allclose(float(a), float(c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(n_card), float(n_cpu), **TRAIN_TOL)
    for (path, a), (_, c) in zip(tree_items(g_card), tree_items(g_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(),
                                   err_msg=str(path), **TRAIN_TOL)
    got, want = train_state_to_numpy(s_card), train_state_to_numpy(s_cpu)
    for part in ("mu", "nu"):
        for (path, a), (_, c) in zip(tree_items(getattr(got.opt, part)),
                                     tree_items(getattr(want.opt, part))):
            np.testing.assert_allclose(a, c, err_msg=f"{part} {path}",
                                       **TRAIN_TOL)
    for m in s_card.params.modules():
        for key, t in getattr(m, "compute", {}).items():
            assert torch.equal(t, getattr(m, key).detach())
    # the update on identical inputs
    updated = {}
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        st = train_state_from_reference(cfg, start, dev)
        grads = nest((p, g.to(dev)) for p, g in tree_items(g_cpu))
        params, _ = PO.adamw_update(grads, st.opt, st.params,
                                    torch.tensor(lr, device=dev))
        updated[side] = train_state_to_numpy(st._replace(
            params=params)).params
    for (path, a), (_, c) in zip(tree_items(updated["card"]),
                                 tree_items(updated["cpu"])):
        np.testing.assert_allclose(a, c, err_msg=str(path), rtol=1e-5,
                                   atol=1e-5)

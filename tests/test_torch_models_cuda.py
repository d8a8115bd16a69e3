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
decode consistency tolerance.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs as PC
from repro_torch.launch import serve
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
}
B, S = 2, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _close(card, cpu, dtype, what):
    np.testing.assert_allclose(card.float().cpu().numpy(),
                               cpu.float().numpy(), err_msg=what, **TOL[dtype])


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
    cfg, cpu, card = _pair(name, dtype, cuda)
    key = "embeds" if cfg.input_kind == "embeds" else "tokens"
    with torch.inference_mode():
        outs = {}
        for side, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
            x = _inputs(cfg, dev)
            h = PM.forward(model, cfg, x)
            prompt = {key: x[key][:, :S - 1]}
            logits, cache = PM.prefill(model, cfg, prompt, s_max=S + 2)
            step, cache = PM.decode_step(model, cfg, x[key][:, S - 1:], cache,
                                         S - 1)
            outs[side] = (h, logits, step, cache["k"], cache["v"])
        for what, a, b in zip(("forward", "prefill", "decode", "k", "v"),
                              outs["card"], outs["cpu"]):
            _close(a, b, dtype, what)


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

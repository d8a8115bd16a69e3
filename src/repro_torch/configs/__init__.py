"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro.configs``: the same ids, aliases, shapes and cells,
over the port's copy of each configuration module.

Each module defines ``config()`` (the exact published configuration)
and ``smoke_config()`` (a reduced same-family variant for CPU tests).
``SHAPES`` defines the assigned input-shape set; ``cells()`` enumerates
the (arch x shape) dry-run grid with documented skips.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

ARCH_IDS = [
    "qwen3_1_7b",
    "deepseek_coder_33b",
    "qwen2_7b",
    "yi_34b",
    "hymba_1_5b",
    "granite_moe_1b_a400m",
    "mixtral_8x22b",
    "qwen2_vl_7b",
    "xlstm_350m",
    "musicgen_large",
]

# canonical external ids (with dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({"qwen3-1.7b": "qwen3_1_7b",
                "granite-moe-1b-a400m": "granite_moe_1b_a400m",
                "hymba-1.5b": "hymba_1_5b"})

# (seq_len, global_batch, kind); kind: train | prefill | decode
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch: str):
    mod = importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(arch, arch)}")
    return mod.config()


def get_smoke_config(arch: str):
    mod = importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(arch, arch)}")
    return mod.smoke_config()


def shape_applicable(cfg, shape: str) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention over the cached
    context: SSM / hybrid state recurrence or sliding-window caches.
    Pure full-attention archs skip it (documented in DESIGN.md)."""
    if shape != "long_500k":
        return True, ""
    if cfg.family in ("ssm", "hybrid"):
        return True, "recurrent state: O(1) decode"
    if cfg.sliding_window > 0:
        return True, f"SWA ring cache (window={cfg.sliding_window})"
    return False, ("full attention: 500k-token KV decode is "
                   "O(S) per token with an O(S) cache; skipped per "
                   "assignment note")


def cells() -> List[Tuple[str, str, bool, str]]:
    """(arch, shape, runnable, note) for all 40 cells."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, note = shape_applicable(cfg, shape)
            out.append((arch, shape, ok, note))
    return out

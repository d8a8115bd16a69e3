"""Carry LM weights across from the reference package.

``params_from_reference`` takes the reference's parameter pytree as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side,
done by the caller, so this module imports nothing of JAX), with every
layer tensor stacked on a leading ``n_layers`` axis (``n_layers // 2``
pairs for xLSTM) as ``lax.scan`` wants it, and returns the port's
``LM`` on ``device`` with those masters and their compute-dtype
copies.  ``params_to_numpy`` is the
reverse.  The database state's converters are ``core/convert.py``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.table import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm
from repro_torch.models.model import LM


def _slots(model: LM) -> Iterator[Tuple[tuple, list]]:
    """(pytree path, the per-layer parameters stacked there) for every
    layer tensor of the reference's pytree the model has: a block's own
    parameter (the hybrid's ``mix``) at ``(name,)``, a norm's scale at
    ``(norm,)`` and every other sub-module's weight at ``(module,
    name)`` -- ``attn``, ``mlp``, ``moe``, ``ssm``, and xLSTM's
    ``mlstm`` / ``slstm``, stacked over its pairs."""
    blocks = list(model.blocks)
    for name, _ in blocks[0].named_parameters(recurse=False):
        yield (name,), [getattr(b, name) for b in blocks]
    for child, mod in blocks[0].named_children():
        for name, _ in mod.named_parameters():
            path = (child,) if isinstance(mod, RMSNorm) else (child, name)
            yield path, [getattr(getattr(b, child), name) for b in blocks]


def _top(model: LM):
    out = {"embed": model.embed, "final_norm": model.final_norm.weight}
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head
    return out


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def params_from_reference(cfg: ModelConfig, params_np: Dict,
                          device=None) -> LM:
    """The reference's parameters (numpy, layer tensors stacked) as the
    port's model on ``device`` (the card unless the caller names
    another).  Raises on a missing or extra tensor."""
    device = resolve_device(device)
    model = LM(cfg, device)
    want = set(_top(model)) | {("layers",) + path
                               for path, _ in _slots(model)}
    got = {p if p[0] == "layers" else p[0] for p in _leaf_paths(params_np)}
    if got != want:
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(map(str, want - got))}, extra "
                         f"{sorted(map(str, got - want))}")

    def put(p, arr):  # a writable C-contiguous view (or copy) of arr
        p.copy_(torch.from_numpy(np.require(arr, requirements=["C", "W"])))

    with torch.no_grad():
        for name, p in _top(model).items():
            put(p, params_np[name])
        for path, params in _slots(model):
            stacked = params_np["layers"]
            for k in path:
                stacked = stacked[k]
            for i, p in enumerate(params):
                put(p, stacked[i])
    return model.cast_()


def params_to_numpy(model: LM) -> Dict:
    """The model's master weights in the reference's pytree layout."""
    out = {k: p.detach().cpu().numpy() for k, p in _top(model).items()}
    layers: Dict = {}
    for path, params in _slots(model):
        node = layers
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.stack(
            [p.detach() for p in params]).cpu().numpy()
    out["layers"] = layers
    return out

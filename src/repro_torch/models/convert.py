"""Carry LM weights and training state across from the reference package.

``params_from_reference`` takes the reference's parameter pytree as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side,
done by the caller, so this module imports nothing of JAX), with every
layer tensor stacked on a leading ``n_layers`` axis (``n_layers // 2``
pairs for xLSTM) as ``lax.scan`` wants it, and returns the port's
``LM`` on ``device`` with those masters and their compute-dtype
copies.  ``params_to_numpy`` is the reverse.
``train_state_from_reference`` / ``train_state_to_numpy`` do the same
for a whole training state (masters, the step, AdamW's moments in
float32 or 8-bit, error feedback).

``param_leaves`` lists the model's masters as the reference's pytree
leaves, in ``jax.tree.flatten``'s order (dict keys sorted at every
level), a stacked layer leaf as the list of its layers' tensors; the
optimizer's moments, the global norm and checkpoints follow that order.
The database state's converters are ``core/convert.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

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
    """The model's master weights in the reference's pytree layout
    (copies: the masters are updated in place)."""
    out = {k: p.detach().to("cpu", copy=True).numpy()
           for k, p in _top(model).items()}
    layers: Dict = {}
    for path, params in _slots(model):
        node = layers
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.stack(
            [p.detach() for p in params]).cpu().numpy()
    out["layers"] = layers
    return out


def param_leaves(model: LM) -> List[Tuple[tuple, Any]]:
    """(pytree path, leaf) of every master in the reference's leaf order
    (paths sorted, as ``jax.tree.flatten`` sorts dict keys): a top-level
    tensor as itself, a layer slot as the list of its layers' tensors,
    which the reference stacks on a leading axis."""
    leaves = [((name,), p) for name, p in _top(model).items()]
    leaves += [(("layers",) + path, params) for path, params in _slots(model)]
    return sorted(leaves, key=lambda kv: kv[0])


def tree_items(tree) -> List[Tuple[tuple, Any]]:
    """(path, leaf) of a nested dict in ``jax.tree.flatten``'s order,
    or of an ``LM``'s masters (``param_leaves``).  A leaf is whatever is
    not a dict: a tensor, an array, a ``Quant8`` pair, or ``None``."""
    if isinstance(tree, LM):
        return param_leaves(tree)
    if not isinstance(tree, dict):
        return [((), tree)]
    return [((k,) + path, leaf) for k in sorted(tree)
            for path, leaf in tree_items(tree[k])]


def nest(items) -> Dict:
    """The nested dict of (path, value) pairs."""
    out: Dict = {}
    for path, value in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def _map_state(fn, tree):
    """``fn`` over a nested dict's array leaves; a ``Quant8``-like pair
    (q, scale) maps each of its arrays and keeps the port's type."""
    from repro_torch.train.optimizer import Quant8

    if tree is None:
        return None

    def one(leaf):
        if isinstance(leaf, tuple):       # Quant8 of either package
            q, scale = leaf
            return Quant8(fn(q), fn(scale))
        return fn(leaf)

    return nest((path, one(leaf)) for path, leaf in tree_items(tree))


def _map_residuals(fn, ef):
    """``fn`` over the residuals: None, or a tuple of one tree per pod
    (the port's form), given also as the reference's one tree (a dict),
    which is one pod's."""
    if isinstance(ef, dict):
        ef = (ef,)
    return None if ef is None else tuple(_map_state(fn, t) for t in ef)


def train_state_from_reference(cfg: ModelConfig, state_np, device=None):
    """The reference's ``TrainState`` as numpy arrays (``params``; ``opt``
    = (``step``, ``mu``, ``nu``), each moment a float32 array or a
    ``Quant8(q, scale)`` pair per leaf; ``ef`` None, the reference's
    one residual tree, or the port's tuple of one tree per pod) as the
    port's ``TrainState`` on ``device`` (the card unless the caller
    names another), its residuals a tuple of one tree per pod."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.steps import TrainState

    device = resolve_device(device)
    params_np, (step, mu, nu), ef = state_np

    def put(arr):  # a copy: the port updates its state in place
        arr = np.require(arr, requirements=["C", "W"])
        return torch.from_numpy(arr).to(device, copy=True)

    opt = AdamWState(put(np.asarray(step, np.int32)), _map_state(put, mu),
                     _map_state(put, nu))
    return TrainState(params_from_reference(cfg, params_np, device), opt,
                      _map_residuals(put, ef))


def train_state_to_numpy(state):
    """The port's ``TrainState`` in the reference's layout, as numpy
    arrays (the port's ``TrainState`` / ``AdamWState`` / ``Quant8``
    tuples, whose fields are the reference's; the residuals one tree
    per pod, whose leaves for one pod are the reference's in order)."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.steps import TrainState

    def host(t):  # a copy, never a view of a tensor updated in place
        return t.detach().to("cpu", copy=True).numpy()

    opt = state.opt
    return TrainState(params_to_numpy(state.params),
                      AdamWState(host(opt.step), _map_state(host, opt.mu),
                                 _map_state(host, opt.nu)),
                      _map_residuals(host, state.ef))

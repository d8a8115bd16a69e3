"""Logical-axis sharding: rules mapping model-logical axes to mesh axes.

Port of ``repro.parallel.sharding``.  Model code names the axes of its
tensors *logically*:

    'dp'  -- batch-parallel dimension (maps to ('pod', 'data'))
    'tp'  -- tensor-parallel dimension (maps to 'model')
    'ep'  -- expert-parallel dimension (maps to 'model' when the expert
             count divides the model-axis size, else dropped in favour
             of intra-expert TP)

``activate(mesh)`` installs the mapping; it reads nothing of the mesh
but ``mesh.shape`` (``{axis name: size}``), so any object with that
attribute serves.  Without an active mapping every spec is empty and
``axis_size`` is 1.  A dimension whose size does not divide its mapped
mesh-axis size is dropped (replicated) on its own.

``spec_for_path`` derives a leaf's ``P`` from its path in the
reference's pytree and its shape -- the single source of truth for
weight layouts used by the dry run, ``runtime.elastic`` and
``launch.specs``.  The port's trees are walked in the reference's
layout (``leaves_with_paths``): an ``LM``'s masters as the reference's
parameter leaves, each layer slot stacked on a leading axis.

The reference compiles one SPMD program per mesh, and its
``constrain`` asks XLA for a layout.  The port has one controller that
runs the step on the gathered state, so ``constrain`` returns its
input and nothing in the model calls it; what the mesh changes in the
model is ``axis_size("tp")`` (attention head padding, the cache's head
count).
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch

# logical -> physical mesh axis (or tuple of axes)
DEFAULT_RULES: Dict[str, object] = {
    "dp": ("pod", "data"),    # batch parallelism
    "tp": "model",            # tensor parallelism
    "ep": "model",            # expert parallelism (when E divides)
    "fsdp": "data",           # ZeRO-3-style weight sharding over data
    "sp": "model",            # sequence parallelism (residual stream)
}

# Serving rules: weights stay stationary (tensor-parallel only).  FSDP
# is a training optimisation -- at decode batch sizes the per-layer
# weight all-gathers it implies dominate the step.
SERVE_RULES: Dict[str, object] = {
    "dp": ("pod", "data"),
    "tp": "model",
    "ep": "model",
    "fsdp": None,
    "sp": "model",
}

_STATE = {"mesh": None, "rules": dict(DEFAULT_RULES)}


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry
    per leading dimension, each ``None`` (replicated), a mesh-axis name
    or a tuple of names (split over their product, the first major).
    A one-name tuple is stored as the name, so specs compare as the
    reference's do: entry for entry (``P()`` is not ``P(None)``)."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def mesh_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split dimension ``dim`` (none past the
        spec's length)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return tuple(e) if isinstance(e, tuple) else (e,)


class NamedSharding(NamedTuple):
    """A leaf's placement: a mesh and the spec that splits it over that
    mesh's axes (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P


# tuple types that are leaves of a tree, not containers
_LEAVES = (P, NamedSharding)


@contextlib.contextmanager
def activate(mesh, rules: Optional[Dict[str, object]] = None):
    """Install the logical->physical mapping for ``logical_spec`` /
    ``axis_size`` (``mesh=None`` installs no mesh)."""
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["rules"] = dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _STATE.update(prev)


def _axis_size(mesh, phys) -> int:
    if isinstance(phys, (tuple, list)):
        n = 1
        for a in phys:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(phys, 1)


def _phys_for(mesh, logical) -> Optional[object]:
    phys = _STATE["rules"].get(logical)
    if phys is None:
        return None
    if isinstance(phys, (tuple, list)):
        present = tuple(a for a in phys if a in mesh.shape)
        return present or None
    return phys if phys in mesh.shape else None


def logical_spec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...]
                 ) -> P:
    """Resolve logical axes against the active mesh into a ``P``,
    dropping non-divisible dimensions and suppressing duplicate
    physical axes (e.g. MoE 'ep' and 'tp' both map to 'model':
    whichever resolves first wins, the other is dropped)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return P()
    spec = []
    used = set()
    for dim, logical in zip(shape, axes):
        phys = _phys_for(mesh, logical) if logical else None
        if phys is not None:
            phys_set = set(phys) if isinstance(phys, tuple) else {phys}
            if phys_set & used:
                phys = None
        if phys is not None and dim % _axis_size(mesh, phys) == 0:
            spec.append(phys)
            used |= set(phys) if isinstance(phys, tuple) else {phys}
        else:
            spec.append(None)
    return P(*spec)


def axis_size(logical: str) -> int:
    """Mesh size behind a logical axis (1 when no mesh is active) --
    lets model code pick between alternative layouts (e.g. padding
    attention heads to a multiple of the tensor-parallel axis)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return 1
    phys = _phys_for(mesh, logical)
    return _axis_size(mesh, phys) if phys is not None else 1


def constrain(x, axes: Tuple[Optional[str], ...]):
    """The reference's ``with_sharding_constraint`` on logical axes.
    The port runs one controller over the gathered state, with no SPMD
    compiler to ask for a layout, so this returns ``x`` itself, with or
    without an active mesh."""
    return x


# ---------------------------------------------------------------------------
# Parameter layouts
# ---------------------------------------------------------------------------

# (path regex, logical axes per dim) -- first match wins.  Paths look
# like 'embed', 'layers/attn/wq', 'layers/moe/w_gate', ...  Stacked
# layer params carry a leading L dim (axis None).
_PARAM_RULES = [
    (r"embed$",               ("tp", "fsdp")),               # (V, d)
    (r"lm_head$",             ("fsdp", "tp")),               # (d, V)
    (r"layers/.*attn/w[qkv]$", (None, "fsdp", "tp")),        # (L, d, H*hd)
    (r"layers/.*attn/wo$",    (None, "tp", "fsdp")),         # (L, H*hd, d)
    (r"layers/.*attn/b[qkv]$", (None, "tp")),                # (L, H*hd)
    (r"layers/.*attn/[qk]_norm$", (None, None)),             # (L, hd)
    (r"layers/.*mlp/w_(gate|up)$", (None, "fsdp", "tp")),    # (L, d, ff)
    (r"layers/.*mlp/w_down$", (None, "tp", "fsdp")),         # (L, ff, d)
    (r"layers/moe/router$",   (None, "fsdp", None)),         # (L, d, E)
    (r"layers/moe/w_(gate|up)$", (None, "ep", "fsdp", "tp")),  # (L,E,d,ff)
    (r"layers/moe/w_down$",   (None, "ep", "tp", "fsdp")),   # (L,E,ff,d)
    (r"layers/.*ssm/w_in$",   (None, "fsdp", "tp")),         # (L, d, 2d_in)
    (r"layers/.*ssm/conv_w$", (None, None, "tp")),           # (L, k, d_in)
    (r"layers/.*ssm/w_bcdt$", (None, "tp", None)),           # (L, d_in, *)
    (r"layers/.*ssm/a_log$",  (None, "tp", None)),           # (L, d_in, N)
    (r"layers/.*ssm/(d_skip|dt_bias)$", (None, "tp")),       # (L, d_in)
    (r"layers/.*ssm/w_out$",  (None, "tp", "fsdp")),         # (L, d_in, d)
    (r"layers/.*mlstm/w_up$", (None, "fsdp", "tp")),         # (L, d, 2d_in)
    (r"layers/.*mlstm/w[qkv]$", (None, "fsdp", "tp")),       # (L, d_in, d_in)
    (r"layers/.*mlstm/w_if$", (None, "fsdp", None)),         # (L, d_in, 2H)
    (r"layers/.*mlstm/ln$",   (None, None)),
    (r"layers/.*mlstm/w_down$", (None, "tp", "fsdp")),       # (L, d_in, d)
    (r"layers/.*slstm/w_gates$", (None, "fsdp", "tp")),      # (L, d, 4d)
    (r"layers/.*slstm/r_gates$", (None, None, None, None)),  # (L,H,4hd,hd)
    (r"layers/.*slstm/w_up$", (None, "fsdp", "tp")),
    (r"layers/.*slstm/w_down$", (None, "tp", "fsdp")),
    (r"layers/.*slstm/ln$",   (None, None)),
    (r".*norm.*$",            None),                         # replicated
    (r".*$",                  None),
]


def _path_str(path) -> str:
    """A path of the port's tree walk (``leaves_with_paths``: dict keys,
    ``NamedTuple`` field names, a ``Quant8``'s ``q`` / ``scale``) as the
    reference's '/'-joined string."""
    return "/".join(str(k) for k in path)


def spec_for_path(path: str, shape: Tuple[int, ...]) -> P:
    """Match a parameter path against the rules.  Paths may carry any
    prefix (state trees embed the param tree under params/mu/nu) and
    Quant8-wrapped moments are matched via their parent path."""
    # Quant8 leaves: .../<param>/q (payload, param-shaped) and
    # .../<param>/scale (replicated per-block scales).
    if path.endswith("/scale") or path.endswith("/1"):
        return P()
    if path.endswith("/q") or path.endswith("/0"):
        head = path.rsplit("/", 1)[0]
        if re.search(r"(embed|lm_head|w[a-z_]*|r_gates|router|a_log|"
                     r"conv_w|d_skip|dt_bias|b[qkv])$", head):
            path = head
    for pattern, axes in _PARAM_RULES:
        if re.search(pattern, path):
            if axes is None:
                return P()
            axes = tuple(axes[: len(shape)]) + (None,) * (len(shape) - len(axes))
            return logical_spec(shape, axes)
    return P()


def leaves_with_paths(tree, prefix: tuple = ()):
    """(path, leaf) of every leaf of a port tree in the reference's
    order (``jax.tree_util.tree_flatten_with_path``): dicts by sorted
    key and an ``LM`` as its parameter leaves (``models.convert.
    tree_items``), ``NamedTuple`` s (``TrainState``, ``AdamWState``,
    ``Quant8``) by field name, other tuples by index; ``None`` has no
    leaf; a ``P`` or ``NamedSharding`` is a leaf.  A layer slot of an
    ``LM`` is one leaf: the list of its layers' tensors, which the
    reference stacks on a leading axis."""
    from repro_torch.models.convert import tree_items
    from repro_torch.models.model import LM

    if tree is None:
        return
    if isinstance(tree, (dict, LM)):
        for path, leaf in tree_items(tree):
            yield from leaves_with_paths(leaf, prefix + path)
    elif isinstance(tree, tuple) and not isinstance(tree, _LEAVES):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, x in zip(names, tree):
            yield from leaves_with_paths(x, prefix + (str(name),))
    else:
        yield prefix, tree


def leaf_shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape as the reference sees it: a layer slot stacked."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def map_leaves(fn, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over every leaf, in a tree of the reference's
    layout: dicts (an ``LM`` as the nested dict of its parameter leaves)
    and the same ``NamedTuple`` types; ``None`` stays ``None``."""
    from repro_torch.models.convert import nest
    from repro_torch.models.model import LM

    if tree is None:
        return None
    if isinstance(tree, LM):
        return nest((path, fn(prefix + path, leaf))
                    for path, leaf in leaves_with_paths(tree))
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and not isinstance(tree, _LEAVES):
        names = getattr(tree, "_fields", range(len(tree)))
        out = [map_leaves(fn, x, prefix + (str(n),))
               for n, x in zip(names, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(prefix, tree)


def tree_shardings(mesh, tree):
    """``NamedSharding`` tree for any state tree (params, optimizer
    moments, train state) via path-based rules, in the reference's
    layout (``map_leaves``).  Needs ``activate(mesh)`` to split
    anything, as the reference's does."""
    return map_leaves(lambda path, leaf: NamedSharding(
        mesh, spec_for_path(_path_str(path), leaf_shape(leaf))), tree)


def param_specs(params) -> object:
    """``P`` tree matching ``params`` (requires an active mesh via
    ``activate``; otherwise everything is replicated)."""
    return map_leaves(lambda path, leaf: spec_for_path(
        _path_str(path), leaf_shape(leaf)), params)


def named_shardings(mesh, params):
    """``NamedSharding`` tree of ``param_specs`` on ``mesh``."""
    return tree_shardings(mesh, params)


# ---------------------------------------------------------------------------
# Storage-shard fan-out (the bench_db engine's per-shard dispatch)
# ---------------------------------------------------------------------------
#
# Unlike the model-parallel rules above, the storage engine shards
# *pages of one table* across a shard list and fans one scan dispatch
# out per shard (core/engine.py).  This helper is the policy of the
# one-device-per-shard fan-out (``core.engine.pmap_batched_full_
# table_scan``).

def shard_fanout_devices(n_shards: int
                         ) -> Optional[Tuple[torch.device, ...]]:
    """Devices for a one-device-per-shard fan-out, or None.

    Returns the first ``n_shards`` local devices
    (``parallel.mesh.local_devices``: the cards, or a forced list) when
    enough exist; None means the caller must keep the single-device
    fan-out.
    """
    from repro_torch.parallel.mesh import local_devices

    if n_shards < 2:
        return None
    devices = local_devices()
    if len(devices) < n_shards:
        return None
    return devices[:n_shards]

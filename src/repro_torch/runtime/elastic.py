"""Elastic scaling: re-shard state onto a different mesh.

Port of ``repro.runtime.elastic``.  Checkpoints store logically
unsharded arrays (``runtime.checkpoint``), so growing 256 -> 512 chips
or shrinking to a degraded 8 x 16 mesh is::

    state = ckpt.restore(like)                  # whole leaves
    state = reshard_state(new_mesh, state)      # split with new specs

``reshard_state`` re-derives every leaf's spec from the same path rules
the trainer uses (``parallel.sharding``), so the layout is always the
one the reference's recompiled step expects.  The batch schedule is
preserved by keeping the GLOBAL batch size fixed and letting the
per-device batch change with the data-parallel degree -- optimizer
hyperparameters need no adjustment on a mesh change (the "consistent
global batch" elasticity policy).

The port's step runs on one controller over the gathered state
(``gather_state``); a resharded state shows the placement -- which
device entry holds which slice of which leaf -- and gives the leaves
back bit for bit.
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch

from repro_torch.parallel import sharding as shardlib


class ShardedTensor:
    """One leaf split over a mesh: ``shards[i]`` is the slice that the
    mesh's entry i (``mesh.flat_devices``, row-major) holds, a
    contiguous tensor on that entry's device.  Dimension k of the leaf
    is cut into as many equal contiguous slices as the product of the
    sizes of ``spec``'s mesh axes for it; an entry's slice index is its
    mesh coordinates over those axes, the first major.  Entries that
    name the same device and hold the same slice share one tensor: a
    leaf the spec does not split (or splits over fewer axes than the
    mesh has) is stored once per device, not once per entry."""

    __slots__ = ("mesh", "spec", "shape", "dtype", "shards", "_keys")

    def __init__(self, mesh, spec: shardlib.P, leaf):
        layers = leaf if isinstance(leaf, list) else None
        self.mesh, self.spec = mesh, spec
        self.shape = shardlib.leaf_shape(leaf)
        self.dtype = (layers[0] if layers else leaf).dtype
        self._keys = [self._slices(c) for c in
                      itertools.product(*map(range, mesh.shape.values()))]
        made: Dict[Tuple, torch.Tensor] = {}
        shards = []
        for dev, key in zip(mesh.flat_devices, self._keys):
            if (dev, key) not in made:
                made[(dev, key)] = _take(leaf, key, dev)
            shards.append(made[(dev, key)])
        self.shards = tuple(shards)

    def _slices(self, coords) -> Tuple[slice, ...]:
        at = dict(zip(self.mesh.shape, coords))
        out = []
        for dim, n in enumerate(self.shape):
            axes = self.spec.mesh_axes(dim)
            parts, idx = 1, 0
            for a in axes:
                parts *= self.mesh.shape[a]
                idx = idx * self.mesh.shape[a] + at[a]
            if n % parts:
                raise ValueError(f"dimension {dim} of {self.shape} does not "
                                 f"split {parts} ways ({self.spec})")
            size = n // parts
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    @property
    def split_counts(self) -> Tuple[int, ...]:
        """Slices per dimension."""
        out = []
        for dim in range(len(self.shape)):
            n = 1
            for a in self.spec.mesh_axes(dim):
                n *= self.mesh.shape[a]
            out.append(n)
        return tuple(out)

    def nbytes(self) -> int:
        """Bytes held over all devices (shared slices counted once)."""
        return sum(t.numel() * t.element_size()
                   for t in {id(t): t for t in self.shards}.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (the first entry's by default)."""
        device = torch.device(device) if device is not None \
            else self.mesh.flat_devices[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for key, t in zip(self._keys, self.shards):
            if key not in done:
                out[key] = t.to(device)
                done.add(key)
        return out


def _take(leaf, key, device) -> torch.Tensor:
    """A contiguous copy of ``leaf[key]`` on ``device`` (a layer slot's
    tensors stacked over the slice of its leading axis only)."""
    if isinstance(leaf, list):
        part = torch.stack([t.detach()[key[1:]] for t in leaf[key[0]]])
        return part.to(device)
    return leaf.detach()[key].to(device, copy=True,
                                 memory_format=torch.contiguous_format)


def reshard_state(mesh, state):
    """Split every leaf of ``state`` with the spec derived for ``mesh``
    (the reference's ``device_put`` of each leaf with its sharding).
    Returns the state in the reference's layout -- dicts and the same
    ``NamedTuple`` types, an ``LM`` as the nested dict of its stacked
    parameter leaves -- with a ``ShardedTensor`` per leaf."""
    with shardlib.activate(mesh):
        return shardlib.map_leaves(
            lambda path, leaf: ShardedTensor(
                mesh, shardlib.spec_for_path(shardlib._path_str(path),
                                             shardlib.leaf_shape(leaf)),
                leaf), state)


def gather_state(state, device=None):
    """Every ``ShardedTensor`` of ``state`` gathered whole on ``device``
    (the first mesh entry's by default): the counterpart of
    ``jax.device_get`` on a sharded state, giving back the leaves that
    ``reshard_state`` split, bit for bit (a layer slot as one stacked
    tensor)."""
    return shardlib.map_leaves(lambda path, leaf: leaf.gather(device),
                               state)


def degraded_mesh_options(n_devices: int):
    """Feasible (data, model) meshes for a degraded device count,
    largest model-parallel degree first (prefer keeping TP intact so
    big models still fit)."""
    opts = []
    for model in (16, 8, 4, 2, 1):
        if n_devices % model == 0:
            opts.append((n_devices // model, model))
    return opts

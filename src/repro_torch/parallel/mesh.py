"""Storage-engine device mesh: the placement of the stacked shard axis.

Port of ``repro.parallel.mesh``.  The batched sharded scan families can
run over a *named* device grid: the stacked shard axis of a
``ShardedTable`` is bound to the grid's ``"shard"`` axis, so device i
owns the contiguous shards ``[i * S / d, (i + 1) * S / d)``, and an
optional second ``"qbatch"`` axis splits a read burst's queries the
same way.  The reference maps one body over the grid with
``shard_map``; the port has one controller, which loops over the
device slices (``core.engine``'s ``mesh_*`` forms) and reduces their
partials on the first device.  int32 add / max / min associate and
commute, so the reductions give the single-device stacked dispatch's
bits for any device count.

This module owns everything device-shaped, so ``core.engine`` never
asks torch which devices exist:

* ``make_scan_mesh``   -- the grid (the reference's placement rule),
  cached per (n_shards, query_axis, devices).
* ``stacked_specs`` / ``batch_spec`` / ``replicated_spec`` -- which
  axis of an operand the grid splits, as plain descriptors.
* ``local_devices``    -- the devices a grid may claim.
* ``force_local_devices`` -- the counterpart of XLA's
  ``--xla_force_host_platform_device_count``: a context manager that
  makes ``local_devices`` return a given list, such as d entries that
  all name ``cuda:0`` or ``cpu``.  Such a list shows the split, the
  per-slice launches and the reductions; it does not show placement
  or speed across cards.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch

SHARD_AXIS = "shard"
QUERY_AXIS = "qbatch"

_forced: Optional[Tuple[torch.device, ...]] = None


@contextlib.contextmanager
def force_local_devices(devices):
    """Within the block, ``local_devices()`` returns ``devices``."""
    global _forced
    before = _forced
    _forced = tuple(torch.device(d) for d in devices)
    try:
        yield _forced
    finally:
        _forced = before


def local_devices(device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """The devices a grid may claim: the forced list inside
    ``force_local_devices``; else every card (``cuda:i``) for a CUDA
    engine, or the one CPU for a CPU engine."""
    if _forced is not None:
        return _forced
    if device_type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


class ScanMesh:
    """A (d, q) grid of devices with named axes, like
    ``jax.sharding.Mesh``: ``devices[i][j]`` owns shard slice i and
    query slice j.  Immutable."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices, axis_names):
        object.__setattr__(self, "devices",
                           tuple(tuple(row) for row in devices))
        object.__setattr__(self, "axis_names", tuple(axis_names))

    def __setattr__(self, name, value):
        raise AttributeError("ScanMesh is immutable")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``Mesh.shape``."""
        d, q = len(self.devices), len(self.devices[0])
        out = {SHARD_AXIS: d}
        if QUERY_AXIS in self.axis_names:
            out[QUERY_AXIS] = q
        return out

    def __repr__(self) -> str:
        return f"ScanMesh({self.shape}, {self.devices})"


@functools.lru_cache(maxsize=32)
def _make_scan_mesh(n_shards: int, q: int,
                    devices: tuple) -> Optional[ScanMesh]:
    avail = len(devices) // q
    d = 0
    for cand in range(min(n_shards, avail), 1, -1):
        if n_shards % cand == 0:
            d = cand
            break
    if d < 2:
        return None
    grid = [devices[i * q:(i + 1) * q] for i in range(d)]
    if q == 1:
        return ScanMesh(grid, (SHARD_AXIS,))
    return ScanMesh(grid, (SHARD_AXIS, QUERY_AXIS))


def make_scan_mesh(n_shards: int, query_axis: int = 1,
                   device_type: str = "cuda") -> Optional[ScanMesh]:
    """Grid binding the stacked shard axis to local devices.

    Picks the largest device count d >= 2 that divides ``n_shards``
    (each device then owns ``n_shards / d`` consecutive shards);
    ``query_axis > 1`` also folds a second ``"qbatch"`` axis for 2-D
    read bursts, so d * query_axis devices are claimed.  Returns None
    when no such placement exists -- the caller falls back to the
    single-device stacked dispatch.  Cached per (n_shards, query_axis,
    devices): the device tuple is part of the key, so a forced list
    never outlives its block.
    """
    q = max(1, int(query_axis))
    return _make_scan_mesh(int(n_shards), q, local_devices(device_type))


def stacked_specs() -> Tuple[str]:
    """Axis spec *prefix* of every stacked-shard operand (table planes,
    per-shard index arrays, coverage mask and words): the leading axis
    is split over the shard axis."""
    return (SHARD_AXIS,)


def batch_spec(mesh: ScanMesh) -> tuple:
    """Spec of the per-query ``(B,)`` operands and results: split over
    the query axis on 2-D grids, replicated on 1-D grids."""
    return (QUERY_AXIS,) if QUERY_AXIS in mesh.axis_names else ()


def replicated_spec() -> tuple:
    return ()


def query_axis_size(mesh: ScanMesh) -> int:
    return int(mesh.shape.get(QUERY_AXIS, 1))


def mesh_device_count(mesh: ScanMesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= int(v)
    return n

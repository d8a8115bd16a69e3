"""Production mesh construction: the port of ``repro.launch.mesh``.

A function (never a module-level constant) so importing this module
never touches device state.  The single-pod production mesh is 16 x 16
= 256 chips (data x model); the multi-pod mesh prepends a 2-way 'pod'
axis (512 chips).  Batch parallelism spans ('pod', 'data');
tensor / expert parallelism lives on 'model'.

The meshes are ``parallel.mesh.ScanMesh`` grids over
``parallel.mesh.local_devices``, and, as ``jax.make_mesh``, raise when
fewer devices exist than the shape needs.  One card is one device, so
the production and debug meshes are built under
``parallel.mesh.force_local_devices`` (the counterpart of XLA's
``--xla_force_host_platform_device_count``): 512 entries naming
``meta`` for the dry run, 8 naming ``cpu`` or ``cuda:0`` for the tests
and the card.
"""
from __future__ import annotations

from repro_torch.parallel.mesh import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False):
    """Small mesh for CI-scale sharding tests (run under a forced list
    of 8 local devices)."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), ("pod", "data", "model"))
    return make_mesh((n_data, n_model), ("data", "model"))


def batch_spec_axes(mesh) -> tuple:
    """Physical axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)

"""Device-mesh helpers for multi-device execution.

The reference is strictly single-GPU (SURVEY.md §2.3); this layer is the
scaling story: a ``jax.sharding.Mesh`` over the local devices (any
device can reach any other, so the mesh follows the algorithm), batch data
parallelism for frame stacks (the generalization of the reference's
batched-1D kernel, separable.cu:214-236) and spatial row-sharding with
halo exchange for single large images (the distributed analog of the
kernels' in-thread periodic indexing, separable.cu:112-121).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "data"
ROW_AXIS = "rows"
COL_AXIS = "cols"


def make_mesh(n_data: int | None = None, n_rows: int = 1,
              devices=None) -> Mesh:
    """A (data, rows) mesh.  Defaults to all devices on the data axis."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_rows
    use = np.asarray(devices[: n_data * n_rows]).reshape(n_data, n_rows)
    return Mesh(use, (BATCH_AXIS, ROW_AXIS))


def make_mesh2d(n_rows: int, n_cols: int, devices=None) -> Mesh:
    """A (rows, cols) mesh for grid-sharding one large image across chips
    in both spatial dimensions."""
    if devices is None:
        devices = jax.devices()
    use = np.asarray(devices[: n_rows * n_cols]).reshape(n_rows, n_cols)
    return Mesh(use, (ROW_AXIS, COL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (frame/batch) axis across the data axis."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard image rows (axis -2 of a 2D image) across the rows axis."""
    return NamedSharding(mesh, P(ROW_AXIS, None))


def multihost_initialize(**kwargs):
    """Initialize multi-host JAX (the distributed runtime layer; no
    counterpart in the single-GPU reference).  Safe to call once per
    process before any jax op."""
    jax.distributed.initialize(**kwargs)

"""Batch data parallelism over frame stacks.

Shards a stack of images (tomography frames, video, ...) across the mesh's
data axis; every transform in the functional core is batch-polymorphic
(leading axes are carried through), so the per-device computation is the
plain single-device path and XLA inserts no collectives for the transforms.
Norm reductions become ``psum`` over the mesh (the distributed analog of
the reference's cuBLAS reductions, wt.cu:368-416).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core import dwt, haar, swt, thresh
from .mesh import BATCH_AXIS


def shard_stack(stack, mesh):
    """Place a (B, ...) stack with its leading axis sharded over the data
    axis."""
    spec = P(BATCH_AXIS, *([None] * (stack.ndim - 1)))
    return jax.device_put(stack, NamedSharding(mesh, spec))


def _sharding_tree(mesh):
    def to_spec(x):
        return NamedSharding(mesh, P(BATCH_AXIS, *([None] * (x.ndim - 1))))
    return to_spec


def wavedec2_batched(stack, fb, levels, mesh):
    """Multi-level 2D forward transform of a sharded (B, Nr, Nc) stack.

    The batch axis stays sharded through every level (all ops are local);
    returns the pyramid with each leaf sharded the same way.
    """
    fn = jax.jit(lambda x: dwt.wavedec2(x, fb, levels))
    return fn(shard_stack(stack, mesh))


def waverec2_batched(coeffs, fb, shape, mesh):
    fn = jax.jit(lambda c: dwt.waverec2(c, fb, shape))
    return fn(coeffs)


def swt2d_batched(stack, fb, levels, mesh):
    fn = jax.jit(lambda x: swt.swt2d(x, fb, levels))
    return fn(shard_stack(stack, mesh))


def denoise_batched(stack, fb, levels, beta, mesh, normalize=False,
                    hard=False):
    """Fused distributed denoise step: forward -> threshold -> inverse on a
    sharded frame stack (the reference's doc/denoising.rst pipeline,
    scaled out)."""
    shape = stack.shape

    def step(x):
        if fb.hlen == 2:
            pyr = haar.haar_wavedec2(x, levels)
        else:
            pyr = dwt.wavedec2(x, fb, levels)
        th = thresh.hard_threshold if hard else thresh.soft_threshold
        pyr = th(pyr, beta, do_thresh_appcoeffs=False, normalize=normalize)
        if fb.hlen == 2:
            return haar.haar_waverec2(pyr, shape)
        return dwt.waverec2(pyr, fb, shape)

    return jax.jit(step)(shard_stack(stack, mesh))


def norms_batched(coeffs):
    """Global L1 and squared-L2 norms of a (sharded) pyramid.  jnp
    reductions over sharded arrays compile to per-shard reductions plus an
    XLA collective — no explicit psum needed under jit."""
    return thresh.norm1(coeffs), thresh.norm2sq(coeffs)

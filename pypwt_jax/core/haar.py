"""Haar fast path — butterfly transforms without general convolution.

Equivalent to the reference's dedicated haar kernels (haar.cu:10-58 for 2D,
:128-160 for 1D), used when hlen == 2 and not SWT (wt.cu:248, :255).  The 2D
path applies a single 0.5 scaling per butterfly (exact in float32, unlike
two 1/sqrt(2) passes), reproducing the reference's precision behavior.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from . import conv
from .shapes import div2

_ONE_SQRT2 = math.sqrt(0.5)


def _extend_even_2d(x):
    x = conv._odd_extend_last(x)
    xt = jnp.swapaxes(x, -1, -2)
    xt = conv._odd_extend_last(xt)
    return jnp.swapaxes(xt, -1, -2)


def haar_dwt2d(x):
    """One 2D haar level -> (a, h, v, d) (haar.cu:10-37)."""
    xe = _extend_even_2d(x)
    # single-axis strided slices only: XLA may lower a (..., i::2, j::2)
    # double-strided slice to a gather
    xe0 = xe[..., 0::2, :]
    xe1 = xe[..., 1::2, :]
    p00 = xe0[..., 0::2]
    p01 = xe0[..., 1::2]
    p10 = xe1[..., 0::2]
    p11 = xe1[..., 1::2]
    sy0 = p00 + p10  # column sums (AVG along rows)
    sy1 = p01 + p11
    dy0 = p00 - p10
    dy1 = p01 - p11
    half = jnp.asarray(0.5, xe.dtype)
    a = half * (sy0 + sy1)
    v = half * (sy0 - sy1)
    h = half * (dy0 + dy1)
    d = half * (dy0 - dy1)
    return a, h, v, d


def haar_idwt2d(a, h, v, d, out_shape):
    """One 2D haar inverse level (haar.cu:41-58)."""
    half = jnp.asarray(0.5, a.dtype)
    o00 = half * (a + h + v + d)
    o01 = half * (a + h - v - d)
    o10 = half * (a - h + v - d)
    o11 = half * (a - h - v + d)
    top = jnp.stack([o00, o01], axis=-1).reshape(*o00.shape[:-1],
                                                 2 * o00.shape[-1])
    bot = jnp.stack([o10, o11], axis=-1).reshape(*o00.shape[:-1],
                                                 2 * o00.shape[-1])
    out = jnp.stack([top, bot], axis=-2).reshape(*o00.shape[:-2],
                                                 2 * o00.shape[-2],
                                                 2 * o00.shape[-1])
    return out[..., :out_shape[-2], :out_shape[-1]]


def haar_dwt1d(x):
    """One (batched) 1D haar level along the last axis (haar.cu:132-146)."""
    if x.ndim == 1:
        rc = conv.long1d_shape(x.shape[0])
        if rc is not None:
            from ..filters import get_filter_bank
            b = get_filter_bank("haar")
            return conv.analysis_long1d(x, b.dec_lo, b.dec_hi, rc)
    xe = conv._odd_extend_last(x)
    e = xe[..., 0::2]
    o = xe[..., 1::2]
    s = jnp.asarray(_ONE_SQRT2, xe.dtype)
    return s * (e + o), s * (e - o)


def haar_idwt1d(a, d, n_out):
    """One (batched) 1D haar inverse level (haar.cu:149-160)."""
    if a.ndim == 1 and n_out == 2 * a.shape[0]:
        rc = conv.long1d_shape(a.shape[0])
        if rc is not None:
            from ..filters import get_filter_bank
            b = get_filter_bank("haar")
            return conv.synthesis_long1d(a, d, b.rec_lo, b.rec_hi,
                                         n_out, rc)
    s = jnp.asarray(_ONE_SQRT2, a.dtype)
    e = s * (a + d)
    o = s * (a - d)
    out = jnp.stack([e, o], axis=-1).reshape(*a.shape[:-1], 2 * a.shape[-1])
    return out[..., :n_out]


def haar_wavedec2(image, levels):
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = haar_dwt2d(a)
        details.append((h, v, d))
    return [a] + details


def haar_waverec2(coeffs, shape):
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = haar_idwt2d(a, h, v, d, sizes[lev - 1])
    return a


def haar_wavedec1(x, levels):
    a = x
    details = []
    for _ in range(levels):
        a, d = haar_dwt1d(a)
        details.append(d)
    return [a] + details


def haar_waverec1(coeffs, n):
    levels = len(coeffs) - 1
    sizes = [n]
    for _ in range(levels):
        sizes.append(div2(sizes[-1]))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = haar_idwt1d(a, coeffs[lev], sizes[lev - 1])
    return a

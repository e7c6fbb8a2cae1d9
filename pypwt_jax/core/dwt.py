"""Multi-level separable DWT (1D, batched-1D, 2D), forward and inverse.

Functional equivalents of the reference's host-side level loops
(w_forward_separable, separable.cu:179-209; w_inverse_separable,
separable.cu:332-364; 1D variants :214-236, :368-395).  The coefficient
pyramid is a PyTree list — 2D: ``[A, (H1, V1, D1), ..., (Hn, Vn, Dn)]``,
1D: ``[A, D1, ..., Dn]`` — replacing the reference's manually managed
device-buffer array (common.cu:400-445).

Axis convention (matches the reference): the last axis is the "column" axis
filtered by pass 1; the second-to-last axis is filtered by pass 2.  1D
transforms filter only the last axis, so a 2D input gives the reference's
batched-1D mode (pypwt.pyx:146-151).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import conv
from .shapes import div2


def dwt1d(x, fb):
    """One analysis level along the last axis -> (a, d).

    Single long signals are folded into rows with inter-row halos
    (``conv.long1d_shape``) and run as the batched-row form."""
    if x.ndim == 1:
        rc = conv.long1d_shape(x.shape[0])
        if rc is not None and fb.hlen <= rc[1] // 2:
            return conv.analysis_long1d(x, fb.dec_lo, fb.dec_hi, rc)
    return conv.analysis_last(x, fb.dec_lo, fb.dec_hi)


def idwt1d(a, d, fb, n_out):
    """One synthesis level along the last axis."""
    if a.ndim == 1 and n_out == 2 * a.shape[0]:
        rc = conv.long1d_shape(a.shape[0])
        if rc is not None and fb.hlen <= rc[1] // 2:
            return conv.synthesis_long1d(a, d, fb.rec_lo, fb.rec_hi,
                                         n_out, rc)
    return conv.synthesis_last(a, d, fb.rec_lo, fb.rec_hi, n_out)


def dwt2d(x, fb):
    """One separable 2D analysis level -> (a, h, v, d).

    Pass 1 filters the last (column) axis, pass 2 the row axis, exactly the
    reference's kernel pair (separable.cu:91-176).
    """
    t1, t2 = conv.analysis_last(x, fb.dec_lo, fb.dec_hi)
    t1 = jnp.swapaxes(t1, -1, -2)
    t2 = jnp.swapaxes(t2, -1, -2)
    a, h = conv.analysis_last(t1, fb.dec_lo, fb.dec_hi)
    v, d = conv.analysis_last(t2, fb.dec_lo, fb.dec_hi)
    return (jnp.swapaxes(a, -1, -2), jnp.swapaxes(h, -1, -2),
            jnp.swapaxes(v, -1, -2), jnp.swapaxes(d, -1, -2))


def idwt2d(a, h, v, d, fb, out_shape):
    """One separable 2D synthesis level -> image of ``out_shape``."""
    nr, nc = out_shape[-2], out_shape[-1]
    at = jnp.swapaxes(a, -1, -2)
    ht = jnp.swapaxes(h, -1, -2)
    vt = jnp.swapaxes(v, -1, -2)
    dt = jnp.swapaxes(d, -1, -2)
    t1 = conv.synthesis_last(at, ht, fb.rec_lo, fb.rec_hi, nr)
    t2 = conv.synthesis_last(vt, dt, fb.rec_lo, fb.rec_hi, nr)
    t1 = jnp.swapaxes(t1, -1, -2)
    t2 = jnp.swapaxes(t2, -1, -2)
    return conv.synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi, nc)


def wavedec2(image, fb, levels: int):
    """Multi-level separable 2D forward transform -> pyramid list."""
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = dwt2d(a, fb)
        details.append((h, v, d))
    return [a] + details


def waverec2(coeffs, fb, shape):
    """Multi-level separable 2D inverse.  ``shape`` is the original image
    shape; per-level output sizes follow the div2 chain (wt.cu:332-342)."""
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = idwt2d(a, h, v, d, fb, sizes[lev - 1])
    return a


def wavedec1(x, fb, levels: int):
    """Multi-level (batched) 1D forward transform along the last axis."""
    a = x
    details = []
    for _ in range(levels):
        a, d = dwt1d(a, fb)
        details.append(d)
    return [a] + details


def waverec1(coeffs, fb, n: int):
    """Multi-level (batched) 1D inverse along the last axis."""
    levels = len(coeffs) - 1
    sizes = [n]
    for _ in range(levels):
        sizes.append(div2(sizes[-1]))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = idwt1d(a, coeffs[lev], fb, sizes[lev - 1])
    return a

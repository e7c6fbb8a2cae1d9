"""Stationary (undecimated) wavelet transform, separable, multi-level.

Equivalent of the reference's a-trous SWT drivers
(w_forward_swt_separable, separable.cu:496-515; w_inverse_swt_separable,
separable.cu:629-649; 1D variants :519-537, :653-672).  All subbands keep
the input size; level-ℓ filters are dilated by 2^(ℓ-1); the inverse rescales
by 1/2 per axis pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import conv

def swt1d_level(x, fb, level):
    if x.ndim == 1:
        rc = conv.long1d_shape(x.shape[0])
        if rc is not None:
            return conv.swt_analysis_long1d(x, fb.dec_lo, fb.dec_hi,
                                            level, rc)
    return conv.swt_analysis_last(x, fb.dec_lo, fb.dec_hi, level)


def iswt1d_level(a, d, fb, level):
    if a.ndim == 1:
        rc = conv.long1d_shape(a.shape[0])
        if rc is not None:
            return conv.swt_synthesis_long1d(a, d, fb.rec_lo, fb.rec_hi,
                                             level, rc)
    return conv.swt_synthesis_last(a, d, fb.rec_lo, fb.rec_hi, level)


def swt2d_level(x, fb, level):
    """One stationary 2D analysis level -> (a, h, v, d)."""
    t1, t2 = conv.swt_analysis_last(x, fb.dec_lo, fb.dec_hi, level)
    t1 = jnp.swapaxes(t1, -1, -2)
    t2 = jnp.swapaxes(t2, -1, -2)
    a, h = conv.swt_analysis_last(t1, fb.dec_lo, fb.dec_hi, level)
    v, d = conv.swt_analysis_last(t2, fb.dec_lo, fb.dec_hi, level)
    return (jnp.swapaxes(a, -1, -2), jnp.swapaxes(h, -1, -2),
            jnp.swapaxes(v, -1, -2), jnp.swapaxes(d, -1, -2))


def iswt2d_level(a, h, v, d, fb, level):
    """One stationary 2D synthesis level (column pass then row pass)."""
    at = jnp.swapaxes(a, -1, -2)
    ht = jnp.swapaxes(h, -1, -2)
    vt = jnp.swapaxes(v, -1, -2)
    dt = jnp.swapaxes(d, -1, -2)
    t1 = conv.swt_synthesis_last(at, ht, fb.rec_lo, fb.rec_hi, level)
    t2 = conv.swt_synthesis_last(vt, dt, fb.rec_lo, fb.rec_hi, level)
    t1 = jnp.swapaxes(t1, -1, -2)
    t2 = jnp.swapaxes(t2, -1, -2)
    return conv.swt_synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi, level)


def swt2d(image, fb, levels):
    a = image
    details = []
    for lev in range(1, levels + 1):
        a, h, v, d = swt2d_level(a, fb, lev)
        details.append((h, v, d))
    return [a] + details


def iswt2d(coeffs, fb):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = iswt2d_level(a, h, v, d, fb, lev)
    return a


def swt1d(x, fb, levels):
    a = x
    details = []
    for lev in range(1, levels + 1):
        a, d = swt1d_level(a, fb, lev)
        details.append(d)
    return [a] + details


def iswt1d(coeffs, fb):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = iswt1d_level(a, coeffs[lev], fb, lev)
    return a

"""End-to-end denoising pipelines as single compiled executables.

The reference's denoising workflow (doc/denoising.rst) is a Python loop
of plan-method calls; here the whole pipeline — including cycle-spinning
averaging — compiles into one XLA program with no host round trips, with
randomness from explicit jax.random keys (the reference uses C rand(),
wt.cu:242-246).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .filters import get_filter_bank
from .core import dwt, haar, swt, thresh
from .core.shapes import clamp_levels


def _fwd_inv(fb, levels, shape, do_swt):
    if fb.hlen == 2 and not do_swt:
        return (lambda x: haar.haar_wavedec2(x, levels),
                lambda c: haar.haar_waverec2(c, shape))
    if do_swt:
        return (lambda x: swt.swt2d(x, fb, levels),
                lambda c: swt.iswt2d(c, fb))
    return (lambda x: dwt.wavedec2(x, fb, levels),
            lambda c: dwt.waverec2(c, fb, shape))


@functools.partial(jax.jit, static_argnames=(
    "wname", "levels", "do_swt", "hard", "normalize",
    "threshold_appcoeffs"))
def denoise2d(img, wname, levels, beta, do_swt=False, hard=False,
              normalize=False, threshold_appcoeffs=False):
    """forward -> threshold -> inverse, one compiled step.

    Works on a single (Nr, Nc) image or a (B, Nr, Nc) stack.
    """
    fb = get_filter_bank(wname)
    levels = clamp_levels(levels, img.shape[-2:], fb.hlen, 2)
    fwd, inv = _fwd_inv(fb, levels, img.shape, do_swt)
    pyr = fwd(img)
    th = thresh.hard_threshold if hard else thresh.soft_threshold
    pyr = th(pyr, beta, bool(threshold_appcoeffs), bool(normalize))
    return inv(pyr)


@functools.partial(jax.jit, static_argnames=(
    "wname", "levels", "n_spins", "hard", "normalize",
    "threshold_appcoeffs", "shifts"))
def denoise2d_cycle_spinning(img, wname, levels, beta, key=None,
                             n_spins=8, hard=False, normalize=False,
                             threshold_appcoeffs=False, shifts=None):
    """Translation-invariant denoising by averaging over circular shifts
    (the reference's cycle spinning, wt.cu:242-246 and :303).

    Two modes:

    * ``shifts=((r0, c0), ...)`` — a STATIC tuple of shifts.  The spins
      unroll at trace time and the rolls compile to static slices.
      Because an L-level periodized DWT is invariant to translations by
      multiples of 2^L, only shifts mod 2^levels are distinct — the
      default diagonal schedule ``((0,0), (1,1), ..)`` already covers
      distinct cosets.
    * ``key=<jax.random key>`` — ``n_spins`` random shifts drawn on
      device (reproducible), run as a lax.scan of dynamic rolls.
      Matches the reference's rand()-based behavior.
    """
    fb = get_filter_bank(wname)
    levels = clamp_levels(levels, img.shape[-2:], fb.hlen, 2)
    fwd, inv = _fwd_inv(fb, levels, img.shape, False)
    nr, nc = img.shape[-2], img.shape[-1]
    th = thresh.hard_threshold if hard else thresh.soft_threshold

    def spin(shifted):
        pyr = fwd(shifted)
        pyr = th(pyr, beta, bool(threshold_appcoeffs), bool(normalize))
        return inv(pyr)

    if shifts is not None:
        acc = None
        for sr, sc in shifts:
            rec = spin(jnp.roll(img, (sr, sc), (-2, -1)))
            rec = jnp.roll(rec, (-sr, -sc), (-2, -1))
            acc = rec if acc is None else acc + rec
        return acc / len(shifts) if len(shifts) > 1 else acc

    if key is None:
        raise ValueError("pass either a random key or static shifts")

    def one(carry, k):
        sr = jax.random.randint(k, (), 0, nr)
        sc = jax.random.randint(jax.random.fold_in(k, 1), (), 0, nc)
        shifted = jnp.roll(img, (sr, sc), (-2, -1))
        rec = jnp.roll(spin(shifted), (-sr, -sc), (-2, -1))
        return carry + rec, None

    keys = jax.random.split(key, n_spins)
    acc, _ = jax.lax.scan(one, jnp.zeros_like(img), keys)
    return acc / n_spins

"""Every bank through the stationary 2D transform, against the FFT oracle.

Rectangular 32x40 planes at two levels: the level-2 dilated supports of
the wide banks exceed the plane, so the periodized a-trous wrap folds
taps (tests/fft_oracle.py embeds them modulo the plane size).  Forward
and inverse run as one compiled program per bank.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax.filters import get_filter_bank, wavelist
from pypwt_jax.core import swt

import fft_oracle as fo


@pytest.mark.parametrize("wname", wavelist())
def test_swt2d_rect_vs_fft_oracle(wname):
    fb = get_filter_bank(wname)
    x = np.random.default_rng(31).standard_normal((32, 40))

    def fwd_inv(v):
        pyr = swt.swt2d(v, fb, 2)
        return pyr, swt.iswt2d(pyr, fb)

    got, y = jax.jit(fwd_inv)(jnp.asarray(x))
    want = fo.fft_swt2d(x, fb, 2)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-10)
    np.testing.assert_allclose(np.asarray(y), fo.fft_iswt2d(want, fb),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)

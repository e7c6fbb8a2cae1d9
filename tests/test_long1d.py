"""Long single 1D signals against the FFT oracle.

Signals of at least 2^15 even samples are folded into rows with
neighbour-row halos (conv.long1d_shape); shorter or odd lengths, and the
levels whose length stops folding, take the plain last-axis path.  Both
must give the periodized transform of the whole signal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax.core import conv, dwt, swt
from pypwt_jax.filters import get_filter_bank

import fft_oracle as fo

BANKS = ["db2", "db4", "sym8", "db10", "coif5"]
# folds to 128-sample-multiple rows / to other widths / to fewer than 128
# rows, then stops folding / never folds (short) — the fold geometry of
# each is pinned in test_fold_geometry below
LENGTHS = [1 << 16, 3 * (1 << 15), 40000, 30000]


def _sig(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def test_fold_geometry():
    assert conv.long1d_shape(1 << 16) == (128, 512)
    assert conv.long1d_shape(3 * (1 << 15)) == (128, 768)
    assert conv.long1d_shape(40000) == (8, 5000)   # no 128-row fold
    assert conv.long1d_shape(20000) is None
    assert conv.long1d_shape(30000) is None


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("wname", BANKS)
def test_long_dwt_vs_fft_oracle(wname, n):
    fb = get_filter_bank(wname)
    x = _sig(n, 1)

    def fwd_inv(v):
        pyr = dwt.wavedec1(v, fb, 4)
        return pyr, dwt.waverec1(pyr, fb, n)

    got, y = jax.jit(fwd_inv)(jnp.asarray(x))
    want = fo.fft_wavedec1(x, fb, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-10)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("wname", BANKS)
def test_long_swt_vs_fft_oracle(wname, n):
    fb = get_filter_bank(wname)
    x = _sig(n, 2)

    def fwd_inv(v):
        pyr = swt.swt1d(v, fb, 3)
        return pyr, swt.iswt1d(pyr, fb)

    got, y = jax.jit(fwd_inv)(jnp.asarray(x))
    want = fo.fft_swt1d(x, fb, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-10)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


@pytest.mark.parametrize("level", [7, 10, 11])
@pytest.mark.parametrize("wname", ["db2", "sym8"])
def test_long_swt_deep_dilations_vs_fft_oracle(wname, level):
    """At 2^16 samples folded to 512-sample rows: level 7 dilates taps by
    64 (multi-column halos), level 10 by exactly one row (pure row
    rolls), level 11 by two rows."""
    fb = get_filter_bank(wname)
    n = 1 << 16
    x = _sig(n, 3)
    assert conv.long1d_shape(n)[1] == 512
    got = jax.jit(lambda v: swt.swt1d_level(v, fb, level))(jnp.asarray(x))
    want_d = fo.fft_swt_analysis_1d(x, fb.dec_hi, level)
    want_a = fo.fft_swt_analysis_1d(x, fb.dec_lo, level)
    np.testing.assert_allclose(np.asarray(got[0]), want_a, atol=1e-10)
    np.testing.assert_allclose(np.asarray(got[1]), want_d, atol=1e-10)
    y = jax.jit(lambda a, d: swt.iswt1d_level(a, d, fb, level))(*got)
    np.testing.assert_allclose(
        np.asarray(y),
        fo.fft_swt_synthesis_1d(want_a, want_d, fb.rec_lo, fb.rec_hi,
                                level), atol=1e-10)

"""The repo core vs the independent FFT-domain oracle (tests/fft_oracle.py).

The reference validated every subband at every level against pywt
(test/test_wavelets.py:230-255); pywt is unavailable here, so this is the
second independently-derived formulation in that role: every filtering
pass is a spectral circular correlation, not a restatement of the index
algebra.  Forward subbands at every level AND inverse outputs are pinned,
for DWT + SWT, 1D + 2D, even and odd sizes.  The 2D DWT covers all 72
banks; the other sweeps run all 72 behind PYPWT_FULL_SWEEP=1 (the default
subset spans every family and both filter parities).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax.filters import get_filter_bank, wavelist
from pypwt_jax.core import dwt, swt

import fft_oracle as fo

FULL = os.environ.get("PYPWT_FULL_SWEEP", "") == "1"
_ALL = wavelist()
_SUBSET = ["haar", "db2", "db7", "db16", "sym5", "sym9", "coif2", "coif5",
           "bior1.3", "bior3.5", "bior5.5", "rbio2.6", "rbio3.1",
           "rbio6.8"]
NAMES = _ALL if FULL else _SUBSET

RNG = np.random.default_rng(77)


def _pin(got_tree, want_tree, atol):
    got = jax.tree.leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64), w,
                                   atol=atol)


@pytest.mark.parametrize("wname", _ALL)
@pytest.mark.parametrize("shape", [(64, 96), (47, 58)])
def test_dwt2d_forward_and_inverse_vs_fft_oracle(wname, shape):
    """Every bank, even and odd sizes; forward and inverse run as one
    compiled program."""
    fb = get_filter_bank(wname)
    levels = 2 if fb.hlen <= 24 else 1
    x = RNG.standard_normal(shape)
    want = fo.fft_wavedec2(x, fb, levels)

    def fwd_inv(v):
        pyr = dwt.wavedec2(v, fb, levels)
        return pyr, dwt.waverec2(pyr, fb, shape)

    got, y_got = jax.jit(fwd_inv)(jnp.asarray(x))
    _pin(got, want, 1e-10)
    y_want = fo.fft_waverec2(want, fb, shape)
    np.testing.assert_allclose(np.asarray(y_got, np.float64), y_want,
                               atol=1e-10)


@pytest.mark.parametrize("wname", NAMES if FULL else _SUBSET[:8])
@pytest.mark.parametrize("n", [32, 29])
def test_swt2d_vs_fft_oracle(wname, n):
    fb = get_filter_bank(wname)
    x = RNG.standard_normal((n, n))
    want = fo.fft_swt2d(x, fb, 2)
    got = swt.swt2d(jnp.asarray(x), fb, 2)
    _pin(got, want, 1e-10)
    y_want = fo.fft_iswt2d(want, fb)
    y_got = swt.iswt2d(got, fb)
    np.testing.assert_allclose(np.asarray(y_got, np.float64), y_want,
                               atol=1e-10)


@pytest.mark.parametrize("wname", NAMES)
@pytest.mark.parametrize("n", [96, 61])
def test_dwt1d_vs_fft_oracle(wname, n):
    fb = get_filter_bank(wname)
    levels = 2 if fb.hlen <= 16 else 1
    x = RNG.standard_normal((3, n))  # batched-1D mode
    want = fo.fft_wavedec1(x, fb, levels)
    got = dwt.wavedec1(jnp.asarray(x), fb, levels)
    _pin(got, want, 1e-10)
    y_want = fo.fft_waverec1(want, fb, n)
    y_got = dwt.waverec1(got, fb, n)
    np.testing.assert_allclose(np.asarray(y_got, np.float64), y_want,
                               atol=1e-10)


@pytest.mark.parametrize("wname", NAMES if FULL else _SUBSET[:8])
def test_swt1d_vs_fft_oracle(wname):
    fb = get_filter_bank(wname)
    x = RNG.standard_normal(64)
    want = fo.fft_swt1d(x, fb, 3)
    got = swt.swt1d(jnp.asarray(x), fb, 3)
    _pin(got, want, 1e-10)
    y_want = fo.fft_iswt1d(want, fb)
    y_got = swt.iswt1d(got, fb)
    np.testing.assert_allclose(np.asarray(y_got, np.float64), y_want,
                               atol=1e-10)


def test_oracles_agree_with_each_other():
    """The two independent derivations (scalar index algebra vs spectral)
    must coincide — a shared-misreading tripwire."""
    import oracle as so
    for wname in ("db2", "sym6", "bior3.5", "coif2"):
        fb = get_filter_bank(wname)
        for n in (32, 33):
            x = RNG.standard_normal(n)
            np.testing.assert_allclose(
                fo.fft_analysis_1d(x, fb.dec_lo),
                so.ref_analysis_1d(x, fb.dec_lo), atol=1e-11)
            L = (n + 1) // 2
            lo, hi = RNG.standard_normal(L), RNG.standard_normal(L)
            np.testing.assert_allclose(
                fo.fft_synthesis_1d(lo, hi, fb.rec_lo, fb.rec_hi, n),
                so.ref_synthesis_1d(lo, hi, fb.rec_lo, fb.rec_hi, n),
                atol=1e-11)
            a, d = RNG.standard_normal(n), RNG.standard_normal(n)
            for lev in (1, 3):
                np.testing.assert_allclose(
                    fo.fft_swt_analysis_1d(x, fb.dec_hi, lev),
                    so.ref_swt_analysis_1d(x, fb.dec_hi, lev), atol=1e-11)
                np.testing.assert_allclose(
                    fo.fft_swt_synthesis_1d(a, d, fb.rec_lo, fb.rec_hi,
                                            lev),
                    so.ref_swt_synthesis_1d(a, d, fb.rec_lo, fb.rec_hi,
                                            lev), atol=1e-11)

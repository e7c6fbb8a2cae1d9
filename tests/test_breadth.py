"""Breadth parity tests: dtype option, custom filter banks vs built-ins,
and the env-gated full 72-wavelet sweep (the reference's test_all.py,
SURVEY.md §4).

The default run keeps compile counts low (the CI box compiles remotely);
set PYPWT_FULL_SWEEP=1 for the complete 72-wavelet x workload matrix.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from pypwt_jax import Wavelets, get_filter_bank, wavelist
from pypwt_jax.core import dwt, swt

FULL = os.environ.get("PYPWT_FULL_SWEEP", "") == "1"


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# dtype option (the reference's -DDOUBLEPRECISION build, filters.h:16-30)
# ---------------------------------------------------------------------------

def test_float64_roundtrip_tighter_than_float32():
    img = _img((64, 64))
    W32 = Wavelets(img, "db4", 3)
    W32.forward()
    W32.inverse()
    e32 = float(np.abs(W32.image - img).max())

    W64 = Wavelets(img.astype(np.float64), "db4", 3, dtype=np.float64)
    W64.forward()
    assert W64.coeff_only(0).dtype == np.float64
    W64.inverse()
    e64 = float(np.abs(W64.image - img).max())
    assert e64 < 1e-10
    assert e64 < e32


def test_bad_dtype_rejected():
    with pytest.raises(ValueError):
        Wavelets(_img((32, 32)), "haar", 1, dtype=np.int32)


# ---------------------------------------------------------------------------
# Custom filter banks must reproduce the built-in wavelets exactly
# (set_wavelets_filters, pypwt.pyx:487-576; demo.cpp's CDF 9/7 = bior4.4
# and LeGall 5/3 = bior2.2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", ["bior2.2", "bior4.4", "db5"])
def test_custom_bank_matches_builtin(wname):
    img = _img((64, 64), 1)
    ref = Wavelets(img, wname, 2)
    ref.forward()

    fb = get_filter_bank(wname)
    W = Wavelets(img, wname, 2)
    W.set_wavelets_filters("custom-" + wname, fb.dec_lo, fb.dec_hi,
                           fb.rec_lo, fb.rec_hi)
    W.forward()
    for num in range(7):
        np.testing.assert_allclose(W.coeff_only(num), ref.coeff_only(num),
                                   atol=1e-6)
    W.inverse()
    assert float(np.abs(W.image - img).max()) < 7e-4


def test_custom_bank_nonseparable():
    img = _img((64, 64), 2)
    fb = get_filter_bank("db3")
    from pypwt_jax.core import nonsep as ns
    f2d = ns.Filters2D.from_bank(fb)
    W = Wavelets(img, "db3", 2, do_separable=0)
    W.set_wavelets_filters(
        "custom2d", f2d.dec[0], f2d.dec[3], f2d.rec[0], f2d.rec[3],
        LH=f2d.dec[1], HL=f2d.dec[2], i_LH=f2d.rec[1], i_HL=f2d.rec[2])
    W.forward()
    W.inverse()
    assert float(np.abs(W.image - img).max()) < 7e-4


# ---------------------------------------------------------------------------
# Wavelet sweep (full matrix behind PYPWT_FULL_SWEEP=1)
# ---------------------------------------------------------------------------

_ALL = wavelist()
_SUBSET = ["haar", "db2", "db11", "db20", "sym7", "sym20", "coif1",
           "coif5", "bior1.5", "bior3.7", "bior6.8", "rbio1.3", "rbio3.9",
           "rbio6.8"]


@pytest.mark.parametrize("wname", _ALL if FULL else _SUBSET)
def test_sweep_dwt2d_roundtrip(wname):
    shape = (64, 96)
    img = _img(shape, 3)
    x = jnp.asarray(img)
    fb = get_filter_bank(wname)
    levels = 2 if fb.hlen <= 24 else 1
    pyr = dwt.wavedec2(x, fb, levels)
    y = dwt.waverec2(pyr, fb, shape)
    err = float(jnp.abs(y - x).max())
    assert err < 3e-4, (wname, err)


@pytest.mark.parametrize("wname", _ALL if FULL else _SUBSET[:6])
def test_sweep_swt2d_roundtrip(wname):
    # periodized a-trous reconstruction holds even when the dilated filter
    # support exceeds the image (periodic_pad_last wraps multiply)
    shape = (32, 32)
    fb = get_filter_bank(wname)
    x = jnp.asarray(_img(shape, 4))
    pyr = swt.swt2d(x, fb, 2)
    y = swt.iswt2d(pyr, fb)
    err = float(jnp.abs(y - x).max())
    assert err < 3e-4, (wname, err)


def test_wavelist_has_72_entries():
    assert len(_ALL) == 72

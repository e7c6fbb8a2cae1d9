"""pywt-style compat layer: order conversion, roundtrips, and agreement
with the FFT oracle (the layer is a veneer — the oracle pins its output
convention to the pywt "periodization" semantics the reference's users
expect)."""

import numpy as np

import jax.numpy as jnp

from pypwt_jax import compat as pwt
from pypwt_jax.filters import get_filter_bank

import fft_oracle as fo

RNG = np.random.default_rng(31)


def test_dwt2_idwt2_roundtrip_and_oracle():
    x = RNG.standard_normal((64, 96))
    cA, (cH, cV, cD) = pwt.dwt2(x, "db3")
    fb = get_filter_bank("db3")
    a, h, v, d = fo.fft_dwt2d(x, fb)
    np.testing.assert_allclose(np.asarray(cA), a, atol=1e-10)
    np.testing.assert_allclose(np.asarray(cH), h, atol=1e-10)
    rec = pwt.idwt2((cA, (cH, cV, cD)), "db3")
    np.testing.assert_allclose(np.asarray(rec), x, atol=1e-10)


def test_wavedec2_order_is_deepest_first():
    x = RNG.standard_normal((64, 64))
    coeffs = pwt.wavedec2(x, "db2", level=3)
    assert len(coeffs) == 4
    # deepest detail tuple right after cA, finest last (pywt order)
    assert coeffs[1][0].shape == (8, 8)
    assert coeffs[3][0].shape == (32, 32)
    rec = pwt.waverec2(coeffs, "db2")
    np.testing.assert_allclose(np.asarray(rec), x, atol=1e-10)


def test_wavedec_waverec_1d_odd():
    x = RNG.standard_normal(101)
    coeffs = pwt.wavedec(x, "sym4", level=2)
    rec = pwt.waverec(coeffs, "sym4", n=101)
    np.testing.assert_allclose(np.asarray(rec), x, atol=1e-10)


def test_dwt_max_level_and_auto():
    assert pwt.dwt_max_level(1024, "db2") == 8  # ilog2(1024/(4-1))
    coeffs = pwt.wavedec(RNG.standard_normal(64), "haar")
    assert len(coeffs) == pwt.dwt_max_level(64, "haar") + 1


def test_swt2_iswt2_roundtrip():
    x = RNG.standard_normal((32, 32))
    coeffs = pwt.swt2(x, "db2", 3)
    assert len(coeffs) == 3
    assert coeffs[0][0].shape == (32, 32)
    rec = pwt.iswt2(coeffs, "db2")
    np.testing.assert_allclose(np.asarray(rec), x, atol=1e-9)


def test_swt_iswt_1d_roundtrip():
    x = RNG.standard_normal(64)
    coeffs = pwt.swt(x, "bior2.2", 2)
    rec = pwt.iswt(coeffs, "bior2.2")
    np.testing.assert_allclose(np.asarray(rec), x, atol=1e-9)


def test_wavelet_object_and_wavelist():
    assert "db2" in pwt.wavelist() and len(pwt.wavelist()) >= 72
    w = pwt.Wavelet("db4")
    assert w.dec_len == w.rec_len == 8
    assert w.orthogonal and w.short_family_name == "db"
    assert len(w.filter_bank) == 4 and isinstance(w.dec_lo, list)
    # a Wavelet object is accepted anywhere a name is
    x = RNG.standard_normal(64)
    cA, cD = pwt.dwt(x, w)
    rec = pwt.idwt(cA, cD, w)
    np.testing.assert_allclose(np.asarray(rec), x, atol=1e-9)
    coeffs = pwt.wavedec2(RNG.standard_normal((32, 32)), w, level=2)
    rec2 = pwt.waverec2(coeffs, w)
    assert rec2.shape == (32, 32)

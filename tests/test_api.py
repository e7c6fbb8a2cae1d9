"""Tests of the reference-compatible ``Wavelets`` class (pypwt.pyx surface).

Uses float32 end to end (the reference's DTYPE) with the reference test
suite's tolerances (test/test_wavelets.py:100-103: tol * 2^level for
forward coefficients, absolute tol for roundtrips).
"""

import numpy as np
import pytest

from pypwt_jax import Wavelets, wavelist


def _img(shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 255).astype(np.float32)


def test_construction_and_metadata():
    W = Wavelets(_img(), "db2", 3)
    assert (W.Nr, W.Nc) == (64, 64)
    assert W.levels == 3
    assert W.wname == "db2"
    assert W.sizes == [(32, 32), (16, 16), (8, 8)]
    assert not W.batched1d


def test_level_clamping():
    # ilog2(64 / (4-1)) = ilog2(21) = 4  (wt.cu:155-165)
    W = Wavelets(_img(), "db2", 99)
    assert W.levels == 4
    W = Wavelets(_img(), "db2", 0)
    assert W.levels == 1


def test_forward_inverse_roundtrip_2d():
    img = _img()
    W = Wavelets(img, "db3", 3)
    W.forward()
    W.inverse()
    err = np.abs(W.image - img).max()
    assert err < 7e-4  # idwt2 tolerance of the reference suite


def test_haar_fast_path_roundtrip():
    img = _img()
    W = Wavelets(img, "haar", 3)
    assert W.hlen == 2
    W.forward()
    W.inverse()
    assert np.abs(W.image - img).max() < 1e-3


def test_coeffs_layout_and_coeff_only():
    img = _img()
    W = Wavelets(img, "db2", 2)
    W.forward()
    c = W.coeffs
    assert len(c) == 3
    assert c[0].shape == (16, 16)
    assert isinstance(c[1], list) and len(c[1]) == 3
    assert c[1][0].shape == (32, 32)
    np.testing.assert_array_equal(W.coeff_only(1), c[1][0])
    np.testing.assert_array_equal(W.coeff_only(5), c[2][1])
    np.testing.assert_array_equal(W.coeff_only(0), c[0])


def test_energy_preservation_orthogonal():
    """Parseval: ||coeffs||^2 == ||img||^2 for orthogonal wavelets."""
    img = _img()
    W = Wavelets(img, "db4", 3)
    W.forward()
    e_img = float((img.astype(np.float64) ** 2).sum())
    assert abs(W.norm2sq() - e_img) / e_img < 1e-4


def test_inverse_state_machine():
    W = Wavelets(_img(), "db2", 2)
    W.forward()
    W.inverse()
    with pytest.raises(RuntimeError):
        W.coeff_only(0)
    with pytest.raises(RuntimeError):
        W.soft_threshold(1.0)
    # forward resets the guard
    W.forward()
    W.coeff_only(0)


def test_denoising_pipeline():
    """forward -> soft_threshold -> inverse reduces noise energy
    (doc/denoising.rst workflow)."""
    rng = np.random.default_rng(5)
    clean = np.zeros((64, 64), np.float32)
    clean[16:48, 16:48] = 100.0
    noisy = clean + rng.normal(0, 5, clean.shape).astype(np.float32)
    W = Wavelets(noisy, "db2", 3)
    W.forward()
    W.soft_threshold(15.0)
    W.inverse()
    den = W.image
    assert ((den - clean) ** 2).mean() < ((noisy - clean) ** 2).mean() * 0.7


def test_cycle_spinning_roundtrip():
    img = _img()
    W = Wavelets(img, "db2", 2, do_cycle_spinning=1, seed=42)
    W.forward()
    W.inverse()
    assert np.abs(W.image - img).max() < 7e-4
    assert W.current_shift != (0, 0)


def test_swt_2d_roundtrip_and_shapes():
    img = _img((32, 32))
    W = Wavelets(img, "db2", 3, do_swt=1)
    W.forward()
    c = W.coeffs
    assert c[0].shape == (32, 32)
    assert c[2][1].shape == (32, 32)
    W.inverse()
    assert np.abs(W.image - img).max() < 4e-4  # iswt2 reference tol


def test_1d_transform():
    rng = np.random.default_rng(1)
    sig = rng.standard_normal(128).astype(np.float32)
    W = Wavelets(sig, "db3", 3)
    assert (W.Nr, W.Nc) == (1, 128)
    W.forward()
    c = W.coeffs
    assert len(c) == 4
    assert c[0].shape == (16,)
    W.inverse()
    assert np.abs(W.image.ravel() - sig).max() < 7e-4


def test_batched_1d_transform():
    rng = np.random.default_rng(2)
    sig = rng.standard_normal((8, 64)).astype(np.float32)
    W = Wavelets(sig, "db2", 2, ndim=1)
    assert W.batched1d
    W.forward()
    c = W.coeffs
    assert c[1].shape == (8, 32)
    # each row transforms independently
    W0 = Wavelets(sig[0], "db2", 2)
    W0.forward()
    np.testing.assert_allclose(c[1][0], W0.coeffs[1], atol=1e-5)
    W.inverse()
    assert np.abs(W.image - sig).max() < 7e-4


def test_nonseparable_mode():
    img = _img((32, 32))
    W = Wavelets(img, "db2", 2, do_separable=0)
    W.forward()
    Ws = Wavelets(img, "db2", 2, do_separable=1)
    Ws.forward()
    # float32 accumulation order differs (2D conv vs two 1D passes); data
    # is 0..255 so ~1e-2 absolute agreement is a few ulps at level 2
    np.testing.assert_allclose(W.coeff_only(0), Ws.coeff_only(0), atol=2e-2)
    W.inverse()
    assert np.abs(W.image - img).max() < 7e-4


def test_set_image_and_forward_with_img():
    img1, img2 = _img(seed=1), _img(seed=2)
    W = Wavelets(img1, "db2", 2)
    W.forward(img2)
    W.inverse()
    assert np.abs(W.image - img2).max() < 7e-4
    with pytest.raises(ValueError):
        W.set_image(np.zeros((8, 8), np.float32))


def test_set_coeff():
    W = Wavelets(_img(), "db2", 2)
    W.forward()
    z = np.zeros((32, 32), np.float32)
    W.set_coeff(z, 1)
    np.testing.assert_array_equal(W.coeff_only(1), z)
    with pytest.raises(ValueError):
        W.set_coeff(np.zeros((4, 4), np.float32), 1, check=True)


def test_add_wavelet():
    img = _img()
    W1 = Wavelets(img, "db2", 2)
    W2 = Wavelets(img, "db2", 2)
    W1.forward()
    W2.forward()
    W1.add_wavelet(W2, alpha=-1.0)
    assert W1.norm1() < 1e-3
    W3 = Wavelets(img, "db3", 2)
    W3.forward()
    with pytest.raises(ValueError):
        W1.add_wavelet(W3)


def test_custom_filter_bank_roundtrip():
    """Custom bank (reference demo: LeGall 5/3, demo.cpp:83-179)."""
    from pypwt_jax import get_filter_bank
    img = _img((32, 32))
    W = Wavelets(img, "db2", 2)
    fb = get_filter_bank("bior2.2")  # = LeGall 5/3
    W.set_wavelets_filters("legall53", fb.dec_lo, fb.dec_hi, fb.rec_lo,
                           fb.rec_hi)
    assert W.wname == "legall53"
    W.forward()
    W.inverse()
    assert np.abs(W.image - img).max() < 7e-4


def test_custom_bank_odd_hlen_rejected():
    """Odd filter lengths are refused with guidance to zero-pad (the
    synthesis algebra assumes even hlen; the reference's own demo
    zero-pads CDF 9/7 and LeGall 5/3 to even length, demo.cpp:83-179)."""
    img = _img((32, 32))
    W = Wavelets(img, "db2", 2)
    f5 = np.array([-0.125, 0.25, 0.75, 0.25, -0.125])
    with pytest.raises(ValueError, match="odd"):
        W.set_wavelets_filters("legall_raw", f5, f5, f5, f5)


def test_custom_bank_reference_demo_cdf97():
    """The reference demo's zero-padded CDF 9/7 bank (demo.cpp:83-137)
    reconstructs through our synthesis algebra."""
    dec_lo = np.array([0.0, 0.026748757411, -0.016864118443,
                       -0.078223266529, 0.266864118443, 0.602949018236,
                       0.266864118443, -0.078223266529, -0.016864118443,
                       0.026748757411])
    dec_hi = np.array([0.0, 0.091271763114, -0.057543526229,
                       -0.591271763114, 1.11508705, -0.591271763114,
                       -0.057543526229, 0.091271763114, 0.0, 0.0])
    rec_lo = np.array([0.0, -0.091271763114, -0.057543526229,
                       0.591271763114, 1.11508705, 0.591271763114,
                       -0.057543526229, -0.091271763114, 0.0, 0.0])
    rec_hi = np.array([0.0, 0.026748757411, 0.016864118443,
                       -0.078223266529, -0.266864118443, 0.602949018236,
                       -0.266864118443, -0.078223266529, 0.016864118443,
                       0.026748757411])
    img = _img((64, 64))
    W = Wavelets(img, "db2", 2)
    W.set_wavelets_filters("cdf97", dec_lo, dec_hi, rec_lo, rec_hi)
    W.forward()
    W.inverse()
    assert np.abs(W.image - img).max() < 7e-4


def test_info_and_version():
    W = Wavelets(_img(), "db2", 2)
    s = repr(W)
    assert "Wavelet name : db2" in s
    assert "Number of levels : 2" in s
    assert Wavelets.version()

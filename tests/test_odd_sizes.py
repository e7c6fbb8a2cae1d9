"""Odd-size div2 chains through the public ``Wavelets`` plan (float64):
every level of odd extent repeats its last sample (the reference's
virtual extension), and the inverse crops back along the same chain.
Forward subbands are pinned to the FFT oracle, the round trip to the
input."""

import numpy as np
import pytest

from pypwt_jax import Wavelets, get_filter_bank

import fft_oracle as fo

SHAPES = [(37, 45), (33, 17), (101, 63), (45, 37), (19, 130), (64, 33)]
BANKS = ["haar", "db2", "db5", "sym8", "bior3.5"]


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_odd_size_chain_vs_fft_oracle_and_roundtrip(shape, wname):
    img = np.random.default_rng(shape[0] * shape[1]).standard_normal(shape)
    W = Wavelets(img, wname, 5, dtype=np.float64)
    W.forward()
    want = fo.fft_wavedec2(img, get_filter_bank(wname), W.levels)
    got = W.coeffs
    assert len(got) == W.levels + 1
    np.testing.assert_allclose(got[0], want[0], atol=1e-10)
    for lev in range(1, W.levels + 1):
        for g, w in zip(got[lev], want[lev]):
            assert g.shape == w.shape == W.sizes[lev - 1]
            np.testing.assert_allclose(g, w, atol=1e-10)
    W.inverse()
    np.testing.assert_allclose(W.image, img, atol=1e-10)

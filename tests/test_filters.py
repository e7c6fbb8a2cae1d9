"""Filter-registry tests: completeness + mathematical properties.

Pure NumPy (no jax) — the properties stand in for the reference's implicit
guarantees (its tables came from wavelets.pybytes.com; ours are generated,
so we *prove* them here): perfect reconstruction, orthonormality, vanishing
moments, sign relations.
"""

import numpy as np
import pytest

from pypwt_jax.filters import FilterBank, get_filter_bank, wavelist
from oracle import ref_analysis_1d, ref_synthesis_1d

EXPECTED = (
    ["haar"]
    + [f"db{i}" for i in range(2, 21)]
    + [f"sym{i}" for i in range(2, 21)]
    + [f"coif{i}" for i in range(1, 6)]
    + [f"bior{n}" for n in ("1.3 1.5 2.2 2.4 2.6 2.8 3.1 3.3 3.5 "
                            "3.7 3.9 4.4 5.5 6.8").split()]
    + [f"rbio{n}" for n in ("1.3 1.5 2.2 2.4 2.6 2.8 3.1 3.3 3.5 "
                            "3.7 3.9 4.4 5.5 6.8").split()]
)


def test_all_72_wavelets_present():
    names = wavelist()
    assert len(names) == 72
    assert sorted(names) == sorted(EXPECTED)


def test_aliases():
    for alias in ("db1", "bior1.1", "rbior1.1", "HAAR", "Db2"):
        get_filter_bank(alias)  # must not raise
    assert get_filter_bank("db1").name == "haar"


def test_unknown_wavelet_raises():
    with pytest.raises(ValueError):
        get_filter_bank("nosuchwavelet42")


def test_sign_relations():
    for name in wavelist():
        fb = get_filter_bank(name)
        k = np.arange(fb.hlen)
        sign = (-1.0) ** k
        assert np.allclose(fb.dec_hi, -sign * fb.rec_lo, atol=0)
        assert np.allclose(fb.rec_hi, sign * fb.dec_lo, atol=0)


def test_lowpass_normalization():
    s2 = np.sqrt(2.0)
    for name in wavelist():
        fb = get_filter_bank(name)
        assert abs(fb.dec_lo.sum() - s2) < 1e-7, name
        assert abs(fb.rec_lo.sum() - s2) < 1e-7, name


def test_orthogonal_banks_are_orthonormal():
    for name in wavelist():
        fb = get_filter_bank(name)
        if not fb.orthogonal:
            continue
        h = fb.rec_lo
        assert abs(np.dot(h, h) - 1.0) < 1e-7, name
        for m in range(1, fb.hlen // 2):
            assert abs(np.dot(h[: fb.hlen - 2 * m], h[2 * m:])) < 1e-7, name
        assert np.allclose(fb.dec_lo, fb.rec_lo[::-1]), name


def test_vanishing_moments_daubechies():
    for N in (2, 5, 10):
        fb = get_filter_bank(f"db{N}")
        n = np.arange(fb.hlen, dtype=float)
        sgn = (-1.0) ** n
        for j in range(N):
            mom = np.dot(sgn * (n / fb.hlen) ** j, fb.rec_lo)
            assert abs(mom) < 1e-7, (N, j, mom)


def test_perfect_reconstruction_all_banks_oracle():
    """Every bank reconstructs a random even-length signal exactly through
    the reference index conventions (scalar float64 oracle)."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal(64)
    for name in wavelist():
        fb = get_filter_bank(name)
        lo = ref_analysis_1d(x, fb.dec_lo)
        hi = ref_analysis_1d(x, fb.dec_hi)
        y = ref_synthesis_1d(lo, hi, fb.rec_lo, fb.rec_hi, 64)
        err = np.abs(y - x).max()
        assert err < 1e-8, (name, err)


def test_custom_bank():
    fb = get_filter_bank("db2")
    cb = FilterBank.custom("mine", fb.dec_lo, fb.dec_hi, fb.rec_lo, fb.rec_hi)
    assert cb.hlen == 4
    with pytest.raises(ValueError):
        FilterBank.custom("bad", [1.0] * 41, [1.0] * 41, [1.0] * 41,
                          [1.0] * 41)

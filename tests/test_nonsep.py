"""Non-separable transform tests.

For built-in (separable) banks the non-separable path must agree with the
separable one to accumulation precision (the reference's non-separable
kernels build 2D filters as outer products, nonseparable.cu:32-83); a truly
non-separable custom bank is exercised via perfect reconstruction of a
rotation-mixed filter set.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax.filters import get_filter_bank
from pypwt_jax.core import dwt, swt
from pypwt_jax.core import nonsep as ns

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("wname", ["db2", "bior2.2"])
def test_nonsep_matches_separable(wname):
    fb = get_filter_bank(wname)
    f2d = ns.Filters2D.from_bank(fb)
    x = RNG.standard_normal((32, 32))
    xa = jnp.asarray(x)
    a1, h1, v1, d1 = jax.jit(lambda x: dwt.dwt2d(x, fb))(xa)
    a2, h2, v2, d2 = jax.jit(lambda x: ns.nsdwt2d(x, f2d))(xa)
    for s, t in ((a1, a2), (h1, h2), (v1, v2), (d1, d2)):
        np.testing.assert_allclose(np.asarray(s), np.asarray(t), atol=1e-12)


def test_nonsep_multilevel_roundtrip():
    fb = get_filter_bank("db3")
    f2d = ns.Filters2D.from_bank(fb)
    for shape in [(32, 32), (31, 33)]:
        x = RNG.standard_normal(shape)
        pyr = jax.jit(lambda x: ns.ns_wavedec2(x, f2d, 2))(jnp.asarray(x))
        y = jax.jit(lambda c: ns.ns_waverec2(c, f2d, shape))(pyr)
        if shape[0] % 2 == 0:
            np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


def test_nonsep_swt_matches_separable_and_roundtrips():
    fb = get_filter_bank("db2")
    f2d = ns.Filters2D.from_bank(fb)
    x = RNG.standard_normal((32, 32))
    xa = jnp.asarray(x)
    pyr_s = jax.jit(lambda x: swt.swt2d(x, fb, 2))(xa)
    pyr_n = jax.jit(lambda x: ns.ns_swt2d(x, f2d, 2))(xa)
    for cs, cn in zip(jax.tree.leaves(pyr_s), jax.tree.leaves(pyr_n)):
        np.testing.assert_allclose(np.asarray(cs), np.asarray(cn),
                                   atol=1e-10)
    y = jax.jit(lambda c: ns.ins_swt2d(c, f2d))(pyr_n)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


def test_batched_nonsep():
    fb = get_filter_bank("db2")
    f2d = ns.Filters2D.from_bank(fb)
    x = RNG.standard_normal((2, 32, 32))
    pyr = jax.jit(lambda x: ns.ns_wavedec2(x, f2d, 2))(jnp.asarray(x))
    y = jax.jit(lambda c: ns.ns_waverec2(c, f2d, (2, 32, 32)))(pyr)
    assert y.shape == (2, 32, 32)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


def test_separable_bank_factorization():
    """from_bank filter sets factor back to the 1D bank; perturbed
    (genuinely non-separable) sets must NOT factor and must take the
    true-2D path."""
    import numpy as np
    from pypwt_jax import get_filter_bank
    fb = get_filter_bank("db3")
    f2d = ns.Filters2D.from_bank(fb)
    bank = f2d.separable_bank()
    assert bank is not None
    np.testing.assert_allclose(bank.dec_lo, fb.dec_lo, atol=1e-12)
    np.testing.assert_allclose(bank.rec_hi, fb.rec_hi, atol=1e-12)

    dec = [f.copy() for f in f2d.dec]
    dec[0] = dec[0] + np.eye(f2d.hlen) * 1e-3  # rank > 1
    f2d_ns = ns.Filters2D(dec, [f.copy() for f in f2d.rec])
    assert f2d_ns.separable_bank() is None


@pytest.mark.parametrize("k", [4, 14])  # slice path / conv fallback
def test_true_2d_path_matches_numpy_oracle(k):
    """Both true-2D implementations (shifted slices for short filters,
    conv_general_dilated for long) against a direct scalar 2D
    convolution."""
    import numpy as np
    rng = np.random.default_rng(5)
    dec = [rng.standard_normal((k, k)) for _ in range(4)]
    f2d = ns.Filters2D(dec, dec)  # synthesis unused here
    assert f2d.separable_bank() is None
    x = rng.standard_normal((12, 14)).astype(np.float32)

    got = [np.asarray(c) for c in ns.nsdwt2d(jnp.asarray(x), f2d)]

    # scalar oracle: out_s[i,j] = sum_kl F_s[k,l] * xp[2i+k, 2j+l]
    s = k // 2
    lp, rp = k - 1 - s, max(s - 1, 0)
    xp = np.pad(x.astype(np.float64), ((lp, rp), (lp, rp)), mode="wrap")
    L_r, L_c = x.shape[0] // 2, x.shape[1] // 2
    for si, F in enumerate(dec):
        want = np.zeros((L_r, L_c))
        Fr = F[::-1, ::-1]
        for i in range(L_r):
            for j in range(L_c):
                want[i, j] = np.sum(Fr * xp[2 * i: 2 * i + k,
                                            2 * j: 2 * j + k])
        np.testing.assert_allclose(got[si], want, atol=1e-4)


def test_true_2d_roundtrip_direct_calls():
    """Level round trip through the direct (non-routed) true-2D kernels:
    nsdwt2d -> insdwt2d and ns_swt2d_level -> ins_swt2d_level."""
    import numpy as np
    from pypwt_jax import get_filter_bank
    fb = get_filter_bank("db4")
    f2d = ns.Filters2D.from_bank(fb)
    x = jnp.asarray(np.random.default_rng(6).random((32, 48)).astype(
        np.float32))
    a, h, v, d = ns.nsdwt2d(x, f2d)
    y = ns.insdwt2d(a, h, v, d, f2d, (32, 48))
    assert float(jnp.abs(y - x).max()) < 5e-6

    a, h, v, d = ns.ns_swt2d_level(x, f2d, 2)
    y = ns.ins_swt2d_level(a, h, v, d, f2d, 2)
    assert float(jnp.abs(y - x).max()) < 5e-6


# ---------------------------------------------------------------------------
# Both true-2D formulations (shifted slices up to _SLICE_TAP_LIMIT taps,
# lax.conv_general_dilated above it) against the spectral 2D oracle
# ---------------------------------------------------------------------------

import fft_oracle as fo  # noqa: E402


def _dense_bank(k, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((k, k)) / k for _ in range(4)]


@pytest.mark.parametrize("shape", [(32, 48), (33, 47)])
@pytest.mark.parametrize("k", [4, 6, 12, 14, 16])
def test_true_2d_forward_vs_fft_oracle(k, shape):
    dec = _dense_bank(k, k)
    f2d = ns.Filters2D(dec, dec)
    assert f2d.separable_bank() is None
    x = np.random.default_rng(7).standard_normal(shape)
    got = jax.jit(lambda v: ns.nsdwt2d(v, f2d))(jnp.asarray(x))
    for g, w in zip(got, fo.fft_ns_dwt2d(x, dec)):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-11)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("k", [4, 14])
def test_true_2d_swt_dilations_vs_fft_oracle(k, level):
    dec = _dense_bank(k, 100 + k)
    f2d = ns.Filters2D(dec, dec)
    x = np.random.default_rng(8).standard_normal((24, 40))
    got = jax.jit(lambda v: ns.ns_swt2d_level(v, f2d, level))(
        jnp.asarray(x))
    for g, w in zip(got, fo.fft_ns_swt2d_level(x, dec, level)):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-11)


def _aniso_bank(row, col):
    fr, fc = get_filter_bank(row), get_filter_bank(col)
    dec = [np.outer(fr.dec_lo, fc.dec_lo), np.outer(fr.dec_hi, fc.dec_lo),
           np.outer(fr.dec_lo, fc.dec_hi), np.outer(fr.dec_hi, fc.dec_hi)]
    rec = [np.outer(fr.rec_lo, fc.rec_lo), np.outer(fr.rec_hi, fc.rec_lo),
           np.outer(fr.rec_lo, fc.rec_hi), np.outer(fr.rec_hi, fc.rec_hi)]
    return ns.Filters2D(dec, rec, name=f"{row}x{col}")


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_anisotropic_bank_pyramid_vs_oracle_and_roundtrip(levels):
    """db3 rows x coif1 cols: perfect reconstruction, but no isotropic 1D
    bank, so every level runs the true-2D slice path."""
    f2d = _aniso_bank("db3", "coif1")
    assert f2d.separable_bank() is None
    x = np.random.default_rng(9).standard_normal((64, 48))
    pyr = jax.jit(lambda v: ns.ns_wavedec2(v, f2d, levels))(jnp.asarray(x))
    a = x
    for lev in range(1, levels + 1):
        a, h, v, d = fo.fft_ns_dwt2d(a, f2d.dec)
        for g, w in zip(pyr[lev], (h, v, d)):
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-10)
    np.testing.assert_allclose(np.asarray(pyr[0]), a, atol=1e-10)
    y = jax.jit(lambda c: ns.ns_waverec2(c, f2d, x.shape))(pyr)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


def test_anisotropic_bank_swt_roundtrip():
    f2d = _aniso_bank("coif1", "db3")
    x = np.random.default_rng(10).standard_normal((32, 40))
    pyr = jax.jit(lambda v: ns.ns_swt2d(v, f2d, 2))(jnp.asarray(x))
    a = x
    for lev in (1, 2):
        a, h, v, d = fo.fft_ns_swt2d_level(a, f2d.dec, lev)
        for g, w in zip(pyr[lev], (h, v, d)):
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-10)
    y = jax.jit(lambda c: ns.ins_swt2d(c, f2d))(pyr)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)

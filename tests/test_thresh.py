"""Threshold / proximal-operator / norm tests over pyramids (common.cu
semantics, including the per-scale beta/sqrt(2) normalization rules)."""

import math

import numpy as np

import jax.numpy as jnp

from pypwt_jax.core import thresh

S2 = math.sqrt(2.0)


def _pyr2d(levels=3, n=8, seed=0):
    rng = np.random.default_rng(seed)
    pyr = [jnp.asarray(rng.standard_normal((n, n)))]
    for _ in range(levels):
        pyr.append(tuple(jnp.asarray(rng.standard_normal((n, n)))
                         for _ in range(3)))
    return pyr


def _np(c):
    return np.asarray(c)


def test_soft_threshold_values_and_normalize():
    pyr = _pyr2d(levels=2)
    beta = 0.5
    out = thresh.soft_threshold(pyr, beta, do_thresh_appcoeffs=False,
                                normalize=True)
    # appcoeffs untouched
    np.testing.assert_array_equal(_np(out[0]), _np(pyr[0]))
    # level i uses beta / sqrt(2)^(i+1)
    for i in (0, 1):
        b = beta / (S2 ** (i + 1))
        for s_in, s_out in zip(pyr[i + 1], out[i + 1]):
            x = _np(s_in)
            expect = np.sign(x) * np.maximum(np.abs(x) - b, 0)
            np.testing.assert_allclose(_np(s_out), expect, atol=1e-12)


def test_soft_threshold_appcoeffs_normalization_rule():
    # beta2 = beta / sqrt(2)^nlevels with the reference's int/half split
    for levels in (2, 3):
        pyr = _pyr2d(levels=levels)
        beta = 1.0
        out = thresh.soft_threshold(pyr, beta, do_thresh_appcoeffs=True,
                                    normalize=True)
        b2 = beta / (2 ** (levels // 2))
        if levels % 2:
            b2 /= S2
        x = _np(pyr[0])
        expect = np.sign(x) * np.maximum(np.abs(x) - b2, 0)
        np.testing.assert_allclose(_np(out[0]), expect, atol=1e-12)


def test_hard_threshold():
    pyr = _pyr2d()
    out = thresh.hard_threshold(pyr, 0.8, do_thresh_appcoeffs=True)
    x = _np(pyr[0])
    np.testing.assert_allclose(_np(out[0]), np.where(np.abs(x) > 0.8, x, 0))


def test_group_soft_threshold_2d():
    pyr = _pyr2d(levels=2)
    beta = 0.4
    out = thresh.group_soft_threshold(pyr, beta)
    h, v, d = (_np(s) for s in pyr[1])
    norm = np.sqrt(h * h + v * v + d * d)
    fac = np.where(norm > 0, np.maximum(1 - beta / norm, 0), 0)
    np.testing.assert_allclose(_np(out[1][0]), h * fac, atol=1e-12)


def test_group_soft_threshold_includes_app_at_last_scale():
    pyr = _pyr2d(levels=2)
    beta = 0.4
    out = thresh.group_soft_threshold(pyr, beta, do_thresh_appcoeffs=True)
    a = _np(pyr[0])
    h, v, d = (_np(s) for s in pyr[2])
    norm = np.sqrt(h * h + v * v + d * d + a * a)
    fac = np.where(norm > 0, np.maximum(1 - beta / norm, 0), 0)
    np.testing.assert_allclose(_np(out[0]), a * fac, atol=1e-12)
    np.testing.assert_allclose(_np(out[2][2]), d * fac, atol=1e-12)


def test_proj_linf_and_shrink():
    pyr = _pyr2d()
    out = thresh.proj_linf(pyr, 0.3, do_thresh_appcoeffs=True)
    assert float(np.abs(_np(out[0])).max()) <= 0.3 + 1e-12
    out2 = thresh.shrink(pyr, 1.5)
    np.testing.assert_allclose(_np(out2[1][1]), _np(pyr[1][1]) / 2.5,
                               atol=1e-12)


def test_norms():
    pyr = _pyr2d(levels=2)
    leaves = [_np(pyr[0])] + [_np(s) for lev in pyr[1:] for s in lev]
    n1 = sum(np.abs(x).sum() for x in leaves)
    n2 = sum((x * x).sum() for x in leaves)
    assert abs(float(thresh.norm1(pyr)) - n1) < 1e-9
    assert abs(float(thresh.norm2sq(pyr)) - n2) < 1e-9


def test_norms_1d_pyramid():
    rng = np.random.default_rng(1)
    pyr = [jnp.asarray(rng.standard_normal(16))]
    pyr += [jnp.asarray(rng.standard_normal(16)) for _ in range(2)]
    leaves = [_np(c) for c in pyr]
    assert abs(float(thresh.norm2sq(pyr))
               - sum((x * x).sum() for x in leaves)) < 1e-9


def test_circshift():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 5))
    out = _np(thresh.circshift(jnp.asarray(x), 1, 2))
    # out[y, x] = in[y-1, x-2] periodic
    np.testing.assert_allclose(out[1, 2], x[0, 0])
    np.testing.assert_allclose(out[0, 0], x[3, 3])


def test_add_coeffs():
    p1 = _pyr2d(seed=1)
    p2 = _pyr2d(seed=2)
    out = thresh.add_coeffs(p1, p2, alpha=2.0)
    np.testing.assert_allclose(_np(out[1][0]),
                               _np(p1[1][0]) + 2.0 * _np(p2[1][0]),
                               atol=1e-12)

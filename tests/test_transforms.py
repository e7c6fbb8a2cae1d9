"""Differential tests of the jnp transform core against the scalar oracle,
plus perfect-reconstruction roundtrips.

Mirrors the reference's test strategy (test/test_wavelets.py: forward
transforms compared per-subband against the oracle; inverse tested as
roundtrip).  Filters are passed as *traced* jax arrays so one compilation
serves every wavelet with the same length — compilation in this environment
is expensive, so tests are batteries grouped by (shape, hlen).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax.filters import get_filter_bank
from pypwt_jax.core import conv, dwt, haar, swt
from oracle import (ref_analysis_1d, ref_analysis_2d, ref_swt_analysis_1d,
                    ref_swt_synthesis_1d, ref_synthesis_1d, ref_synthesis_2d)

RNG = np.random.default_rng(7)


class TracedBank:
    """Filter bank presented as jax arrays (shared-trace compilation)."""

    def __init__(self, fb):
        self.name = fb.name
        self.dec_lo = jnp.asarray(fb.dec_lo)
        self.dec_hi = jnp.asarray(fb.dec_hi)
        self.rec_lo = jnp.asarray(fb.rec_lo)
        self.rec_hi = jnp.asarray(fb.rec_hi)


@functools.lru_cache(maxsize=None)
def _rt1d_fn(n, hlen, levels):
    def f(x, dl, dh, rl, rh):
        fb = type("B", (), dict(dec_lo=dl, dec_hi=dh, rec_lo=rl, rec_hi=rh))
        pyr = dwt.wavedec1(x, fb, levels)
        y = dwt.waverec1(pyr, fb, n)
        return pyr, y
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _rt2d_fn(shape, hlen, levels):
    def f(x, dl, dh, rl, rh):
        fb = type("B", (), dict(dec_lo=dl, dec_hi=dh, rec_lo=rl, rec_hi=rh))
        pyr = dwt.wavedec2(x, fb, levels)
        y = dwt.waverec2(pyr, fb, shape)
        return pyr, y
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _rtswt1d_fn(n, hlen, levels):
    def f(x, dl, dh, rl, rh):
        fb = type("B", (), dict(dec_lo=dl, dec_hi=dh, rec_lo=rl, rec_hi=rh))
        pyr = swt.swt1d(x, fb, levels)
        y = swt.iswt1d(pyr, fb)
        return pyr, y
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _rtswt2d_fn(shape, hlen, levels):
    def f(x, dl, dh, rl, rh):
        fb = type("B", (), dict(dec_lo=dl, dec_hi=dh, rec_lo=rl, rec_hi=rh))
        pyr = swt.swt2d(x, fb, levels)
        y = swt.iswt2d(pyr, fb)
        return pyr, y
    return jax.jit(f)


def _args(fb):
    return (jnp.asarray(fb.dec_lo), jnp.asarray(fb.dec_hi),
            jnp.asarray(fb.rec_lo), jnp.asarray(fb.rec_hi))


# ---------------------------------------------------------------------------
# 1D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", ["db2", "sym4", "bior4.4"])
@pytest.mark.parametrize("n", [32, 31])
def test_dwt1d_vs_oracle_and_roundtrip(wname, n):
    fb = get_filter_bank(wname)
    x = RNG.standard_normal(n)
    fn = _rt1d_fn(n, fb.hlen, 2)
    pyr, y = fn(jnp.asarray(x), *_args(fb))
    # level 1 vs oracle
    lo1 = ref_analysis_1d(x, fb.dec_lo)
    d1 = ref_analysis_1d(x, fb.dec_hi)
    np.testing.assert_allclose(np.asarray(pyr[1]), d1, atol=1e-12)
    # level 2 vs oracle
    d2 = ref_analysis_1d(lo1, fb.dec_hi)
    a2 = ref_analysis_1d(lo1, fb.dec_lo)
    np.testing.assert_allclose(np.asarray(pyr[2]), d2, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pyr[0]), a2, atol=1e-12)
    # roundtrip (even sizes reconstruct exactly; odd sizes lose the
    # virtual sample like the reference)
    if n % 2 == 0:
        np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


def test_dwt1d_batched():
    """Batched-1D: rows are independent 1D signals (pypwt.pyx:146-151)."""
    fb = get_filter_bank("db3")
    x = RNG.standard_normal((4, 64))
    fn = _rt1d_fn(64, fb.hlen, 3)
    pyr, y = fn(jnp.asarray(x), *_args(fb))
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)
    for r in range(4):
        d1 = ref_analysis_1d(x[r], fb.dec_hi)
        np.testing.assert_allclose(np.asarray(pyr[1][r]), d1, atol=1e-12)


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", ["db2", "bior2.2"])
@pytest.mark.parametrize("shape", [(32, 32), (31, 33)])
def test_dwt2d_vs_oracle_and_roundtrip(wname, shape):
    fb = get_filter_bank(wname)
    x = RNG.standard_normal(shape)
    fn = _rt2d_fn(shape, fb.hlen, 2)
    pyr, y = fn(jnp.asarray(x), *_args(fb))
    a_o, h_o, v_o, d_o = ref_analysis_2d(x, fb.dec_lo, fb.dec_hi)
    h1, v1, d1 = pyr[1]
    np.testing.assert_allclose(np.asarray(h1), h_o, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v1), v_o, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d1), d_o, atol=1e-12)
    a2_o = ref_analysis_2d(a_o, fb.dec_lo, fb.dec_hi)
    np.testing.assert_allclose(np.asarray(pyr[0]), a2_o[0], atol=1e-12)
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


def test_idwt2d_matches_oracle_exactly():
    """Inverse pass (including odd output sizes) matches the reference's
    index algebra, not merely the roundtrip."""
    fb = get_filter_bank("db2")
    for shape in [(16, 16), (15, 17)]:
        x = RNG.standard_normal(shape)
        a_o, h_o, v_o, d_o = ref_analysis_2d(x, fb.dec_lo, fb.dec_hi)
        y_o = ref_synthesis_2d(a_o, h_o, v_o, d_o, fb.rec_lo, fb.rec_hi,
                               shape[0], shape[1])
        y = jax.jit(
            lambda a, h, v, d: dwt.idwt2d(a, h, v, d, fb, shape)
        )(*(jnp.asarray(c) for c in (a_o, h_o, v_o, d_o)))
        np.testing.assert_allclose(np.asarray(y), y_o, atol=1e-12)


# ---------------------------------------------------------------------------
# Haar fast path
# ---------------------------------------------------------------------------

def test_haar2d_matches_general_path_and_roundtrips():
    fb = get_filter_bank("haar")
    x = RNG.standard_normal((32, 32))
    pyr = jax.jit(lambda x: haar.haar_wavedec2(x, 3))(jnp.asarray(x))
    y = jax.jit(lambda c: haar.haar_waverec2(c, (32, 32)))(pyr)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-12)
    # subbands match the general separable path with haar filters
    a_o, h_o, v_o, d_o = ref_analysis_2d(x, fb.dec_lo, fb.dec_hi)
    h1, v1, d1 = pyr[1]
    np.testing.assert_allclose(np.asarray(h1), h_o, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v1), v_o, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d1), d_o, atol=1e-12)


def test_haar1d_roundtrip_odd():
    x = RNG.standard_normal((3, 21))
    pyr = jax.jit(lambda x: haar.haar_wavedec1(x, 2))(jnp.asarray(x))
    y = jax.jit(lambda c: haar.haar_waverec1(c, 21))(pyr)
    # odd sizes: last virtual sample repeats; all true samples reconstruct
    np.testing.assert_allclose(np.asarray(y)[:, :20], x[:, :20], atol=1e-10)


# ---------------------------------------------------------------------------
# SWT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wname", ["haar", "db3"])
def test_swt1d_vs_oracle_and_roundtrip(wname):
    fb = get_filter_bank(wname)
    n, levels = 32, 3
    x = RNG.standard_normal(n)
    fn = _rtswt1d_fn(n, fb.hlen, levels)
    pyr, y = fn(jnp.asarray(x), *_args(fb))
    a = x
    for lev in range(1, levels + 1):
        d_o = ref_swt_analysis_1d(a, fb.dec_hi, lev)
        a = ref_swt_analysis_1d(a, fb.dec_lo, lev)
        np.testing.assert_allclose(np.asarray(pyr[lev]), d_o, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pyr[0]), a, atol=1e-12)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)


def test_iswt1d_level_matches_oracle():
    fb = get_filter_bank("db2")
    n = 32
    lo = RNG.standard_normal(n)
    hi = RNG.standard_normal(n)
    for lev in (1, 2):
        y_o = ref_swt_synthesis_1d(lo, hi, fb.rec_lo, fb.rec_hi, lev)
        y = jax.jit(lambda l, h: swt.iswt1d_level(l, h, fb, lev))(
            jnp.asarray(lo), jnp.asarray(hi))
        np.testing.assert_allclose(np.asarray(y), y_o, atol=1e-12)


@pytest.mark.parametrize("wname", ["db2", "bior2.2"])
def test_swt2d_roundtrip(wname):
    fb = get_filter_bank(wname)
    x = RNG.standard_normal((32, 32))
    fn = _rtswt2d_fn((32, 32), fb.hlen, 2)
    pyr, y = fn(jnp.asarray(x), *_args(fb))
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-9)


# ---------------------------------------------------------------------------
# Exhaustive roundtrip sweep (all 72 wavelets, grouped by hlen to share
# compilations — the analog of the reference's test_all.py)
# ---------------------------------------------------------------------------

def test_roundtrip_all_wavelets_2d():
    from pypwt_jax.filters import wavelist
    shape = (64, 64)
    by_hlen = {}
    for name in wavelist():
        by_hlen.setdefault(get_filter_bank(name).hlen, []).append(name)
    failures = []
    for hlen, names in sorted(by_hlen.items()):
        fn = _rt2d_fn(shape, hlen, 2)
        x = RNG.standard_normal(shape)
        for name in names:
            fb = get_filter_bank(name)
            _, y = fn(jnp.asarray(x), *_args(fb))
            err = float(np.abs(np.asarray(y) - x).max())
            if err > 1e-8:
                failures.append((name, err))
    assert not failures, failures


def test_long1d_fold_matches_direct():
    """Long signals fold into rows with neighbour-row halos; results must
    match the direct path exactly."""
    from pypwt_jax.core import conv, dwt, swt
    from pypwt_jax.filters import get_filter_bank
    import numpy as np
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    for n in (1 << 16, 600_000):
        fb = get_filter_bank("db2")
        x = jnp.asarray(rng.random(n, dtype=np.float32))
        rc = conv.long1d_shape(n)
        assert rc is not None and rc[0] * rc[1] == n and rc[1] % 2 == 0
        want = conv.analysis_last(x, fb.dec_lo, fb.dec_hi)
        got = conv.analysis_long1d(x, fb.dec_lo, fb.dec_hi, rc)
        for g, w in zip(got, want):
            assert float(jnp.abs(g - w).max()) == 0.0
        # multi-level API roundtrip through the folded path
        pyr = dwt.wavedec1(x, fb, 4)
        y = dwt.waverec1(pyr, fb, n)
        assert float(jnp.abs(y - x).max()) < 7e-4
        # SWT folded path
        ps = swt.swt1d(x, fb, 2)
        ys = swt.iswt1d(ps, fb)
        assert float(jnp.abs(ys - x).max()) < 7e-4


def test_long1d_shape_rules():
    from pypwt_jax.core import conv
    assert conv.long1d_shape(100) is None          # too small
    assert conv.long1d_shape((1 << 16) + 1) is None  # odd
    r, c = conv.long1d_shape(1 << 20)
    assert c % 128 == 0                             # aligned preference
    # foldings keep >= 128 rows at every level of a deep decomposition
    for n in (1 << 15, 1 << 18, 1 << 20, 1 << 22):
        r, c = conv.long1d_shape(n)
        assert r >= 128, (n, r, c)


@pytest.mark.parametrize("n,min_rows,want", [
    (1 << 20, 256, (256, 4096)),
    (1 << 20, 1024, (1024, 1024)),
    (1 << 20, 8, (128, 8192)),
    (1 << 15, 256, None),
])
def test_long1d_shape_honours_min_rows(n, min_rows, want):
    """A caller's min_rows above 128 is never undercut by the 128-row
    preference (the folding used to return 128 rows for min_rows=256)."""
    from pypwt_jax.core import conv
    got = conv.long1d_shape(n, min_rows=min_rows)
    assert got == want
    if got is not None:
        assert got[0] >= min_rows and got[0] * got[1] == n


def test_long1d_swt_deep_dilations():
    """Dilated supports beyond one folded row: multi-row halos, and
    whole-row rolls when the dilation is a row multiple — the (1, n)
    fallback is never taken."""
    from pypwt_jax.core import conv
    from pypwt_jax.filters import get_filter_bank
    import numpy as np
    import jax.numpy as jnp
    n = 1 << 16
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.random(n, dtype=np.float32))
    rc = conv.long1d_shape(n)
    # sym8 level 12: factor 2048, halo 8 * 2048 = 2 rows (multi-row fold);
    # db2 level 14: factor 8192 = c (pure row rolls)
    for wname, level in (("sym8", 12), ("db2", 14), ("db2", 5)):
        fb = get_filter_bank(wname)
        want = conv.swt_analysis_last(x, fb.dec_lo, fb.dec_hi, level)
        got = conv.swt_analysis_long1d(x, fb.dec_lo, fb.dec_hi, level, rc)
        assert got is not None, (wname, level)
        for g, w in zip(got, want):
            assert float(jnp.abs(g - w).max()) < 1e-6, (wname, level)
        bw = conv.swt_synthesis_last(want[0], want[1], fb.rec_lo,
                                     fb.rec_hi, level)
        bg = conv.swt_synthesis_long1d(got[0], got[1], fb.rec_lo,
                                       fb.rec_hi, level, rc)
        assert bg is not None, (wname, level)
        assert float(jnp.abs(bg - bw).max()) < 1e-6, (wname, level)

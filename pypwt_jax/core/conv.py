"""Periodized filtering primitives, in pure jax.numpy.

These are the exact vectorized restatements of the reference CUDA kernels'
index algebra:

* analysis (convolve + decimate), separable pass
  (separable.cu:91-131 "w_kern_forward_pass1"):
      out[i] = sum_k f[k] * x_ext[(2 i + s - k) mod M],   s = hlen//2
  where for odd N the signal is virtually extended by repeating its last
  element (M = N + 1), matching pywt's "periodization" mode.

* synthesis (upsample + convolve), polyphase form
  (separable.cu:246-328 "w_kern_inverse_pass1/2"): each output parity p reads
  the coefficients once with the phase-p polyphase component of the filter,
  with the reference's even/odd half-length centering rules.

* stationary (a-trous) analysis/synthesis with 2^(level-1)-dilated filters
  (separable.cu:409-493, 553-626), plain mod-N wrap, inverse scaled by 1/2
  per axis.

All functions operate on the last axis; callers transpose for other axes.
Filters are NumPy float64 arrays, cast to the data dtype (float32 by
default) so they become XLA constants — the counterpart of the reference's
CUDA constant memory (common.h:15-37).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def _as_taps(f, dtype):
    """Filter taps as a list of scalars.

    NumPy filters become compile-time constants (the counterpart of CUDA
    constant memory); JAX arrays/tracers stay traced, letting one compiled
    transform serve every wavelet of the same length.
    """
    if isinstance(f, np.ndarray) or isinstance(f, (list, tuple)):
        f = np.asarray(f)
        if f.ndim != 1:
            raise ValueError("filter must be 1D")
        return [np.asarray(v, dtype=dtype) for v in f.astype(np.float64)]
    if f.ndim != 1:
        raise ValueError("filter must be 1D")
    fc = f.astype(dtype)
    return [fc[k] for k in range(f.shape[0])]


def periodic_pad_last(x, lpad: int, rpad: int):
    """Periodic padding along the last axis, robust to pads >= N."""
    if lpad == 0 and rpad == 0:
        return x
    n = x.shape[-1]
    if lpad < n and rpad < n:
        parts = []
        if lpad:
            parts.append(x[..., n - lpad:])
        parts.append(x)
        if rpad:
            parts.append(x[..., :rpad])
        return jnp.concatenate(parts, axis=-1)
    idx = np.arange(-lpad, n + rpad) % n
    return jnp.take(x, jnp.asarray(idx), axis=-1)


def _odd_extend_last(x):
    """Repeat the last element so the length is even (reference's virtual
    extension for odd sizes, separable.cu:116-121)."""
    if x.shape[-1] % 2 == 1:
        x = jnp.concatenate([x, x[..., -1:]], axis=-1)
    return x


def analysis_pads(hlen: int):
    """(lpad, rpad) of the periodic padding used by ``analysis_last``."""
    s = hlen // 2
    return hlen - 1 - s, max(s - 1, 0)


def analysis_core(xp, dec_lo, dec_hi, L: int):
    """Decimating analysis on an already-padded signal:
    out[i] = sum_j f_rev[j] * xp[2i + j] for i < L.

    Shared by the single-device path (periodic pad) and the sharded path
    (halo-exchanged pad).
    """
    hlen = len(dec_lo)
    even = xp[..., 0::2]
    odd = xp[..., 1::2]
    flo = _as_taps(dec_lo, xp.dtype)
    fhi = _as_taps(dec_hi, xp.dtype)
    lo = None
    hi = None
    for j in range(hlen):
        src = even if j % 2 == 0 else odd
        seg = src[..., j // 2: j // 2 + L]
        glo, ghi = flo[hlen - 1 - j], fhi[hlen - 1 - j]
        lo = seg * glo if lo is None else lo + seg * glo
        hi = seg * ghi if hi is None else hi + seg * ghi
    return lo, hi


def analysis_last(x, dec_lo, dec_hi):
    """Single-level decimating analysis along the last axis.

    Returns (lo, hi), each of length div2(N).
    """
    hlen = len(dec_lo)
    xe = _odd_extend_last(x)
    m = xe.shape[-1]
    L = m // 2
    lpad, rpad = analysis_pads(hlen)
    xp = periodic_pad_last(xe, lpad, rpad)
    return analysis_core(xp, dec_lo, dec_hi, L)


def synthesis_pads(hlen: int, L: int, n_out: int):
    """(lpad, rpad) of the periodic padding used by ``synthesis_core``."""
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    Lout = (n_out + 1) // 2
    lpad = c
    rpad = max(((p + sigma) >> 1) - c + Lout + hlen2 - 1 - L
               for p in (0, 1))
    return lpad, max(rpad, 0)


def synthesis_core(lop, hip, rec_lo, rec_hi, n_out: int, L: int,
                   lpad: int):
    """Upsampling synthesis on already-padded coefficient signals.

    lop/hip carry ``lpad`` extra samples on the left (>= c) and enough on
    the right (see ``synthesis_pads``); L is the unpadded coefficient
    length, n_out the output length.  Implements the reference's polyphase
    inverse including its even half-length right-shift rule
    (separable.cu:252-264).
    """
    hlen = len(rec_lo)
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    flo = _as_taps(rec_lo, lop.dtype)
    fhi = _as_taps(rec_hi, lop.dtype)

    Lout = (n_out + 1) // 2  # compute both parities at this length
    phases = []
    for p in (0, 1):
        pp = (p + sigma) & 1
        delta = (p + sigma) >> 1
        off = 1 - pp
        base = lpad + delta - c
        acc = None
        for j in range(hlen2):
            tap = hlen - 1 - 2 * j - off
            gl, gh = flo[tap], fhi[tap]
            seg_l = lop[..., base + j: base + j + Lout]
            seg_h = hip[..., base + j: base + j + Lout]
            term = seg_l * gl + seg_h * gh
            acc = term if acc is None else acc + term
        phases.append(acc)
    out = jnp.stack(phases, axis=-1).reshape(*lop.shape[:-1], 2 * Lout)
    return out[..., :n_out]


def synthesis_last(lo, hi, rec_lo, rec_hi, n_out: int):
    """Single-level upsampling synthesis along the last axis.

    lo/hi have length L = div2(n_out); returns length n_out.
    """
    L = lo.shape[-1]
    hlen = len(rec_lo)
    lpad, rpad = synthesis_pads(hlen, L, n_out)
    lop = periodic_pad_last(lo, lpad, rpad)
    hip = periodic_pad_last(hi, lpad, rpad)
    return synthesis_core(lop, hip, rec_lo, rec_hi, n_out, L, lpad)


def swt_analysis_last(x, dec_lo, dec_hi, level: int):
    """Single-level stationary (a-trous) analysis along the last axis.

    The filters are virtually upsampled by factor = 2^(level-1); no
    decimation.  Plain mod-N periodic wrap (separable.cu:409-448).
    """
    n = x.shape[-1]
    hlen = len(dec_lo)
    s = hlen // 2
    factor = 1 << (level - 1)
    # slice offsets are lpad + (s-k)*factor for k = 0..hlen-1
    lpad, rpad = (hlen - 1 - s) * factor, s * factor
    xp = periodic_pad_last(x, lpad, rpad)
    flo = _as_taps(dec_lo, x.dtype)
    fhi = _as_taps(dec_hi, x.dtype)
    lo = None
    hi = None
    for k in range(hlen):
        ofs = lpad + (s - k) * factor
        seg = xp[..., ofs: ofs + n]
        lo = seg * flo[k] if lo is None else lo + seg * flo[k]
        hi = seg * fhi[k] if hi is None else hi + seg * fhi[k]
    return lo, hi


def swt_synthesis_last(lo, hi, rec_lo, rec_hi, level: int):
    """Single-level stationary synthesis along the last axis (includes the
    1/2-per-axis rescale of the reference, separable.cu:581-584)."""
    n = lo.shape[-1]
    hlen = len(rec_lo)
    s = hlen // 2 - 1 if hlen % 2 == 0 else hlen // 2
    factor = 1 << (level - 1)
    lpad = (hlen - 1 - s) * factor
    rpad = max(s, 0) * factor
    lop = periodic_pad_last(lo, lpad, rpad)
    hip = periodic_pad_last(hi, lpad, rpad)
    flo = _as_taps(rec_lo, lo.dtype)
    fhi = _as_taps(rec_hi, lo.dtype)
    half = jnp.asarray(0.5, lo.dtype)
    out = None
    for k in range(hlen):
        ofs = lpad + (s - k) * factor
        seg = (lop[..., ofs: ofs + n] * (flo[k] * half)
               + hip[..., ofs: ofs + n] * (fhi[k] * half))
        out = seg if out is None else out + seg
    return out


# ---------------------------------------------------------------------------
# Long-1D layout: fold a single long signal into rows with inter-row halos
# ---------------------------------------------------------------------------

def long1d_shape(n: int, min_n: int = 1 << 15, max_cols: int = 8192,
                 min_rows: int = 8):
    """(rows, cols) folding for a long 1D signal, or None.

    Row-major folding with neighbor-row halos turns the 1D transform
    into the batched-row form.  The result never has fewer than
    ``min_rows`` rows.
    """
    if n < min_n or n % 2:
        return None
    # Prefer foldings with >= 128 rows, and within that widths that are
    # multiples of 128, then any even divisor; fall back to ``min_rows``
    # rows only when no such divisor exists.
    for rmin in (max(128, min_rows), min_rows):
        for c in range(max_cols, 255, -128):
            if c % 128 == 0 and n % c == 0 and n // c >= rmin:
                return n // c, c
        for c in range(max_cols, 255, -2):
            if n % c == 0 and n // c >= rmin:
                return n // c, c
    return None


def fold_rows_analysis(x2, lpad: int, rpad: int):
    """Pad each row with the tails/heads of its neighbor rows (rows wrap,
    matching global periodicity of the flattened signal).  Pads larger
    than one row gather from further neighbors, so dilated (SWT) supports
    never force the pathological (1, n) layout."""
    r, c = x2.shape
    parts = []
    nl = -(-lpad // c) if lpad else 0
    for step in range(nl, 0, -1):
        seg = jnp.roll(x2, step, axis=0)
        width = lpad - (step - 1) * c
        if width < c:
            seg = seg[:, c - width:]
        parts.append(seg)
    parts.append(x2)
    nr_ = -(-rpad // c) if rpad else 0
    for step in range(1, nr_ + 1):
        seg = jnp.roll(x2, -step, axis=0)
        width = rpad - (step - 1) * c
        if width < c:
            seg = seg[:, :width]
        parts.append(seg)
    return jnp.concatenate(parts, axis=1) if len(parts) > 1 else x2


def analysis_long1d(x, dec_lo, dec_hi, rc):
    """Single-level decimating analysis of a long 1D signal folded to
    ``rc = (rows, cols)``; returns flat (n/2,) lo/hi.

    The optimization barrier scopes each level: it keeps XLA from fusing
    chained fold-reshape levels, a combination that has miscompiled at
    very large sizes (a 5-level 1e7 round trip)."""
    import jax
    x = jax.lax.optimization_barrier(x)
    r, c = rc
    hlen = len(dec_lo)
    x2 = x.reshape(r, c)
    lpad, rpad = analysis_pads(hlen)
    xp = fold_rows_analysis(x2, lpad, rpad)
    lo, hi = analysis_core(xp, dec_lo, dec_hi, c // 2)
    return lo.reshape(-1), hi.reshape(-1)


def synthesis_long1d(lo, hi, rec_lo, rec_hi, n_out: int, rc):
    """Single-level synthesis of a folded long 1D signal; ``rc`` is the
    folding of the COEFFICIENT length (n_out//2)."""
    r, c = rc
    hlen = len(rec_lo)
    lpad, rpad = synthesis_pads(hlen, c, 2 * c)
    import jax
    lo, hi = jax.lax.optimization_barrier((lo, hi))
    lop = fold_rows_analysis(lo.reshape(r, c), lpad, rpad)
    hip = fold_rows_analysis(hi.reshape(r, c), lpad, rpad)
    out = synthesis_core(lop, hip, rec_lo, rec_hi, 2 * c, c, lpad)
    return out.reshape(-1)


def _swt_long1d_segs(x2, s, factor, hlen, lpad, rpad):
    """Per-tap segments of a folded plane for the a-trous transform.

    When the dilation is a whole number of rows (factor % c == 0, the
    deep-level regime), every tap offset is a pure row roll — no padding
    or lane shifts at all.  Otherwise the rows are folded with (possibly
    multi-row) halos and the taps are lane slices.
    """
    r, c = x2.shape
    if factor % c == 0:
        # seg_k[i] = x[(i + (s-k)*factor) mod n]: content shifts backward
        rows = factor // c
        return [jnp.roll(x2, -(s - k) * rows, axis=0) for k in range(hlen)]
    xp = fold_rows_analysis(x2, lpad, rpad)
    return [xp[:, lpad + (s - k) * factor: lpad + (s - k) * factor + c]
            for k in range(hlen)]


def swt_analysis_long1d(x, dec_lo, dec_hi, level: int, rc):
    """Single-level a-trous analysis of a folded long 1D signal."""
    r, c = rc
    n = x.shape[0]
    hlen = len(dec_lo)
    s = hlen // 2
    factor = 1 << (level - 1)
    lpad, rpad = (hlen - 1 - s) * factor, s * factor
    segs = _swt_long1d_segs(x.reshape(r, c), s, factor, hlen, lpad, rpad)
    flo = _as_taps(dec_lo, x.dtype)
    fhi = _as_taps(dec_hi, x.dtype)
    lo = None
    hi = None
    for k in range(hlen):
        seg = segs[k]
        lo = seg * flo[k] if lo is None else lo + seg * flo[k]
        hi = seg * fhi[k] if hi is None else hi + seg * fhi[k]
    return lo.reshape(n), hi.reshape(n)


def swt_synthesis_long1d(lo, hi, rec_lo, rec_hi, level: int, rc):
    """Single-level a-trous synthesis of a folded long 1D pair."""
    r, c = rc
    n = lo.shape[0]
    hlen = len(rec_lo)
    s = hlen // 2 - 1 if hlen % 2 == 0 else hlen // 2
    factor = 1 << (level - 1)
    lpad, rpad = (hlen - 1 - s) * factor, max(s, 0) * factor
    segs_l = _swt_long1d_segs(lo.reshape(r, c), s, factor, hlen, lpad,
                              rpad)
    segs_h = _swt_long1d_segs(hi.reshape(r, c), s, factor, hlen, lpad,
                              rpad)
    flo = _as_taps(rec_lo, lo.dtype)
    fhi = _as_taps(rec_hi, lo.dtype)
    half = jnp.asarray(0.5, lo.dtype)
    out = None
    for k in range(hlen):
        seg = segs_l[k] * (flo[k] * half) + segs_h[k] * (fhi[k] * half)
        out = seg if out is None else out + seg
    return out.reshape(n)

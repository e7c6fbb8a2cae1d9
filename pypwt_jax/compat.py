"""pywt-style functional convenience API.

The reference's users validate against PyWavelets' ``mode="periodization"``
(test/test_wavelets.py:230-255); this module gives them the familiar
function names on top of the JAX core so migration is a one-line import
change for the supported subset:

    >>> from pypwt_jax import compat as pwt
    >>> cA, (cH, cV, cD) = pwt.dwt2(img, "db2")
    >>> rec = pwt.idwt2((cA, (cH, cV, cD)), "db2")

Only periodization-mode semantics exist here (the reference supports no
other boundary mode, pdwt/README.md:25-31).  Coefficient ORDER follows
pywt: ``wavedec2`` returns [cA_L, (cH_L, cV_L, cD_L), ..., (cH_1, ...)],
i.e. deepest-first detail tuples, whereas the internal pyramid is
finest-first; these wrappers convert.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .filters import get_filter_bank, wavelist  # noqa: F401 (re-export)
from .core import dwt as _dwt
from .core import swt as _swt
from .core.shapes import clamp_levels, div2


class Wavelet:
    """pywt-style wavelet object over a built-in (or custom) bank.

    Exposes the four filters as Python lists plus the usual metadata
    attributes, so code written against ``pywt.Wavelet`` ports directly:

        >>> w = Wavelet("db4")
        >>> w.dec_len, w.orthogonal
        (8, True)
        >>> cA, cD = dwt(sig, w)
    """

    def __init__(self, name, filter_bank=None):
        self._fb = filter_bank if filter_bank is not None \
            else get_filter_bank(name)
        self.name = name if filter_bank is not None else self._fb.name

    @property
    def filter_bank(self):
        return (self.dec_lo, self.dec_hi, self.rec_lo, self.rec_hi)

    dec_lo = property(lambda self: list(self._fb.dec_lo))
    dec_hi = property(lambda self: list(self._fb.dec_hi))
    rec_lo = property(lambda self: list(self._fb.rec_lo))
    rec_hi = property(lambda self: list(self._fb.rec_hi))
    dec_len = property(lambda self: self._fb.hlen)
    rec_len = property(lambda self: self._fb.hlen)
    orthogonal = property(lambda self: bool(self._fb.orthogonal))

    @property
    def short_family_name(self):
        return self.name.rstrip("0123456789.")

    def __repr__(self):
        return f"Wavelet({self.name!r}, dec_len={self.dec_len})"


def _fb(wavelet):
    if isinstance(wavelet, Wavelet):
        return wavelet._fb
    return wavelet if hasattr(wavelet, "dec_lo") else \
        get_filter_bank(wavelet)


def _as_dev(x):
    return jnp.asarray(np.asarray(x))


# ---------------------------------------------------------------------------
# single-level
# ---------------------------------------------------------------------------

def dwt(data, wavelet):
    """Single-level 1D transform -> (cA, cD)."""
    fb = _fb(wavelet)
    return _dwt.dwt1d(_as_dev(data), fb)


def idwt(cA, cD, wavelet, n=None):
    """Single-level 1D inverse; ``n`` overrides the output length for
    odd-sized originals."""
    fb = _fb(wavelet)
    cA = _as_dev(cA)
    cD = _as_dev(cD)
    return _dwt.idwt1d(cA, cD, fb, 2 * cA.shape[-1] if n is None else n)


def dwt2(data, wavelet):
    """Single-level 2D transform -> (cA, (cH, cV, cD))."""
    fb = _fb(wavelet)
    a, h, v, d = _dwt.dwt2d(_as_dev(data), fb)
    return a, (h, v, d)


def idwt2(coeffs, wavelet, shape=None):
    """Single-level 2D inverse of (cA, (cH, cV, cD))."""
    fb = _fb(wavelet)
    a, (h, v, d) = coeffs
    a = _as_dev(a)
    if shape is None:
        shape = (2 * a.shape[-2], 2 * a.shape[-1])
    return _dwt.idwt2d(a, _as_dev(h), _as_dev(v), _as_dev(d), fb, shape)


# ---------------------------------------------------------------------------
# multi-level (pywt deepest-first detail order)
# ---------------------------------------------------------------------------

def wavedec(data, wavelet, level=None):
    """Multi-level 1D decomposition -> [cA_L, cD_L, ..., cD_1]."""
    fb = _fb(wavelet)
    x = _as_dev(data)
    level = _auto_level(x.shape[-1:], fb, level, 1)
    pyr = _dwt.wavedec1(x, fb, level)
    return [pyr[0]] + list(reversed(pyr[1:]))


def waverec(coeffs, wavelet, n=None):
    """Inverse of ``wavedec``; ``n`` restores an odd original length."""
    fb = _fb(wavelet)
    levels = len(coeffs) - 1
    pyr = [_as_dev(coeffs[0])] + [_as_dev(c) for c in
                                  reversed(coeffs[1:])]
    if n is None:
        n = pyr[0].shape[-1] << levels
    return _dwt.waverec1(pyr, fb, n)


def wavedec2(data, wavelet, level=None):
    """Multi-level 2D decomposition ->
    [cA_L, (cH_L, cV_L, cD_L), ..., (cH_1, cV_1, cD_1)]."""
    fb = _fb(wavelet)
    x = _as_dev(data)
    level = _auto_level(x.shape[-2:], fb, level, 2)
    pyr = _dwt.wavedec2(x, fb, level)
    return [pyr[0]] + list(reversed(pyr[1:]))


def waverec2(coeffs, wavelet, shape=None):
    """Inverse of ``wavedec2``; ``shape`` restores odd original sizes."""
    fb = _fb(wavelet)
    levels = len(coeffs) - 1
    pyr = [_as_dev(coeffs[0])] + [tuple(_as_dev(s) for s in c)
                                  for c in reversed(coeffs[1:])]
    if shape is None:
        h1 = pyr[1][0]
        shape = (2 * h1.shape[-2], 2 * h1.shape[-1])
    return _dwt.waverec2(pyr, fb, shape)


def swt(data, wavelet, level):
    """Multi-level 1D stationary transform ->
    [(cA_L, cD_L), ..., (cA_1, cD_1)] (pywt order: deepest first).

    Note: like the reference (and unlike modern pywt's norm=True), the
    analysis is unnormalized and the inverse rescales by 1/2 per level.
    """
    fb = _fb(wavelet)
    x = _as_dev(data)
    approxs = []
    a = x
    for lev in range(1, level + 1):
        a, d = _swt.swt1d_level(a, fb, lev)
        approxs.append((a, d))
    return list(reversed(approxs))


def iswt(coeffs, wavelet):
    """Inverse of ``swt``."""
    fb = _fb(wavelet)
    level = len(coeffs)
    a = _as_dev(coeffs[0][0])
    for i, lev in enumerate(range(level, 0, -1)):
        d = _as_dev(coeffs[i][1])
        a = _swt.iswt1d_level(a, d, fb, lev)
    return a


def swt2(data, wavelet, level):
    """Multi-level 2D stationary transform ->
    [(cA_L, (cH_L, cV_L, cD_L)), ..., (cA_1, ...)]."""
    fb = _fb(wavelet)
    a = _as_dev(data)
    out = []
    for lev in range(1, level + 1):
        a, h, v, d = _swt.swt2d_level(a, fb, lev)
        out.append((a, (h, v, d)))
    return list(reversed(out))


def iswt2(coeffs, wavelet):
    """Inverse of ``swt2``."""
    fb = _fb(wavelet)
    level = len(coeffs)
    a = _as_dev(coeffs[0][0])
    for i, lev in enumerate(range(level, 0, -1)):
        h, v, d = (_as_dev(s) for s in coeffs[i][1])
        a = _swt.iswt2d_level(a, h, v, d, fb, lev)
    return a


def _auto_level(shape, fb, level, ndim):
    maxlev = clamp_levels(64, shape if ndim == 2 else (1, shape[0]),
                          fb.hlen, ndim)
    if level is None:
        return maxlev
    return min(int(level), maxlev)


def dwt_max_level(data_len, wavelet):
    """Maximum useful decomposition level (wt.cu:155-165 clamp)."""
    fb = _fb(wavelet)
    return clamp_levels(64, (1, int(data_len)), fb.hlen, 1)

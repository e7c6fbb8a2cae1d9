"""Non-separable 2D transforms: one true 2D convolution per level.

Equivalent of the reference's non-separable kernels (nonseparable.cu:114-225
for DWT, :304-401 for SWT).  The four 2D filters (LL, LH, HL, HH) are outer
products of the 1D bank for built-in wavelets (w_outer/w_compute_filters,
nonseparable.cu:16-83) or arbitrary user-supplied squares (custom banks).

Short filters run as sums of shifted strided slices, which XLA fuses; long
filters (hlen > _SLICE_TAP_LIMIT) use ``lax.conv_general_dilated``
(NCHW/OIHW), which XLA hands to cuDNN on the GPU; all four subbands are
produced by one convolution with 4 output channels.  The inverse packs the four
output *phases* as 4 output channels of a single stride-1 convolution over
the 4 subband input channels, then interleaves 2x2.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

from . import conv
from .shapes import div2


class Filters2D:
    """The four 2D analysis + four 2D synthesis filters.

    For built-in banks these are outer products f1[i] * f2[j]; the first
    index filters the row axis.

    Note: the reference assigns LH = lo(rows) x hi(cols) to the H subband
    (w_compute_filters, nonseparable.cu:71-74, flagged "CHECKME" upstream),
    which swaps H and V relative to its own separable path / pywt; upstream
    only ever tests separable=1 against pywt.  We use the consistent
    (separable/pywt) convention: H = hi(rows) x lo(cols).
    """

    def __init__(self, dec, rec, name="custom2d"):
        self.name = name
        self.dec = [np.asarray(f, dtype=np.float64) for f in dec]
        self.rec = [np.asarray(f, dtype=np.float64) for f in rec]
        n = self.dec[0].shape[0]
        for f in self.dec + self.rec:
            if f.shape != (n, n):
                raise ValueError("2D filters must all be square, same size")
        self.hlen = n

    @staticmethod
    def from_bank(fb):
        def outer(a, b):
            return np.outer(np.asarray(a), np.asarray(b))

        dec = [outer(fb.dec_lo, fb.dec_lo), outer(fb.dec_hi, fb.dec_lo),
               outer(fb.dec_lo, fb.dec_hi), outer(fb.dec_hi, fb.dec_hi)]
        rec = [outer(fb.rec_lo, fb.rec_lo), outer(fb.rec_hi, fb.rec_lo),
               outer(fb.rec_lo, fb.rec_hi), outer(fb.rec_hi, fb.rec_hi)]
        return Filters2D(dec, rec, name=fb.name)

    def separable_bank(self):
        """If the four 2D filter pairs factor into one isotropic 1D bank
        (outer products with identical row/col factors, the from_bank
        construction), return that bank; else None.

        Used to route non-separable mode through the separable path:
        with harmonized H/V conventions the results coincide, and the
        separable path does 2*hlen taps per output instead of hlen^2.
        """
        if getattr(self, "_sep_bank", "?") != "?":
            return self._sep_bank
        self._sep_bank = None
        try:
            u, s, vt = np.linalg.svd(self.dec[0])
            if s[0] <= 0 or (len(s) > 1 and s[1] > 1e-10 * s[0]):
                return None
            lo_r = u[:, 0] * np.sqrt(s[0])
            lo_c = vt[0] * np.sqrt(s[0])
            if lo_r.sum() < 0:
                lo_r, lo_c = -lo_r, -lo_c
            nlc = float(lo_c @ lo_c)
            nlr = float(lo_r @ lo_r)
            hi_r = self.dec[1] @ lo_c / nlc
            hi_c = self.dec[2].T @ lo_r / nlr

            ur, sr, vr = np.linalg.svd(self.rec[0])
            if sr[0] <= 0 or (len(sr) > 1 and sr[1] > 1e-10 * sr[0]):
                return None
            rlo_r = ur[:, 0] * np.sqrt(sr[0])
            rlo_c = vr[0] * np.sqrt(sr[0])
            if rlo_r.sum() < 0:
                rlo_r, rlo_c = -rlo_r, -rlo_c
            rhi_r = self.rec[1] @ rlo_c / float(rlo_c @ rlo_c)
            rhi_c = self.rec[2].T @ rlo_r / float(rlo_r @ rlo_r)

            tol = 1e-9 * max(np.abs(f).max() for f in self.dec + self.rec)
            checks = [
                (self.dec[0], np.outer(lo_r, lo_c)),
                (self.dec[1], np.outer(hi_r, lo_c)),
                (self.dec[2], np.outer(lo_r, hi_c)),
                (self.dec[3], np.outer(hi_r, hi_c)),
                (self.rec[0], np.outer(rlo_r, rlo_c)),
                (self.rec[1], np.outer(rhi_r, rlo_c)),
                (self.rec[2], np.outer(rlo_r, rhi_c)),
                (self.rec[3], np.outer(rhi_r, rhi_c)),
                # isotropy: the separable core uses one bank on both axes
                (np.outer(lo_r, 1.0), np.outer(lo_c, 1.0)),
                (np.outer(hi_r, 1.0), np.outer(hi_c, 1.0)),
                (np.outer(rlo_r, 1.0), np.outer(rlo_c, 1.0)),
                (np.outer(rhi_r, 1.0), np.outer(rhi_c, 1.0)),
            ]
            for got, want in checks:
                if np.abs(got - want).max() > max(tol, 1e-12):
                    return None
            from ..filters import FilterBank
            self._sep_bank = FilterBank.custom(
                self.name + "-factored", lo_r, hi_r, rlo_r, rhi_r)
        except Exception:
            self._sep_bank = None
        return self._sep_bank


def _pad2_periodic(x, lpad, rpad):
    x = conv.periodic_pad_last(x, lpad, rpad)
    xt = jnp.swapaxes(x, -1, -2)
    xt = conv.periodic_pad_last(xt, lpad, rpad)
    return jnp.swapaxes(xt, -1, -2)


def _odd_extend_2d(x):
    x = conv._odd_extend_last(x)
    xt = jnp.swapaxes(x, -1, -2)
    xt = conv._odd_extend_last(xt)
    return jnp.swapaxes(xt, -1, -2)


def _conv_nchw(x, rhs, strides=(1, 1), dilation=(1, 1)):
    """x: (..., H, W); rhs: (O, I, kh, kw) numpy.  Returns (..., O, H', W')."""
    lead = x.shape[:-2]
    xi = x.reshape((-1, 1, x.shape[-2], x.shape[-1]))
    if rhs.shape[1] > 1:
        # channels are provided in the last-but-2 axis of x
        xi = x.reshape((-1,) + x.shape[-3:])
    out = lax.conv_general_dilated(
        xi, jnp.asarray(rhs, x.dtype),
        window_strides=strides, padding="VALID",
        rhs_dilation=dilation,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=x.dtype,
        # full-precision multiplies: a reduced-precision default (TF32 on
        # the GPU) falls far outside the float32 accuracy envelope
        precision=lax.Precision.HIGHEST,
    )
    if rhs.shape[1] > 1:
        return out.reshape(lead[:-1] + out.shape[1:])
    return out.reshape(lead + out.shape[1:])


# above this tap count the unrolled slice formulation bloats the XLA graph;
# lax.conv takes over (slower but compact)
_SLICE_TAP_LIMIT = 12


def nsdwt2d(x, f2d: Filters2D):
    """One non-separable 2D analysis level -> (a, h, v, d).

    Short filters use shifted single-axis strided slices; long filters
    use lax.conv_general_dilated."""
    hlen = f2d.hlen
    s = hlen // 2
    xe = _odd_extend_2d(x)
    xp = _pad2_periodic(xe, hlen - 1 - s, max(s - 1, 0))
    if hlen > _SLICE_TAP_LIMIT:
        rhs = np.stack([f[::-1, ::-1] for f in f2d.dec])[:, None]
        out = _conv_nchw(xp, rhs, strides=(2, 2))
        return tuple(out[..., i, :, :] for i in range(4))
    L_r = xe.shape[-2] // 2
    L_c = xe.shape[-1] // 2
    frev = [np.asarray(f)[::-1, ::-1] for f in f2d.dec]
    outs = [None] * 4
    for k in range(hlen):
        slab = xp[..., k: k + 2 * L_r: 2, :]
        for l in range(hlen):
            seg = slab[..., :, l: l + 2 * L_c: 2]
            for si in range(4):
                w = float(frev[si][k, l])
                if w == 0.0:
                    continue
                t = seg * jnp.asarray(w, x.dtype)
                outs[si] = t if outs[si] is None else outs[si] + t
    return tuple(outs)


def insdwt2d(a, h, v, d, f2d: Filters2D, out_shape):
    """One non-separable 2D synthesis level (4-phase polyphase inverse,
    nonseparable.cu:176-225)."""
    nr, nc = out_shape[-2], out_shape[-1]
    L_r, L_c = a.shape[-2], a.shape[-1]
    hlen = f2d.hlen
    hlen2 = hlen // 2
    sigma = 1 if hlen2 % 2 == 0 else 0
    c = hlen2 // 2
    Lout_r, Lout_c = (nr + 1) // 2, (nc + 1) // 2

    coeffs = jnp.stack([a, h, v, d], axis=-3)  # (..., 4, L_r, L_c)

    # phase-dependent pads (same recipe as the 1D synthesis)
    def pad_for(p, L, Lout):
        pp = (p + sigma) & 1
        delta = (p + sigma) >> 1
        start = delta - c
        lpad = max(-start, 0)
        rpad = max(start + Lout + hlen2 - 1 - L, 0)
        return pp, start + lpad, lpad, rpad

    # all four phases share delta/lpad per parity; pad once with the max
    pads = {p: pad_for(p, L_r, Lout_r) for p in (0, 1)}
    lpad = max(pads[0][2], pads[1][2])
    rpad = max(pads[0][3], pads[1][3])
    xp = _pad2_periodic(coeffs, lpad, rpad)

    # rhs[(py*2+px), b, jy, jx] = F_b[hlen-1-2jy-offy, hlen-1-2jx-offx]
    rhs = np.zeros((4, 4, hlen2, hlen2))
    offs = {}
    for p in (0, 1):
        pp = (p + sigma) & 1
        offs[p] = 1 - pp
    js = np.arange(hlen2)
    for py in (0, 1):
        for px in (0, 1):
            ty = hlen - 1 - 2 * js - offs[py]
            tx = hlen - 1 - 2 * js - offs[px]
            for b, F in enumerate(f2d.rec):
                rhs[py * 2 + px, b] = F[np.ix_(ty, tx)]

    outs = {}
    for py in (0, 1):
        by = pads[py][1] + lpad - pads[py][2]
        for px in (0, 1):
            bx = pads[px][1] + lpad - pads[px][2]
            win = xp[..., by: by + Lout_r + hlen2 - 1,
                     bx: bx + Lout_c + hlen2 - 1]
            if hlen > _SLICE_TAP_LIMIT:
                o = _conv_nchw(win, rhs[py * 2 + px: py * 2 + px + 1, :])
                outs[(py, px)] = o[..., 0, :, :]
                continue
            acc = None
            for b in range(4):
                wb = win[..., b, :, :]
                for jy in range(hlen2):
                    for jx in range(hlen2):
                        w = float(rhs[py * 2 + px, b, jy, jx])
                        if w == 0.0:
                            continue
                        t = wb[..., jy: jy + Lout_r, jx: jx + Lout_c] \
                            * jnp.asarray(w, a.dtype)
                        acc = t if acc is None else acc + t
            outs[(py, px)] = acc

    top = jnp.stack([outs[(0, 0)], outs[(0, 1)]], axis=-1)
    bot = jnp.stack([outs[(1, 0)], outs[(1, 1)]], axis=-1)
    top = top.reshape(*top.shape[:-2], 2 * Lout_c)
    bot = bot.reshape(*bot.shape[:-2], 2 * Lout_c)
    out = jnp.stack([top, bot], axis=-2).reshape(
        *top.shape[:-2], 2 * Lout_r, 2 * Lout_c)
    return out[..., :nr, :nc]


def ns_swt2d_level(x, f2d: Filters2D, level: int):
    """One non-separable stationary analysis level (nonseparable.cu:304-354)."""
    hlen = f2d.hlen
    s = hlen // 2
    factor = 1 << (level - 1)
    lpad = (hlen - 1 - s) * factor
    xp = _pad2_periodic(x, lpad, s * factor)
    if hlen > _SLICE_TAP_LIMIT:
        rhs = np.stack([f[::-1, ::-1] for f in f2d.dec])[:, None]
        out = _conv_nchw(xp, rhs, dilation=(factor, factor))
        return tuple(out[..., i, :, :] for i in range(4))
    nr, nc = x.shape[-2], x.shape[-1]
    outs = [None] * 4
    for k in range(hlen):
        oy = lpad + (s - k) * factor
        slab = xp[..., oy: oy + nr, :]
        for l in range(hlen):
            ox = lpad + (s - l) * factor
            seg = slab[..., :, ox: ox + nc]
            for si, F in enumerate(f2d.dec):
                w = float(F[k, l])
                if w == 0.0:
                    continue
                t = seg * jnp.asarray(w, x.dtype)
                outs[si] = t if outs[si] is None else outs[si] + t
    return tuple(outs)


def ins_swt2d_level(a, h, v, d, f2d: Filters2D, level: int):
    """One non-separable stationary synthesis level, scaled by 1/4
    (nonseparable.cu:360-401)."""
    hlen = f2d.hlen
    s = hlen // 2 - 1 if hlen % 2 == 0 else hlen // 2
    factor = 1 << (level - 1)
    lpad = (hlen - 1 - s) * factor
    if hlen > _SLICE_TAP_LIMIT:
        coeffs = jnp.stack([a, h, v, d], axis=-3)
        xp = _pad2_periodic(coeffs, lpad, max(s, 0) * factor)
        rhs = np.stack([f[::-1, ::-1] * 0.25
                        for f in f2d.rec])[None]  # (1,4,k,k)
        out = _conv_nchw(xp, rhs, dilation=(factor, factor))
        return out[..., 0, :, :]
    nr, nc = a.shape[-2], a.shape[-1]
    planes = [_pad2_periodic(p, lpad, max(s, 0) * factor)
              for p in (a, h, v, d)]
    out = None
    for k in range(hlen):
        oy = lpad + (s - k) * factor
        for l in range(hlen):
            ox = lpad + (s - l) * factor
            for si, F in enumerate(f2d.rec):
                w = float(F[k, l]) * 0.25
                if w == 0.0:
                    continue
                t = planes[si][..., oy: oy + nr, ox: ox + nc] \
                    * jnp.asarray(w, a.dtype)
                out = t if out is None else out + t
    return out


def ns_wavedec2(image, f2d, levels):
    fb = f2d.separable_bank()
    if fb is not None:
        from . import dwt
        return dwt.wavedec2(image, fb, levels)
    a = image
    details = []
    for _ in range(levels):
        a, h, v, d = nsdwt2d(a, f2d)
        details.append((h, v, d))
    return [a] + details


def ns_waverec2(coeffs, f2d, shape):
    fb = f2d.separable_bank()
    if fb is not None:
        from . import dwt
        return dwt.waverec2(coeffs, fb, shape)
    levels = len(coeffs) - 1
    sizes = [tuple(shape[-2:])]
    for _ in range(levels):
        sizes.append((div2(sizes[-1][0]), div2(sizes[-1][1])))
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = insdwt2d(a, h, v, d, f2d, sizes[lev - 1])
    return a


def ns_swt2d(image, f2d, levels):
    fb = f2d.separable_bank()
    if fb is not None:
        from . import swt
        return swt.swt2d(image, fb, levels)
    a = image
    details = []
    for lev in range(1, levels + 1):
        a, h, v, d = ns_swt2d_level(a, f2d, lev)
        details.append((h, v, d))
    return [a] + details


def ins_swt2d(coeffs, f2d):
    fb = f2d.separable_bank()
    if fb is not None:
        from . import swt
        return swt.iswt2d(coeffs, fb)
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = ins_swt2d_level(a, h, v, d, f2d, lev)
    return a

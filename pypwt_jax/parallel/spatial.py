"""Spatially-sharded transforms of single large images: rows are sharded
across devices and the row-pass filter support is satisfied by exchanging
halo rows between ring neighbours with ``ppermute``.

This is the distributed generalization of the reference kernels' in-thread
periodic indexing (separable.cu:112-121): the periodic wrap lands naturally
on the first<->last link of the ring, so a halo exchange on a ring mesh
*is* periodization.  Column passes stay local (each shard holds full rows).

Halo widths: DWT analysis needs (hlen-1-s, s-1) rows (conv.analysis_pads);
synthesis needs coefficient halos from conv.synthesis_pads; SWT dilates
both by 2^(level-1).  Halos wider than one shard (deep SWT dilations) are
gathered with one ppermute per ring hop, so sharded SWT is depth-complete
(the constraint SURVEY.md §7 flags is handled, not refused).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jax import shard_map

from ..core import conv
from ..core import dwt as _dwt
from ..core import swt as _swt
from .mesh import BATCH_AXIS, ROW_AXIS


def _collect_left(x, pad, axis_name, axis_size):
    """The ``pad`` samples preceding this shard's block in the global
    (periodic) array: the tail of the left neighbors' concatenation,
    gathered farthest-first with one ppermute per ring hop.  Hops past
    axis_size wrap (the perm is mod axis_size), so pads wider than the
    whole array keep periodic semantics."""
    n = x.shape[-1]
    parts = []
    for j in range(-(-pad // n), 0, -1):
        perm = [(p, (p + j) % axis_size) for p in range(axis_size)]
        width = pad - (j - 1) * n
        seg = x if width >= n else x[..., n - width:]
        parts.append(jax.lax.ppermute(seg, axis_name, perm))
    return parts


def _collect_right(x, pad, axis_name, axis_size):
    """The ``pad`` samples following this shard's block (heads of the
    right neighbors), nearest-first."""
    n = x.shape[-1]
    parts = []
    for j in range(1, -(-pad // n) + 1):
        perm = [(p, (p - j) % axis_size) for p in range(axis_size)]
        width = pad - (j - 1) * n
        seg = x if width >= n else x[..., :width]
        parts.append(jax.lax.ppermute(seg, axis_name, perm))
    return parts


def halo_exchange_last(x, lpad, rpad, axis_name, axis_size):
    """Periodic halo exchange along the last axis of a sharded-by-last-axis
    array: prepend the ``lpad`` samples preceding this shard's block and
    append the ``rpad`` samples following it.  Pads wider than one shard
    gather from further neighbors with one ppermute per hop (the deep-SWT
    dilation regime, SURVEY.md §7); with axis_size == 1 this degenerates
    to plain periodic padding.
    """
    if axis_size == 1:
        return conv.periodic_pad_last(x, lpad, rpad)
    parts = _collect_left(x, lpad, axis_name, axis_size) if lpad else []
    parts.append(x)
    if rpad:
        parts.extend(_collect_right(x, rpad, axis_name, axis_size))
    return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else x


def _analysis_rows_sharded(x, fb, axis_name, axis_size):
    """Decimating analysis along axis -2 (rows) with halo exchange."""
    hlen = fb.dec_lo.shape[0] if hasattr(fb.dec_lo, "shape") else len(
        fb.dec_lo)
    xt = jnp.swapaxes(x, -1, -2)
    lpad, rpad = conv.analysis_pads(hlen)
    xp = halo_exchange_last(xt, lpad, rpad, axis_name, axis_size)
    L = xt.shape[-1] // 2
    lo, hi = conv.analysis_core(xp, fb.dec_lo, fb.dec_hi, L)
    return jnp.swapaxes(lo, -1, -2), jnp.swapaxes(hi, -1, -2)


def _synthesis_rows_sharded(lo, hi, fb, axis_name, axis_size):
    """Upsampling synthesis along axis -2 (rows) with halo exchange."""
    hlen = fb.rec_lo.shape[0] if hasattr(fb.rec_lo, "shape") else len(
        fb.rec_lo)
    lot = jnp.swapaxes(lo, -1, -2)
    hit = jnp.swapaxes(hi, -1, -2)
    L = lot.shape[-1]
    n_out = 2 * L
    lpad, rpad = conv.synthesis_pads(hlen, L, n_out)
    lop = halo_exchange_last(lot, lpad, rpad, axis_name, axis_size)
    hip = halo_exchange_last(hit, lpad, rpad, axis_name, axis_size)
    out = conv.synthesis_core(lop, hip, fb.rec_lo, fb.rec_hi, n_out, L,
                              lpad)
    return jnp.swapaxes(out, -1, -2)


def _rows_before(x, pad, axis_name, axis_size):
    """The ``pad`` rows (axis -2) preceding this shard's block, gathered
    farthest-first with one ppermute per ring hop."""
    n = x.shape[-2]
    parts = []
    for j in range(-(-pad // n), 0, -1):
        perm = [(p, (p + j) % axis_size) for p in range(axis_size)]
        width = pad - (j - 1) * n
        seg = x if width >= n else x[..., n - width:, :]
        parts.append(jax.lax.ppermute(seg, axis_name, perm))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0]


def _rows_after(x, pad, axis_name, axis_size):
    """The ``pad`` rows (axis -2) following this shard's block."""
    n = x.shape[-2]
    parts = []
    for j in range(1, -(-pad // n) + 1):
        perm = [(p, (p - j) % axis_size) for p in range(axis_size)]
        width = pad - (j - 1) * n
        seg = x if width >= n else x[..., :width, :]
        parts.append(jax.lax.ppermute(seg, axis_name, perm))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0]


def _dwt2d_level_sharded(a, fb, axis_name, axis_size):
    """One sharded separable analysis level: local column pass, row pass
    with ppermute halos."""
    if axis_size == 1:
        return _dwt.dwt2d(a, fb)  # locally periodic: wrapped kernels
    t1, t2 = conv.analysis_last(a, fb.dec_lo, fb.dec_hi)  # cols: local
    a2, h = _analysis_rows_sharded(t1, fb, axis_name, axis_size)
    v, d = _analysis_rows_sharded(t2, fb, axis_name, axis_size)
    return a2, h, v, d


def _idwt2d_level_sharded(a, h, v, d, fb, axis_name, axis_size):
    """One sharded separable synthesis level."""
    nr_out = 2 * a.shape[-2]
    nc_out = 2 * a.shape[-1]
    if axis_size == 1:
        return _dwt.idwt2d(a, h, v, d, fb, (nr_out, nc_out))
    t1 = _synthesis_rows_sharded(a, h, fb, axis_name, axis_size)
    t2 = _synthesis_rows_sharded(v, d, fb, axis_name, axis_size)
    return conv.synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi, nc_out)


def _local_wavedec2(x, fb, levels, axis_name, axis_size):
    a = x
    details = []
    for _ in range(levels):
        a, h, v, d = _dwt2d_level_sharded(a, fb, axis_name, axis_size)
        details.append((h, v, d))
    return [a] + details


def _local_waverec2(coeffs, fb, axis_name, axis_size):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = _idwt2d_level_sharded(a, h, v, d, fb, axis_name, axis_size)
    return a


def _check_divisible(nr, nc, levels, n_rows):
    if nc % (1 << levels):
        raise ValueError(
            f"row length {nc} must be divisible by 2^levels for the "
            "row-sharded path")
    if nr % (n_rows << levels):
        raise ValueError(
            f"{nr} rows cannot be sharded over {n_rows} devices for "
            f"{levels} levels (need divisibility by {n_rows << levels})")


def wavedec2_rowsharded(image, fb, levels, mesh):
    """Multi-level separable 2D forward transform of an image whose rows
    are sharded over the mesh's row axis.  ``image`` may have a leading
    batch axis, sharded over the data axis.
    """
    nr, nc = image.shape[-2], image.shape[-1]
    n_rows = mesh.shape[ROW_AXIS]
    _check_divisible(nr, nc, levels, n_rows)
    batched = image.ndim == 3
    spec = (P(BATCH_AXIS, ROW_AXIS, None) if batched
            else P(ROW_AXIS, None))

    fn = shard_map(
        lambda x: _local_wavedec2(x, fb, levels, ROW_AXIS, n_rows),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(image)


def waverec2_rowsharded(coeffs, fb, mesh, batched=False):
    """Inverse of ``wavedec2_rowsharded``."""
    n_rows = mesh.shape[ROW_AXIS]
    spec = (P(BATCH_AXIS, ROW_AXIS, None) if batched
            else P(ROW_AXIS, None))
    fn = shard_map(
        lambda c: _local_waverec2(c, fb, ROW_AXIS, n_rows),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(coeffs)


# ---------------------------------------------------------------------------
# Stationary transform, row-sharded (halo = dilated filter support)
# ---------------------------------------------------------------------------

def _swt_last_sharded(x, fb, level, axis_name, axis_size):
    """A-trous analysis along the (sharded) LAST axis with dilated halo
    exchange."""
    hlen = fb.dec_lo.shape[0] if hasattr(fb.dec_lo, "shape") else len(
        fb.dec_lo)
    s = hlen // 2
    factor = 1 << (level - 1)
    lpad, rpad = (hlen - 1 - s) * factor, s * factor
    xp = halo_exchange_last(x, lpad, rpad, axis_name, axis_size)
    n = x.shape[-1]
    flo = conv._as_taps(fb.dec_lo, x.dtype)
    fhi = conv._as_taps(fb.dec_hi, x.dtype)
    lo = None
    hi = None
    for k in range(hlen):
        ofs = lpad + (s - k) * factor
        seg = xp[..., ofs: ofs + n]
        lo = seg * flo[k] if lo is None else lo + seg * flo[k]
        hi = seg * fhi[k] if hi is None else hi + seg * fhi[k]
    return lo, hi


def _swt_rows_sharded(x, fb, level, axis_name, axis_size):
    xt = jnp.swapaxes(x, -1, -2)
    lo, hi = _swt_last_sharded(xt, fb, level, axis_name, axis_size)
    return jnp.swapaxes(lo, -1, -2), jnp.swapaxes(hi, -1, -2)


def _iswt_last_sharded(lo, hi, fb, level, axis_name, axis_size):
    """A-trous synthesis (with the /2 averaging) along the sharded LAST
    axis."""
    hlen = fb.rec_lo.shape[0] if hasattr(fb.rec_lo, "shape") else len(
        fb.rec_lo)
    s = hlen // 2 - 1 if hlen % 2 == 0 else hlen // 2
    factor = 1 << (level - 1)
    lpad, rpad = (hlen - 1 - s) * factor, max(s, 0) * factor
    lop = halo_exchange_last(lo, lpad, rpad, axis_name, axis_size)
    hip = halo_exchange_last(hi, lpad, rpad, axis_name, axis_size)
    n = lo.shape[-1]
    flo = conv._as_taps(fb.rec_lo, lo.dtype)
    fhi = conv._as_taps(fb.rec_hi, lo.dtype)
    half = jnp.asarray(0.5, lo.dtype)
    out = None
    for k in range(hlen):
        ofs = lpad + (s - k) * factor
        seg = (lop[..., ofs: ofs + n] * (flo[k] * half)
               + hip[..., ofs: ofs + n] * (fhi[k] * half))
        out = seg if out is None else out + seg
    return out


def _iswt_rows_sharded(lo, hi, fb, level, axis_name, axis_size):
    lot = jnp.swapaxes(lo, -1, -2)
    hit = jnp.swapaxes(hi, -1, -2)
    out = _iswt_last_sharded(lot, hit, fb, level, axis_name, axis_size)
    return jnp.swapaxes(out, -1, -2)


def _swt2d_level_sharded(a, fb, lev, axis_name, axis_size):
    if axis_size == 1:
        return _swt.swt2d_level(a, fb, lev)
    t1, t2 = conv.swt_analysis_last(a, fb.dec_lo, fb.dec_hi, lev)
    a2, h = _swt_rows_sharded(t1, fb, lev, axis_name, axis_size)
    v, d = _swt_rows_sharded(t2, fb, lev, axis_name, axis_size)
    return a2, h, v, d


def _iswt2d_level_sharded(a, h, v, d, fb, lev, axis_name, axis_size):
    if axis_size == 1:
        return _swt.iswt2d_level(a, h, v, d, fb, lev)
    t1 = _iswt_rows_sharded(a, h, fb, lev, axis_name, axis_size)
    t2 = _iswt_rows_sharded(v, d, fb, lev, axis_name, axis_size)
    return conv.swt_synthesis_last(t1, t2, fb.rec_lo, fb.rec_hi, lev)


def _local_swt2(x, fb, levels, axis_name, axis_size):
    a = x
    details = []
    for lev in range(1, levels + 1):
        a, h, v, d = _swt2d_level_sharded(a, fb, lev, axis_name,
                                          axis_size)
        details.append((h, v, d))
    return [a] + details


def _local_iswt2(coeffs, fb, axis_name, axis_size):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        a = _iswt2d_level_sharded(a, h, v, d, fb, lev, axis_name,
                                  axis_size)
    return a


def swt2d_rowsharded(image, fb, levels, mesh):
    n_rows = mesh.shape[ROW_AXIS]
    batched = image.ndim == 3
    spec = (P(BATCH_AXIS, ROW_AXIS, None) if batched
            else P(ROW_AXIS, None))
    fn = shard_map(
        lambda x: _local_swt2(x, fb, levels, ROW_AXIS, n_rows),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(image)


def iswt2d_rowsharded(coeffs, fb, mesh, batched=False):
    n_rows = mesh.shape[ROW_AXIS]
    spec = (P(BATCH_AXIS, ROW_AXIS, None) if batched
            else P(ROW_AXIS, None))
    fn = shard_map(
        lambda c: _local_iswt2(c, fb, ROW_AXIS, n_rows),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(coeffs)


# ---------------------------------------------------------------------------
# Grid sharding: both image axes sharded (rows x cols mesh), halo exchange
# on both; and long-signal 1D sharding (the "sequence-parallel" analog:
# the sequence axis is the signal axis, SURVEY.md §5)
# ---------------------------------------------------------------------------

from .mesh import COL_AXIS  # noqa: E402


def halo_exchange_rows(x, lpad, rpad, axis_name, axis_size):
    """Halo exchange along axis -2 without any transpose (multi-hop as
    needed; local periodic wrap when axis_size == 1)."""
    parts = []
    if axis_size == 1:
        n = x.shape[-2]
        if lpad:
            parts.append(x[..., n - lpad:, :] if lpad < n else
                         jnp.concatenate(
                             [x] * (-(-lpad // n)), axis=-2)[..., -lpad:,
                                                             :])
        parts.append(x)
        if rpad:
            parts.append(x[..., :rpad, :] if rpad < n else
                         jnp.concatenate(
                             [x] * (-(-rpad // n)), axis=-2)[..., :rpad,
                                                             :])
    else:
        if lpad:
            parts.append(_rows_before(x, lpad, axis_name, axis_size))
        parts.append(x)
        if rpad:
            parts.append(_rows_after(x, rpad, axis_name, axis_size))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else x


def _fold_padded(xp, lpad, rpad, r, c):
    """Fold a padded 1D chunk (lpad + r*c + rpad samples) into an
    (r, c + lpad + rpad) plane of per-row windows: row i holds samples
    [i*c - lpad, i*c + c + rpad) of the body.  This is the sharded-chunk
    analog of conv.fold_rows_analysis (valid pads instead of periodic
    rolls)."""
    w = c + lpad + rpad
    ext = jnp.concatenate(
        [xp, jnp.zeros(((r + 1) * c - xp.shape[0],), xp.dtype)])
    P = ext.reshape(r + 1, c)
    return jnp.concatenate([P[:r], P[1:]], axis=1)[:, :w]


def _analysis_axis_sharded(x, fb, axis, axis_name, axis_size):
    """Decimating analysis along ``axis`` with periodic halo exchange,
    then conv.analysis_core on the padded plane."""
    hlen = len(fb.dec_lo)
    lpad, rpad = conv.analysis_pads(hlen)
    last = axis in (-1, x.ndim - 1)
    if last and x.ndim == 1:
        rc = conv.long1d_shape(x.shape[0])
        if rc is not None and lpad + rpad <= rc[1]:
            r, c = rc
            xp = halo_exchange_last(x, lpad, rpad, axis_name, axis_size)
            fold = _fold_padded(xp, lpad, rpad, r, c)
            L = c // 2
            lo, hi = conv.analysis_core(fold, fb.dec_lo, fb.dec_hi, L)
            return lo.reshape(-1), hi.reshape(-1)
    if not last and x.ndim == 2:
        L = x.shape[-2] // 2
        xp = halo_exchange_rows(x, lpad, rpad, axis_name, axis_size)
        xt = jnp.swapaxes(xp, -1, -2)
        lo, hi = conv.analysis_core(xt, fb.dec_lo, fb.dec_hi, L)
        return jnp.swapaxes(lo, -1, -2), jnp.swapaxes(hi, -1, -2)
    xt = x if last else jnp.swapaxes(x, axis, -1)
    xp = halo_exchange_last(xt, lpad, rpad, axis_name, axis_size)
    L = xt.shape[-1] // 2
    lo, hi = conv.analysis_core(xp, fb.dec_lo, fb.dec_hi, L)
    if not last:
        lo = jnp.swapaxes(lo, axis, -1)
        hi = jnp.swapaxes(hi, axis, -1)
    return lo, hi


def _synthesis_axis_sharded(lo, hi, fb, axis, axis_name, axis_size):
    """Upsampling synthesis along ``axis`` with halo exchange, then
    conv.synthesis_core on the padded coefficient planes."""
    hlen = len(fb.rec_lo)
    last = axis in (-1, lo.ndim - 1)
    if last and lo.ndim == 1:
        rc = conv.long1d_shape(lo.shape[0])
        if rc is not None:
            r, c = rc
            lpad, rpad = conv.synthesis_pads(hlen, c, 2 * c)
            if lpad + rpad <= c:
                lop = halo_exchange_last(lo, lpad, rpad, axis_name,
                                         axis_size)
                hip = halo_exchange_last(hi, lpad, rpad, axis_name,
                                         axis_size)
                fl = _fold_padded(lop, lpad, rpad, r, c)
                fh = _fold_padded(hip, lpad, rpad, r, c)
                out = conv.synthesis_core(fl, fh, fb.rec_lo, fb.rec_hi,
                                          2 * c, c, lpad)
                return out.reshape(-1)
    if not last and lo.ndim == 2:
        L = lo.shape[-2]
        n_out = 2 * L
        lpad, rpad = conv.synthesis_pads(hlen, L, n_out)
        lop = halo_exchange_rows(lo, lpad, rpad, axis_name, axis_size)
        hip = halo_exchange_rows(hi, lpad, rpad, axis_name, axis_size)
        lot = jnp.swapaxes(lop, -1, -2)
        hit = jnp.swapaxes(hip, -1, -2)
        out = conv.synthesis_core(lot, hit, fb.rec_lo, fb.rec_hi, n_out,
                                  L, lpad)
        return jnp.swapaxes(out, -1, -2)
    lot = lo if last else jnp.swapaxes(lo, axis, -1)
    hit = hi if last else jnp.swapaxes(hi, axis, -1)
    L = lot.shape[-1]
    n_out = 2 * L
    lpad, rpad = conv.synthesis_pads(hlen, L, n_out)
    lop = halo_exchange_last(lot, lpad, rpad, axis_name, axis_size)
    hip = halo_exchange_last(hit, lpad, rpad, axis_name, axis_size)
    out = conv.synthesis_core(lop, hip, fb.rec_lo, fb.rec_hi, n_out, L,
                              lpad)
    if not last:
        out = jnp.swapaxes(out, axis, -1)
    return out


def _local_wavedec2_grid(x, fb, levels, n_rows, n_cols):
    a = x
    details = []
    for _ in range(levels):
        t1, t2 = _analysis_axis_sharded(a, fb, -1, COL_AXIS, n_cols)
        a, h = _analysis_axis_sharded(t1, fb, -2, ROW_AXIS, n_rows)
        v, d = _analysis_axis_sharded(t2, fb, -2, ROW_AXIS, n_rows)
        details.append((h, v, d))
    return [a] + details


def _local_waverec2_grid(coeffs, fb, n_rows, n_cols):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        t1 = _synthesis_axis_sharded(a, h, fb, -2, ROW_AXIS, n_rows)
        t2 = _synthesis_axis_sharded(v, d, fb, -2, ROW_AXIS, n_rows)
        a = _synthesis_axis_sharded(t1, t2, fb, -1, COL_AXIS, n_cols)
    return a


def _check_grid(nr, nc, levels, n_rows, n_cols):
    if nr % (n_rows << levels) or nc % (n_cols << levels):
        raise ValueError(
            f"({nr}, {nc}) cannot be grid-sharded over ({n_rows}, "
            f"{n_cols}) chips for {levels} levels")


def wavedec2_gridsharded(image, fb, levels, mesh):
    """Multi-level separable 2D forward transform of an image sharded over
    a (rows, cols) mesh in BOTH spatial axes; halos ride ppermute on each
    ring, so single images larger than one device's memory can be split."""
    nr, nc = image.shape[-2], image.shape[-1]
    n_rows = mesh.shape[ROW_AXIS]
    n_cols = mesh.shape[COL_AXIS]
    _check_grid(nr, nc, levels, n_rows, n_cols)
    spec = P(ROW_AXIS, COL_AXIS)
    fn = shard_map(
        lambda x: _local_wavedec2_grid(x, fb, levels, n_rows, n_cols),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(image)


def waverec2_gridsharded(coeffs, fb, mesh):
    n_rows = mesh.shape[ROW_AXIS]
    n_cols = mesh.shape[COL_AXIS]
    spec = P(ROW_AXIS, COL_AXIS)
    fn = shard_map(
        lambda c: _local_waverec2_grid(c, fb, n_rows, n_cols),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(coeffs)


def _local_swt2_grid(x, fb, levels, n_rows, n_cols):
    """Stationary 2D transform with BOTH axes sharded: a-trous columns
    over the cols ring, then rows over the rows ring (dilated halos on
    each) — no single-axis counterpart in the reference, which is
    single-GPU (SURVEY.md §2.3)."""
    a = x
    details = []
    for lev in range(1, levels + 1):
        t1, t2 = _swt_last_sharded(a, fb, lev, COL_AXIS, n_cols)
        a, h = _swt_rows_sharded(t1, fb, lev, ROW_AXIS, n_rows)
        v, d = _swt_rows_sharded(t2, fb, lev, ROW_AXIS, n_rows)
        details.append((h, v, d))
    return [a] + details


def _local_iswt2_grid(coeffs, fb, n_rows, n_cols):
    levels = len(coeffs) - 1
    a = coeffs[0]
    for lev in range(levels, 0, -1):
        h, v, d = coeffs[lev]
        t1 = _iswt_rows_sharded(a, h, fb, lev, ROW_AXIS, n_rows)
        t2 = _iswt_rows_sharded(v, d, fb, lev, ROW_AXIS, n_rows)
        a = _iswt_last_sharded(t1, t2, fb, lev, COL_AXIS, n_cols)
    return a


def swt2d_gridsharded(image, fb, levels, mesh):
    n_rows = mesh.shape[ROW_AXIS]
    n_cols = mesh.shape[COL_AXIS]
    spec = P(ROW_AXIS, COL_AXIS)
    fn = shard_map(
        lambda x: _local_swt2_grid(x, fb, levels, n_rows, n_cols),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(image)


def iswt2d_gridsharded(coeffs, fb, mesh):
    n_rows = mesh.shape[ROW_AXIS]
    n_cols = mesh.shape[COL_AXIS]
    spec = P(ROW_AXIS, COL_AXIS)
    fn = shard_map(
        lambda c: _local_iswt2_grid(c, fb, n_rows, n_cols),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(coeffs)


def _local_wavedec1_seq(x, fb, levels, axis_name, n_shards):
    """Shard-local multi-level 1D analysis along the sharded LAST axis
    (the body of wavedec1_seqsharded, exposed for plan classes)."""
    a, details = x, []
    for _ in range(levels):
        a, d = _analysis_axis_sharded(a, fb, -1, axis_name, n_shards)
        details.append(d)
    return [a] + details


def _local_waverec1_seq(coeffs, fb, axis_name, n_shards):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        a = _synthesis_axis_sharded(a, coeffs[lev], fb, -1, axis_name,
                                    n_shards)
    return a


def _local_swt1_seq(x, fb, levels, axis_name, n_shards):
    """Shard-local multi-level a-trous 1D analysis along the sharded
    LAST axis (dilated halos ride ppermute; multi-hop for deep levels —
    no upstream counterpart, the reference is single-GPU)."""
    a, details = x, []
    for lev in range(1, levels + 1):
        a, d = _swt_last_sharded(a, fb, lev, axis_name, n_shards)
        details.append(d)
    return [a] + details


def _local_iswt1_seq(coeffs, fb, axis_name, n_shards):
    a = coeffs[0]
    for lev in range(len(coeffs) - 1, 0, -1):
        a = _iswt_last_sharded(a, coeffs[lev], fb, lev, axis_name,
                               n_shards)
    return a


def swt1d_seqsharded(x, fb, levels, mesh, axis_name=ROW_AXIS):
    """Multi-level stationary 1D transform of a signal whose LAST axis
    is sharded across chips."""
    n_shards = mesh.shape[axis_name]
    spec = P(*([None] * (x.ndim - 1)), axis_name)
    fn = shard_map(
        lambda v: _local_swt1_seq(v, fb, levels, axis_name, n_shards),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(x)


def iswt1d_seqsharded(coeffs, fb, mesh, axis_name=ROW_AXIS):
    n_shards = mesh.shape[axis_name]
    ndim = coeffs[0].ndim
    spec = P(*([None] * (ndim - 1)), axis_name)
    fn = shard_map(
        lambda c: _local_iswt1_seq(c, fb, axis_name, n_shards),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(coeffs)


def wavedec1_seqsharded(x, fb, levels, mesh, axis_name=ROW_AXIS):
    """Multi-level 1D transform of signals whose LAST axis is sharded
    across chips — the long-signal ("sequence-parallel") configuration.
    Leading axes (if any) are local/batch."""
    n = x.shape[-1]
    n_shards = mesh.shape[axis_name]
    if n % (n_shards << levels):
        raise ValueError(
            f"signal length {n} cannot be sharded over {n_shards} chips "
            f"for {levels} levels")
    spec = P(*([None] * (x.ndim - 1)), axis_name)

    def local(xl):
        a = xl
        details = []
        for _ in range(levels):
            a, dd = _analysis_axis_sharded(a, fb, -1, axis_name, n_shards)
            details.append(dd)
        return [a] + details

    fn = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(x)


def waverec1_seqsharded(coeffs, fb, mesh, axis_name=ROW_AXIS):
    """Inverse of ``wavedec1_seqsharded``."""
    n_shards = mesh.shape[axis_name]
    ndim = coeffs[0].ndim
    spec = P(*([None] * (ndim - 1)), axis_name)

    def local(c):
        levels = len(c) - 1
        a = c[0]
        for lev in range(levels, 0, -1):
            a = _synthesis_axis_sharded(a, c[lev], fb, -1, axis_name,
                                        n_shards)
        return a

    fn = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return jax.jit(fn)(coeffs)

"""Collective-schedule audit: makes the multi-device scaling claim
falsifiable without multi-device hardware.

The distributed transforms (parallel/spatial.py) promise a specific
communication pattern: per level, a fixed number of ring-neighbor
``ppermute`` exchanges whose operands are halo-sized (a few rows), with
ZERO all-gathers / all-reduces / all-to-alls anywhere in a transform.
That pattern — not any CPU-simulated timing — is the scaling argument:
halo bytes per device are mesh-size-independent, so per-device work stays
constant as the mesh grows (the only sanctioned all-reduce is the psum
of a norm).  The reference has no analog: its only "collective" is
single-GPU cuBLAS (wt.cu:368-416).

This module (a) extracts the collective schedule from a lowered and a
compiled program and (b) predicts the exact schedule analytically from the
halo geometry (the same hop arithmetic as spatial._collect_left/right).

tests/test_collectives.py asserts predicted == lowered == compiled for
every sharded path; a regression that inserts one stray all-gather (or
silently drops a halo exchange) fails CI.
"""

from __future__ import annotations

import math
import re

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from ..core import conv
from . import spatial
from .mesh import COL_AXIS, ROW_AXIS


# ---------------------------------------------------------------------------
# Schedule extraction
# ---------------------------------------------------------------------------

# StableHLO (lowered, pre-SPMD): ops appear as stablehlo.<name>
_SHLO_OPS = {
    "ppermute": r"stablehlo\.collective_permute",
    "all_gather": r"stablehlo\.all_gather",
    "all_reduce": r"stablehlo\.all_reduce",
    "all_to_all": r"stablehlo\.all_to_all",
}
# Optimized HLO (compiled): `%x = f32[r,c]{..} collective-permute(...)`;
# async backends split ops into -start/-done pairs — count starts only.
_HLO_OPS = {
    "ppermute": r"collective-permute(?:-start)?\(",
    "all_gather": r"all-gather(?:-start)?\(",
    "all_reduce": r"all-reduce(?:-start)?\(",
    "all_to_all": r"all-to-all(?:-start)?\(",
}
_HLO_PPERM_SHAPE = re.compile(
    r"=\s*\w+\[([\d,]*)\]\S*\s+collective-permute(?:-start)?\(")


def _count(txt: str, pat: str) -> int:
    return len(re.findall(pat, txt))


def schedule_of_lowered(lowered) -> dict:
    """Collective counts of a ``jax.jit(...).lower(...)`` module."""
    txt = lowered.as_text()
    return {k: _count(txt, pat) for k, pat in _SHLO_OPS.items()}


def schedule_of_compiled(compiled) -> dict:
    """Collective counts + per-ppermute operand element sizes of a
    compiled executable's optimized HLO."""
    txt = compiled.as_text()
    out = {k: _count(txt, pat) for k, pat in _HLO_OPS.items()}
    elems = []
    for dims in _HLO_PPERM_SHAPE.findall(txt):
        elems.append(math.prod(int(d) for d in dims.split(",") if d))
    out["ppermute_elems"] = sorted(elems)
    return out


def audit(fn, *args) -> dict:
    """Lower AND compile ``fn`` on ``args`` (arrays or sharded
    ShapeDtypeStructs) and return both schedules.  ``consistent`` is True
    when the compiler neither added nor removed collectives."""
    low = jax.jit(fn).lower(*args)
    comp = low.compile()
    s, c = schedule_of_lowered(low), schedule_of_compiled(comp)
    keys = ("ppermute", "all_gather", "all_reduce", "all_to_all")
    return {"stablehlo": s, "compiled": c,
            "consistent": all(s[k] == c[k] for k in keys)}


# ---------------------------------------------------------------------------
# Sharded-path constructors (the same programs spatial.py runs, exposed
# as jittable closures so they can be lowered without executing)
# ---------------------------------------------------------------------------

def _row_struct(mesh, shape):
    return jax.ShapeDtypeStruct(
        shape, jnp.float32,
        sharding=NamedSharding(mesh, P(ROW_AXIS, None)))


def rowsharded_fns(fb, levels, mesh, swt=False):
    """(forward, inverse) shard_map closures of the row-sharded path,
    identical to what wavedec2_rowsharded / swt2d_rowsharded jit."""
    n = mesh.shape[ROW_AXIS]
    spec = P(ROW_AXIS, None)
    if swt:
        fwd = lambda x: spatial._local_swt2(x, fb, levels, ROW_AXIS, n)
        inv = lambda c: spatial._local_iswt2(c, fb, ROW_AXIS, n)
    else:
        fwd = lambda x: spatial._local_wavedec2(x, fb, levels, ROW_AXIS, n)
        inv = lambda c: spatial._local_waverec2(c, fb, ROW_AXIS, n)
    mk = lambda f: shard_map(f, mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_vma=False)
    return mk(fwd), mk(inv)


def gridsharded_fns(fb, levels, mesh, swt=False):
    nr = mesh.shape[ROW_AXIS]
    nc = mesh.shape[COL_AXIS]
    spec = P(ROW_AXIS, COL_AXIS)
    if swt:
        fwd = lambda x: spatial._local_swt2_grid(x, fb, levels, nr, nc)
        inv = lambda c: spatial._local_iswt2_grid(c, fb, nr, nc)
    else:
        fwd = lambda x: spatial._local_wavedec2_grid(x, fb, levels, nr, nc)
        inv = lambda c: spatial._local_waverec2_grid(c, fb, nr, nc)
    mk = lambda f: shard_map(f, mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_vma=False)
    return mk(fwd), mk(inv)


def seqsharded_fns(fb, levels, mesh, axis_name=ROW_AXIS):
    n = mesh.shape[axis_name]
    spec = P(axis_name)

    def fwd(xl):
        a, details = xl, []
        for _ in range(levels):
            a, d = spatial._analysis_axis_sharded(a, fb, -1, axis_name, n)
            details.append(d)
        return [a] + details

    def inv(c):
        a = c[0]
        for lev in range(len(c) - 1, 0, -1):
            a = spatial._synthesis_axis_sharded(a, c[lev], fb, -1,
                                                axis_name, n)
        return a

    mk = lambda f: shard_map(f, mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_vma=False)
    return mk(fwd), mk(inv)


# ---------------------------------------------------------------------------
# Analytic schedule prediction — the specification the lowering must meet.
# Hop arithmetic mirrors spatial._collect_left/_collect_right: gathering
# ``pad`` rows from a ring of shards of ``n`` rows costs ceil(pad/n)
# ppermutes per side (multi-hop for deep-SWT dilations).
# ---------------------------------------------------------------------------

def _hops(pad: int, n: int) -> int:
    return 0 if pad <= 0 else -(-pad // n)


def predict_rowsharded(fb, levels, Nr, Nc, n_shards, swt=False):
    """Exact ppermute counts (forward, inverse) of the row-sharded path,
    plus the total halo bytes one device sends per direction (forward)."""
    fwd = inv = 0
    halo_bytes = 0
    for i in range(levels):
        lev = i + 1
        if swt:
            n, c = Nr // n_shards, Nc
            f = 1 << (lev - 1)
            s = fb.hlen // 2
            lp, rp = (fb.hlen - 1 - s) * f, s * f
            fwd += 2 * (_hops(lp, n) + _hops(rp, n))
            halo_bytes += 2 * (lp + rp) * c * 4
            si = fb.hlen // 2 - 1 if fb.hlen % 2 == 0 else fb.hlen // 2
            lpi, rpi = (fb.hlen - 1 - si) * f, max(si, 0) * f
            inv += 4 * (_hops(lpi, n) + _hops(rpi, n))
        else:
            n, c = (Nr // n_shards) >> i, Nc >> i
            lp, rp = conv.analysis_pads(fb.hlen)
            fwd += 2 * (_hops(lp, n) + _hops(rp, n))
            halo_bytes += 2 * (lp + rp) * c * 4
            # inverse consumes the NEXT-coarser level's coeff blocks
            lpi, rpi = conv.synthesis_pads(fb.hlen, n // 2, n)
            inv += 4 * (_hops(lpi, n // 2) + _hops(rpi, n // 2))
    return {"fwd_ppermute": fwd, "inv_ppermute": inv,
            "fwd_halo_bytes": halo_bytes}


def predict_seqsharded(fb, levels, N, n_shards):
    """Exact ppermute counts of the seq-sharded 1D path (single signal,
    last axis split across the ring)."""
    fwd = inv = 0
    for i in range(levels):
        n = (N // n_shards) >> i
        lp, rp = conv.analysis_pads(fb.hlen)
        fwd += _hops(lp, n) + _hops(rp, n)
        li, ri = conv.synthesis_pads(fb.hlen, n // 2, n)
        inv += 2 * (_hops(li, n // 2) + _hops(ri, n // 2))
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}


def predict_gridsharded(fb, levels, Nr, Nc, n_rows, n_cols):
    """Exact ppermute counts of the grid-sharded path: per level one
    column exchange on the image plus two row exchanges on the column
    outputs (forward); four row + two column coefficient exchanges
    (inverse)."""
    fwd = inv = 0
    lp, rp = conv.analysis_pads(fb.hlen)
    for i in range(levels):
        nr = (Nr // n_rows) >> i
        nc = (Nc // n_cols) >> i
        fwd += (_hops(lp, nc) + _hops(rp, nc))          # cols on x
        fwd += 2 * (_hops(lp, nr) + _hops(rp, nr))      # rows on t1, t2
        li_r, ri_r = conv.synthesis_pads(fb.hlen, nr // 2, nr)
        li_c, ri_c = conv.synthesis_pads(fb.hlen, nc // 2, nc)
        inv += 4 * (_hops(li_r, nr // 2) + _hops(ri_r, nr // 2))
        inv += 2 * (_hops(li_c, nc // 2) + _hops(ri_c, nc // 2))
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}


def seqsharded_swt_fns(fb, levels, mesh, axis_name=ROW_AXIS):
    n = mesh.shape[axis_name]
    spec = P(axis_name)
    fwd = lambda x: spatial._local_swt1_seq(x, fb, levels, axis_name, n)
    inv = lambda c: spatial._local_iswt1_seq(c, fb, axis_name, n)
    mk = lambda f: shard_map(f, mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_vma=False)
    return mk(fwd), mk(inv)


def predict_seqsharded_swt(fb, levels, N, n_shards):
    """Exact ppermute counts of the seq-sharded stationary 1D path:
    one dilated exchange per level forward, two plane exchanges per
    level on the synthesis."""
    fwd = inv = 0
    n = N // n_shards  # undecimated: constant per level
    s = fb.hlen // 2
    si = fb.hlen // 2 - 1 if fb.hlen % 2 == 0 else fb.hlen // 2
    for lev in range(1, levels + 1):
        f = 1 << (lev - 1)
        lp, rp = (fb.hlen - 1 - s) * f, s * f
        fwd += _hops(lp, n) + _hops(rp, n)
        lpi, rpi = (fb.hlen - 1 - si) * f, max(si, 0) * f
        inv += 2 * (_hops(lpi, n) + _hops(rpi, n))
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}


def predict_gridsharded_swt(fb, levels, Nr, Nc, n_rows, n_cols):
    """Exact ppermute counts of the grid-sharded STATIONARY path: the
    a-trous halo dilates 2^(level-1); per level one column exchange on
    the undecimated image plus two row exchanges (forward), four row +
    two column plane exchanges with synthesis pads (inverse)."""
    fwd = inv = 0
    nrs, ncs = Nr // n_rows, Nc // n_cols  # undecimated: constant
    s = fb.hlen // 2
    si = fb.hlen // 2 - 1 if fb.hlen % 2 == 0 else fb.hlen // 2
    for lev in range(1, levels + 1):
        f = 1 << (lev - 1)
        lp, rp = (fb.hlen - 1 - s) * f, s * f
        fwd += (_hops(lp, ncs) + _hops(rp, ncs))       # cols on x
        fwd += 2 * (_hops(lp, nrs) + _hops(rp, nrs))   # rows on t1, t2
        lpi, rpi = (fb.hlen - 1 - si) * f, max(si, 0) * f
        inv += 4 * (_hops(lpi, nrs) + _hops(rpi, nrs))
        inv += 2 * (_hops(lpi, ncs) + _hops(rpi, ncs))
    return {"fwd_ppermute": fwd, "inv_ppermute": inv}

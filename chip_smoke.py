#!/usr/bin/env python
"""Smoke test of pypwt_jax on NVIDIA GPUs, at the sizes its users run.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the multi-device paths on 4 cards

Each phase drives the library through its public entry points
(``Wavelets``, ``pipeline``, ``BatchedWavelets``, ``ShardedWavelets``,
the functional ``nonsep`` module), compares the result on the card with an
independent float64 host reference (``tests/fft_oracle.py``, or a direct
numpy convolution for non-separable banks), and stops with exit status 1
on the first failure.  Data are uniform on 0..255, float32 unless stated,
made from a seeded generator.

Every phase prints one line: its max error beside its tolerance, and the
median host wall time of the timed call after warm-up (host clock around
``jax.block_until_ready``).  These times are informational; they are not
the benchmark.  The card's name and power limit come first, a large
device copy's rate is printed as a yardstick, and the last line of
standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

The script exits with status 1, printing no result, when JAX finds no
GPU.  It runs in one process: a JAX process reserves most of a card's
memory, so run one per card.

Tolerances:

* forward subbands at level l: 3e-4 * 2**l * 255, the reference's
  envelope on 0..255 data (pycudwt test/test_wavelets.py:100-103);
* round trips and pipelines: 7e-4 * 255 (the round-trip gate of
  bench.py and tools/bench_suite.py);
* the cuDNN-convolution phase (a 14x14 non-separable bank) is held to
  2e-2 as well: float32 with HIGHEST precision stays near 1e-4 there,
  while TF32's 10-bit mantissa puts the error near 1e-1;
* float64: 1e-10 * 255.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

SCALE = 255.0
RT_TOL = 7e-4 * SCALE
CONV_TOL = 2e-2
F64_TOL = 1e-10 * SCALE
BETA = 10.0
FAMILIES = ("haar", "db4", "sym8", "coif3", "bior4.4")

# Sizes of the one-card run (FULL) and of the four-card run (FULL_4).
FULL = dict(
    n2d=2048, n_swt=1024, batched=(2048, 4096), long_pow2=1 << 22,
    long_big=10 ** 7, n_ns=2048, stack=(64, 2048), n_bank=512,
    n_bank_fwd=256, long_bank=1 << 18, n_f64=1024, banks=None, reps=5,
    copy_elems=1 << 28, compile_threads=8)
FULL_4 = dict(stack=(256, 2048), n_shard=8192, seq=4 * 10 ** 7,
              swt_shape=(1024, 8192), swt_levels=7, reps=3)


def fwd_tol(level):
    return 3e-4 * (1 << level) * SCALE


class SmokeFailure(Exception):
    pass


class Smoke:
    """Prints one line per check and raises on the first failure."""

    def __init__(self):
        self.n_checks = 0

    def line(self, text):
        print(text, flush=True)

    def check(self, phase, err, tol, seconds=None, **extra):
        err = float(err)
        self.n_checks += 1
        ok = bool(np.isfinite(err) and err <= tol)
        parts = [f"phase={phase}", f"max_err={err:.3e}", f"tol={tol:.3e}"]
        if seconds is not None:
            parts.append(f"median_s={seconds:.6f}")
        parts += [f"{k}={v}" for k, v in extra.items()]
        parts.append("ok" if ok else "FAIL")
        self.line(" ".join(parts))
        if not ok:
            raise SmokeFailure(f"{phase}: max_err {err:.3e} > tol {tol:.3e}")


def median_time(fn, reps):
    """Median host wall time of ``fn()`` (already warmed up), each call
    ended by ``jax.block_until_ready``."""
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def uniform(rng, shape, dtype=np.float32):
    return (rng.random(shape, dtype=np.float32) * np.float32(SCALE)
            ).astype(dtype)


def pyr_err(got, want):
    """Worst error of a pyramid ``[A, lev1, ..., levL]`` against the
    oracle, each level against its own envelope: (err, tol) of the worst
    error-to-tolerance ratio."""
    levels = len(want) - 1
    pairs = [(levels, got[0], want[0])]
    for lev in range(1, levels + 1):
        g, w = got[lev], want[lev]
        if not isinstance(w, (list, tuple)):
            g, w = [g], [w]
        pairs += [(lev, gs, ws) for gs, ws in zip(g, w)]
    worst = (0.0, fwd_tol(1))
    for lev, g, w in pairs:
        g = np.asarray(g, np.float64)
        if g.shape != np.shape(w):
            raise SmokeFailure(f"shape {g.shape} != oracle {np.shape(w)}")
        e = float(np.abs(g - w).max())
        if e / fwd_tol(lev) >= worst[0] / worst[1]:
            worst = (e, fwd_tol(lev))
    return worst


def np_soft(x, beta):
    return np.sign(x) * np.maximum(np.abs(x) - beta, 0.0)


def oracle_denoise(img, fb, levels, beta):
    """Host reference of forward -> soft threshold (details) -> inverse."""
    import fft_oracle as fo
    pyr = fo.fft_wavedec2(img, fb, levels)
    pyr = [pyr[0]] + [tuple(np_soft(s, beta) for s in lev)
                      for lev in pyr[1:]]
    return fo.fft_waverec2(pyr, fb, img.shape)


def np_nsdwt2d(x, dec):
    """Direct float64 non-separable analysis level:
    out_s[i, j] = sum_kl F_s[::-1, ::-1][k, l] * xp[2i + k, 2j + l] on
    the periodically padded image (the oracle of tests/test_nonsep.py)."""
    x = np.asarray(x, np.float64)
    k = dec[0].shape[0]
    s = k // 2
    lp, rp = k - 1 - s, max(s - 1, 0)
    xp = np.pad(x, ((lp, rp), (lp, rp)), mode="wrap")
    lr, lc = x.shape[0] // 2, x.shape[1] // 2
    outs = []
    for F in dec:
        fr = np.asarray(F, np.float64)[::-1, ::-1]
        acc = np.zeros((lr, lc))
        for a in range(k):
            for b in range(k):
                acc += fr[a, b] * xp[a: a + 2 * lr: 2, b: b + 2 * lc: 2]
        outs.append(acc)
    return outs


def np_nswavedec2(x, dec, levels):
    a, out = x, []
    for _ in range(levels):
        a, h, v, d = np_nsdwt2d(a, dec)
        out.append((h, v, d))
    return [a] + out


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------

def _wavelets_phase(sm, name, img, wname, levels, oracle, reps, **kw):
    """Forward vs oracle, then threshold(0) -> inverse round trip, then
    the median of forward -> soft_threshold(0) -> inverse."""
    from pypwt_jax import Wavelets, get_filter_bank
    fb = get_filter_bank(wname)
    W = Wavelets(img, wname, levels, **kw)
    W.forward()
    want = oracle(img, fb, W.levels)
    err, tol = pyr_err(W.coeffs, want)
    W.soft_threshold(0.0)
    W.inverse()
    rt = float(np.abs(W.image.reshape(img.shape) - img).max())

    def step():
        W.forward()
        W.soft_threshold(0.0)
        W.inverse()
        return W.image_device_array()

    t = median_time(step, reps)
    sm.check(f"{name}_forward", err, tol, levels=W.levels)
    sm.check(f"{name}_roundtrip", rt, RT_TOL, t)
    return W


def phase_headline(sm, cfg, rng):
    import fft_oracle as fo
    n = cfg["n2d"]
    img = uniform(rng, (n, n))
    _wavelets_phase(sm, f"headline_db2_L3_{n}", img, "db2", 3,
                    fo.fft_wavedec2, cfg["reps"])


def phase_families(sm, cfg, rng):
    import jax
    import jax.numpy as jnp
    import fft_oracle as fo
    from pypwt_jax import haar
    n = cfg["n2d"]
    img = uniform(rng, (n, n))
    for wname in FAMILIES:
        _wavelets_phase(sm, f"family_{wname}_L3_{n}", img, wname, 3,
                        fo.fft_wavedec2, cfg["reps"])
    # the haar butterfly's strided slices: does XLA make gathers of them?
    hlo = jax.jit(lambda v: haar.haar_wavedec2(v, 3)).lower(
        jnp.asarray(img)).compile().as_text()
    sm.line(f"phase=family_haar_hlo gathers={hlo.count(' gather(')}")


def phase_swt(sm, cfg, rng):
    import fft_oracle as fo
    n = cfg["n_swt"]
    img = uniform(rng, (n, n))
    for wname, lv in (("db2", 4), ("sym8", 3)):
        _wavelets_phase(sm, f"swt_{wname}_L{lv}_{n}", img, wname, lv,
                        fo.fft_swt2d, cfg["reps"], do_swt=1)


def phase_1d(sm, cfg, rng):
    import fft_oracle as fo
    r, c = cfg["batched"]
    img = uniform(rng, (r, c))
    _wavelets_phase(sm, f"batched1d_db2_L3_{r}x{c}", img, "db2", 3,
                    fo.fft_wavedec1, cfg["reps"], ndim=1)
    for n, wname in ((cfg["long_pow2"], "sym8"), (cfg["long_big"], "db2")):
        x = uniform(rng, (n,))
        _wavelets_phase(sm, f"long1d_{wname}_L5_{n}", x, wname, 5,
                        fo.fft_wavedec1, cfg["reps"])


def _nonsep_banks(rng):
    from pypwt_jax import get_filter_bank
    from pypwt_jax import nonsep as ns
    fr, fc = get_filter_bank("db3"), get_filter_bank("coif1")
    dec = [np.outer(fr.dec_lo, fc.dec_lo), np.outer(fr.dec_hi, fc.dec_lo),
           np.outer(fr.dec_lo, fc.dec_hi), np.outer(fr.dec_hi, fc.dec_hi)]
    rec = [np.outer(fr.rec_lo, fc.rec_lo), np.outer(fr.rec_hi, fc.rec_lo),
           np.outer(fr.rec_lo, fc.rec_hi), np.outer(fr.rec_hi, fc.rec_hi)]
    aniso = ns.Filters2D(dec, rec, name="db3xcoif1")
    k = 14
    dense = [F / np.linalg.norm(F)
             for F in (rng.standard_normal((k, k)) for _ in range(4))]
    true2d = ns.Filters2D(dense, dense, name="dense14")
    assert aniso.separable_bank() is None
    assert true2d.separable_bank() is None
    assert true2d.hlen > ns._SLICE_TAP_LIMIT
    return aniso, true2d


def phase_nonsep(sm, cfg, rng):
    import jax
    import jax.numpy as jnp
    from pypwt_jax import nonsep as ns
    n = cfg["n_ns"]
    img = uniform(rng, (n, n))
    x = jnp.asarray(img)
    aniso, true2d = _nonsep_banks(rng)

    fwd = jax.jit(lambda v: ns.ns_wavedec2(v, aniso, 2))
    inv = jax.jit(lambda c: ns.ns_waverec2(c, aniso, (n, n)))
    pyr = fwd(x)
    err, tol = pyr_err(pyr, np_nswavedec2(img, aniso.dec, 2))
    rt = float(jnp.abs(inv(pyr) - x).max())
    t = median_time(lambda: inv(fwd(x)), cfg["reps"])
    sm.check(f"nonsep_slices_db3xcoif1_L2_{n}_forward", err, tol)
    sm.check(f"nonsep_slices_db3xcoif1_L2_{n}_roundtrip", rt, RT_TOL, t)

    fwd14 = jax.jit(lambda v: ns.ns_wavedec2(v, true2d, 1))
    pyr = fwd14(x)
    err, tol = pyr_err(pyr, np_nswavedec2(img, true2d.dec, 1))
    t = median_time(lambda: fwd14(x), cfg["reps"])
    sm.check(f"nonsep_conv_dense14_L1_{n}_forward", err, min(tol, CONV_TOL),
             t)


def _spin_shifts(key, n_spins, nr, nc):
    """The shifts ``denoise2d_cycle_spinning`` draws from ``key``."""
    import jax
    out = []
    for k in jax.random.split(key, n_spins):
        sr = int(jax.random.randint(k, (), 0, nr))
        sc = int(jax.random.randint(jax.random.fold_in(k, 1), (), 0, nc))
        out.append((sr, sc))
    return out


def oracle_cycle_spin(img, fb, levels, beta, shifts):
    acc = np.zeros(img.shape)
    for sr, sc in shifts:
        rec = oracle_denoise(np.roll(img, (sr, sc), (0, 1)), fb, levels,
                             beta)
        acc += np.roll(rec, (-sr, -sc), (0, 1))
    return acc / len(shifts)


def phase_pipelines(sm, cfg, rng):
    import jax
    import jax.numpy as jnp
    from pypwt_jax import get_filter_bank, pipeline
    n = cfg["n2d"]
    img = uniform(rng, (n, n))
    x = jnp.asarray(img)
    fb = get_filter_bank("db2")

    out = pipeline.denoise2d(x, "db2", 3, BETA)
    err = np.abs(np.asarray(out, np.float64)
                 - oracle_denoise(img, fb, 3, BETA)).max()
    t = median_time(lambda: pipeline.denoise2d(x, "db2", 3, BETA),
                    cfg["reps"])
    sm.check(f"denoise2d_soft_db2_L3_{n}", err, RT_TOL, t)

    key = jax.random.key(1234)
    out = pipeline.denoise2d_cycle_spinning(x, "db2", 3, BETA, key=key,
                                            n_spins=4)
    shifts = _spin_shifts(key, 4, n, n)
    err = np.abs(np.asarray(out, np.float64)
                 - oracle_cycle_spin(img, fb, 3, BETA, shifts)).max()
    t = median_time(lambda: pipeline.denoise2d_cycle_spinning(
        x, "db2", 3, BETA, key=key, n_spins=4), cfg["reps"])
    sm.check(f"cycle_spin_random4_db2_L3_{n}", err, RT_TOL, t)

    static = ((0, 0), (1, 1), (2, 3), (5, 7))
    out = pipeline.denoise2d_cycle_spinning(x, "db2", 3, BETA,
                                            shifts=static)
    err = np.abs(np.asarray(out, np.float64)
                 - oracle_cycle_spin(img, fb, 3, BETA, static)).max()
    t = median_time(lambda: pipeline.denoise2d_cycle_spinning(
        x, "db2", 3, BETA, shifts=static), cfg["reps"])
    sm.check(f"cycle_spin_static4_db2_L3_{n}", err, RT_TOL, t)


def phase_stack(sm, cfg, rng, dev):
    from pypwt_jax import get_filter_bank
    from pypwt_jax.parallel import mesh as pmesh
    from pypwt_jax.parallel.api import BatchedWavelets
    b, n = cfg["stack"]
    stack = uniform(rng, (b, n, n))
    B = BatchedWavelets(stack, "db2", 3,
                        mesh=pmesh.make_mesh(n_data=1, devices=[dev]))
    B.denoise(BETA)
    out = B.stack_device_array()
    fb = get_filter_bank("db2")
    err = 0.0
    for i in (0, b - 1):
        want = oracle_denoise(stack[i], fb, B.levels, BETA)
        err = max(err, float(np.abs(np.asarray(out[i], np.float64)
                                    - want).max()))

    def step():
        B.denoise(BETA)
        return B.stack_device_array()

    t = median_time(step, cfg["reps"])
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    sm.check(f"stack_denoise_db2_L3_{b}x{n}", err, RT_TOL, t,
             frames_per_s=f"{b / t:.1f}", peak_bytes=peak)


def _bank_program(fb, lv, flv, n_rt, n_long):
    """All eight checks of one bank as one jitted program: four round
    trips and four forward differentials against uploaded oracles."""
    import jax
    import jax.numpy as jnp
    from pypwt_jax.core import dwt, swt

    def tree_diff(a, b):
        return jnp.asarray([jnp.abs(p - q).max() for p, q in
                            zip(jax.tree.leaves(a), jax.tree.leaves(b))]
                           ).max()

    def prog(x2, xf, xl, w_2d, w_swt, w_b, w_l):
        rt2 = dwt.waverec2(dwt.wavedec2(x2, fb, lv), fb, (n_rt, n_rt))
        rts = swt.iswt2d(swt.swt2d(x2, fb, min(2, lv)), fb)
        rtb = dwt.waverec1(dwt.wavedec1(x2, fb, lv), fb, n_rt)
        rtl = dwt.waverec1(dwt.wavedec1(xl, fb, 3), fb, n_long)
        return jnp.stack([
            jnp.abs(rt2 - x2).max(), jnp.abs(rts - x2).max(),
            jnp.abs(rtb - x2).max(), jnp.abs(rtl - xl).max(),
            tree_diff(dwt.wavedec2(xf, fb, flv), w_2d),
            tree_diff(swt.swt2d(xf, fb, flv), w_swt),
            tree_diff(dwt.wavedec1(xf, fb, flv), w_b),
            tree_diff(dwt.wavedec1(xl, fb, flv), w_l)])

    return jax.jit(prog)


def phase_banks(sm, cfg, rng):
    """Every bank x {dwt2d, swt2d, batched-1D, long-1D}: round trips and
    forward differentials against the FFT oracle, errors computed inside
    one jit per bank; the programs compile on a thread pool."""
    import jax
    import jax.numpy as jnp
    import fft_oracle as fo
    from pypwt_jax import get_filter_bank, wavelist
    from pypwt_jax.core.shapes import clamp_levels
    names = cfg["banks"] or wavelist()
    n, nf, nl = cfg["n_bank"], cfg["n_bank_fwd"], cfg["long_bank"]
    x2_h, xf_h, xl_h = (uniform(rng, (n, n)), uniform(rng, (nf, nf)),
                        uniform(rng, (nl,)))
    x2, xf, xl = jnp.asarray(x2_h), jnp.asarray(xf_h), jnp.asarray(xl_h)

    def f32(tree):
        return jax.tree.map(lambda w: jnp.asarray(w, jnp.float32), tree)

    t0 = time.perf_counter()
    jobs = []
    for wname in names:
        fb = get_filter_bank(wname)
        lv = clamp_levels(3, (n, n), fb.hlen, 2)
        flv = min(2, clamp_levels(2, (nf, nf), fb.hlen, 2))
        oracles = (f32(fo.fft_wavedec2(xf_h, fb, flv)),
                   f32(fo.fft_swt2d(xf_h, fb, flv)),
                   f32(fo.fft_wavedec1(xf_h, fb, flv)),
                   f32(fo.fft_wavedec1(xl_h, fb, flv)))
        args = (x2, xf, xl) + oracles
        lowered = _bank_program(fb, lv, flv, n, nl).lower(*args)
        jobs.append((wname, lv, flv, lowered, args))
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(cfg["compile_threads"]) as ex:
        compiled = list(ex.map(lambda j: j[3].compile(), jobs))
    t_compile = time.perf_counter() - t0
    sm.line(f"phase=banks_setup banks={len(names)} "
            f"oracle_and_lower_s={t_lower:.1f} compile_s={t_compile:.1f}")

    run_ts = []
    for (wname, lv, flv, _, args), exe in zip(jobs, compiled):
        t0 = time.perf_counter()
        errs = np.asarray(jax.block_until_ready(exe(*args)))
        run_ts.append(time.perf_counter() - t0)
        gates = [(f"dwt2d_L{lv}_rt", RT_TOL), ("swt2d_L2_rt", RT_TOL),
                 (f"batched1d_L{lv}_rt", RT_TOL), ("long1d_L3_rt", RT_TOL),
                 (f"dwt2d_L{flv}_fwd", fwd_tol(flv)),
                 (f"swt2d_L{flv}_fwd", fwd_tol(flv)),
                 (f"batched1d_L{flv}_fwd", fwd_tol(flv)),
                 (f"long1d_L{flv}_fwd", fwd_tol(flv))]
        worst = max(range(len(gates)), key=lambda i: errs[i] / gates[i][1])
        for (what, tol), e in zip(gates, errs):
            if not e <= tol:
                sm.check(f"bank_{wname}_{what}", e, tol)
        sm.check(f"bank_{wname}_worst_{gates[worst][0]}", errs[worst],
                 gates[worst][1])
    sm.line(f"phase=banks_run median_s={np.median(run_ts):.6f} "
            f"total_s={sum(run_ts):.3f}")


def phase_copy(sm, cfg):
    """A large device copy's rate: the yardstick for the times above."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones((cfg["copy_elems"],), jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    jax.block_until_ready(f(x))
    t = median_time(lambda: f(x), cfg["reps"])
    gbs = 2 * x.size * 4 / t / 1e9
    sm.line(f"phase=copy_yardstick bytes={2 * x.size * 4} "
            f"median_s={t:.6f} GB_per_s={gbs:.1f}")


def phase_float64(sm, cfg, rng):
    import jax
    import fft_oracle as fo
    from pypwt_jax import Wavelets, get_filter_bank
    jax.config.update("jax_enable_x64", True)
    n = cfg["n_f64"]
    img = uniform(rng, (n, n), np.float64)
    W = Wavelets(img, "db4", 3, dtype=np.float64)
    W.forward()
    want = fo.fft_wavedec2(img, get_filter_bank("db4"), W.levels)
    err = max(float(np.abs(np.asarray(g) - w).max())
              for g, w in zip(jax.tree.leaves(W.coeffs),
                              jax.tree.leaves(want)))
    W.inverse()
    rt = float(np.abs(W.image - img).max())

    def step():
        W.forward()
        W.inverse()
        return W.image_device_array()

    t = median_time(step, cfg["reps"])
    sm.check(f"float64_db4_L3_{n}_forward", err, F64_TOL)
    sm.check(f"float64_db4_L3_{n}_roundtrip", rt, F64_TOL, t)


def run_one_card(sm, cfg, dev, seed=0):
    rng = np.random.default_rng(seed)
    phase_copy(sm, cfg)
    phase_headline(sm, cfg, rng)
    phase_families(sm, cfg, rng)
    phase_swt(sm, cfg, rng)
    phase_1d(sm, cfg, rng)
    phase_nonsep(sm, cfg, rng)
    phase_pipelines(sm, cfg, rng)
    phase_stack(sm, cfg, rng, dev)
    phase_banks(sm, cfg, rng)
    phase_float64(sm, cfg, rng)


# ---------------------------------------------------------------------------
# Four-card phases: each multi-device path against the one-device result
# ---------------------------------------------------------------------------

def _on_devices(arrays, n):
    """Check that every array really spans ``n`` devices."""
    import jax
    for a in jax.tree.leaves(arrays):
        if len(a.sharding.device_set) != n:
            raise SmokeFailure(
                f"array {a.shape} on {len(a.sharding.device_set)} devices, "
                f"expected {n}")


def _tree_err(a, b):
    import jax
    return max(float(np.abs(np.asarray(p, np.float64)
                            - np.asarray(q, np.float64)).max())
               for p, q in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def four_batched(sm, cfg, rng, devs):
    from pypwt_jax.parallel import mesh as pmesh
    from pypwt_jax.parallel.api import BatchedWavelets
    b, n = cfg["stack"]
    stack = uniform(rng, (b, n, n))
    results, times = [], []
    for use in (devs, devs[:1]):
        B = BatchedWavelets(stack, "db2", 3,
                            mesh=pmesh.make_mesh(n_data=len(use),
                                                 devices=use))
        B.denoise(BETA)
        _on_devices(B.stack_device_array(), len(use))
        results.append(B.image)

        def step():
            B.denoise(BETA)
            return B.stack_device_array()

        times.append(median_time(step, cfg["reps"]))
        del B
    err = float(np.abs(results[0] - results[1]).max())
    sm.check(f"four_batched_dp_denoise_db2_L3_{b}x{n}", err, RT_TOL,
             times[0], one_device_median_s=f"{times[1]:.6f}")


def _sharded_vs_single(sm, name, data, mesh, n_dev, single_fwd, reps,
                       **kw):
    import jax
    import jax.numpy as jnp
    from pypwt_jax.parallel.sharded import ShardedWavelets
    S = ShardedWavelets(data, "db2", 3, mesh=mesh, **kw)
    S.forward()
    _on_devices(S.coeffs_device(), n_dev)
    want = single_fwd(jax.device_put(jnp.asarray(data), mesh.devices.flat[0]))
    err, tol = pyr_err(S.coeffs, [np.asarray(w, np.float64) if not
                                  isinstance(w, tuple) else
                                  tuple(np.asarray(s, np.float64) for s in w)
                                  for w in want])
    S.inverse()
    rt = float(np.abs(S.image - data).max())

    def step():
        S.forward()
        S.inverse()
        return S.image_device_array()

    t = median_time(step, reps)
    sm.check(f"{name}_forward_vs_one_device", err, tol)
    sm.check(f"{name}_roundtrip", rt, RT_TOL, t)


def four_sharded(sm, cfg, rng, devs):
    import jax
    from pypwt_jax import get_filter_bank
    from pypwt_jax.core import dwt
    from pypwt_jax.parallel import mesh as pmesh
    fb = get_filter_bank("db2")
    n = cfg["n_shard"]
    img = uniform(rng, (n, n))
    fwd2 = jax.jit(lambda v: dwt.wavedec2(v, fb, 3))
    _sharded_vs_single(sm, f"four_row_db2_L3_{n}", img,
                       pmesh.make_mesh(n_data=1, n_rows=4, devices=devs), 4,
                       fwd2, cfg["reps"])
    _sharded_vs_single(sm, f"four_grid2x2_db2_L3_{n}", img,
                       pmesh.make_mesh2d(2, 2, devices=devs), 4, fwd2,
                       cfg["reps"])
    sig = uniform(rng, (cfg["seq"],))
    fwd1 = jax.jit(lambda v: dwt.wavedec1(v, fb, 3))
    _sharded_vs_single(sm, f"four_seq_db2_L3_{cfg['seq']}", sig,
                       pmesh.make_mesh(n_data=1, n_rows=4, devices=devs), 4,
                       fwd1, cfg["reps"])


def four_swt_multihop(sm, cfg, rng, devs):
    """Row-sharded SWT whose deepest halos span more than one shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pypwt_jax import get_filter_bank
    from pypwt_jax.core import swt
    from pypwt_jax.parallel import mesh as pmesh, spatial
    fb = get_filter_bank("sym8")
    nr, nc = cfg["swt_shape"]
    lv = cfg["swt_levels"]
    halo = (fb.hlen - 1 - fb.hlen // 2) * (1 << (lv - 1))
    if halo <= nr // 4:
        raise SmokeFailure("SWT halo fits one shard: not a multi-hop case")
    img = uniform(rng, (nr, nc))
    m = pmesh.make_mesh(n_data=1, n_rows=4, devices=devs)
    x = jax.device_put(jnp.asarray(img),
                       NamedSharding(m, P(pmesh.ROW_AXIS, None)))
    pyr = spatial.swt2d_rowsharded(x, fb, lv, m)
    _on_devices(pyr, 4)
    want = jax.jit(lambda v: swt.swt2d(v, fb, lv))(
        jax.device_put(jnp.asarray(img), devs[0]))
    err, tol = pyr_err(jax.tree.map(np.asarray, pyr),
                       jax.tree.map(lambda w: np.asarray(w, np.float64),
                                    want))
    y = spatial.iswt2d_rowsharded(pyr, fb, m)
    rt = float(np.abs(np.asarray(y) - img).max())
    t = median_time(lambda: spatial.iswt2d_rowsharded(
        spatial.swt2d_rowsharded(x, fb, lv, m), fb, m), cfg["reps"])
    name = f"four_row_swt_sym8_L{lv}_{nr}x{nc}"
    sm.check(f"{name}_forward_vs_one_device", err, tol,
             halo_rows=halo, shard_rows=nr // 4)
    sm.check(f"{name}_roundtrip", rt, RT_TOL, t)


def run_four_cards(sm, cfg, devs, seed=0):
    rng = np.random.default_rng(seed)
    four_batched(sm, cfg, rng, devs)
    four_sharded(sm, cfg, rng, devs)
    four_swt_multihop(sm, cfg, rng, devs)


def result_line(devices):
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax
    from pypwt_jax.utils import profiling

    dev = profiling.require_gpu()
    n_cards = 4 if args.four_cards else 1
    devs = jax.devices()[:n_cards]
    if len(devs) < n_cards or any(d.platform != "gpu" for d in devs):
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {jax.devices()}")
    cache = profiling.enable_compile_cache()
    sm = Smoke()
    sm.line(f"card: {profiling.card_info()}")
    sm.line(f"jax {jax.__version__}; devices used: {n_cards} x "
            f"{dev.device_kind}; compile cache: {cache}")
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            run_four_cards(sm, FULL_4, devs)
        else:
            run_one_card(sm, FULL, dev)
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        raise SystemExit(1)
    sm.line(f"checks={sm.n_checks} wall_s={time.perf_counter() - t0:.1f}")
    print(result_line(devs), flush=True)


if __name__ == "__main__":
    main()

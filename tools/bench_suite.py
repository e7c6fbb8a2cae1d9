#!/usr/bin/env python
"""Benchmark suite — the reference's benchmark machinery, on one GPU.

The reference ships test/benchmark.py (shape sweep 128^2..2048^2, pywt vs
PDWT wall-clock) and benchmark_results_parser.py (speedup tables).  This
suite measures the same configurations with the hardened chained-timing
protocol (pypwt_jax.utils.profiling) and emits one JSON object per line
plus a markdown summary table, so rounds can be diffed.

Every entry carries a CORRECTNESS GATE: the measured transform's
round-trip (or differential) max error is computed on-device and recorded
as ``max_err``; a silently-wrong kernel can no longer post a good number.
The process exits non-zero if any gate fails, and with no result when
JAX finds no GPU.  The card's name and power limit go to stderr first.

Usage:  python tools/bench_suite.py [--quick] [--out results.jsonl]

Configs (BASELINE.md "benchmark configs"):
  * 2D DWT roundtrip, db2, 3 levels, 128^2 .. 2048^2
  * wavelet family sweep haar/db4/sym8/coif3/bior4.4 at 2048^2, 3 levels
  * SWT db2, 4 levels, 1024^2
  * denoise pipeline (forward -> soft threshold -> inverse) 2048^2
  * cycle-spinning denoise (4 spins) 2048^2
  * batched-1D: 2048 rows x 4096 samples, db2
  * batched frame stack 8 x 1024^2 (per-frame throughput)
  * long single 1D signal, 4Mi samples, 5 levels
  * non-separable custom 2D bank roundtrip 2048^2
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

SCALE = 255.0  # match the reference's 0..255 test regime
GATE = 7e-4 * SCALE  # reference roundtrip tolerance (test_wavelets.py:538)

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fewer shapes, fewer iterations")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from pypwt_jax.utils import profiling
    from pypwt_jax.utils.profiling import timeit_chained, make_inputs
    from pypwt_jax.filters import get_filter_bank
    from pypwt_jax.core import dwt, swt, thresh

    dev = profiling.require_gpu().device_kind
    profiling.enable_compile_cache()
    print(f"card: {profiling.card_info()}", file=sys.stderr, flush=True)
    iters = 64 if args.quick else 128
    results = []
    failed = []

    def record(name, time_thunk, err_thunk, gate=GATE, frames=1,
               min_bytes=None):
        """Correctness first, then timing."""
        max_err = err_thunk()
        ok = bool(max_err <= gate)
        row = {"bench": name, "max_err": max_err, "err_ok": ok,
               "device": dev}
        seconds = time_thunk()
        row["time_us"] = seconds * 1e6
        row["throughput_fps"] = frames / seconds
        if min_bytes is not None:
            row["bytes_moved"] = int(min_bytes)
            row["effective_gbps"] = min_bytes / seconds / 1e9
        results.append(row)
        if not ok:
            failed.append(name)
        print(json.dumps(row), flush=True)

    def dwt2d_rt_bytes(n, m=None):
        """Minimal HBM traffic of a 2D DWT roundtrip: read+write per
        level per direction, per-level planes shrinking 4x."""
        return int(2 * 2 * (4 / 3) * n * (m or n) * 4)

    def swt2d_rt_bytes(n, L):
        """SWT keeps full-size planes: fwd reads 1 writes 4, inverse
        reads 4 writes 1 -> 10 planes per level."""
        return int(10 * L * n * n * 4)

    def rt_err(rt, x0):
        """On-device roundtrip max-err, computed inside one jit; only the
        scalar is read back."""
        return float(jax.jit(lambda v: jnp.abs(rt(v) - v).max())(x0))

    sizes = ([512, 2048] if args.quick
             else [128, 256, 512, 1024, 2048, 4096])
    fb = get_filter_bank("db2")
    for n in sizes:
        x0 = make_inputs((n, n))[0] * SCALE
        rt = lambda v: dwt.waverec2(dwt.wavedec2(v, fb, 3), fb, (n, n))
        record(f"dwt2d_roundtrip_db2_L3_{n}",
               lambda: timeit_chained(rt, x0, iters=iters),
               lambda: rt_err(rt, x0), min_bytes=dwt2d_rt_bytes(n))

    n = 2048
    x0 = make_inputs((n, n))[0] * SCALE
    for wname in (["db4"] if args.quick
                  else ["haar", "db4", "sym8", "coif3", "bior4.4"]):
        fbw = get_filter_bank(wname)
        rt = lambda v: dwt.waverec2(dwt.wavedec2(v, fbw, 3), fbw, (n, n))
        record(f"dwt2d_roundtrip_{wname}_L3_2048",
               lambda: timeit_chained(rt, x0, iters=iters),
               lambda: rt_err(rt, x0), min_bytes=dwt2d_rt_bytes(n))

    # SWT 1024^2, 4 levels
    m = 1024
    fb2 = get_filter_bank("db2")
    s0 = make_inputs((m, m))[0] * SCALE
    rt_swt = lambda v: swt.iswt2d(swt.swt2d(v, fb2, 4), fb2)
    record("swt2d_roundtrip_db2_L4_1024",
           lambda: timeit_chained(rt_swt, s0, iters=max(16, iters // 4)),
           lambda: rt_err(rt_swt, s0), min_bytes=swt2d_rt_bytes(m, 4))

    # wide-filter SWT
    if not args.quick:
        fbw8 = get_filter_bank("sym8")
        rt_swt8 = lambda v: swt.iswt2d(swt.swt2d(v, fbw8, 3), fbw8)
        record("swt2d_roundtrip_sym8_L3_1024",
               lambda: timeit_chained(rt_swt8, s0,
                                      iters=max(16, iters // 4)),
               lambda: rt_err(rt_swt8, s0),
               min_bytes=swt2d_rt_bytes(m, 3))

    # denoise pipeline 2048^2 (thresholding changes values by design:
    # gate on the underlying transform roundtrip instead)
    def denoise(v):
        c = dwt.wavedec2(v, fb, 3)
        c = thresh.soft_threshold(c, 1.0)
        return dwt.waverec2(c, fb, (n, n))
    rt_plain = lambda v: dwt.waverec2(dwt.wavedec2(v, fb, 3), fb, (n, n))
    record("denoise_soft_db2_L3_2048",
           lambda: timeit_chained(denoise, x0, iters=iters),
           lambda: rt_err(rt_plain, x0), min_bytes=dwt2d_rt_bytes(n))

    # cycle-spinning denoise (4 spins), jit-fused pipeline
    from pypwt_jax import pipeline as pl_
    key = jax.random.key(int.from_bytes(os.urandom(4), "little"))

    def cyc(v):
        return pl_.denoise2d_cycle_spinning(v, "db2", 3, 1.0, key,
                                            n_spins=4)
    record("denoise_cycle_spin4_db2_L3_2048",
           lambda: timeit_chained(cyc, x0, iters=max(16, iters // 4)),
           lambda: rt_err(rt_plain, x0),
           min_bytes=4 * dwt2d_rt_bytes(n))

    # static-shift mode: spins unroll at trace time; the schedule covers
    # 4 distinct cosets on each axis.
    def cyc_s(v):
        return pl_.denoise2d_cycle_spinning(
            v, "db2", 3, 1.0, shifts=((0, 0), (2, 1), (4, 2), (6, 3)))
    record("denoise_cycle_spin4static_db2_L3_2048",
           lambda: timeit_chained(cyc_s, x0, iters=max(16, iters // 4)),
           lambda: rt_err(rt_plain, x0),
           min_bytes=4 * dwt2d_rt_bytes(n))

    # batched 1D (roofline: per-level traffic halves, sum = 2x2x2xNx4 B)
    b0 = make_inputs((2048, 4096))[0] * SCALE
    rt1 = lambda v: dwt.waverec1(dwt.wavedec1(v, fb, 3), fb, 4096)
    record("dwt1d_batched2048_roundtrip_db2_L3_4096",
           lambda: timeit_chained(rt1, b0, iters=max(16, iters // 4)),
           lambda: rt_err(rt1, b0),
           min_bytes=int(2 * 2 * 2 * 2048 * 4096 * 4))

    # batched frame stack (per-frame throughput)
    if not args.quick:
        st0 = make_inputs((8, 1024, 1024))[0] * SCALE
        rts = lambda v: dwt.waverec2(dwt.wavedec2(v, fb, 3), fb,
                                     (8, 1024, 1024))
        record("dwt2d_stack8_roundtrip_db2_L3_1024",
               lambda: timeit_chained(rts, st0, iters=max(16, iters // 4)),
               lambda: rt_err(rts, st0), frames=8,
               min_bytes=8 * dwt2d_rt_bytes(1024))

    # long single 1D signal (reference sweeps 1D up to 1e7)
    if not args.quick:
        nl = 1 << 22
        l0 = make_inputs((nl,))[0] * SCALE
        rtl = lambda v: dwt.waverec1(dwt.wavedec1(v, fb, 5), fb, nl)
        record("dwt1d_long_roundtrip_db2_L5_4Mi",
               lambda: timeit_chained(rtl, l0, iters=16),
               lambda: rt_err(rtl, l0),
               min_bytes=int(2 * 2 * 2 * nl * 4))
        rtsl = lambda v: swt.iswt1d(swt.swt1d(v, fb, 4), fb)
        record("swt1d_long_roundtrip_db2_L4_4Mi",
               lambda: timeit_chained(rtsl, l0, iters=8),
               lambda: rt_err(rtsl, l0),
               min_bytes=int(6 * 4 * nl * 4))
        # middle band (hlen 8)
        fb4l = get_filter_bank("db4")
        rtl4 = lambda v: dwt.waverec1(dwt.wavedec1(v, fb4l, 5), fb4l, nl)
        record("dwt1d_long_roundtrip_db4_L5_4Mi",
               lambda: timeit_chained(rtl4, l0, iters=16),
               lambda: rt_err(rtl4, l0),
               min_bytes=int(2 * 2 * 2 * nl * 4))
        rtsl4 = lambda v: swt.iswt1d(swt.swt1d(v, fb4l, 3), fb4l)
        record("swt1d_long_roundtrip_db4_L3_4Mi",
               lambda: timeit_chained(rtsl4, l0, iters=8),
               lambda: rt_err(rtsl4, l0),
               min_bytes=int(6 * 3 * nl * 4))

        # wide filter
        fbw8l = get_filter_bank("sym8")
        rtlw = lambda v: dwt.waverec1(dwt.wavedec1(v, fbw8l, 5),
                                      fbw8l, nl)
        record("dwt1d_long_roundtrip_sym8_L5_4Mi",
               lambda: timeit_chained(rtlw, l0, iters=16),
               lambda: rt_err(rtlw, l0),
               min_bytes=int(2 * 2 * 2 * nl * 4))
        rtslw = lambda v: swt.iswt1d(swt.swt1d(v, fbw8l, 3), fbw8l)
        record("swt1d_long_roundtrip_sym8_L3_4Mi",
               lambda: timeit_chained(rtslw, l0, iters=8),
               lambda: rt_err(rtslw, l0),
               min_bytes=int(6 * 3 * nl * 4))

    # non-separable TRUE-2D path: anisotropic db3(rows) x coif1(cols) bank
    # is perfect-reconstruction but non-factorable into one isotropic 1D
    # bank, so it cannot be routed back to the separable path
    if not args.quick:
        from pypwt_jax.core import nonsep as ns
        fr = get_filter_bank("db3")
        fc = get_filter_bank("coif1")
        dec = [np.outer(fr.dec_lo, fc.dec_lo),
               np.outer(fr.dec_hi, fc.dec_lo),
               np.outer(fr.dec_lo, fc.dec_hi),
               np.outer(fr.dec_hi, fc.dec_hi)]
        rec = [np.outer(fr.rec_lo, fc.rec_lo),
               np.outer(fr.rec_hi, fc.rec_lo),
               np.outer(fr.rec_lo, fc.rec_hi),
               np.outer(fr.rec_hi, fc.rec_hi)]
        f2d = ns.Filters2D(dec, rec, name="db3xcoif1")
        assert f2d.separable_bank() is None, "bank unexpectedly factored"
        rtn = lambda v: ns.ns_waverec2(ns.ns_wavedec2(v, f2d, 3), f2d,
                                       (n, n))
        record("nonsep_true2d_db3xcoif1_roundtrip_L3_2048",
               lambda: timeit_chained(rtn, x0, iters=max(16, iters // 4)),
               lambda: rt_err(rtn, x0), min_bytes=dwt2d_rt_bytes(n))

        # rank-6 dense 2D bank: mixes six separable PR banks, so every
        # subband filter has 2D rank 6.  Perfect reconstruction does not
        # hold for an arbitrary mixture, so the gate is the linearity of
        # the forward transform: fwd(2x) == 2 fwd(x)
        rng6 = np.random.default_rng(6)
        banks = [get_filter_bank(w)
                 for w in ("db3", "sym4", "coif1", "db2", "sym5", "db4")]
        mix = rng6.dirichlet(np.ones(len(banks)))
        W6 = 10  # pad every 1D filter to the longest (sym5)
        dec6, rec6 = [], []
        for lo_r, hi_r in (("dec_lo", "dec_lo"), ("dec_hi", "dec_lo"),
                           ("dec_lo", "dec_hi"), ("dec_hi", "dec_hi")):
            F = sum(w * np.outer(
                        np.pad(getattr(b, lo_r),
                               (0, W6 - len(getattr(b, lo_r)))),
                        np.pad(getattr(b, hi_r),
                               (0, W6 - len(getattr(b, hi_r)))))
                    for w, b in zip(mix, banks))
            dec6.append(F)
            rec6.append(F[::-1, ::-1].copy())
        f2d6 = ns.Filters2D(dec6, rec6, name="rank6mix")
        fwd6 = lambda v: ns.ns_wavedec2(v, f2d6, 2)

        def diff6():
            return float(jax.jit(lambda v: jnp.asarray(
                [jnp.abs(2 * p - q).max() for p, q in
                 zip(jax.tree.leaves(fwd6(v)),
                     jax.tree.leaves(fwd6(2 * v)))]).max())(x0))

        # forward-only (no PR inverse exists for the mixture):
        # profiling.timeit's shape adapter folds a scalar of the output
        # back into an image-shaped carry; min_bytes counts the six
        # separable passes per subband the rank-6 bank amounts to
        record("nonsep_rank6_dense_fwd_L2_2048",
               lambda: profiling.timeit(fwd6, x0,
                                        iters=max(16, iters // 4)),
               diff6, gate=1e-3 * SCALE,
               min_bytes=int(6 * 2 * 1.25 * n * n * 4))

    if args.out:
        with open(args.out, "a") as f:
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            for row in results:
                row["when"] = stamp
                f.write(json.dumps(row) + "\n")

    print("\n| bench | us | frames/s | max_err |", file=sys.stderr)
    print("|---|---|---|---|", file=sys.stderr)
    for r in results:
        print(f"| {r['bench']} | {r['time_us']} "
              f"| {r.get('throughput_fps', '-')} | {r['max_err']} |",
              file=sys.stderr)

    rc = 0
    if failed:
        print(f"\nCORRECTNESS GATE FAILED: {failed}", file=sys.stderr)
        rc = 1
    if rc:
        sys.exit(rc)


if __name__ == "__main__":
    main()

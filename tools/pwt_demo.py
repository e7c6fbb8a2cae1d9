#!/usr/bin/env python
"""pypwt_jax demo CLI — the reference demo's workflows.

The reference ships an interactive C++ demo binary (pdwt/src/demo.cpp)
exercising forward / round-trip / threshold+inverse on a raw 512^2 .dat
image (io.cpp).  Here the engine is XLA, so the CLI is Python driving the
same flows; the raw IO, planner, and streaming loader underneath are the
native C++ runtime (native/pwt_runtime.cpp).

Subcommands:
  generate  out.dat [--size 512]          make a synthetic test image
  info      --wavelet db2 --levels 3 ...  print the plan (wt.cu:511-550)
  forward   img.dat [--save coeffs.pwtc]  forward transform + stats
  roundtrip img.dat                       forward+inverse, max error
  denoise   img.dat out.dat [--beta 10]   soft-threshold denoising
  stream    stack.dat out.dat --frames N  batch-denoise a frame stack
                                          through the prefetching loader
"""

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

from pypwt_jax import Wavelets, runtime  # noqa: E402


def _load_img(path, size=None):
    if size is None:
        n = runtime.read_dat(path).size
        size = int(math.isqrt(n))
    return runtime.read_dat(path, shape=(size, size))


def cmd_generate(args):
    n = args.size
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    img = (np.sin(7 * np.pi * xx) * np.cos(5 * np.pi * yy * xx)
           + 0.3 * np.sin(40 * np.pi * (xx + yy)))
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    runtime.write_dat(args.out, img.astype(np.float32))
    print(f"wrote {args.out}: {n}x{n} float32")


def cmd_info(args):
    img = np.zeros((args.size, args.size), np.float32)
    W = Wavelets(img, args.wavelet, args.levels, do_swt=args.swt)
    W.info()


def _plan(args, img):
    return Wavelets(img, args.wavelet, args.levels, do_swt=args.swt,
                    do_cycle_spinning=getattr(args, "cycle_spinning", 0))


def cmd_forward(args):
    img = _load_img(args.img)
    W = _plan(args, img)
    t0 = time.perf_counter()
    W.forward()
    n1 = W.norm1()
    print(f"forward done in {(time.perf_counter()-t0)*1e3:.2f} ms "
          f"(includes compile); norm1={n1:.4g} norm2sq={W.norm2sq():.4g}")
    if args.save:
        runtime.save_checkpoint(args.save, W)
        print(f"coefficients checkpointed to {args.save}")


def cmd_roundtrip(args):
    img = _load_img(args.img)
    W = _plan(args, img)
    W.forward()
    W.inverse()
    err = float(np.abs(W.image - img).max())
    print(f"roundtrip max abs error: {err:.3e} "
          f"({'OK' if err < 7e-4 else 'FAIL'})")


def cmd_denoise(args):
    img = _load_img(args.img)
    W = _plan(args, img)
    W.forward()
    W.soft_threshold(args.beta, do_threshold_appcoeffs=0)
    W.inverse()
    runtime.write_dat(args.out, W.image)
    print(f"denoised (soft, beta={args.beta}) -> {args.out}")


def cmd_stream(args):
    shape = (args.size, args.size)
    out_frames = []
    t0 = time.perf_counter()
    n_done = 0
    with runtime.FrameLoader(args.stack, shape,
                             frames_per_file=args.frames) as loader:
        W = None
        for frame in loader:
            if W is None:
                W = _plan(args, frame)
            W.forward(frame)
            W.soft_threshold(args.beta)
            W.inverse()
            out_frames.append(np.asarray(W.image))
            n_done += 1
    runtime.write_dat(args.out, np.stack(out_frames))
    dt = time.perf_counter() - t0
    print(f"streamed {n_done} frames in {dt:.2f}s "
          f"({n_done/dt:.1f} frames/s incl. IO+compile) -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--wavelet", default="db2")
        sp.add_argument("--levels", type=int, default=3)
        sp.add_argument("--swt", type=int, default=0)

    g = sub.add_parser("generate")
    g.add_argument("out")
    g.add_argument("--size", type=int, default=512)
    g.set_defaults(fn=cmd_generate)

    i = sub.add_parser("info")
    i.add_argument("--size", type=int, default=512)
    common(i)
    i.set_defaults(fn=cmd_info)

    f = sub.add_parser("forward")
    f.add_argument("img")
    f.add_argument("--save", default=None)
    common(f)
    f.set_defaults(fn=cmd_forward)

    r = sub.add_parser("roundtrip")
    r.add_argument("img")
    common(r)
    r.add_argument("--cycle-spinning", type=int, default=0)
    r.set_defaults(fn=cmd_roundtrip)

    d = sub.add_parser("denoise")
    d.add_argument("img")
    d.add_argument("out")
    d.add_argument("--beta", type=float, default=10.0)
    common(d)
    d.set_defaults(fn=cmd_denoise)

    s = sub.add_parser("stream")
    s.add_argument("stack")
    s.add_argument("out")
    s.add_argument("--frames", type=int, default=None)
    s.add_argument("--size", type=int, default=512)
    s.add_argument("--beta", type=float, default=10.0)
    common(s)
    s.set_defaults(fn=cmd_stream)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""SWT wavelet-shrinkage denoising, end to end (doc/denoising.md).

Creates a synthetic image, corrupts it with Gaussian noise, denoises it
three ways — the class API, the fused jitted pipeline, and cycle
spinning — and reports PSNRs.

Run:  python examples/denoise.py [--size 512] [--beta 20]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pypwt_jax import Wavelets, get_filter_bank  # noqa: E402
from pypwt_jax.core import swt, thresh  # noqa: E402


def psnr(ref, x):
    mse = float(np.mean((ref - x) ** 2))
    return 10.0 * np.log10(ref.max() ** 2 / mse)


def make_image(n):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    img = (np.sin(7 * np.pi * xx) * np.cos(5 * np.pi * yy * xx)
           + 0.3 * np.sin(40 * np.pi * (xx + yy)))
    return ((img - img.min()) / (img.max() - img.min()) * 255.0
            ).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--beta", type=float, default=20.0)
    ap.add_argument("--levels", type=int, default=3)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    img = make_image(args.size)
    noisy = img + rng.standard_normal(img.shape).astype(np.float32) \
        * img.max() * 0.05
    print(f"noisy PSNR: {psnr(img, noisy):.2f} dB")

    # 1. class API (the reference workflow)
    W = Wavelets(noisy, "db2", args.levels, do_swt=1)
    W.forward()
    W.soft_threshold(args.beta, do_threshold_appcoeffs=0)
    W.inverse()
    print(f"SWT soft-threshold (class API):   "
          f"{psnr(img, W.image):.2f} dB")

    # 2. fused jitted pipeline (one executable, no host round trips)
    fb = get_filter_bank("db2")

    @jax.jit
    def denoise(frame, beta):
        pyr = swt.swt2d(frame, fb, args.levels)
        pyr = thresh.soft_threshold(pyr, beta)
        return swt.iswt2d(pyr, fb)

    out = np.asarray(denoise(jnp.asarray(noisy), args.beta))
    print(f"SWT soft-threshold (fused jit):   {psnr(img, out):.2f} dB")

    # 3. decimated DWT with cycle spinning
    acc = np.zeros_like(noisy)
    Wc = Wavelets(noisy, "db2", args.levels, do_cycle_spinning=1, seed=7)
    n_spins = 8
    for _ in range(n_spins):
        Wc.forward(noisy)
        Wc.soft_threshold(args.beta)
        Wc.inverse()
        acc += Wc.image
    print(f"DWT + cycle spinning (x{n_spins}):     "
          f"{psnr(img, acc / n_spins):.2f} dB")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Distributed denoising on a device mesh, five ways:

* BatchedWavelets — a (B, Nr, Nc) frame stack data-parallel over devices
  (the tomography/video configuration);
* BatchedWavelets hybrid — frames over the data axis AND each frame's
  rows over the rows axis (stacks of large frames);
* ShardedWavelets — ONE large image with rows sharded across devices,
  halos exchanged between ring neighbours;
* ShardedWavelets grid — BOTH image axes sharded on a (rows, cols)
  mesh;
* ShardedWavelets sequence — ONE long 1D signal, the signal axis
  itself sharded.

Every layout accepts any input size (internal mesh-aligned padding,
cropped on readback).

Runs anywhere: on a CPU-only machine set

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

to simulate an 8-device mesh (what the test suite does); on a machine
with several GPUs it uses the real cards unchanged (one process drives
them all).

Run:  python examples/distributed_denoise.py [--size 512] [--beta 15]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

def psnr(ref, x):
    mse = float(np.mean((ref - x) ** 2))
    return 10.0 * np.log10(ref.max() ** 2 / mse)


def make_frames(b, n, rng):
    yy, xx = np.mgrid[0:n, 0:n] / n
    base = (np.sin(8 * np.pi * xx) * np.cos(6 * np.pi * yy) * 80
            + 120).astype(np.float32)
    stack = np.stack([base + 10 * k for k in range(b)])
    noisy = stack + rng.normal(0, 25, stack.shape).astype(np.float32)
    return stack, noisy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--beta", type=float, default=15.0)
    ap.add_argument("--cpu", action="store_true",
                    help="force an 8-device simulated CPU mesh (some "
                    "containers pre-register an accelerator plugin that "
                    "ignores JAX_PLATFORMS set in the environment)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    global BatchedWavelets, ShardedWavelets, pmesh
    from pypwt_jax.parallel import (BatchedWavelets, ShardedWavelets,
                                    mesh as pmesh)

    ndev = len(jax.devices())
    rng = np.random.default_rng(0)
    print(f"devices: {ndev} x {jax.devices()[0].device_kind}")

    # --- batch DP: one frame per chip ---
    clean, noisy = make_frames(ndev, args.size, rng)
    BW = BatchedWavelets(noisy, "db2", 3,
                         mesh=pmesh.make_mesh(n_data=ndev, n_rows=1))
    BW.denoise(args.beta)
    out = BW.image
    print(f"BatchedWavelets  ({ndev} frames DP): "
          f"noisy {psnr(clean, noisy):.1f} dB -> "
          f"denoised {psnr(clean, out):.1f} dB")

    # --- spatial sharding: one big image, rows across all chips ---
    big_clean, big_noisy = make_frames(1, args.size, rng)
    SW = ShardedWavelets(big_noisy[0], "db2", 3,
                         mesh=pmesh.make_mesh(n_data=1, n_rows=ndev),
                         seed=7)
    SW.denoise(args.beta, spins=4)  # translation-invariant averaging
    print(f"ShardedWavelets  ({ndev} row shards, 4 spins): "
          f"noisy {psnr(big_clean[0], big_noisy[0]):.1f} dB -> "
          f"denoised {psnr(big_clean[0], SW.image):.1f} dB")

    # --- hybrid: frames over data AND rows over rows ---
    if ndev % 2 == 0 and ndev >= 4:
        nd, nr = ndev // 2, 2
        hclean, hnoisy = make_frames(nd, args.size, rng)
        HB = BatchedWavelets(hnoisy, "db2", 3,
                             mesh=pmesh.make_mesh(n_data=nd, n_rows=nr))
        HB.denoise(args.beta)
        print(f"BatchedWavelets  hybrid ({nd} frames x {nr} row shards): "
              f"noisy {psnr(hclean, hnoisy):.1f} dB -> "
              f"denoised {psnr(hclean, HB.image):.1f} dB")

    # --- grid: both image axes sharded ---
    if ndev % 2 == 0 and ndev >= 4:
        GW = ShardedWavelets(big_noisy[0], "db2", 3,
                             mesh=pmesh.make_mesh2d(2, ndev // 2))
        GW.denoise(args.beta)
        print(f"ShardedWavelets  grid (2x{ndev // 2}): "
              f"noisy {psnr(big_clean[0], big_noisy[0]):.1f} dB -> "
              f"denoised {psnr(big_clean[0], GW.image):.1f} dB")

    # --- sequence: one long 1D signal, the signal axis sharded ---
    tt = np.linspace(0, 60, 100_003, dtype=np.float32)
    sig = (np.sin(2 * np.pi * tt) * 80 + 120).astype(np.float32)
    nsig = sig + rng.normal(0, 25, sig.shape).astype(np.float32)
    Q = ShardedWavelets(nsig, "db3", 4,
                        mesh=pmesh.make_mesh(n_data=1, n_rows=ndev))
    Q.denoise(args.beta)
    print(f"ShardedWavelets  sequence ({ndev} shards, 100003 samples): "
          f"noisy {psnr(sig, nsig):.1f} dB -> "
          f"denoised {psnr(sig, Q.image):.1f} dB")


if __name__ == "__main__":
    main()

"""Weak-scaling throughput harness: frames/s/device vs device count.

The scaling target is >= 0.9 linear scaling of the 2D db2 3-level
DWT+IDWT throughput from 1 device to all local devices.  This harness
measures it on whatever devices are visible: for each device count d in
{1, 2, 4, ..., N} it runs the fused denoise-roundtrip step on a stack of
``frames_per_chip * d`` frames sharded batch-DP over a d-device mesh, and
reports per-chip throughput plus efficiency vs the 1-chip number
(reference analog: the pywt-vs-PDWT wall-clock harness,
test/benchmark.py:112-165 — extended to multi-device, which the
reference never had).

PYPWT_SCALING_CPU=1 runs it on 8 virtual CPU devices to validate the
harness itself; those rows are not measurements.  The numbers that
matter come from running it unchanged on several GPUs.

Usage: python tools/scaling_bench.py [--size 2048] [--levels 3]
           [--frames-per-chip 4] [--out SCALING.jsonl]
"""

import argparse
import json
import os
import sys

if os.environ.get("PYPWT_SCALING_CPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--wavelet", default="db2")
    ap.add_argument("--frames-per-chip", type=int, default=4)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--mode", choices=("batch", "spatial"),
                    default="batch",
                    help="batch: DP over a frame stack; spatial: one "
                    "image with rows sharded (strong scaling, halo "
                    "exchange on the ring)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import jax
    if os.environ.get("PYPWT_SCALING_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pypwt_jax.utils import profiling
    from pypwt_jax.utils.profiling import timeit_chained
    from pypwt_jax.filters import get_filter_bank
    from pypwt_jax.core import dwt, thresh
    from pypwt_jax.parallel import mesh as pmesh

    if jax.default_backend() != "cpu":
        profiling.enable_compile_cache()
        print(profiling.card_info(), file=sys.stderr)

    n = args.size
    fb = get_filter_bank(args.wavelet)
    ndev = len(jax.devices())
    counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= ndev]
    rows = []
    base_fps_per_chip = None

    for d in counts:
        rng = np.random.default_rng(0)
        if args.mode == "batch":
            m = pmesh.make_mesh(n_data=d, n_rows=1,
                                devices=np.asarray(jax.devices()[:d]))
            frames = args.frames_per_chip * d
            shape = (frames, n, n)
            x = jnp.asarray(rng.random(shape, dtype=np.float32))
            x = jax.device_put(
                x, NamedSharding(m, P(pmesh.BATCH_AXIS, None, None)))

            def step(v):
                pyr = dwt.wavedec2(v, fb, args.levels)
                pyr = thresh.soft_threshold(pyr, 0.0)
                return dwt.waverec2(pyr, fb, shape)
        else:
            # strong scaling: ONE image, rows sharded over d devices;
            # the row-sharded transform + ppermute halos are the hot path
            from pypwt_jax.parallel.sharded import ShardedWavelets
            m = pmesh.make_mesh(n_data=1, n_rows=d,
                                devices=np.asarray(jax.devices()[:d]))
            frames = 1
            img = rng.random((n, n), dtype=np.float32)
            SW = ShardedWavelets(img, args.wavelet, args.levels, mesh=m)
            step = SW._denoise_step(False, False)
            x0 = SW._image
            beta0 = jnp.float32(0.0)

            def step(v, _s=step, _b=beta0):
                return _s(v, _b)

            x = x0

        # correctness gate (beta=0 keeps the step invertible); the error
        # reduction runs inside the jit, only the scalar is read back
        err = float(jax.jit(lambda v: jnp.abs(step(v) - v).max())(x))
        secs = timeit_chained(step, x, iters=args.iters)
        if args.mode == "batch":
            fps_chip = frames / secs / d
        else:
            # strong scaling: per-image rate; efficiency = speedup / d
            fps_chip = 1.0 / secs / d
        if base_fps_per_chip is None:
            base_fps_per_chip = fps_chip
        row = {"mode": args.mode, "chips": d, "frames": frames,
               "time_us": round(secs * 1e6, 1),
               "fps_per_chip": round(fps_chip, 1),
               "efficiency": round(fps_chip / base_fps_per_chip, 3),
               "max_err": float(f"{err:.3e}"),
               "backend": jax.default_backend(),
               "device": jax.devices()[0].device_kind}
        if jax.default_backend() == "cpu":
            # host-platform "devices" share one socket: these numbers say
            # nothing about scaling.  The falsifiable scaling evidence
            # is the compiled-HLO collective audit
            # (tools/audit_collectives.py).
            row["evidence"] = "cpu-sim, not a scaling measurement"
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")

    # virtual CPU devices share host cores, so efficiency necessarily
    # collapses there — only gate on real accelerator meshes
    if (len(rows) > 1 and rows[-1]["efficiency"] < 0.9
            and jax.default_backend() != "cpu"):
        print(f"weak-scaling efficiency {rows[-1]['efficiency']} < 0.9 "
              f"target at {rows[-1]['chips']} chips", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()

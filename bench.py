"""Headline benchmark: 2D DWT+IDWT frames/s (2048^2, db2, 3 levels) on
one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.  Exits
non-zero with no result when JAX finds no GPU.  The card's name and
power limit and other diagnostic lines go to stderr.

Measurement protocol (tools/ubench.py): the round trip runs as a long
lax.scan whose carry is the image itself, synchronized by a host readback
whose latency is calibrated out.  Chained timing serializes iterations,
so it is a conservative lower bound on pipelined throughput.
"""

import json
import os
import sys


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import jax
    import jax.numpy as jnp
    import ubench

    from pypwt_jax.filters import get_filter_bank
    from pypwt_jax.core import dwt
    from pypwt_jax.utils import profiling

    dev = profiling.require_gpu()
    profiling.enable_compile_cache()
    print(f"[bench] card: {profiling.card_info()}", file=sys.stderr)

    size = 2048
    levels = 3
    fb = get_filter_bank("db2")

    x0 = ubench.make_inputs((size, size))[0]

    def roundtrip(img):
        return dwt.waverec2(dwt.wavedec2(img, fb, levels), fb, (size, size))

    # correctness gate: lossless round trip within float32 envelope
    y = jax.jit(roundtrip)(x0)
    err = float(jnp.abs(y - x0).max())
    print(f"[bench] device={dev.device_kind} "
          f"roundtrip_err={err:.2e}", file=sys.stderr)
    assert err < 7e-4, "correctness gate failed"

    t = ubench.timeit_chained(roundtrip, x0, iters=256, reps=5)
    fps = 1.0 / t

    # pipelined bound: 4 independent chains interleaved in one scan.
    # The headline stays the chained (dependency-serialized) number for
    # round-over-round comparability; pipelined is what a streaming
    # (tomography) user gets if dispatch overlaps HBM with compute.
    tp = ubench.timeit_pipelined(roundtrip, x0, k=4, iters=64, reps=3)

    print(f"[bench] chained {t * 1e6:.1f} us/frame, "
          f"pipelined {tp * 1e6:.1f} us/frame "
          f"(x{t / tp:.2f} overlap)", file=sys.stderr)
    print(json.dumps({
        "metric": "2D DWT+IDWT frames/s (2048^2, db2, 3 levels)",
        "value": fps,
        "unit": "frames/s",
        "pipelined_fps": 1.0 / tp,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

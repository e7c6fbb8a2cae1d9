"""Tracing / timing utilities, device checks and the compile-cache rule.

The reference has no built-in profiling (SURVEY.md §5: an unused
CUDACHECK macro and external wall-clock scripts); the equivalents here
are jax.profiler device traces plus a chained timing harness.

``timeit_chained`` is the measurement primitive: a long lax.scan whose
carry is the data (so loop-invariant work cannot be hoisted out of the
scan), timed together with a one-element host readback, with the readback
latency calibrated and subtracted, and the scan length grown adaptively
until a region dwarfs the readback jitter.  Chained timing is a
conservative (dependency-serialized) lower bound on throughput.

``require_gpu`` and ``card_info`` are what every measurement script calls
first: a measurement never falls back to the CPU.

``tools/ubench.py`` and ``bench.py`` import from here — keep exactly one
copy of this protocol.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np

import jax
import jax.numpy as jnp

# Unique values per run, so no two timed regions see the same inputs.
_rng = np.random.default_rng()

_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         os.pardir, os.pardir))


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace around a block:

        with profiling.trace("/tmp/trace"):
            W.forward()

    View with TensorBoard / xprof.
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_sync(x):
    """Device synchronization by one-element host readback (a value
    read back cannot precede the computation that produces it)."""
    return float(jnp.ravel(jax.tree_util.tree_leaves(x)[0])[0])


def make_inputs(shape, n=1, dtype=np.float32):
    """Value-unique device inputs."""
    return [jnp.asarray(_rng.random(shape, dtype=dtype)) for _ in range(n)]


def readback_latency(x, reps=3):
    """Calibrate the D2H one-element readback cost."""
    device_sync(x)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        device_sync(x)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timeit_chained(step, x0, iters=128, reps=3, return_overhead=False):
    """Seconds per application of a shape-preserving ``step``.

    Runs dependent applications inside one jitted scan, syncs by host
    readback, subtracts the calibrated readback latency, and returns the
    median over ``reps`` regions (after one discarded drain region).  The
    scan length grows until the region dwarfs the readback jitter, so
    fast ops on small shapes are measured accurately too.
    """
    def make(n):
        def body(c, _):
            return step(c), None
        return jax.jit(
            lambda a: jax.lax.scan(body, a, None, length=n)[0])

    def fresh():
        bump = np.float32(_rng.uniform(0.5, 2.0))
        a = jax.tree_util.tree_map(lambda t: t * bump, x0)
        device_sync(jax.tree_util.tree_leaves(a)[0])
        return a

    g = make(iters)
    out = g(fresh())
    device_sync(jax.tree_util.tree_leaves(out)[0])   # compile + drain
    rb = readback_latency(jax.tree_util.tree_leaves(out)[0])

    # adapt: one region should take >= 20x the readback latency
    for _ in range(6):
        a = fresh()
        t0 = time.perf_counter()
        out = g(a)
        device_sync(jax.tree_util.tree_leaves(out)[0])
        region = time.perf_counter() - t0
        if region >= 20.0 * rb or iters >= 1 << 16:
            break
        scale = max(2, int(20.0 * rb / max(region - rb, rb / 4)))
        iters = min(iters * scale, 1 << 16)
        g = make(iters)
        out = g(fresh())
        device_sync(jax.tree_util.tree_leaves(out)[0])

    times = []
    for _ in range(reps):
        a = fresh()
        t0 = time.perf_counter()
        out = g(a)
        device_sync(jax.tree_util.tree_leaves(out)[0])
        times.append(time.perf_counter() - t0)
    t = (float(np.median(times)) - rb) / iters
    t = max(t, 1e-12)
    if return_overhead:
        return t, rb
    return t


# Alias kept for existing callers; same hardened implementation.
time_chained = timeit_chained


def timeit_pipelined(step, x0, k=4, iters=64, reps=3):
    """Amortized seconds per application of ``step`` when ``k``
    INDEPENDENT chains are interleaved in one scan.

    ``timeit_chained`` serializes iterations through a data dependency —
    a conservative lower bound on throughput.  Here the scan carry is a
    tuple of k value-unique trees and the body advances each one, so the
    scheduler may overlap chain i's HBM traffic with chain j's compute;
    the amortized time bounds the *pipelined* throughput a streaming user
    (e.g. tomography) gets.  pipelined ≈ chained means dispatch already
    saturates the device; pipelined ≪ chained means the chained headline
    undersells it.
    """
    xs = tuple(
        jax.tree_util.tree_map(
            lambda t: t * np.float32(_rng.uniform(0.5, 2.0)), x0)
        for _ in range(max(2, int(k))))

    def stepk(cs):
        return tuple(step(c) for c in cs)

    t = timeit_chained(stepk, xs, iters=iters, reps=reps)
    return t / len(xs)


def timeit(fn, x0, iters=128, reps=3, shape_adapter=None):
    """Time ``fn`` whose output shape differs from its input: chain through
    ``shape_adapter(out, x_prev) -> next input`` (default: broadcast-add of
    a scalar derived from the output, keeping the carry shape)."""
    if shape_adapter is None:
        def shape_adapter(out, x_prev):
            leaf = jax.tree_util.tree_leaves(out)[0]
            return x_prev + jnp.ravel(leaf)[0] * np.float32(1e-12)

    def step(c):
        return shape_adapter(fn(c), c)

    return timeit_chained(step, x0, iters=iters, reps=reps)


def compile_cache_dir() -> str:
    """The persistent compile-cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else ``.jax_cache/`` at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return env if env else os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache():
    """Enable JAX's persistent compilation cache in ``compile_cache_dir()``.
    Call once before any transform."""
    p = compile_cache_dir()
    os.makedirs(p, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", p)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return p


def require_gpu():
    """The first device, which must be a GPU; exits with status 1 (and
    no result) when JAX finds none.  There is no CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: jax.devices()[0] is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def card_info() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        txt = out.stdout.strip()
        return txt if out.returncode == 0 and txt else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"

"""Compiled denoising pipelines (pypwt_jax.pipeline)."""

import numpy as np

import jax
import jax.numpy as jnp

from pypwt_jax import Wavelets, pipeline


def _noisy(shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = (50 * np.sin(2 * np.pi * xx / shape[1] * 3)
           * np.cos(2 * np.pi * yy / shape[0] * 2) + 50).astype(np.float32)
    return img, (img + rng.standard_normal(shape).astype(np.float32) * 5)


def test_denoise2d_matches_class_api():
    img, noisy = _noisy()
    out = np.asarray(pipeline.denoise2d(jnp.asarray(noisy), "db2", 3,
                                        10.0))
    W = Wavelets(noisy, "db2", 3)
    W.forward()
    W.soft_threshold(10.0)
    W.inverse()
    np.testing.assert_allclose(out, W.image, atol=1e-4)


def test_denoise2d_swt_and_batched():
    img, noisy = _noisy()
    stack = jnp.stack([jnp.asarray(noisy)] * 3)
    out = pipeline.denoise2d(stack, "db3", 2, 5.0, do_swt=True)
    assert out.shape == stack.shape
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(out[2]),
                               atol=1e-6)
    # denoising reduces noise energy
    err_noisy = float(np.mean((noisy - img) ** 2))
    err_out = float(np.mean((np.asarray(out[0]) - img) ** 2))
    assert err_out < err_noisy


def test_cycle_spinning_reproducible_and_denoises():
    img, noisy = _noisy()
    key = jax.random.key(7)
    o1 = pipeline.denoise2d_cycle_spinning(jnp.asarray(noisy), "db2", 3,
                                           10.0, key, n_spins=4)
    o2 = pipeline.denoise2d_cycle_spinning(jnp.asarray(noisy), "db2", 3,
                                           10.0, key, n_spins=4)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2))
    err_noisy = float(np.mean((noisy - img) ** 2))
    err_out = float(np.mean((np.asarray(o1) - img) ** 2))
    assert err_out < err_noisy
    # different key -> different (but close) result
    o3 = pipeline.denoise2d_cycle_spinning(jnp.asarray(noisy), "db2", 3,
                                           10.0, jax.random.key(8),
                                           n_spins=4)
    assert float(np.abs(np.asarray(o1) - np.asarray(o3)).max()) > 0


def test_profiling_utils(tmp_path, monkeypatch):
    from pypwt_jax.utils import profiling
    x = jnp.asarray(np.ones((8, 128), np.float32))
    assert profiling.device_sync(x) == 1.0
    t = profiling.time_chained(lambda v: v * 1.0000001, x, iters=8,
                               reps=2)
    assert t > 0
    # the cache goes where JAX_COMPILATION_CACHE_DIR says, and only there
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    before = jax.config.jax_compilation_cache_dir
    try:
        p = profiling.enable_compile_cache()
        assert p == str(tmp_path / "xla")
        assert jax.config.jax_compilation_cache_dir == p
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    import os
    assert os.path.isdir(p)


def test_cycle_spinning_static_shifts():
    """Static-shift mode matches the per-shift math (beta=0 reduces to
    identity: every shift round-trips exactly), and distinct cosets give
    the same result as their mod-2^levels equivalents."""
    import numpy as np
    import jax.numpy as jnp
    from pypwt_jax import pipeline

    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.random((64, 64), dtype=np.float32) * 255)
    out = pipeline.denoise2d_cycle_spinning(
        img, "db2", 3, 0.0, shifts=((0, 0), (1, 1), (2, 3), (5, 7)))
    assert float(jnp.abs(out - img).max()) < 7e-4 * 255

    # shift-periodicity: shifting by 2^levels is the identity coset
    a = pipeline.denoise2d_cycle_spinning(img, "db2", 3, 4.0,
                                          shifts=((1, 2),))
    b = pipeline.denoise2d_cycle_spinning(img, "db2", 3, 4.0,
                                          shifts=((1 + 8, 2 + 8),))
    assert float(jnp.abs(a - b).max()) < 1e-3

    import pytest
    with pytest.raises(ValueError, match="random key or static"):
        pipeline.denoise2d_cycle_spinning(img, "db2", 3, 1.0)

"""Grid (rows x cols) sharding and long-signal 1D sharding on the
simulated 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax import get_filter_bank
from pypwt_jax.core import dwt
from pypwt_jax.parallel import mesh as pmesh, spatial


def test_gridsharded_matches_local():
    fb = get_filter_bank("db3")
    m = pmesh.make_mesh2d(2, 2, devices=jax.devices()[:4])
    nr, nc = 64, 128
    x = jnp.asarray(np.random.default_rng(0).random((nr, nc)).astype(
        np.float32))
    levels = 2

    got = spatial.wavedec2_gridsharded(x, fb, levels, m)
    want = jax.jit(lambda v: dwt.wavedec2(v, fb, levels))(x)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)

    y = spatial.waverec2_gridsharded(got, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def test_gridsharded_batched_leading_axis():
    fb = get_filter_bank("haar")
    m = pmesh.make_mesh2d(2, 4, devices=jax.devices()[:8])
    x = jnp.asarray(np.random.default_rng(1).random((32, 64)).astype(
        np.float32))
    c = spatial.wavedec2_gridsharded(x, fb, 2, m)
    y = spatial.waverec2_gridsharded(c, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def test_grid_divisibility_error():
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh2d(2, 2, devices=jax.devices()[:4])
    x = jnp.zeros((30, 64), jnp.float32)
    with pytest.raises(ValueError):
        spatial.wavedec2_gridsharded(x, fb, 2, m)


def test_seqsharded_1d_matches_local():
    fb = get_filter_bank("db4")
    m = pmesh.make_mesh(n_data=1, n_rows=8)
    n = 1024
    x = jnp.asarray(np.random.default_rng(2).random(n).astype(np.float32))
    levels = 3

    got = spatial.wavedec1_seqsharded(x, fb, levels, m)
    want = jax.jit(lambda v: dwt.wavedec1(v, fb, levels))(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5)

    y = spatial.waverec1_seqsharded(got, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def test_seqsharded_batched_rows():
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh(n_data=1, n_rows=4)
    x = jnp.asarray(np.random.default_rng(3).random((6, 256)).astype(
        np.float32))
    c = spatial.wavedec1_seqsharded(x, fb, 2, m)
    y = spatial.waverec1_seqsharded(c, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def test_gridsharded_wide_filter():
    """Wide filters on the grid path (multi-sample halos on both rings)
    match the single-device core."""
    fb = get_filter_bank("sym8")
    m = pmesh.make_mesh2d(2, 2, devices=jax.devices()[:4])
    nr, nc = 128, 256
    x = jnp.asarray(np.random.default_rng(3).random((nr, nc)).astype(
        np.float32))
    got = spatial.wavedec2_gridsharded(x, fb, 2, m)
    y = spatial.waverec2_gridsharded(got, fb, m)
    want = jax.jit(lambda v: dwt.wavedec2(v, fb, 2))(x)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=5e-5)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=5e-5)

"""BatchedWavelets (distributed plan) on the simulated 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from pypwt_jax import Wavelets
from pypwt_jax.parallel import BatchedWavelets, mesh as pmesh


def _stack(b=8, nr=32, nc=64, seed=0):
    return np.random.default_rng(seed).random((b, nr, nc)).astype(
        np.float32)


def test_matches_single_plan():
    stack = _stack()
    m = pmesh.make_mesh(n_data=4, n_rows=2)
    BW = BatchedWavelets(stack, "db2", 2, mesh=m)
    BW.forward()

    W = Wavelets(stack[3], "db2", 2)
    W.forward()
    for num in range(7):
        np.testing.assert_allclose(BW.coeff_only(num)[3],
                                   W.coeff_only(num), atol=1e-5)
    BW.inverse()
    np.testing.assert_allclose(BW.image, stack, atol=1e-5)


def test_sharding_is_applied():
    stack = _stack()
    m = pmesh.make_mesh(n_data=4, n_rows=2)
    BW = BatchedWavelets(stack, "db2", 2, mesh=m)
    shards = BW.stack_device_array().sharding
    assert shards.spec[0] == pmesh.BATCH_AXIS
    BW.forward()
    assert BW.coeffs_device()[0].sharding.spec[0] == pmesh.BATCH_AXIS


def test_denoise_fused_and_norms():
    stack = _stack()
    m = pmesh.make_mesh(n_data=2, n_rows=1,
                        devices=jax.devices()[:2])
    BW = BatchedWavelets(stack, "haar", 2, mesh=m)
    BW.forward()
    n1 = BW.norm1()
    assert n1 > 0
    BW.soft_threshold(0.05)
    assert BW.norm1() < n1
    BW.denoise(0.05)
    out = BW.image
    assert out.shape == stack.shape
    # denoising changed the data but stayed close
    assert 0 < np.abs(out - stack).max() < 1.0


def test_swt_batched_roundtrip():
    stack = _stack(b=4, nr=16, nc=16)
    m = pmesh.make_mesh(n_data=4, n_rows=1,
                        devices=jax.devices()[:4])
    BW = BatchedWavelets(stack, "db2", 2, do_swt=1, mesh=m)
    BW.forward()
    BW.inverse()
    np.testing.assert_allclose(BW.image, stack, atol=1e-5)


def test_bad_batch_divisibility():
    with pytest.raises(ValueError):
        BatchedWavelets(_stack(b=6), "db2", 1,
                        mesh=pmesh.make_mesh(n_data=4, n_rows=2))


# ---------------------------------------------------------------------------
# Hybrid DP x spatial: frames over data, rows over rows
# ---------------------------------------------------------------------------

def test_batched_hybrid_matches_single_plan():
    stack = np.random.default_rng(30).random((4, 128, 64)).astype(
        np.float32)
    m = pmesh.make_mesh(n_data=4, n_rows=2)
    BW = BatchedWavelets(stack, "db3", 2, mesh=m)
    assert BW.hybrid
    BW.forward()
    W = Wavelets(stack[2], "db3", 2)
    W.forward()
    for num in range(7):
        np.testing.assert_allclose(BW.coeff_only(num)[2],
                                   W.coeff_only(num), atol=1e-5)
    BW.soft_threshold(0.1)
    BW.inverse()
    assert BW.image.shape == stack.shape


def test_batched_hybrid_any_rows_and_swt():
    stack = np.random.default_rng(31).random((2, 100, 64)).astype(
        np.float32)
    m = pmesh.make_mesh(n_data=2, n_rows=4)
    BW = BatchedWavelets(stack, "db2", 2, mesh=m)
    assert BW.hybrid and BW._Nrp != 100
    BW.forward()
    BW.inverse()
    np.testing.assert_allclose(BW.image, stack, atol=1e-5)
    BS = BatchedWavelets(stack, "db2", 2, do_swt=1, mesh=m)
    BS.forward()
    BS.inverse()
    np.testing.assert_allclose(BS.image, stack, atol=1e-5)


def test_batched_hybrid_denoise_and_cycle_spin():
    stack = np.random.default_rng(32).random((4, 64, 64)).astype(
        np.float32)
    m = pmesh.make_mesh(n_data=4, n_rows=2)
    BW = BatchedWavelets(stack, "db2", 2, mesh=m, do_cycle_spinning=1,
                         seed=9)
    BW.forward()
    assert BW.current_shift != (0, 0)
    BW.inverse()
    np.testing.assert_allclose(BW.image, stack, atol=1e-5)
    BW2 = BatchedWavelets(stack, "db2", 2, mesh=m)
    BW2.denoise(0.0)
    np.testing.assert_allclose(BW2.image, stack, atol=1e-5)

"""Sharded-execution tests on the simulated 8-device CPU mesh.

The reference has no multi-device story (SURVEY.md §2.3); these tests cover
the new scaling layer: batch DP over frame stacks, spatial row sharding
with ppermute halo exchange (DWT + SWT), and agreement with the
single-device core.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax.filters import get_filter_bank
from pypwt_jax.core import dwt, swt
from pypwt_jax.parallel import batch, mesh as pmesh, spatial

RNG = np.random.default_rng(11)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices")


def test_mesh_construction():
    m = pmesh.make_mesh()
    assert m.shape[pmesh.BATCH_AXIS] == 8
    m2 = pmesh.make_mesh(n_data=4, n_rows=2)
    assert m2.shape == {"data": 4, "rows": 2}


def test_batched_dp_matches_single_device():
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh()
    stack = jnp.asarray(RNG.standard_normal((8, 32, 32)))
    pyr = batch.wavedec2_batched(stack, fb, 2, m)
    # compare against unsharded
    ref = jax.jit(lambda x: dwt.wavedec2(x, fb, 2))(stack)
    for a, b in zip(jax.tree.leaves(pyr), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    # shardings survived
    assert pyr[0].sharding.spec[0] == pmesh.BATCH_AXIS


def test_batched_denoise_and_norms():
    fb = get_filter_bank("db3")
    m = pmesh.make_mesh()
    stack = jnp.asarray(
        RNG.standard_normal((8, 32, 32)), dtype=jnp.float32)
    out = batch.denoise_batched(stack, fb, 2, 0.5, m)
    assert out.shape == stack.shape
    pyr = batch.wavedec2_batched(stack, fb, 2, m)
    n1, n2 = batch.norms_batched(pyr)
    ref = jax.jit(lambda x: dwt.wavedec2(x, fb, 2))(stack)
    n1r = sum(np.abs(np.asarray(c)).sum() for c in jax.tree.leaves(ref))
    assert abs(float(n1) - n1r) / n1r < 1e-5


def test_rowsharded_dwt_matches_single_device():
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh(n_data=1, n_rows=8)
    img = jnp.asarray(RNG.standard_normal((128, 64)))
    pyr = spatial.wavedec2_rowsharded(img, fb, 2, m)
    ref = jax.jit(lambda x: dwt.wavedec2(x, fb, 2))(img)
    for a, b in zip(jax.tree.leaves(pyr), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    y = spatial.waverec2_rowsharded(pyr, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(img), atol=1e-10)


def test_rowsharded_larger_filter():
    # sym4 (hlen=8): halo wider than 1, still within 16-row shards
    fb = get_filter_bank("sym4")
    m = pmesh.make_mesh(n_data=1, n_rows=8)
    img = jnp.asarray(RNG.standard_normal((128, 64)))
    pyr = spatial.wavedec2_rowsharded(img, fb, 2, m)
    ref = jax.jit(lambda x: dwt.wavedec2(x, fb, 2))(img)
    for a, b in zip(jax.tree.leaves(pyr), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    y = spatial.waverec2_rowsharded(pyr, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(img), atol=1e-10)


def test_rowsharded_swt_matches_single_device():
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh(n_data=1, n_rows=4)
    img = jnp.asarray(RNG.standard_normal((64, 32)))
    pyr = spatial.swt2d_rowsharded(img, fb, 2, m)
    ref = jax.jit(lambda x: swt.swt2d(x, fb, 2))(img)
    for a, b in zip(jax.tree.leaves(pyr), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-11)
    y = spatial.iswt2d_rowsharded(pyr, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(img), atol=1e-9)


def test_rowsharded_batched_combined():
    # data x rows combined mesh: (B, Nr, Nc) with B over data, rows over rows
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh(n_data=4, n_rows=2)
    x = jnp.asarray(RNG.standard_normal((4, 64, 32)))
    pyr = spatial.wavedec2_rowsharded(x, fb, 2, m)
    ref = jax.jit(lambda x: dwt.wavedec2(x, fb, 2))(x)
    np.testing.assert_allclose(np.asarray(pyr[0]), np.asarray(ref[0]),
                               atol=1e-12)
    y = spatial.waverec2_rowsharded(pyr, fb, m, batched=True)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-10)


def test_rowsharded_rejects_bad_divisibility():
    fb = get_filter_bank("db2")
    m = pmesh.make_mesh(n_data=1, n_rows=8)
    with pytest.raises(ValueError):
        spatial.wavedec2_rowsharded(
            jnp.zeros((100, 64)), fb, 2, m)


def test_halo_exceeding_shard_multihop():
    # db20 (hlen=40): halo 20+ rows on 16-row shards -> 2-hop exchange
    fb = get_filter_bank("db20")
    m = pmesh.make_mesh(n_data=1, n_rows=8)
    img = jnp.asarray(RNG.standard_normal((128, 64)))
    pyr = spatial.wavedec2_rowsharded(img, fb, 1, m)
    ref = jax.jit(lambda x: dwt.wavedec2(x, fb, 1))(img)
    for a, b in zip(jax.tree.leaves(pyr), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12)
    y = spatial.waverec2_rowsharded(pyr, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(img), atol=1e-10)


def test_rowsharded_deep_swt_multihop():
    # L4 SWT of a 128-row image on 8 row-shards (16 rows each): the db3
    # level-4 dilation needs halos of (16, 24) rows -> multi-hop ppermute
    # (the deep-level regime SURVEY.md §7 flags)
    fb = get_filter_bank("db3")
    m = pmesh.make_mesh(n_data=1, n_rows=8)
    img = jnp.asarray(RNG.standard_normal((128, 128)))
    pyr = spatial.swt2d_rowsharded(img, fb, 4, m)
    ref = jax.jit(lambda x: swt.swt2d(x, fb, 4))(img)
    for a, b in zip(jax.tree.leaves(pyr), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-11)
    y = spatial.iswt2d_rowsharded(pyr, fb, m)
    np.testing.assert_allclose(np.asarray(y), np.asarray(img), atol=1e-9)


def test_graft_entry_dryrun():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(__file__), os.pardir,
                                    "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == args[0].shape
    mod.dryrun_multichip(8)

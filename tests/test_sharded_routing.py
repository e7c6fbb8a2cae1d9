"""Row-, grid- and sequence-sharded transforms on the 8-device CPU mesh
against the local (one-device) transform and the FFT oracle, across
banks whose halos span one or several shards."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax import get_filter_bank
from pypwt_jax.core import dwt
from pypwt_jax.parallel import mesh as pmesh, spatial

import fft_oracle as fo

LEVELS = 2
MODES = ["row4", "row8", "grid2x2", "grid2x4", "seq4", "seq8"]
BANKS = ["db2", "sym8", "coif3", "bior3.5"]


def _sharded(mode, fb, x):
    devs = jax.devices()
    n = int(mode[-1])
    if mode.startswith("row"):
        m = pmesh.make_mesh(n_data=1, n_rows=n, devices=devs[:n])
        c = spatial.wavedec2_rowsharded(x, fb, LEVELS, m)
        return c, spatial.waverec2_rowsharded(c, fb, m)
    if mode.startswith("grid"):
        m = pmesh.make_mesh2d(2, n, devices=devs[:2 * n])
        c = spatial.wavedec2_gridsharded(x, fb, LEVELS, m)
        return c, spatial.waverec2_gridsharded(c, fb, m)
    m = pmesh.make_mesh(n_data=1, n_rows=n, devices=devs[:n])
    c = spatial.wavedec1_seqsharded(x, fb, LEVELS, m)
    return c, spatial.waverec1_seqsharded(c, fb, m)


@pytest.mark.parametrize("wname", BANKS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_local_and_oracle(mode, wname):
    fb = get_filter_bank(wname)
    rng = np.random.default_rng(len(mode) + len(wname))
    one_d = mode.startswith("seq")
    x = rng.standard_normal(4096 if one_d else (64, 48))
    got, y = _sharded(mode, fb, jnp.asarray(x))
    if one_d:
        local = jax.jit(lambda v: dwt.wavedec1(v, fb, LEVELS))(
            jnp.asarray(x))
        want = fo.fft_wavedec1(x, fb, LEVELS)
    else:
        local = jax.jit(lambda v: dwt.wavedec2(v, fb, LEVELS))(
            jnp.asarray(x))
        want = fo.fft_wavedec2(x, fb, LEVELS)
    for g, lo, w in zip(jax.tree.leaves(got), jax.tree.leaves(local),
                        jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(lo),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-10)
    np.testing.assert_allclose(np.asarray(y), x, atol=1e-10)

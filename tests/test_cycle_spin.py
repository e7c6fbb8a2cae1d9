"""Cycle-spinning denoise (pipeline.denoise2d_cycle_spinning) against a
host loop: np.roll -> FFT-oracle forward -> numpy threshold -> oracle
inverse -> un-roll -> mean over the spins.

Static shifts unroll at trace time; random mode draws its shifts from
the key on the device and runs the spins as a scan — the reference here
draws the same shifts from the same key.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pypwt_jax import get_filter_bank, pipeline

import fft_oracle as fo

SHAPE = (64, 96)
LEVELS = 3
BETA = 0.7


def _img(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE)


def _np_thresh(pyr, beta, hard, appcoeffs, normalize):
    def op(x, t):
        if hard:
            return np.where(np.abs(x) > t, x, 0.0)
        return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)

    levels = len(pyr) - 1
    a = pyr[0]
    if appcoeffs:
        # the reference's hard threshold of the approximation ignores
        # normalize (w_call_hard_thresh, common.cu:262-270)
        a = op(a, beta / math.sqrt(2) ** levels
               if normalize and not hard else beta)
    out = [a]
    for i, lev in enumerate(pyr[1:], start=1):
        t = beta / math.sqrt(2) ** i if normalize else beta
        out.append(tuple(op(s, t) for s in lev))
    return out


def _host_cycle_spin(img, wname, shifts, hard=False, appcoeffs=False,
                     normalize=False):
    fb = get_filter_bank(wname)
    acc = np.zeros(img.shape)
    for sr, sc in shifts:
        pyr = fo.fft_wavedec2(np.roll(img, (sr, sc), (0, 1)), fb, LEVELS)
        pyr = _np_thresh(pyr, BETA, hard, appcoeffs, normalize)
        rec = fo.fft_waverec2(pyr, fb, img.shape)
        acc += np.roll(rec, (-sr, -sc), (0, 1))
    return acc / len(shifts)


def _drawn_shifts(key, n_spins):
    out = []
    for k in jax.random.split(key, n_spins):
        sr = int(jax.random.randint(k, (), 0, SHAPE[0]))
        sc = int(jax.random.randint(jax.random.fold_in(k, 1), (), 0,
                                    SHAPE[1]))
        out.append((sr, sc))
    return out


STATIC = [((0, 0),), ((1, 1), (2, 3)), ((3, 5), (11, 13), (8, 16))]


@pytest.mark.parametrize("shifts", STATIC, ids=["one", "two", "three"])
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("wname", ["haar", "db2", "sym4", "bior2.2"])
def test_static_spins_vs_host_loop(wname, hard, shifts):
    img = _img(1)
    got = pipeline.denoise2d_cycle_spinning(
        jnp.asarray(img), wname, LEVELS, BETA, hard=hard, shifts=shifts)
    np.testing.assert_allclose(
        np.asarray(got), _host_cycle_spin(img, wname, shifts, hard=hard),
        atol=1e-10)


@pytest.mark.parametrize("normalize,appcoeffs",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_static_spins_threshold_options(hard, normalize, appcoeffs):
    img = _img(2)
    shifts = ((1, 2), (6, 5))
    got = pipeline.denoise2d_cycle_spinning(
        jnp.asarray(img), "db2", LEVELS, BETA, hard=hard,
        normalize=normalize, threshold_appcoeffs=appcoeffs, shifts=shifts)
    want = _host_cycle_spin(img, "db2", shifts, hard=hard,
                            appcoeffs=appcoeffs, normalize=normalize)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-10)


@pytest.mark.parametrize("wname", ["db2", "sym4"])
def test_shifts_act_mod_two_to_the_levels(wname):
    """An L-level periodized pyramid commutes with translations by
    multiples of 2^L, so shifts congruent mod 2^L denoise identically."""
    img = _img(3)
    a = pipeline.denoise2d_cycle_spinning(
        jnp.asarray(img), wname, LEVELS, BETA, shifts=((3, 5),))
    b = pipeline.denoise2d_cycle_spinning(
        jnp.asarray(img), wname, LEVELS, BETA, shifts=((3 + 8, 5 + 16),))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(a), _host_cycle_spin(img, wname, ((3, 5),)), atol=1e-10)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wname", ["haar", "db2", "sym4"])
def test_random_spins_vs_host_loop(wname, seed, hard):
    img = _img(4)
    key = jax.random.key(seed)
    got = pipeline.denoise2d_cycle_spinning(
        jnp.asarray(img), wname, LEVELS, BETA, key=key, n_spins=3,
        hard=hard)
    want = _host_cycle_spin(img, wname, _drawn_shifts(key, 3), hard=hard)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-10)


@pytest.mark.parametrize("normalize,appcoeffs", [(True, False),
                                                 (True, True)])
def test_random_spins_threshold_options(normalize, appcoeffs):
    img = _img(5)
    key = jax.random.key(7)
    got = pipeline.denoise2d_cycle_spinning(
        jnp.asarray(img), "db2", LEVELS, BETA, key=key, n_spins=2,
        normalize=normalize, threshold_appcoeffs=appcoeffs)
    want = _host_cycle_spin(img, "db2", _drawn_shifts(key, 2),
                            appcoeffs=appcoeffs, normalize=normalize)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-10)


def test_needs_a_key_or_shifts():
    with pytest.raises(ValueError):
        pipeline.denoise2d_cycle_spinning(jnp.asarray(_img()), "db2",
                                          LEVELS, BETA)

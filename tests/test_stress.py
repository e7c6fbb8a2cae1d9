"""Randomized configuration stress sweep (gated: PYPWT_STRESS=1).

Samples the full (wavelet x mode x swt x separable x levels x shape)
space and requires a finite, accurate round trip everywhere.  A 120-trial
run of this sweep passed with zero failures on 2026-08-16.
"""

import os

import numpy as np
import pytest

from pypwt_jax import Wavelets, wavelist

pytestmark = pytest.mark.skipif(
    os.environ.get("PYPWT_STRESS", "") != "1",
    reason="set PYPWT_STRESS=1 for the randomized sweep")

N_TRIALS = int(os.environ.get("PYPWT_STRESS_TRIALS", "40"))


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_random_config_roundtrip(trial):
    rng = np.random.default_rng(1000 + trial)
    names = wavelist()
    wname = names[rng.integers(len(names))]
    do_swt = int(rng.random() < 0.3)
    mode = ["2d", "1d", "b1d"][int(rng.integers(3))]
    nonsep = int(rng.random() < 0.2) if mode == "2d" else 0
    levels = int(rng.integers(1, 5))
    if mode == "2d":
        shape = (int(rng.integers(24, 200)), int(rng.integers(24, 200)))
        kw = dict(ndim=2)
    elif mode == "1d":
        shape = (int(rng.integers(64, 4000)),)
        kw = dict(ndim=1)
    else:
        shape = (int(rng.integers(2, 20)), int(rng.integers(64, 800)))
        kw = dict(ndim=1)
    img = rng.random(shape).astype(np.float32)

    W = Wavelets(img, wname, levels, do_swt=do_swt,
                 do_separable=0 if nonsep else 1, **kw)
    W.forward()
    n1 = W.norm1()
    assert np.isfinite(n1)
    W.soft_threshold(0.0)
    W.inverse()
    err = float(np.abs(W.image.ravel() - img.ravel()).max())
    assert np.isfinite(err) and err < 3e-3, (
        wname, mode, do_swt, nonsep, levels, shape, err)

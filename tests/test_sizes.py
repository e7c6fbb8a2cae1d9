"""Size sweep (the reference's test/test_sizes.py, SURVEY.md §4):
round-trip correctness across image geometries, including odd sizes,
and extreme aspect ratios.

Kept CPU-affordable by default; PYPWT_FULL_SWEEP=1 adds larger sizes.
"""

import os

import numpy as np
import pytest

from pypwt_jax import Wavelets

FULL = os.environ.get("PYPWT_FULL_SWEEP", "") == "1"

SIZES = [(128, 128), (129, 127), (64, 256), (256, 64), (96, 160),
         (33, 513)]
if FULL:
    SIZES += [(512, 512), (1024, 1024), (511, 1025), (2048, 2048)]


@pytest.mark.parametrize("shape", SIZES)
def test_roundtrip_sizes_dwt(shape):
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    W = Wavelets(img, "db3", 3)
    W.forward()
    W.inverse()
    err = float(np.abs(W.image - img).max())
    assert err < 7e-4, (shape, err)


@pytest.mark.parametrize("shape", [(128, 128), (96, 160)])
def test_roundtrip_sizes_swt(shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    W = Wavelets(img, "db2", 3, do_swt=1)
    W.forward()
    W.inverse()
    err = float(np.abs(W.image - img).max())
    assert err < 7e-4, (shape, err)


@pytest.mark.parametrize("n", [100, 1000, 10000] + ([100000] if FULL
                                                    else []))
def test_roundtrip_sizes_1d(n):
    sig = np.random.default_rng(2).random(n).astype(np.float32)
    W = Wavelets(sig, "sym4", 4)
    W.forward()
    W.inverse()
    err = float(np.abs(W.image.ravel() - sig).max())
    assert err < 7e-4, (n, err)

"""Native runtime (C++ planner / IO / loader / checkpoint) tests.

The native library and the Python fallbacks must agree exactly on the
planner calculus; IO and the loader are checked against numpy; checkpoints
round-trip through a live Wavelets plan.
"""

import os

import numpy as np
import pytest

from pypwt_jax import runtime
from pypwt_jax.core import shapes
from pypwt_jax import Wavelets


def test_native_available():
    # The build environment ships g++; the native path must actually load.
    assert runtime.available()


@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 255, 256, 2048])
def test_div2_parity(n):
    assert runtime.div2(n) == shapes.div2(n)


@pytest.mark.parametrize("nr,nc", [(512, 512), (512, 768), (37, 1024),
                                   (4096, 64)])
@pytest.mark.parametrize("hlen", [2, 4, 8, 12, 20, 40])
def test_level_clamp_parity(nr, nc, hlen):
    for ndim in (1, 2):
        assert (runtime.max_levels(nr, nc, hlen, ndim)
                == shapes.max_level((nr, nc), hlen, ndim))
        for lv in (1, 3, 99):
            assert (runtime.clamp_levels(lv, nr, nc, hlen, ndim)
                    == shapes.clamp_levels(lv, (nr, nc), hlen, ndim))


def test_level_shapes_and_offsets():
    got = runtime.level_shapes(511, 768, 4)
    assert got == shapes.level_shapes_2d(511, 768, 4, False)
    offs = runtime.pyramid_offsets(512, 512, 3)
    # A(64x64), then H1,V1,D1 (256^2), H2.. (128^2), H3.. (64^2)
    assert offs[0] == 0
    assert offs[1] == 64 * 64
    assert offs[2] == 64 * 64 + 256 * 256
    assert runtime.coeff_count(512, 512, 3) == offs[-1] + 64 * 64
    assert (runtime.memory_footprint(512, 512, 3)
            == 512 * 512 + runtime.coeff_count(512, 512, 3))


def test_dat_io_roundtrip(tmp_path):
    p = str(tmp_path / "x.dat")
    x = np.random.default_rng(0).random((37, 53)).astype(np.float32)
    runtime.write_dat(p, x)
    y = runtime.read_dat(p, shape=(37, 53))
    np.testing.assert_array_equal(x, y)
    # offset read
    z = runtime.read_dat(p, count=53, offset_elems=53)
    np.testing.assert_array_equal(x[1], z)
    with pytest.raises(Exception):
        runtime.read_dat(str(tmp_path / "missing.dat"), count=4)


def test_frame_loader_single_and_multi_file(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.random((7, 16, 24)).astype(np.float32)
    p1 = str(tmp_path / "a.dat")
    p2 = str(tmp_path / "b.dat")
    frames[:4].tofile(p1)
    frames[4:].tofile(p2)
    # frames_per_file inferred from the first file
    with runtime.FrameLoader(p1, (16, 24)) as ld:
        got = list(ld)
    assert len(got) == 4
    np.testing.assert_array_equal(np.stack(got), frames[:4])
    # short file: the loader must surface the read failure, not hang
    if runtime.available():
        ld = runtime.FrameLoader([p1, p2], (16, 24), frames_per_file=4,
                                 depth=3)
        with pytest.raises((IOError, StopIteration)):
            for _ in range(8):
                next(ld)
        ld.close()
    frames2 = rng.random((8, 16, 24)).astype(np.float32)
    frames2[:4].tofile(p1)
    frames2[4:].tofile(p2)
    with runtime.FrameLoader([p1, p2], (16, 24)) as ld:
        got = np.stack(list(ld))
    np.testing.assert_array_equal(got, frames2)


def test_checkpoint_roundtrip(tmp_path):
    img = np.random.default_rng(2).random((64, 96)).astype(np.float32)
    W = Wavelets(img, "db3", 3)
    W.forward()
    p = str(tmp_path / "ckpt.pwtc")
    runtime.save_checkpoint(p, W)

    W2 = runtime.load_checkpoint(p)
    assert (W2.wname, W2.levels, W2.Nr, W2.Nc) == ("db3", 3, 64, 96)
    for num in range(1 + 3 * W.levels):
        np.testing.assert_allclose(W.coeff_only(num), W2.coeff_only(num),
                                   rtol=0, atol=0)
    W.inverse()
    W2.inverse()
    np.testing.assert_allclose(W.image, W2.image, atol=1e-6)


def test_checkpoint_swt_and_1d(tmp_path):
    img = np.random.default_rng(3).random((32, 64)).astype(np.float32)
    W = Wavelets(img, "haar", 2, do_swt=1)
    W.forward()
    p = str(tmp_path / "ckpt_swt.pwtc")
    runtime.save_checkpoint(p, W)
    W2 = runtime.load_checkpoint(p)
    assert W2.do_swt == 1
    np.testing.assert_allclose(W.coeff_only(2), W2.coeff_only(2))

    sig = np.random.default_rng(4).random(128).astype(np.float32)
    W3 = Wavelets(sig, "db2", 3)
    W3.forward()
    p2 = str(tmp_path / "ckpt_1d.pwtc")
    runtime.save_checkpoint(p2, W3)
    W4 = runtime.load_checkpoint(p2)
    for num in range(4):
        np.testing.assert_allclose(W3.coeff_only(num), W4.coeff_only(num))


def test_checkpoint_cross_format(tmp_path, monkeypatch):
    """Python writer and native writer produce one on-disk PWTC format:
    a file written by either path loads through the other."""
    img = np.random.default_rng(5).random((32, 48)).astype(np.float32)
    W = Wavelets(img, "db2", 2)
    W.forward()

    p_native = str(tmp_path / "native.pwtc")
    runtime.save_checkpoint(p_native, W)  # native when g++ is present

    p_py = str(tmp_path / "python.pwtc")
    monkeypatch.setattr(runtime, "_load", lambda: None)
    runtime.save_checkpoint(p_py, W)  # forced pure-Python writer

    # pure-Python reader on the native-written file
    W2 = runtime.load_checkpoint(p_native)
    # restore native and read the Python-written file through it
    monkeypatch.undo()
    W3 = runtime.load_checkpoint(p_py)
    if runtime.available():
        with open(p_native, "rb") as f1, open(p_py, "rb") as f2:
            assert f1.read() == f2.read()
    for num in range(1 + 3 * W.levels):
        np.testing.assert_array_equal(W.coeff_only(num), W2.coeff_only(num))
        np.testing.assert_array_equal(W.coeff_only(num), W3.coeff_only(num))


def test_checkpoint_float64(tmp_path):
    """float64 plans checkpoint without precision loss and restore as
    float64 (dtype recorded in the header flags)."""
    img = np.random.default_rng(6).random((32, 32)).astype(np.float64)
    W = Wavelets(img, "db3", 2, dtype=np.float64)
    W.forward()
    p = str(tmp_path / "ckpt64.pwtc")
    runtime.save_checkpoint(p, W)
    W2 = runtime.load_checkpoint(p)
    assert W2.dtype == np.dtype(np.float64)
    for num in range(1 + 3 * W.levels):
        a, b = np.asarray(W.coeff_only(num)), np.asarray(W2.coeff_only(num))
        assert a.dtype == np.float64 and b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_checkpoint_custom_bank_refused():
    from pypwt_jax import get_filter_bank
    img = np.random.default_rng(9).random((32, 32)).astype(np.float32)
    W = Wavelets(img, "db2", 2)
    fb = get_filter_bank("db2")
    W.set_wavelets_filters("mybank", fb.dec_lo, fb.dec_hi, fb.rec_lo,
                           fb.rec_hi)
    W.forward()
    with pytest.raises(ValueError):
        runtime.save_checkpoint("/tmp/should_not_exist.pwtc", W)

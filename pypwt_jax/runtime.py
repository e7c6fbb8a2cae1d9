"""Native runtime bindings (ctypes over native/pwt_runtime.cpp).

The reference's host-side runtime is C++ (plan construction wt.cu:84-185,
raw IO io.cpp, buffer layout common.cu:400-445); here the same layer is a
small dependency-free C++ library compiled on first use and bound with
ctypes.  Everything has a pure-Python fallback so the package works
without a compiler; when the native library is present it is
authoritative for IO and the frame loader (background-thread prefetch).

Public surface:
  available()            -> bool
  div2 / max_levels / clamp_levels / level_shapes / coeff_count /
  pyramid_offsets / memory_footprint            (planner)
  read_dat / write_dat                          (raw float32 IO)
  FrameLoader                                   (prefetching stack reader)
  save_checkpoint / load_checkpoint             (pyramid snapshot)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "pwt_runtime.cpp")
_LIB_DIR = os.path.join(_HERE, "_native")
_LIB = os.path.join(_LIB_DIR, "libpwt_runtime.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    os.makedirs(_LIB_DIR, exist_ok=True)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", _LIB]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB)
        except Exception as e:  # no compiler / no source: fall back
            print(f"pypwt_jax: native runtime unavailable ({e}); "
                  "using Python fallbacks", file=sys.stderr)
            return None
        c = ctypes
        lib.pwt_div2.restype = c.c_int32
        lib.pwt_div2.argtypes = [c.c_int32]
        lib.pwt_max_levels.restype = c.c_int32
        lib.pwt_max_levels.argtypes = [c.c_int32] * 4
        lib.pwt_clamp_levels.restype = c.c_int32
        lib.pwt_clamp_levels.argtypes = [c.c_int32] * 5
        lib.pwt_level_shapes.argtypes = [
            c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
        lib.pwt_coeff_count.restype = c.c_int64
        lib.pwt_coeff_count.argtypes = [c.c_int32] * 5
        lib.pwt_pyramid_offsets.restype = c.c_int32
        lib.pwt_pyramid_offsets.argtypes = [
            c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_int64)]
        lib.pwt_memory_footprint.restype = c.c_int64
        lib.pwt_memory_footprint.argtypes = [c.c_int32] * 5
        lib.pwt_file_size.restype = c.c_int64
        lib.pwt_file_size.argtypes = [c.c_char_p]
        lib.pwt_read_f32.restype = c.c_int32
        lib.pwt_read_f32.argtypes = [c.c_char_p, c.POINTER(c.c_float),
                                     c.c_int64, c.c_int64]
        lib.pwt_write_f32.restype = c.c_int32
        lib.pwt_write_f32.argtypes = [c.c_char_p, c.POINTER(c.c_float),
                                      c.c_int64]
        lib.pwt_loader_open.restype = c.c_void_p
        lib.pwt_loader_open.argtypes = [c.POINTER(c.c_char_p), c.c_int32,
                                        c.c_int64, c.c_int64, c.c_int32]
        lib.pwt_loader_total_frames.restype = c.c_int64
        lib.pwt_loader_total_frames.argtypes = [c.c_void_p]
        lib.pwt_loader_next.restype = c.c_int64
        lib.pwt_loader_next.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
        lib.pwt_loader_close.argtypes = [c.c_void_p]
        lib.pwt_ckpt_save.restype = c.c_int32
        lib.pwt_ckpt_save.argtypes = [
            c.c_char_p, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.c_int32, c.c_char_p, c.c_int32, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.POINTER(c.c_float))]
        lib.pwt_ckpt_info.restype = c.c_int32
        lib.pwt_ckpt_info.argtypes = [
            c.c_char_p, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_char_p]
        lib.pwt_ckpt_load_plane.restype = c.c_int32
        lib.pwt_ckpt_load_plane.argtypes = [
            c.c_char_p, c.c_int32, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Planner (native when available, Python otherwise; both must agree —
# tests/test_runtime.py checks them against each other)
# ---------------------------------------------------------------------------

def div2(n: int) -> int:
    lib = _load()
    if lib:
        return int(lib.pwt_div2(n))
    from .core import shapes
    return shapes.div2(n)


def max_levels(nr: int, nc: int, hlen: int, ndim: int = 2) -> int:
    lib = _load()
    if lib:
        return int(lib.pwt_max_levels(nr, nc, hlen, ndim))
    from .core import shapes
    return shapes.max_level((nr, nc), hlen, ndim)


def clamp_levels(levels: int, nr: int, nc: int, hlen: int,
                 ndim: int = 2) -> int:
    lib = _load()
    if lib:
        return int(lib.pwt_clamp_levels(levels, nr, nc, hlen, ndim))
    from .core import shapes
    return shapes.clamp_levels(levels, (nr, nc), hlen, ndim)


def level_shapes(nr: int, nc: int, levels: int, do_swt: bool = False):
    lib = _load()
    if lib:
        rows = (ctypes.c_int32 * (levels + 1))()
        cols = (ctypes.c_int32 * (levels + 1))()
        lib.pwt_level_shapes(nr, nc, levels, int(do_swt), rows, cols)
        return [(int(rows[i]), int(cols[i])) for i in range(1, levels + 1)]
    from .core import shapes
    return shapes.level_shapes_2d(nr, nc, levels, do_swt)


def coeff_count(nr, nc, levels, do_swt=False, ndim=2) -> int:
    lib = _load()
    if lib:
        return int(lib.pwt_coeff_count(nr, nc, levels, int(do_swt), ndim))
    shp = level_shapes(nr, nc, levels, do_swt)
    nsub = 3 if ndim == 2 else 1
    return (shp[-1][0] * shp[-1][1]
            + sum(nsub * r * c for r, c in shp))


def pyramid_offsets(nr, nc, levels, do_swt=False, ndim=2):
    """Element offsets of [A, H1,V1,D1, ...] in a flat buffer."""
    lib = _load()
    nsub = 3 if ndim == 2 else 1
    nplanes = 1 + nsub * levels
    if lib:
        offs = (ctypes.c_int64 * nplanes)()
        lib.pwt_pyramid_offsets(nr, nc, levels, int(do_swt), ndim, offs)
        return [int(o) for o in offs]
    shp = level_shapes(nr, nc, levels, do_swt)
    offs = [0]
    off = shp[-1][0] * shp[-1][1]
    for i in range(levels):
        for _ in range(nsub):
            offs.append(off)
            off += shp[i][0] * shp[i][1]
    return offs


def memory_footprint(nr, nc, levels, do_swt=False, ndim=2) -> int:
    lib = _load()
    if lib:
        return int(lib.pwt_memory_footprint(nr, nc, levels, int(do_swt),
                                            ndim))
    return nr * nc + coeff_count(nr, nc, levels, do_swt, ndim)


# ---------------------------------------------------------------------------
# Raw float32 .dat IO (io.cpp equivalent)
# ---------------------------------------------------------------------------

def read_dat(fname, shape=None, count=None, offset_elems=0):
    """Read float32 raw data; returns a numpy array of ``shape`` (or flat
    of ``count``; or the whole file)."""
    if shape is not None:
        count = int(np.prod(shape))
    lib = _load()
    if lib:
        if count is None:
            n = lib.pwt_file_size(fname.encode())
            if n < 0:
                raise FileNotFoundError(fname)
            count = n // 4 - offset_elems
        out = np.empty(count, dtype=np.float32)
        rc = lib.pwt_read_f32(
            fname.encode(), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), count, offset_elems)
        if rc != 0:
            raise IOError(f"read_dat({fname}): error {rc}")
    else:
        out = np.fromfile(fname, dtype=np.float32,
                          count=-1 if count is None else count,
                          offset=offset_elems * 4)
        if count is not None and out.size != count:
            raise IOError(f"read_dat({fname}): short read")
    return out.reshape(shape) if shape is not None else out


def write_dat(fname, arr):
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    lib = _load()
    if lib:
        rc = lib.pwt_write_f32(
            fname.encode(),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size)
        if rc != 0:
            raise IOError(f"write_dat({fname}): error {rc}")
    else:
        arr.tofile(fname)


# ---------------------------------------------------------------------------
# Prefetching frame loader
# ---------------------------------------------------------------------------

class FrameLoader:
    """Iterate float32 frames of ``frame_shape`` from raw .dat files, read
    ahead on a native background thread (double-buffered by default).

    The reference processes one image at a time (wt.cu); production
    pipelines stream stacks — this overlaps disk IO with device compute.
    """

    def __init__(self, paths, frame_shape, frames_per_file=None, depth=2):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [os.fspath(p) for p in paths]
        self.frame_shape = tuple(frame_shape)
        self.frame_elems = int(np.prod(self.frame_shape))
        if frames_per_file is None:
            size = os.path.getsize(self.paths[0])
            frames_per_file = size // (4 * self.frame_elems)
        self.frames_per_file = int(frames_per_file)
        self.depth = int(depth)
        self._lib = _load()
        self._h = None
        self._py_state = None
        if self._lib:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = self._lib.pwt_loader_open(
                arr, len(self.paths), self.frame_elems,
                self.frames_per_file, self.depth)
            if not self._h:
                raise IOError("pwt_loader_open failed")
        else:
            self._py_state = [0, 0]  # (file idx, frame idx)
        self.total_frames = len(self.paths) * self.frames_per_file

    def __iter__(self):
        return self

    def __next__(self):
        buf = np.empty(self.frame_elems, dtype=np.float32)
        if self._h is not None:
            idx = self._lib.pwt_loader_next(
                self._h, buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)))
            if idx == -1:
                raise StopIteration
            if idx < 0:
                raise IOError("frame read failed")
        else:
            fi, fr = self._py_state
            if fi >= len(self.paths):
                raise StopIteration
            buf = np.fromfile(self.paths[fi], dtype=np.float32,
                              count=self.frame_elems,
                              offset=4 * self.frame_elems * fr)
            if buf.size != self.frame_elems:
                raise IOError("frame read failed")
            fr += 1
            if fr >= self.frames_per_file:
                fi, fr = fi + 1, 0
            self._py_state = [fi, fr]
        return buf.reshape(self.frame_shape)

    def close(self):
        if self._h is not None:
            self._lib.pwt_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Checkpoint / resume of a Wavelets plan's coefficients
# ---------------------------------------------------------------------------
#
# One on-disk format for all paths: the PWTC layout of pwt_runtime.cpp
# (header {magic 'PWTC', version, ndim, nr, nc, levels, flags, wname[32]}
# then nplanes x {rows i32, cols i32, plane data}).  The pure-Python
# writer/reader below produce/consume byte-identical files to the native
# ones, so a checkpoint written with g++ present loads without it and
# vice versa.  float64 plans set _F_F64 and store float64 planes (the
# Python codec handles those; the float32-only native fast path is
# skipped for them).

_F_SWT = 1
_F_BATCHED = 2
_F_F64 = 4

_CKPT_HDR = 60  # 4 magic + 6 * int32 + 32 wname


def _py_ckpt_write(fname, ndim, nr, nc, levels, flags, wname, planes2d):
    with open(fname, "wb") as f:
        f.write(b"PWTC")
        f.write(np.array([1, ndim, nr, nc, levels, flags],
                         np.int32).tobytes())
        f.write(wname.encode().ljust(32, b"\0")[:32])
        for p in planes2d:
            f.write(np.array(p.shape, np.int32).tobytes())
            f.write(np.ascontiguousarray(p).tobytes())


def _py_ckpt_read_header(fname):
    with open(fname, "rb") as f:
        hdr = f.read(_CKPT_HDR)
    if len(hdr) != _CKPT_HDR or hdr[:4] != b"PWTC":
        if hdr[:2] == b"PK":
            raise IOError(
                f"{fname}: legacy .npz checkpoint (pre-PWTC format); "
                "load it with numpy.load and re-save via save_checkpoint")
        raise IOError(f"{fname}: not a PWTC checkpoint")
    ver, ndim, nr, nc, levels, flags = np.frombuffer(
        hdr[4:28], np.int32)
    if ver != 1:
        raise IOError(f"{fname}: unsupported PWTC version {ver}")
    wname = hdr[28:60].split(b"\0", 1)[0].decode()
    return int(ndim), int(nr), int(nc), int(levels), int(flags), wname


def _py_ckpt_read_planes(fname, nplanes, dtype):
    planes = []
    with open(fname, "rb") as f:
        f.seek(_CKPT_HDR)
        for _ in range(nplanes):
            r, c = np.frombuffer(f.read(8), np.int32)
            buf = np.fromfile(f, dtype=dtype, count=int(r) * int(c))
            if buf.size != int(r) * int(c):
                raise IOError(f"{fname}: truncated checkpoint")
            planes.append(buf.reshape(int(r), int(c)))
    return planes


def save_checkpoint(fname, W):
    """Snapshot a ``Wavelets`` plan's coefficient pyramid to disk."""
    from .filters import wavelist
    if W.wname not in wavelist():
        raise ValueError(
            "checkpointing plans with custom filter banks is not "
            "supported (the bank cannot be restored by name)")
    dt = np.dtype(W.dtype)
    planes = [np.ascontiguousarray(W.coeff_only(0), dtype=dt)]
    nsub = 3 if W._eff_ndim == 2 else 1
    for num in range(1, nsub * W.levels + 1):
        planes.append(np.ascontiguousarray(W.coeff_only(num), dtype=dt))
    planes2d = [p.reshape(p.shape[0], -1) if p.ndim == 2
                else p.reshape(1, -1) for p in planes]
    flags = (_F_SWT if W.do_swt else 0) | (_F_BATCHED if W.batched1d else 0)
    if dt == np.float64:
        flags |= _F_F64
    lib = _load()
    if lib and dt == np.float32:
        n = len(planes2d)
        rows = (ctypes.c_int32 * n)(*[p.shape[0] for p in planes2d])
        cols = (ctypes.c_int32 * n)(*[p.shape[1] for p in planes2d])
        ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
            *[p.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for p in planes2d])
        rc = lib.pwt_ckpt_save(fname.encode(), W._eff_ndim, W.Nr, W.Nc,
                               W.levels, flags, W.wname.encode(), n,
                               rows, cols, ptrs)
        if rc != 0:
            raise IOError(f"pwt_ckpt_save: error {rc}")
    else:
        _py_ckpt_write(fname, W._eff_ndim, W.Nr, W.Nc, W.levels, flags,
                       W.wname, planes2d)


def load_checkpoint(fname, img_dtype=None):
    """Rebuild a ``Wavelets`` plan from a checkpoint; its coefficients are
    restored and ``inverse()`` is ready to run.  The plan's dtype follows
    the checkpoint unless ``img_dtype`` is passed explicitly, in which
    case the loaded planes are cast to it (lossy for f64 -> f32)."""
    from .api import Wavelets
    ndim, nr, nc, levels, flags, wname = _py_ckpt_read_header(fname)
    coeff_dtype = np.float64 if flags & _F_F64 else np.float32
    nsub = 3 if ndim == 2 else 1
    nplanes = 1 + nsub * levels

    lib = _load()
    if lib and coeff_dtype == np.float32:
        def plane(i):
            r = ctypes.c_int32()
            cc = ctypes.c_int32()
            rc = lib.pwt_ckpt_load_plane(fname.encode(), i, r, cc, None)
            if rc != 0:
                raise IOError(f"pwt_ckpt_load_plane: error {rc}")
            out = np.empty((r.value, cc.value), np.float32)
            rc = lib.pwt_ckpt_load_plane(
                fname.encode(), i, r, cc,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc != 0:
                raise IOError(f"pwt_ckpt_load_plane: error {rc}")
            return out
        planes = [plane(i) for i in range(nplanes)]
    else:
        planes = _py_ckpt_read_planes(fname, nplanes, coeff_dtype)

    do_swt = bool(flags & _F_SWT)
    batched = bool(flags & _F_BATCHED)
    plan_dtype = coeff_dtype if img_dtype is None else np.dtype(img_dtype)
    img = np.zeros((nr, nc) if (ndim == 2 or batched) else (nc,),
                   dtype=plan_dtype)
    W = Wavelets(img, wname, levels, do_swt=int(do_swt),
                 ndim=1 if batched else ndim, dtype=plan_dtype)
    for num, p in enumerate(planes):
        ref_shape = np.shape(W._coeff_ref(num))
        W.set_coeff(p.reshape(ref_shape), num)
    W._state = "FORWARD"
    return W

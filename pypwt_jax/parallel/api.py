"""BatchedWavelets — the ``Wavelets`` plan scaled out over a device mesh.

The reference processes one image per plan on one GPU; production
workloads process stacks (tomography projections, video) across devices.
This class keeps the familiar surface (forward / threshold / inverse /
coeffs / norms) while the stack stays device-resident and sharded over
the mesh's data axis the whole time.  All compute is the functional core
under one jit per stage; XLA inserts the collectives (only the norms
need any — psum over shards, the distributed cuBLAS asum/nrm2 of
wt.cu:368-416).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..filters import get_filter_bank, FilterBank
from ..core import dwt, haar, swt, thresh
from ..core.shapes import clamp_levels
from . import mesh as pmesh
from . import spatial
from .batch import shard_stack

_roll_cols = jax.jit(lambda x, sc: jnp.roll(x, sc, -1))
_roll_2d = jax.jit(lambda x, sr, sc: jnp.roll(x, (sr, sc), (-2, -1)))


class BatchedWavelets:
    """Wavelet plan for a (B, Nr, Nc) frame stack sharded across devices.

    Parameters mirror ``Wavelets`` (wname, levels, do_swt,
    do_cycle_spinning, ndim); ``mesh`` defaults to all local devices on
    the data axis.  The batch axis must be divisible by the mesh's
    data-axis size.  ``ndim=1`` transforms each frame row as an
    independent 1D signal (the reference's batched-1D mode,
    pypwt.pyx:146-151, scaled over the mesh).

    HYBRID layout: a mesh whose rows axis is > 1 (``make_mesh(n_data,
    n_rows)``) shards frames over ``data`` AND each frame's rows over
    ``rows`` — the stacks-of-large-frames configuration (e.g. 4 devices
    as 2 data x 2 rows).  Per-frame compute runs the row-sharded
    transform with ppermute halo exchange; frame rows are padded internally to the
    mesh-aligned size (PERIODIC extension, so the padded coefficients
    are exactly the transform of the periodized extension) and cropped
    on readback, as in ``ShardedWavelets``.
    """

    def __init__(self, stack, wname, levels, do_swt=0, mesh=None,
                 ndim=2, do_cycle_spinning=0, seed=None):
        stack = np.asarray(stack, dtype=np.float32)
        if stack.ndim != 3:
            raise ValueError("BatchedWavelets expects a (B, Nr, Nc) stack")
        self.mesh = mesh if mesh is not None else pmesh.make_mesh()
        n_data = self.mesh.shape[pmesh.BATCH_AXIS]
        if stack.shape[0] % n_data:
            raise ValueError(
                f"batch {stack.shape[0]} not divisible by data axis "
                f"{n_data}")
        self.B, self.Nr, self.Nc = stack.shape
        self.shape = stack.shape
        self.wname = wname
        self.do_swt = int(bool(do_swt))
        self.ndim = 1 if int(ndim) == 1 else 2
        self.do_cycle_spinning = int(bool(do_cycle_spinning))
        self._rng = np.random.default_rng(seed)
        self.current_shift = (0, 0)
        self._fb = get_filter_bank(wname)
        self.hlen = self._fb.hlen
        self.levels = clamp_levels(int(levels), (self.Nr, self.Nc),
                                   self.hlen, self.ndim)

        self.n_rows = (self.mesh.shape[pmesh.ROW_AXIS]
                       if pmesh.ROW_AXIS in self.mesh.axis_names else 1)
        self.hybrid = self.n_rows > 1 and self.ndim == 2
        if self.hybrid:
            rmult = self.n_rows << self.levels
            self._Nrp = -(-self.Nr // rmult) * rmult
            self._hspec = P(pmesh.BATCH_AXIS, pmesh.ROW_AXIS, None)
            self._hsharding = NamedSharding(self.mesh, self._hspec)
        else:
            self._Nrp = self.Nr

        self._stack = self._put_stack(stack)
        self._coeffs = None
        self._build_plans()

    def _put_stack(self, stack):
        if not self.hybrid:
            return shard_stack(jnp.asarray(stack), self.mesh)
        pr = self._Nrp - stack.shape[1]
        if pr:
            stack = np.pad(np.asarray(stack), ((0, 0), (0, pr), (0, 0)),
                           mode="wrap")
        return jax.device_put(jnp.asarray(stack), self._hsharding)

    def _build_plans(self):
        fb = self._fb
        lv = self.levels
        use_haar = fb.hlen == 2 and not self.do_swt
        if self.hybrid:
            # frames over data, rows over rows: shard_map-local
            # transforms with ppermute halo exchange on the rows ring (the
            # leading batch axis rides through the local transforms)
            ax, nr = pmesh.ROW_AXIS, self.n_rows
            if self.do_swt:
                loc_fwd = lambda x: spatial._local_swt2(x, fb, lv, ax, nr)
                loc_inv = lambda c: spatial._local_iswt2(c, fb, ax, nr)
            else:
                loc_fwd = lambda x: spatial._local_wavedec2(
                    x, fb, lv, ax, nr)
                loc_inv = lambda c: spatial._local_waverec2(
                    c, fb, ax, nr)
            sm = lambda f: shard_map(f, mesh=self.mesh,
                                     in_specs=(self._hspec,),
                                     out_specs=self._hspec,
                                     check_vma=False)
            self._fwd = jax.jit(sm(loc_fwd))
            self._inv = jax.jit(sm(loc_inv))
            self._denoise_cache = {}
            return
        if self.ndim == 1:
            n = self.Nc
            if use_haar:
                fwd = lambda x: haar.haar_wavedec1(x, lv)
                inv = lambda c: haar.haar_waverec1(c, n)
            elif self.do_swt:
                fwd = lambda x: swt.swt1d(x, fb, lv)
                inv = lambda c: swt.iswt1d(c, fb)
            else:
                fwd = lambda x: dwt.wavedec1(x, fb, lv)
                inv = lambda c: dwt.waverec1(c, fb, n)
        elif use_haar:
            fwd = lambda x: haar.haar_wavedec2(x, lv)
            inv = lambda c: haar.haar_waverec2(c, self.shape)
        elif self.do_swt:
            fwd = lambda x: swt.swt2d(x, fb, lv)
            inv = lambda c: swt.iswt2d(c, fb)
        else:
            fwd = lambda x: dwt.wavedec2(x, fb, lv)
            inv = lambda c: dwt.waverec2(c, fb, self.shape)
        self._fwd = jax.jit(fwd)
        self._inv = jax.jit(inv)
        self._denoise_cache = {}

    def set_wavelets_filters(self, filter_name, lowpass, highpass,
                             i_lowpass, i_highpass):
        """Install a custom separable filter bank (pypwt.pyx:487-576) and
        rebuild the compiled plans."""
        self._fb = FilterBank.custom(filter_name, lowpass, highpass,
                                     i_lowpass, i_highpass)
        self.wname = filter_name
        self.hlen = self._fb.hlen
        self._coeffs = None
        self._build_plans()

    # ------------------------------------------------------------------

    def _shift(self, x, sr, sc):
        if self.ndim == 1:
            return _roll_cols(x, sc)  # common.cu:386: sr=0 for 1D
        return _roll_2d(x, sr, sc)

    def forward(self, stack=None):
        if stack is not None:
            stack = np.asarray(stack, dtype=np.float32)
            if stack.shape != self.shape:
                raise ValueError("stack shape changed")
            self._stack = self._put_stack(stack)
        if self.do_cycle_spinning:
            sr = int(self._rng.integers(0, self.Nr))
            sc = int(self._rng.integers(0, self.Nc))
            self.current_shift = (sr, sc)
            self._stack = self._shift(self._stack, sr, sc)
        self._coeffs = self._fwd(self._stack)
        return self

    def inverse(self):
        if self._coeffs is None:
            raise RuntimeError("forward() has not been run")
        self._stack = self._inv(self._coeffs)
        if self.do_cycle_spinning:
            sr, sc = self.current_shift
            self._stack = self._shift(self._stack, -sr, -sc)
        return self

    def _guard(self):
        if self._coeffs is None:
            raise RuntimeError("forward() has not been run")

    def soft_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard()
        self._coeffs = thresh.soft_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def hard_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard()
        self._coeffs = thresh.hard_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def group_soft_threshold(self, beta, do_threshold_appcoeffs=0,
                             normalize=0):
        self._guard()
        self._coeffs = thresh.group_soft_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def shrink(self, beta, do_threshold_appcoeffs=1):
        self._guard()
        self._coeffs = thresh.shrink(self._coeffs, float(beta),
                                     bool(do_threshold_appcoeffs))

    def norm1(self):
        self._guard()
        return float(thresh.norm1(self._coeffs))

    def norm2sq(self):
        self._guard()
        return float(thresh.norm2sq(self._coeffs))

    def _denoise_step(self, normalize, hard):
        """Jitted fused step, cached per (normalize, hard); beta is a
        traced argument so sweeping it never recompiles."""
        key = (bool(normalize), bool(hard))
        cache = self._denoise_cache
        if key not in cache:
            fwd, inv = self._fwd, self._inv
            th = (thresh.hard_threshold if key[1]
                  else thresh.soft_threshold)

            def step(x, beta):
                return inv(th(fwd(x), beta, False, key[0]))

            cache[key] = jax.jit(step)
        return cache[key]

    def denoise(self, beta, normalize=0, hard=False):
        """Fused forward -> threshold -> inverse (one compiled step,
        no host round trips); returns self."""
        step = self._denoise_step(normalize, hard)
        self._stack = step(self._stack,
                           jnp.asarray(beta, self._stack.dtype))
        self._coeffs = None
        return self

    # ------------------------------------------------------------------

    @property
    def image(self):
        """The stack, gathered to host (B, Nr, Nc); hybrid row padding
        is cropped back to the user's geometry."""
        out = np.asarray(self._stack)
        return out[:, : self.Nr] if self.hybrid else out

    def stack_device_array(self):
        return self._stack

    def coeff_only(self, num):
        """One coefficient plane for the whole batch, gathered to host.

        Indexing: 2D: 0=A, 1=H1, 2=V1, 3=D1, ...; 1D: 0=A, i=Di
        (wt.cu:478-502)."""
        self._guard()
        if num == 0:
            return np.asarray(self._coeffs[0])
        if self.ndim == 1:
            if num > self.levels:
                raise ValueError(f"coefficient {num} out of range")
            return np.asarray(self._coeffs[num])
        level = (num - 1) // 3 + 1
        sub = (num - 1) % 3
        if level > self.levels:
            raise ValueError(f"coefficient {num} out of range")
        return np.asarray(self._coeffs[level][sub])

    def coeffs_device(self):
        """The live sharded pyramid PyTree."""
        self._guard()
        return self._coeffs

    def set_coeff(self, coeff, num, check=False):
        """Overwrite one coefficient plane for the whole batch
        (pypwt.pyx:463-484 batched: leading axis is B, re-sharded on
        install)."""
        self._guard()
        if self.ndim == 1:
            if not 0 <= num <= self.levels:
                raise ValueError(f"coefficient {num} out of range")
            ref = self._coeffs[num]
        elif num == 0:
            ref = self._coeffs[0]
        else:
            level = (num - 1) // 3 + 1
            sub = (num - 1) % 3
            if level > self.levels:
                raise ValueError(f"coefficient {num} out of range")
            ref = self._coeffs[level][sub]
        coeff = np.asarray(coeff, dtype=np.float32)
        if check and tuple(coeff.shape) != tuple(ref.shape):
            raise ValueError(
                "set_coeff: Invalid coefficient shape : expected %s, got %s"
                % (str(tuple(ref.shape)), str(tuple(coeff.shape))))
        new = shard_stack(jnp.asarray(coeff.reshape(ref.shape)), self.mesh)
        if num == 0:
            self._coeffs = [new] + list(self._coeffs[1:])
        elif self.ndim == 1:
            c = list(self._coeffs)
            c[num] = new
            self._coeffs = c
        else:
            planes = list(self._coeffs[level])
            planes[sub] = new
            c = list(self._coeffs)
            c[level] = tuple(planes)
            self._coeffs = c

    def add_wavelet(self, W, alpha=1.0):
        """In-place coefficient axpy with another BatchedWavelets
        holding the same transform (wt.cu:622-655, batched)."""
        self._guard()
        W._guard()
        if (self.levels != W.levels
                or self.wname.lower() != W.wname.lower()):
            raise ValueError(
                "add_wavelet(): right operand is not the same transform "
                "(wname, level)")
        if (self.shape, self.ndim, bool(self.do_swt)) != (
                W.shape, W.ndim, bool(W.do_swt)):
            raise ValueError(
                "add_wavelet(): operands do not have the same geometry")
        if (self.do_cycle_spinning and W.do_cycle_spinning
                and self.current_shift != W.current_shift):
            raise ValueError(
                "add_wavelet(): operands do not have the same current shift")
        self._coeffs = thresh.add_coeffs(self._coeffs, W._coeffs,
                                         float(alpha))
        return 0

"""Reference-compatible ``Wavelets`` class (the pypwt/pycudwt user API).

Mirrors the Cython class (src/pypwt.pyx:64-615) and the C++ plan object
(pdwt/src/wt.cu:84-305) on top of the functional JAX core: the constructor
uploads the image to the device, ``forward()``/``inverse()`` run cached
jit-compiled transforms, coefficients live on device and are copied back on
access, and the reference's state machine (coefficients are declared invalid
after ``inverse()``) is preserved even though the functional core never
actually clobbers them.

Differences from the reference (documented, all supersets or fixes):
* ``group_soft_threshold`` and ``proj_linf`` exist in the reference C++ but
  were never exposed to Python (pypwt.pyx:44-61); here they are methods.
* ``norm2sq`` is a true squared L2 norm in 1D too (upstream accumulates an
  L1 sum for 1D details, wt.cu:386-388).
* cycle-spinning shifts come from a seedable NumPy RNG instead of C rand()
  (wt.cu:242-246).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .filters import FilterBank, get_filter_bank, MAX_FILTER_WIDTH
from .core import conv, dwt, haar, swt, thresh
from .core import nonsep as ns
from .core.shapes import clamp_levels, div2, level_shapes_1d, level_shapes_2d
from .version import __version__

# state machine (wt.h:8-17)
W_INIT = "INIT"
W_FORWARD = "FORWARD"
W_INVERSE = "INVERSE"


def _key_of_bank(fb):
    if isinstance(fb, FilterBank):
        return (fb.name, fb.hlen,
                hash((fb.dec_lo.tobytes(), fb.dec_hi.tobytes(),
                      fb.rec_lo.tobytes(), fb.rec_hi.tobytes())))
    return (fb.name, fb.hlen, hash(tuple(f.tobytes() for f in
                                         fb.dec + fb.rec)))


class _Plan:
    """Compiled transform pair for a fixed (shape, bank, levels, mode)."""

    def __init__(self, shape, fb, f2d, levels, ndim, do_swt, separable,
                 batched):
        self.shape = shape
        self.levels = levels

        use_haar = (fb is not None and fb.hlen == 2 and not do_swt)

        if ndim == 1 or batched:
            n = shape[-1]
            if use_haar:
                fwd = lambda x: haar.haar_wavedec1(x, levels)
                inv = lambda c: haar.haar_waverec1(c, n)
            elif do_swt:
                fwd = lambda x: swt.swt1d(x, fb, levels)
                inv = lambda c: swt.iswt1d(c, fb)
            else:
                fwd = lambda x: dwt.wavedec1(x, fb, levels)
                inv = lambda c: dwt.waverec1(c, fb, n)
        else:
            if use_haar:
                fwd = lambda x: haar.haar_wavedec2(x, levels)
                inv = lambda c: haar.haar_waverec2(c, shape)
            elif separable:
                if do_swt:
                    fwd = lambda x: swt.swt2d(x, fb, levels)
                    inv = lambda c: swt.iswt2d(c, fb)
                else:
                    fwd = lambda x: dwt.wavedec2(x, fb, levels)
                    inv = lambda c: dwt.waverec2(c, fb, shape)
            else:
                if do_swt:
                    fwd = lambda x: ns.ns_swt2d(x, f2d, levels)
                    inv = lambda c: ns.ins_swt2d(c, f2d)
                else:
                    fwd = lambda x: ns.ns_wavedec2(x, f2d, levels)
                    inv = lambda c: ns.ns_waverec2(c, f2d, shape)

        self.forward = jax.jit(fwd)
        self.inverse = jax.jit(inv)


@functools.lru_cache(maxsize=256)
def _plan_cache(shape, dtype, bank_key, levels, ndim, do_swt, separable,
                batched, _fb_ref):
    fb, f2d = _fb_ref
    return _Plan(shape, fb, f2d, levels, ndim, do_swt, separable, batched)


class _HashableRef:
    """Wrap unhashable filter objects for the lru key (identity carried by
    bank_key)."""

    def __init__(self, payload):
        self.payload = payload

    def __hash__(self):
        return 0

    def __eq__(self, other):
        return True

    def __iter__(self):
        return iter(self.payload)


_roll2 = jax.jit(lambda x, sr, sc: jnp.roll(x, (sr, sc), (-2, -1)))
_roll1 = jax.jit(lambda x, sc: jnp.roll(x, sc, -1))


class Wavelets:
    """Wavelet transform plan bound to one image geometry.

    Parameters follow the reference (pypwt.pyx:109-118):

    img: 2D or 1D numpy array (float32 coerced, like pypwt.pyx:224-235)
    wname: wavelet name (72 built-ins)
    levels: decomposition levels (clamped like wt.cu:155-165)
    do_separable / do_cycle_spinning / do_swt: mode flags
    ndim: pass ndim=1 with a 2D image for a batched-1D transform
    """

    def __init__(self, img, wname, levels, do_separable=1,
                 do_cycle_spinning=0, do_swt=0, ndim=2, seed=None,
                 dtype=np.float32):
        # float32 default; float64 is the reference's -DDOUBLEPRECISION
        # build option (filters.h:16-30), here a constructor argument.
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError("dtype must be float32 or float64")
        if self.dtype == np.float64 and not jax.config.jax_enable_x64:
            raise ValueError(
                "dtype=float64 requires jax_enable_x64 "
                "(jax.config.update('jax_enable_x64', True))")
        img = self._checkarray(img)
        ndim = min(int(ndim), 2)

        self.batched1d = 0
        if img.ndim == 2:
            self.Nr, self.Nc = img.shape
            if ndim == 1:
                self.batched1d = 1
        elif img.ndim == 1:
            self.Nr, self.Nc = 1, img.shape[0]
            ndim = 1
        else:
            raise NotImplementedError(
                "Wavelets(): Only 1D and 2D transforms are supported for now")
        self.shape = tuple(img.shape)
        self.ndim = img.ndim if not self.batched1d else 2

        eff_ndim = 1 if (self.batched1d or img.ndim == 1) else 2

        if eff_ndim == 1 and not do_separable:
            # wt.cu:138-142
            do_separable = 1

        self.wname = wname
        self.do_separable = int(bool(do_separable))
        self.do_cycle_spinning = int(bool(do_cycle_spinning))
        self.do_swt = int(bool(do_swt))
        self._eff_ndim = eff_ndim

        self._fb = get_filter_bank(wname)
        self._f2d = (ns.Filters2D.from_bank(self._fb)
                     if not self.do_separable else None)
        self.hlen = 2 if (self._fb.hlen == 2 and not do_swt) else self._fb.hlen

        sig_shape = (self.Nr, self.Nc) if eff_ndim == 2 else (self.Nc,)
        self.levels = clamp_levels(int(levels), (self.Nr, self.Nc),
                                   self._fb.hlen, eff_ndim)

        if self.do_cycle_spinning and self.do_swt:
            print("Warning: makes little sense to use Cycle spinning with "
                  "stationary Wavelet transform")
        if self.do_cycle_spinning and eff_ndim == 1 and not self.batched1d:
            raise ValueError(
                "cycle spinning is not implemented for 1D. Use SWT instead.")

        self.sizes = self._compute_sizes()
        self._rng = np.random.default_rng(seed)
        self.current_shift = (0, 0)
        self._state = W_INIT

        self._image = jnp.asarray(img, dtype=self.dtype)
        self._coeffs = self._zero_coeffs()

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def _checkarray(self, arr, shp=None):
        res = np.asarray(arr)
        if res.dtype != self.dtype or not res.flags["C_CONTIGUOUS"]:
            res = np.ascontiguousarray(res, dtype=self.dtype)
        if shp is not None:
            if res.ndim != len(shp):
                raise ValueError(
                    "Invalid number of dimensions (expected %d, got %d)"
                    % (len(shp), res.ndim))
            if tuple(res.shape) != tuple(shp):
                raise ValueError(
                    "The image does not have the correct shape "
                    "(expected %s, got %s)" % (str(tuple(shp)),
                                               str(res.shape)))
        return res

    @staticmethod
    def div2(n):
        return div2(n)

    def _compute_sizes(self):
        if self._eff_ndim == 2:
            shapes = level_shapes_2d(self.Nr, self.Nc, self.levels,
                                     self.do_swt)
            return shapes
        lens = level_shapes_1d(self.Nc, self.levels, self.do_swt)
        return [(self.Nr, n) for n in lens]

    def _coeff_shape(self, i):
        """Host-visible shape of detail level i (1-based); A uses sizes[-1]."""
        nr, nc = self.sizes[i]
        if self._eff_ndim == 1 and self.ndim == 1:
            return (nc,)
        return (nr, nc)

    def _zero_coeffs(self):
        z = []
        dt = self.dtype
        a_shape = self._coeff_shape(self.levels - 1)
        z.append(jnp.zeros(a_shape, dt))
        for i in range(self.levels):
            s = self._coeff_shape(i)
            if self._eff_ndim == 2:
                z.append(tuple(jnp.zeros(s, dt) for _ in range(3)))
            else:
                z.append(jnp.zeros(s, dt))
        return z

    def _plan(self):
        key_shape = self.shape
        bank_key = _key_of_bank(self._fb if self.do_separable else self._f2d)
        return _plan_cache(
            key_shape, str(self.dtype), bank_key, self.levels,
            self._eff_ndim,
            self.do_swt, bool(self.do_separable), bool(self.batched1d),
            _HashableRef((self._fb, self._f2d)))

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------

    def forward(self, img=None):
        """Forward transform (pypwt.pyx:333-344 / wt.cu:236-269)."""
        if img is not None:
            img = self._checkarray(img, self.shape)
            self._image = jnp.asarray(img)
        if self.do_cycle_spinning:
            sr = int(self._rng.integers(0, self.Nr))
            sc = int(self._rng.integers(0, self.Nc))
            self.current_shift = (sr, sc)
            self._image = self._circshift_image(self._image, sr, sc)
        self._coeffs = self._plan().forward(self._image)
        self._state = W_FORWARD
        return self

    def inverse(self):
        """Inverse transform (pypwt.pyx:347-358 / wt.cu:271-305).

        Matches the reference contract: calling inverse() twice is refused
        (the reference's buffer reuse destroys the coefficients; we keep the
        same Python-visible behavior)."""
        if self._state == W_INVERSE:
            print("Warning: W.inverse() has already been run. Inverse is "
                  "available in W.image")
            return self
        self._image = self._plan().inverse(self._coeffs)
        if self.do_cycle_spinning:
            sr, sc = self.current_shift
            self._image = self._circshift_image(self._image, -sr, -sc)
        self._state = W_INVERSE
        return self

    def _circshift_image(self, x, sr, sc):
        if x.ndim == 1:
            return _roll1(x, sc)
        if self._eff_ndim == 1:
            # batched 1D shifts along columns only (common.cu:386 passes
            # sr=0 for ndims==1); every row shifts by the same amount.
            return _roll1(x, sc)
        return _roll2(x, sr, sc)

    def circshift(self, sr, sc):
        """Circular shift of the current image (wt.cu:362-366)."""
        if self._eff_ndim == 1:
            sr = 0
        self._image = self._circshift_image(self._image, sr, sc)
        return self

    # ------------------------------------------------------------------
    # coefficients access
    # ------------------------------------------------------------------

    def _guard_coeffs(self):
        if self._state == W_INVERSE:
            raise RuntimeError(
                "Wavelets: inverse() has been performed, the coefficients "
                "do not make sense anymore (run forward() again)")

    def coeff_only(self, num):
        """Copy one coefficient plane to host (pypwt.pyx:261-286).

        Indexing: 2D: 0=A, 1=H1, 2=V1, 3=D1, 4=H2, ...; 1D: 0=A, i=Di.
        """
        self._guard_coeffs()
        return np.asarray(self._coeff_ref(num))

    def _coeff_ref(self, num):
        if num == 0:
            return self._coeffs[0]
        if self._eff_ndim == 2:
            level = (num - 1) // 3 + 1
            sub = (num - 1) % 3
            if level > self.levels:
                raise ValueError(f"coefficient {num} out of range")
            return self._coeffs[level][sub]
        if num > self.levels:
            raise ValueError(f"coefficient {num} out of range")
        return self._coeffs[num]

    @property
    def coeffs(self):
        """All coefficients as [A, [H1,V1,D1], ...] numpy arrays
        (pypwt.pyx:289-305)."""
        self._guard_coeffs()
        out = [np.asarray(self._coeffs[0])]
        for i in range(1, self.levels + 1):
            c = self._coeffs[i]
            if self._eff_ndim == 2:
                out.append([np.asarray(s) for s in c])
            else:
                out.append(np.asarray(c))
        return out

    def set_coeff(self, coeff, num, check=False):
        """Overwrite one coefficient plane (pypwt.pyx:463-484)."""
        coeff = self._checkarray(coeff)
        ref = self._coeff_ref(num)
        if check and tuple(coeff.shape) != tuple(ref.shape):
            raise ValueError(
                "set_coeff: Invalid coefficient shape : expected %s, got %s"
                % (str(tuple(ref.shape)), str(tuple(coeff.shape))))
        new = jnp.asarray(coeff.reshape(ref.shape))
        if num == 0:
            self._coeffs = [new] + list(self._coeffs[1:])
        elif self._eff_ndim == 2:
            level = (num - 1) // 3 + 1
            sub = (num - 1) % 3
            planes = list(self._coeffs[level])
            planes[sub] = new
            c = list(self._coeffs)
            c[level] = tuple(planes)
            self._coeffs = c
        else:
            c = list(self._coeffs)
            c[num] = new
            self._coeffs = c

    @property
    def image(self):
        """Current image as a (Nr, Nc) numpy array (pypwt.pyx:308-315)."""
        return np.asarray(self._image).reshape(self.Nr, self.Nc)

    def set_image(self, img):
        img = self._checkarray(img, self.shape)
        self._image = jnp.asarray(img)
        self._state = W_INIT

    # device-side access (the counterpart of image_int_ptr/coeff_int_ptr,
    # pypwt.pyx:578-592: hand out the device arrays themselves)
    def image_device_array(self):
        return self._image

    def coeff_device_array(self, num):
        self._guard_coeffs()
        return self._coeff_ref(num)

    # ------------------------------------------------------------------
    # proximal operators / norms
    # ------------------------------------------------------------------

    def _guard_thresh(self):
        if self._state == W_INVERSE:
            raise RuntimeError(
                "Wavelets: cannot threshold coefficients, as they were "
                "modified by W.inverse()")

    def soft_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard_thresh()
        self._coeffs = thresh.soft_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def hard_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard_thresh()
        self._coeffs = thresh.hard_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def group_soft_threshold(self, beta, do_threshold_appcoeffs=0,
                             normalize=0):
        self._guard_thresh()
        self._coeffs = thresh.group_soft_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def proj_linf(self, beta, do_threshold_appcoeffs=0):
        self._guard_thresh()
        self._coeffs = thresh.proj_linf(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs))

    def shrink(self, beta, do_threshold_appcoeffs=1):
        self._guard_thresh()
        self._coeffs = thresh.shrink(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs))

    def norm1(self):
        return float(thresh.norm1(self._coeffs))

    def norm2sq(self):
        return float(thresh.norm2sq(self._coeffs))

    def add_wavelet(self, W, alpha=1.0):
        """In-place coefficient axpy (wt.cu:622-655)."""
        if (self.levels != W.levels
                or self.wname.lower() != W.wname.lower()):
            raise ValueError(
                "add_wavelet(): right operand is not the same transform "
                "(wname, level)")
        if self._state == W_INVERSE or W._state == W_INVERSE:
            print("WARNING: add_wavelet(): this operation makes no sense "
                  "when wavelet has just been inverted")
            return 1
        if (self.Nr, self.Nc, self.ndim) != (W.Nr, W.Nc, W.ndim):
            raise ValueError(
                "add_wavelet(): operands do not have the same geometry")
        if bool(self.do_swt) != bool(W.do_swt):
            raise ValueError(
                "add_wavelet(): operands should both use SWT or DWT")
        if (self.do_cycle_spinning and W.do_cycle_spinning
                and self.current_shift != W.current_shift):
            raise ValueError(
                "add_wavelet(): operands do not have the same current shift")
        self._coeffs = thresh.add_coeffs(self._coeffs, W._coeffs,
                                         float(alpha))
        return 0

    # ------------------------------------------------------------------
    # custom filter banks
    # ------------------------------------------------------------------

    def set_wavelets_filters(self, filter_name, lowpass, highpass,
                             i_lowpass, i_highpass, LH=None, HL=None,
                             i_LH=None, i_HL=None):
        """Install a custom filter bank (pypwt.pyx:487-576).

        Separable: 4 1D arrays (dec_lo, dec_hi, rec_lo, rec_hi).
        Non-separable: lowpass/highpass are the LL/HH 2D filters plus the
        LH/HL ones (and their inverses).
        """
        lowpass = np.asarray(lowpass, dtype=np.float64)
        arrays = [lowpass, highpass, i_lowpass, i_highpass, LH, HL, i_LH,
                  i_HL]
        if any(a is not None and len(a) != len(lowpass) for a in arrays):
            raise ValueError("All filters must have the same length")
        if len(lowpass) > MAX_FILTER_WIDTH:
            raise ValueError("filter too long (max %d)" % MAX_FILTER_WIDTH)
        if not self.do_separable and lowpass.ndim != 2:
            raise ValueError(
                "non-separable custom filters must be 2D square arrays "
                "(pypwt.pyx:487-576 passes LL/LH/HL/HH planes)")

        if self.do_separable:
            self._fb = FilterBank.custom(filter_name, lowpass, highpass,
                                         i_lowpass, i_highpass)
        else:
            if LH is None or HL is None or i_LH is None or i_HL is None:
                raise ValueError(
                    "Expected LH and HL filters for non-separable transform")
            dec = [np.asarray(a, dtype=np.float64)
                   for a in (lowpass, LH, HL, highpass)]
            rec = [np.asarray(a, dtype=np.float64)
                   for a in (i_lowpass, i_LH, i_HL, i_highpass)]
            self._f2d = ns.Filters2D(dec, rec, name=filter_name)
            self._fb = None
        self.wname = filter_name
        self.hlen = len(lowpass)
        # re-derive levels/sizes for the new support
        # (the reference keeps the existing plan; we keep levels unchanged
        # to match, since buffers were already allocated)
        self._state = W_INIT

    # ------------------------------------------------------------------
    # info
    # ------------------------------------------------------------------

    def info(self):
        print(self._info_str())

    def _info_str(self):
        yn = {0: "no", 1: "yes"}
        lines = ["------------- Wavelet transform infos ------------"]
        if self._eff_ndim == 2:
            lines.append(f"Data dimensions : ({self.Nr}, {self.Nc})")
        elif self.Nr == 1:
            lines.append(f"Data dimensions : {self.Nc}")
        else:
            lines.append(
                f"Data dimensions : ({self.Nr}, {self.Nc}) "
                "[batched 1D transform]")
        lines.append(f"Wavelet name : {self.wname}")
        lines.append(f"Number of levels : {self.levels}")
        lines.append(f"Stationary WT : {yn[self.do_swt]}")
        lines.append(f"Cycle spinning : {yn[self.do_cycle_spinning]}")
        lines.append(f"Separable transform : {yn[self.do_separable]}")
        # memory footprint model (wt.cu:527-538); functional core has no
        # persistent temporaries, so this is image + coefficients only
        if not self.do_swt:
            mem = 2 * self.Nr * self.Nc * 4
        elif self._eff_ndim == 2:
            mem = (3 * self.levels + 2) * self.Nr * self.Nc * 4
        else:
            mem = (self.levels + 2) * self.Nr * self.Nc * 4
        lines.append("Estimated memory footprint : %.2f MB" % (mem / 1e6))
        dev = jax.devices()[0]
        lines.append(f"Running on device : {dev.device_kind}")
        lines.append("--------------------------------------------------")
        return "\n".join(lines)

    def __repr__(self):
        return self._info_str()

    @classmethod
    def version(cls):
        return __version__

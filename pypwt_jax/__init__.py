"""pypwt_jax — a JAX wavelet transform engine.

A from-scratch JAX/XLA reimplementation of the pypwt/pycudwt capability
set (1D/2D/batched DWT + stationary SWT, 72 wavelets, separable &
non-separable modes, thresholding/proximal operators, cycle spinning): a
pure functional core of jax.numpy/lax under jit, compiled by XLA for the
GPU, and jax.sharding for multi-device scaling.

Quick start (mirrors the reference README):

    >>> import numpy as np, pypwt_jax
    >>> img = np.random.rand(512, 512).astype(np.float32)
    >>> W = pypwt_jax.Wavelets(img, "db2", 3)
    >>> W.forward()
    >>> W.soft_threshold(10.0)
    >>> W.inverse()
    >>> denoised = W.image
"""

from .api import Wavelets  # noqa: F401
from .filters import (FilterBank, get_filter_bank,  # noqa: F401
                      wavelist)
from .version import __version__  # noqa: F401

from .core import conv, dwt, haar, nonsep, shapes, swt, thresh  # noqa: F401
from . import runtime  # noqa: F401  (native planner/IO/loader/checkpoint)
from . import pipeline  # noqa: F401  (compiled denoise pipelines)
from . import compat  # noqa: F401  (pywt-style functional surface)

__all__ = [
    "Wavelets",
    "FilterBank",
    "get_filter_bank",
    "wavelist",
    "runtime",
    "pipeline",
    "__version__",
]

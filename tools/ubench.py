"""Device timing helpers.

Thin re-export of the single trusted implementation in
``pypwt_jax.utils.profiling`` (see that module's docstring for the
measurement protocol).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from pypwt_jax.utils.profiling import (  # noqa: F401,E402
    device_sync,
    make_inputs,
    readback_latency,
    timeit,
    timeit_chained,
    timeit_pipelined,
)

_sync = device_sync  # legacy alias

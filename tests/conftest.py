import os
import sys

import pytest

# ---------------------------------------------------------------------------
# Test environment.
#
# Tests run on the CPU with a simulated 8-device mesh (SURVEY.md §4:
# multi-host behavior is tested on simulated meshes).  Tests that need a
# GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
# skips them here; ``python chip_smoke.py`` is what runs on the card.
# ---------------------------------------------------------------------------
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# float64 so the scalar-oracle comparisons are exact; production runs f32.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is set,
# else a CPU-only directory inside the checkout.  Full-sweep runs (hundreds
# of distinct executables in one process) hit a deterministic jaxlib
# segfault inside executable.serialize() during the cache write, so they
# run uncached.
_cache_dir = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
              or os.path.join(os.path.dirname(__file__), os.pardir,
                              ".jax_cache_cpu"))
if os.environ.get("PYPWT_FULL_SWEEP", "") != "1":
    jax.config.update("jax_compilation_cache_dir",
                      os.path.abspath(_cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when this process has none.
    Decided here, at run time, never at import or collection."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return gpus[0]

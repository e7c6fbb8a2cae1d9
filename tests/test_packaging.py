"""Installability proof (VERDICT r3 next #9): build a wheel, install it
into a fresh venv (offline), import, and round-trip 64^2 db2 — the
counterpart of the reference's packaging layer (setup.py:104-128, which
ships a compiled extension the same way: build, install, import).

Everything runs in subprocesses with PYTHONPATH cleared and JAX forced to
CPU, so the test is hermetic.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

pytestmark = pytest.mark.skipif(
    os.environ.get("PYPWT_SKIP_PACKAGING", "") == "1",
    reason="packaging proof disabled")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_wheel_builds_installs_and_transforms(tmp_path):
    env = _env()
    wheel_dir = tmp_path / "dist"

    # 1. build the wheel offline (system setuptools, no build isolation —
    #    the container has no package index)
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", REPO, "--no-deps",
         "--no-build-isolation", "--no-index", "-w", str(wheel_dir)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    wheels = list(wheel_dir.glob("pypwt_jax-*.whl"))
    assert len(wheels) == 1, list(wheel_dir.iterdir())
    wheel = wheels[0]

    # 2. fresh venv; jax/numpy come from the parent interpreter's
    #    site-packages via a .pth link (the parent may itself be a venv,
    #    so --system-site-packages would miss them).  The venv's own
    #    site-packages stays first, so the INSTALLED pypwt_jax wins.
    venv = tmp_path / "venv"
    out = subprocess.run(
        [sys.executable, "-m", "venv", str(venv)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    vpy = str(venv / "bin" / "python")
    import sysconfig
    parent_site = sysconfig.get_paths()["purelib"]
    vsite = subprocess.run(
        [vpy, "-c",
         "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
        capture_output=True, text=True, env=env,
        timeout=60).stdout.strip()
    with open(os.path.join(vsite, "parent-deps.pth"), "w") as f:
        f.write(parent_site + "\n")

    out = subprocess.run(
        [vpy, "-m", "pip", "install", "--no-index", "--no-deps",
         str(wheel)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]

    # 3. import from the INSTALLED package (cwd moved off the repo so the
    #    source tree cannot shadow it) and round-trip 64^2 db2
    smoke = (
        "import os, sys\n"
        "assert 'pypwt_jax' not in sys.modules\n"
        "import numpy as np\n"
        "import pypwt_jax\n"
        "assert os.path.realpath(pypwt_jax.__file__).startswith("
        f"os.path.realpath({str(venv)!r})), pypwt_jax.__file__\n"
        "img = np.random.default_rng(0).random((64, 64))"
        ".astype(np.float32)\n"
        "W = pypwt_jax.Wavelets(img, 'db2', 2)\n"
        "W.forward(); W.soft_threshold(0.0); W.inverse()\n"
        "err = float(np.abs(W.image - img).max())\n"
        "assert err < 7e-4, err\n"
        "print('installed-package roundtrip err', err)\n"
    )
    out = subprocess.run([vpy, "-c", smoke], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path),
                         timeout=300)
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-3000:])
    assert "installed-package roundtrip err" in out.stdout

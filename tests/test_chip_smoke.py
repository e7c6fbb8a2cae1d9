"""chip_smoke.py rehearsed on the CPU at tiny sizes.

Every phase of the GPU smoke run is driven here with the same code at
toy sizes (the four-card phases on four of the eight virtual CPU
devices), so wrong paths, arguments and control flow show up before a
card is used.  The script itself must refuse to run without a GPU.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke as cs
from pypwt_jax.utils import profiling

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

TINY = dict(
    n2d=64, n_swt=32, batched=(8, 64), long_pow2=1 << 16, long_big=200000,
    n_ns=32, stack=(4, 32), n_bank=64, n_bank_fwd=32, long_bank=1 << 16,
    n_f64=32, banks=["haar", "db2", "sym8", "bior4.4"], reps=1,
    copy_elems=1 << 12, compile_threads=2)
TINY_4 = dict(stack=(8, 32), n_shard=64, seq=1 << 17, swt_shape=(32, 64),
              swt_levels=3, reps=1)


@pytest.fixture
def sm(capsys):
    return cs.Smoke()


def _rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("phase", [
    cs.phase_headline, cs.phase_families, cs.phase_swt, cs.phase_1d,
    cs.phase_nonsep, cs.phase_pipelines, cs.phase_banks,
    cs.phase_float64], ids=lambda f: f.__name__)
def test_one_card_phase_on_cpu(sm, phase):
    phase(sm, TINY, _rng())
    assert sm.n_checks >= 1


def test_stack_phase_on_cpu(sm):
    cs.phase_stack(sm, TINY, _rng(), jax.devices()[0])
    assert sm.n_checks == 1


def test_copy_phase_prints_rate(capsys):
    cs.phase_copy(cs.Smoke(), TINY)
    assert "GB_per_s=" in capsys.readouterr().out


@pytest.mark.parametrize("phase", [
    cs.four_batched, cs.four_sharded, cs.four_swt_multihop],
    ids=lambda f: f.__name__)
def test_four_card_phase_on_cpu_mesh(sm, phase):
    phase(sm, TINY_4, _rng(), jax.devices()[:4])
    assert sm.n_checks >= 1


def test_multihop_phase_refuses_single_hop_geometry(sm):
    cfg = dict(TINY_4, swt_shape=(256, 64), swt_levels=2)
    with pytest.raises(cs.SmokeFailure, match="multi-hop"):
        cs.four_swt_multihop(sm, cfg, _rng(), jax.devices()[:4])


def test_check_raises_and_reports_failure(capsys):
    sm = cs.Smoke()
    sm.check("fine", 1e-6, 1e-3, 0.5)
    with pytest.raises(cs.SmokeFailure):
        sm.check("broken", 2e-3, 1e-3)
    with pytest.raises(cs.SmokeFailure):
        sm.check("nan", float("nan"), 1e-3)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("phase=fine max_err=1.000e-06 tol=1.000e-03 "
                      "median_s=0.500000 ok")
    assert out[1].endswith("FAIL") and out[2].endswith("FAIL")


def test_pyr_err_uses_the_per_level_envelope():
    want = [np.zeros((2, 2)), (np.zeros((4, 4)),) * 3, (np.zeros((2, 2)),) * 3]
    got = [w if not isinstance(w, tuple) else list(w) for w in want]
    got[1] = [np.full((4, 4), 0.5 * cs.fwd_tol(1))] + list(want[1][1:])
    assert cs.pyr_err(got, want) == (0.5 * cs.fwd_tol(1), cs.fwd_tol(1))
    got[0] = np.full((2, 2), 0.9 * cs.fwd_tol(2))
    assert cs.pyr_err(got, want) == (0.9 * cs.fwd_tol(2), cs.fwd_tol(2))


def test_result_line_shape():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = json.loads(cs.result_line([Dev()] * 4))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_script_exits_nonzero_without_gpu(args):
    out = _run_script(REPO, *args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        profiling.require_gpu()


def test_compile_cache_dir_rule(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert profiling.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


@pytest.mark.gpu
def test_one_card_smoke_on_gpu(gpu_device, sm):
    cs.run_one_card(sm, TINY, gpu_device)

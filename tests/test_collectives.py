"""Compiled-HLO collective-schedule audit (VERDICT r3 next #1).

The multi-device scaling claim rests on a communication pattern, not on any
CPU-simulated timing: per level, a fixed number of ring-neighbor
ppermutes with halo-sized operands, zero all-gathers / all-reduces /
all-to-alls inside a transform (the only sanctioned all-reduce is the
psum of a norm).  These tests lower AND compile every sharded path on
the simulated mesh and assert that exact schedule against the analytic
prediction (parallel/audit.py).  A regression that upgrades a halo to a
gather — a sharding-propagation change, a stray jnp op outside
shard_map — changes these counts and fails here.

Mesh-size independence (the actual scaling property: counts and per-device
halo bytes do not grow with the ring) is asserted by re-running the same
audit in subprocesses with 16 and 32 simulated devices
(tools/audit_collectives.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pypwt_jax.filters import get_filter_bank
from pypwt_jax.core import dwt as _dwt
from pypwt_jax.core import thresh
from pypwt_jax.parallel import audit, mesh as pmesh
from pypwt_jax.parallel.mesh import ROW_AXIS

REPO = os.path.join(os.path.dirname(__file__), os.pardir)

NO_STRAY = {"all_gather": 0, "all_reduce": 0, "all_to_all": 0}


def _mesh_rows(n=8):
    return pmesh.make_mesh(n_data=1, n_rows=n)


def _struct(mesh, shape, spec):
    return jax.ShapeDtypeStruct(shape, jnp.float32,
                                sharding=NamedSharding(mesh, spec))


def _assert_schedule(fwd_fn, inv_fn, x, pred, mesh, spec,
                     shard_elems, max_halo_elems):
    """Lower + compile fwd and inv; assert exact ppermute counts, zero
    stray collectives at both stages, and halo-sized operands."""
    a_f = audit.audit(fwd_fn, x)
    for stage in ("stablehlo", "compiled"):
        assert a_f[stage]["ppermute"] == pred["fwd_ppermute"], (
            stage, a_f[stage], pred)
        for k, v in NO_STRAY.items():
            assert a_f[stage][k] == v, (stage, k, a_f[stage])
    assert a_f["consistent"]
    # every exchanged operand is halo-sized: a full gather of even one
    # shard would be >= shard_elems
    for e in a_f["compiled"]["ppermute_elems"]:
        assert e <= max_halo_elems, (e, max_halo_elems)
        assert e < shard_elems, (e, shard_elems)

    pyr = jax.eval_shape(fwd_fn, x)
    pyr = jax.tree.map(lambda s: _struct(mesh, s.shape, spec), pyr)
    a_i = audit.audit(inv_fn, pyr)
    for stage in ("stablehlo", "compiled"):
        assert a_i[stage]["ppermute"] == pred["inv_ppermute"], (
            stage, a_i[stage], pred)
        for k, v in NO_STRAY.items():
            assert a_i[stage][k] == v, (stage, k, a_i[stage])
    assert a_i["consistent"]


# ---------------------------------------------------------------------------
# Row-sharded DWT
# ---------------------------------------------------------------------------

def test_rowsharded_dwt_db2_schedule_jnp_routing():
    """db2 L3, jnp routing: per level 2 planes x (1 left + 1 right) = 4
    ppermutes forward, 4 coeff planes x 2 = 8 inverse — hand-derived
    anchor, independently of the predictor."""
    mesh = _mesh_rows(8)
    nr, nc = 8 * 32, 64
    pred = audit.predict_rowsharded(get_filter_bank("db2"), 3, nr, nc, 8)
    assert pred["fwd_ppermute"] == 12 and pred["inv_ppermute"] == 24
    fwd, inv = audit.rowsharded_fns(get_filter_bank("db2"), 3, mesh)
    x = _struct(mesh, (nr, nc), P(ROW_AXIS, None))
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS, None),
                     shard_elems=32 * 64,
                     max_halo_elems=2 * 64)  # <= rpad rows x ncols


def test_rowsharded_haar_needs_zero_communication():
    """haar's aligned 2-tap window never crosses a shard boundary:
    the entire distributed transform is communication-free."""
    mesh = _mesh_rows(8)
    fb = get_filter_bank("haar")
    pred = audit.predict_rowsharded(fb, 3, 8 * 32, 64, 8)
    assert pred == {"fwd_ppermute": 0, "inv_ppermute": 0,
                    "fwd_halo_bytes": 0}
    fwd, inv = audit.rowsharded_fns(fb, 3, mesh)
    x = _struct(mesh, (8 * 32, 64), P(ROW_AXIS, None))
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS, None),
                     shard_elems=32 * 64, max_halo_elems=0)


@pytest.mark.parametrize("wname,halo_bytes", [("db2", 3072),
                                              ("sym8", 21504)])
def test_rowsharded_dwt_schedule_wide_and_narrow(wname, halo_bytes):
    """Per level the forward exchanges a left and a right halo for each
    of its two row passes and the inverse a halo pair for each of its
    four coefficient planes; only the halo widths grow with the filter
    (2 * (hlen - 2) rows per pass)."""
    mesh = _mesh_rows(8)
    nr, nc = 8 * 64, 128
    fb = get_filter_bank(wname)
    pred = audit.predict_rowsharded(fb, 2, nr, nc, 8)
    assert pred == {"fwd_ppermute": 8, "inv_ppermute": 16,
                    "fwd_halo_bytes": halo_bytes}, pred
    fwd, inv = audit.rowsharded_fns(fb, 2, mesh)
    x = _struct(mesh, (nr, nc), P(ROW_AXIS, None))
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS, None),
                     shard_elems=64 * 128,
                     max_halo_elems=(fb.hlen - 1) * 128)


def test_rowsharded_batched_same_schedule():
    """A leading data-parallel batch axis adds no collectives."""
    mesh = pmesh.make_mesh(n_data=2, n_rows=4)
    fb = get_filter_bank("db2")
    nr, nc = 4 * 32, 64
    pred = audit.predict_rowsharded(fb, 2, nr, nc, 4)
    spec = P(pmesh.BATCH_AXIS, ROW_AXIS, None)
    from jax import shard_map
    from pypwt_jax.parallel import spatial
    fwd = shard_map(
        lambda v: spatial._local_wavedec2(v, fb, 2, ROW_AXIS, 4),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    x = _struct(mesh, (4, nr, nc), spec)
    got = audit.audit(fwd, x)
    assert got["stablehlo"]["ppermute"] == pred["fwd_ppermute"]
    assert got["compiled"]["ppermute"] == pred["fwd_ppermute"]
    for k, v in NO_STRAY.items():
        assert got["compiled"][k] == v


# ---------------------------------------------------------------------------
# Row-sharded SWT: dilated halos, multi-hop when they span shards
# ---------------------------------------------------------------------------

def test_rowsharded_swt_multihop_schedule():
    """Level-3 a-trous dilation (factor 4) makes the db2 halo 8 rows; on
    4-row shards that is a 2-hop gather — the exact ceil(pad/shard) hop
    count must appear in the compiled module."""
    fb = get_filter_bank("db2")
    mesh = _mesh_rows(8)
    nr, nc = 8 * 4, 64  # 4-row shards force multi-hop at level 3
    pred = audit.predict_rowsharded(fb, 3, nr, nc, 8, swt=True)
    # levels 1..3: lpad=(1,2,4), rpad=(2,4,8) on 4-row shards ->
    # per-plane hops (1+1), (1+1), (1+2); x2 planes
    assert pred["fwd_ppermute"] == 2 * (2 + 2 + 3), pred
    fwd, inv = audit.rowsharded_fns(fb, 3, mesh, swt=True)
    x = _struct(mesh, (nr, nc), P(ROW_AXIS, None))
    # far hops of a multi-hop gather legitimately relay full shards
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS, None),
                     shard_elems=4 * 64 + 1, max_halo_elems=4 * 64)


def test_rowsharded_swt_singlehop_schedule():
    fb = get_filter_bank("db2")
    mesh = _mesh_rows(8)
    nr, nc = 8 * 32, 64
    pred = audit.predict_rowsharded(fb, 2, nr, nc, 8, swt=True)
    fwd, inv = audit.rowsharded_fns(fb, 2, mesh, swt=True)
    x = _struct(mesh, (nr, nc), P(ROW_AXIS, None))
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS, None),
                     shard_elems=32 * 64, max_halo_elems=8 * 64)


# ---------------------------------------------------------------------------
# Grid-sharded and seq-sharded paths
# ---------------------------------------------------------------------------

def test_gridsharded_schedule():
    fb = get_filter_bank("db2")
    mesh = pmesh.make_mesh2d(4, 2)
    nr, nc = 4 * 32, 2 * 64
    pred = audit.predict_gridsharded(fb, 2, nr, nc, 4, 2)
    # per level: 1 col exchange (2 hops) + 2 row exchanges (2 hops each)
    assert pred["fwd_ppermute"] == 2 * (2 + 4), pred
    fwd, inv = audit.gridsharded_fns(fb, 2, mesh)
    x = _struct(mesh, (nr, nc), P(ROW_AXIS, pmesh.COL_AXIS))
    _assert_schedule(fwd, inv, x, pred, mesh,
                     P(ROW_AXIS, pmesh.COL_AXIS),
                     shard_elems=32 * 64, max_halo_elems=2 * 64)


def test_gridsharded_swt_schedule():
    """Grid-sharded a-trous: per level 1 undecimated col exchange + 2 row
    exchanges forward (halo dilates 2^(level-1)), 4 row + 2 col plane
    exchanges on the synthesis."""
    fb = get_filter_bank("db2")
    mesh = pmesh.make_mesh2d(4, 2)
    nr, nc = 4 * 32, 2 * 64
    pred = audit.predict_gridsharded_swt(fb, 2, nr, nc, 4, 2)
    # db2 s=2: lpad=(1,2), rpad=(2,4); single-hop on 32/64 shards ->
    # per level (1+1) cols + 2*(1+1) rows = 6 -> 12 over 2 levels
    assert pred["fwd_ppermute"] == 12, pred
    fwd, inv = audit.gridsharded_fns(fb, 2, mesh, swt=True)
    x = _struct(mesh, (nr, nc), P(ROW_AXIS, pmesh.COL_AXIS))
    _assert_schedule(fwd, inv, x, pred, mesh,
                     P(ROW_AXIS, pmesh.COL_AXIS),
                     shard_elems=32 * 64, max_halo_elems=4 * 64)


def test_seqsharded_1d_schedule():
    fb = get_filter_bank("db2")
    mesh = _mesh_rows(8)
    n = 8 * 4096
    pred = audit.predict_seqsharded(fb, 2, n, 8)
    assert pred["fwd_ppermute"] == 4 and pred["inv_ppermute"] == 8
    fwd, inv = audit.seqsharded_fns(fb, 2, mesh)
    x = _struct(mesh, (n,), P(ROW_AXIS))
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS),
                     shard_elems=4096, max_halo_elems=8)


def test_seqsharded_swt1d_schedule():
    """Seq-sharded a-trous 1D (ShardedWavelets 1D SWT mode): one dilated
    exchange per level forward, two plane exchanges on synthesis."""
    fb = get_filter_bank("db2")
    mesh = _mesh_rows(8)
    n = 8 * 1024
    pred = audit.predict_seqsharded_swt(fb, 3, n, 8)
    assert pred["fwd_ppermute"] == 6 and pred["inv_ppermute"] == 12
    fwd, inv = audit.seqsharded_swt_fns(fb, 3, mesh)
    x = _struct(mesh, (n,), P(ROW_AXIS))
    _assert_schedule(fwd, inv, x, pred, mesh, P(ROW_AXIS),
                     shard_elems=1024, max_halo_elems=8)


# ---------------------------------------------------------------------------
# Batch DP (the north-star tomography config): ZERO collectives.
# Unlike the shard_map paths, this one relies on GSPMD sharding
# propagation, so it is the likeliest place for a compiler change to
# insert an accidental all-gather — the exact regression this file
# exists to catch.
# ---------------------------------------------------------------------------

def test_batch_dp_transform_is_collective_free():
    fb = get_filter_bank("db2")
    mesh = pmesh.make_mesh(n_data=8, n_rows=1)
    spec = P(pmesh.BATCH_AXIS, None, None)
    x = _struct(mesh, (16, 64, 64), spec)

    def denoise(v):
        pyr = _dwt.wavedec2(v, fb, 2)
        pyr = thresh.soft_threshold(pyr, 1.0)
        return _dwt.waverec2(pyr, fb, (16, 64, 64))

    got = audit.audit(denoise, x)
    c = got["compiled"]
    assert c["ppermute"] == 0 and c["all_gather"] == 0, c
    assert c["all_reduce"] == 0 and c["all_to_all"] == 0, c
    # and the output stayed batch-sharded (no silent replication)
    out_sh = jax.jit(denoise).lower(x).compile().output_shardings
    shards = out_sh[0] if isinstance(out_sh, (list, tuple)) else out_sh
    assert not shards.is_fully_replicated


# ---------------------------------------------------------------------------
# Norms: the ONE sanctioned all-reduce
# ---------------------------------------------------------------------------

def test_norm_is_the_only_allreduce():
    fb = get_filter_bank("db2")
    mesh = _mesh_rows(8)
    fwd, _ = audit.rowsharded_fns(fb, 2, mesh)
    x = _struct(mesh, (8 * 32, 64), P(ROW_AXIS, None))
    pyr = jax.eval_shape(fwd, x)
    pyr = jax.tree.map(lambda s: _struct(mesh, s.shape, P(ROW_AXIS, None)),
                       pyr)
    for norm in (thresh.norm1, thresh.norm2sq):
        got = audit.audit(norm, pyr)
        c = got["compiled"]
        assert c["all_reduce"] >= 1, c           # psum over the ring
        assert c["all_gather"] == 0, c           # never a data gather
        assert c["all_to_all"] == 0, c
        assert c["ppermute"] == 0, c


# ---------------------------------------------------------------------------
# Mesh-size independence: same shard geometry, 16 and 32 devices
# ---------------------------------------------------------------------------

def test_schedule_is_mesh_size_independent():
    """tools/audit_collectives.py keeps the per-shard geometry fixed and
    grows the ring; every count must equal the 8-device schedule (this is
    the linear-scaling argument made falsifiable)."""
    base = {}
    for row in _run_audit_tool(8):
        base[row["path"]] = row
        assert row["ok"], row
    for dev in (16, 32):
        for row in _run_audit_tool(dev):
            assert row["ok"], row
            b = base[row["path"]]
            assert row["lowered_ppermute"] == b["lowered_ppermute"], (
                dev, row["path"], row, b)
            assert row["compiled_ppermute"] == b["compiled_ppermute"]
            assert row["fwd_halo_bytes_per_chip"] == \
                b["fwd_halo_bytes_per_chip"]


def _run_audit_tool(devices):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices}")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "audit_collectives.py"),
         "--devices", str(devices), "--fast"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(l) for l in out.stdout.splitlines()
            if l.startswith("{")]

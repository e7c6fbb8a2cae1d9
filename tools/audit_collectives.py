#!/usr/bin/env python
"""Collective-schedule audit over a simulated mesh of N devices.

Lowers AND compiles the sharded transforms on an N-device CPU mesh with
FIXED per-shard geometry, extracts the collective schedule from the
compiled HLO (parallel/audit.py), and checks it against the analytic
prediction: ring-neighbor ppermutes only, counts and per-device halo
bytes independent of N — the falsifiable form of the scaling claim.  This
is an HLO audit, NOT a timing measurement: CPU host-platform "devices"
share one socket, so any simulated-mesh *timing* is non-evidence for
scaling.

Emits one JSON row per path; exits non-zero if any schedule deviates.

Usage: python tools/audit_collectives.py [--devices N] [--fast] [--out F]
"""

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--fast", action="store_true",
                    help="forward-only core paths (used by the test)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    # must precede backend creation
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags +
            f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), os.pardir))

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pypwt_jax.filters import get_filter_bank
    from pypwt_jax.core import dwt as _dwt
    from pypwt_jax.parallel import audit, mesh as pmesh
    from pypwt_jax.parallel.mesh import COL_AXIS, ROW_AXIS

    D = args.devices
    assert len(jax.devices()) >= D, (len(jax.devices()), D)
    rows, bad = [], []

    def struct(mesh, shape, spec):
        return jax.ShapeDtypeStruct(shape, jnp.float32,
                                    sharding=NamedSharding(mesh, spec))

    def check(path, fwd_fn, x, pred_fwd, inv_fn=None, pyr_spec=None,
              mesh=None, halo_bytes=None):
        a = audit.audit(fwd_fn, x)
        row = {"path": path, "devices": D,
               "predicted_ppermute": pred_fwd,
               "lowered_ppermute": a["stablehlo"]["ppermute"],
               "compiled_ppermute": a["compiled"]["ppermute"],
               "all_gather": a["compiled"]["all_gather"],
               "all_reduce": a["compiled"]["all_reduce"],
               "all_to_all": a["compiled"]["all_to_all"],
               "fwd_halo_bytes_per_chip": halo_bytes,
               "evidence": ("hlo-audit on cpu-simulated mesh; "
                            "not a timing measurement")}
        row["ok"] = (row["lowered_ppermute"] == pred_fwd
                     and row["compiled_ppermute"] == pred_fwd
                     and row["all_gather"] == 0
                     and row["all_reduce"] == 0
                     and row["all_to_all"] == 0)
        rows.append(row)
        if not row["ok"]:
            bad.append(path)
        print(json.dumps(row), flush=True)
        if inv_fn is not None:
            pyr = jax.eval_shape(fwd_fn, x)
            pyr = jax.tree.map(
                lambda s: struct(mesh, s.shape, pyr_spec), pyr)
            return pyr

    SHARD_R, NC = 32, 64  # per-shard geometry held fixed across D
    fb = get_filter_bank("db2")
    mesh = pmesh.make_mesh(n_data=1, n_rows=D)
    rspec = P(ROW_AXIS, None)

    # row-sharded DWT, jnp routing, forward + inverse
    pred = audit.predict_rowsharded(fb, 2, SHARD_R * D, NC, D)
    fwd, inv = audit.rowsharded_fns(fb, 2, mesh)
    x = struct(mesh, (SHARD_R * D, NC), rspec)
    pyr = check("row_dwt_db2_L2_jnp", fwd, x, pred["fwd_ppermute"],
                inv_fn=inv, pyr_spec=rspec, mesh=mesh,
                halo_bytes=pred["fwd_halo_bytes"])
    check("row_idwt_db2_L2_jnp", inv, pyr, pred["inv_ppermute"])

    # row-sharded SWT (single-hop geometry)
    pred = audit.predict_rowsharded(fb, 2, SHARD_R * D, NC, D, swt=True)
    sfwd, _ = audit.rowsharded_fns(fb, 2, mesh, swt=True)
    check("row_swt_db2_L2_jnp", sfwd, x, pred["fwd_ppermute"],
          halo_bytes=pred["fwd_halo_bytes"])

    # grid-sharded (2 x D/2), per-shard (32, 64)
    if D % 2 == 0:
        gmesh = pmesh.make_mesh2d(2, D // 2)
        nr, nc = 2 * SHARD_R, (D // 2) * NC
        gpred = audit.predict_gridsharded(fb, 2, nr, nc, 2, D // 2)
        gfwd, _ = audit.gridsharded_fns(fb, 2, gmesh)
        gx = struct(gmesh, (nr, nc), P(ROW_AXIS, COL_AXIS))
        check("grid_dwt_db2_L2", gfwd, gx, gpred["fwd_ppermute"])

        # grid-sharded stationary transform (a-trous halos on both rings)
        wpred = audit.predict_gridsharded_swt(fb, 2, nr, nc, 2, D // 2)
        wfwd, _ = audit.gridsharded_fns(fb, 2, gmesh, swt=True)
        check("grid_swt_db2_L2", wfwd, gx, wpred["fwd_ppermute"])

    # batch DP (the north-star tomography config): the per-device program
    # must contain ZERO collectives — linear scaling by construction.
    # This path uses GSPMD propagation (not shard_map), so it is the
    # likeliest place for a compiler change to insert an all-gather.
    bmesh = pmesh.make_mesh(n_data=D, n_rows=1, devices=jax.devices()[:D])
    bspec = P(pmesh.BATCH_AXIS, None, None)
    bx = struct(bmesh, (2 * D, SHARD_R, NC), bspec)
    check("batch_dp_dwt_db2_L2", lambda v: _dwt.wavedec2(v, fb, 2),
          bx, 0, halo_bytes=0)

    # seq-sharded 1D, local 4096 samples
    spred = audit.predict_seqsharded(fb, 2, 4096 * D, D)
    qfwd, _ = audit.seqsharded_fns(fb, 2, mesh)
    qx = struct(mesh, (4096 * D,), P(ROW_AXIS))
    check("seq_dwt1d_db2_L2", qfwd, qx, spred["fwd_ppermute"])

    if not args.fast:
        # multi-hop deep SWT on narrow shards
        nmesh = pmesh.make_mesh(n_data=1, n_rows=D)
        npred = audit.predict_rowsharded(fb, 3, 4 * D, NC, D, swt=True)
        nfwd, _ = audit.rowsharded_fns(fb, 3, nmesh, swt=True)
        nx = struct(nmesh, (4 * D, NC), rspec)
        check("row_swt_db2_L3_multihop", nfwd, nx,
              npred["fwd_ppermute"], halo_bytes=npred["fwd_halo_bytes"])

    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")

    print(f"{len(rows)} paths audited on {D} simulated devices; "
          f"{len(bad)} deviations", file=sys.stderr)
    if bad:
        print(f"SCHEDULE DEVIATIONS: {bad}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()

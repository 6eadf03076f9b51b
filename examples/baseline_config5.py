"""BASELINE config 5: 512^3 volume, 1024 views, angle-sharded
(replaces the reference's cgls_mpi/sirt_mpi, ``recon/cgls_mpi.py``).

Two modes:

--mode single (default): 512^3/1024-view record on one device — data
  gen through the slab forward, CGLS iterations, throughput in proj/s
  (``chip_smoke.py --four-gpus`` checks the 4-card sharded operators
  against this single-card path).

--mode cpu-mesh: build the angle-sharded operator AND the
  volume-sharded slab operator at 512^3 SHAPES on an 8-device CPU mesh
  (XLA_FLAGS=--xla_force_host_platform_device_count=8) and run one
  forward+adjoint apply each — evidence the config-5 sharding
  constructs and executes at scale shapes, not just the 16^3 tests.
  View count is kept small (16) for CPU wall-clock; shapes are what
  matter (the per-shard program is identical at any view count).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="single",
                    choices=["single", "cpu-mesh"])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--views", type=int, default=1024)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=2,
                    help="CGLS iterations per device program (progress "
                         "is reported between programs)")
    ap.add_argument("--quad", default="plane", choices=["arc", "plane"])
    ap.add_argument("--prealign", default="none",
                    choices=["none", "cc", "com"],
                    help="single mode: pre-align the jittered views before "
                         "CGLS (cc = reference-style sequential pairwise "
                         "subpixel chain, align_cc.py:27-38; com = "
                         "sinogram first-moment consistency) and record "
                         "the BASELINE north-star 'wall-clock to aligned "
                         "512^3 CGLS recon' (reconstruct with ESTIMATED "
                         "params; 'none' reconstructs with the true "
                         "params — pure throughput)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or (f"docs/convergence/config5_{args.mode}.json")

    if args.mode == "cpu-mesh":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        os.environ["JAX_PLATFORMS"] = "cpu"
        args.views = min(args.views, 16)

    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import slab_projector as sp

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    rng = np.random.default_rng(0)
    phi = np.linspace(0.0, np.pi, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-2, 2, n_proj)
    t[:, 2] = rng.uniform(-2, 2, n_proj)
    views = Views.create(n_proj, phi=phi, t=t)
    rec = {"config": vars(args)}

    if args.mode == "cpu-mesh":
        from tomojax.dist.sharding import (
            make_mesh, make_sharded_operator,
            make_volume_sharded_slab_operator)
        # synthetic volume (512^3 phantom gen on host is minutes; shapes
        # are what this mode proves)
        vol = jnp.asarray(
            rng.standard_normal((n, n, n)).astype(np.float32))
        t0 = time.perf_counter()
        op = make_sharded_operator(geom, views, make_mesh(8, 1),
                                   family="slab_plane")
        y = jax.block_until_ready(op.A(vol))
        rec["angle_sharded_fwd_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bk = jax.block_until_ready(op.AT(y))
        rec["angle_sharded_adj_s"] = time.perf_counter() - t0
        print(f"[angle-sharded 8dev] fwd {rec['angle_sharded_fwd_s']:.1f}s "
              f"adj {rec['angle_sharded_adj_s']:.1f}s "
              f"|y|={float(jnp.abs(y).sum()):.3e}", flush=True)
        t0 = time.perf_counter()
        opv = make_volume_sharded_slab_operator(
            geom, views, make_mesh(2, 4), quad="plane")
        y2 = jax.block_until_ready(opv.A(vol))
        rec["vol_sharded_fwd_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b2 = jax.block_until_ready(opv.AT(y2))
        rec["vol_sharded_adj_s"] = time.perf_counter() - t0
        rel = float(jnp.linalg.norm(y2 - y) / jnp.linalg.norm(y))
        rec["vol_vs_angle_fwd_rel"] = rel
        print(f"[vol-sharded 2x4] fwd {rec['vol_sharded_fwd_s']:.1f}s "
              f"adj {rec['vol_sharded_adj_s']:.1f}s rel-vs-angle {rel:.2e}",
              flush=True)
        assert rel < 1e-5, rel
    else:
        from tomojax.core import phantom
        from tomojax.align.pipeline import _slab_cgls_chunk_progs
        vol = jnp.asarray(phantom.shepp3d(n).astype(np.float32))
        t0 = time.perf_counter()
        proj = sp.project(vol, geom, views, quad=args.quad)
        jax.block_until_ready(proj)
        rec["t_datagen_s"] = time.perf_counter() - t0
        rec["datagen_proj_per_s"] = n_proj / rec["t_datagen_s"]
        print(f"[gen] {n_proj} views in {rec['t_datagen_s']:.1f}s "
              f"({rec['datagen_proj_per_s']:.1f} proj/s incl compile)",
              flush=True)
        views_rec = views
        if args.prealign != "none":
            # estimate per-view (tx, tz) from the jittered sinogram and
            # reconstruct with the ESTIMATE: the recorded total is the
            # BASELINE north-star "wall-clock to aligned 512^3 CGLS
            # recon" (pre-alignment + solver, end to end on one device)
            t0 = time.perf_counter()
            if args.prealign == "com":
                from tomojax.align import com_align
                est = np.asarray(com_align(proj, geom, phi))
                est_tx, est_tz = est[:, 0], est[:, 1]
            else:
                from tomojax.align import cross_correlation_chain
                sino = jnp.asarray(proj).reshape(n_proj, n, n)
                offsets, _ = cross_correlation_chain(sino)
                offsets = np.asarray(offsets)
                # chain offsets are relative to view 0; the mean is a
                # pure gauge/COR component (see scripts/config3_256.py)
                est_tx = offsets[:, 0] - offsets[:, 0].mean()
                est_tz = offsets[:, 1] - offsets[:, 1].mean()
            rec["t_prealign_s"] = time.perf_counter() - t0
            err_tx = est_tx - t[:, 0]
            c, s = np.cos(phi), np.sin(phi)
            A = np.stack([c, s], 1)
            coef, *_ = np.linalg.lstsq(A, err_tx, rcond=None)
            rec["prealign_tx_gc_mean"] = float(
                np.abs(err_tx - A @ coef).mean())
            rec["prealign_tz_gc_mean"] = float(np.abs(
                (est_tz - t[:, 2]) - (est_tz - t[:, 2]).mean()).mean())
            t_est = np.zeros((n_proj, 3), np.float32)
            t_est[:, 0], t_est[:, 2] = est_tx, est_tz
            views_rec = Views.create(n_proj, phi=phi, t=t_est)
            print(f"[{args.prealign}] {rec['t_prealign_s']:.1f}s "
                  f"tx gc-mean {rec['prealign_tx_gc_mean']:.3e} px",
                  flush=True)
        # state-carrying chunked CGLS: each program advances the
        # CGLSState by --chunk iterations and the host loop threads the
        # state through (true conjugacy, no restarts)
        gstruct, scalars = sp.scalar_groups(geom, views_rec)
        init_prog, step_prog = _slab_cgls_chunk_progs(
            geom, args.quad, args.chunk, gstruct, "float32")
        b = proj.reshape(n_proj, -1)
        t0 = time.perf_counter()
        state = init_prog(jnp.zeros(geom.vox_shape, jnp.float32), b,
                          scalars)
        jax.block_until_ready(state.x)
        convs = []
        niter = jnp.int32(args.niter)
        while int(state.k) < args.niter and int(state.stop) == 0:
            state, conv, _ = step_prog(state, b, scalars, niter)
            jax.block_until_ready(state.x)
            convs.append(np.asarray(conv))
            print(f"[cgls] {int(state.k)}/{args.niter} "
                  f"t={time.perf_counter()-t0:.1f}s "
                  f"conv={float(state.conv_prev):.4e}", flush=True)
        x = state.x
        rec["t_cgls_s"] = time.perf_counter() - t0
        if int(state.stop) != 0:
            print(f"[cgls] WARNING: double-reinit quit at k={int(state.k)}"
                  f" (stop={int(state.stop)}) — ran fewer than --niter "
                  "iterations; consider a reinit_tol",
                  flush=True)
        rec["cgls_stop"] = int(state.stop)
        rec["cgls_iters_run"] = int(state.k)
        rec["cgls_conv"] = [float(v) for v in
                            np.concatenate(convs)[:int(state.k)]]
        # CGLS does fwd+adjoint per iteration: proj/s on the fused chain
        # (normalize by iterations actually run, not the budget — the
        # solver can early-stop on the double-reinit guard)
        rec["cgls_proj_per_s"] = (n_proj * int(state.k)
                                  / rec["t_cgls_s"]) if int(state.k) else 0.0
        xn = np.asarray(x, np.float64)
        pn = np.asarray(vol, np.float64)
        rec["vol_rel_l2"] = float(
            np.linalg.norm(xn - pn) / np.linalg.norm(pn))
        if args.prealign != "none":
            # BASELINE north-star: wall-clock to aligned 512^3 CGLS recon
            rec["wall_to_aligned_recon_s"] = (rec["t_prealign_s"]
                                              + rec["t_cgls_s"])
            print(f"[north-star] aligned {n}^3 CGLS recon in "
                  f"{rec['wall_to_aligned_recon_s']:.1f}s "
                  f"({args.prealign} pre-align + {args.niter} CGLS)",
                  flush=True)
        print(f"[done] cgls {rec['t_cgls_s']:.1f}s "
              f"({rec['cgls_proj_per_s']:.1f} proj/s fwd+adj incl "
              f"compile), rel-L2 {rec['vol_rel_l2']:.4f}", flush=True)

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()

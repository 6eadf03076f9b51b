"""BASELINE config 3: 256^3 phantom, random rigid perturbations,
cross-correlation/COM pre-alignment + CGLS reconstruction.

Reference flow: ``align/align_cc.py`` pre-alignment feeding the
``recon/cgls.py`` solver over the ray projector
(``utilities/projection_operators.py:22-76``). Here: COM-consistency
pre-alignment (drift-free; the reference's pairwise CC chain is also
available in tomojax.align.cc) + CGLS on the slab-arc production
operator.

Records pre-align residuals, recon error vs the known phantom, and
wall-clock, into docs/convergence/config3_256.json.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


from tomojax.core.geometry import Geometry, Views
from tomojax.core import phantom, slab_projector as sp
from tomojax.align import com_align
from tomojax.align.pipeline import _slab_recon_prog


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--jitter-px", type=float, default=2.0)
    ap.add_argument("--niter", type=int, default=60)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out",
                    default="docs/convergence/config3_256.json")
    args = ap.parse_args()

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    vol = jnp.asarray(phantom.shepp3d(n).astype(np.float32))
    rng = np.random.default_rng(args.seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    t[:, 2] = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    views_true = Views.create(n_proj, phi=phi, t=t)

    rec = {"config": vars(args)}
    t0 = time.perf_counter()
    # translation-jittered data through the production operator
    proj = sp.project(vol, geom, views_true, quad="arc")
    jax.block_until_ready(proj)
    rec["t_datagen_s"] = time.perf_counter() - t0
    print(f"[gen] {n}^3/{n_proj} views in {rec['t_datagen_s']:.1f}s",
          flush=True)

    # COM pre-alignment (reference: align_cc coarse translation stage)
    t0 = time.perf_counter()
    est = np.asarray(com_align(proj, geom, phi))
    rec["t_prealign_s"] = time.perf_counter() - t0
    err0 = np.abs(np.stack([t[:, 0], t[:, 2]], 1))
    err1 = np.abs(est - np.stack([t[:, 0], t[:, 2]], 1))
    rec["prealign_err_px"] = {
        "before_mean": float(err0.mean()), "before_max": float(err0.max()),
        "after_mean": float(err1.mean()), "after_max": float(err1.max())}
    print(f"[com] |t| err mean {err0.mean():.3f} -> {err1.mean():.3f} px "
          f"(max {err0.max():.3f} -> {err1.max():.3f}) in "
          f"{rec['t_prealign_s']:.1f}s", flush=True)

    # CGLS on the pre-aligned views (production slab-arc kernel)
    t_est = np.zeros((n_proj, 3), np.float32)
    t_est[:, 0] = est[:, 0]
    t_est[:, 2] = est[:, 1]
    views_est = Views.create(n_proj, phi=phi, t=t_est)
    gstruct, scalars = sp.scalar_groups(geom, views_est)
    x = jnp.zeros(geom.vox_shape, jnp.float32)
    t0 = time.perf_counter()
    done = 0
    while done < args.niter:
        nit = min(args.chunk, args.niter - done)
        prog = _slab_recon_prog(geom, "arc", "cgls", nit, False, gstruct,
                                "float32")
        x, rms_arr, n_it = prog(x, proj.reshape(n_proj, -1), scalars)
        done += nit
        jax.block_until_ready(x)
        print(f"[cgls] {done}/{args.niter} t={time.perf_counter()-t0:.1f}s",
              flush=True)
    rec["t_cgls_s"] = time.perf_counter() - t0
    rec["cgls_iters"] = args.niter
    xn = np.asarray(x, np.float64)
    pn = np.asarray(vol, np.float64)
    rec["vol_rel_l2"] = float(np.linalg.norm(xn - pn) / np.linalg.norm(pn))
    # same depth with TRUE parameters: isolates the pre-align residual cost
    gstruct_t, scalars_t = sp.scalar_groups(geom, views_true)
    x2 = jnp.zeros(geom.vox_shape, jnp.float32)
    done = 0
    while done < args.niter:
        nit = min(args.chunk, args.niter - done)
        prog = _slab_recon_prog(geom, "arc", "cgls", nit, False, gstruct_t,
                                "float32")
        x2, _, _ = prog(x2, proj.reshape(n_proj, -1), scalars_t)
        done += nit
    x2n = np.asarray(x2, np.float64)
    rec["vol_rel_l2_true_params"] = float(
        np.linalg.norm(x2n - pn) / np.linalg.norm(pn))
    print(f"[done] vol rel-L2 {rec['vol_rel_l2']:.4f} "
          f"(true-params floor {rec['vol_rel_l2_true_params']:.4f}); "
          f"cgls {rec['t_cgls_s']:.1f}s", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

"""Volume-accuracy floor: how close does deep CGLS get to the phantom
when the rigid parameters are exact?

The north star asks volume rel-L2 < 1e-5 (vs the data-generating
operator's fixed point). The convergence studies stop at ~5e-2 — an
ITERATION-BUDGET artifact, not an operator/accuracy limit (the solvers
run 40-120 iterations per outer; CG on a 64^3/90-view system needs
thousands to squeeze the small singular values). This script runs CGLS
to depth at the TRUE parameters on self-consistent (same-family) data
and records the rel-L2 trajectory: the achievable floor of the recon
stage, separating solver depth from alignment error in the end-to-end
numbers.

Protocol matches the convergence harness (same phantom, jitter, seed);
data and recon both through the slab-arc production operator. f32 operator; CG recurrences in f64 via the solver's dtype arg if
requested.
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
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--jitter-px", type=float, default=2.0)
    ap.add_argument("--jitter-deg", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--niter", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--family", default="slab", choices=["slab", "ray"])
    ap.add_argument("--out", default="docs/convergence/vol_floor.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import phantom
    from tomojax.align.pipeline import align_reconstruct  # noqa: F401 (env)

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    vol = jnp.asarray(phantom.shepp3d(n).astype(np.float32))
    rng = np.random.default_rng(args.seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    amax = np.deg2rad(args.jitter_deg)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    t[:, 2] = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    views = Views.create(n_proj, phi=phi,
                         alpha=rng.uniform(-amax, amax, n_proj),
                         beta=rng.uniform(-amax, amax, n_proj), t=t)

    if args.family == "slab":
        from tomojax.core import slab_projector as sp
        proj = sp.project(vol, geom, views, quad="arc")
        from tomojax.core.operators import TomoOperator
        gstruct, scalars = sp.scalar_groups(geom, views, jnp.float32)
        A = jax.jit(lambda x: sp.project_scalars(
            x.reshape(geom.vox_shape), geom, gstruct, scalars,
            quad="arc").reshape(n_proj, -1))
        AT = jax.jit(lambda b: sp.backproject_scalars(
            b.reshape(n_proj, -1), geom, gstruct, scalars,
            quad="arc").ravel())
        op = TomoOperator(geom=geom, views=views, A=A, AT=AT,
                          family="slab", dtype=jnp.float32)
    else:
        from tomojax.core import projector
        from tomojax.core.operators import make_operator
        proj = projector.project(vol, geom, views)
        op = make_operator(geom, views, family="ray")

    from tomojax.recon import cgls
    b = jnp.asarray(proj).reshape(n_proj, -1)
    x = jnp.zeros(geom.n_vox, jnp.float32)
    ref = np.asarray(vol, np.float64).ravel()
    nrm = np.linalg.norm(ref)
    rec = {"config": vars(args), "iters": [], "rel_l2": []}
    t0 = time.perf_counter()
    done = 0
    while done < args.niter:
        nit = min(args.chunk, args.niter - done)
        r = cgls(op, b, niter=nit, x0=x)
        x = r.x
        done += nit
        rel = float(np.linalg.norm(
            np.asarray(x, np.float64).ravel() - ref) / nrm)
        rec["iters"].append(done)
        rec["rel_l2"].append(rel)
        print(f"iter {done:5d}: rel_l2 {rel:.3e} "
              f"(t={time.perf_counter()-t0:.0f}s)", flush=True)
        with open(args.out + ".partial", "w") as f:
            json.dump(rec, f)
    rec["wall_s"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    try:
        os.remove(args.out + ".partial")
    except OSError:
        pass
    print("wrote", args.out)


if __name__ == "__main__":
    main()

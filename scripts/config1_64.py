"""BASELINE config 1: 64^3 Shepp-Logan, 90 parallel-beam views —
data generation -> CGLS reconstruction (CPU-runnable), recorded.

Reference protocol: `examples/generate_data.py:16-29` (64^3 phantom, 90
views, random rigid jitter, build ProjectionMatrix, proj = A.x) followed
by a CGLS solve (`recon/cgls.py`).  Here the same pipeline runs through
the exact matrix-free ray family (bit-matched to the reference math in
f64 against the independent NumPy oracle, tests/test_projector.py) and
the slab production family, with recon error against the known phantom
and per-stage wall-clock recorded.

Runs on any backend; pass --platform cpu to force CPU (the config's
"CPU-runnable" requirement) or leave unset for the local default.
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
    ap.add_argument("--cgls-iters", type=int, default=50)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--families", nargs="+", default=["ray", "slab"])
    ap.add_argument("--out", default="docs/convergence/config1_64.json")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import phantom
    from tomojax.core.operators import make_operator
    from tomojax.recon.cgls import cgls

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
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

    rec = {"config": vars(args),
           "platform": jax.devices()[0].platform,
           "families": {}}

    for fam in args.families:
        op = make_operator(geom, views, family=fam)
        t0 = time.perf_counter()
        proj = op.A(vol)
        jax.block_until_ready(proj)
        gen_s = time.perf_counter() - t0
        # warm pass: first call pays trace + (remote) compile; the
        # steady-state number is what an outer-loop user sees
        t0 = time.perf_counter()
        jax.block_until_ready(op.A(vol))
        gen_warm_s = time.perf_counter() - t0

        # one jitted program for the whole solve (no per-iteration
        # host work)
        solve = jax.jit(lambda b: cgls(op, b, niter=args.cgls_iters))
        t0 = time.perf_counter()
        res = solve(proj)
        jax.block_until_ready(res.x)
        cgls_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = solve(proj * 1.0000001)
        jax.block_until_ready(res.x)
        cgls_warm_s = time.perf_counter() - t0
        rel = float(np.linalg.norm(np.asarray(res.x, np.float64).ravel()
                                   - np.asarray(vol, np.float64).ravel())
                    / np.linalg.norm(np.asarray(vol, np.float64)))
        rec["families"][fam] = {
            "gen_s": gen_s,
            "gen_proj_per_s": n_proj / gen_s,
            "gen_warm_s": gen_warm_s,
            "gen_warm_proj_per_s": n_proj / gen_warm_s,
            "cgls_s": cgls_s,
            "cgls_warm_s": cgls_warm_s,
            "cgls_iters_run": int(np.asarray(res.n_iter)),
            "recon_rel_l2_vs_phantom": rel,
            "final_rms": float(np.asarray(
                res.rms_error[int(np.asarray(res.n_iter)) - 1])),
        }
        print(f"[{fam}] gen {gen_s:.2f}s ({n_proj/gen_s:.1f} proj/s, warm "
              f"{gen_warm_s:.2f}s = {n_proj/gen_warm_s:.1f} proj/s), "
              f"cgls({args.cgls_iters}) {cgls_s:.1f}s (warm "
              f"{cgls_warm_s:.1f}s), rel-L2 {rel:.4f}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

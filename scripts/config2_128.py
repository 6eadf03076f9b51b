"""BASELINE config 2: 128^3 phantom — SIRT and TV-regularized (FISTA)
reconstruction, recorded.

Reference protocol: `recon/sirt.py` (SIRT with row/col inverse-sum
weights, optional positivity, semi-convergence stop) and
`recon/regularized.py:57-154` (run_fista: forward-backward with the
dual-FISTA TV prox of `utilities/tv_denoise.py:98`).  Here both solvers
are single jitted lax.while_loop programs over the slab production
operator (reference semantics preserved — see tomojax/recon/*.py
docstrings), run on clean and on noisy data.

Records recon error vs the known phantom, solver iterations/stop
reasons, throughput, and wall-clock into
docs/convergence/config2_128.json.
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
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--views", type=int, default=180)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sirt-iters", type=int, default=100)
    ap.add_argument("--fista-iters", type=int, default=60)
    ap.add_argument("--beta-tv", type=float, default=2.0)
    ap.add_argument("--noise", type=float, default=0.01,
                    help="relative Gaussian noise on the noisy variant")
    ap.add_argument("--quad", default="plane", choices=["arc", "plane"])
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default="docs/convergence/config2_128.json")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import phantom
    from tomojax.core.operators import make_operator
    from tomojax.recon.sirt import sirt
    from tomojax.recon.fista_tv import fista_tv

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = jnp.asarray(phantom.shepp3d(n).astype(np.float32))
    phi = np.linspace(0.0, np.pi, n_proj)
    views = Views.create(n_proj, phi=phi)
    fam = "slab" if args.quad == "arc" else "slab_plane"
    op = make_operator(geom, views, family=fam)

    rec = {"config": vars(args),
           "platform": jax.devices()[0].platform, "runs": {}}
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    proj = op.A(vol)
    jax.block_until_ready(proj)
    rec["gen_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    scale = float(jnp.abs(proj).mean())
    noisy = jnp.asarray(np.asarray(proj)
                        + (args.noise * scale
                           * rng.standard_normal(proj.shape)
                           ).astype(np.float32))

    def rel(x):
        return float(np.linalg.norm(np.asarray(x, np.float64).ravel()
                                    - np.asarray(vol, np.float64).ravel())
                     / np.linalg.norm(np.asarray(vol, np.float64)))

    def run(name, fn):
        # whole solve as ONE jitted program (the eager path pays a
        # per-call retrace + per-op dispatches)
        t0 = time.perf_counter()
        res = jax.jit(fn)()
        jax.block_until_ready(res.x)
        wall = time.perf_counter() - t0
        k = int(np.asarray(res.n_iter))
        rec["runs"][name] = {
            "wall_s": wall, "iters_run": k,
            "rel_l2_vs_phantom": rel(res.x),
            "final_rms": float(np.asarray(res.rms_error[max(k - 1, 0)])),
        }
        print(f"[{name}] {wall:.1f}s, {k} iters, "
              f"rel-L2 {rec['runs'][name]['rel_l2_vs_phantom']:.4f}",
              flush=True)

    run("sirt_clean", lambda: sirt(op, proj, niter=args.sirt_iters,
                                   positivity=True))
    run("sirt_noisy", lambda: sirt(op, noisy, niter=args.sirt_iters,
                                   positivity=True))
    run("fista_tv_clean", lambda: fista_tv(op, proj,
                                           niter=args.fista_iters,
                                           hyper=None,
                                           beta_tv=args.beta_tv))
    run("fista_tv_noisy", lambda: fista_tv(op, noisy,
                                           niter=args.fista_iters,
                                           hyper=None,
                                           beta_tv=args.beta_tv))

    rec["total_wall_s"] = time.perf_counter() - t_all
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

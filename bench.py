"""tomojax benchmark — projections/sec for fused forward+adjoint on a GPU.

Prints the card (``nvidia-smi`` name and power limit) on one line, then ONE
JSON line:
  {"metric": ..., "value": N, "unit": "proj/s", "vs_baseline": N,
   "device": {"platform": "gpu", "kind": ..., "count": N}}

The BASELINE north-star metric is "projections/sec at 256³ fwd+adjoint"
(BASELINE.json). The reference publishes no numbers (BASELINE.md) and its
f2py modules cannot be built here (no gfortran), so ``vs_baseline`` uses a
measured stand-in: the vectorized f64 NumPy implementation of the identical
math (tests/oracle.py) measured 0.0036 proj/s for 256³ fwd+adjoint on a
CPU host (179 s fwd + 99 s adjoint per view). Granting the reference's
Fortran inner loops a ~100× speedup over vectorized NumPy gives a generous
0.4 proj/s baseline estimate, which is what we compare against.

A run that finds no GPU fails rather than timing the CPU.

Env overrides: TOMOJAX_BENCH_SIZE (default 256), TOMOJAX_BENCH_VIEWS
(default 32), TOMOJAX_BENCH_REPS (default 3), TOMOJAX_BENCH_FAMILY
(slab_plane default; slab, fast, ray).
"""

import json
import os
import time

import numpy as np

REFERENCE_CPU_PROJ_PER_S = 0.4  # est. reference CSR build+spmv at 256³


def main():
    from tomojax.utils.device import require_gpu, gpu_name_power
    dev = require_gpu()
    print(gpu_name_power(), flush=True)

    import jax
    from jax import lax
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import projector

    n = int(os.environ.get("TOMOJAX_BENCH_SIZE", 256))
    n_proj = int(os.environ.get("TOMOJAX_BENCH_VIEWS", 32))
    reps = int(os.environ.get("TOMOJAX_BENCH_REPS", 3))

    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    rng = np.random.default_rng(0)
    vol = jax.numpy.asarray(rng.random((n, n, n)), dtype=np.float32)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-2, 2, n_proj)
    t[:, 2] = rng.uniform(-2, 2, n_proj)
    # phis span the half-circle (exercises every marching octant)
    views = Views.create(n_proj,
                         phi=np.linspace(0, np.pi, n_proj, endpoint=False),
                         alpha=rng.uniform(-0.017, 0.017, n_proj),
                         beta=rng.uniform(-0.017, 0.017, n_proj), t=t)

    family = os.environ.get("TOMOJAX_BENCH_FAMILY", "slab_plane")
    if family == "fast":
        from tomojax.core import fast_projector as fp
        fwd = lambda v: fp.project(v, geom, views)
        adj = lambda y: fp.backproject(y, geom, views)
    elif family in ("slab", "slab_plane"):
        from tomojax.core import slab_projector as sp
        quad = "arc" if family == "slab" else "plane"
        gstruct, scalars = sp.scalar_groups(geom, views)
        fwd = lambda v: sp.project_scalars(v, geom, gstruct, scalars, quad)
        adj = lambda y: sp.backproject_scalars(y, geom, gstruct, scalars,
                                               quad)
    else:
        fwd = lambda v: projector.project(v, geom, views)
        adj = lambda y: projector.backproject(y, geom.vox_shape,
                                              geom, views)

    # all reps chain inside one device program (a data dependency between
    # iterations), as solvers hold many applies per program
    @jax.jit
    def run(x0):
        def body(x, _):
            back = adj(fwd(x))
            return x0 + 1e-30 * back, None
        out, _ = lax.scan(body, x0, None, length=reps)
        return out

    x = run(vol)
    jax.block_until_ready(x)

    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        x = run(x)
        jax.block_until_ready(x)
        best = min(best, time.perf_counter() - t0)

    proj_per_s = reps * n_proj / best
    print(json.dumps({
        "metric": f"projections/sec, {n}^3 volume fwd+adjoint "
                  f"({n_proj} views, {family} matrix-free projector)",
        "value": proj_per_s,
        "unit": "proj/s",
        "vs_baseline": proj_per_s / REFERENCE_CPU_PROJ_PER_S,
        "device": dev,
    }))


if __name__ == "__main__":
    main()

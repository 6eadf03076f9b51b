"""Pallas-Triton plane-forward kernel against the XLA plane forward, on a GPU.

At BASELINE config 4's shape (256³ volume, 256×256 detector, 90 views over
180°, ±2 px / ±0.5° jitter) this measures, in turns (XLA, kernel, kernel,
XLA):

- the multi-view ``slab_plane`` forward alone;
- one ``slab_plane`` CGLS iteration (forward + XLA-transpose adjoint + the
  CG updates), state carried across iterations;

and prints the per-view rel-L2 of kernel against XLA, each program's
compile time and ``memory_analysis()``, and a forward time per kernel tile
shape. ``--trace DIR`` also records one profiler trace of a CGLS iteration
(kernel route) and one of an LM iteration of the slab alignment, and writes
their device-time summaries to ``DIR/summary.json``.

    python scripts/plane_kernel_ab.py [--size 256] [--views 90] [--trace DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _views(n_proj, seed=0, shift_px=2.0, angle_deg=0.5):
    from tomojax.core.geometry import Views
    rng = np.random.default_rng(seed)
    amax = np.deg2rad(angle_deg)
    alpha = rng.uniform(-amax, amax, n_proj)
    beta = rng.uniform(-amax, amax, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-shift_px, shift_px, n_proj)
    t[:, 2] = rng.uniform(-shift_px, shift_px, n_proj)
    return Views.create(n_proj, phi=np.linspace(0.0, np.pi, n_proj),
                        alpha=alpha, beta=beta, t=t)


@contextlib.contextmanager
def _xla_route():
    """Trace the slab operator with the plane kernel swapped for the XLA
    group forward (only programs traced inside are affected)."""
    from tomojax.core import slab_projector as sp
    orig = sp.forward_group
    sp.forward_group = (lambda vol_or, sc, geom, quad, dtype=None,
                        views_chunk=None: sp._forward_group_xla(
                            vol_or, sc, geom, quad, dtype or sc.dtype,
                            views_chunk))
    try:
        yield
    finally:
        sp.forward_group = orig


def _compile(fn, *args):
    import jax
    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    return c, time.perf_counter() - t0


def _mem(c):
    m = c.memory_analysis()
    if m is None:
        return None
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def _time(fn, arg, reps):
    """Seconds per call of ``x = fn(x)`` over ``reps`` calls, after one
    warm-up call (calls are queued back to back, then synchronized)."""
    import jax
    x = fn(arg)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = fn(x)
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / reps, x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    from tomojax.utils.device import require_gpu, gpu_name_power
    dev = require_gpu()
    print(gpu_name_power(), flush=True)
    print(json.dumps({"device": dev}), flush=True)

    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry
    from tomojax.core import phantom
    from tomojax.core import slab_projector as sp
    from tomojax.core.operators import TomoOperator
    from tomojax.kernels.slab import plane_forward
    from tomojax.recon.cgls import cgls_init, cgls_steps

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    views = _views(n_proj)
    vol = jnp.asarray(phantom.shepp3d(n), jnp.float32)
    gs, scalars = sp.scalar_groups(geom, views)

    def programs():
        """Fresh functions per route: jit caches traces by function, and
        the route is decided when a function is first traced."""
        def fwd(v, sc):
            return sp.project_scalars(v, geom, gs, sc, "plane")

        def op_of(sc):
            return TomoOperator(
                geom=geom, views=None,
                A=lambda x: sp.project_scalars(x, geom, gs, sc, "plane"),
                AT=lambda y: sp.backproject_scalars(y, geom, gs, sc,
                                                    "plane"),
                family="slab_plane", dtype=jnp.float32)

        def init(b, sc):
            return cgls_init(op_of(sc), b)

        def cg_step(state, b, sc):
            st, _, _ = cgls_steps(op_of(sc), b, state, nsteps=1,
                                  niter=1 << 30)
            return st

        return fwd, init, cg_step

    progs, rec = {}, {"size": n, "views": n_proj, "compile_s": {},
                      "memory": {}}
    for route in ("xla", "kernel"):
        ctx = _xla_route() if route == "xla" else contextlib.nullcontext()
        fwd, init, cg_step = programs()
        with ctx:
            cf, tf = _compile(fwd, vol, scalars)
            b = cf(vol, scalars)
            st0 = jax.jit(init)(b, scalars)
            cs, ts = _compile(cg_step, st0, b, scalars)
        progs[route] = (cf, cs, st0, b)
        rec["compile_s"][route] = {"forward": tf, "cgls_step": ts}
        rec["memory"][route] = {"forward": _mem(cf), "cgls_step": _mem(cs)}
        print(json.dumps({route: rec["compile_s"][route],
                          "memory": rec["memory"][route]}), flush=True)

    bx, bk = (np.asarray(progs[r][3]).reshape(n_proj, -1)
              for r in ("xla", "kernel"))
    rel = (np.linalg.norm(bk - bx, axis=1)
           / np.maximum(np.linalg.norm(bx, axis=1), 1e-30))
    rec["parity_rel_l2_per_view_max"] = float(rel.max())
    print(json.dumps({"parity_rel_l2_per_view_max": float(rel.max())}),
          flush=True)

    times = {"forward": {"xla": [], "kernel": []},
             "cgls_iter": {"xla": [], "kernel": []}}
    for route in ("xla", "kernel", "kernel", "xla"):
        cf, cs, st0, b = progs[route]
        tf, _ = _time(lambda _: cf(vol, scalars), None, args.reps)
        ts, _ = _time(lambda s: cs(s, b, scalars), st0, args.reps)
        times["forward"][route].append(tf)
        times["cgls_iter"][route].append(ts)
        print(json.dumps({"turn": route, "forward_s": tf,
                          "cgls_iter_s": ts}), flush=True)
    rec["times_s"] = times

    tiles = {}
    for block in ((32, 32), (16, 64), (64, 32), (64, 64)):
        def kf(v, sc, block=block):
            outs = []
            for (idx, sw, yf, uf), s in zip(gs, sc):
                vo = sp.orient_volume(v, geom, sw, yf)
                outs.append(plane_forward(vo, s[:, sp._PLANE_COLS],
                                          geom.det_shape, block=block))
            return outs
        ck, tc = _compile(kf, vol, scalars)
        tk, _ = _time(lambda _: ck(vol, scalars), None, args.reps)
        tiles[f"{block[0]}x{block[1]}"] = {"forward_s": tk, "compile_s": tc}
        print(json.dumps({"tile": block, "forward_s": tk}), flush=True)
    rec["kernel_tiles"] = tiles

    if args.trace:
        from tomojax.utils.profiling import device_summary
        from tomojax.align.slab_refine import refine_views_slab
        cf, cs, st0, b = progs["kernel"]
        st = cs(st0, b, scalars)
        jax.block_until_ready(st)
        summ = {}
        d_cg = os.path.join(args.trace, "cgls_iter")
        jax.profiler.start_trace(d_cg)
        st = cs(st, b, scalars)
        jax.block_until_ready(st)
        jax.profiler.stop_trace()
        summ["cgls_iter"] = device_summary(d_cg)

        # one LM iteration of the slab alignment on one octant group
        idx = np.asarray(gs[0][0])
        sub = jax.tree.map(lambda a: np.asarray(a)[idx], views)
        meas = sp.project(vol, geom, views, quad="arc")[idx]
        kw = dict(param_set="xzab", max_iter=1,
                  groups=((tuple(range(len(idx))),) + gs[0][1:],))
        r = refine_views_slab(vol, meas, geom, sub, **kw)
        jax.block_until_ready(r.theta6)
        d_lm = os.path.join(args.trace, "lm_iter")
        jax.profiler.start_trace(d_lm)
        t0 = time.perf_counter()
        r = refine_views_slab(vol, meas, geom, sub, **kw)
        jax.block_until_ready(r.theta6)
        lm_s = time.perf_counter() - t0
        jax.profiler.stop_trace()
        summ["lm_iter"] = device_summary(d_lm)
        summ["lm_iter_views"] = int(len(idx))
        summ["lm_iter_wall_s_traced"] = lm_s
        os.makedirs(args.trace, exist_ok=True)
        with open(os.path.join(args.trace, "summary.json"), "w") as f:
            json.dump(summ, f, indent=1)
        print(f"trace summaries in {args.trace}/summary.json", flush=True)

    print(json.dumps(rec))


if __name__ == "__main__":
    main()

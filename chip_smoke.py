"""GPU smoke run of tomojax's main path at BASELINE config 4.

    python chip_smoke.py              # one GPU: config 4, 256³, 90 views
    python chip_smoke.py --four-gpus  # four GPUs: config 5's shape, sharded

One process drives the system the way a user does, through
``tomojax.cli.main``, at BASELINE config 4's full size (256³ Shepp phantom,
256×256 detector, 90 views over 180°, ±2 px tx/tz and ±0.5° α/β jitter,
seed 0):

1. device      — JAX's default devices must be GPUs; prints the card's
                 ``nvidia-smi`` name and power limit;
2. simulate    — ``cli simulate`` with the slab arc family;
3. reconstruct — ``cli reconstruct``: COM pre-align, 40 CGLS iterations
                 on ``slab_plane`` (the Pallas-Triton forward kernel);
4. align       — ``cli align``: COM pre-align, then 2 outer iterations of
                 40 arc CGLS + 12 batched slab-LM iterations (xzab);
5. compare     — the kernel and the operator against the repo's plain
                 references on the GPU, each with its tolerance.

Every phase prints one JSON line (wall and compile seconds, peak device
memory, its results); every comparison prints its value beside its
tolerance. Any failed phase or comparison exits non-zero, and only a run
with none prints the last line ``{"ok": true, "device": {...}}``.

``--four-gpus`` runs only the multi-card paths, at BASELINE config 5's
shape (512³, 1024 views over 180°): 5 CGLS iterations of the angle-sharded
``slab_plane`` operator on a 4-card ``proj`` mesh, and one forward+adjoint
of the volume-sharded slab operator on a (2, 2) mesh, each against the
same work on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# BASELINE config 4 (docs: README "Configurations"; jitter as in the
# convergence records of this configuration)
SIZE, VIEWS = 256, 90
SHIFT_PX, ANGLE_DEG, SEED = 2.0, 0.5, 0
# BASELINE config 5's shape, for --four-gpus
SIZE5, VIEWS5 = 512, 1024


def device_phase(n_cards: int = 1) -> dict:
    """JAX's default devices as a record; SystemExit unless they are at
    least ``n_cards`` GPUs."""
    from tomojax.utils.device import require_gpu
    rec = require_gpu()
    if rec["count"] < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, JAX sees {rec['count']}")
    return rec


class Run:
    """Phase bookkeeping: wall and backend-compile seconds, peak device
    memory, and the comparisons' verdicts."""

    def __init__(self):
        import jax
        self.compile_s = 0.0
        self.failed = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    @contextlib.contextmanager
    def phase(self, name):
        import jax
        rec = {"phase": name}
        t0, c0 = time.perf_counter(), self.compile_s
        yield rec
        rec["wall_s"] = time.perf_counter() - t0
        rec["compile_s"] = self.compile_s - c0
        stats = jax.devices()[0].memory_stats() or {}
        rec["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        print(json.dumps(rec, default=float), flush=True)

    def check(self, name, value, tol, why, ok=None):
        ok = bool(value <= tol) if ok is None else bool(ok)
        print(json.dumps({"check": name, "value": value, "tol": tol,
                          "pass": ok, "why": why}, default=float),
              flush=True)
        if not ok:
            self.failed.append(name)


def _memory(compiled) -> dict | None:
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes") if hasattr(m, k)}


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _per_view_rel(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return (np.linalg.norm(a - b, axis=1)
            / np.maximum(np.linalg.norm(b, axis=1), 1e-30))


def _truth(d) -> dict:
    return {"tx": d["xyz"][:, 0], "tz": d["xyz"][:, 2],
            "alpha": d["alpha"], "beta": d["beta"]}


def xla_plane_forward(vol, geom, views):
    """Plane-quadrature multi-view forward through the XLA group path
    only (the kernel's reference)."""
    import jax.numpy as jnp
    from tomojax.core import slab_projector as sp
    gs, scalars = sp.scalar_groups(geom, views)
    out = jnp.zeros((geom.n_proj, geom.n_det), jnp.float32)
    vol = jnp.asarray(vol, jnp.float32).reshape(geom.vox_shape)
    for (idx, sw, yf, uf), sc in zip(gs, scalars):
        sino = sp._forward_group_xla(sp.orient_volume(vol, geom, sw, yf),
                                     sc, geom, "plane", jnp.float32)
        if uf:
            sino = sino[:, ::-1, :]
        out = out.at[jnp.asarray(idx)].set(sino.reshape(len(idx), -1))
    return out


def one_gpu(run: Run, work: str, size: int, n_views: int):
    import jax
    import jax.numpy as jnp
    from tomojax import cli
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import slab_projector as sp
    from tomojax.core import projector
    from tomojax.align import com_align
    from tomojax.align.gauge import param_errors
    from tomojax.utils import io

    ds = os.path.join(work, "config4.npz")
    with run.phase("simulate") as rec:
        cli.main(["simulate", "--size", str(size), "--views", str(n_views),
                  "--set", "simulate.family=slab",
                  "--set", f"simulate.seed={SEED}",
                  "--set", f"simulate.max_shift_px={SHIFT_PX}",
                  "--set", f"simulate.max_angle_deg={ANGLE_DEG}",
                  "-o", ds])
        d = io.load_dataset(ds)
        rec["projections"] = list(d["projections"].shape)
        rec["finite"] = bool(np.isfinite(d["projections"]).all())
    run.check("simulate.finite", 0.0, 0.0, "projections must be finite",
              ok=rec["finite"])
    phantom = d["phantom"]
    geom = Geometry(n_proj=n_views, vox_shape=phantom.shape,
                    det_shape=d["projections"].shape[1:])
    phi = d["phi"]

    # COM pre-align: the tx/tz estimate both the reconstruct and the
    # align phase start from (same function the CLI calls)
    est = np.asarray(com_align(jnp.asarray(d["projections"]), geom, phi))
    t0 = np.zeros((n_views, 3))
    t0[:, 0], t0[:, 2] = est[:, 0], est[:, 1]
    views_com = Views.create(n_views, phi=phi, t=t0)
    err_com = param_errors(views_com, _truth(d), phi)

    rec_path = os.path.join(work, "recon.npy")
    with run.phase("reconstruct") as rec:
        cli.main(["reconstruct", "-i", ds, "-o", rec_path,
                  "--pre-align", "com",
                  "--set", "solver.method=cgls",
                  "--set", "solver.niter=40",
                  "--set", "solver.family=slab_plane"])
        x_rec = io.load_volume(rec_path)
        rec["rel_l2"] = _rel_l2(x_rec, phantom)
        rec["param_errors_com"] = err_com
    run.check("reconstruct.rel_l2_finite", rec["rel_l2"], 1.0,
              "CGLS on slab_plane must give a finite volume closer to the "
              "phantom than zero", ok=np.isfinite(rec["rel_l2"])
              and rec["rel_l2"] < 1.0)

    al_path = os.path.join(work, "aligned.npy")
    par_path = os.path.join(work, "params.npz")
    with run.phase("align") as rec:
        cli.main(["align", "-i", ds, "-o", al_path,
                  "--params-out", par_path,
                  "--set", "align.family=slab",
                  "--set", "align.refine_method=lm_slab",
                  "--set", "align.param_set=xzab",
                  "--set", "align.pre_align_cc=true",
                  "--set", "align.recon=cgls",
                  "--set", "align.outer_iters=2",
                  "--set", "align.recon_iters=40",
                  "--set", "align.refine_iters=12"])
        x_al = io.load_volume(al_path)
        views_al = io.load_views(par_path)
        err_al = param_errors(views_al, _truth(d), phi)
        rec["rel_l2"] = _rel_l2(x_al, phantom)
        rec["param_errors_before"] = err_com
        rec["param_errors_after"] = err_al
    rel_recon = _rel_l2(x_rec, phantom)
    run.check("align.rel_l2_below_reconstruct", rec["rel_l2"], rel_recon,
              "joint alignment must improve the volume over the COM-only "
              "reconstruction", ok=np.isfinite(rec["rel_l2"])
              and rec["rel_l2"] < rel_recon)
    for p in ("tx", "tz"):
        before = err_com["gauge_corrected"][p]["mean"]
        after = err_al["gauge_corrected"][p]["mean"]
        run.check(f"align.{p}_gauge_corrected_mean_px", after, before,
                  "refinement must reduce the COM pre-align error",
                  ok=after < before)

    with run.phase("programs") as rec:
        # the solver and LM programs the align phase ran, compiled again
        # from their caches with the same static keys
        from tomojax.align import pipeline
        from tomojax.align.slab_refine import _group_prog
        gs, _ = sp.scalar_groups(geom, views_com)
        sds = jax.ShapeDtypeStruct
        f32 = jnp.float32
        vol_s = sds(geom.vox_shape, f32)
        b_s = sds((n_views, geom.n_det), f32)
        sc_s = tuple(sds((len(g[0]), sp.NS), f32) for g in gs)
        mem = {}
        for quad in ("plane", "arc"):
            prog = pipeline._slab_recon_prog(geom, quad, "cgls", 40, True,
                                             gs, "float32", True, 0.0)
            c = prog.lower(vol_s, b_s, sc_s, sds((geom.n_vox,), f32)
                           ).compile()
            mem[f"cgls40_{quad}"] = _memory(c)
        idx, sw, yf, uf = max(gs, key=lambda g: len(g[0]))
        v8 = -(-len(idx) // 8) * 8
        lm = _group_prog(geom, (sw, yf, uf), "float32")
        c = lm.lower(vol_s, sds((v8,) + geom.det_shape, f32),
                     sds((v8, 3), f32), sds((6,), f32), sds((v8, 6), f32),
                     sds((v8, 6), f32), sds((v8, 6), f32), sds((v8,), f32),
                     sds((), jnp.int32)).compile()
        mem[f"lm_group_{v8}views"] = _memory(c)
        rec["memory_analysis"] = mem

    with run.phase("compare") as rec:
        vol = jnp.asarray(phantom, jnp.float32)
        views = io.views_from_dataset(d)
        gs, scalars = sp.scalar_groups(geom, views)

        # (1) Pallas-Triton plane forward vs the XLA plane forward
        fwd = jax.jit(lambda v, sc: sp.project_scalars(v, geom, gs, sc,
                                                       "plane"))
        hlo = fwd.lower(vol, scalars).as_text()
        rec["plane_kernel_in_program"] = "triton" in hlo
        run.check("plane_forward.kernel_compiled_in", 0.0, 0.0,
                  "on a GPU the slab_plane forward must run the "
                  "Pallas-Triton kernel", ok=rec["plane_kernel_in_program"])
        ax = fwd(vol, scalars)
        ref = jax.jit(lambda v: xla_plane_forward(v, geom, views))(vol)
        run.check("plane_forward.kernel_vs_xla_rel_l2_per_view_max",
                  float(_per_view_rel(ax, ref).max()), 1e-5,
                  "same f32 math, summed in another order over 256 slabs")

        # (2) adjoint dot-product identity through the custom_vjp
        rng = np.random.default_rng(1)
        y = jnp.asarray(rng.standard_normal(ax.shape), jnp.float32)
        aty = jax.jit(lambda y, sc: sp.backproject_scalars(
            y, geom, gs, sc, "plane"))(y, scalars)
        axn = np.asarray(ax, np.float64)
        yn = np.asarray(y, np.float64)
        lhs = float(np.vdot(axn, yn))
        rhs = float(np.vdot(np.asarray(vol, np.float64),
                            np.asarray(aty, np.float64)))
        run.check("plane_adjoint.dot_identity",
                  abs(lhs - rhs) / (np.linalg.norm(axn) * np.linalg.norm(yn)),
                  1e-4, "f32 sums over about 1e8 terms")

        # (3) XLA slab-arc forward vs the exact ray family, 8 views
        sel = np.linspace(0, n_views - 1, 8).astype(int)
        views8 = jax.tree.map(lambda a: np.asarray(a)[sel], views)
        g8 = Geometry(n_proj=8, vox_shape=geom.vox_shape,
                      det_shape=geom.det_shape)
        arc = sp.project(vol, g8, views8, quad="arc")
        ray = jax.jit(lambda v: projector.project(v, g8, views8))(vol)
        run.check("arc_vs_ray.rel_l2_per_view_max",
                  float(_per_view_rel(arc, ray).max()), 5e-3,
                  "the slab arc quadrature differs from the exact family "
                  "only through the O(sin jitter) pass-A cross term")

        # (4) exact ray family in f64 on the GPU vs the f64 NumPy oracle
        sys.path.insert(0, ROOT)
        from tests import oracle
        with jax.enable_x64(True):
            n = 32
            r = np.random.default_rng(2)
            v64 = r.random((n, n, n))
            g32 = Geometry(n_proj=4, vox_shape=(n,) * 3, det_shape=(n, n))
            ph = np.array([0.0, 0.7, 1.6, 2.5])
            al = r.uniform(-0.0087, 0.0087, 4)
            be = r.uniform(-0.0087, 0.0087, 4)
            tt = np.zeros((4, 3))
            tt[:, 0] = r.uniform(-2, 2, 4)
            tt[:, 2] = r.uniform(-2, 2, 4)
            worst = 0.0
            for i in range(4):
                got = np.asarray(projector.forward_view(
                    jnp.asarray(v64), g32, ph[i], al[i], be[i],
                    jnp.asarray(tt[i]), jnp.zeros(3), dtype=jnp.float64))
                want = oracle.project_view(v64, g32.det_shape, al[i], be[i],
                                           ph[i], tt[i], np.zeros(3),
                                           g32.step_size)
                worst = max(worst, float(np.abs(got - want).max()
                                         / np.abs(want).max()))
        run.check("ray_f64_vs_oracle.max_abs_rel", worst, 1e-10,
                  "both f64; the CPU tests hold 1e-12")


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def config5(size: int, n_views: int):
    """(geom, views, phantom) at config 5's shape with config 4's jitter."""
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import phantom as ph

    rng = np.random.default_rng(SEED)
    amax = np.deg2rad(ANGLE_DEG)
    t = np.zeros((n_views, 3))
    t[:, 0] = rng.uniform(-SHIFT_PX, SHIFT_PX, n_views)
    t[:, 2] = rng.uniform(-SHIFT_PX, SHIFT_PX, n_views)
    views = Views.create(n_views, phi=np.linspace(0.0, np.pi, n_views),
                         alpha=rng.uniform(-amax, amax, n_views),
                         beta=rng.uniform(-amax, amax, n_views), t=t)
    geom = Geometry(n_proj=n_views, vox_shape=(size,) * 3,
                    det_shape=(size, size))
    return geom, views, jnp.asarray(ph.shepp3d(size), jnp.float32)


def angle_sharded(run: Run, geom, views, vol):
    """5 CGLS iterations of the angle-sharded slab_plane operator on a
    4-card ``proj`` mesh against the same on one card."""
    import jax
    from tomojax.core.operators import make_operator
    from tomojax.dist import make_mesh, make_sharded_operator
    from tomojax import recon

    with run.phase("angle_sharded_cgls") as rec:
        op1 = make_operator(geom, views, family="slab_plane")
        b = jax.jit(op1.A)(vol)
        t0 = time.perf_counter()
        x1 = recon.cgls(op1, b, niter=5).x
        jax.block_until_ready(x1)
        rec["one_card_s"] = time.perf_counter() - t0
        mesh = make_mesh(4, 1, devices=jax.devices()[:4])
        ops = make_sharded_operator(geom, views, mesh, family="slab_plane")
        t0 = time.perf_counter()
        x4 = recon.cgls(ops, b, niter=5).x
        jax.block_until_ready(x4)
        rec["four_cards_s"] = time.perf_counter() - t0
        rec["rel_l2_vs_one_card"] = _rel_l2(x4, x1)
        rec["max_rel_vs_one_card"] = _max_rel(x4, x1)
    run.check("angle_sharded_cgls5.max_rel_vs_one_card",
              rec["max_rel_vs_one_card"], 1e-5,
              "psum over 4 cards sums the adjoint in another order")


def volume_sharded(run: Run, geom, views, vol):
    """One forward+adjoint of the volume-sharded slab operator on a (2, 2)
    mesh against one card."""
    import jax
    import jax.numpy as jnp
    from tomojax.core.operators import make_operator
    from tomojax.dist import make_mesh, make_volume_sharded_slab_operator

    with run.phase("volume_sharded_fwd_adj") as rec:
        op1 = make_operator(geom, views, family="slab_plane")
        y = jnp.asarray(np.random.default_rng(3).standard_normal(
            (geom.n_proj, geom.n_det)), jnp.float32)
        f1 = jax.jit(op1.A)(vol)
        a1 = jax.jit(op1.AT)(y)
        mesh22 = make_mesh(2, 2, devices=jax.devices()[:4])
        opv = make_volume_sharded_slab_operator(geom, views, mesh22,
                                                quad="plane")
        t0 = time.perf_counter()
        f4 = jax.jit(opv.A)(vol)
        a4 = jax.jit(opv.AT)(y)
        jax.block_until_ready((f4, a4))
        rec["four_cards_s"] = time.perf_counter() - t0
        rec["fwd_max_rel"] = _max_rel(f4, f1)
        rec["adj_max_rel"] = _max_rel(a4, a1)
    run.check("volume_sharded.fwd_max_rel_vs_one_card", rec["fwd_max_rel"],
              1e-5, "each shard computes its rows' positions as one card "
              "does and reads the same taps through its halo")
    run.check("volume_sharded.adj_max_rel_vs_one_card", rec["adj_max_rel"],
              1e-5, "psum over the proj axis sums in another order")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card sharded paths (config 5)")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_gpus else 1
    dev = device_phase(n_cards)
    from tomojax.utils.device import gpu_name_power
    print(gpu_name_power(), flush=True)
    print(json.dumps({"phase": "device", **dev}), flush=True)

    run = Run()
    if args.four_gpus:
        case = config5(SIZE5, VIEWS5)
        angle_sharded(run, *case)
        volume_sharded(run, *case)
    else:
        work = os.path.join(ROOT, ".smoke_work")
        os.makedirs(work, exist_ok=True)
        try:
            one_gpu(run, work, SIZE, VIEWS)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if run.failed:
        raise SystemExit(f"failed: {', '.join(run.failed)}")
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()

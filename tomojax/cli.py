"""Command-line entry point: ``python -m tomojax.cli <cmd> [...]``.

Subcommands mirror the reference's three driver scripts:

- ``simulate``    → ``examples/generate_data.py`` (phantom → jittered
  projections → dataset, ``.npz`` or reference-layout ``.h5``)
- ``reconstruct`` → ``examples/mpi_reconstruct.py`` (choice of solver,
  optional device-mesh angle sharding instead of MPI)
- ``align``       → ``examples/align_rigid.py`` (alternating recon ↔
  per-view 6-DoF refinement, checkpointed)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--config", help="ExperimentConfig json", default=None)
    p.add_argument("--size", type=int, default=None, help="cubic volume size")
    p.add_argument("--views", type=int, default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.FIELD=VALUE",
                   help="override any config field, e.g. "
                        "--set align.family=slab --set solver.niter=40 "
                        "(repeatable; typed from the dataclass default)")


def _coerce(value: str, ref):
    """Parse a --set VALUE string to the type of the dataclass default."""
    import json as _json
    if value.lower() in ("none", "null"):
        return None
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes", "on")
    for t in (int, float):
        if isinstance(ref, t):
            return t(value)
    if isinstance(ref, (tuple, list)) or ref is None:
        try:
            v = _json.loads(value)
            return tuple(v) if isinstance(v, list) else v
        except _json.JSONDecodeError:
            return value
    return value


def _load_config(args):
    from tomojax.utils.config import ExperimentConfig
    cfg = (ExperimentConfig.from_json(args.config) if args.config
           else ExperimentConfig())
    if args.size:
        n = args.size
        cfg.geometry.vox_shape = (n, n, n)
        cfg.geometry.det_shape = (n, n)
    if args.views:
        cfg.geometry.n_proj = args.views
    for ov in getattr(args, "overrides", []):
        key, _, value = ov.partition("=")
        section, _, field = key.partition(".")
        if not (value and field and hasattr(cfg, section)):
            sys.exit(f"--set wants SECTION.FIELD=VALUE; got {ov!r}")
        sec = getattr(cfg, section)
        if not hasattr(sec, field):
            sys.exit(f"unknown config field {key!r}")
        setattr(sec, field, _coerce(value, getattr(sec, field)))
    return cfg


def _infer_vox_shape(args, d, nu, nv):
    """Volume shape for a loaded dataset: explicit --vox-shape wins, then the
    stored phantom's shape, then the cubic (nu, nu, nv) guess — with a
    warning, since a real (phantom-free) dataset with a non-cubic volume
    would otherwise get a wrong geometry silently."""
    if getattr(args, "vox_shape", None):
        parts = [int(v) for v in args.vox_shape.split(",")]
        if len(parts) == 1:
            parts = parts * 3
        assert len(parts) == 3, f"--vox-shape wants nx,ny,nz; got {parts}"
        return tuple(parts)
    gt = d.get("phantom")
    if gt is not None:
        return gt.shape
    print(f"warning: no phantom in dataset and no --vox-shape given; "
          f"assuming cubic ({nu}, {nu}, {nv})", file=sys.stderr)
    return (nu, nu, nv)


def cmd_simulate(args):
    import jax.numpy as jnp
    from tomojax.core import phantom as ph
    from tomojax.core.geometry import Views
    from tomojax.core import projector
    from tomojax.utils import io

    cfg = _load_config(args)
    geom = cfg.geometry.build()
    n = geom.vox_shape[0]
    rng = np.random.default_rng(cfg.simulate.seed)
    vol = (ph.shepp3d(geom.vox_shape) if cfg.simulate.phantom == "shepp"
           else ph.arbitrary_phantom(geom.vox_shape, seed=cfg.simulate.seed))

    n_proj = geom.n_proj
    phi = np.linspace(0.0, np.pi, n_proj)
    amax = np.deg2rad(cfg.simulate.max_angle_deg)
    alpha = rng.uniform(-amax, amax, n_proj)
    beta = rng.uniform(-amax, amax, n_proj)
    xyz = np.zeros((n_proj, 3))
    # motion along the beam (y) does not affect parallel projections —
    # jitter x and z only (reference generate_data.py:20-23)
    xyz[:, 0] = rng.uniform(-cfg.simulate.max_shift_px,
                            cfg.simulate.max_shift_px, n_proj)
    xyz[:, 2] = rng.uniform(-cfg.simulate.max_shift_px,
                            cfg.simulate.max_shift_px, n_proj)

    views = Views.create(n_proj, phi=phi, alpha=alpha, beta=beta, t=xyz)
    fam = cfg.simulate.family
    if fam in ("slab", "slab_plane"):
        from tomojax.core import slab_projector as sp
        proj = sp.project(jnp.asarray(vol), geom, views,
                          quad="arc" if fam == "slab" else "plane")
    else:
        proj = projector.project(jnp.asarray(vol), geom, views)
    io.save_dataset(args.output, projections=np.asarray(proj).reshape(
        n_proj, *geom.det_shape), phi=phi, alpha=alpha, beta=beta, xyz=xyz,
        phantom=vol)
    print(f"wrote {args.output}: {n_proj} views of {geom.det_shape}, "
          f"volume {geom.vox_shape}")


def cmd_reconstruct(args):
    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Views
    from tomojax.core.operators import make_operator
    from tomojax.utils import io
    from tomojax import recon

    cfg = _load_config(args)
    d = io.load_dataset(args.input)
    n_proj, nu, nv = d["projections"].shape
    gt = d.get("phantom")
    nx, ny, nz = _infer_vox_shape(args, d, nu, nv)
    from tomojax.core.geometry import Geometry
    geom = Geometry(n_proj=n_proj, vox_shape=(nx, ny, nz),
                    det_shape=(nu, nv))
    views = io.views_from_dataset(d)
    b = jnp.asarray(d["projections"].reshape(n_proj, -1))

    if getattr(args, "pre_align", "none") != "none":
        # BASELINE config 3 flow: consistency pre-alignment then recon,
        # no joint refinement (reference: FFT cross-correlation chain;
        # here the drift-free COM variant, align/cc.py)
        from tomojax.core.geometry import Views as _V
        from tomojax.align import com_align, cross_correlation_chain
        proj3 = jnp.asarray(d["projections"], jnp.float32)
        if args.pre_align == "com":
            est = np.asarray(com_align(proj3, geom, d["phi"]))
        else:
            offsets, _ = cross_correlation_chain(proj3)
            # chain offsets are cumulative content displacements (u, v) =
            # (tx, tz); remove the per-axis mean (volume-shift gauge)
            est = np.asarray(offsets)
            est -= est.mean(axis=0, keepdims=True)
        t0 = np.zeros((n_proj, 3), np.float32)
        t0[:, 0] = est[:, 0]
        t0[:, 2] = est[:, 1]
        # pre-alignment estimates SHIFTS; tilt jitter stays unknown (the
        # reference's pre-align stage likewise only corrects shifts)
        views = _V.create(n_proj, phi=d["phi"], t=t0)
        if "xyz" in d:
            ex = np.abs(t0[:, 0] - d["xyz"][:, 0])
            ez = np.abs(t0[:, 2] - d["xyz"][:, 2])
            print(f"pre-align ({args.pre_align}) residual: "
                  f"tx {ex.mean():.3f}/{ex.max():.3f} px "
                  f"tz {ez.mean():.3f}/{ez.max():.3f} px (mean/max)")

    if args.shard and len(jax.devices()) > 1:
        from tomojax.dist import make_mesh, make_sharded_operator
        mesh = make_mesh()
        op = make_sharded_operator(geom, views, mesh,
                                   family=cfg.solver.family)
        print(f"angle-sharded over {mesh.shape} ({op.family})")
    else:
        op = make_operator(geom, views, family=cfg.solver.family)

    m = cfg.solver.method
    if m == "sirt":
        res = recon.sirt(op, b, niter=cfg.solver.niter,
                         positivity=cfg.solver.positivity, ground_truth=gt)
    elif m == "cgls":
        res = recon.cgls(op, b, niter=cfg.solver.niter, ground_truth=gt)
    elif m == "tikhonov":
        res = recon.tikhonov_gd(op, b, niter=cfg.solver.niter,
                                reg_param=cfg.solver.reg_param,
                                positivity=cfg.solver.positivity,
                                ground_truth=gt)
    elif m == "lasso":
        res = recon.lasso_fista(op, b, niter=cfg.solver.niter,
                                reg_param=cfg.solver.reg_param,
                                ground_truth=gt)
    elif m == "fista_tv":
        res = recon.fista_tv(op, b, niter=cfg.solver.niter,
                             hyper=cfg.solver.hyper,
                             beta_tv=cfg.solver.beta_tv,
                             niter_tv=cfg.solver.niter_tv, ground_truth=gt)
    else:
        sys.exit(f"unknown solver {m}")

    k = int(res.n_iter)
    print(f"{m}: {k} iterations, final rms {float(res.rms_error[k-1]):.5f}")
    io.save_volume(args.output, res.x)
    print(f"wrote {args.output}")


def cmd_align(args):
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.align import align_reconstruct, cross_correlation_chain
    from tomojax.utils import io

    cfg = _load_config(args)
    d = io.load_dataset(args.input)
    n_proj, nu, nv = d["projections"].shape
    gt = d.get("phantom")
    nx, ny, nz = _infer_vox_shape(args, d, nu, nv)
    geom = Geometry(n_proj=n_proj, vox_shape=(nx, ny, nz),
                    det_shape=(nu, nv))
    proj = jnp.asarray(d["projections"], dtype=jnp.float32)

    views0 = Views.create(n_proj, phi=d["phi"])  # phi known, jitter unknown

    if cfg.align.pre_align_cc:
        # center-of-mass consistency pre-alignment: drift-free per-view
        # (tx, tz) (replaces the pairwise CC chain, whose rotation-induced
        # drift can exceed the jitter at coarse angular steps)
        from tomojax.align import com_align
        est = np.asarray(com_align(proj, geom, d["phi"]))
        t0 = np.zeros((n_proj, 3), np.float32)
        t0[:, 0] = est[:, 0]
        t0[:, 2] = est[:, 1]
        views0 = Views.create(n_proj, phi=d["phi"], t=t0)
        print("COM pre-alignment applied "
              f"(mean |t| = {np.abs(est).mean():.2f} px)")

    a = cfg.align
    # phi is unbounded (as in _default_bounds): the mask decides whether phi
    # is refined at all; a 0-width box would silently freeze it even for
    # param_set="xzpab"
    bounds_lo = np.array([-a.bound_trans, -a.bound_trans, -a.bound_trans,
                          -np.inf, -a.bound_angle, -a.bound_angle],
                         np.float32)
    bounds_hi = -bounds_lo
    state = align_reconstruct(
        proj.reshape(n_proj, -1), geom, views0, outer_iters=a.outer_iters,
        recon=a.recon, recon_iters=a.recon_iters, positivity=a.positivity,
        param_set=a.param_set, refine_iters=a.refine_iters,
        family=a.family, refine_method=a.refine_method,
        recon_chunk=a.recon_chunk, refine_chunk=a.refine_chunk,
        accel_period=a.accel_period, moment_period=a.moment_period,
        debias_period=a.debias_period, bounds=(bounds_lo, bounds_hi),
        ground_truth=gt,
        checkpoint_dir=a.checkpoint_dir, verbose=True, progress=True)

    io.save_volume(args.output, state.volume)
    if args.params_out:
        io.save_views(args.params_out, state.views)
    # report recovered vs true parameters when ground truth present
    if "xyz" in d:
        print_param_table(state.views, d)
    print(f"wrote {args.output}")


def print_param_table(views, d, file=None):
    """Per-view recovered-vs-true table — the reference prints this every
    alignment pass (``examples/align_rigid.py:53-59``); it is the main
    debugging surface for convergence work."""
    t = np.asarray(views.t)
    al = np.asarray(views.alpha)
    be = np.asarray(views.beta)
    print("view |   tx (true)      tz (true)    | alpha (true)    "
          "beta (true)", file=file)
    for i in range(t.shape[0]):
        print(f"{i:4d} | {t[i, 0]:+8.4f} ({d['xyz'][i, 0]:+7.4f}) "
              f"{t[i, 2]:+8.4f} ({d['xyz'][i, 2]:+7.4f}) | "
              f"{al[i]:+8.5f} ({d['alpha'][i]:+8.5f}) "
              f"{be[i]:+8.5f} ({d['beta'][i]:+8.5f})", file=file)
    tx_err = np.abs(t[:, 0] - d["xyz"][:, 0])
    tz_err = np.abs(t[:, 2] - d["xyz"][:, 2])
    a_err = np.abs(al - d["alpha"])
    b_err = np.abs(be - d["beta"])
    print(f"param errors (mean/max): tx {tx_err.mean():.5f}/{tx_err.max():.5f}"
          f" tz {tz_err.mean():.5f}/{tz_err.max():.5f}"
          f" alpha {a_err.mean():.6f}/{a_err.max():.6f}"
          f" beta {b_err.mean():.6f}/{b_err.max():.6f}", file=file)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tomojax")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="phantom → jittered projections")
    _add_common(p)
    p.add_argument("--output", "-o", required=True)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("reconstruct", help="iterative reconstruction")
    _add_common(p)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--shard", action="store_true",
                   help="angle-shard over all devices")
    p.add_argument("--pre-align", default="none",
                   choices=["none", "com", "cc"],
                   help="shift pre-alignment before reconstruction "
                        "(BASELINE config 3: com + cgls)")
    p.add_argument("--vox-shape", default=None,
                   help="volume shape 'nx,ny,nz' (required for phantom-free "
                        "datasets with non-cubic volumes)")
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("align", help="joint alignment + reconstruction")
    _add_common(p)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--params-out", default=None,
                   help="also write the recovered per-view parameters "
                        "(phi, alpha, beta, t, cor) to this .npz")
    p.add_argument("--vox-shape", default=None,
                   help="volume shape 'nx,ny,nz' (required for phantom-free "
                        "datasets with non-cubic volumes)")
    p.set_defaults(fn=cmd_align)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

"""Accuracy north-star convergence harness.

Runs the full alternating alignment+reconstruction pipeline to the
reference's depth (its driver runs 35 outer iterations,
``examples/align_rigid.py:27``) with staged refinement — fast-family
SIRT + gradient descent for the bulk iterations, exact-family CGLS +
Levenberg-Marquardt for the polish — and records per-outer-iteration
parameter errors and volume rel-L2 against the known ground truth.

Gauge note (documented for the error tables): the joint problem is
invariant under a rigid motion of the volume. To first order a global
volume shift (dx, dy, dz) and tilt (wx, wy) map exactly onto per-view
parameter offsets

    tx_i ->  tx_i + cos(phi_i) dx + sin(phi_i) dy
    tz_i ->  tz_i + dz
    a_i  ->  a_i  + cos(phi_i) wx + sin(phi_i) wy
    b_i  ->  b_i  - sin(phi_i) wx + cos(phi_i) wy

so the cost cannot distinguish them. The random ground-truth jitter has a
nonzero projection onto this 5-dim gauge subspace (~sigma/sqrt(n_views)),
which raw per-view errors can never beat. The harness therefore reports
both raw errors and errors after removing the best-fit gauge component
(the scientifically meaningful residual).

Usage:
    python examples/convergence_study.py --size 64 --views 90 \
        --outers-fast 8 --outers-exact 30 --out docs/convergence/c64.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


from tomojax.align.gauge import param_errors, vol_error  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--outers-fast", type=int, default=8)
    ap.add_argument("--outers-exact", type=int, default=30)
    ap.add_argument("--recon-iters", type=int, default=40)
    ap.add_argument("--recon-chunk", type=int, default=None,
                    help="solver iterations per device program")
    ap.add_argument("--refine-iters", type=int, default=12)
    ap.add_argument("--refine-chunk", type=int, default=None,
                    help="views per refinement chunk (default: memory "
                         "heuristic; pass n_views to disable chunking "
                         "and minimize distinct compiles)")
    ap.add_argument("--jitter-px", type=float, default=2.0)
    ap.add_argument("--jitter-deg", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param-set", default="xzab")
    ap.add_argument("--recon", default="cgls", choices=["cgls", "sirt"])
    ap.add_argument("--outers-polish", type=int, default=0,
                    help="optional final stage: deep recon + deep LM once "
                         "the parameters are close (running deep recon "
                         "from the start overfits the misalignment — "
                         "semi-convergence)")
    ap.add_argument("--recon-iters-polish", type=int, default=120)
    ap.add_argument("--refine-iters-polish", type=int, default=40)
    ap.add_argument("--outers-cv", type=int, default=0,
                    help="final cross-validated stage: refine each view "
                         "against a reconstruction built WITHOUT its own "
                         "data (split-half) — removes the recon's "
                         "self-absorption bias, the tx/tz fixed-point "
                         "floor of the plain alternation (see "
                         "pipeline.align_reconstruct_cv)")
    ap.add_argument("--cv-folds", type=int, default=2,
                    help="K for the CV stage: each view refined against "
                         "a recon of the other K-1 folds (K=2 halves the "
                         "recon data — underdetermined at 64^3/90v; "
                         "K~10 keeps complement recons near full "
                         "quality; pick K | n_views)")
    ap.add_argument("--outers-debias", type=int, default=0,
                    help="final defect-correction stage: slab solver on "
                         "exact-family-recentered data (removes the "
                         "slab<->exact operator-mismatch bias floor)")
    ap.add_argument("--debias-period", type=int, default=1,
                    help="outers between exact-family defect recomputes")
    ap.add_argument("--data-family", default="ray",
                    choices=["ray", "slab", "slab_plane"],
                    help="projector family for data generation. 'ray' "
                         "(default) is a cross-family protocol (solve "
                         "slab on exact data — needs --outers-debias to "
                         "beat the ~1e-3 mismatch floor); 'slab' is the "
                         "reference's own inverse-crime protocol "
                         "(examples/align_rigid.py refines against data "
                         "from its own projector)")
    ap.add_argument("--fam-exact", default=None,
                    choices=["ray", "slab", "slab_plane"],
                    help="recon family for the exact stage (default: "
                         "slab arc at >=64^3, ray below; slab_plane is "
                         "the cheap bulk choice at 512^3 — refinement "
                         "stays arc via lm_slab regardless)")
    ap.add_argument("--fam-polish", default=None,
                    choices=["ray", "slab", "slab_plane"],
                    help="recon family for the polish stage")
    ap.add_argument("--recon-bulk", default="sirt",
                    choices=["sirt", "cgls"],
                    help="solver for the bulk (fast) stage")
    ap.add_argument("--final-recon-iters", type=int, default=0,
                    help="after all stages: one deep chunked CGLS with "
                         "the final parameter estimates (the headline "
                         "volume; state-carrying chunk programs)")
    ap.add_argument("--refine-bulk", default=None,
                    choices=["lm", "gd_fast", "lm_slab"],
                    help="refinement for the bulk stage (default: lm_slab "
                         "— batched box-LM on the slab family's analytic "
                         "Jacobian — at >=64^3, "
                         "exact-family lm below)")
    ap.add_argument("--refine-polish", default=None,
                    choices=["lm", "lm_slab"],
                    help="refinement for the exact/polish stages "
                         "(default: lm_slab at >=64^3 — one exact-family "
                         "LM program over many views is too slow there — "
                         "exact-family lm below)")
    ap.add_argument("--accel", type=int, default=4,
                    help="Aitken-accelerate the alternation every N "
                         "outers (0 disables; see "
                         "pipeline.aitken_extrapolate)")
    ap.add_argument("--moment-period", type=int, default=1,
                    help="COM first-moment matching vs reprojections "
                         "every N outers (0 disables; kills the smooth "
                         "tx drift quasi-null mode — align.cc."
                         "moment_match)")
    ap.add_argument("--platform", default=None,
                    help="force jax platform (cpu/cuda)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="per-stage checkpoint/resume dir (default: "
                         "<out>.ckpt when --out is set) — multi-hour "
                         "runs resume where they stopped")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    from tomojax.core.geometry import Geometry, Views
    from tomojax.core import phantom, projector
    from tomojax.align.pipeline import align_reconstruct

    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    vol = jnp.asarray(phantom.shepp3d(n).astype(np.float32))
    rng = np.random.default_rng(args.seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    amax = np.deg2rad(args.jitter_deg)
    truth = {
        "tx": rng.uniform(-args.jitter_px, args.jitter_px, n_proj),
        "tz": rng.uniform(-args.jitter_px, args.jitter_px, n_proj),
        "alpha": rng.uniform(-amax, amax, n_proj),
        "beta": rng.uniform(-amax, amax, n_proj),
    }
    t_true = np.zeros((n_proj, 3))
    t_true[:, 0] = truth["tx"]
    t_true[:, 2] = truth["tz"]
    views_true = Views.create(n_proj, phi=phi, alpha=truth["alpha"],
                              beta=truth["beta"], t=t_true)
    # measured data is deterministic in (size, views, jitter, seed):
    # cache it in the checkpoint dir so a resumed run skips the
    # minutes-long exact-family projection
    ckpt_root = args.ckpt_dir or (args.out + ".ckpt" if args.out else None)
    data_name = ("data.npz" if args.data_family == "ray"
                 else f"data_{args.data_family}.npz")
    data_cache = os.path.join(ckpt_root, data_name) if ckpt_root else None
    if data_cache and os.path.exists(data_cache):
        proj_meas = jnp.asarray(np.load(data_cache)["proj"])
        print(f"[gen] loaded cached projections from {data_cache}",
              flush=True)
    else:
        print(f"[gen] projecting {n}^3 phantom, {n_proj} jittered views "
              f"(±{args.jitter_px} px, ±{args.jitter_deg} deg, "
              f"family={args.data_family})", flush=True)
        if args.data_family == "ray":
            proj_meas = projector.project(vol, geom, views_true)
        else:
            from tomojax.core import slab_projector as sp
            quad = "arc" if args.data_family == "slab" else "plane"
            proj_meas = sp.project(vol, geom, views_true, quad=quad)
        jax.block_until_ready(proj_meas)
        if data_cache:
            os.makedirs(ckpt_root, exist_ok=True)
            np.savez_compressed(data_cache, proj=np.asarray(proj_meas))

    record = {"config": vars(args), "iters": []}
    t_start = time.perf_counter()

    def cb(stage):
        def callback(it, views, volume, history):
            e = param_errors(views, truth, phi)
            e["stage"] = stage
            e["outer"] = it
            e["vol_rel_l2"] = vol_error(volume, np.asarray(vol))
            e["recon_rms"] = history["recon_rms"][-1]
            e["wall_s"] = time.perf_counter() - t_start
            record["iters"].append(e)
            gc = e["gauge_corrected"]
            print(f"[{stage}] outer {it:3d} t={e['wall_s']:7.1f}s "
                  f"vol={e['vol_rel_l2']:.2e} "
                  f"tx(raw/gc)={e['raw']['tx']['max']:.2e}/"
                  f"{gc['tx']['max']:.2e} "
                  f"alpha(gc)={gc['alpha']['max']:.2e} "
                  f"beta(gc)={gc['beta']['max']:.2e}", flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out + ".partial", "w") as f:
                    json.dump(record, f, indent=1)
        return callback

    # COM-consistency pre-alignment: drift-free per-view (tx, tz) seed
    from tomojax.align import com_align
    est = np.asarray(com_align(proj_meas, geom, phi))
    t0_init = np.zeros((n_proj, 3), np.float32)
    t0_init[:, 0] = est[:, 0]
    t0_init[:, 2] = est[:, 1]
    views0 = Views.create(n_proj, phi=phi, t=t0_init)
    e0 = param_errors(views0, truth, phi)
    print(f"[com] tx(raw/gc)={e0['raw']['tx']['max']:.2e}/"
          f"{e0['gauge_corrected']['tx']['max']:.2e}", flush=True)

    # recon families by scale: the production slab operator takes over
    # from 64^3 up; below that the exact ray family is fast enough and
    # bit-matches the data-generating operator
    fam_bulk = "slab_plane" if n >= 64 else "ray"
    fam_exact = args.fam_exact or ("slab" if n >= 64 else "ray")
    fam_polish = args.fam_polish or ("slab" if n >= 64 else "ray")
    refine_bulk = args.refine_bulk or ("lm_slab" if n >= 64 else "lm")
    refine_polish = args.refine_polish or ("lm_slab" if n >= 64 else "lm")

    ckpt = ckpt_root

    def stage_ckpt(stage):
        if not ckpt:
            return None
        d = os.path.join(ckpt, stage)
        os.makedirs(d, exist_ok=True)
        return d

    state = None
    if args.outers_fast > 0:
        state = align_reconstruct(
            proj_meas, geom, views0, outer_iters=args.outers_fast,
            checkpoint_dir=stage_ckpt("fast"),
            recon=args.recon_bulk, recon_iters=args.recon_iters,
            recon_chunk=args.recon_chunk,
            refine_chunk=args.refine_chunk,
            param_set=args.param_set, refine_iters=args.refine_iters,
            refine_method=refine_bulk, family=fam_bulk,
            accel_period=args.accel or None,
            moment_period=args.moment_period or None,
            progress=True, callback=cb("fast"))
        views0 = state.views
    if args.outers_exact > 0:
        # polish: exact-consistent recon + Levenberg-Marquardt on exact
        # analytic Jacobians (slab-arc tracks the ray operator
        # iterate-for-iterate at >=128^3)
        state = align_reconstruct(
            proj_meas, geom, views0, outer_iters=args.outers_exact,
            recon=args.recon, recon_iters=args.recon_iters,
            recon_chunk=args.recon_chunk,
            refine_chunk=args.refine_chunk,
            param_set=args.param_set, refine_iters=args.refine_iters,
            refine_method=refine_polish, family=fam_exact, progress=True,
            accel_period=args.accel or None,
            moment_period=args.moment_period or None,
            checkpoint_dir=stage_ckpt("exact"),
            volume0=None if state is None else state.volume,
            callback=cb("exact"))
    if args.outers_polish > 0:
        state = align_reconstruct(
            proj_meas, geom, state.views, outer_iters=args.outers_polish,
            recon=args.recon, recon_iters=args.recon_iters_polish,
            recon_chunk=args.recon_chunk,
            refine_chunk=args.refine_chunk,
            param_set=args.param_set,
            refine_iters=args.refine_iters_polish,
            refine_method=refine_polish, family=fam_polish, progress=True,
            accel_period=args.accel or None,
            moment_period=args.moment_period or None,
            checkpoint_dir=stage_ckpt("polish"),
            volume0=state.volume, callback=cb("polish"))
    if args.outers_cv > 0:
        from tomojax.align.pipeline import align_reconstruct_cv
        state = align_reconstruct_cv(
            proj_meas, geom, state.views, outer_iters=args.outers_cv,
            recon=args.recon, recon_iters=args.recon_iters_polish,
            recon_chunk=args.recon_chunk,
            param_set=args.param_set,
            refine_iters=args.refine_iters_polish,
            moment_period=args.moment_period or None,
            checkpoint_dir=stage_ckpt("cv"), folds=args.cv_folds,
            volume0=state.volume, progress=True, callback=cb("cv"))
    if args.outers_debias > 0:
        # defect-correction stage: slab-family solver/refiner against
        # exact-family-recentered data — removes the slab<->exact operator
        # mismatch bias (~1e-3 in theta; scripts/c64_floor.py) so the
        # cross-family run converges to the exact-consistent fixed point
        state = align_reconstruct(
            proj_meas, geom, state.views, outer_iters=args.outers_debias,
            recon=args.recon, recon_iters=args.recon_iters_polish,
            recon_chunk=args.recon_chunk,
            refine_chunk=args.refine_chunk,
            param_set=args.param_set,
            refine_iters=args.refine_iters_polish,
            refine_method=refine_polish, family=fam_polish, progress=True,
            accel_period=args.accel or None,
            moment_period=args.moment_period or None,
            debias_period=args.debias_period,
            checkpoint_dir=stage_ckpt("debias"),
            volume0=state.volume, callback=cb("debias"))

    if args.final_recon_iters > 0:
        # headline volume: deep state-carrying chunked CGLS at the final
        # parameter estimates on the cheap plane tier, DEFECT-CORRECTED
        # to the data-generating operator's semantics: b_work = b −
        # (P_src − P_plane)(x, θ) re-centers the plane solve onto the
        # fixed point the source operator explains (the raw plane-on-arc
        # mismatch costs ~0.05-0.07 rel-L2 at depth 40 — measured at
        # 32³: plane-on-plane 0.160, plane-on-arc 0.228, debiased
        # 0.179, arc-on-arc 0.192). Two defect rounds (second order).
        from tomojax.core import slab_projector as sp
        from tomojax.align.pipeline import (_slab_cgls_chunk_progs,
                                            _exact_forward)
        t0 = time.perf_counter()
        gstruct, scalars = sp.scalar_groups(geom, state.views)
        chunk = args.recon_chunk or args.final_recon_iters
        init_prog, step_prog = _slab_cgls_chunk_progs(
            geom, "plane", min(chunk, args.final_recon_iters), gstruct,
            "float32")
        b = jnp.asarray(proj_meas, jnp.float32).reshape(n_proj, -1)
        x = (jnp.asarray(state.volume, jnp.float32)
             .reshape(geom.vox_shape))
        rel_l2 = None
        rounds_rel = []
        best = (np.inf, None)
        n_debias = 2 if args.data_family != "slab_plane" else 1
        for round_i in range(n_debias):
            b_work = b
            if args.data_family != "slab_plane" \
                    and bool(jnp.any(x != 0)):
                if args.data_family == "slab":
                    p_src = sp.project(
                        x, geom, state.views,
                        quad="arc").reshape(n_proj, -1)
                else:
                    p_src = _exact_forward(x, geom, state.views,
                                           jnp.float32, 15)
                p_pl = sp.project(
                    x, geom, state.views,
                    quad="plane").reshape(n_proj, -1)
                b_work = b - (p_src - p_pl)
                print(f"[final] defect round {round_i} rel="
                      f"{float(jnp.linalg.norm(p_src - p_pl) / jnp.linalg.norm(b)):.2e}",
                      flush=True)
            st = init_prog(x, b_work, scalars)
            niter = jnp.int32(args.final_recon_iters)
            while int(st.k) < args.final_recon_iters \
                    and int(st.stop) == 0:
                st, _, _ = step_prog(st, b_work, scalars, niter)
                print(f"[final] cgls {int(st.k)}/"
                      f"{args.final_recon_iters} "
                      f"t={time.perf_counter() - t0:.0f}s", flush=True)
            x = st.x.reshape(geom.vox_shape)
            rel_l2 = vol_error(x, np.asarray(vol))
            rounds_rel.append(rel_l2)
            if rel_l2 < best[0]:
                best = (rel_l2, x)
            print(f"[final] round {round_i}: vol rel-L2 {rel_l2:.4f}",
                  flush=True)
        rel_l2, x = best
        record["final_recon"] = {
            "iters": int(st.k), "stop": int(st.stop),
            "debias_rounds": n_debias,
            "rounds_rel_l2": rounds_rel,
            "wall_s": time.perf_counter() - t0,
            "vol_rel_l2": rel_l2,
        }
        state = state._replace(volume=x)
        print(f"[final] deep CGLS vol rel-L2 {rel_l2:.4f} "
              f"({record['final_recon']['wall_s']:.0f}s)", flush=True)

    record["total_wall_s"] = time.perf_counter() - t_start
    final = record["iters"][-1] if record["iters"] else {}
    record["final"] = final
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        try:
            os.remove(args.out + ".partial")
        except OSError:
            pass
        print(f"wrote {args.out}")

    # final per-view table (reference examples/align_rigid.py:53-59)
    from tomojax.cli import print_param_table
    d = {"xyz": t_true, "alpha": truth["alpha"], "beta": truth["beta"]}
    print_param_table(state.views, d)


if __name__ == "__main__":
    main()

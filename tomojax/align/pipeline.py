"""Alternating reconstruction ↔ alignment driver with checkpoint/resume.

Replacement for the reference's flagship driver
``examples/align_rigid.py``: alternate

1. reconstruct with the current per-view rigid estimates (SIRT by default,
   warm-started from the previous outer iteration — the reference's
   ``options['rec']`` warm start, ``align_rigid.py:37-39``), then
2. refine every view's masked 6-DoF parameters against the measured
   projections (``align_rigid.py:40-52``; default mask "xzab" and bounds
   ±3 px / ±0.02 rad as at ``align_rigid.py:46-49``).

Differences by design:

- refinement is a *batched* vmapped Levenberg–Marquardt over all views in
  one compiled program instead of n_proj sequential scipy L-BFGS-B calls;
- each outer iteration checkpoints (volume, per-view θ, history) to disk —
  the reference only warm-starts in memory and ``np.save``s at the very end
  (``mpi_reconstruct.py:70-71``).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from tomojax.core.geometry import Geometry, Views
from tomojax.core.operators import make_operator, TomoOperator
from tomojax.recon import sirt as _sirt, cgls as _cgls
from tomojax.align.refine import PARAM_SETS, refine_views


@functools.lru_cache(maxsize=16)
def _slab_recon_prog(geom: Geometry, quad: str, recon: str, nit: int,
                     positivity: bool, gstruct, dtype_str: str,
                     has_gt: bool = False, reinit_tol: float = 0.0):
    """One jitted solver program per (geometry, octant-group structure).

    The per-view slab scalars enter as *arguments*, so consecutive outer
    iterations of the alternating driver (new θ, same shapes) reuse the
    compiled program — the eager path would rebuild + retrace the whole
    solver every outer.
    With ``has_gt`` the ground-truth volume also enters as an argument
    and the per-iteration metric becomes ‖x−x*‖/‖x*‖ (the reference's
    ``options['ground_truth']`` RMSE, ``sirt.py:47-51``)."""
    from tomojax.core import slab_projector as sp
    dtype = jnp.dtype(dtype_str)

    def run(x0, b, scalars, gt=None):
        def A(x):
            return sp.project_scalars(x, geom, gstruct, scalars, quad,
                                      dtype=dtype)

        def AT(y):
            return sp.backproject_scalars(y, geom, gstruct, scalars, quad,
                                          dtype=dtype)

        op = TomoOperator(geom=geom, views=None, A=A, AT=AT,
                          family="slab" if quad == "arc" else "slab_plane",
                          dtype=dtype)
        if recon == "sirt":
            r = _sirt(op, b, niter=nit, positivity=positivity, x0=x0,
                      ground_truth=gt)
        else:
            r = _cgls(op, b, niter=nit, x0=x0, ground_truth=gt,
                      reinit_tol=reinit_tol)
        return r.x, r.rms_error, r.n_iter

    if has_gt:
        return jax.jit(run)
    return jax.jit(lambda x0, b, scalars: run(x0, b, scalars))


@functools.lru_cache(maxsize=8)
def _slab_cgls_chunk_progs(geom: Geometry, quad: str, nsteps: int,
                           gstruct, dtype_str: str, reinit_tol: float = 0.0,
                           has_gt: bool = False):
    """State-carrying CGLS programs: ``(init, step)``.

    ``step`` advances the full :class:`~tomojax.recon.cgls.CGLSState` by
    ``nsteps`` iterations per program, and the host loop threads the
    state through — true conjugacy across programs, unlike restarting
    :func:`_slab_recon_prog` with ``x0=x`` per chunk. This bounds the
    length of one device program (``recon_chunk``) where a solve should
    report progress or stay under a runtime's limit on one program; the
    reference runs one unbounded serial loop (``cgls.py:26-104`` /
    ``cgls_mpi.py:8``)."""
    from tomojax.core import slab_projector as sp
    from tomojax.recon.cgls import cgls_init, cgls_steps
    dtype = jnp.dtype(dtype_str)

    def make_op(scalars):
        def A(x):
            return sp.project_scalars(x, geom, gstruct, scalars, quad,
                                      dtype=dtype)

        def AT(y):
            return sp.backproject_scalars(y, geom, gstruct, scalars, quad,
                                          dtype=dtype)

        return TomoOperator(geom=geom, views=None, A=A, AT=AT,
                            family="slab" if quad == "arc" else "slab_plane",
                            dtype=dtype)

    def init(x0, b, scalars):
        return cgls_init(make_op(scalars), b, x0)

    def step(state, b, scalars, niter, gt=None):
        # niter is traced (a while_loop bound, not a shape) so deeper
        # runs reuse the same compiled program
        return cgls_steps(make_op(scalars), b, state, nsteps=nsteps,
                          niter=niter, ground_truth=gt, reinit_tol=reinit_tol)

    if has_gt:
        return jax.jit(init), jax.jit(step)
    return jax.jit(init), jax.jit(
        lambda state, b, scalars, niter: step(state, b, scalars, niter))


@functools.lru_cache(maxsize=8)
def _exact_fwd_prog(geom: Geometry, dtype_str: str):
    """Jitted exact-family forward for one view chunk (debias stage)."""
    from tomojax.core import projector
    dtype = jnp.dtype(dtype_str)
    return jax.jit(lambda vol, views: projector.project(vol, geom, views,
                                                        dtype=dtype))


def _exact_forward(volume, geom: Geometry, views: Views, dtype,
                   chunk: int) -> jnp.ndarray:
    """Host-chunked exact ray-family forward ``(n_proj, n_det)``.

    Each chunk of views is its own device program (bounded memory and
    program length at >=64^3 x many views)."""
    n = geom.n_proj
    prog = _exact_fwd_prog(geom, jnp.dtype(dtype).name)
    parts = []
    for i0 in range(0, n, chunk):
        sl = np.arange(i0, min(i0 + chunk, n))
        parts.append(prog(volume, jax.tree.map(lambda a: a[sl], views)))
    return jnp.concatenate(parts).reshape(n, -1)


def _fov_mask(geom: Geometry, margin_u: float, margin_v: float):
    """In-FOV support mask: voxels whose trilinear footprint projects onto
    the detector for EVERY view (x–y radius within the detector half-width
    minus margin; |z| within the v half-height minus margin)."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    x = np.arange(nx, dtype=np.float64) - (nx - 1) / 2.0
    y = np.arange(ny, dtype=np.float64) - (ny - 1) / 2.0
    z = np.arange(nz, dtype=np.float64) - (nz - 1) / 2.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    ru = max(nu / 2.0 - margin_u, 1.0)
    rv = max(nv / 2.0 - margin_v, 1.0)
    m = (r2 <= ru * ru)[:, :, None] & (np.abs(z) <= rv)[None, None, :]
    return m


def _support_mask(geom: Geometry, projections, margin: float = 1.5,
                  thresh_rel: float = 1e-3):
    """Object-support mask for the moment hook, estimated FROM THE DATA.

    The moment identity u_com(P(θ) y) = [R⁻¹ c(y)]_u − tx needs y's mass
    to stay on-detector at every view — a reconstruction absorbs coherent
    misalignment partly as mass in the volume's *corners* (radius up to
    √2·n/2, seen by only some views), which soaks up exactly the moment
    signal the hook measures (measured at 64³: unmasked hook recovery
    0.30 of an injected smooth tx perturbation, ``scripts/hook_probe.py``).
    But a mask that clips the OBJECT's own support is worse: the measured
    data's detector-edge truncation then no longer cancels differentially
    against the synth's identical clipping, leaving a smooth-in-φ bias the
    size of the truncated moments (2.0e-3 px rms at 64³/±2 px — precisely
    the observed tx plateau).  The mask must therefore sit just OUTSIDE
    the object support and well inside the corner radius; both recovery
    (0.97–0.99) and bias (6e-4, decaying with recon depth) are insensitive
    to the exact radius in that window (``scripts/hook_probe2.py``).

    The support half-widths come from the sinogram itself: the per-view
    mass-bearing u/v width is shift-invariant (content moves rigidly by
    −t), so ``max_views(width/2) + margin`` bounds the object's projected
    radius with no knowledge of t or the ground truth.

    :returns: float32 mask ``vox_shape`` (cylinder in x–y, slab in z).
    """
    nu, nv = geom.det_shape
    p = np.abs(np.asarray(projections, np.float64)).reshape(-1, nu, nv)
    pu = p.sum(axis=2)   # (n_proj, nu) mass per u-column
    pv = p.sum(axis=1)
    ru = rv = 1.0
    for prof, nn in ((pu, nu), (pv, nv)):
        t = thresh_rel * prof.max(axis=1, keepdims=True)
        on = prof > t
        idx = np.arange(nn, dtype=np.float64)
        c = (nn - 1) / 2.0
        # widest half-extent over views (shift-invariant width / 2)
        w = np.array([(idx[row].max() - idx[row].min()) / 2.0
                      if row.any() else 0.0 for row in on])
        if prof is pu:
            ru = float(w.max()) + margin
        else:
            rv = float(w.max()) + margin
    nx, ny, nz = geom.vox_shape
    x = np.arange(nx, dtype=np.float64) - (nx - 1) / 2.0
    y = np.arange(ny, dtype=np.float64) - (ny - 1) / 2.0
    z = np.arange(nz, dtype=np.float64) - (nz - 1) / 2.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    m = (r2 <= ru * ru)[:, :, None] & (np.abs(z) <= rv)[None, None, :]
    return m


def _family_synth(volume, geom: Geometry, views: Views, family: str,
                  quad: str, dtype, chunk: int) -> jnp.ndarray:
    """One forward apply of the given family at the current (volume, θ)
    — reprojections for the moment-matching hook, ``(n_proj, n_det)``."""
    if family in ("slab", "slab_plane"):
        from tomojax.core import slab_projector as sp
        return sp.project(volume, geom, views, quad=quad,
                          dtype=dtype).reshape(geom.n_proj, -1)
    if family == "ray":
        return _exact_forward(volume, geom, views, dtype, chunk)
    op = make_operator(geom, views, family=family, dtype=dtype)
    return op.A(volume).reshape(geom.n_proj, -1)


class AlignState(NamedTuple):
    views: Views            # current per-view parameter estimates
    volume: jnp.ndarray     # current reconstruction
    residuals: jnp.ndarray  # (n_proj,) final per-view ½‖r‖² this iteration
    history: dict           # per-outer-iteration metric lists


def _project_out_gauge(dmom, phi):
    """Remove the rigid-gauge component from per-view (Δtx, Δtz) moment
    corrections.

    The joint problem is invariant under a global volume shift: tx picks
    up a {cosφ, sinφ} per-view offset, tz a {const} one (see the gauge
    note in ``examples/convergence_study.py``). The moment measurement
    ``com(synth) − com(meas)`` contains exactly that component whenever
    the reconstruction's center-of-mass has drifted relative to the data
    — a meaningless re-gauging that injects an O(drift) kick into θ every
    outer, which the next refinement must spend its iterations undoing
    (measured: a persistent ~1.6e-2 px tz limit cycle at 64³ that froze
    the tilt refinement and broke Aitken's contraction assumption).
    Projecting the 3-dim gauge out keeps only the physically meaningful
    per-view error signal.

    Jittable (device 2×2 normal-equations solve; phi may be a traced
    per-view estimate when the φ parameter is being refined)."""
    dmom = jnp.asarray(dmom)
    c, s = jnp.cos(jnp.asarray(phi, dmom.dtype)), \
        jnp.sin(jnp.asarray(phi, dmom.dtype))
    A = jnp.stack([c, s], 1)
    # SVD least-squares, not normal equations: with one view (or all phi
    # equal mod pi) the 2x2 Gram matrix is singular and a plain solve
    # would inject NaN into theta; lstsq returns the min-norm solution
    # there and is exact (unbiased) in the regular case
    coef = jnp.linalg.lstsq(A, dmom[:, 0])[0]
    du = dmom[:, 0] - jnp.matmul(A, coef,
                                 precision=jax.lax.Precision.HIGHEST)
    dv = dmom[:, 1] - jnp.mean(dmom[:, 1])
    return jnp.stack([du, dv], 1)


def aitken_extrapolate(th0, th1, th2, lo, hi, mask, gain_cap=100.0):
    """Elementwise Aitken Δ² extrapolation of the alternation map.

    The alternating recon↔refine driver is a fixed-point iteration
    θ_{k+1} = F(θ_k) whose slowest mode (per-view tx, which couples to
    the reconstruction through the in-plane rotation) contracts at
    ~0.99/outer — thousands of outers to 1e-4. Near the fixed point each
    (view, param) converges geometrically, so from three consecutive
    iterates θ_0, θ_1, θ_2 the limit is

        θ* ≈ θ_2 + d1 · r/(1-r),   d1 = θ_2-θ_1, r = d1/d0 (elementwise)

    applied only where the sequence is actually contracting in a
    consistent direction (d1·d0 > 0, |r| < 0.995), with the jump capped
    at ``gain_cap``×|d1| and clipped into the box. The refinement step
    after the jump acts as the safeguard: LM accepts/rejects against the
    true cost, so an over-jump is pulled back at normal LM speed.

    (Anderson-style acceleration of the outer loop; the reference has no
    counterpart — it runs a fixed 35 outers, ``align_rigid.py:27``.)"""
    th0, th1, th2 = (np.asarray(a, np.float64) for a in (th0, th1, th2))
    d0, d1 = th1 - th0, th2 - th1
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(np.abs(d0) > 0, d1 / np.where(d0 == 0, 1.0, d0), 0.0)
    ok = (d1 * d0 > 0) & (np.abs(r) < 0.995) & np.asarray(mask)[None, :]
    # |r| < 0.995 where `ok`, but compute gain safely everywhere (r can
    # be exactly 1 in the masked-out lanes)
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = np.clip(r / np.where(r == 1.0, np.inf, 1.0 - r),
                       -gain_cap, gain_cap)
    out = np.where(ok, th2 + d1 * gain, th2)
    return np.clip(out, np.asarray(lo, np.float64),
                   np.asarray(hi, np.float64))


def _default_bounds(dtype=jnp.float32):
    """The reference's L-BFGS-B box: ±3 px translations, ±0.02 rad angles
    (``align_rigid.py:48``), unconstrained phi (not optimized by default)."""
    lo = jnp.asarray([-3.0, -3.0, -3.0, -jnp.inf, -0.02, -0.02], dtype)
    hi = jnp.asarray([3.0, 3.0, 3.0, jnp.inf, 0.02, 0.02], dtype)
    return lo, hi


def align_reconstruct(projections, geom: Geometry, views0: Views, *,
                      outer_iters: int = 10, recon: str = "sirt",
                      recon_iters: int = 100, positivity: bool = True,
                      recon_chunk: int | None = None,
                      refine_chunk: int | None = None,
                      param_set: str = "xzab", refine_iters: int = 12,
                      refine_method: str = "lm",
                      accel_period: int | None = None,
                      moment_period: int | None = 1,
                      debias_period: int | None = None,
                      debias_chunk: int = 15,
                      bounds=None, ground_truth=None, dtype=jnp.float32,
                      family: str = "ray",
                      reinit_tol: float = 0.0,
                      volume0=None,
                      checkpoint_dir: str | None = None,
                      resume: bool = True, verbose: bool = False,
                      progress: bool = False,
                      callback=None) -> AlignState:
    """Run the alternating alignment+reconstruction loop.

    :param projections: measured (possibly jittered) sinogram
        ``(n_proj, n_det)`` or ``(n_proj, nu, nv)``.
    :param views0: initial per-view parameters (phi from acquisition; zero
        jitter estimates).
    :param recon: "sirt" (reference default) or "cgls".
    :param param_set: which 6-DoF subset to refine (keys of PARAM_SETS).
    :param family: projector family for the reconstruction stage
        ("ray" exact / "fast" multi-pass / "voxel").
    :param refine_method: "lm" — box-constrained Levenberg–Marquardt on the
        exact analytic Jacobian (reference-equivalent; heavy at ≥256³);
        "lm_slab" — batched box-LM on the slab family's analytic Jacobian
        (the production path);
        "gd_fast" — Armijo gradient descent with reverse-mode gradients
        through the fast multi-pass projector.
    :param recon_chunk: host-chunk the reconstruction solver into pieces of
        at most this many iterations (bounds the length of one device
        program).  Chunking is exactly equivalent to an
        unchunked run for BOTH solvers: SIRT is memoryless per iteration
        and CGLS threads its full :class:`~tomojax.recon.cgls.CGLSState`
        across chunks (true conjugacy — pinned by
        ``tests/test_solvers.py``).
    :param refine_chunk: host-chunk the per-view refinement into groups of
        at most this many views (default: an automatic device-memory
        heuristic).  Views are independent, so chunking is exactly
        equivalent to the unchunked batched refinement.
    :param accel_period: if set, apply :func:`aitken_extrapolate` to the
        per-view θ sequence every this many outer iterations (plus a
        one-shot re-centering of box-corner-pinned parameters) — orders
        of magnitude faster convergence of the alternation's slow tx
        mode.  ``None`` (default) disables acceleration (the reference's
        plain alternation).
    :param moment_period: every this many outer iterations, correct the
        per-view (tx, tz) estimates by first-moment (center-of-mass)
        matching against the current reprojection
        (:func:`tomojax.align.cc.moment_match`) — the reconstruction can
        absorb per-view misalignment in everything BUT the sinogram's
        first moments, so this measures the translation error up to
        gauge with no attenuation, collapsing the smooth tx drift mode
        the alternation otherwise contracts at ~0.99/outer. Default 1
        (every outer); ``None`` disables (the reference's plain
        alternation).
    :param debias_period: defect-correction against the exact ray family
        (only meaningful with the slab families).  Every this many outers
        the working data is re-centered to

            b_work = b_meas − (P_exact(x, θ) − P_slab(x, θ))

        at the current (volume, θ), so the *slab-family* solver/refiner
        converge to the fixed point ``P_exact(x*, θ*) = b_meas`` — the
        slab↔exact operator mismatch (rel ~1e-3 per view at 64³ jittered
        geometry) otherwise biases the recovered parameters at the
        few-1e-3 level (measured by ``scripts/c64_floor.py``: slab LM
        started at the truth walks away by ~2e-3 in tz on exact data,
        but stays at ~4e-6 on slab data).  One host-chunked exact-family
        forward per period is the only extra cost; correction error is
        second order in (θ − θ_k, x − x_k).  The classic defect
        correction / inexact-Newton outer loop; the reference has no
        counterpart (it refines against its own data-generating operator
        — an inverse-crime protocol, ``examples/align_rigid.py:40-52``).
    :param debias_chunk: views per exact-family forward program.
    :param reinit_tol: CGLS divergence-guard slack; ``0.0`` keeps the
        reference's strict guard (``cgls.py:60``).
    :param checkpoint_dir: if set, write ``align_ckpt_####.npz`` per outer
        iteration and resume from the latest on restart.
    :returns: final :class:`AlignState`.
    """
    projections = jnp.asarray(projections, dtype).reshape(geom.n_proj, -1)
    mask = PARAM_SETS[param_set]
    if bounds is None:
        lo_off, hi_off = _default_bounds(dtype)
    else:
        lo_off, hi_off = (jnp.asarray(bounds[0], dtype),
                          jnp.asarray(bounds[1], dtype))

    views = views0
    volume = (jnp.zeros(geom.vox_shape, dtype) if volume0 is None
              else jnp.asarray(volume0, dtype).reshape(geom.vox_shape))
    history = {"recon_rms": [], "refine_cost": []}
    start_iter = 0

    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        if resume:
            ckpts = sorted(f for f in os.listdir(checkpoint_dir)
                           if f.startswith("align_ckpt_"))
            if ckpts:
                state = load_checkpoint(os.path.join(checkpoint_dir,
                                                     ckpts[-1]))
                views, volume = state["views"], jnp.asarray(state["volume"],
                                                            dtype)
                history = state["history"]
                start_iter = state["iteration"] + 1

    # bounds are offsets around the *initial* estimates (the reference
    # optimizes offset parameters starting at 0 within the box)
    theta_init = views0.theta6().astype(dtype)

    # slab families → the cached jitted solver program (scalars — and the
    # ground-truth volume, if any — as arguments; see _slab_recon_prog)
    scalar_prog = (family in ("slab", "slab_plane")
                   and recon in ("sirt", "cgls"))
    has_gt = ground_truth is not None
    gt_dev = (jnp.asarray(ground_truth, dtype).reshape(-1)
              if has_gt else None)
    quad = "arc" if family == "slab" else "plane"
    gstruct = None
    refine_gs = None       # frozen octant groups for lm_slab (see below)
    th_hist: list = []     # last 3 θ iterates for aitken_extrapolate
    last_jump = start_iter - 1
    escaped = np.zeros((geom.n_proj, 6), bool)
    t_hb = time.perf_counter()

    def hb(msg):
        if progress or verbose:
            print(f"[pipeline] {msg} (t={time.perf_counter() - t_hb:.0f}s)",
                  flush=True)

    proj_work = projections   # debias stage re-centers this (see below)
    defect_done = -1          # outer index of the last defect recompute
    mom_mask = None           # lazy data-driven moment-hook support mask

    for it in range(start_iter, outer_iters):
        if (debias_period and family in ("slab", "slab_plane")
                and (defect_done < 0 or (it - start_iter) % debias_period
                     == 0)
                and bool(jnp.any(volume != 0))):
            from tomojax.core import slab_projector as sp
            p_exact = _exact_forward(volume, geom, views, dtype,
                                     debias_chunk)
            p_fam = sp.project(volume, geom, views, quad=quad,
                               dtype=dtype).reshape(geom.n_proj, -1)
            d = (p_exact - p_fam).astype(dtype)
            proj_work = projections - d
            defect_done = it
            rel = float(jnp.linalg.norm(d) / jnp.linalg.norm(projections))
            hb(f"outer {it}: debias defect rel={rel:.2e}")
        # host-chunk the solver (recon_chunk) to bound one device
        # program's length; the default is one program per solve
        chunk = recon_chunk or recon_iters
        done = 0
        gt_args = (gt_dev,) if has_gt else ()
        if scalar_prog:
            from tomojax.core import slab_projector as sp
            # freeze group membership across outers (see group_scalars_for)
            res = (sp.group_scalars_for(geom, views, gstruct, dtype)
                   if gstruct is not None else None)
            if res is None:
                gstruct, scalars = sp.scalar_groups(geom, views, dtype)
            else:
                gstruct, scalars = res
            if recon == "cgls" and chunk < recon_iters:
                # state-carrying chunked CGLS: true conjugacy across
                # device programs (a per-chunk _slab_recon_prog restart
                # loses the search-direction history every `chunk`
                # iterations, which at small chunks degrades CGLS to
                # steepest descent)
                from tomojax.recon.cgls import cgls_init, cgls_steps  # noqa: F401
                init_prog, step_prog = _slab_cgls_chunk_progs(
                    geom, quad, chunk, gstruct, jnp.dtype(dtype).name,
                    reinit_tol, has_gt)
                state = init_prog(volume, proj_work, scalars)
                rms = 0.0
                niter_t = jnp.int32(recon_iters)
                while int(state.k) < recon_iters and int(state.stop) == 0:
                    prev_k = int(state.k)
                    state, conv, rms_arr = step_prog(
                        state, proj_work, scalars, niter_t, *gt_args)
                    done = int(state.k)
                    if done > prev_k:
                        rms = float(np.asarray(rms_arr)[done - prev_k - 1])
                    hb(f"outer {it}: recon {done}/{recon_iters}")
                if int(state.stop) != 0:
                    hb(f"outer {it}: CGLS double-reinit quit at "
                       f"k={int(state.k)} (stop={int(state.stop)}) — "
                       "operator inconsistency; consider reinit_tol")
                volume = state.x
            else:
                while done < recon_iters:
                    nit = min(chunk, recon_iters - done)
                    prog = _slab_recon_prog(
                        geom, quad, recon, nit, positivity, gstruct,
                        jnp.dtype(dtype).name, has_gt, reinit_tol)
                    volume, rms_arr, n_it = prog(volume, proj_work,
                                                 scalars, *gt_args)
                    done += nit
                    hb(f"outer {it}: recon {done}/{recon_iters}")
                rms = float(np.asarray(rms_arr)[max(0, int(n_it) - 1)])
        else:
            op = make_operator(geom, views, family=family, dtype=dtype)
            if recon == "cgls":
                # state-carrying chunking for the generic families too:
                # chunked == unchunked (pinned by test_solvers), unlike
                # the former per-chunk cold restart
                from tomojax.recon.cgls import cgls_init, cgls_steps
                state = cgls_init(op, proj_work, x0=volume)
                rms = 0.0
                while int(state.k) < recon_iters and int(state.stop) == 0:
                    prev_k = int(state.k)
                    nit = min(chunk, recon_iters - prev_k)
                    state, conv, rms_arr = cgls_steps(
                        op, proj_work, state, nsteps=nit,
                        niter=recon_iters, ground_truth=ground_truth,
                        reinit_tol=reinit_tol)
                    done = int(state.k)
                    if done > prev_k:
                        rms = float(np.asarray(rms_arr)[done - prev_k - 1])
                    hb(f"outer {it}: recon {done}/{recon_iters}")
                volume = state.x
            elif recon == "sirt":
                while done < recon_iters:
                    nit = min(chunk, recon_iters - done)
                    r = _sirt(op, proj_work, niter=nit,
                              positivity=positivity, x0=volume,
                              ground_truth=ground_truth)
                    volume = r.x
                    done += nit
                    hb(f"outer {it}: recon {done}/{recon_iters}")
                rms = float(np.asarray(r.rms_error)[
                    max(0, int(r.n_iter) - 1)])
            else:
                raise ValueError(f"unknown recon {recon!r}")
        history["recon_rms"].append(rms)

        lo = theta_init + lo_off
        hi = theta_init + hi_off
        if refine_method == "lm_slab":
            from tomojax.core import slab_projector as sp
            from tomojax.align.slab_refine import refine_views_slab
            # view-chunking bounds device memory: the LM program holds
            # ~20 detector-sized fields per view (12 Jacobian passes +
            # the (V, 6, nu, nv) Jacobian + trials), so the bound scales
            # with n_det — NOT n_vox (the volume is shared). 256³/90
            # views is ~470 MB: unchunked, one frozen program.
            n = geom.n_proj
            vchunk = refine_chunk or max(
                1, min(n, (1 << 28) // max(1, 20 * geom.n_det)))

            def lm_refine(vws, quiet=False, persist=False):
                nonlocal refine_gs
                # freeze GLOBAL octant-group membership at the first
                # outer: θ drift would re-shuffle groups → new batch
                # shapes → a fresh compile mid-run
                if refine_gs is None:
                    refine_gs, _ = sp.scalar_groups(geom, vws, dtype)
                if vchunk >= n:
                    out = refine_views_slab(volume, proj_work, geom, vws,
                                            mask=mask, lower=lo, upper=hi,
                                            max_iter=refine_iters,
                                            groups=refine_gs, dtype=dtype)
                    if not quiet:
                        hb(f"outer {it}: refine {n}/{n}")
                    return out
                # chunk WITHIN the frozen octant groups so every chunk is
                # single-octant with a deterministic padded batch shape —
                # arbitrary [i0, i0+vchunk) windows straddle octant
                # boundaries, whose varying split sizes force fresh
                # compiles. Completed chunks persist to a partial
                # checkpoint (persist=True) so an interrupted refinement
                # resumes at the next chunk, not the outer.
                th_out = np.zeros((n, 6))
                cost_out = np.zeros((n,))
                done_mask = np.zeros((n,), bool)
                ppath = (os.path.join(checkpoint_dir,
                                      f"refine_partial_{it:04d}.npz")
                         if persist and checkpoint_dir else None)
                if ppath and os.path.exists(ppath):
                    z = np.load(ppath)
                    th_out, cost_out = z["theta"], z["cost"]
                    done_mask = z["done"]
                    hb(f"outer {it}: refine resuming with "
                       f"{int(done_mask.sum())}/{n} views done")
                done_ct = int(done_mask.sum())
                for idx, sw, yf, uf in refine_gs:
                    idx = np.asarray(idx)
                    for j0 in range(0, len(idx), vchunk):
                        sl = idx[j0:j0 + vchunk]
                        if done_mask[sl].all():
                            continue
                        sub = jax.tree.map(lambda a: a[sl], vws)
                        gch = ((tuple(range(len(sl))), sw, yf, uf),)
                        r = refine_views_slab(
                            volume, proj_work[sl], geom, sub, mask=mask,
                            lower=lo[sl], upper=hi[sl],
                            max_iter=refine_iters, groups=gch,
                            dtype=dtype)
                        th_out[sl] = np.asarray(r.theta6, np.float64)
                        cost_out[sl] = np.asarray(r.cost, np.float64)
                        done_mask[sl] = True
                        done_ct += len(sl)
                        if ppath:
                            np.savez(ppath, theta=th_out, cost=cost_out,
                                     done=done_mask)
                        if not quiet:
                            hb(f"outer {it}: refine {done_ct}/{n}")
                from tomojax.align.refine import RefineResult
                return RefineResult(
                    theta6=jnp.asarray(th_out, dtype),
                    cost=jnp.asarray(cost_out, dtype),
                    n_iter=jnp.full((n,), refine_iters, jnp.int32),
                    converged=jnp.ones((n,), bool))

            ref = lm_refine(views, persist=True)
            if checkpoint_dir:
                pp = os.path.join(checkpoint_dir,
                                  f"refine_partial_{it:04d}.npz")
                if os.path.exists(pp):
                    os.remove(pp)
            if accel_period and (it + 1) % accel_period == 0:
                # flip rescue: a view stuck in a tilt-sign-mirrored local
                # minimum (near-symmetric object ⇒ P(α) ≈ P(-α) at
                # special φ) has an outlier residual LM cannot descend
                # out of. Re-run the batched LM from sign-flipped tilt
                # inits for cost-outlier views; keep the per-view lower
                # cost. One extra compiled-program call per cycle.
                # candidates: every view (a sign-mirrored basin is often
                # NOT a cost outlier — near φ=0/π the mirror residual is
                # within noise of the true basin until the recon
                # sharpens, so outlier gating misses exactly the stuck
                # views); per-view strict cost comparison keeps winners
                # acceptance gate: a TRUE basin escape cuts the per-view
                # cost by orders of magnitude once the recon has any
                # sharpness, while cross-family operator mismatch (ray
                # data, slab refinement; rel ~1e-3) perturbs near-equal
                # basins by O(mismatch²) — strict `c2 < best` flips views
                # on that noise and, iterated, diverges the whole run
                # (measured at 64³: runaway 62→68/90 "improvements" with
                # vol rel-L2 climbing 0.15→0.40). Require a 2% cut.
                flip_rel = 0.02
                cost_np = np.asarray(ref.cost, np.float64)
                bad = np.ones(cost_np.shape, bool)
                if bad.any():
                    th = np.asarray(ref.theta6, np.float64)
                    best = cost_np.copy()
                    n_take = 0
                    lo_np = np.asarray(lo, np.float64)
                    hi_np = np.asarray(hi, np.float64)
                    # each combo re-runs the full batched refinement; at
                    # config-5 scale (n_proj·n_det large) one rescue
                    # refinement costs minutes — restrict to the joint
                    # flip there (single-axis escapes compose over
                    # successive rescue cycles)
                    all_combos = ((4, 5),) if n * geom.n_det > (1 << 26) \
                        else ((4,), (5,), (4, 5))
                    combos = [c for c in all_combos
                              if all(mask[i] for i in c)]
                    for cols in combos:
                        th_alt = th.copy()
                        for col in cols:
                            th_alt[bad, col] = -th_alt[bad, col]
                        th_alt = np.clip(th_alt, lo_np, hi_np)
                        alt = Views.from_theta6(
                            jnp.asarray(th_alt, dtype), cor=views.cor)
                        ref2 = lm_refine(alt, quiet=True)
                        c2 = np.asarray(ref2.cost, np.float64)
                        take = (c2 < best * (1.0 - flip_rel)) & bad
                        if take.any():
                            th[take] = np.asarray(ref2.theta6,
                                                  np.float64)[take]
                            best[take] = c2[take]
                            n_take += int(take.sum())
                    if n_take:
                        hb(f"outer {it}: flip-rescue improved "
                           f"{int((best < cost_np * (1 - flip_rel)).sum())}/"
                           f"{int(bad.sum())} views")
                        ref = ref._replace(
                            theta6=jnp.asarray(th, dtype),
                            cost=jnp.asarray(best, dtype))
            theta = ref.theta6
        elif refine_method == "gd_fast":
            from tomojax.align.refine import gradient_descent_view

            def one(args):
                th, p, c = args
                return gradient_descent_view(volume, p, geom, th, c,
                                             mask=mask,
                                             max_iter=refine_iters,
                                             family="fast", dtype=dtype)

            # host-loop over view chunks: bounds per-execution device time
            # and memory (one giant lax.map program at large scales holds
            # all chunk intermediates)
            n = geom.n_proj
            chunk = refine_chunk or max(
                1, min(n, (1 << 26) // max(1, geom.n_vox * 4)))
            fj = jax.jit(jax.vmap(lambda th, p, c: one((th, p, c))))
            th_all = views.theta6().astype(dtype)
            parts = []
            for i0 in range(0, n, chunk):
                sl = slice(i0, min(i0 + chunk, n))
                parts.append(fj(th_all[sl], proj_work[sl], views.cor[sl]))
            ref = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
            theta = jnp.clip(ref.theta6, lo, hi)
        else:
            # host-loop over view chunks for the same memory reasons as
            # gd_fast (views are independent in refinement)
            n = geom.n_proj
            vchunk = refine_chunk or max(
                1, min(n, (1 << 23) // max(1, geom.n_vox)))
            if vchunk >= n:
                ref = refine_views(volume, proj_work, geom, views,
                                   mask=mask, lower=lo, upper=hi,
                                   max_iter=refine_iters, dtype=dtype)
            else:
                parts = []
                for i0 in range(0, n, vchunk):
                    sl = np.arange(i0, min(i0 + vchunk, n))
                    sub = jax.tree.map(lambda a: a[sl], views)
                    parts.append(refine_views(
                        volume, proj_work[sl], geom, sub, mask=mask,
                        lower=lo[sl] if lo.ndim == 2 else lo,
                        upper=hi[sl] if hi.ndim == 2 else hi,
                        max_iter=refine_iters, dtype=dtype))
                    hb(f"outer {it}: refine {min(i0 + vchunk, n)}/{n}")
                ref = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
            theta = ref.theta6
        views = Views.from_theta6(theta, cor=views.cor)
        cost = float(jnp.sum(ref.cost))
        history["refine_cost"].append(cost)

        if moment_period and (mask[0] or mask[2]) \
                and (it + 1) % moment_period == 0 \
                and bool(jnp.any(volume != 0)):
            # Helgason–Ludwig 1st-moment matching vs the reprojection:
            # measures each view's (tx, tz) error up to gauge regardless
            # of how much misalignment the recon absorbed — the fix for
            # the coherent/smooth tx drift mode the per-view refinement
            # cannot see (see align.cc.moment_match). One forward apply.
            from tomojax.align.cc import moment_match
            # mask to the data-estimated object support: blocks the
            # corner-mass absorption that hides the moment signal while
            # keeping the object's own shell so detector-edge truncation
            # cancels differentially (see _support_mask; the former
            # FOV-margin mask clipped the object and carried a 2e-3 px
            # smooth bias — the round-2/3 tx plateau)
            if mom_mask is None:
                mom_mask = jnp.asarray(
                    _support_mask(geom, np.asarray(projections)), dtype)
            # reuse the SOLVER's frozen octant groups for the synth
            # apply: re-deriving groups per outer re-traces the whole
            # apply program whenever θ drift shuffles a boundary view
            synth = None
            if scalar_prog and gstruct is not None:
                from tomojax.core import slab_projector as sp
                res = sp.group_scalars_for(geom, views, gstruct, dtype)
                if res is not None:
                    g2, sc2 = res
                    prog = sp._public_apply_prog(
                        geom, g2, quad, jnp.dtype(dtype).name, None,
                        False)
                    synth = prog(volume * mom_mask,
                                 sc2).reshape(geom.n_proj, -1)
            if synth is None:
                synth = _family_synth(volume * mom_mask,
                                      geom, views, family, quad,
                                      dtype, debias_chunk)
            dmom = moment_match(proj_work, synth, geom.det_shape)
            dmom = _project_out_gauge(dmom, views.phi)
            th = theta.astype(dmom.dtype)
            if mask[0]:
                th = th.at[:, 0].add(dmom[:, 0])
            if mask[2]:
                th = th.at[:, 2].add(dmom[:, 1])
            th = jnp.clip(th, jnp.asarray(lo, dmom.dtype),
                          jnp.asarray(hi, dmom.dtype))
            theta = th.astype(dtype)
            views = Views.from_theta6(theta, cor=views.cor)
            hb(f"outer {it}: moment match "
               f"|dtx|={float(jnp.abs(dmom[:, 0]).mean()):.2e} "
               f"|dtz|={float(jnp.abs(dmom[:, 1]).mean()):.2e}")

        if accel_period:
            th_hist.append(np.asarray(theta, np.float64))
            if len(th_hist) > 3:
                th_hist.pop(0)
            # never extrapolate on the final outer: the jump is only safe
            # because the NEXT refinement accepts/rejects it against the
            # true cost — a last-outer jump would be recorded unverified
            if (len(th_hist) == 3 and (it - last_jump) >= accel_period
                    and it < outer_iters - 1):
                lo_np, hi_np = np.asarray(lo, np.float64), \
                    np.asarray(hi, np.float64)
                th_acc = aitken_extrapolate(*th_hist, lo_np, hi_np, mask)
                # one-shot corner escape: a masked parameter pinned at
                # its bound (LM pushing outside the box, typically a
                # wrong-side local minimum seeded by an early bad recon)
                # is re-centered once; if it returns to the corner it is
                # left there (it genuinely wants the bound)
                at_edge = ((np.abs(th_acc - lo_np) < 1e-9)
                           | (np.abs(th_acc - hi_np) < 1e-9)) \
                    & np.asarray(mask)[None, :] & ~escaped
                mid = np.asarray(theta_init, np.float64)
                th_acc = np.where(at_edge, mid, th_acc)
                escaped |= at_edge
                njump = int(np.sum(np.abs(
                    th_acc - th_hist[-1]) > 1e-12))
                hb(f"outer {it}: aitken jump on {njump} params "
                   f"({int(at_edge.sum())} corner escapes)")
                views = Views.from_theta6(
                    jnp.asarray(th_acc, dtype), cor=views.cor)
                th_hist.clear()
                last_jump = it

        if verbose:
            print(f"[align] outer {it:3d}: recon rms={rms:.5f} "
                  f"refine cost={cost:.5f}")
        if checkpoint_dir:
            save_checkpoint(
                os.path.join(checkpoint_dir, f"align_ckpt_{it:04d}.npz"),
                views=views, volume=volume, history=history, iteration=it)
        if callback is not None:
            callback(it, views, volume, history)

    # a fully-checkpointed run (start_iter >= outer_iters) never enters
    # the loop, so `ref` does not exist
    residuals = (ref.cost if start_iter < outer_iters
                 else jnp.zeros((geom.n_proj,), dtype))
    return AlignState(views=views, volume=volume, residuals=residuals,
                      history=history)


def frozen_polish(projections, geom: Geometry, views: Views, volume, *,
                  param_set: str = "xzab", refine_iters: int = 60,
                  refine_chunk: int | None = None, bounds=None,
                  theta_ref: Views | None = None, family: str = "ray",
                  moment: bool = True, dtype=jnp.float32) -> AlignState:
    """Pure per-view refinement against a FROZEN reconstruction.

    The plain alternation converges to a self-consistent fixed point in
    which the next refinement is stationary BY CONSTRUCTION — each outer
    re-fits the reconstruction to the current (partially misaligned)
    parameters, so the per-view LM sees a cost minimum at the biased θ
    (the 64³ tx floor at ~1.2e-4 px and the 256³ tx wander around accel
    kicks, docs/STATUS.md r4). This stage breaks the *dynamics* instead:
    the volume is frozen (ideally a deep reconstruction from the best θ
    snapshot, or from tail-averaged θ), and every view runs a DEEP
    box-LM against it with no reconstruction update, no acceleration,
    and one optional final moment-match — so θ lands at the actual
    per-view cost minimum of one fixed operator instead of chasing a
    moving one. With ``family="ray"`` the Jacobian is the exact
    reference-semantics one (``ray_wt_grad.f90:95-223``); ``"slab"``
    uses the production slab-Jacobian LM (the right choice when the data
    was slab-generated, and the only tractable one at ≥256³).

    :returns: AlignState with the (unchanged) frozen volume and
        polished views.
    """
    projections = jnp.asarray(projections, dtype).reshape(geom.n_proj, -1)
    volume = jnp.asarray(volume, dtype).reshape(geom.vox_shape)
    mask = PARAM_SETS[param_set]
    if bounds is None:
        lo_off, hi_off = _default_bounds(dtype)
    else:
        lo_off, hi_off = (jnp.asarray(bounds[0], dtype),
                          jnp.asarray(bounds[1], dtype))
    theta_init = (theta_ref if theta_ref is not None
                  else views).theta6().astype(dtype)
    lo = theta_init + lo_off
    hi = theta_init + hi_off

    n = geom.n_proj
    if family in ("slab", "slab_plane"):
        from tomojax.align.slab_refine import refine_views_slab
        vchunk = refine_chunk or max(
            1, min(n, (1 << 28) // max(1, 20 * geom.n_det)))
        parts = []
        for i0 in range(0, n, vchunk):
            sl = np.arange(i0, min(i0 + vchunk, n))
            sub = jax.tree.map(lambda a: a[sl], views)
            parts.append(refine_views_slab(
                volume, projections[sl], geom, sub, mask=mask,
                lower=lo[sl], upper=hi[sl], max_iter=refine_iters,
                dtype=dtype))
        ref = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
    else:
        vchunk = refine_chunk or max(
            1, min(n, (1 << 23) // max(1, geom.n_vox)))
        parts = []
        for i0 in range(0, n, vchunk):
            sl = np.arange(i0, min(i0 + vchunk, n))
            sub = jax.tree.map(lambda a: a[sl], views)
            parts.append(refine_views(
                volume, projections[sl], geom, sub, mask=mask,
                lower=lo[sl], upper=hi[sl], max_iter=refine_iters,
                dtype=dtype))
        ref = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
    theta = ref.theta6
    views_out = Views.from_theta6(theta, cor=views.cor)

    if moment and (mask[0] or mask[2]):
        from tomojax.align.cc import moment_match
        mom_mask = jnp.asarray(
            _support_mask(geom, np.asarray(projections)), dtype)
        quad = "arc" if family == "slab" else "plane"
        synth = _family_synth(volume * mom_mask, geom, views_out,
                              family, quad, dtype, 15)
        dmom = _project_out_gauge(
            moment_match(projections, synth, geom.det_shape),
            views_out.phi)
        th = theta.astype(dmom.dtype)
        if mask[0]:
            th = th.at[:, 0].add(dmom[:, 0])
        if mask[2]:
            th = th.at[:, 2].add(dmom[:, 1])
        theta = jnp.clip(th, jnp.asarray(lo, dmom.dtype),
                         jnp.asarray(hi, dmom.dtype)).astype(dtype)
        views_out = Views.from_theta6(theta, cor=views.cor)

    return AlignState(views=views_out, volume=volume, residuals=ref.cost,
                      history={"recon_rms": [], "refine_cost":
                               [float(jnp.sum(ref.cost))]})


def align_reconstruct_cv(projections, geom: Geometry, views0: Views, *,
                         outer_iters: int = 10, recon: str = "cgls",
                         recon_iters: int = 120,
                         recon_chunk: int | None = None,
                         param_set: str = "xzab",
                         refine_iters: int = 40,
                         moment_period: int | None = 1,
                         bounds=None, theta_ref: Views | None = None,
                         dtype=jnp.float32,
                         volume0=None,
                         checkpoint_dir: str | None = None,
                         resume: bool = True,
                         folds: int = 2,
                         progress: bool = False,
                         callback=None) -> AlignState:
    """Cross-validated alternation: refine each view against a
    reconstruction built WITHOUT that view's data.

    The plain alternation (:func:`align_reconstruct`) converges to a
    self-consistent fixed point in which the reconstruction has absorbed
    part of every view's residual misalignment — each view's refinement
    is then biased by the recon's fit to its *own* error, and deeper
    recon/refinement cannot move the pair (measured at 64³/90 views:
    tx/tz gauge-corrected means stationary at 1.0–1.5e-4 px across 60
    deep-polish outers while LM against the TRUE volume floors at ~4e-6,
    ``docs/convergence/c64_closing.json``, ``scripts/c64_floor.py``).

    This driver breaks the loop by K-fold cross-validation, the
    estimator analog of out-of-fold prediction: views are split into
    ``folds`` interleaved folds (each still covering the angular range
    uniformly); per outer, each fold's COMPLEMENT (the other K-1 folds'
    data) is reconstructed (warm-started across outers), then the
    fold's views are refined — and moment-matched — against that
    complement reconstruction.  The recon a view is aligned to never
    saw that view's data, so the self-absorption bias term vanishes.

    ``folds`` controls the bias/conditioning trade: with K=2 each
    complement is half the data — at 64³/90 views a 45-view recon is
    underdetermined (45·64² < 64³) and its irreducible null-space
    error (~3.8e-2 rel-L2, ``docs/convergence/c64_cv.json``) sets a
    new floor; K≳5 keeps the complement recon near full-data quality
    (81 of 90 views at K=10) while preserving the out-of-fold
    property.  Per-outer cost scales ~K× in recon work; pick K so
    ``n_proj % folds == 0`` to keep one compiled program shape per
    stage.  The reference has no counterpart (its protocol stops at
    ~1e-2-px accuracy after 35 fixed outers,
    ``examples/align_rigid.py:27``).

    Slab production family only (the point of the stage is many deep
    recon solves).  Returns the final state with ``volume`` the mean of
    the complement reconstructions (run one full deep recon afterwards
    for a final volume).

    :param theta_ref: views whose θ defines the center of the bound box
        (default ``views0``).
    """
    from tomojax.core import slab_projector as sp
    from tomojax.align.slab_refine import refine_views_slab
    from tomojax.align.cc import moment_match

    projections = jnp.asarray(projections, dtype).reshape(geom.n_proj, -1)
    mask = PARAM_SETS[param_set]
    if bounds is None:
        lo_off, hi_off = _default_bounds(dtype)
    else:
        lo_off, hi_off = (jnp.asarray(bounds[0], dtype),
                          jnp.asarray(bounds[1], dtype))
    theta_init = (theta_ref if theta_ref is not None
                  else views0).theta6().astype(dtype)
    lo_all = theta_init + lo_off
    hi_all = theta_init + hi_off

    n = geom.n_proj
    K = int(folds)
    if not 2 <= K <= n // 2:
        raise ValueError(f"folds={folds} must be in [2, n_proj//2]")
    fold_ix = [np.arange(k, n, K) for k in range(K)]
    comp_ix = [np.setdiff1d(np.arange(n), ix) for ix in fold_ix]
    fgeoms = [dataclasses.replace(geom, n_proj=len(ix)) for ix in fold_ix]
    cgeoms = [dataclasses.replace(geom, n_proj=len(ix)) for ix in comp_ix]
    quad = "arc"

    views = views0
    # vols[k] = warm-started reconstruction of fold k's COMPLEMENT data
    vols = [None] * K
    if volume0 is not None:
        v0 = jnp.asarray(volume0, dtype).reshape(geom.vox_shape)
        vols = [v0] * K
    history = {"recon_rms": [], "refine_cost": []}
    start_iter = 0
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        if resume:
            ckpts = sorted(f for f in os.listdir(checkpoint_dir)
                           if f.startswith("cv_ckpt_"))
            if ckpts:
                z = np.load(os.path.join(checkpoint_dir, ckpts[-1]))
                views = Views(phi=jnp.asarray(z["phi"]),
                              alpha=jnp.asarray(z["alpha"]),
                              beta=jnp.asarray(z["beta"]),
                              t=jnp.asarray(z["t"]),
                              cor=jnp.asarray(z["cor"]))
                if "vols" in z and z["vols"].shape[0] == K:
                    vols = [jnp.asarray(v, dtype) for v in z["vols"]]
                elif "vol_a" in z and K == 2:
                    # legacy 2-fold layout: vol_a = recon(fold-0 data)
                    # = recon(complement of fold 1) = vols[1]
                    vols = [jnp.asarray(z["vol_b"], dtype),
                            jnp.asarray(z["vol_a"], dtype)]
                else:
                    # fold count changed: reuse θ, re-warm each fold's
                    # recon from the checkpoint's mean volume
                    vm = (jnp.asarray(np.mean(z["vols"], axis=0), dtype)
                          if "vols" in z else jnp.asarray(
                              0.5 * (z["vol_a"] + z["vol_b"]), dtype))
                    vols = [vm] * K
                history = {"recon_rms": list(z["recon_rms"]),
                           "refine_cost": list(z["refine_cost"])}
                start_iter = int(z["iteration"]) + 1

    gstructs = [None] * K  # frozen per-complement octant groups (solver)
    rgroups = [None] * K   # frozen per-fold groups (refinement)
    mom_mask = None
    t_hb = time.perf_counter()

    def hb(msg):
        if progress:
            print(f"[cv] {msg} (t={time.perf_counter() - t_hb:.0f}s)",
                  flush=True)

    for it in range(start_iter, outer_iters):
        # 1) per-fold COMPLEMENT reconstructions (each excludes exactly
        #    the fold it will be used to refine)
        rms_folds = []
        for k in range(K):
            ix, gh = comp_ix[k], cgeoms[k]
            sub = jax.tree.map(lambda a: a[ix], views)
            res = (sp.group_scalars_for(gh, sub, gstructs[k], dtype)
                   if gstructs[k] is not None else None)
            if res is None:
                gstructs[k], scalars = sp.scalar_groups(gh, sub, dtype)
            else:
                gstructs[k], scalars = res
            x = (jnp.zeros(geom.vox_shape, dtype) if vols[k] is None
                 else vols[k])
            done = 0
            chunk = recon_chunk or recon_iters
            while done < recon_iters:
                nit = min(chunk, recon_iters - done)
                prog = _slab_recon_prog(gh, quad, recon, nit, False,
                                        gstructs[k], jnp.dtype(dtype).name)
                x, rms_arr, n_it = prog(x, projections[ix], scalars)
                done += nit
            vols[k] = x
            rms_folds.append(
                float(np.asarray(rms_arr)[max(0, int(n_it) - 1)]))
            hb(f"outer {it}: recon complement {k} ({len(ix)} views)")
        history["recon_rms"].append(float(np.mean(rms_folds)))

        # 2) refine each fold against its complement's reconstruction
        theta = np.asarray(views.theta6(), np.float64)
        cost_total = 0.0
        refs = {}
        for k in range(K):
            ix = fold_ix[k]
            sub = jax.tree.map(lambda a: a[ix], views)
            if rgroups[k] is None:
                rgroups[k], _ = sp.scalar_groups(fgeoms[k], sub, dtype)
            ref = refine_views_slab(vols[k], projections[ix],
                                    fgeoms[k], sub, mask=mask,
                                    lower=lo_all[ix], upper=hi_all[ix],
                                    max_iter=refine_iters,
                                    groups=rgroups[k], dtype=dtype)
            theta[ix] = np.asarray(ref.theta6, np.float64)
            cost_total += float(jnp.sum(ref.cost))
            refs[k] = ref
            hb(f"outer {it}: refine fold {k} vs complement recon")
        history["refine_cost"].append(cost_total)
        views = Views.from_theta6(jnp.asarray(theta, dtype),
                                  cor=views.cor)

        # 3) cross-validated moment hook: each fold's (tx, tz) moment
        #    error measured against its complement recon's reprojection
        if moment_period and (mask[0] or mask[2]) \
                and (it + 1) % moment_period == 0:
            if mom_mask is None:
                mom_mask = jnp.asarray(
                    _support_mask(geom, np.asarray(projections)), dtype)
            dmom = np.zeros((n, 2), np.float64)
            for k in range(K):
                ix = fold_ix[k]
                sub = jax.tree.map(lambda a: a[ix], views)
                synth = sp.project(vols[k] * mom_mask, fgeoms[k], sub,
                                   quad=quad, dtype=dtype).reshape(len(ix),
                                                                   -1)
                dmom[ix] = np.asarray(moment_match(
                    projections[ix], synth, geom.det_shape), np.float64)
            dmom = _project_out_gauge(dmom, views.phi)
            th = np.asarray(views.theta6(), np.float64)
            if mask[0]:
                th[:, 0] += dmom[:, 0]
            if mask[2]:
                th[:, 2] += dmom[:, 1]
            th = np.clip(th, np.asarray(lo_all, np.float64),
                         np.asarray(hi_all, np.float64))
            views = Views.from_theta6(jnp.asarray(th, dtype),
                                      cor=views.cor)
            hb(f"outer {it}: cv moment |dtx|={np.abs(dmom[:, 0]).mean():.2e}"
               f" |dtz|={np.abs(dmom[:, 1]).mean():.2e}")

        volume = sum(vols) / K
        if checkpoint_dir:
            np.savez(os.path.join(checkpoint_dir, f"cv_ckpt_{it:04d}.npz"),
                     phi=np.asarray(views.phi),
                     alpha=np.asarray(views.alpha),
                     beta=np.asarray(views.beta),
                     t=np.asarray(views.t), cor=np.asarray(views.cor),
                     vols=np.stack([np.asarray(v) for v in vols]),
                     iteration=it,
                     recon_rms=np.asarray(history["recon_rms"]),
                     refine_cost=np.asarray(history["refine_cost"]))
        if callback is not None:
            callback(it, views, volume, history)

    residuals = jnp.zeros((n,), dtype)
    if start_iter < outer_iters:
        residuals = jnp.concatenate(
            [refs[k].cost for k in range(K)])[jnp.argsort(
                jnp.concatenate([jnp.asarray(ix) for ix in fold_ix]))]
    volume = sum(vols) / K if vols[0] is not None else \
        jnp.zeros(geom.vox_shape, dtype)
    return AlignState(views=views, volume=volume, residuals=residuals,
                      history=history)


def save_checkpoint(path, *, views: Views, volume, history, iteration):
    """Portable npz checkpoint of (per-view θ, volume, metrics)."""
    np.savez(
        path,
        phi=np.asarray(views.phi), alpha=np.asarray(views.alpha),
        beta=np.asarray(views.beta), t=np.asarray(views.t),
        cor=np.asarray(views.cor), volume=np.asarray(volume),
        iteration=iteration,
        recon_rms=np.asarray(history["recon_rms"]),
        refine_cost=np.asarray(history["refine_cost"]),
    )


def load_checkpoint(path):
    z = np.load(path)
    views = Views(phi=jnp.asarray(z["phi"]), alpha=jnp.asarray(z["alpha"]),
                  beta=jnp.asarray(z["beta"]), t=jnp.asarray(z["t"]),
                  cor=jnp.asarray(z["cor"]))
    history = {"recon_rms": list(z["recon_rms"]),
               "refine_cost": list(z["refine_cost"])}
    return {"views": views, "volume": z["volume"], "history": history,
            "iteration": int(z["iteration"])}

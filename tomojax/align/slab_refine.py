"""Batched slab-family 6-DoF refinement — production alignment gradients.

The reference refines each view with scipy L-BFGS-B over the fused
Fortran projection+gradient kernel (``examples/align_rigid.py:40-52``,
``src/ray_wt_grad.f90:95-223``). Here the whole batch of same-orientation
views refines together in one compiled program:

1. per iteration the per-view scalars are rebuilt from the traced θ batch
   (:func:`tomojax.core.slab_projector.slab_scalars_jnp`);
2. ONE batched slab pass per Jacobian building block — value + nine
   hat-derivative/{j,r}-weight variants + moment + grid-cf passes — runs
   through the XLA slab path;
3. gradients/Jacobians assemble in detector space
   (:func:`tomojax.core.slab_projector._scalar_responses`);
4. the step is a batched box-projected Levenberg–Marquardt or Armijo
   descent: every view carries its own damping/step size, and all trial
   evaluations for the whole batch are a single batched forward call.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.geometry import Geometry, Views
from tomojax.core import slab_projector as sp
from tomojax.align.refine import PARAM_SETS, RefineResult

_HI = lax.Precision.HIGHEST

_PASSES = (("val", None, False, False),
           ("px", "x", False, False), ("py", "y", False, False),
           ("pz", "z", False, False),
           ("jx", "x", True, False), ("jy", "y", True, False),
           ("jz", "z", True, False),
           ("rx", "x", False, True), ("ry", "y", False, True),
           ("rz", "z", False, True),
           ("zm", "zm", False, False), ("zc", "zc", False, False))


def _batched_forward(vol_or, scalars, geom: Geometry, dtype, deriv=None,
                     jweight=False, rweight=False):
    """(V, NS) scalars → (V, nu, nv) arc-mode slab pass (XLA path)."""
    def one(row):
        p = jax.tree.map(lambda a: a.astype(dtype),
                         sp.params_from_scalars(row))
        return sp._forward_oriented_xla(vol_or, p, geom, quad="arc",
                                        dtype=dtype, deriv=deriv,
                                        jweight=jweight, rweight=rweight)

    return jax.vmap(one)(scalars)


def _group_value_jac(vol_or, theta, cor, geom: Geometry, flags, dtype):
    """Batched (value (V,nu,nv), jac (V,6,nu,nv)) for one octant group."""
    sw, yf, uf = flags

    def sc_of(t6, c):
        return sp.slab_scalars_jnp(geom, t6, c, sw, yf, uf, dtype=dtype)

    scalars = jax.vmap(sc_of)(theta, cor)
    out = {name: _batched_forward(vol_or, scalars, geom, dtype, deriv=dv,
                                  jweight=jw, rweight=rw)
           for name, dv, jw, rw in _PASSES}

    def assemble(row_idx):
        t6 = theta[row_idx]
        c = cor[row_idx]
        p = sp.params_from_scalars(scalars[row_idx])
        P = {"x": out["px"][row_idx], "y": out["py"][row_idx],
             "z": out["pz"][row_idx]}
        PJ = {"x": out["jx"][row_idx], "y": out["jy"][row_idx],
              "z": out["jz"][row_idx]}
        PR = {"x": out["rx"][row_idx], "y": out["ry"][row_idx],
              "z": out["rz"][row_idx]}
        resp = sp._scalar_responses(p, P, PJ, PR, out["zm"][row_idx],
                                    out["zc"][row_idx], geom, dtype)

        def params_of(t):
            E, B = sp._oriented_affine_theta(geom, t, c, sw, yf, uf,
                                             dtype)
            return sp.slab_params(E, B, dtype)

        dp = jax.jacfwd(params_of)(t6)
        return sum(jnp.einsum("uv,k->kuv", rf, df, precision=_HI)
                   for rf, df in zip(resp, dp))

    jac = jax.vmap(assemble)(jnp.arange(theta.shape[0]))
    return out["val"], jac


@functools.lru_cache(maxsize=64)
def _group_prog(geom: Geometry, flags, dtype_str: str):
    """One jitted LM program per (geometry, octant) combo.

    The whole box-LM loop runs as a single ``lax.fori_loop`` device
    program (no host round trip per iteration). The caller pads the view
    batch to a multiple of 8, so the program shape is stable across
    outer iterations while group membership drifts. The iteration count
    is a *traced* argument (fori_loop lowers to while_loop), so bulk and
    polish stages with different ``max_iter`` share one compile."""
    dtype = jnp.dtype(dtype_str)
    sw, yf, uf = flags

    def sc_of(t6, c):
        return sp.slab_scalars_jnp(geom, t6, c, sw, yf, uf, dtype=dtype)

    def costs(vol_or, meas, cor, theta):
        scalars = jax.vmap(sc_of)(theta, cor)
        r = _batched_forward(vol_or, scalars, geom, dtype) - meas
        return 0.5 * jnp.sum(r * r, axis=(1, 2))

    def step(vol_or, meas, cor, mask_f, lo, hi, theta, lam, cost):
        val, jac = _group_value_jac(vol_or, theta, cor, geom, flags,
                                    dtype)
        r = val - meas                                   # (V, nu, nv)
        jm = jac * mask_f[None, :, None, None]
        # f32 sums over n_det terms per entry: ask for full f32 (no TF32)
        g = jnp.einsum("vkuw,vuw->vk", jm, r, precision=_HI)
        H = jnp.einsum("vkuw,vluw->vkl", jm, jm, precision=_HI)
        damp = lam[:, None] * jnp.maximum(
            jnp.diagonal(H, axis1=1, axis2=2), 1e-12)
        Hd = (H + jnp.eye(6, dtype=dtype)[None] * (1.0 - mask_f)[None]
              + damp[:, :, None] * jnp.eye(6, dtype=dtype)[None])
        delta = -jnp.linalg.solve(Hd, (g * mask_f[None])[..., None])[..., 0]
        theta_new = jnp.clip(theta + delta * mask_f[None], lo, hi)
        cost_new = costs(vol_or, meas, cor, theta_new)
        improved = cost_new < cost
        theta2 = jnp.where(improved[:, None], theta_new, theta)
        lam2 = jnp.where(improved, jnp.maximum(lam / 3.0, 1e-12),
                         lam * 10.0)
        cost2 = jnp.where(improved, cost_new, cost)
        return theta2, lam2, cost2

    def run(vol, meas, cor, mask_f, lo, hi, theta0, lam0, steps):
        vol_or = sp.orient_volume(jnp.asarray(vol, dtype), geom, sw, yf)
        if uf:   # group forward emits u-flipped rows; flip the data once
            meas = meas[:, ::-1, :]
        cost0 = costs(vol_or, meas, cor, theta0)

        def body(_, c):
            return step(vol_or, meas, cor, mask_f, lo, hi, *c)

        theta, lam, cost = lax.fori_loop(0, steps, body,
                                         (theta0, lam0, cost0))
        return theta, cost

    return jax.jit(run)


def refine_views_slab(vol, projections, geom: Geometry, views: Views, *,
                      param_set: str = "xzab", mask=None, lower=None,
                      upper=None, max_iter: int = 12,
                      lm_lambda0: float = 1e-3, groups=None,
                      dtype=jnp.float32) -> RefineResult:
    """Refine all views' masked 6-DoF on the slab family (batched LM).

    Views are host-grouped by orientation octant (the flags are static
    in the traced program); each group runs the whole batched box-LM as
    ONE compiled device program (per-view damping λ with accept/reject;
    all trial costs for the batch are one batched forward). Bounds are
    absolute 6-vector boxes like
    :func:`tomojax.align.refine.refine_views`.

    :param groups: optional FROZEN group structure — a tuple of
        ``(view_indices, swap, yflip, uflip)`` as returned by
        :func:`tomojax.core.slab_projector.scalar_groups`. The
        alternating pipeline freezes this at its first outer iteration:
        per-view θ drift would otherwise re-shuffle octant membership and
        change group batch shapes, forcing a fresh compile mid-run.
        Frozen flags stay valid under small θ updates (see
        :func:`~tomojax.core.slab_projector.group_scalars_for`)."""
    if mask is None:
        mask = PARAM_SETS[param_set]
    views = jax.tree.map(np.asarray, views)
    n = views.n_proj
    nu, nv = geom.det_shape
    meas_all = np.asarray(projections, np.float64).reshape(n, nu, nv)
    theta_all = np.asarray(views.theta6(), np.float64)
    cor_all = np.asarray(views.cor, np.float64)
    lo = (np.full((n, 6), -np.inf) if lower is None
          else np.broadcast_to(np.asarray(lower, np.float64), (n, 6)))
    hi = (np.full((n, 6), np.inf) if upper is None
          else np.broadcast_to(np.asarray(upper, np.float64), (n, 6)))
    mask_f = jnp.asarray(np.asarray(mask), dtype)

    if groups is None:
        groups = list(sp._orient_groups(views, geom))
    theta_out = np.zeros((n, 6))
    cost_out = np.zeros((n,))
    for idx, sw, yf, uf in groups:
        idx = np.asarray(idx)
        V = len(idx)
        V8 = -(-V // 8) * 8   # pad with copies of the first view: LM is
        #                       per-view independent, results are dropped
        idxp = np.concatenate([idx, np.repeat(idx[:1], V8 - V)])
        prog = _group_prog(geom, (sw, yf, uf), jnp.dtype(dtype).name)
        theta, cost = prog(vol,
                           jnp.asarray(meas_all[idxp], dtype),
                           jnp.asarray(cor_all[idxp], dtype), mask_f,
                           jnp.asarray(lo[idxp], dtype),
                           jnp.asarray(hi[idxp], dtype),
                           jnp.asarray(theta_all[idxp], dtype),
                           jnp.full((V8,), lm_lambda0, dtype),
                           jnp.int32(max_iter))
        theta_out[idx] = np.asarray(theta)[:V]
        cost_out[idx] = np.asarray(cost)[:V]
    return RefineResult(theta6=jnp.asarray(theta_out, dtype),
                        cost=jnp.asarray(cost_out, dtype),
                        n_iter=jnp.full((n,), max_iter, jnp.int32),
                        converged=jnp.ones((n,), bool))

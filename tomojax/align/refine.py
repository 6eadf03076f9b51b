"""Per-view 6-DoF rigid refinement — vmapped, jitted, bounded.

Replacement for the reference's alignment layer:

- ``AlignmentUtilities.cost/gradient`` (``utilities/alignment_functions.py:7-37``)
  → :func:`alignment_cost` / :func:`alignment_cost_grad` (fused analytic
  Jacobian, never finite differences);
- the ten parameter-subset cost/gradient wrappers ``cost_xzpab`` …
  ``gradient_b`` (``alignment_functions.py:113-485``) → one boolean
  mask table :data:`PARAM_SETS` over the 6-vector
  ``(tx, ty, tz, phi, alpha, beta)`` (masks transcribed from each
  wrapper's ``vary_parameter``);
- ``gradient_descent`` with Armijo line search + 10×-backoff brute fallback
  (``alignment_functions.py:40-110``) → :func:`gradient_descent_view`;
- the flagship per-view ``scipy.optimize.minimize(..., 'L-BFGS-B',
  bounds=±3 px / ±0.02 rad)`` loop (``examples/align_rigid.py:40-52``) →
  :func:`refine_view`, a box-projected Levenberg–Marquardt solver that
  exploits the exact per-view Jacobian (k ≤ 6 normal equations — far
  cheaper per step than L-BFGS-B's implicit Hessian), vmapped over all
  views in :func:`refine_views` (the reference refines views one by one in
  Python; here all views refine in parallel in one compiled program).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.geometry import Geometry
from tomojax.core import projector

# Boolean masks over (tx, ty, tz, phi, alpha, beta) — one per reference
# cost/gradient wrapper pair (vary_parameter arrays,
# alignment_functions.py:135,175,209,262,296,332,370,408,472).
PARAM_SETS = {
    "xzpab": jnp.array([True, False, True, True, True, True]),
    "xzab": jnp.array([True, False, True, False, True, True]),
    "xz": jnp.array([True, False, True, False, False, False]),
    "x": jnp.array([True, False, False, False, False, False]),
    "z": jnp.array([False, False, True, False, False, False]),
    "ab": jnp.array([False, False, False, False, True, True]),
    "a": jnp.array([False, False, False, False, True, False]),
    "b": jnp.array([False, False, False, False, False, True]),
    "xzb": jnp.array([True, False, True, False, False, True]),
    "all": jnp.array([True, True, True, True, True, True]),
}


def alignment_cost(vol, proj_meas, geom: Geometry, theta6, cor,
                   dtype=jnp.float32, family: str = "ray"):
    """½‖P(θ)x − p‖² for one view (the reference's scalar cost,
    ``alignment_functions.py:16-25`` with ``0.5‖·‖²`` applied by each
    wrapper). ``family="fast"`` projects with the multi-pass family — its
    θ-gradients flow through the custom-vjp Pallas kernels, making
    gradient-based refinement usable at large volume sizes."""
    if family == "fast":
        from tomojax.core import fast_projector as fastp
        pred = fastp.forward_view(vol, geom, theta6[3], theta6[4],
                                  theta6[5], theta6[:3], cor, dtype=dtype,
                                  swapped=None)
    else:
        pred = projector.forward_view(vol, geom, theta6[3], theta6[4],
                                      theta6[5], theta6[:3], cor,
                                      dtype=dtype)
    r = pred - proj_meas.reshape(-1).astype(pred.dtype)
    return 0.5 * jnp.vdot(r, r, precision="highest").real.astype(pred.dtype)


def alignment_cost_grad(vol, proj_meas, geom: Geometry, theta6, cor,
                        dtype=jnp.float32):
    """(cost, 6-gradient, residual, J) via the fused projection+Jacobian
    kernel (``AlignmentUtilities.gradient``,
    ``alignment_functions.py:27-37``: grad = J·(P(θ)x − p))."""
    pred, jac = projector.forward_view_jac(
        vol, geom, theta6[3], theta6[4], theta6[5], theta6[:3], cor,
        dtype=dtype)
    r = pred - proj_meas.reshape(-1).astype(pred.dtype)
    cost = 0.5 * jnp.vdot(r, r, precision="highest").real.astype(pred.dtype)
    grad = jnp.matmul(jac, r, precision="highest")
    return cost, grad, r, jac


def fd_gradient(vol, proj_meas, geom: Geometry, theta6, cor, *, mask=None,
                eps: float = 1e-4, dtype=jnp.float32):
    """Central-difference gradient of the alignment cost over the masked
    parameters — the formalized version of the reference's ad-hoc checkers
    ``gradient_xz_fd`` / ``gradient_ab_fd``
    (``alignment_functions.py:225-241,424-445``). For validating the
    analytic Jacobian path; not for production optimization."""
    if mask is None:
        mask = PARAM_SETS["xzab"]
    theta6 = jnp.asarray(theta6, dtype)

    def cost(th):
        return alignment_cost(vol, proj_meas, geom, th, cor, dtype=dtype)

    grads = []
    for p in range(6):
        if not bool(mask[p]):
            grads.append(jnp.asarray(0.0, dtype))
            continue
        dp = jnp.zeros(6, dtype).at[p].set(eps)
        grads.append((cost(theta6 + dp) - cost(theta6 - dp)) / (2 * eps))
    return jnp.stack(grads)


class RefineResult(NamedTuple):
    theta6: jnp.ndarray   # refined absolute 6-DoF parameters
    cost: jnp.ndarray     # final ½‖residual‖²
    n_iter: jnp.ndarray
    converged: jnp.ndarray


def refine_view(vol, proj_meas, geom: Geometry, theta6_init, cor, *,
                mask=None, lower=None, upper=None, max_iter: int = 20,
                eps: float = 1e-8, lm_lambda0: float = 1e-3,
                dtype=jnp.float32) -> RefineResult:
    """Box-constrained Levenberg–Marquardt refinement of one view's 6-DoF.

    ``mask`` (6 bools) freezes parameters exactly like the reference's
    ``vary_parameter`` subsets; ``lower``/``upper`` are absolute bounds on
    the 6-vector (the reference's L-BFGS-B box, ``align_rigid.py:48``).
    Jittable; vmap over views via :func:`refine_views`.
    """
    if mask is None:
        mask = PARAM_SETS["xzab"]
    mask_f = mask.astype(dtype)
    theta0 = jnp.asarray(theta6_init, dtype)
    lo = (-jnp.inf * jnp.ones(6, dtype) if lower is None
          else jnp.asarray(lower, dtype))
    hi = (jnp.inf * jnp.ones(6, dtype) if upper is None
          else jnp.asarray(upper, dtype))

    def cost_fn(th):
        return alignment_cost(vol, proj_meas, geom, th, cor, dtype=dtype)

    def cost_grad_hess(th):
        cost, grad, r, jac = alignment_cost_grad(vol, proj_meas, geom, th,
                                                 cor, dtype=dtype)
        jm = jac * mask_f[:, None]
        g = jnp.matmul(jm, r, precision="highest")
        H = jnp.matmul(jm, jm.T, precision="highest")
        return cost, g, H

    def cond(c):
        return (c["it"] < max_iter) & jnp.logical_not(c["done"])

    def body(c):
        th, lam, it = c["theta"], c["lam"], c["it"]
        cost, g, H = cost_grad_hess(th)
        # damped normal equations on the masked subspace; identity on the
        # frozen coordinates keeps the solve well-posed and the step zero
        damp = lam * jnp.maximum(jnp.diag(H), 1e-12)
        Hd = H + jnp.diag(damp) + jnp.diag(1.0 - mask_f)
        delta = -jnp.linalg.solve(Hd, g * mask_f)
        th_new = jnp.clip(th + delta * mask_f, lo, hi)
        cost_new = cost_fn(th_new)
        improved = cost_new < cost
        th2 = jnp.where(improved, th_new, th)
        lam2 = jnp.where(improved, jnp.maximum(lam / 3.0, 1e-12), lam * 10.0)
        rel = jnp.abs(cost - cost_new) / jnp.maximum(
            jnp.maximum(cost, cost_new), 1.0)
        done = (improved & (rel <= eps)) | (lam2 > 1e8)
        return {"theta": th2, "lam": lam2, "it": it + 1, "done": done,
                "cost": jnp.where(improved, cost_new, cost)}

    init = {"theta": jnp.clip(theta0, lo, hi),
            "lam": jnp.asarray(lm_lambda0, dtype),
            "it": jnp.asarray(0, jnp.int32), "done": jnp.asarray(False),
            "cost": cost_fn(jnp.clip(theta0, lo, hi))}
    out = lax.while_loop(cond, body, init)
    return RefineResult(theta6=out["theta"], cost=out["cost"],
                        n_iter=out["it"], converged=out["done"])


def refine_views(vol, projections, geom: Geometry, views, *, mask=None,
                 lower=None, upper=None, max_iter: int = 20,
                 eps: float = 1e-8, dtype=jnp.float32) -> RefineResult:
    """Refine every view in parallel (vmap) — the batched replacement for
    the reference's per-view Python loop (``align_rigid.py:40-52``)."""
    n = views.n_proj
    theta0 = views.theta6().astype(dtype)
    projections = jnp.asarray(projections).reshape(n, -1)
    lo = (-jnp.inf * jnp.ones((n, 6), dtype) if lower is None
          else jnp.broadcast_to(jnp.asarray(lower, dtype), (n, 6)))
    hi = (jnp.inf * jnp.ones((n, 6), dtype) if upper is None
          else jnp.broadcast_to(jnp.asarray(upper, dtype), (n, 6)))

    def one(th, p, cor, lo_i, hi_i):
        return refine_view(vol, p, geom, th, cor, mask=mask, lower=lo_i,
                           upper=hi_i, max_iter=max_iter, eps=eps,
                           dtype=dtype)

    return jax.vmap(one)(theta0, projections, views.cor, lo, hi)


def gradient_descent_view(vol, proj_meas, geom: Geometry, theta6_init, cor,
                          *, mask=None, max_iter: int = 100, eps: float = 1e-6,
                          step_search: str = "armijo", family: str = "ray",
                          param_scale=None,
                          dtype=jnp.float32) -> RefineResult:
    """Plain gradient descent with Armijo (or Wolfe) backtracking and the
    reference's brute 10×-backoff fallback (``gradient_descent``,
    ``alignment_functions.py:40-110``, ``step_search`` option at ``:43``):
    two consecutive brute line searches abort the optimization.

    ``param_scale`` (6,) diagonally preconditions the descent direction —
    the jit equivalent of the reference's ``scale_factor`` hooks
    (``alignment_functions.py:138-141``). Angles produce gradients ~100×
    larger per unit than translations; the default scale
    (1, 1, 1, 0.01, 0.01, 0.01) balances the step so mixed
    translation+angle subsets (xzab, xzpab) converge."""
    from tomojax.recon.linesearch import armijo, wolfe, brute_backoff

    if mask is None:
        mask = PARAM_SETS["xzab"]
    mask_f = mask.astype(dtype)
    theta0 = jnp.asarray(theta6_init, dtype)
    if param_scale is None:
        param_scale = jnp.asarray([1.0, 1.0, 1.0, 0.01, 0.01, 0.01], dtype)
    else:
        param_scale = jnp.asarray(param_scale, dtype)
    precond = param_scale * param_scale

    def cost_fn(th):
        return alignment_cost(vol, proj_meas, geom, th, cor, dtype=dtype,
                              family=family)

    if family == "fast":
        # the fast family has no explicit Jacobian kernel; use reverse-mode
        # through the custom-vjp multi-pass projector
        _raw_grad = jax.grad(cost_fn)

        def grad_fn(th):
            return _raw_grad(th) * mask_f
    else:
        def grad_fn(th):
            _, grad, _, _ = alignment_cost_grad(vol, proj_meas, geom, th,
                                                cor, dtype=dtype)
            return grad * mask_f

    def cond(c):
        return (c["it"] < max_iter) & (c["stop"] == 0)

    def body(c):
        th, it = c["theta"], c["it"]
        f0 = c["cost"]
        g = grad_fn(th)
        # diagonally preconditioned descent direction (scale_factor analog)
        d = -g * precond
        # scale the initial trial step so the first probe moves O(1) in
        # parameter space — raw alpha0=1 with gradients of magnitude ~1e5
        # evaluates wildly out-of-range parameters (the reference tolerates
        # this on CPU; here it wastes backtracking iterations)
        a0 = jnp.minimum(1.0, 1.0 / (1e-12 + jnp.linalg.norm(d)))
        if step_search == "wolfe":
            ls = wolfe(cost_fn, grad_fn, th, d, g, f0, alpha0=a0)
        else:
            ls = armijo(cost_fn, th, d, g, f0, alpha0=a0)

        def on_success(_):
            # ls_counter is cumulative in the reference (never reset,
            # alignment_functions.py:62,82)
            th_new = th + ls.alpha * d
            return th_new, ls.f_new, jnp.asarray(0, jnp.int32), \
                c["brute_count"]

        def on_failure(_):
            bb = brute_backoff(cost_fn, th, d, f0, alpha0=1.0)
            th_new = jnp.where(bb.success, th + bb.alpha * d, th)
            f_new = jnp.where(bb.success, bb.f_new, f0)
            brute = c["brute_count"] + 1
            stop = jnp.where(jnp.logical_not(bb.success) | (brute >= 2),
                             2, 0).astype(jnp.int32)
            return th_new, f_new, stop, brute

        th_new, f_new, stop, brute = lax.cond(ls.success, on_success,
                                              on_failure, None)
        rel = jnp.abs(f_new - f0) / jnp.maximum(jnp.maximum(f_new, f0), 1.0)
        stop = jnp.maximum(stop, jnp.where(rel <= eps, 1, 0)).astype(
            jnp.int32)
        return {"theta": th_new, "cost": f_new, "it": it + 1, "stop": stop,
                "brute_count": brute}

    init = {"theta": theta0, "cost": cost_fn(theta0),
            "it": jnp.asarray(0, jnp.int32), "stop": jnp.asarray(0, jnp.int32),
            "brute_count": jnp.asarray(0, jnp.int32)}
    out = lax.while_loop(cond, body, init)
    return RefineResult(theta6=out["theta"], cost=out["cost"],
                        n_iter=out["it"], converged=out["stop"] > 0)

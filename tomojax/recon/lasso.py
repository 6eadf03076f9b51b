"""L1-regularized least squares (lasso) by ISTA / accelerated ISTA (FISTA).

Replacement for the reference's ``run_lasso_ista``
(``recon/regularized.py:239-315``), ``run_lasso_accelerated``
(``:334-413``), ``_backtrack_lasso`` (``:317-332``) and
``soft_thresholding`` (``:433-440``), plus the MPI twins in
``regularized_mpi.py:283-493``.

    x* = argmin ½‖Ax − b‖² + λ‖x‖₁

Per iteration: gradient of the fidelity term, proximal backtracking line
search (Beck–Teboulle majorization test, same inequality as the reference's
``g ≤ g0 − ⟨∇g0, Gt⟩ + ‖Gt‖²/(2t)``), soft-threshold prox, optional
Nesterov momentum ``v = x_k + (k−2)/(k+1)(x_k − x_{k−1})``
(``regularized.py:374``), semi-convergence stop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from tomojax.core.operators import TomoOperator


class LassoResult(NamedTuple):
    x: jnp.ndarray
    rms_error: jnp.ndarray
    convergence: jnp.ndarray
    step_size: jnp.ndarray
    n_iter: jnp.ndarray
    stop_reason: jnp.ndarray  # 0 budget, 1 semi-convergence, 3 ls failure


def soft_thresholding(x, lam):
    """sgn(x)·max(|x| − λ, 0) (reference ``regularized.py:433-440``)."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - lam, 0.0)


def _backtrack(op, b, x, grad, g0, lam, t0, shrink, min_t=1e-16):
    """Proximal backtracking (reference ``_backtrack_lasso``,
    ``regularized.py:317-332``). Returns (x_prox, t, success)."""
    dtype = x.dtype

    def trial(t):
        xp = soft_thresholding(x - t * grad, t * lam)
        Gt = x - xp
        r = op.A(xp) - b
        g = 0.5 * jnp.vdot(r, r, precision="highest").real.astype(dtype)
        gp = (g0 - jnp.vdot(grad, Gt, precision="highest").real
              + (0.5 / t) * jnp.vdot(Gt, Gt, precision="highest").real
              ).astype(dtype)
        return xp, g <= gp

    def cond(c):
        t, _, ok = c
        return jnp.logical_not(ok) & (t > min_t)

    def body(c):
        t, _, _ = c
        xp, ok = trial(t)
        t_next = jnp.where(ok, t, t * shrink)
        return (t_next, xp, ok)

    xp0, ok0 = trial(jnp.asarray(t0, dtype))
    t, xp, ok = lax.while_loop(
        cond, body, (jnp.where(ok0, t0, t0 * shrink).astype(dtype), xp0, ok0))
    return xp, t, ok


def _lasso(op: TomoOperator, b, *, niter, reg_param, alpha0, shrink,
           x0, ground_truth, accelerated: bool) -> LassoResult:
    dtype = op.dtype
    b = jnp.asarray(b, dtype).reshape(op.geom.n_proj, op.geom.n_det)
    x = (jnp.zeros(op.vol_shape, dtype) if x0 is None
         else jnp.asarray(x0, dtype).reshape(op.vol_shape))
    gt = None if ground_truth is None else \
        jnp.asarray(ground_truth, dtype).reshape(-1)
    norm_factor = jnp.linalg.norm(b) if gt is None else jnp.linalg.norm(gt)
    lam = jnp.asarray(reg_param, dtype)

    def cond(c):
        return (c["k"] < niter) & (c["stop"] == 0)

    def body(c):
        x, k = c["x"], c["k"]
        res = op.A(x) - b
        grad = op.AT(res)
        g0 = 0.5 * jnp.vdot(res, res, precision="highest").real.astype(dtype)
        _, t, ok = _backtrack(op, b, x, grad, g0, lam, alpha0, shrink)

        if accelerated:
            kf = k.astype(dtype)
            v = c["x1"] + (kf - 2.0) / (kf + 1.0) * (c["x1"] - c["x0"])
            x_new = soft_thresholding(v - t * grad, t * lam)
            x0_new, x1_new = c["x1"], x_new
        else:
            x_new = soft_thresholding(x - t * grad, t * lam)
            x0_new, x1_new = c["x0"], c["x1"]

        conv_k = jnp.linalg.norm(res).astype(dtype)
        if gt is None:
            rms_k = conv_k / norm_factor
        else:
            rms_k = (jnp.linalg.norm(x_new.reshape(-1) - gt) / norm_factor
                     ).astype(dtype)
        prev = c["rms"][jnp.maximum(k - 1, 0)]
        semi = jnp.where((k > 1) & (rms_k > prev), 1, 0).astype(jnp.int32)
        stop = jnp.maximum(semi, jnp.where(ok, 0, 3).astype(jnp.int32))
        return {"x": x_new, "x0": x0_new, "x1": x1_new, "k": k + 1,
                "stop": stop,
                "conv": c["conv"].at[k].set(conv_k),
                "rms": c["rms"].at[k].set(rms_k),
                "steps": c["steps"].at[k].set(t)}

    zero = jnp.zeros_like(x)
    init = {"x": x, "x0": zero, "x1": zero, "k": jnp.asarray(0, jnp.int32),
            "stop": jnp.asarray(0, jnp.int32),
            "conv": jnp.zeros((niter,), dtype),
            "rms": jnp.zeros((niter,), dtype),
            "steps": jnp.zeros((niter,), dtype)}
    out = lax.while_loop(cond, body, init)
    return LassoResult(x=out["x"], rms_error=out["rms"],
                       convergence=out["conv"], step_size=out["steps"],
                       n_iter=out["k"], stop_reason=out["stop"])


def lasso_ista(op: TomoOperator, b, *, niter: int = 100,
               reg_param: float = 1.0, alpha0: float = 1.0,
               shrink: float = 0.5, x0=None, ground_truth=None
               ) -> LassoResult:
    """Plain ISTA (reference ``run_lasso_ista``, ``regularized.py:239-315``)."""
    return _lasso(op, b, niter=niter, reg_param=reg_param, alpha0=alpha0,
                  shrink=shrink, x0=x0, ground_truth=ground_truth,
                  accelerated=False)


def lasso_fista(op: TomoOperator, b, *, niter: int = 100,
                reg_param: float = 1.0, alpha0: float = 1.0,
                shrink: float = 0.5, x0=None, ground_truth=None
                ) -> LassoResult:
    """Accelerated ISTA (reference ``run_lasso_accelerated``,
    ``regularized.py:334-413``)."""
    return _lasso(op, b, niter=niter, reg_param=reg_param, alpha0=alpha0,
                  shrink=shrink, x0=x0, ground_truth=ground_truth,
                  accelerated=True)

"""Tikhonov-regularized least squares by gradient descent + Armijo search.

Replacement for the reference's
``RegularizedRecon.run_tikhonov_gd`` (``recon/regularized.py:156-237``,
MPI twin ``regularized_mpi.py``) and ``SIRT.run_regularized_gradient_descent``
(``recon/sirt.py:109-180``):

    x* = argmin ½‖Ax − b‖² + ½λ‖x‖²

Per iteration: gradient Aᵀ(Ax − b) + λx, Armijo backtracking on the exact
objective (the reference's ``line_search_armijo`` on ``my_tikh_f``,
``regularized.py:188-190``), optional positivity clamp, semi-convergence
stop. On line-search failure the reference either breaks
(``regularized.py:192-194``) or falls back to α = 1e-3 (``sirt.py:138-139``)
— both behaviors available via ``fail_alpha``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from tomojax.core.operators import TomoOperator
from tomojax.recon.linesearch import armijo, wolfe


class TikhonovResult(NamedTuple):
    x: jnp.ndarray
    rms_error: jnp.ndarray
    convergence: jnp.ndarray
    n_iter: jnp.ndarray
    stop_reason: jnp.ndarray  # 0 budget, 1 semi-convergence, 3 ls failure


def tikhonov_gd(op: TomoOperator, b, *, niter: int = 100,
                reg_param: float = 1.0, positivity: bool = False, x0=None,
                ground_truth=None, fail_alpha: float | None = None,
                step_search: str = "armijo") -> TikhonovResult:
    """``fail_alpha=None`` → stop on line-search failure (regularized.py
    behavior); a float → use that step instead (sirt.py behavior).

    ``step_search``: "armijo" (``regularized.py:188-190``) or "wolfe" — the
    reference's SIRT-twin regularized GD uses scipy's strong-Wolfe
    ``optimize.line_search`` (``recon/sirt.py:135``); "wolfe" reproduces
    that variant (one extra gradient evaluation per trial step)."""
    dtype = op.dtype
    b = jnp.asarray(b, dtype).reshape(op.geom.n_proj, op.geom.n_det)
    x = (jnp.zeros(op.vol_shape, dtype) if x0 is None
         else jnp.asarray(x0, dtype).reshape(op.vol_shape))
    gt = None if ground_truth is None else \
        jnp.asarray(ground_truth, dtype).reshape(-1)
    norm_factor = jnp.linalg.norm(b) if gt is None else jnp.linalg.norm(gt)
    lam = jnp.asarray(reg_param, dtype)

    def objective(x):
        r = op.A(x) - b
        return 0.5 * (jnp.vdot(r, r, precision="highest").real
                      + lam * jnp.vdot(x, x, precision="highest").real
                      ).astype(dtype)

    def objective_grad(x):
        return op.AT(op.A(x) - b) + lam * x

    def cond(c):
        return (c["k"] < niter) & (c["stop"] == 0)

    def body(c):
        x, k = c["x"], c["k"]
        res = b - op.A(x)
        grad = -op.AT(res) + lam * x
        f0 = 0.5 * (jnp.vdot(res, res, precision="highest").real
                    + lam * jnp.vdot(x, x, precision="highest").real
                    ).astype(dtype)
        if step_search == "wolfe":
            ls = wolfe(objective, objective_grad, x, -grad, grad, f0)
        else:
            ls = armijo(objective, x, -grad, grad, f0)
        if fail_alpha is None:
            alpha = ls.alpha
            ls_stop = jnp.where(ls.success, 0, 3).astype(jnp.int32)
        else:
            alpha = jnp.where(ls.success, ls.alpha,
                              jnp.asarray(fail_alpha, dtype))
            ls_stop = jnp.asarray(0, jnp.int32)

        x = x - alpha * grad
        if positivity:
            x = jnp.maximum(x, 0.0)

        conv_k = jnp.linalg.norm(res).astype(dtype)
        if gt is None:
            rms_k = conv_k / norm_factor
        else:
            rms_k = (jnp.linalg.norm(x.reshape(-1) - gt) / norm_factor
                     ).astype(dtype)
        prev = c["rms"][jnp.maximum(k - 1, 0)]
        semi = jnp.where((k > 1) & (rms_k > prev), 1, 0).astype(jnp.int32)
        stop = jnp.maximum(semi, ls_stop)
        return {"x": x, "k": k + 1, "stop": stop,
                "conv": c["conv"].at[k].set(conv_k),
                "rms": c["rms"].at[k].set(rms_k)}

    init = {"x": x, "k": jnp.asarray(0, jnp.int32),
            "stop": jnp.asarray(0, jnp.int32),
            "conv": jnp.zeros((niter,), dtype),
            "rms": jnp.zeros((niter,), dtype)}
    out = lax.while_loop(cond, body, init)
    return TikhonovResult(x=out["x"], rms_error=out["rms"],
                          convergence=out["conv"], n_iter=out["k"],
                          stop_reason=out["stop"])

"""TV-regularized reconstruction by FISTA forward–backward splitting.

Replacement for the reference's ``RegularizedRecon.run_fista``
(``recon/regularized.py:57-154``) and its MPI twin
(``regularized_mpi.py:80-190``):

    x* = argmin ½‖Ax − b‖² + β_tv · TV(x)

Per iteration (``regularized.py:84-103``):
1. gradient step  x_tmp = x + γ Aᵀ(b − A x),  γ = 1/hyper;
2. TV prox        u = denoise_fista(x_tmp, γ β_tv, niter_tv);
3. momentum       t ← (1 + √(1+4t²))/2,  x = u + (t_old−1)/t (u − u_old).

Distributed note: the reference computes the TV prox on MPI rank 0 only and
broadcasts (``regularized_mpi.py:118-137``) — a serial bottleneck. Under an
angle-sharded mesh the volume is replicated, the prox is deterministic, and
every shard computes it identically: the rank-0 + bcast serialization
disappears by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.operators import TomoOperator
from tomojax.recon import tv


class FistaTVResult(NamedTuple):
    x: jnp.ndarray
    rms_error: jnp.ndarray
    total_cost: jnp.ndarray
    data_fidelity: jnp.ndarray
    n_iter: jnp.ndarray
    stop_reason: jnp.ndarray  # 0 budget, 1 semi-convergence


def estimate_lipschitz(op: TomoOperator, n_power_iter: int = 12, seed: int = 0):
    """‖AᵀA‖₂ via power iteration — used to auto-set the FISTA step.

    The reference requires hand-tuning ``hyper`` (γ = 1/hyper must satisfy
    γ ≤ 1/‖A‖²; e.g. ``mpi_reconstruct.py:63`` hard-codes 1e4); this makes
    the safe choice automatic.
    """
    v = jax.random.normal(jax.random.PRNGKey(seed), op.vol_shape,
                          dtype=op.dtype)

    def body(v, _):
        v = v / jnp.linalg.norm(v)
        return op.AT(op.A(v)), None

    v, _ = lax.scan(body, v, None, length=n_power_iter)
    return jnp.linalg.norm(v)


def fista_tv(op: TomoOperator, b, *, niter: int = 100,
             hyper: float | None = 1e4, beta_tv: float = 1.0,
             niter_tv: int = 20, x0=None, ground_truth=None
             ) -> FistaTVResult:
    """``hyper=None`` auto-sets the step to 1/(1.05·‖AᵀA‖) by power
    iteration; otherwise γ = 1/hyper as in the reference."""
    dtype = op.dtype
    if hyper is None:
        hyper = 1.05 * estimate_lipschitz(op)
    b = jnp.asarray(b, dtype).reshape(op.geom.n_proj, op.geom.n_det)
    x = (jnp.zeros(op.vol_shape, dtype) if x0 is None
         else jnp.asarray(x0, dtype).reshape(op.vol_shape))
    gt = None if ground_truth is None else \
        jnp.asarray(ground_truth, dtype).reshape(-1)
    norm_factor = jnp.linalg.norm(b) if gt is None else jnp.linalg.norm(gt)
    gamma = jnp.asarray(1.0 / hyper, dtype)
    beta = jnp.asarray(beta_tv, dtype)

    def cond(c):
        return (c["k"] < niter) & (c["stop"] == 0)

    def body(c):
        x, u_old, t, k = c["x"], c["u_old"], c["t"], c["k"]
        res = b - op.A(x)
        x_tmp = x + gamma * op.AT(res)
        u = tv.denoise_fista(x_tmp, weight=gamma * beta, niter=niter_tv)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        x_new = u + (t - 1.0) / t_new * (u - u_old)

        fid = 0.5 * jnp.vdot(res, res, precision="highest").real.astype(dtype)
        total = fid + beta * tv.tv_norm_3d(x_new)
        if gt is None:
            rms_k = jnp.sqrt(2.0 * fid) / norm_factor
        else:
            rms_k = (jnp.linalg.norm(x_new.reshape(-1) - gt) / norm_factor
                     ).astype(dtype)
        prev = c["rms"][jnp.maximum(k - 1, 0)]
        stop = jnp.where((k > 0) & (rms_k > prev), 1, 0).astype(jnp.int32)
        return {"x": x_new, "u_old": u, "t": t_new, "k": k + 1, "stop": stop,
                "rms": c["rms"].at[k].set(rms_k),
                "total": c["total"].at[k].set(total.astype(dtype)),
                "fid": c["fid"].at[k].set(fid)}

    init = {"x": x, "u_old": x, "t": jnp.asarray(1.0, dtype),
            "k": jnp.asarray(0, jnp.int32), "stop": jnp.asarray(0, jnp.int32),
            "rms": jnp.zeros((niter,), dtype),
            "total": jnp.zeros((niter,), dtype),
            "fid": jnp.zeros((niter,), dtype)}
    out = lax.while_loop(cond, body, init)
    return FistaTVResult(x=out["x"], rms_error=out["rms"],
                         total_cost=out["total"], data_fidelity=out["fid"],
                         n_iter=out["k"], stop_reason=out["stop"])

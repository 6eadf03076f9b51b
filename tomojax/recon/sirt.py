"""SIRT — simultaneous iterative reconstruction, as one jitted loop.

Replacement for the reference's ``recon/sirt.py`` (serial) and
``recon/sirt_mpi.py`` (angle-sharded). The update is

    x ← x + V ⊙ Aᵀ(W ⊙ (b − A x))

with row/column inverse-sum preconditioners W = 1/(A·1), V = 1/(Aᵀ·1)
computed matrix-free (reference builds them from the CSR matrix,
``sirt.py:26-40``); zero sums invert to zero (the reference's 0→inf→1/inf
guard, ``sirt.py:37-40``). Optional positivity clamp (``sirt.py:66-67``)
and the semi-convergence early stop — quit as soon as the RMS error rises
(``sirt.py:75-78``).

Under an angle-sharded operator the Aᵀ application psums over the mesh —
the replacement for ``sirt_mpi.py:103``'s volume-sized MPI Allreduce.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from tomojax.core.operators import TomoOperator


class SIRTResult(NamedTuple):
    x: jnp.ndarray
    rms_error: jnp.ndarray
    convergence: jnp.ndarray
    n_iter: jnp.ndarray
    stop_reason: jnp.ndarray  # 0 = budget, 1 = semi-convergence


def _safe_inv(a):
    return jnp.where(a == 0.0, 0.0, 1.0 / jnp.where(a == 0.0, 1.0, a))


def sirt(op: TomoOperator, b, *, niter: int = 100, x0=None,
         ground_truth=None, positivity: bool = False) -> SIRTResult:
    """Run SIRT. Jittable end to end (``positivity`` is a static flag)."""
    dtype = op.dtype
    b = jnp.asarray(b, dtype).reshape(op.geom.n_proj, op.geom.n_det)
    x = (jnp.zeros(op.vol_shape, dtype) if x0 is None
         else jnp.asarray(x0, dtype).reshape(op.vol_shape))
    gt = None if ground_truth is None else \
        jnp.asarray(ground_truth, dtype).reshape(-1)
    norm_factor = jnp.linalg.norm(b) if gt is None else jnp.linalg.norm(gt)

    W = _safe_inv(op.row_sums())   # (n_proj, n_det)
    V = _safe_inv(op.col_sums())   # vol_shape

    def cond(c):
        return (c["k"] < niter) & (c["stop"] == 0)

    def body(c):
        x, k = c["x"], c["k"]
        res = b - op.A(x)
        x = x + V * op.AT(W * res)
        if positivity:
            x = jnp.maximum(x, 0.0)
        conv_k = jnp.linalg.norm(res).astype(dtype)
        if gt is None:
            rms_k = conv_k / norm_factor
        else:
            rms_k = (jnp.linalg.norm(x.reshape(-1) - gt) / norm_factor
                     ).astype(dtype)
        prev = c["rms"][jnp.maximum(k - 1, 0)]
        stop = jnp.where((k > 0) & (rms_k > prev), 1, 0).astype(jnp.int32)
        return {"x": x, "k": k + 1, "stop": stop,
                "conv": c["conv"].at[k].set(conv_k),
                "rms": c["rms"].at[k].set(rms_k)}

    init = {"x": x, "k": jnp.asarray(0, jnp.int32),
            "stop": jnp.asarray(0, jnp.int32),
            "conv": jnp.zeros((niter,), dtype),
            "rms": jnp.zeros((niter,), dtype)}
    out = lax.while_loop(cond, body, init)
    return SIRTResult(x=out["x"], rms_error=out["rms"],
                      convergence=out["conv"], n_iter=out["k"],
                      stop_reason=out["stop"])

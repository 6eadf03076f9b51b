"""CGLS — conjugate gradient on the normal equations, as one jitted loop.

Replacement for the reference's ``recon/cgls.py`` (serial) and
``recon/cgls_mpi.py`` (angle-sharded): the iteration is a
``lax.while_loop``; under an angle-sharded operator (``tomojax.dist``) the
Aᵀ reduction becomes an XLA psum instead of ``MPI Allreduce``
(``cgls_mpi.py:55,98``) with no other change here.

Semantics preserved from the reference (``cgls.py:26-104``):

- classic CGLS recursion: γ = ‖Aᵀr‖², α = γ/‖Ap‖², β = γ_new/γ_old;
- divergence guard: if the residual norm rises, re-initialize (r, p, γ)
  from the current iterate; quit after re-initializing at two *consecutive*
  iterations (``cgls.py:60-68``);
- per-iteration metrics: residual norm (``convergence``) and RMS error
  against ground truth if provided, else the scaled residual
  (``cgls.py:79-82``).

Deviation: after a re-initialization the reference still applies the stale
incremental update ``r -= α·(A p_old)`` to the *fresh* residual
(``cgls.py:67-70`` falls through to ``:70``), leaving the CG state
inconsistent; here the restart is clean (fresh r, p, γ; skip the stale
update). Also the reference's ctor bugs (``object['precision']`` typo
``cgls.py:20``, undefined ``self.method`` ``:51``) are not reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from tomojax.core.operators import TomoOperator


class CGLSResult(NamedTuple):
    x: jnp.ndarray            # reconstruction, vol_shape
    rms_error: jnp.ndarray    # (niter,) valid up to n_iter
    convergence: jnp.ndarray  # (niter,) residual norms
    n_iter: jnp.ndarray       # iterations actually run
    stop_reason: jnp.ndarray  # 0 = budget, 2 = double-reinit quit


class CGLSState(NamedTuple):
    """Full CG recursion state, carriable across device programs.

    Lets a host loop over :func:`cgls_steps` bound the length of each
    device program (progress reporting, checkpoints, a runtime's limit on
    one program) while keeping true conjugacy — unlike re-calling
    :func:`cgls` with ``x0=x``, which restarts CG every chunk."""
    x: jnp.ndarray            # iterate, vol_shape
    r: jnp.ndarray            # residual b - A x, (n_proj, n_det)
    p: jnp.ndarray            # search direction, vol_shape
    gamma: jnp.ndarray        # ‖Aᵀr‖² scalar
    k: jnp.ndarray            # global iteration counter
    stop: jnp.ndarray         # 0 = running, 2 = double-reinit quit
    reinit_iter: jnp.ndarray  # iteration of the last re-initialization
    conv_prev: jnp.ndarray    # residual norm at k-1 (divergence guard)


def cgls_init(op: TomoOperator, b, x0=None) -> CGLSState:
    """Initialize (or re-initialize) the CG state from iterate ``x0``."""
    dtype = op.dtype
    b = jnp.asarray(b, dtype).reshape(op.geom.n_proj, op.geom.n_det)
    x = (jnp.zeros(op.vol_shape, dtype) if x0 is None
         else jnp.asarray(x0, dtype).reshape(op.vol_shape))
    r = b - op.A(x)
    p = op.AT(r)
    gamma = jnp.vdot(p, p, precision="highest").real.astype(dtype)
    return CGLSState(x=x, r=r, p=p, gamma=gamma,
                     k=jnp.asarray(0, jnp.int32),
                     stop=jnp.asarray(0, jnp.int32),
                     reinit_iter=jnp.asarray(-10, jnp.int32),
                     conv_prev=jnp.asarray(0.0, dtype))


def cgls_steps(op: TomoOperator, b, state: CGLSState, *, nsteps: int,
               niter: int, ground_truth=None, reinit_tol: float = 0.0):
    """Advance CGLS by up to ``nsteps`` iterations (bounded device work).

    Jittable; the host loop threads the returned state into the next call
    so conjugacy is preserved across device programs. ``niter`` is the
    global iteration budget (the ``cond`` also stops at it, so the last
    chunk may run fewer than ``nsteps``).

    :returns: ``(state', conv, rms)`` — ``conv``/``rms`` are ``(nsteps,)``
        arrays of this chunk's metrics, valid where ``j < state'.k -
        state.k``.
    """
    dtype = op.dtype
    b = jnp.asarray(b, dtype).reshape(op.geom.n_proj, op.geom.n_det)
    gt = None if ground_truth is None else \
        jnp.asarray(ground_truth, dtype).reshape(-1)
    norm_factor = jnp.linalg.norm(b) if gt is None else jnp.linalg.norm(gt)
    k0 = state.k

    def initialize(x):
        r = b - op.A(x)
        p = op.AT(r)
        gamma = jnp.vdot(p, p, precision="highest").real.astype(dtype)
        return r, p, gamma

    def cond(c):
        s = c["s"]
        return (s.k < niter) & (s.k < k0 + nsteps) & (s.stop == 0)

    def body(c):
        s = c["s"]
        x, r, p, gamma, k = s.x, s.r, s.p, s.gamma, s.k
        q = op.A(p)
        alpha = gamma / jnp.vdot(q, q, precision="highest").real.astype(dtype)
        x_new = x + alpha * p
        r_new = r - alpha * q
        conv_k = jnp.linalg.norm(r_new).astype(dtype)

        worse = (k > 0) & (conv_k > (1.0 + reinit_tol) * s.conv_prev)
        consecutive = s.reinit_iter + 1 == k

        stop = jnp.where(worse & consecutive, 2, 0).astype(jnp.int32)

        def do_reinit(_):
            # revert the update and restart CG from the current iterate
            rr, pp, gg = initialize(x)
            return x, rr, pp, gg

        def do_update(_):
            p_new = op.AT(r_new)
            gamma_new = jnp.vdot(p_new, p_new,
                                 precision="highest").real.astype(dtype)
            beta = gamma_new / gamma
            return x_new, r_new, p_new + beta * p, gamma_new

        reinit_now = worse & jnp.logical_not(consecutive)
        x2, r2, p2, gamma2 = lax.cond(reinit_now, do_reinit, do_update, None)
        reinit_iter = jnp.where(reinit_now, k, s.reinit_iter)

        if gt is None:
            rms_k = jnp.linalg.norm(r2) / norm_factor
        else:
            rms_k = jnp.linalg.norm(x2.reshape(-1) - gt) / norm_factor

        conv = c["conv"].at[k - k0].set(conv_k)
        rms = c["rms"].at[k - k0].set(rms_k.astype(dtype))
        s2 = CGLSState(x=x2, r=r2, p=p2, gamma=gamma2, k=k + 1, stop=stop,
                       reinit_iter=reinit_iter, conv_prev=conv_k)
        return {"s": s2, "conv": conv, "rms": rms}

    init = {"s": state, "conv": jnp.zeros((nsteps,), dtype),
            "rms": jnp.zeros((nsteps,), dtype)}
    out = lax.while_loop(cond, body, init)
    return out["s"], out["conv"], out["rms"]


def cgls(op: TomoOperator, b, *, niter: int = 100, x0=None,
         ground_truth=None, reinit_tol: float = 0.0) -> CGLSResult:
    """Run CGLS on ``min_x ‖A x − b‖``. Jittable end to end.

    :param reinit_tol: relative slack on the divergence guard — re-initialize
        only when ``conv_k > (1 + reinit_tol) * conv_{k-1}``. The reference
        uses 0 (any increase, ``cgls.py:60``); a small value (1e-3) makes the
        guard robust to operators whose A/Aᵀ pair is not an exact mutual
        transpose.
    """
    state = cgls_init(op, b, x0)
    state, conv, rms = cgls_steps(op, b, state, nsteps=niter, niter=niter,
                                  ground_truth=ground_truth,
                                  reinit_tol=reinit_tol)
    return CGLSResult(x=state.x, rms_error=rms, convergence=conv,
                      n_iter=state.k, stop_reason=state.stop)

"""Backtracking line searches as ``lax.while_loop``s.

Replaces the reference's scipy dependencies
(``scipy.optimize.linesearch.line_search_armijo`` / ``line_search_wolfe1``
used at ``recon/sirt.py:135``, ``recon/regularized.py:189``,
``utilities/alignment_functions.py:66-78``) with jit-compatible equivalents.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp
from jax import lax


class LineSearchResult(NamedTuple):
    alpha: jnp.ndarray
    f_new: jnp.ndarray
    success: jnp.ndarray
    n_evals: jnp.ndarray


def armijo(f: Callable, x, direction, grad, f0, *, alpha0=1.0, c1=1e-4,
           shrink=0.5, max_backtracks: int = 30) -> LineSearchResult:
    """Armijo backtracking: find α with f(x + α d) ≤ f0 + c1 α ⟨g, d⟩.

    ``f`` must be a jittable scalar function of the iterate.
    """
    gd = jnp.vdot(grad, direction, precision="highest").real
    dtype = jnp.asarray(f0).dtype
    alpha0 = jnp.asarray(alpha0, dtype)

    def cond(c):
        alpha, f_new, it, ok = c
        return jnp.logical_not(ok) & (it < max_backtracks)

    def body(c):
        alpha, _, it, _ = c
        f_new = f(x + alpha * direction)
        ok = f_new <= f0 + c1 * alpha * gd
        alpha_next = jnp.where(ok, alpha, alpha * shrink)
        return (alpha_next, f_new, it + 1, ok)

    alpha, f_new, n, ok = lax.while_loop(
        cond, body, (alpha0, jnp.asarray(jnp.inf, dtype),
                     jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return LineSearchResult(alpha=alpha, f_new=f_new, success=ok, n_evals=n)


def wolfe(f: Callable, grad_f: Callable, x, direction, grad, f0, *,
          alpha0=1.0, c1=1e-4, c2=0.9, shrink=0.5,
          max_backtracks: int = 25) -> LineSearchResult:
    """Backtracking search enforcing both Wolfe conditions (sufficient
    decrease + curvature) — the jit-compatible stand-in for scipy's
    ``line_search_wolfe1`` used by the reference's alignment optimizer
    (``alignment_functions.py:76-78``). ``grad_f`` returns the gradient at
    an iterate; one extra gradient evaluation per trial step.
    """
    gd = jnp.vdot(grad, direction, precision="highest").real
    dtype = jnp.asarray(f0).dtype

    def cond(c):
        alpha, f_new, it, ok = c
        return jnp.logical_not(ok) & (it < max_backtracks)

    def body(c):
        alpha, _, it, _ = c
        x_new = x + alpha * direction
        f_new = f(x_new)
        g_new = grad_f(x_new)
        armijo_ok = f_new <= f0 + c1 * alpha * gd
        curvature_ok = (jnp.vdot(g_new, direction, precision="highest").real
                        >= c2 * gd)
        ok = armijo_ok & curvature_ok
        alpha_next = jnp.where(ok, alpha, alpha * shrink)
        return (alpha_next, f_new, it + 1, ok)

    alpha, f_new, n, ok = lax.while_loop(
        cond, body, (jnp.asarray(alpha0, dtype), jnp.asarray(jnp.inf, dtype),
                     jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return LineSearchResult(alpha=alpha, f_new=f_new, success=ok, n_evals=n)


def brute_backoff(f: Callable, x, direction, f0, *, alpha0=1.0,
                  shrink=0.1, min_alpha=1e-15) -> LineSearchResult:
    """The reference's line-search failure fallback: divide the step by 10
    until the cost decreases or the step underflows
    (``alignment_functions.py:79-99``)."""
    dtype = jnp.asarray(f0).dtype

    def cond(c):
        alpha, f_new, it, ok = c
        return jnp.logical_not(ok) & (alpha > min_alpha)

    def body(c):
        alpha, _, it, _ = c
        alpha = alpha * shrink
        f_new = f(x + alpha * direction)
        return (alpha, f_new, it + 1, f_new < f0)

    alpha, f_new, n, ok = lax.while_loop(
        cond, body, (jnp.asarray(alpha0, dtype), jnp.asarray(jnp.inf, dtype),
                     jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return LineSearchResult(alpha=alpha, f_new=f_new, success=ok, n_evals=n)

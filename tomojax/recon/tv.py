"""Total-variation denoising (dual FISTA prox) — pure jnp, jittable.

Re-implementation of the reference's ``utilities/tv_denoise.py``
(itself derived from E. Gouillart's tomo-tv): the isotropic-TV proximal
operator solved in the dual domain with FISTA momentum
(``tv_denoise.py:98-170``), Lipschitz factor 12 for 3-D / 8 for 2-D
(``:141-145``), dual-gap early stop checked every ``check_gap_frequency``
iterations (``:163-168``).

The reference's Python ``while`` with a data-dependent break becomes a
``lax.while_loop`` with a ``done`` carry flag — same math, one compiled
program.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def gradient(img):
    """Forward-difference gradient, zero-padded at the trailing face.

    Returns ``(ndim, *img.shape)``; component ``d`` is the diff along axis
    ``d`` (reference ``tv_denoise.py:34-59``).
    """
    comps = []
    for d in range(img.ndim):
        g = jnp.diff(img, axis=d)
        pad = [(0, 0)] * img.ndim
        pad[d] = (0, 1)
        comps.append(jnp.pad(g, pad))
    return jnp.stack(comps)


def div(grad):
    """Divergence, the negative adjoint of :func:`gradient`
    (reference ``tv_denoise.py:20-31``)."""
    res = jnp.zeros(grad.shape[1:], dtype=grad.dtype)
    for d in range(grad.shape[0]):
        g = grad[d]
        pad = [(0, 0)] * g.ndim
        pad[d] = (1, 0)
        shifted = jnp.pad(g, pad)[tuple(
            slice(0, -1) if i == d else slice(None) for i in range(g.ndim))]
        res = res + (g - shifted)
    return res


def tv_norm(img):
    """Isotropic TV seminorm Σ |∇x| (pointwise L2 over components)."""
    g = gradient(img)
    return jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0)))


def tv_norm_3d(img):
    """Frobenius norm of the gradient field — the reference's TV *metric*
    (``tv_denoise.py:62-64``; not the isotropic seminorm)."""
    g = gradient(img)
    return jnp.sqrt(jnp.sum(g * g))


def _project_on_dual(grad):
    """Project the dual field onto the pointwise L2 unit ball
    (reference ``tv_denoise.py:67-75``)."""
    norm = jnp.maximum(jnp.sqrt(jnp.sum(grad * grad, axis=0)), 1.0)
    return grad / norm


def _dual_gap(im, new, gap, weight):
    """Dual gap of TV denoising (reference ``tv_denoise.py:78-95``)."""
    im_norm = jnp.sum(im * im)
    g = gradient(new)
    tv_new = 2.0 * weight * jnp.sum(jnp.sqrt(jnp.sum(g * g, axis=0)))
    d_gap = jnp.sum(gap * gap) + tv_new - im_norm + jnp.sum(new * new)
    return 0.5 / im_norm * d_gap


def denoise_fista(im, weight=50.0, niter=200, eps=1e-5,
                  check_gap_frequency=3):
    """argmin_res ½‖im − res‖² + weight · TV(res), via dual FISTA.

    Jittable; ``niter`` is the static iteration cap, the dual-gap test can
    stop earlier (carry flag). Matches ``tv_denoise.denoise_fista``
    semantics including the 12/8 Lipschitz factor and the momentum recursion.
    """
    im = jnp.asarray(im)
    factor = 12.0 if im.ndim == 3 else 8.0
    shape = (im.ndim,) + im.shape

    def cond(c):
        grad_im, grad_aux, t, i, new, done = c
        return (i < niter) & jnp.logical_not(done)

    def body(c):
        grad_im, grad_aux, t, i, new, done = c
        error = weight * div(grad_aux) - im
        grad_tmp = gradient(error)
        grad_tmp = grad_tmp * (1.0 / (factor * weight))
        grad_aux = grad_aux + grad_tmp
        grad_tmp = _project_on_dual(grad_aux)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        t_factor = (t - 1.0) / t_new
        grad_aux = (1.0 + t_factor) * grad_tmp - t_factor * grad_im
        grad_im = grad_tmp

        def with_gap_check(args):
            grad_im, new, done = args
            gap = weight * div(grad_im)
            new = im - gap
            dgap = _dual_gap(im, new, gap, weight)
            return grad_im, new, dgap < eps

        def without(args):
            return args

        grad_im, new, done = lax.cond(
            i % check_gap_frequency == 0, with_gap_check, without,
            (grad_im, new, done))
        return (grad_im, grad_aux, t_new, i + 1, new, done)

    z = jnp.zeros(shape, dtype=im.dtype)
    init = (z, z, jnp.asarray(1.0, im.dtype), jnp.asarray(0, jnp.int32),
            im, jnp.asarray(False))
    grad_im, _, _, _, new, _ = lax.while_loop(cond, body, init)
    # final primal estimate from the last dual iterate (the reference
    # returns the `new` from the last gap check; recompute for freshness)
    return im - weight * div(grad_im)

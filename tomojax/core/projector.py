"""Matrix-free differentiable ray-driven projector (the exact reference family).

This module replaces, in one differentiable function family, the reference's:

- scipy CSR system-matrix factory  (``utilities/projection_operators.py:22-76``)
- Fortran sparse-weight emitter    (``src/ray_wt_grad.f90:1-92``,
  ``trilinear_ray_sparse``)
- Fortran fused projection+6-DoF-gradient kernel
  (``src/ray_wt_grad.f90:95-223``, ``trilinear_ray_interp``) and its Python
  glue (``utilities/ray_voxel_utilities.py:53-170``)
- the all-Fortran pipeline (``src/forward_projection.f90``,
  ``src/projection_gradient.f90``, ``src/external_forward_projection.f90``)

Design (accelerator-first, not a port):

- **Matrix-free.** The reference materializes a CSR matrix with
  ``8 * n_rays * n_steps`` weights per view — wrong for an accelerator (dynamic nnz,
  scatter/gather spmv). Here interpolation weights are recomputed on the fly
  inside a ``lax.scan`` over ray-march steps; A and Aᵀ are jitted functions.
- **Static shapes.** The sample count per ray is
  ``n_steps = int(2 * vox_size_y / step_size)``, static at trace time
  (the reference's ``int(r_length/step_size)``,
  ``ray_voxel_utilities.py:88`` — constant because rigid transforms preserve
  the source–detector distance).
- **Gather-based forward; its exact transpose (scatter-add) as adjoint** so
  CGLS sees a true adjoint pair. The voxel-driven family (gather-based
  adjoint) lives in ``voxel_projector.py``.
- **Analytic 6-DoF Jacobian** via the ``der_static + step · der_ray_direction``
  decomposition (``ray_voxel_utilities.py:15-50``; Fortran
  ``ray_wt_grad.f90:136-141``), exposed both as an explicit
  ``(6, n_rays)`` Jacobian and as a ``jax.custom_vjp`` rule.

Math conventions (identical to the reference's normative Python/f2py path):

- rigid map: ``p' = R_z(phi) @ R_x(alpha) @ (R_y(beta) p + t)``
- per-view center-of-rotation shift added to the *x* coordinate of the
  untransformed source/detector points (``ray_voxel_utilities.py:72-73``)
- samples ``p(r, j) = p0_r + j * step_size * r_hat``, trilinear weights from
  ``floor``/``1 - frac`` with *per-corner* bounds guards
  (``ray_wt_grad.f90:35-89``)
- 6-DoF parameter order ``(tx, ty, tz, phi, alpha, beta)``
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.geometry import Geometry, Views
from tomojax.core.rotations import (
    rot_x, rot_y, rot_z, der_rot_x, der_rot_y, der_rot_z,
)

# ----------------------------------------------------------------------
# Rigid transform helpers
# ----------------------------------------------------------------------

def _mm(a, b):
    """Matmul at HIGHEST precision. Geometry/Jacobian math must not run
    through the backend's default reduced-precision (bf16-pass) matmul —
    ray positions quantized to ~2^-8 would corrupt interpolation weights."""
    return jnp.matmul(a, b, precision="highest")


def _einsum(spec, *ops):
    return jnp.einsum(spec, *ops, precision="highest")



def transform_points(x, alpha, beta, phi, t):
    """Ray-path rigid transform ``R_z(phi) R_x(alpha) (R_y(beta) x + t)``
    (reference ``utilities/ray_voxel_utilities.py:6-12``).

    :param x: (3, n) points. :returns: (3, n) transformed points.
    """
    rot_pa = _mm(rot_z(phi), rot_x(alpha))
    return _mm(rot_pa, _mm(rot_y(beta), x) + t[:, None])


class _RaySetup(NamedTuple):
    """Per-view precomputation shared by forward / adjoint / Jacobian."""

    p0: jnp.ndarray       # (3, n_rays) transformed source points, origin-relative
    d_hat: jnp.ndarray    # (3,) unit ray direction (same for all rays)
    inv_rlen: jnp.ndarray  # scalar 1 / ray_length
    # Jacobian pieces (None unless requested):
    rpa: jnp.ndarray | None       # (3, 3)   R_z R_x  (columns = d p/d t)
    der_ang: jnp.ndarray | None   # (3, 3, n_rays) rows (phi, alpha, beta) static part
    der_dir: jnp.ndarray | None   # (3, 3)   rows (phi, alpha, beta) step-scaled part


def _ray_setup(geom: Geometry, phi, alpha, beta, t, cor, dtype,
               with_jacobian: bool, ray_offset=None,
               ray_count: int | None = None) -> _RaySetup:
    src = geom.source_centers(dtype)
    det = geom.det_centers(dtype)
    if ray_count is not None:
        # contiguous ray block for detector-sharded execution (dist layer);
        # offset may be traced (lax.axis_index), count is static
        off = jnp.asarray(0 if ray_offset is None else ray_offset, jnp.int32)
        src = lax.dynamic_slice_in_dim(src, off, ray_count, axis=1)
        det = lax.dynamic_slice_in_dim(det, off, ray_count, axis=1)
    origin = geom.vox_origin(dtype)
    phi = jnp.asarray(phi, dtype)
    alpha = jnp.asarray(alpha, dtype)
    beta = jnp.asarray(beta, dtype)
    t = jnp.asarray(t, dtype)
    cor = jnp.asarray(cor, dtype)

    # cor shift: x component added to untransformed source & detector
    # (ray_voxel_utilities.py:72-73,129-130)
    src = src.at[0].add(cor[0])
    det = det.at[0].add(cor[0])

    r_p, r_a, r_b = rot_z(phi), rot_x(alpha), rot_y(beta)
    rpa = _mm(r_p, r_a)

    p0 = _mm(rpa, _mm(r_b, src) + t[:, None]) - origin[:, None]
    # Ray vector is identical for every ray: translation & cor cancel in
    # p1 - p0 = R_pa R_b (det - src), and det - src = (0, 2*sy, 0).
    v = det[:, 0] - src[:, 0]
    r = _mm(rpa, _mm(r_b, v))
    r_length = jnp.asarray(geom.ray_length, dtype)
    d_hat = r / r_length

    der_ang = der_dir = None
    if with_jacobian:
        d_p, d_a, d_b = der_rot_z(phi), der_rot_x(alpha), der_rot_y(beta)
        # Static (source-point) parts, rows (phi, alpha, beta)
        # (derivative_ray_points rows 3..5, ray_voxel_utilities.py:43-46)
        rb_st = _mm(r_b, src) + t[:, None]             # (3, n_rays)
        der_phi = _mm(d_p, _mm(r_a, rb_st))
        der_alp = _mm(r_p, _mm(d_a, rb_st))
        der_bet = _mm(rpa, _mm(d_b, src))
        der_ang = jnp.stack([der_phi, der_alp, der_bet])   # (3, 3, n_rays)
        # Ray-direction parts, constant across rays (rows 6..8, :47-49)
        der_dir = jnp.stack([_mm(d_p, _mm(r_a, _mm(r_b, v))),
                             _mm(r_p, _mm(d_a, _mm(r_b, v))),
                             _mm(rpa, _mm(d_b, v))])       # (3, 3)

    return _RaySetup(p0=p0, d_hat=d_hat, inv_rlen=1.0 / r_length,
                     rpa=rpa if with_jacobian else None,
                     der_ang=der_ang, der_dir=der_dir)


# ----------------------------------------------------------------------
# Trilinear corner machinery
# ----------------------------------------------------------------------

# corner offsets in (x, y, z); 0 = floor, 1 = ceil — enumeration order matches
# the Fortran corner order (ray_wt_grad.f90:35-89): z fastest, x slowest.
_CORNERS = [(ox, oy, oz) for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)]


def _corner_indices_weights(p, vox_shape):
    """8-corner trilinear indices, weights, masks for points ``p`` (3, R).

    Returns ``idx (8, R) int32`` (clipped linear indices), ``w (8, R)``
    (weights, zeroed out of bounds), ``parts (3, 2, R)`` per-axis floor/ceil
    weights for the gradient path, and ``mask (8, R)`` the in-bounds
    indicator. Per-corner bounds guards match ``ray_wt_grad.f90:35-89``
    (each corner kept iff all three of *its own* indices are inside).
    """
    nx, ny, nz = vox_shape
    f = jnp.floor(p)
    fi = f.astype(jnp.int32)                       # (3, R) floor indices
    frac = p - f
    wf = 1.0 - frac                                # floor weights
    parts = jnp.stack([wf, frac], axis=1)          # (3, 2, R)

    idx_list, w_list, m_list = [], [], []
    for (ox, oy, oz) in _CORNERS:
        ix = fi[0] + ox
        iy = fi[1] + oy
        iz = fi[2] + oz
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
               & (iz >= 0) & (iz < nz))
        w = parts[0, ox] * parts[1, oy] * parts[2, oz]
        lin = (jnp.clip(ix, 0, nx - 1) * ny + jnp.clip(iy, 0, ny - 1)) * nz \
            + jnp.clip(iz, 0, nz - 1)
        idx_list.append(lin)
        w_list.append(jnp.where(inb, w, jnp.zeros_like(w)))
        m_list.append(inb)
    mask = jnp.stack(m_list).astype(p.dtype)
    return jnp.stack(idx_list), jnp.stack(w_list), parts, mask


def _corner_weight_gradients(parts):
    """Per-corner gradient of the trilinear weight w.r.t. the sample point.

    For corner (ox, oy, oz): ``∂w/∂p_x = s_x * w_y * w_z`` with ``s_x = -1``
    for a floor corner and ``+1`` for a ceil corner (and cyclically) — the
    signed products hard-coded per corner in ``ray_wt_grad.f90:146-218``.

    :param parts: (3, 2, R) per-axis floor/ceil weights.
    :returns: (8, 3, R) d(weight)/d(p).
    """
    out = []
    for (ox, oy, oz) in _CORNERS:
        sx = 2.0 * ox - 1.0
        sy = 2.0 * oy - 1.0
        sz = 2.0 * oz - 1.0
        gx = sx * parts[1, oy] * parts[2, oz]
        gy = sy * parts[0, ox] * parts[2, oz]
        gz = sz * parts[0, ox] * parts[1, oy]
        out.append(jnp.stack([gx, gy, gz]))
    return jnp.stack(out)  # (8, 3, R)


# ----------------------------------------------------------------------
# Single-view forward / adjoint / Jacobian
# ----------------------------------------------------------------------


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor,
                 *, dtype=jnp.float32, unroll: int = 1, ray_offset=None,
                 ray_count: int | None = None):
    """Forward-project one view: ``P(theta) · vol`` → ``(n_det,)``.

    Exact semantics of the reference chain ``forward_sparse`` →
    ``trilinear_ray_sparse`` → CSR spmv (``ray_voxel_utilities.py:53-110``,
    ``ray_wt_grad.f90:1-92``), fused matrix-free: the sparse weights are never
    materialized.
    """
    setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, False,
                       ray_offset, ray_count)
    vol_flat = vol.reshape(-1)
    n_steps = geom.n_steps
    step_size = jnp.asarray(geom.step_size, dtype)
    n_out = geom.n_det if ray_count is None else ray_count

    def body(acc, j):
        c = j.astype(dtype) * step_size
        p = setup.p0 + c * setup.d_hat[:, None]
        idx, w, _, _ = _corner_indices_weights(p, geom.vox_shape)
        vals = jnp.take(vol_flat, idx, axis=0)  # (8, R)
        return acc + jnp.sum(w * vals.astype(w.dtype), axis=0), None

    acc0 = jnp.zeros((n_out,), dtype=dtype)
    acc, _ = lax.scan(body, acc0, jnp.arange(n_steps), unroll=unroll)
    return acc


def backproject_view(det_img, vol_shape, geom: Geometry, phi, alpha, beta, t,
                     cor, *, dtype=jnp.float32, unroll: int = 1,
                     ray_offset=None, ray_count: int | None = None):
    """Adjoint of :func:`forward_view` for one view: ``P(theta)ᵀ · y``.

    Exact transpose by construction: identical sample positions and weights,
    scatter-add instead of gather (replaces the reference's CSR-transpose
    spmv, e.g. ``recon/sirt.py:61``).
    """
    setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, False,
                       ray_offset, ray_count)
    n_steps = geom.n_steps
    step_size = jnp.asarray(geom.step_size, dtype)
    y = det_img.astype(dtype)
    n_vox = vol_shape[0] * vol_shape[1] * vol_shape[2]

    def body(acc, j):
        c = j.astype(dtype) * step_size
        p = setup.p0 + c * setup.d_hat[:, None]
        idx, w, _, _ = _corner_indices_weights(p, geom.vox_shape)
        contrib = (w * y[None, :]).reshape(-1)
        return acc.at[idx.reshape(-1)].add(contrib), None

    acc0 = jnp.zeros((n_vox,), dtype=dtype)
    acc, _ = lax.scan(body, acc0, jnp.arange(n_steps), unroll=unroll)
    return acc.reshape(vol_shape)


def forward_view_jac(vol, geom: Geometry, phi, alpha, beta, t, cor,
                     *, dtype=jnp.float32, unroll: int = 1):
    """Fused projection + analytic 6-DoF Jacobian for one view.

    Returns ``(det_img (n_det,), jac (6, n_det))`` with parameter order
    ``(tx, ty, tz, phi, alpha, beta)`` — the equivalent of
    ``trilinear_ray_interp`` (``src/ray_wt_grad.f90:95-223``) via
    ``forward_proj_grad`` (``ray_voxel_utilities.py:113-170``).

    The sample-point Jacobian is assembled as
    ``g = der_static + step * der_ray_direction`` with
    ``step = j * step_size / ray_length`` (``ray_wt_grad.f90:136-141``);
    per-corner contributions are ``rec[corner] * (∇_p w · g)``.
    """
    setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, True)
    vol_flat = vol.reshape(-1)
    n_steps = geom.n_steps
    step_size = jnp.asarray(geom.step_size, dtype)

    def body(carry, j):
        det_acc, jac_acc = carry
        c = j.astype(dtype) * step_size
        p = setup.p0 + c * setup.d_hat[:, None]
        idx, w, parts, mask = _corner_indices_weights(p, geom.vox_shape)
        vals = jnp.take(vol_flat, idx, axis=0).astype(w.dtype)  # (8, R)
        det_acc = det_acc + jnp.sum(w * vals, axis=0)

        # A genuinely-zero weight still has a nonzero weight *gradient*, so
        # the out-of-bounds masking must be applied to dw explicitly rather
        # than reusing w's zeros (per-corner guards, ray_wt_grad.f90:142-220).
        dw = _corner_weight_gradients(parts)                     # (8, 3, R)
        gval = _einsum("cr,cdr->dr", vals * mask, dw)            # (3, R)

        step_frac = c * setup.inv_rlen
        jac_t = _einsum("dp,dr->pr", setup.rpa, gval)             # (3, R)
        jac_a = _einsum("pdr,dr->pr", setup.der_ang, gval) \
            + step_frac * _einsum("pd,dr->pr", setup.der_dir, gval)
        jac_acc = jac_acc + jnp.concatenate([jac_t, jac_a], axis=0)
        return (det_acc, jac_acc), None

    det0 = jnp.zeros((geom.n_det,), dtype=dtype)
    jac0 = jnp.zeros((6, geom.n_det), dtype=dtype)
    (det_img, jac), _ = lax.scan(body, (det0, jac0), jnp.arange(n_steps),
                                 unroll=unroll)
    return det_img, jac


# ----------------------------------------------------------------------
# custom_vjp single-view projection (differentiable in vol AND theta)
# ----------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 4))
def project_view_t(vol, theta6, geom: Geometry, cor, dtype):
    """Differentiable single-view projection ``P(theta) · vol``.

    ``theta6 = (tx, ty, tz, phi, alpha, beta)``. Reverse-mode gradients:
    w.r.t. ``vol`` — the exact adjoint (scatter-add backprojection);
    w.r.t. ``theta6`` — the analytic Jacobian contraction (the reference's
    fused kernel, never finite differences). ``cor`` is non-differentiable.
    """
    return forward_view(vol, geom, theta6[3], theta6[4], theta6[5],
                        theta6[:3], cor, dtype=dtype)


def _project_view_fwd(vol, theta6, geom, cor, dtype):
    out = project_view_t(vol, theta6, geom, cor, dtype)
    return out, (vol, theta6, cor)


def _project_view_bwd(geom, dtype, res, g):
    vol, theta6, cor = res
    vol_bar = backproject_view(g, vol.shape, geom, theta6[3], theta6[4],
                               theta6[5], theta6[:3], cor, dtype=dtype)
    _, jac = forward_view_jac(vol, geom, theta6[3], theta6[4], theta6[5],
                              theta6[:3], cor, dtype=dtype)
    theta_bar = _mm(jac, g.astype(jac.dtype))
    return vol_bar.astype(vol.dtype), theta_bar.astype(theta6.dtype), \
        jnp.zeros_like(cor)


project_view_t.defvjp(_project_view_fwd, _project_view_bwd)


# ----------------------------------------------------------------------
# Multi-view operators
# ----------------------------------------------------------------------


def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``target`` (≥ 1)."""
    c = max(1, min(int(target), n))
    while n % c:
        c -= 1
    return c


def _auto_forward_chunk(geom: Geometry) -> int:
    # keep per-step temporaries (~ chunk * 8 * n_det * a few arrays) modest
    return _divisor_chunk(geom.n_proj, max(1, (1 << 23) // max(1, geom.n_det)))


def _auto_adjoint_chunk(geom: Geometry) -> int:
    # keep chunk * n_vox accumulation volumes under ~256 MB of f32
    return _divisor_chunk(geom.n_proj, max(1, (1 << 26) // max(1, geom.n_vox)))


def project(vol, geom: Geometry, views: Views, *, dtype=jnp.float32,
            views_chunk: int | None = None, unroll: int = 1):
    """Multi-view forward projection → sinogram ``(n_proj, n_det)``.

    Replaces building the CSR matrix A and ``A @ x``
    (``projection_operators.py:22-76`` + solver spmvs). Views are processed
    in vmapped chunks under a ``lax.scan`` (chunk auto-sized to bound peak
    memory; pass ``views_chunk`` to override).
    """
    f = lambda v: forward_view(vol, geom, v.phi, v.alpha, v.beta, v.t, v.cor,
                               dtype=dtype, unroll=unroll)
    n = views.n_proj
    chunk = _divisor_chunk(n, views_chunk) if views_chunk else \
        _auto_forward_chunk(geom)
    if chunk >= n:
        return jax.vmap(f)(views)
    views_c = jax.tree.map(lambda a: a.reshape(n // chunk, chunk,
                                               *a.shape[1:]), views)
    out = lax.map(jax.vmap(f), views_c)
    return out.reshape(n, -1)


def backproject(sino, vol_shape, geom: Geometry, views: Views, *,
                dtype=jnp.float32, views_chunk: int | None = None,
                unroll: int = 1):
    """Multi-view adjoint ``Aᵀ y`` → volume ``vol_shape``.

    Sums per-view scatter backprojections (the reference's CSR-transpose
    spmv over all views, ``sirt.py:61``/``cgls.py:72``). Chunked scan over
    views so peak memory is ``chunk`` volumes, never ``n_proj`` volumes.
    """
    def f(y, v):
        return backproject_view(y, vol_shape, geom, v.phi, v.alpha, v.beta,
                                v.t, v.cor, dtype=dtype, unroll=unroll)

    n = views.n_proj
    chunk = _divisor_chunk(n, views_chunk) if views_chunk else \
        _auto_adjoint_chunk(geom)
    sino = sino.reshape(n, -1)
    if chunk >= n:
        return jnp.sum(jax.vmap(f)(sino, views), axis=0)
    k = n // chunk
    sino_c = sino.reshape(k, chunk, -1)
    views_c = jax.tree.map(lambda a: a.reshape(k, chunk, *a.shape[1:]), views)

    def chunk_body(acc, args):
        y_c, v_c = args
        return acc + jnp.sum(jax.vmap(f)(y_c, v_c), axis=0), None

    acc0 = jnp.zeros(vol_shape, dtype=dtype)
    acc, _ = lax.scan(chunk_body, acc0, (sino_c, views_c))
    return acc


def project_with_jacobians(vol, geom: Geometry, views: Views, *,
                           dtype=jnp.float32, views_chunk: int | None = None):
    """Batched fused projection + per-view 6-DoF Jacobians.

    Returns ``(sino (n_proj, n_det), jac (n_proj, 6, n_det))`` — the batched
    equivalent of ``ProjectionMatrix.projection_gradient``
    (``projection_operators.py:112-122``), used by the alignment layer.
    """
    f = lambda v: forward_view_jac(vol, geom, v.phi, v.alpha, v.beta, v.t,
                                   v.cor, dtype=dtype)
    n = views.n_proj
    chunk = _divisor_chunk(n, views_chunk) if views_chunk else \
        _divisor_chunk(n, max(1, (1 << 22) // max(1, geom.n_det)))
    if chunk >= n:
        return jax.vmap(f)(views)
    views_c = jax.tree.map(lambda a: a.reshape(n // chunk, chunk,
                                               *a.shape[1:]), views)
    sino, jac = lax.map(jax.vmap(f), views_c)
    return sino.reshape(n, -1), jac.reshape(n, 6, -1)

"""Voxel-driven projector family (bilinear splat / detector gather).

Replacement for the reference's voxel path:
``utilities/voxel_utilities.py`` + ``src/vox_wt_grad.f90``
(``bilinear_sparse``, ``bilinear_vox_interp``) and the all-Fortran adjoint
``src/back_projection.f90`` / ``src/external_back_projection.f90``
(``voxel_back_bilinear``).

Semantics (kept identical to the reference):

- rigid map (NOTE: different composition order than the ray path):
  ``x' = R_y(beta) (R_x(alpha) R_z(phi) x + t)``
  (``voxel_utilities.py:6-20``, ``external_back_projection.f90:1-27``)
- each voxel center is rotated, then orthographically dropped onto the
  detector (x, z) plane relative to ``orig = vox_origin - cor_shift`` and
  divided by the downsampling factors (``voxel_utilities.py:61-67``);
- forward = bilinear *splat* of voxel values to the 4 surrounding detector
  pixels (per-corner bounds guards, ``vox_wt_grad.f90:77-108``);
- adjoint = bilinear *gather* from the detector at each voxel's footprint —
  gather-based, so the backprojection needs no scatter
  (``external_back_projection.f90:30-68``).

Deviations (deliberate, documented):

1. Detector pixel layout: the reference's voxel path flattens detector
   indices z-major (``(fx-1) + ndim_x*(fz-1)``, ``vox_wt_grad.f90:83``)
   while its ray path is u-major. tomojax uses ONE layout everywhere —
   u-major ``u * nv + v`` — so the two families produce interchangeable
   sinograms.
2. The 6-DoF gradient uses the true analytic derivative
   ``∂det/∂θ = rec · ∇w · ∂p/∂θ``. The reference's
   ``bilinear_vox_interp`` (``vox_wt_grad.f90:26-47``) carries the opposite
   sign on the ``∇w`` factors (a latent sign bug, harmless there because the
   alignment layer only consumes the ray-path gradient); ours is validated
   against ``jax.jacrev`` and finite differences in
   ``tests/test_voxel_projector.py``.

Parameter order matches the ray family: ``(tx, ty, tz, phi, alpha, beta)``.

Production status (round-4 decision, VERDICT r3 item 5): this family is
the ORACLE/FALLBACK tier — pure XLA gather/scatter, no Pallas kernel, by
design. The reference ships ``vox_wt_grad.f90`` as its second compiled
production kernel; tomojax's production replacement for BOTH reference
families is the slab family (``core/slab_projector.py`` +
``kernels/slab.py``), whose arc quadrature is machine-exact vs the exact
ray family and which owns the GPU kernel. A dedicated voxel-splat
kernel would duplicate the slab adjoint's role at lower accuracy
(splat aliasing — see ``tests/test_voxel_projector.py::
test_voxel_jacobian_consistent_with_ray_family``), so the voxel family
stays as: (a) the independent cross-check oracle for adjoint/Jacobian
semantics, (b) the gather-based backprojection reference, (c) the
x-block volume-sharding demonstrator (``dist.make_volume_sharded_
operator``). Likewise the explicit COO factory exists only for the ray
path (``native/tomonative.cpp::ray_sparse_coo_f64``) — a voxel
``bilinear_sparse`` twin is consciously dropped (matrix-free by design;
SURVEY §7 decision 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.geometry import Geometry, Views
from tomojax.core.rotations import (
    rot_x, rot_y, rot_z, der_rot_x, der_rot_y, der_rot_z,
)
from tomojax.core.projector import _mm, _einsum

# 4 bilinear corners (x, z); 0 = floor, 1 = ceil (vox_wt_grad.f90:77-108)
_CORNERS2D = [(ox, oz) for ox in (0, 1) for oz in (0, 1)]


def voxel_transform(x, alpha, beta, phi, t):
    """Voxel-path rigid transform ``R_y(beta) (R_x(alpha) R_z(phi) x + t)``
    (reference ``voxel_utilities.py:6-20``)."""
    ratx = _mm(rot_x(alpha), _mm(rot_z(phi), x))
    return _mm(rot_y(beta), ratx + t[:, None])


def derivative_voxel_points(x, alpha, beta, phi, t):
    """(6, 3, n_vox) derivative of the transformed voxel positions w.r.t.
    (tx, ty, tz, phi, alpha, beta) (reference ``voxel_utilities.py:23-48``)."""
    R_b, R_a, R_t = rot_y(beta), rot_x(alpha), rot_z(phi)
    dR_b, dR_a, dR_t = der_rot_y(beta), der_rot_x(alpha), der_rot_z(phi)
    rtx = _mm(R_t, x)
    ratx = _mm(R_a, rtx)
    rba = _mm(R_b, R_a)
    n = x.shape[1]
    dt = jnp.broadcast_to(R_b[:, :, None], (3, 3, n))  # d/dt = columns of R_b
    dphi = _mm(rba, _mm(dR_t, x))
    dalpha = _mm(R_b, _mm(dR_a, rtx))
    dbeta = _mm(dR_b, ratx + t[:, None])
    return jnp.concatenate(
        [dt.transpose(1, 0, 2), jnp.stack([dphi, dalpha, dbeta])], axis=0)


def _footprint(geom: Geometry, phi, alpha, beta, t, cor, dtype):
    """Detector-plane footprint of all voxel centers for one view.

    Returns ``(fx, fz) int32 (n_vox,)`` floor pixel indices and
    ``(ax, az) (n_vox,)`` fractional offsets
    (reference ``voxel_utilities.py:61-67``).
    """
    centers = geom.vox_centers(dtype)
    phi = jnp.asarray(phi, dtype)
    alpha = jnp.asarray(alpha, dtype)
    beta = jnp.asarray(beta, dtype)
    t = jnp.asarray(t, dtype)
    cor = jnp.asarray(cor, dtype)
    rc = voxel_transform(centers, alpha, beta, phi, t)
    orig = geom.vox_origin(dtype) - cor
    # positions in detector-pixel units via the voxel downsampling factors
    # (reference uses vox_ds here, voxel_utilities.py:62-67)
    ds = jnp.asarray(geom.vox_ds, dtype)
    px = (rc[0] - orig[0]) / ds[0]
    pz = (rc[2] - orig[2]) / ds[2]
    fx = jnp.floor(px)
    fz = jnp.floor(pz)
    ax = px - fx
    az = pz - fz
    return fx.astype(jnp.int32), fz.astype(jnp.int32), ax, az, rc


def _corner_scatter_ops(fx, fz, ax, az, det_shape):
    """Per-corner (linear detector index, weight, mask) for bilinear splat.

    Detector layout: u-major ``u * nv + v`` (tomojax convention; see module
    docstring deviation #1).
    """
    nu, nv = det_shape
    ops = []
    wx = (1.0 - ax, ax)
    wz = (1.0 - az, az)
    for (ox, oz) in _CORNERS2D:
        ix = fx + ox
        iz = fz + oz
        inb = (ix >= 0) & (ix < nu) & (iz >= 0) & (iz < nv)
        lin = jnp.clip(ix, 0, nu - 1) * nv + jnp.clip(iz, 0, nv - 1)
        w = wx[ox] * wz[oz]
        ops.append((lin, jnp.where(inb, w, jnp.zeros_like(w)), inb))
    return ops


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor,
                 *, dtype=jnp.float32):
    """Voxel-driven forward projection of one view → ``(n_det,)``.

    Bilinear splat of every voxel value (``bilinear_sparse`` semantics,
    ``vox_wt_grad.f90:58-112``, fused with the spmv)."""
    fx, fz, ax, az, _ = _footprint(geom, phi, alpha, beta, t, cor, dtype)
    rec = vol.reshape(-1).astype(dtype)
    out = jnp.zeros((geom.n_det,), dtype=dtype)
    for lin, w, _ in _corner_scatter_ops(fx, fz, ax, az, geom.det_shape):
        out = out.at[lin].add(w * rec)
    return out


def backproject_view(det_img, geom: Geometry, phi, alpha, beta, t, cor,
                     *, dtype=jnp.float32):
    """Voxel-driven backprojection (exact transpose of voxel forward):
    per-voxel bilinear *gather* from the detector image — a scatter-free
    adjoint (``voxel_back_bilinear``, ``external_back_projection.f90:30-68``).
    """
    fx, fz, ax, az, _ = _footprint(geom, phi, alpha, beta, t, cor, dtype)
    y = det_img.reshape(-1).astype(dtype)
    acc = jnp.zeros((geom.n_vox,), dtype=dtype)
    for lin, w, _ in _corner_scatter_ops(fx, fz, ax, az, geom.det_shape):
        acc = acc + w * jnp.take(y, lin, axis=0)
    return acc.reshape(geom.vox_shape)


def forward_view_jac(vol, geom: Geometry, phi, alpha, beta, t, cor,
                     *, dtype=jnp.float32):
    """Fused voxel-driven projection + analytic 6-DoF gradient.

    Returns ``(det_img (n_det,), grad (6, n_det))`` — the equivalent of
    ``bilinear_vox_interp`` (``vox_wt_grad.f90:1-55``) with the corrected
    gradient sign (module docstring deviation #2). Only the x- and
    z-components of ``∂p/∂θ`` enter (orthographic projection along y,
    ``vox_wt_grad.f90:27-46``), scaled by the inverse detector factors.
    """
    fx, fz, ax, az, _ = _footprint(geom, phi, alpha, beta, t, cor, dtype)
    centers = geom.vox_centers(dtype)
    der = derivative_voxel_points(
        centers, jnp.asarray(alpha, dtype), jnp.asarray(beta, dtype),
        jnp.asarray(phi, dtype), jnp.asarray(t, dtype))  # (6, 3, n_vox)
    ds = jnp.asarray(geom.vox_ds, dtype)
    dpx = der[:, 0, :] / ds[0]   # (6, n_vox) d(pixel-x)/d theta
    dpz = der[:, 2, :] / ds[2]

    rec = vol.reshape(-1).astype(dtype)
    det_img = jnp.zeros((geom.n_det,), dtype=dtype)
    grad = jnp.zeros((6, geom.n_det), dtype=dtype)
    wx = (1.0 - ax, ax)
    wz = (1.0 - az, az)
    nu, nv = geom.det_shape
    for (ox, oz) in _CORNERS2D:
        ix = fx + ox
        iz = fz + oz
        inb = (ix >= 0) & (ix < nu) & (iz >= 0) & (iz < nv)
        lin = jnp.clip(ix, 0, nu - 1) * nv + jnp.clip(iz, 0, nv - 1)
        w = jnp.where(inb, wx[ox] * wz[oz], 0.0)
        det_img = det_img.at[lin].add(w * rec)
        # d w / d px = ±wz, d w / d pz = ±wx (floor corner: −, ceil: +)
        sx = 2.0 * ox - 1.0
        sz = 2.0 * oz - 1.0
        m = inb.astype(dtype) * rec
        contrib = m * (sx * wz[oz] * dpx + sz * wx[ox] * dpz)  # (6, n_vox)
        grad = grad.at[:, lin].add(contrib)
    return det_img, grad


def project(vol, geom: Geometry, views: Views, *, dtype=jnp.float32,
            views_chunk: int | None = None):
    """Multi-view voxel-driven forward → ``(n_proj, n_det)``."""
    f = lambda v: forward_view(vol, geom, v.phi, v.alpha, v.beta, v.t, v.cor,
                               dtype=dtype)
    return _chunked_map(f, views, views_chunk, geom)


def backproject(sino, geom: Geometry, views: Views, *, dtype=jnp.float32,
                views_chunk: int | None = None):
    """Multi-view voxel-driven adjoint (gather) → volume."""
    n = views.n_proj
    sino = sino.reshape(n, -1)

    def f(y, v):
        return backproject_view(y, geom, v.phi, v.alpha, v.beta, v.t, v.cor,
                                dtype=dtype)

    def body(acc, args):
        y, v = args
        return acc + f(y, v), None

    acc0 = jnp.zeros(geom.vox_shape, dtype=dtype)
    acc, _ = lax.scan(body, acc0, (sino, views))
    return acc


def _chunked_map(f, views: Views, views_chunk, geom: Geometry):
    n = views.n_proj
    if views_chunk is None:
        views_chunk = max(1, (1 << 22) // max(1, geom.n_vox // 8))
    c = max(1, min(views_chunk, n))
    while n % c:
        c -= 1
    if c >= n:
        return jax.vmap(f)(views)
    views_c = jax.tree.map(lambda a: a.reshape(n // c, c, *a.shape[1:]),
                           views)
    out = lax.map(jax.vmap(f), views_c)
    return out.reshape(n, -1)

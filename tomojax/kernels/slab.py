"""Pallas-Triton kernel for the slab family's plane-quadrature forward.

Same math as ``slab_projector._forward_oriented_xla(quad="plane")``: for
each slab plane ``s`` of the oriented volume a ray ``(u, v)`` samples the
plane at

    X(u, v, s) = cx_s + eux*u + evx*v,                cx_s = cxb + rx*s
    ζ(x, v, s) = cz_s + gzx*(x - cx_s) + zav*v,       cz_s = czb + rz*s

with ζ evaluated at the two integer x taps of ``X``: the read is
``Σ_{x∈{x0,x0+1}} hat(X - x) · lerp_z(slab_s[x, :], ζ(x, v, s))``, every
out-of-volume tap contributes zero, and the slab sum is scaled by
``1/edy``. A window of the detector (rows ``v_off + [0, nv)``, volume
planes indexed ``z + z_off``) computes positions with the global row and
shifts the z taps by the integer ``z_off``, as the XLA path does.

One program computes one ``(BU, BV)`` detector tile of one view and loops
over the ``ny`` slabs with the sum in registers. Each slab costs four
masked gathers per ray straight from the volume in device memory, so none
of the XLA path's per-slab ``(K, nx, nv)``/``(K, nv, nu)`` intermediates
is written. A tile's footprint in one slab is about ``BU × BV`` voxels,
so the gathers stay in L1/L2. Detector v is the tile's fast axis: along v
the z taps advance by ``zav ≈ 1``, so neighbouring threads read
neighbouring words.

There is no transpose kernel: the adjoint is XLA's transpose of the XLA
forward (see ``slab_projector._plane_forward``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# per-view parameter row consumed by the kernel, in this order
PARAMS = ("rx", "rz", "eux", "evx", "cxb", "czb", "gzx", "zav", "inv_edy",
          "v_off", "z_off")
BLOCK = (32, 32)   # (BU, BV) detector tile; powers of two


def _plane_fwd_kernel(p_ref, vol_ref, out_ref, *, nx, ny, nz, bu, bv):
    b = pl.program_id(0)
    f32 = jnp.float32
    rx, rz, eux, evx, cxb, czb, gzx, zav, inv_edy, v_off, z_off = (
        p_ref[b, i] for i in range(len(PARAMS)))
    z_off = z_off.astype(jnp.int32)

    u = (pl.program_id(1) * bu
         + lax.broadcasted_iota(jnp.int32, (bu, bv), 0)).astype(f32)
    v = (pl.program_id(2) * bv
         + lax.broadcasted_iota(jnp.int32, (bu, bv), 1)).astype(f32) + v_off
    xuv = u * eux + v * evx
    zv = v * zav

    def tap(s_off, xi, wx, cx, cz):
        """wx · lerp_z(slab[xi, :], ζ(xi, v)), zero outside the volume."""
        zeta = cz + gzx * (xi.astype(f32) - cx) + zv
        z0f = jnp.floor(zeta)
        wz = zeta - z0f
        z0 = z0f.astype(jnp.int32) + z_off
        in_x = (xi >= 0) & (xi < nx)
        at = xi * (ny * nz) + s_off + z0     # row-major (nx, ny, nz)
        lo = plgpu.load(vol_ref.at[at], other=0.0,
                        mask=in_x & (z0 >= 0) & (z0 < nz))
        hi = plgpu.load(vol_ref.at[at + 1], other=0.0,
                        mask=in_x & (z0 >= -1) & (z0 < nz - 1))
        return wx * ((1.0 - wz) * lo + wz * hi)

    def body(s, acc):
        sf = s.astype(f32)
        cx = cxb + rx * sf
        cz = czb + rz * sf
        X = cx + xuv
        x0f = jnp.floor(X)
        wx = X - x0f
        x0 = x0f.astype(jnp.int32)
        s_off = s * nz
        return (acc + tap(s_off, x0, 1.0 - wx, cx, cz)
                + tap(s_off, x0 + 1, wx, cx, cz))

    acc = lax.fori_loop(0, ny, body, jnp.zeros((bu, bv), f32))
    out_ref[...] = acc * inv_edy


def plane_forward(vol_or, params, det_shape, *, block=BLOCK,
                  interpret: bool = False):
    """Plane-quadrature slab forward of one orientation group.

    :param vol_or: oriented volume ``(nx, ny, nz)`` f32 (march axis y).
    :param params: ``(V, len(PARAMS))`` f32 per-view rows, columns in
        :data:`PARAMS` order.
    :param det_shape: ``(nu, nv)``.
    :param block: ``(BU, BV)`` detector tile, powers of two. The detector
        is padded up to whole tiles and cropped afterwards.
    :param interpret: run through the Pallas interpreter (CPU tests).
    :returns: ``(V, nu, nv)`` f32.
    """
    nx, ny, nz = vol_or.shape
    nu, nv = det_shape
    bu, bv = block
    n_views = params.shape[0]
    gu, gv = pl.cdiv(nu, bu), pl.cdiv(nv, bv)
    kernel = lambda *refs: _plane_fwd_kernel(*refs, nx=nx, ny=ny, nz=nz,
                                             bu=bu, bv=bv)
    out = pl.pallas_call(
        kernel,
        grid=(n_views, gu, gv),
        in_specs=[pl.no_block_spec, pl.no_block_spec],
        out_specs=pl.BlockSpec((None, bu, bv), lambda b, i, j: (b, i, j)),
        out_shape=jax.ShapeDtypeStruct((n_views, gu * bu, gv * bv),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="slab_plane_forward",
    )(params.astype(jnp.float32), vol_or.astype(jnp.float32).reshape(-1))
    return out[:, :nu, :nv]

"""Slab-marching projector family — the production speed/accuracy operator.

Reformulates the parallel-beam X-ray transform as a scan over volume slabs
perpendicular to the dominant march axis. For each slab, every ray's
intersection coordinates are affine in the detector indices (plus a known
ceil-residual "sawtooth" term in the arc-quadrature mode), so the per-slab
work is two 1-D interpolation passes — no 3-D gathers, no giant
``(n_steps, nv, nu)`` intermediates (the weakness of ``fast_projector``).

Two quadrature modes:

- ``quad="arc"`` (default): reproduces the reference's arc-length sample
  positions exactly (``ray_voxel_utilities.py:88-94``: samples at
  ``p0 + j*step*d_hat``). Per y-slab ``s``, the samples with
  ``floor(y*) in {s-1, s}`` contribute with their trilinear y-weights; their
  in-plane coordinates are ``affine(u, v) + ED_axis * cfrac(u, v)`` where
  ``cfrac`` is the ceil-residual of an affine function (the march index
  ``j = ceil((s - y0)/EDy) + b`` for branch b). This mode is *identical* to
  the exact ray family (``projector.forward_view``) at zero rigid jitter,
  and differs only through the tiny cross-term offset
  ``gzx = EUz'/EUx' = O(sin jitter)`` in pass A (measured ~1e-3 rel-L2 per
  view at ±1° jitter, vs ~3e-2 for the 3-pass ``fast_projector`` family).

- ``quad="plane"``: one sample per slab plane (y-plane Riemann sum, scaled
  by ``1/|EDy|`` = arc samples per unit y, so its mass matches the
  arc/exact family at any ``step_size``) — ~4x cheaper, a *different* but
  equally valid
  discretization (like the reference's voxel-driven family,
  ``vox_wt_grad.f90``), for bulk solver iterations.

Orientation handling: the march axis is the dominant component of
``ED = step * R @ y_hat``. Views are grouped host-side by
``(swap x/y, flip y)`` so that within a group the volume variant is shared
and ``EDy > 0`` — no in-graph branching (cf. ``fast_projector.swap_flags``).

The XLA implementation below (2-tap ``take_along_axis`` lerps) is the
path for every quadrature and platform. On an NVIDIA GPU the f32
plane-quadrature forward runs the Pallas-Triton kernel in
``tomojax.kernels.slab`` instead (same math, direct gathers); its adjoint
stays XLA's transpose of the XLA forward.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.geometry import Geometry, Views
from tomojax.core.fast_projector import view_affine, _mm
from tomojax.core.rotations import rot_x, rot_z

_PERM_SWAP = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float64)


def _np_rot(phi, alpha, beta):
    """(n, 3, 3) rotation R = R_z(phi) R_x(alpha) R_y(beta), numpy f64
    (same conventions as ``core.rotations``)."""
    cp, sp = np.cos(phi), np.sin(phi)
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    n = np.broadcast(phi, alpha, beta).shape or (1,)
    z = np.zeros(np.shape(cp))
    o = np.ones(np.shape(cp))
    Rz = np.stack([np.stack([cp, -sp, z], -1), np.stack([sp, cp, z], -1),
                   np.stack([z, z, o], -1)], -2)
    Rx = np.stack([np.stack([o, z, z], -1), np.stack([z, ca, -sa], -1),
                   np.stack([z, sa, ca], -1)], -2)
    Ry = np.stack([np.stack([cb, z, sb], -1), np.stack([z, o, z], -1),
                   np.stack([-sb, z, cb], -1)], -2)
    return Rz @ Rx @ Ry


def _np_oriented_E(geom: Geometry, views: Views):
    """Per-view oriented affine columns (numpy): returns
    (E (n,3,3), swap, yflip, uflip) with EDy > 0 and EUx' > 0 in the
    oriented frame. E columns are (EU, EV, ED) BEFORE translation (flips
    of B are applied separately where needed)."""
    phi = np.asarray(views.phi, np.float64)
    alpha = np.asarray(views.alpha, np.float64)
    beta = np.asarray(views.beta, np.float64)
    R = _np_rot(phi, alpha, beta)
    du, dv = geom.det_pix
    E = np.stack([du * R[:, :, 0], dv * R[:, :, 2],
                  geom.step_size * R[:, :, 1]], axis=-1)  # (n, 3, 3)
    swap = np.abs(E[:, 0, 2]) > np.abs(E[:, 1, 2])
    Eo = E.copy()
    Eo[swap] = Eo[swap][:, [1, 0, 2], :]
    yflip = Eo[:, 1, 2] < 0.0
    Eo[yflip, 1, :] *= -1.0
    rx = Eo[:, 0, 2] / Eo[:, 1, 2]
    eux = Eo[:, 0, 0] - rx * Eo[:, 1, 0]
    uflip = eux < 0.0
    Eo[uflip, :, 0] *= -1.0
    return Eo, swap, yflip, uflip


def orient_flags(views: Views, geom: Geometry | None = None):
    """Host-side per-view orientation flags (swap x/y, y-flip, u-flip).

    March direction is the rotated ŷ (``ED = R[:, 1]``): swap iff
    ``|ED_x| > |ED_y|``; y-flip makes the dominant component positive
    (slab loop marches +y of the oriented volume); u-flip makes the
    in-plane x-per-detector-u slope positive (kernel requirement; an exact
    detector-row permutation)."""
    g = geom if geom is not None else Geometry(
        n_proj=views.n_proj, vox_shape=(8, 8, 8), det_shape=(8, 8))
    _, swap, yflip, uflip = _np_oriented_E(g, views)
    return swap, yflip, uflip


def orient_volume(vol, geom: Geometry, swap: bool, yflip: bool):
    """Volume variant for an orientation group (one-time per apply)."""
    v = vol.reshape(geom.vox_shape)
    if swap:
        v = v.transpose(1, 0, 2)
    if yflip:
        v = v[:, ::-1, :]
    return v


def orient_affine(E, B, ny_oriented: int, swap: bool, yflip: bool, dtype,
                  uflip: bool = False, nu: int = 0):
    """Transform the (u, v, j) → volume affine map into the oriented frame.

    ``uflip`` reverses the detector-u index (u → nu-1-u): an exact row
    permutation of the sinogram, undone by the caller."""
    if swap:
        perm = jnp.asarray(_PERM_SWAP, dtype)
        E = _mm(perm, E)
        B = _mm(perm, B)
    if yflip:
        # y -> (ny - 1) - y
        B = B.at[1].set((ny_oriented - 1.0) - B[1])
        E = E.at[1].set(-E[1])
    if uflip:
        B = B + (nu - 1.0) * E[:, 0]
        E = E.at[:, 0].multiply(-1.0)
    return E, B


class SlabParams(NamedTuple):
    """Per-view scalars of the oriented slab decomposition (all jnp)."""

    edy: jnp.ndarray     # y-advance per march step (> 0 in oriented frame)
    edx: jnp.ndarray     # x-advance per march step
    edz: jnp.ndarray     # z-advance per march step
    rx: jnp.ndarray      # EDx / EDy
    rz: jnp.ndarray      # EDz / EDy
    eux: jnp.ndarray     # in-plane x per detector-u (EUx - rx*EUy)
    evx: jnp.ndarray     # in-plane x per detector-v
    euz: jnp.ndarray     # in-plane z per detector-u
    evz: jnp.ndarray     # in-plane z per detector-v
    cxb: jnp.ndarray     # in-plane x offset (add rx*s per slab)
    czb: jnp.ndarray     # in-plane z offset (add rz*s per slab)
    gzx: jnp.ndarray     # dz/dx along constant-(v,slab): EUz/EUx
    b1: jnp.ndarray      # B[1] (for the march-index map)
    euy: jnp.ndarray     # EU[1]
    evy: jnp.ndarray     # EV[1]


def slab_params(E, B, dtype) -> SlabParams:
    EU, EV, ED = E[:, 0], E[:, 1], E[:, 2]
    edy = ED[1]
    rx = ED[0] / edy
    rz = ED[2] / edy
    eux = EU[0] - rx * EU[1]
    evx = EV[0] - rx * EV[1]
    euz = EU[2] - rz * EU[1]
    evz = EV[2] - rz * EV[1]
    return SlabParams(
        edy=edy, edx=ED[0], edz=ED[2], rx=rx, rz=rz,
        eux=eux, evx=evx, euz=euz, evz=evz,
        cxb=B[0] - rx * B[1], czb=B[2] - rz * B[1],
        gzx=euz / eux, b1=B[1], euy=EU[1], evy=EV[1])


def _lerp_rows(arr, pos, k_off=0):
    """``out[..., i] = lerp(arr[..., :], pos[..., i] + k_off)``, zero
    outside ``[0, N)`` with per-tap bounds guards. The integer ``k_off``
    shifts the taps after the floor, so a window of a longer row reads
    bit-identical weights."""
    N = arr.shape[-1]
    f = jnp.floor(pos)
    k = f.astype(jnp.int32) + k_off
    w = pos - f
    out = jnp.zeros_like(pos)
    for o in (0, 1):
        kk = k + o
        inb = (kk >= 0) & (kk < N)
        wgt = w if o else 1.0 - w
        v = jnp.take_along_axis(arr, jnp.clip(kk, 0, N - 1), axis=-1)
        out = out + jnp.where(inb, wgt * v, 0.0)
    return out


def _dlerp_rows(arr, pos, k_off=0):
    """``d/dpos`` of :func:`_lerp_rows` (hat-derivative weights ±1, same
    per-tap bounds guards; floors are piecewise-constant)."""
    N = arr.shape[-1]
    k = jnp.floor(pos).astype(jnp.int32) + k_off
    out = jnp.zeros_like(pos)
    for o, s in ((0, -1.0), (1, 1.0)):
        kk = k + o
        inb = (kk >= 0) & (kk < N)
        v = jnp.take_along_axis(arr, jnp.clip(kk, 0, N - 1), axis=-1)
        out = out + jnp.where(inb, s * v, 0.0)
    return out


def _mlerp_rows(arr, pos, k_off=0):
    """First-moment interp ``Σ_tap hat(pos - tap)·(tap - pos)·arr[tap]``
    — the (x − px)-weighted read the Jacobian's grid-sawtooth cross term
    needs (per-tap weights: -w(1-w)·v0 + w(1-w)·v1, same guards)."""
    N = arr.shape[-1]
    f = jnp.floor(pos)
    k = f.astype(jnp.int32) + k_off
    w = pos - f
    m = w * (1.0 - w)
    out = jnp.zeros_like(pos)
    for o, s in ((0, -1.0), (1, 1.0)):
        kk = k + o
        inb = (kk >= 0) & (kk < N)
        v = jnp.take_along_axis(arr, jnp.clip(kk, 0, N - 1), axis=-1)
        out = out + jnp.where(inb, s * m * v, 0.0)
    return out


def _n_branch(step_size: float) -> int:
    # max arc samples per unit slab interval: ceil(1/min|EDy|) with
    # |EDy| >= step*cos(45°)*cos(max jitter); one extra for safety at the
    # octant boundary. step_size=1 → 2.
    return int(np.ceil(np.sqrt(2.0) / step_size + 0.01))


def _forward_oriented_xla(vol_or, p: SlabParams, geom: Geometry, *, quad,
                          dtype, slab_chunk: int = 8,
                          deriv: str | None = None, jweight: bool = False,
                          rweight: bool = False, v_off=0.0, z_off=0):
    """Forward projection of one oriented view (XLA path).

    ``vol_or``: oriented volume (nx', ny', nz). Returns (nu, nv).

    ``v_off``/``z_off`` place a window: detector rows ``v_off + [0, nv)``
    of the full detector, read from volume z-planes indexed ``z + z_off``
    (the volume-sharded operator's shards). Positions are computed with
    the global detector index, so a window is bit-identical to the same
    rows of the whole view.

    ``deriv`` selects a positional-derivative variant (arc mode only) —
    the building blocks of the analytic 6-DoF Jacobian
    (:func:`forward_view_jac`):

    - ``"x"``: hat → hat' in the pass-B x-interp (∂/∂X at fixed z-grid);
    - ``"z"``: hat → hat' in the pass-A z-interp (∂/∂ζ uniform shift);
    - ``"y"``: slab-pair blend → its fy-derivative ``s1 - s0`` (∂/∂Y).

    ``jweight`` multiplies every sample by its march index j,
    ``rweight`` by its source-slab index r (the per-sample weights the
    scalar chain rule needs beyond the free detector-space constants
    u, v — the slab analog of the ``step·der_dir`` term of
    ``ray_wt_grad.f90:136-141``)."""
    assert quad == "arc" or (deriv is None and not jweight
                             and not rweight), \
        "derivative variants are arc-mode only"
    nx, ny, nz = vol_or.shape
    nu, nv = geom.det_shape
    u = jnp.arange(nu, dtype=dtype)[:, None]
    v = jnp.arange(nv, dtype=dtype)[None, :] + v_off
    x_idx = jnp.arange(nx, dtype=dtype)[:, None]
    vz = v

    K = slab_chunk
    while ny % K:
        K -= 1
    n_chunks = ny // K
    n_steps = geom.n_steps

    # affine pieces shared across slabs
    y0_uv = p.b1 + u * p.euy + v * p.evy                     # (nu, nv)
    zeta_slope_x = p.gzx                                      # dζ/dx
    # u_affine(x, v) pieces for pass A (affine inversion of the x map)
    inv_eux = 1.0 / p.eux

    if quad == "plane":
        def slab_contrib(svals, slab_blk):
            # svals (K,), slab_blk (K, nx, nz)
            cx = p.cxb + p.rx * svals                          # (K,)
            cz = p.czb + p.rz * svals
            zeta = (cz[:, None, None]
                    + p.gzx * (x_idx[None] - cx[:, None, None])
                    + vz[None] * (p.evz - p.gzx * p.evx))      # (K, nx, nv)
            tA = _lerp_rows(slab_blk, zeta, z_off)             # (K, nx, nv)
            tB = tA.transpose(0, 2, 1)                         # (K, nv, nx)
            X = (cx[:, None, None] + p.evx * vz.T[None]
                 + p.eux * u.T[None])                          # (K, nv, nu)
            out = _lerp_rows(tB, X)                            # (K, nv, nu)
            return jnp.sum(out, axis=0).T                      # (nu, nv)

        def body(acc, c):
            s0 = c * K
            svals = s0.astype(dtype) + jnp.arange(K, dtype=dtype)
            blk = lax.dynamic_slice_in_dim(vol_or, s0, K, axis=1)
            return acc + slab_contrib(svals, blk.transpose(1, 0, 2)), None

        acc0 = jnp.zeros((nu, nv), dtype=dtype)
        acc, _ = lax.scan(body, acc0, jnp.arange(n_chunks))
        # 1/edy = arc samples per unit y: matches the arc/exact family's
        # mass at ANY step_size (scaling by step/edy instead under-counts
        # by a factor of step_size — advisor round-2 finding)
        return acc * (1.0 / p.edy)

    assert quad == "arc"
    n_branch = _n_branch(geom.step_size)
    lerp_a = _dlerp_rows if deriv in ("z", "zm", "zc") else _lerp_rows
    lerp_b = (_dlerp_rows if deriv == "x"
              else _mlerp_rows if deriv == "zm" else _lerp_rows)

    def slab_contrib(svals, pair_blk):
        # svals (K,) source-slab indices r; pair_blk (K, 2, nx, nz) rows
        # r and r+1 (row r+1 zero-padded at the top edge).
        r = svals
        cx = p.cxb + p.rx * r                                  # (K,)
        cz = p.czb + p.rz * r
        # per-sample march index (K, nu, nv)
        jreal = (r[:, None, None] - y0_uv[None]) / p.edy
        jb = jnp.ceil(jreal)
        out = jnp.zeros((nu, nv), dtype=dtype)
        # pass-A sample coordinates via affine inversion u_aff(x, v)
        u_aff = ((x_idx[None] - cx[:, None, None] - vz[None] * p.evx)
                 * inv_eux)                                    # (K, nx, nv)
        y0_xv = p.b1 + u_aff * p.euy + vz[None] * p.evy
        jreal_xv = (r[:, None, None] - y0_xv) / p.edy
        cf_xv = jnp.ceil(jreal_xv) - jreal_xv                  # [0, 1)
        zeta_aff = (cz[:, None, None]
                    + p.gzx * (x_idx[None] - cx[:, None, None]
                               - vz[None] * p.evx)
                    + vz[None] * p.evz)
        for b in range(n_branch):
            j = jb + b                                         # (K, nu, nv)
            cfb = j - jreal
            fy = p.edy * cfb
            ok = (j >= 0) & (j < n_steps) & (fy < 1.0)
            X = (cx[:, None, None] + u[None] * p.eux
                 + v[None] * p.evx + p.edx * cfb)              # (K, nu, nv)
            zeta = zeta_aff + p.edz * (cf_xv + b)              # (K, nx, nv)
            zeta2 = jnp.broadcast_to(zeta[:, None], (K, 2, nx, nv))
            tA = lerp_a(pair_blk.reshape(K * 2, nx, nz),
                        zeta2.reshape(K * 2, nx, nv), z_off)
            tA = tA.reshape(K, 2, nx, nv)
            if deriv == "zc":
                # dζ/dedz weighting, evaluated ON the grid (cf_xv wraps
                # mod 1, so no sample-level expansion is exact)
                tA = tA * (cf_xv + b)[:, None]
            tB_in = tA.transpose(0, 1, 3, 2)                   # (K,2,nv,nx)
            Xt = X.transpose(0, 2, 1)                          # (K, nv, nu)
            Xt2 = jnp.broadcast_to(Xt[:, None], (K, 2, nv, nu))
            vals = lerp_b(tB_in.reshape(K * 2, nv, nx),
                          Xt2.reshape(K * 2, nv, nu))
            vals = vals.reshape(K, 2, nv, nu).transpose(0, 1, 3, 2)
            if deriv == "y":
                contrib = vals[:, 1] - vals[:, 0]
            else:
                contrib = (1.0 - fy) * vals[:, 0] + fy * vals[:, 1]
            if jweight:
                contrib = contrib * j
            if rweight:
                contrib = contrib * r[:, None, None]
            out = out + jnp.sum(jnp.where(ok, contrib, 0.0), axis=0)
        return out

    # pad one zero slab at the top so the pair (ny-1, ny) is well-formed;
    # prepend one zero slab for source-slab r = -1 (samples entering the
    # volume from below contribute fy-weighted reads of slab 0).
    volp = jnp.pad(vol_or, ((0, 0), (1, 1), (0, 0)))

    def body(acc, c):
        s0 = c * K
        svals = s0.astype(dtype) + jnp.arange(K, dtype=dtype) - 1.0
        blk = lax.dynamic_slice_in_dim(volp, s0, K + 1, axis=1)
        blk = blk.transpose(1, 0, 2)                           # (K+1, nx, nz)
        pair = jnp.stack([blk[:-1], blk[1:]], axis=1)          # (K, 2, nx, nz)
        return acc + slab_contrib(svals, pair), None

    # source slabs r = -1 .. ny-1  → ny+1 values, chunked
    n_src = ny + 1
    Ks = K
    while n_src % Ks:
        Ks -= 1
    if Ks != K:
        # fall back to per-slab chunks that divide ny+1
        K = Ks
        n_chunks = n_src // K
    else:
        n_chunks = n_src // K
    acc0 = jnp.zeros((nu, nv), dtype=dtype)
    acc, _ = lax.scan(body, acc0, jnp.arange(n_chunks))
    return acc


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                 dtype=jnp.float32, quad: str = "arc",
                 swap: bool | None = None, yflip: bool | None = None):
    """Slab-marching forward projection of one view → ``(n_det,)`` u-major.

    ``swap``/``yflip`` are the static orientation flags (from
    :func:`orient_flags`); None → compute host-side from concrete params
    (works only outside jit)."""
    vol = jnp.asarray(vol).reshape(geom.vox_shape).astype(dtype)
    if swap is None or yflip is None:
        vw = Views.create(1, phi=np.asarray([float(phi)]),
                          alpha=np.asarray([float(alpha)]),
                          beta=np.asarray([float(beta)]))
        sw, yf, _ = orient_flags(vw, geom)
        swap, yflip = bool(sw[0]), bool(yf[0])
    vol_or = orient_volume(vol, geom, swap, yflip)
    E, B = view_affine(geom, phi, alpha, beta, t, cor, dtype)
    E, B = orient_affine(E, B, vol_or.shape[1], swap, yflip, dtype)
    p = slab_params(E, B, dtype)
    out = _forward_oriented_xla(vol_or, p, geom, quad=quad, dtype=dtype)
    return out.reshape(-1)


def _take_views(views: Views, idx) -> Views:
    return jax.tree.map(lambda a: a[idx], views)


# ----------------------------------------------------------------------
# Analytic 6-DoF Jacobian (the reference's fused projection+gradient,
# ray_wt_grad.f90:95-223, re-derived for the slab decomposition)
# ----------------------------------------------------------------------
#
# Every sample's position is affine in the parameters through the oriented
# view map: p_j = B + u·EU + v·EV + j·ED (∂p_j/∂θ = dB + u·dEU + v·dEV
# + j·dED — the reference's "der_static + step·der_dir" split). So the
# full 6-DoF Jacobian is a detector-space linear combination of SIX
# θ-independent derivative projections: {∂/∂x, ∂/∂y, ∂/∂z} × {1, j}.
# Each derivative projection is the SAME slab operator with one hat
# weight replaced by its derivative (the ``deriv`` variants of
# ``_forward_oriented_xla``), so alignment gradients run on the production
# operator.


def _oriented_affine_theta(geom: Geometry, theta6, cor, swap: bool,
                           yflip: bool, uflip: bool, dtype):
    """Oriented (E, B) as a differentiable function of theta6 (static
    orientation flags — valid within one octant group)."""
    E, B = view_affine(geom, theta6[3], theta6[4], theta6[5], theta6[:3],
                       cor, dtype)
    ny_o = geom.vox_shape[0] if swap else geom.vox_shape[1]
    return orient_affine(E, B, ny_o, swap, yflip, dtype, uflip,
                         geom.det_shape[0])


def _scalar_responses(p: SlabParams, P, PJ, PR, PM, ZC, geom: Geometry,
                      dtype):
    """Detector-space response fields ∂out/∂(SlabParams scalar).

    ``P/PJ/PR[axis]`` are the plain / march-index-weighted /
    slab-index-weighted derivative projections for axis ∈ {x, y, z};
    ``PM`` is the (x − px)-moment z-derivative projection.
    Derivation (validated term-by-term by least-squares FD fits): every
    scalar perturbs each sample's pass-B position X, its slab-pair blend
    fy, and the pass-A ζ-grid, with per-sample coefficients affine in
    the detector indices (u, v), the march index j, and the slab index
    r. Three couplings matter beyond the naive affine chain:

    - perturbing the in-plane x (cxb, rx·r, evx·v) also shifts the
      ζ-grid by ``-g2 = -(gzx + rz·euy/eux)`` — the per-column z
      tracking PLUS the grid-sawtooth phase (u_aff inversion) response;
    - the sawtooth cfb = j - w responds to (b1, euy·u, evy·v, edy·w)
      through X (×rx), fy (×edy) and ζ (×rz) simultaneously;
    - the ζ-grid sawtooth slopes in grid-x (``wax``), so edz-class
      perturbations carry an (x − px)-moment term (``PM``).
    """
    nu, nv = geom.det_shape
    u = jnp.arange(nu, dtype=dtype)[:, None]
    v = jnp.arange(nv, dtype=dtype)[None, :]
    inv = 1.0 / p.edy
    euy_ieux = p.euy / p.eux
    g2 = p.gzx + p.rz * euy_ieux

    def D(axis, w):
        """Response to a per-sample perturbation with weight w."""
        if w == "1":
            return P[axis]
        if w == "u":
            return u * P[axis]
        if w == "v":
            return v * P[axis]
        if w == "j":
            return PJ[axis]
        if w == "r":
            return PR[axis]
        if w == "cfb":   # cfb = j - (r - b1 - u·euy - v·evy)/edy
            return (PJ[axis] - inv * PR[axis]
                    + inv * (p.b1 * P[axis] + p.euy * u * P[axis]
                             + p.evy * v * P[axis]))
        if w == "w":     # w = j - cfb
            return (inv * PR[axis]
                    - inv * (p.b1 * P[axis] + p.euy * u * P[axis]
                             + p.evy * v * P[axis]))
        raise ValueError(w)

    return SlabParams(
        cxb=D("x", "1") - g2 * D("z", "1"),
        czb=D("z", "1"),
        b1=p.rx * D("x", "1") + D("y", "1") + p.rz * D("z", "1"),
        rx=D("x", "r") - g2 * D("z", "r"),
        rz=D("z", "r"),
        eux=(D("x", "u")
             - p.rz * euy_ieux * (D("z", "u")
                                  + (p.edx / p.eux) * D("z", "cfb")
                                  + PM / p.eux)),
        evx=D("x", "v") - g2 * D("z", "v"),
        evz=D("z", "v"),
        # dζ/dgzx = x - cx_r - v·evx = eux·u + edx·cfb + (x - px)
        gzx=p.eux * D("z", "u") + p.edx * D("z", "cfb") + PM,
        edx=D("x", "cfb"),
        # dζ/dedz = cf_xv + b — computed by the grid-weighted pass ZC
        # (cf_xv wraps mod 1 across the u_aff inversion offset, so no
        # sample-level (u, v, j, r)-affine expansion is exact)
        edz=ZC,
        edy=(D("y", "j") + p.rx * D("x", "w")
             + p.rz * (D("z", "w") - euy_ieux * p.rx * D("z", "cfb"))
             - p.rz * euy_ieux * inv * PM),
        euy=p.rx * D("x", "u") + D("y", "u") + p.rz * D("z", "u"),
        evy=p.rx * D("x", "v") + D("y", "v") + p.rz * D("z", "v"),
        euz=jnp.zeros((nu, nv), dtype),   # forward uses gzx, not euz
    )


def forward_view_jac(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                     dtype=jnp.float32, swap: bool | None = None,
                     yflip: bool | None = None):
    """Fused slab projection + analytic 6-DoF Jacobian for one view.

    Returns ``(det_img (n_det,), jac (6, n_det))``, parameter order
    ``(tx, ty, tz, phi, alpha, beta)`` — slab-family equivalent of
    :func:`tomojax.core.projector.forward_view_jac` (the reference's
    ``trilinear_ray_interp``, ``src/ray_wt_grad.f90:95-223``), arc mode.

    Built from NINE derivative projections ({x, y, z} hat-derivative ×
    {1, j, r} sample weights) of the same slab operator, combined in
    detector space with the autodiff Jacobian of the per-view scalars
    (:func:`_scalar_responses`). All nine run through the production
    operator's XLA path.

    Orientation flags must be static; ``None`` computes them host-side
    from concrete parameters (outside jit only). During refinement the
    flags are frozen at the initial estimate — jitter never crosses an
    octant boundary by more than the hat-support slack."""
    vol = jnp.asarray(vol).reshape(geom.vox_shape).astype(dtype)
    if swap is None or yflip is None:
        vw = Views.create(1, phi=np.asarray([float(phi)]),
                          alpha=np.asarray([float(alpha)]),
                          beta=np.asarray([float(beta)]))
        sw, yf, _ = orient_flags(vw, geom)
        swap, yflip = bool(sw[0]), bool(yf[0])
    vol_or = orient_volume(vol, geom, swap, yflip)
    th = jnp.concatenate([
        jnp.asarray(t, dtype).reshape(3),
        jnp.stack([jnp.asarray(phi, dtype), jnp.asarray(alpha, dtype),
                   jnp.asarray(beta, dtype)])])

    def params_of(th_):
        E, B = _oriented_affine_theta(geom, th_, cor, swap, yflip, False,
                                      dtype)
        return slab_params(E, B, dtype)

    p = params_of(th)
    dp = jax.jacfwd(params_of)(th)        # SlabParams of (6,) leaves

    val = _forward_oriented_xla(vol_or, p, geom, quad="arc", dtype=dtype)
    P, PJ, PR = {}, {}, {}
    for dv in ("x", "y", "z"):
        P[dv] = _forward_oriented_xla(vol_or, p, geom, quad="arc",
                                      dtype=dtype, deriv=dv)
        PJ[dv] = _forward_oriented_xla(vol_or, p, geom, quad="arc",
                                       dtype=dtype, deriv=dv, jweight=True)
        PR[dv] = _forward_oriented_xla(vol_or, p, geom, quad="arc",
                                       dtype=dtype, deriv=dv, rweight=True)
    PM = _forward_oriented_xla(vol_or, p, geom, quad="arc", dtype=dtype,
                               deriv="zm")
    ZC = _forward_oriented_xla(vol_or, p, geom, quad="arc", dtype=dtype,
                               deriv="zc")
    resp = _scalar_responses(p, P, PJ, PR, PM, ZC, geom, dtype)
    jac = sum(jnp.einsum("uv,k->kuv", r_field, d_field)
              for r_field, d_field in zip(resp, dp))
    return val.reshape(-1), jac.reshape(6, -1)


# ----------------------------------------------------------------------
# Per-view scalar rows: numpy/jnp builders, and the group forward
# ----------------------------------------------------------------------
#
# Operators are built from concrete views, so the per-view scalars of the
# oriented decomposition are computed once on the host in f64 and enter
# the device programs as (V, NS) arguments. Column layout:

NS = 18
(S_EDY, S_EDX, S_EDZ, S_RX, S_RZ, S_EUX, S_EVX, S_EVZ, S_CXB, S_CZB,
 S_GZX, S_B1, S_EUY, S_EVY, S_INV_EDY, S_ZAV, S_VOFF, S_ZOFF) = range(NS)
# S_VOFF/S_ZOFF: the detector-row and volume-plane offsets of a window
# (integers; zero except in the volume-sharded operator's shards)

# columns the plane kernel reads, in ``tomojax.kernels.slab.PARAMS`` order
_PLANE_COLS = np.array([S_RX, S_RZ, S_EUX, S_EVX, S_CXB, S_CZB, S_GZX,
                        S_ZAV, S_INV_EDY, S_VOFF, S_ZOFF])


def _scalar_columns(E, B, xp):
    """{column: value} of the scalar row from oriented ``(E, B)`` (per
    view, or batched along a leading axis with ``E[..., i, j]``)."""
    EU, EV, ED = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    edy = ED[..., 1]
    rx = ED[..., 0] / edy
    rz = ED[..., 2] / edy
    eux = EU[..., 0] - rx * EU[..., 1]
    evx = EV[..., 0] - rx * EV[..., 1]
    euz = EU[..., 2] - rz * EU[..., 1]
    evz = EV[..., 2] - rz * EV[..., 1]
    gzx = euz / eux
    return {
        S_EDY: edy, S_EDX: ED[..., 0], S_EDZ: ED[..., 2], S_RX: rx,
        S_RZ: rz, S_EUX: eux, S_EVX: evx, S_EVZ: evz,
        S_CXB: B[..., 0] - rx * B[..., 1],
        S_CZB: B[..., 2] - rz * B[..., 1],
        S_GZX: gzx, S_B1: B[..., 1], S_EUY: EU[..., 1], S_EVY: EV[..., 1],
        S_INV_EDY: 1.0 / edy, S_ZAV: evz - gzx * evx,
    }


def slab_scalars_np(geom: Geometry, views: Views, swap: bool, yflip: bool,
                    uflip: bool) -> np.ndarray:
    """(V, NS) scalar rows, computed host-side in f64 numpy (views are
    concrete when operators are built)."""
    phi = np.asarray(views.phi, np.float64)
    alpha = np.asarray(views.alpha, np.float64)
    beta = np.asarray(views.beta, np.float64)
    t = np.asarray(views.t, np.float64)
    cor = np.asarray(views.cor, np.float64)
    R = _np_rot(phi, alpha, beta)
    Rpa = _np_rot(phi, alpha, np.zeros_like(beta))
    du, dv = geom.det_pix
    E = np.stack([du * R[:, :, 0], dv * R[:, :, 2],
                  geom.step_size * R[:, :, 1]], axis=-1)
    nu, nv = geom.det_shape
    su, sv = geom.det_size
    s0 = np.stack([np.full_like(phi, -su / 2.0 + 0.5) + cor[:, 0],
                   np.full_like(phi, -geom.vox_size[1]),
                   np.full_like(phi, -sv / 2.0 + 0.5)], axis=-1)
    origin = geom.vox_origin_np()
    B = (np.einsum("nij,nj->ni", R, s0)
         + np.einsum("nij,nj->ni", Rpa, t) - origin[None, :])

    nx, ny, nz = geom.vox_shape
    ny_o = ny
    if swap:
        perm = _PERM_SWAP
        E = np.einsum("ij,njk->nik", perm, E)
        B = np.einsum("ij,nj->ni", perm, B)
        ny_o = nx
    if yflip:
        B[:, 1] = (ny_o - 1.0) - B[:, 1]
        E[:, 1, :] *= -1.0
    if uflip:
        B = B + (nu - 1.0) * E[:, :, 0]
        E[:, :, 0] *= -1.0

    sc = np.zeros((len(phi), NS), np.float64)
    for col, val in _scalar_columns(E, B, np).items():
        sc[:, col] = val
    return sc


def slab_scalars_jnp(geom: Geometry, theta6, cor, swap: bool, yflip: bool,
                     uflip: bool, dtype=jnp.float32):
    """(NS,) scalar row for ONE view as a traceable jnp function of
    ``theta6`` — the refinement loop recomputes per-view scalars from
    traced θ every iteration (the numpy twin :func:`slab_scalars_np`
    serves operator build, where views are concrete). vmap over views for
    a batch."""
    E, B = _oriented_affine_theta(geom, jnp.asarray(theta6, dtype),
                                  jnp.asarray(cor, dtype), swap, yflip,
                                  uflip, dtype)
    cols = _scalar_columns(E, B, jnp)
    zero = jnp.zeros_like(cols[S_EDY])
    return jnp.stack([cols.get(i, zero) for i in range(NS)]).astype(dtype)


def params_from_scalars(sc) -> SlabParams:
    """Rebuild :class:`SlabParams` from one scalar row (the XLA path
    inside ``shard_map``, where views are traced but the host computed
    the scalars at operator build)."""
    return SlabParams(
        edy=sc[S_EDY], edx=sc[S_EDX], edz=sc[S_EDZ],
        rx=sc[S_RX], rz=sc[S_RZ], eux=sc[S_EUX], evx=sc[S_EVX],
        euz=sc[S_GZX] * sc[S_EUX], evz=sc[S_EVZ],
        cxb=sc[S_CXB], czb=sc[S_CZB], gzx=sc[S_GZX],
        b1=sc[S_B1], euy=sc[S_EUY], evy=sc[S_EVY])


def forward_from_scalars_xla(vol_or, sc_row, geom: Geometry, quad: str,
                             dtype=jnp.float32):
    """One oriented view from a scalar row (XLA path) → (nu, nv)."""
    p = jax.tree.map(lambda a: a.astype(dtype), params_from_scalars(sc_row))
    return _forward_oriented_xla(vol_or, p, geom, quad=quad, dtype=dtype,
                                 v_off=sc_row[S_VOFF].astype(dtype),
                                 z_off=sc_row[S_ZOFF].astype(jnp.int32))


def _views_chunk(geom: Geometry, m: int, views_chunk: int | None) -> int:
    """Views per vmapped XLA chunk: a divisor of ``m``, by default about
    ``2**26`` voxel-views per chunk."""
    chunk = views_chunk or max(1, (1 << 26) // max(1, geom.n_vox))
    chunk = max(1, min(chunk, m))
    while m % chunk:
        chunk -= 1
    return chunk


def _forward_group_xla(vol_or, sc, geom: Geometry, quad: str, dtype,
                       views_chunk: int | None = None):
    """(V, NS) scalars → (V, nu, nv) through the XLA path, vmapped over
    view chunks and mapped over the chunks.

    Each chunk is rematerialized (``jax.checkpoint``): its transpose
    recomputes the chunk's gather indices and weights instead of keeping
    those of every view alive from the forward pass — at 256³ × 90 views
    that store took 31.7 GB of temporaries in one CGLS iteration."""
    @jax.checkpoint
    def f(vo, rows):
        return jax.vmap(lambda row: forward_from_scalars_xla(
            vo, row, geom, quad, dtype=dtype))(rows)

    m = sc.shape[0]
    chunk = _views_chunk(geom, m, views_chunk)
    if chunk >= m:
        return f(vol_or, sc)
    return lax.map(lambda rows: f(vol_or, rows),
                   sc.reshape(m // chunk, chunk, -1)
                   ).reshape(m, *geom.det_shape)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _plane_forward(vol_or, sc, geom: Geometry, views_chunk):
    """f32 plane-quadrature group forward: the Pallas-Triton kernel
    (:mod:`tomojax.kernels.slab`) when lowered for CUDA, the XLA path on
    every other platform. Its vjp is XLA's transpose of the XLA forward
    (w.r.t. the volume and the scalars alike)."""
    def kernel(vol_or, sc):
        from tomojax.kernels.slab import plane_forward
        return plane_forward(vol_or, sc[:, _PLANE_COLS], geom.det_shape)

    def xla(vol_or, sc):
        return _forward_group_xla(vol_or, sc, geom, "plane", jnp.float32,
                                  views_chunk)

    return lax.platform_dependent(vol_or, sc, cuda=kernel, default=xla)


def _plane_forward_fwd(vol_or, sc, geom, views_chunk):
    return _plane_forward(vol_or, sc, geom, views_chunk), (vol_or, sc)


def _plane_forward_bwd(geom, views_chunk, res, g):
    _, vjp_fn = jax.vjp(
        lambda v, s: _forward_group_xla(v, s, geom, "plane", jnp.float32,
                                        views_chunk), *res)
    return vjp_fn(g)


_plane_forward.defvjp(_plane_forward_fwd, _plane_forward_bwd)


def forward_group(vol_or, sc, geom: Geometry, quad: str, dtype=jnp.float32,
                  views_chunk: int | None = None):
    """Forward of one orientation group: oriented volume + ``(V, NS)``
    scalar rows → ``(V, nu, nv)`` (rows in the group's u-flipped order).
    f32 plane quadrature runs the GPU kernel on CUDA; everything else the
    XLA path."""
    if quad == "plane" and jnp.dtype(dtype) == jnp.float32:
        return _plane_forward(vol_or, sc.astype(jnp.float32), geom,
                              views_chunk)
    return _forward_group_xla(vol_or, sc.astype(dtype), geom, quad, dtype,
                              views_chunk)


def _orient_groups(views: Views, geom: Geometry):
    swaps, yflips, uflips = orient_flags(views, geom)
    for sw in (False, True):
        for yf in (False, True):
            for uf in (False, True):
                idx = np.nonzero((swaps == sw) & (yflips == yf)
                                 & (uflips == uf))[0]
                if idx.size:
                    yield idx, sw, yf, uf


@functools.lru_cache(maxsize=64)
def _public_apply_prog(geom: Geometry, gstruct, quad: str, dtype_str: str,
                       views_chunk, adjoint: bool):
    """One jitted whole-apply program per (geometry, group structure).

    The public :func:`project`/:func:`backproject` route through this so
    every op of the slab march lives in ONE device program (run eagerly,
    each op would be its own dispatch)."""
    dtype = jnp.dtype(dtype_str)
    if adjoint:
        def run(sino, scalars):
            return backproject_scalars(sino, geom, gstruct, scalars, quad,
                                       dtype=dtype,
                                       views_chunk=views_chunk)
    else:
        def run(vol, scalars):
            return project_scalars(vol, geom, gstruct, scalars, quad,
                                   dtype=dtype, views_chunk=views_chunk)
    return jax.jit(run)


def project(vol, geom: Geometry, views: Views, *, dtype=jnp.float32,
            quad: str = "arc", views_chunk: int | None = None):
    """Multi-view slab forward → ``(n_proj, n_det)``.

    Views are grouped host-side by orientation (swap, yflip, uflip); each
    group shares one oriented volume variant, no in-graph branching. The
    whole apply is one cached jitted program (per-view scalars enter as
    arguments, so new θ with the same group structure reuses the
    compilation)."""
    nx, ny, _ = geom.vox_shape
    assert nx == ny, "slab family requires nx == ny (square x-y footprint)"
    gstruct, scalars = scalar_groups(geom, views, dtype)
    prog = _public_apply_prog(geom, gstruct, quad, jnp.dtype(dtype).name,
                              views_chunk, False)
    return prog(vol, scalars)


def backproject(sino, geom: Geometry, views: Views, *, dtype=jnp.float32,
                quad: str = "arc", views_chunk: int | None = None):
    """Exact adjoint of :func:`project` (vjp of the linear forward)."""
    gstruct, scalars = scalar_groups(geom, views, dtype)
    prog = _public_apply_prog(geom, gstruct, quad, jnp.dtype(dtype).name,
                              views_chunk, True)
    return prog(jnp.asarray(sino), scalars)


# ----------------------------------------------------------------------
# Scalar-argument apply path: static group structure + traced scalars
# ----------------------------------------------------------------------
#
# The eager ``project``/``backproject`` above bake the per-view scalars
# into each call as constants, so a solver that closes over them would
# retrace/recompile every outer iteration of the alternating pipeline.
# The functions below split the operator into
#
#   scalar_groups(geom, views)  -> (static group structure, scalar arrays)
#   project_scalars / backproject_scalars(vol/sino, ..., scalars)
#
# so a solver program can be jit-compiled ONCE per (geometry, group
# structure) with the scalars as *arguments* — each outer iteration then
# reuses the compiled program with new scalar values (the alternating
# driver's per-outer θ updates never change shapes, and octant-group
# membership changes only when a view crosses an orientation boundary).


def scalar_groups(geom: Geometry, views: Views, dtype=jnp.float32):
    """Host-side split of concrete views into orientation groups.

    :returns: ``(gstruct, scalars)`` — ``gstruct`` is a hashable tuple of
        per-group ``(view_indices, swap, yflip, uflip)`` and ``scalars`` a
        matching tuple of ``(V_g, NS)`` scalar arrays (suitable as
        jitted-program arguments)."""
    views = jax.tree.map(np.asarray, views)
    gstruct, scalars = [], []
    for idx, sw, yf, uf in _orient_groups(views, geom):
        sc = slab_scalars_np(geom, _take_views(views, idx), sw, yf, uf)
        gstruct.append((tuple(int(i) for i in idx), bool(sw), bool(yf),
                        bool(uf)))
        scalars.append(jnp.asarray(sc, dtype))
    return tuple(gstruct), tuple(scalars)


def project_scalars(vol, geom: Geometry, gstruct, scalars,
                    quad: str = "arc", dtype=jnp.float32,
                    views_chunk: int | None = None):
    """Multi-view slab forward with (possibly traced) scalar arguments.

    Same math as :func:`project`; ``gstruct`` must come from
    :func:`scalar_groups` (static), ``scalars`` may be traced values of
    the same shapes."""
    n = sum(len(g[0]) for g in gstruct)
    vol = jnp.asarray(vol).astype(dtype).reshape(geom.vox_shape)
    out = jnp.zeros((n, geom.n_det), dtype=dtype)
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        vol_or = orient_volume(vol, geom, sw, yf)
        sino = forward_group(vol_or, sc, geom, quad, dtype, views_chunk)
        if uf:
            sino = sino[:, ::-1, :]
        out = out.at[jnp.asarray(idx)].set(
            sino.astype(dtype).reshape(len(idx), -1))
    return out


def backproject_scalars(sino, geom: Geometry, gstruct, scalars,
                        quad: str = "arc", dtype=jnp.float32,
                        views_chunk: int | None = None):
    """Exact adjoint of :func:`project_scalars` (vjp w.r.t. the volume)."""
    n = sum(len(g[0]) for g in gstruct)
    sino = jnp.asarray(sino).reshape(n, geom.n_det).astype(dtype)

    def fwd(v):
        return project_scalars(v, geom, gstruct, scalars, quad,
                               dtype=dtype, views_chunk=views_chunk)

    _, vjp_fn = jax.vjp(fwd, jnp.zeros(geom.vox_shape, dtype))
    (vol_bar,) = vjp_fn(sino)
    return vol_bar


def group_scalars_for(geom: Geometry, views: Views, gstruct,
                      dtype=jnp.float32):
    """Recompute scalar arrays for a FIXED group structure.

    The alternating driver freezes octant-group membership across outer
    iterations so its compiled solver program survives per-view θ updates
    (a boundary view flipping octants would otherwise change the static
    group structure and force a recompile). Frozen flags stay *valid* as
    long as the oriented frame still has ``edy > 0`` and ``eux > 0``
    (guaranteed by the flags at freeze time; ±0.02 rad refinement steps
    cannot cross the 90° sign boundaries, only the harmless 45°
    dominance boundary). Returns ``None`` if validity is lost — the
    caller should regroup via :func:`scalar_groups`."""
    views = jax.tree.map(np.asarray, views)
    scalars = []
    for idx, sw, yf, uf in gstruct:
        sub = _take_views(views, np.asarray(idx))
        sc = slab_scalars_np(geom, sub, sw, yf, uf)
        if not (np.all(sc[:, S_EDY] > 0.0) and np.all(sc[:, S_EUX] > 0.0)):
            return None
        scalars.append(jnp.asarray(sc, dtype))
    return tuple(gstruct), tuple(scalars)

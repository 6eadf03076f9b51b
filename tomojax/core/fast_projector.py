"""Fast multi-pass projector family — line-gathers + banded matmuls.

The exact ray-march projector (``projector.py``) needs 8 random volume
reads per sample — 268M element-gathers per 256³ view. This module
reformulates the same parallel-beam X-ray transform so that *all* memory
access is line-granular and all resampling arithmetic is elementwise or
matmul:

Sample points are affine in the (detector-u, detector-v, march-step-j)
indices: ``p(u, v, j) = B + u·EU + v·EV + j·ED`` (rigid transforms of the
affine detector/source grids of ``utilities/geometry.py:90-100``; march
per ``ray_voxel_utilities.py:88-94``). The trilinear sum over j then
factorizes into three 1-D affine resamples (z, then y, then x — each one
line-gather + three banded 0/1 matmuls + elementwise lerp weights) and a
final reduction over j. Each pass is exact 1-D linear interpolation; the
composition is a *multi-pass* discretization of the same transform — NOT
bitwise the reference's direct trilinear (per-(x,y)-corner the z-offset
differs by O(sin(jitter))), in the same way the reference's own voxel-driven
family (``vox_wt_grad.f90``) is a different discretization. The exact
family remains the parity/oracle path; this family is the speed path.

Adjoint: every op here is linear in the volume, so the exact transpose
comes from ``jax.linear_transpose`` — line-gathers transpose to line
scatters, matmuls to matmuls.

Axis handling: the march direction is ±y for ``|phi| < 45°`` (mod 180°)
and ±x otherwise; the x-marching case transposes the volume and swaps the
x/y rows of the affine map so one code path serves all angles
(views should be grouped by octant for batching; see ``project``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tomojax.core.geometry import Geometry, Views
from tomojax.core.rotations import rot_x, rot_y, rot_z
from tomojax.core.projector import _mm


def view_affine(geom: Geometry, phi, alpha, beta, t, cor, dtype):
    """Affine map (u, v, j) → sample position, origin-relative.

    ``p = R (s0 + u·du·x̂ + v·dv·ẑ + cor_x·x̂) + R_pa t − origin + j·step·R ŷ``
    with R = R_z R_x R_y (ray path). Columns: EU = du·R[:,0],
    EV = dv·R[:,2], ED = step·R[:,1].
    """
    phi = jnp.asarray(phi, dtype)
    alpha = jnp.asarray(alpha, dtype)
    beta = jnp.asarray(beta, dtype)
    t = jnp.asarray(t, dtype)
    cor = jnp.asarray(cor, dtype)

    r_pa = _mm(rot_z(phi), rot_x(alpha))
    R = _mm(r_pa, rot_y(beta))

    nu, nv = geom.det_shape
    su, sv = geom.det_size
    du = geom.det_pix[0]
    dv = geom.det_pix[1]
    u_lo = -su / 2.0 + 0.5
    v_lo = -sv / 2.0 + 0.5
    sy = geom.vox_size[1]

    s0 = jnp.asarray([u_lo, -sy, v_lo], dtype) + cor[0] * jnp.asarray(
        [1.0, 0.0, 0.0], dtype)
    origin = geom.vox_origin(dtype)
    B = _mm(R, s0) + _mm(r_pa, t) - origin

    EU = du * R[:, 0]
    EV = dv * R[:, 2]
    ED = jnp.asarray(geom.step_size, dtype) * R[:, 1]
    E = jnp.stack([EU, EV, ED], axis=1)
    return E, B


def _resample_minor(arr, offsets, slope, m_out: int, max_slope: float):
    """Affine 1-D resample along the minor axis of ``arr`` (A, B, N).

    ``out[a, b, i] = lerp(arr[a, b, :], offsets[a, b] + slope * i)`` with
    zero outside [0, N). Implementation: zero-pad, per-line integer-start
    line gather (slice granularity), then three banded 0/1 matmuls pick the
    i-dependent integer offsets and elementwise weights finish the lerp.
    ``max_slope`` bounds |slope| statically (octant guarantee); the sign of
    ``slope`` may be either (traced).

    Notes:
    - window gathers go through ``lax.gather`` of contiguous 1-D slices from
      the flattened padded buffer, not a vmapped ``dynamic_slice``;
    - the three banded matmuls are fused into one ``(A·B, q) × (q, 3M)``
      contraction at ``Precision.HIGHEST`` (exact for 0/1 selection; a
      lower precision would run f32 operands through TF32 on a GPU);
    - the output axis is chunked so windows never greatly exceed the data
      length N (long sweeps re-anchor per chunk).
    """
    A, Bc, N = arr.shape
    dtype = arr.dtype

    # chunk the output so each window stays near the data length
    max_chunk = max(int((N + 2) / max(max_slope, 1e-6)), 16)
    if m_out > max_chunk:
        n_chunks = -(-m_out // max_chunk)
        chunk = -(-m_out // n_chunks)
        outs = []
        for c0 in range(0, m_out, chunk):
            m_c = min(chunk, m_out - c0)
            outs.append(_resample_minor(arr, offsets + slope * c0, slope,
                                        m_c, max_slope))
        return jnp.concatenate(outs, axis=-1)

    n_win = int(np.ceil(max_slope * max(m_out - 1, 1))) + 3  # window length

    # zero-pad so any clamped window reads zeros outside the volume
    pad = n_win
    width = N + 2 * pad
    arr_p = jnp.pad(arr, ((0, 0), (0, 0), (pad, pad)))

    # window anchored at the minimum sampled position (handles slope < 0)
    minpos = jnp.minimum(slope * (m_out - 1), 0.0)
    k = jnp.floor(offsets + minpos)                         # (A, B)
    r = offsets + minpos - k                                # in [0, 1)
    k_start = jnp.clip(k.astype(jnp.int32) + pad, 0, width - n_win)
    # windows fully left of the volume read left-pad zeros unclamped; only
    # k > N clamps onto real data with stale weights — mask those lines out
    valid = (k <= N).astype(arr.dtype)

    # contiguous-slice gather from the flattened buffer
    flat = arr_p.reshape(A * Bc * width)
    row_base = (jnp.arange(A * Bc, dtype=jnp.int32) * width)
    starts = (row_base + k_start.reshape(-1))[:, None]      # (A·B, 1)
    dnums = lax.GatherDimensionNumbers(offset_dims=(1,),
                                       collapsed_slice_dims=(),
                                       start_index_map=(0,))
    lines = lax.gather(flat, starts, dnums, slice_sizes=(n_win,),
                       mode=lax.GatherScatterMode.CLIP)      # (A·B, n_win)
    lines = lines * valid.reshape(-1)[:, None]

    i = jnp.arange(m_out, dtype=dtype)
    si = slope * i - minpos                                 # (M,) ≥ 0
    k0 = jnp.floor(si)                                      # (M,)
    tau = (si - k0)[None, :] + r.reshape(-1)[:, None]       # (A·B, M) ∈ [0,2)

    # one fused banded selection matmul: (A·B, q) × (q, 3M)
    q_idx = jnp.arange(n_win, dtype=dtype)
    k0q = q_idx[None, :] - k0[:, None]                      # (M, n_win)
    sel = jnp.concatenate([(k0q == 0.0).astype(dtype),
                           (k0q == 1.0).astype(dtype),
                           (k0q == 2.0).astype(dtype)], axis=0)  # (3M, q)
    s_all = jax.lax.dot_general(lines, sel,
                                (((1,), (1,)), ((), ())),
                                precision=lax.Precision.HIGHEST)  # (A·B, 3M)
    s0v, s1v, s2v = (s_all[:, :m_out], s_all[:, m_out:2 * m_out],
                     s_all[:, 2 * m_out:])
    in_lo = tau < 1.0
    w0 = jnp.where(in_lo, 1.0 - tau, 0.0)
    w1 = jnp.where(in_lo, tau, 2.0 - tau)
    w2 = jnp.where(in_lo, 0.0, tau - 1.0)
    out = w0 * s0v + w1 * s1v + w2 * s2v
    return out.reshape(A, Bc, m_out)


def swap_flags(views: Views) -> np.ndarray:
    """Host-side octant decision per view: True → march along x (swap x/y).

    March direction is the rotated ŷ: ``ED = R[:, 1]``; swap iff
    ``|ED_x| > |ED_y|``. Views must be concrete (they are whenever an
    operator is built for an actual acquisition)."""
    phi = np.asarray(views.phi)
    alpha = np.asarray(views.alpha)
    beta = np.asarray(views.beta)
    # column 1 of R = R_z R_x R_y applied to ŷ (independent of beta)
    edx = -np.sin(phi) * np.cos(alpha)
    edy = np.cos(phi) * np.cos(alpha)
    return np.abs(edx) > np.abs(edy)


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor,
                 *, dtype=jnp.float32, swapped: bool | None = None):
    """Fast forward projection of one view → ``(n_det,)`` (u-major).

    ``swapped`` (static) selects the x-marching code path; None → decide
    in-graph with lax.cond (forward-only contexts; the cond is not
    linear-transposable, so the operator layer always passes it statically
    via octant grouping in :func:`project`).
    """
    vol = vol.reshape(geom.vox_shape).astype(dtype)
    E, B = view_affine(geom, phi, alpha, beta, t, cor, dtype)
    nx, ny, nz = geom.vox_shape
    perm = jnp.asarray([[0, 1, 0], [1, 0, 0], [0, 0, 1]], dtype)

    if swapped is True:
        assert nx == ny, "fast family x-marching needs nx == ny"
        return _forward_marching_y(vol.transpose(1, 0, 2), _mm(perm, E),
                                   _mm(perm, B), geom, dtype)
    if swapped is False:
        return _forward_marching_y(vol, E, B, geom, dtype)

    # swapped=None decides the octant in-graph, which requires the x/y swap
    # to be available — refuse nx != ny here rather than silently running the
    # unswapped path for x-dominant views
    if nx != ny:
        raise ValueError(
            "fast family forward_view(swapped=None) requires nx == ny "
            f"(got {nx} != {ny}); pass a static swapped flag or use the "
            "exact ray family")
    swap = jnp.abs(E[0, 2]) > jnp.abs(E[1, 2])

    def sw(_):
        return _forward_marching_y(vol.transpose(1, 0, 2), _mm(perm, E),
                                   _mm(perm, B), geom, dtype)

    def st(_):
        return _forward_marching_y(vol, E, B, geom, dtype)

    return lax.cond(swap, sw, st, None)


def _forward_marching_y(vol, E, B, geom: Geometry, dtype):
    """y-marching fast forward (|ED_y| dominant, |EU_x| bounded below)."""
    nx, ny, nz = vol.shape
    nu, nv = geom.det_shape
    nj = geom.n_steps

    EU, EV, ED = E[:, 0], E[:, 1], E[:, 2]
    G = jnp.linalg.inv(E)

    # ---- pass 1: resample z; I1(x, y, v) = vol(x, y, ζ(x, y, v)) --------
    # v-consistency: G[1]·(p − B) = v  ⇒  ζ = Bz + (v − G10(x−Bx) − G11(y−By))/G12
    x_idx = jnp.arange(nx, dtype=dtype)
    y_idx = jnp.arange(ny, dtype=dtype)
    inv_g12 = 1.0 / G[1, 2]
    zeta0 = (B[2] + (-G[1, 0] * (x_idx[:, None] - B[0])
                     - G[1, 1] * (y_idx[None, :] - B[1])) * inv_g12)
    zeta_slope = inv_g12
    # |1/G12| ≈ dv·(1 + O(jitter)); static bound 1.2·dv covers ±10° jitter
    i1 = _resample_minor(vol, zeta0, zeta_slope, nv,
                         max_slope=1.2 * geom.det_pix[1])

    # ---- pass 2: resample y; I2(x, j, v) = I1(x, y*(x, j, v), v) --------
    # u(x, j, v) = (x − Bx − EVx v − EDx j)/EUx;  y* = By + EUy u + EVy v + EDy j
    i1_t = i1.transpose(0, 2, 1)  # (nx, nv, ny)
    v_idx = jnp.arange(nv, dtype=dtype)
    inv_eux = 1.0 / E[0, 0]
    cu = EU[1] * inv_eux
    y0 = (B[1] + cu * (x_idx[:, None] - B[0] - EV[0] * v_idx[None, :])
          + EV[1] * v_idx[None, :])
    yj = ED[1] - cu * ED[0]
    # |yj| = step·det2/R00 ≤ step/cos45° · (1 + O(jitter)); 1.6·step is safe
    i2 = _resample_minor(i1_t, y0, yj, nj,
                         max_slope=1.6 * geom.step_size)

    # ---- pass 3: resample x + reduce j ----------------------------------
    # x*(u, j, v) = Bx + EUx u + EVx v + EDx j
    i2_t = i2.transpose(2, 1, 0)  # (nj, nv, nx)
    j_idx = jnp.arange(nj, dtype=dtype)
    x0 = B[0] + EV[0] * v_idx[None, :] + ED[0] * j_idx[:, None]
    out = _resample_minor(i2_t, x0, EU[0], nu,
                          max_slope=1.2 * geom.det_pix[0])  # (nj, nv, nu)
    sino = jnp.sum(out, axis=0)  # (nv, nu)
    return sino.T.reshape(-1)    # u-major like the exact family


def _take_views(views: Views, idx) -> Views:
    return jax.tree.map(lambda a: a[idx], views)


def _project_group(vol, geom: Geometry, views: Views, swapped: bool, dtype,
                   views_chunk):
    """All views in one octant group: the volume transpose (if any) is
    shared, no in-graph branching."""
    if swapped:
        vol_use = vol.reshape(geom.vox_shape).astype(dtype).transpose(1, 0, 2)
    else:
        vol_use = vol.reshape(geom.vox_shape).astype(dtype)
    perm = jnp.asarray([[0, 1, 0], [1, 0, 0], [0, 0, 1]], dtype)

    def f(v):
        E, B = view_affine(geom, v.phi, v.alpha, v.beta, v.t, v.cor, dtype)
        if swapped:
            E, B = _mm(perm, E), _mm(perm, B)
        return _forward_marching_y(vol_use, E, B, geom, dtype)

    n = views.n_proj
    chunk = views_chunk or max(1, min(n, (1 << 26) // max(1, geom.n_vox)))
    chunk = max(1, min(chunk, n))
    while n % chunk:
        chunk -= 1
    if chunk >= n:
        return jax.vmap(f)(views)
    views_c = jax.tree.map(lambda a: a.reshape(n // chunk, chunk,
                                               *a.shape[1:]), views)
    out = lax.map(jax.vmap(f), views_c)
    return out.reshape(n, -1)


def project(vol, geom: Geometry, views: Views, *, dtype=jnp.float32,
            views_chunk: int | None = None):
    """Multi-view fast forward → ``(n_proj, n_det)``.

    Views are grouped by marching octant on the host (no in-graph
    branching; each group shares one volume transpose). Requires concrete
    views and nx == ny (true for every reference use case).
    """
    nx, ny, _ = geom.vox_shape
    assert nx == ny, "fast family requires nx == ny (square x-y footprint)"
    flags = swap_flags(views)
    n = views.n_proj
    out = jnp.zeros((n, geom.n_det), dtype=dtype)
    for swapped in (False, True):
        idx = np.nonzero(flags == swapped)[0]
        if idx.size == 0:
            continue
        part = _project_group(vol, geom, _take_views(views, idx), swapped,
                              dtype, views_chunk)
        out = out.at[jnp.asarray(idx)].set(part)
    return out


def backproject(sino, geom: Geometry, views: Views, *, dtype=jnp.float32,
                views_chunk: int | None = None):
    """Exact adjoint of :func:`project` (line-gathers transpose to line
    scatters, matmuls to matmuls).

    Implemented with ``jax.vjp`` linearized at zero — identical to the
    transpose for a linear map (the forward-on-zeros primal is dead code
    XLA largely folds away), and unlike ``jax.linear_transpose`` it works
    through ``lax.cond``.
    """
    flags = swap_flags(views)
    sino = sino.reshape(geom.n_proj, geom.n_det).astype(dtype)
    acc = jnp.zeros(geom.vox_shape, dtype)
    for swapped in (False, True):
        idx = np.nonzero(flags == swapped)[0]
        if idx.size == 0:
            continue
        sub = _take_views(views, jnp.asarray(idx))
        fwd = lambda v: _project_group(v, geom, sub, swapped, dtype,
                                       views_chunk)
        ct = sino[jnp.asarray(idx)]
        _, vjp_fn = jax.vjp(fwd, jnp.zeros(geom.vox_shape, dtype))
        (vol_bar,) = vjp_fn(ct)
        acc = acc + vol_bar
    return acc

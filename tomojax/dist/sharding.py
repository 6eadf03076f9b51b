"""Projection-angle (+ detector-ray) data parallelism over a device mesh.

Replacement for the reference's MPI layer (``recon/sirt_mpi.py``,
``recon/cgls_mpi.py``, ``recon/regularized_mpi.py``):

| reference (mpi4py)                                   | here                        |
|------------------------------------------------------|-----------------------------|
| rank owns ``array_split(arange(n_proj), size)[rank]`` | mesh axis ``"proj"``; views |
|   (``sirt_mpi.py:40``)                               |   sharded by ``shard_map``  |
| volume-sized ``Allreduce`` of Aᵀr (``sirt_mpi.py:103``)| ``lax.psum`` over ``"proj"``|
| scalar ``allreduce`` of norms (``sirt_mpi.py:110``)  | psum'd inside the same jit  |
| rank-0 TV-prox + ``bcast`` (``regularized_mpi.py:118-137``) | replicated determinis-  |
|                                                      |   tic compute — no bcast    |
| ``Barrier`` (``cgls_mpi.py:54``)                     | none (SPMD program order)   |

A second mesh axis ``"ray"`` shards the *detector* dimension within every
view (each ray is independent in the forward; the adjoint psums over both
axes) — the intra-sample parallelism axis the reference does not have.

The sharded operator exposes the same ``TomoOperator`` interface, so every
solver in ``tomojax.recon`` runs unmodified on a mesh: the psum appears
inside ``A``/``AT`` exactly where the reference placed its Allreduce.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from tomojax.core.geometry import Geometry, Views
from tomojax.core.operators import TomoOperator
from tomojax.core import projector as ray_proj


def make_mesh(n_proj_shards: int | None = None, n_ray_shards: int = 1,
              devices=None) -> Mesh:
    """Build a ``("proj", "ray")`` mesh. Defaults to all devices on the
    ``proj`` axis (the reference's only strategy: angle data-parallelism).
    The second axis doubles as the volume axis for
    :func:`make_volume_sharded_operator`."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_proj_shards is None:
        n_proj_shards = devices.size // n_ray_shards
    assert n_proj_shards * n_ray_shards == devices.size, (
        f"{n_proj_shards} x {n_ray_shards} != {devices.size} devices")
    return Mesh(devices.reshape(n_proj_shards, n_ray_shards),
                axis_names=("proj", "ray"))


def shard_views(views: Views, mesh: Mesh) -> Views:
    """Place the views pytree with its leading axis sharded over ``proj``."""
    sharding = NamedSharding(mesh, P("proj"))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), views)


def make_sharded_operator(geom: Geometry, views: Views, mesh: Mesh, *,
                          dtype=jnp.float32, views_chunk: int | None = None,
                          family: str = "ray") -> TomoOperator:
    """Angle(+ray)-sharded matrix-free operator with the reference's MPI
    semantics mapped to XLA collectives. ``n_proj`` must divide the ``proj``
    axis size and ``n_det`` the ``ray`` axis size.

    ``family="fast"`` shards the multi-pass projector over ``proj`` only
    (the detector is produced whole per view; use ``n_ray_shards=1``).
    """
    n_pshard = mesh.shape["proj"]
    n_rshard = mesh.shape["ray"]
    assert geom.n_proj % n_pshard == 0, (geom.n_proj, n_pshard)
    assert geom.n_det % n_rshard == 0, (geom.n_det, n_rshard)
    ray_count = geom.n_det // n_rshard

    if family in ("slab", "slab_plane"):
        assert n_rshard == 1, "slab family shards over 'proj' only"
        return _make_slab_sharded(geom, views, mesh, n_pshard,
                                  quad=("arc" if family == "slab"
                                        else "plane"), dtype=dtype,
                                  views_chunk=views_chunk)

    if family == "fast":
        assert n_rshard == 1, "fast family shards over 'proj' only"
        from tomojax.core import fast_projector as fastp

        # views are traced inside shard_map, so the host-side octant
        # grouping is unavailable — use the in-graph lax.cond variant
        # (both octant branches execute under vmap; ~2× forward cost)
        def _one(vol, vv):
            return fastp.forward_view(vol, geom, vv.phi, vv.alpha, vv.beta,
                                      vv.t, vv.cor, dtype=dtype,
                                      swapped=None)

        def _fwd_local(vol, v: Views):
            return jax.vmap(lambda vv: _one(vol, vv))(v)

        def _adj_local(y, v: Views):
            _, vjp_fn = jax.vjp(lambda vol: _fwd_local(vol, v),
                                jnp.zeros(geom.vox_shape, dtype))
            (local,) = vjp_fn(y)
            return lax.psum(local, ("proj", "ray"))

        vspec_f = Views(phi=P("proj"), alpha=P("proj"), beta=P("proj"),
                        t=P("proj"), cor=P("proj"))
        A_f = shard_map(_fwd_local, mesh=mesh, in_specs=(P(), vspec_f),
                        out_specs=P("proj"), check_vma=False)
        AT_f = shard_map(_adj_local, mesh=mesh,
                         in_specs=(P("proj"), vspec_f), out_specs=P(),
                         check_vma=False)

        def A_fn(x):
            return A_f(x.reshape(geom.vox_shape).astype(dtype), views)

        def AT_fn(y):
            return AT_f(y.reshape(geom.n_proj, geom.n_det).astype(dtype),
                        views)

        return TomoOperator(geom=geom, views=views, A=A_fn, AT=AT_fn,
                            family="fast-sharded", dtype=dtype)

    def _local_forward(vol, v: Views):
        """Forward for this shard's views over this shard's rays."""
        ray_offset = lax.axis_index("ray") * ray_count

        def one(view):
            return ray_proj.forward_view(
                vol, geom, view.phi, view.alpha, view.beta, view.t, view.cor,
                dtype=dtype, ray_offset=ray_offset, ray_count=ray_count)

        return jax.vmap(one)(v)

    def _local_adjoint(y, v: Views):
        ray_offset = lax.axis_index("ray") * ray_count

        def one(y_i, view):
            return ray_proj.backproject_view(
                y_i, geom.vox_shape, geom, view.phi, view.alpha, view.beta,
                view.t, view.cor, dtype=dtype, ray_offset=ray_offset,
                ray_count=ray_count)

        local = jnp.sum(jax.vmap(one)(y, v), axis=0)
        # the reference's volume-sized Allreduce (sirt_mpi.py:103) → psum
        return lax.psum(local, ("proj", "ray"))

    vspec = Views(phi=P("proj"), alpha=P("proj"), beta=P("proj"),
                  t=P("proj"), cor=P("proj"))

    A = shard_map(_local_forward, mesh=mesh,
                  in_specs=(P(), vspec), out_specs=P("proj", "ray"),
                  check_vma=False)
    AT_local = shard_map(_local_adjoint, mesh=mesh,
                         in_specs=(P("proj", "ray"), vspec), out_specs=P(),
                         check_vma=False)

    def A_fn(x):
        return A(x.reshape(geom.vox_shape).astype(dtype), views)

    def AT_fn(y):
        return AT_local(y.reshape(geom.n_proj, geom.n_det).astype(dtype),
                        views)

    return TomoOperator(geom=geom, views=views, A=A_fn, AT=AT_fn,
                        family="ray-sharded", dtype=dtype)


def _make_slab_sharded(geom: Geometry, views: Views, mesh: Mesh,
                       n_pshard: int, *, quad: str, dtype,
                       views_chunk: int | None = None) -> TomoOperator:
    """Angle-sharded slab-family operator with build-time octant grouping.

    Views are grouped host-side by (swap, yflip, uflip) orientation at
    operator build (they are concrete there), each group padded to a
    ``proj``-axis multiple, and the per-view *scalar rows* — not the
    views — are sharded into ``shard_map``. This removes the in-graph
    ``lax.cond`` octant dispatch that made the sharded fast family
    execute both octant branches, and each shard runs the same group
    forward as the single-device operator
    (:func:`~tomojax.core.slab_projector.forward_group`: the plane kernel
    on CUDA, the XLA path elsewhere)."""
    from tomojax.core import slab_projector as slabp

    views_np = jax.tree.map(np.asarray, views)
    n = views_np.n_proj

    groups = []
    for idx, sw, yf, uf in slabp._orient_groups(views_np, geom):
        sub = jax.tree.map(lambda a: a[idx], views_np)
        sc = slabp.slab_scalars_np(geom, sub, sw, yf, uf)
        pad = (-len(idx)) % n_pshard
        if pad:
            sc = np.concatenate([sc, np.repeat(sc[-1:], pad, axis=0)])
        groups.append((idx, sw, yf, uf,
                       jnp.asarray(sc, jnp.float32), pad))

    nu, nv = geom.det_shape

    def _group_fns(sw, yf, uf):
        def fwd_or(vol_or, sc_shard):
            return slabp.forward_group(vol_or, sc_shard, geom, quad, dtype,
                                       views_chunk)

        def fwd_local(vol, sc_shard):
            return fwd_or(slabp.orient_volume(vol, geom, sw, yf), sc_shard)

        def adj_local(g_shard, sc_shard):
            _, vjp_fn = jax.vjp(lambda v: fwd_or(v, sc_shard), jnp.zeros(
                slabp.orient_volume(jnp.zeros(geom.vox_shape, dtype),
                                    geom, sw, yf).shape, dtype))
            (vol_or_bar,) = vjp_fn(g_shard)
            # the reference's volume-sized Allreduce (sirt_mpi.py:103)
            vol_or_bar = lax.psum(vol_or_bar, ("proj", "ray"))
            return vol_or_bar

        # jitted: the group forward rematerializes per view chunk, and
        # shard_map cannot run that eagerly
        A_g = jax.jit(shard_map(fwd_local, mesh=mesh,
                                in_specs=(P(), P("proj")),
                                out_specs=P("proj"), check_vma=False))
        AT_g = jax.jit(shard_map(adj_local, mesh=mesh,
                                 in_specs=(P("proj"), P("proj")),
                                 out_specs=P(), check_vma=False))
        return A_g, AT_g

    fns = {(sw, yf, uf): _group_fns(sw, yf, uf)
           for _, sw, yf, uf, _, _ in groups}

    def A_fn(x):
        vol = x.reshape(geom.vox_shape).astype(dtype)
        out = jnp.zeros((n, geom.n_det), dtype=dtype)
        for idx, sw, yf, uf, sc, pad in groups:
            sino = fns[(sw, yf, uf)][0](vol, sc)       # (Vg+pad, nu, nv)
            if pad:
                sino = sino[:len(idx)]
            if uf:
                sino = sino[:, ::-1, :]
            out = out.at[jnp.asarray(idx)].set(sino.reshape(len(idx), -1))
        return out

    def AT_fn(y):
        y = y.reshape(n, geom.n_det).astype(dtype)
        acc = jnp.zeros(geom.vox_shape, dtype)
        for idx, sw, yf, uf, sc, pad in groups:
            g = y[jnp.asarray(idx)].reshape(len(idx), nu, nv)
            if uf:
                g = g[:, ::-1, :]
            if pad:
                g = jnp.concatenate(
                    [g, jnp.zeros((pad, nu, nv), dtype)], axis=0)
            vol_or_bar = fns[(sw, yf, uf)][1](g, sc)
            # un-orient: inverse of orient_volume (yflip then transpose)
            if yf:
                vol_or_bar = vol_or_bar[:, ::-1, :]
            if sw:
                vol_or_bar = vol_or_bar.transpose(1, 0, 2)
            acc = acc + vol_or_bar
        return acc

    return TomoOperator(geom=geom, views=views, A=A_fn, AT=AT_fn,
                        family=f"{'slab' if quad == 'arc' else 'slab_plane'}"
                               "-sharded", dtype=dtype)


def make_volume_sharded_slab_operator(geom: Geometry, views: Views,
                                      mesh: Mesh, *, quad: str = "arc",
                                      dtype=jnp.float32,
                                      halo: int = 32) -> TomoOperator:
    """Volume-sharded slab-family operator: volume z-axis and detector
    v-axis distributed over the mesh's second axis, views over ``proj``.

    The slab decomposition's z↔v mapping is a near-unit diagonal (the
    march axis lies in the x-y plane for every view), so detector block
    ``v ∈ [v0, v0+nvl)`` reads only volume planes ``z ∈ [v0-H, v0+nvl+H)``
    — a fixed ``H``-plane halo exchanged with mesh neighbors
    (``lax.ppermute``), the tomographic analog of ring-attention/CP
    context sharding (SURVEY §5). The z axis survives every orientation
    transform (swap/yflip act on x/y, uflip on u), which is why it is the
    correct spatial shard axis for all view octants. Enables volumes
    larger than one card's memory for the production projector family
    (the reference always replicates the volume, ``sirt_mpi.py:56``).

    Per-view jitter must satisfy ``|offset| < H`` (checked host-side from
    the scalar vectors: the z-v diagonal intercept stays within the halo).
    """
    from tomojax.core import slab_projector as slabp

    n_pshard = mesh.shape["proj"]
    vol_axis = [a for a in mesh.axis_names if a != "proj"][0]
    n_vshard = mesh.shape[vol_axis]
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    assert nz % n_vshard == 0 and nv % n_vshard == 0
    nzl = nz // n_vshard
    nvl = nv // n_vshard
    H = min(halo, nzl)
    views_np = jax.tree.map(np.asarray, views)
    n = views_np.n_proj

    # local geometry: z-block + halos, v-block; the y extent (ray length /
    # sample count) is unchanged so arc-mode march indices stay global
    local_geom = Geometry(n_proj=geom.n_proj,
                          vox_shape=(nx, ny, nzl + 2 * H),
                          det_shape=(nu, nvl), vox_pix=geom.vox_pix,
                          det_pix=geom.det_pix, step_size=geom.step_size)

    groups = []
    for idx, sw, yf, uf in slabp._orient_groups(views_np, geom):
        sub = jax.tree.map(lambda a: a[idx], views_np)
        sc = slabp.slab_scalars_np(geom, sub, sw, yf, uf)
        # halo sufficiency: the z-v diagonal intercept (czb + rz*r - v*zav
        # deviation) must stay within H for every slab
        zoff_max = (np.abs(sc[:, slabp.S_CZB])
                    + np.abs(sc[:, slabp.S_RZ]) * ny
                    + np.abs(sc[:, slabp.S_ZAV] - 1.0) * nv + 4)
        assert np.all(zoff_max < H), (
            f"halo {H} too small for per-view offsets {zoff_max.max():.1f}")
        pad = (-len(idx)) % n_pshard
        if pad:
            sc = np.concatenate([sc, np.repeat(sc[-1:], pad, axis=0)])
        groups.append((idx, sw, yf, uf, jnp.asarray(sc, jnp.float32), pad))

    def _shift_scalars(sc_shard):
        """Place the shard's window: detector rows from ``i*nvl``, volume
        plane ``z`` at local index ``z + H - i*nzl`` (integer offsets, so
        every position is computed as on one device)."""
        i = lax.axis_index(vol_axis)
        sc = sc_shard.at[:, slabp.S_VOFF].set((i * nvl).astype(sc_shard.dtype))
        return sc.at[:, slabp.S_ZOFF].set((H - i * nzl).astype(sc.dtype))

    def _halo_exchange(vol_local):
        """(nx, ny, nzl) → (nx, ny, nzl + 2H) with neighbor halos."""
        idxs = np.arange(n_vshard)
        left = lax.ppermute(vol_local[:, :, -H:], vol_axis,
                            [(j, j + 1) for j in idxs[:-1]])
        right = lax.ppermute(vol_local[:, :, :H], vol_axis,
                             [(j + 1, j) for j in idxs[:-1]])
        return jnp.concatenate([left, vol_local, right], axis=2)

    def _group_fns(sw, yf, uf):
        def fwd_local(vol_shard, sc_shard):
            sc_loc = _shift_scalars(sc_shard)
            vol_halo = _halo_exchange(vol_shard)
            vol_or = slabp.orient_volume(vol_halo, local_geom, sw, yf)
            return slabp.forward_group(vol_or, sc_loc, local_geom, quad,
                                       dtype)           # (Vl, nu, nvl)

        def adj_local(g_shard, sc_shard):
            fwd = lambda v: fwd_local(v, sc_shard)
            _, vjp_fn = jax.vjp(fwd, jnp.zeros((nx, ny, nzl), dtype))
            (vbar,) = vjp_fn(g_shard)
            return lax.psum(vbar, "proj")

        A_g = jax.jit(shard_map(
            fwd_local, mesh=mesh,
            in_specs=(P(None, None, vol_axis), P("proj")),
            out_specs=P("proj", None, vol_axis), check_vma=False))
        AT_g = jax.jit(shard_map(
            adj_local, mesh=mesh,
            in_specs=(P("proj", None, vol_axis), P("proj")),
            out_specs=P(None, None, vol_axis), check_vma=False))
        return A_g, AT_g

    fns = {(sw, yf, uf): _group_fns(sw, yf, uf)
           for _, sw, yf, uf, _, _ in groups}

    def A_fn(x):
        vol = x.reshape(geom.vox_shape).astype(dtype)
        out = jnp.zeros((n, geom.n_det), dtype=dtype)
        for idx, sw, yf, uf, sc, pad in groups:
            sino = fns[(sw, yf, uf)][0](vol, sc)        # (Vg+pad, nu, nv)
            if pad:
                sino = sino[:len(idx)]
            if uf:
                sino = sino[:, ::-1, :]
            out = out.at[jnp.asarray(idx)].set(sino.reshape(len(idx), -1))
        return out

    def AT_fn(y):
        y = y.reshape(n, geom.n_det).astype(dtype)
        acc = jnp.zeros(geom.vox_shape, dtype)
        for idx, sw, yf, uf, sc, pad in groups:
            g = y[jnp.asarray(idx)].reshape(len(idx), nu, nv)
            if uf:
                g = g[:, ::-1, :]
            if pad:
                g = jnp.concatenate(
                    [g, jnp.zeros((pad, nu, nv), dtype)], axis=0)
            acc = acc + fns[(sw, yf, uf)][1](g, sc)
        return acc

    return TomoOperator(geom=geom, views=views, A=A_fn, AT=AT_fn,
                        family=f"slab-volume-sharded-{quad}", dtype=dtype)


def sharded_refine_views(vol, projections, geom: Geometry, views: Views,
                         mesh: Mesh, *, mask=None, lower=None, upper=None,
                         max_iter: int = 20, dtype=jnp.float32):
    """Per-view 6-DoF refinement sharded over the ``proj`` axis — each
    device refines its own views (embarrassingly parallel, like the
    reference's per-rank view loop would be if it distributed alignment)."""
    from tomojax.align.refine import refine_views, PARAM_SETS

    if mask is None:
        mask = PARAM_SETS["xzab"]
    n = views.n_proj
    projections = jnp.asarray(projections, dtype).reshape(n, -1)

    def local(p_shard, v_shard):
        res = refine_views(vol, p_shard, geom, v_shard, mask=mask,
                           lower=lower, upper=upper, max_iter=max_iter,
                           dtype=dtype)
        return res.theta6, res.cost

    vspec = Views(phi=P("proj"), alpha=P("proj"), beta=P("proj"),
                  t=P("proj"), cor=P("proj"))
    f = shard_map(local, mesh=mesh,
                  in_specs=(P("proj"), vspec),
                  out_specs=(P("proj"), P("proj")), check_vma=False)
    return f(projections, views)


def make_volume_sharded_operator(geom: Geometry, views: Views, mesh: Mesh, *,
                                 dtype=jnp.float32) -> TomoOperator:
    """Volume-sharded operator: the volume's x-axis is distributed over the
    mesh's second axis — the spatial-sharding analog the reference lacks
    (its volume is always fully replicated per rank, ``sirt_mpi.py:56``;
    SURVEY §5 names this the long-context/ring-attention analog).

    Uses the voxel-driven family, whose per-voxel work decomposes cleanly
    under a spatial partition with NO halo exchange: forward = psum of each
    shard's bilinear splat; adjoint = per-shard gather from the (replicated)
    detector. Views are simultaneously sharded over ``proj``. Enables
    volumes larger than one card's memory.

    Requires ``nx %% vol_shards == 0`` and ``n_proj %% proj_shards == 0``.
    """
    from tomojax.core import voxel_projector as vox

    n_pshard = mesh.shape["proj"]
    vol_axis = [a for a in mesh.axis_names if a != "proj"][0]
    n_vshard = mesh.shape[vol_axis]
    nx, ny, nz = geom.vox_shape
    assert nx % n_vshard == 0, (nx, n_vshard)
    assert geom.n_proj % n_pshard == 0, (geom.n_proj, n_pshard)
    nx_loc = nx // n_vshard

    # per-axis center values as small host constants (nx + ny + nz floats);
    # each shard slices its x block and broadcasts in-graph — never the full
    # (3, nx, ny, nz) grid, so per-device memory is O(local volume), not 3x
    # the full volume (the point of spatial sharding)
    sx, sy, sz = geom.vox_size
    x_axis = geom._axis_centers(nx, sx)
    y_axis = geom._axis_centers(ny, sy)
    z_axis = geom._axis_centers(nz, sz)

    def _local_centers(dtype):
        i = lax.axis_index(vol_axis)
        x = lax.dynamic_slice_in_dim(jnp.asarray(x_axis, dtype), i * nx_loc,
                                     nx_loc)
        y = jnp.asarray(y_axis, dtype)
        z = jnp.asarray(z_axis, dtype)
        shape = (nx_loc, ny, nz)
        X = jnp.broadcast_to(x[:, None, None], shape)
        Y = jnp.broadcast_to(y[None, :, None], shape)
        Z = jnp.broadcast_to(z[None, None, :], shape)
        return jnp.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)])

    def _fwd_local(x_shard, v: Views):
        centers = _local_centers(dtype)

        def one(vv):
            rc = vox.voxel_transform(centers, vv.alpha, vv.beta, vv.phi,
                                     vv.t)
            orig = geom.vox_origin(dtype) - vv.cor
            ds = jnp.asarray(geom.vox_ds, dtype)
            px = (rc[0] - orig[0]) / ds[0]
            pz = (rc[2] - orig[2]) / ds[2]
            fx = jnp.floor(px)
            fz = jnp.floor(pz)
            ax = px - fx
            az = pz - fz
            rec = x_shard.reshape(-1).astype(dtype)
            out = jnp.zeros((geom.n_det,), dtype=dtype)
            for lin, w, _ in vox._corner_scatter_ops(
                    fx.astype(jnp.int32), fz.astype(jnp.int32), ax, az,
                    geom.det_shape):
                out = out.at[lin].add(w * rec)
            return out

        local = jax.vmap(one)(v)
        # each shard splats only its voxels: sum shards; proj stays sharded
        return lax.psum(local, vol_axis)

    def _adj_local(y_shard, v: Views):
        centers = _local_centers(dtype)

        def one(y_i, vv):
            rc = vox.voxel_transform(centers, vv.alpha, vv.beta, vv.phi,
                                     vv.t)
            orig = geom.vox_origin(dtype) - vv.cor
            ds = jnp.asarray(geom.vox_ds, dtype)
            px = (rc[0] - orig[0]) / ds[0]
            pz = (rc[2] - orig[2]) / ds[2]
            fx = jnp.floor(px)
            fz = jnp.floor(pz)
            ax = px - fx
            az = pz - fz
            acc = jnp.zeros((nx_loc * ny * nz,), dtype=dtype)
            yy = y_i.reshape(-1).astype(dtype)
            for lin, w, _ in vox._corner_scatter_ops(
                    fx.astype(jnp.int32), fz.astype(jnp.int32), ax, az,
                    geom.det_shape):
                acc = acc + w * jnp.take(yy, lin, axis=0)
            return acc.reshape(nx_loc, ny, nz)

        # sum over this shard's views, then over the proj axis: each shard
        # keeps only ITS x-block of the volume
        local = jnp.sum(jax.vmap(one)(y_shard, v), axis=0)
        return lax.psum(local, "proj")

    vspec = Views(phi=P("proj"), alpha=P("proj"), beta=P("proj"),
                  t=P("proj"), cor=P("proj"))
    A_sh = shard_map(_fwd_local, mesh=mesh,
                     in_specs=(P(vol_axis), vspec), out_specs=P("proj"),
                     check_vma=False)
    AT_sh = shard_map(_adj_local, mesh=mesh,
                      in_specs=(P("proj"), vspec), out_specs=P(vol_axis),
                      check_vma=False)

    def A_fn(x):
        return A_sh(x.reshape(geom.vox_shape).astype(dtype), views)

    def AT_fn(y):
        return AT_sh(y.reshape(geom.n_proj, geom.n_det).astype(dtype),
                     views)

    return TomoOperator(geom=geom, views=views, A=A_fn, AT=AT_fn,
                        family="voxel-volume-sharded", dtype=dtype)

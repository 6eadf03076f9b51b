"""The fast family's resample primitive against a NumPy lerp, and the
Pallas-Triton slab plane-forward kernel (interpret mode on the CPU; compiled
on a GPU by the ``gpu``-marked test) against the XLA plane forward."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tomojax.core.fast_projector import _resample_minor
from tomojax.core.geometry import Geometry, Views
from tomojax.core import phantom
from tomojax.core import slab_projector as sp
from tomojax.kernels.slab import plane_forward

F32 = jnp.float32


def _lerp_ref(arr, pos):
    """out[a, i] = linear interpolation of arr[a] at pos[a, i], zero
    outside [0, N) tap by tap (f64)."""
    A, N = arr.shape
    f = np.floor(pos)
    w = pos - f
    k = f.astype(np.int64)
    out = np.zeros(pos.shape)
    rows = np.arange(A)[:, None]
    for o, wt in ((0, 1.0 - w), (1, w)):
        kk = k + o
        ok = (kk >= 0) & (kk < N)
        out += np.where(ok, wt * arr[rows, np.clip(kk, 0, N - 1)], 0.0)
    return out


@pytest.mark.parametrize("A,N,M,slope,ms", [
    (32, 256, 256, 1.03, 1.2),
    (16, 256, 512, 1.45, 1.6),
    (16, 128, 128, -1.02, 1.2),
    (8, 128, 512, 1.55, 1.6),
    (24, 256, 256, 0.72, 1.2),
])
def test_resample_minor_matches_numpy_lerp(A, N, M, slope, ms):
    rng = np.random.default_rng(0)
    arr = rng.random((A, N)).astype(np.float32)
    off = rng.uniform(-N * 0.5, N * 1.3, (A,)).astype(np.float32)
    got = np.asarray(_resample_minor(
        jnp.asarray(arr)[:, None, :], jnp.asarray(off)[:, None],
        jnp.asarray(slope, F32), M, ms)).reshape(A, M)
    pos = (off.astype(np.float64)[:, None]
           + np.float32(slope) * np.arange(M, dtype=np.float64)[None, :])
    np.testing.assert_allclose(got, _lerp_ref(arr.astype(np.float64), pos),
                               atol=2e-5)


def _groups(n, det, n_views=8, seed=0):
    geom = Geometry(n_proj=n_views, vox_shape=(n,) * 3, det_shape=det)
    rng = np.random.default_rng(seed)
    views = Views.create(
        n_views, phi=0.3 + np.linspace(0, 2 * np.pi, n_views,
                                       endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, n_views),
        beta=rng.uniform(-0.01, 0.01, n_views),
        t=rng.uniform(-1.5, 1.5, (n_views, 3)))
    vol = jnp.asarray(phantom.shepp3d(n), F32)
    gs, scalars = sp.scalar_groups(geom, views)
    for (idx, sw, yf, uf), sc in zip(gs, scalars):
        yield geom, sp.orient_volume(vol, geom, sw, yf), sc


@pytest.mark.parametrize("n,det,block", [
    (16, (16, 16), (16, 16)),     # one tile per view
    (24, (24, 40), (16, 32)),     # detector padded up to whole tiles
    (32, (32, 32), (32, 32)),
])
def test_plane_kernel_interpret_matches_xla(n, det, block):
    """Every orientation group: kernel rows == the XLA plane forward."""
    for geom, vol_or, sc in _groups(n, det):
        got = plane_forward(vol_or, sc[:, sp._PLANE_COLS], det,
                            block=block, interpret=True)
        ref = sp._forward_group_xla(vol_or, sc, geom, "plane", F32)
        assert got.shape == ref.shape == (sc.shape[0],) + det
        rel = (np.linalg.norm(np.asarray(got - ref))
               / np.linalg.norm(np.asarray(ref)))
        assert rel < 1e-5, rel


def test_plane_kernel_window_offsets_match_xla():
    """A window (detector rows from v_off, volume planes shifted by the
    integer z_off — the volume-sharded operator's shards) gives the same
    rows through the kernel as through the XLA path."""
    geom, vol_or, sc = next(_groups(16, (16, 16)))
    sc = sc.at[:, sp.S_VOFF].set(8.0).at[:, sp.S_ZOFF].set(-3.0)
    win = Geometry(n_proj=geom.n_proj, vox_shape=vol_or.shape,
                   det_shape=(16, 8))
    got = plane_forward(vol_or, sc[:, sp._PLANE_COLS], win.det_shape,
                        block=(16, 8), interpret=True)
    ref = sp._forward_group_xla(vol_or, sc, win, "plane", F32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_plane_forward_vjp_is_xla_transpose():
    """The f32 plane route's gradient rule: cotangents w.r.t. the volume
    AND the scalar rows equal those of the XLA forward."""
    geom, vol_or, sc = next(_groups(16, (16, 16)))
    g = jnp.asarray(np.random.default_rng(5).standard_normal(
        (sc.shape[0], 16, 16)), F32)
    sc = sc.astype(F32)
    _, vjp_k = jax.vjp(lambda v, s: sp.forward_group(v, s, geom, "plane"),
                       vol_or, sc)
    _, vjp_x = jax.vjp(lambda v, s: sp._forward_group_xla(
        v, s, geom, "plane", F32), vol_or, sc)
    for a, b in zip(vjp_k(g), vjp_x(g)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_plane_kernel_compiled_matches_xla(gpu):
    """On the card: the compiled kernel (no interpreter) == XLA."""
    for geom, vol_or, sc in _groups(64, (64, 64)):
        got = jax.jit(lambda v, s: plane_forward(
            v, s[:, sp._PLANE_COLS], geom.det_shape))(vol_or, sc)
        ref = sp._forward_group_xla(vol_or, sc, geom, "plane", F32)
        rel = (np.linalg.norm(np.asarray(got - ref))
               / np.linalg.norm(np.asarray(ref)))
        assert rel < 1e-5, rel

"""Slab-marching projector family tests.

The arc-quadrature mode must reproduce the exact ray family
(``projector.forward_view``, i.e. ``ray_wt_grad.f90`` semantics) to machine
precision at zero rigid jitter — same sample positions, same trilinear
weights, just reorganized by slab — and to ≲0.5% per view under rigid
jitter (the only deviation is the O(sin jitter) pass-A cross-term).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tomojax.core.geometry import Geometry, Views
from tomojax.core import projector as exact
from tomojax.core import slab_projector as slab
from tomojax.core import phantom
from tomojax.core.operators import make_operator
from tomojax.recon import cgls as cgls_solve

F64 = jnp.float64


@pytest.fixture(scope="module")
def vol32():
    return jnp.asarray(phantom.shepp3d(32).astype(np.float64))


def _geom(n=32, n_proj=1):
    return Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))


def test_arc_mode_machine_exact_at_zero_jitter(vol32):
    """Zero jitter: identical sample positions → 1e-12 parity in f64
    (one phi per orientation group; the full octant sweep is slow-tier)."""
    geom = _geom()
    for phi in np.deg2rad([0, 45, 181]):
        e = exact.forward_view(vol32, geom, phi, 0.0, 0.0, jnp.zeros(3),
                               jnp.zeros(3), dtype=F64)
        s = slab.forward_view(vol32, geom, phi, 0.0, 0.0, jnp.zeros(3),
                              jnp.zeros(3), dtype=F64, quad="arc")
        rel = float(jnp.linalg.norm(s - e) / jnp.linalg.norm(e))
        assert rel < 1e-12, (np.rad2deg(phi), rel)


def test_arc_mode_close_under_jitter(vol32):
    geom = _geom()
    rng = np.random.default_rng(3)
    for phi in np.deg2rad([45, 200]):
        al, be = rng.uniform(-0.02, 0.02, 2)
        t = jnp.asarray(rng.uniform(-2, 2, 3))
        e = exact.forward_view(vol32, geom, phi, al, be, t, jnp.zeros(3),
                               dtype=F64)
        s = slab.forward_view(vol32, geom, phi, al, be, t, jnp.zeros(3),
                              dtype=F64, quad="arc")
        rel = float(jnp.linalg.norm(s - e) / jnp.linalg.norm(e))
        assert rel < 5e-3, (np.rad2deg(phi), rel)


def test_plane_mode_mass_and_closeness(vol32):
    """Plane quadrature: different discretization, but mass-preserving and
    within a few %% of the exact transform."""
    geom = _geom()
    for phi in np.deg2rad([0, 45, 120]):
        e = np.asarray(exact.forward_view(vol32, geom, phi, 0.01, -0.008,
                                          jnp.asarray([0.7, 0.0, -0.4]),
                                          jnp.zeros(3), dtype=F64))
        p = np.asarray(slab.forward_view(vol32, geom, phi, 0.01, -0.008,
                                         jnp.asarray([0.7, 0.0, -0.4]),
                                         jnp.zeros(3), dtype=F64,
                                         quad="plane"))
        rel = np.linalg.norm(p - e) / np.linalg.norm(e)
        mass = abs(p.sum() / e.sum() - 1.0)
        assert rel < 0.08, (np.rad2deg(phi), rel)
        assert mass < 0.01, (np.rad2deg(phi), mass)


def test_multiview_project_matches_exact(vol32):
    n_proj = 8
    geom = _geom(n_proj=n_proj)
    rng = np.random.default_rng(0)
    views = Views.create(
        n_proj, phi=np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.015, 0.015, n_proj),
        beta=rng.uniform(-0.015, 0.015, n_proj),
        t=rng.uniform(-1.5, 1.5, (n_proj, 3)))
    e = exact.project(vol32, geom, views, dtype=F64)
    s = slab.project(vol32, geom, views, dtype=F64, quad="arc")
    rel = float(jnp.linalg.norm(s - e) / jnp.linalg.norm(e))
    assert rel < 4e-3, rel


def test_adjoint_dot_product(vol32):
    n_proj = 6
    geom = _geom(n_proj=n_proj)
    rng = np.random.default_rng(1)
    views = Views.create(
        n_proj, phi=np.linspace(0, np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, n_proj),
        beta=rng.uniform(-0.01, 0.01, n_proj),
        t=rng.uniform(-1, 1, (n_proj, 3)))
    for quad in ("arc", "plane"):
        ax = slab.project(vol32, geom, views, dtype=F64, quad=quad)
        y = jnp.asarray(rng.standard_normal(ax.shape))
        aty = slab.backproject(y, geom, views, dtype=F64, quad=quad)
        lhs = float(jnp.vdot(ax, y))
        rhs = float(jnp.vdot(vol32, aty))
        assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0), quad


@pytest.mark.slow
def test_cgls_slab_operator_tracks_exact_family(vol32):
    """The headline consistency requirement (round-1 VERDICT item 3): CGLS
    on exact-family data must not stagnate from operator mismatch. The
    slab-arc operator's CGLS trajectory must match the exact ray family's
    essentially iterate-for-iterate (measured: rel errors agree to 4
    digits; the old 3-pass fast family stagnates ~0.10 above exact)."""
    n = 32
    n_proj = 40
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(5)
    views = Views.create(
        n_proj, phi=np.linspace(0, np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.015, 0.015, n_proj),
        beta=rng.uniform(-0.015, 0.015, n_proj),
        t=rng.uniform(-1.5, 1.5, (n_proj, 3)))
    vol = vol32.astype(jnp.float32)
    sino = exact.project(vol, geom, views, dtype=jnp.float32)
    truth = np.asarray(vol)

    def run(fam):
        op = make_operator(geom, views, family=fam, dtype=jnp.float32)
        res = cgls_solve(op, sino, niter=30)
        x = np.asarray(res.x).reshape(geom.vox_shape)
        return np.linalg.norm(x - truth) / np.linalg.norm(truth)

    rel_ray = run("ray")
    rel_slab = run("slab")
    assert abs(rel_slab - rel_ray) < 0.01, (rel_slab, rel_ray)


@pytest.mark.slow
def test_arc_mode_machine_exact_full_octant_sweep(vol32):
    geom = _geom()
    for phi in np.deg2rad([0, 22, 45, 46, 90, 135, 170, 181, 225, 269,
                           315]):
        e = exact.forward_view(vol32, geom, phi, 0.0, 0.0, jnp.zeros(3),
                               jnp.zeros(3), dtype=F64)
        s = slab.forward_view(vol32, geom, phi, 0.0, 0.0, jnp.zeros(3),
                              jnp.zeros(3), dtype=F64, quad="arc")
        rel = float(jnp.linalg.norm(s - e) / jnp.linalg.norm(e))
        assert rel < 1e-12, (np.rad2deg(phi), rel)


# ---------------- analytic 6-DoF Jacobian (theta gradients) ----------------


def _smooth_vol(n):
    xx, yy, zz = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    return jnp.asarray(np.exp(-((xx - n * 0.47) ** 2 + (yy - n * 0.5) ** 2
                                + (zz - n * 0.45) ** 2) / (n * 1.2)), F64)


def test_jacobian_matches_exact_family_at_zero_jitter():
    """At zero jitter the slab operator coincides with the exact ray
    family machine-exactly, and so do the Jacobian rows whose parameter
    does not excite the z-tracking cross term (tx, ty, tz, phi). The
    alpha/beta rows carry ``d(edz)/dtheta ~ 1`` into the grid-sawtooth
    wrap zones where the two (equally valid) quadratures genuinely
    reassign samples, so they agree only to ~10-20%% — each operator's
    row is the a.e.-exact derivative of ITS OWN forward (asserted
    field-by-field in test_jacobian_scalar_responses_fd_exact)."""
    n = 16
    geom = Geometry(n_proj=1, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = jnp.asarray(phantom.shepp3d(n), F64)
    cor = jnp.zeros(3, F64)
    for phi in (0.5, 2.1, 3.8):
        v_s, j_s = slab.forward_view_jac(vol, geom, phi, 0.0, 0.0,
                                         jnp.zeros(3, F64), cor, dtype=F64)
        v_e, j_e = exact.forward_view_jac(vol, geom, phi, 0.0, 0.0,
                                          jnp.zeros(3, F64), cor,
                                          dtype=F64)
        assert float(jnp.linalg.norm(v_s - v_e)) < 1e-9
        for k in range(6):
            den = max(float(jnp.linalg.norm(j_e[k])), 1e-9)
            rel = float(jnp.linalg.norm(j_s[k] - j_e[k])) / den
            tol = 1e-5 if k < 4 else 0.25
            assert rel < tol, (phi, k, rel)


def test_jacobian_scalar_responses_fd_exact():
    """Per-scalar response fields are the exact a.e. derivative of the
    slab operator: central differences on each SlabParams scalar (smooth
    volume, f64) match to ~1e-6."""
    n = 16
    geom = Geometry(n_proj=1, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = _smooth_vol(n)
    cor = jnp.zeros(3, F64)
    phi, al, be = 0.6, 0.01, -0.008
    t = jnp.asarray([0.7, 0.0, -0.4], F64)
    vw = Views.create(1, phi=np.asarray([phi]), alpha=np.asarray([al]),
                      beta=np.asarray([be]))
    sw, yf, _ = slab.orient_flags(vw, geom)
    sw, yf = bool(sw[0]), bool(yf[0])
    vol_or = slab.orient_volume(vol, geom, sw, yf)
    th = jnp.asarray([*np.asarray(t), phi, al, be], F64)
    E, B = slab._oriented_affine_theta(geom, th, cor, sw, yf, False, F64)
    p0 = slab.slab_params(E, B, F64)

    P, PJ, PR = {}, {}, {}
    for dv in ("x", "y", "z"):
        P[dv] = slab._forward_oriented_xla(vol_or, p0, geom, quad="arc",
                                           dtype=F64, deriv=dv)
        PJ[dv] = slab._forward_oriented_xla(vol_or, p0, geom, quad="arc",
                                            dtype=F64, deriv=dv,
                                            jweight=True)
        PR[dv] = slab._forward_oriented_xla(vol_or, p0, geom, quad="arc",
                                            dtype=F64, deriv=dv,
                                            rweight=True)
    PM = slab._forward_oriented_xla(vol_or, p0, geom, quad="arc",
                                    dtype=F64, deriv="zm")
    ZC = slab._forward_oriented_xla(vol_or, p0, geom, quad="arc",
                                    dtype=F64, deriv="zc")
    resp = slab._scalar_responses(p0, P, PJ, PR, PM, ZC, geom, F64)

    eps = 1e-6
    for field in ("cxb", "czb", "b1", "rx", "rz", "eux", "evx", "evz",
                  "gzx", "edx", "edz"):
        pp = p0._replace(**{field: getattr(p0, field) + eps})
        pm = p0._replace(**{field: getattr(p0, field) - eps})
        fd = np.asarray(
            slab._forward_oriented_xla(vol_or, pp, geom, quad="arc",
                                       dtype=F64)
            - slab._forward_oriented_xla(vol_or, pm, geom, quad="arc",
                                         dtype=F64)) / (2 * eps)
        an = np.asarray(getattr(resp, field))
        den = max(np.linalg.norm(fd), 1e-9)
        rel = np.linalg.norm(an - fd) / den
        # a.e.-exact; the residual is the FD's own truncation/knife-edge
        # noise (r-weighted fields amplify it by the slab index)
        assert rel < 3e-5, (field, rel)


def test_jacobian_translation_theta_fd():
    """Whole-theta central differences for the optimized translations
    (tx, tz): the assembled Jacobian rows are a.e.-exact."""
    n = 16
    geom = Geometry(n_proj=1, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = _smooth_vol(n)
    cor = jnp.zeros(3, F64)
    phi, al, be = 0.6, 0.01, -0.008
    t0 = np.array([0.7, 0.0, -0.4, phi, al, be])
    vw = Views.create(1, phi=np.asarray([phi]), alpha=np.asarray([al]),
                      beta=np.asarray([be]))
    sw, yf, _ = slab.orient_flags(vw, geom)
    sw, yf = bool(sw[0]), bool(yf[0])
    _, jac = slab.forward_view_jac(vol, geom, phi, al, be,
                                   jnp.asarray(t0[:3], F64), cor,
                                   dtype=F64, swap=sw, yflip=yf)

    def fwd(th):
        return np.asarray(slab.forward_view(
            vol, geom, th[3], th[4], th[5], jnp.asarray(th[:3], F64), cor,
            dtype=F64, swap=sw, yflip=yf), np.float64)

    eps = 1e-5
    for k in (0, 2):
        tp, tm = t0.copy(), t0.copy()
        tp[k] += eps
        tm[k] -= eps
        fd = (fwd(tp) - fwd(tm)) / (2 * eps)
        ja = np.asarray(jac[k], np.float64)
        rel = np.linalg.norm(ja - fd) / max(np.linalg.norm(fd), 1e-9)
        assert rel < 1e-5, (k, rel)


def test_slab_scalars_jnp_matches_np():
    """The traceable scalar builder (refinement path) must agree with the
    host numpy builder (operator-build path) for every octant."""
    n = 16
    geom = Geometry(n_proj=8, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(4)
    views = Views.create(
        8, phi=0.3 + np.linspace(0, 2 * np.pi, 8, endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, 8),
        beta=rng.uniform(-0.01, 0.01, 8),
        t=rng.uniform(-1, 1, (8, 3)))
    for idx, sw, yf, uf in slab._orient_groups(
            jax.tree.map(np.asarray, views), geom):
        sub = jax.tree.map(lambda a: np.asarray(a)[idx], views)
        sc_np = slab.slab_scalars_np(geom, sub, sw, yf, uf)
        th = jnp.asarray(np.concatenate(
            [sub.t, np.stack([sub.phi, sub.alpha, sub.beta], -1)], -1),
            F64)
        sc_j = jax.vmap(lambda t6, c: slab.slab_scalars_jnp(
            geom, t6, c, sw, yf, uf, dtype=F64))(
            th, jnp.asarray(sub.cor, F64))
        np.testing.assert_allclose(np.asarray(sc_j), sc_np, rtol=1e-9,
                                   atol=1e-9)


def test_scalar_argument_path_matches_eager(vol32):
    """project_scalars/backproject_scalars (the jitted-solver apply path
    with scalars as program arguments) must equal the eager
    project/backproject for every orientation group, including under a
    jit that treats the scalars as traced inputs."""
    n_proj = 7
    geom = _geom(n_proj=n_proj)
    rng = np.random.default_rng(3)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1.5, 1.5, n_proj)
    t[:, 2] = rng.uniform(-1.5, 1.5, n_proj)
    views = Views.create(n_proj, phi=np.linspace(0, np.pi, n_proj),
                         alpha=rng.uniform(-0.02, 0.02, n_proj),
                         beta=rng.uniform(-0.02, 0.02, n_proj), t=t)
    for quad in ("arc", "plane"):
        ref = slab.project(vol32, geom, views, dtype=F64, quad=quad)
        gstruct, scalars = slab.scalar_groups(geom, views, dtype=F64)

        fwd = jax.jit(lambda v, sc: slab.project_scalars(
            v, geom, gstruct, sc, quad, dtype=F64))
        got = fwd(vol32, scalars)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=0, atol=1e-12)

        sino = jnp.asarray(
            rng.standard_normal((n_proj, geom.n_det)), F64)
        bref = slab.backproject(sino, geom, views, dtype=F64, quad=quad)
        adj = jax.jit(lambda s, sc: slab.backproject_scalars(
            s, geom, gstruct, sc, quad, dtype=F64))
        bgot = adj(sino, scalars)
        np.testing.assert_allclose(np.asarray(bgot), np.asarray(bref),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("det", [(64, 64), (61, 67), (64, 96)],
                         ids=["square", "odd", "non-square"])
def test_xla_slab_arc_matches_exact_64(det):
    """64³ volume, jittered views: the XLA slab arc forward tracks the
    exact ray family per view at the square, odd and non-square detector
    shapes the former kernel tests padded."""
    n, n_proj = 64, 4
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=det)
    vol = jnp.asarray(phantom.shepp3d(n), jnp.float32)
    rng = np.random.default_rng(3)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1.5, 1.5, n_proj)
    t[:, 2] = rng.uniform(-1.5, 1.5, n_proj)
    views = Views.create(
        n_proj, phi=0.25 + np.linspace(0, np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.008, 0.008, n_proj),
        beta=rng.uniform(-0.008, 0.008, n_proj), t=t)
    got = np.asarray(slab.project(vol, geom, views, quad="arc"))
    ref = np.asarray(exact.project(vol, geom, views))
    rel = (np.linalg.norm(got - ref, axis=1)
           / np.linalg.norm(ref, axis=1))
    assert got.shape == (n_proj, det[0] * det[1])
    assert rel.max() < 5e-3, rel


@pytest.mark.parametrize("phi,flags", [
    (0.3, (False, False, False)), (1.871, (True, True, False)),
    (3.442, (False, True, True)), (5.012, (True, False, True))])
def test_scalar_row_round_trip(phi, flags):
    """params_from_scalars(slab_scalars_np(...)) == slab_params(...) of
    the oriented affine map, in every reachable orientation group."""
    geom = Geometry(n_proj=1, vox_shape=(24,) * 3, det_shape=(24, 20))
    th = np.array([0.7, 0.0, -1.1, phi, 0.006, -0.004])
    cor = np.array([0.3, 0.0, 0.0])
    views = Views.create(1, phi=[phi], alpha=[th[4]], beta=[th[5]],
                         t=th[None, :3], cor=cor[None], dtype=F64)
    sw, yf, uf = (bool(f[0]) for f in slab.orient_flags(views, geom))
    assert (sw, yf, uf) == flags
    row = slab.slab_scalars_np(geom, views, sw, yf, uf)[0]
    got = slab.params_from_scalars(jnp.asarray(row))
    E, B = slab._oriented_affine_theta(geom, jnp.asarray(th), jnp.asarray(
        cor), sw, yf, uf, F64)
    want = slab.slab_params(E, B, F64)
    for name in slab.SlabParams._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)

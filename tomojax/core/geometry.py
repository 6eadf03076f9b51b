"""Parallel-beam acquisition geometry and per-view rigid parameters.

Re-design of the reference's ``utilities/geometry.py:9-105``.

Two deliberate differences from the reference:

1. ``Geometry`` here is an immutable, hashable dataclass of *static* scalars —
   it can be passed as a static argument to ``jax.jit``. Grids (voxel centers,
   source/detector planes) are derived on demand rather than stored, so the
   object is cheap and trace-friendly.
2. Per-view quantities (angles, translations, center-of-rotation shifts) live
   in a separate ``Views`` pytree whose leaves are arrays of shape
   ``(n_proj, ...)`` — the natural unit for vmap/shard_map over the
   projection axis. The reference instead mutated a deep-copied ``Geometry``
   per view (``utilities/projection_operators.py:101-102``), an in-place
   pattern (``utilities/ray_voxel_utilities.py:72-73``) we do not replicate.

Grid conventions preserved exactly (``utilities/geometry.py:77-105``):
- voxel centers on ``linspace(-s/2, s/2, n, endpoint=False) + 0.5`` per axis;
- ``vox_origin`` = minimum corner of the voxel-center grid;
- detector grid in x–z with the same convention; source plane at
  ``y = -vox_size_y`` and detector plane at ``y = +vox_size_y`` (the reference
  reuses the *voxel* y-extent for the planes — a quirk kept for parity);
- ``det_orig``/``factor`` for the voxel-driven path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


def _as_tuple(x, n, cast):
    if np.isscalar(x):
        return (cast(x),) * n
    t = tuple(cast(v) for v in np.asarray(x).ravel())
    assert len(t) == n, f"expected {n} entries, got {t}"
    return t


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static parallel-beam setup. Hashable → usable as a jit static arg.

    :param n_proj: number of projection views.
    :param vox_shape: ``(nx, ny, nz)`` voxel grid shape.
    :param vox_pix: voxel pitch per axis.
    :param det_shape: ``(nu, nv)`` detector shape; ``u`` maps to volume x and
        ``v`` to volume z (reference ``utilities/geometry.py:90-94``).
    :param det_pix: detector pitch per axis.
    :param step_size: ray-march step (reference default 1.0).
    """

    n_proj: int
    vox_shape: tuple
    det_shape: tuple
    vox_pix: tuple = (1.0, 1.0, 1.0)
    det_pix: tuple = (1.0, 1.0)
    step_size: float = 1.0
    vox_ds: tuple = (1.0, 1.0, 1.0)  # voxel downsampling for the voxel path
    #                                  (reference ``geometry.py:32``)

    def __post_init__(self):
        object.__setattr__(self, "n_proj", int(self.n_proj))
        object.__setattr__(self, "vox_shape", _as_tuple(self.vox_shape, 3, int))
        object.__setattr__(self, "det_shape", _as_tuple(self.det_shape, 2, int))
        object.__setattr__(self, "vox_pix", _as_tuple(self.vox_pix, 3, float))
        object.__setattr__(self, "det_pix", _as_tuple(self.det_pix, 2, float))
        object.__setattr__(self, "step_size", float(self.step_size))
        object.__setattr__(self, "vox_ds", _as_tuple(self.vox_ds, 3, float))

    # ---- static scalar properties -------------------------------------
    @property
    def n_vox(self) -> int:
        nx, ny, nz = self.vox_shape
        return nx * ny * nz

    @property
    def n_det(self) -> int:
        nu, nv = self.det_shape
        return nu * nv

    @property
    def vox_size(self) -> tuple:
        return tuple(n * p for n, p in zip(self.vox_shape, self.vox_pix))

    @property
    def det_size(self) -> tuple:
        return tuple(n * p for n, p in zip(self.det_shape, self.det_pix))

    @property
    def ray_length(self) -> float:
        """Source-to-detector distance = 2 × voxel y-extent.

        Constant across rays and views (rigid transforms preserve it); the
        reference recomputes it per view as ``norm(p1 - p0)``
        (``utilities/ray_voxel_utilities.py:86-88``) but the value is always
        ``2 * vox_size[1]`` (planes at ``y = ∓vox_size_y``,
        ``utilities/geometry.py:95-100``).
        """
        return 2.0 * self.vox_size[1]

    @property
    def n_steps(self) -> int:
        """Samples per ray: ``int(ray_length / step_size)`` — static at trace
        time (reference: ``utilities/ray_voxel_utilities.py:88``)."""
        return int(self.ray_length / self.step_size)

    @property
    def factor(self) -> tuple:
        """Voxel→detector downsampling factors for the voxel-driven path
        (reference ``utilities/geometry.py:103-105``)."""
        sx = float(self.vox_shape[0] / self.det_shape[0])
        sz = float(self.vox_shape[2] / self.det_shape[1])
        return (sx, 1.0, sz)

    # ---- derived grids (host numpy, exact f64; convert at call sites) --
    def _axis_centers(self, n: int, size: float) -> np.ndarray:
        # linspace(-s/2, s/2, n, endpoint=False) + 0.5 — the reference's grid
        # (utilities/geometry.py:82-84, 92-93). The +0.5 is in *world* units
        # regardless of pitch, kept verbatim for parity.
        return np.linspace(-size / 2.0, size / 2.0, n, endpoint=False) + 0.5

    def vox_centers_np(self) -> np.ndarray:
        """(3, n_vox) voxel centers, x-major/z-minor raveling ('ij')."""
        nx, ny, nz = self.vox_shape
        sx, sy, sz = self.vox_size
        x = self._axis_centers(nx, sx)
        y = self._axis_centers(ny, sy)
        z = self._axis_centers(nz, sz)
        X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
        return np.array([X.ravel(), Y.ravel(), Z.ravel()])

    def vox_origin_np(self) -> np.ndarray:
        nx, ny, nz = self.vox_shape
        sx, sy, sz = self.vox_size
        return np.array(
            [
                self._axis_centers(nx, sx).min(),
                self._axis_centers(ny, sy).min(),
                self._axis_centers(nz, sz).min(),
            ]
        )

    def det_grid_np(self):
        """(xd, zd) raveled detector coordinates, 'ij' meshgrid (u-major)."""
        nu, nv = self.det_shape
        su, sv = self.det_size
        x = self._axis_centers(nu, su)
        z = self._axis_centers(nv, sv)
        XD, ZD = np.meshgrid(x, z, indexing="ij")
        return XD.ravel(), ZD.ravel()

    def source_centers_np(self) -> np.ndarray:
        """(3, n_det) source points: detector grid at y = -vox_size_y."""
        xd, zd = self.det_grid_np()
        y = -self.vox_size[1] * np.ones_like(xd)
        return np.array([xd, y, zd])

    def det_centers_np(self) -> np.ndarray:
        """(3, n_det) detector points: detector grid at y = +vox_size_y."""
        xd, zd = self.det_grid_np()
        y = self.vox_size[1] * np.ones_like(xd)
        return np.array([xd, y, zd])

    def det_orig_np(self) -> np.ndarray:
        """Minimum (x, y, z) of the detector grid, y from the *voxel* grid —
        the reference's ``det_orig`` (``utilities/geometry.py:103``)."""
        nu, nv = self.det_shape
        su, sv = self.det_size
        ny = self.vox_shape[1]
        sy = self.vox_size[1]
        return np.array(
            [
                self._axis_centers(nu, su).min(),
                self._axis_centers(ny, sy).min(),
                self._axis_centers(nv, sv).min(),
            ]
        )

    # jnp accessors
    def vox_centers(self, dtype=jnp.float32):
        return jnp.asarray(self.vox_centers_np(), dtype=dtype)

    def vox_origin(self, dtype=jnp.float32):
        return jnp.asarray(self.vox_origin_np(), dtype=dtype)

    def source_centers(self, dtype=jnp.float32):
        return jnp.asarray(self.source_centers_np(), dtype=dtype)

    def det_centers(self, dtype=jnp.float32):
        return jnp.asarray(self.det_centers_np(), dtype=dtype)


class Views(NamedTuple):
    """Per-view rigid parameters — a pytree with leading axis ``n_proj``.

    Parameter semantics follow the reference's normative Python path
    (``utilities/ray_voxel_utilities.py``): a view's projection is
    ``P(theta) x`` with ray transform ``R_z(phi) R_x(alpha) (R_y(beta) p + t)``
    and 6-DoF parameter order ``(tx, ty, tz, phi, alpha, beta)``
    (``derivative_ray_points`` rows, ``ray_voxel_utilities.py:34-49``).
    """

    phi: jnp.ndarray  # (n_proj,) tomographic angle about Z
    alpha: jnp.ndarray  # (n_proj,) jitter about X
    beta: jnp.ndarray  # (n_proj,) jitter about Y
    t: jnp.ndarray  # (n_proj, 3) translations
    cor: jnp.ndarray  # (n_proj, 3) center-of-rotation shift

    @classmethod
    def create(cls, n_proj, phi=None, alpha=None, beta=None, t=None, cor=None,
               dtype=jnp.float32):
        def arr(v, shape, default):
            if v is None:
                return jnp.full(shape, default, dtype=dtype)
            return jnp.broadcast_to(jnp.asarray(v, dtype=dtype), shape)

        if phi is None:
            phi = jnp.linspace(0.0, jnp.pi, n_proj, dtype=dtype)
        else:
            phi = jnp.broadcast_to(jnp.asarray(phi, dtype=dtype), (n_proj,))
        return cls(
            phi=phi,
            alpha=arr(alpha, (n_proj,), 0.0),
            beta=arr(beta, (n_proj,), 0.0),
            t=arr(t, (n_proj, 3), 0.0),
            cor=arr(cor, (n_proj, 3), 0.0),
        )

    @property
    def n_proj(self) -> int:
        return self.phi.shape[0]

    def view(self, i):
        """Single-view slice (still a Views pytree with scalar/1-row leaves)."""
        return Views(self.phi[i], self.alpha[i], self.beta[i], self.t[i], self.cor[i])

    def theta6(self):
        """(n_proj, 6) parameter matrix in the order (tx, ty, tz, phi, alpha, beta)."""
        return jnp.concatenate(
            [self.t, self.phi[:, None], self.alpha[:, None], self.beta[:, None]],
            axis=1,
        )

    @classmethod
    def from_theta6(cls, theta, cor=None):
        theta = jnp.asarray(theta)
        n = theta.shape[0]
        if cor is None:
            cor = jnp.zeros((n, 3), dtype=theta.dtype)
        return cls(phi=theta[:, 3], alpha=theta[:, 4], beta=theta[:, 5],
                   t=theta[:, :3], cor=cor)

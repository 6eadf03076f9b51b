"""Matrix-free linear-operator layer.

Fills the role of the reference's scipy CSR system matrix
(``utilities/projection_operators.py:22-76``) AND the matrix-free
``linear_operators`` module the reference imports but never shipped
(``recon/cgls.py:3``, the dead ``self.f_proj_obj.project`` path at
``cgls.py:52``): solvers program against ``TomoOperator`` and never see how
A is applied.

Three projector families (the reference itself mixes two discretizations,
§2.1 of SURVEY):

- ``family="ray"``   — ray-driven trilinear forward (gather) with its exact
  scatter transpose (``ray_wt_grad.f90`` semantics). Exact adjoint pair →
  safe for CGLS. The bit-parity/oracle path.
- ``family="voxel"`` — voxel-driven bilinear splat forward with its exact
  gather transpose (``vox_wt_grad.f90`` semantics). The adjoint is
  gather-based.
- ``family="fast"``  — multi-pass resampling formulation of the ray
  transform (line-gathers + banded matmuls, ``fast_projector.py``);
  ≲ few % discretization difference from "ray". Exact transpose via
  ``jax.vjp``.
- ``family="slab"``  — slab-marching reformulation with the reference's
  exact arc-quadrature sample positions (``slab_projector.py``,
  ``quad="arc"``): identical to "ray" at zero rigid jitter, ≲0.3% at ±1°
  jitter, and all-resample structure (the production speed path).
- ``family="slab_plane"`` — same engine with one sample per slab plane
  (``quad="plane"``) — ~4x cheaper, a different-but-valid discretization
  for bulk solver iterations.

``voxel_mask`` reproduces the reference's masked system matrix
(``projection_operators.py:60-70``): masked voxels contribute nothing to A
and receive nothing from Aᵀ (algebraically identical to dropping those
columns).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp

from tomojax.core.geometry import Geometry, Views
from tomojax.core import projector as ray
from tomojax.core import voxel_projector as vox


@dataclasses.dataclass(frozen=True)
class TomoOperator:
    """Matrix-free A: volume → sinogram, with exact adjoint."""

    geom: Geometry
    views: Views
    A: Callable    # vol (vox_shape or flat) -> (n_proj, n_det)
    AT: Callable   # sino (n_proj, n_det) or flat -> vol (vox_shape)
    family: str
    dtype: object

    @property
    def vol_shape(self):
        return self.geom.vox_shape

    @property
    def shape(self):
        return (self.geom.n_proj * self.geom.n_det, self.geom.n_vox)

    def row_sums(self):
        """A @ 1 — SIRT's W normalizer (reference ``sirt.py:33``)."""
        return self.A(jnp.ones(self.geom.vox_shape, dtype=self.dtype))

    def col_sums(self):
        """Aᵀ @ 1 — SIRT's V normalizer (reference ``sirt.py:34-35``)."""
        ones = jnp.ones((self.geom.n_proj, self.geom.n_det), dtype=self.dtype)
        return self.AT(ones)


def make_operator(geom: Geometry, views: Views, *, family: str = "ray",
                  dtype=jnp.float32, views_chunk: int | None = None,
                  voxel_mask=None) -> TomoOperator:
    """Build the matrix-free projection operator for a set of views.

    :param voxel_mask: optional boolean volume; False voxels are excluded
        from the system (reference ``projection_operators.py:60-70``).
    """
    mask = None
    if voxel_mask is not None:
        mask = jnp.asarray(voxel_mask, dtype=dtype).reshape(geom.vox_shape)

    if family == "ray":
        def A(x):
            x = x.reshape(geom.vox_shape).astype(dtype)
            if mask is not None:
                x = x * mask
            return ray.project(x, geom, views, dtype=dtype,
                               views_chunk=views_chunk)

        def AT(y):
            out = ray.backproject(y.reshape(geom.n_proj, geom.n_det),
                                  geom.vox_shape, geom, views, dtype=dtype,
                                  views_chunk=views_chunk)
            return out * mask if mask is not None else out

    elif family == "fast":
        from tomojax.core import fast_projector as fastp

        def A(x):
            x = x.reshape(geom.vox_shape).astype(dtype)
            if mask is not None:
                x = x * mask
            return fastp.project(x, geom, views, dtype=dtype,
                                 views_chunk=views_chunk)

        def AT(y):
            out = fastp.backproject(y.reshape(geom.n_proj, geom.n_det),
                                    geom, views, dtype=dtype,
                                    views_chunk=views_chunk)
            return out * mask if mask is not None else out

    elif family in ("slab", "slab_plane"):
        from tomojax.core import slab_projector as slabp
        quad = "arc" if family == "slab" else "plane"

        def A(x):
            x = x.reshape(geom.vox_shape).astype(dtype)
            if mask is not None:
                x = x * mask
            return slabp.project(x, geom, views, dtype=dtype, quad=quad,
                                 views_chunk=views_chunk)

        def AT(y):
            out = slabp.backproject(y.reshape(geom.n_proj, geom.n_det),
                                    geom, views, dtype=dtype, quad=quad,
                                    views_chunk=views_chunk)
            return out * mask if mask is not None else out

    elif family == "voxel":
        def A(x):
            x = x.reshape(geom.vox_shape).astype(dtype)
            if mask is not None:
                x = x * mask
            return vox.project(x, geom, views, dtype=dtype,
                               views_chunk=views_chunk)

        def AT(y):
            out = vox.backproject(y.reshape(geom.n_proj, geom.n_det), geom,
                                  views, dtype=dtype,
                                  views_chunk=views_chunk)
            return out * mask if mask is not None else out

    else:
        raise ValueError(f"unknown projector family: {family!r}")

    return TomoOperator(geom=geom, views=views, A=A, AT=AT, family=family,
                        dtype=dtype)

"""Rotation matrices and their analytic angle-derivatives (pure jnp).

Equivalent of the reference's ``utilities/rotations.py:9-48`` and
``src/rotations_module.f90:6-103``. All functions accept scalar (or batched,
via vmap) angles and return ``(3, 3)`` matrices in the dtype of the input.

Conventions (identical to the reference):
- ``rot_z(phi)``   : tomographic rotation about the Z axis.
- ``rot_x(alpha)`` : jitter rotation about the X axis.
- ``rot_y(beta)``  : jitter rotation about the Y axis.
- ``der_rot_*``    : elementwise d/d(angle) of the corresponding matrix.
"""

from __future__ import annotations

import jax.numpy as jnp


def _mm(a, b):
    """Matmul at HIGHEST precision — geometry math must not go through the
    backend's default reduced-precision matmul passes (TF32 on a GPU, bf16
    on some CPU builds: f32 inputs would otherwise quantize to ~2^-8..2^-11
    relative error)."""
    return jnp.matmul(a, b, precision="highest")


def _cos_sin(angle):
    """cos/sin evaluated on a size-2 batch.

    Some XLA CPU builds route size-1 f64 transcendentals through an
    f32-accuracy scalar approximation (~3e-8 error); batching to size 2 uses
    the accurate vectorized path. Negligible cost, full f64 accuracy — needed
    for the <1e-12 oracle-parity guarantees of the projector tests.
    """
    a2 = jnp.stack([angle, angle])
    return jnp.cos(a2)[0], jnp.sin(a2)[0]


def rot_z(angle):
    c, s = _cos_sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero]),
            jnp.stack([s, c, zero]),
            jnp.stack([zero, zero, one]),
        ]
    )


def der_rot_z(angle):
    c, s = _cos_sin(angle)
    zero = jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([-s, -c, zero]),
            jnp.stack([c, -s, zero]),
            jnp.stack([zero, zero, zero]),
        ]
    )


def rot_x(angle):
    c, s = _cos_sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([one, zero, zero]),
            jnp.stack([zero, c, -s]),
            jnp.stack([zero, s, c]),
        ]
    )


def der_rot_x(angle):
    c, s = _cos_sin(angle)
    zero = jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([zero, zero, zero]),
            jnp.stack([zero, -s, -c]),
            jnp.stack([zero, c, -s]),
        ]
    )


def rot_y(angle):
    c, s = _cos_sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, zero, s]),
            jnp.stack([zero, one, zero]),
            jnp.stack([-s, zero, c]),
        ]
    )


def der_rot_y(angle):
    c, s = _cos_sin(angle)
    zero = jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([-s, zero, c]),
            jnp.stack([zero, zero, zero]),
            jnp.stack([-c, zero, -s]),
        ]
    )


def ray_rotation(phi, alpha, beta):
    """Full rotation of the ray path: ``R_z(phi) @ R_x(alpha) @ R_y(beta)``.

    The ray-path rigid transform is ``x' = R_z(phi) R_x(alpha) (R_y(beta) x + t)``
    (reference: ``utilities/ray_voxel_utilities.py:6-12``,
    ``src/external_forward_projection.f90:1-28``).
    """
    return _mm(_mm(rot_z(phi), rot_x(alpha)), rot_y(beta))


def voxel_rotation(phi, alpha, beta):
    """Full rotation of the voxel path: ``R_y(beta) @ R_x(alpha) @ R_z(phi)``.

    The voxel-path rigid transform is ``x' = R_y(beta) (R_x(alpha) R_z(phi) x + t)``
    — note the composition order differs from the ray path (reference:
    ``utilities/voxel_utilities.py:6-20``, ``src/external_back_projection.f90:1-27``).
    """
    return _mm(_mm(rot_y(beta), rot_x(alpha)), rot_z(phi))

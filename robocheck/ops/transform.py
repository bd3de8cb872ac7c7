"""Batched rigid-body pose transforms.

Semantics match the reference's pose convention exactly: intrinsic Tait-Bryan
Z-Y-X — yaw about Z, pitch about Y, roll about X — composed as
R = Rz(yaw) @ Ry(pitch) @ Rx(roll), plus a translation
(`broad-phase-fused.cu:26-55` ``createTransformationMatrix``; the FCL oracle
uses the same convention via quaternions, `Utils.cu:88-100`).

Array-first design notes:
  * The reference launches one CUDA thread per configuration and serially
    transforms 792 vertices (`transformation/transform.cu:65-97`). Here the
    whole batch is a single dense computation: rotation matrices ``[N, 3, 3]``
    are built with elementwise math and applied to the ``[V, 3]`` base
    vertices as an explicit sum of three scaled broadcasts rather than a
    matmul. With inner dim 3 a matrix unit would idle; the broadcast form
    keeps float32 semantics exact (no reduced-precision matmul passes, such
    as TF32 on the GPU), and XLA fuses it with the AABB reduction that
    follows.
  * No homogeneous 4-vector / w-divide (`transform.cu:43-63` does a full 4x4
    multiply): w is always 1, so the affine form is used directly.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.types import CONF_PITCH, CONF_ROLL, CONF_X, CONF_YAW


def rotation_matrices(confs: jnp.ndarray) -> jnp.ndarray:
    """[N, 6] configurations -> [N, 3, 3] rotation matrices (float32).

    Entry formulas mirror `broad-phase-fused.cu:37-52` (A=yaw, B=pitch,
    C=roll) so that float32 rounding matches the reference kernel.
    """
    pitch = confs[..., CONF_PITCH]
    yaw = confs[..., CONF_YAW]
    roll = confs[..., CONF_ROLL]

    cosB, sinB = jnp.cos(pitch), jnp.sin(pitch)
    cosA, sinA = jnp.cos(yaw), jnp.sin(yaw)
    cosC, sinC = jnp.cos(roll), jnp.sin(roll)

    r00 = cosA * cosB
    r01 = cosA * sinB * sinC - sinA * cosC
    r02 = cosA * sinB * cosC + sinA * sinC
    r10 = sinA * cosB
    r11 = sinA * sinB * sinC + cosA * cosC
    r12 = sinA * sinB * cosC - cosA * sinC
    r20 = -sinB
    r21 = cosB * sinC
    r22 = cosB * cosC

    rows = jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )
    return rows


def transform_vertices(confs: jnp.ndarray, base_vertices: jnp.ndarray) -> jnp.ndarray:
    """Apply each configuration's pose to the base vertices.

    Args:
      confs: [N, 6] float32.
      base_vertices: [V, 3] float32.

    Returns:
      [N, V, 3] float32 transformed vertices.
    """
    R = rotation_matrices(confs)  # [N, 3, 3]
    t = confs[..., CONF_X : CONF_X + 3]  # [N, 3]
    return apply_pose(R, t, base_vertices)


def apply_pose(R: jnp.ndarray, t: jnp.ndarray, base_vertices: jnp.ndarray) -> jnp.ndarray:
    """Apply rotations ``R`` [..., 3, 3] + translations ``t`` [..., 3] to
    ``base_vertices`` [V, 3] -> [..., V, 3].

    Written as three scaled broadcasts (x*R[:,0] + y*R[:,1] + z*R[:,2] + t):
    the per-axis multiply-add order matches the reference's row-major loop
    (`transform.cu:90-93`), keeping float32 accumulation order identical.
    """
    x = base_vertices[:, 0]  # [V]
    y = base_vertices[:, 1]
    z = base_vertices[:, 2]

    # [..., 1, 3] per-column rotation vectors broadcast over V.
    c0 = R[..., :, 0][..., None, :]
    c1 = R[..., :, 1][..., None, :]
    c2 = R[..., :, 2][..., None, :]
    v = x[:, None] * c0 + y[:, None] * c1 + z[:, None] * c2
    return v + t[..., None, :]

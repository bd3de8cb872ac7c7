"""AABB construction.

Reference: `generate-AABB/generate-AABB.cu:7-35` computes one AABB per
configuration by a serial min/max over that configuration's 792 transformed
vertices (one CUDA thread each). Here this is a single vectorized reduction
over the vertex axis — XLA fuses it into the transform that produces the
vertices, so the [N, V, 3] intermediate never round-trips to HBM when the
caller jits the fused pipeline.

AABB layout: float32 [..., 6] = (xmin, ymin, zmin, xmax, ymax, zmax).
"""
from __future__ import annotations

import jax.numpy as jnp


def vertices_aabb(vertices: jnp.ndarray) -> jnp.ndarray:
    """Reduce a vertex set to its AABB.

    Args:
      vertices: [..., V, 3].
    Returns:
      [..., 6] AABB.
    """
    lo = jnp.min(vertices, axis=-2)
    hi = jnp.max(vertices, axis=-2)
    return jnp.concatenate([lo, hi], axis=-1)


def triangle_aabbs(tri_vertices: jnp.ndarray) -> jnp.ndarray:
    """Per-triangle mini AABBs (the MegaKernel's hierarchical cull uses these,
    `test/MegaKernel.cu:31-35` / `:258-331`).

    Args:
      tri_vertices: [..., T, 3 (corner), 3 (xyz)].
    Returns:
      [..., T, 6].
    """
    lo = jnp.min(tri_vertices, axis=-2)
    hi = jnp.max(tri_vertices, axis=-2)
    return jnp.concatenate([lo, hi], axis=-1)


def aabb_overlap(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Interval-overlap test on all 3 axes, broadcasting over leading dims.

    Semantics: closed intervals, overlap iff ``a_min <= b_max && b_min <= a_max``
    per axis (`broad-phase.cu:5-8` ``dimensionCollides``; branch-free there,
    naturally branch-free here).

    Args:
      a, b: [..., 6] AABBs (broadcastable).
    Returns:
      [...] bool — True where the boxes overlap.
    """
    a_lo, a_hi = a[..., :3], a[..., 3:]
    b_lo, b_hi = b[..., :3], b[..., 3:]
    per_axis = (a_lo <= b_hi) & (b_lo <= a_hi)
    return jnp.all(per_axis, axis=-1)

"""Obstacle distance fields for gradient-based trajectory optimization.

The exact narrow phase produces boolean verdicts — correct but not
differentiable. The optimizer (`planner/trajopt.py`) instead descends a
*distance-field proxy*: an unsigned distance grid to the obstacle surface,
precomputed once per obstacle mesh as a dense batched point-to-triangle
distance (pure elementwise work, chunked), then queried with differentiable
trilinear interpolation. Exactness is restored by certifying candidate
trajectories with the boolean mega-kernel each iteration.

No reference counterpart — the reference stops at boolean verdicts; this is
the layer that makes them consumable by an optimizer.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Mesh


def point_triangle_distance(points: jnp.ndarray, tri: jnp.ndarray) -> jnp.ndarray:
    """Exact point-to-triangle distances, broadcast over pair dims.

    Closest-point-on-triangle via the barycentric region classification
    (Ericson, Real-Time Collision Detection §5.1.5) written branch-free.

    Args:
      points: [..., 3].
      tri: [..., 3, 3] (broadcast-compatible with points' leading dims).
    Returns:
      [...] distances.
    """
    a = tri[..., 0, :]
    b = tri[..., 1, :]
    c = tri[..., 2, :]
    p = points

    ab = b - a
    ac = c - a
    ap = p - a

    d1 = jnp.sum(ab * ap, axis=-1)
    d2 = jnp.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = jnp.sum(ab * bp, axis=-1)
    d4 = jnp.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = jnp.sum(ab * cp, axis=-1)
    d6 = jnp.sum(ac * cp, axis=-1)

    # Region tests.
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)

    vc = d1 * d4 - d3 * d2
    on_ab = (~in_a) & (~in_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    vb = d5 * d2 - d1 * d6
    on_ac = (~in_a) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    va = d3 * d6 - d5 * d4
    on_bc = (~in_b) & (~in_c) & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    def safe(x, cond):
        return jnp.where(cond, x, 1.0)

    v_ab = d1 / safe(d1 - d3, on_ab)
    v_ac = d2 / safe(d2 - d6, on_ac)
    w_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6), on_bc)

    denom = safe(va + vb + vc, True)
    v_in = vb / denom
    w_in = vc / denom

    # Assemble the closest point by cascading regions.
    q = a + v_in[..., None] * ab + w_in[..., None] * ac  # face interior
    q = jnp.where(on_bc[..., None], b + w_bc[..., None] * (c - b), q)
    q = jnp.where(on_ac[..., None], a + v_ac[..., None] * ac, q)
    q = jnp.where(on_ab[..., None], a + v_ab[..., None] * ab, q)
    q = jnp.where(in_c[..., None], c, q)
    q = jnp.where(in_b[..., None], b, q)
    q = jnp.where(in_a[..., None], a, q)

    return jnp.linalg.norm(p - q, axis=-1)


@dataclasses.dataclass(frozen=True)
class DistanceGrid:
    """Unsigned distance field on a regular grid with trilinear queries."""

    values: jnp.ndarray  # [nx, ny, nz] float32 distances
    origin: jnp.ndarray  # [3] grid corner (cell-center of voxel 0)
    spacing: jnp.ndarray  # [3] cell sizes

    def query(self, points: jnp.ndarray) -> jnp.ndarray:
        """Differentiable trilinear interpolation; clamps outside the grid.

        Args:
          points: [..., 3].
        Returns:
          [...] distances.
        """
        g = (points - self.origin) / self.spacing
        shape = jnp.asarray(self.values.shape, dtype=jnp.float32)
        g = jnp.clip(g, 0.0, shape - 1.0001)
        i0 = jnp.floor(g).astype(jnp.int32)
        f = g - i0.astype(jnp.float32)

        def at(dx, dy, dz):
            idx = i0 + jnp.asarray([dx, dy, dz], dtype=jnp.int32)
            return self.values[idx[..., 0], idx[..., 1], idx[..., 2]]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
        c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
        c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
        c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz


@partial(jax.jit, static_argnames=("chunk",))
def _grid_distances(points: jnp.ndarray, tri: jnp.ndarray, chunk: int = 2048):
    """Min distance from each point to any triangle, chunked over points."""
    n = points.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(points, ((0, pad), (0, 0)))

    def body(p_chunk):
        d = point_triangle_distance(p_chunk[:, None, :], tri[None, :, :, :])
        return jnp.min(d, axis=1)

    out = jax.lax.map(body, pts.reshape(-1, chunk, 3))
    return out.reshape(-1)[:n]


# Slightly skewed ray direction: axis-aligned rays through a regular grid hit
# mesh edges/vertices exactly; this direction makes such degeneracies
# measure-zero in practice.
_RAY_DIR = np.array([0.8775825, 0.33879128, 0.33946234], dtype=np.float32)


@partial(jax.jit, static_argnames=("chunk",))
def _grid_inside(points: jnp.ndarray, tri: jnp.ndarray, chunk: int = 2048):
    """Inside/outside classification by ray-crossing parity (watertight
    meshes): cast a fixed ray from each point, count Moller-Trumbore
    triangle crossings, odd -> inside."""
    n = points.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(points, ((0, pad), (0, 0)))
    d = jnp.asarray(_RAY_DIR)

    v0 = tri[:, 0, :]
    e1 = tri[:, 1, :] - v0  # [T,3]
    e2 = tri[:, 2, :] - v0
    pvec = jnp.cross(d[None, :], e2)  # [T,3]
    det = jnp.sum(e1 * pvec, axis=-1)  # [T]
    inv_det = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / det)

    def body(p_chunk):  # [C,3]
        tvec = p_chunk[:, None, :] - v0[None, :, :]  # [C,T,3]
        u = jnp.sum(tvec * pvec[None, :, :], axis=-1) * inv_det[None, :]
        qvec = jnp.cross(tvec, e1[None, :, :])
        v = jnp.sum(qvec * d[None, None, :], axis=-1) * inv_det[None, :]
        t = jnp.sum(qvec * e2[None, :, :], axis=-1) * inv_det[None, :]
        crossing = (
            (jnp.abs(det)[None, :] >= 1e-12)
            & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        )
        return jnp.sum(crossing, axis=1) % 2 == 1

    out = jax.lax.map(body, pts.reshape(-1, chunk, 3))
    return out.reshape(-1)[:n]


def build_distance_grid(
    obstacle: Mesh,
    resolution: int = 64,
    padding: float = 0.25,
    signed: bool = True,
) -> DistanceGrid:
    """Precompute the obstacle's distance grid (done once, like the
    mega-kernel's mesh prep). ``padding`` expands the AABB by that fraction of
    its extent so queries near the boundary stay informative.

    ``signed=True`` (watertight meshes) classifies grid points by
    ray-crossing parity and negates interior distances — essential for the
    optimizer: with an *unsigned* field the interior of a solid body looks
    "far from the surface" and becomes a false haven (observed: waypoints
    parked in the middle of a sphere obstacle)."""
    aabb = obstacle.aabb
    lo = aabb[:3].astype(np.float64)
    hi = aabb[3:].astype(np.float64)
    ext = hi - lo
    lo = lo - padding * ext
    hi = hi + padding * ext
    spacing = (hi - lo) / (resolution - 1)

    axes = [np.linspace(lo[k], hi[k], resolution) for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)

    tri = jnp.asarray(obstacle.triangle_vertices.astype(np.float32))
    d = np.asarray(_grid_distances(jnp.asarray(pts), tri), dtype=np.float32)
    if signed:
        inside = np.asarray(_grid_inside(jnp.asarray(pts), tri))
        d = np.where(inside, -d, d)
    values = d.reshape(resolution, resolution, resolution)
    return DistanceGrid(
        values=jnp.asarray(values),
        origin=jnp.asarray(lo, dtype=jnp.float32),
        spacing=jnp.asarray(spacing, dtype=jnp.float32),
    )

"""Dense, vectorized Moller'97 triangle-triangle intersection.

This is the array re-design of the reference narrow phase
(`narrow-phase/narrow-phase.cu`, spec in `/root/reference/python/narrow.py`).
The CUDA version is a branch-and-early-exit loop nest (one thread or warp per
configuration, `narrow-phase.cu:426-688`) whose own report measured 3.45%-37%
warp execution efficiency — divergence killed it. The formulation here is the
opposite: every helper below is a *dense, branch-free, broadcastable* array op
evaluated over whole pair tiles, with separation expressed as masks. Early
exit becomes tile skipping at the Pallas level (`kernels/`), not per-pair
control flow.

Tolerance semantics are copied exactly from the reference so verdicts agree
with the tagged golden datasets:
  * ``isclose``: relative tolerance TOL=1e-6 with absolute-zero windows
    (`narrow-phase.cu:24-35`).
  * ``no_overlap``: the +/-TOL band with >= / <= comparisons
    (`narrow-phase.cu:93-98`).
  * interval test uses the GPU kernels' ``>=`` semantics
    (`narrow-phase.cu:658-663`), not the CPU baseline's ``>``
    (`narrow-phase.cu:399-403`) — the shipped pipeline and the goldens
    reflect ``>=``.

A useful property exploited throughout: a degenerate padding triangle (all
corners equal) yields N=0, d=0, so every signed distance is 0 and the
``no_overlap`` mask separates it automatically — lane padding needs no
explicit mask in the narrow phase.

Triangles are passed as ``[..., 3 (corner), 3 (xyz)]`` vertex arrays; all
functions broadcast over arbitrary leading dims.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.constants import TOL


def isclose(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """Reference relative closeness (`narrow-phase.cu:24-35`).

    both |.| < TOL -> True; exactly one < TOL -> False;
    else |(v1 - v2) / v1| < TOL  (note: asymmetric, divides by v1).
    """
    a1 = jnp.abs(v1)
    a2 = jnp.abs(v2)
    both_small = (a1 < TOL) & (a2 < TOL)
    one_small = (a1 < TOL) | (a2 < TOL)
    rel = jnp.abs((v1 - v2) / jnp.where(a1 < TOL, 1.0, v1)) < TOL
    # both small -> True; exactly one small -> False; else relative compare.
    return both_small | (~one_small & rel)


def iszero(v: jnp.ndarray) -> jnp.ndarray:
    """isclose(v, 0) simplifies to |v| < TOL."""
    return jnp.abs(v) < TOL


def compute_plane(tri: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Plane (N, d) of a triangle with N = (v2-v1) x (v3-v2), d = -N.v1
    (`narrow-phase.cu:48-60`; same normal as the spec's (v1-v0)x(v2-v0)).

    Args:
      tri: [..., 3, 3].
    Returns:
      N: [..., 3], d: [...].
    """
    e1 = tri[..., 1, :] - tri[..., 0, :]
    e2 = tri[..., 2, :] - tri[..., 1, :]
    n = jnp.cross(e1, e2)
    d = -jnp.sum(n * tri[..., 0, :], axis=-1)
    return n, d


def signed_dists(n: jnp.ndarray, d: jnp.ndarray, tri: jnp.ndarray) -> jnp.ndarray:
    """Signed distances of a triangle's corners to a plane
    (`narrow-phase.cu:78-91`).

    Args:
      n: [..., 3], d: [...], tri: [..., 3, 3].
    Returns:
      [..., 3] distances (one per corner).
    """
    return jnp.sum(n[..., None, :] * tri, axis=-1) + d[..., None]


def no_overlap(dists: jnp.ndarray) -> jnp.ndarray:
    """True where the triangle lies strictly on one side of the plane, with a
    +/-TOL dead band (`narrow-phase.cu:93-98`).

    Args:
      dists: [..., 3].
    """
    gz = jnp.any(dists >= TOL, axis=-1)
    lz = jnp.any(dists <= -TOL, axis=-1)
    return ~(gz & lz)


def la_solve(
    a1: jnp.ndarray, a2: jnp.ndarray, a3: jnp.ndarray, a4: jnp.ndarray,
    b1: jnp.ndarray, b2: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Solve [[a1,a2],[a3,a4]] x = [b1,b2], branch-free
    (`narrow-phase.cu:109-125`): when |a1| < TOL use back-substitution via a2,
    otherwise direct elimination. Both branches are evaluated densely with
    safe denominators and selected with ``where``.
    """
    a1_zero = iszero(a1)

    # Branch A (a1 ~ 0): x2 = b1/a2 ; x1 = (b2 - a4*x2)/a3
    x2_a = b1 / a2
    x1_a = (b2 - a4 * x2_a) / a3

    # Branch B: x2 = (a3*b1 - a1*b2) / (a2*a3 - a1*a4) ; x1 = (b1 - a2*x2)/a1
    denom = a2 * a3 - a1 * a4
    x2_b = (a3 * b1 - a1 * b2) / denom
    x1_b = (b1 - a2 * x2_b) / jnp.where(a1_zero, 1.0, a1)

    x1 = jnp.where(a1_zero, x1_a, x1_b)
    x2 = jnp.where(a1_zero, x2_a, x2_b)
    return x1, x2


def intersect_line(
    n1: jnp.ndarray, d1: jnp.ndarray, n2: jnp.ndarray, d2: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Direction D and a point O of the line where two planes intersect
    (`narrow-phase.cu:127-154`). The axis with a usable cross component is
    chosen by the same |D_axis| >= TOL cascade; all three candidate solves run
    densely and ``where`` selects.

    Returns:
      D: [..., 3], O: [..., 3].
    """
    D = jnp.cross(n1, n2)
    dx, dy, dz = D[..., 0], D[..., 1], D[..., 2]

    n1x, n1y, n1z = n1[..., 0], n1[..., 1], n1[..., 2]
    n2x, n2y, n2z = n2[..., 0], n2[..., 1], n2[..., 2]

    # z-branch: solve in (x, y)
    x1_z, x2_z = la_solve(n1x, n1y, n2x, n2y, -d1, -d2)
    # y-branch: solve in (x, z)
    x1_y, x2_y = la_solve(n1x, n1z, n2x, n2z, -d1, -d2)
    # fallback: solve in (y, z)
    x1_x, x2_x = la_solve(n1y, n1z, n2y, n2z, -d1, -d2)

    use_z = ~iszero(dz)
    use_y = ~use_z & ~iszero(dy)

    zeros = jnp.zeros_like(dx)
    ox = jnp.where(use_z, x1_z, jnp.where(use_y, x1_y, zeros))
    oy = jnp.where(use_z, x2_z, jnp.where(use_y, zeros, x1_x))
    oz = jnp.where(use_z, zeros, jnp.where(use_y, x2_y, x2_x))
    O = jnp.stack([ox, oy, oz], axis=-1)
    return D, O


def project_vertex(v: jnp.ndarray, D: jnp.ndarray,
                   O: jnp.ndarray | None = None) -> jnp.ndarray:
    """D . (V - O)  (`narrow-phase.cu:184-190`), or the origin-free D . V
    when O is None (Moller'97's optimized projection: the line origin shifts
    every interval endpoint of a pair equally, so it cancels in the
    endpoint comparisons — computing it is pure cost)."""
    if O is None:
        return jnp.sum(D * v, axis=-1)
    return jnp.sum(D * (v - O), axis=-1)


def canonicalize(
    tri: jnp.ndarray, dists: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reorder corners so v2 (middle) is alone on one side of the other
    triangle's plane (`narrow-phase.cu:192-236`): strict-sign tests, so
    corners with |dist| inside the TOL band pair with either side.

      (d0,d1 same strict sign) -> order (0, 2, 1)
      (d0,d2 same strict sign) -> order (0, 1, 2)
      otherwise               -> order (1, 0, 2)

    Args:
      tri: [..., 3, 3], dists: [..., 3].
    Returns:
      permuted (tri, dists) of the same shapes.
    """
    d0, d1, d2 = dists[..., 0], dists[..., 1], dists[..., 2]
    c01 = ((d0 > 0) & (d1 > 0)) | ((d0 < 0) & (d1 < 0))
    c02 = ((d0 > 0) & (d2 > 0)) | ((d0 < 0) & (d2 < 0))

    # Distances
    nd0 = jnp.where(c01, d0, jnp.where(c02, d0, d1))
    nd1 = jnp.where(c01, d2, jnp.where(c02, d1, d0))
    nd2 = jnp.where(c01, d1, jnp.where(c02, d2, d2))
    new_dists = jnp.stack([nd0, nd1, nd2], axis=-1)

    # Corners
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    c01v = c01[..., None]
    c02v = c02[..., None]
    nv0 = jnp.where(c01v, v0, jnp.where(c02v, v0, v1))
    nv1 = jnp.where(c01v, v2, jnp.where(c02v, v1, v0))
    nv2 = jnp.where(c01v, v1, jnp.where(c02v, v2, v2))
    new_tri = jnp.stack([nv0, nv1, nv2], axis=-2)
    return new_tri, new_dists


def parametric_t(
    v0: jnp.ndarray, v1: jnp.ndarray, d0: jnp.ndarray, d1: jnp.ndarray,
    D: jnp.ndarray, O: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Interval endpoint on the intersection line (`narrow-phase.cu:238-251`):
    t = p(v0) + (p(v1) - p(v0)) * d0 / (d0 - d1). The denominator can only
    vanish for pairs already masked by ``no_overlap``; a safe-divide keeps
    NaNs out of the dense path.
    """
    p0 = project_vertex(v0, D, O)
    p1 = project_vertex(v1, D, O)
    dd = d0 - d1
    dd = jnp.where(dd == 0.0, 1.0, dd)
    return p0 + (p1 - p0) * d0 / dd


def is_coplanar(
    n1: jnp.ndarray, d1: jnp.ndarray, n2: jnp.ndarray, d2: jnp.ndarray
) -> jnp.ndarray:
    """Component-ratio coplanarity test (`narrow-phase.cu:253-294`): the two
    plane 4-vectors (Nx, Ny, Nz, d) must be nonzero in the same components and
    all nonzero-component ratios must ``isclose`` the first nonzero ratio.
    """
    c1 = jnp.stack([n1[..., 0], n1[..., 1], n1[..., 2], d1], axis=-1)
    c2 = jnp.stack([n2[..., 0], n2[..., 1], n2[..., 2], d2], axis=-1)
    z1 = iszero(c1)
    z2 = iszero(c2)
    mismatch = jnp.any(z1 ^ z2, axis=-1)

    valid = ~z1 & ~z2
    ratios = c1 / jnp.where(valid, c2, 1.0)
    # Index of the first valid component (argmax of bool picks first True).
    first = jnp.argmax(valid, axis=-1)
    ratio0 = jnp.take_along_axis(ratios, first[..., None], axis=-1)
    ok = jnp.all(~valid | isclose(ratio0, ratios), axis=-1)
    return ~mismatch & ok


class PairResult(NamedTuple):
    collides: jnp.ndarray  # bool [...]: non-coplanar Moller intersection
    coplanar: jnp.ndarray  # bool [...]: pair needs the coplanar path


def pair_intersects(
    tri_r: jnp.ndarray,
    tri_o: jnp.ndarray,
    plane_r: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    plane_o: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> PairResult:
    """Dense tri-tri intersection over broadcastable triangle arrays.

    Composition mirrors the shipped kernel (`narrow-phase.cu:473-537`):
      separated-by-robot-plane OR separated-by-obstacle-plane -> no hit;
      coplanar -> flagged (resolved separately, see ``coplanar_intersects``);
      otherwise the canonical interval test with ``>=`` no-overlap semantics.

    Args:
      tri_r: [..., 3, 3] robot triangles.
      tri_o: [..., 3, 3] obstacle triangles (broadcast-compatible).
      plane_r / plane_o: optionally precomputed (N, d) for each side.
    Returns:
      PairResult of booleans broadcast over leading dims.
    """
    n_r, d_r = plane_r if plane_r is not None else compute_plane(tri_r)
    n_o, d_o = plane_o if plane_o is not None else compute_plane(tri_o)

    dist_o = signed_dists(n_r, d_r, tri_o)  # obstacle corners vs robot plane
    sep_o = no_overlap(dist_o)
    dist_r = signed_dists(n_o, d_o, tri_r)  # robot corners vs obstacle plane
    sep_r = no_overlap(dist_r)
    coplanar = is_coplanar(n_r, d_r, n_o, d_o)

    # Origin-free projection (Moller'97's optimized form): only the line
    # DIRECTION matters — a shared origin shifts both triangles' interval
    # endpoints equally and cancels in the >= comparisons, so the
    # reference's 2x2 solves for it (`narrow-phase.cu:127-154`) are dropped.
    # This changes FP rounding only, not the TOL-band semantics; verdict
    # parity with the tagged goldens is asserted in CI and by bench.py.
    D = jnp.cross(n_r, n_o)
    ctri_r, cdist_r = canonicalize(tri_r, dist_r)
    ctri_o, cdist_o = canonicalize(tri_o, dist_o)

    t_r01 = parametric_t(ctri_r[..., 0, :], ctri_r[..., 1, :],
                         cdist_r[..., 0], cdist_r[..., 1], D)
    t_r12 = parametric_t(ctri_r[..., 1, :], ctri_r[..., 2, :],
                         cdist_r[..., 1], cdist_r[..., 2], D)
    t_o01 = parametric_t(ctri_o[..., 0, :], ctri_o[..., 1, :],
                         cdist_o[..., 0], cdist_o[..., 1], D)
    t_o12 = parametric_t(ctri_o[..., 1, :], ctri_o[..., 2, :],
                         cdist_o[..., 1], cdist_o[..., 2], D)

    min_r = jnp.minimum(t_r01, t_r12)
    max_r = jnp.maximum(t_r01, t_r12)
    min_o = jnp.minimum(t_o01, t_o12)
    max_o = jnp.maximum(t_o01, t_o12)
    separated_t = (min_r >= max_o) | (min_o >= max_r)

    reach_coplanar = ~sep_o & ~sep_r & coplanar
    collides = ~sep_o & ~sep_r & ~coplanar & ~separated_t
    return PairResult(collides=collides, coplanar=reach_coplanar)


# ---------------------------------------------------------------------------
# Coplanar resolution — the path the CUDA kernels punt on (they printf an
# error, `narrow-phase.cu:544-545`). The executable spec is
# `/root/reference/python/narrow.py:94-162`; this is its dense formulation.
# ---------------------------------------------------------------------------

def _d_mnop(m, n, o, p):
    """Sum((m-n) * (o-p)) over the trailing xyz axis (`narrow.py:94-95`)."""
    return jnp.sum((m - n) * (o - p), axis=-1)


def segments_intersect(p1, p2, p3, p4) -> jnp.ndarray:
    """Closest-approach segment intersection test (`narrow.py:98-121`,
    Paul Bourke's mutual-perpendicular construction), dense over leading dims.
    """
    d2121 = _d_mnop(p2, p1, p2, p1)
    d4343 = _d_mnop(p4, p3, p4, p3)
    d4321 = _d_mnop(p4, p3, p2, p1)
    d1343 = _d_mnop(p1, p3, p4, p3)
    d1321 = _d_mnop(p1, p3, p2, p1)

    mua_denom = d2121 * d4343 - d4321 * d4321
    bad_a = mua_denom == 0.0
    mua = (d1343 * d4321 - d1321 * d4343) / jnp.where(bad_a, 1.0, mua_denom)

    bad_b = d4343 == 0.0
    mub = (d1343 + mua * d4321) / jnp.where(bad_b, 1.0, d4343)

    in_range = (mua >= 0) & (mua <= 1) & (mub >= 0) & (mub <= 1)

    pa = p1 + mua[..., None] * (p2 - p1)
    pb = p3 + mub[..., None] * (p4 - p3)
    touch = jnp.all(isclose(pa, pb), axis=-1)
    return ~bad_a & ~bad_b & in_range & touch


def coplanar_intersects(tri_a: jnp.ndarray, tri_b: jnp.ndarray) -> jnp.ndarray:
    """Coplanar pair intersection = any edge-pair crossing (9 combinations,
    `narrow.py:123-132`) or AABB containment of one triangle in the other
    (`narrow.py:135-162`).

    Args:
      tri_a, tri_b: [..., 3, 3].
    Returns:
      bool [...].
    """
    edge_idx = [(0, 1), (0, 2), (1, 2)]
    hit = None
    for (i, j) in edge_idx:
        for (k, l) in edge_idx:
            h = segments_intersect(
                tri_a[..., i, :], tri_a[..., j, :],
                tri_b[..., k, :], tri_b[..., l, :],
            )
            hit = h if hit is None else (hit | h)

    a_lo = jnp.min(tri_a, axis=-2)
    a_hi = jnp.max(tri_a, axis=-2)
    b_lo = jnp.min(tri_b, axis=-2)
    b_hi = jnp.max(tri_b, axis=-2)
    a_in_b = jnp.all((a_lo >= b_lo) & (a_hi <= b_hi), axis=-1)
    b_in_a = jnp.all((b_lo >= a_lo) & (b_hi <= a_hi), axis=-1)
    return hit | a_in_b | b_in_a

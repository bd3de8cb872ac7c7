"""Tier-3 kernel-level tests of the full pair predicate.

Fixtures mirror the reference's synthetic suites: the interlocking-tetrahedra
pair (`test-narrow-phase.cu:628-686`), the float regression pair
(`python/test_narrow.py:208-217` / `test-narrow-phase.cu:688-739`), and a
randomized differential sweep against the independent float64 oracle.
"""
import numpy as np
import jax.numpy as jnp

from robocheck.ops import narrow as nar
from robocheck.oracle import cpu_oracle


TETRA_TRIS = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
# Interlocking tetrahedra near the origin (collide); the +100-x translate of
# the robot does not touch the obstacle.
ROB_PTS = np.array([[0, 0, 0], [0, 1, 2], [0, 2, 0], [2, 2, 2]], np.float32)
OBS_PTS = np.array(
    [[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0], [3.3, 2, 2]], np.float32
)


def _any_pair_hit(rob_pts, obs_pts):
    rob_tris = jnp.asarray(rob_pts[TETRA_TRIS])  # [4,3,3]
    obs_tris = jnp.asarray(obs_pts[TETRA_TRIS])
    res = nar.pair_intersects(
        rob_tris[:, None, :, :], obs_tris[None, :, :, :]
    )
    return bool(jnp.any(res.collides)), bool(jnp.any(res.coplanar))


def test_tetrahedra_colliding():
    hit, cop = _any_pair_hit(ROB_PTS, OBS_PTS)
    assert hit
    assert not cop


def test_tetrahedra_translated_clear():
    hit, cop = _any_pair_hit(ROB_PTS + np.array([100, 0, 0], np.float32), OBS_PTS)
    assert not hit
    assert not cop


def test_regression_problem_pair():
    # Near-miss pair that historically false-positived (reference
    # python/test_narrow.py:208: expected NOT overlapped).
    t1 = jnp.asarray(
        np.array(
            [
                [1.441547, -14.800514, 62.841087],
                [-4.215309, 8.199282, 23.057938],
                [1.883977, -15.487457, 62.381035],
            ],
            np.float32,
        )
    )
    t2 = jnp.asarray(
        np.array(
            [
                [1.681669, 2.616245, 1.069425],
                [3.561536, 0.677467, 1.707230],
                [1.172210, 2.534812, 1.852433],
            ],
            np.float32,
        )
    )
    res12 = nar.pair_intersects(t1, t2)
    res21 = nar.pair_intersects(t2, t1)
    assert not bool(res12.collides)
    assert not bool(res21.collides)


def test_degenerate_padding_triangle_never_hits():
    # A padding triangle (all corners identical) must self-mask via the
    # separation tests regardless of the partner triangle.
    degen = jnp.zeros((3, 3), dtype=jnp.float32)
    other = jnp.asarray(
        np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    )
    res = nar.pair_intersects(degen, other)
    assert not bool(res.collides)
    res = nar.pair_intersects(other, degen)
    assert not bool(res.collides)


def test_differential_vs_float64_oracle(rng):
    """Random triangle soup: the TOL-band predicate must agree with the
    independent float64 oracle away from its tolerance bands."""
    n = 4096
    t1 = rng.uniform(-1, 1, size=(n, 3, 3)).astype(np.float32)
    t2 = rng.uniform(-1, 1, size=(n, 3, 3)).astype(np.float32)

    res = nar.pair_intersects(jnp.asarray(t1), jnp.asarray(t2))
    fast = np.asarray(res.collides)
    exact = cpu_oracle.tri_tri_intersect(t1, t2)

    disagree = fast != exact
    # f32 TOL-band semantics vs exact float64 can differ only for borderline
    # geometry; on generic random soup the rate must be tiny.
    assert disagree.mean() < 0.005, (
        f"{disagree.sum()} / {n} disagreements with float64 oracle"
    )


def test_differential_near_contact(rng):
    """Triangles nudged to near-touching: the hard regime for tolerance
    semantics. Allows a slightly larger borderline band."""
    n = 2048
    base = rng.uniform(-1, 1, size=(n, 3, 3)).astype(np.float32)
    # Partner is a slightly shifted copy -> lots of near-contact pairs.
    shift = rng.normal(scale=0.05, size=(n, 1, 3)).astype(np.float32)
    other = (base + shift).astype(np.float32)
    perm = rng.permutation(3)
    other = other[:, perm]

    res = nar.pair_intersects(jnp.asarray(base), jnp.asarray(other))
    fast = np.asarray(res.collides | res.coplanar)
    exact = cpu_oracle.tri_tri_intersect(base, other)
    disagree = (fast != exact).mean()
    assert disagree < 0.02, f"near-contact disagreement rate {disagree}"

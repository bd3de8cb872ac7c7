"""Tier-2 unit tests for the narrow-phase helper math.

Mirrors the coverage of the reference helper suite
(`narrow-phase/test-narrow-phase.cu:7-626`) and the spec tests
(`python/test_narrow.py`), with expectations re-derived independently
(hand geometry + float64 NumPy), not transcribed.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from robocheck.core.constants import TOL
from robocheck.ops import narrow as nar


def T(*pts):
    return jnp.asarray(np.array(pts, dtype=np.float32))


class TestIsclose:
    def test_both_tiny(self):
        assert bool(nar.isclose(jnp.float32(1e-8), jnp.float32(-1e-8)))

    def test_one_tiny(self):
        assert not bool(nar.isclose(jnp.float32(1e-8), jnp.float32(0.5)))
        assert not bool(nar.isclose(jnp.float32(0.5), jnp.float32(1e-8)))

    def test_relative(self):
        assert bool(nar.isclose(jnp.float32(1000.0), jnp.float32(1000.0005)))
        assert not bool(nar.isclose(jnp.float32(1.0), jnp.float32(1.1)))

    def test_vectorized(self):
        a = jnp.asarray([1.0, 2.0, 1e-9], dtype=jnp.float32)
        b = jnp.asarray([1.0, -2.0, 0.0], dtype=jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(nar.isclose(a, b)), [True, False, True]
        )


class TestPlane:
    def test_unit_triangle(self):
        # Right triangle in the z=5 plane; N = +z scaled, d = -5*|N|.
        tri = T([0, 0, 5], [1, 0, 5], [0, 1, 5])
        n, d = nar.compute_plane(tri)
        np.testing.assert_allclose(np.asarray(n), [0, 0, 1], atol=1e-6)
        assert np.isclose(float(d), -5.0)

    def test_matches_float64(self, rng):
        tris = rng.normal(size=(64, 3, 3)).astype(np.float32)
        n, d = nar.compute_plane(jnp.asarray(tris))
        t64 = tris.astype(np.float64)
        n64 = np.cross(t64[:, 1] - t64[:, 0], t64[:, 2] - t64[:, 1])
        d64 = -np.sum(n64 * t64[:, 0], axis=-1)
        np.testing.assert_allclose(np.asarray(n), n64, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(d), d64, rtol=1e-4, atol=1e-4)


class TestSignedDistsNoOverlap:
    def test_signs(self):
        n = jnp.asarray([0.0, 0.0, 1.0], dtype=jnp.float32)
        d = jnp.float32(0.0)
        tri = T([0, 0, 1], [0, 0, 2], [0, 0, -1])
        dists = nar.signed_dists(n, d, tri)
        np.testing.assert_allclose(np.asarray(dists), [1, 2, -1], atol=1e-6)
        assert not bool(nar.no_overlap(dists))

    def test_all_one_side(self):
        dists = jnp.asarray([0.5, 1.0, 2.0], dtype=jnp.float32)
        assert bool(nar.no_overlap(dists))

    def test_tol_band(self):
        # Distances inside the +/-TOL band count as neither side.
        dists = jnp.asarray([TOL / 2, -TOL / 2, TOL / 2], dtype=jnp.float32)
        assert bool(nar.no_overlap(dists))
        # Exactly at the band edge: >= semantics include it.
        dists = jnp.asarray([TOL, -TOL, 0.0], dtype=jnp.float32)
        assert not bool(nar.no_overlap(dists))


class TestIntersectLine:
    def test_two_axis_planes(self):
        # x=0 plane (N=(1,0,0), d=0) and y=0 plane -> line along z through origin.
        n1 = jnp.asarray([1.0, 0, 0], dtype=jnp.float32)
        n2 = jnp.asarray([0.0, 1, 0], dtype=jnp.float32)
        D, O = nar.intersect_line(n1, jnp.float32(0), n2, jnp.float32(0))
        np.testing.assert_allclose(np.asarray(D), [0, 0, 1], atol=1e-6)
        np.testing.assert_allclose(np.asarray(O), [0, 0, 0], atol=1e-6)

    def test_point_on_both_planes(self, rng):
        # O must satisfy both plane equations; D must be orthogonal to both N.
        for _ in range(32):
            n1 = rng.normal(size=3).astype(np.float32)
            n2 = rng.normal(size=3).astype(np.float32)
            d1 = np.float32(rng.normal())
            d2 = np.float32(rng.normal())
            D, O = nar.intersect_line(
                jnp.asarray(n1), jnp.asarray(d1), jnp.asarray(n2), jnp.asarray(d2)
            )
            D, O = np.asarray(D, np.float64), np.asarray(O, np.float64)
            assert abs(n1 @ O + d1) < 1e-3
            assert abs(n2 @ O + d2) < 1e-3
            assert abs(D @ n1) < 1e-3 * np.linalg.norm(n1) * np.linalg.norm(D) + 1e-4
            assert abs(D @ n2) < 1e-3 * np.linalg.norm(n2) * np.linalg.norm(D) + 1e-4


class TestCanonicalize:
    CASES = [
        # (dists, expected corner order) — v2' must be the lone-side corner.
        ([1.0, 1.0, -1.0], (0, 2, 1)),
        ([-1.0, -1.0, 1.0], (0, 2, 1)),
        ([1.0, -1.0, 1.0], (0, 1, 2)),
        ([-1.0, 1.0, -1.0], (0, 1, 2)),
        ([1.0, -1.0, -1.0], (1, 0, 2)),
        ([-1.0, 1.0, 1.0], (1, 0, 2)),
    ]

    @pytest.mark.parametrize("dists,order", CASES)
    def test_truth_table(self, dists, order):
        tri = T([0, 0, 0], [1, 1, 1], [2, 2, 2])
        new_tri, new_d = nar.canonicalize(
            tri, jnp.asarray(dists, dtype=jnp.float32)
        )
        expect_tri = np.asarray(tri)[list(order)]
        expect_d = np.asarray(dists, dtype=np.float32)[list(order)]
        np.testing.assert_array_equal(np.asarray(new_tri), expect_tri)
        np.testing.assert_array_equal(np.asarray(new_d), expect_d)

    @pytest.mark.parametrize("dists,order", CASES)
    def test_middle_is_alone(self, dists, order):
        _, new_d = nar.canonicalize(
            T([0, 0, 0], [1, 1, 1], [2, 2, 2]),
            jnp.asarray(dists, dtype=jnp.float32),
        )
        d = np.asarray(new_d)
        assert np.sign(d[0]) == np.sign(d[2])
        assert np.sign(d[1]) != np.sign(d[0])


class TestIsCoplanar:
    def test_same_plane_scaled(self):
        n = jnp.asarray([1.0, 2.0, 3.0], dtype=jnp.float32)
        assert bool(
            nar.is_coplanar(n, jnp.float32(4.0), 2 * n, jnp.float32(8.0))
        )

    def test_zero_component_mismatch(self):
        n1 = jnp.asarray([1.0, 0.0, 3.0], dtype=jnp.float32)
        n2 = jnp.asarray([2.0, 1.0, 6.0], dtype=jnp.float32)
        assert not bool(nar.is_coplanar(n1, jnp.float32(0), n2, jnp.float32(0)))

    def test_ratio_mismatch(self):
        n1 = jnp.asarray([1.0, 2.0, 3.0], dtype=jnp.float32)
        n2 = jnp.asarray([2.0, 4.0, 7.0], dtype=jnp.float32)
        assert not bool(nar.is_coplanar(n1, jnp.float32(1), n2, jnp.float32(2)))

    def test_parallel_not_coplanar(self):
        # Same normal, different offset -> parallel planes, not coplanar.
        n = jnp.asarray([0.0, 0.0, 1.0], dtype=jnp.float32)
        assert not bool(nar.is_coplanar(n, jnp.float32(0), n, jnp.float32(5)))

    def test_zero_offsets_match(self):
        n = jnp.asarray([0.0, 0.0, 2.0], dtype=jnp.float32)
        assert bool(nar.is_coplanar(n, jnp.float32(0), 3 * n, jnp.float32(0)))


class TestCoplanarPath:
    def test_crossing_triangles(self):
        # Both in z=0; edges cross (spec fixture family, test_narrow.py:173-189).
        t1 = T([1, 1, 0], [-1, 1, 0], [1, 2, 3])
        t2 = T([0, 2, 0], [0, 0, 0], [100, 3, 2])
        assert bool(nar.coplanar_intersects(t1, t2))

    def test_contained_triangle(self):
        t1 = T([0, 0, 0], [0, 0, 1], [0, 1, 0])
        t2 = T([0, -1, -1], [0, -1, 3], [0, 3, -1])
        # No edge crossings, but t1 is inside t2 (AABB containment).
        assert bool(nar.coplanar_intersects(t1, t2))

    def test_disjoint_coplanar(self):
        t1 = T([0, 0, 0], [0, 0, 1], [0, 1, 0])
        t3 = T([0, 100, 200], [0, 100, 500], [0, 200, 300])
        assert not bool(nar.coplanar_intersects(t1, t3))

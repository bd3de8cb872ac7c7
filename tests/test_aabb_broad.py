"""AABB + broad-phase tests (reference fixtures re-derived:
`generate-AABB/test-generate-AABB.cu:83-115` exact serial-vs-parallel compare,
`broad-phase/broad-phase.cu:5-8` interval semantics)."""
import numpy as np
import jax.numpy as jnp

from robocheck.ops import aabb as ab
from robocheck.ops.pipeline import broad_phase


def test_vertices_aabb_exact():
    # Two 3-vertex "meshes" with known bounds, exact equality required.
    verts = np.array(
        [
            [[0, 1, 2], [-1, 5, 2], [3, -4, 0]],
            [[10, 10, 10], [12, 8, 11], [11, 9, 12]],
        ],
        np.float32,
    )
    out = np.asarray(ab.vertices_aabb(jnp.asarray(verts)))
    np.testing.assert_array_equal(out[0], [-1, -4, 0, 3, 5, 2])
    np.testing.assert_array_equal(out[1], [10, 8, 10, 12, 10, 12])


def test_triangle_aabbs():
    tris = np.array([[[0, 0, 0], [1, 2, -1], [0.5, -1, 3]]], np.float32)
    out = np.asarray(ab.triangle_aabbs(jnp.asarray(tris)))
    np.testing.assert_array_equal(out[0], [0, -1, -1, 1, 2, 3])


class TestOverlap:
    A = np.array([0, 0, 0, 1, 1, 1], np.float32)

    def run(self, b):
        return bool(ab.aabb_overlap(jnp.asarray(self.A), jnp.asarray(np.array(b, np.float32))))

    def test_identical(self):
        assert self.run([0, 0, 0, 1, 1, 1])

    def test_touching_faces_count(self):
        # Closed-interval semantics: shared face == overlap (<= comparisons).
        assert self.run([1, 0, 0, 2, 1, 1])

    def test_disjoint_one_axis(self):
        assert not self.run([2, 0, 0, 3, 1, 1])
        assert not self.run([0, 2, 0, 1, 3, 1])
        assert not self.run([0, 0, 2, 1, 1, 3])

    def test_containment(self):
        assert self.run([0.25, 0.25, 0.25, 0.75, 0.75, 0.75])


def test_broad_phase_far_configuration(alpha_meshes):
    robot, obstacle = alpha_meshes
    confs = np.zeros((2, 6), np.float32)
    confs[0, 0] = 10000.0  # far away -> no AABB overlap -> valid
    confs[1, :3] = 0.0  # at origin -> overlaps obstacle AABB
    valid, verts = broad_phase(
        jnp.asarray(confs),
        jnp.asarray(robot.vertices),
        jnp.asarray(obstacle.aabb),
    )
    assert bool(valid[0])
    assert not bool(valid[1])
    assert verts.shape == (2, robot.num_vertices, 3)

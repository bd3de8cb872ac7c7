"""Transform-stage tests (the reference's differential transform test,
`transformation/testing/GPU-transform-test.cu`, with the float64 oracle
standing in for FCL)."""
import numpy as np
import jax.numpy as jnp

from robocheck.ops import transform as tf
from robocheck.oracle.cpu_oracle import transform_vertices_f64


def test_identity_configuration():
    verts = np.array([[1, 2, 3], [-4, 5, -6]], np.float32)
    confs = np.zeros((1, 6), np.float32)
    out = np.asarray(tf.transform_vertices(jnp.asarray(confs), jnp.asarray(verts)))
    np.testing.assert_allclose(out[0], verts, atol=1e-6)


def test_pure_translation():
    verts = np.array([[1, 0, 0]], np.float32)
    confs = np.array([[10, -5, 2, 0, 0, 0]], np.float32)
    out = np.asarray(tf.transform_vertices(jnp.asarray(confs), jnp.asarray(verts)))
    np.testing.assert_allclose(out[0, 0], [11, -5, 2], atol=1e-6)


def test_yaw_quarter_turn():
    # yaw = pi/2 about Z maps +x to +y.
    verts = np.array([[1, 0, 0]], np.float32)
    confs = np.array([[0, 0, 0, 0, np.pi / 2, 0]], np.float32)
    out = np.asarray(tf.transform_vertices(jnp.asarray(confs), jnp.asarray(verts)))
    np.testing.assert_allclose(out[0, 0], [0, 1, 0], atol=1e-6)


def test_pitch_quarter_turn():
    # pitch = pi/2 about Y maps +x to -z.
    verts = np.array([[1, 0, 0]], np.float32)
    confs = np.array([[0, 0, 0, np.pi / 2, 0, 0]], np.float32)
    out = np.asarray(tf.transform_vertices(jnp.asarray(confs), jnp.asarray(verts)))
    np.testing.assert_allclose(out[0, 0], [0, 0, -1], atol=1e-6)


def test_roll_quarter_turn():
    # roll = pi/2 about X maps +y to +z.
    verts = np.array([[0, 1, 0]], np.float32)
    confs = np.array([[0, 0, 0, 0, 0, np.pi / 2]], np.float32)
    out = np.asarray(tf.transform_vertices(jnp.asarray(confs), jnp.asarray(verts)))
    np.testing.assert_allclose(out[0, 0], [0, 0, 1], atol=1e-6)


def test_rotation_matrices_orthonormal(rng):
    confs = rng.uniform(-np.pi, np.pi, size=(128, 6)).astype(np.float32)
    R = np.asarray(tf.rotation_matrices(jnp.asarray(confs)))
    eye = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_differential_vs_float64(rng, alpha_meshes):
    """Per-vertex agreement with the float64 oracle transform within 1e-4
    absolute on alpha-scale coordinates (reference uses 1e-5 on a GTX-1080,
    `GPU-transform-test.cu:8-13`; f32 rounding on ~600-unit translations
    dominates)."""
    robot, _ = alpha_meshes
    confs = rng.uniform(-np.pi, np.pi, size=(16, 6)).astype(np.float32)
    confs[:, :3] = rng.uniform(-600, 600, size=(16, 3)).astype(np.float32)

    fast = np.asarray(
        tf.transform_vertices(jnp.asarray(confs), jnp.asarray(robot.vertices))
    )
    for i in range(confs.shape[0]):
        exact = transform_vertices_f64(confs[i], robot.vertices)
        np.testing.assert_allclose(fast[i], exact, atol=2e-4)

"""Native C++ library tests: parsers must bit-match the Python loaders, and
the native oracle must agree with the NumPy float64 oracle."""
import numpy as np
import pytest

from robocheck.io import assets
from robocheck.io.conf import read_conf_file
from robocheck.io.obj import load_obj
from robocheck.models.shapes import icosphere
from robocheck.oracle import cpu_oracle
from robocheck.runtime import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (make -C native)"
)


def test_conf_parser_matches_python():
    path = assets.dataset_path("hard10k")
    confs, valid = native.parse_conf(str(path))
    ds = read_conf_file(path)
    np.testing.assert_array_equal(confs, ds.confs)
    np.testing.assert_array_equal(valid, ds.valid)


def test_obj_parser_matches_python():
    path = assets.alpha_robot_path()
    verts, tris = native.parse_obj(str(path))
    mesh = load_obj(path)
    np.testing.assert_array_equal(verts, mesh.vertices)
    np.testing.assert_array_equal(tris, mesh.triangles)


def test_conf_writer_roundtrip(tmp_path, rng):
    confs = rng.normal(size=(32, 6)).astype(np.float32)
    valid = rng.random(32) > 0.4
    p = tmp_path / "n.conf"
    native.write_conf(str(p), confs, valid.astype(np.int8))
    back_c, back_v = native.parse_conf(str(p))
    np.testing.assert_allclose(back_c, confs, rtol=1e-5)
    np.testing.assert_array_equal(back_v, valid)
    assert p.read_text().startswith(f"There are {valid.sum()} valid")


def test_native_oracle_matches_numpy(rng):
    robot = icosphere(1, radius=1.0)
    obstacle = icosphere(1, radius=1.5)
    confs = rng.uniform(-3, 3, size=(64, 6)).astype(np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    v_native = native.oracle_check(
        robot.vertices, robot.triangles, obstacle.vertices,
        obstacle.triangles, confs,
    )
    v_numpy = cpu_oracle.check_configs(robot, obstacle, confs)
    np.testing.assert_array_equal(v_native, v_numpy)


def test_native_oracle_bvh_deep_traversal(rng):
    # A large irregular triangle soup forces real BVH traversal (many levels,
    # partial leaves, empty-overlap prunes). Verdicts must equal the numpy
    # oracle's linear-scan semantics exactly.
    from robocheck.models.shapes import triangle_soup

    obstacle = triangle_soup(rng, 3000, extent=2.0)
    robot = icosphere(1, radius=0.15)
    confs = rng.uniform(-2.5, 2.5, size=(96, 6)).astype(np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (96, 3)).astype(np.float32)
    v_native = native.oracle_check(
        robot.vertices, robot.triangles, obstacle.vertices,
        obstacle.triangles, confs,
    )
    v_numpy = cpu_oracle.check_configs(robot, obstacle, confs)
    np.testing.assert_array_equal(v_native, v_numpy)
    assert 0 < v_native.sum() < len(confs)  # mixed verdicts, not degenerate


def test_native_oracle_matches_goldens(alpha_meshes, hard10k):
    robot, obstacle = alpha_meshes
    n = 256
    v = native.oracle_check(
        robot.vertices, robot.triangles, obstacle.vertices,
        obstacle.triangles, hard10k.confs[:n],
    )
    np.testing.assert_array_equal(v, hard10k.valid[:n])

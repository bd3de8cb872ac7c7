"""Device clearance engine (`planner/clearance.py`) correctness.

The engine must produce a SOUND lower bound on the true min posed-vertex to
obstacle-surface distance (certificates consume only that direction), and
must stay within its documented error bound of the exact answer (else the
certifier would subdivide forever).  Truth here is float64 numpy brute
force, cross-checked against the native BVH when the library is built.
"""
import numpy as np
import pytest

from robocheck.io import assets
from robocheck.io.obj import load_obj
from robocheck.models.shapes import box, icosphere
from robocheck.planner.ccd import subdivide_mesh
from robocheck.planner.clearance import ClearanceEngine
from robocheck.runtime import native


def _truth(robot_verts, obstacle, confs):
    """f64 brute-force min vertex->surface distance per configuration."""
    import jax
    import jax.numpy as jnp

    from robocheck.ops.transform import rotation_matrices
    from robocheck.planner.sdf import point_triangle_distance

    R = np.asarray(rotation_matrices(jnp.asarray(
        np.asarray(confs, np.float32))), np.float64)
    tri = np.asarray(obstacle.triangle_vertices, np.float64)
    v = np.asarray(robot_verts, np.float64)
    out = np.empty(len(confs))
    with jax.enable_x64(True):
        jt = jnp.asarray(tri)
        for i in range(len(confs)):
            pts = v @ R[i].T + np.asarray(confs[i][0:3], np.float64)
            d = point_triangle_distance(
                jnp.asarray(pts)[:, None, :], jt[None])
            out[i] = float(jnp.min(d))
    return out


def _rand_confs(rng, n, tmax):
    confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
    confs[:, 0:3] = rng.uniform(-tmax, tmax, (n, 3))
    return confs


def test_soundness_and_tightness_synthetic():
    robot = icosphere(2, radius=0.4, name="r")
    obstacle = icosphere(1, radius=1.0, name="o")
    eng = ClearanceEngine(robot.vertices, obstacle)
    rng = np.random.default_rng(3)
    confs = _rand_confs(rng, 24, 2.5)
    d = eng.min_distances(confs)
    ref = _truth(robot.vertices, obstacle, confs)
    err = eng.err_bound(confs)
    diff = ref - d
    assert (diff >= 0).all(), f"not a lower bound: {diff.min()}"
    assert diff.max() <= 2 * err, (diff.max(), err)


def test_soundness_near_contact_alpha():
    # The regime the certificate lives in: refined robot, distances well
    # below one grid cell, translations chosen near the obstacle surface.
    robot = subdivide_mesh(load_obj(assets.alpha_robot_path()), 2)
    obstacle = load_obj(assets.alpha_obstacle_path())
    eng = ClearanceEngine(robot.vertices, obstacle)
    rng = np.random.default_rng(7)
    confs = _rand_confs(rng, 12, 1.0)
    confs[:, 0:3] += obstacle.aabb[:3] * 0.5 + obstacle.aabb[3:] * 0.5
    d = eng.min_distances(confs)
    ref = _truth(robot.vertices, obstacle, confs)
    err = eng.err_bound(confs)
    diff = ref - d
    assert (diff >= 0).all(), f"not a lower bound: {diff.min()}"
    assert diff.max() <= 2 * err, (diff.max(), err)


@pytest.mark.skipif(not (native.available() and native.has_point_mesh_dist()),
                    reason="native library not built")
def test_matches_native_bvh():
    # Cross-backend agreement: the engine's haircut answer must bracket the
    # native f64 BVH answer from below within 2x the documented bound.
    robot = subdivide_mesh(load_obj(assets.alpha_robot_path()), 1)
    obstacle = load_obj(assets.alpha_obstacle_path())
    eng = ClearanceEngine(robot.vertices, obstacle)
    rng = np.random.default_rng(11)
    confs = _rand_confs(rng, 16, 30.0)
    d = eng.min_distances(confs)
    import jax.numpy as jnp

    from robocheck.ops.transform import rotation_matrices

    R = np.asarray(rotation_matrices(jnp.asarray(confs)), np.float64)
    ov = np.ascontiguousarray(obstacle.vertices, np.float64)
    ot = np.ascontiguousarray(obstacle.triangles, np.int32)
    verts = robot.vertices.astype(np.float64)
    ref = np.empty(len(confs))
    for i in range(len(confs)):
        pts = verts @ R[i].T + confs[i, None, 0:3].astype(np.float64)
        ref[i] = native.point_mesh_dist(ov, ot, pts).min()
    err = eng.err_bound(confs)
    diff = ref - d
    assert (diff >= 0).all() and diff.max() <= 2 * err, (
        diff.min(), diff.max(), err)


def test_single_block_and_tiny_meshes():
    # num_blocks == 1 exercises the no-culling path.
    robot = box(extent=(0.2, 0.2, 0.2), name="r")
    obstacle = box(extent=(1.0, 1.0, 1.0), name="o")
    eng = ClearanceEngine(robot.vertices, obstacle)
    assert eng.num_blocks == 1
    confs = np.zeros((3, 6), np.float32)
    confs[:, 0] = [0.0, 1.5, 4.0]
    d = eng.min_distances(confs)
    ref = _truth(robot.vertices, obstacle, confs)
    err = eng.err_bound(confs)
    assert ((ref - d) >= 0).all() and (ref - d).max() <= 2 * err


def test_sharded_engine_matches_unsharded():
    import jax

    from robocheck.parallel.sharding import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    robot = subdivide_mesh(icosphere(2, radius=0.4, name="r"), 1)
    obstacle = icosphere(1, radius=1.0, name="o")
    rng = np.random.default_rng(5)
    confs = _rand_confs(rng, 16, 2.0)
    eng0 = ClearanceEngine(robot.vertices, obstacle)
    eng8 = ClearanceEngine(robot.vertices, obstacle,
                              mesh=make_mesh(len(jax.devices())))
    d0 = eng0.min_distances(confs)
    d8 = eng8.min_distances(confs)
    np.testing.assert_allclose(d0, d8, atol=1e-6)


def test_certifier_device_backend_certifies_wall_gap():
    # The exact device backend must certify a clearance the grid path cannot
    # (below e_g + r_cov), same scenario as test_ccd's native multires.
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.planner.ccd import SweptCertifier, certify_multires

    robot = box(extent=(0.1, 0.1, 0.1), name="r")
    wall = box(extent=(0.4, 4.0, 4.0), name="wall")
    checker = MegaKernelChecker(robot, wall)
    cert = SweptCertifier(robot, wall, refine=2, exact=True, backend="device")
    path = np.zeros((3, 6), np.float32)
    path[:, 0] = 0.05 + 0.2 + 0.08
    path[:, 1] = [-1.0, 0.0, 1.0]
    res = cert.certify(path, checker, max_depth=6)
    assert res.certified and not res.collision
    # A tunneling path is still refuted through the subdivision checks.
    tun = np.zeros((2, 6), np.float32)
    tun[0, 0], tun[1, 0] = -2.0, 2.0
    res2 = certify_multires(robot, wall, tun, checker,
                            levels=((0, 6), (2, 8)), backend="device")
    assert res2.collision and not res2.certified


def test_subdivide_vertices_matches_mesh_subdivision():
    # The exact certifiers sample subdivide_vertices' output; it must be
    # exactly the vertex array subdivide_mesh would have produced (same
    # set, same order) at every chained level.
    from robocheck.planner.ccd import subdivide_mesh, subdivide_vertices

    base = icosphere(1, radius=0.7, name="m")
    for lv in (1, 2, 3):
        a = subdivide_mesh(base, lv).vertices
        b = subdivide_vertices(base, lv)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_batched_multires_matches_per_segment():
    # certify_multires batches a level's segments into one masked certify
    # call; the result must match certifying each segment independently.
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.planner.ccd import SweptCertifier

    robot = box(extent=(0.1, 0.1, 0.1), name="r")
    wall = box(extent=(0.4, 4.0, 4.0), name="wall")
    checker = MegaKernelChecker(robot, wall)
    cert = SweptCertifier(robot, wall, refine=1, exact=True, backend="device")
    segs = []
    for x in (-1.5, 1.5):
        s = np.zeros((3, 6), np.float32)
        s[:, 0] = x
        s[:, 1] = [-1.0, 0.0, 1.0]
        segs.append(s)
    concat = np.concatenate(segs)
    mask = np.ones(len(concat) - 1, bool)
    mask[len(segs[0]) - 1] = False
    batched = cert.certify(concat, checker, max_depth=5, step_mask=mask)
    singles = [cert.certify(s, checker, max_depth=5) for s in segs]
    assert batched.certified == all(s.certified for s in singles)
    assert not batched.collision
    if batched.certified:
        np.testing.assert_allclose(
            batched.min_clearance,
            min(s.min_clearance for s in singles), rtol=1e-9)


@pytest.mark.skipif(not (native.available() and native.has_point_mesh_dist()),
                    reason="native library not built")
def test_multires_backend_verdict_agreement():
    # Randomized cross-backend stress: the device and native exact backends
    # must agree on certified/collision verdicts over random scenes (the
    # device engine's haircut can only cost extra subdivision depth, not
    # flip an outcome at these clearances).
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.planner.ccd import certify_multires

    rng = np.random.default_rng(13)
    robot = box(extent=(0.12, 0.12, 0.12), name="r")
    for trial in range(3):
        wall = box(extent=(0.4, 3.0, 3.0), name="wall")
        checker = MegaKernelChecker(robot, wall)
        # A clear pass-around path with randomized waypoint jitter.
        path = np.zeros((4, 6), np.float32)
        path[:, 0] = 0.26 + 0.06 + rng.uniform(0.0, 0.3)
        path[:, 1] = np.linspace(-1.2, 1.2, 4)
        path[1:3, 2] += rng.uniform(-0.3, 0.3, 2).astype(np.float32)
        results = {}
        for backend in ("device", "native"):
            res = certify_multires(robot, wall, path, checker,
                                   levels=((0, 5), (2, 7)), backend=backend)
            results[backend] = (res.certified, res.collision)
        assert results["device"] == results["native"], (trial, results)


def test_certify_step_mask_junctions_ignored():
    # Two independently-certifiable segments concatenated with a junction
    # step that passes straight through the wall: with the junction masked
    # out, the batch must certify; with it real, it must not.
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.planner.ccd import SweptCertifier

    robot = box(extent=(0.1, 0.1, 0.1), name="r")
    wall = box(extent=(0.4, 4.0, 4.0), name="wall")
    checker = MegaKernelChecker(robot, wall)
    cert = SweptCertifier(robot, wall, refine=1, exact=True, backend="device")
    left = np.zeros((2, 6), np.float32)
    left[:, 0] = -1.5
    left[:, 1] = [-0.5, 0.5]
    right = left.copy()
    right[:, 0] = 1.5
    concat = np.concatenate([left, right])
    mask = np.array([True, False, True])
    res = cert.certify(concat, checker, step_mask=mask, max_depth=4)
    assert res.certified and not res.collision
    res2 = cert.certify(concat, checker, max_depth=4)
    assert not res2.certified

"""Continuous (swept-volume) certification tests — planner/ccd.py.

The reference has no edge-validation code at all (its alpha assets ship a
start/goal query, `models/alpha1.0/alpha.query:1-2`, with nothing to check
a path); discrete densify+check can tunnel. These tests pin the three
behaviors that make the certifier trustworthy: it refutes tunneling paths
discrete checks miss, it certifies clearly-free motion, and its stated
floor is honest (near-floor clearances yield 'unproven', not lies).
"""
import numpy as np
import pytest

from robocheck.core.types import Mesh
from robocheck.kernels.megakernel import MegaKernelChecker
from robocheck.models.shapes import box, icosphere
from robocheck.planner.ccd import (
    SweptCertifier,
    covering_radius,
    subdivide_mesh,
)


@pytest.fixture(scope="module")
def wall_world():
    robot = box(extent=(0.4, 0.4, 0.4), name="robot")
    wall = box(extent=(0.1, 6.0, 6.0), name="wall")
    checker = MegaKernelChecker(robot, wall)
    cert = SweptCertifier(robot, wall, resolution=64)
    return robot, wall, checker, cert


def test_subdivision_halves_covering_radius():
    m = icosphere(1, radius=1.0)
    r0 = covering_radius(m)
    m1 = subdivide_mesh(m, 1)
    r1 = covering_radius(m1)
    assert m1.num_triangles == 4 * m.num_triangles
    assert abs(r1 - r0 / 2) < 1e-6  # midpoint split halves every edge


def test_refutes_tunneling_path(wall_world):
    # Two waypoints straddling the wall: every DISCRETE sample is free, but
    # the straight-line motion passes through the wall. The certifier's
    # midpoint subdivision must find the collision and refute.
    robot, wall, checker, cert = wall_world
    path = np.zeros((2, 6), dtype=np.float32)
    path[0, 0] = -2.0
    path[1, 0] = 2.0
    assert checker.check_valid_resolved(path).all()  # the tunneling setup
    res = cert.certify(path, checker)
    assert res.collision and not res.certified


def test_certifies_clearly_free_path(wall_world):
    # Motion parallel to the wall, 3 units clear: certifiable well above
    # the method floor, including a rotation component.
    robot, wall, checker, cert = wall_world
    path = np.zeros((3, 6), dtype=np.float32)
    path[:, 0] = 3.0
    path[:, 1] = [-2.0, 0.0, 2.0]
    path[2, 5] = 0.5  # roll along the way
    assert cert.floor() < 1.0
    res = cert.certify(path, checker)
    assert res.certified and not res.collision
    assert res.min_clearance > cert.floor()


def test_near_floor_clearance_is_unproven_not_lied_about(wall_world):
    # A free path skimming the wall at a clearance below the method floor:
    # must come back uncertified (honest gap), NOT certified, and NOT
    # reported as a collision.
    robot, wall, checker, cert = wall_world
    gap = 0.5 * cert.floor()
    path = np.zeros((3, 6), dtype=np.float32)
    path[:, 0] = 0.05 + 0.2 + gap  # wall half-extent + robot half + gap
    path[:, 1] = [-1.0, 0.0, 1.0]
    assert checker.check_valid_resolved(path).all()
    res = cert.certify(path, checker, max_depth=4)
    assert not res.certified and not res.collision
    assert res.uncertified_steps > 0
    # The measured gap statement: the worst SEEN clearance sits below the
    # floor (min_clearance itself now reports only the PROVEN margin —
    # the far ends of this path do certify, at healthy clearance).
    assert res.min_seen_clearance < cert.floor()


def test_trajopt_swept_certificate():
    # End-to-end: the optimizer's certificate upgrades to continuous when
    # swept_certify is on (small scene, interpret mode).
    from robocheck.planner.trajopt import TrajectoryOptimizer, TrajOptConfig

    robot = box(extent=(0.3, 0.3, 0.3), name="robot")
    obstacle = icosphere(1, radius=0.6, name="ball")
    opt = TrajectoryOptimizer(
        robot, obstacle,
        TrajOptConfig(num_waypoints=12, iters_per_round=60, max_rounds=3,
                      grid_resolution=32, swept_certify=True, seed=3),
    )
    start = np.array([-2.0, 0, 0, 0, 0, 0], np.float32)
    goal = np.array([2.0, 0, 0, 0, 0, 0], np.float32)
    res = opt.plan(start, goal)
    assert res.certified
    assert res.swept is not None and not res.swept.collision
    # The sphere world is wide open: the continuous certificate should
    # succeed outright here.
    assert res.swept.certified


def test_exact_mode_and_multires(wall_world):
    # Exact-distance clearance (native BVH): floor = r_cov alone, so a path
    # the grid-based certifier cannot decide (clearance below e_g + r_cov)
    # certifies under multi-resolution escalation.
    from robocheck.planner.ccd import certify_multires
    from robocheck.runtime import native

    if not native.available():
        pytest.skip("native library not built")
    robot, wall, checker, cert_grid = wall_world
    gap = 0.6 * cert_grid.floor()  # undecidable for the grid certifier
    path = np.zeros((3, 6), dtype=np.float32)
    path[:, 0] = 0.05 + 0.2 + gap
    path[:, 1] = [-1.0, 0.0, 1.0]
    assert checker.check_valid_resolved(path).all()
    res_grid = cert_grid.certify(path, checker, max_depth=4)
    assert not res_grid.certified and not res_grid.collision
    res = certify_multires(robot, wall, path, checker,
                           levels=((0, 6), (2, 8)))
    assert res.certified and not res.collision
    # And a genuinely tunneling path is still refuted.
    tun = np.zeros((2, 6), dtype=np.float32)
    tun[0, 0] = -2.0
    tun[1, 0] = 2.0
    res2 = certify_multires(robot, wall, tun, checker,
                            levels=((0, 6), (2, 8)))
    assert res2.collision and not res2.certified

"""Planner-layer tests: distance field, trajectory optimizer, batch PRM —
on small synthetic scenes (CPU interpret mode)."""
import numpy as np
import jax.numpy as jnp
import pytest

from robocheck.models.shapes import box, icosphere
from robocheck.planner.prm import PRMConfig, PRMPlanner
from robocheck.planner.sdf import (
    build_distance_grid,
    point_triangle_distance,
)
from robocheck.planner.trajopt import TrajectoryOptimizer, TrajOptConfig


class TestPointTriangleDistance:
    TRI = jnp.asarray(
        np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    )

    def d(self, p):
        return float(
            point_triangle_distance(jnp.asarray(np.array(p, np.float32)), self.TRI)
        )

    def test_above_face(self):
        assert np.isclose(self.d([0.5, 0.5, 3.0]), 3.0, atol=1e-5)

    def test_at_vertex(self):
        assert np.isclose(self.d([-1, -1, 0]), np.sqrt(2), atol=1e-5)

    def test_on_edge(self):
        assert np.isclose(self.d([1.0, -2.0, 0.0]), 2.0, atol=1e-5)

    def test_inside_zero(self):
        assert np.isclose(self.d([0.5, 0.5, 0.0]), 0.0, atol=1e-6)

    def test_beyond_hypotenuse(self):
        # Point past the bc edge, in-plane.
        assert np.isclose(self.d([2, 2, 0]), np.sqrt(2), atol=1e-5)


class TestDistanceGrid:
    def test_sphere_distances(self):
        sphere = icosphere(2, radius=1.0)
        grid = build_distance_grid(sphere, resolution=48, padding=0.5)
        # Distance from a point at radius 1.8 to the unit sphere surface ~ 0.8.
        d = float(grid.query(jnp.asarray([1.8, 0.0, 0.0], dtype=jnp.float32)))
        assert abs(d - 0.8) < 0.08
        # The field is signed: the sphere's center is ~one (chord) radius
        # INSIDE, with trilinear smoothing at the distance-field peak.
        d0 = float(grid.query(jnp.asarray([0.0, 0.0, 0.0], dtype=jnp.float32)))
        assert abs(d0 + 0.98) < 0.15

    def test_query_differentiable(self):
        import jax

        sphere = icosphere(1, radius=1.0)
        grid = build_distance_grid(sphere, resolution=32, padding=0.5)
        g = jax.grad(lambda p: grid.query(p))(
            jnp.asarray([1.5, 0.1, 0.1], dtype=jnp.float32)
        )
        # Gradient points away from the obstacle (increasing distance).
        assert float(g[0]) > 0.1


@pytest.mark.slow
class TestTrajOpt:
    def test_plans_around_sphere(self):
        # A ball at the origin; the distance-field gradient bends the path
        # around it (pure local optimization, no global planner needed).
        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = icosphere(2, radius=1.0, name="ball")
        opt = TrajectoryOptimizer(
            robot, obstacle,
            TrajOptConfig(num_waypoints=16, iters_per_round=200,
                          max_rounds=6, margin=0.35, grid_resolution=40,
                          num_surface_samples=64),
        )
        start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([3, 0, 0, 0, 0, 0], np.float32)
        # Straight-line init passes through the ball.
        init_valid, *_ = opt.checker.check(opt.initial_trajectory(start, goal))
        assert not init_valid.all()
        res = opt.plan(start, goal)
        assert res.certified, f"not certified after {res.rounds} rounds"
        assert res.valid.all()
        # Endpoints pinned.
        np.testing.assert_allclose(res.trajectory[0], start, atol=1e-6)
        np.testing.assert_allclose(res.trajectory[-1], goal, atol=1e-6)
        # The path must have moved off the straight line to clear the ball.
        mids = res.trajectory[4:-4]
        assert np.abs(mids[:, 1:3]).max() > 0.5

    def test_wall_needs_global_planner(self):
        # Large-wall scene: a pure local optimizer has no lateral gradient
        # mid-slab and must NOT claim certification; the PRM-seeded pipeline
        # (TestPipeline) is the way through.
        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = box(extent=(0.5, 4.0, 4.0), name="wall")
        opt = TrajectoryOptimizer(
            robot, obstacle,
            TrajOptConfig(num_waypoints=12, iters_per_round=60,
                          max_rounds=2, margin=0.3, grid_resolution=32,
                          num_surface_samples=32),
        )
        start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([3, 0, 0, 0, 0, 0], np.float32)
        res = opt.plan(start, goal)
        # Whatever it returns, the certificate must be honest: verify the
        # densified path with the checker directly.
        from robocheck.planner.trajopt import densify

        dense, _ = densify(res.trajectory, 0.3)
        dvalid, *_ = opt.checker.check(dense)
        assert res.certified == bool(dvalid.all())


@pytest.mark.slow
class TestSQP:
    def test_sqp_around_sphere(self):
        from robocheck.planner.sqp import SQPConfig, SQPOptimizer

        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = icosphere(2, radius=1.0, name="ball")
        opt = SQPOptimizer(
            robot, obstacle,
            SQPConfig(num_waypoints=16, max_outer=15, top_k=4, margin=0.35,
                      grid_resolution=40, num_surface_samples=64),
        )
        start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([3, 0, 0, 0, 0, 0], np.float32)
        res = opt.plan(start, goal)
        assert res.certified, f"not certified after {res.outer_iters} iters"
        np.testing.assert_allclose(res.trajectory[0], start, atol=1e-6)
        np.testing.assert_allclose(res.trajectory[-1], goal, atol=1e-6)
        # Deviates around the ball.
        assert np.abs(res.trajectory[4:-4, 1:3]).max() > 0.5

    def test_sqp_checkpoint_resume(self, tmp_path):
        from robocheck.planner.sqp import SQPConfig, SQPOptimizer
        from robocheck.runtime import checkpoint

        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = icosphere(2, radius=1.0, name="ball")
        path = str(tmp_path / "sqp.npz")
        cfg = SQPConfig(num_waypoints=16, max_outer=6, top_k=4, margin=0.35,
                        grid_resolution=40, num_surface_samples=64,
                        max_penalty_rounds=1, checkpoint_path=path,
                        checkpoint_every=2)
        opt = SQPOptimizer(robot, obstacle, cfg)
        start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([3, 0, 0, 0, 0, 0], np.float32)
        opt.plan(start, goal)
        arrays, meta = checkpoint.load(path)
        assert arrays["q"].shape == (16, 6)
        assert meta["outer"] >= 2
        # Resume picks up the checkpointed trajectory (endpoints re-pinned).
        res2 = opt.plan(start, goal, resume=True)
        np.testing.assert_allclose(res2.trajectory[0], start, atol=1e-6)
        np.testing.assert_allclose(res2.trajectory[-1], goal, atol=1e-6)


@pytest.mark.slow
class TestPipeline:
    def test_prm_seeded_optimization_through_wall(self):
        from robocheck.planner import plan_and_smooth
        from robocheck.planner.prm import PRMConfig

        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = box(extent=(0.5, 3.0, 3.0), name="wall")
        res = plan_and_smooth(
            robot, obstacle,
            np.array([-3, 0, 0, 0, 0, 0], np.float32),
            np.array([3, 0, 0, 0, 0, 0], np.float32),
            prm_config=PRMConfig(num_samples=256, k_neighbors=8,
                                 edge_resolution=8),
            opt_config=TrajOptConfig(num_waypoints=16, iters_per_round=100,
                                     max_rounds=4, margin=0.25,
                                     grid_resolution=32,
                                     num_surface_samples=32),
        )
        assert res is not None, "PRM found no path"
        assert res.certified


@pytest.mark.slow
class TestPRM:
    def test_plans_around_box(self):
        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = box(extent=(0.5, 3.0, 3.0), name="wall")
        planner = PRMPlanner(
            robot, obstacle,
            PRMConfig(num_samples=256, k_neighbors=8, edge_resolution=8),
            sample_box=((-4, 4), (-3, 3), (-3, 3)),
        )
        start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([3, 0, 0, 0, 0, 0], np.float32)
        res = planner.plan(start, goal)
        assert res.path is not None, "no path found"
        np.testing.assert_allclose(res.path[0], start, atol=1e-6)
        np.testing.assert_allclose(res.path[-1], goal, atol=1e-6)
        # Every waypoint on the returned path is individually valid.
        v, *_ = planner.checker.check(res.path)
        assert v.all()


class TestPlannerCoplanarCertify:
    def test_certify_rejects_coplanar_contact(self):
        # A trajectory resting at a near-coplanar face-on-face contact (the
        # fixture of tests/test_megakernel.py::TestCoplanarResolution) must
        # NOT be certified: the raw kernel only flags the pair; the planner
        # path resolves it in float64 and sees the collision.
        from robocheck.core.types import Mesh
        from tests.test_megakernel import TestCoplanarResolution as F

        tris = np.array([[0, 1, 2]], np.int32)
        robot = Mesh(F.RT, tris, name="r")
        obstacle = Mesh(F.OT, tris, name="o")
        opt = TrajectoryOptimizer(
            robot, obstacle,
            TrajOptConfig(num_waypoints=4, iters_per_round=1, max_rounds=1,
                          grid_resolution=8, num_surface_samples=8),
        )
        raw, cop = opt.checker.check_valid(np.zeros((1, 6), np.float32))
        assert raw[0] and cop[0]  # the raw path would have certified this
        traj = np.zeros((3, 6), np.float32)
        waypoint_valid, certified, _ = opt._certify(traj)
        assert not certified
        assert not waypoint_valid.all()


class TestRRTConnect:
    def _gap_world(self):
        # Two wall slabs with a narrow gap between them: the passage is
        # ~1.2x the robot diameter — uniform PRM at small sample counts
        # rarely threads it, boundary-biased RRT-Connect should.
        from robocheck.core.types import Mesh
        from robocheck.models.shapes import box, icosphere

        robot = icosphere(1, radius=0.25, name="robot")
        top = box(extent=(0.4, 3.0, 2.6), center=(0.0, 0.0, 1.65))
        bot = box(extent=(0.4, 3.0, 2.6), center=(0.0, 0.0, -1.65))
        wall = Mesh.merge([top, bot], name="gap-wall")
        return robot, wall

    def test_threads_narrow_gap(self):
        from robocheck.planner.rrt import RRTConfig, RRTConnectPlanner
        from robocheck.planner.trajopt import densify

        robot, wall = self._gap_world()
        planner = RRTConnectPlanner(
            robot, wall,
            RRTConfig(max_iters=30, batch=64, edge_resolution=8, seed=2),
        )
        start = np.array([-2.5, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([2.5, 0, 0, 0, 0, 0], np.float32)
        res = planner.plan(start, goal)
        assert res.path is not None, (
            f"no path after {res.iters} iters / {res.num_nodes} nodes"
        )
        np.testing.assert_allclose(res.path[0], start, atol=1e-6)
        np.testing.assert_allclose(res.path[-1], goal, atol=1e-6)
        # Certify the path at a fine discretization (no tunneling).
        dense, _ = densify(res.path, step=0.1)
        dv = planner.checker.check_valid_resolved(dense)
        assert dv.all(), f"{int((~dv).sum())}/{len(dv)} densified collide"

    def test_invalid_endpoint_reports_no_path(self):
        from robocheck.planner.rrt import RRTConfig, RRTConnectPlanner

        robot, wall = self._gap_world()
        planner = RRTConnectPlanner(
            robot, wall, RRTConfig(max_iters=2, batch=16),
        )
        inside = np.array([0.0, 0.0, 1.65, 0, 0, 0], np.float32)  # in slab
        goal = np.array([2.5, 0, 0, 0, 0, 0], np.float32)
        res = planner.plan(inside, goal)
        assert res.path is None and res.num_nodes == 0


class TestShardedPlanner:
    """BASELINE.json configs[4]: planner-in-the-loop under batch sharding —
    constraint blocks evaluated waypoint-sharded with a psum-reduced penalty
    total, certification batches through the sharded checker (8 virtual CPU
    devices, see conftest)."""

    def test_sqp_sharded_certifies_and_matches(self):
        import jax

        from robocheck.models.shapes import box, icosphere
        from robocheck.parallel.sharding import ShardedChecker, make_mesh
        from robocheck.planner.sqp import SQPConfig, SQPOptimizer

        if len(jax.devices()) < 2:
            import pytest

            pytest.skip("needs a multi-device mesh")
        robot = box(extent=(0.3, 0.3, 0.3), name="robot")
        obstacle = icosphere(1, radius=0.6, name="ball")
        cfg = SQPConfig(num_waypoints=16, max_outer=6, max_penalty_rounds=2,
                        subproblem_iters=30, grid_resolution=24,
                        num_surface_samples=64, seed=5)
        start = np.array([-2.0, 0, 0, 0, 0, 0], np.float32)
        goal = np.array([2.0, 0, 0, 0, 0, 0], np.float32)

        mesh = make_mesh()
        opt_s = SQPOptimizer(robot, obstacle, cfg, mesh=mesh)
        assert isinstance(opt_s.checker, ShardedChecker)
        res_s = opt_s.plan(start, goal)
        assert res_s.certified

        # The sharded constraint evaluation computes the same residual
        # blocks as the single-device path up to compilation differences
        # (XLA fuses the per-shard vmap differently from the full-batch
        # vmap, so values agree to f32 roundoff, not bit-exactly — unlike
        # the collision kernel, whose sharded twin IS bit-exact).
        opt_1 = SQPOptimizer(robot, obstacle, cfg,
                             grid=opt_s.grid)
        q = jnp.asarray(res_s.trajectory)
        g_s, J_s, tot_s = opt_s._constraint_blocks(q)
        g_1, J_1, tot_1 = opt_1._constraint_blocks(q)
        np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_1),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(J_s), np.asarray(J_1),
                                   rtol=2e-4, atol=1e-5)
        assert abs(tot_s - tot_1) < 1e-4 * max(1.0, abs(tot_1))


def test_unwrap_path_matches_shortest_arc():
    # A path crossing the +/-pi seam: linear interpolation of the raw
    # waypoints takes the LONG way (what densify would check), while the
    # planner validated the short way. unwrap_path makes them identical.
    from robocheck.planner.prm import _interpolate, unwrap_path
    from robocheck.planner.trajopt import densify

    path = np.zeros((3, 6), np.float32)
    path[0, 3] = 3.1
    path[1, 3] = -3.1  # shortest arc: +0.18, linear: -6.2
    path[2, 3] = -2.9
    un = unwrap_path(path)
    # Continuous angles, same rotations at the waypoints (mod 2pi).
    d = np.diff(un[:, 3])
    assert np.abs(d).max() < np.pi
    np.testing.assert_allclose(np.sin(un[:, 3]), np.sin(path[:, 3]),
                               atol=1e-6)
    np.testing.assert_allclose(np.cos(un[:, 3]), np.cos(path[:, 3]),
                               atol=1e-6)
    # densify (linear) of the unwrapped path stays on the short arc: its
    # midpoint sits near pi, not near 0 (where the linear path through the
    # RAW waypoints would go).
    dense, _ = densify(un[:2], step=0.01, rot_scale=1.0)
    mid = dense[len(dense) // 2, 3]
    assert abs(abs(mid) - np.pi) < 0.2

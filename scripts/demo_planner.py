#!/usr/bin/env python3
"""Planner demo: PRM + trajectory optimization on a wall scene, and batch
validation of the alpha-puzzle query configurations.

    python scripts/demo_planner.py            # synthetic wall scene
    python scripts/demo_planner.py --alpha    # alpha-puzzle query endpoints
"""
import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def wall_demo(ccd: bool = False) -> int:
    from robocheck.models.shapes import box, icosphere
    from robocheck.planner import PRMConfig, TrajOptConfig, plan_and_smooth

    robot = icosphere(1, radius=0.3, name="robot")
    obstacle = box(extent=(0.5, 3.0, 3.0), name="wall")
    start = np.array([-3, 0, 0, 0, 0, 0], np.float32)
    goal = np.array([3, 0, 0, 0, 0, 0], np.float32)

    t0 = time.perf_counter()
    res = plan_and_smooth(
        robot, obstacle, start, goal,
        prm_config=PRMConfig(num_samples=512, k_neighbors=10,
                             edge_resolution=8),
        opt_config=TrajOptConfig(num_waypoints=24, iters_per_round=150,
                                 max_rounds=4, margin=0.25,
                                 swept_certify=ccd),
    )
    dt = time.perf_counter() - t0
    if res is None:
        print("no path found")
        return 1
    print(f"planned in {dt:.2f}s: certified={res.certified}, "
          f"rounds={res.rounds}, cost={res.final_cost:.2f}")
    if ccd and res.swept is not None:
        sw = res.swept
        print(f"continuous certificate: certified={sw.certified} "
              f"(min clearance {sw.min_clearance:.3f} vs method floor "
              f"{sw.method_floor:.3f}, {sw.num_steps} steps, "
              f"{sw.num_checks} exact checks)")
    np.set_printoptions(precision=2, suppress=True)
    print("trajectory (x, y, z):")
    print(res.trajectory[:, :3])
    if ccd:
        return 0 if (res.certified and res.swept is not None
                     and res.swept.certified) else 1
    return 0 if res.certified else 1


def alpha_demo(plan: bool = False,
               samples: int = 4096, rrt: bool = False,
               ccd: bool = False, smooth: bool = False) -> int:
    from robocheck.io import assets
    from robocheck.io.obj import load_obj
    from robocheck.io.parasol import read_query
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.planner.trajopt import densify

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
    print(f"alpha query: start={query[0]}, goal={query[1]}")

    checker = MegaKernelChecker(robot, obstacle)
    valid, _ = checker.check_valid(query)
    print(f"start valid: {bool(valid[0])}, goal valid: {bool(valid[1])}")

    # Validate the straight-line sweep between the endpoints (the famous
    # narrow passage makes this infeasible — expect collisions).
    dense, _ = densify(query, step=2.0)
    dvalid, _ = checker.check_valid(dense)
    print(f"straight-line sweep: {int(dvalid.sum())}/{len(dvalid)} "
          f"samples collision-free")
    if ccd:
        # Continuous-certification feasibility report for the alpha query:
        # the certifier's method floor (covering radius + grid error)
        # against the scale of the puzzle. The famous narrow passage has
        # clearance well below any affordable floor — this REPORTS that
        # measured gap honestly instead of letting a discrete densify
        # masquerade as a certificate (see README's alpha section).
        from robocheck.planner.ccd import SweptCertifier

        for refine, res_ in ((1, 128), (2, 192)):
            cert = SweptCertifier(robot, obstacle, resolution=res_,
                                  refine=refine)
            print(f"  certifier floor (refine={refine}, grid={res_}^3): "
                  f"r_cov={cert.r_cov:.2f} + e_g={cert.e_g:.2f} = "
                  f"{cert.floor():.2f} config units "
                  f"(robot min extent {float((robot.aabb[3:] - robot.aabb[:3]).min()):.1f})")
    if rrt:
        # Bidirectional batched RRT-Connect with Gaussian boundary
        # sampling — the sampling family built for narrow passages, every
        # extension validated in large batches on the device.
        import time as _time

        from robocheck.planner.rrt import RRTConfig, RRTConnectPlanner

        ext0 = float((robot.aabb[3:] - robot.aabb[:3]).min())
        planner = RRTConnectPlanner(
            robot, obstacle,
            RRTConfig(max_iters=samples // 256 or 1, batch=256,
                      step=0.35 * ext0, edge_resolution=48,
                      surface_bias=0.6),
            checker=checker,
        )
        t0 = _time.perf_counter()
        res = planner.plan(query[0], query[1])
        dt = _time.perf_counter() - t0
        print(f"RRT-Connect: {res.num_nodes} nodes / {res.iters} batched "
              f"iters, {res.num_confs_checked:,} checks in {dt:.1f}s "
              f"({res.num_confs_checked / dt:,.0f} checks/s)")
        if res.path is None:
            print("no connection; trees did not meet (the alpha passage "
                  "needs a coordinated rotate-while-translate)")
            return 1
        print(f"RRT path with {len(res.path)} waypoints")
        ext = float((robot.aabb[3:] - robot.aabb[:3]).min())
        for frac in (0.5, 0.1):
            dense, _ = densify(res.path, step=frac * ext)
            dv = checker.check_valid_resolved(dense)
            print(f"  densified at {frac:.1f}x robot extent "
                  f"({len(dense)} samples): {int(dv.sum())}/{len(dv)} "
                  f"collision-free"
                  + ("" if dv.all() else " -> NOT certified (tunneling)"))
            if not dv.all():
                return 1
        print("RRT path certified at 0.1x robot extent (discrete)")
        ccd_ok = True
        if ccd:
            # Continuous certification, multi-resolution exact mode: cheap
            # surface-sampling levels certify everything their covering
            # radius allows; only the razor segments escalate to refine-7
            # (16.5M-triangle) sampling. Produces the
            # alpha certificate (scripts/certify_alpha.py).
            from robocheck.planner.ccd import certify_multires

            print("continuous certification (multi-resolution exact)...")
            t0 = _time.perf_counter()
            sw = certify_multires(robot, obstacle, res.path, checker,
                                  levels=((2, 8), (4, 10), (6, 12),
                                          (7, 14)), verbose=True)
            print(f"continuous certificate: certified={sw.certified}, "
                  f"collision={sw.collision}, min conservative clearance "
                  f"{sw.min_clearance:.3f}, floor {sw.method_floor:.3f}, "
                  f"{sw.num_checks} exact checks, "
                  f"{_time.perf_counter() - t0:.0f}s")
            ccd_ok = sw.certified and not sw.collision
        if smooth:
            # Planner-in-the-loop on the real workload: SQP smooths the
            # certified RRT path under the SDF proxy; the exact checker
            # re-certifies at the same fine step (guarantees from the
            # checker, never the proxy).
            from robocheck.planner import SQPConfig, SQPOptimizer
            from robocheck.planner.trajopt import resample

            t0 = _time.perf_counter()
            opt = SQPOptimizer(
                robot, obstacle,
                SQPConfig(num_waypoints=48, max_outer=12,
                          max_penalty_rounds=3, grid_resolution=96,
                          margin=1.0, certify_step=0.1 * ext),
                checker=checker,
            )
            init = resample(res.path, 48, opt.cfg.rot_scale)
            sres = opt.plan(query[0], query[1], init=init)
            dt = _time.perf_counter() - t0
            print(f"SQP smoothing: certified={sres.certified} after "
                  f"{sres.outer_iters} outer iterations in {dt:.1f}s "
                  f"(merit {sres.merit:.1f})")
            if not sres.certified:
                print("  -> keeping the certified RRT path: the SDF "
                      "proxy's grid cells (~0.5 config units at 96^3) "
                      "cannot represent the ~0.3-unit passage clearance, "
                      "so gradient smoothing pushes out of the passage — "
                      "guarantees stay with the exact checker.")
        return 0 if ccd_ok else 1
    if not plan:
        return 0

    # Attempt the real puzzle: batch PRM over SE(3) samples, SQP smoothing
    # if a path is found. The alpha 1.0 puzzle's narrow passage needs a
    # coordinated rotate-while-translate; uniform PRM at this sample count
    # is expected to get close but not through — the point is to measure
    # and report how far the batched planner gets.
    import time as _time

    from robocheck.planner import PRMConfig, PRMPlanner

    prm = PRMPlanner(robot, obstacle,
                     PRMConfig(num_samples=samples, k_neighbors=12,
                               edge_resolution=32),
                     checker=checker)
    t0 = _time.perf_counter()
    res = prm.plan(query[0], query[1])
    dt = _time.perf_counter() - t0
    print(f"PRM: {res.num_vertices} valid vertices, "
          f"{res.num_edges_checked} edges, "
          f"{res.num_confs_checked} collision checks in {dt:.1f}s "
          f"({res.num_confs_checked / dt:,.0f} checks/s)")
    if res.path is None:
        print(f"no path at {samples} samples; start component reaches "
              f"within {res.closest_to_goal:.2f} (weighted metric) of the "
              f"goal — the narrow passage needs rarer samples "
              f"(try --samples {4 * samples})")
        return 1
    print(f"PRM path with {len(res.path)} waypoints")
    # Certify the raw PRM path at a much finer discretization than the
    # PRM's edge resolution: a "path" that only exists at coarse sampling
    # is a tunneling artifact, and the exact checker is cheap enough to say
    # so directly.
    ext = float((robot.aabb[3:] - robot.aabb[:3]).min())
    prm_certified = True
    for frac in (0.5, 0.1):
        dense, _ = densify(res.path, step=frac * ext)
        dv, _ = checker.check_valid(dense)
        print(f"  PRM path densified at {frac:.1f}x robot extent "
              f"({len(dense)} samples): "
              f"{int(dv.sum())}/{len(dv)} collision-free"
              + ("" if dv.all() else " -> NOT certified (tunneling)"))
        if not dv.all():
            prm_certified = False
            break
    print("smoothing with SQP...")
    from robocheck.planner import SQPConfig, SQPOptimizer
    from robocheck.planner.trajopt import resample

    opt = SQPOptimizer(robot, obstacle,
                       SQPConfig(num_waypoints=max(32, len(res.path)),
                                 max_outer=20),
                       checker=checker)
    init = resample(res.path, opt.cfg.num_waypoints, opt.cfg.rot_scale)
    sres = opt.plan(query[0], query[1], init=init)
    print(f"SQP: certified={sres.certified} after {sres.outer_iters} "
          f"outer iterations, merit={sres.merit:.3f}")
    if prm_certified and not sres.certified:
        print("  -> keeping the certified PRM path (the SDF proxy cannot "
              "represent the sub-grid-cell passage clearance; guarantees "
              "stay with the exact checker)")
    return 0 if (sres.certified or prm_certified) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha", action="store_true")
    ap.add_argument("--rrt", action="store_true",
                    help="alpha: batched RRT-Connect instead of PRM")
    ap.add_argument("--plan", action="store_true",
                    help="with --alpha: attempt the puzzle with PRM + SQP")
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--ccd", action="store_true",
                    help="continuous (swept-volume) certification report")
    ap.add_argument("--smooth", action="store_true",
                    help="with --alpha --rrt: SQP-smooth + re-certify")
    args = ap.parse_args()
    from robocheck.runtime.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.alpha:
        return alpha_demo(plan=args.plan, samples=args.samples,
                          rrt=args.rrt, ccd=args.ccd, smooth=args.smooth)
    return wall_demo(ccd=args.ccd)


if __name__ == "__main__":
    raise SystemExit(main())

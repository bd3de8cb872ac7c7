#!/usr/bin/env python3
"""Reproduce the alpha-1.0 continuous certificates.

Certifies the stored RRT-Connect path (`data/alpha_certified_path.npy`,
produced by `demo_planner.py --alpha --rrt`) with the multi-resolution
exact certifier, then (--smooth) re-runs SQP margin smoothing and
certifies the smoothed path. The clearance backend is selectable:

  --backend device  device clearance engine (default; `planner/clearance.py`)
  --backend native  host BVH (`rc_point_mesh_dist`), kept as the
                    independent cross-check

Writes a JSON record (default chiprun_out/alpha_ccd.json) with wall times
per leg and backend, and the device it ran on.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="device",
                    choices=("device", "native"))
    ap.add_argument("--smooth", action="store_true",
                    help="also SQP-smooth and certify the smoothed path")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                   "alpha_ccd.json"))
    ap.add_argument("--raw-levels", default="2:8,4:10,6:12,7:14")
    ap.add_argument("--smooth-levels", default="2:8,4:10,6:12")
    args = ap.parse_args()

    import jax

    from robocheck.runtime.cache import enable_compilation_cache

    enable_compilation_cache()

    from robocheck.io import assets
    from robocheck.io.obj import load_obj
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.planner.ccd import certify_multires

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    path = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "alpha_certified_path.npy"))
    checker = MegaKernelChecker(robot, obstacle)
    # Warm-up: the first dispatch compiles; keep that out of the first
    # certification level's wall time (visible as device_warmup_s).
    t0 = time.perf_counter()
    checker.check_valid_resolved(path[:2])
    warmup_s = round(time.perf_counter() - t0, 1)
    print(f"device warm-up (first dispatch + compile): {warmup_s}s",
          flush=True)

    def levels(spec):
        return tuple(tuple(int(x) for x in part.split(":"))
                     for part in spec.split(","))

    def leg(p, lv):
        t0 = time.perf_counter()
        res = certify_multires(robot, obstacle, p, checker, levels=lv,
                               verbose=True, backend=args.backend)
        wall = time.perf_counter() - t0
        rec = {
            "certified": bool(res.certified),
            "collision": bool(res.collision),
            "num_checks": int(res.num_checks),
            "min_clearance": float(res.min_clearance),
            "min_seen_clearance": float(res.min_seen_clearance),
            "method_floor": float(res.method_floor),
            "uncertified_steps": int(res.uncertified_steps),
            "wall_s": round(wall, 1),
            "backend": args.backend,
        }
        print(json.dumps(rec), flush=True)
        return rec

    out = {
        "description": (
            "Continuous (swept-volume) certificates for the alpha-1.0 query "
            "path, produced by planner/ccd.certify_multires with exact "
            "surface distances ('device' = device clearance engine "
            "planner/clearance.py; 'native' = host BVH rc_point_mesh_dist). "
            "min_clearance = the proof's worst certifying margin (min over "
            "proven steps, each at the level that proved it, of the "
            "certifying endpoint's conservative surface clearance); "
            "min_seen_clearance = worst conservative clearance sampled at "
            "the finest level run (the measured-gap diagnostic). Reproduce: "
            "scripts/certify_alpha.py [--backend native] [--smooth]."),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "device_warmup_s": warmup_s,
    }
    print(f"raw path ({len(path)} waypoints), backend={args.backend}",
          flush=True)
    out["raw_rrt_path"] = leg(path, levels(args.raw_levels))

    if args.smooth:
        from robocheck.io.parasol import read_query
        from robocheck.planner import SQPConfig, SQPOptimizer
        from robocheck.planner.trajopt import resample

        query = read_query(assets.find_asset("models/alpha1.0/alpha.query"))
        ext = float(np.linalg.norm(robot.aabb[3:] - robot.aabb[:3]))
        t0 = time.perf_counter()
        opt = SQPOptimizer(
            robot, obstacle,
            SQPConfig(num_waypoints=48, max_outer=12, max_penalty_rounds=3,
                      grid_resolution=96, margin=1.0,
                      certify_step=0.1 * ext),
            checker=checker,
        )
        init = resample(path, 48, opt.cfg.rot_scale)
        sres = opt.plan(query[0], query[1], init=init)
        out["sqp_smooth_wall_s"] = round(time.perf_counter() - t0, 1)
        out["sqp_smooth_certified"] = bool(sres.certified)
        print(f"SQP smoothing: certified={sres.certified} in "
              f"{out['sqp_smooth_wall_s']}s", flush=True)
        if sres.certified:
            out["sqp_smoothed_path"] = leg(
                np.asarray(sres.trajectory, np.float32),
                levels(args.smooth_levels))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()

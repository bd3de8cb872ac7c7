#!/usr/bin/env python3
"""Scaling-efficiency benchmark: checks/s at 1, 2, 4, ... devices.

On several GPUs this measures batch-sharded throughput directly; on a
single-card or CPU-only machine, pass --cpu-mesh to run the identical
SPMD program over virtual CPU devices (validates the sharding path and
reports relative scaling of the program structure, not absolute speed).

    python scripts/bench_scaling.py                  # real devices
    python scripts/bench_scaling.py --cpu-mesh 8     # 8 virtual CPU devices
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="force N virtual CPU devices (0 = real devices)")
    ap.add_argument("--dataset", default="hard10k")
    ap.add_argument("--confs-per-device", type=int, default=4096)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--clearance", action="store_true",
                    help="also scale the clearance engine's exact pair "
                         "batches (the continuous certifier's hot phase)")
    ap.add_argument("--clearance-only", action="store_true",
                    help="skip the checker legs (CPU-mesh compiles of the "
                         "streamed path dominate otherwise)")
    args = ap.parse_args()

    if args.cpu_mesh:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_mesh}"
        ).strip()

    import jax

    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.io.obj import load_obj
    from robocheck.parallel.sharding import ShardedChecker, make_mesh

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    ds = read_conf_file(assets.dataset_path(args.dataset))

    n_dev_total = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev_total]
    results = {}
    base = None
    for n in ([] if args.clearance_only else sizes):
        checker = ShardedChecker(robot, obstacle, mesh=make_mesh(n))
        want = n * args.confs_per_device
        confs = np.resize(ds.confs, (want, 6)).astype(np.float32)
        checker.check_valid(confs)  # compile + warm
        best = min(
            _timed(checker, confs) for _ in range(args.runs)
        )
        cps = want / best
        eff = None
        if base is None:
            base = cps
        else:
            eff = cps / (base * n)
        results[n] = {"checks_per_s": round(cps, 1),
                      "scaling_efficiency": round(eff, 3) if eff else 1.0}
        print(f"{n} device(s): {cps:,.0f} checks/s"
              + (f", efficiency {eff:.1%}" if eff else ""))

    clear_results = {}
    if args.clearance or args.clearance_only:
        # Clearance-engine scaling: the exact (config, block) pair batches
        # are the certificate's dominant device phase; shard_map splits
        # them over the mesh's batch axis (planner/clearance.py).
        from robocheck.planner.ccd import subdivide_mesh
        from robocheck.planner.clearance import ClearanceEngine

        # Workload sized for the virtual-CPU tier too: refine-2 keeps a
        # per-device pair chunk meaningful without hours of CPU emulation
        # (the absolute numbers here only support the RELATIVE scaling
        # claim).
        rob2 = subdivide_mesh(robot, 2)
        rng = np.random.default_rng(5)
        cl = rng.uniform(-np.pi, np.pi, (64, 6)).astype(np.float32)
        center = 0.5 * (obstacle.aabb[:3] + obstacle.aabb[3:])
        ext = obstacle.aabb[3:] - obstacle.aabb[:3]
        cl[:, 0:3] = center + rng.uniform(-0.5, 0.5, (64, 3)) * ext
        cbase = None
        for n in sorted({1, n_dev_total}):
            eng = ClearanceEngine(rob2.vertices, obstacle,
                                  mesh=make_mesh(n) if n > 1 else None)
            eng.min_distances(cl)  # compile + warm
            best = float("inf")
            for _ in range(args.runs):
                t0 = time.perf_counter()
                eng.min_distances(cl)
                best = min(best, time.perf_counter() - t0)
            cps = len(cl) / best
            ceff = None if cbase is None else cps / (cbase * n)
            if cbase is None:
                cbase = cps
            clear_results[n] = {
                "clearance_configs_per_s": round(cps, 1),
                "scaling_efficiency": round(ceff, 3) if ceff else 1.0}
            print(f"clearance {n} device(s): {cps:,.1f} configs/s"
                  + (f", efficiency {ceff:.1%}" if ceff else ""))

    print(json.dumps({"devices": results,
                      "clearance_devices": clear_results or None,
                      "device": {"platform": jax.devices()[0].platform,
                                 "kind": jax.devices()[0].device_kind,
                                 "count": len(jax.devices())},
                      "dataset": args.dataset}))
    return 0


def _timed(checker, confs) -> float:
    # Times the first-class streamed path (packed verdicts, chunked H2D).
    t0 = time.perf_counter()
    checker.check_valid(confs)
    return time.perf_counter() - t0


if __name__ == "__main__":
    raise SystemExit(main())

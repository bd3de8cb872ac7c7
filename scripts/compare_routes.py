#!/usr/bin/env python3
"""Time the fused kernel against the plain-XLA route, end to end, on the GPU.

Both routes go host numpy in -> resolved verdicts out on the alpha-1.0 pair:
the kernel through `MegaKernelChecker.check_valid_resolved`, the XLA route
through `ops.pipeline.CollisionWorld.check` (fixed-size pair compaction;
coplanar and overflowed poses resolved by the f64 oracle). Each is warmed,
then timed as the minimum of ``--runs`` runs, and its verdicts are checked
against the tags. The XLA route runs the 10k sets only: it is thousands
of times slower than the kernel (PERF.md), too slow for 100k runs.

    python scripts/compare_routes.py [--runs 3]

Prints one JSON line per (route, dataset) and the card's name and power
limit first.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def best_of(fn, confs, runs):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(confs)
        times.append(time.perf_counter() - t0)
    return min(times), times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    from robocheck.runtime.device import require_gpu

    dev = require_gpu()
    from robocheck.runtime.cache import enable_compilation_cache

    enable_compilation_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), dev.device_kind,
          flush=True)

    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.io.datagen import tagged_alpha_dataset
    from robocheck.io.obj import load_obj
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.ops.pipeline import CollisionWorld

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    sets = {}
    for name in ("hard10k", "easy10k"):
        ds = read_conf_file(assets.dataset_path(name))
        sets[name] = (ds.confs, ds.valid)
    for kind in ("hard", "easy"):
        sets[f"{kind}100k"] = tagged_alpha_dataset(robot, obstacle, kind,
                                                   100_000)

    routes = {
        "kernel": MegaKernelChecker(robot, obstacle).check_valid_resolved,
        "xla": CollisionWorld(robot, obstacle).check,
    }
    for route, fn in routes.items():
        for name, (confs, golden) in sets.items():
            if route == "xla" and name.endswith("100k"):
                continue
            valid = fn(confs)  # compile + warm
            best, times = best_of(fn, confs, args.runs)
            print(json.dumps({
                "route": route, "dataset": name, "n": len(confs),
                "best_s": round(best, 6),
                "times_s": [round(t, 6) for t in times],
                "checks_per_s": round(len(confs) / best, 1),
                "mismatches": int((valid != golden).sum()),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

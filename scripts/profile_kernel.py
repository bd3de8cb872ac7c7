#!/usr/bin/env python3
"""Capture a jax.profiler (Perfetto) trace of the fused kernel on a dataset
on the GPU (replaces the reference's checked-in Nsight Compute recipe,
`rai_build.yml:43`).

    python scripts/profile_kernel.py [--dataset hard10k] [--out DIR]

Inspect with XProf/TensorBoard or Perfetto (trace.json.gz inside the
plugins/profile directory).
"""
import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="hard10k")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "trace"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.io.obj import load_obj
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.profiling.timers import trace
    from robocheck.runtime.device import require_gpu

    require_gpu()

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    ds = read_conf_file(assets.dataset_path(args.dataset))
    checker = MegaKernelChecker(robot, obstacle)
    checker.check_valid(ds.confs)  # compile + warm (fixed-chunk shape)

    with trace(args.out):
        for _ in range(args.runs):
            t0 = time.perf_counter()
            checker.check_valid(ds.confs)
            print(f"run: {time.perf_counter() - t0:.3f}s")
    print(f"trace written to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Full-integration driver: check a configuration file end-to-end and diff
against its tags (the reference's `Full-Integration-Test` binary,
`test/full-integration-test.cu:652-732`, including the FP/FN triage and the
red KERNEL BROKEN banner).

    python scripts/run_integration.py data/hard_confs10,000.conf
    python scripts/run_integration.py --oracle ...   # re-tag with CPU oracle
"""
import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("conf_file")
    ap.add_argument("--oracle", action="store_true",
                    help="recompute ground truth with the CPU oracle instead "
                         "of trusting the file's tags")
    ap.add_argument("--xla", action="store_true",
                    help="use the pure-XLA pipeline instead of the Pallas "
                         "mega-kernel")
    args = ap.parse_args()

    import jax
    import numpy as np

    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.io.obj import load_obj
    from robocheck.profiling.counters import CheckStats, verdict_diff

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    ds = read_conf_file(args.conf_file)
    print(f"read {len(ds.confs)} configurations from {args.conf_file}")

    golden = ds.valid
    if golden is not None and ds.tags_match_header is False:
        # Stale tags (e.g. the reference's 10,000samples.conf: header counts
        # from an FCL run that was never written back to the rows). Diffing
        # against them would be all noise; fall back to the oracle.
        print(
            f"warning: row tags disagree with the header "
            f"({ds.num_valid} tagged valid vs header {ds.header_valid}); "
            "treating the file as untagged and re-tagging with the oracle"
        )
        golden = None
    if args.oracle or golden is None:
        from robocheck.oracle import check_configs

        t0 = time.perf_counter()
        golden = check_configs(robot, obstacle, ds.confs)
        print(f"CPU oracle: {time.perf_counter() - t0:.2f}s")

    if args.xla:
        from robocheck.ops.pipeline import CollisionWorld

        world = CollisionWorld(robot, obstacle)
        t0 = time.perf_counter()
        valid = world.check(ds.confs)
        elapsed = time.perf_counter() - t0
        coplanar = np.zeros_like(valid)
        num_pairs = np.zeros(len(valid), np.int32)
        broad_hit = np.ones_like(valid)
    else:
        from robocheck.kernels.megakernel import MegaKernelChecker

        checker = MegaKernelChecker(robot, obstacle)
        checker.check(ds.confs[: min(64, len(ds.confs))])  # compile
        t0 = time.perf_counter()
        valid, coplanar, num_pairs, broad_hit = checker.check(ds.confs)
        elapsed = time.perf_counter() - t0

    stats = CheckStats.from_check(valid, coplanar, num_pairs, broad_hit,
                                  elapsed)
    print(stats.report())

    diff = verdict_diff(valid, golden)
    print(
        f"verdict diff: {diff['mismatches']} mismatches "
        f"({diff['false_positives']} FP / {diff['false_negatives']} FN)"
    )
    if diff["mismatches"]:
        print(f"  FP indices: {diff['fp_indices']}")
        print(f"  FN indices: {diff['fn_indices']}")
        print("\033[31mKERNEL BROKEN\033[0m")
        return 1
    print("all verdicts match")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

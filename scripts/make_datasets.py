#!/usr/bin/env python3
"""Regenerate the benchmark datasets, including the 100k files that are
git-LFS-missing in the reference checkout (`.MISSING_LARGE_BLOBS`).

Generator semantics mirror `Utils_rai.cu:111-136` (easy = translations in
±10x the robot extent, hard = ±extent/200, all angles uniform in [-pi,pi]);
ground-truth tagging uses the double-precision oracle (native C++ when built)
in place of the reference's FCL pass (`generate-tests.cu:4-46`).

    python scripts/make_datasets.py [--sizes 100000] [--kinds easy hard]
"""
import argparse
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[100_000])
    ap.add_argument("--kinds", nargs="+", default=["easy", "hard"],
                    choices=["easy", "hard"])
    ap.add_argument("--seed", type=int, default=508)
    ap.add_argument("--out", default=str(REPO / "data"))
    args = ap.parse_args()

    from robocheck.io import assets
    from robocheck.io.conf import write_conf_file
    from robocheck.io.datagen import alpha_bot_configurations, dataset_seed
    from robocheck.io.obj import load_obj
    from robocheck.oracle import check_configs

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    os.makedirs(args.out, exist_ok=True)

    for size in args.sizes:
        for kind in args.kinds:
            name = f"{kind}_confs{size:,}.conf"
            out = Path(args.out) / name
            if out.exists():
                print(f"{out} exists, skipping")
                continue
            t0 = time.time()
            confs = alpha_bot_configurations(
                robot, size, hard=(kind == "hard"),
                seed=dataset_seed(kind, size, args.seed),
            )
            # Chunked + checkpointed tagging: an interrupted oracle sweep
            # resumes where it left off (runtime/checkpoint.py; the durable
            # analog of the reference persisting FCL verdicts in the files
            # themselves, generate-tests.cu:33-38).
            from robocheck.runtime import checkpoint

            ckpt = out.with_suffix(".tagging.ckpt.npz")
            valid = np.zeros((size,), dtype=bool)
            done = 0
            if ckpt.exists():
                arrays, meta = checkpoint.load(ckpt)
                if meta and meta.get("size") == size:
                    valid = arrays["valid"].astype(bool)
                    done = int(meta["done"])
                    print(f"resuming {name} tagging at {done}/{size}")
            chunk = 8192
            for lo in range(done, size, chunk):
                hi = min(lo + chunk, size)
                valid[lo:hi] = check_configs(robot, obstacle, confs[lo:hi])
                checkpoint.save(ckpt, {"valid": valid},
                                meta={"done": hi, "size": size})
            write_conf_file(out, confs, valid)
            ckpt.unlink(missing_ok=True)
            meta_side = ckpt.with_suffix(".meta.json")
            if meta_side.exists():
                meta_side.unlink()
            dt = time.time() - t0
            print(
                f"wrote {out}: {size} confs, {int(valid.sum())} valid / "
                f"{int((~valid).sum())} invalid in {dt:.1f}s"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""One process of a multi-host (multi-process SPMD) collision-check job.

The real multi-host entry: `jax.distributed.initialize` via
`runtime.distributed.initialize_from_env`, per-host contiguous dataset rows
via `shard_bounds`, the sharded streamed kernel via
`ShardedChecker.check_valid_distributed`. Launch one copy per host with
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID set (any scheduler works —
tests/test_distributed.py spawns two local processes with 4 virtual CPU
devices each).

    python scripts/multihost_worker.py --dataset hard10k --n 256 --out v.npy

Writes this process's verdict shard to --out (np.save bool array) and prints
one JSON status line.
"""
import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="hard10k")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    # Force the virtual-CPU platform before any backend initialization.
    if "xla_force_host_platform_device_count" in os.environ.get(
        "XLA_FLAGS", ""
    ):
        import jax

        jax.config.update("jax_platforms", "cpu")

    from robocheck.runtime.distributed import (
        initialize_from_env,
        shard_bounds,
    )

    initialize_from_env()

    import jax
    import numpy as np

    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.io.obj import load_obj
    from robocheck.parallel.sharding import ShardedChecker, make_mesh

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())

    # Per-host data loading: read only this host's contiguous row shard.
    lo, hi = shard_bounds(args.n)
    ds = read_conf_file(assets.dataset_path(args.dataset))
    local_confs = ds.confs[lo:hi]

    mesh = make_mesh()  # all devices, every process
    checker = ShardedChecker(robot, obstacle, mesh=mesh)
    valid, cop = checker.check_valid_distributed(local_confs, args.n)
    np.save(args.out, valid)
    print(json.dumps({
        "process": jax.process_index(),
        "process_count": jax.process_count(),
        "devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "rows": [int(lo), int(hi)],
        "valid": int(valid.sum()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

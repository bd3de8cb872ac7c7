#!/usr/bin/env python3
"""Oversized-mesh chunked-checker benchmark: compaction on vs off.

An 81,920-triangle icosphere obstacle (Morton chunks, far past the fused
kernel's gate width) against the 80-triangle icosphere robot, comparing the
host-compacted driver (per-chunk XLA broad phase before dispatch) against
plain per-pair dispatch whose culling happens at the kernel's own in-kernel
broad phase. Not yet measured on the GPU; the two paths must give the same
verdicts.

    python scripts/bench_chunked.py [--n 8192]
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--big", action="store_true",
                    help="both-sides-chunked pair: 20,480-tri robot x "
                         "20,480-tri obstacle (30 chunk pairs, 419M "
                         "tri pairs per configuration)")
    args = ap.parse_args()

    from robocheck.runtime.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import numpy as np

    from robocheck.kernels.chunked import (
        ChunkedMegaKernelChecker,
        make_checker,
    )
    from robocheck.models.shapes import icosphere

    if args.big:
        robot = icosphere(5, radius=0.3, name="robot-20k")  # 20,480 tris
        obstacle = icosphere(5, radius=1.5, name="obstacle-20k")  # 20,480
    else:
        robot = icosphere(1, radius=0.3, name="robot")
        obstacle = icosphere(6, radius=1.5, name="big-obstacle")  # 81,920 tris
    rng = np.random.default_rng(7)
    # Mix: far misses, near-surface, deep hits.
    confs = np.zeros((args.n, 6), np.float32)
    confs[:, 0:3] = rng.uniform(-4, 4, (args.n, 3))
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (args.n, 3))

    checker = make_checker(robot, obstacle)
    assert isinstance(checker, ChunkedMegaKernelChecker), type(checker)
    print(json.dumps({"chunk_pairs": checker.num_chunk_pairs,
                      "obs_tris": obstacle.num_triangles,
                      "device": {"platform": jax.devices()[0].platform,
                                 "kind": jax.devices()[0].device_kind,
                                 "count": len(jax.devices())}}), flush=True)

    results = {}
    for compact in (True, False):
        v, c = checker.check_valid(confs, chunk=4096, compact=compact)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            checker.check_valid(confs, chunk=4096, compact=compact)
            times.append(time.perf_counter() - t0)
        results[compact] = v
        print(json.dumps({
            "compact": compact,
            "checks_per_s": round(args.n / min(times), 0),
            "best_s": round(min(times), 3),
            "valid": int(v.sum()),
        }), flush=True)
    assert (results[True] == results[False]).all(), "verdict divergence"
    print(json.dumps({"verdicts_equal": True}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

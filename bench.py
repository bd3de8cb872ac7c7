#!/usr/bin/env python3
"""Headline benchmark: collision checks/second through the fused kernel on
the GPU, on the reference's hard dataset, with verdict correctness gated
against the oracle-tagged goldens.

Protocol mirrors the reference report (§4.2): minimum over 5 timed runs,
device transfers included, file reads excluded. Baseline = the optimized CPU
oracle (the reference's conclusion was that its GPU never beat the CPU FCL
baseline; beating the CPU here is the bar that matters), measured on this
machine and extrapolated from a subsample.

Runs on an NVIDIA GPU only, in one process. The 100k datasets are read from
``data/`` when present and otherwise made in this process with the generator
and seed of `scripts/make_datasets.py`, tagged by the native float64 oracle.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


# Stated real-time budget for one planner-step-shaped batch (2048 configs
# through check_valid_resolved, host numpy in -> verdicts out). 50 ms = a
# 20 Hz replanning loop, the usual bar for online manipulator planning
# (BASELINE.json's metric is "p50 batch latency vs real-time budget").
LATENCY_BUDGET_MS = 50.0


def load_or_make(name, robot, obstacle):
    """(confs, valid, source) of ``hard100k``/``easy100k``: the file when it
    exists, else generated and oracle-tagged in memory."""
    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.io.datagen import tagged_alpha_dataset

    try:
        ds = read_conf_file(assets.dataset_path(name))
        return ds.confs, ds.valid, "file"
    except FileNotFoundError:
        confs, valid = tagged_alpha_dataset(robot, obstacle, name[:4],
                                            100_000)
        return confs, valid, "generated"


def timed_runs(checker, confs, runs=5):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        checker.check_valid_resolved(confs)
        times.append(time.perf_counter() - t0)
    return times


def main():
    import jax

    from robocheck.runtime.device import require_gpu

    dev = require_gpu()

    from robocheck.runtime.cache import enable_compilation_cache

    enable_compilation_cache()

    from robocheck.io import assets
    from robocheck.io.obj import load_obj
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.oracle import check_configs
    from robocheck.runtime import native as native_mod

    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    native_mod.ensure_built()

    confs, golden, source = load_or_make("hard100k", robot, obstacle)
    n = confs.shape[0]
    checker = MegaKernelChecker(robot, obstacle)

    # Warm-up / compile (the throughput path: streamed single-phase
    # dispatch, packed 1-byte/config verdicts; coplanar flags resolved
    # exactly in float64 — free when nothing is flagged).
    valid = checker.check_valid_resolved(confs)
    # Correctness gate (the reference's KERNEL BROKEN check,
    # full-integration-test.cu:695-724).
    mismatches = int((valid != golden).sum())

    times = timed_runs(checker, confs)
    best = min(times)
    checks_per_s = n / best

    # CPU-oracle baseline on a subsample (scaled), cached across runs.
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_baseline_hard100k_native.json")
    if os.path.exists(cache):
        with open(cache) as f:
            baseline_cps = json.load(f)["cpu_oracle_checks_per_s"]
    else:
        sub = 1024
        t0 = time.perf_counter()
        check_configs(robot, obstacle, confs[:sub])
        baseline_cps = sub / (time.perf_counter() - t0)
        with open(cache, "w") as f:
            json.dump({"cpu_oracle_checks_per_s": baseline_cps}, f)

    # Latency leg: round-trip wall time of ONE planner-step-shaped batch
    # (2048 configs, host numpy in -> verdicts out, including transfers and
    # any coplanar resolution) — what an SQP/RRT iteration waits on.
    lat_n = 2048
    lat_confs = confs[:lat_n]
    checker.check_valid_resolved(lat_confs)  # warm the shape
    lats = []
    for _ in range(101):
        t0 = time.perf_counter()
        checker.check_valid_resolved(lat_confs)
        lats.append(time.perf_counter() - t0)
    lats.sort()
    p50_ms = lats[len(lats) // 2] * 1e3
    # Nearest-rank p99 over 101 sorted samples is index 99.
    p99_ms = lats[int(round(0.99 * (len(lats) - 1)))] * 1e3

    # Clearance-query leg: the device clearance engine that powers the
    # continuous certifier — exact min posed-vertex to obstacle-surface
    # distances, refine-4 alpha robot vs the 1008-triangle obstacle,
    # near-contact poses.
    from robocheck.planner.ccd import subdivide_mesh
    from robocheck.planner.clearance import ClearanceEngine

    rob4 = subdivide_mesh(robot, 4)
    eng = ClearanceEngine(rob4.vertices, obstacle)
    rng = np.random.default_rng(5)
    cl_confs = rng.uniform(-np.pi, np.pi, (256, 6)).astype(np.float32)
    center = 0.5 * (obstacle.aabb[:3] + obstacle.aabb[3:])
    ext = obstacle.aabb[3:] - obstacle.aabb[:3]
    cl_confs[:, 0:3] = center + rng.uniform(-0.6, 0.6, (256, 3)) * ext
    eng.min_distances(cl_confs)  # warm / compile
    for k in eng.stats:
        eng.stats[k] = 0 if isinstance(eng.stats[k], int) else 0.0
    t0 = time.perf_counter()
    eng.min_distances(cl_confs)
    clear_cps = round(len(cl_confs) / (time.perf_counter() - t0), 1)
    clear_pairs = int(eng.stats["pairs"])

    # The sparse dataset, same warm-up + min-of-5 protocol, same process.
    e_confs, e_golden, e_source = load_or_make("easy100k", robot, obstacle)
    ev = checker.check_valid_resolved(e_confs)
    easy_mismatches = int((ev != e_golden).sum())
    easy_times = timed_runs(checker, e_confs)
    easy_cps = round(len(e_confs) / min(easy_times), 1)

    result = {
        "metric": "collision_checks_per_s_hard100k",
        "value": round(checks_per_s, 1),
        "unit": "checks/s/device",
        "vs_baseline": round(checks_per_s / baseline_cps, 2),
        "p50_batch_latency_ms": round(p50_ms, 2),
        "latency_budget_ms": LATENCY_BUDGET_MS,
        "latency_margin_ms": round(LATENCY_BUDGET_MS - p50_ms, 2),
    }
    extra = {
        "dataset": "hard100k",
        "dataset_source": source,
        "n_confs": n,
        "times_s": [round(t, 5) for t in times],
        "golden_mismatches": mismatches,
        "latency_batch": lat_n,
        "p99_batch_latency_ms": round(p99_ms, 2),
        "easy100k_checks_per_s": easy_cps,
        "easy100k_times_s": [round(t, 5) for t in easy_times],
        "easy100k_mismatches": easy_mismatches,
        "easy100k_source": e_source,
        "clearance_configs_per_s": clear_cps,
        "clearance_pairs_run": clear_pairs,
        "cpu_oracle_baseline_checks_per_s": round(baseline_cps, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))
    print(json.dumps(extra), file=sys.stderr)
    if mismatches or easy_mismatches:
        raise SystemExit(
            f"golden mismatches: hard {mismatches}, easy {easy_mismatches}")


if __name__ == "__main__":
    main()

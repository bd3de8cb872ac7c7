#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU, at the alpha-1.0 pair's
full width (1008 robot x 1008 obstacle triangles), on the real pose sets.

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --devices 4   # four cards: the sharded phase only

Phases (one process; each failure is reported, and any failure exits 1):
  1. device line: device kind and count, and the card's name and power
     limit from nvidia-smi; every number printed later refers to it.
  2. goldens: `check_valid_resolved` on hard10k and easy10k (tracked,
     FCL-tagged): 0 mismatches.
  3. 100k: the hard100k set made in memory (the generator and seed of
     scripts/make_datasets.py, tagged by the native f64 oracle built with
     ``make -C native``): 0 mismatches, and the warm wall time.
  4. kernel vs plain reference: `check_block` columns against
     `ops.pipeline.CollisionWorld` on 4,096 hard poses, both on the card;
     a disagreement is accepted only where the kernel agrees with the f64
     oracle. Then the broad flags: the XLA broad phase that lets two-phase
     `check`, presort and chunked compaction skip poses must be set wherever
     the kernel's stage 1 hits (column 3), on the hard poses, the
     near-contact poses of phase 6, and 4,096 poses whose robot box touches
     the obstacle box face on, where rounding decides.
  5. planner step: 2,048-pose batches through `check_valid_resolved` (p50,
     p99), then `scripts/demo_planner.wall_demo(ccd=True)`, which must
     certify.
  6. clearance: `ClearanceEngine` on refine-4 alpha, 256 near-contact poses,
     against the native `rc_point_mesh_dist`: every answer brackets the
     native one within `err_bound`; prints the largest deviation in units
     of f32 eps x scale beside the 128 the bound assumes.
  7. card-only tests: ``pytest -m gpu``, in this process.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed. Without a GPU the script exits
non-zero and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def alpha():
    from robocheck.io import assets
    from robocheck.io.obj import load_obj

    return (load_obj(assets.alpha_robot_path()),
            load_obj(assets.alpha_obstacle_path()))


def near_contact_poses(obstacle, n=256, seed=5):
    """The clearance poses of bench.py's clearance leg."""
    rng = np.random.default_rng(seed)
    confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
    center = 0.5 * (obstacle.aabb[:3] + obstacle.aabb[3:])
    ext = obstacle.aabb[3:] - obstacle.aabb[:3]
    confs[:, 0:3] = center + rng.uniform(-0.6, 0.6, (n, 3)) * ext
    return confs


def phase_goldens(ctx):
    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file

    ck = ctx["checker"]
    for name in ("hard10k", "easy10k"):
        ds = read_conf_file(assets.dataset_path(name))
        valid = ck.check_valid_resolved(ds.confs)
        ctx[name] = ds
        mism = int((valid != ds.valid).sum())
        print(f"  {name}: {len(ds.confs)} verdicts, {mism} mismatches")
        assert mism == 0, f"{name}: {mism} golden mismatches"


def phase_100k(ctx):
    from robocheck.io.datagen import tagged_alpha_dataset

    robot, obstacle = ctx["meshes"]
    t0 = time.perf_counter()
    confs, golden = tagged_alpha_dataset(robot, obstacle, "hard", 100_000)
    print(f"  hard100k made and tagged by the native oracle in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    ck = ctx["checker"]
    valid = ck.check_valid_resolved(confs)  # compile + warm
    mism = int((valid != golden).sum())
    t0 = time.perf_counter()
    ck.check_valid_resolved(confs)
    warm = time.perf_counter() - t0
    print(f"  hard100k: {mism} mismatches; warm check_valid_resolved "
          f"{warm:.4f} s")
    assert mism == 0, f"hard100k: {mism} golden mismatches"


def phase_reference(ctx):
    import jax.numpy as jnp

    from robocheck.oracle import check_configs
    from robocheck.ops.pipeline import CollisionWorld, PipelineConfig

    robot, obstacle = ctx["meshes"]
    confs = ctx["hard10k"].confs[:4096]
    out = np.asarray(ctx["checker"].check_block(jnp.asarray(confs)))
    world = CollisionWorld(robot, obstacle,
                           PipelineConfig(resolve_coplanar=False))
    _, res = world.check(confs, return_result=True)
    ok = ~np.asarray(res.overflow)
    k_valid = out[:, 0].astype(bool)
    k_cop = out[:, 1].astype(bool)
    x_valid = np.asarray(res.valid)
    x_cop = np.asarray(res.coplanar)
    both = ok & k_valid & x_valid
    pair_mism = int((out[both, 2] != np.asarray(res.num_pairs)[both]).sum())
    bad = np.nonzero(ok & ((k_valid != x_valid) | (k_cop != x_cop)))[0]
    print(f"  4096 hard poses: {int((~ok).sum())} XLA pair-buffer "
          f"overflows skipped; valid/coplanar disagreements {len(bad)}; "
          f"num_pairs mismatches {pair_mism} of {int(both.sum())}")
    unresolved = 0
    if len(bad):
        oracle = check_configs(robot, obstacle, confs[bad])
        for i, o in zip(bad, oracle):
            print(f"    pose {i}: kernel valid={k_valid[i]} cop={k_cop[i]}, "
                  f"XLA valid={x_valid[i]} cop={x_cop[i]}, f64 oracle "
                  f"valid={bool(o)}")
            if k_valid[i] != o and not k_cop[i]:
                unresolved += 1
    assert pair_mism == 0, f"num_pairs mismatches: {pair_mism}"
    assert unresolved == 0, f"{unresolved} disagreements the oracle refutes"


def broad_flags(ck, confs):
    """(kernel column 3, the widened XLA flag, the unwidened XLA flag)."""
    import jax.numpy as jnp

    from robocheck.kernels import megakernel as km

    c = jnp.asarray(confs)
    kern = np.asarray(ck.check_block(c))[:, 3].astype(bool)
    host = np.asarray(ck.broad_block(c))
    lo, hi, _ = km._posed_bounds(c, ck._corner_pts, ck._corner_mask)
    raw = np.asarray(((lo <= ck._obs_hi) & (ck._obs_lo <= hi)).all(axis=-1))
    return kern, host, raw


def face_contact_poses(ck, confs):
    """``confs`` moved so the robot's box touches the obstacle's box face on
    (the axis and side vary by row)."""
    import jax.numpy as jnp

    from robocheck.kernels import megakernel as km

    lo, hi, _ = (np.asarray(a, np.float64) for a in km._posed_bounds(
        jnp.asarray(confs), ck._corner_pts, ck._corner_mask))
    obs = ck.prep.obs_mesh_aabb[0].astype(np.float64)
    rows = np.arange(len(confs))
    axis = rows % 3
    low = (rows // 3) % 2 == 0
    shift = np.where(low, obs[3 + axis] - lo[rows, axis],
                     obs[axis] - hi[rows, axis])
    out = confs.copy()
    out[rows, axis] = (confs[rows, axis] + shift).astype(np.float32)
    return out


def phase_broad(ctx):
    ck = ctx["checker"]
    hard = ctx["hard10k"].confs
    sets = {"4096 hard": hard[:4096],
            "256 near-contact": near_contact_poses(ctx["meshes"][1]),
            "4096 face-contact": face_contact_poses(ck, hard[4096:8192])}
    missed = 0
    for name, confs in sets.items():
        kern, host, raw = broad_flags(ck, confs)
        bad = int((kern & ~host).sum())
        missed += bad
        print(f"  {name} poses: kernel broad hits {int(kern.sum())}, XLA "
              f"(widened) {int(host.sum())}; kernel hit where XLA misses "
              f"{bad}; unwidened XLA differs from the kernel on "
              f"{int((raw != kern).sum())}")
    assert missed == 0, f"{missed} kernel broad hits the XLA pass skips"


def phase_planner(ctx):
    confs = ctx["hard10k"].confs
    ck = ctx["checker"]
    batches = [confs[i * 2048 % 8192:][:2048] for i in range(20)]
    ck.check_valid_resolved(batches[0])  # warm the shape
    lats = []
    for b in batches:
        t0 = time.perf_counter()
        ck.check_valid_resolved(b)
        lats.append(time.perf_counter() - t0)
    print(f"  2048-pose batches x20: p50 {np.percentile(lats, 50) * 1e3:.3f}"
          f" ms, p99 {np.percentile(lats, 99) * 1e3:.3f} ms")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import demo_planner

    t0 = time.perf_counter()
    rc = demo_planner.wall_demo(ccd=True)
    print(f"  wall_demo(ccd=True): rc={rc} in {time.perf_counter() - t0:.1f}"
          f" s")
    assert rc == 0, "wall demo did not certify"


def phase_clearance(ctx):
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from robocheck.ops.transform import rotation_matrices
    from robocheck.planner.ccd import subdivide_mesh
    from robocheck.planner.clearance import ClearanceEngine
    from robocheck.runtime import native

    robot, obstacle = ctx["meshes"]
    rob4 = subdivide_mesh(robot, 4)
    confs = near_contact_poses(obstacle)
    eng = ClearanceEngine(rob4.vertices, obstacle)
    d = eng.min_distances(confs)
    err = eng.err_bound(confs)
    raw = d + err  # the engine's float32 distance before the haircut
    R = np.asarray(rotation_matrices(jnp.asarray(confs)), np.float64)
    ov = np.ascontiguousarray(obstacle.vertices, np.float64)
    ot = np.ascontiguousarray(obstacle.triangles, np.int32)
    verts = rob4.vertices.astype(np.float64)

    def ref(i):
        pts = verts @ R[i].T + confs[i, 0:3].astype(np.float64)
        return native.point_mesh_dist(ov, ot, pts).min()

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        nat = np.array(list(ex.map(ref, range(len(confs)))))
    unit = err / 128.0  # f32 eps x scale
    dev = np.abs(raw - nat) / unit
    print(f"  {len(confs)} poses, {rob4.num_vertices} robot vertices: "
          f"largest |engine - native| = {dev.max():.2f} x (f32 eps x "
          f"scale), bound assumes 128; err_bound = {err:.6g}")
    ctx["clearance"] = (rob4, confs, d)
    assert (d <= nat).all() and (nat <= raw + err).all(), (
        "an engine answer does not bracket the native distance")


def phase_gpu_tests(ctx):
    import pytest

    rc = pytest.main([os.path.join(REPO, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    print(f"  pytest -m gpu: exit {int(rc)}")
    assert int(rc) == 0, f"pytest -m gpu exited {int(rc)}"


def phase_four_cards(ctx):
    import jax

    from robocheck.io import assets
    from robocheck.io.conf import read_conf_file
    from robocheck.parallel.sharding import ShardedChecker, make_mesh
    from robocheck.planner.ccd import subdivide_mesh
    from robocheck.planner.clearance import ClearanceEngine

    assert len(jax.devices()) >= 4, f"{len(jax.devices())} devices"
    robot, obstacle = ctx["meshes"]
    mesh = make_mesh(4)
    sharded = ShardedChecker(robot, obstacle, mesh=mesh)
    one = ctx["checker"]
    for name in ("hard10k", "easy10k"):
        ds = read_conf_file(assets.dataset_path(name))
        v4 = sharded.check_valid_resolved(ds.confs)
        v1 = one.check_valid_resolved(ds.confs)
        g = int((v4 != ds.valid).sum())
        s = int((v4 != v1).sum())
        print(f"  {name}: 4-card vs tags {g} mismatches, vs one card {s}")
        assert g == 0 and s == 0, name
    rob4 = subdivide_mesh(robot, 4)
    confs = near_contact_poses(obstacle)
    d1 = ClearanceEngine(rob4.vertices, obstacle).min_distances(confs)
    d4 = ClearanceEngine(rob4.vertices, obstacle,
                         mesh=mesh).min_distances(confs)
    diff = float(np.abs(d1 - d4).max())
    print(f"  clearance 4-card vs unsharded: max |diff| = {diff:.3g}")
    assert diff <= 1e-6 * max(1.0, float(np.abs(d1).max())), diff


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phase")
    args = ap.parse_args()

    import jax

    from robocheck.runtime.device import require_gpu

    dev = require_gpu()
    from robocheck.kernels.megakernel import MegaKernelChecker
    from robocheck.runtime.cache import enable_compilation_cache

    print(f"compile cache: {enable_compilation_cache()}")
    count = len(jax.devices())
    print(f"device: {dev.device_kind} x{count}; card: {card_line()}")
    ctx = {"meshes": alpha()}
    t0 = time.perf_counter()
    ctx["checker"] = MegaKernelChecker(*ctx["meshes"])
    print(f"checker built in {time.perf_counter() - t0:.2f} s")

    if args.devices == 4:
        phases = [("four cards", phase_four_cards)]
    else:
        phases = [("goldens", phase_goldens), ("100k", phase_100k),
                  ("kernel vs reference", phase_reference),
                  ("broad flags", phase_broad),
                  ("planner step", phase_planner),
                  ("clearance", phase_clearance),
                  ("card-only tests", phase_gpu_tests)]
    failed = []
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            print("  FAILED", flush=True)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

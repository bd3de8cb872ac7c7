"""Multi-device SPMD tests on the virtual 8-device CPU mesh (the tier the
reference could never have — SURVEY.md §4)."""
import jax
import numpy as np
import pytest

from robocheck.models.shapes import icosphere
from robocheck.parallel.sharding import ShardedChecker, make_mesh
from robocheck.runtime.distributed import shard_bounds


@pytest.fixture(scope="module")
def sphere_world():
    return icosphere(1, radius=1.0, name="robot"), icosphere(1, 1.5, name="obstacle")


@pytest.fixture(scope="module")
def confs():
    rng = np.random.default_rng(9)
    c = rng.uniform(-2, 2, size=(64, 6)).astype(np.float32)
    c[:, 3:6] = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    return c


def test_eight_devices_available():
    assert len(jax.devices()) == 8, (
        "conftest must provide 8 virtual CPU devices"
    )


def test_sharded_matches_single_device(sphere_world, confs):
    robot, obstacle = sphere_world
    full = ShardedChecker(robot, obstacle, mesh=make_mesh(8))
    single = ShardedChecker(robot, obstacle, mesh=make_mesh(1))
    v8, c8, n8, b8 = full.check(confs)
    v1, c1, n1, b1 = single.check(confs)
    np.testing.assert_array_equal(v8, v1)
    np.testing.assert_array_equal(n8, n1)


def test_psum_totals(sphere_world, confs):
    robot, obstacle = sphere_world
    checker = ShardedChecker(robot, obstacle, mesh=make_mesh(8))
    # check_block requires a mesh-and-program-divisible batch.
    reps = -(-checker._block_multiple) // len(confs) + 1
    block = np.tile(confs, (reps, 1))[: checker._block_multiple]
    out, totals = checker.check_block(block)
    confs = block
    out = np.asarray(out)
    totals = np.asarray(totals)
    assert totals[0] == out[:, 0].sum()  # global valid count
    assert totals[0] + totals[1] == confs.shape[0]
    assert totals[2] == out[:, 1].sum()  # coplanar flags


def test_batch_not_divisible(sphere_world, confs):
    robot, obstacle = sphere_world
    checker = ShardedChecker(robot, obstacle, mesh=make_mesh(8))
    v, *_ = checker.check(confs[:37])
    assert v.shape == (37,)


def test_sharded_check_valid_matches_single_chip(sphere_world, confs):
    # The streamed packed path must agree with the single-chip
    # MegaKernelChecker (same kernel, same FP order) on every verdict.
    from robocheck.kernels.megakernel import MegaKernelChecker

    robot, obstacle = sphere_world
    sharded = ShardedChecker(robot, obstacle, mesh=make_mesh(8))
    single = MegaKernelChecker(robot, obstacle)
    v8, c8 = sharded.check_valid(confs)
    v1, c1 = single.check_valid(confs)
    np.testing.assert_array_equal(v8, v1)
    np.testing.assert_array_equal(c8, c1)


def test_sharded_check_valid_chunked_nondivisible(sphere_world, confs):
    robot, obstacle = sphere_world
    checker = ShardedChecker(robot, obstacle, mesh=make_mesh(8))
    # 55 configs, chunk=64 (one block multiple): padded tail rows must not
    # affect verdicts; multi-chunk concat exercised with chunk=128 on 200.
    v, c = checker.check_valid(confs[:55], chunk=64)
    v_ref, c_ref, *_ = checker.check(confs[:55])
    np.testing.assert_array_equal(v, v_ref)
    big = np.concatenate([confs, confs, confs, confs])[:200]
    v2, _ = checker.check_valid(big, chunk=128)
    v2_ref, *_ = checker.check(big)
    np.testing.assert_array_equal(v2, v2_ref)


def test_sharded_check_valid_nonfinite(sphere_world, confs):
    robot, obstacle = sphere_world
    checker = ShardedChecker(robot, obstacle, mesh=make_mesh(8))
    bad = confs[:16].copy()
    bad[3, 0] = np.nan
    bad[7, 5] = np.inf
    v, c = checker.check_valid(bad)
    assert not v[3] and not v[7]
    good = np.delete(np.arange(16), [3, 7])
    v_ref, _ = checker.check_valid(confs[:16][good])
    np.testing.assert_array_equal(v[good], v_ref)


def test_shard_bounds_cover_exactly():
    total = 1003
    seen = []
    for pid in range(4):
        lo, hi = shard_bounds(total, pid, 4)
        seen.append((lo, hi))
    assert seen[0][0] == 0
    assert seen[-1][1] == total
    for (a, b), (c, d) in zip(seen, seen[1:]):
        assert b == c

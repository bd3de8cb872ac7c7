"""Oversized-mesh chunked checking: exact verdict combination across
Morton-ordered mesh chunks + automatic dispatch (`kernels/chunked.py`).

The reference could not represent meshes beyond its constant-memory capacity
constants at all (`Utils_rai.h:98-99`); here any size must check correctly
through the same API.
"""
import numpy as np
import pytest

from robocheck.kernels.chunked import (
    ChunkedMegaKernelChecker,
    MAX_OBS_TRIS,
    make_checker,
    split_mesh,
)
from robocheck.kernels.megakernel import MegaKernelChecker
from robocheck.models.shapes import icosphere, triangle_soup
from robocheck.oracle import cpu_oracle


@pytest.fixture(scope="module")
def worlds():
    robot = icosphere(1, radius=1.0, name="robot")  # 80 tris
    obstacle = icosphere(2, radius=1.5, name="obstacle")  # 320 tris
    return robot, obstacle


@pytest.fixture(scope="module")
def confs():
    rng = np.random.default_rng(41)
    c = rng.uniform(-2.5, 2.5, size=(24, 6)).astype(np.float32)
    c[:, 3:6] = rng.uniform(-np.pi, np.pi, (24, 3)).astype(np.float32)
    return c


def test_split_mesh_partitions_triangles(worlds):
    _, obstacle = worlds
    chunks = split_mesh(obstacle, 100)
    assert len(chunks) == 4  # 320 tris / <=100 -> 4 chunks of 80
    assert sum(c.num_triangles for c in chunks) == obstacle.num_triangles
    # Every original triangle appears exactly once (as a vertex-index row).
    all_rows = np.concatenate([c.triangles for c in chunks])
    orig = set(map(tuple, obstacle.triangles.tolist()))
    got = list(map(tuple, all_rows.tolist()))
    assert len(got) == len(orig) and set(got) == orig


def test_chunked_matches_unchunked_and_oracle(worlds, confs):
    robot, obstacle = worlds
    plain = MegaKernelChecker(robot, obstacle)
    chunked = ChunkedMegaKernelChecker(
        robot, obstacle, max_rob_tris=64, max_obs_tris=128
    )
    assert chunked.num_chunk_pairs == 6  # 2 robot x 3 obstacle chunks

    v0, c0, p0, b0 = plain.check(confs)
    v1, c1, p1, b1 = chunked.check(confs)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(c0, c1)
    # Chunk AABBs are contained in the whole-mesh AABBs, so a chunked broad
    # hit implies a whole-mesh broad hit. (Pair counts are NOT comparable:
    # chunking re-tiles the Morton order, changing which tiles gate in.)
    assert not np.any(b1 & ~b0)
    del p0, p1

    gt = cpu_oracle.check_configs(robot, obstacle, confs)
    np.testing.assert_array_equal(v1, gt)

    vv, cc = chunked.check_valid(confs, chunk=16)
    np.testing.assert_array_equal(vv, v1)
    np.testing.assert_array_equal(cc, c1)


def test_make_checker_dispatch(worlds, rng):
    robot, obstacle = worlds
    small = make_checker(robot, obstacle)
    assert isinstance(small, MegaKernelChecker)

    # Past the fused kernel's gate width (MAX_OBS_TRIS triangles).
    n_big = 58_000
    big_obs = triangle_soup(rng, n_big, extent=2.0)
    big = make_checker(robot, big_obs)
    assert isinstance(big, ChunkedMegaKernelChecker)
    assert big.num_chunk_pairs == -(-n_big // MAX_OBS_TRIS)


@pytest.mark.gpu
def test_chunked_oversized_on_hardware(worlds, rng):
    # Compiled twin of the dispatch test: a 58k-triangle obstacle, past the
    # fused kernel's gate width, runs through make_checker's Morton chunks
    # on the card and matches the oracle.
    robot, _ = worlds
    big_obs = triangle_soup(rng, 58_000, extent=2.0)
    checker = make_checker(robot, big_obs)
    assert isinstance(checker, ChunkedMegaKernelChecker)
    confs = rng.uniform(-2.5, 2.5, size=(64, 6)).astype(np.float32)
    v, _ = checker.check_valid(confs, chunk=64)
    # The f64 oracle: native when built (diff-tested against the numpy
    # one in tests/test_native.py), which keeps 58k triangles quick.
    from robocheck.oracle import check_configs

    np.testing.assert_array_equal(v, check_configs(robot, big_obs, confs))


def test_chunked_oversized_end_to_end(worlds, rng):
    # An obstacle forced through multiple chunks via the public chunked
    # checker: verdicts must match the oracle. (Small caps keep interpret
    # mode fast; the factory-threshold routing is covered above.)
    robot, _ = worlds
    big_obs = triangle_soup(rng, 1000, extent=2.0)
    checker = ChunkedMegaKernelChecker(robot, big_obs,
                                       max_obs_tris=256)
    assert checker.num_chunk_pairs == 4
    confs = rng.uniform(-2, 2, size=(8, 6)).astype(np.float32)
    v, _ = checker.check_valid(confs)
    gt = cpu_oracle.check_configs(robot, big_obs, confs)
    np.testing.assert_array_equal(v, gt)


def test_chunked_compaction_matches_uncompacted(worlds, confs):
    robot, obstacle = worlds
    chunked = ChunkedMegaKernelChecker(
        robot, obstacle, max_rob_tris=64, max_obs_tris=128
    )
    v0, c0 = chunked.check_valid(confs, chunk=16, compact=False)
    v1, c1 = chunked.check_valid(confs, chunk=16, compact=True)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(c0, c1)


def test_sharded_chunked_composition(worlds, confs):
    # Oversized meshes x multi-chip sharding: every chunk pair runs through
    # a batch-sharded checker on the 8-device CPU mesh, verdicts match the
    # float64 oracle and the single-chip chunked path.
    from robocheck.parallel.sharding import make_mesh

    robot, obstacle = worlds
    mesh = make_mesh(8)
    sharded = ChunkedMegaKernelChecker(
        robot, obstacle, max_rob_tris=64, max_obs_tris=128,
        mesh=mesh,
    )
    plain = ChunkedMegaKernelChecker(
        robot, obstacle, max_rob_tris=64, max_obs_tris=128
    )
    v0, c0 = plain.check_valid(confs)
    v1, c1 = sharded.check_valid(confs)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(c0, c1)
    gt = cpu_oracle.check_configs(robot, obstacle, confs)
    np.testing.assert_array_equal(v1, gt)


def test_make_checker_mesh_dispatch(worlds):
    from robocheck.parallel.sharding import ShardedChecker, make_mesh

    robot, obstacle = worlds
    ck = make_checker(robot, obstacle, mesh=make_mesh(8))
    assert isinstance(ck, ShardedChecker)

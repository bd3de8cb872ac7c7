"""Fused-kernel tests (interpret mode on the CPU; the compiled kernel's
equivalence on the GPU is checked by chip_smoke.py's golden phases).

The kernel must agree with the pure-XLA pipeline (same FP semantics) and with
the float64 oracle on synthetic scenes small enough for interpret mode.
"""
import numpy as np
import pytest

from robocheck.kernels.megakernel import (
    BATCH_MULTIPLE,
    MegaKernelChecker,
    MegaKernelPrep,
)
from robocheck.models.shapes import icosphere, tetrahedron
from robocheck.ops.pipeline import CollisionWorld, PipelineConfig
from robocheck.oracle import cpu_oracle


@pytest.fixture(scope="module")
def sphere_world():
    robot = icosphere(1, radius=1.0, name="robot")  # 80 triangles
    obstacle = icosphere(1, radius=1.5, name="obstacle")
    return robot, obstacle


@pytest.fixture(scope="module")
def sphere_confs(rng=None):
    rng = np.random.default_rng(77)
    confs = np.zeros((16, 6), dtype=np.float32)
    # Mix of: deep overlap, shell-crossing, near-miss, far-away.
    confs[:, 0] = np.concatenate(
        [
            rng.uniform(0.0, 0.4, 4),     # robot inside obstacle -> no surface hit
            rng.uniform(0.4, 2.6, 6),     # shells cross
            rng.uniform(2.6, 2.7, 2),     # near miss
            rng.uniform(5.0, 50.0, 4),    # far away
        ]
    ).astype(np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (16, 3)).astype(np.float32)
    return confs


def test_kernel_matches_xla_pipeline(sphere_world, sphere_confs):
    robot, obstacle = sphere_world
    mk = MegaKernelChecker(robot, obstacle)
    valid_k, cop_k, _, _ = mk.check(sphere_confs)

    world = CollisionWorld(
        robot, obstacle,
        PipelineConfig(batch_block=16, narrow_chunk=8, max_pairs=4096),
    )
    valid_x = world.check(sphere_confs)
    np.testing.assert_array_equal(valid_k, valid_x)


def test_kernel_matches_oracle(sphere_world, sphere_confs):
    robot, obstacle = sphere_world
    mk = MegaKernelChecker(robot, obstacle)
    valid_k, _, _, _ = mk.check(sphere_confs)
    valid_o = cpu_oracle.check_configs(robot, obstacle, sphere_confs)
    np.testing.assert_array_equal(valid_k, valid_o)


def test_kernel_tetrahedra_fixture():
    # The reference's 2-config fixture: interlocking tetrahedra collide at
    # the identity pose and are clear at +100x (`test-narrow-phase.cu:628-686`).
    # (Coincident identical tetrahedra would NOT register: every pair is
    # coplanar or edge-sharing, which the TOL-band semantics skip — same as
    # the reference kernels.)
    from robocheck.core.types import Mesh

    robot = tetrahedron()
    obs_pts = np.array(
        [[1, 0.1, 0], [1.5, 1, 2.2], [1, 2.4, 0], [3.3, 2, 2]], np.float32
    )
    obstacle = Mesh(obs_pts, robot.triangles, "obs-tetra")
    mk = MegaKernelChecker(robot, obstacle)
    confs = np.zeros((2, 6), np.float32)
    confs[1, 0] = 100.0
    valid, cop, npairs, broad = mk.check(confs)
    assert not valid[0]
    assert valid[1]
    assert broad[0] and not broad[1]


def test_mismatched_scale_coplanar_precheck():
    # ADVICE r3 (medium): when every plane-coefficient ratio |nr/no| is
    # itself below TOL (~4 orders of mesh-scale mismatch), the full
    # component-ratio test declares pairs coplanar via _isclose's
    # both-small branch, but the parallel-normal |D| precheck never fires —
    # the kernel then skipped the coplanar flag and reported a raw hit,
    # diverging from ops.narrow. The precheck's sub-TOL-ratio branch now
    # covers it; this is the differential fixture: unit robot vs a 1e4x
    # obstacle (plane coeffs O(1) vs O(1e8..1e12)). The robot is a box
    # CENTERED at its own origin so that any pose whose translation lies on
    # an obstacle face plane straddles that plane for every rotation
    # (corners come in +/- pairs).
    from robocheck.models.shapes import box

    robot = box(extent=(2.0, 2.0, 2.0))
    obstacle = tetrahedron(scale=1.0e4)
    mk = MegaKernelChecker(robot, obstacle)
    world = CollisionWorld(
        robot, obstacle,
        PipelineConfig(batch_block=8, narrow_chunk=8, max_pairs=4096,
                       resolve_coplanar=False),
    )
    rng = np.random.default_rng(3)
    confs = np.zeros((8, 6), dtype=np.float32)
    # Rows 0-4: ON the big tetra's slanted face x - 2y - z + 4e4 = 0 (and
    # just off it), where every component ratio is sub-TOL -> ratio-coplanar
    # pairs. Rows 5-6: on the x=0 face, whose normal has zero y/z components
    # while the robot's are generic -> zero-pattern mismatch, NOT coplanar.
    # Row 7: far away.
    confs[:, 0:3] = np.array(
        [
            [6.0e3, 1.8e4, 1.0e4],
            [6.0e3 + 0.5, 1.8e4, 1.0e4],
            [2.0e4 - 10.0, 1.9e4, 1.99e4],
            [0.0, 1.99e4, 5.0],
            [6.0e3, 1.8e4, 1.0e4 - 2.0],
            [0.0, 5.0e3, 5.0e3],
            [1.0, 5.0e3, 5.0e3],
            [9.0e5, 9.0e5, 9.0e5],
        ],
        dtype=np.float32,
    )
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (8, 3)).astype(np.float32)
    valid_k, cop_k, _, _ = mk.check(confs)
    valid_x, res = world.check(confs, return_result=True)
    np.testing.assert_array_equal(valid_k, valid_x)
    np.testing.assert_array_equal(cop_k, res.coplanar)
    # The fixture must actually exercise the sub-TOL branch.
    assert cop_k.any()
    # End-to-end resolved surface agrees with the float64 oracle.
    resolved = mk.check_valid_resolved(confs)
    np.testing.assert_array_equal(
        resolved, cpu_oracle.check_configs(robot, obstacle, confs)
    )


def test_morton_off_same_verdicts(sphere_world, sphere_confs):
    robot, obstacle = sphere_world
    a = MegaKernelChecker(robot, obstacle, morton=True)
    b = MegaKernelChecker(robot, obstacle, morton=False)
    va, *_ = a.check(sphere_confs)
    vb, *_ = b.check(sphere_confs)
    np.testing.assert_array_equal(va, vb)


def test_packed_matches_stats_path(sphere_world, sphere_confs):
    # The packed throughput decode (verdict bits only) must agree bit for
    # bit with the full output columns on the same batch.
    import jax.numpy as jnp

    from robocheck.kernels import megakernel as mk

    robot, obstacle = sphere_world
    ck = MegaKernelChecker(robot, obstacle)
    n = -(-len(sphere_confs) // BATCH_MULTIPLE) * BATCH_MULTIPLE
    confs = np.zeros((n, 6), np.float32)
    confs[:, 0] = 1.0e9
    confs[: len(sphere_confs)] = sphere_confs

    packed = np.asarray(mk._check_block_packed(
        jnp.asarray(confs), *ck._tables, **ck._static))
    stats = np.asarray(ck.check_block(jnp.asarray(confs)))
    np.testing.assert_array_equal(packed & 1, stats[:, 0].astype(np.uint8))
    np.testing.assert_array_equal(packed >> 1, stats[:, 1].astype(np.uint8))


def test_prep_shapes(alpha_meshes):
    from robocheck.kernels.megakernel import OBS_TILE, ROB_TILE

    robot, obstacle = alpha_meshes
    prep = MegaKernelPrep.build(robot, obstacle)
    assert prep.rob_base.shape == (16, 1024)
    assert prep.obs_fields.shape == (32, 1008 // OBS_TILE * OBS_TILE
                                     + (1008 % OBS_TILE > 0) * OBS_TILE)
    assert prep.num_rob_tiles == 1024 // ROB_TILE
    assert prep.num_obs_tiles == -(-1008 // OBS_TILE)
    # Group boxes come in a power-of-two row, empty past the mesh.
    g = prep.obs_group_aabbs.shape[1]
    assert g & (g - 1) == 0 and g >= prep.num_obs_tiles
    assert np.all(prep.obs_group_aabbs[0:3, prep.num_obs_tiles:] == np.inf)
    assert np.all(prep.obs_group_aabbs[3:6, prep.num_obs_tiles:] == -np.inf)
    # Padding robot triangles are flagged invalid.
    assert prep.rob_base[9, :1008].all()
    assert not prep.rob_base[9, 1008:].any()
    # Padding obstacle AABBs are empty (never pass a mask).
    assert np.all(prep.obs_fields[13:16, 1008:] == np.inf)
    assert np.all(prep.obs_fields[16:19, 1008:] == -np.inf)


@pytest.mark.parametrize("rob_tile,obs_tile", [(32, 64), (16, 16)])
def test_multi_tile_gate_not_power_of_two(rng, rob_tile, obs_tile):
    # A 300-triangle obstacle is 5 groups of 64 (or 19 of 16): group counts
    # that are not powers of two, padded to 8 (or 32) empty group boxes, and
    # a 320-triangle robot spans 10 (or 20) robot tiles — multi-tile sweeps
    # on both sides, against the oracle and the XLA pipeline.
    from robocheck.models.shapes import triangle_soup

    obstacle = triangle_soup(rng, 300, extent=1.0)
    robot = icosphere(2, radius=0.3)  # 320 triangles
    mk = MegaKernelChecker(robot, obstacle, rob_tile=rob_tile,
                           obs_tile=obs_tile)
    assert mk.prep.num_obs_tiles == -(-300 // obs_tile)
    assert mk.prep.num_obs_tiles & (mk.prep.num_obs_tiles - 1)
    assert mk.prep.num_rob_tiles > 1
    confs = rng.uniform(-1.2, 1.2, (12, 6)).astype(np.float32)
    valid, cop, pairs, _ = mk.check(confs)
    np.testing.assert_array_equal(
        valid, cpu_oracle.check_configs(robot, obstacle, confs))
    world = CollisionWorld(
        robot, obstacle,
        PipelineConfig(batch_block=12, narrow_chunk=4, max_pairs=8192,
                       resolve_coplanar=False),
    )
    v_x, res = world.check(confs, return_result=True)
    np.testing.assert_array_equal(valid, v_x)
    # Poses that visit every gated tile count every masked pair.
    np.testing.assert_array_equal(pairs[valid], res.num_pairs[valid])


def test_early_exit_counters(sphere_world):
    # A colliding pose stops at its first hit: it visits fewer tiles than a
    # valid pose of the same scene visits, and at least one ran the interval
    # stage. Columns: 4 = mask tiles, 5 = visited tiles, 6 = interval tiles.
    import jax.numpy as jnp

    robot, obstacle = sphere_world
    mk = MegaKernelChecker(robot, obstacle, rob_tile=16, obs_tile=16)
    confs = np.zeros((BATCH_MULTIPLE, 6), np.float32)
    confs[:, 0] = 1.0e9
    confs[0, 0] = 1.0    # shells cross: collides
    confs[1, 0] = 0.0    # concentric: valid, every gated tile visited
    out = np.asarray(mk.check_block(jnp.asarray(confs)))
    hit, clear = out[0], out[1]
    assert hit[0] == 0 and clear[0] == 1
    assert hit[3] == 1 and clear[3] == 1
    assert hit[6] >= 1
    assert 1 <= hit[5] < clear[5]
    assert clear[4] <= clear[5]
    # Far poses stop at the broad phase and visit nothing.
    assert (out[2:, 3] == 0).all() and (out[2:, 4:7] == 0).all()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_host_broad_phase_covers_kernel(sphere_world, axis):
    # Poses whose robot box touches the obstacle box face on along one axis,
    # from either side, where rounding decides the broad flag. The widened
    # XLA pass must be set wherever the kernel's stage 1 hits, and two-phase
    # `check` must report the kernel's own flag and verdicts.
    import jax.numpy as jnp

    from robocheck.kernels import megakernel as km

    robot, obstacle = sphere_world
    mk = MegaKernelChecker(robot, obstacle)
    rng = np.random.default_rng(11 + axis)
    confs = np.zeros((BATCH_MULTIPLE, 6), np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (BATCH_MULTIPLE, 3))
    lo, hi, _ = (np.asarray(a, np.float64) for a in km._posed_bounds(
        jnp.asarray(confs), mk._corner_pts, mk._corner_mask))
    obs = mk.prep.obs_mesh_aabb[0].astype(np.float64)
    half = BATCH_MULTIPLE // 2
    confs[:half, axis] = obs[3 + axis] - lo[:half, axis]
    confs[half:, axis] = obs[axis] - hi[half:, axis]

    v1, c1, p1, b1 = mk.check(confs, two_phase=False)
    host = np.asarray(mk.broad_block(jnp.asarray(confs)))
    assert host[b1].all()
    v2, c2, p2, b2 = mk.check(confs, two_phase=True)
    for a, b in ((v1, v2), (c1, c2), (p1, p2), (b1, b2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        v1, cpu_oracle.check_configs(robot, obstacle, confs))


def test_route_choice():
    # One function picks the route: compiled on the GPU, interpreted on the
    # CPU, refused anywhere else.
    from types import SimpleNamespace

    from robocheck.runtime.device import pallas_interpret

    assert pallas_interpret([SimpleNamespace(platform="gpu")]) is False
    assert pallas_interpret([SimpleNamespace(platform="cpu")]) is True
    with pytest.raises(RuntimeError, match="not supported"):
        pallas_interpret([SimpleNamespace(platform="rocm")])


class TestCheckValid:
    """The streamed throughput path (`check_valid`) is what bench.py times;
    it must agree with `check` (two-phase) and the f64 oracle — including
    the packed-uint8 decode, chunk padding, and the non-finite recursion."""

    def test_matches_check_and_oracle_mixed(self, sphere_world, sphere_confs):
        robot, obstacle = sphere_world
        mk = MegaKernelChecker(robot, obstacle)
        v_stream, c_stream = mk.check_valid(sphere_confs)
        v_check, c_check, _, _ = mk.check(sphere_confs)
        np.testing.assert_array_equal(v_stream, v_check)
        np.testing.assert_array_equal(c_stream, c_check)
        v_oracle = cpu_oracle.check_configs(robot, obstacle, sphere_confs)
        np.testing.assert_array_equal(v_stream, v_oracle)

    def test_non_divisible_multi_chunk(self, sphere_world):
        # chunk=8 over 19 configs: two full chunks + a padded tail, and the
        # multi-chunk device-side concatenation.
        robot, obstacle = sphere_world
        mk = MegaKernelChecker(robot, obstacle)
        rng = np.random.default_rng(3)
        confs = rng.uniform(-2.0, 2.0, (19, 6)).astype(np.float32)
        v_stream, c_stream = mk.check_valid(confs, chunk=8)
        v_check, c_check, _, _ = mk.check(confs)
        np.testing.assert_array_equal(v_stream, v_check)
        np.testing.assert_array_equal(c_stream, c_check)

    def test_nonfinite_rows(self, sphere_world):
        robot, obstacle = sphere_world
        mk = MegaKernelChecker(robot, obstacle)
        confs = np.zeros((6, 6), np.float32)
        confs[0, 0] = np.nan
        confs[2, 3] = np.inf
        confs[4, 0] = 100.0  # far away -> valid
        v, c = mk.check_valid(confs)
        assert not v[0] and not v[2]  # non-finite poses are never valid
        assert v[4]
        v_check, *_ = mk.check(confs)
        np.testing.assert_array_equal(v, v_check)

    def test_all_miss_and_all_hit_chunks(self, sphere_world):
        robot, obstacle = sphere_world
        mk = MegaKernelChecker(robot, obstacle)
        far = np.zeros((8, 6), np.float32)
        far[:, 0] = 1000.0
        near = np.zeros((8, 6), np.float32)
        near[:, 0] = 1.0  # shells cross at |t| in (0.5, 2.5)
        confs = np.concatenate([far, near])
        v, c = mk.check_valid(confs, chunk=8)  # one all-miss, one all-hit
        assert v[:8].all()
        assert not v[8:].any()

    def test_alpha_golden_slice(self, alpha_meshes, hard10k):
        # Real meshes, tagged goldens (256-conf slice; the full files run
        # on the GPU in chip_smoke.py and in the slow tier).
        robot, obstacle = alpha_meshes
        mk = MegaKernelChecker(robot, obstacle)
        confs = hard10k.confs[:256]
        v, _ = mk.check_valid(confs, chunk=64)
        np.testing.assert_array_equal(v, hard10k.valid[:256])


def test_batch_padding_roundtrip(sphere_world):
    robot, obstacle = sphere_world
    mk = MegaKernelChecker(robot, obstacle)
    confs = np.zeros((BATCH_MULTIPLE + 3, 6), np.float32)
    confs[:, 0] = 100.0  # all far away
    valid, *_ = mk.check(confs)
    assert valid.shape == (BATCH_MULTIPLE + 3,)
    assert valid.all()


class TestCoplanarResolution:
    """The failure mode the reference printf's on (`narrow-phase.cu:544-545`):
    near-coplanar face-on-face contact. The f32 kernel flags it; the float64
    oracle resolves it; `check_valid_resolved` is the surface consumers
    certify against. Fixture found by search: two triangles lying in one
    tilted plane at ~300-unit coordinates, where f32 rounding makes the
    signed distances straddle the ±TOL band (so the pair is 'live') while
    the plane-coefficient ratios still match (so it is flagged coplanar) —
    and the exact f64 geometry intersects."""

    RT = np.array([[-88.58568, -287.5827, -148.07309],
                   [-105.54053, -122.13013, -65.34459],
                   [9.788717, -353.9158, -98.061005]], dtype=np.float32)
    OT = np.array([[-163.90807, -449.27316, -312.38596],
                   [55.186058, -181.60817, 45.36783],
                   [-9.889383, -480.09338, -190.76962]], dtype=np.float32)

    def _world(self):
        from robocheck.core.types import Mesh

        tris = np.array([[0, 1, 2]], np.int32)
        return Mesh(self.RT, tris, name="r"), Mesh(self.OT, tris, name="o")

    def test_flagged_then_resolved_colliding(self):
        robot, obstacle = self._world()
        ck = MegaKernelChecker(robot, obstacle)
        confs = np.zeros((1, 6), np.float32)
        valid, cop = ck.check_valid(confs)
        assert valid[0] and cop[0], "fixture must be flagged-but-unresolved"
        resolved = ck.check_valid_resolved(confs)
        assert not resolved[0], "exact geometry collides"
        from robocheck.oracle import check_configs

        assert not check_configs(robot, obstacle, confs)[0]

    def test_resolution_keeps_clean_verdicts(self):
        # Far-away configs: nothing flagged, resolved == raw (and the helper
        # returns the input array untouched).
        robot, obstacle = self._world()
        ck = MegaKernelChecker(robot, obstacle)
        confs = np.zeros((4, 6), np.float32)
        confs[:, 0] = 1e5
        raw, cop = ck.check_valid(confs)
        assert raw.all() and not cop.any()
        assert ck.check_valid_resolved(confs).all()

    def test_invalid_stays_invalid(self):
        # resolve_coplanar must never overturn a collision verdict.
        from robocheck.oracle import resolve_coplanar

        robot, obstacle = self._world()
        valid = np.array([False, True])
        cop = np.array([True, False])
        out = resolve_coplanar(robot, obstacle, np.zeros((2, 6), np.float32),
                               valid, cop)
        np.testing.assert_array_equal(out, [False, True])


def test_presort_matches_plain(sphere_world):
    # Broad-phase presort + never-dispatched all-miss tail must be verdict-
    # identical to the plain streamed path, with order restored.
    robot, obstacle = sphere_world
    mk = MegaKernelChecker(robot, obstacle)
    rng = np.random.default_rng(3)
    confs = np.zeros((40, 6), np.float32)
    confs[:, 0] = rng.permutation(
        np.concatenate([rng.uniform(0.0, 2.4, 25),      # hits
                        rng.uniform(50.0, 90.0, 15)])    # misses
    ).astype(np.float32)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, (40, 3)).astype(np.float32)
    v0, c0 = mk.check_valid(confs, chunk=8, presort=False)
    v1, c1 = mk.check_valid(confs, chunk=8, presort=True)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(c0, c1)

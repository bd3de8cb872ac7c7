"""The end-to-end collision-check pipeline (pure-JAX reference path).

Reference counterpart: `broad-phase-fused.cu:365-521` ``broadPhaseFused_sep``
— the de-facto ``check()`` API that fuses transform + AABB + broad phase in
one kernel and chains the warp-coarsened narrow phase. The array redesign:

  stage 1 (dense, fused by XLA):
      configs [B,6] -> rotation matrices -> transformed vertices [B,V,3]
      -> robot AABB [B,6] -> mesh-level broad mask.        (elementwise)
  stage 2 (hierarchical cull, dense):
      per-triangle mini-AABBs for the posed robot [B,Tr,6] vs the obstacle's
      precomputed mini-AABBs [To,6] -> pair mask [B,Tr,To]. This is the
      MegaKernel's stage-2/3 cull (`test/MegaKernel.cu:258-331`) as one
      broadcasted interval test instead of atomics into a shared buffer.
  stage 3 (compaction):
      surviving pair indices are compacted to a fixed-size buffer
      (``jnp.nonzero(..., size=max_pairs)``) — the XLA-friendly answer to the
      CUDA pair buffer + atomicAdd (`MegaKernel.cu:321-331`). Static shapes
      keep it jittable; buffer overflow raises a flag and the affected
      configurations are re-verdicted by the float64 oracle (see
      ``CollisionWorld.check``).
  stage 4 (dense masked narrow phase):
      exact Moller interval tests on the compacted pairs
      (`ops/narrow.pair_intersects`), any-hit OR-reduce per configuration.

Coplanar pairs (measure-zero on real data) are *flagged*, not resolved, in
the fast path; `CollisionWorld.check` resolves flagged configurations with
the float64 oracle — better than the reference kernels, which only printf
(`narrow-phase.cu:544-545`).

Verdict polarity throughout: ``valid == True`` means collision-free
(`Utils_rai.h:60`).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import constants
from ..core.types import Mesh, validate_confs
from . import aabb as aabb_ops
from . import narrow as narrow_ops
from . import transform as transform_ops


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Runtime knobs (the reference's compile-time #defines, `SURVEY.md` §5.6,
    promoted to a real config object)."""

    # Max tri-tri pairs evaluated per configuration after AABB culling.
    max_pairs: int = 16384
    # Configurations processed per lax.map step inside the narrow stage.
    narrow_chunk: int = 8
    # Mini-batch size the jitted pipeline is compiled for; callers pad to it.
    batch_block: int = 2048
    # Resolve coplanar-flagged configurations with the float64 oracle.
    resolve_coplanar: bool = True
    # Lane padding multiple for triangle arrays.
    lane: int = constants.LANE


class CheckResult(NamedTuple):
    valid: jnp.ndarray  # [B] bool — True = collision-free
    broad_valid: jnp.ndarray  # [B] bool — True = culled by mesh-level AABB
    coplanar: jnp.ndarray  # [B] bool — needs coplanar resolution
    overflow: jnp.ndarray  # [B] bool — pair buffer overflowed (re-run wider)
    num_pairs: jnp.ndarray  # [B] int32 — surviving pair count (stats)


def broad_phase(confs: jnp.ndarray, robot_vertices: jnp.ndarray,
                obstacle_aabb: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fused transform + AABB + mesh-level broad phase.

    Returns (valid [B] bool, transformed vertices [B,V,3]).
    """
    verts = transform_ops.transform_vertices(confs, robot_vertices)
    robot_aabbs = aabb_ops.vertices_aabb(verts)
    overlap = aabb_ops.aabb_overlap(robot_aabbs, obstacle_aabb)
    return ~overlap, verts


def _narrow_one_chunk(
    verts: jnp.ndarray,  # [C, V, 3] posed robot vertices
    rob_tris: jnp.ndarray,  # [Tr, 3] int32 (lane-padded, degenerate tail)
    rob_tri_mask: jnp.ndarray,  # [Tr] bool, False on padding rows
    obs_tri_verts: jnp.ndarray,  # [To, 3, 3]
    obs_tri_aabbs: jnp.ndarray,  # [To, 6]
    obs_planes: tuple[jnp.ndarray, jnp.ndarray],  # ([To,3], [To])
    max_pairs: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Narrow phase for a small chunk of configurations (dense + compaction)."""
    rob_tri_verts = verts[:, rob_tris]  # [C, Tr, 3, 3]
    rob_tri_aabbs = aabb_ops.triangle_aabbs(rob_tri_verts)  # [C, Tr, 6]

    # Stage-2/3 cull: [C, Tr, To] pair mask. Robot padding rows (degenerate
    # point boxes) are masked off so they never occupy pair-buffer slots.
    pair_mask = aabb_ops.aabb_overlap(
        rob_tri_aabbs[:, :, None, :], obs_tri_aabbs[None, None, :, :]
    )
    pair_mask = pair_mask & rob_tri_mask[None, :, None]
    num_pairs = jnp.sum(pair_mask, axis=(1, 2), dtype=jnp.int32)  # [C]
    overflow = num_pairs > max_pairs

    def per_config(args):
        mask, rtv = args  # [Tr, To], [Tr, 3, 3]
        pr, po = jnp.nonzero(mask, size=max_pairs, fill_value=0)
        tri_r = rtv[pr]  # [P, 3, 3]
        tri_o = obs_tri_verts[po]
        plane_o = (obs_planes[0][po], obs_planes[1][po])
        res = narrow_ops.pair_intersects(tri_r, tri_o, plane_o=plane_o)
        in_range = (
            jax.lax.broadcasted_iota(jnp.int32, (max_pairs, 1), 0).squeeze(-1)
            < jnp.sum(mask, dtype=jnp.int32)
        )
        hit = jnp.any(res.collides & in_range)
        cop = jnp.any(res.coplanar & in_range)
        return hit, cop

    hits, cops = jax.lax.map(per_config, (pair_mask, rob_tri_verts))
    return hits, cops, overflow, num_pairs


def check_block(
    confs: jnp.ndarray,  # [B, 6]
    robot_vertices: jnp.ndarray,  # [V, 3]
    rob_tris: jnp.ndarray,  # [Tr, 3]
    rob_tri_mask: jnp.ndarray,  # [Tr]
    obs_tri_verts: jnp.ndarray,  # [To, 3, 3]
    obs_tri_aabbs: jnp.ndarray,  # [To, 6]
    obs_planes_n: jnp.ndarray,  # [To, 3]
    obs_planes_d: jnp.ndarray,  # [To]
    obstacle_aabb: jnp.ndarray,  # [6]
    *,
    max_pairs: int,
    narrow_chunk: int,
) -> CheckResult:
    """Jittable fixed-shape pipeline over one block of configurations."""
    broad_valid, verts = broad_phase(confs, robot_vertices, obstacle_aabb)

    b = confs.shape[0]
    assert b % narrow_chunk == 0, (b, narrow_chunk)

    def chunk_fn(chunk_verts):
        return _narrow_one_chunk(
            chunk_verts, rob_tris, rob_tri_mask, obs_tri_verts, obs_tri_aabbs,
            (obs_planes_n, obs_planes_d), max_pairs,
        )

    chunked = verts.reshape(b // narrow_chunk, narrow_chunk, *verts.shape[1:])
    hits, cops, overflow, num_pairs = jax.lax.map(chunk_fn, chunked)
    hits = hits.reshape(b)
    cops = cops.reshape(b)
    overflow = overflow.reshape(b)
    num_pairs = num_pairs.reshape(b)

    # Broad-phase-valid configs have empty pair masks by construction, so the
    # narrow verdict is already correct for them; keep the flag for stats and
    # the two-phase driver.
    valid = ~hits
    return CheckResult(valid, broad_valid, cops, overflow, num_pairs)


class CollisionWorld:
    """User-facing checker for one robot/obstacle mesh pair.

    Replaces the reference's load-and-upload-every-call host driver
    (`broad-phase-fused.cu:365-521` re-reads both OBJ files and re-uploads
    constant memory per invocation, a reported 45-50 ms fixed cost): meshes
    are prepared and placed once at construction; ``check`` only streams
    configuration batches.
    """

    def __init__(self, robot: Mesh, obstacle: Mesh,
                 config: PipelineConfig | None = None):
        self.robot = robot
        self.obstacle = obstacle
        self.config = config or PipelineConfig()
        cfg = self.config

        rob_p = robot.padded(cfg.lane)
        obs_p = obstacle.padded(cfg.lane)
        self._rob_tris = jnp.asarray(rob_p.triangles)
        self._rob_tri_mask = jnp.asarray(rob_p.tri_mask)
        self._rob_verts = jnp.asarray(robot.vertices)
        obs_tri_verts = obs_p.triangle_vertices.astype(np.float32)
        self._obs_tri_verts = jnp.asarray(obs_tri_verts)
        # Obstacle mini-AABBs: precomputed once on host, like the MegaKernel's
        # generateTriAABBs (`MegaKernel.cu:31-35`) — but padding triangles get
        # an empty box at +inf so they never survive the pair cull.
        aabbs = np.concatenate(
            [obs_tri_verts.min(axis=1), obs_tri_verts.max(axis=1)], axis=-1
        )
        aabbs[~obs_p.tri_mask, :3] = np.inf
        aabbs[~obs_p.tri_mask, 3:] = -np.inf
        self._obs_tri_aabbs = jnp.asarray(aabbs)
        n_o, d_o = narrow_ops.compute_plane(jnp.asarray(obs_tri_verts))
        self._obs_plane_n = n_o
        self._obs_plane_d = d_o
        self._obs_aabb = jnp.asarray(obstacle.aabb)

        self._check_fn = jax.jit(
            partial(
                check_block,
                max_pairs=cfg.max_pairs,
                narrow_chunk=cfg.narrow_chunk,
            )
        )

    def _run_block(self, confs: jnp.ndarray) -> CheckResult:
        return self._check_fn(
            confs, self._rob_verts, self._rob_tris, self._rob_tri_mask,
            self._obs_tri_verts, self._obs_tri_aabbs, self._obs_plane_n,
            self._obs_plane_d, self._obs_aabb,
        )

    def check(self, confs: np.ndarray, return_result: bool = False):
        """Check a host batch; returns ``valid[N]`` (True = collision-free).

        Pads to the compiled block size and streams blocks through the jitted
        pipeline. Configurations flagged coplanar or whose pair buffer
        overflowed are resolved by the float64 oracle (exact semantics, so
        both rare fixups share one code path; disable with
        ``config.resolve_coplanar=False`` to get the raw flags instead).
        """
        confs = validate_confs(confs)
        n = confs.shape[0]
        block = self.config.batch_block
        valid = np.ones((n,), dtype=bool)
        coplanar = np.zeros((n,), dtype=bool)
        overflow = np.zeros((n,), dtype=bool)
        num_pairs = np.zeros((n,), dtype=np.int32)
        broad_valid = np.ones((n,), dtype=bool)

        for s in range(0, n, block):
            e = min(s + block, n)
            chunk = confs[s:e]
            if chunk.shape[0] < block:
                chunk = np.pad(chunk, ((0, block - chunk.shape[0]), (0, 0)))
            res = self._run_block(jnp.asarray(chunk))
            m = e - s
            valid[s:e] = np.asarray(res.valid)[:m]
            coplanar[s:e] = np.asarray(res.coplanar)[:m]
            overflow[s:e] = np.asarray(res.overflow)[:m]
            num_pairs[s:e] = np.asarray(res.num_pairs)[:m]
            broad_valid[s:e] = np.asarray(res.broad_valid)[:m]

        # Slow-path fixups (both are rare; resolved exactly in float64).
        fixup = np.nonzero(coplanar | overflow)[0]
        if fixup.size and self.config.resolve_coplanar:
            from ..oracle import check_configs

            valid[fixup] = check_configs(self.robot, self.obstacle, confs[fixup])

        if return_result:
            return valid, CheckResult(valid, broad_valid, coplanar, overflow,
                                      num_pairs)
        return valid

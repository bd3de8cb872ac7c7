"""Oversized-mesh support: chunked fused checking + automatic dispatch.

The fused kernel gates each robot tile against every obstacle group at once,
which caps the obstacle at `MAX_OBS_GROUPS` groups (the reference had a
harder wall in constant memory — capacity constants `Utils_rai.h:98-99` —
and simply couldn't load bigger models). Here the wall becomes a split:
either mesh is cut into Morton-ordered triangle chunks, each (robot-chunk x
obstacle-chunk) pair runs the ordinary fused kernel, and verdicts combine
exactly —

    collision(robot, obstacle) == any over chunk pairs of collision(rc, oc)

because triangle sets partition and the tri-tri predicate is per-pair. So
``valid`` ANDs, ``coplanar``/``broad`` OR, ``num_pairs`` sums.

``make_checker`` is the public entry: it returns a plain
:class:`MegaKernelChecker` whenever the obstacle fits the gate and a
:class:`ChunkedMegaKernelChecker` otherwise — any mesh size checks correctly
through one API.
"""
from __future__ import annotations

import numpy as np

from ..core.types import Mesh
from ..utils.morton import morton_argsort
from .megakernel import (MAX_OBS_GROUPS, OBS_TILE, GateWidthError,
                         MegaKernelChecker)

# An obstacle chunk fills the fused kernel's gate exactly. The robot has no
# such limit in the kernel; its chunk size is a plain choice that keeps each
# chunk's box, and so its broad phase, tight.
MAX_ROB_TRIS = 2048
MAX_OBS_TRIS = MAX_OBS_GROUPS * OBS_TILE


def split_mesh(mesh: Mesh, max_tris: int) -> list[Mesh]:
    """Split into Morton-ordered contiguous triangle chunks (spatially tight,
    which keeps each chunk's AABB — and so the broad phase — effective)."""
    t = mesh.num_triangles
    if t <= max_tris:
        return [mesh]
    centroids = mesh.triangle_vertices.mean(axis=1)
    order = morton_argsort(centroids)
    n_chunks = -(-t // max_tris)
    per = -(-t // n_chunks)
    chunks = []
    for k in range(n_chunks):
        idx = order[k * per : (k + 1) * per]
        chunks.append(
            Mesh(mesh.vertices, mesh.triangles[idx],
                 name=f"{mesh.name}[{k}]")
        )
    return chunks


class ChunkedMegaKernelChecker:
    """Fused checking for mesh pairs beyond the single kernel's gate.

    API-compatible with :class:`MegaKernelChecker` (``check``,
    ``check_valid``). Work scaling: each chunk pair's kernel runs its OWN
    broad phase in-kernel, so configurations that miss a chunk's (tight,
    Morton-ordered) AABB cost only that chunk's stage 1 — off-chunk work is
    culled on device, not re-evaluated. ``check_valid(compact=True)``
    additionally compacts host-side with the XLA broad phase before
    dispatch (default off; not yet measured on the GPU, see
    scripts/bench_chunked.py). Verdicts are identical either way (a
    configuration skipped by compaction would have exited at that kernel's
    broad phase).

    Pass ``mesh=`` (a `jax.sharding.Mesh`) to run every chunk pair through
    a batch-sharded :class:`parallel.sharding.ShardedChecker` — oversized
    meshes and multi-chip sharding compose.
    """

    def __init__(self, robot: Mesh, obstacle: Mesh, morton: bool = True,
                 max_rob_tris: int = MAX_ROB_TRIS,
                 max_obs_tris: int = MAX_OBS_TRIS,
                 mesh=None):
        self.robot = robot
        self.obstacle = obstacle
        if mesh is not None:
            from ..parallel.sharding import ShardedChecker

            def build(r, o):
                return ShardedChecker(r, o, mesh=mesh, morton=morton)
        else:
            def build(r, o):
                return MegaKernelChecker(r, o, morton=morton)
        rob_chunks = split_mesh(robot, max_rob_tris)
        obs_chunks = split_mesh(obstacle, max_obs_tris)
        self._n_obs_chunks = len(obs_chunks)
        self.checkers = [
            build(r, o) for r in rob_chunks for o in obs_chunks
        ]

    @property
    def num_chunk_pairs(self) -> int:
        return len(self.checkers)

    def check_valid(self, confs: np.ndarray, chunk: int | None = None,
                    compact: bool = False):
        n = np.asarray(confs).shape[0]
        valid = np.ones((n,), dtype=bool)
        coplanar = np.zeros((n,), dtype=bool)
        if compact:
            # All chunk pairs' broad phases batched: robot bounds once on
            # device, per-box compares on host (one small fetch per robot
            # chunk). See the class docstring for why this is opt-in.
            hits = self._broad_multi(np.asarray(confs, dtype=np.float32))
            for k, ck in enumerate(self.checkers):
                idx = np.nonzero(hits[k])[0]
                if not idx.size:
                    continue
                v, c = ck.check_valid(confs[idx], chunk=chunk)
                valid[idx] &= v
                coplanar[idx] |= c
            return valid, coplanar
        for ck in self.checkers:
            v, c = ck.check_valid(confs, chunk=chunk)
            valid &= v
            coplanar |= c
        return valid, coplanar

    def _broad_multi(self, confs: np.ndarray) -> np.ndarray:
        """[num_chunk_pairs, N] bool: per chunk pair, the conservative XLA
        broad phase (`megakernel._broad_overlap`) — the widened per-config
        robot bounds are computed on device once per distinct ROBOT chunk
        (usually once) and fetched small; the per-obstacle-box interval
        compares run on the host (plain f32 <=, as on the device)."""
        import jax.numpy as jnp

        from .megakernel import _robot_bounds

        out = np.empty((len(self.checkers), confs.shape[0]), dtype=bool)
        # Group checkers sharing a robot chunk. Constructor order is
        # robot-major, so checker i's robot chunk is i // n_obs_chunks
        # (grouping by id(prep.rob_base) never merged: every checker builds
        # its own prep and so its own rob_base array).
        groups: dict[int, list[int]] = {}
        for i in range(len(self.checkers)):
            groups.setdefault(i // self._n_obs_chunks, []).append(i)
        for key in sorted(groups):
            idxs = groups[key]
            ck0 = self.checkers[idxs[0]]
            rb = ck0.prep.rob_base
            pts = rb[0:9].T.reshape(-1, 3)
            lo, hi = _robot_bounds(
                jnp.asarray(confs), jnp.asarray(pts),
                jnp.asarray(np.repeat(rb[9] > 0, 3)),
            )
            lo = np.asarray(lo)
            hi = np.asarray(hi)
            for i in idxs:
                box = self.checkers[i].prep.obs_mesh_aabb[0]
                out[i] = ((lo <= box[3:6]) & (box[0:3] <= hi)).all(axis=1)
        return out

    def check_valid_resolved(self, confs: np.ndarray,
                             chunk: int | None = None) -> np.ndarray:
        """``check_valid`` + float64 resolution of coplanar-flagged
        configurations (see `oracle.resolve_coplanar`), against the FULL
        (unchunked) mesh pair."""
        from ..oracle import resolve_coplanar

        valid, cop = self.check_valid(confs, chunk=chunk)
        return resolve_coplanar(self.robot, self.obstacle, confs, valid, cop)

    def check(self, confs: np.ndarray, two_phase: bool = True):
        valid = None
        coplanar = None
        num_pairs = None
        broad = None
        for ck in self.checkers:
            v, c, p, b = ck.check(confs, two_phase=two_phase)
            valid = v if valid is None else (valid & v)
            coplanar = c if coplanar is None else (coplanar | c)
            num_pairs = p if num_pairs is None else (num_pairs + p)
            broad = b if broad is None else (broad | b)
        return valid, coplanar, num_pairs, broad


def make_checker(robot: Mesh, obstacle: Mesh, morton: bool = True,
                 mesh=None):
    """One checker for any mesh sizes (and optionally any device count):
    fused when the obstacle fits the gate, Morton-chunked-fused otherwise;
    sharded over ``mesh`` (a `jax.sharding.Mesh`) when one is given."""
    try:
        if mesh is not None:
            from ..parallel.sharding import ShardedChecker

            # Probe the gate width first (ShardedChecker builds the same
            # prep), then construct the sharded checker.
            from .megakernel import MegaKernelPrep

            MegaKernelPrep.build(robot, obstacle, morton=morton)
            return ShardedChecker(robot, obstacle, mesh=mesh, morton=morton)
        return MegaKernelChecker(robot, obstacle, morton=morton)
    except GateWidthError:
        return ChunkedMegaKernelChecker(robot, obstacle, morton=morton,
                                        mesh=mesh)

"""Device-resident batched point-to-mesh clearance queries.

The continuous certifier (`planner/ccd.py`) needs, per configuration, the
minimum distance from any posed robot VERTEX to the obstacle surface.  The
native BVH (`native/robocheck_native.cpp:rc_point_mesh_dist`) answers that
exactly on the host, with the device idle.  This module is the
device-resident replacement: the same answer (to a documented,
conservatively-subtracted float32 error bound), produced by batched plain
XLA compute, with the culling the BVH did per point done per (configuration,
vertex-block) pair instead.

Reference anchor: this is the distance half of the FCL oracle API the
reference links but never calls (`/root/reference/Utils.cu:102-161` builds
`fcl::BVHModel` collision objects and only ever invokes `fcl::collide`);
the native BVH twin it accelerates is `robocheck_native.cpp:449-519`.

Design (mirrors the mega-kernel's gate hierarchy, but for distances):

  * Robot vertices are Morton-sorted once per (mesh, refine level) and cut
    into spatially-coherent blocks of 1024; each
    block carries a body-frame AABB.  Posing a block's AABB under (R, t) is
    exact-conservative: center -> R c + t, half-extent -> |R| h.
  * Obstacle triangles are Morton-sorted and grouped (32/group) with static
    group AABBs.  A posed-block/group AABB distance is a true lower bound
    on every vertex-triangle distance in the pair, so
        LB[config, block] = min over groups of boxdist(posed block, group)
    lower-bounds the block's contribution to the answer.
  * Upper bound U[config]: every block's REPRESENTATIVE vertex (its
    first Morton-ordered vertex — an actual surface point) is posed and
    measured exactly against all obstacle triangles in the same dispatch
    that computes LB; U = min over representatives.  U is within one
    block diameter of the true answer at a fraction of a percent of the
    full pair cost, which is what makes the cull bite (the argmin-LB
    block alone proved far too loose: an overlapping AABB whose vertices
    sit units away admitted 82% of all blocks at refine 6).
  * Survivors (LB - err <= best + err) run as padded (config, block) pair
    batches in ASCENDING-LB WAVES: pose 1024 vertices, scan obstacle
    triangles in 128-lane chunks through a branch-free squared
    point-triangle distance (one sqrt per pair at the end), running min;
    after each wave the tightened per-config best re-filters the
    remaining pairs before they ever run.
  * Everything is float32 on device; the reported distance subtracts
    `err_bound` (scale-aware, validated against the native f64 BVH in
    `tests/test_clearance.py` with a >=4x measured margin), so the result
    is a sound LOWER bound — which is the only direction the certificate
    consumes.  The same slack guards the culling threshold, so no pair
    that could hold the true minimum is ever dropped.

Dispatches are issued asynchronously and fetched together, so a
device-to-host round trip is paid once per phase, not once per chunk.
"""
from __future__ import annotations

import math
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Mesh
from ..ops.transform import rotation_matrices
from ..utils.morton import morton_argsort


def _apply_rot(R, v):
    """Rotate [..., 3] vectors by [..., 3, 3] matrices WITHOUT a matmul.

    jnp.einsum lowers 3-wide contractions to dot-general, and default
    matmul precision truncates operands (TF32 on the GPU; a reduced-
    precision dot once gave 0.07 absolute error posing 66-unit
    coordinates — 200x the whole f32 error budget).  Explicit multiply-adds
    stay elementwise at full float32.
    ``R``/``v`` broadcast against each other on leading dims.
    """
    return jnp.sum(R * v[..., None, :], axis=-1)


BLOCK = 1024  # robot vertices per block
TRI_CHUNK = 128  # obstacle triangles per scan step
_F32_EPS = float(np.finfo(np.float32).eps)
# Far-away degenerate sentinel for padded obstacle triangle slots: its
# distance (~1.7e4) can never win a min against real geometry, and — unlike
# a 1e8 sentinel — its barycentric products (~coordinate^4) stay finite in
# float32, so the padded lanes can't poison the min with inf/NaN.
_FAR = 1.0e4


def _point_tri_d2(points, tri):
    """Squared point-to-triangle distances, broadcast over pair dims.

    Identical region classification to `planner/sdf.point_triangle_distance`
    (Ericson 5.1.5, branch-free) but returns |p - q|^2: the per-pair sqrt
    (a transcendental on every lane of the hot loop) moves to one sqrt per
    pair AFTER the min — min over d2 selects the same argmin.
    """
    a = tri[..., 0, :]
    b = tri[..., 1, :]
    c = tri[..., 2, :]
    p = points

    ab = b - a
    ac = c - a
    ap = p - a

    d1 = jnp.sum(ab * ap, axis=-1)
    d2 = jnp.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = jnp.sum(ab * bp, axis=-1)
    d4 = jnp.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = jnp.sum(ab * cp, axis=-1)
    d6 = jnp.sum(ac * cp, axis=-1)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)

    vc = d1 * d4 - d3 * d2
    on_ab = (~in_a) & (~in_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    vb = d5 * d2 - d1 * d6
    on_ac = (~in_a) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    va = d3 * d6 - d5 * d4
    on_bc = (~in_b) & (~in_c) & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    def safe(x, cond):
        return jnp.where(cond, x, 1.0)

    v_ab = d1 / safe(d1 - d3, on_ab)
    v_ac = d2 / safe(d2 - d6, on_ac)
    w_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6), on_bc)

    denom = safe(va + vb + vc, True)
    v_in = vb / denom
    w_in = vc / denom

    q = a + v_in[..., None] * ab + w_in[..., None] * ac
    q = jnp.where(on_bc[..., None], b + w_bc[..., None] * (c - b), q)
    q = jnp.where(on_ac[..., None], a + v_ac[..., None] * ac, q)
    q = jnp.where(on_ab[..., None], a + v_ab[..., None] * ab, q)
    q = jnp.where(in_c[..., None], c, q)
    q = jnp.where(in_b[..., None], b, q)
    q = jnp.where(in_a[..., None], a, q)

    d = p - q
    return jnp.sum(d * d, axis=-1)


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    pad = np.broadcast_to(fill, (n - len(x),) + x.shape[1:])
    return np.concatenate([x, pad], axis=0)


class ClearanceEngine:
    """Batched min-distance queries from a posed robot vertex set to a
    static obstacle mesh, on the accelerator.

    Args:
      robot_vertices: [V,3] body-frame vertex positions (any dtype).
      obstacle: obstacle :class:`Mesh` (static across queries).
      mesh: optional ``jax.sharding.Mesh`` with axis ``"batch"``; when
        given, the exact pair batches are sharded over it (shard_map +
        replicated tables), so certification scales with devices.
      obs_group: obstacle triangles per AABB group (lower-bound granularity).
    """

    def __init__(self, robot_vertices: np.ndarray, obstacle: Mesh,
                 mesh=None, obs_group: int = 32):
        t0 = _time.perf_counter()
        v = np.asarray(robot_vertices, dtype=np.float64)
        # Non-stable argsort: ties in Morton code carry no meaning for
        # blocking, and numpy's stable uint64 argsort is ~4x slower at the
        # refine-7 vertex count (8.1 s vs ~2 s for 8.3M points).
        from ..utils.morton import morton_codes

        order = np.argsort(morton_codes(v))
        v = v[order]
        self.num_vertices = len(v)
        nb = max(1, math.ceil(len(v) / BLOCK))
        vp = _pad_to(v, nb * BLOCK, v[-1]).reshape(nb, BLOCK, 3)
        self.num_blocks = nb
        lo = vp.min(axis=1)
        hi = vp.max(axis=1)
        cent = (lo + hi) / 2.0
        half = (hi - lo) / 2.0
        # float32 conversion of the box must stay conservative: inflate the
        # half-extent by the rounding the center/half conversion can lose.
        infl = np.maximum(np.abs(cent), half) * (4 * _F32_EPS) + 1e-12
        self._bcent = jnp.asarray(cent, dtype=jnp.float32)
        self._bhalf = jnp.asarray(half + infl, dtype=jnp.float32)
        self._blocks = jnp.asarray(vp, dtype=jnp.float32)

        tri = np.asarray(obstacle.triangle_vertices, dtype=np.float64)
        tord = morton_argsort(tri.mean(axis=1))
        tri = tri[tord]
        nt = len(tri)
        ng = max(1, math.ceil(nt / obs_group))
        trig = _pad_to(tri, ng * obs_group, tri[-1]).reshape(
            ng, obs_group, 3, 3)
        glo = trig.reshape(ng, -1, 3).min(axis=1)
        ghi = trig.reshape(ng, -1, 3).max(axis=1)
        ginfl = np.maximum(np.abs(glo), np.abs(ghi)) * (4 * _F32_EPS) + 1e-12
        self._glo = jnp.asarray(glo - ginfl, dtype=jnp.float32)
        self._ghi = jnp.asarray(ghi + ginfl, dtype=jnp.float32)
        self.num_groups = ng

        ntc = max(1, math.ceil(nt / TRI_CHUNK))
        far_tri = np.full((3, 3), _FAR, dtype=np.float64)
        trip = _pad_to(tri, ntc * TRI_CHUNK, far_tri[None][0])
        self._otri = jnp.asarray(
            trip.reshape(ntc, TRI_CHUNK, 3, 3), dtype=jnp.float32)
        self.num_tri_chunks = ntc

        self._obs_scale = float(np.abs(tri).max()) if nt else 1.0
        # Cached for err_bound. The MAX VERTEX 2-NORM, not the max body-
        # frame coordinate: a rotation can align a vertex's norm with one
        # axis, so the posed coordinate bound is ||v||_2 + |t|, and using
        # the per-axis max would understate the scale by up to sqrt(3).
        self._r_max_abs = (float(np.sqrt((v * v).sum(axis=1).max()))
                           if len(v) else 1.0)
        self._mesh = mesh
        self._ndev = 1
        if mesh is not None:
            self._ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

        self._bounds_jit = None
        self._exact_jit = {}
        # Wall-clock accounting (read by certify_multires verbose mode and
        # the bench's clearance leg).
        self.stats = {"construct_s": _time.perf_counter() - t0,
                      "bounds_s": 0.0, "exact_s": 0.0, "pairs": 0,
                      "configs": 0, "calls": 0}

    # -- error model --------------------------------------------------------
    def err_bound(self, confs: np.ndarray) -> float:
        """Conservative absolute float32 error on any distance this engine
        computes for ``confs``.  Scale-aware: proportional to the largest
        coordinate magnitude in the posed scene.  The constant (128 ulp x
        scale) is checked against the native f64 BVH in
        `tests/test_clearance.py` (CPU) and in `chip_smoke.py` (GPU, where
        XLA contracts multiply-adds into FMAs), which prints the largest
        deviation it sees in the same unit."""
        c = np.asarray(confs, dtype=np.float64)
        scale = max(1.0, self._obs_scale,
                    float(np.abs(c[:, 0:3]).max(initial=0.0))
                    + self._r_max_abs)
        return 128.0 * _F32_EPS * scale

    # -- jitted device functions -------------------------------------------
    def _bounds_fn(self):
        """(LB, Drep) for a FIXED-size config chunk: AABB lower bound per
        (config, block) plus each block representative vertex's EXACT
        distance (U = Drep.min seeds the cull; it is an attained vertex
        distance, so it also participates in the final answer).

        One fixed chunk shape -> ONE compile per engine; the caller loops
        chunks on the host, dispatching asynchronously. Mesh tables are
        ARGUMENTS, not closure constants: XLA folds closed-over arrays
        into the executable, and that made compile time scale with mesh
        size (the refine-7 block table is 99 MB)."""
        if self._bounds_jit is not None:
            return self._bounds_jit
        nb = self.num_blocks

        @jax.jit
        def fn(confs, bcent, bhalf, glo, ghi, reps, otri):  # [cc,6] -> 2x[cc,nb]
            Rc = rotation_matrices(confs)
            tc = confs[:, 0:3]
            c = _apply_rot(Rc[:, None], bcent[None]) + tc[:, None, :]
            h = _apply_rot(jnp.abs(Rc)[:, None], bhalf[None])
            blo = (c - h)[:, :, None, :]  # [cc,nb,1,3]
            bhi = (c + h)[:, :, None, :]
            gap = jnp.maximum(glo[None, None] - bhi, 0.0) + jnp.maximum(
                blo - ghi[None, None], 0.0)
            d = jnp.sqrt(jnp.sum(gap * gap, axis=-1))  # [cc,nb,ngo]

            pr = _apply_rot(Rc[:, None], reps[None]) + tc[:, None, :]

            def step(carry, tri_chunk):  # [TRI_CHUNK,3,3]
                d2 = _point_tri_d2(pr[:, :, None, :],
                                   tri_chunk[None, None])
                return jnp.minimum(carry, jnp.min(d2, axis=2)), None

            init = jnp.full((pr.shape[0], nb), jnp.inf, jnp.float32)
            m2, _ = jax.lax.scan(step, init, otri)
            return jnp.min(d, axis=-1), jnp.sqrt(m2)

        self._bounds_jit = fn
        return fn

    def _bounds(self, confs: np.ndarray):
        """Host-chunked async (LB, Drep) over any batch size."""
        b = len(confs)
        # Keep the [cc, nb, max(ngo, TRI_CHUNK)] temporaries around 8 MB.
        cc = max(1, (1 << 21) // max(
            self.num_blocks * max(self.num_groups, TRI_CHUNK), 1))
        fn = self._bounds_fn()
        tables = (self._bcent, self._bhalf, self._glo, self._ghi,
                  self._blocks[:, 0, :], self._otri)
        futs = []
        for lo in range(0, b, cc):
            part = _pad_to(confs[lo:lo + cc], cc, confs[lo])
            futs.append(fn(jnp.asarray(part), *tables))
        lb = np.concatenate(
            [np.asarray(f[0], dtype=np.float64) for f in futs])[:b]
        dr = np.concatenate(
            [np.asarray(f[1], dtype=np.float64) for f in futs])[:b]
        return lb, dr

    def _exact_fn(self, kc: int):
        """[kc] pair batch -> per-pair block min distance."""
        if kc in self._exact_jit:
            return self._exact_jit[kc]
        # Keep the [sub, BLOCK, TRI_CHUNK] temporaries around 16 MB.
        sub = 32
        assert kc % sub == 0

        def pair_mins(confs_sel, block_ids, blocks, otri):  # [k,6],[k]->[k]
            k = confs_sel.shape[0]
            R = rotation_matrices(confs_sel)
            t = confs_sel[:, 0:3]
            bv = jnp.take(blocks, block_ids, axis=0)  # [k,BLOCK,3]
            posed = _apply_rot(R[:, None], bv) + t[:, None, :]

            def body(p):  # [sub,BLOCK,3]
                def step(carry, tri_chunk):  # tri_chunk [TRI_CHUNK,3,3]
                    d2 = _point_tri_d2(
                        p[:, :, None, :], tri_chunk[None, None])
                    return jnp.minimum(carry, jnp.min(d2, axis=2)), None

                init = jnp.full((p.shape[0], BLOCK), jnp.inf,
                                dtype=jnp.float32)
                m2, _ = jax.lax.scan(step, init, otri)
                return jnp.sqrt(jnp.min(m2, axis=1))

            out = jax.lax.map(body, posed.reshape(k // sub, sub, BLOCK, 3))
            return out.reshape(-1)

        if self._mesh is not None:
            from jax.sharding import PartitionSpec as P

            assert kc % (self._ndev * sub) == 0
            axes = tuple(self._mesh.axis_names)
            spec = P(axes[0] if len(axes) == 1 else axes)
            fn = jax.jit(jax.shard_map(
                pair_mins, mesh=self._mesh,
                in_specs=(spec, spec, P(), P()),
                out_specs=spec, check_vma=False))
        else:
            fn = jax.jit(pair_mins)
        self._exact_jit[kc] = fn
        return fn

    # -- host orchestration -------------------------------------------------
    def _pair_chunk(self) -> int:
        # 1024 pairs (~1.1 G pair-distances) per dispatch: large enough to
        # amortize dispatch overhead, small enough that a wave still
        # pipelines several chunks.
        base = 1024
        mult = self._ndev * 32
        return max(base // mult, 1) * mult

    def _run_pairs(self, confs32: np.ndarray, cfg_ids: np.ndarray,
                   blk_ids: np.ndarray, best: np.ndarray) -> None:
        """Exact distances for (config, block) pairs; scatter-min into
        ``best`` (f64, in place).  Async: all chunks dispatched before any
        fetch, so the round trip is paid once."""
        if len(cfg_ids) == 0:
            return
        t0 = _time.perf_counter()
        kc = self._pair_chunk()
        fn = self._exact_fn(kc)
        futs = []
        for lo in range(0, len(cfg_ids), kc):
            ci = cfg_ids[lo:lo + kc]
            bi = blk_ids[lo:lo + kc]
            n = len(ci)
            cs = _pad_to(confs32[ci], kc, confs32[ci[0]])
            bs = _pad_to(bi.astype(np.int32), kc, np.int32(0))
            futs.append((fn(jnp.asarray(cs), jnp.asarray(bs), self._blocks,
                            self._otri), ci, n))
        for fut, ci, n in futs:
            d = np.asarray(fut, dtype=np.float64)[:n]
            np.minimum.at(best, ci, d)
        self.stats["exact_s"] += _time.perf_counter() - t0
        self.stats["pairs"] += len(cfg_ids)

    def min_distances(self, confs: np.ndarray) -> np.ndarray:
        """Per-configuration min distance from any posed robot vertex to the
        obstacle surface, minus :meth:`err_bound` (a sound lower bound).

        Exactness of the culling: a pair is dropped only if
        ``LB - err > U + err``; since true LB >= LB - err and the true
        answer <= true U <= U + err, no dropped pair can hold the minimum.
        """
        confs = np.asarray(confs, dtype=np.float32)
        b = len(confs)
        if b == 0:
            return np.zeros(0, dtype=np.float64)
        self.stats["calls"] += 1
        self.stats["configs"] += b
        err = self.err_bound(confs)
        nb = self.num_blocks
        best = np.full(b, np.inf, dtype=np.float64)

        if nb == 1:
            ids = np.arange(b)
            self._run_pairs(confs, ids, np.zeros(b, np.int64), best)
            return best - err

        # Phase 1: AABB lower bounds + representative-vertex distances
        # (host-chunked, async). best starts at U — attained distances.
        t0 = _time.perf_counter()
        lb, drep = self._bounds(confs)
        np.minimum(best, drep.min(axis=1), out=best)
        self.stats["bounds_s"] += _time.perf_counter() - t0

        # Phase 2: surviving pairs in ascending-LB waves; each wave's
        # results tighten `best`, re-filtering the remainder before it
        # ever runs. Exactness: a pair is dropped only while
        # LB - err > best + err, and best only decreases, so no dropped
        # pair can hold the true minimum (see docstring error argument).
        surv_c, surv_b = np.nonzero(lb - err <= best[:, None] + err)
        order = np.argsort(lb[surv_c, surv_b], kind="stable")
        surv_c, surv_b = surv_c[order], surv_b[order]
        slb = lb[surv_c, surv_b]
        wave = max(2048, 4 * b)
        while len(surv_c):
            self._run_pairs(confs, surv_c[:wave], surv_b[:wave], best)
            surv_c, surv_b, slb = (surv_c[wave:], surv_b[wave:], slb[wave:])
            if len(surv_c):
                keep = slb - err <= best[surv_c] + err
                surv_c, surv_b, slb = surv_c[keep], surv_b[keep], slb[keep]
        return best - err


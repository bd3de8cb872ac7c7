"""Conservative continuous-collision certification (CCD-lite).

Discrete boolean checks along a densified path — the reference's only
notion of edge validation (its PRM assets ship start/goal queries,
`models/alpha1.0/alpha.query:1-2`, but no edge checker at all) — can
tunnel: a long thin robot can pass clean through a wall between two
samples.  This module closes that gap with a *certificate*, not more
samples: between consecutive dense samples it bounds how far any robot
surface point can move and proves the whole swept volume stays clear.

The certificate (all bounds rigorous, conservative in every approximation):

  For the linear-in-configuration motion q(s) = (1-s) q_a + s q_b,
  every robot surface point p (body frame, |p| <= r_max) satisfies

      |p(s) - p(0)| <= s |dt| + theta(s) |p|,   theta(s) <= s * sum|dEuler|

  (angular-velocity integral of the Euler-rate bound; ||R(s)-R(0)||_2 =
  2 sin(theta/2) <= theta).  So the whole motion of every surface point
  stays inside a ball of radius

      delta = |dt| + (|dyaw| + |dpitch| + |droll|) * r_max

  around its start (or, symmetrically, its end) position.  If the robot
  surface's conservative obstacle clearance at q_a (or q_b) exceeds delta,
  no surface point can touch the obstacle during the step; combined with
  boolean validity at the endpoints, the step is certified collision-free
  (collision semantics are surface-intersection, matching the checker).

  Surface clearance at a pose is lower-bounded from three measured pieces:
    * sampled distances: robot VERTICES posed into the world and queried
      against the obstacle distance grid (`planner/sdf.py`);
    * grid error e_g: a trilinear value is a convex combination of node
      distances and true distance is 1-Lipschitz, so
      d_true(x) >= trilinear(x) - cell_diagonal; out-of-domain points use
      dist(x, obstacle AABB) instead (the obstacle is inside its AABB);
    * covering radius r_cov: any surface point lies in some triangle and
      every triangle point is within longest_edge/sqrt(3) of one of its
      vertices (acute: circumradius <= L/sqrt(3); obtuse: L/2 < L/sqrt(3)),
      so  d_true(surface point) >= min_vertex_distance - r_cov.

  Steps that fail the clearance test are SUBDIVIDED (delta halves per
  split while clearance is stable), with boolean checks on inserted
  midpoints; a path certifies iff its true clearance exceeds the method
  floor e_g + r_cov — which `floor()` reports, so an uncertifiable scene
  yields a measured gap statement instead of false confidence.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.types import Mesh
from .sdf import DistanceGrid, build_distance_grid

_SQRT3 = float(np.sqrt(3.0))


def covering_radius(mesh: Mesh) -> float:
    """max over triangles of longest_edge/sqrt(3): every surface point is
    within this distance of some mesh vertex (see module docstring)."""
    tv = mesh.triangle_vertices.astype(np.float64)
    e = np.stack([
        np.linalg.norm(tv[:, 1] - tv[:, 0], axis=1),
        np.linalg.norm(tv[:, 2] - tv[:, 1], axis=1),
        np.linalg.norm(tv[:, 0] - tv[:, 2], axis=1),
    ])
    return float(e.max() / _SQRT3)


# Subdivided meshes are pure functions of (base mesh, levels) and a refine-7
# build touches 16.5M triangles — cache the handful of levels a multires
# certificate walks so the raw and smoothed legs don't rebuild them. Values
# keep the base mesh alive, so the id() key stays valid. A full alpha
# ladder retains ~0.5 GB for the process lifetime; long-lived services
# certifying many DIFFERENT meshes should call
# ``clear_subdivision_cache()`` between workloads.
_SUBDIV_CACHE: dict = {}


def clear_subdivision_cache() -> None:
    """Release all cached subdivided meshes (see _SUBDIV_CACHE note)."""
    _SUBDIV_CACHE.clear()


def subdivide_mesh(mesh: Mesh, levels: int = 1) -> Mesh:
    """Loop-topology 1->4 triangle subdivision (midpoint, no smoothing):
    same surface, 4x triangles per level — shrinks ``covering_radius``
    EXACTLY 2x per level (every child edge is half of a parent edge: the
    medial triangle's edges are parallel halves, corner triangles reuse
    half-edges), tightening the certificate floor at sampling cost.
    Vectorized, with edges deduplicated as scalar int64 codes (np.unique
    on a 1-D array — the axis=0 row-unique this replaces was the dominant
    cost of a refine-7 build)."""
    key = (id(mesh), levels)
    hit = _SUBDIV_CACHE.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if levels > 1:
        # Chain through the cache: a 2->4->6->7 multires ladder then costs
        # one pass up the ladder total, not a from-scratch rebuild per
        # level (refine-7 from scratch is ~27 s of host time).
        prev = subdivide_mesh(mesh, levels - 1)
        out = subdivide_mesh(prev, 1)
        out = Mesh(out.vertices, out.triangles, name=f"{mesh.name}/sub")
        if len(_SUBDIV_CACHE) > 8:
            _SUBDIV_CACHE.clear()
        _SUBDIV_CACHE[key] = (mesh, out)
        return out
    v = mesh.vertices.astype(np.float64)
    f = mesh.triangles.astype(np.int64)
    for _ in range(levels):
        t = len(f)
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        lo = e.min(axis=1)
        hi = e.max(axis=1)
        code = lo * np.int64(len(v) + 1) + hi  # unique scalar per edge
        uniq_code, inv = np.unique(code, return_inverse=True)
        u_lo = uniq_code // np.int64(len(v) + 1)
        u_hi = uniq_code % np.int64(len(v) + 1)
        mid_idx = len(v) + inv  # [3T] midpoint vertex index per edge slot
        v = np.concatenate([v, (v[u_lo] + v[u_hi]) / 2.0])
        ab, bc, ca = mid_idx[:t], mid_idx[t : 2 * t], mid_idx[2 * t :]
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ])
    out = Mesh(v.astype(np.float32), f.astype(np.int32),
               name=f"{mesh.name}/sub")
    if len(_SUBDIV_CACHE) > 8:
        _SUBDIV_CACHE.clear()
    _SUBDIV_CACHE[key] = (mesh, out)
    return out


def subdivide_vertices(mesh: Mesh, levels: int) -> np.ndarray:
    """Vertex array of ``subdivide_mesh(mesh, levels)`` without assembling
    the final level's triangle list (4 x 16.5M rows of int64 at refine 7
    that the exact certifier never reads — it samples VERTICES; its
    covering radius comes from the base mesh's exact per-level halving).
    Chains through the subdivision cache for all but the last level."""
    if levels <= 0:
        return mesh.vertices
    prev = mesh if levels == 1 else subdivide_mesh(mesh, levels - 1)
    v = prev.vertices.astype(np.float64)
    f = prev.triangles.astype(np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    lo = e.min(axis=1)
    hi = e.max(axis=1)
    uniq_code = np.unique(lo * np.int64(len(v) + 1) + hi)
    u_lo = uniq_code // np.int64(len(v) + 1)
    u_hi = uniq_code % np.int64(len(v) + 1)
    return np.concatenate(
        [v, (v[u_lo] + v[u_hi]) / 2.0]).astype(np.float32)


@dataclasses.dataclass
class SweptCertificate:
    """Result of a continuous certification attempt."""

    certified: bool  # whole path proven collision-free (continuous)
    collision: bool  # a boolean check FAILED (path definitely invalid)
    num_checks: int  # exact boolean checks spent
    num_steps: int  # final number of certified steps
    # The proof's worst certifying margin: min over PROVEN steps of the
    # certifying endpoint's conservative surface clearance (lower-bounded
    # distance minus that certifier's r_cov). Every proven step's swept
    # ball fits inside this clearance, so it is a sound lower bound on the
    # clearance the certificate actually relies on. Multi-level runs take
    # the min over levels, each step counted at the level that proved it
    # (no cross-level r_cov mixing). NaN when nothing was proven.
    min_clearance: float
    method_floor: float  # e_g + r_cov: clearances below this can't certify
    uncertified_steps: int  # steps still unproven at max depth
    # Worst conservative surface clearance seen at ANY sampled
    # configuration of this certifier's own level (diagnostic: for an
    # uncertified result this is the measured gap statement — how close to
    # the floor the path actually sits). Multi-level runs report the
    # final-run level's value (coarse levels' hopeless negatives are not
    # meaningful gaps).
    min_seen_clearance: float = float("nan")
    # Final (subdivided) path and per-step proof mask — lets a coarser
    # certifier hand its unproven segments to a finer one (certify_multires).
    path: np.ndarray | None = None
    step_ok: np.ndarray | None = None
    # Which steps were real certification targets (False = junction steps
    # between independently-proven segments in a batched concat path).
    step_real: np.ndarray | None = None


class SweptCertifier:
    """Continuous certification for piecewise-linear configuration paths.

    ``certify(path, checker)`` returns a :class:`SweptCertificate`;
    ``checker`` is any object with ``check_valid_resolved(confs)`` (the
    exact resolved verdict surface). The distance grid is built once per
    obstacle (reusable across paths; pass ``grid=`` to share the
    optimizer's).
    """

    def __init__(self, robot: Mesh, obstacle: Mesh,
                 grid: DistanceGrid | None = None, resolution: int = 96,
                 refine: int = 0, exact: bool = False,
                 backend: str = "device", mesh=None):
        # Exact mode samples vertices only — skip assembling the finest
        # level's triangle list (see subdivide_vertices).
        if refine and exact:
            self.robot = robot
            self._exact_verts = subdivide_vertices(robot, refine)
        else:
            self.robot = subdivide_mesh(robot, refine) if refine else robot
            self._exact_verts = self.robot.vertices
        self.obstacle = obstacle
        self.exact = exact
        self._engine = None
        if refine:
            # Midpoint subdivision halves every edge exactly, so the
            # refined covering radius is the base's / 2^refine. float32
            # vertex storage perturbs each chained level's vertices by an
            # ABSOLUTE ~0.5 ulp of the coordinate magnitude (not a
            # fraction of r_cov), so the inflation has a relative term
            # for the halving arithmetic plus an absolute term of
            # 4 ulp x coordinate scale per stored level.
            coord_scale = float(
                np.abs(robot.vertices.astype(np.float64)).max(initial=1.0))
            f32_eps = float(np.finfo(np.float32).eps)
            self.r_cov = ((covering_radius(robot) / (2.0 ** refine))
                          * (1.0 + 1e-5)
                          + (refine + 1) * 4.0 * f32_eps * coord_scale)
            # Midpoints are convex combinations: the base's max |v| bounds
            # the refined mesh's.
            self.r_max = float(np.linalg.norm(
                robot.vertices.astype(np.float64), axis=1).max())
        else:
            self.r_cov = covering_radius(self.robot)
            self.r_max = float(np.linalg.norm(
                self.robot.vertices.astype(np.float64), axis=1).max())
        if exact and backend == "device":
            # Exact surface distances on the ACCELERATOR
            # (`planner/clearance.py`): batched posed-vertex-block vs
            # obstacle-triangle distance queries with AABB culling. No
            # grid, no interpolation error — the method floor drops to
            # r_cov plus the engine's conservative f32 haircut, which is
            # what makes sub-grid-cell clearances certifiable, without
            # idling the device through its own proof.
            from .clearance import ClearanceEngine

            self.grid = None
            self.e_g = 0.0
            self._engine = ClearanceEngine(
                self._exact_verts, obstacle, mesh=mesh)
        elif exact:
            # Host fallback / cross-check backend: the native BVH
            # point-to-mesh query (`runtime/native.rc_point_mesh_dist`).
            from ..runtime import native as _native

            if not _native.available():
                raise RuntimeError(
                    "exact clearance needs the native library "
                    "(make -C native)")
            if not _native.has_point_mesh_dist():
                raise RuntimeError(
                    "native library is stale (no rc_point_mesh_dist) — "
                    "rebuild with make -C native")
            self.grid = None
            self.e_g = 0.0
            self._native = _native
            self._obs_v = np.ascontiguousarray(
                obstacle.vertices, dtype=np.float64)
            self._obs_t = np.ascontiguousarray(
                obstacle.triangles, dtype=np.int32)
        else:
            self.grid = grid if grid is not None else build_distance_grid(
                obstacle, resolution
            )
            # Conservative trilinear error: full cell diagonal (true
            # distance is 1-Lipschitz; a trilinear value mixes the cell's
            # 8 corner nodes).
            self.e_g = float(np.linalg.norm(np.asarray(self.grid.spacing)))
            # Grid domain for the in-domain test.
            origin = np.asarray(self.grid.origin, dtype=np.float64)
            shape = np.asarray(self.grid.values.shape, dtype=np.float64)
            spacing = np.asarray(self.grid.spacing, dtype=np.float64)
            self._dom_lo = origin
            self._dom_hi = origin + (shape - 1.0) * spacing
        # The refined vertex set every clearance backend samples (for the
        # exact backends this is subdivide_vertices' output; the grid path
        # uses the mesh's own vertices).
        self._verts = jnp.asarray(
            np.asarray(self._exact_verts, dtype=np.float32))
        self._obs_lo = obstacle.aabb[:3].astype(np.float64)
        self._obs_hi = obstacle.aabb[3:].astype(np.float64)

    def floor(self) -> float:
        """Minimum true clearance a path must have anywhere for this
        certifier to succeed (e_g + r_cov). Tighten with a finer grid
        (resolution) and surface refinement (refine)."""
        return self.e_g + self.r_cov

    def step_bounds(self, path: np.ndarray) -> np.ndarray:
        """delta[j]: max surface-point displacement bound for step j."""
        p = path.astype(np.float64)
        dt = np.linalg.norm(p[1:, 0:3] - p[:-1, 0:3], axis=1)
        dang = np.abs(p[1:, 3:6] - p[:-1, 3:6]).sum(axis=1)
        return dt + dang * self.r_max

    def clearances(self, path: np.ndarray, chunk: int = 256) -> np.ndarray:
        """Conservative robot-surface clearance at each configuration:
        min over vertices of (lower-bounded distance) minus r_cov."""
        from ..ops.transform import apply_pose, rotation_matrices

        if self._engine is not None:
            # Device path: per-config min posed-vertex distance, already a
            # sound lower bound (f32 haircut subtracted by the engine).
            return self._engine.min_distances(path) - self.r_cov

        if self.exact:
            out = np.empty(len(path), dtype=np.float64)
            R = np.asarray(rotation_matrices(jnp.asarray(
                np.asarray(path, np.float32))), dtype=np.float64)
            verts = np.asarray(self._verts, dtype=np.float64)
            t = np.asarray(path, np.float64)[:, 0:3]
            # Batch configurations per native call (amortizes call +
            # obstacle-BVH setup) up to ~2M posed points per call.
            vb = max(1, int(2_000_000 // max(len(verts), 1)))
            for lo in range(0, len(path), vb):
                hi = min(lo + vb, len(path))
                pts = np.einsum("bij,vj->bvi", R[lo:hi], verts)
                pts += t[lo:hi, None, :]
                d = self._native.point_mesh_dist(
                    self._obs_v, self._obs_t, pts.reshape(-1, 3))
                out[lo:hi] = d.reshape(hi - lo, len(verts)).min(
                    axis=1) - self.r_cov
            return out

        out = np.empty(len(path), dtype=np.float64)
        for lo in range(0, len(path), chunk):
            part = np.asarray(path[lo : lo + chunk], dtype=np.float32)
            R = rotation_matrices(jnp.asarray(part))  # [B,3,3]
            t = jnp.asarray(part[:, 0:3])
            # apply_pose, NOT einsum: einsum lowers to a bf16-precision
            # dot-general whose ~0.07-unit posing error is NOT covered by
            # e_g (which only bounds interpolation error).
            pts = apply_pose(R, t, self._verts)
            tril = np.asarray(self.grid.query(pts), dtype=np.float64)
            p_np = np.asarray(pts, dtype=np.float64)
            in_dom = np.logical_and(
                (p_np >= self._dom_lo).all(-1), (p_np <= self._dom_hi).all(-1)
            )
            # Out-of-domain points: the obstacle is inside its AABB, so the
            # distance to the AABB is a true lower bound.
            gap = np.maximum(self._obs_lo - p_np, 0.0) + np.maximum(
                p_np - self._obs_hi, 0.0
            )
            d_aabb = np.linalg.norm(gap, axis=-1)
            d_low = np.where(in_dom, tril - self.e_g, d_aabb)
            out[lo : lo + len(part)] = d_low.min(axis=1) - self.r_cov
        return out

    def certify(self, path: np.ndarray, checker, max_depth: int = 8,
                step_mask: np.ndarray | None = None) -> SweptCertificate:
        """Prove (or refute, or give up with a measured gap) that the
        piecewise-linear path is collision-free CONTINUOUSLY.

        The path's own vertices are boolean-checked here too, so callers
        can pass any piecewise-linear path (waypoints or densified).

        ``step_mask`` (bool, ``len(path)-1``) marks which steps are real
        certification targets; ``False`` steps are junctions between
        independent segments concatenated into one call (certify_multires
        batches a whole level's segments this way, so every clearance and
        boolean query is ONE batched dispatch rather than a per-segment
        host loop) — junction steps are never tested, subdivided, frozen,
        or reported."""
        path = np.asarray(path, dtype=np.float32)
        real = (np.ones(max(len(path) - 1, 0), dtype=bool)
                if step_mask is None
                else np.asarray(step_mask, dtype=bool).copy())
        valid = np.asarray(checker.check_valid_resolved(path), dtype=bool)
        num_checks = len(path)
        if not valid.all():
            return SweptCertificate(False, True, num_checks, len(path) - 1,
                                    float("nan"), self.floor(), 0)
        clear = self.clearances(path)
        min_seen = float(clear.min())

        def proven_margin(pairmax, proven):
            vals = pairmax[proven]
            return float(vals.min()) if len(vals) else float("nan")

        for _ in range(max_depth):
            delta = self.step_bounds(path)
            # A step certifies from EITHER endpoint's clearance ball.
            pairmax = np.maximum(clear[:-1], clear[1:])
            ok = (pairmax > delta) | ~real
            if ok.all():
                return SweptCertificate(True, False, num_checks,
                                        int(real.sum()),
                                        proven_margin(pairmax, real),
                                        self.floor(), 0,
                                        min_seen_clearance=min_seen)
            # HOPELESS steps — conservative clearance <= 0 at both
            # endpoints — can never certify at THIS sampling level no
            # matter how small delta gets; splitting them doubles work
            # every round for nothing (measured: it turned a multires
            # level into hours). Freeze them as unproven; a finer level
            # (smaller r_cov) re-examines them via certify_multires.
            frozen = (pairmax <= 0.0) & real
            if (ok | frozen).all():
                break
            # Subdivide the remaining failing steps: insert midpoints,
            # boolean-check them, recompute their clearances only.
            bad = np.nonzero(~ok & ~frozen)[0]
            mids = 0.5 * (path[bad].astype(np.float64)
                          + path[bad + 1].astype(np.float64))
            mids = mids.astype(np.float32)
            mvalid = np.asarray(checker.check_valid_resolved(mids),
                                dtype=bool)
            num_checks += len(mids)
            if not mvalid.all():
                return SweptCertificate(False, True, num_checks,
                                        len(path) - 1, float("nan"),
                                        self.floor(), 0)
            mclear = self.clearances(mids)
            min_seen = min(min_seen, float(mclear.min()))
            new_path = np.empty((len(path) + len(bad), 6), dtype=np.float32)
            new_clear = np.empty(len(path) + len(bad), dtype=np.float64)
            ins = bad + 1 + np.arange(len(bad))
            keep = np.setdiff1d(np.arange(len(new_path)), ins)
            new_path[keep] = path
            new_clear[keep] = clear
            new_path[ins] = mids
            new_clear[ins] = mclear
            # A split step becomes two steps, both real; junction steps
            # are never bad, so the mask just stretches over insertions.
            counts = np.ones(len(real), dtype=np.int64)
            counts[bad] = 2
            real = np.repeat(real, counts)
            path, clear = new_path, new_clear
        delta = self.step_bounds(path)
        pairmax = np.maximum(clear[:-1], clear[1:])
        ok = (pairmax > delta) | ~real
        return SweptCertificate(bool(ok.all()), False, num_checks,
                                int(real.sum()),
                                proven_margin(pairmax, ok & real),
                                self.floor(), int((~ok).sum()), path=path,
                                step_ok=ok, step_real=real,
                                min_seen_clearance=min_seen)


def certify_multires(robot: Mesh, obstacle: Mesh, path: np.ndarray,
                     checker, levels=((0, 8), (2, 8), (4, 8), (7, 10)),
                     verbose: bool = False, backend: str = "device",
                     mesh=None, prefetch: bool = True) -> SweptCertificate:
    """Multi-resolution continuous certification: each level is a
    ``(refine, max_depth)`` pair using EXACT surface distances (floor =
    covering radius alone; backend "device" = the device clearance engine,
    "native" = the host BVH cross-check path). Cheap levels certify
    everything their floor allows; only the still-unproven SEGMENTS
    escalate to the next (4x-more-samples) level — this is what makes
    razor-thin passages affordable: refine-7 clearance queries (8M surface
    samples) run only where refine-4 could not decide.

    A level's surviving segments are certified in ONE batched `certify`
    call (concatenated path + junction step mask), so all their boolean
    checks and clearance queries land on the device as whole-level batches
    — the round-4 per-segment host loop serialized exactly the part of the
    proof that is embarrassingly parallel. Pass ``mesh=`` (a jax Mesh) to
    shard those batches across devices.

    With ``prefetch`` (default), the NEXT level's certifier — mesh
    subdivision, Morton blocking, table upload, the expensive host half of
    a refine-7 level — is built on a worker thread while the current
    level's certification runs on the device, hiding ~1/3 of the alpha
    proof's wall clock. The build is speculative: if the current level
    proves everything, the in-flight build finishes in the background
    (its subdivision cache entries still help later calls).

    Returns a certificate with totals aggregated across levels;
    ``min_clearance`` is the min over levels of each level's own
    conservative surface clearance (no cross-level r_cov mixing).
    Short-circuits on any refutation (collision=True).
    """
    import time as _time

    total_checks = 0
    min_clear = float("inf")
    segments = [np.asarray(path, np.float32)]
    last_floor = float("nan")
    last_seen = float("nan")
    pool = None
    nxt = None
    if prefetch and len(levels) > 1:
        import concurrent.futures as _cf

        pool = _cf.ThreadPoolExecutor(max_workers=1)

    def _build(refine):
        return SweptCertifier(robot, obstacle, refine=refine, exact=True,
                              backend=backend, mesh=mesh)

    try:
        for li, (refine, max_depth) in enumerate(levels):
            t_level = _time.perf_counter()
            if nxt is not None:
                cert = nxt.result()
            else:
                cert = _build(refine)
            nxt = (pool.submit(_build, levels[li + 1][0])
                   if pool is not None and li + 1 < len(levels) else None)
            t_built = _time.perf_counter() - t_level
            last_floor = cert.floor()
            # One batched call for the whole level: concatenate segments and
            # mask out the junction steps between them.
            concat = np.concatenate(segments, axis=0)
            real = np.ones(max(len(concat) - 1, 0), dtype=bool)
            off = 0
            for seg in segments[:-1]:
                off += len(seg)
                real[off - 1] = False
            res = cert.certify(concat, checker, max_depth=max_depth,
                               step_mask=real)
            total_checks += res.num_checks
            if np.isfinite(res.min_clearance):
                min_clear = min(min_clear, res.min_clearance)
            mc = min_clear if np.isfinite(min_clear) else float("nan")

            def _report(tag):
                if not verbose:
                    return
                eng = getattr(cert, "_engine", None)
                es = (", engine[" + ", ".join(
                    f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in eng.stats.items()) + "]"
                    if eng is not None else "")
                print(f"  level {li} (refine={refine}, floor="
                      f"{cert.floor():.3f}): {tag}, {total_checks} checks so "
                      f"far, {_time.perf_counter() - t_level:.1f}s "
                      f"(build {t_built:.1f}s){es}", flush=True)

            if res.collision:
                _report("REFUTED")
                return SweptCertificate(False, True, total_checks, 0,
                                        float("nan"), cert.floor(), 0)
            if res.certified:
                _report("all segments certified")
                return SweptCertificate(
                    True, False, total_checks, len(path) - 1, mc, cert.floor(),
                    0, min_seen_clearance=res.min_seen_clearance)
            # Merge adjacent unproven real steps into contiguous segments for
            # the next level (junction steps are never unproven-real, so runs
            # cannot bleed across segment boundaries).
            p, ok, rl = res.path, res.step_ok, res.step_real
            bad = np.nonzero(~ok & rl)[0]
            next_segments = []
            start = None
            for b in bad:
                if start is None:
                    start = end = b
                elif b == end + 1:
                    end = b
                else:
                    next_segments.append(p[start : end + 2])
                    start = end = b
            if start is not None:
                next_segments.append(p[start : end + 2])
            _report(f"{len(next_segments)} unproven segment(s) remain")
            segments = next_segments
            if not segments:
                return SweptCertificate(
                    True, False, total_checks, len(path) - 1, mc, cert.floor(),
                    0, min_seen_clearance=res.min_seen_clearance)
            last_seen = res.min_seen_clearance

    finally:
        if pool is not None:
            # Never join a speculative build from the hot path; threads
            # finish in the background (subdiv cache entries persist).
            pool.shutdown(wait=False)
    return SweptCertificate(
        False, False, total_checks, len(path) - 1,
        min_clear if np.isfinite(min_clear) else float("nan"), last_floor,
        sum(len(s) - 1 for s in segments), min_seen_clearance=last_seen)

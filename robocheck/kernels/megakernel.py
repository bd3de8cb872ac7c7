"""The fused collision kernel (Pallas, Triton route, for the GPU).

A redesign for the GPU of the reference's best configuration, the fused
`MegaKernel` (`test/MegaKernel.cu:113-384`: one launch does transform, AABB
broad phase, mini-AABB culling and tri-tri tests, one block working through
its poses one at a time and stopping each pose at its first hit). Each
program of the grid takes one pose:

  stage 1  mesh AABB broad phase: the robot's corners are posed in chunks
           and reduced to one box, compared with the obstacle's
           (`broadPhaseFusedKernel_sep`, `broad-phase-fused.cu:157-207`;
           the operation order of `_posed_bounds`, whose widened XLA boxes
           never miss where this stage hits). A miss ends the pose.
  stage 2  gated tile sweep: robot tiles of ``rob_tile`` triangles are posed
           again (9 FMAs per corner, cheaper than keeping them anywhere) and
           gated against the obstacle's groups of ``obs_tile`` triangles: a
           group is visited only if some robot triangle box touches its box.
           A `while_loop` walks the gated groups in Morton order and stops at
           the pose's first hit (the warp-cooperative ``valid[ty]`` exit of
           `narrow-phase.cu:601-607`).
  stage 3  inside a visited [rob_tile x obs_tile] pair tile: the mini-AABB
           pair mask, then the plane-separation stage only if the mask is
           non-empty, then the interval stage only if some masked pair
           straddles both planes — each an exact short-circuit.

Data layout (host-prepared by `MegaKernelPrep`), one field per row so every
load is a contiguous power-of-two vector:
  * robot base corners   rob [16, Tr]: rows 0-8 = c0x,c0y,c0z,...,c2z; row 9
                         = 1.0 for real triangles, 0.0 for padding.
  * obstacle fields      obs [32, To]: rows 0-8 corners, 9-12 plane
                         (nx,ny,nz,d), 13-18 AABB (lo,hi); padding boxes are
                         (+inf,-inf) so padded triangles never pass a mask.
  * obstacle group boxes grp [8, G]: rows 0-2 lo, 3-5 hi per group of
                         ``obs_tile`` triangles; G is a power of two, the
                         groups past the mesh hold empty boxes.
  * poses [B, 16]: r00,r01,r02,tx, r10,...,ty, r20,...,tz (built by XLA).

Division uses ``div.rn.f32`` (IEEE round-to-nearest) through inline PTX:
Triton's own float division is the approximate ``div.full.f32``, which would
move pairs on the TOL edges of the interval and coplanarity tests.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..core.constants import TOL, round_up
from ..core.types import Mesh, validate_confs
from ..ops.transform import rotation_matrices
from ..runtime.device import pallas_interpret
from ..utils.morton import morton_argsort

# Robot rows ([16, Tr]).
_R_VALID = 9
_R_ROWS = 16

# Obstacle rows ([32, To]).
_O_C = 0
_O_N = 9
_O_D = 12
_O_LO = 13
_O_HI = 16
_O_ROWS = 32

# Tile sizes (powers of two: Triton blocks must be). A [rob_tile x obs_tile]
# f32 pair tile is held in registers across ~20 live fields, so tiles are
# small, and small robot tiles gate tightly: 8 x 32 with 4 warps was the
# fastest of the sizes swept on an H100 (PERF.md). The stage-1 broad phase
# poses the robot in wider chunks.
ROB_TILE = 8
OBS_TILE = 32
BROAD_CHUNK = 128
NUM_WARPS = 4

# Callers pad batches to a multiple of this so few shapes compile.
BATCH_MULTIPLE = 32

# The stage-2 gate compares each robot tile against every obstacle group at
# once ([rob_tile x G] in registers), which bounds the obstacle this kernel
# takes: at most MAX_OBS_GROUPS groups, i.e. MAX_OBS_GROUPS * obs_tile
# triangles. Larger obstacles are split by `kernels.chunked.make_checker`.
MAX_OBS_GROUPS = 128


class GateWidthError(ValueError):
    """Obstacle needs more gate groups than the fused kernel holds.

    Raised by :meth:`MegaKernelPrep.build`; `kernels.chunked.make_checker`
    catches exactly this to dispatch to the Morton-chunked checker (other
    ``ValueError``s — malformed meshes etc. — propagate)."""


def _iszero(v):
    return jnp.abs(v) < TOL


def _true_div(a, b):
    return a / b


def _div_rn(a, b):
    """IEEE f32 division on the GPU (Triton's ``/`` is approximate)."""
    a, b = jnp.broadcast_arrays(jnp.asarray(a, jnp.float32),
                                jnp.asarray(b, jnp.float32))
    return pltriton.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape,
                                                          jnp.float32)],
    )[0]


def _any(x):
    """any() over a boolean array as a max of ints (the Triton lowering has
    no boolean reductions)."""
    return jnp.max(x.astype(jnp.int32)) > 0


def _isclose(v1, v2, div=_true_div):
    a1 = jnp.abs(v1)
    a2 = jnp.abs(v2)
    both = (a1 < TOL) & (a2 < TOL)
    one = (a1 < TOL) | (a2 < TOL)
    rel = jnp.abs(div(v1 - v2, jnp.where(a1 < TOL, 1.0, v1))) < TOL
    # both -> True; exactly one small -> False; else rel.
    return both | (~one & rel)


def _tile_planes(rob, obs):
    """Cheap first stage of the Moller test on one pair tile: signed corner
    distances against the opposite plane and the plane separation tests
    (`compute_signed_dists`/`no_overlap`, `narrow-phase.cu:78-106`). A pair
    with either plane separating cannot collide and cannot be live-coplanar,
    so tiles where `live` is empty can skip `_tile_moller_rest` entirely —
    an exact short-circuit.

    Returns (dist_o, dist_r, live) where live = ~sep_o & ~sep_r.
    """
    nrx, nry, nrz, dr = rob["nx"], rob["ny"], rob["nz"], rob["d"]
    nox, noy, noz, do = obs["nx"], obs["ny"], obs["nz"], obs["d"]

    dist_o = [
        nrx * obs[f"c{c}x"] + nry * obs[f"c{c}y"] + nrz * obs[f"c{c}z"] + dr
        for c in range(3)
    ]
    dist_r = [
        nox * rob[f"c{c}x"] + noy * rob[f"c{c}y"] + noz * rob[f"c{c}z"] + do
        for c in range(3)
    ]

    def _no_overlap(d3):
        gz = (d3[0] >= TOL) | (d3[1] >= TOL) | (d3[2] >= TOL)
        lz = (d3[0] <= -TOL) | (d3[1] <= -TOL) | (d3[2] <= -TOL)
        return ~(gz & lz)

    live = ~_no_overlap(dist_o) & ~_no_overlap(dist_r)
    return dist_o, dist_r, live


def _moller_interval_parts(rob, obs, dist_o, dist_r, live, div=_true_div):
    """Vector core of the Moller interval stage on one pair block: interval
    separation plus the conservative coplanarity precheck, NO reductions and
    NO control flow — per-pair boolean arrays only.

    Returns (isect_raw, maybe_cop): isect_raw = live pairs whose projected
    intervals overlap (a hit unless the pair is ratio-coplanar); maybe_cop =
    live pairs where the conservative necessary condition for ratio
    coplanarity fires (the exact component-ratio test is only needed — and
    only run by callers — when some maybe_cop pair exists, which on real
    data is ~never).
    """
    nrx, nry, nrz, dr = rob["nx"], rob["ny"], rob["nz"], rob["d"]
    nox, noy, noz, do = obs["nx"], obs["ny"], obs["nz"], obs["d"]

    # Intersection-line DIRECTION only (origin-free projections: a shared
    # line origin shifts both triangles' interval endpoints equally and
    # cancels in the >= comparisons — Moller'97's optimized form. The
    # reference solves 2x2 systems for the origin, `narrow-phase.cu:127-154`;
    # dropping them removes ~60 operations and 12 of 24 divides from the
    # hot stage). The cross-product terms are kept separate: the
    # coplanarity precheck reuses them.
    axx, bxx = nry * noz, nrz * noy
    axy, bxy = nrz * nox, nrx * noz
    axz, bxz = nrx * noy, nry * nox
    Dx = axx - bxx
    Dy = axy - bxy
    Dz = axz - bxz

    # Projections of all six corners onto the line.
    def proj(side):
        return [
            Dx * side[f"c{c}x"]
            + Dy * side[f"c{c}y"]
            + Dz * side[f"c{c}z"]
            for c in range(3)
        ]

    p_r = proj(rob)
    p_o = proj(obs)

    def interval(p, d3):
        d0, d1, d2 = d3
        c01 = ((d0 > 0) & (d1 > 0)) | ((d0 < 0) & (d1 < 0))
        c02 = ((d0 > 0) & (d2 > 0)) | ((d0 < 0) & (d2 < 0))
        # canonical permutations: c01 -> (0,2,1); c02 -> (0,1,2); else (1,0,2)
        q0 = jnp.where(c01, p[0], jnp.where(c02, p[0], p[1]))
        q1 = jnp.where(c01, p[2], jnp.where(c02, p[1], p[0]))
        q2 = jnp.where(c01, p[1], jnp.where(c02, p[2], p[2]))
        e0 = jnp.where(c01, d0, jnp.where(c02, d0, d1))
        e1 = jnp.where(c01, d2, jnp.where(c02, d1, d0))
        e2 = jnp.where(c01, d1, jnp.where(c02, d2, d2))

        def pvar(pa, pb, da, db):
            dd = da - db
            dd = jnp.where(dd == 0.0, 1.0, dd)
            return pa + (pb - pa) * div(da, dd)

        t01 = pvar(q0, q1, e0, e1)
        t12 = pvar(q1, q2, e1, e2)
        return jnp.minimum(t01, t12), jnp.maximum(t01, t12)

    min_r, max_r = interval(p_r, dist_r)
    min_o, max_o = interval(p_o, dist_o)
    separated_t = (min_r >= max_o) | (min_o >= max_r)
    isect_raw = ~separated_t & live

    # Conservative coplanarity precheck: ratio-coplanar (all nonzero
    # component ratios within TOL=1e-6 of each other) forces each |D|
    # component below ~1e-6x the magnitude of its two cross terms — unless a
    # component pair is inside the |.|<TOL zero band on BOTH sides, in which
    # case that axis is excused (the ratio test skips it too). The bound
    # here uses 1e-3, three orders of magnitude of headroom over the exact
    # bound plus f32 evaluation noise (~6e-8 relative), so precheck=False
    # PROVES no live pair can be ratio-coplanar and the full component-ratio
    # block (8 divides) is skipped. Mismatched zero patterns are
    # non-coplanar by definition and need no excuse.
    B = jnp.float32(1.0e-3)
    bs_x = _iszero(nrx) & _iszero(nox)
    bs_y = _iszero(nry) & _iszero(noy)
    bs_z = _iszero(nrz) & _iszero(noz)
    okx = (jnp.abs(Dx) <= B * (jnp.abs(axx) + jnp.abs(bxx))) | bs_y | bs_z
    oky = (jnp.abs(Dy) <= B * (jnp.abs(axy) + jnp.abs(bxy))) | bs_z | bs_x
    okz = (jnp.abs(Dz) <= B * (jnp.abs(axz) + jnp.abs(bxz))) | bs_x | bs_y
    maybe_cop = okx & oky & okz & live

    # Second branch of the ratio test's truth table: when EVERY valid
    # component ratio |nr/no| is itself below TOL (~6 orders of mesh-scale
    # mismatch between the two triangles), `_isclose`'s both-small case
    # declares the ratios equal and the full test flags coplanar even
    # though the planes are nowhere near parallel — the |D| bound above
    # does not cover that. Detect it directly: each of the four components
    # either sits in the shared zero band or is valid with
    # |nr| <= 2*TOL*|no| (factor-2 headroom over the f32 divide noise in
    # the exact |nr/no| < TOL threshold); mismatched zero patterns make
    # the component non-coplanar and correctly fail both branches.
    T2 = jnp.float32(2.0 * TOL)

    def _sub_ratio(a, b):
        za = _iszero(a)
        zb = _iszero(b)
        return (za & zb) | (~za & ~zb & (jnp.abs(a) <= T2 * jnp.abs(b)))

    maybe_cop = maybe_cop | (
        _sub_ratio(nrx, nox) & _sub_ratio(nry, noy) & _sub_ratio(nrz, noz)
        & _sub_ratio(dr, do) & live
    )
    return isect_raw, maybe_cop


def _tile_moller_rest(rob, obs, dist_o, dist_r, live, hit, cop,
                      div=_true_div):
    """Expensive remainder of the Moller test: interval overlap plus the
    (rare) coplanarity resolution, on one pair tile. Only pairs where
    `_tile_planes` reported live matter; ``live`` must already include the
    mini-AABB mask.

    Returns scalar (hit', cop') carries: hit' = hit OR some live pair
    intersects; cop' = cop OR some live pair is flagged coplanar. Combined
    semantics are identical to `ops.narrow.pair_intersects` (same FP
    operation order); the ~45-op/8-divide component-ratio block runs only
    when the conservative `maybe_cop` precheck fires on some live pair.
    """
    isect_raw, maybe_cop = _moller_interval_parts(rob, obs, dist_o, dist_r,
                                                  live, div)
    nrx, nry, nrz, dr = rob["nx"], rob["ny"], rob["nz"], rob["d"]
    nox, noy, noz, do = obs["nx"], obs["ny"], obs["nz"], obs["d"]

    def with_cop(c):
        h, cp = c
        # Component-ratio test against the first usable component
        # (`narrow-phase.cu:253-294` semantics).
        comps = [(nrx, nox), (nry, noy), (nrz, noz), (dr, do)]
        z1 = [_iszero(a) for a, _ in comps]
        z2 = [_iszero(b) for _, b in comps]
        mismatch = (z1[0] ^ z2[0]) | (z1[1] ^ z2[1]) | (z1[2] ^ z2[2]) | (
            z1[3] ^ z2[3])
        valid = [~za & ~zb for za, zb in zip(z1, z2)]
        ratios = [div(a, jnp.where(v, b, 1.0))
                  for (a, b), v in zip(comps, valid)]
        ratio0 = jnp.where(
            valid[0], ratios[0],
            jnp.where(valid[1], ratios[1],
                      jnp.where(valid[2], ratios[2], ratios[3])),
        )
        ok = ~mismatch
        for v, r in zip(valid, ratios):
            ok &= ~v | _isclose(ratio0, r, div)
        coplanar = ok
        return (h | _any(isect_raw & ~coplanar),
                cp | _any(coplanar & live))

    def no_cop(c):
        h, cp = c
        return (h | _any(isect_raw), cp)

    return jax.lax.cond(_any(maybe_cop), with_cop, no_cop, (hit, cop))


def _posed_corners(pose, rob_ref, off, n):
    """Nine [n] arrays c0x..c2z: robot triangles off..off+n posed, in the
    operation order of `_posed_bounds` (x*r0 + y*r1 + z*r2 + t)."""
    out = []
    for c in range(3):
        x = rob_ref[3 * c + 0, pl.ds(off, n)]
        y = rob_ref[3 * c + 1, pl.ds(off, n)]
        z = rob_ref[3 * c + 2, pl.ds(off, n)]
        for k in range(3):
            r = pose[4 * k : 4 * k + 4]
            out.append(x * r[0] + y * r[1] + z * r[2] + r[3])
    return out


def _boxes(corners):
    """Per-triangle AABB (lo[3], hi[3]) of nine posed corner arrays."""
    c0, c1, c2 = corners[0:3], corners[3:6], corners[6:9]
    lo = [jnp.minimum(jnp.minimum(c0[k], c1[k]), c2[k]) for k in range(3)]
    hi = [jnp.maximum(jnp.maximum(c0[k], c1[k]), c2[k]) for k in range(3)]
    return lo, hi


def _kernel(pose_ref, obs_mesh_ref, grp_ref, rob_ref, obs_ref, out_ref, *,
            rob_tile, obs_tile, div):
    num_groups = grp_ref.shape[1]
    tr = rob_ref.shape[1]
    num_rob_tiles = tr // rob_tile
    broad_chunk = BROAD_CHUNK
    # Loop and branch carries start from traced values: the Triton lowering
    # passes literal constants to scf.for/scf.if as Python numbers, which
    # those ops cannot yield.
    i0 = pl.program_id(0) * 0
    f0 = i0 != 0
    big = i0.astype(jnp.float32) + 3.0e38

    pose = [pose_ref[0, k] for k in range(12)]

    # ---- Stage 1: mesh AABB broad phase. ----
    def s1(ci, box):
        off = pl.multiple_of(ci * broad_chunk, broad_chunk)
        lo, hi = _boxes(_posed_corners(pose, rob_ref, off, broad_chunk))
        valid = rob_ref[_R_VALID, pl.ds(off, broad_chunk)] > 0.0
        return tuple(
            [jnp.minimum(box[k], jnp.min(jnp.where(valid, lo[k], big)))
             for k in range(3)]
            + [jnp.maximum(box[3 + k],
                           jnp.max(jnp.where(valid, hi[k], -big)))
               for k in range(3)])

    box = jax.lax.fori_loop(0, tr // broad_chunk, s1,
                            (big,) * 3 + (-big,) * 3)
    broad = (box[0] <= obs_mesh_ref[0, 3]) & (obs_mesh_ref[0, 0] <= box[3])
    for k in (1, 2):
        broad &= (box[k] <= obs_mesh_ref[0, 3 + k]) & (
            obs_mesh_ref[0, k] <= box[3 + k])

    # ---- Stage 2: gated tile sweep, any-hit exit. ----
    # Carry: hit, coplanar, pairs, mask tiles, visited tiles, interval
    # tiles.
    zero = (f0, f0, i0, i0, i0, i0)
    giota = jax.lax.broadcasted_iota(jnp.int32, (num_groups,), 0)
    g_lo = [grp_ref[k, :] for k in range(3)]
    g_hi = [grp_ref[3 + k, :] for k in range(3)]

    def rob_tile_body(state):
        i, carry = state
        off = pl.multiple_of(i * rob_tile, rob_tile)
        corners = _posed_corners(pose, rob_ref, off, rob_tile)
        r_lo, r_hi = _boxes(corners)
        valid = rob_ref[_R_VALID, pl.ds(off, rob_tile)] > 0.0
        touch = valid[:, None]
        for k in range(3):
            touch &= (r_lo[k][:, None] <= g_hi[k][None, :]) & (
                g_lo[k][None, :] <= r_hi[k][:, None])
        gate = jnp.max(touch.astype(jnp.int32), axis=0) > 0  # [G]

        def next_group(after):
            return jnp.min(jnp.where(gate & (giota > after), giota,
                                     num_groups))

        def sweep(carry):
            c0, c1, c2 = corners[0:3], corners[3:6], corners[6:9]
            e1 = [c1[k] - c0[k] for k in range(3)]
            e2 = [c2[k] - c1[k] for k in range(3)]
            nx = e1[1] * e2[2] - e1[2] * e2[1]
            ny = e1[2] * e2[0] - e1[0] * e2[2]
            nz = e1[0] * e2[1] - e1[1] * e2[0]
            d = -(nx * c0[0] + ny * c0[1] + nz * c0[2])
            rob = {"nx": nx[:, None], "ny": ny[:, None],
                   "nz": nz[:, None], "d": d[:, None]}
            for c in range(3):
                for k, ax in enumerate("xyz"):
                    rob[f"c{c}{ax}"] = corners[3 * c + k][:, None]

            def tile(j, carry):
                hit, cop, npairs, nmask, nvisit, nrest = carry
                ooff = pl.multiple_of(j * obs_tile, obs_tile)

                def orow(r):
                    return obs_ref[r, pl.ds(ooff, obs_tile)][None, :]

                mask = valid[:, None]
                for k in range(3):
                    mask &= (r_lo[k][:, None] <= orow(_O_HI + k)) & (
                        orow(_O_LO + k) <= r_hi[k][:, None])
                count = jnp.sum(mask.astype(jnp.int32))

                def planes(c):
                    hit, cop, npairs, nmask, nvisit, nrest = c
                    obs = {"nx": orow(_O_N), "ny": orow(_O_N + 1),
                           "nz": orow(_O_N + 2), "d": orow(_O_D)}
                    for cc in range(3):
                        for k, ax in enumerate("xyz"):
                            obs[f"c{cc}{ax}"] = orow(_O_C + 3 * cc + k)
                    dist_o, dist_r, live = _tile_planes(rob, obs)
                    live &= mask

                    def rest(c5):
                        h, cp, nr = c5
                        h, cp = _tile_moller_rest(rob, obs, dist_o,
                                                  dist_r, live, h, cp,
                                                  div=div)
                        return h, cp, nr + 1

                    hit, cop, nrest = jax.lax.cond(
                        _any(live), rest, lambda c5: c5,
                        (hit, cop, nrest))
                    return hit, cop, npairs, nmask + 1, nvisit, nrest

                return jax.lax.cond(
                    count > 0, planes, lambda c: c,
                    (hit, cop, npairs + count, nmask, nvisit + 1, nrest))

            def g_cond(s):
                j, c = s
                return (j < num_groups) & jnp.logical_not(c[0])

            def g_body(s):
                j, c = s
                return next_group(j), tile(j, c)

            _, carry = jax.lax.while_loop(g_cond, g_body,
                                          (next_group(-1), carry))
            return carry

        carry = jax.lax.cond(_any(gate), sweep, lambda c: c, carry)
        return i + 1, carry

    def rob_cond(state):
        i, c = state
        return (i < num_rob_tiles) & jnp.logical_not(c[0])

    def run(c):
        return jax.lax.while_loop(rob_cond, rob_tile_body,
                                  (jnp.int32(0), c))[1]

    hit, cop, npairs, nmask, nvisit, nrest = jax.lax.cond(
        broad, run, lambda c: c, zero)

    col = jax.lax.broadcasted_iota(jnp.int32, (OUT_COLS,), 0)
    out = jnp.where(col == 0, jnp.logical_not(hit).astype(jnp.int32), 0)
    out = jnp.where(col == 1, cop.astype(jnp.int32), out)
    out = jnp.where(col == 2, npairs, out)
    out = jnp.where(col == 3, broad.astype(jnp.int32), out)
    out = jnp.where(col == 4, nmask, out)
    out = jnp.where(col == 5, nvisit, out)
    out = jnp.where(col == 6, nrest, out)
    out_ref[0, :] = out


@dataclasses.dataclass(frozen=True)
class MegaKernelPrep:
    """Host-side mesh preparation for the fused kernel (done once per mesh
    pair, unlike the reference which re-reads and re-uploads per call)."""

    rob_base: np.ndarray  # [16, Tr] f32
    obs_fields: np.ndarray  # [32, To] f32
    obs_mesh_aabb: np.ndarray  # [1, 8] f32
    obs_group_aabbs: np.ndarray  # [8, G] f32 per-group AABBs
    num_rob_tiles: int
    num_obs_tiles: int
    rob_tile: int = ROB_TILE
    obs_tile: int = OBS_TILE

    @staticmethod
    def build(robot: Mesh, obstacle: Mesh, morton: bool = True,
              rob_tile: int = ROB_TILE,
              obs_tile: int = OBS_TILE) -> "MegaKernelPrep":
        def corners(mesh: Mesh) -> np.ndarray:
            tv = mesh.vertices[mesh.triangles].astype(np.float64)  # [T,3,3]
            if morton:
                order = morton_argsort(tv.mean(axis=1))
                tv = tv[order]
            return tv

        if any(t <= 0 or t & (t - 1) for t in (rob_tile, obs_tile)):
            raise ValueError(f"tile sizes must be powers of two: "
                             f"{rob_tile}, {obs_tile}")
        n_obs = obstacle.num_triangles
        n_groups = -(-n_obs // obs_tile)
        if n_groups > MAX_OBS_GROUPS:
            raise GateWidthError(
                f"obstacle of {n_obs} triangles needs {n_groups} gate groups "
                f"of {obs_tile} (> {MAX_OBS_GROUPS}); use "
                f"kernels.chunked.make_checker (automatic Morton-chunked "
                f"dispatch) or ops.pipeline.CollisionWorld")

        rob_tv = corners(robot)
        tr = round_up(rob_tv.shape[0], max(rob_tile, BROAD_CHUNK))
        rob_base = np.zeros((_R_ROWS, tr), dtype=np.float32)
        rob_base[0:9, : rob_tv.shape[0]] = (
            rob_tv.reshape(rob_tv.shape[0], 9).T.astype(np.float32))
        rob_base[_R_VALID, : rob_tv.shape[0]] = 1.0

        obs_tv = corners(obstacle).astype(np.float32)
        to = n_groups * obs_tile
        obs = np.zeros((_O_ROWS, to), dtype=np.float32)
        obs[0:9, :n_obs] = obs_tv.reshape(n_obs, 9).T
        # Planes (same op order as ops.narrow.compute_plane, in f32).
        e1 = obs_tv[:, 1] - obs_tv[:, 0]
        e2 = obs_tv[:, 2] - obs_tv[:, 1]
        n = np.cross(e1, e2)
        obs[_O_N : _O_N + 3, :n_obs] = n.T
        obs[_O_D, :n_obs] = -np.sum(n * obs_tv[:, 0], axis=-1)
        obs[_O_LO : _O_LO + 3] = np.inf
        obs[_O_HI : _O_HI + 3] = -np.inf
        obs[_O_LO : _O_LO + 3, :n_obs] = obs_tv.min(axis=1).T
        obs[_O_HI : _O_HI + 3, :n_obs] = obs_tv.max(axis=1).T

        # Mesh-level obstacle box from the *referenced* triangle vertices
        # (not mesh.aabb, which reduces over the whole vertex array): for
        # Morton chunks sharing a parent vertex buffer this is what makes
        # per-chunk broad culling real rather than the whole-mesh box.
        obs_mesh = np.zeros((1, 8), dtype=np.float32)
        obs_mesh[0, 0:3] = obs_tv.reshape(-1, 3).min(axis=0)
        obs_mesh[0, 3:6] = obs_tv.reshape(-1, 3).max(axis=0)

        # Per-group obstacle boxes for the stage-2 gate; Morton order makes
        # them tight. Groups past the mesh (the power-of-two tail) are empty.
        g_pad = 1 << max(n_groups - 1, 0).bit_length()
        grp = np.zeros((8, g_pad), dtype=np.float32)
        grp[0:3] = np.inf
        grp[3:6] = -np.inf
        for g in range(n_groups):
            part = obs_tv[g * obs_tile : (g + 1) * obs_tile].reshape(-1, 3)
            grp[0:3, g] = part.min(axis=0)
            grp[3:6, g] = part.max(axis=0)

        return MegaKernelPrep(
            rob_base=rob_base,
            obs_fields=obs,
            obs_mesh_aabb=obs_mesh,
            obs_group_aabbs=grp,
            num_rob_tiles=tr // rob_tile,
            num_obs_tiles=n_groups,
            rob_tile=rob_tile,
            obs_tile=obs_tile,
        )


# Columns of the kernel output: 0=valid, 1=coplanar, 2=num_pairs
# (mini-AABB-overlapping pairs in the tiles visited), 3=broad, 4=tiles whose
# pair mask was non-empty (ran the plane stage), 5=tiles visited through the
# gate, 6=tiles that ran the interval stage, 7=zero. A colliding pose stops
# at its first hit, so its columns 2 and 4-6 count only the tiles it visited.
OUT_COLS = 8


def poses_from_confs(confs: jnp.ndarray) -> jnp.ndarray:
    """[B,6] configurations -> [B,16] flattened (R | t) pose rows."""
    R = rotation_matrices(confs)  # [B,3,3]
    t = confs[:, 0:3]
    b = confs.shape[0]
    pad = jnp.zeros((b, 4), dtype=jnp.float32)
    return jnp.concatenate(
        [
            R[:, 0, :], t[:, 0:1],
            R[:, 1, :], t[:, 1:2],
            R[:, 2, :], t[:, 2:3],
            pad,
        ],
        axis=1,
    )


@functools.partial(jax.jit, static_argnames=("rob_tile", "obs_tile",
                                             "interpret"))
def _check_block_impl(confs, obs_mesh, obs_grp, rob_base, obs_fields, *,
                      rob_tile, obs_tile, interpret):
    """Pose construction + kernel, one jit: [B,6] -> [B, OUT_COLS] int32.
    One grid program per pose."""
    b = confs.shape[0]
    kernel = functools.partial(
        _kernel, rob_tile=rob_tile, obs_tile=obs_tile,
        div=_true_div if interpret else _div_rn,
    )
    tables = (obs_mesh, obs_grp, rob_base, obs_fields)
    return pl.pallas_call(
        kernel,
        grid=(b,),
        in_specs=[pl.BlockSpec((1, 16), lambda i: (i, 0))]
        + [pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in tables],
        out_specs=pl.BlockSpec((1, OUT_COLS), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b, OUT_COLS), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="robocheck_fused_check",
    )(poses_from_confs(confs), *tables)


@functools.partial(jax.jit, static_argnames=("rob_tile", "obs_tile",
                                             "interpret"))
def _check_block_packed(confs, obs_mesh, obs_grp, rob_base, obs_fields, *,
                        rob_tile, obs_tile, interpret):
    """Like `_check_block_impl` but returns a [B] uint8 packed verdict
    (bit 0 = valid, bit 1 = coplanar-pair-seen): 1 byte per configuration
    to copy back to the host instead of 32."""
    out = _check_block_impl(
        confs, obs_mesh, obs_grp, rob_base, obs_fields,
        rob_tile=rob_tile, obs_tile=obs_tile, interpret=interpret,
    )
    return (out[:, 0] | (out[:, 1] << 1)).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=())
def _broad_sort(confs, corner_pts, corner_mask, obs_lo, obs_hi):
    """Device-side presort for the streamed path: broad phase + stable
    partition with broad-phase HITS first. Returns (sorted_confs, dest, n_hit)
    where dest[i] is row i's position in the sorted array (so un-permuting
    the packed verdicts is a plain row gather). Implemented with cumsums +
    one iota scatter + row gathers: linear, where an argsort is not."""
    hits = _broad_overlap(confs, corner_pts, corner_mask, obs_lo, obs_hi)
    n = confs.shape[0]
    nh = jnp.cumsum(hits.astype(jnp.int32))
    n_hit = nh[-1]
    nm = jnp.cumsum(jnp.logical_not(hits).astype(jnp.int32))
    dest = jnp.where(hits, nh - 1, n_hit + nm - 1)
    src = jnp.zeros((n,), jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True
    )
    return confs[src], dest, n_hit


@functools.partial(jax.jit, static_argnames=("chunk",))
def _slice_chunk(arr, lo, *, chunk):
    return jax.lax.dynamic_slice(arr, (lo, 0), (chunk, arr.shape[1]))


@functools.partial(jax.jit, static_argnames=())
def _unpermute(packed_sorted, dest):
    return packed_sorted[dest]


# Slack of the XLA broad phase, in f32 ulps of a pose's coordinate scale.
# The XLA boxes and the kernel's stage 1 pose the corners in the same
# operation order, but on the GPU XLA and Triton each contract multiply-adds
# into FMAs by their own rules, so the two boxes can differ in their last
# bits (a few ulps of the scale). Widening the XLA boxes by this
# slack makes every pose it calls a miss a miss in the kernel too.
BROAD_SLACK_ULPS = 64


@functools.partial(jax.jit, static_argnames=())
def _posed_bounds(confs, corner_pts, corner_mask):
    """Per-config robot AABB (lo[B,3], hi[B,3]) in the kernel's stage-1
    operation order (x*r0 + y*r1 + z*r2 + t, masked min/max), and each
    config's coordinate scale (largest |x|+|y|+|z| of a corner plus the
    largest |t|), which bounds every partial sum of that order."""
    R = rotation_matrices(confs)  # [B,3,3]
    t = confs[:, 0:3]
    x, y, z = corner_pts[:, 0], corner_pts[:, 1], corner_pts[:, 2]
    c0 = R[:, None, :, 0]
    c1 = R[:, None, :, 1]
    c2 = R[:, None, :, 2]
    v = x[None, :, None] * c0 + y[None, :, None] * c1 + z[None, :, None] * c2
    v = v + t[:, None, :]  # [B, C, 3]
    big = jnp.float32(3.0e38)
    lo = jnp.min(jnp.where(corner_mask[None, :, None], v, big), axis=1)
    hi = jnp.max(jnp.where(corner_mask[None, :, None], v, -big), axis=1)
    r_abs = jnp.max(jnp.where(corner_mask, jnp.abs(corner_pts).sum(-1), 0.0))
    scale = r_abs + jnp.max(jnp.abs(t), axis=1)
    return lo, hi, scale


@functools.partial(jax.jit, static_argnames=())
def _robot_bounds(confs, corner_pts, corner_mask):
    """Per-config robot AABB (lo[B,3], hi[B,3]) widened by the broad-phase
    slack — the expensive half of the broad phase, computed once and
    compared against any number of obstacle boxes (plain f32 <=, the same
    on the host)."""
    lo, hi, scale = _posed_bounds(confs, corner_pts, corner_mask)
    m = (BROAD_SLACK_ULPS * float(np.finfo(np.float32).eps) * scale)[:, None]
    return lo - m, hi + m


@functools.partial(jax.jit, static_argnames=())
def _broad_overlap(confs, corner_pts, corner_mask, obs_lo, obs_hi):
    """Mesh-level broad phase over pre-gathered corners, conservative
    against the kernel's stage 1: True wherever the kernel's broad phase
    hits (and, within the slack, where it barely misses), so two-phase
    dispatch and presort never skip a configuration the kernel would
    check."""
    lo, hi = _robot_bounds(confs, corner_pts, corner_mask)
    return jnp.all((lo <= obs_hi) & (obs_lo <= hi), axis=-1)  # [B] bool


class MegaKernelChecker:
    """Drop-in fast path: same verdicts as the XLA pipeline, one fused kernel.

    Returns (valid, coplanar, num_pairs, broad_hit) device arrays via
    ``check_block``; `CollisionWorld`-style host convenience via ``check``.

    ``check`` defaults to two-phase dispatch: a cheap XLA broad phase over
    the whole batch, then the fused kernel only on configurations whose mesh
    AABBs overlap the obstacle (the reference's skip-if-already-valid
    contract, `narrow-phase.cu:698-699`, done batch-level). On sparse
    datasets this removes almost all kernel work.

    The kernel is compiled for the GPU, or interpreted on the CPU
    (`runtime.device.pallas_interpret` decides).
    """

    def __init__(self, robot: Mesh, obstacle: Mesh, morton: bool = True,
                 rob_tile: int = ROB_TILE, obs_tile: int = OBS_TILE):
        self.robot = robot
        self.obstacle = obstacle
        self.prep = MegaKernelPrep.build(robot, obstacle, morton=morton,
                                         rob_tile=rob_tile,
                                         obs_tile=obs_tile)
        self._tables = tuple(jnp.asarray(a) for a in (
            self.prep.obs_mesh_aabb, self.prep.obs_group_aabbs,
            self.prep.rob_base, self.prep.obs_fields))
        self._static = dict(rob_tile=self.prep.rob_tile,
                            obs_tile=self.prep.obs_tile,
                            interpret=pallas_interpret())
        # Corner table for the XLA broad phase: [3*Tr, 3] points + valid mask.
        rb = self.prep.rob_base
        pts = rb[0:9].T.reshape(-1, 3, 3)  # [Tr, 3 corners, 3 xyz]
        self._corner_pts = jnp.asarray(pts.reshape(-1, 3))  # [3*Tr, 3]
        self._corner_mask = jnp.asarray(np.repeat(rb[_R_VALID] > 0, 3))
        self._obs_lo = jnp.asarray(self.prep.obs_mesh_aabb[0, 0:3])
        self._obs_hi = jnp.asarray(self.prep.obs_mesh_aabb[0, 3:6])

    def check_block(self, confs: jnp.ndarray) -> jnp.ndarray:
        """[B,6] device confs -> [B, OUT_COLS] int32 kernel output."""
        return _check_block_impl(confs, *self._tables, **self._static)

    def _packed(self, confs: jnp.ndarray) -> jnp.ndarray:
        return _check_block_packed(confs, *self._tables, **self._static)

    def broad_block(self, confs: jnp.ndarray) -> jnp.ndarray:
        """[B,6] -> [B] bool mesh-AABB overlap (True = needs narrow phase),
        conservative: True wherever the kernel's column 3 is set."""
        return _broad_overlap(
            confs, self._corner_pts, self._corner_mask, self._obs_lo,
            self._obs_hi,
        )

    @staticmethod
    def _pad_block(n: int) -> int:
        """Round survivor counts to a coarse grid to bound recompiles while
        keeping padding waste low (<= 1/8 of the batch)."""
        if n <= 256:
            return max(round_up(n, BATCH_MULTIPLE), BATCH_MULTIPLE)
        if n <= 4096:
            return 1 << (n - 1).bit_length()
        step = 1 << ((n - 1).bit_length() - 3)  # 1/8 granularity
        return round_up(n, step)

    # Streaming chunk size: big enough to amortize dispatch, small enough
    # that uploads of chunk i+1 overlap the kernel of chunk i.
    STREAM_CHUNK = 16384

    def check_valid(self, confs: np.ndarray, chunk: int | None = None,
                    presort: bool = False):
        """Throughput path: [N,6] configs -> (valid[N], coplanar[N]) bool.

        Single-phase (the kernel's in-kernel broad phase handles misses) and
        streamed: the batch is cut into fixed-shape chunks whose upload,
        kernel, and 1-byte/config packed copy back pipeline against each
        other via JAX async dispatch — no host sync between phases. Same
        verdicts as ``check`` (tests/test_megakernel.py::TestCheckValid
        asserts it).

        ``presort`` (default off; not yet measured on the GPU) first runs
        the cheap, conservative XLA broad phase (`_broad_overlap`) over the
        whole batch and orders broad-phase HITS first. Chunks past
        the hits are never dispatched (a broad miss is `valid=True,
        coplanar=False` by construction). Verdicts are identical either way;
        this is the reference's skip-if-already-valid contract
        (`narrow-phase.cu:698-699`) at batch scale with static shapes.
        """
        confs = validate_confs(confs)
        n = confs.shape[0]
        finite = np.isfinite(confs).all(axis=1)
        if not finite.all():
            out_v = np.zeros((n,), dtype=bool)
            out_c = np.zeros((n,), dtype=bool)
            if finite.any():
                v, c = self.check_valid(confs[finite], chunk=chunk,
                                        presort=presort)
                out_v[finite] = v
                out_c[finite] = c
            return out_v, out_c
        chunk = chunk or self.STREAM_CHUNK
        chunk = max(BATCH_MULTIPLE, chunk - chunk % BATCH_MULTIPLE)
        if presort:
            # Fully device-side: broad phase, hits-first partition, gather,
            # per-chunk kernel dispatches on the sorted array, inverse
            # permutation — then ONE packed fetch, after one scalar sync for
            # the hit count.
            padded = ((n + chunk - 1) // chunk) * chunk
            cpad = confs
            if padded > n:
                tail = np.zeros((padded - n, 6), dtype=np.float32)
                tail[:, 0] = 1.0e9  # far away: sorts to the miss tail
                cpad = np.concatenate([confs, tail], axis=0)
            sorted_confs, dest, n_hit = _broad_sort(
                jnp.asarray(cpad), self._corner_pts, self._corner_mask,
                self._obs_lo, self._obs_hi,
            )
            # Chunks past the hit count are never dispatched — a broad miss
            # is valid=True/coplanar=False by construction, so their packed
            # byte is the constant 1, filled on device.
            k = int(np.asarray(n_hit))
            nchunks = (min(k, n) + chunk - 1) // chunk
            outs = [self._packed(_slice_chunk(sorted_confs, ci * chunk,
                                              chunk=chunk))
                    for ci in range(nchunks)]
            if nchunks * chunk < padded:
                outs.append(jnp.ones((padded - nchunks * chunk,),
                                     dtype=jnp.uint8))
            packed = _unpermute(
                outs[0] if len(outs) == 1 else jnp.concatenate(outs), dest
            )
            packed = np.asarray(packed)[:n]
            return (packed & 1).astype(bool), (packed >> 1).astype(bool)
        outs = []
        for lo in range(0, n, chunk):
            part = confs[lo : lo + chunk]
            if part.shape[0] < chunk:
                # Pad rows far away: they exit at the in-kernel broad phase.
                pad = np.zeros((chunk - part.shape[0], 6), dtype=np.float32)
                pad[:, 0] = 1.0e9
                part = np.concatenate([part, pad], axis=0)
            outs.append(self._packed(jnp.asarray(part)))
        # Concatenate on device: ONE device->host fetch for the whole batch.
        packed = np.asarray(outs[0] if len(outs) == 1
                            else jnp.concatenate(outs))[:n]
        return (packed & 1).astype(bool), (packed >> 1).astype(bool)

    def check_valid_resolved(self, confs: np.ndarray,
                             chunk: int | None = None) -> np.ndarray:
        """``check_valid`` + exact float64 resolution of coplanar-flagged
        configurations (`oracle.resolve_coplanar`) — the verdict surface
        consumers should certify against. Returns valid[N] bool."""
        from ..oracle import resolve_coplanar

        valid, cop = self.check_valid(confs, chunk=chunk)
        return resolve_coplanar(self.robot, self.obstacle, confs, valid, cop)

    def check(self, confs: np.ndarray, two_phase: bool = True):
        confs = validate_confs(confs)
        n = confs.shape[0]
        # Non-finite configurations are not poses; never report them valid
        # (NaN comparisons would otherwise sail through the broad phase).
        finite = np.isfinite(confs).all(axis=1)
        if not finite.all():
            out_v = np.zeros((n,), dtype=bool)
            out_c = np.zeros((n,), dtype=bool)
            out_p = np.zeros((n,), dtype=np.int32)
            out_b = np.ones((n,), dtype=bool)
            if finite.any():
                v, c, p, b = self.check(confs[finite], two_phase=two_phase)
                out_v[finite] = v
                out_c[finite] = c
                out_p[finite] = p
                out_b[finite] = b
            return out_v, out_c, out_p, out_b
        if not two_phase:
            m = self._pad_block(max(n, 1))
            confs = np.pad(confs, ((0, m - n), (0, 0)))
            out = np.asarray(self.check_block(jnp.asarray(confs)))[:n]
            return (out[:, 0].astype(bool), out[:, 1].astype(bool),
                    out[:, 2], out[:, 3].astype(bool))

        # Phase 1: broad phase over the whole batch (pad to a coarse grid).
        bpad = self._pad_block(max(n, 1))
        cpad = np.pad(confs, ((0, bpad - n % bpad if n % bpad else 0), (0, 0)))
        overlap = np.asarray(self.broad_block(jnp.asarray(cpad)))[:n]

        valid = np.ones((n,), dtype=bool)
        coplanar = np.zeros((n,), dtype=bool)
        num_pairs = np.zeros((n,), dtype=np.int32)
        broad = overlap.copy()

        idx = np.nonzero(overlap)[0]
        if idx.size:
            # Phase 2: fused kernel on survivors only. Padding rows are
            # placed far away so they exit at the kernel's broad phase.
            m = self._pad_block(idx.size)
            surv = np.zeros((m, 6), dtype=np.float32)
            surv[:, 0] = 1.0e9
            surv[: idx.size] = confs[idx]
            out = np.asarray(self.check_block(jnp.asarray(surv)))[: idx.size]
            valid[idx] = out[:, 0].astype(bool)
            coplanar[idx] = out[:, 1].astype(bool)
            num_pairs[idx] = out[:, 2]
            # The kernel's own flag for survivors: the XLA pass is wider.
            broad[idx] = out[:, 3].astype(bool)
        return valid, coplanar, num_pairs, broad

"""Sequential Quadratic Programming trajectory optimizer.

The l1-penalty SQP formulation (TrajOpt-style) over batched collision
constraint blocks — the "SQP/QP planner-in-the-loop" configuration of the
north-star spec. Per outer iteration:

  1. Constraint evaluation (batched, on the device): for every waypoint,
     pose the robot's surface samples, query the signed distance grid, and
     keep the top-K most-penetrating samples -> residuals
     g[t,k] = margin - sdf and
     their Jacobian blocks J[t,k,6] (block-diagonal in waypoints; computed
     with jax.jacrev through the differentiable grid query).
  2. Convex subproblem (QP): minimize the quadratic smoothness model plus
     mu * sum hinge(g + J dq) subject to a trust-region box |dq| <= delta —
     solved by jitted projected gradient descent (the subproblem is convex;
     a fixed iteration count keeps it compile-friendly).
  3. Merit line test: accept dq if the true l1 merit (exact re-evaluation)
     decreased; shrink the trust region otherwise, grow it on good steps.
  4. Penalty escalation until the exact boolean mega-kernel certifies the
     densified trajectory (`trajopt.densify`).

Complements `trajopt.py`'s CHOMP-style first-order descent: SQP converges in
far fewer (more expensive) outer iterations and handles deep penetrations
more decisively via the linearized constraint geometry.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Mesh
from ..kernels.megakernel import MegaKernelChecker
from .sdf import DistanceGrid, build_distance_grid
from .trajopt import _pose_points, _sample_surface_points, densify


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    num_waypoints: int = 32
    max_outer: int = 30
    subproblem_iters: int = 60
    top_k: int = 8  # constraint blocks per waypoint
    margin: float = 0.3
    smooth_weight: float = 1.0
    penalty_init: float = 10.0
    penalty_growth: float = 5.0
    max_penalty_rounds: int = 5
    trust_init: float = 0.5
    trust_shrink: float = 0.5
    trust_grow: float = 1.6
    trust_max: float = 4.0
    trust_min: float = 1e-4
    rot_scale: float = 20.0
    num_surface_samples: int = 128
    grid_resolution: int = 64
    certify_step: float | None = None
    seed: int = 0
    # Periodic checkpoint of (trajectory, penalty, trust, iter) so long runs
    # survive preemption (`runtime/checkpoint.py`); None disables.
    checkpoint_path: str | None = None
    checkpoint_every: int = 10  # outer iterations between checkpoints


class SQPResult(NamedTuple):
    trajectory: np.ndarray  # [T, 6]
    certified: bool
    outer_iters: int
    merit: float


class SQPOptimizer:
    def __init__(self, robot: Mesh, obstacle: Mesh,
                 config: SQPConfig | None = None,
                 grid: DistanceGrid | None = None,
                 checker: MegaKernelChecker | None = None,
                 mesh=None):
        from ..kernels.chunked import make_checker

        self.robot = robot
        self.obstacle = obstacle
        self._cert_pool = None
        self.cfg = config or SQPConfig()
        cfg = self.cfg
        self.grid = grid if grid is not None else build_distance_grid(
            obstacle, cfg.grid_resolution
        )
        # ``mesh`` (a jax.sharding.Mesh): certification batches route
        # through the batch-sharded checker AND constraint evaluation
        # shards over the waypoint axis with psum-reduced penalty totals
        # (the "planner constraint blocks reduced with psum" leg of
        # BASELINE.json configs[4]; see _constraint_blocks below).
        self.mesh = mesh
        self.checker = checker or make_checker(
            robot, obstacle, mesh=mesh
        )
        self._samples = jnp.asarray(
            _sample_surface_points(robot, cfg.num_surface_samples, cfg.seed)
        )
        grid_ = self.grid
        samples = self._samples
        scale = jnp.asarray(
            [1.0, 1.0, 1.0, cfg.rot_scale, cfg.rot_scale, cfg.rot_scale],
            dtype=jnp.float32,
        )

        def waypoint_residuals(q_t):
            """One waypoint's top-K penetration residuals, [K]."""
            pts = _pose_points(q_t[None, :], samples)[0]  # [P,3]
            d = grid_.query(pts)  # [P]
            g = cfg.margin - d
            top, _ = jax.lax.top_k(g, cfg.top_k)
            return top

        # Batched residuals + block-diagonal Jacobians over all waypoints.
        self._residuals = jax.jit(jax.vmap(waypoint_residuals))
        self._jacobians = jax.jit(jax.vmap(jax.jacrev(waypoint_residuals)))

        if mesh is not None:
            # SPMD constraint evaluation: waypoints shard over the device
            # mesh's batch axis, each device evaluates its waypoints'
            # residual/Jacobian blocks (surface-sample posing + grid
            # queries — the expensive part), and the scalar penalty total
            # reduces with psum across devices. The g/J blocks stay sharded; the
            # subproblem consumes them as global jax.Arrays.
            from jax.sharding import PartitionSpec as P

            axis = mesh.axis_names[0]
            self._ndev = mesh.devices.size

            @jax.jit
            @partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=(P(axis), P(axis), P()),
            )
            def blocks_sharded(q_shard, mask_shard):
                g = jax.vmap(waypoint_residuals)(q_shard)
                J = jax.vmap(jax.jacrev(waypoint_residuals))(q_shard)
                local = jnp.sum(jnp.maximum(g, 0.0) * mask_shard[:, None])
                return g, J, jax.lax.psum(local[None], axis)

            @jax.jit
            @partial(
                jax.shard_map, mesh=mesh,
                in_specs=(P(axis), P(axis)), out_specs=P(),
            )
            def penalty_sharded(q_shard, mask_shard):
                g = jax.vmap(waypoint_residuals)(q_shard)
                local = jnp.sum(jnp.maximum(g, 0.0) * mask_shard[:, None])
                return jax.lax.psum(local[None], axis)

            self._blocks_sharded = blocks_sharded
            self._penalty_sharded = penalty_sharded

        def smooth_cost(q):
            dq = (q[1:] - q[:-1]) * scale
            return cfg.smooth_weight * jnp.sum(dq * dq)

        self._smooth_cost = jax.jit(smooth_cost)

        @partial(jax.jit, static_argnames=())
        def solve_subproblem(q, g0, J, mu, delta):
            """Projected gradient descent on the convexified merit in dq.

            model(dq) = smooth(q + dq) + mu * sum hinge(g0 + J dq),
            box constraint |dq| <= delta (endpoints pinned via zero rows).
            """
            T = q.shape[0]
            free_mask = jnp.ones((T, 1), jnp.float32)
            free_mask = free_mask.at[0].set(0.0).at[-1].set(0.0)

            def model_grad(dq):
                def model(dq):
                    # Elementwise contraction (einsum would lower to a
                    # bf16-precision dot-general; d=6 is elementwise work anyway).
                    lin = g0 + jnp.sum(J * dq[:, None, :], axis=-1)
                    return smooth_cost(q + dq) + mu * jnp.sum(
                        jnp.maximum(lin, 0.0)
                    )

                return jax.grad(model)(dq)

            # Lipschitz-ish step: smoothness curvature ~ 4*w*scale^2.
            lr = 1.0 / (4.0 * cfg.smooth_weight * scale * scale
                        + mu * jnp.sum(J * J, axis=(0, 1)) / T + 1e-6)

            def body(_, dq):
                gsub = model_grad(dq)
                dq = dq - lr[None, :] * gsub
                dq = jnp.clip(dq, -delta, delta) * free_mask
                return dq

            dq = jax.lax.fori_loop(
                0, cfg.subproblem_iters, body, jnp.zeros_like(q)
            )
            return dq

        self._solve_subproblem = solve_subproblem

    def _pad_waypoints(self, q: jnp.ndarray):
        """Pad the waypoint axis to a device-count multiple (duplicated
        last row, masked out of every reduction)."""
        t = q.shape[0]
        pad = (-t) % self._ndev
        mask = jnp.concatenate(
            [jnp.ones((t,), jnp.float32), jnp.zeros((pad,), jnp.float32)]
        )
        if pad:
            q = jnp.concatenate([q, jnp.broadcast_to(q[-1:], (pad, 6))])
        return q, mask, t

    def _constraint_blocks(self, q: jnp.ndarray):
        """(g0 [T,K], J [T,K,6], penalty total) — waypoint-sharded with a
        psum-reduced penalty when a device mesh was given, single-device
        otherwise."""
        if self.mesh is None:
            g = self._residuals(q)
            J = self._jacobians(q)
            return g, J, float(jnp.sum(jnp.maximum(g, 0.0)))
        qp, mask, t = self._pad_waypoints(q)
        g, J, tot = self._blocks_sharded(qp, mask)
        return g[:t], J[:t], float(tot[0])

    def _penalty_total(self, q: jnp.ndarray) -> float:
        if self.mesh is None:
            g = self._residuals(q)
            return float(jnp.sum(jnp.maximum(g, 0.0)))
        qp, mask, _ = self._pad_waypoints(q)
        return float(self._penalty_sharded(qp, mask)[0])

    def _merit(self, q: jnp.ndarray, mu: float) -> float:
        return float(self._smooth_cost(q)) + mu * self._penalty_total(q)

    def _certify_submit(self, traj: np.ndarray):
        """Run `_certify` on a worker thread: the verdict fetch (a full
        device-to-host round trip) overlaps the
        NEXT penalty round's constraint-block dispatches instead of
        stalling the optimizer between rounds (BASELINE.json's p50-vs-
        budget metric; bench.py LATENCY_BUDGET_MS). jax dispatch is
        thread-safe; the speculative outer iteration a passing verdict
        wastes costs ~one subproblem (~ms)."""
        if self._cert_pool is None:
            import concurrent.futures as _cf

            self._cert_pool = _cf.ThreadPoolExecutor(max_workers=1)
        return self._cert_pool.submit(self._certify, traj)

    def _certify(self, traj: np.ndarray) -> bool:
        step = self.cfg.certify_step
        if step is None:
            ext = self.robot.aabb[3:] - self.robot.aabb[:3]
            step = 0.5 * float(ext.min())
        dense, _ = densify(traj, step, self.cfg.rot_scale)
        # Resolved path: coplanar contacts must fail certification.
        dvalid = self.checker.check_valid_resolved(dense)
        return bool(dvalid.all())

    def _checkpoint(self, qj, mu, delta, outer, rnd) -> None:
        if self.cfg.checkpoint_path is None:
            return
        from ..runtime import checkpoint

        checkpoint.save(
            self.cfg.checkpoint_path,
            {"q": np.asarray(qj)},
            meta={"mu": float(mu), "delta": float(delta),
                  "outer": int(outer), "round": int(rnd)},
        )

    def plan(self, start: np.ndarray, goal: np.ndarray,
             init: np.ndarray | None = None,
             resume: bool = False) -> SQPResult:
        """Plan start -> goal. With ``resume=True`` and an existing
        ``cfg.checkpoint_path``, continues from the checkpointed trajectory,
        penalty, and trust region instead of the straight-line init."""
        cfg = self.cfg
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        mu = cfg.penalty_init
        delta = cfg.trust_init
        outer = 0
        start_round = 0
        if resume and cfg.checkpoint_path is not None:
            from ..runtime import checkpoint
            import os as _os

            if _os.path.exists(cfg.checkpoint_path):
                arrays, meta = checkpoint.load(cfg.checkpoint_path)
                init = arrays["q"]
                if meta:
                    mu = meta.get("mu", mu)
                    delta = meta.get("delta", delta)
                    outer = meta.get("outer", 0)
                    start_round = meta.get("round", 0)
        if init is None:
            t = np.linspace(0, 1, cfg.num_waypoints)[:, None]
            q = ((1 - t) * start[None] + t * goal[None]).astype(np.float32)
            rng = np.random.default_rng(cfg.seed + 1)
            q[1:-1, :3] += rng.normal(scale=1e-2, size=(cfg.num_waypoints - 2,
                                                        3)).astype(np.float32)
        else:
            from .trajopt import snap_endpoint_branch

            q = np.asarray(init, np.float32).copy()
            # Pin endpoints on the init's 2*pi branch (see
            # trajopt.snap_endpoint_branch): raw endpoints re-introduce the
            # near-2*pi final-segment jump unwrap_path removed.
            q[0] = snap_endpoint_branch(start, q[0])
            q[-1] = snap_endpoint_branch(goal, q[-1])

        qj = jnp.asarray(q)
        pending = None  # (future, traj, outer, mu) certification in flight
        for rnd in range(start_round, cfg.max_penalty_rounds):
            for _ in range(cfg.max_outer):
                outer += 1
                g0, J, tot = self._constraint_blocks(qj)
                # Harvest the previous round's in-flight certification
                # AFTER dispatching this round's constraint blocks, so the
                # verdict's device-to-host round trip hides behind device
                # work.
                if pending is not None:
                    fut, ptraj, pouter, pmu, ckpt = pending
                    pending = None
                    if fut.result():
                        return SQPResult(ptraj, True, pouter,
                                         self._merit(jnp.asarray(ptraj),
                                                     pmu))
                    # Only now that the previous round is known
                    # uncertified does its successor checkpoint get
                    # written — a preemption during the speculative
                    # window must resume BEFORE the escalated round, as
                    # the non-overlapped flow would have.
                    self._checkpoint(*ckpt)
                dq = self._solve_subproblem(qj, g0, J, jnp.float32(mu),
                                            jnp.float32(delta))
                # merit(qj) reuses the penalty total the block evaluation
                # already (psum-)reduced — no second residual pass.
                merit_old = float(self._smooth_cost(qj)) + mu * tot
                merit_new = self._merit(qj + dq, mu)
                if merit_new < merit_old - 1e-9:
                    qj = qj + dq
                    delta = min(delta * cfg.trust_grow, cfg.trust_max)
                else:
                    delta = delta * cfg.trust_shrink
                    if delta < cfg.trust_min:
                        break
                if outer % cfg.checkpoint_every == 0:
                    self._checkpoint(qj, mu, delta, outer, rnd)
            traj = np.asarray(qj)
            if rnd + 1 < cfg.max_penalty_rounds:
                # Dispatch certification asynchronously and speculatively
                # begin the next penalty round; harvested at that round's
                # first iteration (above). The rnd+1 checkpoint is
                # deferred to the harvest (see there).
                pending = (self._certify_submit(traj), traj, outer, mu,
                           (qj, mu * cfg.penalty_growth, cfg.trust_init,
                            outer, rnd + 1))
                mu *= cfg.penalty_growth
                delta = cfg.trust_init
            else:
                if self._certify(traj):
                    return SQPResult(traj, True, outer,
                                     self._merit(qj, mu))
        if pending is not None:  # max_outer == 0 edge: nothing harvested it
            fut, ptraj, pouter, pmu, _ckpt = pending
            if fut.result():
                return SQPResult(ptraj, True, pouter,
                                 self._merit(jnp.asarray(ptraj), pmu))
        traj = np.asarray(qj)
        return SQPResult(traj, self._certify(traj), outer,
                         self._merit(qj, mu))

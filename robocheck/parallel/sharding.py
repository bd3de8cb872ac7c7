"""SPMD sharding of the collision pipeline over a device mesh.

The reference is strictly single-process/single-GPU (`SURVEY.md` §2.9); this
module is the net-new distribution layer: configurations shard along the
batch axis of a 1-D ``jax.sharding.Mesh``, base meshes replicate, each device
runs the fused kernel on its shard, and global statistics (valid / coplanar
counts) reduce with ``jax.lax.psum``, which XLA hands to NCCL across cards.
Multi-host extends the same program via ``jax.distributed.initialize``
(`runtime/distributed.py`); nothing here is host-count-aware.

Testable without hardware: an 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``) with the kernel in interpret
mode runs the identical SPMD program.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.types import Mesh as TriMesh, validate_confs
from ..kernels import megakernel as mk
from ..runtime.device import pallas_interpret

BATCH_AXIS = "batch"


def make_mesh(num_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


class ShardedChecker:
    """Batch-parallel collision checking over a device mesh.

    ``check_block`` keeps everything on device; ``check`` is the host
    convenience API (pads to mesh-divisible block, returns numpy verdicts).
    """

    def __init__(
        self,
        robot: TriMesh,
        obstacle: TriMesh,
        mesh: Mesh | None = None,
        morton: bool = True,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.robot = robot
        self.obstacle = obstacle
        self.prep = mk.MegaKernelPrep.build(robot, obstacle, morton=morton)

        n_dev = self.mesh.devices.size
        replicated = NamedSharding(self.mesh, P())
        self._tables = tuple(jax.device_put(a, replicated) for a in (
            self.prep.obs_mesh_aabb, self.prep.obs_group_aabbs,
            self.prep.rob_base, self.prep.obs_fields))
        self._conf_sharding = NamedSharding(self.mesh, P(BATCH_AXIS))
        static = dict(rob_tile=self.prep.rob_tile,
                      obs_tile=self.prep.obs_tile,
                      interpret=pallas_interpret(self.mesh.devices.flat))

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(BATCH_AXIS), P(), P(), P(), P()),
            out_specs=(P(BATCH_AXIS), P()),
            # pallas_call out_shapes carry no varying-mesh-axis info.
            check_vma=False,
        )
        def _sharded(confs, *tables):
            out = mk._check_block_impl(confs, *tables, **static)
            # Global statistics: per-shard partial counts psum-reduced across
            # the batch axis (valid count, collision count, coplanar).
            local = jnp.stack(
                [
                    jnp.sum(out[:, 0], dtype=jnp.int32),
                    jnp.sum(1 - out[:, 0], dtype=jnp.int32),
                    jnp.sum(out[:, 1], dtype=jnp.int32),
                ]
            )
            totals = jax.lax.psum(local, BATCH_AXIS)
            return out, totals

        self._sharded = jax.jit(_sharded)

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(BATCH_AXIS), P(), P(), P(), P()),
            out_specs=P(BATCH_AXIS),
            check_vma=False,
        )
        def _sharded_packed(confs, *tables):
            return mk._check_block_packed(confs, *tables, **static)

        self._sharded_packed = jax.jit(_sharded_packed)
        self._block_multiple = n_dev * mk.BATCH_MULTIPLE

    def check_block(self, confs: jnp.ndarray):
        """[B,6] (B divisible by the device count) -> ([B, OUT_COLS] out,
        [3] totals)."""
        confs = jax.device_put(confs, self._conf_sharding)
        return self._sharded(confs, *self._tables)

    def check(self, confs: np.ndarray):
        confs = validate_confs(confs)
        n = confs.shape[0]
        pad = (-n) % self._block_multiple
        if pad:
            # Padding rows sit far away and exit at the in-kernel broad
            # phase (an all-zero pad row would run the full narrow phase).
            tail = np.zeros((pad, 6), dtype=np.float32)
            tail[:, 0] = 1.0e9
            confs = np.concatenate([confs, tail], axis=0)
        out, _ = self.check_block(jnp.asarray(confs))
        out = np.asarray(out)[:n]
        return (
            out[:, 0].astype(bool),
            out[:, 1].astype(bool),
            out[:, 2],
            out[:, 3].astype(bool),
        )

    # Streaming chunk size per device (matches the single-chip checker's
    # dispatch-vs-overlap sweet spot).
    STREAM_CHUNK_PER_DEVICE = 16384

    def check_valid(self, confs: np.ndarray, chunk: int | None = None):
        """Throughput path, sharded: [N,6] -> (valid[N], coplanar[N]) bool.

        The multi-chip twin of ``MegaKernelChecker.check_valid``: the batch
        is cut into fixed-shape chunks laid out along the mesh's batch axis;
        each chunk's H2D scatter, per-shard fused kernel, and packed
        1-byte/config gather pipeline against each other via JAX async
        dispatch, and all chunks are concatenated on device for a single
        host fetch. Verdicts are identical to the single-chip path (same
        kernel, same FP order; tests/test_sharding.py asserts it).
        """
        confs = validate_confs(confs)
        n = confs.shape[0]
        finite = np.isfinite(confs).all(axis=1)
        if not finite.all():
            out_v = np.zeros((n,), dtype=bool)
            out_c = np.zeros((n,), dtype=bool)
            if finite.any():
                v, c = self.check_valid(confs[finite], chunk=chunk)
                out_v[finite] = v
                out_c[finite] = c
            return out_v, out_c
        chunk = chunk or self.STREAM_CHUNK_PER_DEVICE * self.mesh.devices.size
        chunk = max(self._block_multiple,
                    chunk - chunk % self._block_multiple)
        outs = []
        for lo in range(0, n, chunk):
            part = confs[lo : lo + chunk]
            if part.shape[0] < chunk:
                pad = np.zeros((chunk - part.shape[0], 6), dtype=np.float32)
                pad[:, 0] = 1.0e9  # far away: exits at the broad phase
                part = np.concatenate([part, pad], axis=0)
            part = jax.device_put(part, self._conf_sharding)
            outs.append(
                self._sharded_packed(part, *self._tables)
            )
        packed = np.asarray(outs[0] if len(outs) == 1
                            else jnp.concatenate(outs))[:n]
        return (packed & 1).astype(bool), (packed >> 1).astype(bool)

    def check_valid_resolved(self, confs: np.ndarray,
                             chunk: int | None = None) -> np.ndarray:
        """``check_valid`` + float64 resolution of coplanar-flagged
        configurations (see `oracle.resolve_coplanar`)."""
        from ..oracle import resolve_coplanar

        valid, cop = self.check_valid(confs, chunk=chunk)
        return resolve_coplanar(self.robot, self.obstacle, confs, valid, cop)

    def check_valid_distributed(self, local_confs: np.ndarray,
                                global_n: int):
        """Multi-host throughput path (SPMD, one process per host).

        Every process passes ONLY its own contiguous row shard of the global
        batch (`runtime.distributed.shard_bounds` tells each host which file
        rows to read) and receives verdicts for exactly those rows — the
        global configuration array is assembled device-side via
        ``jax.make_array_from_process_local_data``, never materialized on
        any single host. The mesh must span all processes' devices (a 1-D
        mesh over ``jax.devices()``; JAX orders devices by process, so
        contiguous row shards land on the owning host's devices).

        Verdicts are identical to the single-process path: same kernel, same
        FP order, batch-parallel only (tests/test_distributed.py runs two
        coordinated processes and asserts equality against goldens).

        Args:
          local_confs: [local_n, 6] this process's contiguous row shard.
          global_n: total rows across processes (padding is added here so
            every process pads identically).
        Returns:
          (valid, coplanar) bool arrays for the local shard, in row order.
        """
        import jax as _jax

        nproc = _jax.process_count()
        pidx = _jax.process_index()
        local_confs = validate_confs(local_confs)
        # Global padded size: divisible by (devices * BATCH_MULTIPLE) and
        # by nproc so every process contributes equal local shards.
        blk = self._block_multiple
        padded = ((global_n + blk - 1) // blk) * blk
        per_proc = padded // nproc
        lo, hi = pidx * per_proc, (pidx + 1) * per_proc
        # This process's padded local block (rows outside the dataset are
        # far-away padding that exits at the in-kernel broad phase).
        local = np.zeros((per_proc, 6), dtype=np.float32)
        local[:, 0] = 1.0e9
        n_local = local_confs.shape[0]
        local[:n_local] = local_confs
        garr = _jax.make_array_from_process_local_data(
            self._conf_sharding, local, (padded, 6)
        )
        packed = self._sharded_packed(garr, *self._tables)
        # Reassemble this process's rows from its addressable shards.
        out = np.zeros((per_proc,), dtype=np.uint8)
        for s in packed.addressable_shards:
            start = s.index[0].start or 0
            out[start - lo : start - lo + s.data.shape[0]] = np.asarray(
                s.data
            )
        out = out[:n_local]
        return (out & 1).astype(bool), (out >> 1).astype(bool)

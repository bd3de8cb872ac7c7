"""robocheck — batched rigid-body collision checking on the GPU.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
CUDA framework `vmurta/robo-check`: batch-validate rigid-body robot
configurations against an obstacle mesh (transform -> AABB broad phase ->
triangle-triangle narrow phase) for sampling-based motion planning, plus a
collision-constrained trajectory optimizer, sharded over device meshes.
"""

from .core.types import Mesh, PaddedMesh
from .io.conf import read_conf_file, write_conf_file
from .io.obj import load_obj, save_obj
from .ops.pipeline import CheckResult, CollisionWorld, PipelineConfig

__version__ = "0.1.0"

__all__ = [
    "Mesh",
    "PaddedMesh",
    "CollisionWorld",
    "PipelineConfig",
    "CheckResult",
    "load_obj",
    "save_obj",
    "read_conf_file",
    "write_conf_file",
    "__version__",
]

"""Motion-planning layer: batch PRM (global), CHOMP-style trajectory
optimization (local), and the standard pipeline of seeding the optimizer
with a PRM path."""
from __future__ import annotations

import numpy as np

from ..core.types import Mesh
from .ccd import SweptCertificate, SweptCertifier, covering_radius
from .prm import PRMConfig, PRMPlanner, PRMResult
from .rrt import RRTConfig, RRTConnectPlanner, RRTResult
from .sdf import DistanceGrid, build_distance_grid, point_triangle_distance
from .sqp import SQPConfig, SQPOptimizer, SQPResult
from .trajopt import (
    TrajectoryOptimizer,
    TrajOptConfig,
    TrajOptResult,
    densify,
    resample,
)

__all__ = [
    "RRTConfig",
    "RRTConnectPlanner",
    "RRTResult",
    "PRMConfig", "PRMPlanner", "PRMResult",
    "SQPConfig", "SQPOptimizer", "SQPResult",
    "TrajectoryOptimizer", "TrajOptConfig", "TrajOptResult",
    "DistanceGrid", "build_distance_grid", "point_triangle_distance",
    "SweptCertificate", "SweptCertifier", "covering_radius",
    "densify", "resample", "plan_and_smooth",
]


def plan_and_smooth(
    robot: Mesh,
    obstacle: Mesh,
    start: np.ndarray,
    goal: np.ndarray,
    prm_config: PRMConfig | None = None,
    opt_config: TrajOptConfig | None = None,
) -> TrajOptResult | None:
    """The full planning pipeline: PRM finds a feasible (jagged) path through
    narrow passages a local optimizer cannot discover; the trajectory
    optimizer then smooths it under the distance-field penalty; the exact
    checker certifies the result. Returns None if the PRM finds no path."""
    prm = PRMPlanner(robot, obstacle, prm_config)
    found = prm.plan(start, goal)
    if found.path is None:
        return None
    opt = TrajectoryOptimizer(
        robot, obstacle, opt_config, checker=prm.checker
    )
    init = resample(found.path, opt.cfg.num_waypoints, opt.cfg.rot_scale)
    return opt.plan(start, goal, init=init)

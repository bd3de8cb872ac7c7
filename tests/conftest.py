"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the multi-device story is
validated without a GPU, per SURVEY.md §4's added tier), with the Pallas
kernels interpreted. Tests marked ``gpu`` need the card: select them with
``-m gpu`` (the selection then runs on JAX's default platform), e.g.
``python -m pytest tests/ -m gpu`` on a machine with an NVIDIA GPU, or
``python chip_smoke.py``, which runs them in its own process. Without a card
they skip.
"""
import os
import sys


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from robocheck.io import assets  # noqa: E402
from robocheck.io.conf import read_conf_file  # noqa: E402
from robocheck.io.obj import load_obj  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU (decided
    here, at run time, never while modules are imported)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="session")
def alpha_meshes():
    robot = load_obj(assets.alpha_robot_path())
    obstacle = load_obj(assets.alpha_obstacle_path())
    return robot, obstacle


@pytest.fixture(scope="session")
def hard10k():
    return read_conf_file(assets.dataset_path("hard10k"))


@pytest.fixture(scope="session")
def easy10k():
    return read_conf_file(assets.dataset_path("easy10k"))


@pytest.fixture(scope="session")
def samples10k():
    return read_conf_file(assets.dataset_path("samples10k"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(508)

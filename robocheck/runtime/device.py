"""The one place that picks the device route for Pallas kernels.

``"gpu"`` runs the compiled Triton kernels; ``"cpu"`` runs them in Pallas
interpret mode, which exists for the CPU tests and the virtual-device dryrun
only (and says so once on stderr); any other platform is refused.
"""
from __future__ import annotations

import functools
import sys

import jax


@functools.cache
def _announce_interpret() -> None:
    print("robocheck: no GPU; Pallas kernels run in interpret mode on the "
          "CPU (tests and dryruns only)", file=sys.stderr)


def pallas_interpret(devices=None) -> bool:
    """False on the GPU (compiled kernels), True on the CPU (interpret
    mode); raises on any other platform. ``devices`` defaults to
    ``jax.devices()``; the first one decides."""
    p = next(iter(devices if devices is not None else jax.devices())).platform
    if p == "gpu":
        return False
    if p == "cpu":
        _announce_interpret()
        return True
    raise RuntimeError(
        f"robocheck runs its kernels on an NVIDIA GPU (or interpreted on the "
        f"CPU for tests); platform {p!r} is not supported")


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: measurement entry points call
    this so that they never fall back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found (jax platform {dev.platform!r}); this entry point "
            f"measures the card and does not run on the CPU")
    return dev

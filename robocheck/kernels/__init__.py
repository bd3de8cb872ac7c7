"""Pallas kernels for the GPU (the performance path)."""
from .megakernel import MegaKernelChecker, MegaKernelPrep

__all__ = ["MegaKernelChecker", "MegaKernelPrep"]

"""Graph distance metrics; counterpart of ``graphdot_tpu/metric/``."""
from ._kernel_induced import KernelInducedDistance
from .maximin import MaxiMin

__all__ = ['MaxiMin', 'KernelInducedDistance']

"""Gram matrices over a fixed graph set as functions of the kernel's
hyperparameters; counterpart of ``graphdot_tpu/inference``.

Only :class:`GramFactory` is ported so far. ``GPRLogProb`` and the
samplers (NUTS, HMC, SMC, VI) are still to port.
"""
from .gram import GramFactory

__all__ = ['GramFactory']

"""Bayesian inference over kernel hyperparameters (NUTS, HMC, SMC, VI);
counterpart of ``graphdot_tpu/inference``.

The samplers run their chains (or particles) as the leading axis of every
tensor, where the JAX package used ``jax.vmap``, and take an explicit
``torch.Generator``; a log density maps [C, D] to [C] and is differentiated
by torch autograd. :class:`GPRLogProb` is such a density over a graph-kernel
GP's log hyperparameters: each evaluation is one Gram of a
:class:`GramFactory` for all the chains it is given, its solves in the
card's kernels.

Not ported: the JAX sampler's ``mesh``/``chain_axis`` and SMC's
``particle_axis`` (chains sharded over devices, waiting for the port's
multi-GPU work), ``sample``'s ``loop`` (one Python-driven loop here), and
the nested-loop NUTS oracle ``_nuts_step_nested``.
"""
from .checkpoint import load_chains, resume_state, save_chains
from .diagnostics import ess, split_rhat
from .dual_averaging import da_init, da_update
from .gp_logprob import GPRLogProb
from .gram import GramFactory
from .hmc import HMCState, hmc_init, hmc_step
from .mcmc import sample
from .nuts import nuts_step
from .smc import smc_sample
from .vi import advi

__all__ = [
    'GPRLogProb', 'GramFactory', 'sample', 'nuts_step', 'hmc_step',
    'hmc_init', 'HMCState', 'smc_sample', 'advi', 'split_rhat', 'ess',
    'da_init', 'da_update', 'save_chains', 'load_chains', 'resume_state',
]

"""Step-size and mass-matrix adaptation for HMC and NUTS; counterpart of
``graphdot_tpu/inference/dual_averaging.py``.

Nesterov dual averaging (Hoffman & Gelman 2014, section 3.2) of the log step
size, and Welford's streaming estimate of a diagonal mass matrix. The
states are records of tensors. The dual-averaging state is one scalar
record shared by all chains; the Welford functions are batched over chains,
the chain axis leading.
"""
import math
from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(step_size):
    """The dual-averaging state that starts at ``step_size`` (a float or a
    scalar tensor; float32 unless a tensor says otherwise)."""
    log_step = torch.log(torch.as_tensor(step_size, dtype=torch.float32)
                         if not isinstance(step_size, torch.Tensor)
                         else step_size)
    zero = torch.zeros_like(log_step)
    return DualAveragingState(log_step=log_step, log_step_avg=zero,
                              grad_avg=zero, t=zero,
                              mu=math.log(10.0) + log_step)


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
              kappa=0.75):
    """One dual-averaging step toward the acceptance rate ``target``, given
    the mean acceptance statistic ``accept_prob`` of a transition."""
    t = state.t + 1.0
    g = target - accept_prob
    grad_avg = (1.0 - 1.0 / (t + t0)) * state.grad_avg + g / (t + t0)
    log_step = state.mu - grad_avg * torch.sqrt(t) / gamma
    eta = t ** -kappa
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step=log_step, log_step_avg=log_step_avg,
                              grad_avg=grad_avg, t=t, mu=state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor      # [C, D]
    m2: torch.Tensor        # [C, D]
    count: torch.Tensor     # [C]


def welford_init(n_chains, n_dims, dtype=torch.float32, device='cpu'):
    """An empty running estimate for each of ``n_chains`` chains."""
    zeros = torch.zeros(n_chains, n_dims, dtype=dtype, device=device)
    return WelfordState(mean=zeros, m2=zeros.clone(),
                        count=torch.zeros(n_chains, dtype=dtype,
                                          device=device))


def welford_update(state, x):
    """Add one draw x [C, D] of each chain."""
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[:, None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state, regularize=True):
    """Each chain's variance estimate [C, D], shrunk toward 1e-3 as Stan
    does when ``regularize``."""
    n = state.count[:, None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var

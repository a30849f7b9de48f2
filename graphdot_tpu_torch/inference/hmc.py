"""Hamiltonian Monte Carlo transition, batched over chains; counterpart of
``graphdot_tpu/inference/hmc.py``.

The chain axis leads every tensor where the JAX module ran under
``jax.vmap``: a state holds q [C, D], logp [C] and grad [C, D], and a
log density ``logp_fn`` maps [C, D] to [C], differentiable by torch
autograd. A transition takes its random draws as an argument
(:func:`hmc_draws`), so that a caller can feed it another generator's
draws, the JAX package's included.
"""
from typing import NamedTuple

import torch

from ..util.trace import span


class HMCState(NamedTuple):
    q: torch.Tensor         # [C, D] positions
    logp: torch.Tensor      # [C] log density at q
    grad: torch.Tensor      # [C, D] its gradient at q


def value_and_grad(logp_fn, q):
    """``logp_fn(q)`` [C] and its gradient in q [C, D], detached, on q's
    device and in float32. A row where the density is not finite gets
    whatever autograd gives there; the other rows are not touched by it.
    Runs in a ``torch.profiler`` range named ``value_and_grad``."""
    with span('value_and_grad'), \
            torch.enable_grad():
        q = q.detach().requires_grad_(True)
        logp = logp_fn(q)
        grad, = torch.autograd.grad(logp.sum(), q)
    return (logp.detach().to(q.device, torch.float32),
            grad.detach().to(q.device, torch.float32))


def hmc_init(logp_fn, q0):
    """The state at positions q0 [C, D]."""
    q0 = torch.as_tensor(q0, dtype=torch.float32)
    logp, grad = value_and_grad(logp_fn, q0)
    return HMCState(q=q0, logp=logp, grad=grad)


def _draw_on(generator, device, *shape, uniform=False):
    """Draws made on the generator's own device, then moved to ``device``:
    the same generator gives the same draws whatever the chains' device."""
    fn = torch.rand if uniform else torch.randn
    return fn(*shape, generator=generator,
              device=generator.device).to(device)


def hmc_draws(generator, n_chains, n_dims, device='cpu'):
    """The draws of one :func:`hmc_step`: standard-normal momenta ``p0``
    [C, D] (scaled by the step's inverse mass) and the acceptance uniforms
    ``u`` [C]."""
    return {'p0': _draw_on(generator, device, n_chains, n_dims),
            'u': _draw_on(generator, device, n_chains, uniform=True)}


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1)


def leapfrog(logp_and_grad, q, p, grad, logp, step_size, inv_mass, n_steps):
    """``n_steps`` velocity-Verlet steps from (q, p) with the gradient
    ``grad`` and density ``logp`` at q; returns the final (q, p, logp,
    grad). ``logp_and_grad`` maps q [C, D] to (logp [C], grad [C, D])."""
    for _ in range(n_steps):
        p = p + 0.5 * step_size * grad
        q = q + step_size * inv_mass * p
        logp, grad = logp_and_grad(q)
        p = p + 0.5 * step_size * grad
    return q, p, logp, grad


def hmc_step(draws, state, logp_fn, step_size, inv_mass, n_steps):
    """One HMC transition of every chain, with Metropolis correction.

    ``draws`` is :func:`hmc_draws`'s output. Returns (new state, info with
    ``accept_prob``, ``divergent`` and ``energy``, each [C])."""
    def logp_and_grad(q):
        return value_and_grad(logp_fn, q)

    p0 = draws['p0'] / torch.sqrt(inv_mass)
    h0 = -state.logp + _kinetic(p0, inv_mass)
    q, p, logp, grad = leapfrog(logp_and_grad, state.q, p0, state.grad,
                                state.logp, step_size, inv_mass, n_steps)
    h1 = -logp + _kinetic(p, inv_mass)
    delta = h0 - h1
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    accept_prob = torch.clamp(torch.exp(delta), max=1.0)
    divergent = (h1 - h0) > 1000.0
    accept = draws['u'] < accept_prob
    new_state = HMCState(
        q=torch.where(accept[:, None], q, state.q),
        logp=torch.where(accept, logp, state.logp),
        grad=torch.where(accept[:, None], grad, state.grad))
    return new_state, {'accept_prob': accept_prob, 'divergent': divergent,
                       'energy': h1}

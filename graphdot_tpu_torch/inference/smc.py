"""Sequential Monte Carlo over tempered posteriors; counterpart of
``graphdot_tpu/inference/smc.py``.

The particles are the leading axis of every tensor, where the JAX module
ran them under ``jax.vmap``. Adaptive tempering chooses each temperature
increment so that the effective sample size stays at a target fraction,
with systematic resampling and random-walk, HMC or NUTS mutation moves.
"""
import math

import torch

from .hmc import _draw_on, hmc_draws, hmc_init, hmc_step
from .nuts import nuts_draws, nuts_step


def _systematic_resample(generator, log_w, n):
    w = torch.softmax(log_w, dim=0)
    cum = torch.cumsum(w, dim=0)
    u = (_draw_on(generator, log_w.device, 1, uniform=True)
         + torch.arange(n, device=log_w.device)) / n
    return torch.searchsorted(cum, u, right=True).clamp(0, n - 1)


def _ess(log_w):
    w = torch.softmax(log_w, dim=0)
    return 1.0 / torch.sum(w * w)


def _next_beta(log_like, beta, target_frac, n):
    """The largest beta' in (beta, 1] whose incremental weights keep the
    ESS >= target_frac * n, by bisection (at most 50 halvings, to 1e-6)."""
    def ess_at(b):
        lw = (b - beta) * log_like
        return float(_ess(lw - torch.max(lw)))

    target = target_frac * n
    if ess_at(1.0) >= target:
        return 1.0
    lo, hi = torch.tensor(beta), torch.tensor(1.0)   # float32, as in JAX
    for _ in range(50):
        if not hi - lo > 1e-6:
            break
        mid = 0.5 * (lo + hi)
        if ess_at(float(mid)) >= target:
            lo = mid
        else:
            hi = mid
    return float(lo)


def smc_sample(log_prior, log_like, generator, n_particles=256, init=None,
               n_moves=3, step_size=0.2, target_frac=0.5, max_stages=50,
               moves='rw', use_hmc=False, n_leapfrog=8, max_depth=6,
               device='cuda'):
    """SMC sampling of p(t) ∝ exp(log_prior(t) + log_like(t)).

    Parameters
    ----------
    log_prior, log_like: callables [N, D] -> [N], differentiable by torch
        autograd for the gradient moves.
    generator: torch.Generator of every draw.
    init: [n_particles, D] initial draws from the prior.
    moves: 'rw' | 'hmc' | 'nuts', the mutation kernel at each tempering
        stage. Random-walk MH is cheapest per move; gradient moves mix far
        better for high-dimensional hyperparameter posteriors.
    use_hmc: deprecated alias for ``moves='hmc'``.
    max_depth: NUTS tree-depth bound for ``moves='nuts'``.
    device: the particles' device.

    The JAX module's ``mesh``/``particle_axis`` (particles sharded over
    devices) waits for the port's multi-GPU work.

    Returns
    -------
    dict with 'samples' [n_particles, D], 'log_evidence', 'n_stages',
    'beta_history'.
    """
    if use_hmc:
        moves = 'hmc'
    if moves not in ('rw', 'hmc', 'nuts'):
        raise ValueError(f"unknown mutation kernel {moves!r}")
    device = torch.device(device)
    particles = torch.as_tensor(init, dtype=torch.float32).to(device)
    n, D = particles.shape
    ones = torch.ones(D, device=device)

    def mutate(particles, beta, eps):
        """A few MCMC moves targeting prior * like^beta; returns the
        particles and the mean acceptance."""
        def logp(t):
            return log_prior(t) + beta * log_like(t)

        accs = []
        if moves in ('hmc', 'nuts'):
            states = hmc_init(logp, particles)
            for _ in range(n_moves):
                if moves == 'hmc':
                    states, infos = hmc_step(
                        hmc_draws(generator, n, D, device), states, logp,
                        eps, ones, n_leapfrog)
                else:
                    states, infos = nuts_step(
                        nuts_draws(generator, n, D, max_depth, device),
                        states, logp, eps, ones, max_depth=max_depth)
                accs.append(torch.mean(infos['accept_prob']))
            return states.q, float(torch.stack(accs).mean())
        with torch.no_grad():
            lp = logp(particles)
            for _ in range(n_moves):
                prop = particles + eps * _draw_on(generator, device, n, D)
                lp_prop = logp(prop)
                accept = torch.log(_draw_on(generator, device, n,
                                            uniform=True)) < lp_prop - lp
                particles = torch.where(accept[:, None], prop, particles)
                lp = torch.where(accept, lp_prop, lp)
                accs.append(accept.float().mean())
        return particles, float(torch.stack(accs).mean())

    beta = 0.0
    log_evidence = 0.0
    betas = []
    stage = 0
    eps = step_size
    while beta < 1.0 and stage < max_stages:
        with torch.no_grad():
            ll = log_like(particles)
        new_beta = _next_beta(ll, beta, target_frac, n)
        lw = (new_beta - beta) * ll
        log_evidence += float(torch.logsumexp(lw, dim=0) - math.log(n))
        particles = particles[_systematic_resample(generator, lw, n)]
        particles, acc = mutate(particles, new_beta, eps)
        # crude step-size control: toward ~30% acceptance for RW,
        # toward the ~80% canonical target for gradient moves
        if moves == 'rw':
            eps = eps * (1.3 if acc > 0.4 else (0.7 if acc < 0.2 else 1.0))
        else:
            eps = eps * (1.2 if acc > 0.9 else (0.7 if acc < 0.6 else 1.0))
        betas.append(new_beta)
        beta = new_beta
        stage += 1

    return {
        'samples': particles,
        'log_evidence': log_evidence,
        'n_stages': stage,
        'beta_history': betas,
    }

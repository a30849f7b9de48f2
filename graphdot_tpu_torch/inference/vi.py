"""Automatic-differentiation variational inference (mean-field Gaussian);
counterpart of ``graphdot_tpu/inference/vi.py``.

Fits q(t) = N(mu, diag(exp(log_sigma)^2)) to a log density by maximizing
the reparameterized ELBO with Adam at optax's defaults (betas 0.9 and
0.999, eps 1e-8), after clipping the gradient's global norm to 100, as the
JAX module's ``optax.chain`` does.
"""
import math

import torch

from .hmc import _draw_on

#: the largest global norm of a step's gradient (optax.clip_by_global_norm)
CLIP_NORM = 100.0


def advi(logp_fn, generator, init, n_steps=1000, n_mc=8, learning_rate=1e-2,
         device='cuda'):
    """Mean-field ADVI.

    Parameters
    ----------
    logp_fn: callable [n_mc, D] -> [n_mc] log density, differentiable by
        torch autograd.
    generator: torch.Generator of the Monte Carlo draws.
    init: [D] initial mean.
    device: the variational parameters' device.

    A step whose ELBO or gradient is not finite (a draw where the density
    overflows) leaves the parameters and Adam's state as they were.

    Returns
    -------
    dict with 'mu', 'sigma', 'elbo_history', and a 'sample(generator, n)'
    callable giving [n, D] draws of q.
    """
    device = torch.device(device)
    mu = torch.as_tensor(init, dtype=torch.float32).to(device).clone()
    D = mu.shape[0]
    mu.requires_grad_(True)
    log_sigma = torch.full((D,), -2.0, device=device, requires_grad=True)
    params = [mu, log_sigma]
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    entropy_const = 0.5 * D * (1.0 + math.log(2.0 * math.pi))

    history = []
    for _ in range(n_steps):
        eps = _draw_on(generator, device, n_mc, D)
        opt.zero_grad()
        ts = mu[None, :] + eps * torch.exp(log_sigma)[None, :]
        elbo = torch.mean(logp_fn(ts)) + torch.sum(log_sigma) + entropy_const
        (-elbo).backward()
        grads = [p.grad for p in params]
        ok = bool(torch.isfinite(elbo)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        if ok:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if norm >= CLIP_NORM:
                for g in grads:
                    g.mul_(CLIP_NORM / norm)
            opt.step()
        history.append(float(elbo.detach()))

    mu = mu.detach()
    sigma = torch.exp(log_sigma.detach())

    def sample(generator, n):
        return mu[None, :] + _draw_on(generator, device, n, D) * sigma[None, :]

    return {
        'mu': mu,
        'sigma': sigma,
        'elbo_history': torch.tensor(history),
        'sample': sample,
    }

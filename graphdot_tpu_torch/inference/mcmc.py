"""MCMC sampling: multi-chain NUTS or HMC with Stan-style warmup windows;
counterpart of ``graphdot_tpu/inference/mcmc.py``.

The chains are the leading axis of every tensor, where the JAX module ran
them under ``jax.vmap``: each transition evaluates the log density of all
live chains in one call. Adaptation statistics are pooled across chains by
plain means. Over a mesh (``mesh``, ``chain_axis``) each rank advances its
block of the chains, and the pooled statistics and the samples are
gathered from all ranks first, so that a sharded run equals the unsharded
one draw for draw when the log density gives each row the same bits
whatever rows share its call. ``GPRLogProb`` does on the CPU; on CUDA a
row's value changes in its last bits with the rows beside it, so sharded
chains there equal unsharded ones only to rounding, and drift apart over a
run.
"""
import math

import torch

from ..parallel.mesh import replicated, sharded_along

from .dual_averaging import (da_init, da_update, welford_init,
                             welford_update, welford_variance)
from .hmc import (HMCState, _draw_on, _kinetic, hmc_draws, hmc_init,
                  hmc_step, leapfrog, value_and_grad)
from .nuts import nuts_draws, nuts_step


def _transition(algorithm, max_depth, n_leapfrog):
    """(draws(generator, C, D, device), step(draws, state, logp_fn,
    step_size, inv_mass)) of ``algorithm``."""
    if algorithm == 'nuts':
        def draw(generator, n_chains, n_dims, device):
            return nuts_draws(generator, n_chains, n_dims, max_depth, device)

        def step(draws, state, logp_fn, step_size, inv_mass):
            return nuts_step(draws, state, logp_fn, step_size, inv_mass,
                             max_depth=max_depth)
    elif algorithm == 'hmc':
        draw = hmc_draws

        def step(draws, state, logp_fn, step_size, inv_mass):
            return hmc_step(draws, state, logp_fn, step_size, inv_mass,
                            n_leapfrog)
    else:
        raise ValueError(f'Unknown algorithm {algorithm!r}')
    return draw, step


def _find_reasonable_step_size(logp_fn, state, inv_mass, generator):
    """Crude bracketing of an initial step size by the one-step energy
    error of the first chain (Hoffman & Gelman 2014, Alg. 4 in spirit):
    halve from 1 while the error exceeds log 2, at most 30 times."""
    q, logp, grad = state.q[:1], state.logp[:1], state.grad[:1]
    p0 = _draw_on(generator, q.device, *q.shape) / torch.sqrt(inv_mass)
    h0 = -logp + _kinetic(p0, inv_mass)

    def err(eps):
        _, p, logp1, _ = leapfrog(lambda x: value_and_grad(logp_fn, x), q,
                                  p0, grad, logp, eps, inv_mass, 1)
        h = -logp1 + _kinetic(p, inv_mass)
        return float(torch.where(torch.isnan(h), torch.inf, h) - h0)

    eps = torch.tensor(1.0, device=q.device)
    it = 0
    while err(eps) > math.log(2.0) and it < 30:
        eps = eps * 0.5
        it += 1
    return eps


def warmup_windows(n_warmup):
    """Stan-style warmup: (initial fast window, the doubling slow windows
    that adapt the mass matrix, final fast window), in transitions: 15 %
    fast, slow windows from max(10, slow // 8) doubling, a trailing window
    shorter than 10 absorbed, 10 % fast."""
    n_fast1 = max(1, int(0.15 * n_warmup))
    n_fast2 = max(1, int(0.10 * n_warmup))
    n_slow = max(1, n_warmup - n_fast1 - n_fast2)
    windows = []
    w = max(10, n_slow // 8)
    remaining = n_slow
    while remaining > 0:
        take = min(w, remaining)
        # absorb a too-small trailing window
        if remaining - take < 10:
            take = remaining
        windows.append(take)
        w *= 2
        remaining -= take
    return n_fast1, windows, n_fast2


def sample(logp_fn, generator, n_chains=4, n_warmup=300, n_samples=500,
           init=None, algorithm='nuts', max_depth=8, n_leapfrog=32,
           target_accept=0.8, init_jitter=1.0, thin=1, mesh=None,
           chain_axis='chains', step_size=None, inv_mass=None,
           device='cuda'):
    """Run multi-chain MCMC over ``logp_fn``.

    Parameters
    ----------
    logp_fn: callable [C, D] -> [C] log density, differentiable by torch
        autograd (the chains are its leading axis). Wrap a function of one
        position [D] -> scalar with ``torch.func.vmap``.
    generator: torch.Generator of every draw (initial jitter, the step-size
        search, the transitions), in that order.
    init: [D] or [n_chains, D] initial positions; a [D] start is jittered
        by ``init_jitter`` standard normals a chain.
    algorithm: 'nuts' or 'hmc'.
    mesh: optional :class:`~graphdot_tpu_torch.parallel.Mesh`. The chains
        split over the ranks along ``chain_axis`` in equal blocks (which
        must divide ``n_chains``), and each rank advances its block: every
        rank makes all the chains' draws from ``generator`` (the same seed
        on every rank) and takes its block's, and the mean accept of dual
        averaging, the mass matrix's variance over the chains and the
        samples are gathered from all ranks before they are reduced or
        returned. The run is then the unsharded one, draw for draw, when
        ``logp_fn`` gives each row the same bits whatever rows share its
        call; ``GPRLogProb`` on CUDA does not (the module docstring), and
        there the two runs agree only to rounding.
    step_size, inv_mass: both given resume a run with these adaptation
        products (:func:`~.checkpoint.resume_state`) and skip warmup.
    device: the chains' tensors (positions, momenta, tree state) live here;
        ``logp_fn`` is handed them there and its values are moved there.

    The JAX ``sample``'s ``loop`` is not ported: ``'scan'`` is an XLA
    construct, and the port has one Python-driven loop, the JAX
    ``sample``'s ``'host'``.

    Returns
    -------
    dict with 'samples' [n_chains, n_samples, D], 'logp', 'accept_prob'
    and 'divergent' [n_chains, n_samples], 'step_size' (a float) and
    'inv_mass' [D]; over a mesh, all the chains' on every rank.
    """
    device = torch.device(device)
    init = torch.atleast_1d(torch.as_tensor(init, dtype=torch.float32)) \
        .to(device)
    D = init.shape[-1]
    if init.dim() == 1:
        init = init[None, :] + init_jitter * _draw_on(
            generator, device, n_chains, D)
    n_chains = init.shape[0]
    rows = replicated(mesh)
    if mesh is not None:
        n_dev = mesh.axis_size(chain_axis)
        assert n_chains % n_dev == 0, (
            f'n_chains={n_chains} must be a multiple of the '
            f'{chain_axis!r} mesh axis size {n_dev}')
        rows = sharded_along(mesh, chain_axis)
    transition, step = _transition(algorithm, max_depth, n_leapfrog)

    def draw():
        """The draws of all the chains' next transition, this rank's
        rows"""
        return {k: rows.local(v) for k, v in transition(
            generator, n_chains, D, device).items()}

    states = hmc_init(logp_fn, rows.local(init))

    # resume path: with both adaptation products supplied, skip warmup
    # entirely (see .checkpoint.resume_state)
    if step_size is not None and inv_mass is not None:
        return _run_sampling_only(
            logp_fn, draw, step, rows, states, float(step_size),
            torch.as_tensor(inv_mass, dtype=torch.float32).to(device),
            n_samples, thin)

    inv_mass = torch.ones(D, device=device)
    # the first chain's state, from the rank that holds it
    first = HMCState(*(rows.gather(v)[:1] for v in states))
    eps0 = _find_reasonable_step_size(logp_fn, first, inv_mass, generator)

    def run_window(states, da, welford, inv_mass, n_steps, adapt_mass):
        for _ in range(n_steps):
            states, infos = step(draw(), states, logp_fn,
                                 torch.exp(da.log_step), inv_mass)
            da = da_update(
                da, torch.mean(rows.gather(infos['accept_prob'])),
                target=target_accept)
            if adapt_mass:
                welford = welford_update(welford, states.q)
        return states, da, welford

    n_fast1, windows, n_fast2 = warmup_windows(n_warmup)
    C = states.q.shape[0]
    da = da_init(eps0)
    welford = welford_init(C, D, device=device)
    states, da, welford = run_window(states, da, welford, inv_mass,
                                     n_fast1, False)
    for wn in windows:
        states, da, welford = run_window(states, da, welford, inv_mass, wn,
                                         True)
        inv_mass = 1.0 / torch.mean(
            rows.gather(welford_variance(welford)), dim=0)
        welford = welford_init(C, D, device=device)
        da = da_init(torch.exp(da.log_step_avg))
    states, da, welford = run_window(states, da, welford, inv_mass,
                                     n_fast2, False)
    return _run_sampling_only(
        logp_fn, draw, step, rows, states,
        float(torch.exp(da.log_step_avg)), inv_mass, n_samples, thin)


def _run_sampling_only(logp_fn, draw, step, rows, states, step_size,
                       inv_mass, n_samples, thin):
    qs, logps, acc, div = [], [], [], []
    for _ in range(n_samples):
        for _ in range(thin):
            states, infos = step(draw(), states, logp_fn, step_size,
                                 inv_mass)
        qs.append(states.q)
        logps.append(states.logp)
        acc.append(infos['accept_prob'])
        div.append(infos['divergent'])
    return {
        # [chains, samples, D], every rank's chains
        'samples': rows.gather(torch.stack(qs, dim=1)),
        'logp': rows.gather(torch.stack(logps, dim=1)),
        'accept_prob': rows.gather(torch.stack(acc, dim=1)),
        'divergent': rows.gather(torch.stack(div, dim=1)),
        'step_size': step_size,
        'inv_mass': inv_mass,
    }

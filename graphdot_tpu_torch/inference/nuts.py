"""No-U-Turn Sampler (iterative, multinomial), batched over chains;
counterpart of the flat ``nuts_step`` of ``graphdot_tpu/inference/nuts.py``.

Multinomial NUTS (Hoffman & Gelman 2014; Betancourt 2017) with the
checkpoint-based iterative tree expansion (Phan & Pradhan 2019): one loop,
one leapfrog of every live chain an iteration. The chain axis leads every
tensor, where the JAX module ran its while loop under ``jax.vmap``. A chain
whose tree has stopped is masked: its state is kept, and only the live
chains' positions go to the log density at each iteration.

U-turn bookkeeping: leaves of a depth-d subtree are visited left to right;
leaf m starts a nested subtree iff its low bits are zero, and the live
checkpoint-stack depth at that moment equals popcount(m), so the starting
momentum and running momentum sum are stored at slot popcount(m). Leaf n
closes subtrees of sizes 2^1..2^t where t = trailing_ones(n), whose
checkpoints live at slots popcount(n)-t .. popcount(n)-1.

The transition takes its random draws as one argument (:func:`nuts_draws`),
laid out as the JAX module folds its keys, so that it reproduces the JAX
transition draw for draw when fed the JAX draws. The JAX module's
nested-loop ``_nuts_step_nested`` is its own oracle and is not ported.
"""
from typing import NamedTuple

import torch

from .hmc import HMCState, _draw_on, value_and_grad

_DIVERGENCE = 1000.0


class _Leaf(NamedTuple):
    q: torch.Tensor         # [C, D]
    p: torch.Tensor         # [C, D]
    grad: torch.Tensor      # [C, D]
    logp: torch.Tensor      # [C]


def _where(mask, a, b):
    """Row-wise select of two leaves (or tensors) by a [C] mask."""
    if isinstance(a, _Leaf):
        return _Leaf(*(_where(mask, x, y) for x, y in zip(a, b)))
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, b)


def _energy(leaf, inv_mass):
    return -leaf.logp + 0.5 * torch.sum(inv_mass * leaf.p * leaf.p, dim=-1)


def _popcount(n, bits):
    """Set bits of each entry of an int tensor of entries below 2^bits."""
    count = torch.zeros_like(n)
    for _ in range(bits):
        count = count + (n & 1)
        n = n >> 1
    return count


def _trailing_ones(n, bits):
    """Trailing one bits of each entry (below 2^bits - 1):
    popcount(((n+1) & -(n+1)) - 1)."""
    u = n + 1
    return _popcount((u & -u) - 1, bits)


def _is_turning(rsum, p_start, p_end, inv_mass):
    v = inv_mass * rsum
    return (torch.sum(v * p_start, dim=-1) <= 0) | \
        (torch.sum(v * p_end, dim=-1) <= 0)


def nuts_draws(generator, n_chains, n_dims, max_depth, device='cpu'):
    """The draws of one :func:`nuts_step`, made on the generator's device
    and moved to ``device``:

    - ``p0`` [C, D]: standard-normal momenta (the step scales them by
      1 / sqrt(inv_mass)); JAX's ``normal(k_mom)``;
    - ``direction`` [C, max_depth] bool: the direction of doubling d is
      forward where True; JAX's ``bernoulli(fold_in(k_tree, 2d))``;
    - ``within`` [C, max_depth, 2^(max_depth-1)]: the uniform of leaf j of
      doubling d's subtree; JAX's ``uniform(fold_in(fold_in(k_tree,
      2d+1), j))``;
    - ``merge`` [C, max_depth]: the uniform of doubling d's merge; JAX's
      ``uniform(fold_in(k_tree, 2d+11311))``.
    """
    half = 1 << (max_depth - 1)
    return {
        'p0': _draw_on(generator, device, n_chains, n_dims),
        'direction': _draw_on(generator, device, n_chains, max_depth,
                              uniform=True) < 0.5,
        'within': _draw_on(generator, device, n_chains, max_depth, half,
                           uniform=True),
        'merge': _draw_on(generator, device, n_chains, max_depth,
                          uniform=True),
    }


def nuts_step(draws, state, logp_fn, step_size, inv_mass, max_depth=8):
    """One NUTS transition of every chain: one loop that advances each live
    chain by one leapfrog an iteration, until every chain's tree has
    stopped (a U-turn, a divergence or ``max_depth`` doublings).

    Parameters
    ----------
    draws: :func:`nuts_draws`'s output for these chains and ``max_depth``.
    state: HMCState of [C, D] / [C] tensors.
    logp_fn: callable [B, D] -> [B] log density, differentiable by torch
        autograd; called on the live chains' positions only.
    step_size: float or scalar tensor.
    inv_mass: [D] diagonal inverse mass.
    max_depth: maximum number of tree doublings.

    Returns
    -------
    (new_state, info) where info holds, each [C], ``accept_prob`` (the
    dual-averaging statistic), ``divergent``, ``depth`` (doublings begun),
    ``n_leapfrog`` and ``energy`` (-logp at the new state).
    """
    q0 = state.q
    C, D = q0.shape
    device = q0.device
    inv_mass = torch.as_tensor(inv_mass, dtype=torch.float32, device=device)
    step_size = torch.as_tensor(step_size, dtype=torch.float32,
                                device=device)
    p0 = draws['p0'] / torch.sqrt(inv_mass)
    z0 = _Leaf(q=q0, p=p0, grad=state.grad, logp=state.logp)
    h0 = _energy(z0, inv_mass)
    rows = torch.arange(C, device=device)
    slots = torch.arange(max_depth + 1, device=device)
    zeros_i = torch.zeros(C, dtype=torch.long, device=device)
    false = torch.zeros(C, dtype=torch.bool, device=device)
    inf = torch.full((C,), torch.inf, device=device)

    c = dict(
        d=zeros_i,                    # current doubling
        j=zeros_i,                    # leaf index within the subtree
        v=torch.ones(C, device=device),   # current direction
        z=z0,                         # integration edge being extended
        z_left=z0, z_right=z0,
        prop=z0,                      # tree-level proposal
        logsumw=torch.zeros(C, device=device),  # tree-level weight
        rsum=p0,                      # tree-level momentum sum
        sub_prop=z0, sub_logsumw=-inf, sub_rsum=torch.zeros_like(p0),
        ckpt_r=torch.zeros(C, max_depth + 1, D, device=device),
        ckpt_rsum=torch.zeros(C, max_depth + 1, D, device=device),
        sum_acc=torch.zeros(C, device=device),
        n_leapfrog=zeros_i, depth=zeros_i,
        stop=false, divergent=false,
    )

    while True:
        live = ~c['stop'] & (c['d'] < max_depth)
        if not bool(live.any()):
            break
        d, j = c['d'], c['j']
        dd = d.clamp(max=max_depth - 1)

        # -- subtree start: pick a direction, reset subtree state ---------
        starting = j == 0
        v_new = torch.where(draws['direction'][rows, dd], 1.0, -1.0)
        v = torch.where(starting, v_new, c['v'])
        edge = _where(v > 0, c['z_right'], c['z_left'])
        z = _where(starting, edge, c['z'])
        sub_logsumw = torch.where(starting, -torch.inf, c['sub_logsumw'])
        sub_rsum = _where(starting, torch.zeros_like(p0), c['sub_rsum'])
        depth = c['depth'] + starting.long()

        # -- one leapfrog of the live chains ------------------------------
        eps = v * step_size
        p = z.p + (0.5 * eps)[:, None] * z.grad
        q = z.q + eps[:, None] * inv_mass * p
        idx = torch.nonzero(live).squeeze(1)
        logp_live, grad_live = value_and_grad(logp_fn, q[idx])
        logp, grad = z.logp.clone(), z.grad.clone()
        logp[idx] = logp_live
        grad[idx] = grad_live
        p = p + (0.5 * eps)[:, None] * grad
        z = _Leaf(q=q, p=p, grad=grad, logp=logp)

        # -- within-subtree multinomial proposal --------------------------
        h = _energy(z, inv_mass)
        h = torch.where(torch.isnan(h), torch.inf, h)
        log_w = h0 - h
        divergent = (h - h0) > _DIVERGENCE
        sub_logsumw_new = torch.logaddexp(sub_logsumw, log_w)
        u = draws['within'][rows, dd, j.clamp(
            max=draws['within'].shape[-1] - 1)]
        # the first leaf always seeds the subtree proposal: sub_logsumw
        # is -inf at a subtree start, so take is True by construction
        take = torch.log(u) < log_w - sub_logsumw_new
        sub_prop = _where(take, z, c['sub_prop'])
        sum_acc = c['sum_acc'] + torch.clamp(torch.exp(log_w), max=1.0)

        # -- checkpoint bookkeeping for within-subtree U-turns ------------
        rsum_before = sub_rsum
        sub_rsum = rsum_before + z.p
        pc = _popcount(j, max_depth)
        is_start = (j % 2) == 0
        at = is_start[:, None] & (slots[None, :] == pc[:, None])
        ckpt_r = torch.where(at[..., None], z.p[:, None, :], c['ckpt_r'])
        ckpt_rsum = torch.where(at[..., None], rsum_before[:, None, :],
                                c['ckpt_rsum'])
        t = _trailing_ones(j, max_depth)
        # the subtrees that leaf j closes: slots pc - t .. pc - 1
        closing = (slots[None, :] >= (pc - t)[:, None]) & \
            (slots[None, :] < pc[:, None])
        turn = _is_turning(sub_rsum[:, None, :] - ckpt_rsum, ckpt_r,
                           z.p[:, None, :], inv_mass)
        sub_turning = (closing & turn).any(dim=1)

        j = j + 1
        n_leapfrog = c['n_leapfrog'] + 1
        complete = j >= (torch.ones_like(d) << d)
        aborted = sub_turning | divergent

        # -- doubling merge (only when the subtree completed cleanly) -----
        ok = complete & ~aborted
        take2 = ok & (torch.log(draws['merge'][rows, dd])
                      < sub_logsumw_new - c['logsumw'])
        prop = _where(take2, sub_prop, c['prop'])
        z_left = _where((v < 0) & ok, z, c['z_left'])
        z_right = _where((v > 0) & ok, z, c['z_right'])
        rsum = _where(ok, c['rsum'] + sub_rsum, c['rsum'])
        logsumw = torch.where(
            ok, torch.logaddexp(c['logsumw'], sub_logsumw_new), c['logsumw'])
        whole_turn = _is_turning(rsum, z_left.p, z_right.p, inv_mass)
        stop = aborted | (complete & (~ok | whole_turn))

        new = dict(
            d=d + complete.long(), j=torch.where(complete, 0, j), v=v, z=z,
            z_left=z_left, z_right=z_right, prop=prop, logsumw=logsumw,
            rsum=rsum, sub_prop=sub_prop, sub_logsumw=sub_logsumw_new,
            sub_rsum=sub_rsum, ckpt_r=ckpt_r, ckpt_rsum=ckpt_rsum,
            sum_acc=sum_acc, n_leapfrog=n_leapfrog, depth=depth, stop=stop,
            divergent=c['divergent'] | divergent)
        # a chain whose tree has stopped keeps its state
        c = {k: _where(live, new[k], c[k]) for k in c}

    prop = c['prop']
    new_state = HMCState(q=prop.q, logp=prop.logp, grad=prop.grad)
    info = {
        'accept_prob': c['sum_acc'] / torch.clamp(
            c['n_leapfrog'].float(), min=1.0),
        'divergent': c['divergent'],
        'depth': c['depth'],
        'n_leapfrog': c['n_leapfrog'],
        'energy': -prop.logp,
    }
    return new_state, info

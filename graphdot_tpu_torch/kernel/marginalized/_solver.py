"""Batched product-graph MLGK solver, values and hyperparameter tangents;
counterpart of ``graphdot_tpu/kernel/marginalized/_solver.py``.

Each graph pair's system is the generalized Kronecker system of the dense
oracle in ``tests/oracle.py``:
``[diag(Dx/Vx) - (A1 (x) A2) . Ex] x = Dx`` with ``Dx = kron(D1, D2)/(1-q)^2``
and the kernel value ``K = sum_ij p1_i p2_j x_ij``.

The off-diagonal matvec is the dense coupling tensor (``mode='dense'``),
the edge-factored form with per-pair edge-coupling matrix
``T[e1,e2] = w1 w2 k_edge(e1,e2)`` over the directed edge lists (``'edge'``
in plain torch, ``'cuda'`` in the CUDA PCG kernels), or the
sum-of-Kronecker form of :mod:`._kron` (``'kron'``: two batched products
over Chebyshev factors, no T). :func:`solve_route` names the route of each
chunk before any launch: ``pcg_resident`` (``pcg_packed`` for tangents),
``pcg_stream`` or kron. The batched PCG loop itself lives in
:mod:`graphdot_tpu_torch.ops.pcg`, where the kernels' plain twins share it.

Gradients in the hyperparameters theta are forward mode, as the JAX
package's ``jax.jacfwd`` through ``lax.custom_linear_solve``: for every
direction d, ``A x_d = b_d - A_d x`` with the same A, where ``A_d`` and
``b_d`` come from ``torch.func.jacfwd`` of :func:`mlgk_setup`'s elementwise
part (:func:`mlgk_tangents`). Mode ``'cuda'`` solves a pair's n_theta
tangent systems as one group of ``pcg_packed`` (:func:`cuda_tangent_solver`).
:func:`solve_linear` is the reverse-mode counterpart of
``custom_linear_solve``, a ``torch.autograd.Function``.
"""
import functools

import torch

from ...ops.pcg import (gather_offdiag, largest_packed_k, offdiag_operator,
                        pcg, pcg_packed, pcg_resident, pcg_stream,
                        resident_fits)
from ._kron import (fold_side_2, kron_factors,
                    kron_grid_kernel, kron_offdiag, kron_pcg,
                    kron_tangent_offdiag)

#: mode ``'cuda'`` sends a pair that does not fit a block to kron only
#: when its padded product space n1 * n2 exceeds this (and its edge
#: kernel is kron-eligible and calibrated); the counterpart of the JAX
#: package's ``GRAPHDOT_KRON_MIN_N`` (0 on the TPU). On an H100, over
#: three runs of ``chip_smoke.py`` phase 16's ladder, kron's value Gram
#: lost to ``pcg_stream``'s on proteins at n = 96 twice (and tied once),
#: tied or won at n = 120, won from n = 160 on, and lost on molecules at
#: n = 72 (``PERF.md``, section 6): 96^2
KRON_MIN_N = 9216

# ---------------------------------------------------------------------------
# feature pytree helpers
# ---------------------------------------------------------------------------


def _expand(feat, axes):
    """Insert broadcast axes into a feature (tensor or (values, mask))."""
    if isinstance(feat, tuple):
        v, m = feat
        for ax in axes:
            v = v.unsqueeze(ax)
            m = m.unsqueeze(ax)
        return (v, m)
    for ax in axes:
        feat = feat.unsqueeze(ax)
    return feat


def _expand_dict(feats, axes):
    return {k: _expand(v, axes) for k, v in feats.items()}


def _apply_on_features(kernel, theta, X, Y):
    """Recursively evaluate ``kernel`` on dict features: composites index
    the dict themselves; elementary kernels are fed the single column."""
    name = kernel.name
    if name == 'Composite':
        return kernel.apply(theta, X, Y)
    if name == 'Normalize':
        Fxy = _apply_on_features(kernel.kernel, theta, X, Y)
        Fxx = _apply_on_features(kernel.kernel, theta, X, X)
        Fyy = _apply_on_features(kernel.kernel, theta, Y, Y)
        den = torch.sqrt(Fxx * Fyy)
        ok = den > 0
        return torch.where(ok, Fxy / torch.where(ok, den, 1.0), 0.0)
    if name in ('Add', 'Multiply', 'Exponentiation'):
        n1 = kernel.k1.n_theta
        f1 = _apply_on_features(kernel.k1, theta[:n1], X, Y)
        f2 = _apply_on_features(
            kernel.k2, theta[n1:kernel.n_theta], X, Y
        )
        if name == 'Add':
            return f1 + f2
        elif name == 'Multiply':
            return f1 * f2
        else:
            return f1 ** f2
    # elementary kernel on a single feature column
    if isinstance(X, dict):
        if len(X) == 1:
            (x,) = X.values()
            (y,) = Y.values()
            return kernel.apply(theta, x, y)
        elif kernel.n_theta > 0 and kernel.name == 'Constant':
            # Constant ignores features; use any column for shape
            x = next(iter(X.values()))
            y = next(iter(Y.values()))
            return kernel.apply(theta, x, y)
        else:
            raise ValueError(
                f'Elementary kernel {kernel.name} cannot consume '
                f'multi-column features {list(X)}; wrap it in '
                'TensorProduct/Additive.'
            )
    return kernel.apply(theta, X, Y)


# ---------------------------------------------------------------------------
# the batched MLGK solve
# ---------------------------------------------------------------------------


def solve_route(mode, fits, eligible, ranks, n1n2, kron_min_n=None):
    """The route of a chunk of pairs, named before any launch: ``'kron'``,
    ``'resident'`` (``pcg_resident``, and ``pcg_packed`` for tangents),
    ``'stream'`` (``pcg_stream``), or the plain mode (``'edge'``,
    ``'dense'``).

    Mode ``'kron'`` solves every pair by kron. Mode ``'cuda'`` keeps a chunk
    whose pairs ``fits`` a block in ``pcg_resident``; otherwise it takes
    kron when the edge features are ``eligible`` (:func:`._kron.
    kron_eligible`), the ``ranks`` are calibrated (not None, not ``'off'``)
    and the padded product space ``n1n2`` exceeds ``kron_min_n`` (default
    :data:`KRON_MIN_N`), and ``pcg_stream`` else. No route stands in for
    another after a failure."""
    if mode == 'kron':
        return 'kron'
    if mode != 'cuda':
        return mode
    if fits:
        return 'resident'
    if kron_min_n is None:
        kron_min_n = KRON_MIN_N
    if eligible and ranks is not None and ranks != 'off' \
            and n1n2 > kron_min_n:
        return 'kron'
    return 'stream'


def chunk_route(mode, M1, M2, N1, N2, device, eligible=False, ranks=None):
    """:func:`solve_route` for pairs of these shapes on ``device``: they fit
    a block when :func:`resident_fits` says so on a CUDA device (its shared
    memory, and the registers of the CG state of its product nodes), and
    always on the CPU, where the resident route runs its plain twin."""
    device = torch.device(device)
    fits = device.type != 'cuda' or (
        mode == 'cuda' and resident_fits(M1, M2, N1, N2, device))
    return solve_route(mode, fits, eligible, ranks, N1 * N2)


def cuda_solver(M1, M2, N1, N2, device, route=None):
    """The kernel that mode ``'cuda'`` solves a chunk of pairs of these
    shapes with, off the kron route: :func:`pcg_resident` on the route
    ``'resident'``, :func:`pcg_stream` on ``'stream'``. ``route`` is the
    chunk's, as its plan named it (``JobPlan.route``); None names it from
    the shapes by :func:`chunk_route` (one pair fits a block on the CUDA
    ``device``, kron aside).

    This is the counterpart of ``graphdot_tpu/ops/pallas_pcg.py:379-388``
    with the TPU's 48 MB VMEM limit replaced by the card's limit per
    block; the sum-of-Kronecker branch is :func:`solve_route`'s. On the CPU
    both wrappers run the same plain function, and :func:`pcg_resident` is
    returned."""
    if route is None:
        route = chunk_route('cuda', M1, M2, N1, N2, device)
    return pcg_resident if route == 'resident' else pcg_stream


def _packed_tangents(group, T, esrc1, edst1, esrc2, edst2, diag, precond,
                     rhs, tol, maxiter):
    """The k tangent systems of each of P pairs in :func:`pcg_packed`, in
    groups of ``group`` members that share their pair's operator (a member
    stride of 0). k is padded to a multiple of ``group`` with zero right-hand
    sides, which stay zero; every member has its pair's tol, and maxiter is
    scaled by the group size, as the JAX package's packing does. Returns
    (x [P, k, N1, N2], iters [P * groups])."""
    P, k, N1, N2 = rhs.shape
    n_groups = -(-k // group)
    pad = n_groups * group - k
    if pad:
        rhs = torch.cat([rhs, rhs.new_zeros(P, pad, N1, N2)], dim=1)

    def per_group(a):
        """[P, ...] -> [P * n_groups, 1, ...]"""
        a = a.unsqueeze(1)
        if n_groups > 1:
            a = a.expand(P, n_groups, *a.shape[2:]).reshape(
                P * n_groups, 1, *a.shape[2:])
        return a

    x, iters = pcg_packed(
        *(per_group(a) for a in (T, esrc1, edst1, esrc2, edst2, diag,
                                 precond)),
        rhs.reshape(P * n_groups, group, N1, N2).contiguous(),
        tol.repeat_interleave(n_groups), min(maxiter * group, 16384))
    return x.reshape(P, n_groups * group, N1, N2)[:, :k], iters


def _stream_tangents(T, esrc1, edst1, esrc2, edst2, diag, precond, rhs, tol,
                     maxiter):
    """The k tangent systems of each of P pairs as P * k systems of
    :func:`pcg_stream`, each pair's operator repeated k times."""
    P, k, N1, N2 = rhs.shape

    def rep(a):
        return a.repeat_interleave(k, dim=0)

    x, iters = pcg_stream(
        *(rep(a) for a in (T, esrc1, edst1, esrc2, edst2, diag, precond)),
        rhs.reshape(P * k, N1, N2).contiguous(), rep(tol), maxiter)
    return x.view(P, k, N1, N2), iters


def cuda_tangent_solver(k, M1, M2, N1, N2, device, route=None):
    """The solver that mode ``'cuda'`` runs the k tangent systems of each
    pair of a chunk with, as ``solve(T, esrc1, edst1, esrc2, edst2, diag,
    precond, rhs [P, k, N1, N2], tol [P], maxiter) -> (x [P, k, N1, N2],
    iters)``:

    - the k systems of a pair as one group of :func:`pcg_packed` sharing
      the pair's operator, when such a group runs in one block on the
      CUDA ``device`` (:func:`largest_packed_k`: at most
      ``PACKED_MAX_K`` = 4 members, and within the block's shared memory
      and registers);
    - else the fewest groups whose size fits, as even as they can be (k =
      6 with a largest fit of 4 runs as two groups of 3); groups of one
      member launch :func:`pcg_resident`'s kernel (pairs of more than
      2048 product nodes, where two members' CG state exceeds a block's
      registers);
    - :func:`pcg_stream` over P * k systems on the route ``'stream'``, a
      single pair beyond a block.

    ``route`` is the chunk's, as :func:`cuda_solver` takes it (None: from
    the shapes by :func:`chunk_route`).

    On the CPU the groups hold all k systems, and :func:`pcg_packed` runs
    its plain twin. The route is chosen by these rules before any launch,
    never after a failure."""
    device = torch.device(device)
    if device.type != 'cuda':
        return functools.partial(_packed_tangents, k)
    if route is None:
        route = chunk_route('cuda', M1, M2, N1, N2, device)
    if route == 'stream':
        return _stream_tangents
    group = largest_packed_k(k, M1, M2, N1, N2, device, shared=True)
    n_groups = -(-k // group)
    return functools.partial(_packed_tangents, -(-k // n_groups))


def _split_theta(theta, knode, kedge, n_p_theta):
    """(q, node hyperparameters, edge hyperparameters) of theta."""
    q = theta[n_p_theta]
    tn = theta[n_p_theta + 1:n_p_theta + 1 + knode.n_theta]
    te = theta[n_p_theta + 1 + knode.n_theta:
               n_p_theta + 1 + knode.n_theta + kedge.n_theta]
    return q, tn, te


def mlgk_setup(theta, ops, *, knode, kedge, n_p_theta, mode, kron=None):
    """Build the product-graph systems of a batch of graph pairs.

    Parameters
    ----------
    theta: [n_dims] float32 linear-scale hyperparameters laid out as
        [p..., q, node_theta..., edge_theta...].
    ops: dict of per-side operands (``MarginalizedGraphKernel._operands``);
        all leading dims are the number of pairs P.
    knode, kedge: microkernels.
    n_p_theta: number of starting-probability hyperparameters.
    mode: 'cuda', 'edge', 'dense' or 'kron' (the coupling built; None
        builds none).
    kron: the :class:`._kron.KronPlan` of mode ``'kron'`` (ranks and
        domain; None: the default ranks and the chunk's own domain).

    Returns
    -------
    dict with ``Vx``, ``valid``, ``diag``, ``precond``, ``b`` [P, n1, n2],
    ``tol`` [P] (``ops['ftol'] * n1 * n2``; ``gtol`` [P] too when ops
    has ``'gtol'``), and the coupling: ``T`` [P, M1, M2] with the int32 edge
    lists ``esrc_1``, ``edst_1``, ``esrc_2``, ``edst_2`` and each node's
    real edges ``edge_lists_1``, ``edge_lists_2`` (edge-factored modes;
    T is 0 at the padded edges), ``W`` [P, n1, n1, n2, n2] ('dense'), or the Kronecker factors
    ``A1s``, ``B2s``, ``V2`` and the grid kernel ``C`` [R, R] ('kron', no T:
    :func:`._kron.kron_factors`).
    """
    q, tn, te = _split_theta(theta, knode, kedge, n_p_theta)

    nf1, nf2 = ops['node_feats_1'], ops['node_feats_2']
    mask1, mask2 = ops['node_mask_1'], ops['node_mask_2']
    deg1, deg2 = ops['degree_1'], ops['degree_2']

    P, n1 = mask1.shape
    n2 = mask2.shape[1]

    if not nf1:
        # unlabeled graphs: synthesize a constant feature for shape
        nf1 = {'_phantom': mask1}
        nf2 = {'_phantom': mask2}

    # Vx[i1, i2] = k_node(f1_i1, f2_i2)
    Vx = _apply_on_features(
        knode, tn,
        _expand_dict(nf1, (2,)),   # [P, n1, 1(, L)]
        _expand_dict(nf2, (1,)),   # [P, 1, n2(, L)]
    )
    Vx = Vx.expand(P, n1, n2)

    valid = mask1[:, :, None] * mask2[:, None, :]
    dx = (deg1[:, :, None] * deg2[:, None, :]) / (1.0 - q) ** 2

    ok = (valid > 0) & (dx > 0) & (Vx > 0)
    system = {
        'Vx': Vx,
        'valid': valid,
        'diag': torch.where(ok, dx / torch.where(ok, Vx, 1.0), 1.0),
        'precond': torch.where(ok, Vx / torch.where(ok, dx, 1.0), 1.0),
        'b': torch.where(ok, dx, 0.0),
    }
    n_true = mask1.sum(dim=1) * mask2.sum(dim=1)
    system['tol'] = ops['ftol'] * n_true
    if 'gtol' in ops:
        system['gtol'] = ops['gtol'] * n_true

    if mode is None:
        return system
    if mode == 'dense':
        adj1, adj2 = ops['adj_1'], ops['adj_2']
        raw_ef1, raw_ef2 = ops['edge_feats_1'], ops['edge_feats_2']
        if not raw_ef1:
            raw_ef1 = {'_phantom': adj1}
            raw_ef2 = {'_phantom': adj2}
        ef1 = _expand_dict(raw_ef1, (3, 4))  # [P,n1,n1,1,1(,L)]
        ef2 = _expand_dict(raw_ef2, (1, 2))  # [P,1,1,n2,n2(,L)]
        ke = _apply_on_features(kedge, te, ef1, ef2)
        # W[c, i1, j1, i2, j2], zero off the edges by a mask (as T below)
        a1 = adj1[:, :, :, None, None]
        a2 = adj2[:, None, None, :, :]
        W = torch.where((a1 != 0) & (a2 != 0), ke * a1 * a2, 0.0)
        system['W'] = W.expand(P, n1, n1, n2, n2)
        return system
    if mode == 'kron':
        system.update(kron_factors(ops, _apply_on_features, kedge, te, kron))
        return system

    ew1, ew2 = ops['ew_1'], ops['ew_2']
    raw_eef1 = ops['edge_elist_feats_1']
    raw_eef2 = ops['edge_elist_feats_2']
    if not raw_eef1:
        raw_eef1 = {'_phantom': ew1}
        raw_eef2 = {'_phantom': ew2}
    eef1 = _expand_dict(raw_eef1, (2,))  # [P,M1,1(,L)]
    eef2 = _expand_dict(raw_eef2, (1,))  # [P,1,M2(,L)]
    ke = _apply_on_features(kedge, te, eef1, eef2)
    # zero at the padded edges (weight 0) by a mask, not by the weight
    # alone: at a tiny length scale the edge kernel's derivative overflows
    # against a padded edge's features where it does not between real
    # edges, and 0 * inf would make T_d NaN there (the JAX package
    # multiplies by the weights, and its gradients are NaN at such theta)
    w1, w2 = ew1[:, :, None], ew2[:, None, :]
    T = torch.where((w1 != 0) & (w2 != 0), ke * w1 * w2, 0.0)
    system['T'] = T.expand(P, ew1.shape[1], ew2.shape[1]).contiguous()
    for f in ('esrc_1', 'edst_1', 'esrc_2', 'edst_2', 'edge_lists_1',
              'edge_lists_2'):
        system[f] = ops[f]
    return system


def _setup_over_thetas(theta, ops, **kwargs):
    """:func:`mlgk_setup` at every row of theta [C, n_theta], vectorized over
    the rows by ``torch.func.vmap``: each of the returned tensors holds the
    C systems of every pair of ``ops`` theta by theta, [C * P, ...] (the
    edge lists and the tol repeated a theta)."""
    s = torch.func.vmap(lambda t: mlgk_setup(t, ops, **kwargs))(theta)
    return {f: v.flatten(0, 1) for f, v in s.items()}


def _repeat(a, k):
    """Each pair's entry k times in a row: [P, ...] -> [P * k, ...]."""
    return a if k == 1 else a.repeat_interleave(k, dim=0)


def _edges(system, k=1):
    """The edge-factored system's four edge lists and the pair of its
    nodes' real-edge lists
    (:func:`~graphdot_tpu_torch.ops.pcg.offdiag_operator`'s ``segments``),
    each pair's k times in a row."""
    return (*(_repeat(system[f], k) for f in ('esrc_1', 'edst_1', 'esrc_2',
                                              'edst_2')),
            tuple(_repeat(system[f'edge_lists_{s}'], k) for s in (1, 2)))


def _plain_offdiag(system, mode, k):
    """The off-diagonal matvec of the plain modes over Y [P * k, n1, n2]:
    k systems a pair, all with the pair's coupling."""
    P, n1, n2 = system['diag'].shape
    if mode == 'dense':
        W = system['W']

        def offdiag(Y):
            return torch.einsum('cijkl,cdjl->cdik', W,
                                Y.view(P, k, n1, n2)).reshape(P * k, n1, n2)
        return offdiag
    if mode == 'kron':
        def offdiag(Y):
            return kron_offdiag(system['A1s'], system['B2s'],
                                Y.view(P, k, n1, n2)).reshape(P * k, n1, n2)
        return offdiag
    return offdiag_operator(_repeat(system['T'], k), *_edges(system, k))


def _plain_matvec(system, mode, k=1):
    """``y -> A y`` over y [P * k, n1 * n2], k systems a pair, each with its
    pair's operator, by the plain modes' off-diagonal matvec (and kron's)."""
    P, n1, n2 = system['diag'].shape
    N = n1 * n2
    offdiag = _plain_offdiag(system, mode, k)
    diag_flat = _repeat(system['diag'].reshape(P, N), k)

    def matvec(y):
        return diag_flat * y - offdiag(y.view(P * k, n1, n2)).reshape(
            P * k, N)
    return matvec


def _plain_solve(system, mode, b, tol, maxiter, return_iters=False):
    """Solve ``A x = b`` for b [P, k, n1, n2] (k right-hand sides a pair)
    by the plain batched :func:`pcg` of modes ``'edge'`` and ``'dense'``,
    or by :func:`._kron.kron_pcg` for ``'kron'`` (the k right-hand sides of
    a pair side by side through its factors), every one of the P * k
    systems to its pair's tol. With ``return_iters``, also the [P * k] step
    counts."""
    P, k, n1, n2 = b.shape
    N = n1 * n2
    if mode == 'kron':
        return kron_pcg(system['A1s'], system['B2s'], system['diag'],
                        system['precond'], b, tol, maxiter,
                        return_iters=return_iters)
    out = pcg(_plain_matvec(system, mode, k), b.reshape(P * k, N),
              _repeat(system['precond'].reshape(P, N), k), _repeat(tol, k),
              maxiter, return_iters=return_iters)
    if return_iters:
        return out[0].view(P, k, n1, n2), out[1]
    return out.view(P, k, n1, n2)


def _detached(system):
    """The system's tensors cut from autograd."""
    return {f: v.detach() for f, v in system.items()}


def _value_solver(system, mode, maxiter, route=None):
    """``solve(b [P, n1, n2]) -> x`` with the system's operator at its
    value tol, in the mode's route (:func:`cuda_solver` of ``route`` for
    ``'cuda'``)."""
    s = _detached(system)
    diag, precond, tol = (s[f].contiguous()
                          for f in ('diag', 'precond', 'tol'))
    if mode == 'cuda':
        T = s['T']
        P, n1, n2 = diag.shape
        solver = cuda_solver(T.shape[1], T.shape[2], n1, n2, T.device,
                             route)

        def solve(b):
            return solver(T, s['esrc_1'], s['edst_1'], s['esrc_2'],
                          s['edst_2'], diag, precond, b.contiguous(), tol,
                          maxiter)[0]
        return solve

    def solve(b):
        return _plain_solve(s, mode, b.unsqueeze(1), tol, maxiter)[:, 0]
    return solve


class _SolveLinear(torch.autograd.Function):
    """x = A(theta)^-1 b(theta) with implicit-function gradients; A is the
    symmetric product-graph operator ``matvec(y, diag, coupling)``."""

    @staticmethod
    def forward(ctx, matvec, solve, b, diag, coupling):
        x = solve(b.detach())
        ctx.matvec, ctx.solve = matvec, solve
        ctx.save_for_backward(x, diag, coupling)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        x, diag, coupling = ctx.saved_tensors
        # the adjoint system: A is symmetric, so A^T lam = x_bar is one
        # more solve by the same route
        lam = ctx.solve(x_bar.contiguous())
        with torch.enable_grad():
            operands = [t.detach().requires_grad_() for t in (diag, coupling)]
            Ax = ctx.matvec(x, *operands)
            d_diag, d_coupling = torch.autograd.grad(
                Ax, operands, grad_outputs=-lam)
        return None, None, lam, d_diag, d_coupling


def solve_linear(system, mode, maxiter, route=None):
    """Solve a chunk's systems ``A x = b`` (:func:`mlgk_setup`'s output) to
    their value tol, differentiably in the system's tensors: the reverse-
    mode counterpart of the JAX package's ``solve_linear``
    (``lax.custom_linear_solve(symmetric=True)``).

    The forward solve runs in the mode's route (:func:`cuda_solver` of the
    chunk's ``route`` for ``'cuda'``, :func:`._kron.kron_pcg` for
    ``'kron'``); the backward pass
    solves the adjoint system ``A lam = x_bar`` by the same route, then
    takes ``b_bar = lam`` and the operator's cotangents from autograd
    through the plain matvec at ``-lam^T A x``. The coupling that carries
    the hyperparameters is T, W, or for ``'kron'`` the grid kernel C, which
    side 2's factors are folded with again. Returns x [P, n1, n2]."""
    P, n1, n2 = system['diag'].shape
    if mode == 'dense':
        coupling = system['W']

        def offdiag(W, Y):
            return torch.einsum('cijkl,cjl->cik', W, Y)
    elif mode == 'kron':
        coupling = system['C']
        A1s, V2 = system['A1s'].detach(), system['V2'].detach()

        def offdiag(C, Y):
            return kron_offdiag(A1s, fold_side_2(V2, C),
                                Y.unsqueeze(1))[:, 0]
    else:
        coupling = system['T']
        *edges, segments = _edges(system)

        def offdiag(T, Y):
            return gather_offdiag(T, *edges, Y, segments)

    def matvec(y, diag, C):
        return diag * y - offdiag(C, y)

    return _SolveLinear.apply(matvec,
                              _value_solver(system, mode, maxiter, route),
                              system['b'], system['diag'], coupling)


def mlgk_tangents(theta, ops, system, x, *, knode, kedge, n_p_theta, mode,
                  kron=None):
    """The tangent right-hand sides of the product-graph systems, one for
    each of the n_theta directions of theta:

        rhs_d = b_d - A_d x = b_d - diag_d o x + offdiag(T_d, x)

    with ``T_d``, ``diag_d`` and ``b_d`` from ``torch.func.jacfwd`` of
    :func:`mlgk_setup`'s elementwise part in theta (``W_d`` in mode
    ``'dense'``), and the plain gather matvec, which is linear in T, on each
    direction's ``T_d``: the gather itself is not differentiated. The matvec
    sums each node's real edges in edge order
    (:func:`~graphdot_tpu_torch.ops.pcg.offdiag_operator`), so that the
    tangents are the same bits at every call, on the card as on the CPU;
    ``T_d`` is 0 at the padded edges (:func:`mlgk_setup`).
    In mode ``'kron'`` the coupling's jacobian is the grid kernel's,
    ``C_d`` [n_theta, R, R], and each direction's term a kron matvec on x
    with side 2 folded with ``C_d`` (:func:`._kron.kron_tangent_offdiag`).

    Parameters
    ----------
    theta, ops, knode, kedge, n_p_theta, mode, kron: as :func:`mlgk_setup`;
        theta may be [C, n_theta] (not on kron), and then ``system`` and
        ``x`` hold the C * P systems theta by theta, as :func:`mlgk_solve`
        lays them out, and so does the result.
    system: :func:`mlgk_setup`'s output at theta.
    x: [P, n1, n2] the systems' solutions at theta.

    Returns
    -------
    dict with ``rhs`` [P, n_theta, n1, n2] and ``Vx`` [P, n_theta, n1, n2],
    the tangents of the node-kernel diagonal (for ``lmin == 1``).
    """
    def elementwise(t):
        s = mlgk_setup(t, ops, knode=knode, kedge=kedge,
                       n_p_theta=n_p_theta,
                       mode=None if mode == 'kron' else mode)
        if mode == 'kron':
            coupling = kron_grid_kernel(
                ops, _apply_on_features, kedge,
                _split_theta(t, knode, kedge, n_p_theta)[2], kron)
        else:
            coupling = s['W' if mode == 'dense' else 'T']
        return s['diag'], s['b'], coupling, s['Vx']

    jacobian = torch.func.jacfwd(elementwise)
    if theta.dim() == 2:
        # one vectorized jacobian for all C thetas, the systems theta-major
        diag_d, b_d, C_d, Vx_d = (
            d.flatten(0, 1)
            for d in torch.func.vmap(jacobian)(theta.detach()))
    else:
        diag_d, b_d, C_d, Vx_d = jacobian(theta.detach())
    diag_d, b_d, Vx_d = (torch.movedim(t, -1, 1) for t in (diag_d, b_d, Vx_d))
    P, k, n1, n2 = diag_d.shape
    xk = x.detach().unsqueeze(1).expand(P, k, n1, n2)
    if mode == 'kron':
        off = kron_tangent_offdiag(system['A1s'].detach(),
                                   system['V2'].detach(),
                                   torch.movedim(C_d, -1, 0), x.detach())
    elif mode == 'dense':
        off = torch.einsum('cijkld,cjl->cdik', C_d, x.detach())
    else:
        C_d = torch.movedim(C_d, -1, 1)
        *edges, segments = _edges(system, k)
        off = gather_offdiag(
            C_d.reshape(P * k, *C_d.shape[2:]), *edges,
            xk.reshape(P * k, n1, n2), segments).view(P, k, n1, n2)
    return {'rhs': b_d - diag_d * xk + off, 'Vx': Vx_d}


def mlgk_solve(theta, ops, *, knode, kedge, n_p_theta, lmin, mode,
               maxiter, tangents=False, return_resnorm=False, kron=None,
               route=None):
    """Solve a batch of graph-pair MLGK systems (see :func:`mlgk_setup`
    for the arguments; ``lmin`` is 0 or 1, ``maxiter`` the CG step bound).

    ``route`` is the chunk's route as its plan named it before any launch
    (``JobPlan.route``, by :func:`solve_route`): ``'kron'`` builds the kron
    system with the ``kron`` plan (:class:`._kron.KronPlan`), whatever the
    mode; ``'resident'`` and ``'stream'`` pick mode ``'cuda'``'s kernels.
    None takes mode ``'kron'``'s route for mode ``'kron'``, and names mode
    ``'cuda'``'s from the chunk's shapes (:func:`chunk_route`, kron aside).

    The value solve runs at ``ops['ftol']`` through :func:`solve_linear`,
    so x is differentiable by autograd in theta. With ``tangents``, the
    n_theta tangent systems of every pair run at ``ops['gtol']``: in
    :func:`cuda_tangent_solver`'s route for mode ``'cuda'``, side by side
    through the pair's factors for kron, in the plain PCG for the others.
    The four phases run in ``torch.profiler`` ranges named ``mlgk_setup``,
    ``mlgk_value_solve``, ``mlgk_tangents`` and ``mlgk_tangent_solve``.

    ``return_resnorm`` adds each pair's relative residual ``||b - A x|| /
    ||b||`` of the value solve, by one plain matvec on x (converged float32
    solves sit near 1e-7..1e-5; far above that, ``maxiter`` cut the solve
    short).

    theta may also be [C, n_theta], C hyperparameter vectors (not on the
    kron route): the setup and the tangents are vectorized over them
    (``torch.func.vmap``), and the C * P systems, laid out theta by theta,
    go to the route's kernels together: one ``pcg_resident`` launch for the
    values and one ``pcg_packed`` launch for the tangents on the resident
    route. Every result then leads with C * P in that order.

    Returns
    -------
    x: [P, n1, n2] solution of the product-graph system (zero on padding)
    Vx: [P, n1, n2] node-kernel diagonal
    valid: [P, n1, n2] product-space validity mask
    x_dot: [P, n1, n2, n_theta] d x / d theta (only with ``tangents``)
    resnorm: [P] relative residuals (only with ``return_resnorm``)
    """
    batched = theta.dim() == 2
    if route == 'kron':
        mode = 'kron'
    if batched and mode == 'kron':
        raise ValueError('the kron route solves one theta at a time')
    if mode == 'cuda' and route is None:
        route = chunk_route(
            mode, ops['esrc_1'].shape[1], ops['esrc_2'].shape[1],
            ops['node_mask_1'].shape[1], ops['node_mask_2'].shape[1],
            ops['ew_1'].device)
    record = torch.profiler.record_function
    with record('mlgk_setup'):
        setup = _setup_over_thetas if batched else mlgk_setup
        s = setup(theta, ops, knode=knode, kedge=kedge,
                  n_p_theta=n_p_theta, mode=mode, kron=kron)
    Vx, valid = s['Vx'], s['valid']
    with record('mlgk_value_solve'):
        x = solve_linear(s, mode, maxiter, route)
    resnorm = None
    if return_resnorm:
        sd = _detached(s)
        P = x.shape[0]
        b = sd['b'].reshape(P, -1)
        leftover = torch.linalg.vector_norm(
            b - _plain_matvec(sd, mode)(x.detach().reshape(P, -1)), dim=-1)
        scale = torch.linalg.vector_norm(b, dim=-1)
        resnorm = leftover / torch.where(scale > 0, scale, 1.0)

    x_dot = None
    if tangents:
        with record('mlgk_tangents'):
            t = mlgk_tangents(theta, ops, s, x, knode=knode, kedge=kedge,
                              n_p_theta=n_p_theta, mode=mode, kron=kron)
        rhs = t['rhs']
        sd = _detached(s)
        with record('mlgk_tangent_solve'):
            if mode == 'cuda':
                T = sd['T']
                P, k, n1, n2 = rhs.shape
                solver = cuda_tangent_solver(k, T.shape[1], T.shape[2], n1,
                                             n2, T.device, route)
                x_dot, _ = solver(
                    T, sd['esrc_1'], sd['edst_1'], sd['esrc_2'],
                    sd['edst_2'], sd['diag'].contiguous(),
                    sd['precond'].contiguous(), rhs.contiguous(),
                    sd['gtol'].contiguous(), maxiter)
            else:
                x_dot = _plain_solve(sd, mode, rhs, sd['gtol'], maxiter)
        if lmin == 1:
            x_dot = x_dot - torch.where(valid[:, None] > 0, t['Vx'], 0.0)
        x_dot = torch.movedim(x_dot, 1, -1)

    if lmin == 1:
        # skip the l=0 term of the random-walk sum
        x = x - torch.where(valid > 0, Vx, 0.0)
    out = (x, Vx, valid)
    if tangents:
        out += (x_dot,)
    if return_resnorm:
        out += (resnorm,)
    return out


def weight_by_p(x, p1, p2):
    """R[i1, i2] = x[i1, i2] * p1_i1 * p2_i2 (p1 [..., n1], p2 [..., n2])."""
    return x * p1[..., :, None] * p2[..., None, :]

"""Batched product-graph MLGK solver, forward value; counterpart of
``graphdot_tpu/kernel/marginalized/_solver.py``.

Each graph pair's system is the generalized Kronecker system of the dense
oracle in ``tests/oracle.py``:
``[diag(Dx/Vx) - (A1 (x) A2) . Ex] x = Dx`` with ``Dx = kron(D1, D2)/(1-q)^2``
and the kernel value ``K = sum_ij p1_i p2_j x_ij``.

The off-diagonal matvec is either the dense coupling tensor
(``mode='dense'``) or the edge-factored form with per-pair edge-coupling
matrix ``T[e1,e2] = w1 w2 k_edge(e1,e2)`` over the directed edge lists
(``'edge'`` in plain torch, ``'cuda'`` in the CUDA PCG kernels, routed
by :func:`cuda_solver`). The batched PCG loop itself lives in
:mod:`graphdot_tpu_torch.ops.pcg`, where the kernels' plain twins share it.
"""
import torch

from ...ops.pcg import (gather_offdiag, pcg, pcg_resident, pcg_stream,
                        resident_smem)

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


def cuda_solver(M1, M2, N1, N2, device):
    """The kernel that mode ``'cuda'`` solves a chunk of pairs of these
    shapes with: :func:`pcg_resident` when one pair fits the shared memory
    a block can get on the CUDA ``device``, else :func:`pcg_stream`.

    This is the counterpart of ``graphdot_tpu/ops/pallas_pcg.py:379-388``
    with the TPU's 48 MB VMEM limit replaced by the card's limit per
    block; the sum-of-Kronecker branch of the JAX package is not ported.
    On the CPU both wrappers run the same plain function, and
    :func:`pcg_resident` is returned."""
    if torch.device(device).type != 'cuda':
        return pcg_resident
    smem, limit = resident_smem(M1, M2, N1, N2, torch.device(device))
    return pcg_resident if smem <= limit else pcg_stream


def mlgk_setup(theta, ops, *, knode, kedge, n_p_theta, mode):
    """Build the product-graph systems of a batch of graph pairs.

    Parameters
    ----------
    theta: [n_dims] float32 linear-scale hyperparameters laid out as
        [p..., q, node_theta..., edge_theta...].
    ops: dict of per-side operands (``MarginalizedGraphKernel._operands``);
        all leading dims are the number of pairs P.
    knode, kedge: microkernels.
    n_p_theta: number of starting-probability hyperparameters.
    mode: 'cuda', 'edge' or 'dense'.

    Returns
    -------
    dict with ``Vx``, ``valid``, ``diag``, ``precond``, ``b`` [P, n1, n2],
    ``tol`` [P], and the coupling: ``T`` [P, M1, M2] with the int32 edge
    lists ``esrc_1``, ``edst_1``, ``esrc_2``, ``edst_2`` (edge-factored
    modes), or ``W`` [P, n1, n1, n2, n2] ('dense').
    """
    q = theta[n_p_theta]
    tn = theta[n_p_theta + 1:n_p_theta + 1 + knode.n_theta]
    te = theta[n_p_theta + 1 + knode.n_theta:
               n_p_theta + 1 + knode.n_theta + kedge.n_theta]

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
        'tol': ops['ftol'] * (mask1.sum(dim=1) * mask2.sum(dim=1)),
    }

    if mode == 'dense':
        adj1, adj2 = ops['adj_1'], ops['adj_2']
        raw_ef1, raw_ef2 = ops['edge_feats_1'], ops['edge_feats_2']
        if not raw_ef1:
            raw_ef1 = {'_phantom': adj1}
            raw_ef2 = {'_phantom': adj2}
        ef1 = _expand_dict(raw_ef1, (3, 4))  # [P,n1,n1,1,1(,L)]
        ef2 = _expand_dict(raw_ef2, (1, 2))  # [P,1,1,n2,n2(,L)]
        ke = _apply_on_features(kedge, te, ef1, ef2)
        # W[c, i1, j1, i2, j2]
        W = ke * adj1[:, :, :, None, None] * adj2[:, None, None, :, :]
        system['W'] = W.expand(P, n1, n1, n2, n2)
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
    T = ke * ew1[:, :, None] * ew2[:, None, :]
    system['T'] = T.expand(P, ew1.shape[1], ew2.shape[1]).contiguous()
    for f in ('esrc_1', 'edst_1', 'esrc_2', 'edst_2'):
        system[f] = ops[f]
    return system


def mlgk_solve(theta, ops, *, knode, kedge, n_p_theta, lmin, mode,
               maxiter):
    """Solve a batch of graph-pair MLGK systems (see :func:`mlgk_setup`
    for the arguments; ``lmin`` is 0 or 1, ``maxiter`` the CG step bound).

    Returns
    -------
    x: [P, n1, n2] solution of the product-graph system (zero on padding)
    Vx: [P, n1, n2] node-kernel diagonal
    valid: [P, n1, n2] product-space validity mask
    """
    s = mlgk_setup(theta, ops, knode=knode, kedge=kedge,
                   n_p_theta=n_p_theta, mode=mode)
    Vx, valid, diag = s['Vx'], s['valid'], s['diag']
    P, n1, n2 = diag.shape
    N = n1 * n2

    if mode == 'cuda':
        T = s['T']
        solver = cuda_solver(T.shape[1], T.shape[2], n1, n2, T.device)
        x, _ = solver(
            T, s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            diag.contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol'].contiguous(), maxiter)
    else:
        if mode == 'dense':
            W = s['W']

            def offdiag(Y):
                return torch.einsum('cijkl,cjl->cik', W, Y)
        else:
            T = s['T']
            edges = [s[f].long()
                     for f in ('esrc_1', 'edst_1', 'esrc_2', 'edst_2')]

            def offdiag(Y):
                return gather_offdiag(T, *edges, Y)

        diag_flat = diag.reshape(P, N)

        def matvec(y):
            return diag_flat * y - offdiag(y.view(P, n1, n2)).reshape(P, N)

        x = pcg(matvec, s['b'].reshape(P, N), s['precond'].reshape(P, N),
                s['tol'], maxiter).view(P, n1, n2)

    if lmin == 1:
        # skip the l=0 term of the random-walk sum
        x = x - torch.where(valid > 0, Vx, 0.0)
    return x, Vx, valid


def weight_by_p(x, p1, p2):
    """R[i1, i2] = x[i1, i2] * p1_i1 * p2_i2."""
    return x * p1[:, :, None] * p2[:, None, :]

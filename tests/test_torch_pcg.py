"""The resident PCG's plain twin (``graphdot_tpu_torch.ops.pcg``) against
the JAX package's Pallas kernel, and the wrapper's argument checks.

The systems are the ones the port's solver sets up for every pair of 6
molecules of 5-14 atoms. JAX's ``pallas_pcg`` runs in interpret mode on
the CPU with one-hot incidence matrices built from the same edge indices,
at ``unroll=1``, i.e. the same CG step sequence as the twin. Tolerance:
rtol 1e-5, atol 1e-7 on x (float32 CG stopped at ftol * N; the two sum in
different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from graphdot_tpu.ops.pallas_pcg import pallas_pcg  # noqa: E402
from graphdot_tpu.testing import random_molecule_set  # noqa: E402

from graphdot_tpu_torch.kernel import MarginalizedGraphKernel  # noqa: E402
from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    mlgk_setup)
from graphdot_tpu_torch.microkernel import (  # noqa: E402
    KroneckerDelta, SquareExponential, TensorProduct)
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    edge_segments, gather_offdiag, offdiag_operator, pcg_resident,
    pcg_resident_reference)


def molecule_systems():
    """(operands of pcg_resident, maxiter) for all 21 upper-triangular
    pairs of 6 molecules."""
    graphs = random_molecule_set(11, 6, n_atoms_range=(5, 14))
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05,
        backend='cuda', device='cpu')
    batch, bd, _ = kernel._prepare_batch(graphs)
    i, j = np.triu_indices(len(graphs))
    s = mlgk_setup(kernel._theta_vector(),
                   kernel._operands(bd, bd, torch.as_tensor(i),
                                    torch.as_tensor(j)),
                   knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                   n_p_theta=1, mode='cuda')
    n_pad = batch.node_mask.shape[1]
    return [s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol']], kernel.maxiter(n_pad)


def test_reference_matches_pallas_pcg():
    args, maxiter = molecule_systems()
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol = args
    P, M1, M2 = T.shape
    N1, N2 = diag.shape[1:]
    assert P == 21 and N1 == N2 == 16

    x, iters = pcg_resident_reference(*args, maxiter)
    assert x.shape == (P, N1, N2) and x.dtype == torch.float32
    assert iters.dtype == torch.int32
    assert 0 < int(iters.min()) and int(iters.max()) < maxiter

    def onehot(idx, n):
        return jnp.asarray(np.eye(n, dtype=np.float32)[idx.numpy()])

    x_jax = pallas_pcg(
        jnp.asarray(T.numpy()), onehot(esrc1, N1), onehot(edst1, N1),
        onehot(esrc2, N2), onehot(edst2, N2), jnp.asarray(diag.numpy()),
        jnp.asarray(precond.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(tol.numpy()), block_pairs=7, maxiter=maxiter,
        interpret=True, mode='split2', unroll=1)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax), rtol=1e-5,
                               atol=1e-7)


def test_wrapper_on_cpu_runs_reference():
    args, maxiter = molecule_systems()
    before = pcg_resident.launches
    x, iters = pcg_resident(*args, maxiter)
    x_ref, iters_ref = pcg_resident_reference(*args, maxiter)
    assert torch.equal(x, x_ref) and torch.equal(iters, iters_ref)
    assert pcg_resident.launches == before


def test_gather_offdiag_matches_onehot_contractions():
    """The gather form equals the four one-hot contractions of
    ``graphdot_tpu/kernel/marginalized/_solver.py`` (edge mode)."""
    rng = np.random.default_rng(0)
    P, M1, M2, N1, N2 = 3, 7, 5, 4, 6
    T = rng.uniform(size=(P, M1, M2)).astype(np.float32)
    e = {k: rng.integers(0, n, (P, m))
         for k, n, m in [('s1', N1, M1), ('d1', N1, M1),
                         ('s2', N2, M2), ('d2', N2, M2)]}
    Y = rng.normal(size=(P, N1, N2)).astype(np.float32)
    oh = {k: np.eye(N1 if k[1] == '1' else N2)[v] for k, v in e.items()}
    G = np.einsum('cen,cnk->cek', oh['d1'], Y)
    H = np.einsum('cek,cfk->cef', G, oh['d2'])
    U = np.einsum('cef,cei->cif', T * H, oh['s1'])
    want = np.einsum('cif,cfk->cik', U, oh['s2'])
    got = gather_offdiag(torch.from_numpy(T),
                         *(torch.from_numpy(e[k])
                           for k in ('s1', 'd1', 's2', 'd2')),
                         torch.from_numpy(Y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def offdiag_operands(seed, P, M1, M2, N1, N2):
    """Random operands of :func:`offdiag_operator`: T with zeros and dead
    rows and columns (padding edges at node 0), edge lists and Y."""
    rng = np.random.default_rng(seed)
    T = rng.normal(size=(P, M1, M2)).astype(np.float32)
    T[T < -0.5] = 0.0
    T[:, M1 // 2:, :] *= rng.random((P, M1 - M1 // 2, 1)) < 0.7
    T[:, :, M2 // 2:] *= rng.random((P, 1, M2 - M2 // 2)) < 0.7
    edges = [rng.integers(0, n, (P, m)).astype(np.int32)
             for n, m in ((N1, M1), (N1, M1), (N2, M2), (N2, M2))]
    for e in edges:
        e[:, -2:] = 0        # padding edges, as the batcher lays them
    Y = rng.normal(size=(P, N1, N2)).astype(np.float32)
    return (torch.from_numpy(T), *map(torch.from_numpy, edges),
            torch.from_numpy(Y))


def sequential_offdiag(T, esrc1, edst1, esrc2, edst2, Y):
    """The matvec of :func:`offdiag_operator` by float32 scalar adds, each
    node's terms from 0 in edge order: U over side 2's edges, then out
    over side 1's."""
    T, Y = T.numpy(), Y.numpy()
    s1, d1, s2, d2 = (e.numpy() for e in (esrc1, edst1, esrc2, edst2))
    P, M1, M2 = T.shape
    N1, N2 = Y.shape[1:]
    out = np.zeros((P, N1, N2), np.float32)
    for p in range(P):
        U = np.zeros((M1, N2), np.float32)
        for e1 in range(M1):
            for e2 in range(M2):
                U[e1, s2[p, e2]] = np.float32(
                    U[e1, s2[p, e2]] + T[p, e1, e2] * Y[p, d1[p, e1],
                                                        d2[p, e2]])
        for e1 in range(M1):
            out[p, s1[p, e1]] = (out[p, s1[p, e1]] + U[e1]).astype(
                np.float32)
    return torch.from_numpy(out)


@pytest.mark.parametrize('shape', [(5, 11, 9, 6, 7), (3, 40, 56, 16, 24),
                                   (2, 3, 1, 2, 1), (1, 0, 4, 3, 3)])
def test_offdiag_sums_each_node_in_edge_order(shape):
    """Each output adds its terms from 0 in edge order: the bits of scalar
    float32 adds in that order, whether the lists come from a scan of T
    or hold every edge (a dead one adds an exact zero), and a pair's bits
    alone are those it has in a batch."""
    *ops, Y = offdiag_operands(sum(shape), *shape)
    T, esrc1, _, esrc2, _ = ops
    P, M1, M2, N1, N2 = shape
    every = (edge_segments(esrc1, torch.ones(P, M1, dtype=torch.bool), N1),
             edge_segments(esrc2, torch.ones(P, M2, dtype=torch.bool), N2))
    want = sequential_offdiag(*ops, Y)
    scanned = offdiag_operator(*ops)(Y)
    assert torch.equal(scanned, want)
    assert torch.equal(offdiag_operator(*ops, every)(Y), want)
    assert torch.equal(gather_offdiag(*ops, Y), want)
    alone = offdiag_operator(*(o[-1:] for o in ops))(Y[-1:])
    assert torch.equal(alone[0], scanned[-1])


@pytest.mark.parametrize('batched', [False, True])
def test_tangent_rhs_real_edge_lists_equal_scanned_lists(batched,
                                                         monkeypatch):
    """``mlgk_tangents`` sums the tangent right-hand sides over the lists
    of each graph's real edges (weight != 0) that the packed batch
    carries: the bits of lists from a scan of each T_d, one theta or
    two."""
    from graphdot_tpu_torch.kernel.marginalized import _solver
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05, device='cpu')
    graphs = random_molecule_set(7, 12, n_atoms_range=(9, 24))
    _, bd, _ = kernel._prepare_batch(graphs)
    i, j = np.triu_indices(len(graphs))
    ops = kernel._operands(bd, bd, torch.as_tensor(i), torch.as_tensor(j))
    theta = kernel._theta_vector()
    if batched:
        theta = torch.stack([theta, 1.1 * theta])
    setup = _solver._setup_over_thetas if batched else _solver.mlgk_setup
    kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
              n_p_theta=1, mode='cuda')
    s = setup(theta, ops, **kw)
    x = torch.rand(s['diag'].shape, generator=torch.Generator().manual_seed(0))
    got = _solver.mlgk_tangents(theta, ops, s, x, **kw)['rhs']
    plain = _solver.gather_offdiag
    monkeypatch.setattr(_solver, 'gather_offdiag',
                        lambda *a: plain(*a[:6]))
    want = _solver.mlgk_tangents(theta, ops, s, x, **kw)['rhs']
    assert got.shape[1] == 4 and torch.equal(got, want)


def test_reference_stop_rules():
    args, maxiter = molecule_systems()
    b = args[7]
    # maxiter caps the steps; x = 0 without a step
    x, iters = pcg_resident_reference(*args, 0)
    assert not x.any() and not iters.any()
    x, iters = pcg_resident_reference(*args, 2)
    assert torch.all(iters == 2)
    # a zero right-hand side has converged before the first step
    zero = list(args)
    zero[7] = torch.zeros_like(b)
    x, iters = pcg_resident_reference(*zero, maxiter)
    assert not x.any() and not iters.any()
    # a zero preconditioner gives rz == 0: breakdown in the first step,
    # x stays 0
    broken = list(args)
    broken[6] = torch.zeros_like(b)
    x, iters = pcg_resident_reference(*broken, maxiter)
    assert not x.any() and torch.all(iters == 1)


def _bad_args(case):
    args, maxiter = molecule_systems()
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol = args
    if case == 'T_float64':
        args[0] = T.double()
    elif case == 'T_2d':
        args[0] = T[0]
    elif case == 'esrc_int64':
        args[1] = esrc1.long()
    elif case == 'edst_shape':
        args[4] = edst2[:, :-1].contiguous()
    elif case == 'diag_shape':
        args[5] = diag[:-1]
    elif case == 'b_noncontiguous':
        args[7] = b.transpose(1, 2)
    elif case == 'tol_shape':
        args[8] = tol[:, None]
    elif case == 'index_out_of_range':
        bad = esrc1.clone()
        bad[0, 0] = diag.shape[1]
        args[1] = bad
    elif case == 'index_negative':
        bad = edst1.clone()
        bad[-1, -1] = -1
        args[2] = bad
    elif case == 'maxiter_negative':
        maxiter = -1
    elif case == 'maxiter_float':
        maxiter = 10.0
    elif case == 'not_a_tensor':
        args[8] = tol.numpy()
    return args, maxiter


@pytest.mark.parametrize('fn', [pcg_resident, pcg_resident_reference])
@pytest.mark.parametrize('case,error', [
    ('T_float64', TypeError),
    ('T_2d', ValueError),
    ('esrc_int64', TypeError),
    ('edst_shape', ValueError),
    ('diag_shape', ValueError),
    ('b_noncontiguous', ValueError),
    ('tol_shape', ValueError),
    ('index_out_of_range', ValueError),
    ('index_negative', ValueError),
    ('maxiter_negative', ValueError),
    ('maxiter_float', ValueError),
    ('not_a_tensor', TypeError),
])
def test_argument_errors(fn, case, error):
    args, maxiter = _bad_args(case)
    with pytest.raises(error):
        fn(*args, maxiter)

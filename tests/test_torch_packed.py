"""The packed PCG's plain twin (``graphdot_tpu_torch.ops.pcg``) against the
JAX package's ``pallas_pcg_packed`` (``_pcg_pack_kernel``), its group
semantics, the wrapper's argument checks, and the tangent route of mode
``'cuda'`` on the CPU.

The systems are the ones the port's solver sets up for the pairs of 6
molecules of 5-14 atoms. JAX runs in interpret mode on the CPU with one-hot
incidence matrices built from the same edge indices (``np.eye``), at
``unroll=1``: the same CG step sequence on the union as the twin. In
interpret mode ``pallas_pcg_solver`` never packs (k = 1), so the packed
kernel is called directly, as ``tests/test_mlgk.py`` does through
``pack=3``. Tolerance: rtol 1e-5, atol 1e-7 on x (float32 CG on both sides,
summed in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from graphdot_tpu.ops.pallas_pcg import pallas_pcg_packed  # noqa: E402

from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    _packed_tangents, _plain_solve, cuda_tangent_solver, mlgk_setup,
    mlgk_tangents)
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    group_pairs, pcg_packed, pcg_packed_reference, pcg_resident_reference)

from test_torch_pcg import molecule_systems  # noqa: E402


def grouped_systems(k, S):
    """The first S * k molecule pairs as S groups of k members, each
    member its own pair: (operands of pcg_packed, maxiter)."""
    args, maxiter = molecule_systems()
    return list(group_pairs(k, *(a[:S * k] for a in args), maxiter))


def onehot(idx, n):
    return jnp.asarray(np.eye(n, dtype=np.float32)[idx.numpy()])


def jax_packed(args):
    """``pallas_pcg_packed`` in interpret mode on the same operands."""
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol, maxiter = args
    S, k = b.shape[:2]
    N1, N2 = diag.shape[2:]
    return np.asarray(pallas_pcg_packed(
        jnp.asarray(T.numpy()), onehot(esrc1, N1), onehot(edst1, N1),
        onehot(esrc2, N2), onehot(edst2, N2), jnp.asarray(diag.numpy()),
        jnp.asarray(precond.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(tol.numpy()), block_pairs=S, k=k, maxiter=maxiter,
        interpret=True, mode='split2', unroll=1))


@pytest.mark.parametrize('k,P', [(2, 6), (3, 9), (3, 7)])
def test_reference_matches_pallas_pcg_packed(k, P):
    """k in {2, 3} over S = 3 groups; P = 7 is not a multiple of k, so
    group_pairs pads the last group with a zero system."""
    args, maxiter = molecule_systems()
    grouped = group_pairs(k, *(a[:P] for a in args), maxiter)
    S = grouped[7].shape[0]
    assert S == 3 and grouped[-1] == maxiter * k
    x, iters = pcg_packed_reference(*grouped)
    assert x.shape == (S, k, 16, 16) and x.dtype == torch.float32
    assert iters.shape == (S,) and iters.dtype == torch.int32
    assert 0 < int(iters.min()) and int(iters.max()) < grouped[-1]
    np.testing.assert_allclose(x.numpy(), jax_packed(grouped), rtol=1e-5,
                               atol=1e-7)
    if P % k:
        assert not x.reshape(S * k, 16, 16)[P:].any()


@pytest.mark.parametrize('k', [2, 3])
def test_reference_matches_resident_per_member(k):
    """At a tight tol every member reaches its own solution, whatever path
    the shared step sizes take."""
    args, maxiter = molecule_systems()
    P = 3 * k
    args = [a[:P] for a in args]
    args[8] = torch.full((P,), 1e-6)
    x, _ = pcg_packed_reference(*group_pairs(k, *args, maxiter))
    want, _ = pcg_resident_reference(*args, maxiter)
    np.testing.assert_allclose(x.reshape(P, 16, 16).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_group_steps_bound_members_steps():
    """A group takes at least as many CG steps as each member alone."""
    args, maxiter = molecule_systems()
    k, P = 3, 9
    args = [a[:P] for a in args]
    _, iters = pcg_packed_reference(*group_pairs(k, *args, maxiter))
    _, alone = pcg_resident_reference(*args, maxiter)
    assert torch.all(iters >= alone.view(-1, k).max(dim=1).values)


def test_zero_group_and_zero_member():
    args = grouped_systems(3, 3)
    b = args[7]
    # a group whose b is all zero stops before its first step
    b[1] = 0.0
    # a zero member inside a live group stays exactly zero
    b[2, 1] = 0.0
    x, iters = pcg_packed_reference(*args)
    assert int(iters[1]) == 0 and not x[1].any()
    assert int(iters[2]) > 0 and not x[2, 1].any() and x[2, 0].any()
    # the zero member changes nothing for the others: the group is the
    # same PCG with one member less
    alone = [a[2:3, [0, 2]].contiguous() if a.dim() > 1 else a[2:3]
             for a in args[:9]]
    x2, _ = pcg_packed_reference(*alone, args[9])
    np.testing.assert_allclose(x[2, [0, 2]].numpy(), x2[0].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_stop_rules():
    args = grouped_systems(2, 3)
    x, iters = pcg_packed_reference(*args[:-1], 0)
    assert not x.any() and not iters.any()
    x, iters = pcg_packed_reference(*args[:-1], 2)
    assert torch.all(iters == 2)
    broken = list(args)
    broken[6] = torch.zeros_like(args[6])   # precond = 0: rz == 0
    x, iters = pcg_packed_reference(*broken)
    assert not x.any() and torch.all(iters == 1)


def test_shared_operator_matches_copies():
    """Members that share one operator (a member stride of 0: T, edges,
    diag and precond given once a group) solve as the same operator
    copied k times."""
    args, maxiter = molecule_systems()
    rng = np.random.default_rng(5)
    S, k = 4, 3
    shared = [a[:S, None].contiguous() for a in args[:7]]
    b = torch.tensor(rng.normal(size=(S, k, 16, 16)), dtype=torch.float32)
    tol = args[8][:S]
    x1, it1 = pcg_packed_reference(*shared, b, tol, maxiter)
    copied = [a.expand(S, k, *a.shape[2:]).contiguous() for a in shared]
    x2, it2 = pcg_packed_reference(*copied, b, tol, maxiter)
    assert torch.equal(it1, it2)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=1e-6, atol=0)
    before = pcg_packed.launches
    x3, _ = pcg_packed(*shared, b, tol, maxiter)
    assert torch.equal(x3, x1) and pcg_packed.launches == before


def _bad_packed(case):
    args = grouped_systems(2, 3)
    if case == 'T_3d':
        args[0] = args[0][:, 0]
    elif case == 'T_float64':
        args[0] = args[0].double()
    elif case == 'ka_not_1_or_k':
        args[0] = torch.cat([args[0], args[0][:, :1]], 1)
    elif case == 'edges_int64':
        args[1] = args[1].long()
    elif case == 'edges_members':
        args[2] = args[2][:, :1].contiguous()
    elif case == 'diag_shape':
        args[5] = args[5][:, :, :-1].contiguous()
    elif case == 'b_3d':
        args[7] = args[7][:, 0]
    elif case == 'b_noncontiguous':
        args[7] = args[7].transpose(2, 3)
    elif case == 'tol_shape':
        args[8] = args[8][:, None]
    elif case == 'tol_per_member':
        args[8] = args[8].repeat_interleave(2)
    elif case == 'index_out_of_range':
        args[3] = args[3].clone()
        args[3][0, 0, 0] = 16
    elif case == 'maxiter_float':
        args[9] = 10.0
    return args


@pytest.mark.parametrize('fn', [pcg_packed, pcg_packed_reference])
@pytest.mark.parametrize('case,error', [
    ('T_3d', ValueError),
    ('T_float64', TypeError),
    ('ka_not_1_or_k', ValueError),
    ('edges_int64', TypeError),
    ('edges_members', ValueError),
    ('diag_shape', ValueError),
    ('b_3d', ValueError),
    ('b_noncontiguous', ValueError),
    ('tol_shape', ValueError),
    ('tol_per_member', ValueError),
    ('index_out_of_range', ValueError),
    ('maxiter_float', ValueError),
])
def test_argument_errors(fn, case, error):
    with pytest.raises(error):
        fn(*_bad_packed(case))


# ---------------------------------------------------------------------------
# the tangent route of mode 'cuda', on the CPU
# ---------------------------------------------------------------------------


def tangent_systems():
    """(system, tangent right-hand sides [P, 4, 16, 16], maxiter) of the 21
    molecule pairs, at their value solution."""
    from graphdot_tpu_torch.kernel import MarginalizedGraphKernel
    from graphdot_tpu_torch.microkernel import (
        KroneckerDelta, SquareExponential, TensorProduct)
    from graphdot_tpu_torch.testing import random_molecule_set
    graphs = random_molecule_set(11, 6, n_atoms_range=(5, 14))
    kernel = MarginalizedGraphKernel(
        TensorProduct(element=KroneckerDelta(0.2)),
        TensorProduct(length=SquareExponential(0.3)), q=0.05,
        backend='cuda', device='cpu')
    batch, bd, _ = kernel._prepare_batch(graphs)
    i, j = np.triu_indices(len(graphs))
    ops = kernel._operands(bd, bd, torch.as_tensor(i), torch.as_tensor(j))
    theta = kernel._theta_vector()
    kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
              n_p_theta=1, mode='cuda')
    s = mlgk_setup(theta, ops, **kw)
    maxiter = kernel.maxiter(batch.node_mask.shape[1])
    x = _plain_solve(s, 'edge', s['b'][:, None], s['tol'], maxiter)[:, 0]
    rhs = mlgk_tangents(theta, ops, s, x, **kw)['rhs']
    return s, rhs, maxiter


def _route_args(s):
    return (s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous())


def test_tangent_route_on_cpu_packs_all_directions():
    """On the CPU mode 'cuda' runs a pair's 4 tangent systems as one group
    of pcg_packed's twin, sharing the pair's operator; every system
    reaches the plain per-system PCG's solution."""
    s, rhs, maxiter = tangent_systems()
    P, k = rhs.shape[:2]
    assert k == 4 and not rhs[:, 0].any()     # p: b and A do not depend on it
    solve = cuda_tangent_solver(k, 64, 64, 16, 16, 'cpu')
    before = pcg_packed.launches
    x, iters = solve(*_route_args(s), rhs.contiguous(), s['gtol'], maxiter)
    assert pcg_packed.launches == before
    assert x.shape == (P, k, 16, 16) and iters.shape == (P,)
    assert not x[:, 0].any()
    want = _plain_solve(s, 'edge', rhs, s['gtol'], maxiter)
    scale = float(want.abs().max())
    np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize('group', [1, 3])
def test_tangent_route_splits_directions(group):
    """Directions split into groups of ``group`` (the route's choice when
    four members do not fit a block) give the same solutions."""
    s, rhs, maxiter = tangent_systems()
    P, k = rhs.shape[:2]
    x_all, _ = _packed_tangents(k, *_route_args(s), rhs.contiguous(),
                                s['gtol'], maxiter)
    x, iters = _packed_tangents(group, *_route_args(s), rhs.contiguous(),
                                s['gtol'], maxiter)
    assert x.shape == (P, k, 16, 16)
    assert iters.shape == (P * -(-k // group),)
    scale = float(x_all.abs().max())
    np.testing.assert_allclose(x.numpy(), x_all.numpy(), rtol=0,
                               atol=1e-4 * scale)

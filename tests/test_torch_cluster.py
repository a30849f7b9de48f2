"""The cluster route: ``pcg_cluster``'s plain twin and wrapper on the CPU,
the route rule that names it, and a Gram of mid-size molecules on its CPU
path, against the JAX package.

JAX's ``_pcg_stream_kernel`` (the TPU kernel that ``csrc/pcg_cluster.cu``
replaces for pairs beyond a block that fit a cluster) runs in interpret
mode on the CPU, forced for every pair by ``GRAPHDOT_PALLAS_STREAM=1``, as
``tests/test_torch_stream.py`` does. Tolerances: rtol 1e-5, atol 1e-7 on x
(float32 CG stopped at the same tol on both sides, summing in different
orders); atol 1e-6 on normalized Grams, 1e-3 max |dK| + 1e-5 on their
gradients.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK,
    Normalization as JaxNormalization,
)
from graphdot_tpu.ops.pallas_pcg import pallas_pcg_solver  # noqa: E402
from graphdot_tpu.testing import random_molecule_set  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.kernel.marginalized import _solver  # noqa: E402
from graphdot_tpu_torch.kernel.marginalized._kernel import (  # noqa: E402
    JobPlan)
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    CLUSTER_SIZES, pcg_cluster, pcg_cluster_reference, pcg_resident,
    pcg_stream, pcg_stream_reference)

from test_torch_pcg import _bad_args  # noqa: E402
from test_torch_stream import molecule_systems  # noqa: E402

CUDA = torch.device('cuda')


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

def _expected_route(fits, fits_cluster, eligible, ranks, n1n2, kron_min_n):
    """The order of the rule: a block, then kron, then a cluster, then the
    stream."""
    if fits:
        return 'resident'
    if eligible and ranks not in (None, 'off') and n1n2 > kron_min_n:
        return 'kron'
    return 'cluster' if fits_cluster else 'stream'


@pytest.mark.parametrize(
    'fits,fits_cluster,eligible,ranks,n1n2', itertools.product(
        (True, False), (True, False), (True, False), (None, 'off', (32,)),
        (64 * 64, 300 * 300)))
def test_route_rule_with_clusters(fits, fits_cluster, eligible, ranks, n1n2):
    """Mode 'cuda' over every combination: a block first, kron on its
    terms, a cluster before the stream; mode 'kron' and the plain modes
    are untouched by a cluster's fit."""
    kron_min_n = 96 * 96
    assert _solver.solve_route(
        'cuda', fits, eligible, ranks, n1n2, kron_min_n,
        fits_cluster=fits_cluster) == _expected_route(
            fits, fits_cluster, eligible, ranks, n1n2, kron_min_n)
    assert _solver.solve_route('kron', fits, eligible, ranks, n1n2,
                               kron_min_n, fits_cluster=fits_cluster) \
        == 'kron'
    for mode in ('edge', 'dense'):
        assert _solver.solve_route(mode, fits, eligible, ranks, n1n2,
                                   kron_min_n,
                                   fits_cluster=fits_cluster) == mode


def test_route_rule_cluster_between_kron_and_stream():
    big = 300 * 300
    assert _solver.solve_route('cuda', False, True, (32,), big, 0,
                               fits_cluster=True) == 'kron'
    assert _solver.solve_route('cuda', False, True, 'off', big, 0,
                               fits_cluster=True) == 'cluster'
    assert _solver.solve_route('cuda', False, False, (32,), 64 * 64,
                               fits_cluster=True) == 'cluster'
    assert _solver.solve_route('cuda', False, False, (32,), 64 * 64,
                               fits_cluster=False) == 'stream'
    # the default: no cluster named, the route of before
    assert _solver.solve_route('cuda', False, False, None, big) == 'stream'


@pytest.mark.parametrize('fits,fits_cluster,route', [
    (True, True, 'resident'), (True, False, 'resident'),
    (False, True, 'cluster'), (False, False, 'stream')])
def test_chunk_route_asks_the_card(monkeypatch, fits, fits_cluster, route):
    """On a CUDA device the shapes' fits decide; a cluster's fit is asked
    only of pairs beyond a block."""
    asked = []
    monkeypatch.setattr(_solver, 'resident_fits', lambda *a: fits)

    def cluster(*a):
        asked.append(a)
        return fits_cluster
    monkeypatch.setattr(_solver, 'cluster_fits', cluster)
    got = _solver.chunk_route('cuda', 192, 192, 72, 72, CUDA)
    assert got == route
    assert len(asked) == (0 if fits else 1)
    assert _solver.cuda_solver(192, 192, 72, 72, CUDA) is {
        'resident': pcg_resident, 'cluster': pcg_cluster,
        'stream': pcg_stream}[route]


def test_chunk_route_on_the_cpu_asks_nothing(monkeypatch):
    def fail(*a):
        raise AssertionError('asked a card')
    monkeypatch.setattr(_solver, 'resident_fits', fail)
    monkeypatch.setattr(_solver, 'cluster_fits', fail)
    assert _solver.chunk_route('cuda', 192, 192, 72, 72, 'cpu') == \
        'resident'
    assert _solver.chunk_route('edge', 192, 192, 72, 72, CUDA) == 'edge'


@pytest.mark.parametrize('route,solver', [
    ('resident', 'pcg_resident'), ('cluster', 'pcg_cluster'),
    ('stream', 'pcg_stream')])
def test_cuda_solver_by_route(route, solver):
    assert _solver.cuda_solver(192, 192, 72, 72, CUDA, route).__name__ \
        == solver


# ---------------------------------------------------------------------------
# the plain twin and the wrapper on the CPU
# ---------------------------------------------------------------------------

def _op_systems(seed=0):
    """The 15 pairs of ``molecule_systems('square')`` as operators, and
    systems naming them: some operators by several systems, one by none,
    each system its own right-hand side and tol."""
    args, maxiter = molecule_systems('square')
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol = args
    rng = np.random.default_rng(seed)
    op = torch.tensor([0, 0, 3, 5, 5, 5, 14, 2, 9, 0], dtype=torch.int32)
    scale = b[op.long()].abs().amax(dim=(1, 2), keepdim=True)
    rhs = torch.as_tensor(rng.normal(size=(len(op), *b.shape[1:])),
                          dtype=torch.float32) * scale
    return ((T, esrc1, edst1, esrc2, edst2, diag, precond, rhs.contiguous(),
             tol[op.long()].contiguous()), maxiter, op)


def test_twin_with_op_is_the_operator_repeated():
    args, maxiter, op = _op_systems()
    x, iters = pcg_cluster_reference(*args, maxiter, op=op)
    repeated = [a.index_select(0, op.long()) for a in args[:7]]
    x_rep, iters_rep = pcg_stream_reference(*repeated, *args[7:], maxiter)
    assert torch.equal(x, x_rep) and torch.equal(iters, iters_rep)
    assert x.shape == (len(op), *args[5].shape[1:])


def test_twin_without_op_is_the_stream_twin():
    args, maxiter = molecule_systems('rectangular')
    x, iters = pcg_cluster_reference(*args, maxiter)
    x_s, iters_s = pcg_stream_reference(*args, maxiter)
    assert torch.equal(x, x_s) and torch.equal(iters, iters_s)


def test_twin_with_op_matches_pallas_stream(monkeypatch):
    """The twin over systems that name their operators, against JAX's
    streaming kernel solving each system with its operator."""
    monkeypatch.setenv('GRAPHDOT_PALLAS_STREAM', '1')
    args, maxiter, op = _op_systems(1)
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol = args
    N1, N2 = diag.shape[1:]
    x, iters = pcg_cluster_reference(*args, maxiter, op=op)
    assert 0 < int(iters.min()) and int(iters.max()) < maxiter
    idx = op.numpy().astype(np.int64)

    def onehot(e, n):
        return jnp.asarray(np.eye(n, dtype=np.float32)[e.numpy()[idx]])

    solve = pallas_pcg_solver(
        jnp.asarray(T.numpy()[idx]), onehot(esrc1, N1), onehot(edst1, N1),
        onehot(esrc2, N2), onehot(edst2, N2), jnp.asarray(diag.numpy()[idx]),
        jnp.asarray(precond.numpy()[idx]), jnp.asarray(tol.numpy()), maxiter)
    x_jax = solve(jnp.asarray(b.numpy()).reshape(len(idx), N1 * N2))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax).reshape(x.shape),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('cluster_size', [None, 2, 16])
def test_wrapper_on_cpu_runs_the_twin(cluster_size):
    args, maxiter, op = _op_systems()
    before, last = pcg_cluster.launches, pcg_cluster.last_cluster_size
    x, iters = pcg_cluster(*args, maxiter, op=op, cluster_size=cluster_size)
    x_ref, iters_ref = pcg_cluster_reference(*args, maxiter, op=op)
    assert torch.equal(x, x_ref) and torch.equal(iters, iters_ref)
    assert pcg_cluster.launches == before
    assert pcg_cluster.last_cluster_size == last
    assert CLUSTER_SIZES == (2, 4, 8, 16)


def _bad_op(case):
    args, maxiter, op = _op_systems()
    args = list(args)
    if case == 'op_int64':
        op = op.long()
    elif case == 'op_float':
        op = op.float()
    elif case == 'op_shape':
        op = op[:-1]
    elif case == 'op_2d':
        op = op[:, None]
    elif case == 'op_out_of_range':
        op = op.clone()
        op[3] = args[0].shape[0]
    elif case == 'op_negative':
        op = op.clone()
        op[0] = -1
    elif case == 'op_list':
        op = op.tolist()
    elif case == 'b_2d':
        args[7] = args[7][0]
    elif case == 'tol_per_operator':
        args[8] = torch.ones(args[0].shape[0])
    elif case == 'diag_per_system':
        args[5] = args[5][op.long()]
    return args, maxiter, op


BAD_OP = [('op_int64', TypeError), ('op_float', TypeError),
          ('op_shape', ValueError), ('op_2d', ValueError),
          ('op_out_of_range', ValueError), ('op_negative', ValueError),
          ('op_list', TypeError), ('b_2d', ValueError),
          ('tol_per_operator', ValueError), ('diag_per_system', ValueError)]


@pytest.mark.parametrize('fn', [pcg_cluster, pcg_cluster_reference])
@pytest.mark.parametrize('case,error', BAD_OP)
def test_op_errors(fn, case, error):
    args, maxiter, op = _bad_op(case)
    with pytest.raises(error):
        fn(*args, maxiter, op=op)


@pytest.mark.parametrize('fn', [pcg_cluster, pcg_cluster_reference])
@pytest.mark.parametrize('case,error', [
    ('T_float64', TypeError), ('T_2d', ValueError),
    ('esrc_int64', TypeError), ('edst_shape', ValueError),
    ('diag_shape', ValueError), ('b_noncontiguous', ValueError),
    ('tol_shape', ValueError), ('index_out_of_range', ValueError),
    ('index_negative', ValueError), ('maxiter_negative', ValueError),
    ('maxiter_float', ValueError), ('not_a_tensor', TypeError)])
def test_argument_errors(fn, case, error):
    args, maxiter = _bad_args(case)
    with pytest.raises(error):
        fn(*args, maxiter)


@pytest.mark.parametrize('size', [1, 3, 32, 2.0, True, '4'])
def test_cluster_size_errors(size):
    args, maxiter, op = _op_systems()
    with pytest.raises(ValueError, match='cluster_size'):
        pcg_cluster(*args, maxiter, op=op, cluster_size=size)


# ---------------------------------------------------------------------------
# the cluster tangent route
# ---------------------------------------------------------------------------

def _tangent_case():
    """The operators of ``molecule_systems('square')`` with k = 3 right-hand
    sides a pair, a pair's tol for each."""
    args, maxiter = molecule_systems('square')
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol = args
    rng = np.random.default_rng(3)
    rhs = torch.as_tensor(rng.normal(size=(b.shape[0], 3, *b.shape[1:])),
                          dtype=torch.float32) * b.abs().amax() + 0.0
    return (T, esrc1, edst1, esrc2, edst2, diag, precond, rhs.contiguous(),
            tol, maxiter)


def test_cluster_tangents_name_their_pair(monkeypatch):
    """One pcg_cluster call for the P * k systems, each with its pair's
    operator (op = repeat_interleave(arange(P), k)) and tol; the result is
    each system solved with its pair's operator."""
    case = _tangent_case()
    operator, rhs, tol, maxiter = case[:7], case[7], case[8], case[9]
    P, k = rhs.shape[:2]
    calls = []

    def counted(*args, op=None, **kw):
        calls.append(op)
        return pcg_cluster(*args, op=op, **kw)
    monkeypatch.setattr(_solver, 'pcg_cluster', counted)
    x, iters = _solver._cluster_tangents(*operator, rhs, tol, maxiter)
    assert len(calls) == 1 and calls[0].dtype == torch.int32
    assert calls[0].tolist() == [p for p in range(P) for _ in range(k)]
    assert x.shape == rhs.shape and iters.shape == (P * k,)
    for m in range(k):
        x_m, _ = pcg_stream_reference(*operator, rhs[:, m].contiguous(), tol,
                                      maxiter)
        np.testing.assert_allclose(x[:, m].numpy(), x_m.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize('bad', [float('nan'), float('inf')])
def test_cluster_tangents_keep_a_non_finite_member_to_itself(bad):
    """A member whose right-hand side holds a NaN or inf gets a NaN x and
    no steps; every other member keeps the bits it gets with that
    member's right-hand side zero, and pairs without one the bits they get
    alone."""
    case = _tangent_case()
    operator, rhs, tol, maxiter = case[:7], case[7], case[8], case[9]
    hit = torch.tensor([0, 7])
    poisoned, zeroed = rhs.clone(), rhs.clone()
    poisoned[hit, 1, 1, 2] = bad
    zeroed[hit, 1] = 0.0
    x, iters = _solver._cluster_tangents(*operator, poisoned, tol, maxiter)
    x_zeroed, _ = _solver._cluster_tangents(*operator, zeroed, tol, maxiter)
    x_clean, _ = _solver._cluster_tangents(*operator, rhs, tol, maxiter)
    assert torch.isnan(x[hit, 1]).all()
    assert (iters.view(-1, 3)[hit, 1] == 0).all()
    assert torch.equal(x[:, [0, 2]], x_zeroed[:, [0, 2]])
    rest = torch.ones(rhs.shape[0], dtype=torch.bool)
    rest[hit] = False
    assert torch.equal(x[rest], x_clean[rest])


# ---------------------------------------------------------------------------
# a Gram of mid-size molecules on the cluster route's CPU path
# ---------------------------------------------------------------------------

def _kernels(m, **kwargs):
    return dict(node_kernel=m.TensorProduct(element=m.KroneckerDelta(0.2)),
                edge_kernel=m.TensorProduct(length=m.SquareExponential(0.3)),
                q=0.05, **kwargs)


def test_gram_on_the_cluster_route_matches_jax(monkeypatch):
    """Three molecules of 56-63 atoms (the pairs the cluster route takes on
    the card), the route forced on the CPU: the values in pcg_cluster's
    twin and the tangents as one cluster call a chunk, K and dK against
    the JAX package's edge backend."""
    graphs = random_molecule_set(7, 3, n_atoms_range=(56, 64))
    ops = []

    def counted(*args, op=None, **kw):
        ops.append(None if op is None else op.shape[0])
        return pcg_cluster(*args, op=op, **kw)
    monkeypatch.setattr(_solver, 'pcg_cluster', counted)
    monkeypatch.setattr(JobPlan, 'route',
                        lambda self, grp, ranks=None: 'cluster')
    monkeypatch.setattr(_solver, 'cuda_tangent_solver',
                        lambda *a, route=None: _solver._cluster_tangents)
    kernel = MarginalizedGraphKernel(**_kernels(tmk, backend='cuda',
                                                device='cpu'))
    K, dK = Normalization(kernel)(graphs, eval_gradient=True)
    assert None in ops and any(o is not None for o in ops)
    monkeypatch.undo()
    jax_kernel = JaxMGK(**_kernels(jmk, backend='edge'))
    K_jax, dK_jax = JaxNormalization(jax_kernel)(graphs, eval_gradient=True)
    np.testing.assert_allclose(K, np.asarray(K_jax), rtol=0, atol=1e-6)
    dK_jax = np.asarray(dK_jax)
    np.testing.assert_allclose(dK, dK_jax, rtol=0,
                               atol=1e-3 * np.abs(dK_jax).max() + 1e-5)

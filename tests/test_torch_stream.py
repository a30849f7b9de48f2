"""The streaming PCG's plain twin (``graphdot_tpu_torch.ops.pcg``) and the
port's Gram against the JAX package's streaming Pallas kernel, the protein
fixture, and the categorical-edge protein set.

JAX's ``_pcg_stream_kernel`` runs in interpret mode on the CPU, forced for
every pair by ``GRAPHDOT_PALLAS_STREAM=1`` (as ``tests/test_mlgk.py`` does),
with one-hot incidence matrices built from the same edge indices.
Tolerances: rtol 1e-5, atol 1e-7 on x and on raw Grams, atol 1e-6 on
normalized Grams (float32 CG stopped at ftol * N on both sides; the two sum
in different orders).

Run as a script to rewrite ``fixtures/torch_port_protein_ref.npz``.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu.graph import Graph  # noqa: E402
from graphdot_tpu.graph.batch import batch_graphs  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK,
    Normalization as JaxNormalization,
)
from graphdot_tpu.ops.pallas_pcg import pallas_pcg_solver  # noqa: E402
from graphdot_tpu.testing import (  # noqa: E402
    random_molecule_set, random_protein_set)

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch.convert import hyperparameters_from_numpy  # noqa
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    cuda_solver, mlgk_setup)
from graphdot_tpu_torch.ops.pcg import (  # noqa: E402
    pcg_resident, pcg_stream, pcg_stream_reference, stream_ctas_per_pair,
    stream_launch_plan)
from graphdot_tpu_torch.testing import (  # noqa: E402
    protein_niche_set, stream_plan_kind, with_dead_edges)

from test_torch_pcg import _bad_args  # noqa: E402

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_protein_ref.npz'
#: the fixture's graphs: protein_niche_set(seed, n, residues)
FIXTURE_SEED, FIXTURE_GRAPHS, FIXTURE_RESIDUES = 13, 4, (60, 90)


def niche_kernels(m, **kwargs):
    """The categorical-edge protein kernel, from microkernel module m."""
    return dict(
        node_kernel=m.TensorProduct(element=m.KroneckerDelta(0.2)),
        edge_kernel=m.TensorProduct(length=m.SquareExponential(3.0),
                                    ctype=m.KroneckerDelta(0.3)),
        q=0.05, **kwargs)


def jax_reference_gram():
    """The JAX package's exact normalized Gram (``backend='edge'``) over
    the fixture's graphs; returns (K, theta)."""
    graphs = protein_niche_set(FIXTURE_SEED, FIXTURE_GRAPHS,
                               FIXTURE_RESIDUES)
    kernel = JaxMGK(**niche_kernels(jmk, backend='edge'))
    return JaxNormalization(kernel)(graphs), kernel.flat_hyperparameters


# ---------------------------------------------------------------------------
# the plain twin against _pcg_stream_kernel
# ---------------------------------------------------------------------------


def molecule_systems(case):
    """Operands of pcg_stream for pairs of molecules of 8-14 atoms:
    'square' is all 15 pairs of 5 molecules; 'rectangular' pairs 5 of them
    with 3 of 20-24 atoms (M1 != M2, N1 != N2); 'odd_m2' and
    'dead_between' are the rectangular systems with dead edges added
    (``testing.with_dead_edges``), the shapes of the card's checks of
    csrc/pcg_stream.cu: M2 % 4 == 3, and dead edges between live ones on
    both sides."""
    if case in ('odd_m2', 'dead_between'):
        args, maxiter = molecule_systems('rectangular')
        return with_dead_edges(args, case), maxiter
    kernel = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
        device='cpu')
    mols = random_molecule_set(5, 5, n_atoms_range=(8, 14))
    _, bd1, _ = kernel._prepare_batch(mols)
    if case == 'square':
        bd2 = bd1
        i, j = np.triu_indices(5)
    else:
        _, bd2, _ = kernel._prepare_batch(
            random_molecule_set(6, 3, n_atoms_range=(20, 24)))
        i, j = (a.ravel() for a in np.indices((5, 3)))
    s = mlgk_setup(kernel._theta_vector(),
                   kernel._operands(bd1, bd2, torch.as_tensor(i),
                                    torch.as_tensor(j)),
                   knode=kernel.node_kernel, kedge=kernel.edge_kernel,
                   n_p_theta=1, mode='cuda')
    n_pad = max(bd1['node_mask'].shape[1], bd2['node_mask'].shape[1])
    return [s['T'], s['esrc_1'], s['edst_1'], s['esrc_2'], s['edst_2'],
            s['diag'].contiguous(), s['precond'].contiguous(),
            s['b'].contiguous(), s['tol']], kernel.maxiter(n_pad)


@pytest.mark.parametrize('case', ['square', 'rectangular', 'odd_m2',
                                  'dead_between'])
def test_reference_matches_pallas_stream(monkeypatch, case):
    monkeypatch.setenv('GRAPHDOT_PALLAS_STREAM', '1')
    args, maxiter = molecule_systems(case)
    T, esrc1, edst1, esrc2, edst2, diag, precond, b, tol = args
    P, M1, M2 = T.shape
    N1, N2 = diag.shape[1:]
    assert M2 % 128 != 0       # the JAX side pads M2 to 128 lanes
    if case != 'square':
        assert M1 != M2 and N1 != N2
    if case == 'odd_m2':
        assert M2 % 4 == 3 and M1 % 2 == 1
    if case == 'dead_between':
        # a dead edge of each side lies between two live ones
        for live in ((T != 0).any(dim=2), (T != 0).any(dim=1)):
            gaps = ~live[:, 1:-1] & live[:, :-2] & live[:, 2:]
            assert bool(gaps.any(dim=1).all())

    x, iters = pcg_stream_reference(*args, maxiter)
    assert x.shape == (P, N1, N2) and x.dtype == torch.float32
    assert 0 < int(iters.min()) and int(iters.max()) < maxiter

    def onehot(idx, n):
        return jnp.asarray(np.eye(n, dtype=np.float32)[idx.numpy()])

    solve = pallas_pcg_solver(
        jnp.asarray(T.numpy()), onehot(esrc1, N1), onehot(edst1, N1),
        onehot(esrc2, N2), onehot(edst2, N2), jnp.asarray(diag.numpy()),
        jnp.asarray(precond.numpy()), jnp.asarray(tol.numpy()), maxiter)
    x_jax = solve(jnp.asarray(b.numpy()).reshape(P, N1 * N2))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax).reshape(x.shape),
                               rtol=1e-5, atol=1e-7)


def test_wrapper_on_cpu_runs_reference():
    args, maxiter = molecule_systems('square')
    before = pcg_stream.launches
    x, iters = pcg_stream(*args, maxiter)
    x_ref, iters_ref = pcg_stream_reference(*args, maxiter)
    assert torch.equal(x, x_ref) and torch.equal(iters, iters_ref)
    assert pcg_stream.launches == before


@pytest.mark.parametrize('ctas', [1, 4, None])
def test_wrapper_on_cpu_takes_ctas_per_pair(ctas):
    """The split is the kernel's layout: the twin's result is the same at
    every C, and the wrapper's CPU path launches nothing."""
    args, maxiter = molecule_systems('rectangular')
    x, iters = pcg_stream(*args, maxiter, ctas_per_pair=ctas)
    x_ref, iters_ref = pcg_stream_reference(*args, maxiter)
    assert torch.equal(x, x_ref) and torch.equal(iters, iters_ref)


@pytest.mark.parametrize('ctas', [0, -2, 1.5, '3'])
def test_wrapper_rejects_bad_ctas_per_pair(ctas):
    args, maxiter = molecule_systems('square')
    with pytest.raises(ValueError, match='ctas_per_pair'):
        pcg_stream(*args, maxiter, ctas_per_pair=ctas)


@pytest.mark.parametrize('case', ['odd_m2', 'dead_between'])
def test_dead_edges_leave_the_twin_unchanged(case):
    """Dead edges are left out of the solve: the twin's result on the edge
    cases is the rectangular systems' own, bit for bit."""
    args, maxiter = molecule_systems('rectangular')
    x, iters = pcg_stream_reference(*args, maxiter)
    x_d, iters_d = pcg_stream_reference(*molecule_systems(case)[0], maxiter)
    assert torch.equal(x, x_d) and torch.equal(iters, iters_d)


@pytest.mark.parametrize('P,N1,grid,ctas,want', [
    (21, 272, 132, None, [(21, 6)]),        # the protein Gram's chunk
    (1, 272, 132, None, [(1, 132)]),        # a lone pair takes the grid
    (1, 88, 132, None, [(1, 88)]),          # ... at most N1 CTAs a pair
    (528, 72, 132, None, [(132, 1)] * 4),   # more pairs than the grid
    (140, 272, 132, None, [(132, 1), (8, 16)]),   # the last launch spreads
    (300, 88, 132, None, [(132, 1), (132, 1), (36, 3)]),
    (21, 272, 132, 7, [(18, 7), (3, 7)]),   # a forced C, every launch
    (5, 16, 132, 132, [(1, 132)] * 5),
    (0, 16, 132, None, []),
])
def test_stream_launch_plan(P, N1, grid, ctas, want):
    plan = stream_launch_plan(P, N1, grid, ctas)
    assert plan == want
    assert sum(pairs for pairs, _ in plan) == P
    assert all(pairs * C <= grid for pairs, C in plan)


@pytest.mark.parametrize('grid,ctas', [(0, None), (132, 0), (132, 133)])
def test_stream_launch_plan_rejects(grid, ctas):
    with pytest.raises(ValueError):
        stream_launch_plan(4, 16, grid, ctas)


@pytest.mark.parametrize('plan,kind', [
    ({'chunk_cols': 0, 'list_in_smem': 1}, 'shared'),
    ({'chunk_cols': 0, 'list_in_smem': 0}, 'list_in_device'),
    ({'chunk_cols': 6944, 'list_in_smem': 1, 'vectors_in_smem': 1},
     'chunked'),
    ({'chunk_cols': 14304, 'list_in_smem': 0, 'vectors_in_smem': 1},
     'chunked_list_in_device'),
    ({'chunk_cols': 6816, 'list_in_smem': 0, 'vectors_in_smem': 0},
     'chunked_l2'),
])
def test_stream_plan_kind(plan, kind):
    assert stream_plan_kind(plan) == kind


def test_smem_limit_leaves_the_cpu_path(monkeypatch):
    """A shared-memory limit only picks the card's plan: on CPU tensors
    pcg_stream is its twin whatever the limit."""
    rng = np.random.default_rng(3)
    P, M1, M2, N1, N2 = 2, 12, 11, 5, 4
    T = torch.tensor(rng.uniform(0, 0.1, (P, M1, M2)), dtype=torch.float32)
    edges = [torch.tensor(rng.integers(0, n, (P, m)), dtype=torch.int32)
             for n, m in ((N1, M1), (N1, M1), (N2, M2), (N2, M2))]
    diag = torch.tensor(rng.uniform(2, 3, (P, N1, N2)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(P, N1, N2)), dtype=torch.float32)
    args = [T, *edges, diag, 1 / diag, b, torch.full((P,), 1e-6), 40]
    want = pcg_stream_reference(*args)
    monkeypatch.setattr(pcg_stream, 'smem_limit', 4096)
    got = pcg_stream(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize('P,N1,grid,want', [
    (21, 272, 132, 6),      # the protein Gram's chunk: 6 CTAs a pair
    (1, 272, 132, 132),     # a lone protein pair takes the whole grid
    (1, 88, 132, 88),       # ... but no more CTAs than side-1 nodes
    (3, 88, 132, 44),
    (132, 272, 132, 1),
    (496, 72, 132, 1),      # more pairs than one launch takes
    (0, 16, 132, 16),
])
def test_stream_ctas_per_pair(P, N1, grid, want):
    assert stream_ctas_per_pair(P, N1, grid) == want


def test_route_on_cpu_is_the_plain_solver():
    """Off the card both kernels' wrappers run the same plain function;
    the route takes pcg_resident's and launches nothing."""
    assert cuda_solver(1144, 1144, 88, 88, 'cpu') is pcg_resident


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
@pytest.mark.parametrize('fn', [pcg_stream, pcg_stream_reference])
def test_argument_errors(fn, case, error):
    args, maxiter = _bad_args(case)
    with pytest.raises(error):
        fn(*args, maxiter)


# ---------------------------------------------------------------------------
# the port's Gram against the JAX package's streaming path
# ---------------------------------------------------------------------------


def jax_kernel():
    """The JAX kernel under test, away from the defaults."""
    return JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
        jmk.TensorProduct(length=jmk.SquareExponential(0.5)),
        p=1.5, q=0.1, backend='pallas')


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_gram_matches_jax_stream(monkeypatch, backend):
    monkeypatch.setenv('GRAPHDOT_PALLAS_STREAM', '1')
    mols = random_molecule_set(5, 5, n_atoms_range=(8, 14))
    jk = jax_kernel()
    tk = hyperparameters_from_numpy(
        MarginalizedGraphKernel(
            tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
            tmk.TensorProduct(length=tmk.SquareExponential(0.3)),
            backend=backend, device='cpu'),
        jk.flat_hyperparameters, bounds=jk.hyperparameter_bounds)
    np.testing.assert_allclose(tk(mols), jk(mols), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Normalization(tk)(mols),
                               JaxNormalization(jk)(mols), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the categorical-edge protein set and its fixture
# ---------------------------------------------------------------------------


def bench_protein_recipe(seed, n, residues):
    """The niche graphs as ``bench_protein.py`` builds them in ``main``."""
    base = random_protein_set(seed, n, n_residues_range=residues)
    out = []
    for g in base:
        e = g.edges
        ctype = np.minimum(
            np.abs(np.asarray(e['!i']) - np.asarray(e['!j'])) // 6, 2
        ).astype(np.float32)
        out.append(Graph(
            nodes=g.nodes,
            edges={'!i': e['!i'], '!j': e['!j'], '!w': e['!w'],
                   'length': e['length'], 'ctype': ctype},
            title=g.title))
    return Graph.unify_datatype(out)


@pytest.mark.parametrize('seed,n,residues,sizes,pads', [
    (13, 6, (180, 280), [269, 259, 196, 225, 252, 221], (272, 3736)),
    (FIXTURE_SEED, FIXTURE_GRAPHS, FIXTURE_RESIDUES, [86, 87, 88, 83],
     (88, 1144)),
])
def test_protein_niche_set_is_the_bench_recipe(seed, n, residues, sizes,
                                               pads):
    got = protein_niche_set(seed, n, residues)
    want = bench_protein_recipe(seed, n, residues)
    assert [len(g.nodes) for g in got] == sizes
    for g, w in zip(got, want):
        assert list(g.edges.columns) == list(w.edges.columns)
        for col in w.edges.columns:
            np.testing.assert_array_equal(np.asarray(g.edges[col]),
                                          np.asarray(w.edges[col]))
        for col in w.nodes.columns:
            np.testing.assert_array_equal(np.asarray(g.nodes[col]),
                                          np.asarray(w.nodes[col]))
        assert set(np.unique(np.asarray(g.edges['ctype']))) <= {0, 1, 2}
    batch = batch_graphs(got, use_native=False)
    assert (batch.node_mask.shape[1], batch.esrc.shape[1]) == pads


def test_protein_fixture_is_current():
    """The stored JAX reference Gram regenerates from the JAX package."""
    ref = np.load(FIXTURE)
    assert (int(ref['seed']), int(ref['n_graphs'])) == (FIXTURE_SEED,
                                                        FIXTURE_GRAPHS)
    assert tuple(ref['residues']) == FIXTURE_RESIDUES
    K, theta = jax_reference_gram()
    np.testing.assert_allclose(ref['theta'], theta, rtol=0, atol=0)
    np.testing.assert_allclose(ref['K'], K, rtol=0, atol=1e-6)


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_port_matches_protein_fixture(backend):
    ref = np.load(FIXTURE)
    graphs = protein_niche_set(int(ref['seed']), int(ref['n_graphs']),
                               tuple(ref['residues']))
    tk = MarginalizedGraphKernel(
        **niche_kernels(tmk, backend=backend, device='cpu'))
    hyperparameters_from_numpy(tk, ref['theta'])
    K = Normalization(tk)(graphs)
    np.testing.assert_allclose(K, ref['K'], rtol=0, atol=1e-6)


if __name__ == '__main__':
    import jax
    jax.config.update('jax_platforms', 'cpu')
    K, theta = jax_reference_gram()
    np.savez(FIXTURE, K=K, theta=theta, seed=FIXTURE_SEED,
             n_graphs=FIXTURE_GRAPHS, residues=np.array(FIXTURE_RESIDUES))
    print(f'wrote {FIXTURE}: K {K.shape}, theta {theta}')

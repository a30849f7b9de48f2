"""The port's sum-of-Kronecker route (``graphdot_tpu_torch/kernel/
marginalized/_kron.py``, ``backend='kron'``) against the JAX package's
``graphdot_tpu/kernel/marginalized/_kron.py``, on the CPU.

The same inputs go through both: the Chebyshev pieces one by one, rank
calibration, and the Grams of ``GramFactory(backend='kron')`` and of the
per-pair ``__call__`` over small contact-map proteins
(``random_protein_set``), with one edge feature (``length``) and with two
(``length``, ``sep``).

Tolerances: the Chebyshev pieces within 1e-6 (atol; float32 on both sides),
basis values within 5e-6 (the two packages' float32 cosines may put a node
an ulp apart, which the barycentric form amplifies near the node);
Grams within 1e-4 and dK within 5e-3 of JAX kron and of the port's
``'edge'``, the tolerances of ``tests/test_mlgk.py``'s kron tests: the
factorization is accurate to the calibration's 1e-6 on k_edge, not bit for
bit. The fused matvec meets its sequential twin within 1e-6.

Run as a script to rewrite ``fixtures/torch_port_kron_ref.npz``.
"""
import warnings
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.graph import Graph as JaxGraph  # noqa: E402
from graphdot_tpu.inference import GramFactory as JaxGramFactory  # noqa
from graphdot_tpu.kernel import MarginalizedGraphKernel as JaxMGK  # noqa
from graphdot_tpu.kernel.marginalized import _kron as jkron  # noqa: E402
from graphdot_tpu.kernel.marginalized._solver import (  # noqa: E402
    _apply_on_features as jax_apply)

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.inference import GramFactory  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.kernel.marginalized import _kernel, _kron  # noqa
from graphdot_tpu_torch.kernel.marginalized._backend import (  # noqa
    Backend, backend_factory)
from graphdot_tpu_torch.kernel.marginalized._solver import (  # noqa: E402
    _apply_on_features, mlgk_setup, mlgk_solve, solve_route)

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_kron_ref.npz'
#: the proteins of tests/test_mlgk.py::test_kron_backend_matches_edge:
#: random_protein_set(seed, n, residues)
PROTEINS = (7, 3, (30, 50))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread: the test processes run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kernels(m, **kwargs):
    """bench_protein.py's kernel, from microkernel module ``m``."""
    return dict(node_kernel=m.TensorProduct(element=m.KroneckerDelta(0.2)),
                edge_kernel=m.TensorProduct(length=m.SquareExponential(3.0)),
                q=0.05, **kwargs)


def two_feature_kernels(m, **kwargs):
    return dict(node_kernel=m.TensorProduct(element=m.KroneckerDelta(0.2)),
                edge_kernel=m.TensorProduct(length=m.SquareExponential(3.0),
                                            sep=m.SquareExponential(8.0)),
                q=0.05, **kwargs)


def with_sep(graphs, graph_cls):
    """The graphs with a second scalar edge feature, the sequence
    separation ``|i - j|``, as ``tests/test_mlgk.py`` builds it."""
    out = []
    for g in graphs:
        e = g.edges
        sep = np.abs(np.asarray(e['!i']) - np.asarray(e['!j'])).astype(
            np.float32)
        out.append(graph_cls(
            nodes=g.nodes,
            edges={'!i': e['!i'], '!j': e['!j'], '!w': e['!w'],
                   'length': e['length'], 'sep': sep},
            title=g.title))
    return out


def protein_sets(case):
    """(JAX graphs, port graphs, the function of its kernel arguments) of
    a case."""
    if case == 'length':
        return (jax_testing.random_protein_set(*PROTEINS),
                port_testing.random_protein_set(*PROTEINS), kernels)
    seed = (5, 3, (20, 30))
    return (with_sep(jax_testing.random_protein_set(*seed), JaxGraph),
            with_sep(port_testing.random_protein_set(*seed), Graph),
            two_feature_kernels)


@lru_cache(maxsize=None)
def jax_kron_gram(case):
    """The JAX package's kron GramFactory over a case's graphs: (K, dK in
    log theta, theta0, ranks), dK by ``jax.jacfwd`` of its ``gram``."""
    graphs, _, kern = protein_sets(case)
    fk = JaxGramFactory(JaxMGK(**kern(jmk, backend='kron')), graphs,
                        normalize=True, buckets=False)
    t0 = jnp.asarray(fk.theta0, dtype=jnp.float32)
    K = np.asarray(jax.jit(fk.gram)(t0))
    dK = np.asarray(jax.jit(jax.jacfwd(fk.gram))(t0))
    return K, dK, np.asarray(fk.theta0), np.asarray(fk._kron_ranks)


def port_gram(case, backend, **kwargs):
    """The port's factory Gram of a case: (K, dK, factory)."""
    _, graphs, kern = protein_sets(case)
    factory = GramFactory(
        MarginalizedGraphKernel(**kern(tmk, backend=backend, device='cpu')),
        graphs, normalize=True, buckets=False, **kwargs)
    K, dK = factory.gram(factory.theta0, eval_gradient=True)
    return K.numpy(), dK.numpy(), factory


# ---------------------------------------------------------------------------
# the Chebyshev pieces
# ---------------------------------------------------------------------------


def protein_edges(seed=7, n=3, residues=(30, 50)):
    """The padded edge lists of small proteins from the port's packer:
    (esrc, edst, ew, length [P, M], n_pad), numpy."""
    graphs = port_testing.random_protein_set(seed, n, residues)
    kernel = MarginalizedGraphKernel(**kernels(tmk, device='cpu'))
    batch, _, _ = kernel._prepare_batch(graphs)
    return (batch.esrc, batch.edst, batch.ew,
            batch.edge_elist_feats['length'], batch.node_mask.shape[1])


def test_cheb_nodes_and_basis_match_jax():
    rng = np.random.default_rng(0)
    for R in (8, 12, 33):
        t_j, w_j = jkron._cheb_nodes(jnp.float32(2.5), jnp.float32(9.0), R)
        t, w = _kron._cheb_nodes(2.5, 9.0, R)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-6)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6)
        # exact hits on the nodes (the JAX nodes, given to both) resolve to
        # one-hot rows; the other points to the barycentric values
        t_j = np.asarray(t_j)
        x = np.concatenate([rng.uniform(2.5, 9.0, 40).astype(np.float32),
                            t_j[[0, R // 2, R - 1]]])
        L_j = np.asarray(jkron._cheb_basis(jnp.asarray(x), t_j,
                                           np.asarray(w_j)))
        L = _kron._cheb_basis(torch.tensor(x), torch.tensor(t_j),
                              torch.tensor(np.asarray(w_j))).numpy()
        np.testing.assert_allclose(L, L_j, atol=1e-6)
        np.testing.assert_array_equal(L[-3:], np.eye(R)[[0, R // 2, R - 1]])
        np.testing.assert_allclose(L.sum(axis=-1), 1.0, atol=1e-5)


def test_feature_domain_matches_jax():
    esrc, edst, ew, x, _ = protein_edges()
    x2 = x[::-1].copy() + 1.5
    ew2 = ew[::-1].copy()
    lo_j, hi_j = jkron._feature_domain(x, ew, x2, ew2)
    lo, hi = _kron._feature_domain(*(torch.from_numpy(a) for a in
                                     (x, ew, x2, ew2)))
    assert float(lo) == float(lo_j) and float(hi) == float(hi_j)
    # padding edges carry 0, below every real length, and stay out
    assert (ew == 0).any() and float(lo) > 2.0
    # a feature of a single value: the guard widens it to a unit domain
    flat = np.where(ew != 0, 4.25, 0.0).astype(np.float32)
    lo, hi = _kron._feature_domain(*(torch.from_numpy(a) for a in
                                     (flat, ew, flat, ew)))
    lo_j, hi_j = jkron._feature_domain(flat, ew, flat, ew)
    assert (float(lo), float(hi)) == (float(lo_j), float(hi_j)) == (4.25,
                                                                     5.25)


@pytest.mark.parametrize('ranks', [(16,), (6, 5)])
def test_grid_basis_matches_jax(ranks):
    esrc, edst, ew, x, _ = protein_edges()
    rng = np.random.default_rng(1)
    f1 = {'length': x}
    f2 = {'length': x[::-1].copy()}
    if len(ranks) == 2:
        f1['sep'] = np.where(ew != 0, rng.uniform(1, 30, x.shape),
                             0).astype(np.float32)
        f2['sep'] = f1['sep'][::-1].copy()
    L1_j, L2_j, grids_j = jkron._grid_basis(f1, f2, ew, ew[::-1], ranks)
    L1, L2, grids = _kron._grid_basis(
        {k: torch.from_numpy(v) for k, v in f1.items()},
        {k: torch.from_numpy(v) for k, v in f2.items()},
        torch.from_numpy(ew), torch.from_numpy(ew[::-1].copy()), ranks)
    np.testing.assert_allclose(L1.numpy(), np.asarray(L1_j), atol=5e-6)
    np.testing.assert_allclose(L2.numpy(), np.asarray(L2_j), atol=5e-6)
    assert np.isfinite(L1.numpy()).all()    # padding edges clamped
    for name in grids_j:
        np.testing.assert_allclose(grids[name].numpy(),
                                   np.asarray(grids_j[name]), atol=1e-5)
    C_j = jkron._edge_kernel_grid(
        jax_apply, two_feature_kernels(jmk)['edge_kernel'] if len(ranks) == 2
        else kernels(jmk)['edge_kernel'], jnp.asarray([3.0, 8.0][:len(ranks)],
                                                      jnp.float32), grids_j)
    kedge = (two_feature_kernels(tmk) if len(ranks) == 2
             else kernels(tmk))['edge_kernel']
    C = _kron._edge_kernel_grid(_apply_on_features, kedge,
                                torch.tensor([3.0, 8.0][:len(ranks)]), grids)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_j), atol=1e-6)


def test_dense_grid_values_match_jax():
    esrc, edst, ew, x, n_pad = protein_edges()
    ranks = (12,)
    f = {'length': x}
    axes_j, _ = jkron._grid_axes(f, f, ew, ew, ranks)
    V_j = np.asarray(jkron._dense_grid_values(
        esrc, edst, ew, x[:, :, None], n_pad, ['length'], axes_j))
    domain = _kron.kron_domain({'length': torch.from_numpy(x)},
                               torch.from_numpy(ew),
                               {'length': torch.from_numpy(x)},
                               torch.from_numpy(ew))
    axes, _ = _kron._grid_axes(['length'], ranks, domain)
    V = _kron._dense_grid_values(
        torch.from_numpy(esrc), torch.from_numpy(edst), torch.from_numpy(ew),
        torch.from_numpy(x)[:, :, None], n_pad, ['length'], axes).numpy()
    assert V.shape == (x.shape[0], n_pad * n_pad, 12)
    np.testing.assert_allclose(V, V_j, atol=1e-6)
    # the grid holds each real edge once, nothing else
    assert (np.abs(V).sum(axis=-1) > 0).sum() == (ew != 0).sum()


def _ops(esrc, edst, ew, feats):
    return {'esrc_1': esrc, 'edst_1': edst, 'ew_1': ew,
            'edge_elist_feats_1': feats, 'esrc_2': esrc, 'edst_2': edst,
            'ew_2': ew, 'edge_elist_feats_2': feats}


def test_kron_eligible_matches_jax():
    esrc, edst, ew, x, _ = protein_edges()
    cases = {
        'one scalar': {'length': x},
        'two scalars': {'length': x, 'sep': x},
        'three scalars': {'length': x, 'sep': x, 'b': x},
        'no features': {},
        'variable length': {'length': (x, x > 0)},
        'not 2-D': {'length': x[:, :, None]},
    }
    for what, feats in cases.items():
        want = jkron.kron_eligible(_ops(esrc, edst, ew, feats))
        got = _kron.kron_eligible(_ops(esrc, edst, ew, feats))
        assert got == want, what
        assert got == (what in ('one scalar', 'two scalars'))
    mixed = _ops(esrc, edst, ew, {'length': x})
    mixed['edge_elist_feats_2'] = {'sep': x}
    assert not _kron.kron_eligible(mixed)
    assert not jkron.kron_eligible(mixed)


# ---------------------------------------------------------------------------
# ranks and their calibration
# ---------------------------------------------------------------------------


def calibration_data():
    """test_kron_rank_calibration's edge features: lengths in [2, 29]."""
    rng = np.random.default_rng(0)
    x1 = rng.uniform(2, 29, (4, 64)).astype(np.float32)
    x2 = rng.uniform(2, 29, (4, 64)).astype(np.float32)
    return x1, x2, np.ones((4, 64), np.float32)


def test_calibrate_ranks_matches_jax():
    """The smooth kernel settles on JAX's rank. The sharp one lands on
    JAX's rank or the rung below it: there the float32 error floor (~1e-6)
    meets RANK_TOL, and the sample decides; on the very sample where the
    port stopped, JAX's rank meets RANK_TOL too. The KroneckerDelta edge
    factor stays far above 1e-4."""
    x1, x2, w = calibration_data()
    tx1, tx2, tw = (torch.from_numpy(a) for a in (x1, x2, w))
    for length_scale in (3.0, 1.5):
        want, err_j = jkron.calibrate_ranks(
            jax_apply, kernels(jmk)['edge_kernel'],
            jnp.asarray([length_scale], jnp.float32), {'length': x1}, w,
            {'length': x2}, w)
        kedge = kernels(tmk)['edge_kernel']
        te = torch.tensor([length_scale])
        got, err = _kron.calibrate_ranks(
            _apply_on_features, kedge, te, {'length': tx1}, tw,
            {'length': tx2}, tw)
        assert err < _kron.RANK_TOL and err_j < _kron.RANK_TOL
        rungs = _kron.RANK_CANDIDATES
        if length_scale == 3.0:
            assert got == want == (32,)
            continue
        assert rungs.index(got[0]) in (rungs.index(want[0]),
                                       rungs.index(want[0]) - 1)
        # replay the calibration's draws up to the sample it stopped on
        g = torch.Generator().manual_seed(0)
        for R in rungs:
            state = g.get_state()
            e = float(_kron.factorization_error(
                _apply_on_features, kedge, te, {'length': tx1}, tw,
                {'length': tx2}, tw, ranks=R, n_sample=2048, generator=g))
            if e < _kron.RANK_TOL:
                break
        assert R == got[0]
        g.set_state(state)
        e_want = float(_kron.factorization_error(
            _apply_on_features, kedge, te, {'length': tx1}, tw,
            {'length': tx2}, tw, ranks=want, n_sample=2048, generator=g))
        assert e < _kron.RANK_TOL and e_want < _kron.RANK_TOL
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        _, err = _kron.calibrate_ranks(
            _apply_on_features, tmk.TensorProduct(length=tmk.KroneckerDelta(
                0.5)), torch.tensor([0.5]), {'length': tx1.round()}, tw,
            {'length': tx2.round()}, tw, candidates=(8, 16))
    assert err > 1e-4
    with pytest.warns(UserWarning, match='not smooth enough'):
        _kron.calibrate_ranks(
            _apply_on_features, tmk.TensorProduct(length=tmk.KroneckerDelta(
                0.5)), torch.tensor([0.5]), {'length': tx1.round()}, tw,
            {'length': tx2.round()}, tw, candidates=(8, 16))


def test_factorization_error_matches_jax():
    """test_kron_factorization_error_diagnostic's data; the port's error
    at each rung within a factor 3 of JAX's (other samples)."""
    rng = np.random.default_rng(0)
    x1 = rng.uniform(2, 9, (4, 64)).astype(np.float32)
    x2 = rng.uniform(2, 9, (4, 64)).astype(np.float32)
    w = np.ones((4, 64), np.float32)
    te = torch.tensor([3.0])
    err = float(_kron.factorization_error(
        _apply_on_features, kernels(tmk)['edge_kernel'], te,
        {'length': torch.from_numpy(x1)}, torch.from_numpy(w),
        {'length': torch.from_numpy(x2)}, torch.from_numpy(w)))
    assert err < 1e-5
    for R in (8, 12, 16):
        e_j = float(jkron.factorization_error(
            jax_apply, kernels(jmk)['edge_kernel'],
            jnp.asarray([3.0], jnp.float32), {'length': x1}, w,
            {'length': x2}, w, ranks=R))
        e = float(_kron.factorization_error(
            _apply_on_features, tmk.SquareExponential(3.0), te,
            torch.from_numpy(x1), torch.from_numpy(w), torch.from_numpy(x2),
            torch.from_numpy(w), ranks=R))
        assert e_j / 3 < e < 3 * e_j


def test_factorization_error_uses_the_whole_domain():
    """The grid lies on all real edges' range, not the sample's: a sample
    drawn from a narrow part of the data is measured on the solve's grid."""
    x = np.linspace(2.0, 29.0, 64, dtype=np.float32)[None]
    w = np.zeros_like(x)
    w[0, :8] = 1.0                       # the sample sees 2..5.4 only
    args = (_apply_on_features, kernels(tmk)['edge_kernel'],
            torch.tensor([1.5]), {'length': torch.from_numpy(x)},
            torch.from_numpy(w), {'length': torch.from_numpy(x)},
            torch.from_numpy(w))
    whole = {'length': (2.0, 29.0)}
    narrow = float(_kron.factorization_error(*args, ranks=16))
    wide = float(_kron.factorization_error(*args, ranks=16, domain=whole))
    assert narrow < 1e-4 < wide


def test_normalize_ranks():
    """JAX's defaults for one and two features; three and four stay within
    MAX_GRID instead of looping (the JAX loop never ends there)."""
    for names in (['a'], ['a', 'b']):
        assert _kron._normalize_ranks(None, names) == \
            jkron._normalize_ranks(None, names)
        assert _kron._normalize_ranks('off', names) == \
            jkron._normalize_ranks('off', names)
        assert _kron._normalize_ranks(12, names) == \
            jkron._normalize_ranks(12, names)
    for n in (3, 4, 5):
        ranks = _kron._normalize_ranks(None, list('abcde')[:n])
        assert len(ranks) == n and np.prod(ranks) <= _kron.MAX_GRID
        assert (ranks[0] + 1) ** n > _kron.MAX_GRID
    assert _kron._normalize_ranks((4, 6), ['a', 'b']) == (4, 6)
    assert _kron._normalize_ranks(np.int64(9), ['a']) == (9,)
    with pytest.raises(ValueError, match='2 ranks'):
        _kron._normalize_ranks((4, 6), ['a'])


# ---------------------------------------------------------------------------
# the matvec, the solve, the route
# ---------------------------------------------------------------------------


def kron_system(graphs, kern, ranks=None):
    """A kron system of all pairs of ``graphs`` (mlgk_setup, mode 'kron')
    and the kernel and ops it came from."""
    kernel = MarginalizedGraphKernel(**kern(tmk, backend='kron',
                                            device='cpu'))
    _, bd, _ = kernel._prepare_batch(graphs)
    i, j = (torch.as_tensor(a) for a in np.triu_indices(len(graphs)))
    ops = kernel._operands(bd, bd, i, j)
    plan = None if ranks is None else _kron.KronPlan(ranks, None, None)
    s = mlgk_setup(kernel._theta_vector(), ops, knode=kernel.node_kernel,
                   kedge=kernel.edge_kernel, n_p_theta=1, mode='kron',
                   kron=plan)
    return s, ops, kernel


@pytest.mark.parametrize('case', ['length', 'length and sep'])
def test_fused_matvec_matches_sequential(case):
    _, graphs, kern = protein_sets(case)
    ranks = (24,) if case == 'length' else (16, 12)
    s, ops, kernel = kron_system(graphs, kern, ranks)
    names = sorted(ops['edge_elist_feats_1'])
    P, n1, n2 = s['diag'].shape
    domain = _kron.kron_domain(ops['edge_elist_feats_1'], ops['ew_1'],
                               ops['edge_elist_feats_2'], ops['ew_2'])
    L1, L2, _ = _kron._grid_basis(ops['edge_elist_feats_1'],
                                  ops['edge_elist_feats_2'], ops['ew_1'],
                                  ops['ew_2'], ranks, domain)
    A1 = _kron._assemble_stack(ops['esrc_1'], ops['edst_1'], ops['ew_1'], L1,
                               n1)
    B2 = _kron._assemble_stack(ops['esrc_2'], ops['edst_2'], ops['ew_2'],
                               torch.einsum('cmq,pq->cmp', L2, s['C']), n2)
    Y = torch.from_numpy(np.random.default_rng(3).normal(
        size=(P, 3, n1, n2)).astype(np.float32))
    fused = _kron.kron_offdiag(s['A1s'], s['B2s'], Y)
    for d in range(3):
        # float32 sums of R * n terms in two orders: within 1e-6 of the
        # output's scale
        seq = _kron.kron_offdiag_sequential(A1, B2, Y[:, d])
        scale = float(seq.abs().max())
        assert float((fused[:, d] - seq).abs().max()) <= 1e-6 * scale
    # and the edge-factored matvec within the factorization's accuracy
    from graphdot_tpu_torch.ops.pcg import gather_offdiag
    e = mlgk_setup(kernel._theta_vector(), ops, knode=kernel.node_kernel,
                   kedge=kernel.edge_kernel, n_p_theta=1, mode='edge')
    exact = gather_offdiag(e['T'], *(e[f].long() for f in (
        'esrc_1', 'edst_1', 'esrc_2', 'edst_2')), Y[:, 0])
    scale = float(exact.abs().max())
    assert float((fused[:, 0] - exact).abs().max()) <= 1e-4 * scale


def test_fp32_products_restore_the_callers_tf32_setting():
    for setting in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = setting
        seen = []
        with _kron._fp32_matmul():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is setting
    torch.backends.cuda.matmul.allow_tf32 = False


def test_kron_solve_is_differentiable():
    """solve_linear's backward on the kron route (the coupling is C)
    against the forward-mode tangents of the same systems."""
    _, graphs, kern = protein_sets('length')
    s, ops, kernel = kron_system(graphs[:2], kern)
    theta = kernel._theta_vector().requires_grad_()
    kw = dict(knode=kernel.node_kernel, kedge=kernel.edge_kernel,
              n_p_theta=1, lmin=0, mode='kron', maxiter=400)
    x, _, _ = mlgk_solve(theta, ops, **kw)
    w = torch.from_numpy(np.random.default_rng(0).uniform(
        size=x.shape).astype(np.float32))
    (grad,) = torch.autograd.grad((x * w).sum(), theta)
    _, _, _, x_dot = mlgk_solve(theta.detach(), ops, tangents=True, **kw)
    want = (x_dot * w[..., None]).sum(dim=(0, 1, 2))
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=5e-3,
                               atol=5e-3 * float(want.abs().max()))


def test_route_rule():
    """solve_route as a function of shapes, eligibility, ranks and
    KRON_MIN_N: 'kron' takes every pair; 'cuda' keeps pairs that fit a
    block resident, and sends the others to kron only when eligible,
    calibrated and beyond KRON_MIN_N; the plain modes stay plain."""
    big = 300 * 300
    assert solve_route('kron', True, True, (8,), 16) == 'kron'
    assert solve_route('kron', False, False, None, big) == 'kron'
    assert solve_route('cuda', True, True, (32,), big, 0) == 'resident'
    assert solve_route('cuda', False, True, (32,), big, 0) == 'kron'
    assert solve_route('cuda', False, True, (32,), big, big) == 'stream'
    assert solve_route('cuda', False, True, (32,), big, big - 1) == 'kron'
    assert solve_route('cuda', False, True, 'off', big, 0) == 'stream'
    assert solve_route('cuda', False, True, None, big, 0) == 'stream'
    assert solve_route('cuda', False, False, (32,), big, 0) == 'stream'
    for mode in ('edge', 'dense'):
        assert solve_route(mode, False, True, (32,), big, 0) == mode
    # the default threshold: the port's choice from the card
    from graphdot_tpu_torch.kernel.marginalized import _solver
    assert solve_route('cuda', False, True, (32,), _solver.KRON_MIN_N + 1) \
        == 'kron'
    assert solve_route('cuda', False, True, (32,), _solver.KRON_MIN_N) \
        == 'stream'


def test_backend_modes():
    assert 'kron' in Backend.MODES
    assert backend_factory('kron', torch.device('cpu')).mode == 'kron'
    assert backend_factory('auto', torch.device('cpu')).mode == 'edge'


def test_kron_needs_scalar_edge_features():
    """Backend 'kron' on graphs without kron-eligible edge features raises:
    nothing stands in for it."""
    graphs = port_testing.protein_niche_set(13, 2, (20, 30))
    kernel = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(3.0),
                          ctype=tmk.KroneckerDelta(0.3)),
        q=0.05, backend='kron', device='cpu')
    # two scalar features: eligible, and calibration keeps the best rung
    with pytest.warns(UserWarning, match='not smooth enough'):
        kernel(graphs)
    molecules = port_testing.random_molecule_set(3, 3, (5, 9))
    bare = [Graph(nodes=g.nodes, edges={'!i': g.edges['!i'],
                                        '!j': g.edges['!j'],
                                        '!w': g.edges['!w']}, title=g.title)
            for g in molecules]
    kernel = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.Constant(1.0), q=0.05, backend='kron', device='cpu')
    with pytest.raises(ValueError, match="backend 'kron' needs"):
        kernel(bare)


def test_chunk_size_bounds_the_kron_working_set():
    """At 800-1000 residues (n = 920, R = 32) a chunk's four factor stacks
    stay within the route's budget, and gradients take smaller chunks."""
    kernel = MarginalizedGraphKernel(**kernels(tmk, backend='kron',
                                               device='cpu'))
    n, R = 920, 32
    sizes = [kernel._chunk_size(n, 13504, grad, route='kron', grid=R)
             for grad in (False, True)]
    assert 1 <= sizes[1] < sizes[0]
    assert 4 * R * n * n * sizes[0] <= _kernel.KRON_CHUNK_FLOATS


# ---------------------------------------------------------------------------
# the Grams against the JAX package and the edge backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', ['length', 'length and sep'])
def test_factory_gram_matches_jax_and_edge(case):
    K_j, dK_j, theta0, ranks_j = jax_kron_gram(case)
    launches = _kron.kron_pcg.launches
    K, dK, fk = port_gram(case, 'kron')
    assert _kron.kron_pcg.launches > launches
    K_e, dK_e, _ = port_gram(case, 'edge')
    np.testing.assert_allclose(fk.theta0, theta0, rtol=1e-6)
    assert len(fk._kron_ranks) == len(ranks_j)
    for want, what in ((K_j, 'jax kron'), (K_e, 'edge')):
        np.testing.assert_allclose(K, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    for want, what in ((dK_j, 'jax kron'), (dK_e, 'edge')):
        np.testing.assert_allclose(dK, want, rtol=5e-3, atol=5e-3,
                                   err_msg=what)
    stats = fk.iteration_stats(fk.theta0)
    assert stats[0]['iters'].min() >= 1
    _, worst = fk.gram(fk.theta0, with_residual=True)
    assert worst < 1e-4


def test_reference_fixture_is_current():
    ref = np.load(FIXTURE)
    K, dK, theta0, ranks = jax_kron_gram('length')
    np.testing.assert_array_equal(ref['theta'], theta0)
    np.testing.assert_array_equal(ref['ranks'], ranks)
    np.testing.assert_allclose(ref['K'], K, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ref['dK'], dK, rtol=1e-5, atol=1e-5)
    assert tuple(ref['proteins']) == (PROTEINS[0], PROTEINS[1],
                                      *PROTEINS[2])
    K, dK, _ = port_gram('length', 'kron')
    np.testing.assert_allclose(K, ref['K'], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dK, ref['dK'], rtol=5e-3, atol=5e-3)


def test_per_pair_call_matches_edge():
    """``__call__`` and ``diag`` with backend 'kron' (the per-pair route
    below 512 jobs) calibrate at the call's hyperparameters and agree with
    'edge': values, gradients, nodal values, a rectangular call."""
    graphs = port_testing.random_protein_set(*PROTEINS)

    def kern(backend):
        return MarginalizedGraphKernel(**kernels(tmk, backend=backend,
                                                 device='cpu'))

    kron, edge = kern('kron'), kern('edge')
    launches = _kron.kron_pcg.launches
    K, dK = Normalization(kron)(graphs, eval_gradient=True)
    assert _kron.kron_pcg.launches > launches
    K_e, dK_e = Normalization(edge)(graphs, eval_gradient=True)
    np.testing.assert_allclose(K, K_e, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dK, dK_e, rtol=5e-3, atol=5e-3)
    D, dD = kron.diag(graphs, eval_gradient=True)
    D_e, dD_e = edge.diag(graphs, eval_gradient=True)
    np.testing.assert_allclose(D, D_e, rtol=1e-4)
    np.testing.assert_allclose(dD, dD_e, rtol=5e-3,
                               atol=5e-3 * np.abs(dD_e).max())
    N = kron(graphs[:2], nodal=True)
    N_e = edge(graphs[:2], nodal=True)
    np.testing.assert_allclose(N, N_e, rtol=1e-4,
                               atol=1e-4 * np.abs(N_e).max())
    R = kron(graphs[:1], graphs[1:])
    np.testing.assert_allclose(R, edge(graphs[:1], graphs[1:]), rtol=1e-4)


def test_per_pair_call_calibrates_at_its_theta(monkeypatch):
    """Each call calibrates at its own hyperparameters: a sharper length
    scale gets a larger grid."""
    graphs = port_testing.random_protein_set(*PROTEINS)
    kernel = MarginalizedGraphKernel(**kernels(tmk, backend='kron',
                                               device='cpu'))
    seen = []
    real = _kron.calibrate_ranks

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((float(args[2][0]), out[0]))
        return out

    monkeypatch.setattr(_kernel, 'calibrate_ranks', recorded)
    kernel(graphs)
    sharp = kernel.clone_with_theta(kernel.theta + np.log(
        [1, 1, 1, 0.2]))
    sharp(graphs)
    assert [s[0] for s in seen] == pytest.approx([3.0, 0.6])
    assert seen[1][1][0] > seen[0][1][0]


def test_recalibrate_kron_at_a_sharper_length_scale():
    _, graphs, kern = protein_sets('length')
    fk = GramFactory(MarginalizedGraphKernel(**kern(
        tmk, backend='kron', device='cpu')), graphs, normalize=True)
    fe = GramFactory(MarginalizedGraphKernel(**kern(
        tmk, backend='edge', device='cpu')), graphs, normalize=True)
    ranks0 = fk._kron_ranks
    theta = fk.theta0.copy()
    theta[-1] = np.log(0.6)            # length scale 3.0 -> 0.6
    ranks = fk.recalibrate_kron(theta)
    assert ranks == fk._kron_ranks and ranks[0] > ranks0[0]
    assert fe.recalibrate_kron(theta) is None
    np.testing.assert_allclose(fk.gram(theta).numpy(),
                               fe.gram(theta).numpy(), rtol=1e-4, atol=1e-4)


def test_cuda_mode_on_the_cpu_never_takes_kron():
    """On the CPU every chunk of mode 'cuda' fits (the resident twin), so
    no factory calibrates; backend 'kron' refuses kron_ranks='off', which
    would leave it no route, and keeps the ranks it is given."""
    _, graphs, kern = protein_sets('length')
    fc = GramFactory(MarginalizedGraphKernel(**kern(
        tmk, backend='cuda', device='cpu')), graphs)
    assert fc._kron_ranks is None and not fc._kron_possible()
    with pytest.raises(ValueError, match="kron_ranks='off'"):
        GramFactory(MarginalizedGraphKernel(**kern(
            tmk, backend='kron', device='cpu')), graphs, kron_ranks='off')
    fk = GramFactory(MarginalizedGraphKernel(**kern(
        tmk, backend='kron', device='cpu')), graphs, kron_ranks=None)
    assert fk._kron_ranks == (_kron.DEFAULT_RANK,)
    fe = GramFactory(MarginalizedGraphKernel(**kern(
        tmk, backend='kron', device='cpu')), graphs, kron_ranks=12)
    assert fe._kron_ranks == (12,)
    np.testing.assert_allclose(fk.gram(fk.theta0).numpy(),
                               fe.gram(fe.theta0).numpy(), atol=1e-4)


def test_recalibration_at_the_same_theta_keeps_the_plan(monkeypatch):
    """recalibrate_kron (and so every call through the cached factory)
    calibrates again only at a theta other than the last calibration's."""
    _, graphs, kern = protein_sets('length')
    calls = []
    real = _kron.calibrate_ranks

    def counted(*args, **kwargs):
        calls.append(float(args[2][0]))
        return real(*args, **kwargs)

    monkeypatch.setattr(_kernel, 'calibrate_ranks', counted)
    fk = GramFactory(MarginalizedGraphKernel(**kern(
        tmk, backend='kron', device='cpu')), graphs)
    plan = fk._plan.kron
    assert calls == pytest.approx([3.0])
    assert fk.recalibrate_kron(fk.theta0) == plan.ranks
    assert fk._plan.kron is plan and len(calls) == 1
    theta = fk.theta0.copy()
    theta[-1] = np.log(0.6)
    fk.recalibrate_kron(theta)
    assert calls == pytest.approx([3.0, 0.6])
    fk.recalibrate_kron(theta)
    assert len(calls) == 2


def test_the_plan_names_each_chunks_route(monkeypatch):
    """The route that JobPlan.route names is the one every chunk's solve
    receives: kron for backend 'kron', resident for 'cuda' on the CPU."""
    _, graphs, kern = protein_sets('length')
    seen = []
    real = _kernel.mlgk_solve

    def recorded(*args, **kwargs):
        seen.append(kwargs['route'])
        return real(*args, **kwargs)

    monkeypatch.setattr(_kernel, 'mlgk_solve', recorded)
    for backend, want in (('kron', 'kron'), ('cuda', 'resident')):
        seen.clear()
        f = GramFactory(MarginalizedGraphKernel(**kern(
            tmk, backend=backend, device='cpu')), graphs)
        f.gram(f.theta0)
        assert [f._plan.route(g) for g in f._plan.groups] == [want]
        assert seen and set(seen) == {want}


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    K, dK, theta, ranks = jax_kron_gram('length')
    np.savez(FIXTURE, K=K, dK=dK, theta=theta, ranks=ranks,
             proteins=np.array([PROTEINS[0], PROTEINS[1], *PROTEINS[2]]))
    print(f'wrote {FIXTURE}: K {K.shape}, dK {dK.shape}, ranks {ranks}')

"""The port's graph metrics against the JAX package's: ``MaxiMin`` (the
distance, its hotspots, the hotspot gradient, ``device_distance_fn``),
``KernelInducedDistance`` and ``AltMarginalizedGraphKernel``, on the CPU
(``device='cpu'``; backend ``'cuda'`` runs its kernels' plain twins there).

Limits:

- D: 1e-4 where both sides' distance exceeds 0.01, else 5e-3 (the sqrt of
  d = sqrt(1 - ratio) turns a 1e-6 error of a float32 ratio into ~1e-3
  near d = 0); against a float64 brute force over the port's own nodal
  Gram, 1e-5.
- Hotspots: equal wherever a pair's top two distinct candidate distances
  (its nodal distance matrix's row and column minima) differ by more than
  1e-4; elsewhere float32 noise may break the tie differently.
- dD: 1e-3 max |dD| + 1e-4 off the diagonal at the pairs whose hotspots
  agree (at d = 0, the sqrt's kink, the gradient divides rounding by
  d + 1e-4); central differences in log theta (step 1e-3), rtol 0.1, atol
  0.05 off the diagonal, as ``tests/test_metric.py``.

Run as a script to rewrite ``fixtures/torch_port_maximin_ref.npz``: the
JAX package's D, hotspots, dD and ``device_distance_fn`` D over
``random_molecule_set(11, 16, (9, 24))`` (``backend='edge'``), which
``chip_smoke.py`` holds the card's metric against.
"""
from pathlib import Path

import networkx as nx
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.experimental.alternative_mgk import (  # noqa: E402
    AltMarginalizedGraphKernel as JaxAltMGK)
from graphdot_tpu.graph import Graph as JaxGraph  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK, Normalization as JaxNormalization)
from graphdot_tpu.metric import (  # noqa: E402
    KernelInducedDistance as JaxKID, MaxiMin as JaxMaxiMin)

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.experimental.alternative_mgk import (  # noqa: E402
    AltMarginalizedGraphKernel)
from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.kernel.marginalized import _solver  # noqa: E402
from graphdot_tpu_torch.kernel.marginalized._kernel import (  # noqa: E402
    JobPlan)
from graphdot_tpu_torch.metric import (  # noqa: E402
    KernelInducedDistance, MaxiMin)
from graphdot_tpu_torch.ops import pcg  # noqa: E402

from oracle import mlgk_pair  # noqa: E402

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_maximin_ref.npz'
#: bench_maximin.py's set, cut to 16 graphs: (seed, count, atoms)
FIXTURE_SET = (11, 16, (9, 24))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread (test processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def d_limit(a, b):
    """The D limit: 1e-4 where both distances exceed 0.01, else 5e-3."""
    return np.where((a > 0.01) & (b > 0.01), 1e-4, 5e-3)


def _nx_graphs():
    out = []
    for seed, n in [(0, 5), (1, 6), (2, 4)]:
        rng = np.random.default_rng(seed)
        g = nx.newman_watts_strogatz_graph(n, 3, 0.3, seed=seed)
        nx.set_node_attributes(
            g, {k: int(rng.integers(1, 4)) for k in g.nodes}, 'element')
        nx.set_edge_attributes(
            g, {e: float(rng.uniform(0.9, 1.4)) for e in g.edges}, 'length')
        out.append(g)
    return out


def small_graphs(package=Graph):
    """The three graphs of ``tests/test_metric.py`` in either package."""
    return package.unify_datatype(
        [package.from_networkx(g) for g in _nx_graphs()])


def port_metric(q=0.1, cls=MaxiMin, **kw):
    return cls(tmk.TensorProduct(element=tmk.KroneckerDelta(0.3)),
               tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=q,
               device='cpu', **kw)


def jax_metric(q=0.1, cls=JaxMaxiMin, **kw):
    return cls(jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
               jmk.TensorProduct(length=jmk.SquareExponential(0.3)), q=q,
               backend='edge', **kw)


def bench_metric(package='port', **kw):
    """``bench_maximin.py``'s metric in either package."""
    if package == 'port':
        return MaxiMin(tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
                       tmk.TensorProduct(length=tmk.SquareExponential(0.3)),
                       q=0.05, device='cpu', **kw)
    return JaxMaxiMin(jmk.TensorProduct(element=jmk.KroneckerDelta(0.2)),
                      jmk.TensorProduct(length=jmk.SquareExponential(0.3)),
                      q=0.05, backend='edge', **kw)


def nodal_distances(R, sizes):
    """The nodal distance matrix of every pair from a nodal Gram R (float64
    brute force): {(a, b): D_ab}."""
    starts = np.concatenate([[0], np.cumsum(sizes)])
    diag = np.diagonal(R)
    out = {}
    for a in range(len(sizes)):
        for b in range(len(sizes)):
            k12 = R[starts[a]:starts[a + 1], starts[b]:starts[b + 1]]
            k1 = diag[starts[a]:starts[a + 1]]
            k2 = diag[starts[b]:starts[b + 1]]
            out[a, b] = np.sqrt(np.maximum(
                0, 1 - k12 / np.sqrt(np.outer(k1, k2))))
    return out


def brute_force(nodal):
    """The maximin distance matrix from the nodal distances."""
    n = int(np.sqrt(len(nodal)))
    D = np.zeros((n, n))
    for (a, b), d in nodal.items():
        D[a, b] = max(d.min(axis=1).max(), d.min(axis=0).max())
    return D


def unambiguous(nodal):
    """[n, n] bool: the pairs whose top two distinct candidate distances
    (the row and column minima of the nodal distances) differ by more than
    1e-4."""
    n = int(np.sqrt(len(nodal)))
    out = np.zeros((n, n), dtype=bool)
    for (a, b), d in nodal.items():
        top = np.unique(np.concatenate([d.min(axis=1), d.min(axis=0)]))
        out[a, b] = len(top) < 2 or top[-1] - top[-2] > 1e-4
    return out


def _float64_nodal(metric, graphs):
    kernel = MarginalizedGraphKernel(
        metric.node_kernel, metric.edge_kernel, q=metric.q, device='cpu')
    return kernel(graphs, nodal=True).astype(np.float64)


# ---------------------------------------------------------------------------
# against a brute force and the dense oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_maximin_matches_brute_force(backend):
    G = small_graphs()
    metric = port_metric(backend=backend)
    D = metric(G)
    sizes = [len(g.nodes) for g in G]
    D_ref = brute_force(nodal_distances(_float64_nodal(metric, G), sizes))
    np.testing.assert_allclose(D, D_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.diag(D), 0, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(D, D.T)


def test_maximin_matches_dense_oracle():
    """The distance from the dense oracle's nodal solves
    (``tests/oracle.py::mlgk_pair``, float64 scipy CG)."""
    G = small_graphs()
    metric = port_metric()
    D = metric(G)
    n = len(G)
    R = {(a, b): mlgk_pair(G[a], G[b], metric.node_kernel,
                           metric.edge_kernel, metric.q)
         for a in range(n) for b in range(n)}
    D_ref = np.zeros((n, n))
    for a in range(n):
        for b in range(n):
            d = np.sqrt(np.maximum(0, 1 - R[a, b] / np.sqrt(np.outer(
                np.diag(R[a, a]), np.diag(R[b, b])))))
            D_ref[a, b] = max(d.min(axis=1).max(), d.min(axis=0).max())
    np.testing.assert_allclose(D, D_ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _compare_with_jax(D, hot, dD, JD, jhot, JdD, nodal):
    n = len(D)
    off = ~np.eye(n, dtype=bool)
    assert (np.abs(D - JD) <= d_limit(D, JD))[off].all()
    clear = unambiguous(nodal)
    assert clear.sum() >= n, 'too few pairs with a clear hotspot'
    agree = (hot[0] == jhot[0]) & (hot[1] == jhot[1])
    assert agree[clear].all()
    if dD is not None:
        limit = 1e-3 * np.abs(JdD).max() + 1e-4
        assert np.abs(dD - JdD)[agree & off].max() <= limit


@pytest.mark.parametrize('backend,buckets', [
    ('cuda', False), ('edge', False), ('cuda', True)])
def test_maximin_matches_jax(backend, buckets):
    """D, hotspots and dD over bench_maximin.py's graphs (9-24 atoms; two
    size classes with ``buckets``, where jobs are solved transposed)."""
    seed, _, atoms = FIXTURE_SET
    G = port_testing.random_molecule_set(seed, 10, atoms)
    JG = jax_testing.random_molecule_set(seed, 10, atoms)
    metric = bench_metric(backend=backend, buckets=buckets)
    D, hot, dD = metric(G, return_hotspot=True, eval_gradient=True)
    JD, jhot, JdD = bench_metric('jax')(JG, return_hotspot=True,
                                        eval_gradient=True)
    assert D.dtype == np.float32 and dD.dtype == np.float32
    assert dD.shape == (10, 10, len(metric.theta))
    nodal = nodal_distances(_float64_nodal(metric, G),
                            [len(g.nodes) for g in G])
    _compare_with_jax(D, hot, dD, JD, jhot, JdD, nodal)
    sizes = np.array([len(g.nodes) for g in G])
    assert (hot[0] < sizes[:, None]).all() and (hot[1] < sizes[None, :]).all()


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_maximin_lmin1_matches_jax(backend):
    """``lmin=1`` (walks of one step or more, the metric that the Gaussian
    field's weights take from ``bench_maximin.py``'s kernel) against JAX
    ``edge``: D by the D limit, dD off the diagonal by the dD limit at the
    pairs whose hotspots agree."""
    seed, _, atoms = FIXTURE_SET
    G = port_testing.random_molecule_set(seed, 8, atoms)
    JG = jax_testing.random_molecule_set(seed, 8, atoms)
    D, hot, dD = bench_metric(backend=backend)(
        G, return_hotspot=True, eval_gradient=True, lmin=1)
    JD, jhot, JdD = bench_metric('jax')(JG, return_hotspot=True,
                                        eval_gradient=True, lmin=1)
    off = ~np.eye(len(G), dtype=bool)
    assert (np.abs(D - JD) <= d_limit(D, JD))[off].all()
    agree = (hot[0] == jhot[0]) & (hot[1] == jhot[1]) & off
    assert agree.sum() >= 0.9 * off.sum()
    limit = 1e-3 * np.abs(JdD).max() + 1e-4
    assert np.abs(dD - JdD)[agree].max() <= limit
    D0 = bench_metric(backend=backend)(G)
    assert np.abs(D - D0)[off].max() > 1e-3, 'lmin=1 changes D'


def test_maximin_cross_matches_symmetric():
    """A rectangular call (X, Y) gives the symmetric call's block: D,
    hotspots and dD."""
    G = port_testing.random_molecule_set(11, 7, (9, 24))
    metric = bench_metric(buckets=True)
    D, (h1, h2), dD = metric(G, return_hotspot=True, eval_gradient=True)
    D2, (g1, g2), dD2 = metric(G[:3], G[3:], return_hotspot=True,
                               eval_gradient=True)
    np.testing.assert_allclose(D2, D[:3, 3:], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(g1, h1[:3, 3:])
    np.testing.assert_array_equal(g2, h2[:3, 3:])
    np.testing.assert_allclose(dD2, dD[:3, 3:], rtol=0,
                               atol=1e-5 * np.abs(dD).max())


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_device_distance_fn_matches_call(backend):
    G = port_testing.random_molecule_set(11, 8, (9, 24))
    metric = bench_metric(backend=backend)
    D = metric(G)
    fn, theta0 = metric.device_distance_fn(G)
    assert theta0.dtype == torch.float32
    np.testing.assert_allclose(theta0.numpy(), metric.theta, rtol=1e-6)
    D_fn = fn(theta0)
    assert D_fn.dtype == torch.float32 and D_fn.shape == (8, 8)
    D_fn = D_fn.numpy()
    assert (np.abs(D_fn - D) <= d_limit(D_fn, D)).all()
    np.testing.assert_array_equal(D_fn, D_fn.T)
    # a function of theta: another theta gives that theta's matrix
    theta = metric.theta + 0.2
    other = metric.clone_with_theta(theta)
    D_other = other(G)
    D_fn = fn(torch.as_tensor(theta)).numpy()
    assert (np.abs(D_fn - D_other) <= d_limit(D_fn, D_other)).all()


def test_maximin_gradient_central_differences():
    G = small_graphs()
    metric = port_metric()
    D, dD = metric(G, eval_gradient=True)
    assert dD.shape == (len(G), len(G), len(metric.theta))
    eps = 1e-3
    theta0 = metric.theta.copy()
    off = ~np.eye(len(G), dtype=bool)
    for i in range(len(theta0)):
        tp, tm = theta0.copy(), theta0.copy()
        tp[i] += eps
        tm[i] -= eps
        metric.theta = tp
        Dp = metric(G)
        metric.theta = tm
        Dm = metric(G)
        metric.theta = theta0
        fd = (Dp - Dm) / (2 * eps) / np.exp(theta0[i])
        np.testing.assert_allclose(dD[:, :, i][off], fd[off], rtol=0.1,
                                   atol=0.05, err_msg=f'theta[{i}]')


def test_port_matches_maximin_fixture():
    """The port on the fixture's graphs (backend 'cuda', its twins on the
    CPU) against the JAX values stored there."""
    ref = np.load(FIXTURE)
    seed, count, atoms = FIXTURE_SET
    G = port_testing.random_molecule_set(seed, count, atoms)
    metric = bench_metric(backend='cuda')
    D, hot, dD = metric(G, return_hotspot=True, eval_gradient=True)
    nodal = nodal_distances(_float64_nodal(metric, G),
                            [len(g.nodes) for g in G])
    _compare_with_jax(D, hot, dD, ref['D'], (ref['h1'], ref['h2']),
                      ref['dD'], nodal)
    fn, theta0 = metric.device_distance_fn(G)
    D_fn = fn(theta0).numpy()
    off = ~np.eye(count, dtype=bool)
    assert (np.abs(D_fn - ref['D_fn']) <= d_limit(D_fn, ref['D_fn']))[
        off].all()


def test_maximin_fixture_is_current():
    """JAX's values regenerate the fixture by the contracts of this file:
    D and ``device_distance_fn``'s D by the D limit (both float32, whose
    sqrt near d = 0 turns the ratio's rounding, which differs with the
    host's summation order, into ~1e-4), dD off the diagonal by the dD
    limit (its diagonal divides rounding by d + 1e-4), the hotspots
    exactly."""
    ref = np.load(FIXTURE)
    got = jax_reference()
    for key in ('h1', 'h2'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ('D', 'D_fn'):
        err = np.abs(got[key] - ref[key])
        assert (err <= d_limit(got[key], ref[key])).all(), (key, err.max())
    off = ~np.eye(len(ref['D']), dtype=bool)
    limit = 1e-3 * np.abs(ref['dD']).max() + 1e-4
    assert np.abs(got['dD'] - ref['dD'])[off].max() <= limit


# ---------------------------------------------------------------------------
# the hotspot gradient and the reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('buckets', [False, True])
def test_hotspot_grads_are_entries_of_the_nodal_jacobian(buckets):
    """``_solve_hotspot_grads`` gives, for each job, the entry of the full
    nodal jacobian at its hotspot, swapped jobs (two size classes)
    included."""
    G = port_testing.random_molecule_set(5, 5, (6, 20))
    kernel = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
        device='cpu', buckets=buckets)
    i, j = np.triu_indices(len(G))
    rng = np.random.default_rng(0)
    sizes = np.array([len(g.nodes) for g in G])
    h1 = rng.integers(0, sizes[i])
    h2 = rng.integers(0, sizes[j])
    plan = JobPlan(kernel, G, i, j, buckets)
    if buckets:
        assert plan.n_classes >= 2 and any(g["swap"].any()
                                           for g in plan.groups)
    grads = kernel._solve_hotspot_grads(plan, h1, h2, 0)
    _, full = kernel._solve_jobs(G, i, j, nodal=True, lmin=0,
                                 eval_gradient=True)
    want = np.stack([full[p][h1[p], h2[p]] for p in range(len(i))])
    np.testing.assert_allclose(grads, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _reduce_cases():
    """Nodal blocks with exact ties, and the same blocks solved
    transposed."""
    rng = np.random.default_rng(3)
    ks = rng.uniform(0.5, 1.0, size=(4, 5, 6))
    ks[0, 1, 2] = ks[0, 3, 4] = 0.2    # tied far entries
    ks[1] = 0.7                         # every entry tied
    k1 = rng.uniform(0.8, 1.2, size=(4, 5))
    k2 = rng.uniform(0.8, 1.2, size=(4, 6))
    k1[1] = k2[1] = 1.0
    n1 = np.array([5, 4, 3, 5])
    n2 = np.array([6, 6, 2, 4])
    return ks, k1, k2, n1, n2


def test_reduce_block_matches_jax():
    """The reduction on torch tensors against the JAX module's numpy one:
    the same distances and hotspots (largest flat index on ties), and a
    block solved transposed (``swap``) gives its job's own hotspot."""
    ks, k1, k2, n1, n2 = _reduce_cases()
    jdh, ji1, ji2 = jax_metric()._reduce_block(ks, k1, k2, n1, n2)
    t = [torch.as_tensor(a) for a in (ks, k1, k2, n1, n2)]
    dh, hot = MaxiMin._reduce_block(*t)
    np.testing.assert_array_equal(dh.numpy(), jdh)
    np.testing.assert_array_equal(hot.numpy(), ji1 * n2 + ji2)
    dh_t, hot_t = MaxiMin._reduce_block(
        t[0].transpose(1, 2), t[2], t[1], t[4], t[3],
        torch.ones(4, dtype=torch.bool))
    np.testing.assert_array_equal(dh_t.numpy(), jdh)
    np.testing.assert_array_equal(hot_t.numpy(), ji1 * n2 + ji2)


def test_hotspot_gradient_stream_twin(monkeypatch):
    """Graphs past a block on the ``pcg_stream`` route: the values and the
    tangents run in ``pcg_stream``'s plain twin (the route that mode
    'cuda' names on the card for such pairs, forced here), and D and dD
    agree with ``edge``."""
    G = port_testing.random_molecule_set(7, 3, (48, 72))
    calls = []
    real = pcg.pcg_stream

    def counted(*args, **kw):
        calls.append(args[7].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(_solver, 'pcg_stream', counted)
    monkeypatch.setattr(JobPlan, 'route', lambda self, grp, ranks=None:
                        'stream')
    monkeypatch.setattr(_solver, 'cuda_tangent_solver',
                        lambda *args, route=None: _solver._stream_tangents)
    D, dD = bench_metric(backend='cuda')(G, eval_gradient=True)
    assert len(calls) >= 3      # self, cross and hotspot-tangent solves
    monkeypatch.undo()
    De, dDe = bench_metric(backend='edge')(G, eval_gradient=True)
    assert (np.abs(D - De) <= d_limit(D, De)).all()
    np.testing.assert_allclose(dD, dDe, rtol=0,
                               atol=1e-3 * np.abs(dDe).max() + 1e-4)


def test_hotspot_gradient_kron():
    """Backend 'kron', ranks calibrated at the call's theta, against
    ``edge``: D within the D limit, dD within 1e-3 max |dD| + 1e-4."""
    G = port_testing.random_molecule_set(11, 5, (9, 24))
    D, hot, dD = bench_metric(backend='kron')(
        G, return_hotspot=True, eval_gradient=True)
    De, hote, dDe = bench_metric(backend='edge')(
        G, return_hotspot=True, eval_gradient=True)
    assert (np.abs(D - De) <= d_limit(D, De)).all()
    agree = (hot[0] == hote[0]) & (hot[1] == hote[1])
    assert agree.sum() >= len(G)
    assert np.abs(dD - dDe)[agree].max() <= 1e-3 * np.abs(dDe).max() + 1e-4


# ---------------------------------------------------------------------------
# the kernel-induced distance and the pair-list kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('cross', [False, True])
def test_kernel_induced_distance_matches_jax(cross):
    G, JG = small_graphs(), small_graphs(JaxGraph)
    kid = KernelInducedDistance(Normalization(port_metric(
        cls=MarginalizedGraphKernel)))
    jkid = JaxKID(JaxNormalization(jax_metric(cls=JaxMGK)))
    args = (G[:2], G[1:]) if cross else (G,)
    jargs = (JG[:2], JG[1:]) if cross else (JG,)
    D = kid(*args)
    np.testing.assert_allclose(D, jkid(*jargs), rtol=0, atol=1e-5)
    D2, dD = kid(*args, eval_gradient=True)
    JD2, JdD = jkid(*jargs, eval_gradient=True)
    np.testing.assert_allclose(D2, D, rtol=0, atol=1e-7)
    np.testing.assert_allclose(dD, JdD, rtol=0,
                               atol=1e-3 * np.abs(JdD).max() + 1e-5)
    assert kid.device == torch.device('cpu')
    if not cross:
        np.testing.assert_allclose(np.diag(D), 0, atol=1e-3)
    clone = kid.clone_with_theta(kid.theta)
    np.testing.assert_allclose(clone(*args), D, rtol=0, atol=0)


def test_alternative_mgk_matches_jax_and_the_gram():
    G = port_testing.random_molecule_set(2, 6, (6, 14))
    JG = jax_testing.random_molecule_set(2, 6, (6, 14))
    ij = [(0, 0), (0, 5), (3, 1), (4, 4), (2, 5), (5, 2)]
    k = port_metric(cls=AltMarginalizedGraphKernel)
    jk = jax_metric(cls=JaxAltMGK)
    got = k(G, ij)
    assert got.shape == (len(ij),) and got.dtype == np.float64
    np.testing.assert_allclose(got, jk(JG, ij), rtol=1e-5)
    K = port_metric(cls=MarginalizedGraphKernel)(G)
    np.testing.assert_allclose(got, [K[i, j] for i, j in ij], rtol=1e-6)
    np.testing.assert_allclose(k(G, ij, lmin=1), jk(JG, ij, lmin=1),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------


def jax_reference():
    seed, count, atoms = FIXTURE_SET
    JG = jax_testing.random_molecule_set(seed, count, atoms)
    metric = bench_metric('jax')
    D, (h1, h2), dD = metric(JG, return_hotspot=True, eval_gradient=True)
    fn, theta0 = metric.device_distance_fn(JG)
    return {'D': D, 'h1': h1, 'h2': h2, 'dD': dD,
            'D_fn': np.asarray(fn(theta0)),
            'theta': np.asarray(metric.theta), 'bench_set': np.array(
                [seed, count, *atoms])}


if __name__ == '__main__':
    np.savez(FIXTURE, **jax_reference())
    print(f'wrote {FIXTURE}')

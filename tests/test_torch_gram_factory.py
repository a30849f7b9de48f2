"""The port's ``GramFactory`` and the factory route of
``MarginalizedGraphKernel.__call__`` against the JAX package.

The same graphs (each package's ``random_molecule_set`` at one seed) and
hyperparameters go through JAX ``GramFactory`` (``backend='edge'``, on the
CPU) and the port's (``backend='cuda'``, whose CUDA kernels run their plain
twins on CPU tensors, and ``'edge'``): symmetric and rectangular, normalized
or not, one and two size classes, an ``Adhoc`` starting probability.

Tolerances: K within 1e-6 (atol; rtol 1e-6 for unnormalized Grams, whose
entries reach 10); dK within 1e-3 * max |dK| + 1e-5 of ``jax.jacfwd`` of
the JAX factory's ``gram``. The JAX jacobian solves its tangents at
``ftol``, the port at ``gtol``; both are float32 CG.
"""
import copy
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.inference import GramFactory as JaxGramFactory  # noqa
from graphdot_tpu.kernel import MarginalizedGraphKernel as JaxMGK  # noqa

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.inference import GramFactory  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    Exponentiation, MarginalizedGraphKernel, Normalization,
    Tang2019MolecularKernel)
from graphdot_tpu_torch.kernel.marginalized import Adhoc  # noqa: E402
from graphdot_tpu_torch.kernel.marginalized import _kernel  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread. The test processes run side by side, and
    torch's default of a thread a core then makes every small op wait on
    descheduled threads (tens of times slower than one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _p(nodes):
    """An ad hoc starting probability by element."""
    return 0.5 + 0.1 * np.asarray(nodes['element'] % 3, dtype=float)


#: graph sets: (seed, count, atom range); 'two' spans the classes 8 and 16
SETS = {'two': (11, 7, (5, 14)), 'one': (12, 5, (10, 16))}


@lru_cache(maxsize=None)
def graphs(pkg, name):
    m = jax_testing if pkg == 'jax' else port_testing
    return m.random_molecule_set(*SETS[name])


def jax_kernel(adhoc=False):
    return JaxMGK(jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
                  jmk.TensorProduct(length=jmk.SquareExponential(0.5)),
                  p=(_p, 'p') if adhoc else 1.5, q=0.1, backend='edge')


def port_kernel(backend='cuda', adhoc=False):
    return MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.3)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.5)),
        p=Adhoc(_p, 'p') if adhoc else 1.5, q=0.1, backend=backend,
        device='cpu')


#: case -> (graph set, normalize, rectangular, adhoc)
CASES = {
    'normalized_two_classes': ('two', True, False, False),
    'raw_one_class': ('one', False, False, False),
    'rectangular': ('two', False, True, False),
    'adhoc': ('two', True, False, True),
}


def _factory(factory_cls, pkg, case, kernel, **kwargs):
    name, normalize, rect, _ = CASES[case]
    G = graphs(pkg, name)
    if rect:
        return factory_cls(kernel, G[:3], normalize=False, graphs2=G[3:],
                           **kwargs)
    return factory_cls(kernel, G, normalize=normalize, **kwargs)


@lru_cache(maxsize=None)
def jax_gram(case):
    """K and jax.jacfwd(gram) of the JAX factory at its theta0."""
    fac = _factory(JaxGramFactory, 'jax', case, jax_kernel(CASES[case][3]))
    t = jnp.asarray(fac.theta0, dtype=jnp.float32)
    K, dK = jax.jit(lambda t: (fac.gram(t), jax.jacfwd(fac.gram)(t)))(t)
    return np.asarray(K), np.asarray(dK), fac.theta0


def _assert_gram(K, dK, K_want, dK_want):
    np.testing.assert_allclose(K, K_want, rtol=1e-6, atol=1e-6)
    scale = np.abs(dK_want).max()
    np.testing.assert_allclose(dK, dK_want, rtol=0, atol=1e-3 * scale + 1e-5)


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
@pytest.mark.parametrize('case', CASES)
def test_gram_matches_jax(case, backend):
    K_want, dK_want, theta0 = jax_gram(case)
    fac = _factory(GramFactory, 'port', case,
                   port_kernel(backend, CASES[case][3]))
    np.testing.assert_allclose(fac.theta0, theta0)
    assert fac.n_active == len(theta0)
    K, dK = fac.gram(fac.theta0, eval_gradient=True)
    assert K.dtype == dK.dtype == torch.float32
    assert K.shape == K_want.shape and dK.shape == dK_want.shape
    _assert_gram(K.numpy(), dK.numpy(), K_want, dK_want)
    # the value-only call gives the same K
    np.testing.assert_allclose(fac.gram(fac.theta0).numpy(), K.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_size_classes_and_packing():
    """Two classes give three groups at their own padded sizes, packed
    without the dense arrays; ``buckets=False`` packs one batch."""
    fac = GramFactory(port_kernel(), graphs('port', 'two'))
    assert [(g['n1'], g['n2']) for g in fac._plan.groups] == [
        (8, 8), (8, 16), (16, 16)]
    assert sum(len(g['pos']) for g in fac._plan.groups) == 7 * 8 // 2
    assert 'adj' not in fac._plan.groups[0]['bd1']
    one = GramFactory(port_kernel(), graphs('port', 'two'), buckets=False)
    assert [(g['n1'], g['n2']) for g in one._plan.groups] == [(16, 16)]
    np.testing.assert_allclose(one.gram(one.theta0).numpy(),
                               fac.gram(fac.theta0).numpy(), atol=1e-6)
    dense = GramFactory(port_kernel('dense'), graphs('port', 'one'))
    assert dense._plan.groups[0]['bd1']['adj'].shape[1:] == (16, 16)


def test_full_theta_and_validation():
    kernel = port_kernel()
    fac = GramFactory(Normalization(kernel), graphs('port', 'one'))
    assert fac.normalize and fac.kernel is kernel
    full = fac.full_theta(fac.theta0 + np.log(2.0))
    want = kernel.flat_hyperparameters.copy()
    want[kernel.active_theta_mask] *= 2.0
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-6)
    with pytest.raises(ValueError, match='maxiter'):
        GramFactory(kernel, graphs('port', 'one'), maxiter=0)
    with pytest.raises(ValueError, match='normalize'):
        GramFactory(kernel, graphs('port', 'one'), graphs2=graphs(
            'port', 'one'))


def test_residual_matches_jax():
    """The worst relative residual: at the float32 floor when converged,
    far above it when maxiter = 1 cuts every solve, as in JAX."""
    def both(maxiter):
        jf = JaxGramFactory(jax_kernel(), graphs('jax', 'two'),
                            maxiter=maxiter, union=False)
        pf = GramFactory(port_kernel(), graphs('port', 'two'),
                         maxiter=maxiter)
        jw = float(jax.jit(lambda t: jf.gram(t, with_residual=True)[1])(
            jnp.asarray(jf.theta0, dtype=jnp.float32)))
        K, pw = pf.gram(pf.theta0, with_residual=True)
        return jw, pw, K
    jax_conv, port_conv, K = both(None)
    assert port_conv < 1e-5 and jax_conv < 1e-5
    jax_cut, port_cut, _ = both(1)
    assert port_cut > 100 * port_conv
    np.testing.assert_allclose(port_cut, jax_cut, rtol=1e-3)
    # with eval_gradient the residual comes last
    fac = GramFactory(port_kernel(), graphs('port', 'two'))
    out = fac.gram(fac.theta0, eval_gradient=True, with_residual=True)
    assert len(out) == 3 and out[2] == port_conv
    np.testing.assert_allclose(out[0].numpy(), K.numpy(), atol=1e-7)


def test_iteration_stats_match_jax():
    """CG steps a pair against JAX's XLA count: each pair's count within
    one step (the two sides add in other orders)."""
    jf = JaxGramFactory(jax_kernel(), graphs('jax', 'two'), union=False)
    want = {}
    for st in jf.iteration_stats(jnp.asarray(jf.theta0, jnp.float32)):
        for gi, gj, it in zip(st['gi'].ravel(), st['gj'].ravel(),
                              st['iters']):
            want[min(gi, gj), max(gi, gj)] = int(it)
    pf = GramFactory(port_kernel(), graphs('port', 'two'))
    stats = pf.iteration_stats(pf.theta0)
    got = {}
    for st in stats:
        assert st['iters'].shape == (st['n_jobs'],)
        assert np.all(st['iters'] <= st['ca'] * st['cb'])
        assert st['k1'] == st['k2'] == 1 and st['m1'] > 0
        for gi, gj, it in zip(st['gi'], st['gj'], st['iters']):
            got[min(gi, gj), max(gi, gj)] = int(it)
    assert sorted(got) == sorted(want)
    assert all(abs(got[k] - want[k]) <= 1 for k in want), (got, want)
    assert np.all(np.array(list(got.values())) >= 1)


# ---------------------------------------------------------------------------
# __call__ through the cached factory
# ---------------------------------------------------------------------------


@pytest.fixture
def route(monkeypatch):
    """Set GRAPHDOT_API_UNION for the test; '1' routes every call."""
    def set_to(value):
        monkeypatch.setenv('GRAPHDOT_API_UNION', value)
    return set_to


@pytest.fixture
def packings(monkeypatch):
    """Counts the port's batch_graphs calls."""
    calls = []
    real = _kernel.batch_graphs

    def counted(*args, **kwargs):
        calls.append(len(args[0]))
        return real(*args, **kwargs)
    monkeypatch.setattr(_kernel, 'batch_graphs', counted)
    return calls


@lru_cache(maxsize=None)
def jax_call(rectangular):
    J = graphs('jax', 'two')
    return jax_kernel()(*((J[:3], J[3:]) if rectangular else (J,)),
                        eval_gradient=True)


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
@pytest.mark.parametrize('rectangular', [False, True])
def test_call_route_matches_per_pair_and_jax(route, backend, rectangular):
    G = graphs('port', 'two')
    args = (G[:3], G[3:]) if rectangular else (G,)
    route('0')
    kernel = port_kernel(backend)
    K_pair, dK_pair = kernel(*args, eval_gradient=True)
    assert not kernel.__dict__.get('_factory_cache')
    route('1')
    K, dK = kernel(*args, eval_gradient=True)
    assert len(kernel._factory_cache) == 1
    assert K.dtype == dK.dtype == np.float64
    np.testing.assert_allclose(K, K_pair, rtol=1e-6, atol=1e-6)
    scale = np.abs(dK_pair).max()
    np.testing.assert_allclose(dK, dK_pair, atol=1e-3 * scale + 1e-5)
    _assert_gram(K, dK, *jax_call(rectangular))
    np.testing.assert_allclose(kernel(*args), K, rtol=1e-6, atol=1e-7)


def test_call_route_threshold(route):
    """The route is taken at 512 jobs by default (32 graphs: 528), not
    below, and never for nodal calls or mode 'dense'."""
    route('auto')
    G = port_testing.random_molecule_set(3, 32, (3, 6))
    kernel = port_kernel()
    kernel(G[:31])                       # 496 jobs
    assert not kernel.__dict__.get('_factory_cache')
    kernel(G)
    assert len(kernel._factory_cache) == 1
    route('1')
    kernel(G[:3], nodal=True)
    assert len(kernel._factory_cache) == 1
    dense = port_kernel('dense')
    dense(G[:3])
    assert not dense.__dict__.get('_factory_cache')


def test_cache_reuse_and_invalidation(route, packings):
    route('1')
    G = port_testing.random_molecule_set(*SETS['two'])
    kernel = port_kernel()
    K = kernel(G)
    assert len(packings) == 2            # the classes 8 and 16, once each
    kernel(G, eval_gradient=True)
    kernel.clone_with_theta(kernel.theta)(G)
    assert len(packings) == 2            # hits: no packing
    # a clone shares the cache
    clone = kernel.clone_with_theta(kernel.theta + 0.1)
    assert clone._factory_cache is kernel._factory_cache
    # permuting a graph in place clears its cookie: the entry is rebuilt
    G[0].permute(np.arange(len(G[0].nodes))[::-1], inplace=True)
    np.testing.assert_allclose(kernel(G), K, atol=1e-6)
    assert len(packings) == 4
    Graph.unify_datatype(G, inplace=True)
    kernel(G)
    assert len(packings) == 6
    # four entries at most, the oldest dropped first
    for n in range(3, 8):
        kernel(G[:n])
    assert len(kernel._factory_cache) == 4


@pytest.mark.parametrize('wrapper', ['normalization', 'exponentiation',
                                     'tang2019'])
def test_wrapped_clones_share_the_cache(route, packings, wrapper):
    """A wrapper's ``clone_with_theta`` clones the graph kernel through its
    own, so a clone's call at other hyperparameters packs nothing."""
    route('1')
    G = graphs('port', 'two')
    if wrapper == 'tang2019':
        kernel = Tang2019MolecularKernel(device='cpu')
        inner = kernel.kernel
    else:
        inner = port_kernel()
        kernel = (Normalization if wrapper == 'normalization'
                  else Exponentiation)(inner)
    K = kernel(G)
    assert len(packings) == 2
    clone = kernel.clone_with_theta(kernel.theta + 0.1)
    K_clone = clone(G)
    assert len(packings) == 2
    assert clone.kernel._factory_cache is inner._factory_cache
    np.testing.assert_allclose(clone.theta, kernel.theta + 0.1)
    assert not np.allclose(K_clone, K)
    # the original keeps its hyperparameters
    np.testing.assert_allclose(kernel(G), K, atol=1e-7)


def test_pickle_state_and_deep_copies_drop_the_cache(route):
    """``__getstate__`` (pickle's and deepcopy's view of the kernel) leaves
    the cache of device tensors out, and the copy builds its own."""
    route('1')
    kernel = port_kernel()
    K = kernel(graphs('port', 'two'))
    assert kernel._factory_cache
    state = kernel.__getstate__()
    assert '_factory_cache' not in state
    assert state['node_kernel'] is kernel.node_kernel
    twin = copy.deepcopy(kernel)
    assert '_factory_cache' not in twin.__dict__
    np.testing.assert_allclose(twin(graphs('port', 'two')), K, atol=1e-7)
    assert len(twin._factory_cache) == len(kernel._factory_cache) == 1


def test_route_raises_instead_of_falling_back(route, monkeypatch):
    route('1')

    def broken(*args, **kwargs):
        raise RuntimeError('solver failed')
    kernel = port_kernel()
    monkeypatch.setattr(kernel, '_solve_chunk', broken)
    with pytest.raises(RuntimeError, match='solver failed'):
        kernel(graphs('port', 'two'))

"""The port's active-learning selectors (``VarianceMinimizer``,
``DeterminantMaximizer``, ``HierarchicalDrafter``: numpy copies) against
the JAX package's: the first four cases of
``tests/test_active_learning.py``, each also against the JAX selector on
the same inputs, exact ties, and the selection over graphs with each
package's normalized marginalized graph kernel (the port's on the CPU,
``device='cpu'``).

Limits: the same indices in the same order, everywhere; over graphs the
two kernels' float32 Grams differ by ~1e-7, far below the gaps between
the greedy scores of these sets.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK, Normalization as JaxNormalization)
from graphdot_tpu.model import active_learning as jal  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.model import active_learning as al  # noqa: E402
from graphdot_tpu_torch.model.active_learning import (  # noqa: E402
    DeterminantMaximizer, HierarchicalDrafter, VarianceMinimizer)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread (test processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rbf_kernel_matrix(X, s=0.3):
    d2 = (X[:, None] - X[None, :]) ** 2
    return np.exp(-0.5 * d2 / s ** 2)


class RBF:
    def __call__(self, X, **kw):
        return _rbf_kernel_matrix(np.asarray(X, dtype=float))


def both(name, *args, **kwargs):
    """The selector ``name`` of the port and of the JAX package."""
    return getattr(al, name)(*args, **kwargs), getattr(jal, name)(
        *args, **kwargs)


def test_variance_minimizer_spreads():
    X = np.concatenate([np.linspace(0, 1, 20), [5.0]])
    chosen, jchosen = (s(X, 5) for s in both('VarianceMinimizer', RBF()))
    assert len(set(chosen)) == 5
    # the isolated point cannot be explained by the cluster and must be
    # picked once the cluster is covered
    assert 20 in chosen
    assert chosen == jchosen


def test_variance_minimizer_precomputed():
    X = np.linspace(0, 1, 12)
    K = _rbf_kernel_matrix(X)
    c1, j1 = (s(K, 4) for s in both('VarianceMinimizer', 'precomputed'))
    c2 = VarianceMinimizer(RBF())(X, 4)
    assert sorted(c1) == sorted(c2)
    assert c1 == j1
    with pytest.raises(ValueError):
        VarianceMinimizer('precomputed')(K[:3], 2)
    with pytest.raises(ValueError):
        VarianceMinimizer(RBF())(X, 13)
    with pytest.raises(TypeError):
        VarianceMinimizer('rbf')


def test_determinant_maximizer():
    X = np.concatenate([np.linspace(0, 0.2, 10), [3.0, 6.0]])
    chosen, jchosen = (s(X, 3) for s in both('DeterminantMaximizer', RBF()))
    assert len(set(chosen)) == 3
    assert 10 in chosen and 11 in chosen  # both isolated points chosen
    assert chosen == jchosen
    K = _rbf_kernel_matrix(X)
    assert DeterminantMaximizer('precomputed')(K, 3) == chosen


@pytest.mark.parametrize('k,a', [(2, 2), (3, 1.5)])
def test_hierarchical_drafter(k, a):
    X = np.linspace(0, 1, 64)
    drafter, jdrafter = both('HierarchicalDrafter',
                             VarianceMinimizer(RBF()), k=k, a=a)
    chosen = drafter(X, 8, random_state=0)
    assert len(chosen) == 8
    assert len(set(chosen.tolist())) == 8
    assert np.all(np.diff(chosen) > 0)  # sorted
    np.testing.assert_array_equal(chosen,
                                  jdrafter(X, 8, random_state=0))
    rng, jrng = (np.random.default_rng(3) for _ in range(2))
    np.testing.assert_array_equal(drafter(X, 8, random_state=rng),
                                  jdrafter(X, 8, random_state=jrng))
    with pytest.raises(ValueError):
        HierarchicalDrafter(VarianceMinimizer(RBF()), k=1)
    with pytest.raises(ValueError):
        drafter(X, 65)


@pytest.mark.parametrize('name', ['VarianceMinimizer',
                                  'DeterminantMaximizer'])
def test_ties_break_as_jax(name):
    """Exact ties in the greedy score (identical samples, a constant
    kernel block) break to the lowest index, as ``np.argmax`` does in
    the JAX selectors."""
    K = np.ones((6, 6)) * 0.5 + 0.5 * np.eye(6)
    K[4:, 4:] = 1.0
    for n in (1, 3, 5):
        picks, jpicks = (s(K.copy(), n) for s in both(name, 'precomputed'))
        assert picks == jpicks


def _graph_kernel(package):
    if package == 'port':
        return Normalization(MarginalizedGraphKernel(
            tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
            tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
            device='cpu'))
    return JaxNormalization(JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.2)),
        jmk.TensorProduct(length=jmk.SquareExponential(0.3)), q=0.05,
        backend='edge'))


def test_selection_over_graphs_matches_jax():
    """The three selectors over molecules, each package's kernel computing
    the Gram: the same picks."""
    G = port_testing.random_molecule_set(9, 16, (5, 12))
    JG = jax_testing.random_molecule_set(9, 16, (5, 12))
    k, jk = _graph_kernel('port'), _graph_kernel('jax')
    assert VarianceMinimizer(k)(G, 5) == jal.VarianceMinimizer(jk)(JG, 5)
    # the first pick of the determinant is the largest diagonal entry,
    # which a normalized Gram ties at 1: the raw kernel instead
    assert DeterminantMaximizer(k.kernel)(G, 5) == \
        jal.DeterminantMaximizer(jk.kernel)(JG, 5)
    chosen = HierarchicalDrafter(VarianceMinimizer(k))(G, 4, random_state=1)
    np.testing.assert_array_equal(
        chosen, jal.HierarchicalDrafter(jal.VarianceMinimizer(jk))(
            JG, 4, random_state=1))

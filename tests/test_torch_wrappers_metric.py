"""The port's ``RBFKernel`` and ``KernelOverMetric`` against the JAX
package's, the cases of ``tests/test_wrappers.py`` (``test_rbf_kernel``,
``test_kernel_over_metric``) on the CPU (``device='cpu'``), and their
default device.

Limits: the RBF kernel and its gradient 1e-12 (float64 on both sides)
wherever the distance is not a rounding residual; on the diagonal of
k(X), where it is, the value at d = 0 within ``_diagonal_limit``;
``KernelOverMetric`` over ``MaxiMin`` K 1e-4 (the D limit of
``tests/test_torch_metric.py`` through a Gaussian of width 1), dK
1e-3 max |dK| + 1e-4, central differences in log theta (step 1e-3) rtol
0.1, atol 0.05.
"""
import numpy as np
import pytest
import sympy

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.kernel._kernel_over_metric import (  # noqa: E402
    KernelOverMetric as JaxKOM)
from graphdot_tpu.kernel.rbf import RBFKernel as JaxRBF  # noqa: E402
from graphdot_tpu.metric import MaxiMin as JaxMaxiMin  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.kernel._kernel_over_metric import (  # noqa: E402
    KernelOverMetric, _parse_hyper_spec)
from graphdot_tpu_torch.kernel.rbf import RBFKernel  # noqa: E402
from graphdot_tpu_torch.metric import MaxiMin  # noqa: E402

GRAPHS = port_testing.random_molecule_set(1, 6, n_atoms_range=(5, 9))
JAX_GRAPHS = jax_testing.random_molecule_set(1, 6, n_atoms_range=(5, 9))
EXPR = 'v * exp(-d**2 / (2 * s**2))'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread (test processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _metric():
    return MaxiMin(tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
                   tmk.TensorProduct(length=tmk.SquareExponential(0.3)),
                   q=0.05, device='cpu')


def _jax_metric():
    return JaxMaxiMin(jmk.TensorProduct(element=jmk.KroneckerDelta(0.2)),
                      jmk.TensorProduct(length=jmk.SquareExponential(0.3)),
                      q=0.05, backend='edge')


def _diagonal_limit(f, X):
    """The limit on the diagonal of a Gram of ``f(d)`` over X.

    There d is sqrt(sq) with sq = |x|^2 - 2 x.x + |x|^2 a rounding
    residual: each of the three float64 dot products of length m errs by
    at most m eps |x|^2 (any summation order), the doubled one twice
    that, and the two subtractions add eps |x|^2 at most, so |sq| <=
    c eps max |x|^2 with c = 4 m + 2. Both packages' diagonal is then
    f(0) within |f'(0)| sqrt(c eps max |x|^2), plus the off-diagonal
    limit 1e-12 for the higher orders. ``f`` is a SymPy expression of d
    alone."""
    d = sympy.Symbol('d')
    slope = abs(float(sympy.diff(f, d).subs(d, 0)))
    c = 4 * X.shape[1] + 2
    residual = c * np.finfo(np.float64).eps * float((X * X).sum(1).max())
    return slope * np.sqrt(residual) + 1e-12


@pytest.mark.parametrize('expr,params', [
    ('exp(-0.5 * d**2 / s**2)', dict(s=0.7)),
    ('v * exp(-d / l) + c', dict(v=1.5, l=0.8, c=0.1)),
    ('(1 + d**2 / (2 * a * l**2))**(-a)', dict(a=2.0, l=1.3)),
])
def test_rbf_kernel_matches_jax(expr, params):
    """1e-12 wherever the distance is not a rounding residual; on the
    diagonal of k(X), where it is, both packages within
    ``_diagonal_limit`` of the value at d = 0 (of ``k.diag`` for K)."""
    k = RBFKernel(expr, 'd', device='cpu', **params)
    jk = JaxRBF(expr, 'd', **params)
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(10, 3)), rng.normal(size=(7, 3))
    off = ~np.eye(len(X), dtype=bool)
    f = sympy.sympify(expr).subs(params)
    K, JK = k(X), jk(X)
    np.testing.assert_allclose(K[off], JK[off], rtol=1e-12, atol=1e-12)
    limit = _diagonal_limit(f, X)
    for M in (K, JK):
        np.testing.assert_allclose(np.diag(M), k.diag(X), rtol=0,
                                   atol=limit)
    np.testing.assert_allclose(k(X, Y), jk(X, Y), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(k.diag(X), jk.diag(X), rtol=1e-12)
    g, jg = k.gradient(X), jk.gradient(X)
    assert len(g) == len(params)
    for name, a, b in zip(params, g, jg):
        np.testing.assert_allclose(a[off], b[off], rtol=1e-10, atol=1e-12)
        df = sympy.diff(sympy.sympify(expr), name).subs(params)
        at_zero = float(df.subs('d', 0))
        limit = _diagonal_limit(df, X)
        for M in (a, b):
            np.testing.assert_allclose(np.diag(M), at_zero, rtol=0,
                                       atol=limit)
    np.testing.assert_allclose(k.theta, jk.theta, rtol=0, atol=0)


def test_rbf_kernel_cases_of_the_jax_tests():
    k = RBFKernel('exp(-0.5 * d**2 / s**2)', 'd', s=0.7, device='cpu')
    X = np.random.default_rng(0).normal(size=(10, 3))
    K = k(X)
    assert np.allclose(np.diag(K), 1)
    assert np.allclose(k.diag(X), 1)
    d2 = ((X[:, None] - X[None, :]) ** 2).sum(-1)
    assert np.allclose(K, np.exp(-0.5 * d2 / 0.49))
    assert len(k.gradient(X)) == 1
    t = k.theta
    k.theta = t  # round trip
    assert k.get_params()['s'] == pytest.approx(0.7)
    assert k.device == torch.device('cpu')


def test_kernel_over_metric_matches_jax():
    k = KernelOverMetric(_metric(), EXPR, 'd', v=1.0, s=1.0)
    jk = JaxKOM(_jax_metric(), EXPR, 'd', v=1.0, s=1.0)
    assert k.device == torch.device('cpu')
    K = k(GRAPHS)
    np.testing.assert_allclose(K, jk(JAX_GRAPHS), rtol=0, atol=1e-4)
    K2, dK = k(GRAPHS, eval_gradient=True)
    JK2, JdK = jk(JAX_GRAPHS, eval_gradient=True)
    np.testing.assert_allclose(K2, K, rtol=0, atol=0)
    assert dK.shape == JdK.shape == (6, 6, len(k.theta))
    np.testing.assert_allclose(dK, JdK, rtol=0,
                               atol=1e-3 * np.abs(JdK).max() + 1e-4)
    np.testing.assert_allclose(k.diag(GRAPHS), jk.diag(JAX_GRAPHS), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(k.theta, jk.theta, rtol=1e-6)
    np.testing.assert_allclose(k.bounds, jk.bounds, rtol=1e-6)


def test_kernel_over_metric_cases_of_the_jax_tests():
    k = KernelOverMetric(_metric(), EXPR, 'd', v=1.0, s=1.0)
    K = k(GRAPHS)
    assert K.shape == (len(GRAPHS), len(GRAPHS))
    assert np.allclose(np.diag(K), 1.0, atol=1e-5)
    K2, dK = k(GRAPHS, eval_gradient=True)
    assert np.allclose(K, K2)
    assert dK.shape[2] == len(k.theta)
    assert np.all(np.isfinite(dK))
    assert np.allclose(k.diag(GRAPHS), 1.0)
    clone = k.clone_with_theta()
    assert clone.device == k.device
    assert np.allclose(clone(GRAPHS), K, rtol=1e-5)


def test_kernel_over_metric_central_differences():
    """The chained gradient in every log hyperparameter (f's own and the
    metric's) against central differences, off the diagonal."""
    k = KernelOverMetric(_metric(), EXPR, 'd', v=1.3, s=0.8)
    G = GRAPHS[:4]
    _, dK = k(G, eval_gradient=True)
    theta0 = k.theta.copy()
    off = ~np.eye(len(G), dtype=bool)
    eps = 1e-3
    for i in range(len(theta0)):
        tp, tm = theta0.copy(), theta0.copy()
        tp[i] += eps
        tm[i] -= eps
        k.theta = tp
        Kp = k(G)
        k.theta = tm
        Km = k(G)
        k.theta = theta0
        fd = (Kp - Km) / (2 * eps) / np.exp(theta0[i])
        np.testing.assert_allclose(dK[:, :, i][off], fd[off], rtol=0.1,
                                   atol=0.05, err_msg=f'theta[{i}]')


@pytest.mark.parametrize('spec,want', [
    (0.5, (0.5, (0, np.inf))),
    ((0.5,), (0.5, (0, np.inf))),
    ((0.5, (0.1, 2.0)), (0.5, (0.1, 2.0))),
    ((0.5, 0.1, 2.0), (0.5, (0.1, 2.0))),
])
def test_parse_hyper_spec(spec, want):
    assert _parse_hyper_spec(spec) == want


def test_parse_hyper_spec_rejects_four_values():
    with pytest.raises(ValueError):
        _parse_hyper_spec((1, 2, 3, 4))


def test_kernel_over_metric_takes_the_device_given():
    class Fixed:
        """A distance without a device: a constant matrix."""
        theta = np.zeros(0)
        bounds = np.zeros((0, 2))
        hyperparameters = ()

        def __call__(self, X, Y=None, eval_gradient=False):
            return np.full((len(X), len(X)), 0.5)

    k = KernelOverMetric(Fixed(), EXPR, 'd', device='cpu', v=2.0, s=1.0)
    assert k.device == torch.device('cpu')
    np.testing.assert_allclose(k([0, 1]), 2.0 * np.exp(-0.125), rtol=1e-12)

"""The port's microkernels against the JAX package's.

Each case builds the same microkernel expression from both packages and
checks, on features drawn with numpy from a seed:

- ``apply`` on tensors against the JAX ``apply`` (rtol 1e-6: both
  evaluate the same float32 expression);
- theta, bounds and minmax, which must be equal;
- the host-side ``__call__`` value and jacobian, which must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
from graphdot_tpu import microkernel as jmk  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402


#: name -> (factory taking a microkernel module, feature kind)
CASES = {
    'KroneckerDelta': (lambda m: m.KroneckerDelta(0.3), 'category'),
    'KroneckerDelta_fixed': (
        lambda m: m.KroneckerDelta(0.4, h_bounds='fixed'), 'category'),
    'SquareExponential': (lambda m: m.SquareExponential(0.7), 'real'),
    'Constant': (lambda m: m.Constant(0.5, (0.1, 1.0)), 'real'),
    'Product': (lambda m: m.Product(), 'real'),
    'Add': (lambda m: m.SquareExponential(1.0) + 0.01, 'real'),
    'Multiply': (
        lambda m: m.KroneckerDelta(0.3) * m.SquareExponential(0.5),
        'category'),
    'Exponentiation': (lambda m: m.SquareExponential(0.5) ** 2, 'real'),
    'Normalize': (lambda m: (m.KroneckerDelta(0.3) + 0.1).normalized,
                  'category'),
    'TensorProduct': (lambda m: m.TensorProduct(
        element=m.KroneckerDelta(0.2), length=m.SquareExponential(0.3)),
        'dict'),
    'Additive': (lambda m: m.Additive(
        element=m.KroneckerDelta(0.3), length=m.SquareExponential(0.05)),
        'dict'),
    'Composite_normalized': (lambda m: m.Composite(
        '*', element=m.KroneckerDelta(0.3),
        length=m.SquareExponential(1.0) + 0.01).normalized, 'dict'),
}


def features(kind, seed):
    """(X [5, 1], Y [1, 7]) numpy features of one kind."""
    rng = np.random.default_rng(seed)

    def draw(kind, shape):
        if kind == 'category':
            return rng.integers(0, 3, shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)

    if kind == 'dict':
        return tuple(
            {'element': draw('category', shape),
             'length': draw('real', shape)}
            for shape in ((5, 1), (1, 7)))
    return draw(kind, (5, 1)), draw(kind, (1, 7))


def _tree(X, f):
    return {k: f(v) for k, v in X.items()} if isinstance(X, dict) else f(X)


@pytest.mark.parametrize('case', CASES)
def test_apply_matches_jax(case):
    build, kind = CASES[case]
    jk, tk = build(jmk), build(tmk)
    X, Y = features(kind, seed=len(case))
    theta = np.asarray(jk.flat_theta, dtype=np.float32)
    want = np.asarray(jk.apply(jnp.asarray(theta), _tree(X, jnp.asarray),
                               _tree(Y, jnp.asarray)))
    got = tk.apply(torch.from_numpy(theta), _tree(X, torch.from_numpy),
                   _tree(Y, torch.from_numpy))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize('case', CASES)
def test_hyperparameters_match_jax(case):
    build, _ = CASES[case]
    jk, tk = build(jmk), build(tmk)
    assert tk.name == jk.name
    assert tk.n_theta == jk.n_theta
    assert tk.theta == jk.theta
    assert tk.flat_theta == jk.flat_theta
    assert tk.bounds == jk.bounds
    assert tk.minmax == jk.minmax
    assert repr(tk) == repr(jk)
    # theta round trip through the setter
    tk.theta = jk.theta
    assert tk.theta == jk.theta


def _rows(X, Y):
    """Scalar feature pairs for the host-side __call__."""
    if isinstance(X, dict):
        return [({k: v.ravel()[a] for k, v in X.items()},
                 {k: v.ravel()[b] for k, v in Y.items()})
                for a in range(5) for b in range(7)]
    return [(x, y) for x in X.ravel() for y in Y.ravel()]


@pytest.mark.parametrize('case', CASES)
def test_host_call_matches_jax(case):
    build, kind = CASES[case]
    jk, tk = build(jmk), build(tmk)
    X, Y = features(kind, seed=len(case) + 1)
    for x, y in _rows(X, Y):
        assert tk(x, y) == jk(x, y)
        f_t, J_t = tk(x, y, jac=True)
        f_j, J_j = jk(x, y, jac=True)
        assert f_t == f_j
        np.testing.assert_array_equal(np.asarray(J_t), np.asarray(J_j))


def test_pow_requires_constant_exponent():
    with pytest.raises(ValueError):
        tmk.SquareExponential(0.5) ** tmk.KroneckerDelta(0.3)
    with pytest.raises(ValueError):
        jmk.SquareExponential(0.5) ** jmk.KroneckerDelta(0.3)

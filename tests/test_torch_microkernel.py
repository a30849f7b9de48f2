"""The port's microkernels against the JAX package's.

Each case builds the same microkernel expression from both packages and
checks, on features drawn with numpy from a seed:

- ``apply`` on tensors against the JAX ``apply`` (rtol 1e-6: both
  evaluate the same float32 expression);
- theta, bounds and minmax, which must be equal;
- the host-side ``__call__`` value and jacobian, which must be equal.

Variable-length features (``Convolution``) and vector features
(``DotProduct``) go to ``apply`` as the ``(values, mask)`` pairs the
batcher packs, and to ``__call__`` as tuples; ``RationalQuadratic``'s
jacobian is also held to central differences (rtol 1e-4), as
``tests/test_microkernel.py`` holds JAX's.
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
    'RationalQuadratic': (lambda m: m.RationalQuadratic(0.8, 2.0), 'real'),
    'RationalQuadratic_sum': (
        lambda m: m.RationalQuadratic(1.2, 0.5) + 0.1, 'real'),
    'Convolution': (lambda m: m.Convolution(m.KroneckerDelta(0.3)),
                    'sequence'),
    'Convolution_sum': (
        lambda m: m.Convolution(m.SquareExponential(1.0), mean=False),
        'sequence'),
    'Convolution_rq': (
        lambda m: m.Convolution(m.RationalQuadratic(0.9, 1.5)), 'sequence'),
    'DotProduct': (lambda m: m.DotProduct(), 'vector'),
    'DotProduct_normalized': (lambda m: m.DotProduct().normalized, 'vector'),
}


def features(kind, seed):
    """(X [5, 1], Y [1, 7]) numpy features of one kind; a sequence (of
    1-4 categories, padded to 4) or a vector (of 3 reals) as the
    ``(values, mask)`` pair the batcher packs it into."""
    rng = np.random.default_rng(seed)

    def draw(kind, shape):
        if kind == 'category':
            return rng.integers(0, 3, shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)

    if kind in ('sequence', 'vector'):
        def padded(shape):
            values = draw('category' if kind == 'sequence' else 'real',
                          shape + (4 if kind == 'sequence' else 3,))
            if kind == 'vector':
                return values, np.ones_like(values)
            lengths = rng.integers(1, 5, shape)
            mask = (np.arange(4) < lengths[..., None]).astype(np.float32)
            return values * mask, mask
        return padded((5, 1)), padded((1, 7))
    if kind == 'dict':
        return tuple(
            {'element': draw('category', shape),
             'length': draw('real', shape)}
            for shape in ((5, 1), (1, 7)))
    return draw(kind, (5, 1)), draw(kind, (1, 7))


def _tree(X, f):
    if isinstance(X, dict):
        return {k: f(v) for k, v in X.items()}
    if isinstance(X, tuple):
        return tuple(f(v) for v in X)
    return f(X)


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
    """Scalar (or sequence) feature pairs for the host-side __call__."""
    if isinstance(X, tuple):
        def seqs(F):
            values, mask = (a.reshape(-1, a.shape[-1]) for a in F)
            return [tuple(v[m > 0].tolist()) for v, m in zip(values, mask)]
        return [(x, y) for x in seqs(X) for y in seqs(Y)]
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


@pytest.mark.parametrize('case', ['RationalQuadratic', 'Convolution_rq'])
def test_jacobian_central_differences(case):
    """The host jacobian against central differences in the linear-scale
    hyperparameters (step 1e-6), as ``tests/test_microkernel.py``."""
    from graphdot_tpu_torch.util.iterable import fold_like
    build, kind = CASES[case]
    k = build(tmk)
    x, y = (0.5, 1.2) if kind == 'real' else ((1.0, 2.0), (2.0, 3.0, 1.0))
    _, jac = k(x, y, jac=True)
    t0 = np.array(k.flat_theta, dtype=float)
    fd = []
    for i in range(len(t0)):
        vals = []
        for step in (1e-6, -1e-6):
            t = t0.copy()
            t[i] += step
            k.theta = fold_like(t, k.theta)
            vals.append(k(x, y))
        k.theta = fold_like(t0, k.theta)
        fd.append((vals[0] - vals[1]) / 2e-6)
    np.testing.assert_allclose(jac, fd, rtol=1e-4, atol=1e-6)

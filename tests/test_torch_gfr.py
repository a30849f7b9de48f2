"""The port's Gaussian field regressor and weights
(``graphdot_tpu_torch.model.gaussian_field``) against the JAX package's:
the seven tests of ``tests/test_gfr.py`` (with their parameters), each
also against the JAX model on the same seeded inputs, on the CPU
(``device='cpu'``).

Limits: on float64 weights both packages agree within 1e-10 relative
(values, gradients, predictions, influence); central differences as
``tests/test_gfr.py`` (rtol 1e-3). Over ``RBFOverDistance(MaxiMin)`` the
distances are float32 and the two metrics agree within the D limit of
``tests/test_torch_metric.py``, so the losses agree within 1e-4 relative
and their gradients within 1e-3 max |grad| + 1e-4, predictions within
1e-4 of the label scale.
"""
import numpy as np
import pytest
from scipy.spatial.distance import cdist

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.metric import MaxiMin as JaxMaxiMin  # noqa: E402
from graphdot_tpu.model import gaussian_field as jgf  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.metric import MaxiMin  # noqa: E402
from graphdot_tpu_torch.model import gaussian_field as gf  # noqa: E402
from graphdot_tpu_torch.model.gaussian_field import (  # noqa: E402
    GaussianFieldRegressor, RBFOverDistance, RBFOverFixedDistance, Weight)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread (test processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class OneOverRn:
    """w = 1 / (r + a)^b with log-scale gradients."""

    def __init__(self, a=0.1, b=1):
        self.a = a
        self.b = b

    def __call__(self, X, Y=None, eval_gradient=False):
        d = self.a + (cdist(X, X) if Y is None else cdist(X, Y))
        w = d ** -self.b
        if eval_gradient:
            j1 = -self.b * d ** (-self.b - 1)
            j2 = -d ** (-self.b) * np.log(d)
            return w, np.stack([j1, j2], axis=2) * np.exp(
                self.theta
            )[None, None, :]
        return w

    @property
    def theta(self):
        return np.log([self.a, self.b])

    @theta.setter
    def theta(self, values):
        self.a, self.b = np.exp(values)

    @property
    def bounds(self):
        return np.log([[0.001, 100.0], [0.001, 100.0]])


def both(weight, **kwargs):
    """The port's model (on the CPU) and the JAX package's."""
    return (GaussianFieldRegressor(weight, device='cpu', **kwargs),
            jgf.GaussianFieldRegressor(weight, **kwargs))


def close(got, want, rtol=1e-10):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(
        float(np.abs(want).max()), 1e-300))


def test_precomputed_harmonic():
    W = np.array([
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 1.0],
        [0.0, 1.0, 0.0],
    ])
    y = np.array([0.0, np.nan, 1.0])
    g, jg = both('precomputed', smoothing=0)
    z = g.predict(W, y)
    assert z[1] == pytest.approx(0.5)
    close(z, jg.predict(W, y))
    (z, infl), (jz, jinfl) = (m.predict(W, y, return_influence=True)
                              for m in (g, jg))
    close(z, jz)
    close(infl, jinfl)
    with pytest.raises(RuntimeError, match='All samples are labeled'):
        g.predict(W, np.zeros(3))


def test_average_label_entropy_value():
    X = np.array([
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 1.0],
        [0.0, 1.0, 0.0],
    ])
    y = np.array([0, np.nan, 1])
    g, jg = both('precomputed', smoothing=0)
    e = g.average_label_entropy(X=X, y=y)
    assert e == pytest.approx(-np.log(0.5))
    assert e == pytest.approx(jg.average_label_entropy(X=X, y=y),
                              rel=1e-12)


def test_loocv_error_values():
    g, jg = both('precomputed', smoothing=0)
    X = np.array([
        [0.0, 1.0, 1.0],
        [1.0, 0.0, 1.0],
        [1.0, 1.0, 0.0],
    ])
    y = np.array([-1.0, 0.0, 1.0])
    assert g.loocv_error(X, y, p=1) == pytest.approx(1.0)
    assert g.loocv_error(X, y, p=2) == pytest.approx(np.sqrt(1.5))
    assert g.loocv_error(X, np.zeros(3)) == pytest.approx(0)
    for p in (1, 1.5, 2):
        assert g.loocv_error(X, y, p=p) == pytest.approx(
            jg.loocv_error(X, y, p=p), rel=1e-12)


def _inputs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = rng.random(n)
    y[rng.choice(n, max(1, n // k), replace=False)] = np.nan
    return X, y


@pytest.mark.parametrize('smoothing', [0, 0.1])
@pytest.mark.parametrize('n,k,d', [(7, 3, 2), (16, 5, 4)])
def test_average_label_entropy_gradient(n, k, d, smoothing):
    gfr, jgfr = both(OneOverRn(a=1.5, b=0.7), smoothing=smoothing)
    X, y = _inputs(n, n, k, d)
    loss, dloss = gfr.average_label_entropy(X, y, eval_gradient=True)
    jloss, jdloss = jgfr.average_label_entropy(X, y, eval_gradient=True)
    assert loss == pytest.approx(jloss, rel=1e-10)
    close(dloss, jdloss)

    eps = 1e-4
    theta = np.copy(gfr.weight.theta)
    for i in range(len(theta)):
        pos, neg = theta.copy(), theta.copy()
        pos[i] += eps
        neg[i] -= eps
        f_pos = gfr.average_label_entropy(X, y, theta=pos)
        f_neg = gfr.average_label_entropy(X, y, theta=neg)
        gfr.weight.theta = theta
        delta = (f_pos - f_neg) / (2 * eps)
        assert delta == pytest.approx(dloss[i], rel=1e-3, abs=1e-8)


@pytest.mark.parametrize('p', [1, 1.5, 2])
@pytest.mark.parametrize('smoothing', [0, 0.1])
def test_loocv_error_gradient(p, smoothing):
    n, k, d = 12, 4, 3
    gfr, jgfr = both(OneOverRn(a=1.2, b=0.9), smoothing=smoothing)
    X, y = _inputs(int(10 * p), n, k, d)
    loss, dloss = gfr.loocv_error(X, y, p=p, eval_gradient=True)
    jloss, jdloss = jgfr.loocv_error(X, y, p=p, eval_gradient=True)
    assert loss == pytest.approx(jloss, rel=1e-10)
    close(dloss, jdloss)

    eps = 1e-4
    theta = np.copy(gfr.weight.theta)
    for i in range(len(theta)):
        pos, neg = theta.copy(), theta.copy()
        pos[i] += eps
        neg[i] -= eps
        f_pos = gfr.loocv_error(X, y, p=p, theta=pos)
        f_neg = gfr.loocv_error(X, y, p=p, theta=neg)
        gfr.weight.theta = theta
        delta = (f_pos - f_neg) / (2 * eps)
        assert delta == pytest.approx(dloss[i], rel=1e-3, abs=1e-8)


@pytest.mark.parametrize('loss', ['loocv2', 'loocv1', 'ale'])
def test_fit_and_fit_predict_match_jax(loss):
    """L-BFGS-B over the same objective from the same start: the same
    fitted theta (1e-6) and predictions (1e-8 of the label scale)."""
    X, y = _inputs(5, 14, 3, 2)
    if loss == 'ale':
        y = np.where(np.isfinite(y), np.round(y), np.nan)
    fitted = []
    for model in both(OneOverRn(a=1.2, b=0.9), optimizer=True):
        model.weight = OneOverRn(a=1.2, b=0.9)
        z, influence = model.fit_predict(X, y, loss=loss,
                                         return_influence=True)
        fitted.append((model.weight.theta, z, influence))
    (theta, z, infl), (jtheta, jz, jinfl) = fitted
    np.testing.assert_allclose(theta, jtheta, rtol=1e-6, atol=1e-8)
    close(z, jz, 1e-8)
    close(infl, jinfl, 1e-8)
    with pytest.raises(RuntimeError, match='Unknown loss'):
        GaussianFieldRegressor(OneOverRn(), optimizer=True,
                               device='cpu').fit(X, y, loss='mse')


def test_singular_laplacian_falls_back():
    """An isolated unlabeled node makes the Laplacian singular: both
    packages warn and take the least-squares solution."""
    W = np.array([
        [0.0, 1.0, 0.0, 0.0],
        [1.0, 0.0, 1.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0],
    ])
    y = np.array([0.0, np.nan, 1.0, np.nan])
    got = []
    for model in both('precomputed', smoothing=0):
        with pytest.warns(UserWarning, match='singular'):
            got.append(model.predict(W, y))
    close(got[0], got[1])


def test_rbf_over_fixed_distance_gradient():
    rng = np.random.default_rng(8)
    n = 8
    D = np.abs(rng.standard_normal((n, n)))
    D = 0.5 * (D + D.T)
    np.fill_diagonal(D, 0)
    w = RBFOverFixedDistance(D, sigma=1.3)
    jw = jgf.RBFOverFixedDistance(D, sigma=1.3)
    idx = np.arange(n)
    W, dW = w(idx, eval_gradient=True)
    JW, JdW = jw(idx, eval_gradient=True)
    np.testing.assert_array_equal(W, JW)
    np.testing.assert_array_equal(dW, JdW)
    np.testing.assert_array_equal(w(idx[:3], idx[3:]), jw(idx[:3], idx[3:]))
    eps = 1e-5
    t0 = w.theta
    w.theta = t0 + eps
    Wp = w(idx)
    w.theta = t0 - eps
    Wm = w(idx)
    w.theta = t0
    fd = (Wp - Wm) / (2 * eps)
    assert np.allclose(dW[:, :, 0], fd, rtol=1e-4, atol=1e-8)
    assert isinstance(w, Weight)
    np.testing.assert_array_equal(w.bounds, jw.bounds)
    np.testing.assert_allclose(w.clone_with_theta(t0 + 1).theta, t0 + 1)


def _metrics():
    kw = dict(q=0.05)
    return (MaxiMin(tmk.TensorProduct(element=tmk.KroneckerDelta(0.3)),
                    tmk.TensorProduct(length=tmk.SquareExponential(0.3)),
                    device='cpu', **kw),
            JaxMaxiMin(jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
                       jmk.TensorProduct(length=jmk.SquareExponential(0.3)),
                       backend='edge', **kw))


def test_gfr_with_maximin_weights():
    """Integration: the field over RBFOverDistance(MaxiMin) weights on
    molecules (``tests/test_gfr.py``), against the JAX model over JAX's
    MaxiMin."""
    graphs = port_testing.random_molecule_set(2, 8, n_atoms_range=(5, 8))
    jgraphs = jax_testing.random_molecule_set(2, 8, n_atoms_range=(5, 8))
    metric, jmetric = _metrics()
    gfr = GaussianFieldRegressor(RBFOverDistance(metric, sigma=0.5),
                                 smoothing=1e-3, device='cpu')
    jgfr = jgf.GaussianFieldRegressor(jgf.RBFOverDistance(jmetric,
                                                          sigma=0.5),
                                      smoothing=1e-3)
    y = np.array([float(len(g.nodes)) for g in graphs])
    y_obs = y.copy()
    y_obs[[2, 5]] = np.nan
    z = gfr.predict(np.asarray(graphs, dtype=object), y_obs)
    assert np.all(np.isfinite(z))
    # harmonic interpolation stays within the labeled range
    assert z[[2, 5]].min() >= y[np.isfinite(y_obs)].min() - 1e-6
    assert z[[2, 5]].max() <= y[np.isfinite(y_obs)].max() + 1e-6
    jz = jgfr.predict(np.asarray(jgraphs, dtype=object), y_obs)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-4 * np.abs(y).max())

    X, JX = (np.asarray(g, dtype=object) for g in (graphs, jgraphs))
    for loss in ('loocv_error_2', 'loocv_error_1'):
        value, grad = getattr(gfr, loss)(X, y_obs, eval_gradient=True)
        jvalue, jgrad = getattr(jgfr, loss)(JX, y_obs, eval_gradient=True)
        assert value == pytest.approx(jvalue, rel=1e-4)
        assert grad.shape == jgrad.shape == (1 + len(metric.theta),)
        np.testing.assert_allclose(
            grad, jgrad, rtol=0, atol=1e-3 * np.abs(jgrad).max() + 1e-4)


def test_rbf_over_distance_matches_jax():
    """W and dW (log sigma, then the metric's log theta) over MaxiMin,
    symmetric and rectangular, against JAX: W within 1e-4 (the D limit
    through a Gaussian of width 0.5 is ~4e-4 d, here < 1e-4 as D > 0.01
    off the diagonal), dW within 1e-3 max |dW| + 1e-4."""
    graphs = port_testing.random_molecule_set(4, 6, n_atoms_range=(5, 9))
    jgraphs = jax_testing.random_molecule_set(4, 6, n_atoms_range=(5, 9))
    metric, jmetric = _metrics()
    w = RBFOverDistance(metric, sigma=0.5)
    jw = jgf.RBFOverDistance(jmetric, sigma=0.5)
    np.testing.assert_allclose(w.theta, jw.theta, rtol=1e-6)
    np.testing.assert_allclose(w.bounds, jw.bounds, rtol=1e-6)
    for args, jargs in (((graphs,), (jgraphs,)),
                        ((graphs[:2], graphs[2:]), (jgraphs[:2],
                                                    jgraphs[2:]))):
        W, dW = w(*args, eval_gradient=True)
        JW, JdW = jw(*jargs, eval_gradient=True)
        np.testing.assert_allclose(W, JW, rtol=0, atol=1e-4)
        np.testing.assert_allclose(w(*args), W, rtol=0, atol=1e-6)
        np.testing.assert_allclose(dW, JdW, rtol=0,
                                   atol=1e-3 * np.abs(JdW).max() + 1e-4)
    twin = w.clone_with_theta(w.theta + 0.1)
    np.testing.assert_allclose(twin.theta, w.theta + 0.1)
    assert twin.metric is not w.metric


def test_gfr_defaults_to_the_card(monkeypatch):
    """Without a card the default device raises at the first solve."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    g = GaussianFieldRegressor('precomputed')
    assert g.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        g.predict(np.ones((3, 3)), np.array([0.0, np.nan, 1.0]))
    assert gf.__all__ == jgf.__all__

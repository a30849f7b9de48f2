"""The port's Gaussian-process regressor against the JAX package's.

- The closed-form RBF cases of ``tests/test_models.py`` (interpolation,
  masked targets, LML and LOOCV gradients by finite differences, an
  optimizer fit, LOOCV against refits, save and load), on ``device='cpu'``.
- The objectives (:mod:`graphdot_tpu_torch.model.gaussian_process.
  _objectives`) against the JAX module's on the same float64 matrices:
  values and K-gradients within 1e-9 relative; ``linalg/_exec.py``'s
  decompositions against the JAX module's within 1e-12.
- The graph GPR (``Normalization(MarginalizedGraphKernel)``, alpha 1e-2,
  ``normalize_y``) against JAX ``GaussianProcessRegressor`` on 16 molecules
  of ``bench.py``'s set with ``bench_nuts.py``'s targets, predicting 8 held
  out, at theta0 and one other theta: LML within 1e-4 relative, its
  gradient within 1e-3 * max |grad| + 1e-3, means within 1e-4 relative and
  stds within 1e-4 absolute (float32 Grams on both sides).
- The factory engine of ``fit``: against the per-pair route, what it
  declines, and saving a model fitted through it.

Run as a script to rewrite ``fixtures/torch_port_gpr_ref.npz``, the JAX
values that ``chip_smoke.py`` holds the card's regressor against.
"""
import warnings
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK, Normalization as JaxNormalization)
from graphdot_tpu.model.gaussian_process import (  # noqa: E402
    GaussianProcessRegressor as JaxGPR)
from graphdot_tpu.model.gaussian_process import (  # noqa: E402
    _objectives as jax_obj)

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.model.gaussian_process import (  # noqa: E402
    GaussianProcessRegressor)
from graphdot_tpu_torch.model.gaussian_process import (  # noqa: E402
    _objectives as obj)

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_gpr_ref.npz'
#: bench.py's training set and the held-out set of the card's GP phase,
#: (seed, count, atoms), and how much of each the fixture covers
TRAIN, HELD_OUT = (42, 128, (9, 24)), (7, 32, (9, 24))
N_TRAIN, N_PREDICT = 16, 8
#: the second theta (log scale), a step from the kernel's theta0
THETA_STEP = np.array([0.2, 0.3, -0.3, 0.2])
ALPHA = 1e-2


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread. The test processes run side by side, and
    torch's default of a thread a core then makes every small op wait on
    descheduled threads (tens of times slower than one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def targets(graphs):
    """bench_nuts.py's targets: -10 |nodes| + N(0, 1) from default_rng(0)."""
    rng = np.random.default_rng(0)
    return np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])


# ---------------------------------------------------------------------------
# closed-form kernel cases (tests/test_models.py)
# ---------------------------------------------------------------------------


class RBFKernel:
    """Closed-form RBF over scalars with analytic log-scale gradient."""

    def __init__(self, s=1.0):
        self.s = s

    def __call__(self, X, Y=None, eval_gradient=False):
        X = np.asarray(X, dtype=float)
        Y = np.asarray(Y, dtype=float) if Y is not None else X
        d2 = (X[:, None] - Y[None, :]) ** 2
        K = np.exp(-0.5 * d2 / self.s ** 2)
        if eval_gradient:
            J = (K * d2 / self.s ** 3)[:, :, None]
            return K, J
        return K

    def diag(self, X, eval_gradient=False):
        if eval_gradient:
            return np.ones(len(X)), np.zeros((len(X), 1))
        return np.ones(len(X))

    @property
    def theta(self):
        return np.log([self.s])

    @theta.setter
    def theta(self, t):
        self.s = np.exp(t[0])

    @property
    def bounds(self):
        return np.log([[1e-2, 10.0]])

    def clone_with_theta(self, theta):
        k = RBFKernel()
        k.theta = theta
        return k


def gpr(s, **kwargs):
    return GaussianProcessRegressor(kernel=RBFKernel(s), device='cpu',
                                    **kwargs)


def test_gpr_interpolation():
    X = np.linspace(0, 1, 8)
    y = np.sin(2 * np.pi * X)
    model = gpr(0.3, alpha=1e-10).fit(X, y)
    assert np.allclose(model.predict(X), y, atol=1e-5)
    _, std = model.predict(np.linspace(0, 1, 20), return_std=True)
    assert np.all(std >= 0)
    mean, cov = model.predict(np.linspace(0, 1, 5), return_cov=True)
    assert cov.shape == (5, 5) and np.allclose(cov, cov.T)


def test_gpr_masked_targets():
    X = np.linspace(0, 1, 10)
    y = np.sin(2 * np.pi * X)
    y_masked = y.copy().astype(object)
    y_masked[3] = None
    y_masked[7] = np.nan
    model = gpr(0.3, alpha=1e-10).fit(X, y_masked)
    assert np.allclose(model.predict(X)[[3, 7]], y[[3, 7]], atol=1e-2)


def test_gpr_lml_gradient():
    rng = np.random.default_rng(0)
    X = rng.random(12)
    model = gpr(0.8, alpha=1e-8)
    model.X, model.y = X, np.sin(4 * X)
    _, grad = model.log_marginal_likelihood(eval_gradient=True)
    eps = 1e-5
    t0 = model.kernel.theta
    fd = (model.log_marginal_likelihood(t0 + eps)
          - model.log_marginal_likelihood(t0 - eps)) / (2 * eps)
    assert grad[0] == pytest.approx(fd, rel=1e-4, abs=1e-6)


def test_gpr_fit_optimizer():
    X = np.linspace(0, 1, 16)
    model = gpr(0.5, alpha=1e-8, optimizer=True)
    model.fit(X, np.sin(2 * np.pi * X), tol=1e-6)
    assert model._engine is None          # not a graph kernel
    assert model.squared_loocv_error() < 1e-2


def test_gpr_loocv_consistency():
    rng = np.random.default_rng(1)
    X = rng.random(10)
    y = np.sin(4 * X)
    model = gpr(0.8, alpha=1e-8).fit(X, y)
    zstar, std = model.predict_loocv(X, y, return_std=True)
    assert np.all(std > 0)
    for i in range(len(X)):
        keep = np.arange(len(X)) != i
        zi = gpr(0.8, alpha=1e-8).fit(X[keep], y[keep]).predict(X[[i]])
        assert zi[0] == pytest.approx(zstar[i], rel=1e-4, abs=1e-6)


def test_gpr_loocv_error_gradient():
    rng = np.random.default_rng(2)
    X = rng.random(10)
    model = gpr(0.7, alpha=1e-8)
    model.X, model.y = X, np.sin(4 * X)
    _, de = model.squared_loocv_error(eval_gradient=True)
    eps = 1e-5
    t0 = model.kernel.theta
    fd = (model.squared_loocv_error(t0 + eps)
          - model.squared_loocv_error(t0 - eps)) / (2 * eps)
    assert de[0] == pytest.approx(fd, rel=1e-3, abs=1e-8)


def test_gpr_save_load(tmp_path):
    X = np.linspace(0, 1, 8)
    model = gpr(0.3, alpha=1e-10).fit(X, np.sin(2 * np.pi * X))
    z0 = model.predict(X)
    model.save(tmp_path, 'model.pkl')
    with pytest.raises(RuntimeError, match='overwrite'):
        model.save(tmp_path, 'model.pkl')
    twin = gpr(1.0, alpha=1e-10)
    twin.load(tmp_path, 'model.pkl')
    assert np.allclose(twin.predict(X), z0)


# ---------------------------------------------------------------------------
# the objectives against the JAX module's
# ---------------------------------------------------------------------------


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T / n + 0.1 * np.eye(n), rng.normal(size=n)


@pytest.mark.parametrize('name', ['negative_log_marginal', 'loocv_error'])
def test_objectives_match_jax(name):
    K, y = _spd(7, 3)
    v, (gK,) = getattr(obj, name)(K, y, 1e-8, with_grad=True, device='cpu')
    v_jax, (gK_jax,) = getattr(jax_obj, name)(K, y, 1e-8, with_grad=True)
    np.testing.assert_allclose(v, v_jax, rtol=1e-9)
    np.testing.assert_allclose(gK, gK_jax, rtol=1e-9, atol=1e-12)
    assert getattr(obj, name)(K, y, 1e-8, device='cpu') == pytest.approx(
        float(v_jax), rel=1e-9)


def test_nystrom_chain_and_inverse_match_jax():
    K, y = _spd(6, 4)
    Kxc = K[:, :3] + 0.01
    Kcc = K[:3, :3]
    got = obj.nystrom_negative_log_marginal(Kxc, Kcc, y, 1e-8, True,
                                            device='cpu')
    want = jax_obj.nystrom_negative_log_marginal(Kxc, Kcc, y, 1e-8, True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-10)
    dK = np.random.default_rng(5).normal(size=(6, 6, 3))
    theta = np.array([0.1, -0.2, 0.3])
    np.testing.assert_allclose(
        obj.chain_to_theta(K, dK, theta, device='cpu'),
        jax_obj.chain_to_theta(K, dK, theta), rtol=1e-12)
    K_inv, logdet, method = obj.inverse(K, 1e-8, device='cpu')
    np.testing.assert_allclose(K_inv @ K, np.eye(6), atol=1e-10)
    assert method == 'cholesky'
    assert logdet == pytest.approx(np.linalg.slogdet(K)[1], rel=1e-12)


@pytest.mark.parametrize('name', ['eigh', 'cholesky', 'cho_apply', 'svd'])
def test_linalg_exec_matches_jax(name):
    """``linalg._exec``'s decompositions against the JAX module's, float64
    in and out (eigenvectors and singular vectors up to sign: through the
    matrices they rebuild)."""
    from graphdot_tpu.linalg import _exec as jax_exec
    from graphdot_tpu_torch.linalg import _exec
    K, y = _spd(6, 8)
    args = {'eigh': (K,), 'cholesky': (K,), 'svd': (K[:, :4],),
            'cho_apply': (np.linalg.cholesky(K), np.stack([y, 2 * y], 1))}
    got = getattr(_exec, name)(*args[name], device='cpu')
    want = getattr(jax_exec, name)(*args[name])
    for g in (got if isinstance(got, tuple) else (got,)):
        assert g.dtype == np.float64
    if name == 'eigh':
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        np.testing.assert_allclose((got[1] * got[0]) @ got[1].T, K,
                                   atol=1e-12)
    elif name == 'svd':
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
        np.testing.assert_allclose((got[0] * got[1]) @ got[2], K[:, :4],
                                   atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    if name == 'cholesky':
        K[0, 0] = -1.0   # not positive definite: NaN-filled alike
        L = _exec.cholesky(K, device='cpu')
        assert np.isnan(L[np.tril_indices(len(K))]).all()
        np.testing.assert_array_equal(L, jax_exec.cholesky(K))
    if name == 'cho_apply':   # one right-hand side
        np.testing.assert_allclose(
            _exec.cho_apply(args[name][0], y, device='cpu'),
            np.linalg.solve(K, y), rtol=1e-10)


def test_indefinite_gram_falls_back_and_nan_raises():
    K, y = _spd(5, 6)
    K[0, 0] = -1.0
    with pytest.warns(UserWarning, match='positive-clamped'):
        v, (gK,) = obj.negative_log_marginal(K, y, 1e-8, True, device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        v_jax, (gK_jax,) = jax_obj.negative_log_marginal(K, y, 1e-8, True)
    np.testing.assert_allclose(v, v_jax, rtol=1e-9)
    np.testing.assert_allclose(gK, gK_jax, rtol=1e-6, atol=1e-9)
    assert obj.inverse(K, 1e-8, device='cpu')[2] == 'eigh'
    K[1, 2] = np.nan
    with pytest.raises(np.linalg.LinAlgError):
        obj.loocv_error(K, y, 1e-8, device='cpu')


# ---------------------------------------------------------------------------
# the graph regressor against the JAX package's
# ---------------------------------------------------------------------------


def slice_sets(m):
    """(training graphs, their targets, held-out graphs) from testing
    module ``m``."""
    train = m.random_molecule_set(*TRAIN)
    return (train[:N_TRAIN], targets(train)[:N_TRAIN],
            m.random_molecule_set(*HELD_OUT)[:N_PREDICT])


def slice_kernel(m, cls, norm, **kwargs):
    return norm(cls(m.TensorProduct(element=m.KroneckerDelta(0.2)),
                    m.TensorProduct(length=m.SquareExponential(0.3)),
                    q=0.05, **kwargs))


def gp_values(model, graphs, y, held_out, theta):
    """(LML, gradient, mean, std) of a fitted regressor at ``theta``."""
    model.kernel.theta = theta
    model.fit(graphs, y)
    lml, grad = model.log_marginal_likelihood(eval_gradient=True)
    mean, std = model.predict(held_out, return_std=True)
    return lml, grad, mean, std


@lru_cache(maxsize=None)
def jax_reference():
    """The JAX regressor's values at theta0 and theta0 + THETA_STEP: a dict
    of arrays with a leading axis of 2."""
    G, y, Z = slice_sets(jax_testing)
    model = JaxGPR(slice_kernel(jmk, JaxMGK, JaxNormalization,
                                backend='edge'),
                   alpha=ALPHA, normalize_y=True)
    theta0 = model.kernel.theta.copy()
    thetas = np.stack([theta0, theta0 + THETA_STEP])
    values = [gp_values(model, G, y, Z, t) for t in thetas]
    out = {k: np.array([v[i] for v in values])
           for i, k in enumerate(('lml', 'grad', 'mean', 'std'))}
    out.update(theta=thetas, y=y)
    return out


def assert_gp_close(got, want):
    """The tolerances of this file's docstring."""
    np.testing.assert_allclose(got['lml'], want['lml'], rtol=1e-4)
    scale = np.abs(want['grad']).max()
    np.testing.assert_allclose(got['grad'], want['grad'], rtol=0,
                               atol=1e-3 * scale + 1e-3)
    np.testing.assert_allclose(got['mean'], want['mean'], rtol=1e-4)
    np.testing.assert_allclose(got['std'], want['std'], rtol=0, atol=1e-4)


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_graph_gpr_matches_jax(backend):
    ref = jax_reference()
    G, y, Z = slice_sets(port_testing)
    np.testing.assert_array_equal(y, ref['y'])
    model = GaussianProcessRegressor(
        slice_kernel(tmk, MarginalizedGraphKernel, Normalization,
                     backend=backend, device='cpu'),
        alpha=ALPHA, normalize_y=True, device='cpu')
    np.testing.assert_allclose(model.kernel.theta, ref['theta'][0])
    values = [gp_values(model, G, y, Z, t) for t in ref['theta']]
    got = {k: np.array([v[i] for v in values])
           for i, k in enumerate(('lml', 'grad', 'mean', 'std'))}
    assert_gp_close(got, ref)
    assert np.all(np.isfinite(got['mean'])) and np.all(got['std'] >= 0)


def test_reference_fixture_is_current():
    ref = np.load(FIXTURE)
    want = jax_reference()
    np.testing.assert_array_equal(ref['theta'], want['theta'])
    np.testing.assert_array_equal(ref['y'], want['y'])
    for key in ('lml', 'grad', 'mean', 'std'):
        np.testing.assert_allclose(ref[key], want[key], rtol=1e-6,
                                   atol=1e-6, err_msg=key)


def _small_graph_model(**kwargs):
    G = port_testing.random_molecule_set(9, 16, (4, 9))
    y = targets(G)
    model = GaussianProcessRegressor(
        slice_kernel(tmk, MarginalizedGraphKernel, Normalization,
                     device='cpu'),
        alpha=ALPHA, normalize_y=True, device='cpu', **kwargs)
    return model, G, y


def test_engine_matches_per_pair_route():
    """The factory engine's LML and gradient are the per-pair route's."""
    model, G, y = _small_graph_model()
    model.X, model.y = G, y
    t = model.kernel.theta + 0.1
    want = model.log_marginal_likelihood(t, eval_gradient=True)
    model._engine = model._make_factory_engine(model.kernel, model._X)
    assert model._engine is not None
    got = model.log_marginal_likelihood(t, eval_gradient=True)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    assert model.log_marginal_likelihood(t) == pytest.approx(want[0],
                                                             rel=1e-6)


def test_engine_declines_only_on_shape_conditions(monkeypatch):
    model, G, _ = _small_graph_model()
    X = np.asarray(G)
    assert model._make_factory_engine(model.kernel, X) is not None
    assert model._make_factory_engine(model.kernel.kernel, X) is not None
    assert model._make_factory_engine(RBFKernel(), X) is None
    assert model._make_factory_engine(model.kernel, np.arange(3.0)) is None
    monkeypatch.setenv('GRAPHDOT_GPR_ENGINE', '0')
    assert model._make_factory_engine(model.kernel, X) is None
    monkeypatch.delenv('GRAPHDOT_GPR_ENGINE')
    opts, _, _ = _small_graph_model(kernel_options={'lmin': 1})
    assert opts._make_factory_engine(opts.kernel, X) is None


def test_fit_through_the_engine_saves_and_loads(tmp_path):
    """A model fitted with an optimizer on 16 graphs (the engine's route)
    saves without its engine and predicts the same after loading."""
    model, G, y = _small_graph_model(optimizer=True)
    theta0 = model.kernel.theta.copy()
    model.fit(G, y, tol=1e-3)
    assert model._engine is not None
    assert model.log_marginal_likelihood() <= \
        model.log_marginal_likelihood(theta0)
    mean, std = model.predict(G[:4], return_std=True)
    model.save(tmp_path)
    twin, _, _ = _small_graph_model()
    twin.load(tmp_path)
    assert not hasattr(twin, '_engine')
    np.testing.assert_allclose(twin.kernel.theta, model.kernel.theta)
    got_mean, got_std = twin.predict(G[:4], return_std=True)
    np.testing.assert_allclose(got_mean, mean, rtol=1e-12)
    np.testing.assert_allclose(got_std, std, rtol=1e-12)


if __name__ == '__main__':
    import jax
    jax.config.update('jax_platforms', 'cpu')
    ref = jax_reference()
    np.savez(FIXTURE, **ref, train=np.hstack(TRAIN),
             held_out=np.hstack(HELD_OUT), n_train=N_TRAIN,
             n_predict=N_PREDICT, alpha=ALPHA)
    print(f'wrote {FIXTURE}: ' + ', '.join(
        f'{k} {np.shape(v)}' for k, v in ref.items()))

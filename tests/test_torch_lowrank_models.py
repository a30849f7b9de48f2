"""The port's Nystrom GPR (``LowRankApproximateGPR``) and outlier detector
(``GPROutlierDetector``) against the JAX package's.

- The closed-form RBF cases of ``tests/test_models.py`` (the Nystrom model
  at full rank against the exact GPR, the Nystrom LML gradient against
  finite differences, the outlier found), each also against the JAX model
  on the same inputs: float64 on both sides, LML and gradients within
  1e-9 relative, predictions within 1e-8 relative to their scale; the
  outlier fit's learned noise and means within 1e-3 relative (two
  L-BFGS-B runs whose gradients differ in the last digits), its stds,
  square roots of residuals near 0, within 1e-3 absolute.
- The graph case (``Normalization(MarginalizedGraphKernel)``, alpha 1e-5,
  ``normalize_y``): 24 molecules of 6-12 atoms, the core of 8 picked from
  the first 20 by ``HierarchicalDrafter(VarianceMinimizer(kernel))``, 4
  held out. Against ``tests/fixtures/torch_port_models_ref.npz`` (JAX,
  ``backend='edge'``): the core indices equal, LML within 1e-4 relative,
  its gradient within 1e-3 max |grad| + 1e-3, means within 1e-4 relative,
  stds within 1e-4 (float32 Grams on both sides). The fixture test
  regenerates those values from JAX and holds them by the same limits.
- The cross Gram Kxc of every objective evaluation comes from one factory
  cached over X and C, built once.

Run as a script to rewrite ``fixtures/torch_port_models_ref.npz``: the
graph case above and the dense oracle's Gram of the variable-length
('vario') graphs of ``tests/test_mlgk.py``, which ``chip_smoke.py`` holds
the card against.
"""
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    MarginalizedGraphKernel as JaxMGK, Normalization as JaxNormalization)
from graphdot_tpu.model.active_learning import (  # noqa: E402
    HierarchicalDrafter as JaxDrafter, VarianceMinimizer as JaxVM)
from graphdot_tpu.model.gaussian_process import (  # noqa: E402
    GaussianProcessRegressor as JaxGPR, GPROutlierDetector as JaxOD,
    LowRankApproximateGPR as JaxNystrom)

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.inference import gram as gram_module  # noqa: E402
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)
from graphdot_tpu_torch.model.active_learning import (  # noqa: E402
    HierarchicalDrafter, VarianceMinimizer)
from graphdot_tpu_torch.model.gaussian_process import (  # noqa: E402
    GaussianProcessRegressor, GPROutlierDetector, LowRankApproximateGPR)

from test_models import RBFKernel  # noqa: E402

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_models_ref.npz'
#: the graph case: random_molecule_set(seed, count, atoms), the training
#: part, the core drawn from it, alpha
GRAPH_SET, N_TRAIN, N_CORE, ALPHA = (3, 24, (6, 12)), 20, 8, 1e-5
#: the vario case of the fixture: q and the kernels of tests/test_mlgk.py
VARIO_Q = 0.05


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread (test processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# closed-form kernel cases (tests/test_models.py)
# ---------------------------------------------------------------------------


def test_nystrom_full_rank_matches_gpr():
    X = np.linspace(0, 1, 12)
    y = np.sin(2 * np.pi * X)
    Z = np.linspace(0.05, 0.95, 7)
    gpr = GaussianProcessRegressor(kernel=RBFKernel(0.4), alpha=1e-8,
                                   device='cpu').fit(X, y)
    nys = LowRankApproximateGPR(kernel=RBFKernel(0.4), alpha=1e-8,
                                device='cpu').fit(X, X, y)
    assert np.allclose(gpr.predict(Z), nys.predict(Z), atol=1e-3)
    jnys = JaxNystrom(kernel=RBFKernel(0.4), alpha=1e-8).fit(X, X, y)
    close(nys.predict(Z), jnys.predict(Z), 1e-8)


def _nystrom_pair(**kwargs):
    X = np.linspace(0, 1, 14)
    C = X[::3]
    y = np.sin(4 * X)
    out = []
    for cls, kw in ((LowRankApproximateGPR, dict(device='cpu')),
                    (JaxNystrom, {})):
        m = cls(kernel=RBFKernel(0.25), alpha=1e-6, **kw, **kwargs)
        m.C, m.X, m.y = C, X, y
        out.append(m)
    return out, (C, X, y)


def test_nystrom_lml_gradient():
    (nys, jnys), _ = _nystrom_pair()
    lml, grad = nys.log_marginal_likelihood(eval_gradient=True)
    jlml, jgrad = jnys.log_marginal_likelihood(eval_gradient=True)
    assert lml == pytest.approx(jlml, rel=1e-9)
    close(grad, jgrad, 1e-9)
    assert nys.log_marginal_likelihood() == pytest.approx(lml, rel=1e-12)
    eps = 1e-6
    t0 = nys.kernel.theta
    fd = (nys.log_marginal_likelihood(t0 + eps)
          - nys.log_marginal_likelihood(t0 - eps)) / (2 * eps)
    assert grad[0] == pytest.approx(fd, rel=1e-2)


@pytest.mark.parametrize('normalize_y', [False, True])
def test_nystrom_predictions_match_jax(normalize_y):
    """predict (mean, std, cov) and both predict_loocv methods."""
    (nys, jnys), (C, X, y) = _nystrom_pair(normalize_y=normalize_y)
    nys.alpha = jnys.alpha = 1e-3
    nys.fit(C, X, y)
    jnys.fit(C, X, y)
    Z = X[:5] + 0.03
    close(nys.predict(Z), jnys.predict(Z), 1e-8)
    for kw in (dict(return_std=True), dict(return_cov=True)):
        for a, b in zip(nys.predict(Z, **kw), jnys.predict(Z, **kw)):
            close(a, b, 1e-8)
    for method in ('ridge-like', 'gpr-like', 'auto'):
        close(nys.predict_loocv(X, y, method=method),
              jnys.predict_loocv(X, y, method=method), 1e-8)
    for a, b in zip(nys.predict_loocv(X, y, return_std=True,
                                      method='gpr-like'),
                    jnys.predict_loocv(X, y, return_std=True,
                                       method='gpr-like')):
        close(a, b, 1e-8)
    with pytest.raises(NotImplementedError):
        nys.predict_loocv(X, y, return_std=True, method='ridge-like')
    with pytest.raises(RuntimeError, match='not available'):
        LowRankApproximateGPR(RBFKernel(0.25), optimizer=True,
                              device='cpu').fit(C, X, y, loss='loocv')


def test_nystrom_singular_core_falls_back():
    """A singular core (repeated samples, alpha 0) takes the clamped
    whitener with a warning, in both packages alike. The basis that each
    eigensolver picks in the degenerate null space is arbitrary and is
    scaled up by the clamp, so the predictions agree to 1e-2 of their
    scale, not to rounding."""
    X = np.linspace(0, 1, 10)
    C = np.concatenate([X[:3], X[:3]])
    y = np.cos(3 * X)
    got = []
    for m in (LowRankApproximateGPR(RBFKernel(0.3), alpha=0, device='cpu'),
              JaxNystrom(RBFKernel(0.3), alpha=0)):
        with pytest.warns(UserWarning, match='Core matrix singular'):
            m.fit(C, X, y)
        got.append(m.predict(X + 0.05))
    assert np.isfinite(got[0]).all()
    close(got[0], got[1], 1e-2)


def test_outlier_detector():
    """The outlier of tests/test_models.py found, with the JAX model's
    noises; the start point's LML and gradient as JAX's."""
    X = np.linspace(0, 1, 24)
    y = np.sin(2 * np.pi * X)
    y[5] += 2.5  # outlier
    fitted = []
    for cls, kw in ((GPROutlierDetector, dict(device='cpu')), (JaxOD, {})):
        np.random.seed(7)
        od = cls(kernel=RBFKernel(0.3), beta=1e-8, **kw)
        od.fit(X, y, w=0.5, repeat=1, tol=1e-4)
        fitted.append(od)
    od, jod = fitted
    assert np.argmax(od.y_uncertainty) == 5
    close(od.y_uncertainty, jod.y_uncertainty, 1e-3)
    theta_ext = np.concatenate([[np.log(0.3)], np.full(24, np.log(0.1))])
    value, grad = od.log_marginal_likelihood(theta_ext, eval_gradient=True)
    jvalue, jgrad = jod.log_marginal_likelihood(theta_ext,
                                                eval_gradient=True)
    assert value == pytest.approx(jvalue, rel=1e-9)
    close(grad, jgrad, 1e-9)
    assert od.log_marginal_likelihood(theta_ext) == pytest.approx(
        value, rel=1e-12)
    # the std is the square root of a residual near 0: absolute 1e-3
    Z = X[:6] + 0.02
    (mean, std), (jmean, jstd) = (m.predict(Z, return_std=True)
                                  for m in fitted)
    close(mean, jmean, 1e-3)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=1e-3)


def test_outlier_udist_is_used():
    """An explicit ``udist`` seeds the noises: two fits with the same
    seeded sampler agree exactly."""
    X = np.linspace(0, 1, 16)
    y = np.sin(2 * np.pi * X)
    y[3] -= 2.0
    sigmas = []
    for _ in range(2):
        rng = np.random.default_rng(11)
        od = GPROutlierDetector(RBFKernel(0.3), device='cpu').fit(
            X, y, w=0.5, udist=lambda k: rng.lognormal(-1.0, 1.0, k))
        sigmas.append(od.y_uncertainty)
    np.testing.assert_array_equal(*sigmas)
    assert np.argmax(sigmas[0]) == 3


def test_save_load(tmp_path):
    X = np.linspace(0, 1, 12)
    y = np.sin(2 * np.pi * X)
    nys = LowRankApproximateGPR(RBFKernel(0.4), alpha=1e-6,
                                device='cpu').fit(X[::2], X, y)
    od = GPROutlierDetector(RBFKernel(0.3), device='cpu').fit(
        X, y, w=0.5, udist=lambda k: np.full(k, 0.1))
    for model, twin in ((nys, LowRankApproximateGPR(RBFKernel(1.0),
                                                    device='cpu')),
                        (od, GPROutlierDetector(RBFKernel(1.0),
                                                device='cpu'))):
        model.save(tmp_path, 'model.pkl', overwrite=True)
        twin.load(tmp_path, 'model.pkl')
        np.testing.assert_array_equal(twin.predict(X + 0.01),
                                      model.predict(X + 0.01))


def test_models_default_to_the_card(monkeypatch):
    """Without a card the default device raises at the first solve."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    X = np.linspace(0, 1, 8)
    y = np.sin(X)
    for model in (LowRankApproximateGPR(RBFKernel(0.4)),
                  GPROutlierDetector(RBFKernel(0.4), optimizer=None)):
        assert model.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        LowRankApproximateGPR(RBFKernel(0.4)).fit(X, X, y)
    od = GPROutlierDetector(RBFKernel(0.4))
    od.X, od.y = X, y
    with pytest.raises(RuntimeError, match='no CUDA device'):
        od.log_marginal_likelihood(np.zeros(9), eval_gradient=True)


# ---------------------------------------------------------------------------
# the graph case
# ---------------------------------------------------------------------------


def targets(graphs):
    """bench_nuts.py's targets: -10 |nodes| + N(0, 1) from default_rng(0)."""
    rng = np.random.default_rng(0)
    return np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])


def graph_kernel(m, **kwargs):
    """The Tang-style normalized kernel from package module ``m`` (its
    ``microkernel`` and ``kernel`` names)."""
    mk, MGK, Norm = m
    return Norm(MGK(mk.TensorProduct(element=mk.KroneckerDelta(0.2)),
                    mk.TensorProduct(length=mk.SquareExponential(0.3)),
                    q=0.05, **kwargs))


PORT = (tmk, MarginalizedGraphKernel, Normalization)
JAX = (jmk, JaxMGK, JaxNormalization)


def graph_case(kernel, graphs, model_cls, **kwargs):
    """The core, LML and gradient at theta0, and the predictions of the
    held-out graphs with std, of one package's models."""
    y = targets(graphs)
    train = graphs[:N_TRAIN]
    core = HierarchicalDrafter(VarianceMinimizer(kernel))(
        train, N_CORE, random_state=0) if model_cls is \
        LowRankApproximateGPR else JaxDrafter(JaxVM(kernel))(
            train, N_CORE, random_state=0)
    model = model_cls(kernel, alpha=ALPHA, normalize_y=True, **kwargs)
    model.fit([train[i] for i in core], train, y[:N_TRAIN])
    lml, grad = model.log_marginal_likelihood(eval_gradient=True)
    mean, std = model.predict(graphs[N_TRAIN:], return_std=True)
    return {'core': np.asarray(core), 'y': y, 'theta': model.kernel.theta,
            'lml': lml, 'grad': grad, 'mean': mean, 'std': std}


def vario_reference():
    """The dense oracle's raw Gram of the vario graphs at VARIO_Q, float64,
    over the port's graphs and kernels (``tests/oracle.py``)."""
    from oracle import mlgk
    from test_torch_mlgk import vario_graphs, vario_kernels
    G = vario_graphs(Graph)
    knode, kedge = vario_kernels(tmk, 'conv')
    return np.array([[mlgk(a, b, knode, kedge, VARIO_Q) for b in G]
                     for a in G])


def jax_reference():
    seed, count, atoms = GRAPH_SET
    graphs = jax_testing.random_molecule_set(seed, count, atoms)
    out = graph_case(graph_kernel(JAX, backend='edge'), graphs, JaxNystrom)
    out.update(graph_set=np.array([seed, count, *atoms]), n_train=N_TRAIN,
               n_core=N_CORE, alpha=ALPHA, vario_q=VARIO_Q,
               vario_oracle=vario_reference())
    return out


def assert_graph_case_close(got, want):
    np.testing.assert_array_equal(got['core'], want['core'])
    np.testing.assert_array_equal(got['y'], want['y'])
    np.testing.assert_allclose(got['theta'], want['theta'], rtol=1e-6)
    assert abs(got['lml'] - want['lml']) <= 1e-4 * abs(want['lml'])
    assert np.abs(got['grad'] - want['grad']).max() <= (
        1e-3 * np.abs(want['grad']).max() + 1e-3)
    np.testing.assert_allclose(got['mean'], want['mean'], rtol=1e-4)
    assert np.abs(got['std'] - want['std']).max() <= 1e-4


@lru_cache(maxsize=None)
def port_graph_case(backend):
    seed, count, atoms = GRAPH_SET
    graphs = port_testing.random_molecule_set(seed, count, atoms)
    return graph_case(graph_kernel(PORT, backend=backend, device='cpu'),
                      graphs, LowRankApproximateGPR, device='cpu')


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_port_matches_models_fixture(backend):
    assert_graph_case_close(port_graph_case(backend), dict(np.load(FIXTURE)))


def test_models_fixture_is_current():
    """JAX's values regenerate the fixture, held by the contract limits of
    the graph case (never by 1e-6 on a float32 result); the oracle's vario
    Gram within 1e-12."""
    ref = dict(np.load(FIXTURE))
    got = jax_reference()
    assert_graph_case_close(got, ref)
    np.testing.assert_allclose(got['vario_oracle'], ref['vario_oracle'],
                               rtol=1e-12)


def test_nystrom_full_core_matches_exact_gpr_on_graphs():
    """With the core equal to the training set, the Nystrom prediction on
    graphs is the exact GPR's, as ``test_nystrom_full_rank_matches_gpr``
    on scalars (atol 1e-3 of the target scale)."""
    seed, count, atoms = GRAPH_SET
    graphs = port_testing.random_molecule_set(seed, 12, atoms)
    y = targets(graphs)
    kernel = graph_kernel(PORT, device='cpu')
    exact = GaussianProcessRegressor(kernel, alpha=1e-4, normalize_y=True,
                                     device='cpu').fit(graphs[:8], y[:8])
    nys = LowRankApproximateGPR(kernel, alpha=1e-4, normalize_y=True,
                                device='cpu').fit(graphs[:8], graphs[:8],
                                                  y[:8])
    np.testing.assert_allclose(nys.predict(graphs[8:]),
                               exact.predict(graphs[8:]),
                               rtol=0, atol=1e-3 * np.abs(y).std())


def test_cross_gram_comes_from_one_cached_factory(monkeypatch):
    """Every objective evaluation's two-sided Kxc and core Kcc reach the
    kernel's factory route (here at any size) and the factories are built
    once: repeated evaluations, at other theta too, hit the cache."""
    monkeypatch.setenv('GRAPHDOT_API_UNION', '1')
    built = []
    real = gram_module.GramFactory.__init__

    def counted(self, kernel, graphs, *args, graphs2=None, **kwargs):
        built.append((len(graphs), None if graphs2 is None
                      else len(graphs2)))
        real(self, kernel, graphs, *args, graphs2=graphs2, **kwargs)

    monkeypatch.setattr(gram_module.GramFactory, '__init__', counted)
    seed, _, atoms = GRAPH_SET
    graphs = port_testing.random_molecule_set(seed, 12, atoms)
    model = LowRankApproximateGPR(graph_kernel(PORT, device='cpu'),
                                  alpha=ALPHA, normalize_y=True,
                                  device='cpu')
    model.C, model.X, model.y = graphs[:4], graphs, targets(graphs)
    theta = model.kernel.theta
    first = model.log_marginal_likelihood(theta, eval_gradient=True,
                                          clone_kernel=False)
    assert sorted(built, key=str) == sorted([(12, 4), (4, None)], key=str)
    again = model.log_marginal_likelihood(theta, eval_gradient=True,
                                          clone_kernel=False)
    model.log_marginal_likelihood(theta + 0.1, eval_gradient=True)
    assert len(built) == 2
    assert again[0] == first[0]
    np.testing.assert_array_equal(again[1], first[1])


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).parent))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    ref = jax_reference()
    np.savez(FIXTURE, **ref)
    print(f'wrote {FIXTURE}: ' + ', '.join(sorted(ref)))

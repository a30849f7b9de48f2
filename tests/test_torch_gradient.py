"""Hyperparameter gradients of the PyTorch port against the JAX package.

The same graphs and hyperparameters go through the JAX kernel
(``jax.jacfwd`` through ``custom_linear_solve``; ``backend='pallas'`` in
interpret mode on the CPU, and ``'edge'``) and through the port
(``eval_gradient=True``: forward-mode tangent systems; ``backend='cuda'``
runs the CUDA kernels' plain twins on CPU tensors, ``'edge'`` the plain
torch path). Also: finite differences on the port, the reverse-mode
``solve_linear`` against the tangents, the Gram-level chain rules of
``kernel/fix.py``, the constructor's signature, and the JAX fixture of the
slice's gradient Gram.

Tolerances: K rtol 1e-5, atol 1e-7; dK rtol 1e-3, atol 1e-5, as JAX's own
``test_mlgk.py`` holds ``pallas`` against ``edge``: the JAX jacobian solves
its linearization point and tangents at gtol, the port takes the value
solve's x (ftol) and solves the tangents at gtol, and both are float32 CG.

Run as a script to rewrite ``fixtures/torch_port_grad_ref.npz``.
"""
import inspect
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu.kernel import (  # noqa: E402
    Exponentiation as JaxExponentiation,
    MarginalizedGraphKernel as JaxMGK,
    Normalization as JaxNormalization,
)
from graphdot_tpu.testing import random_molecule_set  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch.convert import hyperparameters_from_numpy  # noqa
from graphdot_tpu_torch.kernel import (  # noqa: E402
    Exponentiation,
    MarginalizedGraphKernel,
    Normalization,
    Tang2019MolecularKernel,
)
from graphdot_tpu_torch.kernel.marginalized import Adhoc  # noqa: E402
from graphdot_tpu_torch.ops import pcg_packed  # noqa: E402

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_grad_ref.npz'
#: the slice's graph set (bench.py) and how much of it the fixture covers
SLICE_SEED, SLICE_GRAPHS, FIXTURE_GRAPHS = 42, 128, 8

K_TOL = dict(rtol=1e-5, atol=1e-7)
DK_TOL = dict(rtol=1e-3, atol=1e-5)


def slice_kernels(m, **kwargs):
    """The slice's kernel, built from microkernel module ``m``."""
    return dict(
        node_kernel=m.TensorProduct(element=m.KroneckerDelta(0.2)),
        edge_kernel=m.TensorProduct(length=m.SquareExponential(0.3)),
        q=0.05, **kwargs)


def slice_graphs():
    return random_molecule_set(
        SLICE_SEED, SLICE_GRAPHS, n_atoms_range=(9, 24))[:FIXTURE_GRAPHS]


def jax_reference_gradient():
    """The JAX package's normalized Gram and its gradient over the first
    graphs of the slice's set (fused PCG in interpret mode); returns
    (K, dK, theta)."""
    kernel = JaxMGK(**slice_kernels(jmk, backend='pallas'))
    K, dK = JaxNormalization(kernel)(slice_graphs(), eval_gradient=True)
    return K, dK, kernel.flat_hyperparameters


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def molecules():
    """6 molecules of 5-14 atoms (two padded-size classes)."""
    return random_molecule_set(11, 6, n_atoms_range=(5, 14))


def jax_kernel(backend, **kwargs):
    """The JAX kernel under test, at hyperparameters away from the
    defaults so that carrying them over matters."""
    return JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
        jmk.TensorProduct(length=jmk.SquareExponential(0.5)),
        p=1.5, q=0.1, backend=backend, **kwargs)


def port_kernel(jk, backend, **kwargs):
    """A port kernel with default hyperparameters, set to ``jk``'s."""
    tk = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)),
        backend=backend, device='cpu', **kwargs)
    return hyperparameters_from_numpy(tk, jk.flat_hyperparameters,
                                      bounds=jk.hyperparameter_bounds)


def _split(G):
    return G[:2], G[2:]


#: case -> (kernel kwargs, call(kernel, graphs, Normalization class))
CASES = {
    'symmetric': ({}, lambda k, G, N: k(G, eval_gradient=True)),
    'rectangular': ({}, lambda k, G, N: k(*_split(G), eval_gradient=True)),
    'nodal': ({}, lambda k, G, N: k(G, nodal=True, eval_gradient=True)),
    'lmin': ({}, lambda k, G, N: k(G, lmin=1, eval_gradient=True)),
    'nodal_lmin': ({}, lambda k, G, N: k(G, nodal=True, lmin=1,
                                         eval_gradient=True)),
    'buckets': (dict(buckets=True),
                lambda k, G, N: k(G, eval_gradient=True)),
    'buckets_nodal': (dict(buckets=True),
                      lambda k, G, N: k(G, nodal=True, eval_gradient=True)),
    'diag': ({}, lambda k, G, N: k.diag(G, eval_gradient=True)),
    'diag_nodal': ({}, lambda k, G, N: k.diag(G, True, nodal=True)),
    'diag_block': ({}, lambda k, G, N: k.diag(G, True, nodal='block')),
    'diag_all_theta': ({}, lambda k, G, N: k.diag(
        G, True, active_theta_only=False)),
    'normalization': ({}, lambda k, G, N: N(k)(G, eval_gradient=True)),
    'normalization_rectangular': ({}, lambda k, G, N: N(k)(
        *_split(G), eval_gradient=True)),
}


@lru_cache(maxsize=None)
def jax_result(case, backend):
    kwargs, call = CASES[case]
    return call(jax_kernel(backend, **kwargs), molecules(), JaxNormalization)


def _assert_close(got, want, tol):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **tol)
    else:
        assert np.shape(got) == np.shape(want)
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize('jax_backend', ['pallas', 'edge'])
@pytest.mark.parametrize('backend', ['cuda', 'edge'])
@pytest.mark.parametrize('case', CASES)
def test_gradient_matches_jax(case, backend, jax_backend):
    kwargs, call = CASES[case]
    tk = port_kernel(jax_kernel('edge', **kwargs), backend, **kwargs)
    K, dK = call(tk, molecules(), Normalization)
    K_want, dK_want = jax_result(case, jax_backend)
    _assert_close(K, K_want, K_TOL)
    _assert_close(dK, dK_want, DK_TOL)
    if case not in ('diag_block',):
        assert np.asarray(dK).dtype == np.float64


@pytest.mark.parametrize('backend', ['cuda', 'edge', 'dense'])
@pytest.mark.parametrize('nodal', [False, True])
def test_finite_differences(backend, nodal):
    """d K / d theta against central differences in log theta, as
    ``test_mlgk.py::test_gradient``."""
    G = molecules()[:4]
    k = port_kernel(jax_kernel('edge'), backend)
    R, dR = k(G, nodal=nodal, eval_gradient=True)
    assert dR.shape == R.shape + (len(k.theta),)
    eps = 1e-3
    theta0 = k.theta
    for t in range(len(theta0)):
        tp, tm = np.copy(theta0), np.copy(theta0)
        tp[t] += eps
        tm[t] -= eps
        Rp = k.clone_with_theta(tp)(G, nodal=nodal)
        Rm = k.clone_with_theta(tm)(G, nodal=nodal)
        dR_dt = (Rp - Rm) / (2 * eps) / np.exp(theta0[t])
        np.testing.assert_allclose(dR[:, :, t], dR_dt, rtol=0.05, atol=0.05,
                                   err_msg=f'theta[{t}]')


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_solve_linear_backward_matches_tangents(backend):
    """Reverse mode through ``solve_linear`` (one adjoint solve a chunk)
    gives the same gradient of sum(c o K) as the forward tangents."""
    G = molecules()
    k = port_kernel(jax_kernel('edge'), backend)
    _, dK = k(G, eval_gradient=True)
    assert k.active_theta_mask.all()
    batch, bd, pf = k._prepare_batch(G)
    i, j = np.triu_indices(len(G))
    theta = k._theta_vector().requires_grad_()
    values, _ = k._solve_chunk(theta, bd, bd, torch.as_tensor(i),
                               torch.as_tensor(j), pf, pf, nodal=False,
                               lmin=0)
    c = np.random.default_rng(7).normal(size=len(i))
    loss = torch.sum(torch.as_tensor(c, dtype=torch.float32) * values)
    (got,) = torch.autograd.grad(loss, theta)
    want = np.sum(c[:, None] * dK[i, j], axis=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)


def test_cuda_route_on_cpu_packs_tangents():
    """backend='cuda' on CPU tensors runs the tangents through the packed
    route's plain twin and launches nothing."""
    before = pcg_packed.launches
    G = molecules()[:3]
    k = MarginalizedGraphKernel(
        **slice_kernels(tmk, backend='cuda', device='cpu'))
    _, dK_cuda = k(G, eval_gradient=True)
    _, dK_edge = MarginalizedGraphKernel(
        **slice_kernels(tmk, backend='edge', device='cpu'))(
            G, eval_gradient=True)
    np.testing.assert_allclose(dK_cuda, dK_edge, **DK_TOL)
    assert pcg_packed.launches == before


def test_adhoc_starting_probability_gradient():
    """Fixed per-node starting probabilities carry no hyperparameter; the
    gradient is the solve's alone."""
    G = molecules()[:4]

    def p(nodes):
        return 0.5 + 0.1 * np.asarray(nodes['element'] % 3, dtype=float)

    jk = JaxMGK(jmk.TensorProduct(element=jmk.KroneckerDelta(0.3)),
                jmk.TensorProduct(length=jmk.SquareExponential(0.5)),
                p=(p, 'p'), q=0.1, backend='edge')
    tk = MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.3)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.5)),
        p=Adhoc(p, 'p'), q=0.1, backend='cuda', device='cpu')
    K_want, dK_want = jk(G, eval_gradient=True)
    K, dK = tk(G, eval_gradient=True)
    np.testing.assert_allclose(K, K_want, **K_TOL)
    np.testing.assert_allclose(dK, dK_want, **DK_TOL)


@pytest.mark.parametrize('wrapper', ['normalization', 'exponentiation'])
def test_fix_chain_rules_match_jax(wrapper):
    """``kernel/fix.py``'s chain rules against the JAX package's on the
    same R and dR (a base kernel that returns fixed arrays)."""
    rng = np.random.default_rng(3)
    n, m, d = 4, 3, 2
    R = rng.uniform(0.5, 2.0, (n + m, n + m))
    R = R @ R.T
    dR = rng.normal(size=(n + m, n + m, d))
    dR = dR + dR.transpose(1, 0, 2)

    class Fixed:
        theta = np.zeros(d)

        def __call__(self, X, Y=None, eval_gradient=False):
            rows = np.asarray(X)
            cols = rows if Y is None else np.asarray(Y)
            sub = R[np.ix_(rows, cols)], dR[np.ix_(rows, cols)]
            return sub if eval_gradient else sub[0]

        def diag(self, X, eval_gradient=False):
            X = np.asarray(X)
            out = R[X, X], dR[X, X]
            return out if eval_gradient else out[0]

    X, Y = list(range(n)), list(range(n, n + m))
    if wrapper == 'normalization':
        port, ref = Normalization(Fixed()), JaxNormalization(Fixed())
        calls = [(X,), (X, Y)]
    else:
        port = Exponentiation(Fixed(), xi=1.7)
        ref = JaxExponentiation(Fixed(), xi=1.7)
        calls = [(X,), (X, Y)]
    for args in calls:
        K, dK = port(*args, eval_gradient=True)
        K_want, dK_want = ref(*args, eval_gradient=True)
        np.testing.assert_allclose(K, K_want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(dK, dK_want, rtol=1e-12, atol=0)


@pytest.mark.parametrize('kernel', [
    tmk.KroneckerDelta(0.3),
    tmk.SquareExponential(0.7),
    tmk.Constant(0.4, (0.1, 1.0)),
    tmk.TensorProduct(a=tmk.KroneckerDelta(0.3),
                      b=tmk.SquareExponential(0.7)),
    tmk.Additive(a=tmk.KroneckerDelta(0.3), b=tmk.SquareExponential(0.7)),
    (tmk.KroneckerDelta(0.3) * tmk.SquareExponential(0.7) + 0.1).normalized,
], ids=['delta', 'sqexp', 'constant', 'tensor_product', 'additive',
        'expression'])
def test_microkernel_apply_is_jacfwd_differentiable(kernel):
    """Every ``apply`` of the slice differentiates under
    ``torch.func.jacfwd`` and agrees with its host jacobian."""
    rng = np.random.default_rng(0)
    composite = kernel.name == 'Composite'
    x = rng.integers(0, 3, 5).astype(np.float32)
    y = rng.integers(0, 3, 5).astype(np.float32)
    X = {'a': torch.tensor(x), 'b': torch.tensor(x)} if composite \
        else torch.tensor(x)
    Y = {'a': torch.tensor(y), 'b': torch.tensor(y)} if composite \
        else torch.tensor(y)
    if kernel.name == 'Normalize':
        X, Y = torch.tensor(x), torch.tensor(y)
    theta = torch.tensor(kernel.flat_theta, dtype=torch.float32)
    jac = torch.func.jacfwd(lambda t: kernel.apply(t, X, Y))(theta)
    assert jac.shape == (5, len(theta))
    for n in range(5):
        xi = {'a': x[n], 'b': x[n]} if composite else x[n]
        yi = {'a': y[n], 'b': y[n]} if composite else y[n]
        _, want = kernel(xi, yi, jac=True)
        np.testing.assert_allclose(jac[n].numpy(), np.ravel(want),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the constructor
# ---------------------------------------------------------------------------


def test_constructor_signature_matches_jax():
    """The same parameters in the same order, with the port's ``device``
    as the one extra, trailing parameter."""
    jax_params = list(inspect.signature(JaxMGK).parameters.values())
    port_params = list(
        inspect.signature(MarginalizedGraphKernel).parameters.values())
    assert [p.name for p in port_params[:-1]] == [p.name for p in jax_params]
    assert [p.default for p in port_params[:-1]] == \
        [p.default for p in jax_params]
    assert port_params[-1].name == 'device'
    assert port_params[-1].default == 'cuda'


def test_positional_call_sets_tolerances_alike():
    nk, ek = jmk.KroneckerDelta(0.3), jmk.SquareExponential(0.5)
    tnk, tek = tmk.KroneckerDelta(0.3), tmk.SquareExponential(0.5)
    args = (0.5, 0.1, (1e-3, 0.9), 0.02, 3e-9, 4e-7, np.float32, 'edge',
            True)
    jk = JaxMGK(nk, ek, *args)
    tk = MarginalizedGraphKernel(tnk, tek, *args, 'cpu')
    for name in ('q', 'q_bounds', 'eps', 'ftol', 'gtol', 'element_dtype',
                 'buckets'):
        assert getattr(tk, name) == getattr(jk, name), name
    assert tk.backend.mode == jk.backend.mode
    assert (tk.ftol, tk.gtol, tk.eps) == (3e-9, 4e-7, 0.02)
    tang = Tang2019MolecularKernel(gtol=2e-7, eps=0.5, device='cpu')
    assert (tang.kernel.gtol, tang.kernel.eps) == (2e-7, 0.5)


# ---------------------------------------------------------------------------
# the slice's fixture
# ---------------------------------------------------------------------------


def test_reference_fixture_is_current():
    """The stored JAX gradient Gram regenerates from the JAX package."""
    ref = np.load(FIXTURE)
    K, dK, theta = jax_reference_gradient()
    np.testing.assert_allclose(ref['theta'], theta, rtol=0, atol=0)
    np.testing.assert_allclose(ref['K'], K, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref['dK'], dK, rtol=0,
                               atol=1e-5 * np.abs(dK).max())


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_port_matches_reference_fixture(backend):
    ref = np.load(FIXTURE)
    tk = MarginalizedGraphKernel(
        **slice_kernels(tmk, backend=backend, device='cpu'))
    hyperparameters_from_numpy(tk, ref['theta'])
    K, dK = Normalization(tk)(slice_graphs(), eval_gradient=True)
    np.testing.assert_allclose(K, ref['K'], rtol=0, atol=1e-6)
    scale = np.abs(ref['dK']).max()
    np.testing.assert_allclose(dK, ref['dK'], rtol=0,
                               atol=1e-3 * scale + 1e-5)
    # p cancels in a normalized kernel
    assert np.abs(dK[:, :, 0]).max() <= 1e-5


if __name__ == '__main__':
    import jax
    jax.config.update('jax_platforms', 'cpu')
    K, dK, theta = jax_reference_gradient()
    np.savez(FIXTURE, K=K, dK=dK, theta=theta, seed=SLICE_SEED,
             n_graphs=SLICE_GRAPHS, n_first=FIXTURE_GRAPHS)
    print(f'wrote {FIXTURE}: K {K.shape}, dK {dK.shape}, theta {theta}')

"""The port's dense linear algebra (``graphdot_tpu_torch.linalg``) against
the JAX package's, the eight cases of ``tests/test_linalg.py`` on the CPU
(``device='cpu'``), and its default device.

Both sides compute in float64 from the same numpy inputs (drawn from a
seed), so the limits are those of float64 rounding through a
decomposition: 1e-10 relative to the largest entry, unless a case says
otherwise. The regularized low-rank ``pinvh`` starts both subspace
iterations from the same numpy block and is held to 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu.linalg import low_rank as jlr  # noqa: E402
from graphdot_tpu.linalg.block import binvh1 as jax_binvh1  # noqa: E402
from graphdot_tpu.linalg.cg import CGSolver as JaxCG  # noqa: E402
from graphdot_tpu.linalg.cholesky import (  # noqa: E402
    CholSolver as JaxChol, chol_solve as jax_chol_solve)
from graphdot_tpu.linalg.spectral import (  # noqa: E402
    pinvh as jax_pinvh, powerh as jax_powerh)

from graphdot_tpu_torch.linalg import low_rank as lr  # noqa: E402
from graphdot_tpu_torch.linalg.block import binvh1  # noqa: E402
from graphdot_tpu_torch.linalg.cg import CGSolver  # noqa: E402
from graphdot_tpu_torch.linalg.cholesky import (  # noqa: E402
    CholSolver, chol_solve)
from graphdot_tpu_torch.linalg.spectral import pinvh, powerh  # noqa: E402

CPU = 'cpu'


def _spd(rng, n, rank=None):
    A = rng.standard_normal((n, rank or n))
    return A @ A.T + 1e-3 * np.eye(n)


def close(got, want, rtol=1e-10):
    """|got - want| <= rtol * max |want| (and a float64 floor)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(
        float(np.abs(want).max()), 1e-300))


def test_chol_solver():
    rng = np.random.default_rng(0)
    A, b = _spd(rng, 8), rng.standard_normal(8)
    x = CholSolver(A, device=CPU) @ b
    close(x, JaxChol(A) @ b)
    assert np.allclose(A @ x, b, atol=1e-8)
    close(chol_solve(A, b, device=CPU), jax_chol_solve(A, b))
    close(CholSolver(A, device=CPU).todense(), JaxChol(A).todense())
    close(CholSolver(A, device=CPU).diagonal(), np.diag(np.linalg.inv(A)))
    B = rng.standard_normal((8, 3))
    close(CholSolver(A, device=CPU) @ B, JaxChol(A) @ B)
    for solver in (JaxChol, lambda M: CholSolver(M, device=CPU)):
        with pytest.raises(np.linalg.LinAlgError):
            solver(-np.eye(3))


def test_cg_solver():
    rng = np.random.default_rng(1)
    A, b = _spd(rng, 10), rng.standard_normal(10)
    x = CGSolver(A, rtol=1e-10, device=CPU) @ b
    assert np.allclose(A @ x, b, atol=1e-6)
    # the same iteration to the same stop: float64 rounding apart
    close(x, JaxCG(A, rtol=1e-10) @ b, rtol=1e-8)
    # a matrix of right-hand sides is one system (Frobenius inner product)
    close(CGSolver(A, rtol=1e-12, device=CPU).todense(),
          JaxCG(A, rtol=1e-12).todense(), rtol=1e-8)
    # maxiter caps the steps and the residual check raises, in both
    for solver in (JaxCG, lambda *a, **k: CGSolver(*a, device=CPU, **k)):
        with pytest.raises(RuntimeError, match='did not converge'):
            solver(A, rtol=1e-10, maxiter=1) @ b


def test_powerh():
    rng = np.random.default_rng(2)
    A = _spd(rng, 6)
    half = powerh(A, 0.5, device=CPU)
    assert np.allclose(half @ half, A, atol=1e-8)
    close(half, jax_powerh(A, 0.5))
    close(powerh(A, -1.0, device=CPU), jax_powerh(A, -1.0))
    close(powerh(A, -0.5, return_symmetric=False, device=CPU)
          @ powerh(A, -0.5, return_symmetric=False, device=CPU).T,
          np.linalg.inv(A))
    Hp, w = powerh(A, 2, return_eigvals=True, device=CPU)
    close(Hp, A @ A)
    close(w, np.linalg.eigvalsh(A))
    for fn in (jax_powerh, lambda *a: powerh(*a, device=CPU)):
        with pytest.raises(np.linalg.LinAlgError):
            fn(-np.eye(3), -0.5)


@pytest.mark.parametrize('mode', ['truncate', 'clamp'])
def test_pinvh(mode):
    rng = np.random.default_rng(3)
    A = _spd(rng, 8, rank=5)
    Ainv, nlogdet = pinvh(A, rcond=1e-8, mode=mode, return_nlogdet=True,
                          device=CPU)
    assert np.allclose(A @ Ainv @ A, A, atol=1e-5)
    assert np.isfinite(nlogdet)
    JAinv, jnlogdet = jax_pinvh(A, rcond=1e-8, mode=mode,
                                return_nlogdet=True)
    close(Ainv, JAinv, rtol=1e-8)
    assert nlogdet == pytest.approx(jnlogdet, rel=1e-10)


def test_binvh1():
    rng = np.random.default_rng(4)
    n = 6
    B = _spd(rng, n + 1)
    A_inv = np.linalg.inv(B[:n, :n])
    B_inv = binvh1(A_inv, B[:n, n], B[n, n])
    assert np.allclose(B_inv, np.linalg.inv(B), atol=1e-8)
    np.testing.assert_array_equal(
        B_inv, jax_binvh1(A_inv, B[:n, n], B[n, n]))


def test_low_rank_algebra():
    rng = np.random.default_rng(5)
    n, k = 12, 4
    X, Y = rng.standard_normal((n, k)), rng.standard_normal((n, k))
    a = rng.standard_normal(n)
    results = []
    for m, kw in ((lr, dict(device=CPU)), (jlr, {})):
        L = m.dot(X, **kw)
        M = m.dot(X, Y.T, **kw)
        S, D, P = L + M, L - M, L @ M
        results.append(dict(
            L=L.todense(), Ld=L.diagonal(), Lt=L.trace(), S=S.todense(),
            D=D.todense(), q=S.quadratic(a, a),
            qd=S.quadratic_diag(np.outer(a, a), np.eye(n)),
            P=P.todense(), PT=P.T.todense(), neg=(-M).todense(),
            Sa=S @ a, direct=m.dot(X, method='direct', **kw).todense()))
    got, want = results
    assert np.allclose(got['L'], X @ X.T, atol=1e-8)
    assert np.allclose(got['S'], X @ X.T + X @ Y.T, atol=1e-8)
    assert np.allclose(got['D'], X @ X.T - X @ Y.T, atol=1e-8)
    assert np.allclose(got['P'], (X @ X.T) @ (X @ Y.T), atol=1e-6)
    for key in want:
        close(got[key], want[key])
    with pytest.raises(RuntimeError):
        lr.dot(X, Y.T, method='spectral', device=CPU)
    with pytest.raises(TypeError):
        lr.dot(X, device=CPU) + X


def test_llt_pinv_logdet():
    rng = np.random.default_rng(6)
    n = 10
    X = rng.standard_normal((n, n))
    L, J = lr.dot(X, device=CPU), jlr.dot(X)
    assert np.allclose(L.pinv().todense(), np.linalg.inv(X @ X.T),
                       atol=1e-5)
    close(L.pinv().todense(), J.pinv().todense(), rtol=1e-8)
    assert L.logdet() == pytest.approx(J.logdet(), rel=1e-10)
    assert L.cond() == pytest.approx(J.cond(), rel=1e-8)
    close((L ** 0.5).todense(), (J ** 0.5).todense(), rtol=1e-8)
    for mode in ('truncate', 'clamp'):
        close(lr.dot(X[:, :4], rcond=0.5, mode=mode, device=CPU).todense(),
              jlr.dot(X[:, :4], rcond=0.5, mode=mode).todense())
    close(lr.LLT(X, device=CPU).todense(), jlr.LLT(X).todense())
    close(lr.LATR(X, X.T, device=CPU).todense(), jlr.LATR(X, X.T).todense())


@pytest.mark.parametrize('mode', ['truncate', 'clamp'])
def test_low_rank_pinvh_regularized(mode):
    rng = np.random.default_rng(7)
    n, k = 30, 5
    X = rng.standard_normal((n, k))
    d = np.full(n, 0.1)
    Ainv = lr.pinvh(lr.dot(X, device=CPU), d, k=k + 6, mode=mode)
    JAinv = jlr.pinvh(jlr.dot(X), d, k=k + 6, mode=mode)
    dense = np.linalg.inv(X @ X.T + np.diag(d))
    v = X @ rng.standard_normal(k)
    assert np.allclose(Ainv @ v, dense @ v, atol=1e-2)
    close(Ainv @ v, JAinv @ v, rtol=1e-8)
    close(lr.pinvh(lr.dot(X, device=CPU), d).todense(),
          jlr.pinvh(jlr.dot(X), d).todense(), rtol=1e-8)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the default device (``'cuda'``) raises instead of
    computing elsewhere."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    A = np.eye(3)
    for call in (lambda: CholSolver(A), lambda: CGSolver(A),
                 lambda: powerh(A, 0.5), lambda: pinvh(A),
                 lambda: lr.dot(A), lambda: lr.Factored([(A, A)])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()

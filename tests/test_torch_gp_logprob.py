"""The port's ``GPRLogProb`` and its batched Gram against the JAX package's,
on the CPU.

On ``gp_problem`` of ``tests/test_inference.py`` (8 molecules of 5-9 atoms,
``KroneckerDelta(0.2)`` on element, ``SquareExponential(0.3)`` on length,
q = 0.05), the port with ``device='cpu'`` (backend ``'cuda'``, whose kernels
run their plain twins on CPU tensors) against JAX (``'edge'``):

- logp and its gradient at theta0 and 4 jittered thetas, one batched call,
  against ``jax.value_and_grad``: logp within 1e-4 |logp| + 1e-4, the
  gradient within 1e-3 max |grad| + 1e-3; the gradient against central
  differences (rel 0.05, abs 0.02), as the JAX test;
- K against the port's ``Normalization`` (rtol 1e-4, atol 1e-5), the
  convergence diagnostics as the JAX test, ``predict_fn`` against JAX's
  (1e-4 max);
- ``GramFactory.gram`` of [C, n_active] against C single calls (K 1e-6, dK
  1e-6 max |dK|, the residuals);
- at q >= 1, the same finiteness as JAX, and the call returns;
- a short GP chain (2 chains, warmup 40, 16 draws, ``max_depth`` 5): every
  draw finite, no chain stuck;
- the JAX GP NUTS transition of ``fixtures/torch_port_nuts_ref.npz``, draw
  for draw, and the fixture's ``bench_nuts.py`` values on the CPU.

Run as a script (``PYTHONPATH=.:tests python tests/test_torch_gp_logprob.py``)
to rewrite the fixture from JAX on the CPU: the log posterior of
``bench_nuts.py``'s 32 molecules and its gradient at theta0 and 7 jittered
thetas, one GP NUTS transition on ``gp_problem`` (key, start state, step
size, inverse mass, ``max_depth`` 5, its draws in ``nuts_draws``'s layout,
and JAX's result), and thetas with q >= 1 with the finiteness of JAX's
log density there. ``chip_smoke.py`` holds the card against it.
"""
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.inference import GPRLogProb as JaxGPRLogProb  # noqa
from graphdot_tpu.inference.hmc import hmc_init as jax_hmc_init  # noqa
from graphdot_tpu.inference.nuts import nuts_step as jax_nuts_step  # noqa
from graphdot_tpu.kernel import MarginalizedGraphKernel as JaxMGK  # noqa

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.inference import (  # noqa: E402
    GPRLogProb, HMCState, nuts_step, sample)
from graphdot_tpu_torch.kernel import (  # noqa: E402
    MarginalizedGraphKernel, Normalization)

from test_torch_inference import jax_nuts_draws  # noqa: E402

FIXTURE = Path(__file__).parent / 'fixtures' / 'torch_port_nuts_ref.npz'
#: random_molecule_set(seed, count, atoms) of bench_nuts.py and of
#: tests/test_inference.py's gp_problem
BENCH_SET, GP_SET = (7, 32, (9, 24)), (0, 8, (5, 9))
#: bench_nuts.py's alpha; the GP chain's (test_gp_nuts_short_chain)
ALPHA = 1e-2
#: the jittered thetas: theta0 + JITTER * default_rng(JITTER_SEED) normals
N_JITTER, JITTER, JITTER_SEED = 7, 0.1, 5
#: the fixture's GP NUTS transition on gp_problem: PRNGKey, offset of the
#: start from theta0, step size, max_depth (inverse mass: ones)
NUTS_KEY, NUTS_OFFSET, NUTS_STEP, NUTS_DEPTH = 3, 0.05, 0.4, 5
#: log q of the out-of-domain thetas (q = 1 and q = 2)
OOD_LOG_Q = (0.0, float(np.log(2.0)))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread. The test processes run side by side, and
    torch's default of a thread a core then makes every small op wait on
    descheduled threads (tens of times slower than one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_kernel():
    return JaxMGK(jmk.TensorProduct(element=jmk.KroneckerDelta(0.2)),
                  jmk.TensorProduct(length=jmk.SquareExponential(0.3)),
                  q=0.05)


def port_kernel(backend='cuda'):
    return MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
        backend=backend, device='cpu')


def gp_targets(graphs):
    """gp_problem's targets: N(0, 1) from default_rng(1)."""
    return np.random.default_rng(1).normal(size=len(graphs))


def bench_targets(graphs):
    """bench_nuts.py's targets: -10 |nodes| + N(0, 1), default_rng(0)."""
    rng = np.random.default_rng(0)
    return np.array([-10.0 * len(g.nodes) + rng.normal() for g in graphs])


@lru_cache(maxsize=None)
def graphs(pkg, which):
    m = jax_testing if pkg == 'jax' else port_testing
    seed, count, atoms = GP_SET if which == 'gp' else BENCH_SET
    return m.random_molecule_set(seed, count, n_atoms_range=atoms)


@lru_cache(maxsize=None)
def logprob(pkg, alpha=1e-3, maxiter=64):
    """The log posterior of gp_problem in one package (alpha 1e-3, as the
    JAX GP tests' gradient checks)."""
    G = graphs(pkg, 'gp')
    if pkg == 'jax':
        return JaxGPRLogProb(jax_kernel(), G, gp_targets(G), alpha=alpha,
                             maxiter=maxiter)
    return GPRLogProb(port_kernel(), G, gp_targets(G), alpha=alpha,
                      maxiter=maxiter)


def jittered(theta0, n, seed=JITTER_SEED):
    """theta0 and n jittered copies, [n + 1, D] float32."""
    rng = np.random.default_rng(seed)
    return np.vstack([theta0, theta0 + JITTER * rng.normal(
        size=(n, len(theta0)))]).astype(np.float32)


def jax_value_and_grad(lp, thetas):
    vg = jax.jit(jax.value_and_grad(lp))
    out = [vg(jnp.asarray(t)) for t in thetas]
    return (np.array([float(v) for v, _ in out]),
            np.array([np.asarray(g) for _, g in out]))


def _assert_logp_grad(logp, grad, logp_want, grad_want, logp_atol):
    np.testing.assert_allclose(logp, logp_want, rtol=1e-4, atol=logp_atol)
    for g, w in zip(grad, grad_want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max() + 1e-3)


def test_logp_and_grad_match_jax():
    """theta0 and 4 jittered thetas in one batched call [5, D]."""
    lp = logprob('port')
    thetas = jittered(lp.theta0, 4)
    logp_want, grad_want = jax_value_and_grad(logprob('jax'), thetas)
    logp, grad = lp.value_and_grad()(torch.from_numpy(thetas))
    assert logp.shape == (5,) and grad.shape == (5, 4)
    assert logp.dtype == grad.dtype == torch.float32
    _assert_logp_grad(logp.numpy(), grad.numpy(), logp_want, grad_want,
                      1e-4)
    # one theta [D] gives a scalar
    one = lp(torch.from_numpy(thetas[0]))
    assert one.shape == () and float(one) == pytest.approx(float(logp[0]),
                                                           rel=1e-6)


def test_grad_matches_central_differences():
    lp = logprob('port')
    t0 = torch.tensor(lp.theta0, dtype=torch.float32)
    val, grad = lp.value_and_grad()(t0)
    assert np.isfinite(float(val))
    eps = 1e-3
    steps = torch.eye(len(t0)) * eps
    plus, minus = lp(t0 + steps), lp(t0 - steps)
    for i in range(len(t0)):
        fd = (float(plus[i]) - float(minus[i])) / (2 * eps)
        assert float(grad[i]) == pytest.approx(fd, rel=0.05, abs=0.02), i


#: log theta of gp_problem with a length scale of 1.5e-13: there the edge
#: kernel's derivative overflows float32 against a padded edge's length (0)
#: but not between real bonds (1.0-1.8), found by a seeded search
TINY_LENGTH_THETA = (-2.2526717, -4.2657475, -1.0926995, -29.531305)


def test_tiny_length_scale_gradient_matches_jax_differences():
    """Where the edge kernel's derivative overflows against the padded
    edges' features, the port's T_d is 0 at those edges (a mask in
    ``mlgk_setup``), so its gradient is finite: it equals JAX's in the
    directions where JAX's is finite, and central differences of JAX's
    log density in all of them. JAX multiplies the padded edges' NaN by
    their weight 0 and returns NaN in the length scale's direction."""
    G, Gj = graphs('port', 'gp'), graphs('jax', 'gp')
    lp = GPRLogProb(port_kernel(), G, gp_targets(G), alpha=ALPHA)
    lpj = JaxGPRLogProb(jax_kernel(), Gj, gp_targets(Gj), alpha=ALPHA)
    t = np.array(TINY_LENGTH_THETA, dtype=np.float32)
    logp, grad = lp.value_and_grad()(torch.from_numpy(t))
    logp_want, grad_want = jax_value_and_grad(lpj, [t])
    assert np.isnan(grad_want[0, 3]) and np.isfinite(grad_want[0, :3]).all()
    assert np.isfinite(grad.numpy()).all()
    ok = np.isfinite(grad_want[0])
    _assert_logp_grad([float(logp)], grad.numpy()[None, ok],
                      logp_want, grad_want[:, ok], 1e-4)
    eps = 1e-2
    for i in range(len(t)):
        step = np.eye(len(t), dtype=np.float32)[i] * eps
        fd = (float(lpj(jnp.asarray(t + step)))
              - float(lpj(jnp.asarray(t - step)))) / (2 * eps)
        assert float(grad[i]) == pytest.approx(fd, rel=0.05, abs=0.02), i


def test_gram_matches_normalization():
    lp = logprob('port')
    K = lp.factory.gram(lp.theta0).numpy()
    K_ref = Normalization(port_kernel())(graphs('port', 'gp'))
    assert np.allclose(K, K_ref, rtol=1e-4, atol=1e-5)


def test_convergence_diagnostics():
    """The bounded-effort CG cap is observable, as in the JAX test."""
    lp = logprob('port', maxiter=256)
    ratio = lp.convergence_diagnostics(lp.theta0)
    assert ratio.shape == (1,) and ratio[0] < 1e-4
    starved = logprob('port', maxiter=1)
    assert starved.convergence_diagnostics(lp.theta0)[0] > 100 * ratio[0]
    both = lp.convergence_diagnostics(jittered(lp.theta0, 1))
    assert both.shape == (2,) and both[0] == ratio[0]


def test_predict_fn_matches_jax():
    G = graphs('port', 'gp')
    Z = port_testing.random_molecule_set(3, 4, n_atoms_range=(5, 9))
    Zj = jax_testing.random_molecule_set(3, 4, n_atoms_range=(5, 9))
    theta = jittered(logprob('port').theta0, 1)[1]
    mean, var = logprob('port').predict_fn(Z)(theta)
    mean_want, var_want = logprob('jax').predict_fn(Zj)(jnp.asarray(theta))
    assert len(G) == 8 and mean.shape == var.shape == (4,)
    mean_want, var_want = np.asarray(mean_want), np.asarray(var_want)
    np.testing.assert_allclose(mean.numpy(), mean_want, rtol=0,
                               atol=1e-4 * np.abs(mean_want).max())
    np.testing.assert_allclose(var.numpy(), var_want, rtol=0,
                               atol=1e-4 * np.abs(var_want).max())


@pytest.mark.parametrize('which', ['gp', 'bench_subset', 'edge', 'kron'])
def test_batched_gram_equals_single_calls(which):
    """gram([C, n_active]) against C calls of one theta: K, dK and the
    residuals. Two size classes with the bench subset; the plain
    ``'edge'`` mode batched as the resident route; the kron route solves
    the thetas one after another."""
    from graphdot_tpu_torch.inference import GramFactory
    if which == 'gp':
        factory = logprob('port').factory
    elif which == 'bench_subset':
        factory = GramFactory(port_kernel(), graphs('port', 'bench')[:10],
                              maxiter=64)
        assert len(factory._plan.groups) == 3
    else:
        factory = GramFactory(port_kernel(which), graphs('port', 'gp'))
        assert factory._plan.route(factory._plan.groups[0]) == which
    thetas = jittered(factory.theta0, 3)
    K, dK, res = factory.gram(thetas, eval_gradient=True,
                              with_residual=True)
    assert K.shape == (4, *factory.gram(thetas[0]).shape)
    assert dK.shape == (*K.shape, 4) and res.shape == (4,)
    for c, t in enumerate(thetas):
        K1, dK1, r1 = factory.gram(t, eval_gradient=True, with_residual=True)
        np.testing.assert_allclose(K[c].numpy(), K1.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(dK[c].numpy(), dK1.numpy(), rtol=0,
                                   atol=1e-6 * float(dK1.abs().max()))
        assert res[c] == pytest.approx(r1, rel=1e-3, abs=1e-9)
    np.testing.assert_allclose(factory.gram(thetas).numpy(), K.numpy(),
                               rtol=0, atol=1e-6)


def ood_thetas(theta0):
    """theta0 with q = 1 and q = 2 (log q is the second entry)."""
    out = np.tile(np.asarray(theta0, dtype=np.float32), (len(OOD_LOG_Q), 1))
    out[:, 1] = OOD_LOG_Q
    return out


def test_out_of_domain_finiteness_matches_jax():
    lp, lpj = logprob('port'), logprob('jax')
    thetas = ood_thetas(lp.theta0)
    logp, grad = lp.value_and_grad()(torch.from_numpy(thetas))
    want = np.array([float(lpj(jnp.asarray(t))) for t in thetas])
    assert np.array_equal(np.isfinite(logp.numpy()), np.isfinite(want)), (
        logp, want)
    # the finite value agrees too, and the in-domain rows of a mixed batch
    # are untouched by the others
    ok = np.isfinite(want)
    np.testing.assert_allclose(logp.numpy()[ok], want[ok], rtol=1e-4,
                               atol=1e-4)
    mixed = np.vstack([thetas, lp.theta0[None].astype(np.float32)])
    logp_mixed, grad_mixed = lp.value_and_grad()(torch.from_numpy(mixed))
    alone, grad_alone = lp.value_and_grad()(torch.from_numpy(mixed[-1]))
    assert float(logp_mixed[-1]) == pytest.approx(float(alone), rel=1e-6)
    np.testing.assert_allclose(grad_mixed[-1].numpy(), grad_alone.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_gp_nuts_short_chain():
    """As ``test_gp_nuts_short_chain`` of ``tests/test_inference.py``, and
    every chain moves in every dimension."""
    G = graphs('port', 'gp')
    lp = GPRLogProb(port_kernel(), G, gp_targets(G), alpha=ALPHA)
    out = sample(lp, torch.Generator().manual_seed(0), n_chains=2,
                 n_warmup=40, n_samples=16, init=lp.theta0, max_depth=5,
                 init_jitter=0.1, device='cpu')
    s = out['samples'].numpy()
    assert s.shape == (2, 16, 4)
    assert np.all(np.isfinite(s))
    assert out['divergent'].float().mean() < 0.5
    assert np.all(s.std(axis=1) > 1e-6), s.std(axis=1)


def test_sample_repeats_on_one_logprob():
    """Two runs of ``sample`` from one seed on one ``GPRLogProb`` give the
    same bits (nothing that a call leaves behind changes the next), and so
    does ``value_and_grad`` at 8 thetas before and after them."""
    G = graphs('port', 'gp')
    lp = GPRLogProb(port_kernel(), G, gp_targets(G), alpha=ALPHA)
    thetas = torch.from_numpy(jittered(lp.theta0, 7))
    before = lp.value_and_grad()(thetas)
    runs = [sample(lp, torch.Generator().manual_seed(0), n_chains=2,
                   n_warmup=10, n_samples=3, init=lp.theta0, max_depth=3,
                   init_jitter=0.1, device='cpu') for _ in range(2)]
    for key in ('samples', 'logp', 'accept_prob', 'divergent', 'inv_mass'):
        assert torch.equal(runs[0][key], runs[1][key]), key
    assert runs[0]['step_size'] == runs[1]['step_size']
    after = lp.value_and_grad()(thetas)
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])


def fixture_transition(ref, lp, device='cpu'):
    """The fixture's GP NUTS transition through the port's ``nuts_step``
    with the fixture's start state and draws: (state, info)."""
    def t(name, dtype=torch.float32):
        return torch.as_tensor(ref[name], dtype=dtype, device=device)

    state = HMCState(q=t('nuts_q0')[None], logp=t('nuts_logp0')[None],
                     grad=t('nuts_grad0')[None])
    draws = {'p0': t('nuts_p0'), 'direction': t('nuts_direction',
                                                torch.bool),
             'within': t('nuts_within'), 'merge': t('nuts_merge')}
    return nuts_step(draws, state, lp, float(ref['nuts_step']),
                     t('nuts_inv_mass'), max_depth=int(ref['nuts_max_depth']))


def assert_fixture_transition(state, info, ref):
    """n_leapfrog, depth and divergent equal to JAX's; q and accept_prob
    within 1e-4. Returns a line of text."""
    q = state.q[0].cpu().numpy()
    assert int(info['n_leapfrog'][0]) == int(ref['nuts_n_leapfrog'])
    assert int(info['depth'][0]) == int(ref['nuts_depth'])
    assert bool(info['divergent'][0]) == bool(ref['nuts_divergent'])
    err_q = float(np.abs(q - ref['nuts_q']).max())
    err_a = abs(float(info['accept_prob'][0]) - float(ref['nuts_accept']))
    assert err_q <= 1e-4 and err_a <= 1e-4, (err_q, err_a)
    return (f'n_leapfrog {int(ref["nuts_n_leapfrog"])}, depth '
            f'{int(ref["nuts_depth"])}, max |q - q_jax| {err_q:.3e}, '
            f'|accept - accept_jax| {err_a:.3e}')


def test_fixture_transition_draw_for_draw():
    ref = np.load(FIXTURE)
    G = graphs('port', 'gp')
    assert np.array_equal(ref['gp_set'], np.hstack(GP_SET))
    lp = GPRLogProb(port_kernel(), G, gp_targets(G),
                    alpha=float(ref['gp_alpha']))
    state, info = fixture_transition(ref, lp)
    assert_fixture_transition(state, info, ref)
    assert int(ref['nuts_n_leapfrog']) > 3


def test_fixture_bench_nuts_values():
    """The fixture's JAX values on bench_nuts.py's 32 molecules, by the port
    on the CPU, in one batched call: logp within 1e-4 |logp| + 1e-3, the
    gradient within 1e-3 max |grad| + 1e-3, the limits of the card's
    phase."""
    ref = np.load(FIXTURE)
    assert np.array_equal(ref['bench_set'], np.hstack(BENCH_SET))
    G = graphs('port', 'bench')
    lp = GPRLogProb(port_kernel(), G, bench_targets(G),
                    alpha=float(ref['bench_alpha']), normalize_y=True)
    np.testing.assert_allclose(ref['thetas'][0], lp.theta0.astype(np.float32))
    logp, grad = lp.value_and_grad()(torch.from_numpy(ref['thetas']))
    _assert_logp_grad(logp.numpy(), grad.numpy(), ref['logp'], ref['grad'],
                      1e-3)


def jax_reference():
    """The fixture's arrays, from JAX on the CPU."""
    out = {}
    G = graphs('jax', 'bench')
    lp = JaxGPRLogProb(jax_kernel(), G, bench_targets(G), alpha=ALPHA,
                       normalize_y=True)
    out['thetas'] = jittered(lp.theta0, N_JITTER)
    out['logp'], out['grad'] = jax_value_and_grad(lp, out['thetas'])
    out['bench_set'], out['bench_alpha'] = np.hstack(BENCH_SET), ALPHA

    G = graphs('jax', 'gp')
    lp = JaxGPRLogProb(jax_kernel(), G, gp_targets(G), alpha=ALPHA)
    out['gp_set'], out['gp_alpha'] = np.hstack(GP_SET), ALPHA
    key = jax.random.PRNGKey(NUTS_KEY)
    inv_mass = jnp.ones(len(lp.theta0), dtype=jnp.float32)
    start = jax_hmc_init(lp, jnp.asarray(lp.theta0 + NUTS_OFFSET,
                                         dtype=jnp.float32))
    state, info = jax.jit(lambda k, s: jax_nuts_step(
        k, s, lp, NUTS_STEP, inv_mass, max_depth=NUTS_DEPTH))(key, start)
    out.update({
        'nuts_key': np.asarray(key),
        'nuts_q0': np.asarray(start.q), 'nuts_logp0': np.asarray(start.logp),
        'nuts_grad0': np.asarray(start.grad), 'nuts_step': NUTS_STEP,
        'nuts_inv_mass': np.asarray(inv_mass), 'nuts_max_depth': NUTS_DEPTH,
        'nuts_q': np.asarray(state.q), 'nuts_logp': np.asarray(state.logp),
        'nuts_accept': np.asarray(info['accept_prob']),
        'nuts_n_leapfrog': np.asarray(info['n_leapfrog']),
        'nuts_depth': np.asarray(info['depth']),
        'nuts_divergent': np.asarray(info['divergent']),
    })
    out.update({'nuts_' + k: v for k, v in jax_nuts_draws(
        key, len(lp.theta0), NUTS_DEPTH).items()})
    out['ood_theta'] = ood_thetas(lp.theta0)
    out['ood_finite'] = np.array([np.isfinite(float(lp(jnp.asarray(t))))
                                  for t in out['ood_theta']])
    return out


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    ref = jax_reference()
    np.savez(FIXTURE, **ref)
    print(f'wrote {FIXTURE}: ' + ', '.join(
        f'{k} {np.shape(v)}' for k, v in ref.items()))
